"""What bounds the encoder attention on a CUDA card: builds that change or leave out parts.

    python3 scripts/attention_bounds.py            # from the repository root, one card

Each variant is ``l4p_tpu_torch/csrc/flash_attention.cu`` compiled by nvcc
(the port's flags) with one or two of the build-time hooks that
``csrc/attention.cuh`` lists, all variants at once, into a temporary
directory. They are timed against the unchanged kernel and
``scaled_dot_product_attention`` in turns (forward, then backward, averaged)
at (2, 16, 2048, 88) and (5, 16, 2048, 88) bf16, q/k/v rows padded as the
encoder pads them (``kernel_layout``):
  kv_stages_2, kv_stages_4  a K/V ring of 2 or 4 stages instead of 3;
  no_turns      the consumer warpgroups issue without taking turns;
  no_reload     the producer loads each stage once, then only completes its
                barrier: the consumers reuse stale K/V, no bytes move;
  no_exp        the softmax's exponentials replaced by a multiply;
  no_softmax    no softmax: P is S cast to bf16;
  no_reload_no_softmax  the products and the pipeline alone.
The first three compute the attention and are held against the plain
version (``KERNEL_TOL``) on one tile, at a ragged N and at the timed shapes
before they are timed; the others compute wrong results on purpose and only
their times mean something. Every line names the card and its power limit.
"""

from __future__ import annotations

import math
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import KERNEL_TOL, PEAK_FLOPS, card_line, time_ms  # noqa: E402

# name: (the -D defines, whether the variant still computes the attention)
VARIANTS = {"kernel": ((), True), "kv_stages_2": (("L4P_ATTN_KV_STAGES=2",), True),
            "kv_stages_4": (("L4P_ATTN_KV_STAGES=4",), True), "no_turns": (("L4P_ABLATE_NO_TURNS",), True),
            "no_reload": (("L4P_ABLATE_NO_RELOAD",), False), "no_exp": (("L4P_ABLATE_NO_EXP",), False),
            "no_softmax": (("L4P_ABLATE_NO_SOFTMAX",), False),
            "no_reload_no_softmax": (("L4P_ABLATE_NO_RELOAD", "L4P_ABLATE_NO_SOFTMAX"), False)}
CHECK_SHAPES = ((1, 1, 64, 88), (1, 2, 300, 88))
SHAPES = ((2, 16, 2048, 88), (5, 16, 2048, 88))


def build(name: str, defines, work: str):
    """flash_attention.cu with `defines` as a loaded entry point."""
    from l4p_tpu_torch import _build
    from l4p_tpu_torch.ops import flash_attention as FA

    out = os.path.join(work, f"{name}.so")
    cmd = _build.nvcc_command(_build.find_nvcc(), [os.path.join(_build.CSRC_DIR, "flash_attention.cu")], out, defines)
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"attention_bounds: {name} does not build:\n{proc.stderr[-3000:]}")
    return FA.KERNEL.bind(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_bounds: needs a CUDA card", file=sys.stderr)
        return 1
    from l4p_tpu_torch.ops.flash_attention import flash_attention_plain, kernel_layout, kernel_row_pitch

    card = card_line()

    def log(msg: str) -> None:
        print(f"[{card}] {msg}", flush=True)

    with tempfile.TemporaryDirectory() as work:
        with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
            fns = dict(zip(VARIANTS, pool.map(lambda item: build(item[0], item[1][0], work), VARIANTS.items())))
        gen = torch.Generator(device="cuda").manual_seed(0)

        def operands(shape):
            return tuple(kernel_layout(torch.randn(shape, generator=gen, device="cuda").bfloat16()) for _ in range(3))

        def call(fn, q, k, v, o):
            b, h, n, d = q.shape

            def run():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * h, n, n, d,
                         kernel_row_pitch(d), d ** -0.5, torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"attention_bounds: launch failed with {err}")
            return run

        failed = []
        for shape in CHECK_SHAPES + SHAPES:
            q, k, v = operands(shape)
            ref = flash_attention_plain(q, k, v, shape[3] ** -0.5).float()
            for name, (_, exact) in VARIANTS.items():
                if exact:
                    o = torch.empty(shape, device="cuda", dtype=torch.bfloat16)
                    call(fns[name], q, k, v, o)()
                    err = (o.float() - ref).abs().max().item()
                    ok = math.isfinite(err) and err <= KERNEL_TOL
                    log(f"{name} {shape}: max|kernel - plain| {err:.3g} (tol {KERNEL_TOL}){'' if ok else ' FAILED'}")
                    if not ok:
                        failed.append((name, shape))

        for shape in SHAPES:
            b, h, n, d = shape
            q, k, v = operands(shape)
            o = torch.empty(shape, device="cuda", dtype=torch.bfloat16)
            calls = {name: call(fn, q, k, v, o) for name, fn in fns.items()}
            calls["scaled_dot_product_attention"] = lambda: F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)
            names = list(calls)
            times = {name: [] for name in names}
            for name in names + names[::-1]:
                times[name].append(time_ms(calls[name], 20))
            base = sum(times["kernel"]) / 2
            flop = 4 * b * h * n * n * d
            for name in names:
                ms = sum(times[name]) / 2
                log(f"{name} {shape} bf16: {ms:.4f} ms ({', '.join(f'{t:.4f}' for t in times[name])}), "
                    f"{flop / ms / 1e9:.1f} TFLOP/s, {100 * flop / PEAK_FLOPS * 1e3 / ms:.1f}% of the bf16 peak, "
                    f"{100 * (1 - ms / base):.1f}% below the kernel")
    if failed:
        print(f"attention_bounds: {failed} disagree with the plain version", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
