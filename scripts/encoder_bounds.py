"""What bounds the whole-encoder kernels' GEMM on a CUDA card: builds that leave out parts.

    python3 scripts/encoder_bounds.py                       # from the repository root, one card
    python3 scripts/encoder_bounds.py --other old=path.cu   # also time another fused_encoder.cu

Each variant is ``l4p_tpu_torch/csrc/fused_encoder.cu`` compiled by nvcc
(the port's flags) with the build-time hooks that the source lists, all
builds at once, into a temporary directory; ``--other`` adds sources with
the C interface of the mma.sync GEMM before wgmma (no tile-width argument;
an earlier revision, with the headers it includes beside it), built
without hooks:
  kernel       the shipped GEMM;
  one_tile     one block per output tile instead of one per SM walking
               the tiles;
  raster_m     the walk down M under one panel of W instead of across N
               under one panel of A;
  no_epilogue  the products and their ring without the epilogue;
  loads_only   the ring and its TMA loads alone;
  no_store     the epilogue without its global stores;
  stages3      a ring of at most 3 stages.
The exact builds (kernel, one_tile, raster_m, stages3 and each --other) are
held against the plain version (GEMM_BAND) at each timed shape
first; the others compute nothing usable on purpose and only their times
mean something.
Then, for each of a giant block's four products (qkv with the QKV epilogue,
proj and fc2 with RESIDUAL, fc1 with GELU) at M = 4096 (2 windows of 2048
tokens) and M = 10240 (the fused point's 5 windows), all builds and one
torch.matmul of the same operands are timed in turns (forward, then
backward, averaged): ms, TFLOP/s and the bound (the larger of the FLOP
over the bf16 peak and the bytes, each input read once and each output
written once, over the memory rate); the kernel also at each tile width it
is built for. Last, one block's time split over its 7 launches (CUDA
events around each launch) at x (2, 2048, 1408) and (5, 2048, 1408).
Every line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import PEAK_BYTES, PEAK_FLOPS, card_line, encoder_operands, time_ms  # noqa: E402

VARIANTS = {"kernel": (), "one_tile": ("L4P_GEMM_ONE_TILE_PER_BLOCK",), "raster_m": ("L4P_GEMM_RASTER_M",),
            "no_epilogue": ("L4P_GEMM_NO_EPILOGUE",), "loads_only": ("L4P_GEMM_LOADS_ONLY",),
            "no_store": ("L4P_GEMM_NO_STORE",), "stages3": ("L4P_GEMM_STAGES_MAX=3",)}
EXACT = ("kernel", "one_tile", "raster_m", "stages3")
GEMM_BAND = 2e-2  # tests/test_torch_gpu.py's band of the GEMM against its plain version
TOKENS, HEADS, HEAD_DIM, E, HIDDEN = 2048, 16, 88, 1408, 6144
# (name, epilogue, N, K) of a giant block's products
PRODUCTS = (("qkv", "QKV", 3 * E, E), ("proj", "RESIDUAL", E, E), ("fc1", "GELU", HIDDEN, E),
            ("fc2", "RESIDUAL", E, HIDDEN))
ROWS = (4096, 10240)
ITERS = 20


def build(name: str, source: str, defines, parent_interface: bool, work: str):
    """`source` with `defines` as a loaded GEMM entry point taking the
    current interface's arguments (the parent's drop the tile width)."""
    from l4p_tpu_torch import _build
    from l4p_tpu_torch.ops import fused_encoder as FE

    out = os.path.join(work, f"{name}.so")
    proc = subprocess.run(_build.nvcc_command(_build.find_nvcc(), [source], out, defines), capture_output=True,
                          text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"encoder_bounds: {name} does not build:\n{proc.stderr[-3000:]}")
    entry = _build.kernel(FE.NAME, FE.SOURCES, FE.GEMM.symbol, "p" * 5 + "i" * 7 + "p") if parent_interface else FE.GEMM
    fn = entry.bind(out)
    ptxas = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
             if "gemm_nt" in line or "registers" in line or "spill" in line or "C75" in line]
    if parent_interface:
        return (lambda *args: fn(*args[:12], args[13])), ptxas
    return fn, ptxas


def operands(m: int, n: int, k: int, epilogue: int, gen):
    from l4p_tpu_torch.ops import fused_encoder as FE
    from l4p_tpu_torch.ops.flash_attention import kernel_row_pitch

    a = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((n, k), generator=gen, device="cuda") * k ** -0.5).bfloat16()
    bias = (0.1 * torch.randn((n,), generator=gen, device="cuda")).bfloat16()
    if epilogue == FE.QKV:
        out = torch.zeros((3, m // TOKENS, HEADS, TOKENS, kernel_row_pitch(HEAD_DIM)), device="cuda",
                          dtype=torch.bfloat16)
    else:
        out = torch.randn((m, n), generator=gen, device="cuda").bfloat16()
    return a, w, bias, out


def call(fn, a, w, bias, out, epilogue: int, tile_n: int):
    (m, k), n = a.shape, w.shape[0]
    args = (a.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), None, m, n, k, epilogue, TOKENS, HEADS,
            HEAD_DIM, tile_n, torch.cuda.current_stream().cuda_stream)

    def run():
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"encoder_bounds: launch failed with {err}")
    return run


def block_split(FE, m_windows: int, log) -> None:
    """One giant block's 7 launches, each between two CUDA events."""
    import l4p_tpu_torch as P

    cfg = dataclasses.replace(P.GIANT, depth=1)
    gen = torch.Generator(device="cuda").manual_seed(1)
    blocks, x = encoder_operands(cfg, m_windows, TOKENS, gen)
    ws = FE.EncoderWorkspace(x, cfg)
    steps = ws.block_steps(FE.block_params(blocks[0]))
    reps = [[(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in steps]
            for _ in range(3 + ITERS)]
    for events in reps:  # queued back to back, synchronised once: no launch waits on the host
        for (_, step), (start, end) in zip(steps, events):
            start.record()
            step()  # raises where the launch fails
            end.record()
    torch.cuda.synchronize()
    total = [sum(events[i][0].elapsed_time(events[i][1]) for events in reps[3:]) / ITERS for i in range(len(steps))]
    log(f"one block at x ({m_windows}, {TOKENS}, {E}) bf16, ms per launch: "
        + ", ".join(f"{what} {t:.4f}" for (what, _), t in zip(steps, total)) + f"; sum {sum(total):.4f} ms")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[], metavar="NAME=PATH",
                    help="another fused_encoder.cu with the parent's C interface, timed beside the variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("encoder_bounds: needs a CUDA card", file=sys.stderr)
        return 1
    from l4p_tpu_torch import _build
    from l4p_tpu_torch.ops import fused_encoder as FE

    card = card_line()

    def log(msg: str) -> None:
        print(f"[{card}] {msg}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    source = os.path.join(_build.CSRC_DIR, "fused_encoder.cu")
    builds = {name: (source, defines, False) for name, defines in VARIANTS.items()}
    others = dict(o.split("=", 1) for o in args.other)
    builds.update({name: (os.path.abspath(path), (), True) for name, path in others.items()})
    exact = [*EXACT, *others]
    failed = []
    with tempfile.TemporaryDirectory() as work:
        with ThreadPoolExecutor(max_workers=len(builds)) as pool:
            built = dict(zip(builds, pool.map(lambda kv: build(kv[0], *kv[1], work), builds.items())))
        for name in exact:
            for line in built[name][1]:
                log(f"ptxas {name}: {line}")
        gen = torch.Generator(device="cuda").manual_seed(0)
        for rows in ROWS:
            for pname, epi_name, n, k in PRODUCTS:
                epilogue = getattr(FE, epi_name)
                a, w, bias, out = operands(rows, n, k, epilogue, gen)
                tile_n = FE.gemm_tile_width(n)
                qkv = dict(tokens=TOKENS, heads=HEADS, head_dim=HEAD_DIM) if epi_name == "QKV" else {}
                ref = FE.gemm_nt_plain(a, w, bias, epilogue, out.clone(), **qkv)
                for name in exact:
                    got = out.clone()
                    call(built[name][0], a, w, bias, got, epilogue, tile_n)()
                    torch.cuda.synchronize()
                    got, want = (got[..., :HEAD_DIM], ref[..., :HEAD_DIM]) if qkv else (got, ref)
                    ratio = (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()
                    ok = math.isfinite(ratio) and ratio <= GEMM_BAND
                    log(f"{name} {pname} ({rows}, {n}, {k}): max|kernel - plain| / max|plain| {ratio:.3g} "
                        f"(band {GEMM_BAND}){'' if ok else ' FAILED'}")
                    if not ok:
                        failed.append((name, pname, rows))
                del ref
                runs = {name: call(fn, a, w, bias, out, epilogue, tile_n) for name, (fn, _) in built.items()}
                runs.update({f"kernel@{bn}": call(built["kernel"][0], a, w, bias, out, epilogue, bn)
                             for bn in FE.GEMM_TILE_WIDTHS if bn != tile_n})
                runs["torch.matmul"] = lambda: torch.matmul(a, w.t())
                names = list(runs)
                times = {name: [] for name in names}
                for name in names + names[::-1]:
                    times[name].append(time_ms(runs[name], ITERS))
                flop = 2 * rows * n * k
                moved = (rows * k + n * k + n + (2 if epi_name == "RESIDUAL" else 1) * rows * n) * 2
                bound = max(flop / PEAK_FLOPS, moved / PEAK_BYTES) * 1e3
                log(f"{pname} ({rows} x {k}) . ({n} x {k})^T {epi_name}, tile width {tile_n}: bound {bound:.4f} ms "
                    f"({'operations' if flop / PEAK_FLOPS >= moved / PEAK_BYTES else 'bytes'})")
                for name in names:
                    ms = sum(times[name]) / len(times[name])
                    each = ", ".join(f"{t:.4f}" for t in times[name])
                    log(f"  {pname} M={rows} {name}: {ms:.4f} ms ({each}), {flop / ms / 1e9:.1f} TFLOP/s, "
                        f"{100 * bound / ms:.1f}% of the bound")
                del a, w, bias, out, runs
        for windows in (2, 5):
            block_split(FE, windows, log)
    if failed:
        print(f"encoder_bounds: {failed} disagree with the plain version", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
