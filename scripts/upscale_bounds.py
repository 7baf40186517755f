"""What bounds the mask decoder's upscale kernel on a CUDA card: builds that leave out parts.

    python3 scripts/upscale_bounds.py                       # from the repository root, one card
    python3 scripts/upscale_bounds.py --other old=path.cu   # also time another fused_upscale.cu

Each variant is ``l4p_tpu_torch/csrc/fused_upscale.cu`` compiled by nvcc
(the port's flags) with one or more of the build-time hooks that the source
lists, all builds at once, into a temporary directory; ``--other`` adds
sources of the same C interface (an earlier revision of the kernel, with
the headers it includes beside it), built without hooks. All are timed in
turns (forward, then backward, averaged) at N=128 queries, P=2048 tokens,
C=1408, d1=352, d2=176, M=3 (the track head's shape on the giant model),
bf16:
  no_erf          GELU's erf replaced by a multiply (both epilogues);
  no_dots         the hypernetwork dots and the logit stores left out;
  no_epilogue2    product 2's GELU, rounding, dots and stores left out;
  no_epilogue1    the LayerNorm and GELU after product 1 left out;
  no_product2     product 2 and everything after it left out;
  product1_only   product 1 and its pipeline alone;
  no_reload       each ring stage loaded once, later uses compute on its
                  stale bytes: the kernel without L2 -> SM traffic;
  products_only   no reloads and no epilogues: the products and the ring.
The unchanged kernel and each --other source are held against the plain
version (UPSCALE_BAND) at a ragged shape and at the timed
shape first; the variants compute wrong results on purpose and only their
times mean something. Prints ms and TFLOP/s for each, and the split of the
kernel's time that the differences give. Every line names the card and its
power limit.
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import PEAK_FLOPS, UPSCALE_BAND, card_line, time_ms, upscale_operands  # noqa: E402

VARIANTS = {"kernel": (), "no_erf": ("L4P_ABLATE_NO_ERF",), "no_dots": ("L4P_ABLATE_NO_DOTS",),
            "no_epilogue2": ("L4P_ABLATE_NO_EPILOGUE2",), "no_epilogue1": ("L4P_ABLATE_NO_EPILOGUE1",),
            "no_product2": ("L4P_ABLATE_NO_PRODUCT2",),
            "product1_only": ("L4P_ABLATE_NO_PRODUCT2", "L4P_ABLATE_NO_EPILOGUE1"),
            "no_reload": ("L4P_ABLATE_NO_RELOAD",),
            "products_only": ("L4P_ABLATE_NO_RELOAD", "L4P_ABLATE_NO_EPILOGUE1", "L4P_ABLATE_NO_EPILOGUE2")}
SHAPE = dict(n=128, p=2048, c=1408, d1=352, d2=176, m=3)
ITERS = 5  # launches per timing (~8 ms each at SHAPE)
CHECK_SHAPE = dict(n=3, p=1000, c=64, d1=24, d2=12, m=3)


def build(name: str, source: str, defines, work: str):
    """`source` with `defines` as a loaded entry point."""
    from l4p_tpu_torch import _build
    from l4p_tpu_torch.ops import fused_upscale as FU

    out = os.path.join(work, f"{name}.so")
    proc = subprocess.run(_build.nvcc_command(_build.find_nvcc(), [source], out, defines), capture_output=True,
                          text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"upscale_bounds: {name} does not build:\n{proc.stderr[-3000:]}")
    fn = FU.KERNEL.bind(out)
    ptxas = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
             if "registers" in line or "spill" in line or "C75" in line]
    return fn, ptxas


def flop(n, p, c, d1, d2, m) -> float:
    """deconv1 (8 offsets), deconv2 (4 offsets each), the hypernetwork dots."""
    return 2 * n * p * 8 * (c * d1 + 4 * d1 * d2) + 2 * n * m * p * 32 * d2


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[], metavar="NAME=PATH",
                    help="another fused_upscale.cu with the same C interface, timed beside the variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("upscale_bounds: needs a CUDA card", file=sys.stderr)
        return 1
    from l4p_tpu_torch import _build
    from l4p_tpu_torch.ops import fused_upscale as FU

    card = card_line()

    def log(msg: str) -> None:
        print(f"[{card}] {msg}", flush=True)

    source = os.path.join(_build.CSRC_DIR, "fused_upscale.cu")
    builds = {name: (source, defines) for name, defines in VARIANTS.items()}
    others = dict(o.split("=", 1) for o in args.other)
    builds.update({name: (os.path.abspath(path), ()) for name, path in others.items()})
    exact = ["kernel", *others]
    with tempfile.TemporaryDirectory() as work:
        with ThreadPoolExecutor(max_workers=len(builds)) as pool:
            built = dict(zip(builds, pool.map(lambda kv: build(kv[0], *kv[1], work), builds.items())))
        for name in exact:
            for line in built[name][1]:
                log(f"ptxas {name}: {line}")
        gen = torch.Generator(device="cuda").manual_seed(0)
        failed = []

        def call(fn, ops):
            out, cargs, keep = FU.launch_args(*ops)

            def run():
                err = fn(*cargs, torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"upscale_bounds: launch failed with {err}")
            return run, out, keep

        for shape in (CHECK_SHAPE, SHAPE):
            ops = upscale_operands(*shape.values(), gen)
            ref = FU.fused_upscale_hypernet_plain(*ops).float()
            for name in exact:
                run, out, _keep = call(built[name][0], ops)
                run()
                torch.cuda.synchronize()
                ratio = (out - ref).abs().max().item() / ref.abs().max().item()
                ok = math.isfinite(ratio) and ratio <= UPSCALE_BAND
                log(f"{name} {tuple(shape.values())}: max|kernel - plain| / max|plain| {ratio:.3g} "
                    f"(band {UPSCALE_BAND}){'' if ok else ' FAILED'}")
                if not ok:
                    failed.append((name, tuple(shape.values())))
            del ref

        ops = upscale_operands(*SHAPE.values(), gen)
        calls = {name: call(fn, ops) for name, (fn, _) in built.items()}
        names = list(calls)
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(time_ms(calls[name][0], ITERS))
        ms = {name: sum(t) / len(t) for name, t in times.items()}
        f = flop(*SHAPE.values())
        for name in names:
            each = ", ".join(f"{t:.4f}" for t in times[name])
            log(f"{name} {tuple(SHAPE.values())} bf16: {ms[name]:.4f} ms ({each}), {f / ms[name] / 1e9:.1f} TFLOP/s,"
                f" {100 * f / PEAK_FLOPS * 1e3 / ms[name]:.1f}% of the bf16 peak "
                f"(bound {f / PEAK_FLOPS * 1e3:.4f} ms)")
        split = {"product 1 and its pipeline": ms["product1_only"],
                 "epilogue 1 (LayerNorm, GELU)": ms["no_product2"] - ms["product1_only"],
                 "product 2 and its pipeline": ms["no_epilogue2"] - ms["no_product2"],
                 "epilogue 2 (GELU, rounding, dots, stores)": ms["kernel"] - ms["no_epilogue2"]}
        log("split of the kernel's time by differences: " + "; ".join(f"{k} {v:.3f} ms" for k, v in split.items())
            + f"; the erf alone {ms['kernel'] - ms['no_erf']:.3f} ms, the dots and stores alone "
            f"{ms['kernel'] - ms['no_dots']:.3f} ms")
    if failed:
        print(f"upscale_bounds: {failed} disagree with the plain version", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
