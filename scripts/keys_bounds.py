"""What bounds the two-way transformer's image-side kernels on a CUDA card: builds that leave out parts.

    python3 scripts/keys_bounds.py                       # from the repository root, one card
    python3 scripts/keys_bounds.py --other old=path.cu   # also time another fused_keys.cu
    python3 scripts/keys_bounds.py --clocks              # also each part's cycles per tile

Each variant is ``l4p_tpu_torch/csrc/fused_keys.cu`` compiled by nvcc (the
port's flags) with the build-time hooks that the source lists, all builds at
once, into a temporary directory; ``--other`` adds another source of the
cluster kernel with the same entry points (an earlier design: the headers
it includes beside it, e.g. from ``git show``), built without hooks and
launched with the same split of P. i2t_ln_t2i's variants stop the kernel
after one more part each:
  loads_only      keys read, nothing computed;
  no_v2           + the i2t logits, each head's softmax and its rows sent;
  no_ln           + y = keys + attn . v2 + ob;
  no_next_logits  + the LayerNorm and the new keys' store;
  no_acc          + the next t2i logits (no weighted sum);
  no_combine      + the weighted sum, without combining P-splits;
  kernel          the whole kernel.
The unchanged kernel and each --other source are held against the plain
versions (KEYS_BAND, both kernels) at a ragged shape and at the timed shape
first; the variants compute wrong results on purpose and only their times
mean something. All are timed in turns (forward, then backward, averaged)
at N=128 queries, P=2048 tokens, C=1408, K=K2=48 in 8 heads (the track
head's shape on the giant model), bf16. Prints ms and GB/s of keys traffic
for each (one read of keys and one write of the new keys for i2t_ln_t2i,
one read for t2i_flash, the bound's bytes) and the split of i2t_ln_t2i's
time that the differences give, then the exact builds' times at a
data-parallel rank's queries (RANK_QUERIES). Every line names the card and
its power limit. ``--clocks`` also builds the L4P_KEYS_CLOCKS variant, runs
each kernel once at the timed shape and prints the cycles per 128-row tile
of each part (CLOCK_PARTS), as thread 0 of each block of query 0's first
cluster counted them: where a tile's time goes, waits included (thread 0
also issues the tile's TMA loads and stores, so its parts hold those).
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

from chip_smoke import KEYS_BAND, PEAK_BYTES, card_line, keys_operands, time_ms  # noqa: E402

STOPS = ("L4P_KEYS_NO_ACC", "L4P_KEYS_NO_NEXT_LOGITS", "L4P_KEYS_NO_LN", "L4P_KEYS_NO_V2", "L4P_KEYS_LOADS_ONLY")
VARIANTS = {"kernel": (), "no_combine": ("L4P_KEYS_NO_COMBINE",), "no_acc": STOPS[:1],
            "no_next_logits": STOPS[:2], "no_ln": STOPS[:3], "no_v2": STOPS[:4], "loads_only": STOPS}
SHAPE = dict(n=128, p=2048, c=1408, k=48, k2=48)
RANK_QUERIES = (64, 32)  # a rank's queries of a 128-query chunk on 2 and 4 data-parallel cards
CHECK_SHAPES = (dict(n=3, p=1000, c=128, k=48, k2=32), SHAPE)
HEADS = 8
EPS = 1e-5
ITERS = 10
CLOCK_PARTS = ("between tiles (and the prologue)", "wait for the tile", "i2t logits, partials sent",
               "wait for the other owners' probabilities", "y", "LayerNorm moments, exchange",
               "LayerNorm, new keys, store", "next logits, partials sent, wait for them (t2i_flash: and the window)",
               "wait for the other owners' next logits", "next logits to registers (i2t_ln_t2i: and the accumulation)",
               "end of tile", "wait for the i2t partials", "owners' softmax, its rows sent",
               "owners' next logits, their rows sent", "t2i_flash's window: exponentials",
               "t2i_flash's window: the barrier after them")


def build(name: str, source: str, defines, work: str):
    """`source` with `defines` as {"i2t": .., "t2i": ..}, its two entry points bound."""
    from l4p_tpu_torch import _build
    from l4p_tpu_torch.ops import fused_keys as FK

    out = os.path.join(work, f"{name}.so")
    proc = subprocess.run(_build.nvcc_command(_build.find_nvcc(), [source], out, defines), capture_output=True,
                          text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"keys_bounds: {name} does not build:\n{proc.stderr[-3000:]}")
    ptxas = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
             if "registers" in line or "spill" in line or "C75" in line]
    return {"i2t": FK.I2T.bind(out), "t2i": FK.T2I.bind(out)}, ptxas


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[], metavar="NAME=PATH",
                    help="another fused_keys.cu with the same entry points, timed beside the variants")
    ap.add_argument("--clocks", action="store_true", help="also each part's cycles per tile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("keys_bounds: needs a CUDA card", file=sys.stderr)
        return 1
    from l4p_tpu_torch import _build
    from l4p_tpu_torch.ops import fused_keys as FK

    card = card_line()

    def log(msg: str) -> None:
        print(f"[{card}] {msg}", flush=True)

    source = os.path.join(_build.CSRC_DIR, "fused_keys.cu")
    builds = {name: (source, defines) for name, defines in VARIANTS.items()}
    others = dict(o.split("=", 1) for o in args.other)
    builds.update({name: (os.path.abspath(path), ()) for name, path in others.items()})
    if args.clocks:
        builds["clocks"] = (source, ("L4P_KEYS_CLOCKS",))
    exact = ["kernel", *others]

    def i2t_call(name, lib, ops, n, p):
        outs, cargs, keep = FK.i2t_launch_args(*ops, HEADS, EPS, FK.split_rows(n, p))

        def run():
            err = lib["i2t"](*cargs, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"keys_bounds: {name} i2t_ln_t2i launch failed with {err}")
        return run, outs, keep

    def t2i_call(name, lib, ops, n, p):
        out, cargs, keep = FK.t2i_launch_args(*ops, FK.split_rows(n, p))

        def run():
            err = lib["t2i"](*cargs, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"keys_bounds: {name} t2i_flash launch failed with {err}")
        return run, (out,), keep

    with tempfile.TemporaryDirectory() as work:
        with ThreadPoolExecutor(max_workers=len(builds)) as pool:
            built = dict(zip(builds, pool.map(lambda kv: build(kv[0], *kv[1], work), builds.items())))
        for name in exact:
            for line in built[name][1]:
                log(f"ptxas {name}: {line}")
        gen = torch.Generator(device="cuda").manual_seed(0)
        failed = []
        for shape in CHECK_SHAPES:
            n, p, c, k, k2 = shape.values()
            t2i_ops, i2t_ops = keys_operands(n, p, c, k, gen, k2)
            refs = {"t2i_flash": (FK.t2i_flash_plain(*t2i_ops),),
                    "i2t_ln_t2i": FK.i2t_ln_t2i_plain(*i2t_ops, HEADS, EPS)}
            for name in exact:
                for what, call, ops in (("t2i_flash", t2i_call, t2i_ops), ("i2t_ln_t2i", i2t_call, i2t_ops)):
                    run, outs, _keep = call(name, built[name][0], ops, n, p)
                    run()
                    torch.cuda.synchronize()
                    ratios = [(o.float() - r.float()).abs().max().item() / r.float().abs().max().item()
                              for o, r in zip(outs, refs[what])]
                    ok = all(math.isfinite(x) and x <= KEYS_BAND for x in ratios)
                    log(f"{name} {what} {tuple(shape.values())}: max|kernel - plain| / max|plain| "
                        f"{', '.join(f'{x:.3g}' for x in ratios)} (band {KEYS_BAND}){'' if ok else ' FAILED'}")
                    if not ok:
                        failed.append((name, what, tuple(shape.values())))
            del refs, t2i_ops, i2t_ops

        n, p, c, k, k2 = SHAPE.values()
        t2i_ops, i2t_ops = keys_operands(n, p, c, k, gen, k2)
        if args.clocks:
            cw = c // 16
            blocks = -(-cw // -(-cw // 8))  # the cluster's blocks (csrc/fused_keys.cu make_plan; 8 at C = 1408)
            for what, call, ops in (("i2t_ln_t2i", i2t_call, i2t_ops), ("t2i_flash", t2i_call, t2i_ops)):
                run, outs, _keep = call("clocks", built["clocks"][0], ops, n, p)
                run()
                torch.cuda.synchronize()
                cyc = outs[-1].flatten()[: 16 * blocks].view(blocks, 16)[:, : len(CLOCK_PARTS)].mean(0).tolist()
                log(f"{what} {tuple(SHAPE.values())}, cycles per 128-row tile (mean over the {blocks} blocks): "
                    + "; ".join(f"{part} {v:.0f}" for part, v in zip(CLOCK_PARTS, cyc)) + f"; total {sum(cyc):.0f}")
            del built["clocks"]
        calls = {name: i2t_call(name, lib, i2t_ops, n, p) for name, (lib, _) in built.items()}
        calls.update({f"{name} t2i_flash": t2i_call(name, built[name][0], t2i_ops, n, p) for name in exact})
        names = list(calls)
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(time_ms(calls[name][0], ITERS))
        ms = {name: sum(t) / len(t) for name, t in times.items()}
        keys_bytes = n * p * c * 2
        for name in names:
            moved = keys_bytes if name.endswith("t2i_flash") else 2 * keys_bytes
            each = ", ".join(f"{t:.4f}" for t in times[name])
            log(f"{name} {tuple(SHAPE.values())} bf16: {ms[name]:.4f} ms ({each}), "
                f"{moved / ms[name] / 1e6:.0f} GB/s of keys traffic "
                f"(bound of that traffic {moved / PEAK_BYTES * 1e3:.4f} ms)")
        split_ms = {"load": ms["loads_only"], "logits": ms["no_v2"] - ms["loads_only"],
                    "softmax + v2": ms["no_ln"] - ms["no_v2"],
                    "LayerNorm + store": ms["no_next_logits"] - ms["no_ln"],
                    "next logits": ms["no_acc"] - ms["no_next_logits"],
                    "t2i_acc": ms["no_combine"] - ms["no_acc"], "combine": ms["kernel"] - ms["no_combine"]}
        log("split of i2t_ln_t2i's time by differences: " + "; ".join(f"{key} {v:.3f} ms"
                                                                      for key, v in split_ms.items()))
        del calls, t2i_ops, i2t_ops
        # the exact builds at a data-parallel rank's queries (a chunk of 128 over 2 and 4 ranks)
        for n_rank in RANK_QUERIES:
            t2i_ops, i2t_ops = keys_operands(n_rank, p, c, k, gen, k2)
            calls = {}
            for name in exact:
                calls[f"{name} i2t_ln_t2i"] = i2t_call(name, built[name][0], i2t_ops, n_rank, p)
                calls[f"{name} t2i_flash"] = t2i_call(name, built[name][0], t2i_ops, n_rank, p)
            names = list(calls)
            times = {name: [] for name in names}
            for name in names + names[::-1]:
                times[name].append(time_ms(calls[name][0], ITERS))
            for name in names:
                moved = n_rank * p * c * 2 * (1 if name.endswith("t2i_flash") else 2)
                t = sum(times[name]) / len(times[name])
                log(f"{name} ({n_rank}, {p}, {c}, {k}, {k2}) bf16: {t:.4f} ms, {moved / t / 1e6:.0f} GB/s of keys "
                    f"traffic (bound {moved / PEAK_BYTES * 1e3:.4f} ms)")
            del calls, t2i_ops, i2t_ops
    if failed:
        print(f"keys_bounds: {failed} disagree with the plain versions", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
