"""The track outputs' distance from an fp32 attention, path by path, over several requests.

    python3 scripts/track_witness.py [--requests 48] [--eval]   # from the repository root, one card

Builds the released giant model with random bf16 weights (as chip_smoke.py's
phase 3 does) and runs chip_smoke's `track_witness`: each request, a random
48-frame uint8 video with 128 queries from its own seed, is served on the
default encoder by the kernel path, the plain path, and each of the two
again with the attention in fp32 from the same bf16 q, k, v. Prints per
request and track output (max, 99th percentile) of |path - its
fp32-attention run| over the output's largest value for both paths and of
|kernel path - plain path| (what chip_smoke's TRACK_BANDS bound), then the
means over the requests. With --eval, chip_smoke's phase 23 witness instead:
the eval protocol's synthetic batches of seeds 0 to requests - 1, each on
the track task by both paths, by the kernel attention with the plain track
kernels, and by each path with the attention in fp32. Copied with chip_smoke.py into another tree of the
repository, it measures that tree's kernels the same way. Every line names
the card and its power limit.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import WITNESS_REQUESTS, card_line, eval_track_witness, giant_model, track_witness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=WITNESS_REQUESTS)
    ap.add_argument("--eval", action="store_true", help="phase 23's witness on the eval protocol's batches")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("track_witness: needs a CUDA card", file=sys.stderr)
        return 1
    import l4p_tpu_torch as P
    from l4p_tpu_torch.ops import flash_attention as FA

    card = card_line()

    def log(msg: str) -> None:
        print(f"[{card}] {msg}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg, model = giant_model(P, dev)
    if args.eval:
        from l4p_tpu_torch import eval_protocol as EP

        frames = EP.config_frames(cfg, 4)
        for key, rows in eval_track_witness(P, model, cfg, frames, dev, range(args.requests), log).items():
            mean = {what: sum(p99 for _, p99 in v) / len(v) for what, v in rows.items()}
            log(f"mean over {args.requests} batches, {key}, 99th pct / output max: against its fp32-attention run "
                f"kernel path {mean['kernel']:.3g}, plain path {mean['plain']:.3g}; kernel path against the plain "
                f"track kernels {mean['track']:.3g}; ratios to the plain path {mean['kernel'] / mean['plain']:.3g}, "
                f"{mean['track'] / mean['plain']:.3g}")
        return 0
    for key, rows in track_witness(P, FA, model, cfg, dev, args.requests, log).items():
        mean = {what: tuple(sum(x[i] for x in v) / len(v) for i in range(2)) for what, v in rows.items()}
        log(f"mean over {args.requests} requests, {key}, (max, 99th pct) / output max: against its fp32-attention run "
            f"kernel path ({mean['kernel'][0]:.3g}, {mean['kernel'][1]:.3g}), plain path ({mean['plain'][0]:.3g}, "
            f"{mean['plain'][1]:.3g}), 99th pct ratio kernel / plain {mean['kernel'][1] / mean['plain'][1]:.3g}; "
            f"kernel path against plain path ({mean['kernel - plain'][0]:.3g}, {mean['kernel - plain'][1]:.3g}), "
            f"largest 99th pct {max(x[1] for x in rows['kernel - plain']):.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
