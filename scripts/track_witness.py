"""The track outputs' distance from an fp32 attention, path by path, over several requests.

    python3 scripts/track_witness.py [--requests 6]     # from the repository root, one card

Builds the released giant model with random bf16 weights (as chip_smoke.py's
phase 3 does) and runs chip_smoke's `track_witness`: each request, a random
48-frame uint8 video with 128 queries from its own seed, is served on the
default encoder by the kernel path, the plain path, and each of the two
again with the attention in fp32 from the same bf16 q, k, v. Prints per
request and track output (max, 99th percentile) of |path - its
fp32-attention run| over the output's largest value for both paths and of
|kernel path - plain path| (what chip_smoke's TRACK_BANDS bound), then the
means over the requests. Copied with chip_smoke.py into another tree of the
repository, it measures that tree's kernels the same way. Every line names
the card and its power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import QUERY_CHUNK, card_line, track_witness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=6)
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
    cfg = P.L4PConfig()
    cfg = dataclasses.replace(cfg, track=dataclasses.replace(cfg.track, max_queries=QUERY_CHUNK))
    model = P.L4P(cfg, device=dev, dtype=torch.bfloat16).eval()
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
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
