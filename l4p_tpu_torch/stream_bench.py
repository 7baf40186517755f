"""Streaming (online) all-task latency on one CUDA card (counterpart of
scripts/stream_bench.py).

    python3 -m l4p_tpu_torch.stream_bench [--queries 64] [--windows 8]

Serves configs/model.yaml as loaded (the giant model, random bf16 weights
from a seeded generator) through StreamingL4P: one window pushed first, one
stride more, then `--windows` strides timed together, ending in
torch.cuda.synchronize(). Frames are uint8 from np.random.default_rng(0),
the queries at t = 0.5, the intrinsics with focal = width and the centre at
half of it. Prints ONE JSON line: `value` (ms per window in the steady
state), `sustained_input_fps` (stride frames over that), `latency_frames`
(the window), `compile_s` (the first window, which builds or loads the
kernels, and the first steady one), `device` and `card` (nvidia-smi's name
and power limit). A failure, or no card, prints an error line and exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback

import numpy as np
import torch

from l4p_tpu_torch.bench import MODEL_YAML, card_line


def measure(queries: int, windows: int) -> dict:
    from l4p_tpu_torch.checkpoint import prepare_model
    from l4p_tpu_torch.streaming import StreamingL4P

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: the benchmark measures a CUDA card")
    model, cfg, tasks = prepare_model(str(MODEL_YAML), max_queries=queries, device="cuda")
    ws, stride = cfg.window_size[0], cfg.window_stride_t
    h, w = cfg.window_size[1:]
    rng = np.random.default_rng(0)
    q = np.stack([np.zeros(queries) + 0.5, rng.uniform(4, w - 4, queries), rng.uniform(4, h - 4, queries)], -1)
    s = StreamingL4P(model, cfg, tasks, "cuda", q[None].astype(np.float32))
    t_total = ws + stride * (1 + windows)
    frames = rng.integers(0, 256, (1, t_total, h, w, 3), dtype=np.uint8)
    intr = np.tile(np.diag([float(w), float(h), 1, 1]).astype(np.float32)[None, :, :, None], (1, 1, 1, t_total))
    intr[:, 0, 2], intr[:, 1, 2] = w / 2, h / 2

    def push(lo: int, hi: int) -> int:
        return len(s.push(frames[:, lo:hi], intr[..., lo:hi]))

    t0 = time.perf_counter()
    emitted = push(0, ws)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    emitted += push(ws, ws + stride)
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(windows):
        lo = ws + stride * (1 + i)
        emitted += push(lo, lo + stride)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / windows
    if emitted != windows + 2:
        raise RuntimeError(f"{emitted} windows emitted, expected {windows + 2}")
    return {
        "metric": f"stream_window_latency_ms_{queries}q",
        "value": dt * 1e3,
        "unit": "ms/window",
        "sustained_input_fps": stride / dt,
        "latency_frames": ws,
        "compile_s": {"first_window": first, "steady": steady},
        "tasks": list(tasks),
        "device": torch.cuda.get_device_name(0),
        "card": card_line(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--windows", type=int, default=8, help="timed steady-state windows")
    args = ap.parse_args(argv)
    try:
        print(json.dumps(measure(args.queries, args.windows)))
        return 0
    except Exception as e:  # noqa: BLE001 - the line must stay parseable, never a bare traceback
        print(json.dumps({"metric": f"stream_window_latency_ms_{args.queries}q", "value": 0.0, "unit": "ms/window",
                          "error": f"{type(e).__name__}: {str(e)[:400]}",
                          "traceback_tail": traceback.format_exc().splitlines()[-3:]}))
        return 1


if __name__ == "__main__":
    sys.exit(main())
