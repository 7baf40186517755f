"""All-task sliding-window inference throughput of the port on one CUDA card
(counterpart of bench.py).

    python3 -m l4p_tpu_torch.bench [--frames 192] [--queries 128] [--iters 3]
                                   [--tasks flow_2d_backward,track_2d,depth,dyn_mask,camray] [--float-input]

Prints ONE JSON line, bench.py's: {"metric", "value" (frames/s), "unit",
"vs_baseline" (against 30 fps), "detail"}; `detail` holds `frames`,
`seconds_per_video`, `compile_seconds`, `tasks`, `device`,
`model_tflops_per_video`, `mfu` and `encoder_tflops_per_video` (on a card
that utils.flops knows), `secondary` (the 48-frame x 64-query point) and
`card` (nvidia-smi's name and power limit). The model is configs/model.yaml
as loaded (its default encoder), with random bf16 weights from a seeded
generator; the request is bench.py's, made with the same numpy generator:
uint8 frames, intrinsics with focal = width and the centre at half of it,
every query at t = 0.5 with label 1. `compile_seconds` is the first
request, which builds or loads the kernels and sets up cuBLAS and cuDNN.
Each timed request ends in torch.cuda.synchronize(). These are the card's
numbers: they are not comparable with the TPU figures in BENCH_r0*.json.
A failure, or no card, prints bench.py's error line and exits 1; the
benchmark never runs on the CPU (the tests call `measure_point` there).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, Sequence, Union

import numpy as np
import torch

from l4p_tpu_torch.config import L4PConfig, load_model_config
from l4p_tpu_torch.inference import InferenceSession
from l4p_tpu_torch.models.l4p import L4P
from l4p_tpu_torch.utils.flops import alltask_video_flops, device_peak_flops, mfu

MODEL_YAML = Path(__file__).resolve().parents[1] / "configs" / "model.yaml"
BASELINE_FPS = 30.0  # the north-star target bench.py compares against (BASELINE.md)
SECONDARY = (48, 64)


def bench_request(cfg: L4PConfig, tasks: Sequence[str], frames: int, queries: int,
                  u8_ingest: bool = True) -> Dict[str, np.ndarray]:
    """bench.py's request (bench.py:45-68) at the model's frame size, drawn
    from np.random.default_rng(0) in bench.py's order: at 224 x 224 the
    same bytes."""
    h, w = cfg.window_size[1:]
    rng = np.random.default_rng(0)
    k = np.tile(np.diag([float(w), float(h), 1, 1]).astype(np.float32)[None, :, :, None], (1, 1, 1, frames))
    k[:, 0, 2] = w / 2
    k[:, 1, 2] = h / 2
    data = {"intrinsics_b44t": k}
    if u8_ingest:
        data["rgb_u8_bthw3"] = rng.integers(0, 256, (1, frames, h, w, 3), dtype=np.uint8)
    else:
        data["rgb_b3thw"] = rng.standard_normal((1, 3, frames, h, w)).astype(np.float32)
    if "track_2d" in tasks:
        q = np.stack([np.zeros(queries) + 0.5, rng.uniform(4, w - 4, queries), rng.uniform(4, h - 4, queries)],
                     -1).astype(np.float32)
        data["track_2d_pointquerries_bn3"] = q[None]
        data["track_2d_pointlabels_bn"] = np.ones((1, queries), np.float32)
    return data


def measure_point(cfg: L4PConfig, tasks: Sequence[str], frames: int, queries: int,
                  device: Union[str, torch.device], iters: int, u8_ingest: bool = True) -> dict:
    """bench.py's `_measure_point` (bench.py:28-124) on `device`: one first
    request timed as compile_seconds, then `iters` timed requests; returns
    bench.py's result dict (`mfu` only where utils.flops knows the device's
    peak)."""
    device = torch.device(device)
    tasks = tuple(tasks)
    cfg = dataclasses.replace(cfg, track=dataclasses.replace(cfg.track, max_queries=queries))
    model = L4P(cfg, device=device, dtype=torch.bfloat16).eval()
    model.init_weights(torch.Generator(device=device).manual_seed(0))
    data = {k: torch.as_tensor(v, device=device) for k, v in bench_request(cfg, tasks, frames, queries,
                                                                          u8_ingest).items()}
    if "rgb_b3thw" in data:
        data["rgb_b3thw"] = data["rgb_b3thw"].bfloat16()
    sess = InferenceSession(cfg, tasks, device)

    def run_once() -> None:
        sess(model, data)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    run_once()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        run_once()
    dt = (time.perf_counter() - t0) / iters
    fps = frames / dt
    detail = {
        "frames": frames,
        "seconds_per_video": round(dt, 3),
        "compile_seconds": round(compile_s, 1),
        "tasks": list(tasks),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
    }
    stages = alltask_video_flops(cfg, tasks, frames, queries if "track_2d" in tasks else 0)
    detail["model_tflops_per_video"] = round(stages["total"] / 1e12, 2)
    u = mfu(stages["total"], dt, device_peak_flops(device))
    if u is not None:
        detail["mfu"] = round(u, 4)
        detail["encoder_tflops_per_video"] = round(stages["encoder"] / 1e12, 2)
    return {
        "metric": f"all_task_fps_per_chip_{frames}f_{queries}q",
        "value": round(fps, 2),
        "unit": "fps",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "detail": detail,
    }


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def build_and_run(args) -> dict:
    """The headline point, then the secondary one (bench.py:127-196, without
    the ladder of smaller points that bench.py falls back to on a TPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: the benchmark measures a CUDA card")
    cfg, _ = load_model_config(str(MODEL_YAML))
    tasks = tuple(args.tasks.split(","))
    result = measure_point(cfg, tasks, args.frames, args.queries, "cuda", args.iters, args.u8_ingest)
    if (args.frames, args.queries) != SECONDARY:
        try:
            sec = measure_point(cfg, tasks, *SECONDARY, "cuda", args.iters, args.u8_ingest)
            result["detail"]["secondary"] = {"metric": sec["metric"], "value": sec["value"],
                                             "seconds_per_video": sec["detail"]["seconds_per_video"]}
        except Exception as e:  # noqa: BLE001 - the secondary point must not lose the headline
            result["detail"]["secondary"] = {"error": str(e)[:200]}
    result["detail"]["card"] = card_line()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=192, help="video length (multiple of 8)")
    ap.add_argument("--queries", type=int, default=128, help="tracking queries")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--tasks", type=str, default="flow_2d_backward,track_2d,depth,dyn_mask,camray")
    ap.add_argument("--u8-ingest", dest="u8_ingest", action="store_true", default=True,
                    help="ship uint8 video, normalize on the device (default)")
    ap.add_argument("--float-input", dest="u8_ingest", action="store_false")
    args = ap.parse_args(argv)
    try:
        print(json.dumps(build_and_run(args)))
        return 0
    except Exception as e:  # noqa: BLE001 - the line must stay parseable, never a bare traceback
        print(json.dumps({
            "metric": "all_task_fps_per_chip",
            "value": 0.0,
            "unit": "fps",
            "vs_baseline": 0.0,
            "error": f"{type(e).__name__}: {str(e)[:400]}",
            "traceback_tail": traceback.format_exc().splitlines()[-3:],
        }))
        return 1


if __name__ == "__main__":
    sys.exit(main())
