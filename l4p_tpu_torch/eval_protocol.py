"""The five-config evaluation harness on the port (counterpart of
scripts/eval_protocol.py, BASELINE.md's protocol): one JSONL metric record
per config under --out-dir, with the JAX script's keys. On synthetic data
with random weights today; with the released weights and the datasets:

    python3 -m l4p_tpu_torch.eval_protocol --ckpt weights/l4p_v1.ckpt \\
        --davis-root /data/davis --dycheck-root /data/dycheck
    python3 -m l4p_tpu_torch.eval_protocol --device cpu --model-config configs/model_tiny.yaml

Configs:
  1 depth_single_window   depth only, one window, no joint alignment
  2 dense_windowed        depth + flow + dyn_mask, 1 + 4 strides of windows
  3 track2d               2D tracks (DAVIS with --davis-root, else synthetic)
  4 track3d_depth         3D tracks + depth (Dycheck with --dycheck-root)
  5 all_task              the five tasks, camray and the joint Sim(3) stitch

Each record: {"config", "tasks", "frames", "queries", "metrics", "seconds",
"fps", "data": "synthetic|davis|dycheck", "weights": "random|ckpt"}. The
time is the mean of 3 requests after a first one, ending in a
synchronisation of the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from l4p_tpu_torch.config import L4PConfig
from l4p_tpu_torch.inference import InferenceSession
from l4p_tpu_torch.metrics import l4p_metrics


def synthetic_extrinsics(t: int) -> np.ndarray:
    """(1, 4, 4, t) cam_T_world of the protocol's trajectory: a turn of
    0.01 rad a frame about y and a drift in x and z."""
    ext = np.tile(np.eye(4, dtype=np.float32)[None, :, :, None], (1, 1, 1, t))
    for i in range(t):
        a = 0.01 * i
        ext[0, :3, :3, i] = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]], np.float32)
        ext[0, :3, 3, i] = [0.02 * i, 0.0, -0.01 * i]
    return ext


def synthetic_batch(t: int, h: int = 224, w: int = 224, n_queries: int = 32, seed: int = 0,
                    tasks: Sequence[str] = ("depth",)) -> Dict[str, np.ndarray]:
    """An L4PData-schema batch with ground truth for every task: the JAX
    script's draws from default_rng(seed), in its order."""
    rng = np.random.default_rng(seed)
    k = np.tile(np.diag([float(w), float(h), 1, 1]).astype(np.float32)[None, :, :, None], (1, 1, 1, t))
    k[:, 0, 2] = w / 2.0
    k[:, 1, 2] = h / 2.0
    batch = {
        "rgb_b3thw": rng.standard_normal((1, 3, t, h, w)).astype(np.float32) * 0.5,
        "intrinsics_b44t": k,
        "extrinsics_b44t": synthetic_extrinsics(t),
        "depth_b1thw": np.exp(rng.standard_normal((1, 1, t, h, w)).astype(np.float32) * 0.3),
        "flow_2d_backward_b2thw": rng.standard_normal((1, 2, t, h, w)).astype(np.float32),
        "dyn_mask_b1thw": (rng.random((1, 1, t, h, w)) > 0.5).astype(np.float32),
    }
    if "track_2d" in tasks:
        q = np.stack([np.zeros(n_queries) + 0.5, rng.uniform(4, w - 4, n_queries),
                      rng.uniform(4, h - 4, n_queries)], -1).astype(np.float32)[None]
        batch["track_2d_pointquerries_bn3"] = q
        batch["track_2d_pointlabels_bn"] = np.ones((1, n_queries), np.float32)
        batch["track_2d_traj_bn2t"] = np.repeat(q[:, :, 1:3, None], t, axis=3).astype(np.float32)  # static tracks
        batch["track_2d_vis_bn1t"] = np.ones((1, n_queries, 1, t), np.float32)
        batch["track_2d_valid_bn1t"] = np.ones((1, n_queries, 1, t), np.float32)
    return batch


def real_batch(kind: str, root: str, t_max: int) -> Dict[str, np.ndarray]:
    """The first sequence of a DAVIS or Dycheck root, collated."""
    from l4p_tpu_torch.data.dataset import collate
    from l4p_tpu_torch.data.sources import DavisDataset, DycheckDataset

    crop = (t_max, 224, 224)
    ds = DavisDataset(root, crop_size=crop) if kind == "davis" else DycheckDataset(root, crop_size=crop)
    return collate(ds[0])


# (name, tasks, strides past the first window): 16 and 48 frames at the released 16 / 8 geometry
CONFIGS = [
    ("depth_single_window", ("depth",), 0),
    ("dense_windowed", ("depth", "flow_2d_backward", "dyn_mask"), 4),
    ("track2d", ("track_2d",), 4),
    ("track3d_depth", ("track_2d", "depth"), 4),
    ("all_task", ("flow_2d_backward", "track_2d", "depth", "dyn_mask", "camray"), 4),
]


def config_frames(cfg: L4PConfig, extra_strides: int) -> int:
    return cfg.window_size[0] + extra_strides * cfg.window_stride_t


def config_for(cfg: L4PConfig, name: str) -> L4PConfig:
    """The model config a protocol config runs: depth_single_window without
    the joint alignment, as the JAX script runs it."""
    return dataclasses.replace(cfg, joint_alignment=False) if name == "depth_single_window" else cfg


def run_config(model, cfg: L4PConfig, name: str, tasks: Sequence[str], batch: Dict[str, np.ndarray],
               device: torch.device,
               iters: int = 3) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], Dict[str, float]]:
    """One config on one batch: (the batch on the device, the outputs, the
    metrics as floats and the request's mean seconds under 'seconds'). A
    first request, then `iters` timed ones ending in a synchronisation of
    the card."""
    sess = InferenceSession(config_for(cfg, name), tasks, device)
    data = {k: torch.as_tensor(v, device=device) for k, v in batch.items() if not isinstance(v, str)}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = sess(model, data)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = sess(model, data)
    sync()
    seconds = (time.perf_counter() - t0) / iters
    metrics, _ = l4p_metrics(data, out)
    return data, out, {**{k: float(v) for k, v in metrics.items()}, "seconds": seconds}


def main(argv: Optional[Sequence[str]] = None) -> int:
    from l4p_tpu_torch.checkpoint import prepare_model

    ap = argparse.ArgumentParser(prog="l4p_tpu_torch.eval_protocol")
    ap.add_argument("--model-config", default="configs/model.yaml")
    ap.add_argument("--ckpt", default=None, help="released Lightning .ckpt (strict load)")
    ap.add_argument("--queries", type=int, default=128, help="tracking queries (reference default, demo.py:24-25)")
    ap.add_argument("--out-dir", default="runs/eval_protocol_torch")
    ap.add_argument("--davis-root", default=None)
    ap.add_argument("--dycheck-root", default=None)
    ap.add_argument("--only", default=None, help="comma list of config names")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    model, cfg, _ = prepare_model(args.model_config, args.ckpt, max_queries=args.queries, dtype=torch.bfloat16,
                                  device=device)
    os.makedirs(args.out_dir, exist_ok=True)
    only = set(args.only.split(",")) if args.only else None
    _, h_img, w_img = cfg.window_size
    for name, tasks, extra_strides in CONFIGS:
        if only and name not in only:
            continue
        frames = config_frames(cfg, extra_strides)
        data_kind = "synthetic"
        if name == "track2d" and args.davis_root:
            batch, data_kind = real_batch("davis", args.davis_root, frames), "davis"
        elif name == "track3d_depth" and args.dycheck_root:
            batch, data_kind = real_batch("dycheck", args.dycheck_root, frames), "dycheck"
        else:
            batch = synthetic_batch(frames, h=h_img, w=w_img, n_queries=args.queries, tasks=tasks)
        _, _, metrics = run_config(model, cfg, name, tasks, batch, device)
        dt = metrics.pop("seconds")
        rec = {
            "config": name,
            "tasks": list(tasks),
            "frames": frames,
            "queries": args.queries if "track_2d" in tasks else None,
            "metrics": metrics,
            "seconds": round(dt, 3),
            "fps": round(frames / dt, 2),
            "data": data_kind,
            "weights": "ckpt" if args.ckpt else "random",
        }
        with open(os.path.join(args.out_dir, f"{name}.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
