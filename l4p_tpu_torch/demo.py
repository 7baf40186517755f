"""All-task inference demo on the card (counterpart of the root demo.py;
reference demo/demo.py).

    python3 -m l4p_tpu_torch.demo --video path/to/clip.mp4 --out-dir out/
    python3 -m l4p_tpu_torch.demo --davis-root /data/davis --seq train parkour
    python3 -m l4p_tpu_torch.demo --dycheck-root /data/dycheck
    python3 -m l4p_tpu_torch.demo --synthetic        # random video, no data needed

Runs the config's tasks on DAVIS clips, videos or Dycheck sequences and
writes each one's panel video and 4D point clouds (`run_sequence`). The
panel video needs cv2; `--device cpu` runs the plain versions of the
kernels, for tests.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Sequence

import numpy as np

from l4p_tpu_torch.config import L4PConfig


def synthetic_batch(cfg: L4PConfig, frames: int = 24, queries: int = 32) -> Dict[str, np.ndarray]:
    """demo.py's seeded smoke sequence (demo.py:65-86) at the model's frame
    size: uint8 frames, intrinsics with focal = width and the centre at half
    of it, queries at t = 0.5 inside an 8-pixel margin; at 224 x 224 the same
    bytes as demo.py's."""
    h, w = cfg.window_size[1:]
    rng = np.random.default_rng(0)
    k = np.tile(np.diag([float(w), float(h), 1, 1]).astype(np.float32)[None, :, :, None], (1, 1, 1, frames))
    k[:, 0, 2], k[:, 1, 2] = w / 2, h / 2
    q = np.stack([np.zeros(queries) + 0.5, rng.uniform(8, w - 8, queries), rng.uniform(8, h - 8, queries)], -1)
    u8 = rng.integers(0, 256, (1, frames, h, w, 3), dtype=np.uint8)
    return {
        "rgb_u8_bthw3": u8,
        "rgb_b3thw": (u8.transpose(0, 4, 1, 2, 3) / 255.0).astype(np.float32),
        "intrinsics_b44t": k,
        "track_2d_pointquerries_bn3": q[None].astype(np.float32),
        "track_2d_pointlabels_bn": np.ones((1, queries), np.float32),
        "rgb_mean_b3111": np.zeros((1, 3, 1, 1, 1), np.float32),
        "rgb_std_b3111": np.ones((1, 3, 1, 1, 1), np.float32),
    }


def dataset_kwargs(cfg: L4PConfig) -> dict:
    """The sources' resize and sample sizes at the model's window geometry."""
    t, h, w = cfg.window_size
    return dict(resize_size=(h, w), sample_size=(t, h, w), length_multiply_of=cfg.window_stride_t)


def main(argv: Sequence[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/model.yaml")
    ap.add_argument("--ckpt", default=None, help="released Lightning .ckpt (strict load)")
    ap.add_argument("--video", nargs="*", default=None)
    # dataset roots default to L4P_DAVIS_ROOT / L4P_DYCHECK_ROOT, as demo.py reads them
    ap.add_argument("--davis-root", default=os.environ.get("L4P_DAVIS_ROOT"))
    ap.add_argument("--dycheck-root", default=os.environ.get("L4P_DYCHECK_ROOT"))
    ap.add_argument("--seq", nargs="*", default=None, help="filter sequence names")
    ap.add_argument("--out-dir", default="out")
    ap.add_argument("--max-queries", type=int, default=128)
    ap.add_argument("--tasks", default=None, help="defaults to the config's task list")
    ap.add_argument("--synthetic", action="store_true", help="random-video smoke run")
    ap.add_argument("--stream", action="store_true",
                    help="frames through StreamingL4P one window-stride at a time (online mode)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from l4p_tpu_torch.checkpoint import prepare_model
    from l4p_tpu_torch.data.dataset import collate
    from l4p_tpu_torch.data.sources import DavisDataset, DycheckDataset, VideoDataset
    from l4p_tpu_torch.inference import run_sequence

    model, cfg, tasks = prepare_model(args.config, args.ckpt, max_queries=args.max_queries, device=args.device)
    if args.tasks:
        tasks = tuple(args.tasks.split(","))
    if args.ckpt is None:
        print("WARNING: no checkpoint given, running with random weights")

    kw = dataset_kwargs(cfg)
    datasets = []
    if args.video:
        datasets.append(VideoDataset(args.video, **kw))
    if args.davis_root:
        datasets.append(DavisDataset(args.davis_root, **kw))
    if args.dycheck_root:
        datasets.append(DycheckDataset(args.dycheck_root, **kw))

    def run(batch, seq):
        run_sequence(model, cfg, tasks, batch, args.out_dir, seq, device=args.device, stream=args.stream)

    if args.synthetic or not datasets:
        print("Running the synthetic smoke sequence (24 frames)")
        run(synthetic_batch(cfg), "synthetic")
        return 0
    for ds in datasets:
        names = getattr(ds, "scene_list", None) or getattr(ds, "video_paths", None) or getattr(ds, "seq_list", None)
        for i in range(len(ds)):
            # filter on the name before decoding the sequence
            if args.seq and not any(s in os.path.basename(str(names[i])) for s in args.seq):
                continue
            sample = ds[i]
            seq = sample.get("seq_name", f"seq{i}")
            if args.seq and not any(s in seq for s in args.seq):
                continue
            run(collate(sample), seq)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
