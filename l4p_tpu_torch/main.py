"""The CLI (counterpart of l4p_tpu/main.py; reference l4p/main.py, a
LightningCLI):

    python3 -m l4p_tpu_torch.main predict --config configs/model.yaml --video clip.mp4
    python3 -m l4p_tpu_torch.main predict --davis-root /data/davis --stream --fp32

`predict` runs each sequence of a video list, a DAVIS root or a Dycheck root
through `run_sequence` and writes its panel video and 4D point clouds under
`--out-dir`. A `.ckpt` loads strictly through `released_state_dict`. `fit`,
`validate` and `test` need the training side, which is not ported yet
(ROADMAP.md, queue 1's next item).
"""

from __future__ import annotations

import argparse
from typing import Sequence

import torch


def _build(args):
    """(model, cfg, tasks) of the config, with the checkpoint's weights."""
    from l4p_tpu_torch.checkpoint import prepare_model

    if args.ckpt and not args.ckpt.endswith(".ckpt"):
        raise NotImplementedError(
            f"{args.ckpt}: orbax checkpoints (the JAX trainer's) are read by the JAX package; the port reads a "
            "Lightning .ckpt")
    return prepare_model(args.config, args.ckpt, max_queries=args.max_queries,
                         dtype=torch.bfloat16 if args.bf16 else torch.float32, device=args.device)


def _dataset(args, cfg):
    from l4p_tpu_torch.data.sources import DavisDataset, DycheckDataset, VideoDataset
    from l4p_tpu_torch.demo import dataset_kwargs

    kw = dataset_kwargs(cfg)
    if args.video:
        return VideoDataset(args.video, **kw)
    if args.davis_root:
        return DavisDataset(args.davis_root, **kw)
    if args.dycheck_root:
        return DycheckDataset(args.dycheck_root, **kw)
    raise SystemExit("provide --video/--davis-root/--dycheck-root")


def main(argv: Sequence[str] = None) -> int:
    ap = argparse.ArgumentParser(prog="l4p_tpu_torch")
    ap.add_argument("command", choices=["fit", "validate", "test", "predict"])
    ap.add_argument("--config", default="configs/model.yaml")
    ap.add_argument("--ckpt", default=None, help="released Lightning .ckpt")
    ap.add_argument("--video", nargs="*", default=None)
    ap.add_argument("--davis-root", default=None)
    ap.add_argument("--dycheck-root", default=None)
    ap.add_argument("--out-dir", default="runs/default")
    ap.add_argument("--max-queries", type=int, default=128)
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--fp32", dest="bf16", action="store_false")
    ap.add_argument("--stream", action="store_true",
                    help="predict only: frames through StreamingL4P one window-stride at a time")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.command != "predict":
        raise NotImplementedError(
            f"'{args.command}' needs the training side (losses, trainer, metrics and backward kernels), which the "
            "port does not have yet: it is the next item of ROADMAP.md's queue 1; use `python -m l4p_tpu.main`")

    from l4p_tpu_torch.data.dataset import collate
    from l4p_tpu_torch.inference import run_sequence

    model, cfg, tasks = _build(args)
    ds = _dataset(args, cfg)
    for i in range(len(ds)):
        batch = collate(ds[i])
        seq = str(batch.get("seq_name", f"seq{i}"))
        out = run_sequence(model, cfg, tasks, batch, args.out_dir, seq, device=args.device,
                           dtype=torch.bfloat16 if args.bf16 else torch.float32, stream=args.stream)
        print(f"sample {i} ({seq}): " + ", ".join(f"{k}{list(v.shape)}" for k, v in sorted(out.items())))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
