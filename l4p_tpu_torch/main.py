"""The CLI (counterpart of l4p_tpu/main.py; reference l4p/main.py, a
LightningCLI):

    python3 -m l4p_tpu_torch.main predict  --config configs/model.yaml --video clip.mp4
    python3 -m l4p_tpu_torch.main predict  --davis-root /data/davis --stream --fp32
    python3 -m l4p_tpu_torch.main validate --config configs/model.yaml --ckpt l4p.ckpt --davis-root /data/davis
    python3 -m l4p_tpu_torch.main fit      --config configs/model.yaml --dycheck-root /data/dycheck --max-steps 1000

`predict` runs each sequence of a video list, a DAVIS root or a Dycheck root
through `run_sequence` and writes its panel video and 4D point clouds under
`--out-dir`. `validate` and `test` run the sequences through
`Trainer.validate` and log the averaged metrics under `scalars/val/...` or
`scalars/test/...` in `--out-dir/scalars.jsonl`. `fit` trains on the
sequences through `Trainer.fit` for `--max-steps` steps at peak learning
rate `--lr`, logging under `scalars/train/...` and writing `ckpt_*.pt`
into `--out-dir`; every task of the config needs its ground truth in the
samples (l4p_loss). A `.ckpt` loads strictly through
`released_state_dict`.
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
    ap.add_argument("--max-steps", type=int, default=10000)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--max-queries", type=int, default=128)
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--fp32", dest="bf16", action="store_false")
    ap.add_argument("--stream", action="store_true",
                    help="predict only: frames through StreamingL4P one window-stride at a time")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from l4p_tpu_torch.data.dataset import collate

    model, cfg, tasks = _build(args)
    ds = _dataset(args, cfg)
    if args.command in ("fit", "validate", "test"):
        from l4p_tpu_torch.trainer import Trainer, TrainerConfig

        trainer = Trainer(cfg, tasks, TrainerConfig(max_steps=args.max_steps, lr=args.lr, out_dir=args.out_dir),
                          device=args.device)
        samples = (collate(ds[i]) for i in range(len(ds)))
        if args.command == "fit":
            _, _, step = trainer.fit(model, samples)
            print(f"finished at step {step}; checkpoints in {args.out_dir}")
        else:
            print(trainer.validate(model, samples, phase="val" if args.command == "validate" else "test"))
        return 0

    from l4p_tpu_torch.inference import run_sequence

    for i in range(len(ds)):
        batch = collate(ds[i])
        seq = str(batch.get("seq_name", f"seq{i}"))
        out = run_sequence(model, cfg, tasks, batch, args.out_dir, seq, device=args.device,
                           dtype=torch.bfloat16 if args.bf16 else torch.float32, stream=args.stream)
        print(f"sample {i} ({seq}): " + ", ".join(f"{k}{list(v.shape)}" for k, v in sorted(out.items())))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
