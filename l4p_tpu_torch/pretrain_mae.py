"""VideoMAE pretraining CLI (counterpart of scripts/pretrain_mae.py): the
stage that produces the encoder the L4P heads are finetuned on.

    python3 -m l4p_tpu_torch.pretrain_mae --size giant --steps 100 --batch 2
    python3 -m l4p_tpu_torch.pretrain_mae --size giant --adafactor
    python3 -m l4p_tpu_torch.pretrain_mae --size tiny --steps 3 --device cpu --fp32

Tube masking at `--mask-ratio` shared across tubelet steps, the MSE on
per-tubelet normalised pixels (models/mae.py), the global-norm clip and
AdamW on warmup-cosine (or Adafactor; train.py), on clips under
`--video-root` or seeded synthetic batches. Logs `scalars.jsonl` records
(`step`, `loss`, `s_per_step`) as the JAX script does, and saves the
encoder as `<out-dir>/ckpt.pt`: its state dict under upstream MAE's
`encoder.` prefix, which `load_video_encoder_ckpt` of either package
overlays on an L4P encoder (config key `video_encoder_ckpt_path`).

Where it departs from the JAX script: `--device` (default cuda) in place of
`--cpu`; bf16 by default (`--fp32` turns it off, on the CPU only: the
attention kernel takes bf16); no `--remat` (JAX's sets a field its blocks
never read: ROADMAP.md section 3); a torch file in place of an orbax
directory.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Iterator, Mapping, Sequence

import numpy as np
import torch

from l4p_tpu_torch.config import EncoderConfig
from l4p_tpu_torch.models.encoder import AttentionFn
from l4p_tpu_torch.models.mae import MAE, MAEConfig, mae_pretrain_loss, mae_registry, tube_mask_indices
from l4p_tpu_torch.ops.flash_attention import flash_attention
from l4p_tpu_torch.train import Adafactor, make_mae_optimizer, warmup_cosine_decay_schedule

VIDEO_EXTENSIONS = (".mp4", ".avi", ".mov", ".webm")


def mae_config(size: str) -> MAEConfig:
    """mae_registry(size), or the JAX script's 'tiny' config (28 x 28, 4 frames)."""
    if size != "tiny":
        return mae_registry(size)
    enc = EncoderConfig(img_size=28, patch_size=14, embed_dim=64, depth=2, num_heads=4, mlp_ratio=4.0, all_frames=4)
    return MAEConfig(encoder=enc, decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2,
                     decoder_num_classes=3 * 2 * 14 * 14)


def synthetic_batches(cfg_enc: EncoderConfig, batch: int, seed: int = 0) -> Iterator[np.ndarray]:
    """N(0, 1) float32 videos (B, 3, frames, img, img) from default_rng(seed):
    the JAX script's stream."""
    rng = np.random.default_rng(seed)
    shape = (batch, 3, cfg_enc.all_frames, cfg_enc.img_size, cfg_enc.img_size)
    while True:
        yield rng.standard_normal(shape).astype(np.float32)


def video_batches(root: str, cfg_enc: EncoderConfig, batch: int, seed: int = 0) -> Iterator[np.ndarray]:
    """Random crops of `cfg_enc.all_frames` frames from the clips under
    `root` (B, 3, frames, img, img), ImageNet-normalised as the finetuning
    pipeline normalises them (data/dataset.py), each clip resized to the
    encoder's image size and mirror-padded to at least `frames` frames;
    clips and start frames from default_rng(seed). (The JAX script indexes
    its sample's channel 0 as if it were the video and cannot batch it.)"""
    from l4p_tpu_torch.data.sources import VideoDataset

    paths = sorted(os.path.join(root, f) for f in os.listdir(root) if f.lower().endswith(VIDEO_EXTENSIONS))
    if not paths:
        raise FileNotFoundError(f"no {'/'.join(VIDEO_EXTENSIONS)} clips under {root}")
    t_need, size = cfg_enc.all_frames, (cfg_enc.img_size, cfg_enc.img_size)
    ds = VideoDataset(paths, crop_size=None, resize_size=size, sample_size=(t_need, *size), length_multiply_of=1)
    rng = np.random.default_rng(seed)
    while True:
        clips = []
        for _ in range(batch):
            vid = ds[int(rng.integers(len(ds)))]["rgb_b3thw"]  # (3, T, H, W), T >= t_need
            t0 = int(rng.integers(vid.shape[1] - t_need + 1))
            clips.append(vid[:, t0:t0 + t_need])
        yield np.stack(clips).astype(np.float32)


def pretrain_step(model: MAE, optimizer, x: torch.Tensor, visible_idx: torch.Tensor, masked_idx: torch.Tensor,
                  attention: AttentionFn = flash_attention) -> torch.Tensor:
    """One optimization step (the JAX script's jitted `step`): the loss on
    x's masked tubelets, its gradients for the optimizer's parameters, one
    update in place. Returns the loss, detached."""
    loss = mae_pretrain_loss(model, x, visible_idx, masked_idx, attention=attention)
    grads = torch.autograd.grad(loss, list(optimizer.params.values()), allow_unused=True)
    optimizer.step(grads)
    return loss.detach()


def encoder_checkpoint(model: MAE) -> Mapping[str, torch.Tensor]:
    """The encoder's state dict under the `encoder.` prefix, on the CPU and in
    fp32: the JAX package's torch branch reads it through numpy, which has
    no bf16."""
    return {f"encoder.{k}": v.to("cpu", torch.float32) for k, v in model.encoder.state_dict().items()}


def main(argv: Sequence[str] = None) -> int:
    ap = argparse.ArgumentParser(prog="l4p_tpu_torch.pretrain_mae")
    ap.add_argument("--size", default="small", help="mae_registry size or 'tiny'")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1.5e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--mask-ratio", type=float, default=0.9)
    ap.add_argument("--video-root", default=None, help="directory of clips; synthetic if absent")
    ap.add_argument("--out-dir", default="runs/mae_pretrain_torch")
    ap.add_argument("--adafactor", action="store_true", help="factored second moments in place of AdamW's")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fp32", action="store_true", help="fp32 weights and compute (CPU only) in place of bf16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    if device.type == "cuda" and dtype != torch.bfloat16:
        ap.error("--fp32 on a CUDA device: the attention kernel (l4p_tpu_torch/ops/flash_attention.py) takes bf16 "
                 "only; drop --fp32, or pass --device cpu")
    cfg = mae_config(args.size)
    model = MAE(cfg, device=device, dtype=dtype)
    model.init_weights(torch.Generator(device=device).manual_seed(0))
    params = dict(model.named_parameters())
    if args.adafactor:
        optimizer = Adafactor(params, warmup_cosine_decay_schedule(0.0, args.lr, max(args.warmup, 1),
                                                                   max(args.steps, args.warmup + 1)))
    else:
        optimizer = make_mae_optimizer(params, args.lr, args.steps, args.warmup)
    batches = (video_batches(args.video_root, cfg.encoder, args.batch) if args.video_root
               else synthetic_batches(cfg.encoder, args.batch))
    masks = torch.Generator().manual_seed(1)

    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.time()
    with open(os.path.join(args.out_dir, "scalars.jsonl"), "a") as log:
        for i in range(args.steps):
            visible_idx, masked_idx = tube_mask_indices(masks, cfg.encoder, args.batch, args.mask_ratio)
            x = torch.as_tensor(next(batches), device=device).to(dtype)
            loss = pretrain_step(model, optimizer, x, visible_idx.to(device), masked_idx.to(device))
            if i % args.log_every == 0 or i == args.steps - 1:
                rec = {"step": i, "loss": round(loss.item(), 5), "s_per_step": round((time.time() - t0) / (i + 1), 3)}
                log.write(json.dumps(rec) + "\n")
                log.flush()
                print(json.dumps(rec), flush=True)

    path = os.path.abspath(os.path.join(args.out_dir, "ckpt.pt"))
    torch.save(encoder_checkpoint(model), path)
    print(f"saved encoder checkpoint -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
