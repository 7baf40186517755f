"""Multi-GPU dry run of the port (the analog of
`__graft_entry__.dryrun_multichip`, :48-192): one training step over a
(data, model) mesh, data parallel over the batch and tensor parallel over
the encoder, then window-sharded uint8 inference of every task, on a tiny
model with the flagship's structure (four dense heads, variable-K camray,
bidirectional tracks).

    torchrun --standalone --nproc_per_node=N -m l4p_tpu_torch.parallel.dryrun [--device cuda|cpu]

One process per rank; the mesh is (N / 2, 2) for an even N, else (N, 1).
The backend is NCCL on cuda and gloo on the CPU (`--backend` picks another:
gloo reduces CUDA tensors too, which lets several ranks share one card). On
cuda the model is bf16 on the kernels, on the CPU fp32 on their plain
versions. Rank 0 prints one line: the mesh, the loss and each task's loss,
and the frame count of the inference; any non-finite value fails the run.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from l4p_tpu_torch.config import DenseHeadConfig, DPTConfig, EncoderConfig, L4PConfig, SamConfig, TrackConfig
from l4p_tpu_torch.inference import InferenceSession
from l4p_tpu_torch.models.l4p import L4P
from l4p_tpu_torch.parallel.mesh import DATA, MODEL, axis_size, make_mesh, shard_params
from l4p_tpu_torch.train import make_optimizer, train_step

TASKS = ("flow_2d_backward", "track_2d", "depth", "dyn_mask", "camray")
HOOKS = (1, 2, 3, 4)
QUERIES = 4


def dryrun_config() -> L4PConfig:
    """dryrun_multichip's model: a 4-block encoder of width 64 and 4 heads
    whose MLP width (256) splits over a model axis of 2, the four dense
    heads (camray with per-frame K), bidirectional tracking."""
    enc = EncoderConfig(img_size=28, patch_size=14, embed_dim=64, depth=4, num_heads=4, all_frames=4, mlp_ratio=4.0)
    dpt_kw = dict(layer_dims=(8, 8, 16, 16), feature_dim=8, last_dim=8, dim_tokens=64)
    # the JAX DenseHeadConfig's defaults, which dryrun_multichip's heads keep (l4p_tpu/models/l4p.py:55-60)
    head_kw = dict(depth_fn="exp", mask_fn="linear", align_pre_inverse=True, use_intrinsics=False)
    heads = (
        ("flow_2d_backward", DenseHeadConfig(task_name="flow_2d_backward", kind="flow", out_nchan=2,
                                             dpt=DPTConfig(num_channels=2, hooks=HOOKS, **dpt_kw),
                                             fixed_intrinsics=True, **head_kw)),
        ("depth", DenseHeadConfig(task_name="depth", kind="depth", out_nchan=1,
                                  dpt=DPTConfig(num_channels=1, hooks=HOOKS, **dpt_kw), fixed_intrinsics=True,
                                  **head_kw)),
        ("dyn_mask", DenseHeadConfig(task_name="dyn_mask", kind="dyn_mask", out_nchan=1,
                                     dpt=DPTConfig(num_channels=1, hooks=HOOKS, **dpt_kw), fixed_intrinsics=True,
                                     **head_kw)),
        ("camray", DenseHeadConfig(task_name="traj3d", kind="camray", out_nchan=6, fixed_intrinsics=False,
                                   **head_kw,
                                   dpt=DPTConfig(num_channels=6, hooks=HOOKS,
                                                 actpost_scale_factors=((1, 0, 0), (1, 0, 0), (0, 0, 0), (-1, -1, -1)),
                                                 fusion_scale_factors=((1, 1, 1), (1, 1, 1), (2, 1, 1), (2, 2, 2)),
                                                 output_size=(4, 2, 2), **dpt_kw))),
    )
    track = TrackConfig(image_size=(4, 28, 28),
                        sam=SamConfig(embed_dim=64, image_embedding_size=(2, 2, 2), input_image_size=(4, 28, 28)),
                        max_queries=8, estimation_directions=(1, -1))
    return L4PConfig(encoder=enc, window_size=(4, 28, 28), window_stride_t=2, joint_alignment=True, heads=heads,
                     track=track)


def intrinsics(b: int, t: int) -> np.ndarray:
    k = np.tile(np.diag([30.0, 30.0, 1, 1]).astype(np.float32)[None, :, :, None], (b, 1, 1, t))
    k[:, 0, 2] = k[:, 1, 2] = 14.0
    return k


def train_batch(b: int, t: int = 4, n_q: int = QUERIES, seed: int = 0) -> Dict[str, np.ndarray]:
    """dryrun_multichip's batch: b clips of one window with every task's ground truth."""
    rng = np.random.default_rng(seed)
    return {
        "rgb_b3thw": rng.standard_normal((b, 3, t, 28, 28)).astype(np.float32),
        "intrinsics_b44t": intrinsics(b, t),
        "extrinsics_b44t": np.tile(np.eye(4, dtype=np.float32)[None, :, :, None], (b, 1, 1, t)),
        "depth_b1thw": rng.uniform(1, 5, (b, 1, t, 28, 28)).astype(np.float32),
        "flow_2d_backward_b2thw": rng.standard_normal((b, 2, t, 28, 28)).astype(np.float32),
        "dyn_mask_b1thw": (rng.uniform(size=(b, 1, t, 28, 28)) > 0.5).astype(np.float32),
        "track_2d_pointquerries_bn3": np.stack(
            [rng.uniform(0, t, (b, n_q)), rng.uniform(0, 28, (b, n_q)), rng.uniform(0, 28, (b, n_q))], -1
        ).astype(np.float32),
        "track_2d_pointlabels_bn": np.ones((b, n_q), np.float32),
        "track_2d_traj_bn2t": rng.uniform(0, 28, (b, n_q, 2, t)).astype(np.float32),
        "track_2d_vis_bn1t": np.ones((b, n_q, 1, t), np.float32),
        "track_2d_depth_bn1t": rng.uniform(1, 5, (b, n_q, 1, t)).astype(np.float32),
        "track_2d_valid_bn1t": np.ones((b, n_q, 1, t), np.float32),
    }


def inference_request(t: int, n_q: int = QUERIES, seed: int = 1) -> Dict[str, np.ndarray]:
    """uint8 frames over t frames, their intrinsics and n_q queries at the first frame."""
    rng = np.random.default_rng(seed)
    return {
        "rgb_u8_bthw3": rng.integers(0, 256, (1, t, 28, 28, 3)).astype(np.uint8),
        "intrinsics_b44t": intrinsics(1, t),
        "track_2d_pointquerries_bn3": np.stack(
            [np.zeros((1, n_q)) + 0.5, rng.uniform(4, 24, (1, n_q)), rng.uniform(4, 24, (1, n_q))], -1
        ).astype(np.float32),
        "track_2d_pointlabels_bn": np.ones((1, n_q), np.float32),
    }


def dryrun(device: str, backend: Optional[str] = None) -> str:
    """The summary line of one training step and one window-sharded request
    on this rank of the job (torchrun's environment)."""
    dev = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    mesh = make_mesh(n_model=2 if world % 2 == 0 else 1, device=dev, backend=backend)
    nd, nm = axis_size(mesh, DATA), axis_size(mesh, MODEL)
    cfg = dryrun_config()
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model = L4P(cfg, device=dev, dtype=dtype)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))  # the same weights on every rank
    shard_params(model, mesh)
    optimizer = make_optimizer(model, total_steps=10)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in train_batch(nd).items()}
    batch["rgb_b3thw"] = batch["rgb_b3thw"].to(dtype)
    loss, losses = train_step(model, optimizer, batch, cfg, TASKS, mesh=mesh)
    loss_val = float(loss)
    if not math.isfinite(loss_val):
        raise RuntimeError(f"non-finite training loss {loss_val}")

    t_inf = 2 * (nd * 2) + 2  # 2 nd windows at stride 2
    data = {k: torch.as_tensor(v, device=dev) for k, v in inference_request(t_inf).items()}
    out = InferenceSession(cfg, TASKS, dev, mesh=mesh)(model.eval(), data)
    bad = [k for k, v in out.items() if not bool(torch.isfinite(v.float()).all())]
    if bad:
        raise RuntimeError(f"non-finite inference outputs {bad}")
    return (f"dryrun OK: mesh={{'data': {nd}, 'model': {nm}}} loss={loss_val:.4f} "
            + " ".join(f"{k}={float(v):.4f}" for k, v in losses.items())
            + f" | sharded inference over {t_inf} frames OK")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the process group's backend (default: nccl on cuda, gloo on cpu)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun: --device cuda needs a CUDA card; pass --device cpu", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    try:
        line = dryrun(args.device, args.backend)
        if dist.get_rank() == 0:
            print(line, flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
