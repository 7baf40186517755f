"""l4p_tpu_torch: the PyTorch/CUDA port of l4p_tpu for NVIDIA Hopper.

The port serves every task of the JAX session: the dense tasks (backward
flow, depth, dynamic mask), camray poses and intrinsics with the joint
depth + camray Sim(3) stitch, and point tracks. The ViT-giant encoder runs
its attention on a hand-written CUDA kernel (ops/flash_attention.py,
csrc/flash_attention.cu) or, with `encoder.fused_encoder`, all its blocks on
the whole-encoder kernels (ops/fused_encoder.py, csrc/fused_encoder.cu);
then the DPT heads, the camera solve and the window stitching, and the
SAM-style track head whose two-way transformer and mask decoder stream the
per-query image tokens through three more kernels (ops/fused_keys.py,
ops/fused_upscale.py). The same session serves VGGT-1B (models/vggt.py):
cameras, depth and world points from alternating frame and global attention
on the attention and resize kernels, each block's q/k LayerNorm and 2D RoPE
on one more (ops/qk_norm_rope.py). Every kernel is built, bound and
launched through _build.py. Besides the session: the model factory
(`prepare_model`, `load_video_encoder_ckpt`), backward and bidirectional
tracking (`track_bidirectional`, or `estimation_directions` in the session),
one unstitched window (`forward_single_window`), online serving
(`StreamingL4P`) and bench.py's measurement (`python3 -m
l4p_tpu_torch.bench`). The artefact-writing entry points run a video end to
end: `run_sequence` (panel video and 4D PLYs, utils/vis.py), the demo
(`python3 -m l4p_tpu_torch.demo`), the CLI's predict (`python3 -m
l4p_tpu_torch.main predict`), the numpy data pipeline (data/), the host
preprocessing library (native/) and streaming latency (`python3 -m
l4p_tpu_torch.stream_bench`). Evaluation: the metrics of the five tasks
(`metrics.l4p_metrics`), `Trainer.validate` (trainer.py; the CLI's validate
and test) and the five-config protocol (`python3 -m
l4p_tpu_torch.eval_protocol`). Training: the multi-task loss, the
trainable parameters, AdamW with the one-cycle schedule and stochastic
depth (train.py), `Trainer.fit` / `save` / `restore` and the CLI's fit;
each kernel's backward recomputes its plain version (ops/recompute.py).
VideoMAE pretraining: the masked autoencoder (models/mae.py), AdamW with
warmup-cosine or Adafactor (train.py) and its CLI (`python3 -m
l4p_tpu_torch.pretrain_mae`), whose encoder checkpoint
`load_video_encoder_ckpt` overlays. The encoder's option branches (cosine
attention, LayerScale, learnable positions, the Plucker camera embedding)
read from the same YAML keys as the JAX package's. It imports torch and
never jax or the JAX package (l4p_tpu/).
"""

from l4p_tpu_torch.checkpoint import load_video_encoder_ckpt, mae_params_from_jax, params_from_jax, prepare_model
from l4p_tpu_torch.config import (
    GIANT,
    DenseHeadConfig,
    DPTConfig,
    EncoderConfig,
    L4PConfig,
    SamConfig,
    TrackConfig,
    default_dense_heads,
    load_model_config,
)
from l4p_tpu_torch.inference import ALL_TASKS, DENSE_TASKS, SLICE_TASKS, InferenceSession, run_sequence
from l4p_tpu_torch.metrics import l4p_metrics
from l4p_tpu_torch.models.l4p import L4P, Draws, RandomDraws, forward_single_window, track_bidirectional
from l4p_tpu_torch.models.mae import MAE, MAEConfig, mae_pretrain_loss, mae_registry, tube_mask_indices
from l4p_tpu_torch.models.sam import KERNELS, PLAIN, TrackKernels
from l4p_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from l4p_tpu_torch.ops.fused_encoder import fused_encoder_blocks, fused_encoder_blocks_plain
from l4p_tpu_torch.ops.fused_keys import i2t_ln_t2i, i2t_ln_t2i_plain, t2i_flash, t2i_flash_plain
from l4p_tpu_torch.ops.fused_upscale import fused_upscale_hypernet, fused_upscale_hypernet_plain
from l4p_tpu_torch.streaming import StreamingL4P, assemble_emissions
from l4p_tpu_torch.trainer import Trainer, TrainerConfig

__all__ = [
    "ALL_TASKS", "DENSE_TASKS", "GIANT", "KERNELS", "PLAIN", "DPTConfig", "DenseHeadConfig", "Draws", "EncoderConfig",
    "InferenceSession", "L4P", "L4PConfig", "MAE", "MAEConfig", "RandomDraws", "SLICE_TASKS", "SamConfig", "StreamingL4P", "TrackConfig",
    "TrackKernels", "Trainer", "TrainerConfig", "assemble_emissions", "default_dense_heads", "flash_attention",
    "flash_attention_plain", "forward_single_window", "fused_encoder_blocks", "fused_encoder_blocks_plain",
    "fused_upscale_hypernet", "fused_upscale_hypernet_plain", "i2t_ln_t2i", "i2t_ln_t2i_plain", "l4p_metrics",
    "load_model_config", "load_video_encoder_ckpt", "mae_params_from_jax", "mae_pretrain_loss", "mae_registry",
    "params_from_jax", "prepare_model", "run_sequence", "t2i_flash",
    "t2i_flash_plain", "track_bidirectional", "tube_mask_indices",
]
