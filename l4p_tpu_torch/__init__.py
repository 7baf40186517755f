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
ops/fused_upscale.py). It imports torch and never jax or l4p_tpu.
"""

from l4p_tpu_torch.checkpoint import params_from_jax
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
from l4p_tpu_torch.inference import ALL_TASKS, DENSE_TASKS, SLICE_TASKS, InferenceSession
from l4p_tpu_torch.models.l4p import L4P, Draws, RandomDraws
from l4p_tpu_torch.models.sam import KERNELS, PLAIN, TrackKernels
from l4p_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from l4p_tpu_torch.ops.fused_encoder import fused_encoder_blocks, fused_encoder_blocks_plain
from l4p_tpu_torch.ops.fused_keys import i2t_ln_t2i, i2t_ln_t2i_plain, t2i_flash, t2i_flash_plain
from l4p_tpu_torch.ops.fused_upscale import fused_upscale_hypernet, fused_upscale_hypernet_plain

__all__ = [
    "ALL_TASKS", "DENSE_TASKS", "GIANT", "KERNELS", "PLAIN", "DPTConfig", "DenseHeadConfig", "Draws", "EncoderConfig",
    "InferenceSession", "L4P", "L4PConfig", "RandomDraws", "SLICE_TASKS", "SamConfig", "TrackConfig", "TrackKernels",
    "default_dense_heads", "flash_attention", "flash_attention_plain", "fused_encoder_blocks",
    "fused_encoder_blocks_plain", "fused_upscale_hypernet", "fused_upscale_hypernet_plain", "i2t_ln_t2i",
    "i2t_ln_t2i_plain", "load_model_config", "params_from_jax", "t2i_flash", "t2i_flash_plain",
]
