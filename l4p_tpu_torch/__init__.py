"""l4p_tpu_torch: the PyTorch/CUDA port of l4p_tpu for NVIDIA Hopper.

This slice serves the dense tasks (backward flow, depth, dynamic mask):
the ViT-giant encoder with its attention on a hand-written CUDA kernel
(ops/flash_attention.py, csrc/flash_attention.cu), the DPT heads and the
window stitching. It imports torch and never jax or l4p_tpu.
"""

from l4p_tpu_torch.checkpoint import params_from_jax
from l4p_tpu_torch.config import (
    GIANT,
    DenseHeadConfig,
    DPTConfig,
    EncoderConfig,
    L4PConfig,
    default_dense_heads,
    load_model_config,
)
from l4p_tpu_torch.inference import SLICE_TASKS, InferenceSession
from l4p_tpu_torch.models.l4p import L4P
from l4p_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

__all__ = [
    "GIANT", "DPTConfig", "DenseHeadConfig", "EncoderConfig", "InferenceSession", "L4P", "L4PConfig",
    "SLICE_TASKS", "default_dense_heads", "flash_attention", "flash_attention_plain", "load_model_config",
    "params_from_jax",
]
