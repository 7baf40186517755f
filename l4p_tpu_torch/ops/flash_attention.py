"""Encoder self-attention: the hand-written Hopper kernel and its plain version.

`flash_attention` launches ``csrc/flash_attention.cu``, which replaces the
Pallas TPU kernel ``l4p_tpu/ops/flash_attention.py:_attn_kernel`` (the
source's header says what bounds it and how it is built around that). It is
built by ``nvcc`` at first use (``_build.py``). `flash_attention_plain` is the
same function in plain PyTorch (== `mha`).

For tensors on the CPU the wrapper runs the plain version; for CUDA tensors
it launches the kernel or raises, never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from l4p_tpu_torch import _build
from l4p_tpu_torch.ops.attention import mha

NAME = "flash_attention"
SOURCES = ("flash_attention.cu",)
MAX_HEAD_DIM = 128


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    return mha(q, k, v, scale)


def _kernel():
    fn = _build.load(NAME, SOURCES).l4p_flash_attention_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """q: (B, H, Nq, D), k/v: (B, H, Nk, D) -> (B, H, Nq, D): softmax(q k^T * scale) v
    with fp32 scores and softmax."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention: incompatible shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    devices = {q.device, k.device, v.device}
    if devices == {torch.device("cpu")}:
        return flash_attention_plain(q, k, v, scale)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash_attention: q, k, v must lie on one CUDA device, got {devices}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash_attention: the kernel takes bf16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if d % 8 != 0 or d > MAX_HEAD_DIM or min(b * h, nq, nk) == 0 or b * h > 65535:
        raise ValueError(f"flash_attention: unsupported shape q{tuple(q.shape)} k{tuple(k.shape)}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be 16-byte aligned")
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * h, nq, nk, d, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {err}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0  # kernel launches since the last reset
