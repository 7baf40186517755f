"""Encoder self-attention: the hand-written Hopper kernel and its plain version.

`flash_attention` launches ``csrc/flash_attention.cu``, which replaces the
Pallas TPU kernel ``l4p_tpu/ops/flash_attention.py:_attn_kernel`` with wgmma
products on tiles that TMA loads (``csrc/attention.cuh``, whose header says
what bounds it and how it is built around that). It is built by ``nvcc`` at
first use (``_build.py``). `flash_attention_plain` is the same function in
plain PyTorch (== `mha`).

The wrapper runs the plain version on the CPU and the kernel on one CUDA
device (`_build.route`, `_build.launch`), never falling back, through
`FlashAttentionFunction`, whose backward recomputes the plain version
(ops/recompute.py), as `_flash_bwd` recomputes `mha`.
"""

from __future__ import annotations

from typing import Optional

import torch

from l4p_tpu_torch import _build
from l4p_tpu_torch.ops.attention import mha
from l4p_tpu_torch.ops.recompute import recomputing_function

NAME = "flash_attention"
SOURCES = ("flash_attention.cu",)
KERNEL = _build.kernel(NAME, SOURCES, "l4p_flash_attention_fwd_bf16", "ppppiiiiifp")
MAX_HEAD_DIM = 256  # csrc/attention.cuh: D_pad 64, 96 and 128 in 128-key tiles, 256 in 64-key tiles
MAX_BH = 2 ** 31 - 65535  # csrc/attention.cuh:kMaxBH: the launcher's grid arithmetic stays inside an int


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    return mha(q, k, v, scale)


def kernel_row_pitch(d: int) -> int:
    """The elements between two q/k/v rows that the kernel loads at full rate:
    d rounded up to 16, so that every row starts on a 32-byte sector. (At
    D = 88, 176-byte rows ran 1.3x slower than 192-byte ones on an H100,
    PERF.md.) csrc/fused_encoder.cu pads its q/k/v by the same rule."""
    return -(-d // 16) * 16


def kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """x (B, H, N, D), any strides -> the same values as a view of a (B, H,
    N, kernel_row_pitch(D)) buffer: one copy, as `.contiguous()` would make,
    into the layout the kernel reads fastest. The padding is never read."""
    b, h, n, d = x.shape
    out = torch.empty((b, h, n, kernel_row_pitch(d)), device=x.device, dtype=x.dtype)[..., :d]
    return out.copy_(x)


def in_kernel_layout(t: torch.Tensor) -> bool:
    """Whether (B, H, N, D) `t` lies as `kernel_layout` puts it: rows
    kernel_row_pitch(D) elements apart, heads and batch entries one after
    the other, 16-byte aligned (as the fused encoder's q/k/v buffer does)."""
    b, h, n, d = t.shape
    p = kernel_row_pitch(d)
    return t.stride() == (h * n * p, n * p, p, 1) and t.data_ptr() % 16 == 0


def kernel_unsupported(bh: int, nq: int, nk: int, d: int) -> Optional[str]:
    """What the kernel cannot take, or None: its TMA boxes need D a multiple
    of 8 (16-byte rows) and at most MAX_HEAD_DIM, and B*H, which the grid
    spreads over its y and z, at most MAX_BH."""
    if d % 8 or d > MAX_HEAD_DIM:
        return f"head_dim {d} must be a multiple of 8 and at most {MAX_HEAD_DIM}"
    if min(bh, nq, nk) <= 0 or bh > MAX_BH:
        return f"B*H {bh} must be 1..{MAX_BH} and Nq {nq}, Nk {nk} positive"
    return None


def _forward(scale: float, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention: incompatible shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if _build.route("flash_attention", q, k, v) == "plain":
        return flash_attention_plain(q, k, v, scale)
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash_attention: the kernel takes bf16, got {q.dtype}/{k.dtype}/{v.dtype}")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    reason = kernel_unsupported(b * h, nq, nk, d)
    if reason is not None:
        raise ValueError(f"flash_attention: q{tuple(q.shape)} k{tuple(k.shape)}: {reason}")
    q, k, v = (t if in_kernel_layout(t) else kernel_layout(t) for t in (q, k, v))
    o = torch.empty((b, h, nq, d), device=q.device, dtype=q.dtype)
    _build.launch(flash_attention, KERNEL, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * h,
                  nq, nk, d, kernel_row_pitch(d), float(scale))
    return o


FlashAttentionFunction = recomputing_function(
    "FlashAttentionFunction", _forward, lambda scale, q, k, v: flash_attention_plain(q, k, v, scale), consts=1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """q: (B, H, Nq, D), k/v: (B, H, Nk, D), any strides -> (B, H, Nq, D)
    contiguous: softmax(q k^T * scale) v with fp32 scores and softmax,
    differentiable. On CUDA an operand that does not lie as `kernel_layout`
    puts it is copied so first (one copy each, where a caller would make a
    contiguous one)."""
    return FlashAttentionFunction.apply(scale, q, k, v)


flash_attention.launches = 0  # kernel launches since the last reset
