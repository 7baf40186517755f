"""Trilinear resize (l4p_tpu/ops/resize.py:95-125) and the per-axis
interpolation matrix (l4p_tpu/ops/resize.py:21-48).

The JAX package builds per-axis interpolation matrices because
jax.image.resize has no align_corners=True mode; F.interpolate has both
modes, and given the explicit output size it computes the same sampling
positions. `interp_matrix` is kept for the track head's exact column means.

`interpolate_trilinear` launches ``csrc/resize.cu`` for CUDA tensors: a
hand-written kernel that replaces no TPU kernel (the source's header says
why it exists, what bounds it and how the design answers that) and equals
F.interpolate bit for bit, in the memory format F.interpolate keeps (the DPT
trunk's tensors are channels_last_3d). On the CPU it runs F.interpolate, the
plain version (`_build.route`), and never falls back from the kernel,
through `TrilinearFunction`, whose backward recomputes the plain version
(ops/recompute.py). `interpolate_bilinear` is the same kernel on 2D
images as a depth-1 volume (VGGT's DPT heads).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from l4p_tpu_torch import _build
from l4p_tpu_torch.ops.recompute import recomputing_function

NAME = "resize"
SOURCES = ("resize.cu",)
KERNELS = {dtype: _build.kernel(NAME, SOURCES, f"l4p_resize_trilinear_{suffix}", "pp" + "i" * 9 + "p")
           for dtype, suffix in ((torch.bfloat16, "bf16"), (torch.float32, "f32"))}


def interp_matrix(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """(n_out, n_in) float32 linear-interpolation matrix with
    F.interpolate's source positions (the source index clamps at 0)."""
    if n_out == n_in:
        return np.eye(n_in, dtype=np.float32)
    dst = np.arange(n_out, dtype=np.float64)
    if align_corners:
        src = dst * (n_in - 1) / max(n_out - 1, 1) if n_out > 1 else np.zeros_like(dst)
    else:
        src = np.maximum((dst + 0.5) * (n_in / n_out) - 0.5, 0.0)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    w1 = (src - np.floor(src)).astype(np.float32).astype(np.float64)
    m = np.zeros((n_out, n_in), dtype=np.float64)
    m[np.arange(n_out), i0] += 1.0 - w1
    m[np.arange(n_out), i1] += w1
    return m.astype(np.float32)


def interpolate_trilinear_plain(x: torch.Tensor, size: Tuple[int, int, int], align_corners: bool) -> torch.Tensor:
    return F.interpolate(x, size=size, mode="trilinear", align_corners=align_corners)


def _forward(size: Tuple[int, int, int], align_corners: bool, x: torch.Tensor) -> torch.Tensor:
    if _build.route("interpolate_trilinear", x) == "plain":
        return interpolate_trilinear_plain(x, size, align_corners)
    if x.dtype not in KERNELS:
        raise TypeError(f"interpolate_trilinear: the kernel takes bf16 or fp32, got {x.dtype}")
    if x.dim() != 5:
        raise ValueError(f"interpolate_trilinear: x must be (B, C, T, H, W), got {tuple(x.shape)}")
    b, c = x.shape[:2]
    # the kernel reads (N, T, H, W, C): channels_last_3d as it is (the DPT trunk's convs hand that over, and
    # F.interpolate keeps it), NCDHW as C = 1 and N the planes
    if x.is_contiguous():
        n, ch, fmt = b * c, 1, torch.contiguous_format
    elif x.is_contiguous(memory_format=torch.channels_last_3d):
        n, ch, fmt = b, c, torch.channels_last_3d
    else:
        raise ValueError("interpolate_trilinear: x must be contiguous, NCDHW or channels_last_3d")
    out = torch.empty((b, c, *size), device=x.device, dtype=x.dtype, memory_format=fmt)
    _build.launch(interpolate_trilinear, KERNELS[x.dtype], x.device, x.data_ptr(), out.data_ptr(), n, ch,
                  *x.shape[2:], *size, int(align_corners))
    return out


TrilinearFunction = recomputing_function(
    "TrilinearFunction", _forward, lambda size, align_corners, x: interpolate_trilinear_plain(x, size, align_corners),
    consts=2)


def interpolate_trilinear(x: torch.Tensor, size: Sequence[int], align_corners: bool = False) -> torch.Tensor:
    """x: (B, C, T, H, W) -> (B, C, *size); F.interpolate(mode='trilinear')."""
    size = tuple(int(s) for s in size)
    if tuple(x.shape[-3:]) == size and x.dim() == 5:
        return x
    return TrilinearFunction.apply(size, bool(align_corners), x)


interpolate_trilinear.launches = 0  # kernel launches since the last reset


def interpolate_bilinear(x: torch.Tensor, size: Sequence[int], align_corners: bool = False) -> torch.Tensor:
    """x: (B, C, H, W) -> (B, C, *size), F.interpolate(mode='bilinear'): a
    trilinear resize of depth 1, which weighs the one plane by 1. A
    channels_last x is a channels_last_3d volume once unsqueezed, so it
    keeps its layout."""
    return interpolate_trilinear(x.unsqueeze(2), (1, *size), align_corners).squeeze(2)


def interpolate_scale(x: torch.Tensor, scale_factor: Sequence[float], align_corners: bool = True) -> torch.Tensor:
    """Scale-factor form over (T, H, W): output size floor(in * scale), as
    torch computes it, then resized at that explicit size."""
    return interpolate_trilinear(x, scaled_size(x.shape[-3:], scale_factor), align_corners)


def scaled_size(shape: Sequence[int], scale_factor: Sequence[float]) -> List[int]:
    """floor(n * s) per axis: the output size torch's scale-factor form gives."""
    return [int(math.floor(n * s)) for n, s in zip(shape, scale_factor)]
