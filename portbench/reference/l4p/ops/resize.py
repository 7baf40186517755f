"""Trilinear resize (l4p_tpu/ops/resize.py:95-125) and the per-axis
interpolation matrix (l4p_tpu/ops/resize.py:21-48).

The JAX package builds per-axis interpolation matrices because
jax.image.resize has no align_corners=True mode; F.interpolate has both
modes, and given the explicit output size it computes the same sampling
positions. `interp_matrix` is kept for the track head's exact column means.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


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


def interpolate_trilinear(x: torch.Tensor, size: Sequence[int], align_corners: bool = False) -> torch.Tensor:
    """x: (B, C, T, H, W) -> (B, C, *size); F.interpolate(mode='trilinear')."""
    size = tuple(int(s) for s in size)
    if tuple(x.shape[-3:]) == size:
        return x
    return F.interpolate(x, size=size, mode="trilinear", align_corners=align_corners)


def interpolate_scale(x: torch.Tensor, scale_factor: Sequence[float], align_corners: bool = True) -> torch.Tensor:
    """Scale-factor form over (T, H, W): output size floor(in * scale), as
    torch computes it, then resized at that explicit size."""
    size = [int(math.floor(n * s)) for n, s in zip(x.shape[-3:], scale_factor)]
    return interpolate_trilinear(x, size, align_corners)
