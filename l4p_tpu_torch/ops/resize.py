"""Trilinear resize with align_corners=True (l4p_tpu/ops/resize.py:95-125).

The JAX package builds per-axis interpolation matrices because
jax.image.resize has no align_corners=True mode; F.interpolate has one, and
given the explicit output size it computes the same sampling positions.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F


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
