"""Conv3d / ConvTranspose3d / Linear / LayerNorm / GELU with the JAX package's
dtype policy (l4p_tpu/ops/conv.py). Weights are in torch layout, tensors NCDHW.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

IntOr3 = Union[int, Sequence[int]]


def conv3d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: IntOr3 = 1, padding: IntOr3 = 0) -> torch.Tensor:
    """x: (B, Cin, D, H, W); w: (Cout, Cin, kD, kH, kW). Computes in x's dtype."""
    return F.conv3d(x, w.to(x.dtype), None if b is None else b.to(x.dtype), stride=stride, padding=padding)


def conv_transpose3d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                     stride: IntOr3 = 1, padding: IntOr3 = 0) -> torch.Tensor:
    """torch.nn.ConvTranspose3d semantics; w: (Cin, Cout, kD, kH, kW)."""
    return F.conv_transpose3d(
        x, w.to(x.dtype), None if b is None else b.to(x.dtype), stride=stride, padding=padding
    )


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (..., in); w: (out, in)."""
    return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics and affine, cast back."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU in fp32 and above, the tanh approximation in bf16
    (the JAX package's policy, l4p_tpu/ops/conv.py:107-120)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")
