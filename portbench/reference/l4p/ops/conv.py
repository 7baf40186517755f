"""Conv3d / ConvTranspose3d / Linear / LayerNorm / GELU with the JAX package's
dtype policy (l4p_tpu/ops/conv.py). Weights are in torch layout, tensors NCDHW.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from portbench.reference.l4p.ops.lowp import q8

IntOr3 = Union[int, Sequence[int]]


def conv3d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: IntOr3 = 1, padding: IntOr3 = 0) -> torch.Tensor:
    """x: (B, Cin, D, H, W); w: (Cout, Cin, kD, kH, kW). Computes in x's dtype."""
    return F.conv3d(q8(x), q8(w.to(x.dtype)), None if b is None else b.to(x.dtype), stride=stride, padding=padding)


def conv_transpose3d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                     stride: IntOr3 = 1, padding: IntOr3 = 0) -> torch.Tensor:
    """torch.nn.ConvTranspose3d semantics; w: (Cin, Cout, kD, kH, kW)."""
    return F.conv_transpose3d(
        q8(x), q8(w.to(x.dtype)), None if b is None else b.to(x.dtype), stride=stride, padding=padding
    )


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (..., in); w: (out, in)."""
    return F.linear(q8(x), q8(w.to(x.dtype)), None if b is None else b.to(x.dtype))


class _LinearFp32(torch.autograd.Function):
    """x w^T of bf16 / fp16 operands with the fp32 accumulator as the
    result; the backward takes the fp32 cotangent back to the operands'
    dtype before its products."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        if x.is_cuda:
            y = torch.mm(x2, w.t(), out_dtype=torch.float32)
        else:
            y = torch.mm(x2.float(), w.float().t())
        return y.view(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.to(x.dtype).reshape(-1, w.shape[0])
        gx = (g @ w).view_as(x) if ctx.needs_input_grad[0] else None
        gw = (g.t() @ x.reshape(-1, x.shape[-1])) if ctx.needs_input_grad[1] else None
        return gx, gw


def linear_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., in); w: (out, in) -> x w^T in fp32, no bias: the products of
    the compute dtype accumulated in fp32 and returned so (JAX's
    preferred_element_type=float32)."""
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        return F.linear(q8(x), q8(w))
    return _LinearFp32.apply(x, w)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics and affine, cast back."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU in fp32 and above, the tanh approximation in bf16
    (the JAX package's policy, l4p_tpu/ops/conv.py:107-120)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")
