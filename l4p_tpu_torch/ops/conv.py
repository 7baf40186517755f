"""Conv3d / ConvTranspose3d / Linear / LayerNorm / GELU with the JAX package's
dtype policy (l4p_tpu/ops/conv.py), and the products it asks for in fp32
(preferred_element_type=float32): `linear_fp32`, `einsum_fp32`. Weights are
in torch layout, tensors NCDHW.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from l4p_tpu_torch import _build

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


def _mm_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16 / fp16 operands, (B, M, K) x (B, K, N) or 2-D, with the
    fp32 accumulator as the result; a 2-D operand beside a 3-D one is read
    by every batch entry at stride 0, never copied. On the card one cuBLAS
    mm / bmm with out_dtype=float32 (no TF32, no reduction in the operands'
    dtype); elsewhere, which has no such product, the same values in fp32."""
    if not a.is_cuda:
        return torch.matmul(a.float(), b.float())
    if a.dim() == b.dim() == 2:
        return torch.mm(a, b, out_dtype=torch.float32)
    batch = (a if a.dim() == 3 else b).shape[0]
    return torch.bmm(a.expand(batch, *a.shape[-2:]), b.expand(batch, *b.shape[-2:]), out_dtype=torch.float32)


def _fold(t: torch.Tensor) -> torch.Tensor:
    """(B, X, Y) -> (X, B * Y): the batch moved into the summed axis."""
    return t.transpose(0, 1).reshape(t.shape[1], -1)


class _BmmFp32(torch.autograd.Function):
    """`_mm_fp32` with a backward: the fp32 cotangent goes to the operands'
    dtype, each gradient is one `_mm_fp32` product cast to that dtype
    after it, and a shared (2-D) operand's gradient sums the batch inside
    its product."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_fp32(a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        g = grad.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _mm_fp32(g, b.mT) if a.dim() == g.dim() else _mm_fp32(_fold(g), b.mT.reshape(-1, a.shape[-1]))
            ga = ga.to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = _mm_fp32(a.mT, g) if b.dim() == g.dim() else _mm_fp32(_fold(a.mT), g.reshape(-1, b.shape[-1]))
            gb = gb.to(b.dtype)
        return ga, gb


def linear_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., in); w: (out, in) -> x w^T in fp32, no bias: the products of
    the compute dtype accumulated in fp32 and returned so (JAX's
    preferred_element_type=float32)."""
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        return F.linear(x, w)
    return _BmmFp32.apply(x.reshape(-1, x.shape[-1]), w.t()).view(*x.shape[:-1], w.shape[0])


def _arrange(t: torch.Tensor, letters: str, *groups: str) -> torch.Tensor:
    """t (an axis a letter) permuted to the letters of `groups` in order and
    each group merged into one axis; the first group (the batch) is left
    out where t holds none of it."""
    if not set(groups[0]) & set(letters):
        groups = groups[1:]
    size = dict(zip(letters, t.shape))
    return t.permute([letters.index(c) for c in "".join(groups)]).reshape([math.prod(size[c] for c in g)
                                                                          for g in groups])


def _bmm_plan(spec: str, x: torch.Tensor, w: torch.Tensor):
    """(a, b, finish) with torch.einsum(spec, x, w) == finish(a @ b), a and b
    the (B, M, K) and (B, K, N) operands of one product. A 2-D operand
    (F, S) against a 3-D one with the output (B, F, G), the track head's
    PE products, is shared across the batch in place and the product
    writes the output's own layout; every other form is arranged as
    torch.einsum arranges it (the batch the letters of both operands, the
    output a permuted view)."""
    ins, out = spec.split("->")
    xs, ws = ins.split(",")
    summed = "".join(c for c in xs if c in ws and c not in out)
    (lt, ls), (rt, rs) = (x, xs), (w, ws)
    batch = "".join(c for c in out if c in xs and c in ws)
    m, n = "".join(c for c in out if c not in ws), "".join(c for c in out if c not in xs)
    two, three = (xs, ws) if len(xs) == 2 else (ws, xs)
    if len(out) == 3 and sorted(two) == sorted(out[1] + summed) and sorted(three) == sorted(out[::2] + summed):
        if two == ws:
            (lt, ls), (rt, rs) = (rt, rs), (lt, ls)
        batch, m, n = out
    a, b = _arrange(lt, ls, batch, m, summed), _arrange(rt, rs, batch, summed, n)
    size = {**dict(zip(xs, x.shape)), **dict(zip(ws, w.shape))}
    order = batch + m + n

    def finish(y: torch.Tensor) -> torch.Tensor:
        return y.view([size[c] for c in order]).permute([order.index(c) for c in out])

    return a, b, finish


def einsum_fp32(spec: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """torch.einsum(spec, x, w) with `w` rounded to x's dtype, the products
    accumulated and returned in fp32 (the JAX package's
    preferred_element_type=float32 products). bf16 / fp16 operands on one
    CUDA device (`_build.route`'s rule): one tensor-core product with an
    fp32 result (`_BmmFp32`; no TF32, nothing rounded that the fp32
    einsum does not round), counted in `einsum_fp32.launches`; anywhere
    else the fp32 einsum itself."""
    w = w.to(x.dtype)
    if x.dtype not in (torch.bfloat16, torch.float16) or _build.route("einsum_fp32", x, w) == "plain":
        return torch.einsum(spec, x.float(), w.float())
    a, b, finish = _bmm_plan(spec, x, w)
    y = finish(_BmmFp32.apply(a, b))
    einsum_fp32.launches += 1
    return y


einsum_fp32.launches = 0  # products sent to the tensor cores since the last reset


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics and affine, cast back.
    Where the weight and bias have x's dtype, one F.layer_norm call on x does
    it: PyTorch's kernel computes a bf16 or fp16 row in fp32 and rounds once,
    the value of the upcast expression below in one launch in place of five
    (on the card bit for bit; tests/test_torch_gpu.py holds it at the cells'
    widths). Parameters of another dtype (fp32 weights beside bf16
    activations) take the upcast expression, which rounds nothing but the
    output."""
    if weight.dtype == bias.dtype == x.dtype:
        return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU in fp32 and above, the tanh approximation in bf16
    (the JAX package's policy, l4p_tpu/ops/conv.py:107-120)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")
