"""The prologue of an attention block whose q and k take a LayerNorm over the
head dim and/or 2D rotary positions (VGGT's aggregator blocks): the hand-
written Hopper kernel and its plain version.

`qk_norm_rope` takes the QKV product (B, N, 3 * H * D) as the block's
`linear` leaves it and returns q, k and v as (B, H, N, D) buffers in the
layout the attention kernel reads (`flash_attention.in_kernel_layout`), q and
k normed and rotated in fp32 and rounded once to the product's dtype. On
CUDA it launches ``csrc/qk_norm_rope.cu`` (the source's header says what
bounds it and how the design answers that); on the CPU it runs
`qk_norm_rope_plain`, the same function in plain PyTorch (`_build.route`),
and never falls back from the kernel, through `QkNormRopeFunction`, whose
backward recomputes the plain version (ops/recompute.py).

`Rope2D` holds one frame's cos / sin table; a sequence of S frames (N = S *
P tokens) takes it again for each frame, which is what upstream's table of
the S-times repeated positions holds.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from l4p_tpu_torch import _build
from l4p_tpu_torch.ops.recompute import recomputing_function
from l4p_tpu_torch.utils.profiling import span

NAME = "qk_norm_rope"
SOURCES = ("qk_norm_rope.cu",)
KERNEL = _build.kernel(NAME, SOURCES, "l4p_qk_norm_rope_bf16", "p" * 10 + "i" * 7 + "fp")
HEAD_DIM = 64  # the kernel's head row: 8 threads of 8 values
HEADS_PER_BLOCK = 4  # of each of q, k, v a thread


class Rope2D:
    """2D rotary positions (vggt/layers/rope.py) on (..., N, D) fp32 q or
    k: dims [0, D/2) rotate by each token's y, [D/2, D) by its x, each half
    as 1D RoPE with inv_freq_j = freq^(-2j / (D/2)) and rotate_half. The
    table holds `positions`' rows (one frame's, P); N may be any multiple
    of P, token n taking row n mod P."""

    def __init__(self, positions: torch.Tensor, head_dim: int, freq: float):
        d = head_dim // 2
        inv = freq ** (-torch.arange(0, d, 2, device=positions.device, dtype=torch.float32) / d)
        ang = positions.float()[..., None] * inv  # (P, 2, d / 2)
        ang = torch.cat([ang, ang], -1).flatten(-2)  # (P, D): y's angles twice, then x's twice
        self.cos, self.sin = ang.cos(), ang.sin()

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return rope_plain(t, self.cos, self.sin)


def rope_plain(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """t (..., N, D) rotated by the (P, D) table, N a multiple of P."""
    n, p = t.shape[-2], cos.shape[0]
    if n != p:
        if n % p:
            raise ValueError(f"rope: {n} tokens are not a whole number of the table's {p} rows")
        cos, sin = cos.repeat(n // p, 1), sin.repeat(n // p, 1)
    parts = t.unflatten(-1, (2, 2, t.shape[-1] // 4))  # (..., axis, half, D / 4)
    rot = torch.stack((-parts[..., 1, :], parts[..., 0, :]), -2).flatten(-3)
    return t * cos + rot * sin


def qk_norm_rope_plain(heads: int, eps: float, qkv: torch.Tensor, q_weight: Optional[torch.Tensor],
                       q_bias: Optional[torch.Tensor], k_weight: Optional[torch.Tensor],
                       k_bias: Optional[torch.Tensor], cos: Optional[torch.Tensor],
                       sin: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, n, _ = qkv.shape
    parts = qkv.view(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
    hd = parts.shape[-1]
    q, k = parts[0].float(), parts[1].float()
    if q_weight is not None:
        q = F.layer_norm(q, (hd,), q_weight.float(), q_bias.float(), eps)
        k = F.layer_norm(k, (hd,), k_weight.float(), k_bias.float(), eps)
    if cos is not None:
        q, k = rope_plain(q, cos, sin), rope_plain(k, cos, sin)
    return q.to(qkv.dtype).contiguous(), k.to(qkv.dtype).contiguous(), parts[2].contiguous()


def kernel_unsupported(qkv_shape, heads: int, table_rows: Optional[int]) -> Optional[str]:
    """What the kernel cannot take, or None: a head dim other than
    HEAD_DIM, heads not a multiple of HEADS_PER_BLOCK, tokens that are not
    a whole number of the table's rows."""
    b, n, c = qkv_shape
    if c != 3 * heads * HEAD_DIM:
        return f"the QKV width {c} over 3 x {heads} heads must give head_dim {HEAD_DIM}"
    if heads % HEADS_PER_BLOCK:
        return f"heads {heads} must be a multiple of {HEADS_PER_BLOCK}"
    if min(b, n) == 0:
        return f"B {b} and N {n} must be positive"
    if table_rows is not None and n % table_rows:
        return f"N {n} must be a multiple of the rope table's {table_rows} rows"
    return None


def _forward(heads: int, eps: float, qkv: torch.Tensor, q_weight, q_bias, k_weight, k_bias, cos, sin):
    norm, rope = q_weight is not None, cos is not None
    if not (norm or rope):
        raise ValueError("qk_norm_rope: neither a norm nor a rotation to apply")
    if _build.route(NAME, qkv, q_weight, q_bias, k_weight, k_bias, cos, sin) == "plain":
        return qk_norm_rope_plain(heads, eps, qkv, q_weight, q_bias, k_weight, k_bias, cos, sin)
    norms = (q_weight, q_bias, k_weight, k_bias) if norm else ()
    if qkv.dtype != torch.bfloat16 or any(t.dtype != torch.bfloat16 for t in norms):
        raise TypeError(f"qk_norm_rope: the kernel takes bf16 q/k/v and norms, got {qkv.dtype}/"
                        f"{[t.dtype for t in norms]}")
    if rope and (cos.dtype != torch.float32 or sin.dtype != torch.float32):
        raise TypeError(f"qk_norm_rope: the kernel takes an fp32 rope table, got {cos.dtype}/{sin.dtype}")
    if qkv.dim() != 3:
        raise ValueError(f"qk_norm_rope: qkv must be (B, N, 3 * H * D), got {tuple(qkv.shape)}")
    if rope and (cos.dim() != 2 or cos.shape[1] != HEAD_DIM or sin.shape != cos.shape):
        raise ValueError(f"qk_norm_rope: the rope table must be (P, {HEAD_DIM}), got {tuple(cos.shape)}")
    if any(t.shape != (HEAD_DIM,) for t in norms):
        raise ValueError(f"qk_norm_rope: the norms must be ({HEAD_DIM},), got {[tuple(t.shape) for t in norms]}")
    reason = kernel_unsupported(qkv.shape, heads, cos.shape[0] if rope else None)
    if reason is not None:
        raise ValueError(f"qk_norm_rope: qkv {tuple(qkv.shape)}, {heads} heads: {reason}")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in (qkv, *norms, *((cos, sin) if rope else ()))):
        raise ValueError("qk_norm_rope: the kernel reads contiguous, 16-byte aligned qkv, norms and table")
    b, n, _ = qkv.shape
    q, k, v = (torch.empty((b, heads, n, HEAD_DIM), device=qkv.device, dtype=qkv.dtype) for _ in range(3))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with span(NAME, tokens=b * n, heads=heads, head_dim=HEAD_DIM, itemsize=qkv.element_size(),
              table_rows=cos.shape[0] if rope else 0, norm=norm):
        _build.launch(qk_norm_rope, KERNEL, qkv.device, qkv.data_ptr(), ptr(q_weight), ptr(q_bias), ptr(k_weight),
                      ptr(k_bias), ptr(cos), ptr(sin), q.data_ptr(), k.data_ptr(), v.data_ptr(), b, n, heads,
                      HEAD_DIM, cos.shape[0] if rope else 0, int(norm), int(rope), float(eps))
    return q, k, v


QkNormRopeFunction = recomputing_function("QkNormRopeFunction", _forward, qk_norm_rope_plain, consts=2)


def qk_norm_rope(qkv: torch.Tensor, heads: int, eps: float,
                 norms: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]] = None,
                 rope: Optional[Rope2D] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """qkv (B, N, 3 * H * D) -> q, k, v (B, H, N, D), differentiable: q and
    k in fp32, LayerNorm over D under `norms` (q weight, q bias, k weight,
    k bias) at `eps`, then rotated by `rope`, each cast once to qkv's dtype;
    v as it is. Each output is contiguous (`flash_attention.kernel_layout`'s
    layout at D = 64)."""
    qw, qb, kw, kb = norms if norms is not None else (None,) * 4
    cos, sin = (rope.cos, rope.sin) if rope is not None else (None, None)
    return QkNormRopeFunction.apply(heads, eps, qkv, qw, qb, kw, kb, cos, sin)


qk_norm_rope.launches = 0  # kernel launches since the last reset
