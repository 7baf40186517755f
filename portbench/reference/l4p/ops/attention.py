"""Plain multi-head attention (counterpart of l4p_tpu/ops/attention.py).

It is the plain PyTorch version of the encoder attention kernel
(ops/flash_attention.py) and what that kernel is checked against.
"""

from __future__ import annotations

from typing import Optional

import torch

from portbench.reference.l4p.ops.lowp import q8


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: (B, H, N, D) -> (B, H, Nq, D).

    Same rounding points as the JAX `mha`: q is scaled in its own dtype,
    scores and softmax are fp32, the probabilities are cast to q's dtype
    before the PV product, which accumulates in fp32."""
    q, k, v = q8(q), q8(k), q8(v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul((q * scale).float(), k.float().transpose(-2, -1))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)
