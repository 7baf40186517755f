"""The two-way transformer's image side in the reference: the plain versions
of its two fused functions."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from portbench.reference.l4p.ops.lowp import q8


def t2i_flash_plain(keys: torch.Tensor, st: torch.Tensor, spe: torch.Tensor) -> torch.Tensor:
    """softmax over P of (keys . st + spe), then its weighted sum of keys:
    (N, P, C), (N, C, K), (N, P, K) f32 -> (N, K, C) f32. The probabilities
    are cast to the keys' dtype before the value product (sam.py:268)."""
    kf = q8(keys).float()
    attn = torch.softmax(torch.matmul(kf, q8(st).float()) + spe, dim=1).to(keys.dtype)
    return torch.matmul(attn.float().transpose(1, 2), kf)


def i2t_ln_t2i_plain(keys, r, per, v2, ob, lnw, lnb, st, spe, num_heads: int,
                     eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Image -> token attention with a softmax per head over its K/num_heads
    tokens, + v2 product + out bias + residual (fp32) -> LayerNorm(eps) ->
    new keys in the keys' dtype; then the next layer's `t2i_flash` on them.
    r: (N, C, K), per: (N, P, K) f32, v2: (N, K, C), ob/lnw/lnb: (C,),
    st: (N, C, K2), spe: (N, P, K2) f32."""
    n, p, c = keys.shape
    k = r.shape[-1]
    kf = keys.float()
    lg = torch.matmul(kf, r.float()) + per
    attn = torch.softmax(lg.view(n, p, num_heads, k // num_heads), dim=-1).view(n, p, k).to(keys.dtype)
    y = kf + torch.matmul(attn.float(), v2.float()) + ob.float()
    keys_new = F.layer_norm(y, (c,), lnw.float(), lnb.float(), eps).to(keys.dtype)
    return keys_new, t2i_flash_plain(keys_new, st, spe)


t2i_flash = t2i_flash_plain
i2t_ln_t2i = i2t_ln_t2i_plain
