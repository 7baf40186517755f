"""The two-way transformer's image side: two hand-written Hopper kernels and
their plain versions.

`t2i_flash` (token -> image attention weighted sum) and `i2t_ln_t2i`
(image -> token attention + out-proj residual + LayerNorm, fused with the
next layer's token -> image accumulation) launch ``csrc/fused_keys.cu``,
which replaces the Pallas TPU kernels ``l4p_tpu/ops/fused_keys.py``
`_t2i_kernel` and `_i2t_t2i_kernel` (the source's header says what bounds
them on the card and how the design answers that). The operands are the
factored two-way transformer's (models/sam.py): `keys` (N, P, C) is the
per-query image embedding, K = heads x tokens.

The wrappers run the plain versions on the CPU and the kernels on bf16
tensors on one CUDA device (`_build.route`, `_build.launch`), never falling
back.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from l4p_tpu_torch import _build

NAME = "fused_keys"
SOURCES = ("fused_keys.cu",)
T2I = _build.kernel(NAME, SOURCES, "l4p_t2i_flash_bf16", "p" * 7 + "i" * 5 + "p")
I2T = _build.kernel(NAME, SOURCES, "l4p_i2t_ln_t2i_bf16", "p" * 14 + "i" * 7 + "fp")
MAX_K = 64
TILE_ROWS = 128  # keys rows per tile of the kernels (csrc/fused_keys.cu)
BLOCK_BOXES = 11  # 16-column boxes a block of a cluster takes (csrc/fused_keys.cu kKS)
# clusters (one per query and split of P) that fill the card about twice: 16
# clusters of 8 blocks run at once on an H100's 132 SMs
MIN_CLUSTERS = 32


def t2i_flash_plain(keys: torch.Tensor, st: torch.Tensor, spe: torch.Tensor) -> torch.Tensor:
    """softmax over P of (keys . st + spe), then its weighted sum of keys:
    (N, P, C), (N, C, K), (N, P, K) f32 -> (N, K, C) f32. The probabilities
    are cast to the keys' dtype before the value product (sam.py:268)."""
    kf = keys.float()
    attn = torch.softmax(torch.matmul(kf, st.float()) + spe, dim=1).to(keys.dtype)
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


def _check_cuda(name: str, keys, bf16, f32, k: int) -> None:
    for t in (keys, *bf16):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bf16 keys and token operands, got {t.dtype}")
    for t in f32:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes fp32 logit terms, got {t.dtype}")
    for t in (keys, *bf16, *f32):
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")
    n, p, c = keys.shape
    if c % 16 or k % 16 or not 0 < k <= MAX_K or min(n, p) == 0 or n > 65535:
        raise ValueError(f"{name}: unsupported shape keys{tuple(keys.shape)}, K={k} "
                         f"(needs C % 16 == 0, K % 16 == 0, K <= {MAX_K})")


def split_rows(n: int, p: int) -> int:
    """Keys rows per cluster: all of P, unless fewer than MIN_CLUSTERS
    clusters would run, then P split in multiples of TILE_ROWS."""
    tiles = -(-p // TILE_ROWS)
    splits = min(tiles, max(1, -(-MIN_CLUSTERS // n)))
    return -(-tiles // splits) * TILE_ROWS


def kernel_variant(c: int, k2: int, i2t: bool) -> str:
    """The build a launch takes (csrc/fused_keys.cu's launchers): "wide" for
    t2i_flash where even 16 blocks take more than BLOCK_BOXES column boxes
    each (C > 2816), else by the weighted sum's token width, "nt48" (K2 <=
    48) or "nt64"."""
    boxes = c // 16
    per_block = -(-boxes // 8)
    if per_block > BLOCK_BOXES:
        per_block = -(-boxes // 16)
    if not i2t and per_block > BLOCK_BOXES:
        return "wide"
    return "nt64" if k2 > 48 else "nt48"


def _workspace(keys: torch.Tensor, k: int, split: int):
    """The per-split partials of the weighted sum (acc, m, l), empty where
    P is not split."""
    n, p, c = keys.shape
    splits = -(-p // split)
    if splits == 1:
        n = c = 0
    f32 = dict(device=keys.device, dtype=torch.float32)
    return (torch.empty((n, splits, k, c), **f32), torch.empty((n, splits, k), **f32),
            torch.empty((n, splits, k), **f32))


def t2i_launch_args(keys, st, spe, split: int):
    """(wsum, the C entry point's arguments but the stream, the tensors they
    point into) for checked CUDA operands; `split` keys rows per cluster
    (split_rows). Keep the third item alive until the launch."""
    n, p, c = keys.shape
    k = st.shape[-1]
    s_t = st.transpose(1, 2).contiguous()  # (N, K, C): rows of the kernel's B operand
    _check_cuda("t2i_flash", keys, (s_t,), (spe,), k)
    wsum = torch.empty((n, k, c), device=keys.device, dtype=torch.float32)
    ws = _workspace(keys, k, split)
    args = (keys.data_ptr(), s_t.data_ptr(), spe.data_ptr(), wsum.data_ptr(), *(w.data_ptr() for w in ws),
            n, p, c, k, split)
    return wsum, args, (s_t, *ws)


def i2t_launch_args(keys, r, per, v2, ob, lnw, lnb, st, spe, num_heads: int, eps: float, split: int):
    """((keys_new, wsum), the C entry point's arguments but the stream, the
    tensors they point into), as `t2i_launch_args`."""
    n, p, c = keys.shape
    k, k2 = r.shape[-1], st.shape[-1]
    r_t = r.transpose(1, 2).contiguous()  # (N, K, C)
    v2_t = v2.transpose(1, 2).contiguous()  # (N, C, K)
    s_t = st.transpose(1, 2).contiguous()  # (N, K2, C)
    vecs = [v.float().contiguous() for v in (ob, lnw, lnb)]
    _check_cuda("i2t_ln_t2i", keys, (r_t, v2_t, s_t), (per, spe, *vecs), k)
    if k2 % 16 or not 0 < k2 <= MAX_K:
        raise ValueError(f"i2t_ln_t2i: unsupported K2={k2} (needs K2 % 16 == 0, K2 <= {MAX_K})")
    keys_new = torch.empty_like(keys)
    wsum = torch.empty((n, k2, c), device=keys.device, dtype=torch.float32)
    ws = _workspace(keys, k2, split)
    args = (keys.data_ptr(), r_t.data_ptr(), per.data_ptr(), v2_t.data_ptr(), *(v.data_ptr() for v in vecs),
            s_t.data_ptr(), spe.data_ptr(), keys_new.data_ptr(), wsum.data_ptr(), *(w.data_ptr() for w in ws),
            n, p, c, k, k2, num_heads, split, float(eps))
    return (keys_new, wsum), args, (r_t, v2_t, s_t, *vecs, *ws)


def t2i_flash(keys: torch.Tensor, st: torch.Tensor, spe: torch.Tensor) -> torch.Tensor:
    """(N, P, C) keys, (N, C, K) st, (N, P, K) f32 spe -> (N, K, C) f32."""
    n, p, c = keys.shape
    k = st.shape[-1]
    if st.shape != (n, c, k) or spe.shape != (n, p, k):
        raise ValueError(f"t2i_flash: incompatible shapes keys{tuple(keys.shape)} st{tuple(st.shape)} "
                         f"spe{tuple(spe.shape)}")
    if _build.route("t2i_flash", keys, st, spe) == "plain":
        return t2i_flash_plain(keys, st, spe)
    wsum, args, _keep = t2i_launch_args(keys, st, spe, split_rows(n, p))
    _build.launch(t2i_flash, T2I, keys.device, *args)
    t2i_flash.variant_launches[kernel_variant(c, k, False)] += 1
    return wsum


def i2t_ln_t2i(keys, r, per, v2, ob, lnw, lnb, st, spe, num_heads: int,
               eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused image -> token attention + residual LayerNorm + next t2i;
    returns (keys_new like keys, next wsum (N, K2, C) f32). Shapes as in
    `i2t_ln_t2i_plain`."""
    n, p, c = keys.shape
    k, k2 = r.shape[-1], st.shape[-1]
    if (r.shape != (n, c, k) or per.shape != (n, p, k) or v2.shape != (n, k, c) or st.shape != (n, c, k2)
            or spe.shape != (n, p, k2) or any(t.shape != (c,) for t in (ob, lnw, lnb)) or k % num_heads):
        raise ValueError(f"i2t_ln_t2i: incompatible shapes keys{tuple(keys.shape)} r{tuple(r.shape)} "
                         f"per{tuple(per.shape)} v2{tuple(v2.shape)} st{tuple(st.shape)} spe{tuple(spe.shape)} "
                         f"heads {num_heads}")
    if _build.route("i2t_ln_t2i", keys, r, per, v2, ob, lnw, lnb, st, spe) == "plain":
        return i2t_ln_t2i_plain(keys, r, per, v2, ob, lnw, lnb, st, spe, num_heads, eps)
    outs, args, _keep = i2t_launch_args(keys, r, per, v2, ob, lnw, lnb, st, spe, num_heads, eps, split_rows(n, p))
    _build.launch(i2t_ln_t2i, I2T, keys.device, *args)
    i2t_ln_t2i.variant_launches[kernel_variant(c, k2, True)] += 1
    return outs


t2i_flash.launches = 0  # kernel launches since the last reset
i2t_ln_t2i.launches = 0
t2i_flash.variant_launches = {"nt48": 0, "nt64": 0, "wide": 0}  # the same, by kernel_variant
i2t_ln_t2i.variant_launches = {"nt48": 0, "nt64": 0}
