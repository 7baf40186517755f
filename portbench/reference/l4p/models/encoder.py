"""ViT-giant video encoder (counterpart of l4p_tpu/models/encoder.py).

Parameter names are the released checkpoint's (`patch_embed.proj`,
`blocks.{i}.{norm1,attn.{qkv,q_bias,v_bias,proj},norm2,mlp.{fc1,fc2}}`,
`norm`); the sinusoid position table is a non-persistent buffer, as in the
reference (modeling_pretrain.py:77). The tubelet embedding runs as a reshape
plus a matmul, and attention goes through the function the caller passes:
the Hopper kernel (`flash_attention`) by default.

The option branches keep the reference's names too: cosine attention's
logit scale `blocks.{i}.attn.scale` (cos_attn), the LayerScale gains
`blocks.{i}.gamma_1` / `gamma_2` (init_values > 0), a learnable `pos_embed`
(use_learnable_pos_emb) and the Plucker camera embedding's
`cam_emb.cam_emb_proj` (cam_emb_placed_at), which needs each window's
normalised intrinsics and extrinsics.

Inference on one device only: the program's training (stochastic depth),
multi-device and whole-encoder kernel paths have no counterpart here.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from portbench.reference.l4p.config import GIANT, EncoderConfig
from portbench.reference.l4p.geometry.core import get_rays_plucker
from portbench.reference.l4p.ops.conv import gelu, layer_norm, linear
from portbench.reference.l4p.ops.flash_attention import flash_attention
from portbench.reference.l4p.ops.resize import interp_matrix

AttentionFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, float], torch.Tensor]


def sinusoid_pos_embed(n_position: int, d_hid: int) -> np.ndarray:
    """Fixed sin/cos table (1, N, C), float64 math then float32
    (reference modeling_finetune.py:288-299)."""
    pos = np.arange(n_position, dtype=np.float64)[:, None]
    dim = np.arange(d_hid, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table[None].astype(np.float32)


def patchify(x_b3thw: torch.Tensor, cfg: EncoderConfig) -> torch.Tensor:
    """(B, C, T, H, W) -> (B, T'*H'*W', C*tt*p*p) tubelets, feature order
    (c, dt, dh, dw): the flattened Conv3d(kernel == stride) input."""
    b, c, t, h, w = x_b3thw.shape
    p, tt = cfg.patch_size, cfg.tubelet_size
    x = x_b3thw.reshape(b, c, t // tt, tt, h // p, p, w // p, p)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, (t // tt) * (h // p) * (w // p), c * tt * p * p)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: EncoderConfig, device=None, dtype=None):
        super().__init__()
        k = (cfg.tubelet_size, cfg.patch_size, cfg.patch_size)
        self.proj = nn.Conv3d(cfg.in_chans, cfg.embed_dim, k, stride=k, device=device, dtype=dtype)


# cosine attention's logit scale is clamped at log(1 / 0.01) (reference modeling_finetune.py:122-125)
COS_ATTN_MAX_LOG_SCALE = 4.6052


class Attention(nn.Module):
    def __init__(self, cfg: EncoderConfig, device=None, dtype=None):
        super().__init__()
        dim = cfg.embed_dim
        self.qkv = nn.Linear(dim, 3 * dim, bias=False, device=device, dtype=dtype)
        self.q_bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))
        self.v_bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))
        if cfg.cos_attn:
            self.scale = nn.Parameter(torch.full((cfg.num_heads, 1, 1), math.log(10.0), device=device, dtype=dtype))
        self.proj = nn.Linear(dim, dim, device=device, dtype=dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device, dtype=dtype)
        self.fc2 = nn.Linear(hidden, dim, device=device, dtype=dtype)


class Block(nn.Module):
    """Pre-LN transformer block (reference modeling_finetune.py:245-252):
    x + gamma_1 * attn(ln(x)), x + gamma_2 * mlp(ln(x)), the gammas only
    when init_values > 0 (:239-243)."""

    def __init__(self, cfg: EncoderConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_dim
        self.norm1 = nn.LayerNorm(e, eps=cfg.ln_eps, device=device, dtype=dtype)
        self.attn = Attention(cfg, device, dtype)
        self.norm2 = nn.LayerNorm(e, eps=cfg.ln_eps, device=device, dtype=dtype)
        self.mlp = Mlp(e, cfg.mlp_hidden, device, dtype)
        if cfg.init_values > 0:
            self.gamma_1 = nn.Parameter(torch.full((e,), cfg.init_values, device=device, dtype=dtype))
            self.gamma_2 = nn.Parameter(torch.full((e,), cfg.init_values, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor, attention: AttentionFn) -> torch.Tensor:
        b, n, e = x.shape
        hd, eps, nh = self.cfg.head_dim, self.cfg.ln_eps, self.cfg.num_heads
        a = self.attn
        h = layer_norm(x, self.norm1.weight, self.norm1.bias, eps)
        qkv_bias = torch.cat([a.q_bias, torch.zeros_like(a.v_bias), a.v_bias])  # no k bias
        qkv = linear(h, a.qkv.weight, qkv_bias).view(b, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        if self.cfg.cos_attn:
            # JAX's order of dtypes (l4p_tpu/models/encoder.py:256-261): q and k over their fp32 norms
            # cast to the compute dtype, the logit scale in fp32, q times it in the compute dtype
            q, k = (t / torch.linalg.vector_norm(t, dim=-1, keepdim=True, dtype=torch.float32).to(x.dtype)
                    for t in qkv[:2])
            logit_scale = torch.exp(torch.clamp(a.scale.float(), max=COS_ATTN_MAX_LOG_SCALE))
            o = attention(q * logit_scale.to(x.dtype), k, qkv[2], 1.0)
        else:
            o = attention(qkv[0], qkv[1], qkv[2], hd ** -0.5)  # strided views: the kernel's wrapper lays them out
        branch = linear(o.transpose(1, 2).reshape(b, n, nh * hd), a.proj.weight, a.proj.bias)
        if self.cfg.init_values > 0:
            branch = branch * self.gamma_1.to(x.dtype)
        x = x + branch
        h = layer_norm(x, self.norm2.weight, self.norm2.bias, eps)
        h = gelu(linear(h, self.mlp.fc1.weight, self.mlp.fc1.bias))
        branch = linear(h, self.mlp.fc2.weight, self.mlp.fc2.bias)
        if self.cfg.init_values > 0:
            branch = branch * self.gamma_2.to(x.dtype)
        return x + branch


class CameraEmbedding(nn.Module):
    """The Plucker camera embedding (reference l4p/models/blocks.py:13-53;
    l4p_tpu/models/encoder.py:309-337): `cam_emb_proj` maps each token's
    6-channel ray (with its feature, for 'concat') to a feature added to
    the token."""

    def __init__(self, cfg: EncoderConfig, device=None, dtype=None):
        super().__init__()
        self.embed_type, self.tokens_thw = cfg.cam_emb_type, cfg.tokens_thw
        in_dim = 6 + (cfg.embed_dim if cfg.cam_emb_type == "concat" else 0)
        self.cam_emb_proj = nn.Linear(in_dim, cfg.embed_dim, device=device, dtype=dtype)

    def rays(self, intrinsics_b44t: torch.Tensor, extrinsics_b44t: torch.Tensor) -> torch.Tensor:
        """Each token's ray (B, t*h*w, 6) in (t, h, w) order: the rays at the
        (h, w) patch grid, each window relative to its first camera, linearly
        resized in time from the window's frames to its t tubelets
        (align_corners False)."""
        b = intrinsics_b44t.shape[0]
        et, eh, ew = self.tokens_thw
        camray, _ = get_rays_plucker(intrinsics_b44t, extrinsics_b44t, (eh, ew))  # (B, 6, T, h, w)
        t_full = camray.shape[2]
        m = torch.from_numpy(interp_matrix(t_full, et, align_corners=False)).to(camray.device)
        flat = camray.permute(0, 3, 4, 1, 2).reshape(b, -1, t_full) @ m.T.to(camray.dtype)  # (B, h*w*6, t)
        return flat.reshape(b, eh, ew, 6, et).permute(0, 4, 1, 2, 3).reshape(b, -1, 6)

    def forward(self, feat_blc: torch.Tensor, rays_bn6: torch.Tensor) -> torch.Tensor:
        """Tokens (B, N, C) plus the projection of their rays (`rays`)."""
        rays_bn6 = rays_bn6.to(feat_blc.dtype)
        x = torch.cat([feat_blc, rays_bn6], -1) if self.embed_type == "concat" else rays_bn6
        return feat_blc + linear(x, self.cam_emb_proj.weight, self.cam_emb_proj.bias)


class VideoEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig = GIANT, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg, device, dtype)
        self.blocks = nn.ModuleList(Block(cfg, device, dtype) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps, device=device, dtype=dtype)
        table = torch.as_tensor(sinusoid_pos_embed(cfg.num_tokens, cfg.embed_dim), device=device)
        table = table.to(dtype or torch.get_default_dtype())
        if cfg.use_learnable_pos_emb:
            self.pos_embed = nn.Parameter(table)
        else:
            self.register_buffer("pos_embed", table, persistent=False)
        if cfg.cam_emb_placed_at is not None:
            self.cam_emb = CameraEmbedding(cfg, device, dtype)

    def embed(self, x_b3thw: torch.Tensor) -> torch.Tensor:
        """Float video -> (B, N, E) tokens without the position table. The
        video is cast to the weights' dtype: the encoder computes in it."""
        w = self.patch_embed.proj.weight
        x = patchify(x_b3thw.to(w.dtype), self.cfg)
        return linear(x, w.flatten(1), self.patch_embed.proj.bias)

    def forward(self, tokens_bne: torch.Tensor, hooks: Sequence[int],
                attention: AttentionFn = flash_attention,
                intrinsics_b44t: Optional[torch.Tensor] = None,
                extrinsics_b44t: Optional[torch.Tensor] = None) -> Dict[str, object]:
        """Tokens (B, N, E) without the position table -> {'hooks': [feature
        per hook], 'final': normed output}. Hook index 0 is the embedding,
        index i the output of block i-1, index `depth` the normed output
        (reference l4p_videomae.py:108-115). The blocks run one by one with
        `attention`. With the camera embedding, each batch
        item's normalised intrinsics and extrinsics (B, 4, 4, frames) are
        needed: it is added after the positions ('input') or to every hook
        feature and the output ('output'; l4p_tpu/models/encoder.py:378-381,
        :452-459)."""
        cfg = self.cfg
        x = tokens_bne + self.pos_embed.to(tokens_bne.dtype)
        place = cfg.cam_emb_placed_at
        if place is not None:
            if intrinsics_b44t is None or extrinsics_b44t is None:
                raise ValueError(f"the camera embedding (cam_emb_placed_at {place!r}) needs intrinsics_b44t and "
                                 "extrinsics_b44t")
            rays = self.cam_emb.rays(intrinsics_b44t, extrinsics_b44t)  # one ray map for every feature
        if place == "input":
            x = self.cam_emb(x, rays)
        feats: Dict[int, torch.Tensor] = {0: x}
        for i, blk in enumerate(self.blocks):
            x = blk(x, attention)
            if i + 1 in hooks:
                feats[i + 1] = x
        final = layer_norm(x, self.norm.weight, self.norm.bias, cfg.ln_eps)
        if place == "output":
            final = self.cam_emb(final, rays)
            feats = {h: final if h == cfg.depth else self.cam_emb(feats[h], rays) for h in hooks}
        feats[cfg.depth] = final
        return {"hooks": [feats[h] for h in hooks], "final": final}
