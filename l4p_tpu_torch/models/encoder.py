"""ViT-giant video encoder (counterpart of l4p_tpu/models/encoder.py).

Parameter names are the released checkpoint's (`patch_embed.proj`,
`blocks.{i}.{norm1,attn.{qkv,q_bias,v_bias,proj},norm2,mlp.{fc1,fc2}}`,
`norm`); the sinusoid position table is a non-persistent buffer, as in the
reference (modeling_pretrain.py:77). The tubelet embedding runs as a reshape
plus a matmul, and attention goes through the function the caller passes:
the Hopper kernel (`flash_attention`) by default.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from l4p_tpu_torch.config import GIANT, EncoderConfig
from l4p_tpu_torch.ops.conv import gelu, layer_norm, linear
from l4p_tpu_torch.ops.flash_attention import flash_attention

AttentionFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, float], torch.Tensor]
# (blocks, x, cfg, hook_ends) -> (B, len(hook_ends), N, E): fused_encoder_blocks or its plain version
EncoderBlocksFn = Callable[[Sequence[nn.Module], torch.Tensor, EncoderConfig, Sequence[int]], torch.Tensor]


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


class Attention(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim, bias=False, device=device, dtype=dtype)
        self.q_bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))
        self.v_bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))
        self.proj = nn.Linear(dim, dim, device=device, dtype=dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device, dtype=dtype)
        self.fc2 = nn.Linear(hidden, dim, device=device, dtype=dtype)


class Block(nn.Module):
    """Pre-LN transformer block (reference modeling_finetune.py:245-252);
    the released config has no LayerScale gammas and no drop path."""

    def __init__(self, cfg: EncoderConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_dim
        self.norm1 = nn.LayerNorm(e, eps=cfg.ln_eps, device=device, dtype=dtype)
        self.attn = Attention(e, device, dtype)
        self.norm2 = nn.LayerNorm(e, eps=cfg.ln_eps, device=device, dtype=dtype)
        self.mlp = Mlp(e, cfg.mlp_hidden, device, dtype)

    def forward(self, x: torch.Tensor, attention: AttentionFn) -> torch.Tensor:
        b, n, e = x.shape
        nh, hd, eps = self.cfg.num_heads, self.cfg.head_dim, self.cfg.ln_eps
        a = self.attn
        h = layer_norm(x, self.norm1.weight, self.norm1.bias, eps)
        qkv_bias = torch.cat([a.q_bias, torch.zeros_like(a.v_bias), a.v_bias])  # no k bias
        qkv = linear(h, a.qkv.weight, qkv_bias).view(b, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        o = attention(qkv[0], qkv[1], qkv[2], hd ** -0.5)  # strided views: the kernel's wrapper lays them out
        x = x + linear(o.transpose(1, 2).reshape(b, n, e), a.proj.weight, a.proj.bias)
        h = layer_norm(x, self.norm2.weight, self.norm2.bias, eps)
        h = gelu(linear(h, self.mlp.fc1.weight, self.mlp.fc1.bias))
        return x + linear(h, self.mlp.fc2.weight, self.mlp.fc2.bias)


class VideoEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig = GIANT, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg, device, dtype)
        self.blocks = nn.ModuleList(Block(cfg, device, dtype) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps, device=device, dtype=dtype)
        table = torch.as_tensor(sinusoid_pos_embed(cfg.num_tokens, cfg.embed_dim), device=device)
        self.register_buffer("pos_embed", table.to(dtype or torch.get_default_dtype()), persistent=False)

    def embed(self, x_b3thw: torch.Tensor) -> torch.Tensor:
        """Float video -> (B, N, E) tokens without the position table. The
        video is cast to the weights' dtype: the encoder computes in it."""
        w = self.patch_embed.proj.weight
        x = patchify(x_b3thw.to(w.dtype), self.cfg)
        return linear(x, w.flatten(1), self.patch_embed.proj.bias)

    def forward(self, tokens_bne: torch.Tensor, hooks: Sequence[int],
                attention: AttentionFn = flash_attention,
                encoder_blocks: Optional[EncoderBlocksFn] = None) -> Dict[str, object]:
        """Tokens (B, N, E) without the position table -> {'hooks': [feature
        per hook], 'final': normed output}. Hook index 0 is the embedding,
        index i the output of block i-1, index `depth` the normed output
        (reference l4p_videomae.py:108-115). The blocks run in one
        `encoder_blocks` call when one is given (`fused_encoder_blocks`, as
        `encode_windows` passes it under `cfg.encoder.fused_encoder`), else
        one by one with `attention`."""
        x = tokens_bne + self.pos_embed.to(tokens_bne.dtype)
        feats: Dict[int, torch.Tensor] = {0: x}
        if encoder_blocks is not None:
            ends = sorted({h for h in hooks if h > 0} | {self.cfg.depth})
            stack = encoder_blocks(self.blocks, x, self.cfg, ends)
            feats.update({e: stack[:, i] for i, e in enumerate(ends)})
            x = feats[self.cfg.depth]
        else:
            for i, blk in enumerate(self.blocks):
                x = blk(x, attention)
                if i + 1 in hooks:
                    feats[i + 1] = x
        final = layer_norm(x, self.norm.weight, self.norm.bias, self.cfg.ln_eps)
        feats[self.cfg.depth] = final
        return {"hooks": [feats[h] for h in hooks], "final": final}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from `generator`, with the distributions of the JAX
        package's init_encoder_params: Xavier-uniform matrices (q, k and v
        each as an E x E block), zero biases, unit LayerNorm scales."""
        def xavier(w: torch.Tensor, fan_out: int, fan_in: int) -> None:
            a = math.sqrt(6.0 / (fan_in + fan_out))
            w.uniform_(-a, a, generator=generator)

        e = self.cfg.embed_dim
        pw = self.patch_embed.proj.weight
        xavier(pw, e, pw[0].numel())
        self.patch_embed.proj.bias.zero_()
        for blk in self.blocks:
            xavier(blk.attn.qkv.weight, e, e)
            xavier(blk.attn.proj.weight, e, e)
            xavier(blk.mlp.fc1.weight, *blk.mlp.fc1.weight.shape)
            xavier(blk.mlp.fc2.weight, *blk.mlp.fc2.weight.shape)
            for bias in (blk.attn.q_bias, blk.attn.v_bias, blk.attn.proj.bias, blk.mlp.fc1.bias,
                         blk.mlp.fc2.bias, blk.norm1.bias, blk.norm2.bias):
                bias.zero_()
            blk.norm1.weight.fill_(1.0)
            blk.norm2.weight.fill_(1.0)
        self.norm.weight.fill_(1.0)
        self.norm.bias.zero_()
