"""VideoMAE masked-autoencoder pretraining model (counterpart of
l4p_tpu/models/mae.py; reference modeling_pretrain.py:152-364).

Parameter names are upstream PretrainVisionTransformer's, which the JAX
package's `convert_mae` reads (l4p_tpu/checkpoint.py:205-255): `encoder.*`
(the port's VideoEncoder), `decoder.blocks.{i}.*`, `decoder.norm`,
`decoder.head`, `encoder_to_decoder.weight` (no bias) and `mask_token`. So
one state dict loads here with `load_state_dict(strict=True)` and into JAX
through `convert_mae`.

The two sinusoid tables, the encoder's `pos_embed` and the decoder's
`decoder_pos_embed`, are non-persistent buffers, fixed as upstream keeps
them. (JAX's tree holds both as leaves: the decoder's gets a gradient and
trains, the encoder's is decayed by AdamW; ROADMAP.md section 3.)

Visible and masked tokens are chosen by index lists (B, n_vis) / (B, n_mask),
one spatial tube mask shared by every tubelet step (`tube_mask_indices`),
as JAX gathers them in place of upstream's boolean indexing. Attention goes
through the function the caller passes: the Hopper kernel (`flash_attention`)
by default, for the encoder's visible tokens and the decoder's full set.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn as nn

from l4p_tpu_torch.config import EncoderConfig
from l4p_tpu_torch.models.encoder import (AttentionFn, Block, VideoEncoder, patchify, sinusoid_pos_embed,
                                          xavier_uniform_)
from l4p_tpu_torch.ops.conv import layer_norm, linear
from l4p_tpu_torch.ops.flash_attention import flash_attention


@dataclasses.dataclass(frozen=True)
class MAEConfig:
    encoder: EncoderConfig
    decoder_embed_dim: int = 512
    decoder_depth: int = 8
    decoder_num_heads: int = 8
    decoder_num_classes: int = 1176 * 2

    @property
    def decoder_cfg(self) -> EncoderConfig:
        """The decoder's blocks: the encoder's config (mlp_ratio, ln_eps, image
        size, frames) at the decoder's width, depth and heads."""
        return dataclasses.replace(self.encoder, embed_dim=self.decoder_embed_dim, depth=self.decoder_depth,
                                   num_heads=self.decoder_num_heads)


def mae_registry(name: str) -> MAEConfig:
    """Upstream's @register_model factories (modeling_pretrain.py:367-484);
    decoder_depth is the signature default 8 in every one."""
    sizes = {
        "small": dict(patch=16, e=384, d=12, h=6, de=192, dh=3),
        "base": dict(patch=16, e=768, d=12, h=12, de=384, dh=6),
        "large": dict(patch=16, e=1024, d=24, h=16, de=512, dh=8),
        "huge": dict(patch=16, e=1280, d=32, h=16, de=512, dh=8),
        "giant": dict(patch=14, e=1408, d=40, h=16, de=512, dh=8, mlp=48 / 11),
    }
    s = sizes[name]
    enc = EncoderConfig(patch_size=s["patch"], embed_dim=s["e"], depth=s["d"], num_heads=s["h"],
                        mlp_ratio=s.get("mlp", 4.0))
    return MAEConfig(encoder=enc, decoder_embed_dim=s["de"], decoder_depth=8, decoder_num_heads=s["dh"],
                     decoder_num_classes=3 * enc.tubelet_size * s["patch"] ** 2)


class MAEDecoder(nn.Module):
    def __init__(self, cfg: MAEConfig, device=None, dtype=None):
        super().__init__()
        dcfg = cfg.decoder_cfg
        self.blocks = nn.ModuleList(Block(dcfg.block, device, dtype) for _ in range(dcfg.depth))
        self.norm = nn.LayerNorm(dcfg.embed_dim, eps=dcfg.ln_eps, device=device, dtype=dtype)
        self.head = nn.Linear(dcfg.embed_dim, cfg.decoder_num_classes, device=device, dtype=dtype)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C), idx (B, M) -> (B, M, C): row idx[b, m] of x[b]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


class MAE(nn.Module):
    def __init__(self, cfg: MAEConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        de = cfg.decoder_embed_dim
        self.encoder = VideoEncoder(cfg.encoder, device, dtype)
        self.decoder = MAEDecoder(cfg, device, dtype)
        self.encoder_to_decoder = nn.Linear(cfg.encoder.embed_dim, de, bias=False, device=device, dtype=dtype)
        self.mask_token = nn.Parameter(torch.zeros((1, 1, de), device=device, dtype=dtype))
        table = torch.as_tensor(sinusoid_pos_embed(cfg.encoder.num_tokens, de), device=device)
        self.register_buffer("decoder_pos_embed", table.to(dtype or torch.get_default_dtype()), persistent=False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from `generator` with init_mae_params' distributions
        (l4p_tpu/models/mae.py:76-95): the encoder's and the decoder blocks'
        as the encoder's init, encoder_to_decoder and the head Xavier-uniform,
        the head's bias 0, the decoder norm's unit scale, and mask_token 0.02
        times a normal truncated at +-2."""
        cfg, dec = self.cfg, self.decoder
        self.encoder.init_weights(generator)
        for blk in dec.blocks:
            blk.init_weights(generator)
        dec.norm.weight.fill_(1.0)
        dec.norm.bias.zero_()
        xavier_uniform_(self.encoder_to_decoder.weight, *self.encoder_to_decoder.weight.shape, generator)
        # the truncated normal by its inverse CDF, as jax.random.truncated_normal draws it
        lo, hi = (math.erf(b / math.sqrt(2.0)) for b in (-2.0, 2.0))
        u = torch.empty(self.mask_token.shape, device=self.mask_token.device).uniform_(lo, hi, generator=generator)
        self.mask_token.copy_(0.02 * math.sqrt(2.0) * torch.erfinv(u))
        xavier_uniform_(dec.head.weight, *dec.head.weight.shape, generator)
        dec.head.bias.zero_()
        self.decoder_pos_embed.copy_(torch.as_tensor(sinusoid_pos_embed(cfg.encoder.num_tokens,
                                                                         cfg.decoder_embed_dim)))

    def encode_visible(self, x_b3thw: torch.Tensor, visible_idx: torch.Tensor,
                       attention: AttentionFn = flash_attention) -> torch.Tensor:
        """The masked encoder (modeling_pretrain.py:129-149; l4p_tpu/models/
        mae.py:106-116): embed, add the fixed positions, keep the visible
        rows, run the blocks, norm. -> (B, n_vis, E)."""
        enc = self.encoder
        x = enc.embed(x_b3thw)
        x = _gather_rows(x + enc.pos_embed.to(x.dtype), visible_idx)
        for blk in enc.blocks:
            x = blk(x, attention)
        return layer_norm(x, enc.norm.weight, enc.norm.bias, enc.cfg.ln_eps)

    def forward(self, x_b3thw: torch.Tensor, visible_idx: torch.Tensor, masked_idx: torch.Tensor,
                attention: AttentionFn = flash_attention) -> torch.Tensor:
        """The pixels of the masked tubelets (B, n_mask, decoder_num_classes)
        (modeling_pretrain.py:346-364; l4p_tpu/models/mae.py:119-147): the
        visible tokens at the decoder's width plus their positions, then a
        mask token plus its position per masked tubelet, the decoder blocks,
        and the norm and head on the last n_mask rows."""
        dec, dcfg = self.decoder, self.cfg.decoder_cfg
        x_vis = linear(self.encode_visible(x_b3thw, visible_idx, attention), self.encoder_to_decoder.weight)
        pos = self.decoder_pos_embed.to(x_vis.dtype).expand(x_vis.shape[0], -1, -1)
        x = torch.cat([x_vis + _gather_rows(pos, visible_idx),
                       self.mask_token.to(x_vis.dtype) + _gather_rows(pos, masked_idx)], 1)
        for blk in dec.blocks:
            x = blk(x, attention)
        x = layer_norm(x[:, -masked_idx.shape[1]:], dec.norm.weight, dec.norm.bias, dcfg.ln_eps)
        return linear(x, dec.head.weight, dec.head.bias)


def tube_mask_indices(generator: torch.Generator, cfg: EncoderConfig, batch: int,
                      mask_ratio: float = 0.9) -> Tuple[torch.Tensor, torch.Tensor]:
    """VideoMAE tube masking (l4p_tpu/models/mae.py:150-168): per batch item
    one random spatial mask of int(h * w * mask_ratio) tokens, shared by every
    tubelet step. -> (visible_idx (B, t * n_vis), masked_idx (B, t *
    n_mask)), each sorted, on the generator's device."""
    t, h, w = cfg.tokens_thw
    n_space = h * w
    n_mask = int(n_space * mask_ratio)
    steps = torch.arange(t, device=generator.device)[:, None] * n_space
    vis, mask = [], []
    for _ in range(batch):
        perm = torch.randperm(n_space, generator=generator, device=generator.device)
        vis.append((perm[n_mask:].sort().values + steps).reshape(-1))
        mask.append((perm[:n_mask].sort().values + steps).reshape(-1))
    return torch.stack(vis), torch.stack(mask)


def mae_pretrain_loss(model: MAE, x_b3thw: torch.Tensor, visible_idx: torch.Tensor, masked_idx: torch.Tensor,
                      normalize_target: bool = True, attention: AttentionFn = flash_attention) -> torch.Tensor:
    """The MSE of the predicted pixels of the masked tubelets against the
    video's own, in fp32 (l4p_tpu/models/mae.py:171-194): the target is
    each masked tubelet of the video as given, features (c, dt, dh, dw),
    normalised by its own mean and population variance (eps 1e-6 inside the
    root) unless `normalize_target` is false."""
    pred = model(x_b3thw, visible_idx, masked_idx, attention)
    tgt = _gather_rows(patchify(x_b3thw, model.cfg.encoder), masked_idx).float()
    if normalize_target:
        mu = tgt.mean(-1, keepdim=True)
        var = tgt.var(-1, keepdim=True, correction=0)
        tgt = (tgt - mu) / torch.sqrt(var + 1e-6)
    return (pred.float() - tgt).square().mean()
