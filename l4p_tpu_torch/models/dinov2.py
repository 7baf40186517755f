"""DINOv2 ViT (Oquab et al., "DINOv2: Learning Robust Visual Features without
Supervision", arXiv:2304.07193), run whole once per frame: VGGT's patch
embedder (dinov2_vitl14_reg, models/vggt.py) and Video Depth Anything's
encoder (Depth Anything V2's vit_large, models/vda.py), each built from its
`DINOv2Config` (config.py).

The patch conv, the cls token and its position, the patch positions resized
bicubically from the table's square grid to the frame's (to the grid's size,
or by scale factor as Depth Anything V2's copy of DINOv2 does), the
registers after cls (where there are any), the blocks (the encoder's
`Block` on DINOv2's `BlockConfig`), the final LayerNorm. The outputs are the
patch tokens of chosen blocks, each through the final LayerNorm
(`get_intermediate_layers`' `norm=True`). `mask_token` is upstream's and
unused at inference. The ImageNet normalisation of uint8 pixels is folded
into the patch weights (models/ingest.py).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from l4p_tpu_torch.config import DINOv2Config
from l4p_tpu_torch.models.encoder import AttentionFn, Block
from l4p_tpu_torch.models.ingest import folded_patch_weights
from l4p_tpu_torch.ops.conv import layer_norm, linear


class PatchEmbed2d(nn.Module):
    def __init__(self, e: int, p: int, device=None, dtype=None):
        super().__init__()
        self.proj = nn.Conv2d(3, e, p, stride=p, device=device, dtype=dtype)


class DINOv2(nn.Module):
    def __init__(self, cfg: DINOv2Config, device=None, dtype=None):
        super().__init__()
        self.cfg, e = cfg, cfg.embed_dim
        m = cfg.img_size // cfg.patch_size
        self.patch_embed = PatchEmbed2d(e, cfg.patch_size, device, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, e, device=device, dtype=dtype))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + m * m, e, device=device, dtype=dtype))
        if cfg.num_register_tokens:
            self.register_tokens = nn.Parameter(torch.zeros(1, cfg.num_register_tokens, e, device=device,
                                                            dtype=dtype))
        self.blocks = nn.ModuleList(Block(cfg.block, device, dtype) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(e, eps=cfg.ln_eps, device=device, dtype=dtype)
        self.mask_token = nn.Parameter(torch.zeros(1, e, device=device, dtype=dtype))

    def positions(self, gh: int, gw: int) -> torch.Tensor:
        """(1, 1 + gh * gw, E) fp32: cls's position, then the resized grid;
        the table as it is where the grid is the table's own."""
        cfg, pos = self.cfg, self.pos_embed.float()
        e, m = pos.shape[-1], math.isqrt(pos.shape[1] - 1)
        if gh == gw == m:
            return pos
        grid = pos[:, 1:].reshape(1, m, m, e).permute(0, 3, 1, 2)
        if cfg.interpolate_offset:
            off = cfg.interpolate_offset
            grid = F.interpolate(grid, scale_factor=((gh + off) / m, (gw + off) / m), mode="bicubic",
                                 antialias=cfg.interpolate_antialias)
        else:
            grid = F.interpolate(grid, size=(gh, gw), mode="bicubic", antialias=cfg.interpolate_antialias)
        if tuple(grid.shape[2:]) != (gh, gw):
            raise ValueError(f"the position table resized to {tuple(grid.shape[2:])}, not the grid {(gh, gw)}")
        return torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, e)], 1)

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The patch weights with the normalisation folded in (fp32), for a
        caller that embeds several batches of frames with one fold."""
        return folded_patch_weights(self.patch_embed.proj)

    def intermediate_layers(self, rgb_u8: torch.Tensor, attention: AttentionFn, layers: Sequence[int],
                            folded: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> List[torch.Tensor]:
        """(N, H, W, 3) uint8 -> [(N, H/p * W/p, E) normed patch tokens of
        block i for i in `layers`]."""
        cfg, p = self.cfg, self.cfg.patch_size
        n, h, w, _ = rgb_u8.shape
        gh, gw = h // p, w // p
        dtype = self.cls_token.dtype
        w_fold, b_fold = self.folded() if folded is None else folded
        x = rgb_u8.to(dtype).reshape(n, gh, p, gw, p, 3).permute(0, 1, 3, 5, 2, 4).reshape(n, gh * gw, 3 * p * p)
        x = linear(x, w_fold.to(dtype), b_fold.to(dtype))  # the features in the conv weight's order (c, dh, dw)
        x = torch.cat([self.cls_token.expand(n, -1, -1), x], 1) + self.positions(gh, gw).to(dtype)
        if cfg.num_register_tokens:
            x = torch.cat([x[:, :1], self.register_tokens.expand(n, -1, -1), x[:, 1:]], 1)
        out = {}
        for i, blk in enumerate(self.blocks[:max(layers) + 1]):
            x = blk(x, attention)
            if i in layers:
                out[i] = x
        start = 1 + cfg.num_register_tokens
        return [layer_norm(out[i][:, start:], self.norm.weight, self.norm.bias, cfg.ln_eps) for i in layers]

    def forward(self, rgb_u8: torch.Tensor, attention: AttentionFn) -> torch.Tensor:
        """(N, H, W, 3) uint8 -> (N, H/p * W/p, E) normed patch tokens of the last block."""
        return self.intermediate_layers(rgb_u8, attention, (self.cfg.depth - 1,))[0]
