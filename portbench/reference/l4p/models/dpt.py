"""DPT decoder, the trunk of every dense head (counterpart of
l4p_tpu/models/dpt.py:80-130).

Module names are the released checkpoint's (checkpoint.py:258-300 of the
JAX package): `dpt.act_postprocess.{i}.{0,1}`, `dpt.scratch.layer{1-4}_rn`
and their alias `dpt.scratch.layer_rn.{i}` (the reference registers the same
convs twice, so its state dict carries both names), `dpt.scratch.refinenet{1-4}`,
`dpt.head1.0`, `dpt.head2.{0,2}`. All convs are 3D, NCDHW.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.l4p.config import DPTConfig
from portbench.reference.l4p.ops.conv import conv3d, conv_transpose3d
from portbench.reference.l4p.ops.resize import interpolate_scale, interpolate_trilinear


def rescale_kind(sf: Tuple[int, int, int]) -> str:
    """make_conv3d_custom dispatch (reference dpt_block.py:255-278)."""
    if not (all(s >= 0 for s in sf) or all(s <= 0 for s in sf)):
        raise ValueError(f"mixed up/down scale factors {sf}")
    if any(s > 0 for s in sf):
        return "up"
    if any(s < 0 for s in sf):
        return "down"
    return "id"


def _conv(cin: int, cout: int, k, device, dtype, **kw) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, k, device=device, dtype=dtype, **kw)


class ResidualConvUnit(nn.Module):
    """relu-conv-relu-conv + x (reference dpt_block.py:136-157)."""

    def __init__(self, f: int, device=None, dtype=None):
        super().__init__()
        self.conv1 = _conv(f, f, 3, device, dtype, padding=1)
        self.conv2 = _conv(f, f, 3, device, dtype, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = conv3d(F.relu(x), self.conv1.weight, self.conv1.bias, padding=1)
        out = conv3d(F.relu(out), self.conv2.weight, self.conv2.bias, padding=1)
        return out + x


class FeatureFusionBlock(nn.Module):
    """Residual merge, residual conv unit, trilinear upsample
    (align_corners=True), 1x1 conv (reference dpt_block.py:210-238)."""

    def __init__(self, f: int, device=None, dtype=None):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(f, device, dtype)
        self.resConfUnit2 = ResidualConvUnit(f, device, dtype)
        self.out_conv = _conv(f, f, 1, device, dtype)

    def forward(self, x: torch.Tensor, res: Optional[torch.Tensor], sf: Tuple[int, int, int]) -> torch.Tensor:
        out = x
        if res is not None:
            out = out + self.resConfUnit1(res)
        out = self.resConfUnit2(out)
        out = interpolate_scale(out, sf, align_corners=True)
        return conv3d(out, self.out_conv.weight, self.out_conv.bias)


class Scratch(nn.Module):
    def __init__(self, cfg: DPTConfig, device=None, dtype=None):
        super().__init__()
        f = cfg.feature_dim
        convs = [_conv(cfg.layer_dims[i], f, 3, device, dtype, padding=1, bias=False) for i in range(4)]
        for i, c in enumerate(convs):
            setattr(self, f"layer{i + 1}_rn", c)
        self.layer_rn = nn.ModuleList(convs)  # alias of layer{1-4}_rn, as registered upstream
        for i in range(4):
            setattr(self, f"refinenet{i + 1}", FeatureFusionBlock(f, device, dtype))


class DPTAdapter(nn.Module):
    """Released `dpt` submodule: act_postprocess, scratch, head1, head2."""

    def __init__(self, cfg: DPTConfig, device=None, dtype=None):
        super().__init__()
        post = []
        for i, sf in enumerate(cfg.actpost_scale_factors):
            ld = cfg.layer_dims[i]
            kind = rescale_kind(sf)
            if kind == "up":
                stride = tuple(2 ** s for s in sf)
                rescale = nn.ConvTranspose3d(ld, ld, stride, stride=stride, device=device, dtype=dtype)
            elif kind == "down":
                stride = tuple(2 ** (-s) for s in sf)
                k = tuple((s // 2) * 2 + 1 for s in stride)
                rescale = _conv(ld, ld, k, device, dtype, stride=stride, padding=tuple(s // 2 for s in stride))
            else:
                rescale = nn.Identity()
            post.append(nn.Sequential(_conv(cfg.dim_tokens, ld, 1, device, dtype), rescale))
        self.act_postprocess = nn.ModuleList(post)
        self.scratch = Scratch(cfg, device, dtype)
        f = cfg.feature_dim
        self.head1 = nn.Sequential(_conv(f, f // 2, 3, device, dtype, padding=1))
        self.head2 = nn.Sequential(
            _conv(f // 2, cfg.last_dim, 3, device, dtype, padding=1),
            nn.ReLU(),
            _conv(cfg.last_dim, cfg.num_channels, 1, device, dtype),
        )


class DPTHead(nn.Module):
    """4 hook features -> (B, num_channels, *output_size)
    (DPTOutputAdapter_fix.forward, reference dpt_head.py:41-86)."""

    def __init__(self, cfg: DPTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.dpt = DPTAdapter(cfg, device, dtype)

    def forward(self, hook_feats: Sequence[torch.Tensor], img_info: Tuple[int, int, int]) -> torch.Tensor:
        cfg, d = self.cfg, self.dpt
        t, h, w = img_info
        grid = (t // cfg.patch_size[0], h // cfg.patch_size[1], w // cfg.patch_size[2])
        layers: List[torch.Tensor] = []
        for i, feat in enumerate(hook_feats):
            b, _, c = feat.shape
            x = feat.transpose(1, 2).reshape(b, c, *grid)
            proj, rescale = d.act_postprocess[i]
            x = conv3d(x, proj.weight, proj.bias)
            sf = cfg.actpost_scale_factors[i]
            kind = rescale_kind(sf)
            if kind == "up":
                x = conv_transpose3d(x, rescale.weight, rescale.bias, stride=rescale.stride)
            elif kind == "down":
                x = conv3d(x, rescale.weight, rescale.bias, stride=rescale.stride, padding=rescale.padding)
            layers.append(x)
        layers = [conv3d(x, d.scratch.layer_rn[i].weight, None, padding=1) for i, x in enumerate(layers)]

        sfs = cfg.fusion_scale_factors
        s = d.scratch
        path4 = s.refinenet4(layers[3], None, sfs[3])
        # the reference crops path_4 on T and H only, not W (dpt_head.py:70-72)
        path4 = path4[:, :, : layers[2].shape[2], : layers[2].shape[3]]
        path3 = s.refinenet3(path4, layers[2], sfs[2])
        path2 = s.refinenet2(path3, layers[1], sfs[1])
        path1 = s.refinenet1(path2, layers[0], sfs[0])

        out = conv3d(path1, d.head1[0].weight, d.head1[0].bias, padding=1)
        out = interpolate_trilinear(out, cfg.output_size or img_info, align_corners=True)
        out = F.relu(conv3d(out, d.head2[0].weight, d.head2[0].bias, padding=1))
        return conv3d(out, d.head2[2].weight, d.head2[2].bias)
