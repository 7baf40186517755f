"""DPT decoder, the trunk of every dense head (counterpart of
l4p_tpu/models/dpt.py:80-130).

Module names are the released checkpoint's (checkpoint.py:258-300 of the
JAX package): `dpt.act_postprocess.{i}.{0,1}`, `dpt.scratch.layer{1-4}_rn`
and their alias `dpt.scratch.layer_rn.{i}` (the reference registers the same
convs twice, so its state dict carries both names), `dpt.scratch.refinenet{1-4}`,
`dpt.head1.0`, `dpt.head2.{0,2}`. All convs are 3D, NCDHW.

The fusion trunk (`ResidualConvUnit`, `FeatureFusionBlock`, `Scratch`,
`fuse`) is generic over 2D and 3D (`nd`): VGGT's DPT heads (models/vggt.py)
run the same topology on 2D frames, with refinenet4's residual unit left
out and the residual units adding their ReLU'd input (`relu_skip`); Video
Depth Anything's temporal head (models/vda.py) runs it on 2D frames with a
motion module after refinenet4 and refinenet3 and its tail in frame chunks.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from l4p_tpu_torch.config import DPTConfig
from l4p_tpu_torch.ops.conv import conv3d, conv_transpose3d
from l4p_tpu_torch.ops.resize import interpolate_bilinear, interpolate_trilinear, scaled_size


def rescale_kind(sf: Tuple[int, int, int]) -> str:
    """make_conv3d_custom dispatch (reference dpt_block.py:255-278)."""
    if not (all(s >= 0 for s in sf) or all(s <= 0 for s in sf)):
        raise ValueError(f"mixed up/down scale factors {sf}")
    if any(s > 0 for s in sf):
        return "up"
    if any(s < 0 for s in sf):
        return "down"
    return "id"


def _conv(cin: int, cout: int, k, device, dtype, nd: int = 3, **kw) -> nn.Module:
    return (nn.Conv3d if nd == 3 else nn.Conv2d)(cin, cout, k, device=device, dtype=dtype, **kw)


def conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, stride=1, padding=0) -> torch.Tensor:
    """F.conv3d on (B, C, T, H, W), F.conv2d on (B, C, H, W), in x's dtype."""
    f = F.conv3d if x.dim() == 5 else F.conv2d
    return f(x, w.to(x.dtype), None if b is None else b.to(x.dtype), stride=stride, padding=padding)


def resize(x: torch.Tensor, size: Sequence[int], align_corners: bool) -> torch.Tensor:
    """Trilinear on (B, C, T, H, W), bilinear on (B, C, H, W): both on the
    resize kernel (ops/resize.py)."""
    return (interpolate_trilinear if x.dim() == 5 else interpolate_bilinear)(x, size, align_corners)


class ResidualConvUnit(nn.Module):
    """relu-conv-relu-conv + x (reference dpt_block.py:136-157); with
    `relu_skip`, + relu(x): VGGT's unit applies an in-place ReLU to its
    input first, so its skip adds the ReLU'd input (vggt/heads/dpt_head.py,
    `_make_fusion_block`'s `nn.ReLU(inplace=True)`)."""

    def __init__(self, f: int, device=None, dtype=None, nd: int = 3, relu_skip: bool = False):
        super().__init__()
        self.relu_skip = relu_skip
        self.conv1 = _conv(f, f, 3, device, dtype, nd, padding=1)
        self.conv2 = _conv(f, f, 3, device, dtype, nd, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rx = F.relu(x)
        out = conv(rx, self.conv1.weight, self.conv1.bias, padding=1)
        out = conv(F.relu(out), self.conv2.weight, self.conv2.bias, padding=1)
        return out + (rx if self.relu_skip else x)


class FeatureFusionBlock(nn.Module):
    """Residual merge, residual conv unit, linear resize to `size`
    (align_corners=True), 1x1 conv (reference dpt_block.py:210-238).
    Without `has_residual` there is no resConfUnit1 (VGGT's refinenet4)."""

    def __init__(self, f: int, device=None, dtype=None, nd: int = 3, has_residual: bool = True,
                 relu_skip: bool = False):
        super().__init__()
        if has_residual:
            self.resConfUnit1 = ResidualConvUnit(f, device, dtype, nd, relu_skip)
        self.resConfUnit2 = ResidualConvUnit(f, device, dtype, nd, relu_skip)
        self.out_conv = _conv(f, f, 1, device, dtype, nd)

    def forward(self, x: torch.Tensor, res: Optional[torch.Tensor], size: Sequence[int]) -> torch.Tensor:
        out = x
        if res is not None:
            out = out + self.resConfUnit1(res)
        out = self.resConfUnit2(out)
        out = resize(out, size, align_corners=True)
        return conv(out, self.out_conv.weight, self.out_conv.bias)


class Scratch(nn.Module):
    """layer{1-4}_rn (3x3 convs to `f` channels, no bias) and
    refinenet{1-4}. `alias` also registers the convs as `layer_rn` (L4P's
    checkpoint carries both names); `nd`, `first_residual` and `relu_skip`
    as FeatureFusionBlock takes them (refinenet4's)."""

    def __init__(self, layer_dims: Sequence[int], f: int, device=None, dtype=None, nd: int = 3, alias: bool = True,
                 first_residual: bool = True, relu_skip: bool = False):
        super().__init__()
        convs = [_conv(layer_dims[i], f, 3, device, dtype, nd, padding=1, bias=False) for i in range(4)]
        for i, c in enumerate(convs):
            setattr(self, f"layer{i + 1}_rn", c)
        if alias:
            self.layer_rn = nn.ModuleList(convs)  # alias of layer{1-4}_rn, as registered upstream
        for i in range(4):
            setattr(self, f"refinenet{i + 1}", FeatureFusionBlock(f, device, dtype, nd, first_residual or i < 3,
                                                                  relu_skip))


def fuse(scratch: Scratch, layers: Sequence[torch.Tensor], sizes: Sequence[Sequence[int]],
         crop: bool = False, between: Optional[Callable[[int, torch.Tensor], torch.Tensor]] = None,
         chunk: Optional[int] = None, tail: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """The four rescaled features through layer{1-4}_rn and refinenet4 ..
    refinenet1, refinenet i resizing to sizes[i - 1]. `crop` cuts
    refinenet4's output to layer 3's T and H, not W, as L4P's reference
    does (dpt_head.py:70-72). `between(i, path)` replaces refinenet i's
    output for i = 4 and 3 (Video Depth Anything's motion modules); from
    refinenet2 on the trunk runs `chunk` batch entries at a time (all at
    once without it), each chunk's refinenet1 output through `tail`, and
    the chunks' results are concatenated."""
    rn = [conv(x, getattr(scratch, f"layer{i + 1}_rn").weight, None, padding=1) for i, x in enumerate(layers)]
    out = scratch.refinenet4(rn[3], None, sizes[3])
    if crop:
        out = out[:, :, : rn[2].shape[2], : rn[2].shape[3]]
    if between is not None:
        out = between(4, out)
    out = scratch.refinenet3(out, rn[2], sizes[2])
    if between is not None:
        out = between(3, out)
    n = out.shape[0]
    step = n if chunk is None else chunk
    parts = []
    for lo in range(0, n, step):
        part = scratch.refinenet2(out[lo: lo + step], rn[1][lo: lo + step], sizes[1])
        part = scratch.refinenet1(part, rn[0][lo: lo + step], sizes[0])
        parts.append(part if tail is None else tail(part))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


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
        self.scratch = Scratch(cfg.layer_dims, cfg.feature_dim, device, dtype)
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
        # refinenet i scales its input grid by fusion_scale_factors[i - 1]; refinenet4's is its own layer's
        sfs = cfg.fusion_scale_factors
        sizes = [None] * 4
        sizes[3] = scaled_size(layers[3].shape[2:], sfs[3])
        grid4 = (min(sizes[3][0], layers[2].shape[2]), min(sizes[3][1], layers[2].shape[3]), sizes[3][2])
        sizes[2] = scaled_size(grid4, sfs[2])
        sizes[1] = scaled_size(sizes[2], sfs[1])
        sizes[0] = scaled_size(sizes[1], sfs[0])
        path1 = fuse(d.scratch, layers, sizes, crop=True)

        out = conv3d(path1, d.head1[0].weight, d.head1[0].bias, padding=1)
        out = interpolate_trilinear(out, cfg.output_size or img_info, align_corners=True)
        out = F.relu(conv3d(out, d.head2[0].weight, d.head2[0].bias, padding=1))
        return conv3d(out, d.head2[2].weight, d.head2[2].bias)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from `generator` with the JAX package's
        init_dpt_params distribution: U(-a, a), a = 1/sqrt(fan_in), for
        weights and biases of every conv."""
        for m in self.modules():
            if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
                cin = m.in_channels
                a = 1.0 / math.sqrt(cin * math.prod(m.kernel_size))
                m.weight.uniform_(-a, a, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-a, a, generator=generator)
