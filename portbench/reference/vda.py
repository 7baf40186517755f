"""Video Depth Anything's forward and long-video inference in plain fp32
PyTorch: the benchmark's reference for the `vda_l` configuration, written
from upstream's modules (github.com/DepthAnything/Video-Depth-Anything:
video_depth_anything/video_depth.py, dpt_temporal.py,
motion_module/motion_module.py, motion_module/attention.py, util/util.py;
Depth Anything V2's dinov2.py, dinov2_layers/, dpt.py, util/blocks.py), in
upstream's module and parameter names, importing nothing of the program and
running no kernel. The transformer block, patch embedding and product layers
are the VGGT reference's (portbench/reference/vggt.py), which are DINOv2's.

Departures from upstream, each forced by the benchmark:
- Everything runs in fp32 with TF32 off (`plain_fp32`), where upstream runs
  the model under fp16 autocast (and casts the head's output back to fp16);
  the long-video loop keeps its depth on the device in fp32, where upstream
  moves each frame to numpy.
- The frames arrive as uint8 (1, L, H, W, 3) at the network's size, H and W
  multiples of 14: upstream's cv2 bicubic resize to the lower-bound 518 side
  is host work outside the model, and the identity at these sizes. They are
  taken to [0, 1] and normalised with ImageNet's mean and std, as upstream's
  transform does.
- Spatial attention runs in blocks of the VGGT reference's `QUERY_BLOCK`
  queries and temporal attention in chunks of `TEMPORAL_CHUNK` positions
  (upstream calls xformers' memory-efficient attention), so that both fit
  on one card.
- `compute_scale_and_shift` sums in fp32 torch, where upstream sums in fp32
  numpy (another summation order).
- Under `fp8_products()` (portbench/reference/l4p/ops/lowp.py) the operands
  of every linear layer, convolution, attention product and the stitch's
  least-squares products are rounded to e4m3: the control that the
  correctness limits are set against.
"""

from __future__ import annotations

import json
import math
from types import SimpleNamespace
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.l4p.ops.lowp import q8
from portbench.reference.vggt import (MEAN, STD, Block, Conv2d, ConvTranspose2d, Linear, PatchEmbed,  # noqa: F401
                                      attention, plain_fp32)

TEMPORAL_CHUNK = 16384  # positions a chunk of temporal attention
INFER_LEN = 32
OVERLAP = 10
KEYFRAMES = [0, 12, 24, 25, 26, 27, 28, 29, 30, 31]
INTERP_LEN = 8


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over (P, heads, T, D), TEMPORAL_CHUNK positions at a time."""
    q, k, v = q8(q), q8(k), q8(v)
    scale = q.shape[-1] ** -0.5
    out = torch.empty_like(q)
    for i in range(0, q.shape[0], TEMPORAL_CHUNK):
        s = torch.matmul(q[i: i + TEMPORAL_CHUNK] * scale, k[i: i + TEMPORAL_CHUNK].transpose(-2, -1))
        out[i: i + TEMPORAL_CHUNK] = torch.matmul(torch.softmax(s, -1), v[i: i + TEMPORAL_CHUNK])
    return out


# ---------------------------------------------------------------------------
# Depth Anything V2: dinov2.py (vit_large, no registers)
# ---------------------------------------------------------------------------

class DinoVisionTransformer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        e, p = cfg.embed_dim, cfg.patch_size
        self.patch_size, self.embed_dim = p, e
        self.num_register_tokens = 0
        self.interpolate_antialias, self.interpolate_offset = cfg.interpolate_antialias, cfg.interpolate_offset
        self.patch_embed = PatchEmbed(p, e)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, e))
        self.pos_embed = nn.Parameter(torch.zeros(1, (cfg.img_size // p) ** 2 + 1, e))
        self.blocks = nn.ModuleList(Block(e, cfg.num_heads, cfg.mlp_ratio, cfg.init_values, eps=cfg.ln_eps)
                                    for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(e, eps=cfg.ln_eps)
        self.mask_token = nn.Parameter(torch.zeros(1, e))

    def interpolate_pos_encoding(self, x, w, h):
        previous_dtype = x.dtype
        npatch = x.shape[1] - 1
        N = self.pos_embed.shape[1] - 1
        if npatch == N and w == h:
            return self.pos_embed
        pos_embed = self.pos_embed.float()
        class_pos_embed = pos_embed[:, 0]
        patch_pos_embed = pos_embed[:, 1:]
        dim = x.shape[-1]
        w0 = w // self.patch_size
        h0 = h // self.patch_size
        w0, h0 = w0 + self.interpolate_offset, h0 + self.interpolate_offset
        sqrt_N = math.sqrt(N)
        sx, sy = float(w0) / sqrt_N, float(h0) / sqrt_N
        patch_pos_embed = nn.functional.interpolate(
            patch_pos_embed.reshape(1, int(sqrt_N), int(sqrt_N), dim).permute(0, 3, 1, 2),
            scale_factor=(sx, sy),
            mode="bicubic",
            antialias=self.interpolate_antialias,
        )
        assert int(w0) == patch_pos_embed.shape[-2]
        assert int(h0) == patch_pos_embed.shape[-1]
        patch_pos_embed = patch_pos_embed.permute(0, 2, 3, 1).view(1, -1, dim)
        return torch.cat((class_pos_embed.unsqueeze(0), patch_pos_embed), dim=1).to(previous_dtype)

    def prepare_tokens_with_masks(self, x):
        B, nc, w, h = x.shape
        x = self.patch_embed(x)
        x = torch.cat((self.cls_token.expand(x.shape[0], -1, -1), x), dim=1)
        return x + self.interpolate_pos_encoding(x, w, h)

    def _get_intermediate_layers_not_chunked(self, x, n=1):
        x = self.prepare_tokens_with_masks(x)
        output, total_block_len = [], len(self.blocks)
        blocks_to_take = range(total_block_len - n, total_block_len) if isinstance(n, int) else n
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in blocks_to_take:
                output.append(x)
        assert len(output) == len(blocks_to_take), f"only {len(output)} / {len(blocks_to_take)} blocks found"
        return output

    def get_intermediate_layers(self, x, n=1, return_class_token=False, norm=True):
        outputs = self._get_intermediate_layers_not_chunked(x, n)
        if norm:
            outputs = [self.norm(out) for out in outputs]
        class_tokens = [out[:, 0] for out in outputs]
        outputs = [out[:, 1 + self.num_register_tokens:] for out in outputs]
        if return_class_token:
            return tuple(zip(outputs, class_tokens))
        return tuple(outputs)


# ---------------------------------------------------------------------------
# motion_module/motion_module.py, attention.py
# ---------------------------------------------------------------------------

class PositionalEncoding(nn.Module):
    def __init__(self, d_model, dropout=0.0, max_len=32):
        super().__init__()
        self.dropout = nn.Dropout(p=dropout)
        position = torch.arange(max_len).unsqueeze(1)
        div_term = torch.exp(torch.arange(0, d_model, 2) * (-math.log(10000.0) / d_model))
        pe = torch.zeros(1, max_len, d_model)
        pe[0, :, 0::2] = torch.sin(position * div_term)
        pe[0, :, 1::2] = torch.cos(position * div_term)
        self.register_buffer("pe", pe)

    def forward(self, x):
        x = x + self.pe[:, :x.size(1)].to(x.dtype)
        return self.dropout(x)


class TemporalAttention(nn.Module):
    """CrossAttention without a context, as TemporalAttention builds it
    (pos_embedding_type "ape")."""

    def __init__(self, query_dim, heads=8, dim_head=64, temporal_max_len=32):
        super().__init__()
        inner_dim = dim_head * heads
        self.heads = heads
        self.to_q = Linear(query_dim, inner_dim, bias=False)
        self.to_k = Linear(query_dim, inner_dim, bias=False)
        self.to_v = Linear(query_dim, inner_dim, bias=False)
        self.to_out = nn.ModuleList([Linear(inner_dim, query_dim), nn.Dropout(0.0)])
        self.pos_encoder = PositionalEncoding(query_dim, dropout=0.0, max_len=temporal_max_len)

    def heads_out(self, hidden_states, video_length):
        """(b f) d c -> the heads' outputs before to_out, (b d) f c."""
        hidden_states = hidden_states.unflatten(0, (-1, video_length)).transpose(1, 2).flatten(0, 1)  # (b d) f c
        hidden_states = self.pos_encoder(hidden_states)
        query, key, value = self.to_q(hidden_states), self.to_k(hidden_states), self.to_v(hidden_states)
        bd, f, c = query.shape
        query, key, value = (t.reshape(bd, f, self.heads, c // self.heads).transpose(1, 2)
                             for t in (query, key, value))
        out = temporal_attention(query, key, value)
        return out.transpose(1, 2).reshape(bd, f, c)

    def forward(self, hidden_states, video_length=None):
        d = hidden_states.shape[1]
        hidden_states = self.to_out[1](self.to_out[0](self.heads_out(hidden_states, video_length)))
        return hidden_states.unflatten(0, (-1, d)).transpose(1, 2).flatten(0, 1)  # (b f) d c


class GEGLU(nn.Module):
    def __init__(self, dim_in, dim_out):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2)

    def forward(self, hidden_states):
        hidden_states, gate = self.proj(hidden_states).chunk(2, dim=-1)
        return hidden_states * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim, mult=4, dropout=0.0):
        super().__init__()
        inner_dim = int(dim * mult)
        self.net = nn.ModuleList([GEGLU(dim, inner_dim), nn.Dropout(dropout), Linear(inner_dim, dim)])

    def forward(self, hidden_states):
        for module in self.net:
            hidden_states = module(hidden_states)
        return hidden_states


class TemporalTransformerBlock(nn.Module):
    def __init__(self, dim, num_attention_heads, attention_head_dim, num_attention_blocks=2, temporal_max_len=32,
                 ff_mult=4, eps=1e-5):
        super().__init__()
        self.attention_blocks = nn.ModuleList(
            TemporalAttention(dim, num_attention_heads, attention_head_dim, temporal_max_len)
            for _ in range(num_attention_blocks))
        self.norms = nn.ModuleList(nn.LayerNorm(dim, eps=eps) for _ in range(num_attention_blocks))
        self.ff = FeedForward(dim, mult=ff_mult, dropout=0.0)
        self.ff_norm = nn.LayerNorm(dim, eps=eps)

    def forward(self, hidden_states, video_length=None):
        for attention_block, norm in zip(self.attention_blocks, self.norms):
            norm_hidden_states = norm(hidden_states)
            hidden_states = attention_block(norm_hidden_states, video_length=video_length) + hidden_states
        hidden_states = self.ff(self.ff_norm(hidden_states)) + hidden_states
        return hidden_states


class TemporalTransformer3DModel(nn.Module):
    def __init__(self, in_channels, num_attention_heads, attention_head_dim, num_layers, num_attention_blocks=2,
                 norm_num_groups=32, temporal_max_len=32, gn_eps=1e-6, ln_eps=1e-5, ff_mult=4):
        super().__init__()
        inner_dim = num_attention_heads * attention_head_dim
        self.norm = nn.GroupNorm(num_groups=norm_num_groups, num_channels=in_channels, eps=gn_eps, affine=True)
        self.proj_in = Linear(in_channels, inner_dim)
        self.transformer_blocks = nn.ModuleList(
            TemporalTransformerBlock(inner_dim, num_attention_heads, attention_head_dim, num_attention_blocks,
                                     temporal_max_len, ff_mult, ln_eps)
            for _ in range(num_layers))
        self.proj_out = Linear(inner_dim, in_channels)

    def forward(self, hidden_states):
        video_length = hidden_states.shape[2]
        hidden_states = hidden_states.transpose(1, 2).flatten(0, 1)  # b c f h w -> (b f) c h w
        batch, channel, height, width = hidden_states.shape
        residual = hidden_states
        hidden_states = self.norm(hidden_states)
        inner_dim = hidden_states.shape[1]
        hidden_states = hidden_states.permute(0, 2, 3, 1).reshape(batch, height * width, inner_dim).contiguous()
        hidden_states = self.proj_in(hidden_states)
        for block in self.transformer_blocks:
            hidden_states = block(hidden_states, video_length=video_length)
        hidden_states = self.proj_out(hidden_states)
        hidden_states = hidden_states.reshape(batch, height, width, inner_dim).permute(0, 3, 1, 2).contiguous()
        output = hidden_states + residual
        return output.unflatten(0, (-1, video_length)).transpose(1, 2)  # (b f) c h w -> b c f h w


class TemporalModule(nn.Module):
    def __init__(self, in_channels, cfg):
        super().__init__()
        heads = cfg.motion_heads
        self.temporal_transformer = TemporalTransformer3DModel(
            in_channels, heads, in_channels // heads, num_layers=1, num_attention_blocks=cfg.motion_attention_blocks,
            norm_num_groups=cfg.motion_groups, temporal_max_len=cfg.num_frames, gn_eps=cfg.motion_gn_eps,
            ln_eps=cfg.motion_ln_eps, ff_mult=cfg.ff_mult)

    def forward(self, input_tensor, encoder_hidden_states=None, attention_mask=None):
        return self.temporal_transformer(input_tensor)


# ---------------------------------------------------------------------------
# Depth Anything V2: util/blocks.py, dpt.py; Video Depth Anything: dpt_temporal.py
# ---------------------------------------------------------------------------

class ResidualConvUnit(nn.Module):
    def __init__(self, features, activation):
        super().__init__()
        self.conv1 = Conv2d(features, features, kernel_size=3, stride=1, padding=1, bias=True)
        self.conv2 = Conv2d(features, features, kernel_size=3, stride=1, padding=1, bias=True)
        self.activation = activation

    def forward(self, x):
        out = self.activation(x)
        out = self.conv1(out)
        out = self.activation(out)
        out = self.conv2(out)
        return out + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features, activation, align_corners=True, size=None):
        super().__init__()
        self.align_corners = align_corners
        self.out_conv = Conv2d(features, features, kernel_size=1, stride=1, padding=0, bias=True)
        self.resConfUnit1 = ResidualConvUnit(features, activation)
        self.resConfUnit2 = ResidualConvUnit(features, activation)
        self.size = size

    def forward(self, *xs, size=None):
        output = xs[0]
        if len(xs) == 2:
            res = self.resConfUnit1(xs[1])
            output = output + res
        output = self.resConfUnit2(output)
        if (size is None) and (self.size is None):
            modifier = {"scale_factor": 2}
        elif size is None:
            modifier = {"size": self.size}
        else:
            modifier = {"size": size}
        output = F.interpolate(output, **modifier, mode="bilinear", align_corners=self.align_corners)
        return self.out_conv(output)


class Scratch(nn.Module):
    pass


class DPTHeadTemporal(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        in_channels, features, out_channels = cfg.embed_dim, cfg.features, cfg.out_channels
        self.projects = nn.ModuleList([Conv2d(in_channels, o, kernel_size=1, stride=1, padding=0)
                                       for o in out_channels])
        self.resize_layers = nn.ModuleList([
            ConvTranspose2d(out_channels[0], out_channels[0], kernel_size=4, stride=4, padding=0),
            ConvTranspose2d(out_channels[1], out_channels[1], kernel_size=2, stride=2, padding=0),
            nn.Identity(),
            Conv2d(out_channels[3], out_channels[3], kernel_size=3, stride=2, padding=1)])
        self.scratch = Scratch()
        for i, o in enumerate(out_channels):
            setattr(self.scratch, f"layer{i + 1}_rn", Conv2d(o, features, kernel_size=3, stride=1, padding=1,
                                                             bias=False))
        for i in range(4):
            setattr(self.scratch, f"refinenet{i + 1}", FeatureFusionBlock(features, nn.ReLU(False)))
        head_features_1, head_features_2 = features, 32
        self.scratch.output_conv1 = Conv2d(head_features_1, head_features_1 // 2, kernel_size=3, stride=1, padding=1)
        self.scratch.output_conv2 = nn.Sequential(
            Conv2d(head_features_1 // 2, head_features_2, kernel_size=3, stride=1, padding=1), nn.ReLU(True),
            Conv2d(head_features_2, 1, kernel_size=1, stride=1, padding=0), nn.ReLU(True), nn.Identity())
        self.motion_modules = nn.ModuleList([TemporalModule(out_channels[2], cfg), TemporalModule(out_channels[3], cfg),
                                             TemporalModule(features, cfg), TemporalModule(features, cfg)])

    def forward(self, out_features, patch_h, patch_w, frame_length, micro_batch_size=4):
        out = []
        for i, x in enumerate(out_features):
            x = x[0]
            x = x.permute(0, 2, 1).reshape((x.shape[0], x.shape[-1], patch_h, patch_w)).contiguous()
            x = self.projects[i](x)
            x = self.resize_layers[i](x)
            out.append(x)
        layer_1, layer_2, layer_3, layer_4 = out

        B, T = layer_1.shape[0] // frame_length, frame_length
        mm = self.motion_modules
        layer_3 = mm[0](layer_3.unflatten(0, (B, T)).permute(0, 2, 1, 3, 4)).permute(0, 2, 1, 3, 4).flatten(0, 1)
        layer_4 = mm[1](layer_4.unflatten(0, (B, T)).permute(0, 2, 1, 3, 4)).permute(0, 2, 1, 3, 4).flatten(0, 1)

        layer_1_rn = self.scratch.layer1_rn(layer_1)
        layer_2_rn = self.scratch.layer2_rn(layer_2)
        layer_3_rn = self.scratch.layer3_rn(layer_3)
        layer_4_rn = self.scratch.layer4_rn(layer_4)

        path_4 = self.scratch.refinenet4(layer_4_rn, size=layer_3_rn.shape[2:])
        path_4 = mm[2](path_4.unflatten(0, (B, T)).permute(0, 2, 1, 3, 4)).permute(0, 2, 1, 3, 4).flatten(0, 1)
        path_3 = self.scratch.refinenet3(path_4, layer_3_rn, size=layer_2_rn.shape[2:])
        path_3 = mm[3](path_3.unflatten(0, (B, T)).permute(0, 2, 1, 3, 4)).permute(0, 2, 1, 3, 4).flatten(0, 1)

        batch_size = layer_1_rn.shape[0]
        if batch_size <= micro_batch_size or batch_size % micro_batch_size != 0:
            path_2 = self.scratch.refinenet2(path_3, layer_2_rn, size=layer_1_rn.shape[2:])
            path_1 = self.scratch.refinenet1(path_2, layer_1_rn)
            out = self.scratch.output_conv1(path_1)
            out = F.interpolate(out, (int(patch_h * 14), int(patch_w * 14)), mode="bilinear", align_corners=True)
            return self.scratch.output_conv2(out.float())
        ret = []
        for i in range(0, batch_size, micro_batch_size):
            path_2 = self.scratch.refinenet2(path_3[i:i + micro_batch_size], layer_2_rn[i:i + micro_batch_size],
                                             size=layer_1_rn[i:i + micro_batch_size].shape[2:])
            path_1 = self.scratch.refinenet1(path_2, layer_1_rn[i:i + micro_batch_size])
            out = self.scratch.output_conv1(path_1)
            out = F.interpolate(out, (int(patch_h * 14), int(patch_w * 14)), mode="bilinear", align_corners=True)
            ret.append(self.scratch.output_conv2(out.float()))
        return torch.cat(ret, dim=0)


# ---------------------------------------------------------------------------
# util/util.py
# ---------------------------------------------------------------------------

def compute_scale_and_shift(prediction, target, mask):
    prediction, target = q8(prediction.float()), q8(target.float())
    mask = mask.float()
    a_00 = torch.sum(mask * prediction * prediction)
    a_01 = torch.sum(mask * prediction)
    a_11 = torch.sum(mask)
    b_0 = torch.sum(mask * prediction * target)
    b_1 = torch.sum(mask * target)
    x_0 = torch.ones_like(a_00)
    x_1 = torch.zeros_like(a_00)
    det = a_00 * a_11 - a_01 * a_01
    if det != 0:
        x_0 = (a_11 * b_0 - a_01 * b_1) / det
        x_1 = (-a_01 * b_0 + a_00 * b_1) / det
    return x_0, x_1


def get_interpolate_frames(frame_list_pre, frame_list_post):
    assert len(frame_list_pre) == len(frame_list_post)
    min_w = 0.0
    max_w = 1.0
    step = (max_w - min_w) / (len(frame_list_pre) - 1)
    post_w_list = [min_w] + [i * step for i in range(1, len(frame_list_pre) - 1)] + [max_w]
    interpolated_frames = []
    for i in range(len(frame_list_pre)):
        interpolated_frames.append(frame_list_pre[i] * (1 - post_w_list[i]) + frame_list_post[i] * post_w_list[i])
    return interpolated_frames


# ---------------------------------------------------------------------------
# video_depth.py
# ---------------------------------------------------------------------------

class VideoDepthAnything(nn.Module):
    """`cfg` holds the configuration's numbers under the names of the
    program's VDAConfig, the encoder's at the top level (`read_config`)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.intermediate_layer_idx = list(cfg.intermediate_layers)
        self.pretrained = DinoVisionTransformer(cfg)
        self.head = DPTHeadTemporal(cfg)
        self.register_buffer("_mean", torch.tensor(MEAN).view(1, 1, 3, 1, 1), persistent=False)
        self.register_buffer("_std", torch.tensor(STD).view(1, 1, 3, 1, 1), persistent=False)

    def forward(self, x):
        B, T, C, H, W = x.shape
        patch_h, patch_w = H // 14, W // 14
        features = self.pretrained.get_intermediate_layers(x.flatten(0, 1), self.intermediate_layer_idx,
                                                           return_class_token=True)
        depth = self.head(features, patch_h, patch_w, T, self.cfg.micro_batch)
        depth = F.interpolate(depth, size=(H, W), mode="bilinear", align_corners=True)
        depth = F.relu(depth)
        return depth.squeeze(1).unflatten(0, (B, T))

    def infer_windows(self, frames_u8: torch.Tensor) -> Tuple[List[torch.Tensor], int]:
        """The first loop of infer_video_depth on a clip (1, L, H, W, 3)
        uint8: every window's depth, frame by frame, and L."""
        frames = frames_u8[0]
        frame_height, frame_width = frames.shape[1:3]
        frame_list = [((frames[i].permute(2, 0, 1).float() / 255.0)[None] - self._mean[0]) / self._std[0]
                      for i in range(frames.shape[0])]
        frame_step = INFER_LEN - OVERLAP
        org_video_len = len(frame_list)
        append_frame_len = (frame_step - (org_video_len % frame_step)) % frame_step + (INFER_LEN - frame_step)
        frame_list = frame_list + [frame_list[-1].clone()] * append_frame_len

        depth_list = []
        pre_input = None
        for frame_id in range(0, org_video_len, frame_step):
            cur_list = []
            for i in range(INFER_LEN):
                cur_list.append(frame_list[frame_id + i].unsqueeze(0))
            cur_input = torch.cat(cur_list, dim=1)
            if pre_input is not None:
                cur_input[:, :OVERLAP, ...] = pre_input[:, KEYFRAMES, ...]
            depth = self.forward(cur_input)
            depth = depth.to(cur_input.dtype)
            depth = F.interpolate(depth.flatten(0, 1).unsqueeze(1), size=(frame_height, frame_width), mode="bilinear",
                                  align_corners=True)
            depth_list += [depth[i][0] for i in range(depth.shape[0])]
            pre_input = cur_input
        return depth_list, org_video_len

    @torch.no_grad()
    def infer_video_depth(self, frames_u8: torch.Tensor):
        """A clip (1, L, H, W, 3) uint8 -> (depth (1, L, H, W), the raw
        windows (n, INFER_LEN, H, W), each later window's (scale, shift) (n
        - 1, 2))."""
        depth_list, org_video_len = self.infer_windows(frames_u8)
        depth, fits = align(depth_list, org_video_len)
        return depth[None], torch.stack(depth_list).unflatten(0, (-1, INFER_LEN)), fits


def align(depth_list: Sequence[torch.Tensor], org_video_len: int):
    """The second loop of infer_video_depth: the windows' frames (each (H,
    W)) -> (the stitched clip (L, H, W), each later window's (scale, shift)
    (n - 1, 2))."""
    depth_list = list(depth_list)
    depth_list_aligned = []
    ref_align = []
    align_len = OVERLAP - INTERP_LEN
    kf_align_list = KEYFRAMES[:align_len]
    fits = []

    for frame_id in range(0, len(depth_list), INFER_LEN):
        if len(depth_list_aligned) == 0:
            depth_list_aligned += depth_list[:INFER_LEN]
            for kf_id in kf_align_list:
                ref_align.append(depth_list[frame_id + kf_id])
        else:
            curr_align = []
            for i in range(len(kf_align_list)):
                curr_align.append(depth_list[frame_id + i])
            scale, shift = compute_scale_and_shift(torch.cat(curr_align), torch.cat(ref_align),
                                                   torch.cat([torch.ones_like(r) == 1 for r in ref_align]))
            fits.append(torch.stack([scale, shift]))

            pre_depth_list = depth_list_aligned[-INTERP_LEN:]
            post_depth_list = depth_list[frame_id + align_len:frame_id + OVERLAP]
            for i in range(len(post_depth_list)):
                post_depth_list[i] = post_depth_list[i] * scale + shift
                post_depth_list[i][post_depth_list[i] < 0] = 0
            depth_list_aligned[-INTERP_LEN:] = get_interpolate_frames(pre_depth_list, post_depth_list)

            for i in range(OVERLAP, INFER_LEN):
                new_depth = depth_list[frame_id + i] * scale + shift
                new_depth[new_depth < 0] = 0
                depth_list_aligned.append(new_depth)

            ref_align = ref_align[:1]
            for kf_id in kf_align_list[1:]:
                new_depth = depth_list[frame_id + kf_id] * scale + shift
                new_depth[new_depth < 0] = 0
                ref_align.append(new_depth)

    depth_list = depth_list_aligned
    stacked = torch.stack(depth_list[:org_video_len], dim=0)
    return stacked, (torch.stack(fits) if fits else stacked.new_zeros(0, 2))


def read_config(path) -> SimpleNamespace:
    """The configuration file's numbers under the names the modules above
    read: the encoder's (`pretrained`) at the top level, the head's and the
    motion modules' beside them."""
    with open(path) as f:
        tree = json.load(f)
    init, enc, mm, inf = (tree.get(k, {}) for k in ("init_args", "pretrained", "motion_module", "infer_video_depth"))
    if (inf["INFER_LEN"], inf["OVERLAP"], list(inf["KEYFRAMES"]), inf["INTERP_LEN"]) != (
            INFER_LEN, OVERLAP, KEYFRAMES, INTERP_LEN):
        raise ValueError("infer_video_depth's constants differ from upstream's, which this reference hard-codes")
    return SimpleNamespace(
        img_size=enc["img_size"], patch_size=enc["patch_size"], embed_dim=enc["embed_dim"], depth=enc["depth"],
        num_heads=enc["num_heads"], mlp_ratio=enc["mlp_ratio"], init_values=enc["init_values"],
        ln_eps=enc["layer_norm_eps"], interpolate_offset=enc["interpolate_offset"],
        interpolate_antialias=enc["interpolate_antialias"], intermediate_layers=tuple(tree["intermediate_layer_idx"]),
        features=init["features"], out_channels=tuple(init["out_channels"]), num_frames=init["num_frames"],
        motion_heads=mm["num_attention_heads"], motion_groups=mm["norm_num_groups"],
        motion_gn_eps=mm["group_norm_eps"], motion_ln_eps=mm["layer_norm_eps"],
        motion_attention_blocks=mm["num_attention_blocks"], ff_mult=mm["ff_mult"],
        micro_batch=tree["head"]["micro_batch_size"])
