"""SAM 2.1's video propagation in plain fp32 PyTorch: the benchmark's
reference for the `sam2_1_hiera_l` configuration, written from upstream's
modules (github.com/facebookresearch/sam2: sam2/modeling/backbones/
hieradet.py, image_encoder.py, utils.py; position_encoding.py;
memory_attention.py; memory_encoder.py; sam/transformer.py,
prompt_encoder.py, mask_decoder.py; sam2_utils.py; sam2_base.py;
sam2_video_predictor.py) in upstream's module and parameter names and its
sequence-first layouts, importing nothing of the program and running no
kernel.

`SAM2Base.propagate` is the video predictor's forward propagation from
clicks on frame 0: upstream's per-frame `track_step` with the output
dictionary of every frame, from which `_prepare_memory_conditioned_features`
picks the memories and object pointers as upstream does. Each stage can
also run alone from given inputs (`forward_image`, `condition`, the
`memory_attention` module, `_forward_sam_heads`, `_encode_new_memory`), so
that a comparison can take up the program's own memory bank and choices.

Departures from upstream, each forced by the benchmark:
- Everything runs in fp32 with TF32 off (`plain_fp32`), where upstream runs
  under bf16 autocast.
- The frames arrive as uint8 (1, T, S, S, 3) at the network's size S;
  upstream's resize of each frame to it is host work outside the model.
  They are taken to [0, 1] and normalised with ImageNet's mean and std, as
  the predictor's loader does.
- All objects run as one batch, where the predictor runs them one at a
  time (each object's computation is its own either way).
- Each frame's memory is kept in fp32, where the predictor stores it in
  bf16 (`_run_single_frame_inference`'s offload).
- Attention runs in blocks of `KEY_BLOCK` keys with a running maximum and
  sum (upstream calls scaled_dot_product_attention), so that 28,736 keys for
  8 objects fit on one card.
- `fill_hole_area` (a compiled connected-components extension) is not run,
  as upstream does not run it where the extension is not built.
- Under `fp8_products()` (portbench/reference/l4p/ops/lowp.py) the operands
  of every linear layer, convolution and attention product are rounded to
  e4m3: the control that the correctness limits are set against.
"""

from __future__ import annotations

import json
import math
from types import SimpleNamespace
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.l4p.ops.lowp import q8
from portbench.reference.vggt import MEAN, STD, ConvTranspose2d, Linear, plain_fp32  # noqa: F401

KEY_BLOCK = 4096  # keys a block of attention
NO_OBJ_SCORE = -1024.0


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return F.conv2d(q8(x), q8(self.weight), self.bias, self.stride, self.padding, self.dilation, self.groups)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over (B, H, N, D), KEY_BLOCK keys at a time."""
    q, k, v = q8(q), q8(k), q8(v)
    q = q * q.shape[-1] ** -0.5
    m = torch.full(q.shape[:-1] + (1,), -math.inf, device=q.device, dtype=q.dtype)
    s_sum = torch.zeros_like(m)
    acc = torch.zeros(q.shape[:-1] + (v.shape[-1],), device=q.device, dtype=q.dtype)
    for i in range(0, k.shape[2], KEY_BLOCK):
        s = torch.matmul(q, k[:, :, i: i + KEY_BLOCK].transpose(-2, -1))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        s_sum = s_sum * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, v[:, :, i: i + KEY_BLOCK])
        m = m_new
    return acc / s_sum


class LayerNorm2d(nn.LayerNorm):
    """sam2_utils.LayerNorm2d: LayerNorm over the channels of (B, C, H, W)."""

    def __init__(self, num_channels: int, eps: float = 1e-6):
        super().__init__(num_channels, eps=eps)

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class MLP(nn.Module):
    """sam2_utils.MLP."""

    def __init__(self, input_dim, hidden_dim, output_dim, num_layers, activation=nn.ReLU, sigmoid_output=False):
        super().__init__()
        self.num_layers = num_layers
        h = [hidden_dim] * (num_layers - 1)
        self.layers = nn.ModuleList(Linear(n, k) for n, k in zip([input_dim] + h, h + [output_dim]))
        self.sigmoid_output = sigmoid_output
        self.act = activation()

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = self.act(layer(x)) if i < self.num_layers - 1 else layer(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


# ---------------------------------------------------------------------------
# position_encoding.py
# ---------------------------------------------------------------------------

class PositionEmbeddingSine(nn.Module):
    def __init__(self, num_pos_feats, temperature=10000):
        super().__init__()
        self.num_pos_feats, self.temperature, self.scale = num_pos_feats // 2, temperature, 2 * math.pi

    @torch.no_grad()
    def forward(self, x):
        b, _, h, w = x.shape
        y_embed = torch.arange(1, h + 1, dtype=torch.float32, device=x.device).view(1, -1, 1).repeat(b, 1, w)
        x_embed = torch.arange(1, w + 1, dtype=torch.float32, device=x.device).view(1, 1, -1).repeat(b, h, 1)
        eps = 1e-6
        y_embed = y_embed / (y_embed[:, -1:, :] + eps) * self.scale
        x_embed = x_embed / (x_embed[:, :, -1:] + eps) * self.scale
        dim_t = torch.arange(self.num_pos_feats, dtype=torch.float32, device=x.device)
        dim_t = self.temperature ** (2 * (dim_t // 2) / self.num_pos_feats)
        pos_x = x_embed[:, :, :, None] / dim_t
        pos_y = y_embed[:, :, :, None] / dim_t
        pos_x = torch.stack((pos_x[:, :, :, 0::2].sin(), pos_x[:, :, :, 1::2].cos()), dim=4).flatten(3)
        pos_y = torch.stack((pos_y[:, :, :, 0::2].sin(), pos_y[:, :, :, 1::2].cos()), dim=4).flatten(3)
        return torch.cat((pos_y, pos_x), dim=3).permute(0, 3, 1, 2)


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats=64):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.randn((2, num_pos_feats)))

    def _pe_encoding(self, coords):
        coords = 2 * coords - 1
        coords = coords @ self.positional_encoding_gaussian_matrix
        coords = 2 * math.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)

    def forward(self, size):
        h, w = size
        grid = torch.ones((h, w), device=self.positional_encoding_gaussian_matrix.device, dtype=torch.float32)
        y_embed = (grid.cumsum(dim=0) - 0.5) / h
        x_embed = (grid.cumsum(dim=1) - 0.5) / w
        return self._pe_encoding(torch.stack([x_embed, y_embed], dim=-1)).permute(2, 0, 1)

    def forward_with_coords(self, coords_input, image_size):
        coords = coords_input.clone()
        coords[:, :, 0] = coords[:, :, 0] / image_size[1]
        coords[:, :, 1] = coords[:, :, 1] / image_size[0]
        return self._pe_encoding(coords.to(torch.float))


def init_t_xy(end_x, end_y):
    t = torch.arange(end_x * end_y, dtype=torch.float32)
    return (t % end_x).float(), torch.div(t, end_x, rounding_mode="floor").float()


def compute_axial_cis(dim, end_x, end_y, theta=10000.0):
    freqs_x = 1.0 / (theta ** (torch.arange(0, dim, 4)[: (dim // 4)].float() / dim))
    freqs_y = 1.0 / (theta ** (torch.arange(0, dim, 4)[: (dim // 4)].float() / dim))
    t_x, t_y = init_t_xy(end_x, end_y)
    freqs_x = torch.outer(t_x, freqs_x)
    freqs_y = torch.outer(t_y, freqs_y)
    return torch.cat([torch.polar(torch.ones_like(freqs_x), freqs_x), torch.polar(torch.ones_like(freqs_y), freqs_y)],
                     dim=-1)


def apply_rotary_enc(xq, xk, freqs_cis, repeat_freqs_k=False):
    xq_ = torch.view_as_complex(xq.float().reshape(*xq.shape[:-1], -1, 2))
    xk_ = torch.view_as_complex(xk.float().reshape(*xk.shape[:-1], -1, 2)) if xk.shape[-2] != 0 else None
    freqs_cis = freqs_cis.view(*[d if i >= xq_.ndim - 2 else 1 for i, d in enumerate(xq_.shape)])
    xq_out = torch.view_as_real(xq_ * freqs_cis).flatten(3)
    if xk_ is None:
        return xq_out.type_as(xq), xk
    if repeat_freqs_k:
        r = xk_.shape[-2] // xq_.shape[-2]
        freqs_cis = freqs_cis.repeat(*([1] * (freqs_cis.ndim - 2)), r, 1)
    xk_out = torch.view_as_real(xk_ * freqs_cis).flatten(3)
    return xq_out.type_as(xq), xk_out.type_as(xk)


def get_1d_sine_pe(pos_inds, dim, temperature=10000):
    pe_dim = dim // 2
    dim_t = torch.arange(pe_dim, dtype=torch.float32, device=pos_inds.device)
    dim_t = temperature ** (2 * (dim_t // 2) / pe_dim)
    pos_embed = pos_inds.unsqueeze(-1) / dim_t
    return torch.cat([pos_embed.sin(), pos_embed.cos()], dim=-1)


# ---------------------------------------------------------------------------
# backbones/hieradet.py, utils.py, image_encoder.py
# ---------------------------------------------------------------------------

def window_partition(x, window_size):
    b, h, w, c = x.shape
    pad_h = (window_size - h % window_size) % window_size
    pad_w = (window_size - w % window_size) % window_size
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.view(b, hp // window_size, window_size, wp // window_size, window_size, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size, window_size, c), (hp, wp)


def window_unpartition(windows, window_size, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // window_size // window_size)
    x = windows.reshape(b, hp // window_size, wp // window_size, window_size, window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w, :] if hp > h or wp > w else x


def do_pool(x, pool):
    if pool is None:
        return x
    return pool(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class MultiScaleAttention(nn.Module):
    def __init__(self, dim, dim_out, num_heads, q_pool=None):
        super().__init__()
        self.num_heads, self.q_pool = num_heads, q_pool
        self.qkv = Linear(dim, dim_out * 3)
        self.proj = Linear(dim_out, dim_out)

    def heads(self, x):
        """The heads' outputs (B, H', W', C_out) before `proj`."""
        b, h, w, _ = x.shape
        qkv = self.qkv(x).reshape(b, h * w, 3, self.num_heads, -1)
        q, k, v = torch.unbind(qkv, 2)
        if self.q_pool:
            q = do_pool(q.reshape(b, h, w, -1), self.q_pool)
            h, w = q.shape[1:3]
            q = q.reshape(b, h * w, self.num_heads, -1)
        x = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)
        return x.reshape(b, h, w, -1)

    def forward(self, x):
        return self.proj(self.heads(x))


class MultiScaleBlock(nn.Module):
    def __init__(self, dim, dim_out, num_heads, q_stride=None, window_size=0):
        super().__init__()
        self.dim, self.dim_out = dim, dim_out
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.window_size = window_size
        self.pool, self.q_stride = None, q_stride
        if self.q_stride:
            self.pool = nn.MaxPool2d(kernel_size=q_stride, stride=q_stride, ceil_mode=False)
        self.attn = MultiScaleAttention(dim, dim_out, num_heads=num_heads, q_pool=self.pool)
        self.norm2 = nn.LayerNorm(dim_out, eps=1e-6)
        self.mlp = MLP(dim_out, int(dim_out * 4.0), dim_out, num_layers=2, activation=nn.GELU)
        if dim != dim_out:
            self.proj = Linear(dim, dim_out)

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.dim != self.dim_out:
            shortcut = do_pool(self.proj(x), self.pool)
        window_size = self.window_size
        if window_size > 0:
            h, w = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, window_size)
        x = self.attn(x)
        if self.q_stride:
            window_size = self.window_size // self.q_stride[0]
            h, w = shortcut.shape[1:3]
            pad_h = (window_size - h % window_size) % window_size
            pad_w = (window_size - w % window_size) % window_size
            pad_hw = (h + pad_h, w + pad_w)
        if self.window_size > 0:
            x = window_unpartition(x, window_size, pad_hw, (h, w))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim):
        super().__init__()
        self.proj = Conv2d(3, embed_dim, kernel_size=7, stride=4, padding=3)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)


class Hiera(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        embed_dim, num_heads, stages = cfg.embed_dim, cfg.num_heads, cfg.stages
        self.window_spec = cfg.window_spec
        self.stage_ends = [sum(stages[:i]) - 1 for i in range(1, len(stages) + 1)]
        q_pool_blocks = [x + 1 for x in self.stage_ends[:-1]][: cfg.q_pool]
        self.patch_embed = PatchEmbed(embed_dim)
        self.global_att_blocks = cfg.global_att_blocks
        self.pos_embed = nn.Parameter(torch.zeros(1, embed_dim, *cfg.window_pos_embed_bkg_spatial_size))
        self.pos_embed_window = nn.Parameter(torch.zeros(1, embed_dim, self.window_spec[0], self.window_spec[0]))
        cur_stage = 1
        self.blocks = nn.ModuleList()
        for i in range(sum(stages)):
            dim_out = embed_dim
            window_size = self.window_spec[cur_stage - 1]
            window_size = 0 if i in self.global_att_blocks else window_size
            if i - 1 in self.stage_ends:
                dim_out, num_heads = int(embed_dim * 2.0), int(num_heads * 2.0)
                cur_stage += 1
            self.blocks.append(MultiScaleBlock(embed_dim, dim_out, num_heads,
                                               q_stride=(2, 2) if i in q_pool_blocks else None,
                                               window_size=window_size))
            embed_dim = dim_out
        self.channel_list = [self.blocks[i].dim_out for i in self.stage_ends[::-1]]

    def _get_pos_embed(self, hw):
        h, w = hw
        pos_embed = F.interpolate(self.pos_embed, size=(h, w), mode="bicubic")
        win = self.pos_embed_window
        pos_embed = pos_embed + win.tile([x // y for x, y in zip(pos_embed.shape, win.shape)])
        return pos_embed.permute(0, 2, 3, 1)

    def forward(self, x):
        x = self.patch_embed(x)
        x = x + self._get_pos_embed(x.shape[1:3])
        outputs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.stage_ends:
                outputs.append(x.permute(0, 3, 1, 2))
        return outputs


class FpnNeck(nn.Module):
    def __init__(self, d_model, backbone_channel_list, fpn_top_down_levels):
        super().__init__()
        self.position_encoding = PositionEmbeddingSine(d_model)
        self.convs = nn.ModuleList()
        for dim in backbone_channel_list:
            current = nn.Sequential()
            current.add_module("conv", Conv2d(dim, d_model, kernel_size=1))
            self.convs.append(current)
        self.fpn_top_down_levels = list(fpn_top_down_levels)

    def forward(self, xs):
        out, pos = [None] * len(self.convs), [None] * len(self.convs)
        prev_features = None
        n = len(self.convs) - 1
        for i in range(n, -1, -1):
            lateral_features = self.convs[n - i](xs[i])
            if i in self.fpn_top_down_levels and prev_features is not None:
                top_down_features = F.interpolate(prev_features.to(dtype=torch.float32), scale_factor=2.0,
                                                  mode="nearest", align_corners=None, antialias=False)
                prev_features = lateral_features + top_down_features
            else:
                prev_features = lateral_features
            out[i] = prev_features
            pos[i] = self.position_encoding(prev_features).to(prev_features.dtype)
        return out, pos


class ImageEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.trunk = Hiera(cfg)
        self.neck = FpnNeck(cfg.d_model, self.trunk.channel_list, cfg.fpn_top_down_levels)
        self.scalp = cfg.scalp

    def forward(self, sample):
        features, pos = self.neck(self.trunk(sample))
        if self.scalp > 0:
            features, pos = features[: -self.scalp], pos[: -self.scalp]
        return {"vision_features": features[-1], "vision_pos_enc": pos, "backbone_fpn": features}


# ---------------------------------------------------------------------------
# sam/transformer.py, memory_attention.py
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, embedding_dim, num_heads, downsample_rate=1, kv_in_dim=None):
        super().__init__()
        self.kv_in_dim = kv_in_dim if kv_in_dim is not None else embedding_dim
        self.internal_dim = embedding_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = Linear(embedding_dim, self.internal_dim)
        self.k_proj = Linear(self.kv_in_dim, self.internal_dim)
        self.v_proj = Linear(self.kv_in_dim, self.internal_dim)
        self.out_proj = Linear(self.internal_dim, embedding_dim)

    def _separate_heads(self, x, num_heads):
        b, n, c = x.shape
        return x.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)

    def _recombine_heads(self, x):
        b, n_heads, n_tokens, c_per_head = x.shape
        return x.transpose(1, 2).reshape(b, n_tokens, n_heads * c_per_head)

    def forward(self, q, k, v):
        q = self._separate_heads(self.q_proj(q), self.num_heads)
        k = self._separate_heads(self.k_proj(k), self.num_heads)
        v = self._separate_heads(self.v_proj(v), self.num_heads)
        return self.out_proj(self._recombine_heads(attention(q, k, v)))


class RoPEAttention(Attention):
    def __init__(self, *args, rope_theta=10000.0, rope_k_repeat=False, feat_sizes=(64, 64), **kwargs):
        super().__init__(*args, **kwargs)
        self.theta = rope_theta
        self.freqs_cis = compute_axial_cis(self.internal_dim // self.num_heads, feat_sizes[0], feat_sizes[1],
                                           rope_theta)
        self.rope_k_repeat = rope_k_repeat

    def heads(self, q, k, v, num_k_exclude_rope=0):
        """The head's output (B, Nq, C) before `out_proj`."""
        q = self._separate_heads(self.q_proj(q), self.num_heads)
        k = self._separate_heads(self.k_proj(k), self.num_heads)
        v = self._separate_heads(self.v_proj(v), self.num_heads)
        self.freqs_cis = self.freqs_cis.to(q.device)
        num_k_rope = k.size(-2) - num_k_exclude_rope
        q, k_rope = apply_rotary_enc(q, k[:, :, :num_k_rope], freqs_cis=self.freqs_cis,
                                     repeat_freqs_k=self.rope_k_repeat)
        k = torch.cat([k_rope, k[:, :, num_k_rope:]], dim=2)
        return self._recombine_heads(attention(q, k, v))

    def forward(self, q, k, v, num_k_exclude_rope=0):
        return self.out_proj(self.heads(q, k, v, num_k_exclude_rope))


class MemoryAttentionLayer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, fs = cfg.d_model, (cfg.feat_size, cfg.feat_size)
        self.self_attn = RoPEAttention(d, 1, rope_theta=cfg.rope_theta, feat_sizes=fs)
        self.cross_attn_image = RoPEAttention(d, 1, rope_theta=cfg.rope_theta, feat_sizes=fs, rope_k_repeat=True,
                                              kv_in_dim=cfg.mem_dim)
        self.linear1 = Linear(d, cfg.memory_ffn)
        self.linear2 = Linear(cfg.memory_ffn, d)
        self.norm1, self.norm2, self.norm3 = nn.LayerNorm(d), nn.LayerNorm(d), nn.LayerNorm(d)

    def forward(self, tgt, memory, pos=None, query_pos=None, num_k_exclude_rope=0):
        tgt2 = self.norm1(tgt)
        tgt = tgt + self.self_attn(tgt2, tgt2, v=tgt2)
        tgt2 = self.norm2(tgt)
        tgt = tgt + self.cross_attn_image(q=tgt2, k=memory + pos, v=memory, num_k_exclude_rope=num_k_exclude_rope)
        tgt2 = self.norm3(tgt)
        return tgt + self.linear2(F.relu(self.linear1(tgt2)))


class MemoryAttention(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList(MemoryAttentionLayer(cfg) for _ in range(cfg.memory_layers))
        self.norm = nn.LayerNorm(cfg.d_model)

    def forward(self, curr, memory, curr_pos=None, memory_pos=None, num_obj_ptr_tokens=0):
        """Sequence-first: curr (HW, B, C), memory (Nk, B, mem_dim) -> (HW, B, C)."""
        output = curr + 0.1 * curr_pos
        output, memory, memory_pos = output.transpose(0, 1), memory.transpose(0, 1), memory_pos.transpose(0, 1)
        curr_pos = curr_pos.transpose(0, 1)
        for layer in self.layers:
            output = layer(tgt=output, memory=memory, pos=memory_pos, query_pos=curr_pos,
                           num_k_exclude_rope=num_obj_ptr_tokens)
        return self.norm(output).transpose(0, 1)


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, embedding_dim, num_heads, mlp_dim=2048, attention_downsample_rate=2, skip_first_layer_pe=False):
        super().__init__()
        self.self_attn = Attention(embedding_dim, num_heads)
        self.norm1 = nn.LayerNorm(embedding_dim)
        self.cross_attn_token_to_image = Attention(embedding_dim, num_heads, downsample_rate=attention_downsample_rate)
        self.norm2 = nn.LayerNorm(embedding_dim)
        self.mlp = MLP(embedding_dim, mlp_dim, embedding_dim, num_layers=2, activation=nn.ReLU)
        self.norm3 = nn.LayerNorm(embedding_dim)
        self.norm4 = nn.LayerNorm(embedding_dim)
        self.cross_attn_image_to_token = Attention(embedding_dim, num_heads, downsample_rate=attention_downsample_rate)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(q=queries, k=queries, v=queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q=q, k=q, v=queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q=q, k=k, v=keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(q=k, k=q, v=queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth, embedding_dim, num_heads, mlp_dim, attention_downsample_rate=2):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim, attention_downsample_rate, i == 0)
            for i in range(depth))
        self.final_attn_token_to_image = Attention(embedding_dim, num_heads,
                                                   downsample_rate=attention_downsample_rate)
        self.norm_final_attn = nn.LayerNorm(embedding_dim)

    def forward(self, image_embedding, image_pe, point_embedding):
        image_embedding = image_embedding.flatten(2).permute(0, 2, 1)
        image_pe = image_pe.flatten(2).permute(0, 2, 1)
        queries, keys = point_embedding, image_embedding
        for layer in self.layers:
            queries, keys = layer(queries=queries, keys=keys, query_pe=point_embedding, key_pe=image_pe)
        q, k = queries + point_embedding, keys + image_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q=q, k=k, v=keys))
        return queries, keys


# ---------------------------------------------------------------------------
# sam/prompt_encoder.py, sam/mask_decoder.py
# ---------------------------------------------------------------------------

class PromptEncoder(nn.Module):
    def __init__(self, embed_dim, image_embedding_size, input_image_size, mask_in_chans):
        super().__init__()
        self.embed_dim, self.input_image_size = embed_dim, input_image_size
        self.image_embedding_size = image_embedding_size
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.mask_downscaling = nn.Sequential(
            Conv2d(1, mask_in_chans // 4, kernel_size=2, stride=2), LayerNorm2d(mask_in_chans // 4), nn.GELU(),
            Conv2d(mask_in_chans // 4, mask_in_chans, kernel_size=2, stride=2), LayerNorm2d(mask_in_chans), nn.GELU(),
            Conv2d(mask_in_chans, embed_dim, kernel_size=1))
        self.no_mask_embed = nn.Embedding(1, embed_dim)

    def get_dense_pe(self):
        return self.pe_layer(self.image_embedding_size).unsqueeze(0)

    def _embed_points(self, points, labels, pad):
        points = points + 0.5
        if pad:
            points = torch.cat([points, torch.zeros((points.shape[0], 1, 2), device=points.device)], dim=1)
            labels = torch.cat([labels, -torch.ones((labels.shape[0], 1), device=labels.device)], dim=1)
        point_embedding = self.pe_layer.forward_with_coords(points, self.input_image_size)
        point_embedding[labels == -1] = 0.0
        point_embedding[labels == -1] += self.not_a_point_embed.weight
        for i in range(4):
            point_embedding[labels == i] += self.point_embeddings[i].weight
        return point_embedding

    def forward(self, points):
        coords, labels = points
        sparse = self._embed_points(coords, labels, pad=True)
        dense = self.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(coords.shape[0], -1,
                                                                      *self.image_embedding_size)
        return sparse, dense


class MaskDecoder(nn.Module):
    def __init__(self, transformer_dim, transformer, num_multimask_outputs=3, iou_head_depth=3,
                 iou_head_hidden_dim=256, stability_delta=0.05, stability_thresh=0.98):
        super().__init__()
        self.transformer = transformer
        self.iou_token = nn.Embedding(1, transformer_dim)
        self.num_mask_tokens = num_multimask_outputs + 1
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, transformer_dim)
        self.obj_score_token = nn.Embedding(1, transformer_dim)
        self.output_upscaling = nn.Sequential(
            ConvTranspose2d(transformer_dim, transformer_dim // 4, kernel_size=2, stride=2),
            LayerNorm2d(transformer_dim // 4), nn.GELU(),
            ConvTranspose2d(transformer_dim // 4, transformer_dim // 8, kernel_size=2, stride=2), nn.GELU())
        self.conv_s0 = Conv2d(transformer_dim, transformer_dim // 8, kernel_size=1, stride=1)
        self.conv_s1 = Conv2d(transformer_dim, transformer_dim // 4, kernel_size=1, stride=1)
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(transformer_dim, transformer_dim, transformer_dim // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(transformer_dim, iou_head_hidden_dim, self.num_mask_tokens, iou_head_depth,
                                       sigmoid_output=True)
        self.pred_obj_score_head = MLP(transformer_dim, transformer_dim, 1, 3)
        self.dynamic_multimask_stability_delta = stability_delta
        self.dynamic_multimask_stability_thresh = stability_thresh

    def forward(self, image_embeddings, image_pe, sparse_prompt_embeddings, dense_prompt_embeddings,
                multimask_output, high_res_features):
        masks, iou_pred, mask_tokens_out, object_score_logits = self.predict_masks(
            image_embeddings, image_pe, sparse_prompt_embeddings, dense_prompt_embeddings, high_res_features)
        if multimask_output:
            masks, iou_pred = masks[:, 1:, :, :], iou_pred[:, 1:]
            sam_tokens_out = mask_tokens_out[:, 1:]
        else:
            masks, iou_pred = self._dynamic_multimask_via_stability(masks, iou_pred)
            sam_tokens_out = mask_tokens_out[:, 0:1]
        return masks, iou_pred, sam_tokens_out, object_score_logits

    def predict_masks(self, image_embeddings, image_pe, sparse_prompt_embeddings, dense_prompt_embeddings,
                      high_res_features):
        output_tokens = torch.cat([self.obj_score_token.weight, self.iou_token.weight, self.mask_tokens.weight], dim=0)
        output_tokens = output_tokens.unsqueeze(0).expand(sparse_prompt_embeddings.size(0), -1, -1)
        tokens = torch.cat((output_tokens, sparse_prompt_embeddings), dim=1)
        src = image_embeddings + dense_prompt_embeddings
        pos_src = torch.repeat_interleave(image_pe, tokens.shape[0], dim=0)
        b, c, h, w = src.shape
        hs, src = self.transformer(src, pos_src, tokens)
        iou_token_out = hs[:, 1, :]
        mask_tokens_out = hs[:, 2: 2 + self.num_mask_tokens, :]
        src = src.transpose(1, 2).reshape(b, c, h, w)
        dc1, ln1, act1, dc2, act2 = self.output_upscaling
        feat_s0, feat_s1 = high_res_features
        upscaled_embedding = act1(ln1(dc1(src) + feat_s1))
        upscaled_embedding = act2(dc2(upscaled_embedding) + feat_s0)
        hyper_in = torch.stack([self.output_hypernetworks_mlps[i](mask_tokens_out[:, i, :])
                                for i in range(self.num_mask_tokens)], dim=1)
        b, c, h, w = upscaled_embedding.shape
        masks = torch.matmul(q8(hyper_in), q8(upscaled_embedding.view(b, c, h * w))).view(b, -1, h, w)
        iou_pred = self.iou_prediction_head(iou_token_out)
        object_score_logits = self.pred_obj_score_head(hs[:, 0, :])
        return masks, iou_pred, mask_tokens_out, object_score_logits

    def _get_stability_scores(self, mask_logits):
        mask_logits = mask_logits.flatten(-2)
        delta = self.dynamic_multimask_stability_delta
        area_i = torch.sum(mask_logits > delta, dim=-1).float()
        area_u = torch.sum(mask_logits > -delta, dim=-1).float()
        return torch.where(area_u > 0, area_i / area_u, 1.0)

    def _dynamic_multimask_via_stability(self, all_mask_logits, all_iou_scores):
        multimask_logits, multimask_iou_scores = all_mask_logits[:, 1:, :, :], all_iou_scores[:, 1:]
        best = torch.argmax(multimask_iou_scores, dim=-1)
        batch_inds = torch.arange(multimask_iou_scores.size(0), device=all_iou_scores.device)
        best_multimask_logits = multimask_logits[batch_inds, best].unsqueeze(1)
        best_multimask_iou_scores = multimask_iou_scores[batch_inds, best].unsqueeze(1)
        singlemask_logits, singlemask_iou_scores = all_mask_logits[:, 0:1, :, :], all_iou_scores[:, 0:1]
        is_stable = self._get_stability_scores(singlemask_logits) >= self.dynamic_multimask_stability_thresh
        mask_logits_out = torch.where(is_stable[..., None, None].expand_as(singlemask_logits), singlemask_logits,
                                      best_multimask_logits)
        iou_scores_out = torch.where(is_stable.expand_as(singlemask_iou_scores), singlemask_iou_scores,
                                     best_multimask_iou_scores)
        return mask_logits_out, iou_scores_out


# ---------------------------------------------------------------------------
# memory_encoder.py
# ---------------------------------------------------------------------------

class MaskDownSampler(nn.Module):
    def __init__(self, embed_dim=256, kernel_size=3, stride=2, padding=1, total_stride=16):
        super().__init__()
        num_layers = int(math.log2(total_stride) // math.log2(stride))
        self.encoder = nn.Sequential()
        mask_in_chans, mask_out_chans = 1, 1
        for _ in range(num_layers):
            mask_out_chans = mask_in_chans * (stride ** 2)
            self.encoder.append(Conv2d(mask_in_chans, mask_out_chans, kernel_size=kernel_size, stride=stride,
                                       padding=padding))
            self.encoder.append(LayerNorm2d(mask_out_chans))
            self.encoder.append(nn.GELU())
            mask_in_chans = mask_out_chans
        self.encoder.append(Conv2d(mask_out_chans, embed_dim, kernel_size=1))

    def forward(self, x):
        return self.encoder(x)


class CXBlock(nn.Module):
    def __init__(self, dim, kernel_size=7, padding=3):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, kernel_size=kernel_size, padding=padding, groups=dim)
        self.norm = LayerNorm2d(dim, eps=1e-6)
        self.pwconv1 = Linear(dim, 4 * dim)
        self.act = nn.GELU()
        self.pwconv2 = Linear(4 * dim, dim)
        self.gamma = nn.Parameter(1e-6 * torch.ones(dim))

    def forward(self, x):
        inp = x
        x = self.norm(self.dwconv(x)).permute(0, 2, 3, 1)
        x = self.gamma * self.pwconv2(self.act(self.pwconv1(x)))
        return inp + x.permute(0, 3, 1, 2)


class Fuser(nn.Module):
    def __init__(self, dim, num_layers, kernel_size):
        super().__init__()
        self.layers = nn.ModuleList(CXBlock(dim, kernel_size, kernel_size // 2) for _ in range(num_layers))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class MemoryEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.mask_downsampler = MaskDownSampler(cfg.d_model)
        self.pix_feat_proj = Conv2d(cfg.d_model, cfg.d_model, kernel_size=1)
        self.fuser = Fuser(cfg.d_model, cfg.fuser_layers, cfg.fuser_kernel)
        self.position_encoding = PositionEmbeddingSine(cfg.mem_dim)
        self.out_proj = Conv2d(cfg.d_model, cfg.mem_dim, kernel_size=1)

    def forward(self, pix_feat, masks):
        """The masks already through the sigmoid (skip_mask_sigmoid)."""
        masks = self.mask_downsampler(masks)
        x = self.fuser(self.pix_feat_proj(pix_feat) + masks)
        x = self.out_proj(x)
        return {"vision_features": x, "vision_pos_enc": [self.position_encoding(x).to(x.dtype)]}


# ---------------------------------------------------------------------------
# sam2_base.py and sam2_video_predictor.py
# ---------------------------------------------------------------------------

def memory_selection(frame_idx: int, num_frames: int, num_maskmem: int, max_obj_ptrs: int):
    """What frame `frame_idx` (> 0, forward, stride 1) attends to, clicks on
    frame 0 only, as _prepare_memory_conditioned_features picks it: the
    memories as (t_pos, frame), the pointers as (signed distance, frame),
    in upstream's order. Frames absent from the dictionary are skipped."""
    mems = [(0, 0)]
    for t_pos in range(1, num_maskmem):
        t_rel = num_maskmem - t_pos
        prev = frame_idx - t_rel
        if prev >= 1:  # frame 0 is a conditioning frame, negative frames do not exist
            mems.append((t_pos, prev))
    ptrs = [(frame_idx, 0)]
    for t_diff in range(1, min(num_frames, max_obj_ptrs)):
        t = frame_idx - t_diff
        if t < 0:
            break
        if t >= 1:
            ptrs.append((t_diff, t))
    return mems, ptrs


class SAM2Base(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoder(cfg)
        self.mask_downsample = Conv2d(1, 1, kernel_size=4, stride=4)
        self.memory_attention = MemoryAttention(cfg)
        self.memory_encoder = MemoryEncoder(cfg)
        self.hidden_dim, self.mem_dim = cfg.d_model, cfg.mem_dim
        self.num_maskmem = cfg.num_maskmem
        self.maskmem_tpos_enc = nn.Parameter(torch.zeros(cfg.num_maskmem, 1, 1, self.mem_dim))
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, self.hidden_dim))
        self.no_mem_pos_enc = nn.Parameter(torch.zeros(1, 1, self.hidden_dim))
        self.image_size = cfg.image_size
        self.sam_image_embedding_size = cfg.image_size // 16
        self.max_obj_ptrs_in_encoder = cfg.max_obj_ptrs
        self.no_obj_ptr = nn.Parameter(torch.zeros(1, self.hidden_dim))
        self.no_obj_embed_spatial = nn.Parameter(torch.zeros(1, self.mem_dim))
        s = self.sam_image_embedding_size
        self.sam_prompt_encoder = PromptEncoder(self.hidden_dim, (s, s), (cfg.image_size, cfg.image_size), 16)
        self.sam_mask_decoder = MaskDecoder(
            self.hidden_dim, TwoWayTransformer(cfg.decoder_depth, self.hidden_dim, cfg.decoder_heads, cfg.decoder_mlp),
            num_multimask_outputs=3, iou_head_depth=3, iou_head_hidden_dim=256 if self.hidden_dim == 256
            else self.hidden_dim, stability_delta=cfg.stability_delta, stability_thresh=cfg.stability_thresh)
        self.obj_ptr_proj = MLP(self.hidden_dim, self.hidden_dim, self.hidden_dim, 3)
        self.obj_ptr_tpos_proj = Linear(self.hidden_dim, self.mem_dim)

    def forward_image(self, frame_u8):
        """frame_u8 (1, S, S, 3) -> upstream's backbone_out, conv_s0 / conv_s1 applied."""
        mean = torch.tensor(MEAN, device=frame_u8.device).view(1, 3, 1, 1)
        std = torch.tensor(STD, device=frame_u8.device).view(1, 3, 1, 1)
        img = (frame_u8.permute(0, 3, 1, 2).float() / 255.0 - mean) / std
        out = self.image_encoder(img)
        out["backbone_fpn"][0] = self.sam_mask_decoder.conv_s0(out["backbone_fpn"][0])
        out["backbone_fpn"][1] = self.sam_mask_decoder.conv_s1(out["backbone_fpn"][1])
        return out

    @staticmethod
    def features(backbone_out):
        """_prepare_backbone_features: sequence-first features and positions of the three levels."""
        fmaps, pos = backbone_out["backbone_fpn"][-3:], backbone_out["vision_pos_enc"][-3:]
        sizes = [(x.shape[-2], x.shape[-1]) for x in pos]
        return ([x.flatten(2).permute(2, 0, 1) for x in fmaps], [x.flatten(2).permute(2, 0, 1) for x in pos], sizes)

    def memory_bank(self, frame_idx, output_dict, num_frames, b):
        """The memory (Nk, B, mem_dim), its positions and the pointer tokens'
        count, sequence-first, from the outputs of the earlier frames."""
        mems, ptrs = memory_selection(frame_idx, num_frames, self.num_maskmem, self.max_obj_ptrs_in_encoder)
        to_cat_memory, to_cat_memory_pos_embed = [], []
        for t_pos, t in mems:
            prev = output_dict[t]
            to_cat_memory.append(prev["maskmem_features"].flatten(2).permute(2, 0, 1))
            enc = prev["maskmem_pos_enc"][-1].flatten(2).permute(2, 0, 1)
            to_cat_memory_pos_embed.append(enc + self.maskmem_tpos_enc[self.num_maskmem - t_pos - 1])
        pos_list = [p for p, _ in ptrs]
        obj_ptrs = torch.stack([output_dict[t]["obj_ptr"] for _, t in ptrs], dim=0)
        t_diff_max = min(num_frames, self.max_obj_ptrs_in_encoder) - 1
        obj_pos = torch.tensor(pos_list, device=obj_ptrs.device)
        obj_pos = self.obj_ptr_tpos_proj(get_1d_sine_pe(obj_pos / t_diff_max, dim=self.hidden_dim))
        obj_pos = obj_pos.unsqueeze(1).expand(-1, b, self.mem_dim)
        split = self.hidden_dim // self.mem_dim
        obj_ptrs = obj_ptrs.reshape(-1, b, split, self.mem_dim).permute(0, 2, 1, 3).flatten(0, 1)
        obj_pos = obj_pos.repeat_interleave(split, dim=0)
        to_cat_memory.append(obj_ptrs)
        to_cat_memory_pos_embed.append(obj_pos)
        return torch.cat(to_cat_memory, dim=0), torch.cat(to_cat_memory_pos_embed, dim=0), obj_ptrs.shape[0]

    def condition(self, frame_idx, vision_feats, vision_pos, feat_sizes, output_dict, num_frames):
        """_prepare_memory_conditioned_features -> (B, C, h, w)."""
        b = next(iter(output_dict.values()))["obj_ptr"].shape[0] if output_dict else 1
        h, w = feat_sizes[-1]
        if frame_idx == 0:
            pix = vision_feats[-1] + self.no_mem_embed
            return pix.permute(1, 2, 0).view(-1, self.hidden_dim, h, w)
        memory, memory_pos, n_ptr = self.memory_bank(frame_idx, output_dict, num_frames, b)
        curr = vision_feats[-1].expand(-1, b, -1)
        pix = self.memory_attention(curr=curr, curr_pos=vision_pos[-1].expand(-1, b, -1), memory=memory,
                                    memory_pos=memory_pos, num_obj_ptr_tokens=n_ptr)
        return pix.permute(1, 2, 0).view(b, self.hidden_dim, h, w)

    def _forward_sam_heads(self, backbone_features, point_inputs, high_res_features, multimask_output):
        b = backbone_features.size(0)
        if point_inputs is not None:
            coords, labels = point_inputs["point_coords"], point_inputs["point_labels"]
        else:
            coords = torch.zeros(b, 1, 2, device=backbone_features.device)
            labels = -torch.ones(b, 1, dtype=torch.int32, device=backbone_features.device)
        sparse, dense = self.sam_prompt_encoder(points=(coords, labels))
        low_res_multimasks, ious, sam_output_tokens, object_score_logits = self.sam_mask_decoder(
            image_embeddings=backbone_features, image_pe=self.sam_prompt_encoder.get_dense_pe(),
            sparse_prompt_embeddings=sparse, dense_prompt_embeddings=dense, multimask_output=multimask_output,
            high_res_features=high_res_features)
        candidates = low_res_multimasks
        is_obj_appearing = object_score_logits > 0
        low_res_multimasks = torch.where(is_obj_appearing[:, None, None], low_res_multimasks, NO_OBJ_SCORE)
        high_res_multimasks = F.interpolate(low_res_multimasks, size=(self.image_size, self.image_size),
                                            mode="bilinear", align_corners=False)
        sam_output_token = sam_output_tokens[:, 0]
        if multimask_output:
            best_iou_inds = torch.argmax(ious, dim=-1)
            batch_inds = torch.arange(b, device=backbone_features.device)
            low_res_masks = low_res_multimasks[batch_inds, best_iou_inds].unsqueeze(1)
            high_res_masks = high_res_multimasks[batch_inds, best_iou_inds].unsqueeze(1)
            if sam_output_tokens.size(1) > 1:
                sam_output_token = sam_output_tokens[batch_inds, best_iou_inds]
        else:
            low_res_masks, high_res_masks = low_res_multimasks, high_res_multimasks
        obj_ptr = self.obj_ptr_proj(sam_output_token)
        lambda_is_obj_appearing = is_obj_appearing.float()
        obj_ptr = lambda_is_obj_appearing * obj_ptr + (1 - lambda_is_obj_appearing) * self.no_obj_ptr
        return {"candidates": candidates, "ious": ious, "low_res_masks": low_res_masks,
                "high_res_masks": high_res_masks, "obj_ptr": obj_ptr, "object_score_logits": object_score_logits}

    def _encode_new_memory(self, vision_feats, feat_sizes, pred_masks_high_res, object_score_logits,
                           is_mask_from_pts):
        b = pred_masks_high_res.shape[0]
        h, w = feat_sizes[-1]
        pix_feat = vision_feats[-1].permute(1, 2, 0).view(-1, self.hidden_dim, h, w)
        if is_mask_from_pts:
            mask_for_mem = (pred_masks_high_res > 0).float()
        else:
            mask_for_mem = torch.sigmoid(pred_masks_high_res)
        mask_for_mem = mask_for_mem * self.cfg.sigmoid_scale_for_mem_enc + self.cfg.sigmoid_bias_for_mem_enc
        out = self.memory_encoder(pix_feat.expand(b, -1, -1, -1), mask_for_mem)
        maskmem_features = out["vision_features"]
        is_obj_appearing = (object_score_logits > 0).float()
        maskmem_features = maskmem_features + (1 - is_obj_appearing[..., None, None]) * \
            self.no_obj_embed_spatial[..., None, None].expand(*maskmem_features.shape)
        return maskmem_features, out["vision_pos_enc"]

    def track_step(self, frame_idx, frame_u8, point_inputs, output_dict, num_frames):
        """One frame of the propagation: its output dictionary (upstream's
        current_out, with the candidates and IoU besides)."""
        vision_feats, vision_pos, sizes = self.features(self.forward_image(frame_u8))
        high_res = [x.permute(1, 2, 0).view(x.size(1), x.size(2), *s) for x, s in zip(vision_feats[:-1], sizes[:-1])]
        pix = self.condition(frame_idx, vision_feats, vision_pos, sizes, output_dict, num_frames)
        if frame_idx == 0:
            b = point_inputs["point_coords"].shape[0]
            pix = pix.expand(b, -1, -1, -1)
        num_pts = 0 if point_inputs is None else point_inputs["point_labels"].size(1)
        out = self._forward_sam_heads(pix, point_inputs, high_res, multimask_output=num_pts <= 1)
        out["maskmem_features"], out["maskmem_pos_enc"] = self._encode_new_memory(
            vision_feats, sizes, out["high_res_masks"], out["object_score_logits"], point_inputs is not None)
        return out

    def propagate(self, frames_u8, coords, labels):
        """frames_u8 (1, T, S, S, 3), clicks (N, K, 2) in pixels with labels (N, K)
        on frame 0 -> mask logits (T, N, S, S) and object scores (T, N), the
        predictor's outputs at the video's size (which is the network's)."""
        t = frames_u8.shape[1]
        output_dict: Dict[int, dict] = {}
        masks, scores = [], []
        for f in range(t):
            points = {"point_coords": coords.float(), "point_labels": labels} if f == 0 else None
            out = self.track_step(f, frames_u8[:, f], points, output_dict, t)
            output_dict[f] = out
            masks.append(out["high_res_masks"][:, 0])
            scores.append(out["object_score_logits"][:, 0])
        return torch.stack(masks), torch.stack(scores)


def read_config(path) -> SimpleNamespace:
    """The configuration file's settings (portbench/configs/sam2_1_hiera_l.json)."""
    with open(path) as f:
        tree = json.load(f)
    m, tr, nk = tree["model"], tree["trunk"], tree["neck"]
    ma, me, dx = tree["memory_attention"], tree["memory_encoder"], tree["sam_mask_decoder_extra_args"]
    return SimpleNamespace(
        image_size=m["image_size"], embed_dim=tr["embed_dim"], num_heads=tr["num_heads"], stages=tr["stages"],
        global_att_blocks=tr["global_att_blocks"], window_pos_embed_bkg_spatial_size=tr[
            "window_pos_embed_bkg_spatial_size"], window_spec=tr["window_spec"], q_pool=tr["q_pool"],
        d_model=nk["d_model"], fpn_top_down_levels=nk["fpn_top_down_levels"], scalp=m["scalp"],
        memory_layers=ma["num_layers"], memory_ffn=ma["dim_feedforward"], rope_theta=ma["rope_theta"],
        feat_size=m["image_size"] // 16, mem_dim=me["out_dim"], num_maskmem=m["num_maskmem"],
        max_obj_ptrs=m["max_obj_ptrs_in_encoder"], decoder_depth=2, decoder_heads=8, decoder_mlp=2048,
        fuser_layers=me["fuser_num_layers"], fuser_kernel=me["fuser_kernel_size"],
        sigmoid_scale_for_mem_enc=m["sigmoid_scale_for_mem_enc"], sigmoid_bias_for_mem_enc=m[
            "sigmoid_bias_for_mem_enc"], stability_delta=dx["dynamic_multimask_stability_delta"],
        stability_thresh=dx["dynamic_multimask_stability_thresh"])
