"""SAM 2.1 (Ravi et al., "SAM 2: Segment Anything in Images and Videos",
arXiv:2408.00714; github.com/facebookresearch/sam2): promptable object
masks propagated through a video, each object with a memory of its own.

A clip runs as upstream's video predictor propagates it forward from
clicks on frame 0 (`SAM2VideoPredictor.propagate_in_video` with
sam2.1_hiera_l.yaml and the predictor's overrides), one frame at a time:

1. the image encoder (`ImageEncoder`, `ENCODE_CHUNK` frames a call): Hiera (`Hiera`: a 7x7 stride-4
   patch embedding, a windowed position embedding, 48 `MultiScaleBlock`s
   in four stages whose widths and heads double, 2x2 max-pooled queries at
   the first block of stages 2-4, windowed attention but in the global
   blocks) and an FPN neck at `d_model`, of whose levels the top (stride
   16) feeds memory attention and the two finer ones the decoder's skips
   (conv_s0, conv_s1);
2. memory attention (`MemoryAttention`): on frame 0 the top features plus
   `no_mem_embed`; later, four layers of RoPE self-attention and RoPE
   cross-attention to the object's memory bank (one head of `d_model`;
   axial RoPE on the feature grid, repeated over the memories, none on the
   object pointers), each with an FFN;
3. the decoder (models/sam.py:`sam2_decode`): SAM's two-way transformer
   on the clicks (frame 0) or a padding prompt (later frames), the three
   candidate masks, their IoU predictions and the object score; the mask
   with the best IoU is chosen (multimask output: at most one click), or,
   for two or more clicks, the single-mask token unless its stability is
   below the threshold; a mask whose object score is not positive becomes
   NO_OBJ_SCORE; the chosen token through `obj_ptr_proj` is the object
   pointer (`no_obj_ptr` where the object is absent);
4. the memory encoder (`MemoryEncoder`): the chosen mask at the image's
   size, binarised on the clicked frame and a sigmoid elsewhere, scaled by
   20 and shifted by -10, downsampled by four stride-2 convolutions, added
   to a projection of the frame's top features, two ConvNeXt blocks and a
   projection to `mem_dim`; `no_obj_embed_spatial` where the object is
   absent.

The memory bank is rings on the device (`Bank`): per object the clicked
frame's memory and pointer for the whole clip, the last `num_maskmem - 1`
memories and the last `max_obj_ptrs - 1` pointers of the other frames.
Which slots a frame reads and their temporal encodings depend on the
frame's number alone, so the host picks them without reading the device;
the mask choice and the object's presence are on-device `where` and
gather. All objects of a clip run as one batch (upstream's predictor runs
them one at a time; the image features are shared).

Every attention of Hiera and of memory attention runs through the function
the caller passes, the Hopper kernel by default (head dim 72 for Hiera,
256 for memory attention); the decoder's attention is models/sam.py's plain
`mha` (`twoway_block`), over 8 tokens and the 4,096 image tokens.

Parameter names are upstream's SAM2Base state dict (`image_encoder.trunk.*`,
`image_encoder.neck.*`, `memory_attention.*`, `memory_encoder.*`,
`sam_prompt_encoder.*`, `sam_mask_decoder.*`, `obj_ptr_proj.*`, ...), but
for the two-way transformer's MLPs, which models/sam.py holds as lin1 /
lin2: `upstream_name` and `load_upstream_state_dict` map them.

Departures from upstream, which runs under bf16 autocast: every stage
computes in the model's dtype (bf16 on the card) with fp32 LayerNorm
statistics, RoPE and position tables in fp32 cast once, the FPN's
top-down sum in the model's dtype, and the mask logits upsampled and
returned in fp32. The frames arrive at the network's size; upstream's
host-side resize to it is outside the model. Upstream's hole filling
(`fill_hole_area`, a compiled extension) is not run.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from l4p_tpu_torch.config import SAM2_TASKS, SamConfig, Sam2Config
from l4p_tpu_torch.models.encoder import AttentionFn
from l4p_tpu_torch.models.sam import (NO_OBJ_SCORE, HyperMLP, LayerNorm2d, Sam2MaskDecoder, Sam2PromptEncoder,
                                      dense_pe_2d, embed_points_2d, hyper_mlp, layer_norm_2d, sam2_decode,
                                      stability_scores)
from l4p_tpu_torch.ops.conv import layer_norm, linear
from l4p_tpu_torch.ops.flash_attention import flash_attention, kernel_row_pitch
from l4p_tpu_torch.ops.resize import interpolate_bilinear
from l4p_tpu_torch.utils.profiling import span

MEAN = (0.485, 0.456, 0.406)  # the predictor's image normalisation, of [0, 1] pixels
STD = (0.229, 0.224, 0.225)
HIERA_EPS = 1e-6
MEMORY_EPS = 1e-5  # nn.LayerNorm's default: memory attention's norms
# the two-way transformer's MLPs: the port's names -> upstream's
UPSTREAM_MLP = {".mlp.lin1.": ".mlp.layers.0.", ".mlp.lin2.": ".mlp.layers.1."}
# frames a call of the image encoder: a frame's encoding needs no memory, so a chunk of frames shares Hiera's
# ~600 launches (one frame a call left the request host-bound, PERF.md); each window and head is its own
# attention sequence, so the values are a frame's alone
ENCODE_CHUNK = 8
# SAM2Base's hard-coded SAM heads (sam2_base.py:_build_sam_heads), which upstream's YAML does not set: the two-way
# transformer's depth, heads and MLP width, and the prompt encoder's mask channels
DECODER_DEPTH, DECODER_HEADS, DECODER_MLP, MASK_IN_CHANS = 2, 8, 2048, 16


def check_tasks(tasks: Sequence[str]) -> None:
    """ValueError for an unknown task."""
    if not tasks or any(t not in SAM2_TASKS for t in tasks):
        raise ValueError(f"tasks {list(tasks)}: SAM 2 serves {SAM2_TASKS}")


def decoder_config(cfg: Sam2Config) -> SamConfig:
    """The SamConfig of SAM 2's two-way transformer and mask tokens."""
    return SamConfig(embed_dim=cfg.d_model, num_heads=DECODER_HEADS, mlp_dim=DECODER_MLP,
                     sam_head_depth=DECODER_DEPTH, attention_downsample_rate=2,
                     num_mask_tokens=cfg.num_multimask_outputs + 1)


def sine_pe_2d(channels: int, h: int, w: int, device=None) -> torch.Tensor:
    """(h * w, channels) fp32, token-major: upstream's PositionEmbeddingSine
    (normalised, scale 2 pi, temperature 10^4), y's half first."""
    half = channels // 2
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device) / (h + 1e-6) * 2 * math.pi
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device) / (w + 1e-6) * 2 * math.pi
    dim_t = 10000.0 ** (2 * (torch.arange(half, dtype=torch.float32, device=device) // 2) / half)

    def enc(v):  # (n,) -> (n, half): sin at even, cos at odd channels
        p = v[:, None] / dim_t
        return torch.stack([p[:, 0::2].sin(), p[:, 1::2].cos()], dim=2).flatten(1)

    py, px = enc(y), enc(x)
    return torch.cat([py[:, None].expand(h, w, half), px[None].expand(h, w, half)], dim=-1).reshape(h * w, channels)


def sine_pe_1d(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """(n,) -> (n, dim) fp32: upstream's get_1d_sine_pe (sines, then cosines)."""
    half = dim // 2
    dim_t = 10000.0 ** (2 * (torch.arange(half, dtype=torch.float32, device=pos.device) // 2) / half)
    p = pos.float()[:, None] / dim_t
    return torch.cat([p.sin(), p.cos()], dim=-1)


def rope_table(dim: int, side: int, theta: float, device=None) -> torch.Tensor:
    """(side^2, dim / 2) complex64 unit rotations of upstream's
    compute_axial_cis: pair j < dim / 4 turns by x * f_j, the others by
    y * f_(j - dim / 4), f_j = theta^(-4j / dim), token t at x = t mod side,
    y = t div side."""
    freqs = 1.0 / theta ** (torch.arange(0, dim, 4, device=device)[: dim // 4].float() / dim)
    t = torch.arange(side * side, device=device, dtype=torch.float32)
    angles = torch.cat([torch.outer(t % side, freqs), torch.outer(torch.div(t, side, rounding_mode="floor"), freqs)],
                       dim=-1)
    return torch.polar(torch.ones_like(angles), angles)


def apply_rope(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x (B, r * P, D) with interleaved pairs, rotated in fp32 by the (P, D / 2)
    table repeated r times (upstream's apply_rotary_enc with
    repeat_freqs_k), cast back to x's dtype."""
    b, n, d = x.shape
    p = table.shape[0]
    xc = torch.view_as_complex(x.float().view(b, n // p, p, d // 2, 2))
    return torch.view_as_real(xc * table).view(b, n, d).to(x.dtype)


def norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """`ln` over the last axis: ops/conv.py's layer_norm with its epsilon."""
    return layer_norm(x, ln.weight, ln.bias, ln.eps)


def heads_major(t: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(B, N, S, H, D) -> S tensors (B, H, N, D), views of one buffer in the
    attention kernel's layout (rows kernel_row_pitch(D) apart): one copy for
    all S, where the kernel's wrapper would copy each."""
    b, n, parts, h, d = t.shape
    buf = torch.empty((parts, b, h, n, kernel_row_pitch(d)), device=t.device, dtype=t.dtype)[..., :d]
    return tuple(buf.copy_(t.permute(2, 0, 3, 1, 4)).unbind(0))


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H / 2, W / 2, C): 2x2 max pooling (upstream's do_pool)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H / ws * W / ws, ws, ws, C)."""
    b, h, w, c = x.shape
    return x.view(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)


def window_unpartition(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """The inverse of window_partition at a grid of h x w."""
    b = x.shape[0] // (h // ws * (w // ws))
    return x.view(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


class Mlp(nn.Module):
    """Upstream's MLP of two layers (sam2_utils.MLP), GELU or ReLU between."""

    def __init__(self, dim: int, hidden: int, out: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.layers = nn.ModuleList([nn.Linear(dim, hidden, **kw), nn.Linear(hidden, out, **kw)])


# ---------------------------------------------------------------------------
# the image encoder: Hiera and the FPN neck (backbones/hieradet.py, image_encoder.py)
# ---------------------------------------------------------------------------

class MultiScaleAttention(nn.Module):
    def __init__(self, dim: int, dim_out: int, heads: int, q_pool: bool, device=None, dtype=None):
        super().__init__()
        self.heads, self.q_pool = heads, q_pool
        self.qkv = nn.Linear(dim, dim_out * 3, device=device, dtype=dtype)
        self.proj = nn.Linear(dim_out, dim_out, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, attention: AttentionFn) -> torch.Tensor:
        """x (N, h, w, C) windows -> (N, h', w', C_out), h' = h / 2 with q_pool."""
        n, h, w, _ = x.shape
        qkv = linear(x, self.qkv.weight, self.qkv.bias).view(n, h * w, 3, self.heads, -1)
        d = qkv.shape[-1]
        if self.q_pool:
            h, w = h // 2, w // 2
            q = maxpool2(qkv[:, :, 0].reshape(n, 2 * h, 2 * w, -1)).reshape(n, h * w, 1, self.heads, d)
            (q,), (k, v) = heads_major(q), heads_major(qkv[:, :, 1:])
        else:
            q, k, v = heads_major(qkv)
        o = attention(q, k, v, d ** -0.5)
        return linear(o.transpose(1, 2).reshape(n, h, w, -1), self.proj.weight, self.proj.bias)


class MultiScaleBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, heads: int, window: int, q_pool: bool, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dim, self.dim_out, self.window, self.q_pool = dim, dim_out, window, q_pool
        self.norm1 = nn.LayerNorm(dim, eps=HIERA_EPS, **kw)
        self.attn = MultiScaleAttention(dim, dim_out, heads, q_pool, **kw)
        self.norm2 = nn.LayerNorm(dim_out, eps=HIERA_EPS, **kw)
        self.mlp = Mlp(dim_out, 4 * dim_out, dim_out, **kw)
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out, **kw)

    def forward(self, x: torch.Tensor, attention: AttentionFn) -> torch.Tensor:
        """x (B, H, W, C) -> (B, H', W', C_out)."""
        b, h, w, _ = x.shape
        xn = norm(x, self.norm1)
        shortcut = x
        if self.dim != self.dim_out:
            shortcut = linear(xn, self.proj.weight, self.proj.bias)
            if self.q_pool:
                shortcut = maxpool2(shortcut)
        ws = self.window
        y = self.attn(window_partition(xn, ws) if ws else xn, attention)
        if self.q_pool:
            ws, h, w = ws // 2, h // 2, w // 2
        if ws:
            y = window_unpartition(y, ws, h, w)
        x = shortcut + y
        m = self.mlp.layers
        y = norm(x, self.norm2)
        return x + linear(F.gelu(linear(y, m[0].weight, m[0].bias)), m[1].weight, m[1].bias)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, 7, stride=4, padding=3, device=device, dtype=dtype)


class Hiera(nn.Module):
    def __init__(self, cfg: Sam2Config, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        e, heads = cfg.embed_dim, cfg.num_heads
        self.patch_embed = PatchEmbed(e, **kw)
        self.pos_embed = nn.Parameter(torch.zeros(1, e, *cfg.window_pos_embed_bkg_spatial_size, **kw))
        self.pos_embed_window = nn.Parameter(torch.zeros(1, e, cfg.window_spec[0], cfg.window_spec[0], **kw))
        self.stage_ends = [sum(cfg.stages[:i]) - 1 for i in range(1, len(cfg.stages) + 1)]
        q_pool_blocks = [x + 1 for x in self.stage_ends[:-1]]  # the first block of every stage but the first
        self.blocks = nn.ModuleList()
        stage, dim = 1, e
        grid = cfg.image_size // 4
        for i in range(sum(cfg.stages)):
            dim_out = dim
            # the first block of a stage keeps the previous stage's window (upstream's lag)
            window = 0 if i in cfg.global_att_blocks else cfg.window_spec[stage - 1]
            if i - 1 in self.stage_ends:
                dim_out, heads, stage = 2 * dim, 2 * heads, stage + 1
            if window and grid % window:
                raise ValueError(f"block {i}: a {grid} x {grid} grid does not split into windows of {window}")
            self.blocks.append(MultiScaleBlock(dim, dim_out, heads, window, i in q_pool_blocks, **kw))
            grid //= 2 if i in q_pool_blocks else 1
            dim = dim_out

    def pos_table(self, h: int, w: int) -> torch.Tensor:
        """(1, h, w, C) in fp32: the background embedding resized bicubic plus the window embedding tiled."""
        pe = F.interpolate(self.pos_embed.float(), size=(h, w), mode="bicubic")
        win = self.pos_embed_window.float()
        pe = pe + win.tile([1, 1, h // win.shape[2], w // win.shape[3]])
        return pe.permute(0, 2, 3, 1)

    def forward(self, img: torch.Tensor, attention: AttentionFn, pos: torch.Tensor) -> List[torch.Tensor]:
        """img (B, 3, H, W) normalised, pos the `pos_table` -> each stage's
        output (B, H_i, W_i, C_i), finest first."""
        p = self.patch_embed.proj
        x = F.conv2d(img, p.weight.to(img.dtype), p.bias.to(img.dtype), stride=4, padding=3).permute(0, 2, 3, 1)
        x = (x.float() + pos).to(img.dtype)
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x, attention)
            if i in self.stage_ends:
                outs.append(x)
        return outs


class FpnNeck(nn.Module):
    def __init__(self, cfg: Sam2Config, device=None, dtype=None):
        super().__init__()
        self.top_down = cfg.fpn_top_down_levels
        self.convs = nn.ModuleList()
        for dim in cfg.channel_list:
            conv = nn.Sequential()
            conv.add_module("conv", nn.Conv2d(dim, cfg.d_model, 1, device=device, dtype=dtype))
            self.convs.append(conv)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Hiera's outputs (B, H_i, W_i, C_i) -> the levels (B, H_i, W_i,
        d_model), finest first, top-down (nearest x2) where `top_down` says."""
        n = len(self.convs) - 1
        out: List[Optional[torch.Tensor]] = [None] * (n + 1)
        prev = None
        for i in range(n, -1, -1):
            conv = self.convs[n - i].conv
            lateral = linear(xs[i], conv.weight.flatten(1), conv.bias)
            if i in self.top_down and prev is not None:
                b, h, w, c = prev.shape
                prev = lateral + prev[:, :, None, :, None].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)
            else:
                prev = lateral
            out[i] = prev
        return out


class ImageEncoder(nn.Module):
    def __init__(self, cfg: Sam2Config, device=None, dtype=None):
        super().__init__()
        self.trunk = Hiera(cfg, device, dtype)
        self.neck = FpnNeck(cfg, device, dtype)


# ---------------------------------------------------------------------------
# memory attention (memory_attention.py, sam/transformer.py:RoPEAttention)
# ---------------------------------------------------------------------------

class RoPEAttention(nn.Module):
    def __init__(self, dim: int, kv_in_dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.q_proj = nn.Linear(dim, dim, **kw)
        self.k_proj = nn.Linear(kv_in_dim, dim, **kw)
        self.v_proj = nn.Linear(kv_in_dim, dim, **kw)
        self.out_proj = nn.Linear(dim, dim, **kw)


class MemoryAttentionLayer(nn.Module):
    def __init__(self, cfg: Sam2Config, device=None, dtype=None):
        super().__init__()
        c, kw = cfg.d_model, dict(device=device, dtype=dtype)
        self.self_attn = RoPEAttention(c, c, **kw)
        self.cross_attn_image = RoPEAttention(c, cfg.mem_dim, **kw)
        self.linear1 = nn.Linear(c, cfg.memory_ffn, **kw)
        self.linear2 = nn.Linear(cfg.memory_ffn, c, **kw)
        self.norm1 = nn.LayerNorm(c, eps=MEMORY_EPS, **kw)
        self.norm2 = nn.LayerNorm(c, eps=MEMORY_EPS, **kw)
        self.norm3 = nn.LayerNorm(c, eps=MEMORY_EPS, **kw)


def _attend(attention: AttentionFn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One head over (B, N, D) each, through the caller's attention, in its span."""
    b, nq, d = q.shape
    with span("sam2/memory_attention_call", batch=b, heads=1, queries=nq, keys=k.shape[1], head_dim=d,
              itemsize=q.element_size()):
        return attention(q[:, None], k[:, None], v[:, None], d ** -0.5)[:, 0]


class MemoryAttention(nn.Module):
    def __init__(self, cfg: Sam2Config, device=None, dtype=None):
        super().__init__()
        self.layers = nn.ModuleList(MemoryAttentionLayer(cfg, device, dtype) for _ in range(cfg.memory_layers))
        self.norm = nn.LayerNorm(cfg.d_model, eps=MEMORY_EPS, device=device, dtype=dtype)
        self.register_buffer("rope", rope_table(cfg.d_model, cfg.feat_size, cfg.rope_theta, device), persistent=False)

    def forward(self, curr: torch.Tensor, curr_pos: torch.Tensor, memory: torch.Tensor, memory_pos: torch.Tensor,
                num_ptr_tokens: int, attention: AttentionFn) -> torch.Tensor:
        """curr (1 or B, P, C) the frame's top features, curr_pos (P, C) fp32,
        memory (B, Nk, mem_dim) and memory_pos (1 or B, Nk, mem_dim) with the
        pointer tokens last -> (B, P, C). A batch-1 `curr` is the same image
        for every object: the first self-attention runs once for all."""
        rope = self.rope
        b, n_rope = memory.shape[0], memory.shape[1] - num_ptr_tokens
        tgt = (curr.float() + 0.1 * curr_pos).to(curr.dtype)
        k_in, v_in = (memory + memory_pos.to(memory.dtype)), memory
        for layer in self.layers:
            sa, ca = layer.self_attn, layer.cross_attn_image
            t2 = norm(tgt, layer.norm1)
            q = apply_rope(linear(t2, sa.q_proj.weight, sa.q_proj.bias), rope)
            k = apply_rope(linear(t2, sa.k_proj.weight, sa.k_proj.bias), rope)
            o = _attend(attention, q, k, linear(t2, sa.v_proj.weight, sa.v_proj.bias))
            tgt = tgt + linear(o, sa.out_proj.weight, sa.out_proj.bias)
            if tgt.shape[0] != b:
                tgt = tgt.expand(b, -1, -1)
            t2 = norm(tgt, layer.norm2)
            q = apply_rope(linear(t2, ca.q_proj.weight, ca.q_proj.bias), rope)
            k = linear(k_in, ca.k_proj.weight, ca.k_proj.bias)
            k[:, :n_rope] = apply_rope(k[:, :n_rope], rope)
            o = _attend(attention, q, k, linear(v_in, ca.v_proj.weight, ca.v_proj.bias))
            tgt = tgt + linear(o, ca.out_proj.weight, ca.out_proj.bias)
            t2 = norm(tgt, layer.norm3)
            tgt = tgt + linear(torch.relu(linear(t2, layer.linear1.weight, layer.linear1.bias)),
                               layer.linear2.weight, layer.linear2.bias)
        return norm(tgt, self.norm)


# ---------------------------------------------------------------------------
# the memory encoder (memory_encoder.py)
# ---------------------------------------------------------------------------

class MaskDownSampler(nn.Module):
    def __init__(self, cfg: Sam2Config, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.encoder = nn.Sequential()
        cin = 1
        for _ in range(4):  # total stride 16 in steps of 2
            self.encoder.append(nn.Conv2d(cin, 4 * cin, 3, stride=2, padding=1, **kw))
            self.encoder.append(LayerNorm2d(4 * cin, **kw))
            self.encoder.append(nn.GELU())
            cin *= 4
        self.encoder.append(nn.Conv2d(cin, cfg.d_model, 1, **kw))


class CXBlock(nn.Module):
    def __init__(self, dim: int, kernel: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dwconv = nn.Conv2d(dim, dim, kernel, padding=kernel // 2, groups=dim, **kw)
        self.norm = LayerNorm2d(dim, **kw)
        self.pwconv1 = nn.Linear(dim, 4 * dim, **kw)
        self.pwconv2 = nn.Linear(4 * dim, dim, **kw)
        self.gamma = nn.Parameter(torch.ones(dim, **kw))


class Fuser(nn.Module):
    def __init__(self, cfg: Sam2Config, device=None, dtype=None):
        super().__init__()
        self.layers = nn.ModuleList(CXBlock(cfg.d_model, cfg.fuser_kernel, device, dtype)
                                    for _ in range(cfg.fuser_layers))


class MemoryEncoder(nn.Module):
    def __init__(self, cfg: Sam2Config, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.mask_downsampler = MaskDownSampler(cfg, **kw)
        self.pix_feat_proj = nn.Conv2d(cfg.d_model, cfg.d_model, 1, **kw)
        self.fuser = Fuser(cfg, **kw)
        self.out_proj = nn.Conv2d(cfg.d_model, cfg.mem_dim, 1, **kw)

    def forward(self, pix: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """pix (1, h, w, C) the frame's top features, mask (B, 1, 16h, 16w)
        already scaled and shifted -> the memory (B, h * w, mem_dim)."""
        x = mask.to(pix.dtype)
        enc = self.mask_downsampler.encoder
        for i in range(0, 12, 3):
            conv, ln = enc[i], enc[i + 1]
            x = F.gelu(layer_norm_2d(F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), stride=2,
                                              padding=1), ln))
        x = x.permute(0, 2, 3, 1)  # channels last from here on: the 1x1 convolutions are products
        x = linear(x, enc[12].weight.flatten(1), enc[12].bias)
        x = x + linear(pix, self.pix_feat_proj.weight.flatten(1), self.pix_feat_proj.bias)
        for blk in self.fuser.layers:
            y = F.conv2d(x.permute(0, 3, 1, 2), blk.dwconv.weight.to(x.dtype), blk.dwconv.bias.to(x.dtype),
                         padding=blk.dwconv.padding, groups=blk.dwconv.groups).permute(0, 2, 3, 1)
            y = norm(y, blk.norm)
            y = linear(F.gelu(linear(y, blk.pwconv1.weight, blk.pwconv1.bias)), blk.pwconv2.weight, blk.pwconv2.bias)
            x = x + y * blk.gamma.to(y.dtype)
        x = linear(x, self.out_proj.weight.flatten(1), self.out_proj.bias)
        return x.flatten(1, 2)


# ---------------------------------------------------------------------------
# the memory bank and the model
# ---------------------------------------------------------------------------

class Bank:
    """Per object, on the device: the clicked frame's memory (B, P, mem_dim)
    and pointer (B, C), rings of the last `memories` memories and the last
    `pointers` pointers of the frames after it. Frame j >= 1 lives in slot
    (j - 1) mod the ring's size."""

    def __init__(self, b: int, p: int, mem_dim: int, c: int, memories: int, pointers: int, device, dtype):
        self.cond_mem = self.cond_ptr = None
        self.mem = torch.empty((memories, b, p, mem_dim), device=device, dtype=dtype)
        self.ptr = torch.empty((max(pointers, 1), b, c), device=device, dtype=dtype)

    def put(self, frame: int, memory: torch.Tensor, pointer: torch.Tensor) -> None:
        if frame == 0:
            self.cond_mem, self.cond_ptr = memory, pointer
        else:
            self.mem[(frame - 1) % self.mem.shape[0]] = memory
            self.ptr[(frame - 1) % self.ptr.shape[0]] = pointer


def bank_order(frame: int, memories: int, pointers: int) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
    """What frame `frame` >= 1 reads (upstream's
    _prepare_memory_conditioned_features, stride 1, forward): the memories
    as (frame, temporal index into maskmem_tpos_enc), the clicked frame's
    first and then the last `memories` frames oldest first; the pointers as
    (frame, signed distance), the clicked frame's first and then the last
    `pointers` frames newest first. Frame 0's entries are the clicked
    frame's."""
    mems = [(0, memories)] + [(j, frame - j - 1) for j in range(max(1, frame - memories), frame)]
    ptrs = [(0, frame)] + [(frame - d, d) for d in range(1, pointers + 1) if frame - d >= 1]
    return mems, ptrs


class Sam2(nn.Module):
    memory_tokens = 0  # memory tokens attended since the last reset, summed over objects and frames

    def __init__(self, cfg: Sam2Config = Sam2Config(), device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        c, kw = cfg.d_model, dict(device=device, dtype=dtype)
        self.dcfg = decoder_config(cfg)
        self.image_encoder = ImageEncoder(cfg, **kw)
        self.mask_downsample = nn.Conv2d(1, 1, 4, stride=4, **kw)  # mask prompts only: never run here
        self.memory_attention = MemoryAttention(cfg, **kw)
        self.memory_encoder = MemoryEncoder(cfg, **kw)
        self.sam_prompt_encoder = Sam2PromptEncoder(c, MASK_IN_CHANS, **kw)
        self.sam_mask_decoder = Sam2MaskDecoder(self.dcfg, **kw)
        self.maskmem_tpos_enc = nn.Parameter(torch.zeros(cfg.num_maskmem, 1, 1, cfg.mem_dim, **kw))
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, c, **kw))
        self.no_mem_pos_enc = nn.Parameter(torch.zeros(1, 1, c, **kw))  # the transformer path for frame 0: not run
        self.no_obj_ptr = nn.Parameter(torch.zeros(1, c, **kw))
        self.no_obj_embed_spatial = nn.Parameter(torch.zeros(1, cfg.mem_dim, **kw))
        self.obj_ptr_proj = HyperMLP(c, c, **kw)
        self.obj_ptr_tpos_proj = nn.Linear(c, cfg.mem_dim, **kw)
        fs = cfg.feat_size
        self.register_buffer("curr_pos", sine_pe_2d(c, fs, fs, device), persistent=False)
        self.register_buffer("memory_pos", sine_pe_2d(cfg.mem_dim, fs, fs, device), persistent=False)
        # of 0..255 pixels, made once: a copy from host memory to the card waits for it
        self.register_buffer("pixel_mean", 255.0 * torch.tensor(MEAN, device=device).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("pixel_std", 255.0 * torch.tensor(STD, device=device).view(1, 3, 1, 1), persistent=False)

    # the four stages of a frame, each callable alone (the benchmark's comparison takes them up)

    def encode(self, frames_u8: torch.Tensor, attention: AttentionFn, pos: torch.Tensor):
        """frames_u8 (F, H, W, 3) uint8 -> (top (F, h, w, C), (s0, s1) the
        decoder's skips (F, C/8, 4h, 4w), (F, C/4, 2h, 2w) after conv_s0 /
        conv_s1), in the model's dtype."""
        dt = self.no_mem_embed.dtype
        img = ((frames_u8.permute(0, 3, 1, 2).float() - self.pixel_mean) / self.pixel_std).to(dt)
        levels = self.image_encoder.neck(self.image_encoder.trunk(img, attention, pos))
        md = self.sam_mask_decoder
        s0 = linear(levels[0], md.conv_s0.weight.flatten(1), md.conv_s0.bias).permute(0, 3, 1, 2)
        s1 = linear(levels[1], md.conv_s1.weight.flatten(1), md.conv_s1.bias).permute(0, 3, 1, 2)
        return levels[2], (s0, s1)

    def decode(self, pix: torch.Tensor, skips, coords: Optional[torch.Tensor], labels: Optional[torch.Tensor]):
        """pix (B, C, h, w) the memory-conditioned features, coords (B, K, 2)
        and labels (B, K) of the clicks or None -> (candidates (B, M, 4h, 4w)
        in the model's dtype, IoU (B, M), object score (B, 1) fp32, the chosen
        low-resolution logits (B, 1, 4h, 4w) fp32, NO_OBJ_SCORE where the
        object is absent, and the object pointer (B, C))."""
        cfg, b = self.cfg, pix.shape[0]
        if coords is None:
            coords = pix.new_zeros((b, 1, 2), dtype=torch.float32)
            labels = -torch.ones((b, 1), device=pix.device, dtype=torch.int64)
        pe = self.sam_prompt_encoder
        sparse = embed_points_2d(pe, coords, labels, cfg.image_size)
        image_pe = dense_pe_2d(pe.pe_layer.positional_encoding_gaussian_matrix, pix.shape[2], pix.shape[3])
        masks, iou, tokens, score = sam2_decode(self.sam_mask_decoder, self.dcfg, pe, pix, skips, sparse, image_pe)
        if labels.shape[1] <= cfg.multimask_max_pt_num:  # multimask output: the best of tokens 1..3
            best = iou[:, 1:].argmax(-1) + 1
            token_index = best
        else:  # one mask: token 0 unless unstable, then the best of 1..3; the pointer from token 0
            multi = iou[:, 1:].argmax(-1) + 1
            stable = stability_scores(masks[:, 0].float(), cfg.stability_delta) >= cfg.stability_thresh
            best = torch.where(stable, torch.zeros_like(multi), multi)
            token_index = torch.zeros_like(multi)
        h, w = masks.shape[2:]
        low = masks.gather(1, best.view(b, 1, 1, 1).expand(b, 1, h, w)).float()
        present = score > 0
        low = torch.where(present.view(b, 1, 1, 1), low, torch.full_like(low, NO_OBJ_SCORE))
        token = tokens.gather(1, token_index.view(b, 1, 1).expand(b, 1, tokens.shape[2]))[:, 0]
        ptr = hyper_mlp(self.obj_ptr_proj, token)
        p = present.to(ptr.dtype)
        ptr = p * ptr + (1 - p) * self.no_obj_ptr.to(ptr.dtype)
        return masks, iou, score, low, ptr

    def encode_memory(self, top: torch.Tensor, high: torch.Tensor, score: torch.Tensor, clicked: bool):
        """top (1, h, w, C), high (B, 1, H, W) fp32 the chosen logits at the
        image's size, score (B, 1) -> the frame's memory (B, h * w, mem_dim):
        the mask binarised on a clicked frame, a sigmoid elsewhere, x 20 - 10;
        no_obj_embed_spatial added where the object is absent."""
        cfg = self.cfg
        m = (high > 0).float() if clicked else torch.sigmoid(high)
        m = m * cfg.sigmoid_scale_for_mem_enc + cfg.sigmoid_bias_for_mem_enc
        mem = self.memory_encoder(top, m)
        absent = (score <= 0).to(mem.dtype).view(-1, 1, 1)
        return mem + absent * self.no_obj_embed_spatial.to(mem.dtype)

    def memory_inputs(self, bank: Bank, frame: int, pointers: int, pointer_pos: torch.Tensor):
        """The memory (B, Nk, mem_dim) that frame `frame` attends to, its
        positions (1, Nk, mem_dim) and its count of pointer tokens (last)."""
        cfg = self.cfg
        mems, ptrs = bank_order(frame, bank.mem.shape[0], pointers)
        ring = lambda t, j: t[(j - 1) % t.shape[0]]  # noqa: E731 - frame j's slot
        tokens = [bank.cond_mem if j == 0 else ring(bank.mem, j) for j, _ in mems]
        tpos = self.maskmem_tpos_enc.float()[:, 0, 0]
        pos = [self.memory_pos + tpos[i] for _, i in mems]
        ptr = torch.stack([bank.cond_ptr if j == 0 else ring(bank.ptr, j) for j, _ in ptrs], dim=1)  # (B, n, C)
        b, n, c = ptr.shape
        split = c // cfg.mem_dim  # a pointer is `split` tokens of mem_dim
        tokens.append(ptr.reshape(b, n * split, cfg.mem_dim))
        # the clicked frame's distance, then 1, 2, ...: two runs of rows of the table
        rows = torch.cat([pointer_pos[frame: frame + 1], pointer_pos[1: n]])
        pos.append(rows.repeat_interleave(split, dim=0))
        return torch.cat(tokens, dim=1), torch.cat(pos)[None], n * split

    def forward(self, rgb_u8: torch.Tensor, tasks: Sequence[str] = SAM2_TASKS, attention: AttentionFn = flash_attention,
                point_coords_bnk2: Optional[torch.Tensor] = None, point_labels_bnk: Optional[torch.Tensor] = None,
                prompt_frame: int = 0) -> Dict[str, torch.Tensor]:
        """rgb_u8 (1, T, H, W, 3) uint8 at the network's size, clicks (1, N,
        K, 2) as (x, y) pixels with labels (1, N, K) (1 positive, 0
        negative) on frame 0 -> {"mask_logits_btnhw": (1, T, N, H, W) fp32,
        "object_score_logits_btn": (1, T, N) fp32}: each object's mask logits
        on every frame, propagated forward from the clicks."""
        check_tasks(tasks)
        cfg = self.cfg
        b, t, hh, ww, _ = rgb_u8.shape
        if b != 1 or (hh, ww) != (cfg.image_size, cfg.image_size):
            raise ValueError(f"SAM 2 takes one clip of {cfg.image_size} x {cfg.image_size} frames, got "
                             f"{tuple(rgb_u8.shape)}")
        if point_coords_bnk2 is None or point_labels_bnk is None or int(prompt_frame) != 0:
            raise ValueError("SAM 2 takes clicks (point_coords_bnk2, point_labels_bnk) on frame 0")
        coords, labels = point_coords_bnk2[0].float(), point_labels_bnk[0].long()
        n = coords.shape[0]
        fs, c = cfg.feat_size, cfg.d_model
        dt = self.no_mem_embed.dtype
        pointers = min(t, cfg.max_obj_ptrs) - 1  # upstream's max_obj_ptrs_in_encoder - 1 after the clicked frame's
        pos = self.image_encoder.trunk.pos_table(cfg.image_size // 4, cfg.image_size // 4)
        # each pointer's temporal encoding by its distance d = 0 .. T - 1, normalised by the farthest a pointer reaches
        dist = torch.arange(t, device=rgb_u8.device, dtype=torch.float32) / max(pointers, 1)
        pointer_pos = linear(sine_pe_1d(dist, c), self.obj_ptr_tpos_proj.weight.float(),
                             self.obj_ptr_tpos_proj.bias.float())
        bank = Bank(n, fs * fs, cfg.mem_dim, c, cfg.num_maskmem - 1, pointers, rgb_u8.device, dt)
        masks = torch.empty((1, t, n, hh, ww), device=rgb_u8.device, dtype=torch.float32)
        scores = torch.empty((1, t, n), device=rgb_u8.device, dtype=torch.float32)
        for f in range(t):
            if f % ENCODE_CHUNK == 0:
                with span("sam2/encode", frames=min(ENCODE_CHUNK, t - f)):
                    tops, (s0, s1) = self.encode(rgb_u8[0, f: f + ENCODE_CHUNK], attention, pos)
            j = f % ENCODE_CHUNK
            top, skips = tops[j: j + 1], (s0[j: j + 1], s1[j: j + 1])
            mems, ptrs = bank_order(f, cfg.num_maskmem - 1, pointers) if f else ([], [])
            with span("sam2/frame", frame=f, objects=n, memories=len(mems), pointers=len(ptrs)):
                if f == 0:
                    pix = (top + self.no_mem_embed.to(dt)).permute(0, 3, 1, 2).expand(n, -1, -1, -1)
                else:
                    with span("sam2/memory_attention"):
                        memory, memory_pos, n_ptr = self.memory_inputs(bank, f, pointers, pointer_pos)
                        type(self).memory_tokens += n * memory.shape[1]
                        pix = self.memory_attention(top.flatten(1, 2), self.curr_pos, memory, memory_pos, n_ptr,
                                                    attention)
                        pix = pix.transpose(1, 2).reshape(n, c, fs, fs)
                with span("sam2/decode"):
                    _, _, score, low, ptr = self.decode(pix, skips, *((coords, labels) if f == 0 else (None, None)))
                    high = interpolate_bilinear(low, (hh, ww))
                    masks[0, f] = high[:, 0]
                    scores[0, f] = score[:, 0]
                with span("sam2/memory_encode"):
                    bank.put(f, self.encode_memory(top, high, score, f == 0), ptr)
        return {"mask_logits_btnhw": masks, "object_score_logits_btn": scores}


def upstream_name(name: str) -> str:
    """A parameter's name in upstream's state dict."""
    for ours, theirs in UPSTREAM_MLP.items():
        if name.startswith("sam_mask_decoder.transformer.") and ours in name:
            return name.replace(ours, theirs)
    return name


def load_upstream_state_dict(model: Sam2, state: Mapping[str, torch.Tensor]) -> None:
    """Loads upstream's state dict (sam2.1_hiera_large.pt's "model") with
    strict=True. The port's own names load too."""
    ours = {upstream_name(k): k for k in model.state_dict()}
    model.load_state_dict({ours.get(k, k): v for k, v in state.items()}, strict=True)
