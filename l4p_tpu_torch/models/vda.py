"""Video Depth Anything (Chen et al., "Video Depth Anything: Consistent Depth
Estimation for Super-Long Videos", CVPR 2025, arXiv:2501.12375;
github.com/DepthAnything/Video-Depth-Anything): temporally consistent
relative depth for videos of any length.

Each window of `num_frames` frames runs Depth Anything V2's encoder
(DINOv2 ViT-L/14 without registers, models/dinov2.py) on every frame, then
its temporal head (`DPTHeadTemporal`): the DPT projections and rescales,
a motion module on the third and fourth feature maps, the fusion trunk of
models/dpt.py with a motion module after refinenet4 and after refinenet3,
and the tail (refinenet2, refinenet1, the output convolutions, the second
of them in fp32) in chunks of MICRO_BATCH frames. A motion module
(`MotionModule`, upstream's TemporalModule) normalises each frame
(GroupNorm), projects, runs one transformer block of two temporal
attentions (each position attending over the window's frames, with a
sinusoidal frame-position table added to its input) and a GEGLU
feed-forward, projects back and adds its input. Every attention, the
encoder's and the temporal one, runs through the function the caller passes,
the Hopper kernel by default.

A clip runs as upstream's `infer_video_depth` runs it, with its
hard-coded constants (INFER_LEN, OVERLAP, KEYFRAMES, INTERP_LEN below):
windows at stride INFER_LEN - OVERLAP, the clip padded with its last
frame; each later window takes the previous window's input frames at
KEYFRAMES first; window 0's depth is kept as it is, each later window is
fitted to two anchors by a least-squares scale and shift (fp64 sums) and
joined by a linear blend over INTERP_LEN frames (`stitch_windows`), all on
the device with no host sync.

Parameter names are upstream's (`pretrained.*`, `head.projects.*`,
`head.resize_layers.*`, `head.scratch.*`,
`head.motion_modules.{i}.temporal_transformer.*`), but for the encoder's
LayerScale gains, which the encoder Block holds as `gamma_1` / `gamma_2`:
`upstream_name` and `load_upstream_state_dict` map them, as for VGGT. The
motion modules' frame-position tables (`pos_encoder.pe`) are upstream's
persistent buffers, fp32 whatever the model's dtype.

Departures from upstream, which runs under fp16 autocast: every stage
computes in the model's dtype (bf16 on the card) with fp32 LayerNorm and
GroupNorm statistics, the frame positions added to the fp32 LayerNorm
output before the one cast; the output convolution after the resize and
the stitch run in fp32, and the depth stays fp32 where upstream casts the
head's output back to fp16. The motion modules run their tokens
position-major throughout (B * h * w, T, C), which upstream rearranges to
and from around each temporal attention; q, k and v come from one product
with the three weights side by side.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from l4p_tpu_torch.config import VDA_TASKS, VDAConfig
from l4p_tpu_torch.models.dinov2 import DINOv2
from l4p_tpu_torch.models.dpt import Scratch, conv, fuse, resize
from l4p_tpu_torch.models.encoder import AttentionFn
from l4p_tpu_torch.ops.conv import linear
from l4p_tpu_torch.ops.flash_attention import flash_attention
from l4p_tpu_torch.utils.profiling import span

# the encoder Block's LayerScale gains under upstream's (DINOv2's) names
UPSTREAM_GAINS = {"gamma_1": "ls1.gamma", "gamma_2": "ls2.gamma"}
# infer_video_depth's constants (video_depth.py), which upstream hard-codes
INFER_LEN = 32
OVERLAP = 10
KEYFRAMES = (0, 12, 24, 25, 26, 27, 28, 29, 30, 31)
INTERP_LEN = 8
STRIDE = INFER_LEN - OVERLAP
# frames a chunk of the head's tail, refinenet2 on (upstream's micro_batch_size); a chunk changes no value
MICRO_BATCH = 4


def check_tasks(tasks: Sequence[str]) -> None:
    """ValueError for an unknown task."""
    if not tasks or any(t not in VDA_TASKS for t in tasks):
        raise ValueError(f"tasks {list(tasks)}: Video Depth Anything serves {VDA_TASKS}")


def frame_table(dim: int, max_len: int, device=None) -> torch.Tensor:
    """(1, max_len, dim) fp32: sin(t w_i) at 2i, cos(t w_i) at 2i + 1, w_i =
    exp(-2i ln(10^4) / dim) (upstream's PositionalEncoding)."""
    position = torch.arange(max_len, device=device).unsqueeze(1)
    div_term = torch.exp(torch.arange(0, dim, 2, device=device) * (-math.log(10000.0) / dim))
    pe = torch.zeros(1, max_len, dim, device=device)
    pe[0, :, 0::2] = torch.sin(position * div_term)
    pe[0, :, 1::2] = torch.cos(position * div_term)
    return pe


def _norm(x: torch.Tensor, norm: nn.LayerNorm, eps: float, add: torch.Tensor = None) -> torch.Tensor:
    """LayerNorm over the last axis in fp32, plus `add` (fp32), cast once to x's dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), norm.weight.float(), norm.bias.float(), eps)
    return (y if add is None else y + add).to(x.dtype)


class PositionalEncoding(nn.Module):
    def __init__(self, dim: int, max_len: int, device=None):
        super().__init__()
        self.register_buffer("pe", frame_table(dim, max_len, device))


class TemporalAttention(nn.Module):
    """Self-attention over the frames of each position: q, k and v (no
    bias) of the input plus the frame-position table, `heads` heads,
    softmax(q k^T / sqrt(C / heads)) v, `to_out`."""

    def __init__(self, dim: int, heads: int, max_len: int, device=None, dtype=None):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False, device=device, dtype=dtype)
        self.to_k = nn.Linear(dim, dim, bias=False, device=device, dtype=dtype)
        self.to_v = nn.Linear(dim, dim, bias=False, device=device, dtype=dtype)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim, device=device, dtype=dtype), nn.Dropout(0.0)])
        self.pos_encoder = PositionalEncoding(dim, max_len, device)

    def forward(self, h: torch.Tensor, attention: AttentionFn) -> torch.Tensor:
        """h (P, T, C), the normed input with the frame positions added, P
        positions of T frames -> (P, T, C)."""
        p, t, c = h.shape
        nh, d = self.heads, c // self.heads
        w = torch.cat([self.to_q.weight, self.to_k.weight, self.to_v.weight])
        qkv = linear(h, w).view(p, t, 3, nh, d).permute(2, 0, 3, 1, 4).contiguous()  # (3, P, heads, T, d)
        with span("vda/temporal_attention", positions=p, heads=nh, frames=t, head_dim=d, itemsize=h.element_size()):
            o = attention(qkv[0], qkv[1], qkv[2], d ** -0.5)
        return linear(o.transpose(1, 2).reshape(p, t, c), self.to_out[0].weight, self.to_out[0].bias)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int, device=None, dtype=None):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner, device=device, dtype=dtype)


class FeedForward(nn.Module):
    """GEGLU: [h, g] = proj(x), h * GELU(g) (exact), then the output linear."""

    def __init__(self, dim: int, mult: int, device=None, dtype=None):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, mult * dim, device, dtype), nn.Dropout(0.0),
                                  nn.Linear(mult * dim, dim, device=device, dtype=dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, g = linear(x, self.net[0].proj.weight, self.net[0].proj.bias).chunk(2, -1)
        return linear(h * F.gelu(g), self.net[2].weight, self.net[2].bias)


class TemporalTransformerBlock(nn.Module):
    """x + TA_i(LN_i(x)) for each temporal attention, then x + FF(LN_ff(x)),
    on position-major tokens (P, T, C)."""

    def __init__(self, cfg: VDAConfig, dim: int, device=None, dtype=None):
        super().__init__()
        self.eps = cfg.motion_ln_eps
        n = cfg.motion_attention_blocks
        self.attention_blocks = nn.ModuleList(TemporalAttention(dim, cfg.motion_heads, cfg.num_frames, device, dtype)
                                              for _ in range(n))
        self.norms = nn.ModuleList(nn.LayerNorm(dim, eps=self.eps, device=device, dtype=dtype) for _ in range(n))
        self.ff = FeedForward(dim, cfg.ff_mult, device, dtype)
        self.ff_norm = nn.LayerNorm(dim, eps=self.eps, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, attention: AttentionFn) -> torch.Tensor:
        t = x.shape[1]
        for ta, norm in zip(self.attention_blocks, self.norms):
            x = x + ta(_norm(x, norm, self.eps, ta.pos_encoder.pe[0, :t]), attention)
        return x + self.ff(_norm(x, self.ff_norm, self.eps))


class TemporalTransformer(nn.Module):
    def __init__(self, cfg: VDAConfig, dim: int, device=None, dtype=None):
        super().__init__()
        self.norm = nn.GroupNorm(cfg.motion_groups, dim, eps=cfg.motion_gn_eps, device=device, dtype=dtype)
        self.proj_in = nn.Linear(dim, dim, device=device, dtype=dtype)
        self.transformer_blocks = nn.ModuleList([TemporalTransformerBlock(cfg, dim, device, dtype)])
        self.proj_out = nn.Linear(dim, dim, device=device, dtype=dtype)


class MotionModule(nn.Module):
    """Upstream's TemporalModule: x + proj_out(block(proj_in(GroupNorm(x))))
    with the tokens of each position over the window's frames."""

    def __init__(self, cfg: VDAConfig, dim: int, device=None, dtype=None):
        super().__init__()
        self.temporal_transformer = TemporalTransformer(cfg, dim, device, dtype)

    def forward(self, x: torch.Tensor, frames: int, attention: AttentionFn) -> torch.Tensor:
        """x (B * T, C, h, w), T = frames -> the same shape, channels_last."""
        tt = self.temporal_transformer
        n, c, h, w = x.shape
        b = n // frames
        y = F.group_norm(x.float(), tt.norm.num_groups, tt.norm.weight.float(), tt.norm.bias.float(), tt.norm.eps)
        y = y.to(x.dtype).permute(0, 2, 3, 1).reshape(b, frames, h * w, c).transpose(1, 2).reshape(-1, frames, c)
        y = linear(y, tt.proj_in.weight, tt.proj_in.bias)
        for blk in tt.transformer_blocks:
            y = blk(y, attention)
        y = linear(y, tt.proj_out.weight, tt.proj_out.bias)
        y = y.view(b, h, w, frames, c).permute(0, 3, 1, 2, 4).reshape(n, h, w, c).permute(0, 3, 1, 2)
        return y + x


class DPTHeadTemporal(nn.Module):
    def __init__(self, cfg: VDAConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        c, oc, f = cfg.encoder.embed_dim, cfg.out_channels, cfg.features
        kw = dict(device=device, dtype=dtype)
        self.projects = nn.ModuleList(nn.Conv2d(c, o, 1, **kw) for o in oc)
        self.resize_layers = nn.ModuleList([nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4, **kw),
                                            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2, **kw), nn.Identity(),
                                            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1, **kw)])
        self.scratch = Scratch(oc, f, device, dtype, nd=2, alias=False)
        self.scratch.output_conv1 = nn.Conv2d(f, f // 2, 3, padding=1, **kw)
        self.scratch.output_conv2 = nn.Sequential(nn.Conv2d(f // 2, 32, 3, padding=1, **kw), nn.ReLU(),
                                                  nn.Conv2d(32, 1, 1, **kw), nn.ReLU(), nn.Identity())
        self.motion_modules = nn.ModuleList(MotionModule(cfg, d, device, dtype) for d in (oc[2], oc[3], f, f))

    def motion(self, i: int, x: torch.Tensor, frames: int, attention: AttentionFn) -> torch.Tensor:
        with span("vda/motion", module=i):
            return self.motion_modules[i](x, frames, attention)

    def forward(self, feats: Sequence[torch.Tensor], gh: int, gw: int, frames: int,
                attention: AttentionFn) -> torch.Tensor:
        """The encoder's four outputs (N, gh * gw, E), N = B * frames ->
        (N, 1, 14 gh, 14 gw) fp32, before the model's ReLU."""
        layers = []
        for i, x in enumerate(feats):
            x = x.transpose(1, 2).unflatten(2, (gh, gw))  # channels_last (N, E, gh, gw)
            x = conv(x, self.projects[i].weight, self.projects[i].bias)
            r = self.resize_layers[i]
            if isinstance(r, nn.ConvTranspose2d):
                x = F.conv_transpose2d(x, r.weight.to(x.dtype), r.bias.to(x.dtype), stride=r.stride)
            elif isinstance(r, nn.Conv2d):
                x = conv(x, r.weight, r.bias, stride=r.stride, padding=r.padding)
            layers.append(x)
        layers[2] = self.motion(0, layers[2], frames, attention)
        layers[3] = self.motion(1, layers[3], frames, attention)
        grids = [tuple(x.shape[2:]) for x in layers]
        sizes = [(2 * grids[0][0], 2 * grids[0][1]), grids[0], grids[1], grids[2]]
        s, p = self.scratch, self.cfg.encoder.patch_size

        def between(i, x):  # motion modules 2 and 3 after refinenet4 and refinenet3
            return self.motion(6 - i, x, frames, attention)

        def tail(x):
            x = conv(x, s.output_conv1.weight, s.output_conv1.bias, padding=1)
            x = resize(x, (p * gh, p * gw), align_corners=True).float()
            head = s.output_conv2
            x = F.relu(conv(x, head[0].weight, head[0].bias, padding=1))
            return F.relu(conv(x, head[2].weight, head[2].bias))

        return fuse(s, layers, sizes, between=between, chunk=MICRO_BATCH, tail=tail)


def window_frames(length: int) -> List[List[int]]:
    """The clip's frame indices of each window's inputs: windows start every
    STRIDE frames while they start inside the clip, indices past its end
    take the last frame (upstream's padding with copies of it), and a later
    window's first OVERLAP inputs are the previous window's at
    KEYFRAMES."""
    out: List[List[int]] = []
    for start in range(0, length, STRIDE):
        cur = [min(start + i, length - 1) for i in range(INFER_LEN)]
        if out:
            cur[:OVERLAP] = [out[-1][k] for k in KEYFRAMES]
        out.append(cur)
    return out


def take(x: torch.Tensor, index: Sequence[int], dim: int = 1) -> torch.Tensor:
    """x at `index` along `dim`, from slices of consecutive runs: no index
    tensor is copied to the device, so the host never waits."""
    runs, lo = [], 0
    for j in range(1, len(index) + 1):
        if j == len(index) or index[j] != index[j - 1] + 1:
            runs.append(x.narrow(dim, index[lo], j - lo))
            lo = j
    return runs[0] if len(runs) == 1 else torch.cat(runs, dim)


def scale_and_shift(pred: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, ...) each -> the least-squares (s, t) per batch entry minimising
    |s pred + t - target|^2 over every element (upstream's
    compute_scale_and_shift with an all-true mask), sums in fp64; (1, 0)
    where the system is singular. fp32 (B,) each."""
    p, t = pred.double().flatten(1), target.double().flatten(1)
    a00, a01, a11 = (p * p).sum(1), p.sum(1), p.new_full(p.shape[:1], float(p.shape[1]))
    b0, b1 = (p * t).sum(1), t.sum(1)
    det = a00 * a11 - a01 * a01
    ok = det != 0
    det = torch.where(ok, det, torch.ones_like(det))
    s = torch.where(ok, (a11 * b0 - a01 * b1) / det, torch.ones_like(det))
    shift = torch.where(ok, (-a01 * b0 + a00 * b1) / det, torch.zeros_like(det))
    return s.float(), shift.float()


def stitch_windows(windows: Sequence[torch.Tensor], length: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Windows' depth (B, INFER_LEN, H, W) fp32 -> the clip's depth (B,
    length, H, W) and each later window's fit (B, len(windows) - 1, 2):
    window 0 as it is, its outputs at the first keyframes the anchors; each
    later window fitted from its first outputs to the anchors, max(s o + t,
    0) blended into the last INTERP_LEN frames with weights i / (INTERP_LEN
    - 1) and appended after them, its outputs at the later keyframes the new
    anchors."""
    t, stride, overlap, n = INFER_LEN, STRIDE, OVERLAP, INTERP_LEN
    align = overlap - n
    kf = KEYFRAMES[:align]
    first = windows[0]
    b, dev = first.shape[0], first.device
    out = first.new_empty((b, stride * (len(windows) - 1) + t) + tuple(first.shape[2:]))
    out[:, :t] = first
    anchors = take(first, kf)
    w = torch.arange(n, device=dev, dtype=torch.float64) / (n - 1)
    w_post, w_pre = w.float().view(1, n, 1, 1), (1 - w).float().view(1, n, 1, 1)
    fits = []
    for i, win in enumerate(windows[1:], 1):
        s, shift = scale_and_shift(win[:, :align], anchors)
        fits.append(torch.stack([s, shift], -1))
        s, shift = s.view(b, 1, 1, 1), shift.view(b, 1, 1, 1)
        lo = stride * i + align
        out[:, lo: lo + n] = out[:, lo: lo + n] * w_pre + (win[:, align:overlap] * s + shift).clamp_min(0) * w_post
        out[:, lo + n: stride * i + t] = (win[:, overlap:] * s + shift).clamp_min(0)
        anchors = torch.cat([anchors[:, :1]] + [(win[:, k: k + 1] * s + shift).clamp_min(0) for k in kf[1:]], 1)
    return out[:, :length], (torch.stack(fits, 1) if fits else first.new_zeros(b, 0, 2))


class VideoDepthAnything(nn.Module):
    def __init__(self, cfg: VDAConfig = VDAConfig(), device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.pretrained = DINOv2(cfg.encoder, device, dtype)
        self.head = DPTHeadTemporal(cfg, device, dtype)

    def window(self, rgb_u8: torch.Tensor, attention: AttentionFn = flash_attention, folded=None) -> torch.Tensor:
        """One window (B, T, H, W, 3) uint8 -> depth (B, T, H, W) fp32
        (upstream's VideoDepthAnything.forward)."""
        cfg, p = self.cfg, self.cfg.encoder.patch_size
        b, t, h, w, _ = rgb_u8.shape
        gh, gw = h // p, w // p
        with span("vda/encode"):
            feats = self.pretrained.intermediate_layers(rgb_u8.reshape(b * t, h, w, 3), attention,
                                                        cfg.intermediate_layers, folded)
        with span("vda/head"):
            depth = self.head(feats, gh, gw, t, attention)
            if (p * gh, p * gw) != (h, w):
                depth = resize(depth, (h, w), align_corners=True)
            return F.relu(depth).view(b, t, h, w)

    def forward(self, rgb_u8: torch.Tensor, tasks: Sequence[str] = VDA_TASKS,
                attention: AttentionFn = flash_attention) -> Dict[str, torch.Tensor]:
        """(B, L, H, W, 3) uint8 frames of any length L -> {"depth": (B, L,
        H, W) fp32}, the clip's stitched relative depth."""
        check_tasks(tasks)
        folded = self.pretrained.folded()  # once a request: the fold's tables reach the device by a blocking copy
        windows = []
        for i, index in enumerate(window_frames(rgb_u8.shape[1])):
            with span("vda/window", window=i):
                windows.append(self.window(take(rgb_u8, index), attention, folded))
        with span("vda/stitch"):
            depth, _ = stitch_windows(windows, rgb_u8.shape[1])
        return {"depth": depth}


def upstream_name(name: str) -> str:
    """A parameter's name in upstream's state dict."""
    head, _, leaf = name.rpartition(".")
    return f"{head}.{UPSTREAM_GAINS[leaf]}" if leaf in UPSTREAM_GAINS else name


def load_upstream_state_dict(model: VideoDepthAnything, state: Mapping[str, torch.Tensor]) -> None:
    """Loads upstream's state dict (video_depth_anything_vitl.pth) with
    strict=True. The port's own names load too."""
    ours = {upstream_name(k): k for k in model.state_dict()}
    model.load_state_dict({ours.get(k, k): v for k, v in state.items()}, strict=True)
