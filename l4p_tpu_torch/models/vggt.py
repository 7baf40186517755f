"""VGGT (Wang et al., "VGGT: Visual Geometry Grounded Transformer", CVPR
2025, arXiv:2503.11651; github.com/facebookresearch/vggt): per-frame depth,
point maps and cameras for a set of frames, from one feed-forward pass.

The aggregator embeds each frame with DINOv2 ViT-L/14 with registers
(models/dinov2.py), puts a camera token and 4 register tokens before each frame's
patches (frame 0 takes slot 0 of each, the others slot 1), and alternates
frame attention over one frame's tokens with global attention over every
frame's at once, each block with LayerNorm on q and k and 2D rotary
positions (`Rope2D`). Every transformer block is the encoder's `Block`
(models/encoder.py) on VGGT's `BlockConfig`; the attention runs through the
function the caller passes, the Hopper kernel by default. The camera head
refines a pose encoding (translation, quaternion scalar-last, two fields
of view) through an adaLN-modulated trunk; the depth and point heads are
2D DPT heads on models/dpt.py's fusion trunk, whose resizes run on the
resize kernel (ops/resize.py).

Parameter names are upstream's (`aggregator.patch_embed.*`,
`aggregator.frame_blocks.{i}.*`, `aggregator.global_blocks.{i}.*`,
`aggregator.camera_token`, `aggregator.register_token`, `camera_head.*`,
`depth_head.*`, `point_head.*`), but for the LayerScale gains, which the
encoder Block holds as `gamma_1` / `gamma_2` where upstream has
`ls1.gamma` / `ls2.gamma`: `load_upstream_state_dict` maps them, and
`upstream_name` gives a parameter's upstream name. The track head is not
built: upstream runs it only for query points; `load_upstream_state_dict`
drops a checkpoint's `track_head.*` and loads the rest with strict=True.

Departures from upstream, which runs the aggregator under bf16 autocast and
the heads in fp32: every stage computes in the model's dtype with fp32
LayerNorm statistics (so the residual stream is bf16 where autocast keeps
it fp32), q/k LayerNorm and RoPE in fp32 before the attention (one kernel
on CUDA, ops/qk_norm_rope.py), the camera head's pose sum and every head
activation in fp32; the RoPE and DPT position tables are computed in fp32
(the DPT's in float64 as upstream) and cast. Only the aggregator outputs the
heads read are kept.
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from l4p_tpu_torch.config import VGGT_TASKS, VGGTConfig
from l4p_tpu_torch.models.dinov2 import DINOv2
from l4p_tpu_torch.models.dpt import Scratch, conv, fuse, resize
from l4p_tpu_torch.models.encoder import AttentionFn, Block
from l4p_tpu_torch.ops.conv import layer_norm, linear
from l4p_tpu_torch.ops.flash_attention import flash_attention
from l4p_tpu_torch.ops.qk_norm_rope import Rope2D
from l4p_tpu_torch.utils.profiling import span

POSE_DIM = 9  # absT_quaR_FoV: translation 3, quaternion 4 (scalar last), fov_h, fov_w
UV_OMEGA = 100.0  # the DPT position embedding's base (vggt/heads/utils.py)
UV_RATIO = 0.1
# the encoder Block's LayerScale gains under upstream's (DINOv2's) names
UPSTREAM_GAINS = {"gamma_1": "ls1.gamma", "gamma_2": "ls2.gamma"}


def check_tasks(tasks: Sequence[str]) -> None:
    """ValueError for an unknown task."""
    if not tasks or any(t not in VGGT_TASKS for t in tasks):
        raise ValueError(f"tasks {list(tasks)}: VGGT serves {VGGT_TASKS}")


def frame_positions(gh: int, gw: int, special: int, device) -> torch.Tensor:
    """(special + gh * gw, 2) (y, x): 0 for the special tokens, the patch
    grid's index + 1 for the patches."""
    yx = torch.cartesian_prod(torch.arange(gh, device=device), torch.arange(gw, device=device)) + 1
    return torch.cat([torch.zeros(special, 2, dtype=yx.dtype, device=device), yx])


class Aggregator(nn.Module):
    def __init__(self, cfg: VGGTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg, bc, e = cfg, cfg.aggregator_block, cfg.embed_dim
        self.patch_embed = DINOv2(cfg.dinov2, device, dtype)
        self.frame_blocks = nn.ModuleList(Block(bc, device, dtype) for _ in range(cfg.depth))
        self.global_blocks = nn.ModuleList(Block(bc, device, dtype) for _ in range(cfg.depth))
        self.camera_token = nn.Parameter(torch.zeros(1, 2, 1, e, device=device, dtype=dtype))
        self.register_token = nn.Parameter(torch.zeros(1, 2, cfg.num_register_tokens, e, device=device, dtype=dtype))

    def forward(self, rgb_u8: torch.Tensor, attention: AttentionFn, keep: Sequence[int]) -> Dict[int, torch.Tensor]:
        """(B, S, H, W, 3) uint8 -> {i: output i (B, S, P, 2E)} for i in
        `keep`: frame block i's output beside global block i's."""
        cfg, e = self.cfg, self.cfg.embed_dim
        b, s, h, w, _ = rgb_u8.shape
        gh, gw = h // cfg.patch_size, w // cfg.patch_size
        with span("vggt/embed"):
            patches = self.patch_embed(rgb_u8.reshape(b * s, h, w, 3), attention)
        special = torch.cat([self.camera_token, self.register_token], 2)  # (1, 2, 1 + R, E)
        special = torch.cat([special[:, :1].expand(b, 1, -1, -1), special[:, 1:].expand(b, s - 1, -1, -1)], 1)
        x = torch.cat([special.reshape(b * s, cfg.patch_start, e), patches], 1)
        p = x.shape[1]
        pos = frame_positions(gh, gw, cfg.patch_start, x.device)
        hd = cfg.aggregator_block.head_dim
        rope = Rope2D(pos, hd, cfg.rope_freq)  # one frame's table: a global block's S frames take it S times
        out = {}
        for i in range(cfg.depth):
            with span("vggt/frame_block", block=i):
                x = self.frame_blocks[i](x, attention, rope=rope)
            frame_out = x
            with span("vggt/global_block", block=i):
                x = self.global_blocks[i](x.view(b, s * p, e), attention, rope=rope).view(b * s, p, e)
            if i in keep:
                out[i] = torch.cat([frame_out, x], -1).view(b, s, p, 2 * e)
        return out


class PoseMlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int, device=None, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device, dtype=dtype)
        self.fc2 = nn.Linear(hidden, out, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(F.gelu(linear(x, self.fc1.weight, self.fc1.bias)), self.fc2.weight, self.fc2.bias)


class CameraHead(nn.Module):
    """vggt/heads/camera_head.py: the last output's camera tokens, normed
    once, refined `camera_iterations` times; each pass modulates them by the
    embedding of the pose so far (the empty pose first), runs the trunk and
    adds a pose delta. The pose sum is kept in fp32."""

    def __init__(self, cfg: VGGTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg, bc, c = cfg, cfg.camera_block, 2 * cfg.embed_dim
        self.trunk = nn.Sequential(*(Block(bc, device, dtype) for _ in range(cfg.camera_trunk_depth)))
        self.token_norm = nn.LayerNorm(c, eps=cfg.ln_eps, device=device, dtype=dtype)
        self.trunk_norm = nn.LayerNorm(c, eps=cfg.ln_eps, device=device, dtype=dtype)
        self.empty_pose_tokens = nn.Parameter(torch.zeros(1, 1, POSE_DIM, device=device, dtype=dtype))
        self.embed_pose = nn.Linear(POSE_DIM, c, device=device, dtype=dtype)
        self.poseLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(c, 3 * c, device=device, dtype=dtype))
        self.pose_branch = PoseMlp(c, c // 2, POSE_DIM, device, dtype)

    def forward(self, tokens: torch.Tensor, attention: AttentionFn) -> torch.Tensor:
        """(B, S, 2E) camera tokens -> the pose encoding (B, S, 9), fp32."""
        eps, dtype = self.cfg.ln_eps, tokens.dtype
        t = layer_norm(tokens, self.token_norm.weight, self.token_norm.bias, eps)
        t_hat = F.layer_norm(t.float(), t.shape[-1:], eps=1e-6).to(dtype)  # adaln_norm: no affine
        mod = self.poseLN_modulation[1]
        pred = None
        for _ in range(self.cfg.camera_iterations):
            pose_in = self.empty_pose_tokens.expand(*t.shape[:2], -1) if pred is None else pred.to(dtype)
            u = linear(pose_in, self.embed_pose.weight, self.embed_pose.bias)
            shift, scale, gate = linear(F.silu(u), mod.weight, mod.bias).chunk(3, -1)
            y = gate * (t_hat * (1 + scale) + shift) + t
            for blk in self.trunk:
                y = blk(y, attention)
            delta = self.pose_branch(layer_norm(y, self.trunk_norm.weight, self.trunk_norm.bias, eps)).float()
            pred = delta if pred is None else pred + delta
        return torch.cat([pred[..., :7], F.relu(pred[..., 7:])], -1)  # translation, quaternion linear; FoV ReLU


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternions (x, y, z, w) -> (..., 3, 3) rotations."""
    i, j, k, r = q.unbind(-1)
    two_s = 2.0 / (q * q).sum(-1)
    o = torch.stack((1 - two_s * (j * j + k * k), two_s * (i * j - k * r), two_s * (i * k + j * r),
                     two_s * (i * j + k * r), 1 - two_s * (i * i + k * k), two_s * (j * k - i * r),
                     two_s * (i * k - j * r), two_s * (j * k + i * r), 1 - two_s * (i * i + j * j)), -1)
    return o.unflatten(-1, (3, 3))


def pose_encoding_to_extri_intri(pose_enc: torch.Tensor, hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, 9) -> extrinsics (B, S, 3, 4) [R | T] and intrinsics (B, S, 3,
    3): f = (size / 2) / tan(fov / 2), the principal point at the centre
    (vggt/utils/pose_enc.py)."""
    h, w = hw
    ext = torch.cat([quat_to_mat(pose_enc[..., 3:7]), pose_enc[..., :3, None]], -1)
    intr = torch.zeros(*pose_enc.shape[:-1], 3, 3, device=pose_enc.device, dtype=pose_enc.dtype)
    intr[..., 0, 0] = (w / 2.0) / torch.tan(pose_enc[..., 8] / 2.0)
    intr[..., 1, 1] = (h / 2.0) / torch.tan(pose_enc[..., 7] / 2.0)
    intr[..., 0, 2], intr[..., 1, 2], intr[..., 2, 2] = w / 2.0, h / 2.0, 1.0
    return ext, intr


@functools.lru_cache(maxsize=32)
def uv_embedding(w: int, h: int, c: int, aspect: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(1, C, h, w) channels_last: upstream's UV grid (x over +-aspect /
    sqrt(aspect^2 + 1), y over +-1 / sqrt(aspect^2 + 1), each scaled by (n -
    1) / n) under sin / cos at base 100, half the channels for x and half for
    y, times 0.1 (DPTHead._apply_pos_embed)."""
    diag = (aspect ** 2 + 1.0) ** 0.5
    sx, sy = aspect / diag, 1.0 / diag
    xs = torch.linspace(-sx * (w - 1) / w, sx * (w - 1) / w, w, device=device)
    ys = torch.linspace(-sy * (h - 1) / h, sy * (h - 1) / h, h, device=device)
    uu, vv = torch.meshgrid(xs, ys, indexing="xy")  # (h, w)
    omega = 1.0 / UV_OMEGA ** (torch.arange(c // 4, device=device, dtype=torch.float64) / (c / 4))

    def sincos(p):
        out = p.reshape(-1, 1).double() * omega
        return torch.cat([out.sin(), out.cos()], 1)

    emb = torch.cat([sincos(uu), sincos(vv)], 1).float().view(h, w, c) * UV_RATIO
    return emb.to(dtype).permute(2, 0, 1)[None]


class VGGTDPTHead(nn.Module):
    """vggt/heads/dpt_head.py on models/dpt.py's 2D trunk: per aggregator
    output read, the patch tokens under one LayerNorm, a 1x1 projection, the
    UV embedding, a rescale (transposed conv x4, x2, identity, strided conv
    /2); the fusion trunk (refinenet4 without a residual, each resizing to
    the next grid, refinenet1 x2); output_conv1, a resize to the image, the
    UV embedding again, output_conv2; then the activation in fp32."""

    def __init__(self, cfg: VGGTConfig, output_dim: int, activation: str, device=None, dtype=None):
        super().__init__()
        self.cfg, self.activation = cfg, activation
        c, oc, f = 2 * cfg.embed_dim, cfg.dpt_out_channels, cfg.dpt_features
        kw = dict(device=device, dtype=dtype)
        self.norm = nn.LayerNorm(c, eps=cfg.ln_eps, **kw)
        self.projects = nn.ModuleList(nn.Conv2d(c, o, 1, **kw) for o in oc)
        self.resize_layers = nn.ModuleList([nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4, **kw),
                                            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2, **kw), nn.Identity(),
                                            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1, **kw)])
        self.scratch = Scratch(oc, f, device, dtype, nd=2, alias=False, first_residual=False, relu_skip=True)
        self.scratch.output_conv1 = nn.Conv2d(f, f // 2, 3, padding=1, **kw)
        self.scratch.output_conv2 = nn.Sequential(nn.Conv2d(f // 2, 32, 3, padding=1, **kw), nn.ReLU(),
                                                  nn.Conv2d(32, output_dim, 1, **kw))

    def forward(self, feats: Mapping[int, torch.Tensor], hw: Tuple[int, int], lo: int, hi: int):
        """Frames [lo, hi) of the aggregator outputs -> (values (B, s, H, W,
        k - 1), confidence (B, s, H, W)), fp32."""
        cfg, (h, w) = self.cfg, hw
        gh, gw = h // cfg.patch_size, w // cfg.patch_size
        b = next(iter(feats.values())).shape[0]
        layers = []
        for i, li in enumerate(cfg.dpt_layers):
            x = feats[li][:, lo:hi, cfg.patch_start:]
            x = layer_norm(x.reshape(-1, gh * gw, x.shape[-1]), self.norm.weight, self.norm.bias, cfg.ln_eps)
            x = x.transpose(1, 2).unflatten(2, (gh, gw))  # channels_last (N, C, gh, gw)
            x = conv(x, self.projects[i].weight, self.projects[i].bias)
            x = x + uv_embedding(gw, gh, x.shape[1], w / h, x.dtype, x.device)
            r = self.resize_layers[i]
            if isinstance(r, nn.ConvTranspose2d):
                x = F.conv_transpose2d(x, r.weight.to(x.dtype), r.bias.to(x.dtype), stride=r.stride)
            elif isinstance(r, nn.Conv2d):
                x = conv(x, r.weight, r.bias, stride=r.stride, padding=r.padding)
            layers.append(x)
        grids = [tuple(x.shape[2:]) for x in layers]
        sizes = [(2 * grids[0][0], 2 * grids[0][1]), grids[0], grids[1], grids[2]]
        s = self.scratch
        out = conv(fuse(s, layers, sizes), s.output_conv1.weight, s.output_conv1.bias, padding=1)
        out = resize(out, (h, w), align_corners=True)
        out = out + uv_embedding(w, h, out.shape[1], w / h, out.dtype, out.device)
        head = s.output_conv2
        out = conv(F.relu(conv(out, head[0].weight, head[0].bias, padding=1)), head[2].weight, head[2].bias)
        out = out.permute(0, 2, 3, 1).float()
        val, conf = out[..., :-1], 1.0 + out[..., -1].exp()
        val = val.exp() if self.activation == "exp" else val.sign() * val.abs().expm1()  # exp / inv_log
        return val.unflatten(0, (b, -1)), conf.unflatten(0, (b, -1))


class VGGT(nn.Module):
    def __init__(self, cfg: VGGTConfig = VGGTConfig(), device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.aggregator = Aggregator(cfg, device, dtype)
        self.camera_head = CameraHead(cfg, device, dtype)
        self.point_head = VGGTDPTHead(cfg, 4, "inv_log", device, dtype)
        self.depth_head = VGGTDPTHead(cfg, 2, "exp", device, dtype)

    def forward(self, rgb_u8: torch.Tensor, tasks: Sequence[str] = VGGT_TASKS,
                attention: AttentionFn = flash_attention) -> Dict[str, torch.Tensor]:
        """(B, S, H, W, 3) uint8 frames -> upstream's outputs for `tasks`:
        `pose_enc` (B, S, 9), `extrinsic` (B, S, 3, 4) and `intrinsic` (B, S,
        3, 3) for camera; `depth` (B, S, H, W, 1) and `depth_conf` (B, S, H,
        W); `world_points` (B, S, H, W, 3) and `world_points_conf`; fp32."""
        cfg = self.cfg
        check_tasks(tasks)
        hw = tuple(rgb_u8.shape[2:4])
        keep = set(cfg.dpt_layers) if {"depth", "world_points"} & set(tasks) else set()
        feats = self.aggregator(rgb_u8, attention, keep | ({cfg.depth - 1} if "camera" in tasks else set()))
        out: Dict[str, torch.Tensor] = {}
        if "camera" in tasks:
            with span("vggt/camera_head"):
                out["pose_enc"] = self.camera_head(feats[cfg.depth - 1][:, :, 0], attention)
                out["extrinsic"], out["intrinsic"] = pose_encoding_to_extri_intri(out["pose_enc"], hw)
        s = rgb_u8.shape[1]
        for task, head in (("depth", "depth_head"), ("world_points", "point_head")):
            if task not in tasks:
                continue
            vals, confs = [], []
            for chunk, lo in enumerate(range(0, s, cfg.frames_chunk_size)):
                with span("vggt/dpt_head", task=task, chunk=chunk):
                    v, c = getattr(self, head)(feats, hw, lo, min(lo + cfg.frames_chunk_size, s))
                vals.append(v)
                confs.append(c)
            out[task], out[f"{task}_conf"] = torch.cat(vals, 1), torch.cat(confs, 1)
        return out


def upstream_name(name: str) -> str:
    """A parameter's name in upstream's state dict."""
    head, _, leaf = name.rpartition(".")
    return f"{head}.{UPSTREAM_GAINS[leaf]}" if leaf in UPSTREAM_GAINS else name


def load_upstream_state_dict(model: VGGT, state: Mapping[str, torch.Tensor]) -> None:
    """Loads upstream's state dict (facebook/VGGT-1B) with strict=True,
    without the track head that the port does not build. The port's own
    names load too."""
    ours = {upstream_name(k): k for k in model.state_dict()}
    model.load_state_dict({ours.get(k, k): v for k, v in state.items() if not k.startswith("track_head.")},
                          strict=True)
