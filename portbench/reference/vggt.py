"""VGGT's forward in plain fp32 PyTorch: the benchmark's reference for the
`vggt_1b` configuration, written from upstream's modules
(github.com/facebookresearch/vggt: vggt/models/vggt.py, aggregator.py,
heads/camera_head.py, heads/dpt_head.py, heads/utils.py, heads/head_act.py,
layers/rope.py, layers/block.py, layers/attention.py,
layers/vision_transformer.py, utils/pose_enc.py, utils/rotation.py), in
upstream's module and parameter names, importing nothing of the program
and running no kernel.

Departures from upstream, each forced by the benchmark:
- The track head is not built (no query points in the traffic); its
  `enable_track` is the configuration's one reduced key.
- Everything runs in fp32 with TF32 off (`plain_fp32`), where upstream runs
  the aggregator under bf16 autocast and the heads in fp32.
- Attention is computed in blocks of `QUERY_BLOCK` queries, softmax over
  every key, so that global attention over 50,048 tokens fits on one card.
- The input is uint8 frames (B, S, H, W, 3), taken to [0, 1] and normalised
  with ImageNet's mean and std as upstream's aggregator does.
- The pose embedding's sin / cos in the DPT heads are computed in float64
  from an fp32 UV grid, as upstream does on CUDA.
- The DPT residual units apply upstream's ReLU in place (`nn.ReLU(inplace=
  True)`), so each unit's skip adds its ReLU'd input, as upstream's does.
- Under `fp8_products()` (portbench/reference/l4p/ops/lowp.py) the operands
  of every linear layer, convolution and attention product are rounded to
  e4m3: the control that the correctness limits are set against.
"""

from __future__ import annotations

import json
import math
from types import SimpleNamespace
from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.l4p.ops.lowp import q8

QUERY_BLOCK = 512
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def plain_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(q8(x), q8(self.weight), self.bias)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return F.conv2d(q8(x), q8(self.weight), self.bias, self.stride, self.padding)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x):
        return F.conv_transpose2d(q8(x), q8(self.weight), self.bias, self.stride, self.padding)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over (B, H, N, D), QUERY_BLOCK queries at a time."""
    q, k, v = q8(q), q8(k), q8(v)
    scale = q.shape[-1] ** -0.5
    out = torch.empty_like(q)
    for i in range(0, q.shape[2], QUERY_BLOCK):
        s = torch.matmul(q[:, :, i: i + QUERY_BLOCK] * scale, k.transpose(-2, -1))
        out[:, :, i: i + QUERY_BLOCK] = torch.matmul(torch.softmax(s, -1), v)
    return out


# ---------------------------------------------------------------------------
# layers/rope.py
# ---------------------------------------------------------------------------

class RotaryPositionEmbedding2D(nn.Module):
    def __init__(self, frequency: float = 100.0):
        super().__init__()
        self.base_frequency = frequency

    def components(self, dim: int, seq_len: int, device):
        exponents = torch.arange(0, dim, 2, device=device).float() / dim
        inv_freq = 1.0 / (self.base_frequency ** exponents)
        positions = torch.arange(seq_len, device=device, dtype=inv_freq.dtype)
        angles = torch.einsum("i,j->ij", positions, inv_freq)
        angles = torch.cat((angles, angles), dim=-1)
        return angles.cos(), angles.sin()

    @staticmethod
    def rotate(x):
        d = x.shape[-1]
        return torch.cat((-x[..., d // 2:], x[..., : d // 2]), dim=-1)

    def apply_1d(self, tokens, positions, cos_comp, sin_comp):
        cos = F.embedding(positions, cos_comp)[:, None, :, :]
        sin = F.embedding(positions, sin_comp)[:, None, :, :]
        return tokens * cos + self.rotate(tokens) * sin

    def forward(self, tokens, positions):
        dim = tokens.size(-1) // 2
        cos_comp, sin_comp = self.components(dim, int(positions.max()) + 1, tokens.device)
        vertical, horizontal = tokens.chunk(2, dim=-1)
        vertical = self.apply_1d(vertical, positions[..., 0], cos_comp, sin_comp)
        horizontal = self.apply_1d(horizontal, positions[..., 1], cos_comp, sin_comp)
        return torch.cat((vertical, horizontal), dim=-1)


# ---------------------------------------------------------------------------
# layers/block.py, attention.py, mlp.py, layer_scale.py
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, dim, num_heads, qk_norm=False, rope=None, eps=1e-5):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        self.qkv = Linear(dim, dim * 3, bias=True)
        self.q_norm = nn.LayerNorm(self.head_dim, eps=eps) if qk_norm else nn.Identity()
        self.k_norm = nn.LayerNorm(self.head_dim, eps=eps) if qk_norm else nn.Identity()
        self.proj = Linear(dim, dim, bias=True)
        self.rope = rope

    def heads(self, x, pos=None):
        """The heads' outputs before `proj`, (B, N, C)."""
        b, n, c = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.num_heads, self.head_dim).permute(2, 0, 3, 1, 4).unbind(0)
        q, k = self.q_norm(q), self.k_norm(k)
        if self.rope is not None:
            q, k = self.rope(q, pos), self.rope(k, pos)
        return attention(q, k, v).transpose(1, 2).reshape(b, n, c)

    def forward(self, x, pos=None):
        return self.proj(self.heads(x, pos))


class Mlp(nn.Module):
    def __init__(self, in_features, hidden_features, out_features=None):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features)
        self.fc2 = Linear(hidden_features, out_features or in_features)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class LayerScale(nn.Module):
    def __init__(self, dim, init_values):
        super().__init__()
        self.gamma = nn.Parameter(init_values * torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=4.0, init_values=None, qk_norm=False, rope=None, eps=1e-5):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, num_heads, qk_norm, rope, eps)
        self.ls1 = LayerScale(dim, init_values) if init_values else nn.Identity()
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim, init_values) if init_values else nn.Identity()

    def forward(self, x, pos=None):
        x = x + self.ls1(self.attn(self.norm1(x), pos=pos))
        return x + self.ls2(self.mlp(self.norm2(x)))


# ---------------------------------------------------------------------------
# layers/vision_transformer.py: dinov2_vitl14_reg
# ---------------------------------------------------------------------------

class PatchEmbed(nn.Module):
    def __init__(self, patch_size, embed_dim):
        super().__init__()
        self.proj = Conv2d(3, embed_dim, kernel_size=patch_size, stride=patch_size)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class DinoVisionTransformer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        e, p = cfg.embed_dim, cfg.patch_size
        self.patch_size = p
        self.num_register_tokens = cfg.num_register_tokens
        self.patch_embed = PatchEmbed(p, e)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, e))
        self.pos_embed = nn.Parameter(torch.zeros(1, (cfg.img_size // p) ** 2 + 1, e))
        self.register_tokens = nn.Parameter(torch.zeros(1, cfg.num_register_tokens, e))
        self.blocks = nn.ModuleList(Block(e, cfg.embed_num_heads, cfg.mlp_ratio, cfg.embed_init_values,
                                          eps=cfg.embed_ln_eps) for _ in range(cfg.embed_depth))
        self.norm = nn.LayerNorm(e, eps=cfg.embed_ln_eps)
        self.mask_token = nn.Parameter(torch.zeros(1, e))

    def interpolate_pos_encoding(self, x, w, h):
        pos_embed = self.pos_embed.float()
        class_pos_embed, patch_pos_embed = pos_embed[:, 0], pos_embed[:, 1:]
        n = pos_embed.shape[1] - 1
        dim = x.shape[-1]
        w0, h0 = w // self.patch_size, h // self.patch_size
        m = int(math.sqrt(n))
        patch_pos_embed = F.interpolate(patch_pos_embed.reshape(1, m, m, dim).permute(0, 3, 1, 2), mode="bicubic",
                                        antialias=True, size=(w0, h0))
        patch_pos_embed = patch_pos_embed.permute(0, 2, 3, 1).view(1, -1, dim)
        return torch.cat((class_pos_embed.unsqueeze(0), patch_pos_embed), dim=1).to(x.dtype)

    def forward(self, x):
        b, _, w, h = x.shape
        x = self.patch_embed(x)
        x = torch.cat((self.cls_token.expand(x.shape[0], -1, -1), x), dim=1)
        x = x + self.interpolate_pos_encoding(x, w, h)
        x = torch.cat((x[:, :1], self.register_tokens.expand(x.shape[0], -1, -1), x[:, 1:]), dim=1)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)[:, self.num_register_tokens + 1:]


# ---------------------------------------------------------------------------
# models/aggregator.py
# ---------------------------------------------------------------------------

def slice_expand_and_flatten(token_tensor, b, s):
    query = token_tensor[:, 0:1, ...].expand(b, 1, *token_tensor.shape[2:])
    others = token_tensor[:, 1:, ...].expand(b, s - 1, *token_tensor.shape[2:])
    combined = torch.cat([query, others], dim=1)
    return combined.view(b * s, *combined.shape[2:])


class Aggregator(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        e = cfg.embed_dim
        self.patch_embed = DinoVisionTransformer(cfg)
        self.rope = RotaryPositionEmbedding2D(frequency=cfg.rope_freq)
        block = lambda: Block(e, cfg.num_heads, cfg.mlp_ratio, cfg.init_values, cfg.qk_norm, self.rope, cfg.ln_eps)
        self.frame_blocks = nn.ModuleList(block() for _ in range(cfg.depth))
        self.global_blocks = nn.ModuleList(block() for _ in range(cfg.depth))
        self.depth, self.patch_size = cfg.depth, cfg.patch_size
        self.camera_token = nn.Parameter(torch.zeros(1, 2, 1, e))
        self.register_token = nn.Parameter(torch.zeros(1, 2, cfg.num_register_tokens, e))
        self.patch_start_idx = 1 + cfg.num_register_tokens
        self.register_buffer("_resnet_mean", torch.tensor(MEAN).view(1, 1, 3, 1, 1), persistent=False)
        self.register_buffer("_resnet_std", torch.tensor(STD).view(1, 1, 3, 1, 1), persistent=False)

    def forward(self, images, keep: Sequence[int]) -> Dict[int, torch.Tensor]:
        """images (B, S, 3, H, W) in [0, 1] -> {i: output i (B, S, P, 2C)}."""
        b, s, c_in, h, w = images.shape
        images = ((images - self._resnet_mean) / self._resnet_std).view(b * s, c_in, h, w)
        patch_tokens = self.patch_embed(images)
        camera_token = slice_expand_and_flatten(self.camera_token, b, s)
        register_token = slice_expand_and_flatten(self.register_token, b, s)
        tokens = torch.cat([camera_token, register_token, patch_tokens], dim=1)
        pos = self.positions(b * s, h, w, images.device)
        _, p, c = tokens.shape
        out = {}
        for i in range(self.depth):
            tokens = self.frame_blocks[i](tokens.view(b * s, p, c), pos=pos.view(b * s, p, 2))
            frame = tokens.view(b, s, p, c)
            tokens = self.global_blocks[i](tokens.view(b, s * p, c), pos=pos.view(b, s * p, 2))
            if i in keep:
                out[i] = torch.cat([frame, tokens.view(b, s, p, c)], dim=-1)
        return out

    def positions(self, n: int, h: int, w: int, device) -> torch.Tensor:
        """(n, P, 2) (y, x) of each frame's tokens: 0 for the camera and
        register tokens, the patch grid's index + 1 for the patches."""
        gh, gw = h // self.patch_size, w // self.patch_size
        yx = torch.cartesian_prod(torch.arange(gh, device=device), torch.arange(gw, device=device))
        pos = yx.view(1, gh * gw, 2).expand(n, -1, -1) + 1
        return torch.cat([torch.zeros(n, self.patch_start_idx, 2, device=device, dtype=pos.dtype), pos], 1)


# ---------------------------------------------------------------------------
# heads/camera_head.py, utils/pose_enc.py
# ---------------------------------------------------------------------------

class CameraHead(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        dim = 2 * cfg.embed_dim
        self.trunk = nn.Sequential(*[Block(dim, cfg.camera_num_heads, cfg.mlp_ratio, cfg.init_values, eps=cfg.ln_eps)
                                     for _ in range(cfg.camera_trunk_depth)])
        self.token_norm = nn.LayerNorm(dim, eps=cfg.ln_eps)
        self.trunk_norm = nn.LayerNorm(dim, eps=cfg.ln_eps)
        self.empty_pose_tokens = nn.Parameter(torch.zeros(1, 1, 9))
        self.embed_pose = Linear(9, dim)
        self.poseLN_modulation = nn.Sequential(nn.SiLU(), Linear(dim, 3 * dim, bias=True))
        self.adaln_norm = nn.LayerNorm(dim, elementwise_affine=False, eps=1e-6)
        self.pose_branch = Mlp(dim, dim // 2, 9)
        self.iterations = cfg.camera_iterations

    def forward(self, pose_tokens) -> torch.Tensor:
        """The last aggregator output's camera tokens (B, S, 2C) -> the pose encoding (B, S, 9)."""
        pose_tokens = self.token_norm(pose_tokens)
        b, s, _ = pose_tokens.shape
        pred = None
        for _ in range(self.iterations):
            module_input = self.embed_pose(self.empty_pose_tokens.expand(b, s, -1) if pred is None else pred)
            shift, scale, gate = self.poseLN_modulation(module_input).chunk(3, dim=-1)
            modulated = gate * (self.adaln_norm(pose_tokens) * (1 + scale) + shift) + pose_tokens
            delta = self.pose_branch(self.trunk_norm(self.trunk(modulated)))
            pred = delta if pred is None else pred + delta
        return torch.cat([pred[..., :7], F.relu(pred[..., 7:])], dim=-1)


def quat_to_mat(quaternions):
    i, j, k, r = torch.unbind(quaternions, -1)
    two_s = 2.0 / (quaternions * quaternions).sum(-1)
    o = torch.stack((1 - two_s * (j * j + k * k), two_s * (i * j - k * r), two_s * (i * k + j * r),
                     two_s * (i * j + k * r), 1 - two_s * (i * i + k * k), two_s * (j * k - i * r),
                     two_s * (i * k - j * r), two_s * (j * k + i * r), 1 - two_s * (i * i + j * j)), -1)
    return o.reshape(quaternions.shape[:-1] + (3, 3))


def pose_encoding_to_extri_intri(pose_encoding, image_size_hw):
    t, quat = pose_encoding[..., :3], pose_encoding[..., 3:7]
    fov_h, fov_w = pose_encoding[..., 7], pose_encoding[..., 8]
    extrinsics = torch.cat([quat_to_mat(quat), t[..., None]], dim=-1)
    h, w = image_size_hw
    intrinsics = torch.zeros(pose_encoding.shape[:2] + (3, 3), device=pose_encoding.device)
    intrinsics[..., 0, 0] = (w / 2.0) / torch.tan(fov_w / 2.0)
    intrinsics[..., 1, 1] = (h / 2.0) / torch.tan(fov_h / 2.0)
    intrinsics[..., 0, 2], intrinsics[..., 1, 2], intrinsics[..., 2, 2] = w / 2, h / 2, 1.0
    return extrinsics, intrinsics


# ---------------------------------------------------------------------------
# heads/dpt_head.py, heads/utils.py, heads/head_act.py
# ---------------------------------------------------------------------------

class ResidualConvUnit(nn.Module):
    def __init__(self, features):
        super().__init__()
        self.conv1 = Conv2d(features, features, kernel_size=3, stride=1, padding=1, bias=True)
        self.conv2 = Conv2d(features, features, kernel_size=3, stride=1, padding=1, bias=True)
        self.activation = nn.ReLU(inplace=True)

    def forward(self, x):
        out = self.activation(x)
        out = self.conv1(out)
        out = self.activation(out)
        out = self.conv2(out)
        return out + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features, has_residual=True):
        super().__init__()
        self.out_conv = Conv2d(features, features, kernel_size=1, stride=1, padding=0, bias=True)
        if has_residual:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.has_residual = has_residual
        self.resConfUnit2 = ResidualConvUnit(features)

    def forward(self, *xs, size=None):
        output = xs[0]
        if self.has_residual:
            output = output + self.resConfUnit1(xs[1])
        output = self.resConfUnit2(output)
        if size is None:
            size = (output.shape[-2] * 2, output.shape[-1] * 2)
        output = F.interpolate(output, size=size, mode="bilinear", align_corners=True)
        return self.out_conv(output)


def create_uv_grid(width, height, aspect_ratio, dtype, device):
    diag_factor = (aspect_ratio ** 2 + 1.0) ** 0.5
    span_x, span_y = aspect_ratio / diag_factor, 1.0 / diag_factor
    x_coords = torch.linspace(-span_x * (width - 1) / width, span_x * (width - 1) / width, steps=width, dtype=dtype,
                              device=device)
    y_coords = torch.linspace(-span_y * (height - 1) / height, span_y * (height - 1) / height, steps=height,
                              dtype=dtype, device=device)
    uu, vv = torch.meshgrid(x_coords, y_coords, indexing="xy")
    return torch.stack((uu, vv), dim=-1)


def make_sincos_pos_embed(embed_dim, pos, omega_0=100):
    omega = torch.arange(embed_dim // 2, dtype=torch.double, device=pos.device)
    omega /= embed_dim / 2.0
    omega = 1.0 / omega_0 ** omega
    out = torch.einsum("m,d->md", pos.reshape(-1).double(), omega)
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1).float()


def position_grid_to_embed(pos_grid, embed_dim, omega_0=100):
    h, w, grid_dim = pos_grid.shape
    pos_flat = pos_grid.reshape(-1, grid_dim)
    emb_x = make_sincos_pos_embed(embed_dim // 2, pos_flat[:, 0], omega_0=omega_0)
    emb_y = make_sincos_pos_embed(embed_dim // 2, pos_flat[:, 1], omega_0=omega_0)
    return torch.cat([emb_x, emb_y], dim=-1).view(h, w, embed_dim)


class Scratch(nn.Module):
    pass


class DPTHead(nn.Module):
    def __init__(self, cfg, output_dim, activation):
        super().__init__()
        dim_in, oc, features = 2 * cfg.embed_dim, cfg.dpt_out_channels, cfg.dpt_features
        self.patch_size, self.activation = cfg.patch_size, activation
        self.intermediate_layer_idx = cfg.dpt_layers
        self.norm = nn.LayerNorm(dim_in, eps=cfg.ln_eps)
        self.projects = nn.ModuleList([Conv2d(dim_in, o, kernel_size=1, stride=1, padding=0) for o in oc])
        self.resize_layers = nn.ModuleList([
            ConvTranspose2d(oc[0], oc[0], kernel_size=4, stride=4, padding=0),
            ConvTranspose2d(oc[1], oc[1], kernel_size=2, stride=2, padding=0),
            nn.Identity(),
            Conv2d(oc[3], oc[3], kernel_size=3, stride=2, padding=1)])
        self.scratch = Scratch()
        for i in range(4):
            setattr(self.scratch, f"layer{i + 1}_rn", Conv2d(oc[i], features, 3, stride=1, padding=1, bias=False))
        self.scratch.refinenet1 = FeatureFusionBlock(features)
        self.scratch.refinenet2 = FeatureFusionBlock(features)
        self.scratch.refinenet3 = FeatureFusionBlock(features)
        self.scratch.refinenet4 = FeatureFusionBlock(features, has_residual=False)
        self.scratch.output_conv1 = Conv2d(features, features // 2, kernel_size=3, stride=1, padding=1)
        self.scratch.output_conv2 = nn.Sequential(Conv2d(features // 2, 32, kernel_size=3, stride=1, padding=1),
                                                  nn.ReLU(inplace=True), Conv2d(32, output_dim, kernel_size=1))
        self.frames_chunk_size = cfg.frames_chunk_size

    def apply_pos_embed(self, x, w, h, ratio=0.1):
        pos_embed = create_uv_grid(x.shape[-1], x.shape[-2], aspect_ratio=w / h, dtype=x.dtype, device=x.device)
        pos_embed = position_grid_to_embed(pos_embed, x.shape[1]) * ratio
        return x + pos_embed.permute(2, 0, 1)[None].expand(x.shape[0], -1, -1, -1)

    def forward(self, tokens: Dict[int, torch.Tensor], hw, patch_start_idx):
        s = next(iter(tokens.values())).shape[1]
        preds, confs = [], []
        for lo in range(0, s, self.frames_chunk_size):
            p, c = self.forward_impl(tokens, hw, patch_start_idx, lo, min(lo + self.frames_chunk_size, s))
            preds.append(p)
            confs.append(c)
        return torch.cat(preds, dim=1), torch.cat(confs, dim=1)

    def forward_impl(self, tokens, hw, patch_start_idx, lo, hi):
        h, w = hw
        patch_h, patch_w = h // self.patch_size, w // self.patch_size
        out = []
        for dpt_idx, layer_idx in enumerate(self.intermediate_layer_idx):
            x = tokens[layer_idx][:, lo:hi, patch_start_idx:]
            b, s = x.shape[:2]
            x = self.norm(x.reshape(b * s, -1, x.shape[-1]))
            x = x.permute(0, 2, 1).reshape((x.shape[0], x.shape[-1], patch_h, patch_w))
            x = self.apply_pos_embed(self.projects[dpt_idx](x), w, h)
            out.append(self.resize_layers[dpt_idx](x))
        sc = self.scratch
        l1, l2, l3, l4 = (getattr(sc, f"layer{i + 1}_rn")(x) for i, x in enumerate(out))
        x = sc.refinenet4(l4, size=l3.shape[2:])
        x = sc.refinenet3(x, l3, size=l2.shape[2:])
        x = sc.refinenet2(x, l2, size=l1.shape[2:])
        x = sc.refinenet1(x, l1)
        x = sc.output_conv1(x)
        x = F.interpolate(x, size=(patch_h * self.patch_size, patch_w * self.patch_size), mode="bilinear",
                          align_corners=True)
        x = sc.output_conv2(self.apply_pos_embed(x, w, h))
        fmap = x.permute(0, 2, 3, 1)
        xyz, conf = fmap[..., :-1], fmap[..., -1]
        pts = torch.exp(xyz) if self.activation == "exp" else torch.sign(xyz) * torch.expm1(torch.abs(xyz))
        conf = 1 + conf.exp()
        return pts.view(b, s, *pts.shape[1:]), conf.view(b, s, *conf.shape[1:])


# ---------------------------------------------------------------------------
# models/vggt.py
# ---------------------------------------------------------------------------

class VGGT(nn.Module):
    """`cfg` holds the configuration's numbers under the names of the
    program's VGGTConfig (the harness reads them from the configuration
    file)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.aggregator = Aggregator(cfg)
        self.camera_head = CameraHead(cfg)
        self.point_head = DPTHead(cfg, output_dim=4, activation="inv_log")
        self.depth_head = DPTHead(cfg, output_dim=2, activation="exp")

    def forward(self, rgb_u8: torch.Tensor, tasks: Sequence[str]) -> Dict[str, torch.Tensor]:
        """(B, S, H, W, 3) uint8 -> upstream's outputs for `tasks`, and
        `tokens`: the last aggregator output (B, S, P, 2C)."""
        cfg = self.cfg
        images = rgb_u8.permute(0, 1, 4, 2, 3).float() / 255.0
        hw = tuple(images.shape[-2:])
        last = cfg.depth - 1
        tokens = self.aggregator(images, set(cfg.dpt_layers) | {last})
        out = {"tokens": tokens[last]}
        if "camera" in tasks:
            out["pose_enc"] = self.camera_head(tokens[last][:, :, 0])
            out["extrinsic"], out["intrinsic"] = pose_encoding_to_extri_intri(out["pose_enc"], hw)
        if "depth" in tasks:
            out["depth"], out["depth_conf"] = self.depth_head(tokens, hw, self.aggregator.patch_start_idx)
        if "world_points" in tasks:
            out["world_points"], out["world_points_conf"] = self.point_head(tokens, hw,
                                                                            self.aggregator.patch_start_idx)
        return out


def read_config(path) -> SimpleNamespace:
    """The configuration file's numbers (its `init_args` and module groups)
    under the names the modules above read."""
    with open(path) as f:
        tree = json.load(f)
    init, agg, cam, dpt = (tree.get(k, {}) for k in ("init_args", "aggregator", "camera_head", "depth_head"))
    eps = tree.get("layer_norm_eps", {})
    return SimpleNamespace(
        img_size=init["img_size"], patch_size=init["patch_size"], embed_dim=init["embed_dim"], depth=agg["depth"],
        num_heads=agg["num_heads"], mlp_ratio=agg["mlp_ratio"], num_register_tokens=agg["num_register_tokens"],
        qk_norm=agg["qk_norm"], rope_freq=agg["rope_freq"], init_values=agg["init_values"], ln_eps=eps["default"],
        embed_depth=agg["embed_depth"], embed_num_heads=agg["embed_num_heads"], embed_ln_eps=eps["patch_embed"],
        embed_init_values=agg["embed_init_values"], camera_trunk_depth=cam["trunk_depth"],
        camera_num_heads=cam["num_heads"], camera_iterations=cam["num_iterations"], dpt_features=dpt["features"],
        dpt_out_channels=tuple(dpt["out_channels"]), dpt_layers=tuple(dpt["intermediate_layer_idx"]),
        frames_chunk_size=dpt["frames_chunk_size"])
