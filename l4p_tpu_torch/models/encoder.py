"""ViT-giant video encoder (counterpart of l4p_tpu/models/encoder.py).

Parameter names are the released checkpoint's (`patch_embed.proj`,
`blocks.{i}.{norm1,attn.{qkv,q_bias,v_bias,proj},norm2,mlp.{fc1,fc2}}`,
`norm`); the sinusoid position table is a non-persistent buffer, as in the
reference (modeling_pretrain.py:77). The tubelet embedding runs as a reshape
plus a matmul, and attention goes through the function the caller passes:
the Hopper kernel (`flash_attention`) by default.

The option branches keep the reference's names too: cosine attention's
logit scale `blocks.{i}.attn.scale` (cos_attn), the LayerScale gains
`blocks.{i}.gamma_1` / `gamma_2` (init_values > 0), a learnable `pos_embed`
(use_learnable_pos_emb) and the Plucker camera embedding's
`cam_emb.cam_emb_proj` (cam_emb_placed_at), which needs each window's
normalised intrinsics and extrinsics.

Stochastic depth (DropPath) acts when a caller passes a `DropPathDraws`:
training does, with `RandomDropPath` by default.

Under a mesh whose `model` axis has nm > 1 ranks (parallel/mesh.py), each
block holds this rank's shard (`shard_params`) and runs nh / nm heads and
hidden / nm MLP columns, Megatron's split: the LayerNorm outputs enter the
column-parallel qkv and fc1 through `copy_to_model`, and the row-parallel
proj and fc2 give fp32 partials that are summed over `model` in fp32, then
get their bias once and are cast (`row_parallel_linear`), as the JAX
package's products with preferred_element_type=float32 are reduced under
GSPMD (l4p_tpu/models/encoder.py:241-280). The attention runs on the local
heads: the process is the shard, where JAX wraps the kernel in shard_map
(`flash_attention_sharded`, l4p_tpu/ops/flash_attention.py:174-198).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Protocol, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from l4p_tpu_torch.config import GIANT, BlockConfig, EncoderConfig
from l4p_tpu_torch.geometry.core import get_rays_plucker
from l4p_tpu_torch.ops.conv import gelu, layer_norm, linear, linear_fp32
from l4p_tpu_torch.ops import qk_norm_rope as qnr
from l4p_tpu_torch.ops.flash_attention import flash_attention
from l4p_tpu_torch.ops.resize import interp_matrix
from l4p_tpu_torch.parallel.comm import Group, copy_to_model, reduce_from_model
from l4p_tpu_torch.parallel.mesh import MODEL, axis_group, axis_rank, axis_size

AttentionFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, float], torch.Tensor]
# (blocks, x, cfg, hook_ends) -> (B, len(hook_ends), N, E): fused_encoder_blocks or its plain version
EncoderBlocksFn = Callable[[Sequence[nn.Module], torch.Tensor, EncoderConfig, Sequence[int]], torch.Tensor]


def sinusoid_pos_embed(n_position: int, d_hid: int) -> np.ndarray:
    """Fixed sin/cos table (1, N, C), float64 math then float32
    (reference modeling_finetune.py:288-299)."""
    pos = np.arange(n_position, dtype=np.float64)[:, None]
    dim = np.arange(d_hid, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table[None].astype(np.float32)


def patchify(x_b3thw: torch.Tensor, cfg: EncoderConfig) -> torch.Tensor:
    """(B, C, T, H, W) -> (B, T'*H'*W', C*tt*p*p) tubelets, feature order
    (c, dt, dh, dw): the flattened Conv3d(kernel == stride) input."""
    b, c, t, h, w = x_b3thw.shape
    p, tt = cfg.patch_size, cfg.tubelet_size
    x = x_b3thw.reshape(b, c, t // tt, tt, h // p, p, w // p, p)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, (t // tt) * (h // p) * (w // p), c * tt * p * p)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: EncoderConfig, device=None, dtype=None):
        super().__init__()
        k = (cfg.tubelet_size, cfg.patch_size, cfg.patch_size)
        self.proj = nn.Conv3d(cfg.in_chans, cfg.embed_dim, k, stride=k, device=device, dtype=dtype)


class DropPathDraws(Protocol):
    """Where stochastic depth's per-sample keep masks come from."""

    def keep(self, block: int, branch: int, batch: int, keep_prob: torch.Tensor) -> torch.Tensor:
        """(batch,) bool: which samples keep branch `branch` (0 attention,
        1 MLP) of block `block`, each with probability `keep_prob` (an fp32
        scalar)."""


class RandomDropPath:
    """`DropPathDraws` from one torch.Generator seeded by (seed, step), so
    each training step draws its own masks and a rerun the same ones (the
    JAX trainer folds the step into its key); masks are drawn in the
    order the blocks ask for them."""

    def __init__(self, seed: int, step: int):
        self.generator = torch.Generator().manual_seed(hash((seed, step)) & 0x7FFF_FFFF_FFFF_FFFF)

    def keep(self, block, branch, batch, keep_prob):
        return torch.rand(batch, generator=self.generator) < keep_prob


class BatchRows:
    """`DropPathDraws` for rows [lo, hi) of a batch of n (a data rank's):
    each mask is drawn from `draws` for all n rows, as one process would
    draw it, and cut to the rows."""

    def __init__(self, draws: DropPathDraws, n: int, lo: int, hi: int):
        self.draws, self.n, self.lo, self.hi = draws, n, lo, hi

    def keep(self, block, branch, batch, keep_prob):
        if batch != self.hi - self.lo:
            raise ValueError(f"{batch} rows asked for, these draws are for {self.hi - self.lo}")
        return self.draws.keep(block, branch, self.n, keep_prob)[self.lo: self.hi]


def xavier_uniform_(w: torch.Tensor, fan_out: int, fan_in: int, generator: torch.Generator) -> None:
    """w in place: uniform in +-sqrt(6 / (fan_in + fan_out)) from `generator`
    (the JAX package's Xavier-uniform init)."""
    a = math.sqrt(6.0 / (fan_in + fan_out))
    w.uniform_(-a, a, generator=generator)


def drop_path_rates(cfg: EncoderConfig) -> torch.Tensor:
    """Each block's drop rate, linearly spaced from 0 to drop_path_rate over
    the depth (reference modeling_pretrain.py:87-89), fp32 (within a float32
    step of jnp.linspace's)."""
    return torch.linspace(0.0, cfg.drop_path_rate, cfg.depth, dtype=torch.float32)


def drop_path(x: torch.Tensor, keep_b: torch.Tensor, keep_prob: torch.Tensor) -> torch.Tensor:
    """A residual branch x (B, ...) with the samples whose `keep_b` is false
    zeroed and the others scaled by 1 / keep_prob (reference timm drop_path;
    l4p_tpu/models/encoder.py:224-230)."""
    scale = (keep_b.to(device=x.device, dtype=torch.float32) / keep_prob.to(x.device)).to(x.dtype)
    return x * scale.view(-1, *(1,) * (x.dim() - 1))


# cosine attention's logit scale is clamped at log(1 / 0.01) (reference modeling_finetune.py:122-125)
COS_ATTN_MAX_LOG_SCALE = 4.6052


class Attention(nn.Module):
    def __init__(self, cfg: BlockConfig, device=None, dtype=None):
        super().__init__()
        dim = cfg.embed_dim
        self.qkv = nn.Linear(dim, 3 * dim, bias=cfg.qkv_bias, device=device, dtype=dtype)
        if not cfg.qkv_bias:  # VideoMAE's q and v biases, no k bias
            self.q_bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))
            self.v_bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))
        if cfg.qk_norm:
            self.q_norm = nn.LayerNorm(cfg.head_dim, eps=cfg.ln_eps, device=device, dtype=dtype)
            self.k_norm = nn.LayerNorm(cfg.head_dim, eps=cfg.ln_eps, device=device, dtype=dtype)
        if cfg.cos_attn:
            self.scale = nn.Parameter(torch.full((cfg.num_heads, 1, 1), math.log(10.0), device=device, dtype=dtype))
        self.proj = nn.Linear(dim, dim, device=device, dtype=dtype)

    def qkv_bias(self) -> torch.Tensor:
        if self.qkv.bias is not None:
            return self.qkv.bias
        return torch.cat([self.q_bias, torch.zeros_like(self.v_bias), self.v_bias])  # no k bias


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device, dtype=dtype)
        self.fc2 = nn.Linear(hidden, dim, device=device, dtype=dtype)


class Block(nn.Module):
    """Pre-LN transformer block (reference modeling_finetune.py:245-252):
    x + gamma_1 * attn(ln(x)), x + gamma_2 * mlp(ln(x)), the gammas only
    when init_values > 0 (:239-243). VGGT's blocks (`BlockConfig`) add a k
    bias and exact GELU; with `qk_norm` q and k pass a LayerNorm over the
    head dim, and `rope` rotates them after it, both in fp32 before the
    attention function, in one op (ops/qk_norm_rope.py, a kernel on CUDA)
    that also lays q, k and v out for the attention kernel. `drop` ((B,)
    keep mask of the attention branch, of the MLP branch, the keep
    probability), given in training only, applies stochastic depth to both
    branches after their gains (l4p_tpu/models/encoder.py:268-282)."""

    def __init__(self, cfg: BlockConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_dim
        self.norm1 = nn.LayerNorm(e, eps=cfg.ln_eps, device=device, dtype=dtype)
        self.attn = Attention(cfg, device, dtype)
        self.norm2 = nn.LayerNorm(e, eps=cfg.ln_eps, device=device, dtype=dtype)
        self.mlp = Mlp(e, cfg.mlp_hidden, device, dtype)
        if cfg.init_values > 0:
            self.gamma_1 = nn.Parameter(torch.full((e,), cfg.init_values, device=device, dtype=dtype))
            self.gamma_2 = nn.Parameter(torch.full((e,), cfg.init_values, device=device, dtype=dtype))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """init_encoder_params' distributions for one block: Xavier-uniform
        matrices (q, k and v each as an E x E block), zero biases, unit
        LayerNorm scales, the cosine logit scale log 10 and the LayerScale
        gains init_values."""
        cfg, a = self.cfg, self.attn
        e = cfg.embed_dim
        xavier_uniform_(a.qkv.weight, e, e, generator)
        for w in (a.proj.weight, self.mlp.fc1.weight, self.mlp.fc2.weight):
            xavier_uniform_(w, *w.shape, generator)
        qkv_biases = (a.qkv.bias,) if cfg.qkv_bias else (a.q_bias, a.v_bias)
        for bias in (*qkv_biases, a.proj.bias, self.mlp.fc1.bias, self.mlp.fc2.bias, self.norm1.bias,
                     self.norm2.bias):
            bias.zero_()
        self.norm1.weight.fill_(1.0)
        self.norm2.weight.fill_(1.0)
        if cfg.qk_norm:
            for norm in (a.q_norm, a.k_norm):
                norm.weight.fill_(1.0)
                norm.bias.zero_()
        if cfg.cos_attn:
            a.scale.fill_(math.log(10.0))
        if cfg.init_values > 0:
            self.gamma_1.fill_(cfg.init_values)
            self.gamma_2.fill_(cfg.init_values)

    def forward(self, x: torch.Tensor, attention: AttentionFn, drop=None, mesh=None,
                rope: Optional[qnr.Rope2D] = None) -> torch.Tensor:
        """`mesh` (a DeviceMesh) splits the block over its `model` axis; the
        block's parameters must then be this rank's shard (`shard_params`)."""
        b, n, e = x.shape
        hd, eps = self.cfg.head_dim, self.cfg.ln_eps
        group, nm = axis_group(mesh, MODEL), axis_size(mesh, MODEL)
        nh = self.cfg.num_heads // nm  # this rank's heads
        a = self.attn
        if a.qkv.weight.shape[0] != 3 * nh * hd:
            raise ValueError(f"block qkv weight {tuple(a.qkv.weight.shape)} is not the shard of a model axis of {nm} "
                             "ranks: split the model with parallel.shard_params for this mesh")
        h = copy_to_model(layer_norm(x, self.norm1.weight, self.norm1.bias, eps), group)
        flat = linear(h, a.qkv.weight, a.qkv_bias())
        qkv = flat.view(b, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        if self.cfg.qk_norm or rope is not None:
            norms = (a.q_norm.weight, a.q_norm.bias, a.k_norm.weight, a.k_norm.bias) if self.cfg.qk_norm else None
            o = attention(*qnr.qk_norm_rope(flat, nh, eps, norms, rope), hd ** -0.5)
        elif self.cfg.cos_attn:
            # JAX's order of dtypes (l4p_tpu/models/encoder.py:256-261): q and k over their fp32 norms
            # cast to the compute dtype, the logit scale in fp32, q times it in the compute dtype
            q, k = (t / torch.linalg.vector_norm(t, dim=-1, keepdim=True, dtype=torch.float32).to(x.dtype)
                    for t in qkv[:2])
            scale = a.scale if group is None else copy_to_model(a.scale, group).narrow(0, axis_rank(mesh, MODEL) * nh, nh)
            logit_scale = torch.exp(torch.clamp(scale.float(), max=COS_ATTN_MAX_LOG_SCALE))
            o = attention(q * logit_scale.to(x.dtype), k, qkv[2], 1.0)
        else:
            o = attention(qkv[0], qkv[1], qkv[2], hd ** -0.5)  # strided views: the kernel's wrapper lays them out
        branch = row_parallel_linear(o.transpose(1, 2).reshape(b, n, nh * hd), a.proj.weight, a.proj.bias, group)
        if self.cfg.init_values > 0:
            branch = branch * self.gamma_1.to(x.dtype)
        x = x + (branch if drop is None else drop_path(branch, drop[0], drop[2]))
        h = copy_to_model(layer_norm(x, self.norm2.weight, self.norm2.bias, eps), group)
        h = linear(h, self.mlp.fc1.weight, self.mlp.fc1.bias)
        h = F.gelu(h) if self.cfg.exact_gelu else gelu(h)
        branch = row_parallel_linear(h, self.mlp.fc2.weight, self.mlp.fc2.bias, group)
        if self.cfg.init_values > 0:
            branch = branch * self.gamma_2.to(x.dtype)
        return x + (branch if drop is None else drop_path(branch, drop[1], drop[2]))


def row_parallel_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, group: Group) -> torch.Tensor:
    """`linear(x, w, b)` of a product whose input columns are split over the
    model group: this rank's partial x w^T in fp32, summed over the group in
    fp32, then the bias added once and the sum cast to x's dtype (summing
    bf16 partials would round twice). Without a group, `linear` itself."""
    if group is None:
        return linear(x, w, b)
    return (reduce_from_model(linear_fp32(x, w), group) + b.float()).to(x.dtype)


class CameraEmbedding(nn.Module):
    """The Plucker camera embedding (reference l4p/models/blocks.py:13-53;
    l4p_tpu/models/encoder.py:309-337): `cam_emb_proj` maps each token's
    6-channel ray (with its feature, for 'concat') to a feature added to
    the token."""

    def __init__(self, cfg: EncoderConfig, device=None, dtype=None):
        super().__init__()
        self.embed_type, self.tokens_thw = cfg.cam_emb_type, cfg.tokens_thw
        in_dim = 6 + (cfg.embed_dim if cfg.cam_emb_type == "concat" else 0)
        self.cam_emb_proj = nn.Linear(in_dim, cfg.embed_dim, device=device, dtype=dtype)

    def rays(self, intrinsics_b44t: torch.Tensor, extrinsics_b44t: torch.Tensor) -> torch.Tensor:
        """Each token's ray (B, t*h*w, 6) in (t, h, w) order: the rays at the
        (h, w) patch grid, each window relative to its first camera, linearly
        resized in time from the window's frames to its t tubelets
        (align_corners False)."""
        b = intrinsics_b44t.shape[0]
        et, eh, ew = self.tokens_thw
        camray, _ = get_rays_plucker(intrinsics_b44t, extrinsics_b44t, (eh, ew))  # (B, 6, T, h, w)
        t_full = camray.shape[2]
        m = torch.from_numpy(interp_matrix(t_full, et, align_corners=False)).to(camray.device)
        flat = camray.permute(0, 3, 4, 1, 2).reshape(b, -1, t_full) @ m.T.to(camray.dtype)  # (B, h*w*6, t)
        return flat.reshape(b, eh, ew, 6, et).permute(0, 4, 1, 2, 3).reshape(b, -1, 6)

    def forward(self, feat_blc: torch.Tensor, rays_bn6: torch.Tensor) -> torch.Tensor:
        """Tokens (B, N, C) plus the projection of their rays (`rays`)."""
        rays_bn6 = rays_bn6.to(feat_blc.dtype)
        x = torch.cat([feat_blc, rays_bn6], -1) if self.embed_type == "concat" else rays_bn6
        return feat_blc + linear(x, self.cam_emb_proj.weight, self.cam_emb_proj.bias)


class VideoEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig = GIANT, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg, device, dtype)
        self.blocks = nn.ModuleList(Block(cfg.block, device, dtype) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps, device=device, dtype=dtype)
        table = torch.as_tensor(sinusoid_pos_embed(cfg.num_tokens, cfg.embed_dim), device=device)
        table = table.to(dtype or torch.get_default_dtype())
        if cfg.use_learnable_pos_emb:
            self.pos_embed = nn.Parameter(table)
        else:
            self.register_buffer("pos_embed", table, persistent=False)
        if cfg.cam_emb_placed_at is not None:
            self.cam_emb = CameraEmbedding(cfg, device, dtype)

    def embed(self, x_b3thw: torch.Tensor) -> torch.Tensor:
        """Float video -> (B, N, E) tokens without the position table. The
        video is cast to the weights' dtype: the encoder computes in it."""
        w = self.patch_embed.proj.weight
        x = patchify(x_b3thw.to(w.dtype), self.cfg)
        return linear(x, w.flatten(1), self.patch_embed.proj.bias)

    def forward(self, tokens_bne: torch.Tensor, hooks: Sequence[int],
                attention: AttentionFn = flash_attention,
                encoder_blocks: Optional[EncoderBlocksFn] = None,
                intrinsics_b44t: Optional[torch.Tensor] = None,
                extrinsics_b44t: Optional[torch.Tensor] = None,
                drop_path_draws: Optional[DropPathDraws] = None, mesh=None) -> Dict[str, object]:
        """Tokens (B, N, E) without the position table -> {'hooks': [feature
        per hook], 'final': normed output}. Hook index 0 is the embedding,
        index i the output of block i-1, index `depth` the normed output
        (reference l4p_videomae.py:108-115). The blocks run in one
        `encoder_blocks` call when one is given (`fused_encoder_blocks`, as
        `encode_windows` passes it under `cfg.encoder.fused_encoder`), else
        one by one with `attention`. With the camera embedding, each batch
        item's normalised intrinsics and extrinsics (B, 4, 4, frames) are
        needed: it is added after the positions ('input') or to every hook
        feature and the output ('output'; l4p_tpu/models/encoder.py:378-381,
        :452-459). With `drop_path_draws` and drop_path_rate > 0 (training) the
        blocks run one by one with stochastic depth, whatever
        `encoder_blocks` says (the fused gate of :390-394). `mesh` splits
        the blocks over its `model` axis (`Block.forward`); the whole-encoder
        kernels take no mesh, and `encoder_blocks` with one raises, where
        JAX's gate runs the default blocks (`fused_encoder_engaged`,
        l4p_tpu/models/encoder.py:296)."""
        cfg = self.cfg
        if mesh is not None and encoder_blocks is not None:
            raise ValueError(f"the fused encoder (encoder_blocks) takes no mesh, got {mesh}: serve the mesh with "
                             "fused_encoder off")
        x = tokens_bne + self.pos_embed.to(tokens_bne.dtype)
        place = cfg.cam_emb_placed_at
        if place is not None:
            if intrinsics_b44t is None or extrinsics_b44t is None:
                raise ValueError(f"the camera embedding (cam_emb_placed_at {place!r}) needs intrinsics_b44t and "
                                 "extrinsics_b44t")
            rays = self.cam_emb.rays(intrinsics_b44t, extrinsics_b44t)  # one ray map for every feature
        if place == "input":
            x = self.cam_emb(x, rays)
        feats: Dict[int, torch.Tensor] = {0: x}
        dropping = drop_path_draws is not None and cfg.drop_path_rate > 0
        if encoder_blocks is not None and not dropping:
            ends = sorted({h for h in hooks if h > 0} | {cfg.depth})
            stack = encoder_blocks(self.blocks, x, cfg, ends)
            feats.update({e: stack[:, i] for i, e in enumerate(ends)})
            x = feats[cfg.depth]
        else:
            keep_probs = 1.0 - drop_path_rates(cfg) if dropping else None
            for i, blk in enumerate(self.blocks):
                drop = None
                if dropping:
                    p = keep_probs[i]
                    drop = tuple(drop_path_draws.keep(i, branch, x.shape[0], p) for branch in (0, 1)) + (p,)
                x = blk(x, attention, drop, mesh)
                if i + 1 in hooks:
                    feats[i + 1] = x
        final = layer_norm(x, self.norm.weight, self.norm.bias, cfg.ln_eps)
        if place == "output":
            final = self.cam_emb(final, rays)
            feats = {h: final if h == cfg.depth else self.cam_emb(feats[h], rays) for h in hooks}
        feats[cfg.depth] = final
        return {"hooks": [feats[h] for h in hooks], "final": final}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from `generator`, with the distributions of the JAX
        package's init_encoder_params: Xavier-uniform matrices (q, k and v
        each as an E x E block), zero biases, unit LayerNorm scales; the
        options' cosine logit scales log 10, LayerScale gains init_values,
        the sinusoid table for learnable positions, and the camera
        projection uniform in +-sqrt(1 / its input width)."""
        cfg, e = self.cfg, self.cfg.embed_dim
        pw = self.patch_embed.proj.weight
        xavier_uniform_(pw, e, pw[0].numel(), generator)
        self.patch_embed.proj.bias.zero_()
        for blk in self.blocks:
            blk.init_weights(generator)
        self.norm.weight.fill_(1.0)
        self.norm.bias.zero_()
        self.pos_embed.copy_(torch.as_tensor(sinusoid_pos_embed(cfg.num_tokens, e)))
        if cfg.cam_emb_placed_at is not None:
            w = self.cam_emb.cam_emb_proj.weight
            a = math.sqrt(1.0 / w.shape[1])
            w.uniform_(-a, a, generator=generator)
            self.cam_emb.cam_emb_proj.bias.zero_()
