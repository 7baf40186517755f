"""SAM-style promptable video decoder of the track head: prompt encoder,
two-way transformer, mask decoder (counterpart of l4p_tpu/models/sam.py);
and SAM 2's 2D prompt encoder and mask decoder (`Sam2PromptEncoder`,
`Sam2MaskDecoder`, `sam2_decode`) on the same two-way transformer, attention
and MLP modules (`twoway_block`, `attn_apply`, `pe_encoding`, `HyperMLP`).

Modules carry the released checkpoint's parameter names; the forward
functions take them and plain tensors. Queries are the decoder's batch
axis N, and each carries its own (N, P, C) image embedding.

The two-way transformer has two image-side schedules:
* `naive`: the direct transcription with full image-side projections, the
  oracle of the other;
* `streamed`: every projection that touches the (N, P, C) keys is
  reassociated through the ~6-token bottleneck (sam.py:217-238 of the JAX
  package), and the keys are streamed through the two fused kernels
  `t2i_flash` and `i2t_ln_t2i` in the pass schedule of `twoway_streamed`.
  With the kernels' plain versions (`PLAIN`) this is the JAX package's
  `factored` path, so `impl="factored"` maps onto it. With any other
  kernels it runs as one `TwoWayStreamedFunction` over the queries, keys,
  encodings and the transformer's parameters, whose backward recomputes
  the factored path (JAX's `_twoway_streamed` custom VJP, sam.py:398-481).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from l4p_tpu_torch.config import SamConfig
from l4p_tpu_torch.ops.attention import mha
from l4p_tpu_torch.ops.conv import einsum_fp32, layer_norm, linear
from l4p_tpu_torch.ops.fused_keys import i2t_ln_t2i, i2t_ln_t2i_plain, t2i_flash, t2i_flash_plain
from l4p_tpu_torch.ops.fused_upscale import fused_upscale_hypernet, fused_upscale_hypernet_plain
from l4p_tpu_torch.ops.recompute import module_call, recomputing_function

LN_EPS = 1e-5  # the two-way transformer's norms are torch nn.LayerNorm defaults


@dataclasses.dataclass(frozen=True)
class TrackKernels:
    """The track head's three kernel functions; `PLAIN` holds their plain
    versions, which tests and the card's comparisons pass explicitly."""

    t2i: Callable = t2i_flash
    i2t: Callable = i2t_ln_t2i
    upscale: Callable = fused_upscale_hypernet


KERNELS = TrackKernels()
PLAIN = TrackKernels(t2i_flash_plain, i2t_ln_t2i_plain, fused_upscale_hypernet_plain)


# ---------------------------------------------------------------------------
# modules (released names)
# ---------------------------------------------------------------------------

class PositionEmbeddingRandom(nn.Module):
    """The random Fourier matrix of `coords` coordinates: (t, x, y) for the
    track head, (x, y) for SAM 2."""

    def __init__(self, embed_dim: int, device=None, dtype=None, coords: int = 3):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros((coords, embed_dim // 2), device=device, dtype=dtype))


class PromptEncoder(nn.Module):
    """`no_mask_embed` is instantiated by the reference but never read by the
    video forward; it is kept so the released state dict loads strictly."""

    def __init__(self, cfg: SamConfig, with_features: bool, device=None, dtype=None):
        super().__init__()
        c, kw = cfg.embed_dim, dict(device=device, dtype=dtype)
        self.pe_layer = PositionEmbeddingRandom(c, **kw)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, c, **kw) for _ in range(cfg.num_point_embeddings))
        self.not_a_point_embed = nn.Embedding(1, c, **kw)
        self.no_mask_embed = nn.Embedding(1, c, **kw)
        if with_features:
            self.prompt_feature_embeddings = nn.ModuleList(
                nn.Embedding(1, c, **kw) for _ in range(cfg.num_prompt_feature_embeddings))


class Attention(nn.Module):
    def __init__(self, dim: int, downsample: int = 1, device=None, dtype=None):
        super().__init__()
        inner, kw = dim // downsample, dict(device=device, dtype=dtype)
        self.q_proj = nn.Linear(dim, inner, **kw)
        self.k_proj = nn.Linear(dim, inner, **kw)
        self.v_proj = nn.Linear(dim, inner, **kw)
        self.out_proj = nn.Linear(inner, dim, **kw)


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None, dtype=None):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden, device=device, dtype=dtype)
        self.lin2 = nn.Linear(hidden, dim, device=device, dtype=dtype)


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, cfg: SamConfig, device=None, dtype=None):
        super().__init__()
        c, dr, kw = cfg.embed_dim, cfg.attention_downsample_rate, dict(device=device, dtype=dtype)
        self.self_attn = Attention(c, 1, **kw)
        self.norm1 = nn.LayerNorm(c, eps=LN_EPS, **kw)
        self.cross_attn_token_to_image = Attention(c, dr, **kw)
        self.norm2 = nn.LayerNorm(c, eps=LN_EPS, **kw)
        self.mlp = MLPBlock(c, cfg.mlp_dim, **kw)
        self.norm3 = nn.LayerNorm(c, eps=LN_EPS, **kw)
        self.norm4 = nn.LayerNorm(c, eps=LN_EPS, **kw)
        self.cross_attn_image_to_token = Attention(c, dr, **kw)


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SamConfig, device=None, dtype=None):
        super().__init__()
        c, kw = cfg.embed_dim, dict(device=device, dtype=dtype)
        self.layers = nn.ModuleList(TwoWayAttentionBlock(cfg, **kw) for _ in range(cfg.sam_head_depth))
        self.final_attn_token_to_image = Attention(c, cfg.attention_downsample_rate, **kw)
        self.norm_final_attn = nn.LayerNorm(c, eps=LN_EPS, **kw)


class HyperMLP(nn.Module):
    def __init__(self, dim: int, out: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.layers = nn.ModuleList([nn.Linear(dim, dim, **kw), nn.Linear(dim, dim, **kw), nn.Linear(dim, out, **kw)])


class MaskDecoder(nn.Module):
    """`output_upscaling` is (deconv1, LayerNorm, GELU, deconv2, GELU), as
    released; `iou_token` is never read by the video forward."""

    def __init__(self, cfg: SamConfig, num_mask_tokens: int, device=None, dtype=None):
        super().__init__()
        c, kw = cfg.embed_dim, dict(device=device, dtype=dtype)
        d1, d2 = cfg.decode_dims
        self.transformer = TwoWayTransformer(cfg, **kw)
        self.iou_token = nn.Embedding(1, c, **kw)
        self.mask_tokens = nn.Embedding(num_mask_tokens, c, **kw)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose3d(c, d1, 2, stride=2, **kw),
            nn.LayerNorm(d1, eps=1e-6, **kw),
            nn.GELU(),
            nn.ConvTranspose3d(d1, d2, (1, 2, 2), stride=(1, 2, 2), **kw),
            nn.GELU(),
        )
        self.output_hypernetworks_mlps = nn.ModuleList(HyperMLP(c, d2, **kw) for _ in range(num_mask_tokens))


# ---------------------------------------------------------------------------
# prompt encoder (l4p_tpu/models/sam.py:54-129)
# ---------------------------------------------------------------------------

def pe_encoding(coords: torch.Tensor, gauss: torch.Tensor) -> torch.Tensor:
    """Random-Fourier encoding of [0, 1]^d coordinates (d the rows of
    `gauss`: 3 for the track head, 2 for SAM 2), fp32."""
    c = 2 * math.pi * torch.matmul((2 * coords - 1).float(), gauss.float())
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def dense_pe(gauss: torch.Tensor, cfg: SamConfig) -> torch.Tensor:
    """(1, C, t, h, w) encoding of the token grid's centres; the coordinate
    order is (t, x, y) from a (t, y, x) meshgrid."""
    t, h, w = cfg.image_embedding_size
    dev = gauss.device
    t_e, y_e, x_e = ((torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s for s in (t, h, w))
    tt, yy, xx = torch.meshgrid(t_e, y_e, x_e, indexing="ij")
    pe = pe_encoding(torch.stack([tt, xx, yy], dim=-1), gauss)
    return pe.permute(3, 0, 1, 2)[None]


@functools.lru_cache(maxsize=16)
def point_scale(t: int, w: int, h: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(t, w, h) on `device`, made once: a copy from host memory waits for
    the device, and every window of the track scan divides by it."""
    with torch.inference_mode(False):  # read by training steps too
        return torch.tensor([t, w, h], dtype=dtype, device=device)


def embed_points(pe: PromptEncoder, cfg: SamConfig, points_n13: torch.Tensor, labels_n1: torch.Tensor,
                 pad: bool = True) -> torch.Tensor:
    """(t, x, y) point prompts, normalised by (T, W, H), plus per-label
    embeddings. Labels: -1 padding, 0 invalid, 1 input, 2 predicted (no
    additive embedding with two point embeddings, as released)."""
    n = points_n13.shape[0]
    if pad:
        points_n13 = torch.cat([points_n13, points_n13.new_zeros((n, 1, 3))], dim=1)
        labels_n1 = torch.cat([labels_n1, -labels_n1.new_ones((n, 1))], dim=1)
    t, h, w = cfg.input_image_size
    coords = points_n13 / point_scale(t, w, h, points_n13.dtype, points_n13.device)
    emb = pe_encoding(coords, pe.pe_layer.positional_encoding_gaussian_matrix).to(points_n13.dtype)
    lab = labels_n1[..., None]
    emb = torch.where(lab == -1, pe.not_a_point_embed.weight[0].to(emb.dtype), emb)
    for i, point in enumerate(pe.point_embeddings):
        emb = emb + torch.where(lab == i, point.weight[0].to(emb.dtype), torch.zeros_like(emb))
    return emb


def embed_features(pe: PromptEncoder, features_n1c: torch.Tensor, labels_n1: torch.Tensor) -> torch.Tensor:
    """Track-feature prompts: + embedding 0 for label 0, + embedding 1 for
    label 1, zero otherwise."""
    lab = labels_n1[..., None]
    emb0 = features_n1c + pe.prompt_feature_embeddings[0].weight[0].to(features_n1c.dtype)
    emb1 = features_n1c + pe.prompt_feature_embeddings[1].weight[0].to(features_n1c.dtype)
    return torch.where(lab == 1, emb1, torch.where(lab == 0, emb0, torch.zeros_like(features_n1c)))


def prompt_encoder_apply(pe: PromptEncoder, cfg: SamConfig, points_n13: torch.Tensor, labels_n1: torch.Tensor,
                         features_n1c: Optional[torch.Tensor] = None,
                         feature_labels_n1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sparse prompt embeddings (N, prompts, C)."""
    sparse = embed_points(pe, cfg, points_n13, labels_n1, pad=True)
    if cfg.prompt_using_features:
        n = points_n13.shape[0]
        if features_n1c is None:
            features_n1c = sparse.new_zeros((n, 1, cfg.embed_dim))
        if feature_labels_n1 is None:
            feature_labels_n1 = sparse.new_zeros((n, 1))
        sparse = torch.cat([sparse, embed_features(pe, features_n1c, feature_labels_n1).to(sparse.dtype)], dim=1)
    return sparse


# ---------------------------------------------------------------------------
# two-way transformer (l4p_tpu/models/sam.py:136-632)
# ---------------------------------------------------------------------------

def attn_apply(p: Attention, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
               q_pe: Optional[torch.Tensor] = None, k_pe: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Projection attention with internal downsample; positional encodings
    enter through the projections: proj(x + pe) = proj(x) + proj(pe)."""
    q = linear(q, p.q_proj.weight, p.q_proj.bias)
    if q_pe is not None:
        q = q + linear(q_pe, p.q_proj.weight).to(q.dtype)
    k = linear(k, p.k_proj.weight, p.k_proj.bias)
    if k_pe is not None:
        k = k + linear(k_pe, p.k_proj.weight).to(k.dtype)
    v = linear(v, p.v_proj.weight, p.v_proj.bias)
    b, nq, c = q.shape
    hd = c // num_heads
    qh, kh, vh = (x.reshape(x.shape[0], x.shape[1], num_heads, hd).transpose(1, 2) for x in (q, k, v))
    out = mha(qh, kh, vh, scale=hd ** -0.5).transpose(1, 2).reshape(b, nq, c)
    return linear(out, p.out_proj.weight, p.out_proj.bias)


def _norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    return layer_norm(x, ln.weight, ln.bias, LN_EPS)


def _mlp(x: torch.Tensor, mlp: MLPBlock) -> torch.Tensor:
    return linear(torch.relu(linear(x, mlp.lin1.weight, mlp.lin1.bias)), mlp.lin2.weight, mlp.lin2.bias)


def twoway_block(p: TwoWayAttentionBlock, cfg: SamConfig, queries, keys, query_pe, key_pe,
                 skip_first_layer_pe: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """TwoWayAttentionBlock, direct transcription."""
    nh = cfg.num_heads
    if skip_first_layer_pe:
        queries = attn_apply(p.self_attn, queries, queries, queries, nh)
    else:
        queries = queries + attn_apply(p.self_attn, queries, queries, queries, nh, query_pe, query_pe)
    queries = _norm(queries, p.norm1)
    queries = _norm(queries + attn_apply(p.cross_attn_token_to_image, queries, keys, keys, nh, query_pe, key_pe),
                    p.norm2)
    queries = _norm(queries + _mlp(queries, p.mlp), p.norm3)
    keys = _norm(keys + attn_apply(p.cross_attn_image_to_token, keys, queries, queries, nh, key_pe, query_pe),
                 p.norm4)
    return queries, keys


def proj_q_with_pe(lin: nn.Linear, x: torch.Tensor, pe: torch.Tensor) -> torch.Tensor:
    out = linear(x, lin.weight, lin.bias)
    return out + linear(pe, lin.weight).to(out.dtype)


def t2i_prep(p: Attention, queries, query_pe, pe_pc, num_heads: int):
    """Token-side operands of `t2i_flash`: st (N, C, K) in the compute
    dtype, the scaled query side through Wk; spe (N, P, K) f32 = s . pe^T."""
    q = proj_q_with_pe(p.q_proj, queries, query_pe)
    n, nq, d = q.shape
    hd = d // num_heads
    c = pe_pc.shape[-1]
    qh = q.view(n, nq, num_heads, hd).transpose(1, 2) * hd ** -0.5
    s = einsum_fp32("nhqd,hdc->nhqc", qh, p.k_proj.weight.view(num_heads, hd, c)).to(qh.dtype)
    s_flat = s.reshape(n, num_heads * nq, c)
    # the kernel reads the (N, P, K) logit terms row by row: the fp32 einsum returns a permuted view
    return s_flat.transpose(1, 2), einsum_fp32("nkc,pc->npk", s_flat, pe_pc).contiguous()


def t2i_finish(p: Attention, wsum_f32: torch.Tensor, num_heads: int, out_dtype) -> torch.Tensor:
    """wsum (N, K, C) f32 -> the attention output (N, Q, C): value side and
    out_proj, the v bias riding through because softmax rows sum to 1."""
    n, k, c = wsum_f32.shape
    nq = k // num_heads
    d = p.v_proj.weight.shape[0]
    hd = d // num_heads
    wsum = wsum_f32.to(out_dtype).view(n, num_heads, nq, c)
    outh = einsum_fp32("nhqc,hdc->nhqd", wsum, p.v_proj.weight.view(num_heads, hd, c))
    outh = outh + p.v_proj.bias.view(num_heads, 1, hd).float()
    out = outh.to(out_dtype).transpose(1, 2).reshape(n, nq, d)
    return linear(out, p.out_proj.weight, p.out_proj.bias)


def i2t_prep(p: Attention, queries, query_pe, pe_pc, num_heads: int):
    """Token-side operands of `i2t_ln_t2i`: r (N, C, K), per (N, P, K) f32
    (pe term + q-bias term), v2 (N, K, C) already through out_proj, and the
    out_proj bias."""
    c = pe_pc.shape[-1]
    k_tok = proj_q_with_pe(p.k_proj, queries, query_pe)
    v_tok = linear(queries, p.v_proj.weight, p.v_proj.bias)
    n, nq, d = k_tok.shape
    hd = d // num_heads
    kh = k_tok.view(n, nq, num_heads, hd).transpose(1, 2) * hd ** -0.5
    vh = v_tok.view(n, nq, num_heads, hd).transpose(1, 2)
    dt = kh.dtype
    r4 = einsum_fp32("hdc,nhqd->nhcq", p.q_proj.weight.view(num_heads, hd, c).to(dt), kh).to(dt)
    r = r4.permute(0, 2, 1, 3).reshape(n, c, num_heads * nq)
    bterm = torch.einsum("hd,nhqd->nhq", p.q_proj.bias.view(num_heads, hd).float(), kh.float())
    per = einsum_fp32("pc,nck->npk", pe_pc.to(dt), r)
    per += bterm.reshape(n, 1, num_heads * nq)
    per = per.contiguous()  # read row by row, as t2i_prep's spe
    wo_h = p.out_proj.weight.view(c, num_heads, hd).permute(1, 2, 0)  # (h, hd, C)
    v2 = einsum_fp32("nhqd,hdc->nhqc", vh, wo_h).to(dt).reshape(n, num_heads * nq, c)
    return r, per, v2, p.out_proj.bias


def _twoway_streamed(tf: TwoWayTransformer, cfg: SamConfig, queries, keys, query_pe, pe_pc,
                     kernels: TrackKernels) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole two-way transformer with the image side in the two fused
    kernels. Pass schedule (legal because everything between a layer's i2t
    and the next layer's t2i logits touches only the token side):
      1. layer 0's self-attention + norm1, then t2i (one pass over keys);
      2. per layer: t2i tail + norm2 + MLP + norm3, the i2t operands, the
         next t2i's operands (next layer's self-attention + norm1, or the
         final attention), then i2t_ln_t2i, which emits the new keys and
         the next t2i weighted sum;
      3. the final attention's tail + norm_final_attn."""
    nh = cfg.num_heads
    layers = list(tf.layers)
    p0 = layers[0]
    queries = _norm(attn_apply(p0.self_attn, queries, queries, queries, nh), p0.norm1)
    st, spe = t2i_prep(p0.cross_attn_token_to_image, queries, query_pe, pe_pc, nh)
    wsum = kernels.t2i(keys, st, spe)
    for i, p in enumerate(layers):
        queries = _norm(queries + t2i_finish(p.cross_attn_token_to_image, wsum, nh, queries.dtype), p.norm2)
        queries = _norm(queries + _mlp(queries, p.mlp), p.norm3)
        r, per, v2, ob = i2t_prep(p.cross_attn_image_to_token, queries, query_pe, pe_pc, nh)
        if i + 1 < len(layers):
            pn = layers[i + 1]
            queries = _norm(queries + attn_apply(pn.self_attn, queries, queries, queries, nh, query_pe, query_pe),
                            pn.norm1)
            t2i_next = pn.cross_attn_token_to_image
        else:
            t2i_next = tf.final_attn_token_to_image
        st, spe = t2i_prep(t2i_next, queries, query_pe, pe_pc, nh)
        keys, wsum = kernels.i2t(keys, r, per, v2, ob, p.norm4.weight, p.norm4.bias, st, spe, nh, LN_EPS)
    queries = queries + t2i_finish(tf.final_attn_token_to_image, wsum, nh, queries.dtype)
    return _norm(queries, tf.norm_final_attn), keys


def _twoway_kernels(tf, cfg, kernels, names, queries, keys, query_pe, pe_pc, *params):
    return _twoway_streamed(tf, cfg, queries, keys, query_pe, pe_pc, kernels)


def _twoway_plain(tf, cfg, kernels, names, queries, keys, query_pe, pe_pc, *params):
    return module_call(lambda tf_, *a: _twoway_streamed(tf_, cfg, *a, PLAIN), tf, names, params, queries, keys,
                       query_pe, pe_pc)


# `_twoway_streamed` with `kernels` over (queries, keys, query_pe, pe_pc) and
# the parameters `names` of `tf`; the backward recomputes it with the plain
# versions (JAX's factored path) on those inputs
TwoWayStreamedFunction = recomputing_function("TwoWayStreamedFunction", _twoway_kernels, _twoway_plain, consts=4)


def twoway_streamed(tf: TwoWayTransformer, cfg: SamConfig, queries, keys, query_pe, pe_pc,
                    kernels: TrackKernels = KERNELS) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries (N, Q, C), keys (N, P, C), query_pe (N, Q, C), pe_pc (P, C)
    -> (queries, keys) after the transformer, differentiable in all four and
    in tf's parameters: directly with the plain versions, else through
    `TwoWayStreamedFunction` (every kernel call is one of `kernels`)."""
    if kernels == PLAIN:
        return _twoway_streamed(tf, cfg, queries, keys, query_pe, pe_pc, PLAIN)
    names, params = zip(*tf.named_parameters())
    return TwoWayStreamedFunction.apply(tf, cfg, kernels, names, queries, keys, query_pe, pe_pc, *params)


def twoway_transformer_apply(tf: TwoWayTransformer, cfg: SamConfig, image_embedding: torch.Tensor,
                             image_pe: torch.Tensor, point_embedding: torch.Tensor, impl: str = "streamed",
                             kernels: TrackKernels = KERNELS) -> Tuple[torch.Tensor, torch.Tensor]:
    """image_embedding (N, P, C), image_pe (1, P, C), point_embedding
    (N, Q, C) -> (queries (N, Q, C), keys (N, P, C)). `impl`: 'streamed'
    (with `kernels`), 'factored' (streamed with the plain versions) or
    'naive'."""
    if impl in ("streamed", "factored"):
        return twoway_streamed(tf, cfg, point_embedding, image_embedding, point_embedding, image_pe[0],
                               kernels if impl == "streamed" else PLAIN)
    if impl != "naive":
        raise ValueError(f"unknown two-way transformer impl {impl!r}")
    queries, keys = point_embedding, image_embedding
    for i, layer in enumerate(tf.layers):
        queries, keys = twoway_block(layer, cfg, queries, keys, point_embedding, image_pe, i == 0)
    queries = queries + attn_apply(tf.final_attn_token_to_image, queries, keys, keys, cfg.num_heads,
                                   point_embedding, image_pe)
    return _norm(queries, tf.norm_final_attn), keys


# ---------------------------------------------------------------------------
# mask decoder (l4p_tpu/models/sam.py:639-748)
# ---------------------------------------------------------------------------

def hyper_mlp(mlp: HyperMLP, x: torch.Tensor) -> torch.Tensor:
    for i, lin in enumerate(mlp.layers):
        x = linear(x, lin.weight, lin.bias)
        if i < len(mlp.layers) - 1:
            x = torch.relu(x)
    return x


def mask_decoder_apply(md: MaskDecoder, cfg: SamConfig, image_embeddings: torch.Tensor, image_pe: torch.Tensor,
                       sparse: torch.Tensor,
                       kernels: TrackKernels = KERNELS) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """image_embeddings (N or 1, P, C), image_pe (1, C, t, h, w), sparse
    prompts (N, Q, C) -> (mask logits (N, M, 2t, 4h, 4w) in the image dtype,
    {'io_features': tokens (N, M + Q, C), 'enc_features': keys (N, P, C)}).

    The upscale keeps the deconv offsets packed (both deconvs have kernel ==
    stride) until the logits, which are interleaved once at the end."""
    n = sparse.shape[0]
    t, h, w = cfg.image_embedding_size
    c = cfg.embed_dim
    m = md.mask_tokens.weight.shape[0]
    tokens = torch.cat([md.mask_tokens.weight.to(sparse.dtype)[None].expand(n, m, c), sparse], dim=1)
    src = image_embeddings
    if src.shape[0] == 1 and n > 1:
        src = src.expand(n, *src.shape[1:]).contiguous()
    pos_src = image_pe.reshape(1, c, -1).transpose(1, 2).to(src.dtype)
    hs, src = twoway_transformer_apply(md.transformer, cfg, src, pos_src, tokens, "streamed", kernels)
    hyper_in = torch.stack([hyper_mlp(md.output_hypernetworks_mlps[i], hs[:, i]) for i in range(m)], dim=1)
    deconv1, ln, _, deconv2, _ = md.output_upscaling
    out = kernels.upscale(src, deconv1.weight, deconv1.bias, ln.weight, ln.bias, deconv2.weight, deconv2.bias,
                          hyper_in)  # (N, M, P, k1, k2)
    kt, kh, kw = deconv1.weight.shape[2:]
    lt, lh, lw = deconv2.weight.shape[2:]
    out = out.reshape(n, m, t, h, w, kt, kh, kw, lt, lh, lw).permute(0, 1, 2, 5, 8, 3, 6, 9, 4, 7, 10)
    out = out.reshape(n, m, t * kt * lt, h * kh * lh, w * kw * lw)
    return out.to(src.dtype), {"io_features": hs, "enc_features": src}


# ---------------------------------------------------------------------------
# SAM 2's 2D prompt encoder and mask decoder (facebookresearch/sam2:
# sam2/modeling/sam/prompt_encoder.py, mask_decoder.py, transformer.py)
# ---------------------------------------------------------------------------

NO_OBJ_SCORE = -1024.0  # sam2_base.py: the logits of a mask whose object is absent


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of (N, C, H, W) (upstream's LayerNorm2d,
    eps 1e-6), applied by `layer_norm_2d`."""

    def __init__(self, channels: int, eps: float = 1e-6, device=None, dtype=None):
        super().__init__(channels, eps=eps, device=device, dtype=dtype)


def layer_norm_2d(x: torch.Tensor, ln: LayerNorm2d) -> torch.Tensor:
    """LayerNorm2d as ops/conv.py's layer_norm over the channels-last view."""
    return layer_norm(x.permute(0, 2, 3, 1), ln.weight, ln.bias, ln.eps).permute(0, 3, 1, 2)


class Sam2PromptEncoder(nn.Module):
    """Points (two labels and two box corners) and the mask prompt's
    downscaling, which the video propagation never runs but the released
    state dict holds."""

    def __init__(self, embed_dim: int, mask_in_chans: int = 16, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.pe_layer = PositionEmbeddingRandom(embed_dim, coords=2, **kw)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, embed_dim, **kw) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim, **kw)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mask_in_chans // 4, 2, stride=2, **kw), LayerNorm2d(mask_in_chans // 4, **kw), nn.GELU(),
            nn.Conv2d(mask_in_chans // 4, mask_in_chans, 2, stride=2, **kw), LayerNorm2d(mask_in_chans, **kw),
            nn.GELU(), nn.Conv2d(mask_in_chans, embed_dim, 1, **kw))
        self.no_mask_embed = nn.Embedding(1, embed_dim, **kw)


class Sam2MaskDecoder(nn.Module):
    """The two-way transformer (`TwoWayTransformer` on a SamConfig of SAM 2's
    widths), the object-score, IoU and mask tokens, the upscaling with the
    high-resolution skips, and the hypernetwork, IoU and object-score MLPs.
    The transformer's MLPs are `MLPBlock`'s lin1 / lin2, upstream's
    mlp.layers.0 / 1 (models/sam2.py:upstream_name maps them)."""

    def __init__(self, cfg: SamConfig, device=None, dtype=None):
        super().__init__()
        c, m, kw = cfg.embed_dim, cfg.num_mask_tokens, dict(device=device, dtype=dtype)
        self.transformer = TwoWayTransformer(cfg, **kw)
        self.iou_token = nn.Embedding(1, c, **kw)
        self.mask_tokens = nn.Embedding(m, c, **kw)
        self.obj_score_token = nn.Embedding(1, c, **kw)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(c, c // 4, 2, stride=2, **kw), LayerNorm2d(c // 4, **kw), nn.GELU(),
            nn.ConvTranspose2d(c // 4, c // 8, 2, stride=2, **kw), nn.GELU())
        self.conv_s0 = nn.Conv2d(c, c // 8, 1, **kw)
        self.conv_s1 = nn.Conv2d(c, c // 4, 1, **kw)
        self.output_hypernetworks_mlps = nn.ModuleList(HyperMLP(c, c // 8, **kw) for _ in range(m))
        self.iou_prediction_head = HyperMLP(c, m, **kw)
        self.pred_obj_score_head = HyperMLP(c, 1, **kw)


def dense_pe_2d(gauss: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(h * w, C) fp32 encoding of the token grid's centres, (x, y) order
    (upstream's PositionEmbeddingRandom.forward), token-major."""
    dev = gauss.device
    y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return pe_encoding(torch.stack([xx, yy], dim=-1), gauss).reshape(h * w, -1)


def embed_points_2d(pe: Sam2PromptEncoder, coords: torch.Tensor, labels: torch.Tensor,
                    image_size: int) -> torch.Tensor:
    """(N, K, 2) clicks as (x, y) in the network's pixels, labels (N, K)
    (1 positive, 0 negative, -1 none) -> the sparse prompts (N, K + 1, C)
    fp32: pixel centres, a padding point appended, the encoding of each
    labelled point plus its label's embedding, `not_a_point_embed` alone
    for the padding."""
    n = coords.shape[0]
    coords = torch.cat([coords.float() + 0.5, coords.new_zeros((n, 1, 2), dtype=torch.float32)], dim=1)
    labels = torch.cat([labels, -labels.new_ones((n, 1))], dim=1)[..., None]
    emb = pe_encoding(coords / image_size, pe.pe_layer.positional_encoding_gaussian_matrix)
    emb = torch.where(labels == -1, pe.not_a_point_embed.weight[0].float(), emb)
    for i, point in enumerate(pe.point_embeddings):
        emb = emb + torch.where(labels == i, point.weight[0].float(), torch.zeros_like(emb))
    return emb


def stability_scores(logits: torch.Tensor, delta: float) -> torch.Tensor:
    """(N, h, w) -> (N,): the area above +delta over the area above -delta, 1 where the latter is 0."""
    area_i = (logits > delta).flatten(1).sum(-1).float()
    area_u = (logits > -delta).flatten(1).sum(-1).float()
    return torch.where(area_u > 0, area_i / area_u.clamp_min(1), torch.ones_like(area_u))


def sam2_decode(md: Sam2MaskDecoder, cfg: SamConfig, pe: Sam2PromptEncoder, image: torch.Tensor,
                high_res: Tuple[torch.Tensor, torch.Tensor], sparse: torch.Tensor, image_pe: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """image (N, C, h, w), high_res (s0 (N or 1, C/8, 4h, 4w), s1 (N or 1,
    C/4, 2h, 2w)) after conv_s0 / conv_s1, sparse prompts (N, Q, C), image_pe
    (h * w, C) -> every mask token's low-resolution logits (N, M, 4h, 4w) in
    the image dtype, their IoU predictions (N, M) and output tokens (N, M, C)
    and the object-score logits (N, 1), fp32 (upstream's predict_masks; the
    dense prompt is `no_mask_embed` everywhere). The two-way transformer
    runs its naive schedule (`twoway_block`, `attn_apply`: plain attention
    over the h * w image tokens)."""
    n, c, h, w = image.shape
    dt = image.dtype
    out_tokens = torch.cat([md.obj_score_token.weight, md.iou_token.weight, md.mask_tokens.weight]).to(dt)
    tokens = torch.cat([out_tokens[None].expand(n, -1, -1), sparse.to(dt)], dim=1)
    src = (image + pe.no_mask_embed.weight.to(dt).view(1, c, 1, 1)).flatten(2).transpose(1, 2)
    hs, src = twoway_transformer_apply(md.transformer, cfg, src, image_pe[None].to(dt), tokens, impl="naive")
    m = md.mask_tokens.weight.shape[0]
    mask_out = hs[:, 2: 2 + m]
    src = src.transpose(1, 2).reshape(n, c, h, w)
    dc1, ln1, _, dc2, _ = md.output_upscaling
    s0, s1 = high_res
    up = F.conv_transpose2d(src, dc1.weight.to(dt), dc1.bias.to(dt), stride=2) + s1
    up = F.gelu(layer_norm_2d(up, ln1))
    up = F.gelu(F.conv_transpose2d(up, dc2.weight.to(dt), dc2.bias.to(dt), stride=2) + s0)
    hyper = torch.stack([hyper_mlp(md.output_hypernetworks_mlps[i], mask_out[:, i]) for i in range(m)], dim=1)
    masks = torch.matmul(hyper, up.flatten(2)).view(n, m, 4 * h, 4 * w)
    iou = torch.sigmoid(hyper_mlp(md.iou_prediction_head, hs[:, 1]).float())
    score = hyper_mlp(md.pred_obj_score_head, hs[:, 0]).float()
    return masks, iou, mask_out, score
