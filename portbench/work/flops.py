"""Analytic matmul FLOPs of the work the cells complete, frozen from
l4p_tpu_torch/utils/flops.py (itself the JAX package's counts): 2 x MACs of
the matmuls and convolutions of each stage of the all-task request, at the
shapes the port runs (the encoder window, the DPT trunk, the factored
two-way transformer, the packed upscale, the memory projection, padded
query chunks). Elementwise work is not counted, so `mfu` is the
matmul-FLOPs-against-peak measure.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def encoder_window_flops(ecfg) -> float:
    """One encoder window forward (models/encoder.py: patchify + `depth`
    transformer blocks over P tokens)."""
    grid = (
        ecfg.all_frames // ecfg.tubelet_size,
        ecfg.img_size // ecfg.patch_size,
        ecfg.img_size // ecfg.patch_size,
    )
    p = _prod(grid)
    c = ecfg.embed_dim
    m = int(c * ecfg.mlp_ratio)
    patch_in = ecfg.in_chans * ecfg.tubelet_size * ecfg.patch_size ** 2
    patchify = 2 * p * patch_in * c
    qkv = 2 * p * c * 3 * c
    attn = 4 * p * p * c  # q@k^T + attn@v, all heads combined
    proj = 2 * p * c * c
    mlp = 4 * p * c * m
    return patchify + ecfg.depth * (qkv + attn + proj + mlp)


# ---------------------------------------------------------------------------
# DPT dense head
# ---------------------------------------------------------------------------

def dpt_head_flops(dcfg, img_info: Tuple[int, int, int] = (16, 224, 224)) -> float:
    """One window of one DPT head — walks the same shapes as dpt_apply
    (models/dpt.py): act_postprocess -> layer_rn -> 4 fusion stages ->
    head1 -> resize -> head2."""
    t, h, w = img_info
    grid0 = (t // dcfg.patch_size[0], h // dcfg.patch_size[1], w // dcfg.patch_size[2])
    p0 = _prod(grid0)
    f = dcfg.feature_dim
    total = 0.0

    grids = []
    for i, sf in enumerate(dcfg.actpost_scale_factors):
        cin, cout = dcfg.dim_tokens, dcfg.layer_dims[i]
        total += 2 * p0 * cin * cout  # 1x1x1 projection
        if all(s == 0 for s in sf):
            g = grid0
        elif all(s >= 0 for s in sf):  # conv-transpose, kernel == stride
            stride = tuple(2 ** s for s in sf)
            g = tuple(a * b for a, b in zip(grid0, stride))
            total += 2 * _prod(g) * cout * cout
        else:  # strided conv, kernel 3 (per-dim), stride 2
            stride = tuple(2 ** (-s) for s in sf)
            g = tuple(a // b for a, b in zip(grid0, stride))
            ksz = _prod(tuple((s // 2) * 2 + 1 for s in stride))
            total += 2 * _prod(g) * ksz * cout * cout
        grids.append(g)
        total += 2 * _prod(g) * 27 * cout * f  # layer_rn 3x3x3 -> feature_dim

    # fusion stages (refinenet4..1): resConfUnit(s) at the INPUT grid, out
    # conv at the upsampled grid. path4 crop (dpt_head.py:70-72) shrinks T/H
    # to layers[2]'s — mirror it.
    def resunit(v):  # 2 convs 3^3 f->f
        return 2 * (2 * v * 27 * f * f)

    sf4 = dcfg.fusion_scale_factors[3]
    g = grids[3]
    total += resunit(_prod(g))
    g = tuple(a * b for a, b in zip(g, sf4))
    total += 2 * _prod(g) * f * f  # out_conv 1x1x1
    g = (min(g[0], grids[2][0]), min(g[1], grids[2][1]), g[2])  # path4 crop

    for lvl, sf in ((2, dcfg.fusion_scale_factors[2]), (1, dcfg.fusion_scale_factors[1]),
                    (0, dcfg.fusion_scale_factors[0])):
        total += resunit(_prod(grids[lvl]))  # resConfUnit1 on the residual
        total += resunit(_prod(g))  # resConfUnit2 on the merged path
        g = tuple(a * b for a, b in zip(g, sf))
        total += 2 * _prod(g) * f * f  # out_conv

    total += 2 * _prod(g) * 27 * f * (f // 2)  # head1 3^3 f -> f/2
    out_sz = tuple(img_info) if dcfg.output_size is None else tuple(dcfg.output_size)
    v_out = _prod(out_sz)
    total += 2 * v_out * 27 * (f // 2) * dcfg.last_dim  # head2_0 3^3
    total += 2 * v_out * dcfg.last_dim * dcfg.num_channels  # head2_2 1x1x1
    return total


# ---------------------------------------------------------------------------
# track head
# ---------------------------------------------------------------------------

def twoway_flops(sam, n: int) -> float:
    """Factored two-way transformer (models/sam.py, twoway_streamed): per layer, both
    image-side cross-attentions touch the (N, P, C) keys in three rank-hQ
    matmuls each (logits, PE logits, weighted sum); the final t2i adds three
    more. Token-side self-attn/MLP/projections are O(N·Q·C·D) and counted."""
    p, c = sam.num_video_tokens, sam.embed_dim
    d = c // sam.attention_downsample_rate
    # mask tokens + (point + pad) prompts + optional feature prompt
    q = sam.num_mask_tokens + 2 + (1 if sam.prompt_using_features else 0)
    hq = sam.num_heads * q
    big = 2 * n * hq * c * p  # one (hQ, C) x (C, P) pass over the keys
    t2i = 3 * big + 2 * (2 * n * q * c * d) + 2 * n * q * d * c + 2 * n * q * d * c
    i2t = 3 * big + 3 * (2 * n * q * c * d)
    self_attn = 4 * (2 * n * q * c * c) + 4 * n * q * q * c
    mlp = 4 * n * q * c * sam.mlp_dim
    per_layer = t2i + i2t + self_attn + mlp
    return sam.sam_head_depth * per_layer + t2i


def upscale_flops(sam, n: int) -> float:
    """Packed-offset upscale + hypernet contraction (models/sam.py
    mask_decoder_apply / ops/fused_upscale.py), true (unpadded) FLOPs."""
    p, c = sam.num_video_tokens, sam.embed_dim
    d1, d2 = sam.decode_dims
    k1, k2 = 8, 4  # deconv1 (2,2,2), deconv2 (1,2,2)
    m = sam.num_mask_tokens
    dec1 = 2 * n * p * c * (k1 * d1)
    dec2 = 2 * n * (p * k1) * d1 * (k2 * d2)
    hyper_mlps = 3 * (2 * n * (c * c + c * c + c * d2))
    contraction = 2 * n * (p * k1 * k2) * d2 * m
    return dec1 + dec2 + hyper_mlps + contraction


def track_window_flops(tcfg, n: int) -> float:
    """One tracked window at N in-flight queries (models/track.py
    track_forward_item + the attend_to_past memory projection)."""
    sam = tcfg.sam
    p, c = sam.num_video_tokens, sam.embed_dim
    total = twoway_flops(sam, n) + upscale_flops(sam, n)
    if tcfg.attend_to_past:
        total += 2 * n * (p // 2) * c * c  # processed_video_features_proj
    if tcfg.prompt_using_features:
        total += 2 * n * c * c
    return total


# ---------------------------------------------------------------------------
# whole pipeline
# ---------------------------------------------------------------------------

def num_windows(t_frames: int, ws: int = 16, stride: int = 8) -> int:
    return (t_frames - ws) // stride + 1


def alltask_video_flops(
    cfg,
    tasks: Sequence[str],
    t_frames: int,
    n_queries: int,
) -> Dict[str, float]:
    """Per-stage matmul FLOPs for one all-task video at an operating point.

    Mirrors the production execution: query chunking pads to full
    `max_queries` chunks (padded queries compute real FLOPs — counted),
    every window runs every head, stitching/solves are matmul-negligible."""
    ws, stride = cfg.window_size[0], cfg.window_stride_t
    img_info = (ws, *cfg.window_size[1:])
    nw = num_windows(t_frames, ws, stride)
    heads = cfg.head_dict

    stages: Dict[str, float] = {}
    stages["encoder"] = nw * encoder_window_flops(cfg.encoder)
    for t in tasks:
        hc = heads.get(t)
        if hc is not None and hc.kind in ("flow", "depth", "dyn_mask", "camray"):
            stages[f"dense/{t}"] = nw * dpt_head_flops(hc.dpt, img_info)
    if "track_2d" in tasks and n_queries > 0:
        chunk = min(cfg.track.max_queries, n_queries)
        n_chunks = -(-n_queries // chunk)
        stages["track"] = nw * n_chunks * track_window_flops(cfg.track, chunk)
    stages["total"] = float(sum(stages.values()))
    return stages
