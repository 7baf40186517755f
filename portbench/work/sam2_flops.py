"""Analytic matmul FLOPs of one SAM 2 request (models/sam2.py): 2 x MACs of
every linear layer, convolution and attention product at the shapes the
request runs, frame by frame: the image encoder (Hiera and the neck, with
conv_s0 / conv_s1), memory attention over each frame's bank (its first
self-attention once for all objects, as the program runs it: every object
starts from the same image), the decoder and the memory encoder per
object. Elementwise work, the norms, pooling, RoPE, resizes and position
tables are not counted, so `mfu` is the matmul-FLOPs-against-peak measure,
as work/vda_flops.py's for Video Depth Anything.
"""

from __future__ import annotations

from typing import Dict

from l4p_tpu_torch.models.sam2 import DECODER_DEPTH, DECODER_MLP
from portbench.reference.sam2 import memory_selection


def encoder_flops(cfg) -> float:
    """One frame through Hiera, the FPN neck and conv_s0 / conv_s1."""
    grid, dim, heads = cfg.image_size // 4, cfg.embed_dim, cfg.num_heads
    total = 2.0 * grid * grid * 3 * 49 * dim  # the 7x7 patch embedding
    ends = [sum(cfg.stages[:i]) - 1 for i in range(1, len(cfg.stages) + 1)]
    pooled = [x + 1 for x in ends[:-1]]
    stage, widths = 1, []
    for i in range(sum(cfg.stages)):
        window = 0 if i in cfg.global_att_blocks else cfg.window_spec[stage - 1]
        dim_out = dim
        if i - 1 in ends:
            dim_out, stage = 2 * dim, stage + 1
        n_in = grid * grid
        grid_out = grid // 2 if i in pooled else grid
        n_out = grid_out * grid_out
        nk = window * window if window else n_in  # keys a window (or the whole grid)
        nq = nk // 4 if i in pooled else nk
        total += 2.0 * n_in * dim * 3 * dim_out  # qkv
        total += 4.0 * (n_in // nk) * nq * nk * dim_out  # q k^T and p v over every window, all heads
        total += 2.0 * n_out * dim_out * dim_out  # proj
        if dim != dim_out:
            total += 2.0 * n_in * dim * dim_out  # the shortcut's projection
        total += 2.0 * 2 * n_out * dim_out * 4 * dim_out  # the MLP
        if i in ends:
            widths.append((grid_out, dim_out))
        grid, dim = grid_out, dim_out
    total += sum(2.0 * g * g * c * cfg.d_model for g, c in widths)  # the neck's laterals
    (g0, _), (g1, _) = widths[0], widths[1]
    total += 2.0 * g0 * g0 * cfg.d_model * (cfg.d_model // 8) + 2.0 * g1 * g1 * cfg.d_model * (cfg.d_model // 4)
    return total


def memory_attention_flops(cfg, keys: int, objects: int) -> float:
    """One frame's memory attention over `keys` memory and pointer tokens."""
    p, c, f = cfg.feat_size ** 2, cfg.d_model, cfg.memory_ffn
    self_attn = 4 * 2.0 * p * c * c + 4.0 * p * p * c
    cross = 2 * 2.0 * p * c * c + 2 * 2.0 * keys * cfg.mem_dim * c + 4.0 * p * keys * c
    ffn = 2 * 2.0 * p * c * f
    return self_attn + objects * (cross + ffn) + (cfg.memory_layers - 1) * objects * (self_attn + cross + ffn)


def decoder_flops(cfg, objects: int) -> float:
    """One frame's decoder: the two-way transformer over 8 tokens and the
    top map's tokens, the upscaling and the mask products."""
    s = cfg.feat_size
    p, c, q, i = s * s, cfg.d_model, 8, cfg.d_model // 2
    self_attn = 4 * 2.0 * q * c * c + 4.0 * q * q * c
    t2i = 2 * 2.0 * q * c * i + 3 * 2.0 * p * c * i + 4.0 * q * p * i  # q, out; k, v, the keys' encoding; products
    i2t = 3 * 2.0 * p * c * i + 2 * 2.0 * q * c * i + 4.0 * p * q * i  # q, out, the keys' encoding; k, v; products
    mlp = 2 * 2.0 * q * c * DECODER_MLP
    two_way = DECODER_DEPTH * (self_attn + t2i + mlp + i2t) + t2i
    up = 2.0 * (2 * s) ** 2 * c * (c // 4) + 2.0 * (4 * s) ** 2 * (c // 4) * (c // 8)
    masks = 2.0 * (cfg.num_multimask_outputs + 1) * (c // 8) * (4 * s) ** 2
    return objects * (two_way + up + masks)


def memory_encoder_flops(cfg, objects: int) -> float:
    """One frame's memory encoder: the mask's four stride-2 convolutions and
    projection per object, the frame's projection once, the fuser and the
    output projection per object."""
    side, cin, conv = cfg.image_size, 1, 0.0
    for _ in range(4):
        side //= 2
        conv += 2.0 * side * side * 4 * cin * 9 * cin
        cin *= 4
    p, c = cfg.feat_size ** 2, cfg.d_model
    conv += 2.0 * p * cin * c
    fuser = cfg.fuser_layers * (2.0 * p * c * cfg.fuser_kernel ** 2 + 2 * 2.0 * p * c * 4 * c)
    return 2.0 * p * c * c + objects * (conv + fuser + 2.0 * p * c * cfg.mem_dim)


def sam2_request_flops(cfg, frames: int, objects: int) -> Dict[str, float]:
    """Per-part matmul FLOPs of one request of `frames` frames and `objects`
    objects clicked on frame 0; `cfg` is a Sam2Config."""
    p, split = cfg.feat_size ** 2, cfg.d_model // cfg.mem_dim
    keys = []
    for f in range(1, frames):
        mems, ptrs = memory_selection(f, frames, cfg.num_maskmem, cfg.max_obj_ptrs)
        keys.append(len(mems) * p + len(ptrs) * split)
    stages = {"encode": frames * encoder_flops(cfg),
              "memory_attention": sum(memory_attention_flops(cfg, k, objects) for k in keys),
              "decode": frames * decoder_flops(cfg, objects),
              "memory_encode": frames * memory_encoder_flops(cfg, objects)}
    stages["total"] = float(sum(stages.values()))
    return stages
