"""Analytic matmul FLOPs of one VGGT request (models/vggt.py): 2 x MACs of
every linear layer, convolution and attention product at the shapes the
request runs, stage by stage. Elementwise work, LayerNorms, resizes and
position tables are not counted, so `mfu` is the matmul-FLOPs-against-peak
measure, as work/flops.py's for L4P.
"""

from __future__ import annotations

from typing import Dict, Sequence


def block_flops(tokens: int, dim: int, mlp: int, seqs: int = 1) -> float:
    """One pre-LN transformer block over `seqs` sequences of `tokens`:
    qkv, q k^T and p v, proj, the MLP's two products."""
    t = seqs * tokens
    return 2 * t * dim * 3 * dim + 4 * seqs * tokens * tokens * dim + 2 * t * dim * dim + 4 * t * dim * mlp


def dpt_flops(cfg, frames: int, h: int, w: int, out_dim: int) -> float:
    """One DPT head over `frames` frames (the projections, the rescales, the
    fusion trunk and the output convolutions)."""
    p, c, f, oc = cfg.patch_size, 2 * cfg.embed_dim, cfg.dpt_features, cfg.dpt_out_channels
    gh, gw = h // p, w // p
    n = gh * gw
    grids = [(4 * gh, 4 * gw), (2 * gh, 2 * gw), (gh, gw), ((gh - 1) // 2 + 1, (gw - 1) // 2 + 1)]
    area = [a * b for a, b in grids]
    total = sum(2 * n * c * o for o in oc)  # the 1x1 projections
    total += 2 * n * oc[0] * oc[0] * 16 + 2 * n * oc[1] * oc[1] * 4 + 2 * area[3] * oc[3] * oc[3] * 9  # rescales
    total += sum(2 * a * 9 * o * f for a, o in zip(area, oc))  # layer{1-4}_rn
    unit = lambda a: 2 * (2 * a * 9 * f * f)  # noqa: E731 - a residual conv unit: two 3x3 convs
    out_area = [4 * area[0], area[0], area[1], area[2]]  # refinenet i's output grid
    total += unit(area[3]) + 2 * out_area[3] * f * f  # refinenet4: no residual input
    for i in (2, 1, 0):
        total += 2 * unit(area[i]) + 2 * out_area[i] * f * f
    total += 2 * out_area[0] * 9 * f * (f // 2)  # output_conv1
    total += 2 * h * w * 9 * (f // 2) * 32 + 2 * h * w * 32 * out_dim  # output_conv2
    return frames * total


def vggt_request_flops(cfg, tasks: Sequence[str], frames: int, h: int, w: int) -> Dict[str, float]:
    """Per-stage matmul FLOPs of one request of `frames` frames at h x w;
    `cfg` is a VGGTConfig (or anything with its fields)."""
    p, e, m = cfg.patch_size, cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)
    n = (h // p) * (w // p)
    tok = cfg.num_register_tokens + 1 + n  # a frame's tokens: camera (cls in the embedder), registers, patches
    stages: Dict[str, float] = {}
    stages["embed"] = frames * (2 * n * 3 * p * p * e) + cfg.embed_depth * block_flops(tok, e, m, frames)
    stages["frame"] = cfg.depth * block_flops(tok, e, m, frames)
    stages["global"] = cfg.depth * block_flops(frames * tok, e, m)
    if "camera" in tasks:
        c = 2 * e
        per_pass = (2 * frames * 9 * c + 2 * frames * c * 3 * c
                    + cfg.camera_trunk_depth * block_flops(frames, c, int(c * cfg.mlp_ratio))
                    + 2 * frames * c * (c // 2) + 2 * frames * (c // 2) * 9)
        stages["camera"] = cfg.camera_iterations * per_pass
    for task, out_dim in (("depth", 2), ("world_points", 4)):
        if task in tasks:
            stages[task] = dpt_flops(cfg, frames, h, w, out_dim)
    stages["total"] = float(sum(stages.values()))
    return stages
