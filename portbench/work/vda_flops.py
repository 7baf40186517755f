"""Analytic matmul FLOPs of one Video Depth Anything request
(models/vda.py): 2 x MACs of every linear layer, convolution and attention
product at the shapes the request runs, window by window. Elementwise work,
the norms, resizes, position tables and the stitch are not counted, so
`mfu` is the matmul-FLOPs-against-peak measure, as work/vggt_flops.py's for
VGGT.
"""

from __future__ import annotations

from typing import Dict

from portbench.reference.vda import INFER_LEN, OVERLAP
from portbench.work.vggt_flops import block_flops


def windows(frames: int) -> int:
    """Windows of a clip: one every INFER_LEN - OVERLAP frames (upstream's constants) that starts inside it."""
    stride = INFER_LEN - OVERLAP
    return -(-frames // stride)


def motion_flops(positions: int, frames: int, c: int, cfg) -> float:
    """One motion module over `positions` positions of `frames` frames at
    width c: proj_in, per temporal attention q/k/v, q k^T and p v, to_out,
    the GEGLU's two products, proj_out."""
    tok, m = positions * frames, cfg.ff_mult
    attn = 2 * tok * c * 3 * c + 4 * positions * frames * frames * c + 2 * tok * c * c
    ff = 2 * tok * c * 2 * m * c + 2 * tok * m * c * c
    return 2 * tok * c * c + cfg.motion_attention_blocks * attn + ff + 2 * tok * c * c


def window_flops(cfg, h: int, w: int) -> Dict[str, float]:
    """One window of num_frames frames at h x w: the encoder, the motion
    modules and the rest of the head."""
    enc, t, f, oc = cfg.encoder, cfg.num_frames, cfg.features, cfg.out_channels
    p, e = enc.patch_size, enc.embed_dim
    gh, gw = h // p, w // p
    n = gh * gw
    encoder = t * 2 * n * 3 * p * p * e + enc.depth * block_flops(1 + n, e, int(e * enc.mlp_ratio), t)
    grids = [(4 * gh, 4 * gw), (2 * gh, 2 * gw), (gh, gw), ((gh - 1) // 2 + 1, (gw - 1) // 2 + 1)]
    area = [a * b for a, b in grids]
    head = sum(2 * n * e * o for o in oc)  # the 1x1 projections
    head += 2 * n * oc[0] * oc[0] * 16 + 2 * n * oc[1] * oc[1] * 4 + 2 * area[3] * oc[3] * oc[3] * 9  # rescales
    head += sum(2 * a * 9 * o * f for a, o in zip(area, oc))  # layer{1-4}_rn
    unit = lambda a: 2 * (2 * a * 9 * f * f)  # noqa: E731 - a residual conv unit: two 3x3 convs
    out_area = [4 * area[0], area[0], area[1], area[2]]  # refinenet i's output grid
    head += unit(area[3]) + 2 * out_area[3] * f * f  # refinenet4: its residual input unused
    for i in (2, 1, 0):
        head += 2 * unit(area[i]) + 2 * out_area[i] * f * f
    head += 2 * out_area[0] * 9 * f * (f // 2)  # output_conv1
    head += 2 * (p * gh) * (p * gw) * (9 * (f // 2) * 32 + 32)  # output_conv2
    motion = (motion_flops(area[2], t, oc[2], cfg) + motion_flops(area[3], t, oc[3], cfg)
              + motion_flops(area[2], t, f, cfg) + motion_flops(area[1], t, f, cfg))
    return {"encoder": float(encoder), "motion": float(motion), "head": float(t * head)}


def vda_request_flops(cfg, frames: int, h: int, w: int) -> Dict[str, float]:
    """Per-part matmul FLOPs of one request of a `frames`-frame clip at h x
    w; `cfg` is a VDAConfig. `head` leaves the motion modules out."""
    per = window_flops(cfg, h, w)
    nw = windows(frames)
    stages = {k: nw * v for k, v in per.items()}
    stages["total"] = float(sum(stages.values()))
    return stages
