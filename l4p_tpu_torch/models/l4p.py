"""L4P: shared encoder + flow/depth/dyn_mask DPT heads + the point-track
head + sliding-window stitching (counterpart of l4p_tpu/models/l4p.py).

Windows are encoded `enc_window_chunk` at a time with the window axis merged
into the batch, and each dense head runs `dense_window_chunk` windows at a
time; the JAX package's lax.map chunking and stacked zero-padded heads exist
for XLA's compiler and are not carried over (the outputs are the same).
Tracking runs `max_queries` queries at a time (`run_track_chunked`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from l4p_tpu_torch.config import DenseHeadConfig, L4PConfig
from l4p_tpu_torch.geometry.alignment import (
    linear_scale_apply,
    linear_scale_solve,
    lstsq_affine_apply,
    lstsq_affine_solve,
)
from l4p_tpu_torch.models.dpt import DPTHead
from l4p_tpu_torch.models.encoder import AttentionFn, VideoEncoder
from l4p_tpu_torch.models.ingest import ingest_video_tokens
from l4p_tpu_torch.models.sam import KERNELS, TrackKernels
from l4p_tpu_torch.models.track import TrackHead, track_forward_windowed
from l4p_tpu_torch.ops.flash_attention import flash_attention
from l4p_tpu_torch.ops.misc import apply_fn


class DenseTaskHead(nn.Module):
    """`task_heads.<task>`: the DPT trunk under `task_head`, as released."""

    def __init__(self, hcfg: DenseHeadConfig, device=None, dtype=None):
        super().__init__()
        self.hcfg = hcfg
        self.task_head = DPTHead(hcfg.dpt, device, dtype)

    def forward(self, hook_feats: Sequence[torch.Tensor], img_info: Tuple[int, int, int]) -> torch.Tensor:
        return dense_head_raw(self.task_head, self.hcfg, hook_feats, img_info)


class L4P(nn.Module):
    """`video_encoder` + `task_heads.<task>.task_head` for the dense heads +
    `task_heads.track_2d` (no `task_head.` infix) when the config has a
    track head: the released `l4p_model.` state dict (minus that prefix)
    loads with strict=True."""

    def __init__(self, cfg: L4PConfig = L4PConfig(), device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.video_encoder = VideoEncoder(cfg.encoder, device, dtype)
        heads = {name: DenseTaskHead(h, device, dtype) for name, h in cfg.heads}
        if cfg.track is not None:
            heads["track_2d"] = TrackHead(cfg.track, device, dtype)
        self.task_heads = nn.ModuleDict(heads)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.video_encoder.init_weights(generator)
        for head in self.task_heads.values():
            (head if isinstance(head, TrackHead) else head.task_head).init_weights(generator)


def dense_head_raw(head: DPTHead, hcfg: DenseHeadConfig, hook_feats: Sequence[torch.Tensor],
                   img_info: Tuple[int, int, int]) -> torch.Tensor:
    """DPT trunk + per-kind activation (reference dense_heads.py:66-74,
    :172-182, :208-217)."""
    out = head(hook_feats, img_info)[:, : hcfg.out_nchan]
    if hcfg.kind == "depth":
        out = apply_fn(out, hcfg.depth_fn)
    elif hcfg.kind == "dyn_mask":
        out = torch.cat([apply_fn(out[:, :1], hcfg.mask_fn), out[:, 1:]], dim=1)
    return out


def num_windows(cfg: L4PConfig, t: int) -> int:
    """Windows must tile the video exactly (l4p_tpu/models/l4p.py:177)."""
    ws, stride = cfg.window_size[0], cfg.window_stride_t
    if t < ws or (t - ws) % stride != 0:
        raise ValueError(f"T={t} not tiled by window {ws} / stride {stride}")
    return (t - ws) // stride + 1


def encode_windows(
    encoder: VideoEncoder,
    cfg: L4PConfig,
    rgb_b3thw: Optional[torch.Tensor] = None,
    rgb_u8_bthw3: Optional[torch.Tensor] = None,
    attention: AttentionFn = flash_attention,
) -> Dict[str, object]:
    """Slice the video into overlapping windows and encode them all.
    Returns {'hooks': {hook: (nw, B, P, C)}, 'final': (nw, B, P, C)}.

    With `rgb_u8_bthw3` the whole video is tokenized once by the folded
    normalise+patchify matmul and windows are sliced in token space."""
    ecfg = cfg.encoder
    ws, stride, tt = cfg.window_size[0], cfg.window_stride_t, ecfg.tubelet_size
    b, t = rgb_u8_bthw3.shape[:2] if rgb_u8_bthw3 is not None else (rgb_b3thw.shape[0], rgb_b3thw.shape[2])
    nw = num_windows(cfg, t)
    if rgb_u8_bthw3 is not None:
        if stride % tt != 0:
            raise ValueError("window stride must be a tubelet multiple for token slicing")
        tok = ingest_video_tokens(encoder, rgb_u8_bthw3, add_pos_embed=False)
        tok = tok.view(b, t // tt, -1, ecfg.embed_dim)  # (B, T/tt, gh*gw, E)

        def window_tokens(starts):
            return torch.cat([tok[:, s // tt: (s + ws) // tt].flatten(1, 2) for s in starts])
    else:
        def window_tokens(starts):
            return encoder.embed(torch.cat([rgb_b3thw[:, :, s: s + ws] for s in starts]))

    hooks = cfg.all_hooks
    chunks = []
    for c0 in range(0, nw, cfg.enc_window_chunk):
        starts = [i * stride for i in range(c0, min(c0 + cfg.enc_window_chunk, nw))]
        chunks.append(encoder(window_tokens(starts), hooks, attention))  # window-major batch

    def merge(feats):
        return torch.cat(feats).unflatten(0, (nw, b))

    return {
        "hooks": {hk: merge([c["hooks"][i] for c in chunks]) for i, hk in enumerate(hooks)},
        "final": merge([c["final"] for c in chunks]),
    }


def run_dense_head(head: DenseTaskHead, hook_feats: Dict[int, torch.Tensor], img_info: Tuple[int, int, int],
                   window_chunk: int) -> torch.Tensor:
    """Per-window head outputs (nw, B, C, ws, H, W), `window_chunk` windows
    per call with the window axis merged into the batch."""
    feats = [hook_feats[hk] for hk in head.hcfg.dpt.hooks]
    nw, b = feats[0].shape[:2]
    outs = [
        head([f[c0: c0 + window_chunk].flatten(0, 1) for f in feats], img_info)
        for c0 in range(0, nw, window_chunk)
    ]
    return torch.cat(outs).unflatten(0, (nw, b))


def writer_index(t_total: int, nw: int, stride: int, flow_skip: bool, device=None):
    """For each output frame, (window, frame-in-window) of the last window
    that writes it: the reference's sequential overwrite (dense_heads.py:136-140)
    as a gather. With `flow_skip`, windows after the first do not write their
    frame 0 (dense_heads.py:136-138)."""
    t_idx = torch.arange(t_total, device=device)
    if flow_skip:
        win = torch.where(t_idx == 0, torch.zeros_like(t_idx), torch.div(t_idx - 1, stride, rounding_mode="floor"))
    else:
        win = torch.div(t_idx, stride, rounding_mode="floor")
    win = win.clamp(0, nw - 1)
    return win, t_idx - win * stride


def stitch_overwrite(win_outs: torch.Tensor, stride: int, t_total: int, flow_skip: bool = False) -> torch.Tensor:
    """(nw, B, C, ws, ...) -> (B, C, T, ...)."""
    win, frame = writer_index(t_total, win_outs.shape[0], stride, flow_skip, win_outs.device)
    return win_outs[win, :, :, frame].movedim(0, 2)


def stitch_depth_aligned(depth_w: torch.Tensor, stride: int, t_total: int, hcfg: DenseHeadConfig) -> torch.Tensor:
    """Sequential scale/shift alignment chain over windows
    (reference dense_heads.py:104-140): each window is aligned to the
    previous aligned window on their overlap, then overwrite-stitched."""
    overlap = depth_w.shape[3] - stride
    aligned = [depth_w[0]]
    for cur in depth_w[1:]:
        prev = aligned[-1]
        if hcfg.align_type == "affine":
            sol = lstsq_affine_solve(cur[:, :, :overlap], prev[:, :, stride:], pre_inverse=hcfg.align_pre_inverse)
            aligned.append(lstsq_affine_apply(sol, cur, pre_inverse=hcfg.align_pre_inverse))
        else:
            sol = linear_scale_solve(cur[:, :, :overlap], prev[:, :, stride:], pre_inverse=hcfg.align_pre_inverse)
            aligned.append(linear_scale_apply(sol, cur, pre_inverse=hcfg.align_pre_inverse))
    return stitch_overwrite(torch.stack(aligned), stride, t_total)


def stitch_dense_outputs(cfg: L4PConfig, tasks: Sequence[str], dense_outs: Dict[str, torch.Tensor], stride: int,
                         t_total: int) -> Dict[str, torch.Tensor]:
    """flow = overwrite with the frame-0 skip; dyn_mask = overwrite;
    depth = disparity-affine chain (l4p_tpu/models/l4p.py:604-656, dense part)."""
    heads = cfg.head_dict
    out: Dict[str, torch.Tensor] = {}
    for t in tasks:
        hcf = heads[t]
        if t == "flow_2d_backward":
            out[f"{hcf.task_name}_est_b2thw"] = stitch_overwrite(dense_outs[t], stride, t_total, flow_skip=True)
        elif t == "dyn_mask":
            out[f"{hcf.task_name}_est_b1thw"] = stitch_overwrite(dense_outs[t], stride, t_total)
        elif t == "depth":
            out[f"{hcf.task_name}_est_b1thw"] = stitch_depth_aligned(dense_outs[t], stride, t_total, hcf)
    return out


def merge_query_chunks(v: torch.Tensor, n_queries: int) -> torch.Tensor:
    """(n_chunks, B, chunk, ...) -> (B, n_queries, ...): undoes the
    `max_queries` chunking and drops the padding queries."""
    m = v.movedim(0, 1)
    return m.reshape(m.shape[0], m.shape[1] * m.shape[2], *m.shape[3:])[:, :n_queries]


def run_track_chunked(head: TrackHead, enc_final: torch.Tensor, queries: torch.Tensor, labels: torch.Tensor,
                      stride: int, kernels: TrackKernels = KERNELS) -> Dict[str, torch.Tensor]:
    """Forward-direction windowed tracking over the encoder's final features
    (nw, B, P, C), `max_queries` queries at a time (the reference's memory
    governor, sparse_heads.py:181-211). Padding queries get coordinates 0
    and label 0, and their outputs are sliced off."""
    tcfg = head.cfg
    n = queries.shape[1]
    chunk = min(tcfg.max_queries, n)
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    if pad:
        queries = torch.cat([queries, queries.new_zeros((queries.shape[0], pad, 3))], dim=1)
        labels = torch.cat([labels, labels.new_zeros((labels.shape[0], pad))], dim=1)
    outs = [
        track_forward_windowed(head, tcfg, enc_final, queries[:, i * chunk: (i + 1) * chunk],
                               labels[:, i * chunk: (i + 1) * chunk], stride, kernels)
        for i in range(n_chunks)
    ]
    return {k: merge_query_chunks(torch.stack([o[k] for o in outs]), n) for k in outs[0]}
