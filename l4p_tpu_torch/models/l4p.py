"""L4P: shared encoder + flow/depth/dyn_mask/camray DPT heads + the
point-track head + sliding-window stitching (counterpart of
l4p_tpu/models/l4p.py).

Windows are encoded `enc_window_chunk` at a time (all at once with the
fused encoder) with the window axis merged into the batch, and each dense
head runs `dense_window_chunk` windows at a time; the JAX package's lax.map
chunking and stacked zero-padded heads exist for XLA's compiler and are not
carried over (the outputs are the same). Camray rays become poses and
intrinsics per window (`camray_windows_to_cameras`); depth and camray are
stitched by one Sim(3) chain under `joint_alignment`. Tracking runs
`max_queries` queries at a time (`run_track_chunked`).

Every random draw (the homography and Sim(3) RANSAC samples) comes from a
`Draws` object the caller passes: `RandomDraws` by default.
"""

from __future__ import annotations

from typing import Dict, Optional, Protocol, Sequence, Tuple

import torch
import torch.nn as nn

from l4p_tpu_torch.config import DenseHeadConfig, L4PConfig
from l4p_tpu_torch.geometry.alignment import (
    linear_scale_apply,
    linear_scale_solve,
    lstsq_affine_apply,
    lstsq_affine_solve,
    sim3_overlap_apply,
    sim3_overlap_solve,
    sim3_sample_counts,
)
from l4p_tpu_torch.geometry.cameras import (
    rays_to_cameras,
    rays_to_cameras_and_fixed_intrinsics,
    rays_to_cameras_and_variable_intrinsics,
)
from l4p_tpu_torch.geometry.core import normalize_intrinsics, ransac_sample_indices
from l4p_tpu_torch.models.dpt import DPTHead
from l4p_tpu_torch.models.encoder import AttentionFn, EncoderBlocksFn, VideoEncoder
from l4p_tpu_torch.models.ingest import ingest_video_tokens
from l4p_tpu_torch.models.sam import KERNELS, TrackKernels
from l4p_tpu_torch.models.track import TrackHead, track_forward_windowed
from l4p_tpu_torch.ops.flash_attention import flash_attention
from l4p_tpu_torch.ops.fused_encoder import fused_encoder_blocks
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


HOMOGRAPHY_TRIALS = 128  # find_homography_ransac's hypotheses (l4p_tpu/geometry/cameras.py:134)
HOMOGRAPHY_SAMPLE = 4


class Draws(Protocol):
    """Where the session's random numbers come from. Each method returns
    int64 CPU tensors; `window` and `step` name the draw, so a draw does not
    depend on the order of the calls."""

    def homography_samples(self, window: Optional[int], num_windows: int, count: int, n: int,
                           num_trials: int) -> torch.Tensor:
        """(count, num_trials, 4) minimal samples over n rays: the window-0
        solve of fixed intrinsics (window None, one per batch item) or window
        `window` of variable intrinsics (one per batch item and frame)."""

    def sim3_draws(self, step: int, count: int, stride: int, n: int, num_trials: int,
                   min_samples: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Window step `step` of the joint stitch, per batch item: the
        subsampling phase in [0, stride) (count,) and (count, num_trials,
        min_samples) minimal samples over the n kept points."""


class RandomDraws:
    """`Draws` from torch.Generators seeded by (seed, stream), so one request
    gets the same draws every time, as the JAX session's fixed key gives."""

    def __init__(self, seed: int = 0):
        self.seed = seed

    def _generator(self, *stream: int) -> torch.Generator:
        return torch.Generator().manual_seed(hash((self.seed, *stream)) & 0x7FFF_FFFF_FFFF_FFFF)

    def homography_samples(self, window, num_windows, count, n, num_trials):
        g = self._generator(7, -1 if window is None else window)
        return torch.stack([ransac_sample_indices(g, n, num_trials, HOMOGRAPHY_SAMPLE) for _ in range(count)])

    def sim3_draws(self, step, count, stride, n, num_trials, min_samples):
        g = self._generator(11, step)
        phase = torch.randint(0, stride, (count,), generator=g)
        return phase, torch.stack([ransac_sample_indices(g, n, num_trials, min_samples) for _ in range(count)])


def dense_head_raw(head: DPTHead, hcfg: DenseHeadConfig, hook_feats: Sequence[torch.Tensor],
                   img_info: Tuple[int, int, int]) -> torch.Tensor:
    """DPT trunk + per-kind activation (reference dense_heads.py:66-74,
    :172-182, :208-217); camray keeps its 6 raw ray channels."""
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
    encoder_blocks: EncoderBlocksFn = fused_encoder_blocks,
) -> Dict[str, object]:
    """Slice the video into overlapping windows and encode them all.
    Returns {'hooks': {hook: (nw, B, P, C)}, 'final': (nw, B, P, C)}.

    With `rgb_u8_bthw3` the whole video is tokenized once by the folded
    normalise+patchify matmul and windows are sliced in token space. With
    `cfg.encoder.fused_encoder` every window goes into one batch and one
    `encoder_blocks` call (l4p_tpu/models/l4p.py:259-269), else
    `enc_window_chunk` windows per encoder call."""
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
    chunk = nw if ecfg.fused_encoder else cfg.enc_window_chunk
    blocks_fn = encoder_blocks if ecfg.fused_encoder else None
    chunks = []
    for c0 in range(0, nw, chunk):
        starts = [i * stride for i in range(c0, min(c0 + chunk, nw))]
        chunks.append(encoder(window_tokens(starts), hooks, attention, blocks_fn))  # window-major batch

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


def camray_windows_to_cameras(rays_w_b6thw: torch.Tensor, hcfg: DenseHeadConfig, img_info: Tuple[int, int, int],
                              intrinsics_b44t: Optional[torch.Tensor], window_stride: int,
                              draws: Draws) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-window rays (nw, B, 6, t, h, w) -> (pose (nw, B, 16, t),
    intrinsics (nw, B, 16, t)), fp32, in VideoMAETraj3DDPTHead.forward's three
    modes (dense_heads.py:292-352; l4p_tpu/models/l4p.py:294-360):
    `use_intrinsics` solves poses from the input K and reports it;
    `fixed_intrinsics` estimates K from window 0 by homography RANSAC,
    solves later windows' rotations from the input K (from that estimate when
    there is none) and reports window 0's K everywhere; otherwise K is
    estimated per frame."""
    nw, b = rays_w_b6thw.shape[:2]
    _, h_img, w_img = img_info
    rays = rays_w_b6thw.float()
    tw, n_rays = rays.shape[3], rays.shape[4] * rays.shape[5]
    dev = rays.device

    def raw_k(w):
        return intrinsics_b44t[..., w * window_stride: w * window_stride + tw].float()

    def window_k(w):  # the input intrinsics of window w, normalised to ray space
        return normalize_intrinsics(raw_k(w), h_img, w_img)

    if hcfg.use_intrinsics:
        ext = torch.stack([rays_to_cameras(rays[w], window_k(w))[0] for w in range(nw)])
        # the reference emits no estimated K here; the joint stitch reads the
        # raw input intrinsics (dense_heads.py:424-426)
        k_out = torch.stack([raw_k(w) for w in range(nw)]).reshape(nw, b, 16, tw)
    elif hcfg.fixed_intrinsics:
        idx = draws.homography_samples(None, nw, b, n_rays, HOMOGRAPHY_TRIALS).to(dev)
        ext0, _, k_est0 = rays_to_cameras_and_fixed_intrinsics(rays[0], idx, output_size=(h_img, w_img))
        exts = [ext0]
        for w in range(1, nw):
            k = window_k(w) if intrinsics_b44t is not None else normalize_intrinsics(k_est0, h_img, w_img)
            exts.append(rays_to_cameras(rays[w], k)[0])
        ext = torch.stack(exts)
        k_out = k_est0.reshape(1, b, 16, tw).expand(nw, b, 16, tw)
    else:
        exts, ks = [], []
        for w in range(nw):
            idx = draws.homography_samples(w, nw, b * tw, n_rays, HOMOGRAPHY_TRIALS).to(dev)
            ext_w, _, k_w = rays_to_cameras_and_variable_intrinsics(rays[w], idx, output_size=(h_img, w_img))
            exts.append(ext_w)
            ks.append(k_w.reshape(b, 16, tw))
        ext, k_out = torch.stack(exts), torch.stack(ks)
    # pose = inv(extrinsics) (dense_heads.py:346-347)
    pose = torch.linalg.inv_ex(ext.permute(0, 1, 4, 2, 3))[0].permute(0, 1, 3, 4, 2)
    return pose.reshape(nw, b, 16, tw), k_out


def stitch_joint_depth_camray(depth_w: torch.Tensor, pose_w: torch.Tensor, intr_w: torch.Tensor, stride: int,
                              t_total: int, draws: Draws, num_trials: int = 128,
                              min_samples: int = 10) -> Dict[str, torch.Tensor]:
    """Joint Sim(3) alignment chain (reference joint_windowed_estimation,
    dense_heads.py:360-492): each window's point map on the overlap, from its
    depth, pose and K, is RANSAC-aligned to the previous aligned window's,
    then depth, pose and K are overwrite-stitched. depth_w (nw, B, 1, ws, H, W),
    pose_w and intr_w (nw, B, 16, ws)."""
    nw, b = depth_w.shape[:2]
    ws, h, w = depth_w.shape[3:]
    overlap = ws - stride
    n_keep, n_stride = sim3_sample_counts(overlap, h, w, min_samples=min_samples)
    depths, poses = [depth_w[0]], [pose_w[0]]
    for k_idx in range(1, nw):
        prev_d, prev_p, prev_k = depths[-1], poses[-1], intr_w[k_idx - 1]
        cur_d, cur_p, cur_k = depth_w[k_idx], pose_w[k_idx], intr_w[k_idx]
        pred = {"depth": cur_d[:, :, :overlap], "camray": cur_p[:, :, :overlap],
                "camray_intrinsics": cur_k[:, :, :overlap].reshape(b, 4, 4, overlap)}
        tgt = {"depth": prev_d[:, :, stride:], "camray": prev_p[:, :, stride:],
               "camray_intrinsics": prev_k[:, :, stride:].reshape(b, 4, 4, overlap)}
        phase, idx = draws.sim3_draws(k_idx, b, n_stride, n_keep, num_trials, min_samples)
        rel = sim3_overlap_solve(pred, tgt, phase, idx)
        applied = sim3_overlap_apply(rel, {"depth": cur_d, "camray": cur_p})
        depths.append(applied["depth"])
        poses.append(applied["camray"])
    return {
        "depth": stitch_overwrite(torch.stack(depths), stride, t_total),
        "camray": stitch_overwrite(torch.stack(poses), stride, t_total),
        "camray_intrinsics": stitch_overwrite(intr_w, stride, t_total),
    }


def stitch_dense_outputs(cfg: L4PConfig, tasks: Sequence[str], dense_outs: Dict[str, torch.Tensor], stride: int,
                         t_total: int, pose_w: Optional[torch.Tensor] = None, intr_w: Optional[torch.Tensor] = None,
                         draws: Optional[Draws] = None) -> Dict[str, torch.Tensor]:
    """flow = overwrite with the frame-0 skip; dyn_mask = overwrite;
    depth = disparity-affine chain; camray = pose overwrite (+ the estimated
    K unless use_intrinsics); depth and camray together under
    `joint_alignment` = the joint Sim(3) chain (l4p_tpu/models/l4p.py:604-656).
    pose_w and intr_w (nw, B, 16, ws) come from `camray_windows_to_cameras`."""
    heads = cfg.head_dict
    joint = cfg.joint_alignment and "depth" in tasks and "camray" in tasks and pose_w is not None
    out: Dict[str, torch.Tensor] = {}
    for t in tasks:
        hcf = heads.get(t)
        if t == "flow_2d_backward":
            out[f"{hcf.task_name}_est_b2thw"] = stitch_overwrite(dense_outs[t], stride, t_total, flow_skip=True)
        elif t == "dyn_mask":
            out[f"{hcf.task_name}_est_b1thw"] = stitch_overwrite(dense_outs[t], stride, t_total)
        elif t == "depth" and not joint:
            out[f"{hcf.task_name}_est_b1thw"] = stitch_depth_aligned(dense_outs[t], stride, t_total, hcf)
        elif t == "camray" and pose_w is not None and not joint:
            out[f"{hcf.task_name}_est_b16t"] = stitch_overwrite(pose_w, stride, t_total)
            if not hcf.use_intrinsics:
                # with input intrinsics the reference emits no K estimate (dense_heads.py:309-315)
                out[f"{hcf.task_name}_intrinsics_est_b16t"] = stitch_overwrite(intr_w, stride, t_total)
    if joint:
        stitched = stitch_joint_depth_camray(dense_outs["depth"], pose_w, intr_w, stride, t_total,
                                             draws or RandomDraws(), cfg.sim3_num_trials, cfg.sim3_min_samples)
        out[f"{heads['depth'].task_name}_est_b1thw"] = stitched["depth"]
        name = heads["camray"].task_name
        out[f"{name}_est_b16t"] = stitched["camray"]
        out[f"{name}_intrinsics_est_b16t"] = stitched["camray_intrinsics"]
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
