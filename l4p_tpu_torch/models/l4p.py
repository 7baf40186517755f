"""L4P: shared encoder + flow/depth/dyn_mask/camray/camera_rays DPT heads
+ the point-track head + sliding-window stitching (counterpart of
l4p_tpu/models/l4p.py).

Windows are encoded `enc_window_chunk` at a time (all at once with the
fused encoder) with the window axis merged into the batch, and each dense
head runs `dense_window_chunk` windows at a time; the JAX package's lax.map
chunking and stacked zero-padded heads exist for XLA's compiler and are not
carried over (the outputs are the same). Camray rays become poses and
intrinsics per window (`window_cameras`). Stitching is a loop over windows
that streaming also runs one window at a time: `align_window` takes a
window's outputs through the depth chain, or through one Sim(3) chain for
depth and camray under `joint_alignment`, and `window_frames` gives the
frames no later window writes.
Tracking runs `max_queries` queries at a time (`run_track_chunked`), and
backward in time on the flipped video (`flip_query_times`,
`merge_directions`). `forward_single_window` runs one window unstitched.

Every random draw (the homography and Sim(3) RANSAC samples) comes from a
`Draws` object the caller passes: `RandomDraws` by default.

Under a mesh (parallel/mesh.py; JAX's `mesh=`, l4p_tpu/models/l4p.py:231-246,
:586-597, :708-717) `encode_windows` and `run_dense_head` take this rank's
windows over `data` and `run_track_chunked` this rank's queries of each
chunk, and each gathers its outputs over `data`: every rank returns the
whole result. The encoder's blocks split over `model`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Protocol, Sequence, Tuple

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
from l4p_tpu_torch.models.track import TrackHead, track_forward, track_forward_windowed
from l4p_tpu_torch.ops.flash_attention import flash_attention
from l4p_tpu_torch.ops.fused_encoder import fused_encoder_blocks
from l4p_tpu_torch.ops.misc import apply_fn
from l4p_tpu_torch.parallel.mesh import DATA, axis_size, gather_rows, row_range, shard_rows


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
        `window` of variable intrinsics (one per batch item and frame).
        `num_windows` is the request's window count, None when streaming."""

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
    hooks: Optional[Sequence[int]] = None,
    intrinsics_b44t: Optional[torch.Tensor] = None,
    extrinsics_b44t: Optional[torch.Tensor] = None,
    mesh=None,
) -> Dict[str, object]:
    """Slice the video into overlapping windows and encode them all.
    Returns {'hooks': {hook: (nw, B, P, C)}, 'final': (nw, B, P, C)} for
    `hooks` (default: every hook of the configured heads).

    With `rgb_u8_bthw3` the whole video is tokenized once by the folded
    normalise+patchify matmul and windows are sliced in token space. With
    `cfg.encoder.fused_encoder` every window goes into one batch and one
    `encoder_blocks` call (l4p_tpu/models/l4p.py:259-269), else
    `enc_window_chunk` windows per encoder call. With the camera embedding,
    the intrinsics (pixels, normalised here) and extrinsics (B, 4, 4, T) are
    sliced per window beside the frames (l4p_tpu/models/l4p.py:208-214).
    With `mesh`, this rank encodes its windows of the `data` axis (its
    blocks split over `model`) and the features are gathered over `data`;
    the fused encoder then raises (`VideoEncoder.forward`)."""
    ecfg = cfg.encoder
    ws, stride, tt = cfg.window_size[0], cfg.window_stride_t, ecfg.tubelet_size
    if rgb_u8_bthw3 is not None:
        b, t, h, w = rgb_u8_bthw3.shape[:4]
    else:
        b, _, t, h, w = rgb_b3thw.shape
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

    cams = None
    if ecfg.cam_emb_placed_at is not None:
        if intrinsics_b44t is None or extrinsics_b44t is None:
            raise ValueError(f"the camera embedding (cam_emb_placed_at {ecfg.cam_emb_placed_at!r}) needs "
                             "intrinsics_b44t and extrinsics_b44t")
        cams = (normalize_intrinsics(intrinsics_b44t.float(), h, w), extrinsics_b44t.float())

    def window_cams(starts):
        if cams is None:
            return {}
        k, e = (torch.cat([c[..., s: s + ws] for s in starts]) for c in cams)
        return {"intrinsics_b44t": k, "extrinsics_b44t": e}

    hooks = cfg.all_hooks if hooks is None else tuple(hooks)
    chunk = nw if ecfg.fused_encoder else cfg.enc_window_chunk
    blocks_fn = encoder_blocks if ecfg.fused_encoder else None
    lo, hi, run_lo, run_hi = local_windows(nw, mesh)
    chunks = []
    for c0 in range(run_lo, run_hi, chunk):
        starts = [i * stride for i in range(c0, min(c0 + chunk, run_hi))]
        # window-major batch
        chunks.append(encoder(window_tokens(starts), hooks, attention, blocks_fn, mesh=mesh, **window_cams(starts)))

    def merge(feats):
        local = torch.cat(feats).unflatten(0, (-1, b))[: hi - lo]
        return gather_rows(local, nw, mesh)

    return {
        "hooks": {hk: merge([c["hooks"][i] for c in chunks]) for i, hk in enumerate(hooks)},
        "final": merge([c["final"] for c in chunks]),
    }


def local_windows(nw: int, mesh) -> Tuple[int, int, int, int]:
    """(lo, hi, run_lo, run_hi): this data rank's windows [lo, hi) of nw, and
    the windows it runs, which are the last one where it has none (its
    outputs are cut to no rows, so that the gather has their shape)."""
    lo, hi = row_range(nw, mesh)
    return (lo, hi, lo, hi) if hi > lo else (lo, hi, nw - 1, nw)


def run_dense_head(head: DenseTaskHead, hook_feats: Dict[int, torch.Tensor], img_info: Tuple[int, int, int],
                   window_chunk: int, mesh=None) -> torch.Tensor:
    """Per-window head outputs (nw, B, C, ws, H, W), `window_chunk` windows
    per call with the window axis merged into the batch; with `mesh`, this
    rank's windows of the `data` axis, gathered (l4p_tpu/models/l4p.py:708-717)."""
    feats = [hook_feats[hk] for hk in head.hcfg.dpt.hooks]
    nw, b = feats[0].shape[:2]
    lo, hi, run_lo, run_hi = local_windows(nw, mesh)
    outs = [
        head([f[c0: min(c0 + window_chunk, run_hi)].flatten(0, 1) for f in feats], img_info)
        for c0 in range(run_lo, run_hi, window_chunk)
    ]
    return gather_rows(torch.cat(outs).unflatten(0, (-1, b))[: hi - lo], nw, mesh)


def window_frames(aligned: Dict[str, torch.Tensor], prev: Optional[Dict[str, torch.Tensor]], stride: int,
                  skip_first: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The frames of one window that no later window writes (the
    reference's sequential overwrite, dense_heads.py:136-140: the last
    writer wins): the `stride` frames from the window's start, on axis 2 of
    each of its outputs. Windows after the first do not write frame 0 of
    the output `skip_first` (flow's skip, dense_heads.py:136-138): that
    frame is the previous window's frame `stride`. `prev` is the previous
    window's outputs, None at window 0."""
    out = {k: v[:, :, :stride] for k, v in aligned.items()}
    if prev is not None and skip_first in aligned:
        out[skip_first] = torch.cat([prev[skip_first][:, :, stride: stride + 1], aligned[skip_first][:, :, 1:stride]],
                                    dim=2)
    return out


def window_tail(aligned: Dict[str, torch.Tensor], stride: int) -> Dict[str, torch.Tensor]:
    """The last window's frames after its first stride."""
    return {k: v[:, :, stride:] for k, v in aligned.items()}


def stitch_overwrite(win_outs: torch.Tensor, stride: int, t_total: int, flow_skip: bool = False) -> torch.Tensor:
    """(nw, B, C, ws, ...) -> (B, C, T, ...) by `window_frames`."""
    check_frames(win_outs.shape[0], win_outs.shape[3], stride, t_total)
    wins = [{"x": w} for w in win_outs]
    parts = [window_frames(cur, wins[i - 1] if i else None, stride, "x" if flow_skip else None)["x"]
             for i, cur in enumerate(wins)]
    return torch.cat([*parts, window_tail(wins[-1], stride)["x"]], dim=2)


def check_frames(nw: int, ws: int, stride: int, t_total: int) -> None:
    if (nw - 1) * stride + ws != t_total:
        raise ValueError(f"{nw} windows of {ws} frames at stride {stride} cover {(nw - 1) * stride + ws} frames, "
                         f"not {t_total}")


def window_cameras(rays_b6thw: torch.Tensor, hcfg: DenseHeadConfig, img_info: Tuple[int, int, int],
                   intr_b44t: Optional[torch.Tensor], window: int, num_windows: Optional[int],
                   k0: Optional[torch.Tensor], draws: Draws):
    """One window's rays (B, 6, t, h, w) -> (pose (B, 16, t), intrinsics
    (B, 16, t), k0), fp32, in VideoMAETraj3DDPTHead.forward's three modes
    (dense_heads.py:292-352; l4p_tpu/models/l4p.py:294-360).
    `use_intrinsics` solves poses from the input K `intr_b44t` (this window's
    frames, pixels) and reports it; `fixed_intrinsics` estimates K at window 0
    by homography RANSAC and returns it as `k0` (B, 4, 4, t), which later
    windows pass back: they solve rotations from the input K (from k0 when
    there is none) and report k0; otherwise K is estimated per frame."""
    b, tw, n_rays = rays_b6thw.shape[0], rays_b6thw.shape[2], rays_b6thw.shape[3] * rays_b6thw.shape[4]
    _, h_img, w_img = img_info
    rays, dev = rays_b6thw.float(), rays_b6thw.device
    if hcfg.use_intrinsics:
        ext = rays_to_cameras(rays, normalize_intrinsics(intr_b44t.float(), h_img, w_img))[0]
        # the reference emits no estimated K here; the joint stitch reads the
        # raw input intrinsics (dense_heads.py:424-426)
        k_out = intr_b44t.float().reshape(b, 16, tw)
    elif hcfg.fixed_intrinsics:
        if window == 0:
            idx = draws.homography_samples(None, num_windows, b, n_rays, HOMOGRAPHY_TRIALS).to(dev)
            ext, _, k0 = rays_to_cameras_and_fixed_intrinsics(rays, idx, output_size=(h_img, w_img))
        else:
            k = intr_b44t.float() if intr_b44t is not None else k0
            ext = rays_to_cameras(rays, normalize_intrinsics(k, h_img, w_img))[0]
        k_out = k0.reshape(b, 16, tw)
    else:
        idx = draws.homography_samples(window, num_windows, b * tw, n_rays, HOMOGRAPHY_TRIALS).to(dev)
        ext, _, k_w = rays_to_cameras_and_variable_intrinsics(rays, idx, output_size=(h_img, w_img))
        k_out = k_w.reshape(b, 16, tw)
    # pose = inv(extrinsics) (dense_heads.py:346-347)
    pose = torch.linalg.inv_ex(ext.permute(0, 3, 1, 2))[0].permute(0, 2, 3, 1)
    return pose.reshape(b, 16, tw), k_out, k0


def camray_windows_to_cameras(rays_w_b6thw: torch.Tensor, hcfg: DenseHeadConfig, img_info: Tuple[int, int, int],
                              intrinsics_b44t: Optional[torch.Tensor], window_stride: int,
                              draws: Draws) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-window rays (nw, B, 6, t, h, w) -> (pose (nw, B, 16, t),
    intrinsics (nw, B, 16, t)), fp32: `window_cameras` over the windows,
    window 0's K estimate carried to the later ones."""
    nw, tw = rays_w_b6thw.shape[0], rays_w_b6thw.shape[3]
    poses, ks, k0 = [], [], None
    for w in range(nw):
        intr = None if intrinsics_b44t is None else intrinsics_b44t[..., w * window_stride: w * window_stride + tw]
        pose, k, k0 = window_cameras(rays_w_b6thw[w], hcfg, img_info, intr, w, nw, k0, draws)
        poses.append(pose)
        ks.append(k)
    return torch.stack(poses), torch.stack(ks)


def depth_align_step(prev: torch.Tensor, cur: torch.Tensor, stride: int, hcfg: DenseHeadConfig) -> torch.Tensor:
    """One step of the depth chain: window depth `cur` (B, 1, ws, H, W)
    aligned to the previous aligned window `prev` on their overlap."""
    overlap = cur.shape[2] - stride
    if hcfg.align_type == "affine":
        sol = lstsq_affine_solve(cur[:, :, :overlap], prev[:, :, stride:], pre_inverse=hcfg.align_pre_inverse)
        return lstsq_affine_apply(sol, cur, pre_inverse=hcfg.align_pre_inverse)
    sol = linear_scale_solve(cur[:, :, :overlap], prev[:, :, stride:], pre_inverse=hcfg.align_pre_inverse)
    return linear_scale_apply(sol, cur, pre_inverse=hcfg.align_pre_inverse)


def joint_align_step(prev: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                     cur: Tuple[torch.Tensor, torch.Tensor, torch.Tensor], stride: int, step: int, draws: Draws,
                     num_trials: int = 128, min_samples: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the joint Sim(3) chain: window `cur`'s point map on the
    overlap, from its (depth (B, 1, ws, H, W), pose (B, 16, ws), K (B, 16,
    ws)), RANSAC-aligned to the previous aligned window `prev`'s; returns
    cur's aligned (depth, pose). `step` names the draws."""
    (prev_d, prev_p, prev_k), (cur_d, cur_p, cur_k) = prev, cur
    b, _, ws, h, w = cur_d.shape
    overlap = ws - stride
    n_keep, n_stride = sim3_sample_counts(overlap, h, w, min_samples=min_samples)
    pred = {"depth": cur_d[:, :, :overlap], "camray": cur_p[:, :, :overlap],
            "camray_intrinsics": cur_k[:, :, :overlap].reshape(b, 4, 4, overlap)}
    tgt = {"depth": prev_d[:, :, stride:], "camray": prev_p[:, :, stride:],
           "camray_intrinsics": prev_k[:, :, stride:].reshape(b, 4, 4, overlap)}
    phase, idx = draws.sim3_draws(step, b, n_stride, n_keep, num_trials, min_samples)
    rel = sim3_overlap_solve(pred, tgt, phase, idx)
    applied = sim3_overlap_apply(rel, {"depth": cur_d, "camray": cur_p})
    return applied["depth"], applied["camray"]


def flow_key(cfg: L4PConfig) -> Optional[str]:
    """The flow output's key, the one whose frame 0 later windows skip."""
    h = cfg.head_dict.get("flow_2d_backward")
    return None if h is None else f"{h.task_name}_est_b2thw"


def align_window(cfg: L4PConfig, tasks: Sequence[str], cur: Dict[str, torch.Tensor],
                 prev: Optional[Dict[str, torch.Tensor]], step: int, stride: int,
                 draws: Draws) -> Dict[str, torch.Tensor]:
    """One window's outputs under the session's keys, each (B, C, ws, ...),
    aligned to `prev`, the previous window's result (None at window 0).
    `cur` holds the window's dense head outputs by task and, for camray, its
    `pose` and `intrinsics` (B, 16, ws) from `window_cameras`. flow and
    dyn_mask stay as they are; depth goes through the disparity-affine (or
    scale) chain (reference dense_heads.py:104-140); camray gives its poses
    and, unless it uses the input intrinsics, its K (dense_heads.py:
    309-315); under `joint_alignment` depth and poses go through one Sim(3)
    chain (dense_heads.py:360-492; l4p_tpu/models/l4p.py:604-656) and K is
    always given. `step` names the Sim(3) draws."""
    heads = cfg.head_dict
    joint = cfg.joint_alignment and "depth" in tasks and "camray" in tasks
    out: Dict[str, torch.Tensor] = {}
    for t, layout in (("flow_2d_backward", "b2thw"), ("depth", "b1thw"), ("dyn_mask", "b1thw")):
        if t in tasks:
            out[f"{heads[t].task_name}_est_{layout}"] = cur[t]
    if "camray" in tasks:
        pose_key, k_key = f"{heads['camray'].task_name}_est_b16t", f"{heads['camray'].task_name}_intrinsics_est_b16t"
        out[pose_key] = cur["pose"]
        if joint or not heads["camray"].use_intrinsics:
            out[k_key] = cur["intrinsics"]
    if prev is not None and "depth" in tasks:
        depth_key = f"{heads['depth'].task_name}_est_b1thw"
        if joint:
            out[depth_key], out[pose_key] = joint_align_step(
                (prev[depth_key], prev[pose_key], prev[k_key]), (cur["depth"], cur["pose"], cur["intrinsics"]),
                stride, step, draws, cfg.sim3_num_trials, cfg.sim3_min_samples)
        else:
            out[depth_key] = depth_align_step(prev[depth_key], cur["depth"], stride, heads["depth"])
    return out


def stitch_dense_outputs(cfg: L4PConfig, tasks: Sequence[str], dense_outs: Dict[str, torch.Tensor], stride: int,
                         t_total: int, pose_w: Optional[torch.Tensor] = None, intr_w: Optional[torch.Tensor] = None,
                         draws: Optional[Draws] = None) -> Dict[str, torch.Tensor]:
    """Per-window outputs -> whole-video outputs: `align_window` over the
    windows, each window's `window_frames` and the last window's tail
    concatenated in time. dense_outs (nw, B, C, ws, H, W) by task; pose_w and
    intr_w (nw, B, 16, ws) from `camray_windows_to_cameras` when the tasks
    have camray. Tasks without a dense output (track_2d) are skipped."""
    tasks = [t for t in tasks if t in dense_outs or (t == "camray" and pose_w is not None)]
    if not tasks:
        return {}
    nw = (pose_w if pose_w is not None else dense_outs[tasks[0]]).shape[0]
    draws = draws or RandomDraws()
    parts, prev = [], None
    for w in range(nw):
        cur = {t: v[w] for t, v in dense_outs.items()}
        if pose_w is not None:
            cur.update(pose=pose_w[w], intrinsics=intr_w[w])
        aligned = align_window(cfg, tasks, cur, prev, w, stride, draws)
        parts.append(window_frames(aligned, prev, stride, flow_key(cfg)))
        prev = aligned
    check_frames(nw, next(iter(prev.values())).shape[2], stride, t_total)
    parts.append(window_tail(prev, stride))
    return {k: torch.cat([p[k] for p in parts], dim=2) for k in prev}


def merge_query_chunks(v: torch.Tensor, n_queries: int) -> torch.Tensor:
    """(n_chunks, B, chunk, ...) -> (B, n_queries, ...): undoes the
    `max_queries` chunking and drops the padding queries."""
    m = v.movedim(0, 1)
    return m.reshape(m.shape[0], m.shape[1] * m.shape[2], *m.shape[3:])[:, :n_queries]


def query_chunks(queries_bn3: torch.Tensor, max_queries: int, multiple: int = 1) -> List[torch.Tensor]:
    """`max_queries` queries at a time (the reference's memory governor,
    sparse_heads.py:181-211), the chunk rounded up to a multiple of
    `multiple` and the last chunk padded with queries at (0, 0, 0) whose
    outputs `merge_query_chunks` drops."""
    n = queries_bn3.shape[1]
    chunk = -(-min(max_queries, n) // multiple) * multiple
    pad = -n % chunk
    if pad:
        queries_bn3 = torch.cat([queries_bn3, queries_bn3.new_zeros((queries_bn3.shape[0], pad, 3))], dim=1)
    return list(queries_bn3.split(chunk, dim=1))


def run_track_chunked(head: TrackHead, enc_final: torch.Tensor, queries: torch.Tensor, labels: torch.Tensor,
                      stride: int, kernels: TrackKernels = KERNELS, mesh=None) -> Dict[str, torch.Tensor]:
    """Forward-direction windowed tracking over the encoder's final features
    (nw, B, P, C), in `query_chunks`. The labels are recomputed per window
    from the queries' validity, as the reference does. With `mesh`, each
    chunk (padded to a multiple of the `data` axis) is split over `data`,
    this rank tracks its queries, and the outputs are gathered before the
    chunks merge (l4p_tpu/models/l4p.py:586-597): queries are independent
    streams through the whole track head."""
    del labels
    nd = axis_size(mesh, DATA)
    outs = []
    for i, q in enumerate(query_chunks(queries, head.cfg.max_queries, nd)):
        o = track_forward_windowed(head, head.cfg, enc_final, shard_rows(q, mesh, dim=1), None, stride, kernels, i)
        outs.append({k: gather_rows(v, q.shape[1], mesh, dim=1) for k, v in o.items()})
    return {k: merge_query_chunks(torch.stack([o[k] for o in outs]), queries.shape[1]) for k in outs[0]}


def flip_query_times(queries_bn3: torch.Tensor, t_total: int) -> torch.Tensor:
    """Query times in the time-flipped video: t -> T - t (l4p.py:752-754 of
    the JAX package; not T - 1 - t, since t is a frame time plus 0.5)."""
    q = queries_bn3.clone()
    q[:, :, 0] = t_total - q[:, :, 0]
    return q


def merge_directions(fwd: Optional[Dict[str, torch.Tensor]], bwd: Dict[str, torch.Tensor], queries_bn3: torch.Tensor,
                     t_total: int) -> Dict[str, torch.Tensor]:
    """Bidirectional tracks (reference sparse_heads.py:242-245): the forward
    outputs where t + 0.5 >= the query time, the backward ones (already
    flipped back to forward time) elsewhere; the backward ones alone
    without a forward pass."""
    if fwd is None:
        return bwd
    t_ids = torch.arange(t_total, dtype=queries_bn3.dtype, device=queries_bn3.device) + 0.5
    after = (t_ids[None, None, None, :] - queries_bn3[:, :, 0:1, None]) >= 0
    return {k: torch.where(after, fwd[k], bwd[k]) for k in fwd}


def track_bidirectional(model: L4P, cfg: L4PConfig, data: Dict, device, directions: Tuple[int, ...] = (1, -1),
                        **session_kw) -> Dict[str, torch.Tensor]:
    """Backward (`(-1,)`) or bidirectional (`(1, -1)`) tracking alone: the
    session's track_2d task with those estimation directions (counterpart of
    l4p_tpu/models/l4p.py:797-819). `session_kw` go to InferenceSession."""
    import dataclasses

    from l4p_tpu_torch.inference import InferenceSession

    bi = dataclasses.replace(cfg, track=dataclasses.replace(cfg.track, estimation_directions=tuple(directions)))
    return InferenceSession(bi, ("track_2d",), device, **session_kw)(model, data)


@torch.inference_mode()
def forward_single_window(model: L4P, cfg: L4PConfig, data: Dict, tasks: Sequence[str], device,
                          draws: Optional[Draws] = None, attention: AttentionFn = flash_attention,
                          track_kernels: TrackKernels = KERNELS,
                          encoder_blocks: EncoderBlocksFn = fused_encoder_blocks) -> Dict[str, torch.Tensor]:
    """One window of `rgb_b3thw` (B, 3, t, H, W), no stitching (reference
    forward_single_window, l4p_videomae.py:234-254; l4p_tpu/models/l4p.py:
    822-863): the dense heads' raw window outputs, camray's window poses and,
    unless it uses the input intrinsics, its K (draws from `draws`), and the
    track head on the one window (the prompt-feature and token-memory
    outputs dropped). With the camera embedding, the window's intrinsics
    (pixels) and extrinsics go to the encoder, normalised as
    `encode_windows` does."""
    dev = torch.device(device)
    rgb = torch.as_tensor(data["rgb_b3thw"], device=dev)
    img_info = tuple(rgb.shape[2:5])
    intr, ext = (None if data.get(k) is None else torch.as_tensor(data[k], device=dev)
                 for k in ("intrinsics_b44t", "extrinsics_b44t"))
    cams = {}
    if cfg.encoder.cam_emb_placed_at is not None and intr is not None and ext is not None:
        t = img_info[0]
        cams = {"intrinsics_b44t": normalize_intrinsics(intr[..., :t].float(), *img_info[1:]),
                "extrinsics_b44t": ext[..., :t].float()}
    enc_model, hooks = model.video_encoder, cfg.all_hooks
    enc = enc_model(enc_model.embed(rgb), hooks, attention, encoder_blocks if cfg.encoder.fused_encoder else None,
                    **cams)
    feats = dict(zip(hooks, enc["hooks"]))
    out: Dict[str, torch.Tensor] = {}
    for task in tasks:
        if task == "track_2d":
            o = track_forward(model.task_heads["track_2d"], cfg.track, enc["final"],
                              torch.as_tensor(data["track_2d_pointquerries_bn3"], device=dev),
                              torch.as_tensor(data["track_2d_pointlabels_bn"], device=dev), kernels=track_kernels)
            out.update({k: v for k, v in o.items() if not k.endswith(("bnpc", "_prompt_features_bnc"))})
            continue
        hcfg = cfg.head_dict[task]
        raw = model.task_heads[task]([feats[h] for h in hcfg.dpt.hooks], img_info)
        if hcfg.kind == "camray":
            k_in = None if intr is None else intr[..., : raw.shape[2]]
            pose, k, _ = window_cameras(raw, hcfg, img_info, k_in, 0, 1, None, draws or RandomDraws())
            out[f"{hcfg.task_name}_est_b16t"] = pose
            if not hcfg.use_intrinsics:
                out[f"{hcfg.task_name}_intrinsics_est_b16t"] = k
        else:
            out[f"{hcfg.task_name}_est_b{hcfg.out_nchan}thw"] = raw
    return out
