"""Inference session (counterpart of l4p_tpu/inference.py:25-181).

`InferenceSession(cfg, tasks, device)(model_or_state, data)` returns the same
keys and layouts as the JAX session for every task of the JAX session: the
dense `flow_2d_backward_est_b2thw`, `depth_est_b1thw`, `dyn_mask_est_b1thw`,
each (B, C, T, H, W); for `camray` the poses `traj3d_est_b16t` and (unless
the head uses the input intrinsics) `traj3d_intrinsics_est_b16t`, each
(B, 16, T); for a configured `camera_rays` head (VideoMAECameraDPTHead),
served under its name, its raw rays `<task_name>_est_b6thw` (B, 6, T, h, w)
overwrite-stitched; for `track_2d` `track_2d_traj_est_bn2t` (B, N, 2, T),
`track_2d_vis_est_bn1t` and `track_2d_depth_est_bn1t` (B, N, 1, T), forward
in time, backward or both as `estimation_directions` says. With
`joint_alignment`, depth and camray are stitched together by the Sim(3)
chain. `data` holds `rgb_u8_bthw3` (uint8, normalised on the device) or
`rgb_b3thw` (normalised float), `intrinsics_b44t` (B, 4, 4, T) in pixels
for camray, cam_T_world `extrinsics_b44t` (B, 4, 4, T) beside the
intrinsics for an encoder with the Plucker camera embedding, and for
tracking `track_2d_pointquerries_bn3` (B, N, 3) as (t, x, y) in frames and
pixels and `track_2d_pointlabels_bn`, as tensors or numpy arrays. The
stages run in the order of l4p_tpu/inference.py:157-181: encode, dense
heads, camray rays and the camera solve, stitch, track; with the backward
direction, the time-flipped video (its cameras flipped too) is encoded
once more after the forward tracks (l4p_tpu/models/l4p.py:735-766).

`run_sequence` (counterpart of l4p_tpu/inference.py:211-299) is the entry
point of the demo and the CLI's `predict`: one collated sequence through a
cached session, or frame by frame through StreamingL4P, then the panel mp4
and the 4D PLY exports.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from l4p_tpu_torch.config import L4PConfig
from l4p_tpu_torch.models.encoder import AttentionFn, EncoderBlocksFn
from l4p_tpu_torch.models.l4p import (
    L4P,
    Draws,
    RandomDraws,
    camray_windows_to_cameras,
    encode_windows,
    flip_query_times,
    merge_directions,
    run_dense_head,
    run_track_chunked,
    stitch_dense_outputs,
    stitch_overwrite,
)
from l4p_tpu_torch.models.sam import KERNELS, TrackKernels
from l4p_tpu_torch.ops.flash_attention import flash_attention
from l4p_tpu_torch.ops.fused_encoder import fused_encoder_blocks

ALL_TASKS = ("flow_2d_backward", "track_2d", "depth", "dyn_mask", "camray")  # bench.py's request
SLICE_TASKS = ("flow_2d_backward", "track_2d", "depth", "dyn_mask")  # the dense tasks and tracks
DENSE_TASKS = ("flow_2d_backward", "depth", "dyn_mask")


class InferenceSession:
    """`attention` replaces the encoder's attention kernel, `encoder_blocks`
    the whole-encoder kernels (with `encoder.fused_encoder`) and
    `track_kernels` the track head's three kernels; tests pass the plain
    versions (`flash_attention_plain`, `fused_encoder_blocks_plain`,
    `models.sam.PLAIN`) to hold the kernels' path against the plain one.
    `draws` gives every random number of the camray solve and the joint
    stitch (`RandomDraws(0)` by default). `tasks` are names of ALL_TASKS and
    of configured camera_rays heads; tracking runs in the directions of the
    track head's `estimation_directions`: (1,), (-1,) or (1, -1)."""

    def __init__(self, cfg: L4PConfig, tasks: Sequence[str], device: Union[str, torch.device],
                 attention: AttentionFn = flash_attention, track_kernels: TrackKernels = KERNELS,
                 encoder_blocks: EncoderBlocksFn = fused_encoder_blocks, draws: Optional[Draws] = None):
        self.tasks = tuple(tasks)
        heads = cfg.head_dict
        # a camera_rays head is served by its kind, whatever its name (l4p_tpu/models/l4p.py:774)
        self.rays_tasks = tuple(t for t in self.tasks if t in heads and heads[t].kind == "camera_rays")
        unsupported = [t for t in self.tasks if t not in ALL_TASKS and t not in self.rays_tasks]
        if unsupported:
            raise ValueError(f"unknown tasks {unsupported}; the port serves {ALL_TASKS} and camera_rays heads")
        self.stitch_tasks = tuple(t for t in self.tasks if t not in self.rays_tasks and t != "track_2d")
        missing = [t for t in self.stitch_tasks if t not in heads]
        if "camray" in self.stitch_tasks and "camray" not in missing and heads["camray"].kind != "camray":
            missing.append("camray")
        if "track_2d" in self.tasks and cfg.track is None:
            missing.append("track_2d")
        if not self.tasks or missing:
            raise ValueError(f"no configured head for tasks {missing or self.tasks}")
        if "track_2d" in self.tasks:
            dirs = tuple(cfg.track.estimation_directions)
            if not dirs or not set(dirs) <= {1, -1} or len(set(dirs)) != len(dirs):
                raise ValueError(f"estimation_directions {dirs}: expected (1,), (-1,) or (1, -1)")
        self.cfg = cfg
        self.device = torch.device(device)
        self.attention = attention
        self.track_kernels = track_kernels
        self.encoder_blocks = encoder_blocks
        self.draws = RandomDraws() if draws is None else draws
        self._loaded = None  # (state dict, model built from it)

    def model(self, model_or_state: Union[nn.Module, Mapping[str, torch.Tensor]]) -> L4P:
        if isinstance(model_or_state, nn.Module):
            return model_or_state
        if self._loaded is None or self._loaded[0] is not model_or_state:
            dtype = next(iter(model_or_state.values())).dtype
            model = L4P(self.cfg, device=self.device, dtype=dtype)
            model.load_state_dict(model_or_state, strict=True)
            self._loaded = (model_or_state, model.eval())
        return self._loaded[1]

    def _encode(self, model: L4P, rgb, rgb_u8, intr, ext, hooks=None) -> Dict[str, object]:
        return encode_windows(model.video_encoder, self.cfg, rgb, rgb_u8, self.attention, self.encoder_blocks, hooks,
                              intr, ext)

    @torch.inference_mode()
    def __call__(self, model_or_state, data: Mapping) -> Dict[str, torch.Tensor]:
        model = self.model(model_or_state)
        cfg = self.cfg
        rgb_u8 = data.get("rgb_u8_bthw3")
        rgb = data.get("rgb_b3thw") if rgb_u8 is None else None
        if rgb_u8 is None and rgb is None:
            raise ValueError("data needs 'rgb_u8_bthw3' or 'rgb_b3thw'")
        rgb_u8 = None if rgb_u8 is None else torch.as_tensor(rgb_u8, device=self.device)
        rgb = None if rgb is None else torch.as_tensor(rgb, device=self.device)
        t, *hw = rgb_u8.shape[1:4] if rgb_u8 is not None else rgb.shape[2:5]
        if tuple(hw) != tuple(cfg.window_size[1:]):
            raise ValueError(f"frames are {tuple(hw)}, the model takes {tuple(cfg.window_size[1:])} only")

        intr, ext = (None if data.get(k) is None else torch.as_tensor(data[k], device=self.device)
                     for k in ("intrinsics_b44t", "extrinsics_b44t"))

        enc = self._encode(model, rgb, rgb_u8, intr, ext)
        hooks, final = enc["hooks"], enc["final"]
        del enc
        img_info = tuple(cfg.window_size)
        stride, chunk = cfg.window_stride_t, cfg.dense_window_chunk
        dense = {t_: run_dense_head(model.task_heads[t_], hooks, img_info, chunk)
                 for t_ in self.stitch_tasks if t_ in DENSE_TASKS}
        pose_w = intr_w = None
        if "camray" in self.stitch_tasks:
            rays = run_dense_head(model.task_heads["camray"], hooks, img_info, chunk).float()
            pose_w, intr_w = camray_windows_to_cameras(rays, cfg.head_dict["camray"], img_info, intr, stride,
                                                       self.draws)
            del rays
        rays_out = {}
        for t_ in self.rays_tasks:
            # raw rays, overwrite-stitched with no aligner (reference dense_heads.py:220-254)
            hcfg = cfg.head_dict[t_]
            rays_out[f"{hcfg.task_name}_est_b{hcfg.out_nchan}thw"] = stitch_overwrite(
                run_dense_head(model.task_heads[t_], hooks, img_info, chunk), stride, t)
        del hooks  # the hook pyramid is freed before the track stage, the largest
        out = stitch_dense_outputs(cfg, self.stitch_tasks, dense, stride, t, pose_w, intr_w, self.draws)
        out.update(rays_out)
        del dense, rays_out
        if "track_2d" in self.tasks:
            head, dirs = model.task_heads["track_2d"], tuple(cfg.track.estimation_directions)
            queries = torch.as_tensor(data["track_2d_pointquerries_bn3"], device=self.device)
            labels = torch.as_tensor(data["track_2d_pointlabels_bn"], device=self.device)
            fwd = run_track_chunked(head, final, queries, labels, stride, self.track_kernels) if 1 in dirs else None
            del final  # freed before the flipped video is encoded, so peak memory does not double
            if -1 in dirs:
                # the backward pass encodes the time-flipped video, its cameras flipped with it (the
                # encoder is not symmetric in time), and tracks forward in it (reference
                # sparse_heads.py:242-245; l4p_tpu/models/l4p.py:743-752)
                flipped = self._encode(model, *(None if v is None else v.flip(d) for v, d in
                                                ((rgb, 2), (rgb_u8, 1), (intr, 3), (ext, 3))), hooks=())["final"]
                bwd = run_track_chunked(head, flipped, flip_query_times(queries, t), labels, stride,
                                        self.track_kernels)
                del flipped
                fwd = merge_directions(fwd, {k: v.flip(-1) for k, v in bwd.items()}, queries, t)
            out.update(fwd)
        return out


_SESSIONS: Dict[Tuple, Tuple[L4PConfig, Optional[Draws], InferenceSession]] = {}


def get_session(cfg: L4PConfig, tasks: Sequence[str], device: Union[str, torch.device] = "cuda",
                draws: Optional[Draws] = None) -> InferenceSession:
    """One session per (cfg, tasks, device, draws), reused across sequences
    so that a state dict is loaded into a model once (counterpart of
    l4p_tpu/inference.py:184-208 get_forward_fn). The cache holds `cfg` and
    `draws` themselves, so the ids in its key are never recycled by other
    objects."""
    key = (id(cfg), tuple(tasks), torch.device(device), id(draws))
    hit = _SESSIONS.get(key)
    if hit is None or hit[0] is not cfg or hit[1] is not draws:
        hit = (cfg, draws, InferenceSession(cfg, tasks, device, draws=draws))
        _SESSIONS[key] = hit
    return hit[2]


def run_sequence(model_or_state: Union[nn.Module, Mapping[str, torch.Tensor]], cfg: L4PConfig, tasks: Sequence[str],
                 batch: Dict[str, np.ndarray], out_dir: str, seq_name: str, device: Union[str, torch.device] = "cuda",
                 dtype: torch.dtype = torch.bfloat16, write_artifacts: bool = True, stream: bool = False,
                 draws: Optional[Draws] = None) -> Dict[str, np.ndarray]:
    """All-task inference on one collated sequence (numpy arrays with the
    batch dimension, as `data.dataset.collate` makes them), then the demo's
    artefacts: `{seq}_panels.mp4` and, with depth and poses, per-frame point
    clouds (every 4th frame), the camera frusta and the 3D track points as
    PLYs under `{out_dir}/{seq}/` (reference demo/demo.py:78, :151). Returns
    the outputs as float32 numpy arrays.

    Offline, the sequence runs through `get_session`'s session. With
    `stream`, its uint8 frames go through StreamingL4P as a camera would
    send them, the first window and then one stride a push, and the
    emissions are assembled at the end. `rgb_u8_bthw3` is preferred where
    the batch has it (normalised on the device); otherwise `rgb_b3thw` goes
    to the device in `dtype`. The mp4 needs cv2 (`utils.vis`)."""
    from l4p_tpu_torch.utils import vis

    use_u8 = "rgb_u8_bthw3" in batch
    if stream and not use_u8:
        raise ValueError("streaming needs uint8 frames (rgb_u8_bthw3; the dataset's emit_uint8)")
    dev = torch.device(device)
    t0 = time.time()
    if stream:
        from l4p_tpu_torch.streaming import StreamingL4P, assemble_emissions

        s = StreamingL4P(model_or_state, cfg, tasks, dev, batch.get("track_2d_pointquerries_bn3"), draws=draws)
        rgb, intr = batch["rgb_u8_bthw3"], batch.get("intrinsics_b44t")
        ws, stride = cfg.window_size[0], cfg.window_stride_t
        emits, lo = [], 0
        while lo < rgb.shape[1]:
            hi = min(lo + (ws if lo == 0 else stride), rgb.shape[1])
            emits += s.push(rgb[:, lo:hi], None if intr is None else intr[..., lo:hi])
            lo = hi
        emits.append(s.flush())
        out = assemble_emissions(emits)
    else:
        keys = ("rgb_u8_bthw3" if use_u8 else "rgb_b3thw", "intrinsics_b44t", "extrinsics_b44t",
                "track_2d_pointquerries_bn3", "track_2d_pointlabels_bn")
        data = {k: torch.as_tensor(batch[k], device=dev, dtype=dtype if k == "rgb_b3thw" else None)
                for k in keys if isinstance(batch.get(k), np.ndarray)}
        out = get_session(cfg, tasks, dev, draws)(model_or_state, data)
    out_np = {k: v.float().cpu().numpy() for k, v in out.items()}
    dt = time.time() - t0
    t_frames = batch["rgb_u8_bthw3"].shape[1] if use_u8 else batch["rgb_b3thw"].shape[2]
    mode = "streamed" if stream else "in"
    print(f"[{seq_name}] {t_frames} frames {mode} {dt:.2f}s ({t_frames / dt:.1f} fps incl. compile)")
    print(f"[{seq_name}] outputs: {sorted(out_np.keys())}")
    if not write_artifacts:
        return out_np

    os.makedirs(out_dir, exist_ok=True)
    vis_path = vis.generate_video_visualizations(batch, out_np, tasks, os.path.join(out_dir, f"{seq_name}_panels.mp4"))
    print(f"[{seq_name}] wrote {vis_path}")
    if "depth_est_b1thw" in out_np and "traj3d_est_b16t" in out_np:
        seq_dir = os.path.join(out_dir, seq_name)
        n_ply = len(vis.generate_4d_visualization(batch, out_np, seq_dir, stride=4, device=dev))
        if "traj3d_intrinsics_est_b16t" in out_np:  # absent where the camray head uses the input K
            vis.generate_camera_trajectory_ply(out_np, os.path.join(seq_dir, "cameras.ply"))
            n_ply += 1
        if "track_2d_traj_est_bn2t" in out_np and "track_2d_depth_est_bn1t" in out_np:
            n_ply += len(vis.generate_3d_track_ply(batch, out_np, seq_dir, device=dev))
        print(f"[{seq_name}] wrote {n_ply} point clouds (view: python -c "
              f"\"from l4p_tpu_torch.utils.vis import serve_point_clouds; "
              f"serve_point_clouds('{seq_dir}').serve_forever()\")")
    return out_np
