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
for camray, and for tracking `track_2d_pointquerries_bn3` (B, N, 3) as
(t, x, y) in frames and pixels and `track_2d_pointlabels_bn`, as tensors or
numpy arrays. The stages run in the order of l4p_tpu/inference.py:157-181:
encode, dense heads, camray rays and the camera solve, stitch, track; with
the backward direction, the time-flipped video is encoded once more after
the forward tracks (l4p_tpu/models/l4p.py:735-766).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Union

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

    def _encode(self, model: L4P, rgb, rgb_u8, hooks=None) -> Dict[str, object]:
        return encode_windows(model.video_encoder, self.cfg, rgb, rgb_u8, self.attention, self.encoder_blocks, hooks)

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

        intr = data.get("intrinsics_b44t")
        intr = None if intr is None else torch.as_tensor(intr, device=self.device)

        enc = self._encode(model, rgb, rgb_u8)
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
                # the backward pass encodes the time-flipped video (the encoder is not symmetric in
                # time) and tracks forward in it (reference sparse_heads.py:242-245)
                flipped = self._encode(model, None if rgb is None else rgb.flip(2),
                                       None if rgb_u8 is None else rgb_u8.flip(1), hooks=())["final"]
                bwd = run_track_chunked(head, flipped, flip_query_times(queries, t), labels, stride,
                                        self.track_kernels)
                del flipped
                fwd = merge_directions(fwd, {k: v.flip(-1) for k, v in bwd.items()}, queries, t)
            out.update(fwd)
        return out
