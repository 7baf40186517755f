"""Inference session (counterpart of l4p_tpu/inference.py:25-181), on one
device, forward in time.

`InferenceSession(cfg, tasks, device)(model, data)` returns the same keys
and layouts as the JAX session: the dense `flow_2d_backward_est_b2thw`,
`depth_est_b1thw`, `dyn_mask_est_b1thw`, each (B, C, T, H, W); for `camray`
the poses `traj3d_est_b16t` and (unless the head uses the input
intrinsics) `traj3d_intrinsics_est_b16t`, each (B, 16, T); for a
configured `camera_rays` head (VideoMAECameraDPTHead), served under its
name, its raw rays `<task_name>_est_b6thw` (B, 6, T, h, w)
overwrite-stitched; for `track_2d` `track_2d_traj_est_bn2t` (B, N, 2, T),
`track_2d_vis_est_bn1t` and `track_2d_depth_est_bn1t` (B, N, 1, T), forward
in time. With `joint_alignment`, depth and camray are stitched together by
the Sim(3) chain. `data` holds `rgb_u8_bthw3` (uint8, normalised on the
device) or `rgb_b3thw` (normalised float), `intrinsics_b44t` (B, 4, 4, T)
in pixels for camray, cam_T_world `extrinsics_b44t` (B, 4, 4, T) beside the
intrinsics for an encoder with the Plucker camera embedding, and for
tracking `track_2d_pointquerries_bn3` (B, N, 3) as (t, x, y) in frames and
pixels and `track_2d_pointlabels_bn`. The stages run in the order of
l4p_tpu/inference.py:157-181: encode, dense heads, camray rays and the
camera solve, stitch, track.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Union

import torch

from portbench.reference.l4p.config import L4PConfig
from portbench.reference.l4p.models.l4p import (
    L4P,
    Draws,
    RandomDraws,
    camray_windows_to_cameras,
    encode_windows,
    run_dense_head,
    run_track_chunked,
    stitch_dense_outputs,
    stitch_overwrite,
)

ALL_TASKS = ("flow_2d_backward", "track_2d", "depth", "dyn_mask", "camray")  # bench.py's request
DENSE_TASKS = ("flow_2d_backward", "depth", "dyn_mask")


class InferenceSession:
    """`draws` gives every random number of the camray solve and the joint
    stitch (`RandomDraws(0)` by default). `tasks` are names of ALL_TASKS and
    of configured camera_rays heads; tracking runs forward in time, the
    track head's `estimation_directions` being (1,)."""

    def __init__(self, cfg: L4PConfig, tasks: Sequence[str], device: Union[str, torch.device],
                 draws: Optional[Draws] = None):
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
            if dirs != (1,):
                raise ValueError(f"estimation_directions {dirs}: the reference tracks forward only, (1,)")
        self.cfg = cfg
        self.device = torch.device(device)
        self.draws = RandomDraws() if draws is None else draws

    @torch.inference_mode()
    def __call__(self, model: L4P, data: Mapping) -> Dict[str, torch.Tensor]:
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

        enc = encode_windows(model.video_encoder, cfg, rgb, rgb_u8, intrinsics_b44t=intr, extrinsics_b44t=ext)
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
            queries = torch.as_tensor(data["track_2d_pointquerries_bn3"], device=self.device)
            labels = torch.as_tensor(data["track_2d_pointlabels_bn"], device=self.device)
            out.update(run_track_chunked(model.task_heads["track_2d"], final, queries, labels, stride))
        return out
