"""Camera geometry: RANSAC sample indices, intrinsics normalisation, the
pixel grid, Plucker rays and the world point maps of depth and of 2D tracks
(counterpart of l4p_tpu/geometry/core.py:17-107, :232-242; reference
geometry_utils.py). fp32 throughout, as the reference forces there too.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

# Set to a list to keep, for every RANSAC solve, (inlier counts (B, trials),
# chosen hypothesis (B,)) on the CPU: a run on two devices can then say
# where a near-tie picked another hypothesis. None (the default) costs nothing.
RANSAC_TRACE: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None


def ransac_best(inliers: torch.Tensor) -> torch.Tensor:
    """The hypothesis with the most inliers (the first on ties) per batch
    item: inliers (B, trials, N) bool -> (B,)."""
    counts = inliers.sum(-1)
    best = torch.argmax(counts, dim=-1)
    if RANSAC_TRACE is not None:
        RANSAC_TRACE.append((counts.cpu(), best.cpu()))
    return best


def ransac_sample_indices(generator: torch.Generator, n: int, num_trials: int, k: int) -> torch.Tensor:
    """(num_trials, k) int64 point indices, distinct within each minimal
    sample: rows cut from whole random permutations of n, never across two
    (l4p_tpu/geometry/core.py:17-35 with a torch.Generator for the key)."""
    per = n // k  # full samples per permutation
    if per < 1:
        raise ValueError(f"need at least {k} points, got {n}")
    n_perms = -(-num_trials // per)
    rows = [torch.randperm(n, generator=generator)[: per * k].reshape(per, k) for _ in range(n_perms)]
    return torch.cat(rows)[:num_trials]


def normalize_intrinsics(intrinsics_b44t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[0, 1]-normalised K with the half-pixel offset (geometry_utils.py:110-116)."""
    k = intrinsics_b44t.clone()
    k[:, :2, 2] += 0.5
    k[:, 0] /= w
    k[:, 1] /= h
    return k


def denormalize_intrinsics(intrinsics_b44t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse of `normalize_intrinsics` (geometry_utils.py:119-125)."""
    k = intrinsics_b44t.clone()
    k[:, 0] *= w
    k[:, 1] *= h
    k[:, :2, 2] -= 0.5
    return k


def _pixel_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Homogeneous pixel grid (h, w, 3) as (x = column, y = row, 1)."""
    j, i = torch.meshgrid(torch.arange(h, dtype=dtype, device=device), torch.arange(w, dtype=dtype, device=device),
                          indexing="ij")
    return torch.stack([i, j, torch.ones_like(i)], dim=-1)


def plucker_to_point_direction(camray_b6thw: torch.Tensor,
                               normalize_moment: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plucker rays (B, 6, ...) -> (closest point to the origin, direction),
    each (B, 3, ...) (geometry_utils.py:308-328)."""
    direction = camray_b6thw[:, :3]
    moment = camray_b6thw[:, 3:]
    if normalize_moment:
        moment = moment / torch.linalg.vector_norm(direction, dim=1, keepdim=True)
    return torch.linalg.cross(direction, moment, dim=1), direction


def generate_point_map(depth_b1thw: torch.Tensor, intrinsics_b44t: torch.Tensor,
                       world_T_cam_b44t: torch.Tensor) -> torch.Tensor:
    """Depth unprojected into world points, (B, 3, T, H, W) in depth's dtype
    (geometry_utils.py:13-53; l4p_tpu/geometry/core.py:62-77)."""
    _, _, _, h, w = depth_b1thw.shape
    k_inv = torch.linalg.inv(intrinsics_b44t[:, :3, :3].float().permute(0, 3, 1, 2))  # (B, T, 3, 3)
    rays = torch.einsum("btmn,hwn->bmthw", k_inv, _pixel_grid(h, w, device=depth_b1thw.device))
    pts = rays * depth_b1thw.float()
    pts_h = torch.cat([pts, torch.ones_like(pts[:, :1])], dim=1)
    out = torch.einsum("bmnt,bnthw->bmthw", world_T_cam_b44t.float(), pts_h)
    return out[:, :3].to(depth_b1thw.dtype)


def unproject_2d_track_to_3d(track_xy_bn2t: torch.Tensor, track_z_bn1t: torch.Tensor,
                             intrinsics_b44t: torch.Tensor) -> torch.Tensor:
    """2D tracks (x, y pixels) and their depth -> camera XYZ (B, N, 3, T)
    (geometry_utils.py:56-81)."""
    fx, fy = intrinsics_b44t[:, 0:1, 0:1, :], intrinsics_b44t[:, 1:2, 1:2, :]
    cx, cy = intrinsics_b44t[:, 0:1, 2:3, :], intrinsics_b44t[:, 1:2, 2:3, :]
    x = (track_xy_bn2t[:, :, 0:1, :] - cx) * track_z_bn1t / fx
    y = (track_xy_bn2t[:, :, 1:2, :] - cy) * track_z_bn1t / fy
    return torch.cat([x, y, track_z_bn1t], dim=-2)


def generate_3d_track_point_map(track_2d_traj_bn2t: torch.Tensor, track_2d_depth_bn1t: torch.Tensor,
                                intrinsics_b44t: torch.Tensor, world_T_cam_b44t: torch.Tensor) -> torch.Tensor:
    """2D tracks and their depth -> world XYZ (B, N, 3, T)
    (geometry_utils.py:84-107)."""
    xyz_b3tn = unproject_2d_track_to_3d(track_2d_traj_bn2t, track_2d_depth_bn1t, intrinsics_b44t).permute(0, 2, 3, 1)
    xyz_b4tn = torch.cat([xyz_b3tn, torch.ones_like(xyz_b3tn[:, :1])], dim=1)
    xyz_b4tn = torch.einsum("bmnt,bntp->bmtp", world_T_cam_b44t, xyz_b4tn)
    return xyz_b4tn[:, :3].permute(0, 3, 1, 2)
