"""Camera geometry: RANSAC sample indices, intrinsics normalisation, the
pixel grid, the world point maps of depth and of 2D tracks, the pose helpers
(quaternions, rotation vectors, relative poses) and Plucker rays (counterpart
of l4p_tpu/geometry/core.py; reference geometry_utils.py). fp32 throughout,
as the reference forces there too. The pose helpers take any leading axes
where the JAX package maps one matrix at a time.
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


def rotmat_to_quat(r_33: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> unit quaternions (..., 4) as (w, x,
    y, z), w >= 0: Shepperd's method, each matrix taking the branch of its
    largest 4 q_i^2 candidate (the first on ties; l4p_tpu/geometry/core.py:
    107-133)."""
    r = r_33.float()
    m00, m11, m22 = r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]
    cand = torch.stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22, 1 - m00 - m11 + m22], -1)
    i = torch.argmax(cand, dim=-1, keepdim=True)
    s = 2.0 * torch.sqrt(torch.clamp(cand.gather(-1, i)[..., 0], min=1e-12))
    d21, d02, d10 = r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0], r[..., 1, 0] - r[..., 0, 1]
    s01, s02, s12 = r[..., 0, 1] + r[..., 1, 0], r[..., 0, 2] + r[..., 2, 0], r[..., 1, 2] + r[..., 2, 1]
    branches = torch.stack([
        torch.stack([s / 4, d21 / s, d02 / s, d10 / s], -1),
        torch.stack([d21 / s, s / 4, s01 / s, s02 / s], -1),
        torch.stack([d02 / s, s01 / s, s / 4, s12 / s], -1),
        torch.stack([d10 / s, s02 / s, s12 / s, s / 4], -1),
    ], -2)  # (..., branch, 4)
    q = branches.gather(-2, i[..., None].expand(*i.shape[:-1], 1, 4))[..., 0, :]
    w = q[..., :1]
    q = q * torch.sign(torch.where(w == 0, torch.ones_like(w), w))  # canonical w >= 0
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def rotmat_to_rotvec(r_33: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle vectors (..., 3), 2 xyz
    of the quaternion below |xyz| 1e-12 (first order; l4p_tpu/geometry/
    core.py:136-146)."""
    q = rotmat_to_quat(r_33)
    w, xyz = q[..., 0], q[..., 1:]
    n = torch.linalg.vector_norm(xyz, dim=-1)
    angle = 2.0 * torch.atan2(n, w)
    tiny = n < 1e-12
    axis = xyz / torch.where(tiny, torch.ones_like(n), n)[..., None]
    return torch.where(tiny[..., None], 2.0 * xyz, axis * angle[..., None])


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    z = torch.zeros_like(v[..., 0])
    x, y, w = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([torch.stack([z, -w, y], -1), torch.stack([w, z, -x], -1), torch.stack([-y, x, z], -1)], -2)


def rotvec_to_rotmat(v_3: torch.Tensor) -> torch.Tensor:
    """Axis-angle vectors (..., 3) -> rotation matrices (..., 3, 3)
    (Rodrigues), I + [v]x below angle 1e-12 (first order; l4p_tpu/geometry/
    core.py:149-158)."""
    v = v_3.float()
    angle = torch.linalg.vector_norm(v, dim=-1)
    tiny = angle < 1e-12
    kx = _skew(v / torch.where(tiny, torch.ones_like(angle), angle)[..., None])
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    a = angle[..., None, None]
    r = eye + torch.sin(a) * kx + (1 - torch.cos(a)) * (kx @ kx)
    return torch.where(tiny[..., None, None], eye + _skew(v), r)


def pose_to_rel_pose_b6t(world_T_cam_b44t: torch.Tensor) -> torch.Tensor:
    """Poses (B, 4, 4, T) -> first-frame-relative xyz + rotation vector
    (B, 6, T), the rel_pose_b6t schema (l4p_tpu/geometry/core.py:161-169)."""
    pose = world_T_cam_b44t.permute(0, 3, 1, 2).float()
    rel = torch.linalg.inv(pose[:, :1]) @ pose
    return torch.cat([rel[..., :3, 3], rotmat_to_rotvec(rel[..., :3, :3])], dim=-1).permute(0, 2, 1)


def get_cam_T_ref(cam_T_world_b44t: torch.Tensor, ref_idx: int = 0) -> torch.Tensor:
    """Poses (B, 4, 4, T) relative to frame `ref_idx` (geometry_utils.py:
    128-143)."""
    cam_T_world = cam_T_world_b44t.permute(0, 3, 1, 2)
    world_T_ref = torch.linalg.inv(cam_T_world[:, ref_idx: ref_idx + 1])
    return (cam_T_world @ world_T_ref).permute(0, 2, 3, 1)


def scale_extrinsics(extrinsics_b44t: torch.Tensor, scale_b1: torch.Tensor) -> torch.Tensor:
    """The translations of (B, 4, 4, T) scaled by scale (B,)
    (geometry_utils.py:146-150)."""
    out = extrinsics_b44t.clone()
    out[:, :3, 3] *= scale_b1[:, None, None]
    return out


def scale_rays_plucker(camray_b6thw: torch.Tensor, scale_b1: torch.Tensor) -> torch.Tensor:
    """Plucker moments of (B, 6, T, H, W) scaled by scale (B,)
    (geometry_utils.py:158-162)."""
    out = camray_b6thw.clone()
    out[:, 3:] *= scale_b1.reshape(-1, 1, 1, 1, 1)
    return out


def get_rays_plucker(intrinsics_b44t: torch.Tensor, extrinsics_b44t: torch.Tensor, emb_hw: Tuple[int, int],
                     make_first_cam_ref: bool = True, normalize_dist: bool = False,
                     eps: float = 1e-6) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per-pixel Plucker rays of a camera trajectory on an (h, w) grid
    (geometry_utils.py:165-241; l4p_tpu/geometry/core.py:186-229):
    normalised intrinsics and cam_T_world extrinsics (B, 4, 4, T) ->
    (rays (B, 6, T, h, w) as direction and moment, in the first camera's
    frame with `make_first_cam_ref`; the scale (B,) that makes frame 1 unit
    distance away with `normalize_dist`, else None). Computes in the
    intrinsics' dtype."""
    h, w = emb_hw
    dtype = intrinsics_b44t.dtype
    cam_T_world = extrinsics_b44t.permute(0, 3, 1, 2)
    world_T_cam = torch.linalg.inv(cam_T_world)
    ref_T_cam = cam_T_world[:, :1] @ world_T_cam if make_first_cam_ref else world_T_cam
    scale = None
    if normalize_dist:
        dist = torch.linalg.vector_norm(ref_T_cam[:, 1, :3, -1], dim=1)
        scale = 1.0 / torch.where(dist < eps, torch.ones_like(dist), dist)
    k_inv = torch.linalg.inv(denormalize_intrinsics(intrinsics_b44t, h, w)[:, :3, :3].permute(0, 3, 1, 2))
    rays_d = torch.einsum("btmn,hwn->bthwm", k_inv, _pixel_grid(h, w, dtype, intrinsics_b44t.device))
    rays_d = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    rays_d = torch.einsum("btmn,bthwn->bthwm", ref_T_cam[..., :3, :3].to(dtype), rays_d)
    rays_o = ref_T_cam[..., :3, 3].to(dtype)
    if normalize_dist:
        rays_o = rays_o * scale[:, None, None]
    rays_oxd = torch.linalg.cross(rays_o[:, :, None, None, :].expand_as(rays_d), rays_d, dim=-1)
    return torch.cat([rays_d, rays_oxd], dim=-1).permute(0, 4, 1, 2, 3), scale
