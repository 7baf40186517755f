"""Plucker rays -> camera extrinsics and intrinsics, batched (counterpart of
l4p_tpu/geometry/cameras.py; reference geometry_utils.py:249-654).

The reference loops over (batch, frame) on the CPU with SVDs and
cv2.findHomography(RANSAC) + cv2.RQDecomp3x3; here every solve is one batched
torch.linalg call: the skew-line centres by pinv, Kabsch by a 3x3 SVD, the
RANSAC homography as a batch of 4-point DLT hypotheses scored against all
points at once, RQ by a flipped QR. RANSAC draws no random numbers itself:
the caller passes the sample indices (`ransac_sample_indices`), so a test can
feed both packages the same draws. All math fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from portbench.reference.l4p.geometry.core import (
    _pixel_grid,
    denormalize_intrinsics,
    normalize_intrinsics,
    plucker_to_point_direction,
    ransac_best,
)


def _inv(m: torch.Tensor) -> torch.Tensor:
    """Batched inverse that returns non-finite values for a singular matrix
    instead of raising, as the JAX package's does; callers guard on them."""
    return torch.linalg.inv_ex(m)[0]


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) gathered at idx (B, ...) along N."""
    b = torch.arange(x.shape[0], device=x.device).reshape((-1,) + (1,) * (idx.dim() - 1))
    return x[b, idx]


def intersect_skew_lines_high_dim(points: torch.Tensor, directions: torch.Tensor,
                                  mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest point to a bundle of skew lines (geometry_utils.py:249-282).
    points, directions (B, R, D) -> (p (B, D), unit directions)."""
    dim = points.shape[-1]
    if mask is None:
        mask = torch.ones_like(points[..., 0])
    d = directions / torch.linalg.vector_norm(directions, dim=-1, keepdim=True)
    eye = torch.eye(dim, dtype=points.dtype, device=points.device)
    i_min_cov = (eye - d[..., :, None] * d[..., None, :]) * mask[..., None, None]
    sum_proj = torch.matmul(i_min_cov, points[..., None]).sum(dim=-3)  # (B, D, 1)
    a = i_min_cov.sum(dim=-3).float()
    # the min-norm least-squares solve (the reference's lstsq) with the JAX
    # package's pinv cut-off, 10 * max(m, n) * eps
    rtol = 10 * dim * torch.finfo(torch.float32).eps
    p = torch.matmul(torch.linalg.pinv(a, rtol=rtol), sum_proj.float())[..., 0]
    return p.to(points.dtype), d


def kabsch_rotation(a_n3: torch.Tensor, b_n3: torch.Tensor) -> torch.Tensor:
    """R minimising ||A - B R||_F, batched over leading dims
    (geometry_utils.py:285-305)."""
    h = torch.matmul(b_n3.transpose(-1, -2), a_n3).float()
    u, _, vh = torch.linalg.svd(h)
    s = torch.sign(torch.linalg.det(torch.matmul(u, vh)))
    ones = torch.ones_like(s)
    r = torch.matmul(u * torch.stack([ones, ones, s], dim=-1)[..., None, :], vh)
    return r.transpose(-1, -2)


_kabsch_bt = kabsch_rotation  # (B, T, N, 3) pairs: the batch dims are the leading ones


def rq_decomposition_3x3(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """M = R Q with R upper-triangular with a positive diagonal and Q
    orthogonal (cv2.RQDecomp3x3 up to that convention), via a flipped QR;
    batched over leading dims."""
    p = torch.tensor([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]], dtype=m.dtype, device=m.device)
    q_, r_ = torch.linalg.qr(torch.matmul(p, m).transpose(-1, -2))
    r = p @ r_.transpose(-1, -2) @ p
    q = p @ q_.transpose(-1, -2)
    d = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))
    d = torch.where(d == 0, torch.ones_like(d), d)
    return r * d[..., None, :], q * d[..., :, None]


def homography_dlt(src: torch.Tensor, dst: torch.Tensor, w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted least-squares homography by the Hartley-normalised DLT.
    src, dst (..., N, 2), w (..., N) -> H (..., 3, 3) with dst ~ H src, in
    src's dtype. Solved in float64, as cv2.findHomography solves: the null
    vector of A^T A from an fp32 eigh differs between an H100 and the CPU
    (up to 1.5e-3 on 4-point samples whose largest to second-smallest
    eigenvalue ratio is 675-3.2e3, tests/test_torch_gpu.py), enough for a
    RANSAC on each device to choose another hypothesis."""
    dtype = src.dtype
    src, dst = src.double(), dst.double()
    w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device) if w is None else w.double()
    wsum = torch.clamp(w.sum(-1), min=1e-8)

    def normalizer(pts):
        mean = (pts * w[..., None]).sum(-2) / wsum[..., None]
        dist = torch.sqrt(((pts - mean[..., None, :]) ** 2).sum(-1))
        meand = (dist * w).sum(-1) / wsum
        s = torch.sqrt(torch.tensor(2.0, dtype=pts.dtype)) / torch.clamp(meand, min=1e-12)
        zero, one = torch.zeros_like(s), torch.ones_like(s)
        t = torch.stack([torch.stack([s, zero, -mean[..., 0] * s], -1),
                         torch.stack([zero, s, -mean[..., 1] * s], -1),
                         torch.stack([zero, zero, one], -1)], -2)
        return (pts - mean[..., None, :]) * s[..., None, None], t

    s_n, t_s = normalizer(src)
    d_n, t_d = normalizer(dst)
    x, y = s_n[..., 0], s_n[..., 1]
    u, v = d_n[..., 0], d_n[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    row1 = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], dim=-1)
    row2 = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], dim=-1)
    a = torch.cat([row1, row2], dim=-2) * torch.sqrt(torch.cat([w, w], dim=-1))[..., None]
    # the null vector is the eigenvector of A^T A (9 x 9) with the smallest
    # eigenvalue, as in the JAX package (l4p_tpu/geometry/cameras.py:106-113),
    # which solves it in fp32
    ata = torch.matmul(a.transpose(-1, -2), a)
    vecs = torch.linalg.eigh(ata)[1]
    h_n = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))
    h = _inv(t_d) @ h_n @ t_s
    return (h / h[..., 2:3, 2:3]).to(dtype)


def _homography_transfer_err2(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Squared forward transfer error |dst - proj(H src)|^2 per point,
    cv2.findHomography RANSAC's measure; h (..., 3, 3), src/dst (..., N, 2)."""
    p = torch.matmul(torch.cat([src, torch.ones_like(src[..., :1])], dim=-1), h.transpose(-1, -2))
    z = p[..., 2:3]
    zsafe = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    return ((p[..., :2] / zsafe - dst) ** 2).sum(-1)


def find_homography_ransac(src: torch.Tensor, dst: torch.Tensor, sample_idx: torch.Tensor,
                           reproj_threshold: float = 0.2, refine_iters: int = 2,
                           valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fixed-trial RANSAC homography per batch item (replaces
    cv2.findHomography, geometry_utils.py:436-441). src, dst (B, N, 2);
    sample_idx (B, trials, 4) minimal samples; valid (B, N) excludes points
    from inlier counts and refit weights. Every hypothesis is solved and
    scored at once; the best (first on ties) is refit `refine_iters` times on
    its inliers."""
    if valid is None:
        valid = torch.ones(src.shape[:-1], dtype=torch.bool, device=src.device)
    hs = homography_dlt(_rows(src, sample_idx), _rows(dst, sample_idx))  # (B, trials, 3, 3)
    errs = _homography_transfer_err2(hs, src[:, None], dst[:, None])  # (B, trials, N)
    inf = torch.full_like(errs, float("inf"))
    errs = torch.where(valid[:, None], errs, inf)
    thr2 = reproj_threshold ** 2
    inliers = errs < thr2
    best = ransac_best(inliers)
    w = inliers[torch.arange(src.shape[0], device=src.device), best].to(src.dtype)
    for _ in range(refine_iters):
        h = homography_dlt(src, dst, w)
        e = torch.where(valid, _homography_transfer_err2(h, src, dst), inf[:, 0])
        w = (e < thr2).to(src.dtype)
    return homography_dlt(src, dst, w)


def compute_optimal_rotation_intrinsics(rays_origin: torch.Tensor, rays_target: torch.Tensor,
                                        sample_idx: torch.Tensor, z_threshold: float = 1e-4,
                                        reproj_threshold: float = 0.2
                                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rotation and intrinsics aligning ray bundles by homography + RQ
    (geometry_utils.py:409-456), batched: rays (B, N, 3), sample_idx
    (B, trials, 4) -> (R, K, H), each (B, 3, 3). Rays with a small |z| get
    zero RANSAC weight (the reference drops them). Too few usable rays or a
    non-finite solve gives the identity (l4p_tpu/geometry/cameras.py:197-204)."""
    z_ok = (rays_target[..., 2].abs() > z_threshold) & (rays_origin[..., 2].abs() > z_threshold)

    def project(rays):
        z = rays[..., 2:3]
        z = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
        return torch.where(z_ok[..., None], rays[..., :2] / z, torch.zeros_like(rays[..., :2]))

    a = find_homography_ransac(project(rays_origin), project(rays_target), sample_idx, reproj_threshold,
                               valid=z_ok)
    a = torch.where((torch.linalg.det(a) < 0)[..., None, None], -a, a)
    h = _inv(a.float())  # H = K R
    k, r = rq_decomposition_3x3(h)
    k22 = k[..., 2:3, 2:3]
    k = k / torch.where(k22.abs() < 1e-12, torch.ones_like(k22), k22)
    ok = (z_ok.sum(-1) >= 4) & torch.isfinite(k).all(-1).all(-1) & torch.isfinite(r).all(-1).all(-1)
    eye = torch.eye(3, dtype=torch.float32, device=h.device).expand_as(h)
    ok = ok[..., None, None]
    return torch.where(ok, r, eye), torch.where(ok, k, eye), torch.where(ok, h, eye)


def _centers(camray: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera centres (B, T, 3) and the ray directions (B, 3, T, h, w)."""
    b, _, t, h, w = camray.shape
    origins, directions = plucker_to_point_direction(camray)
    centers, _ = intersect_skew_lines_high_dim(origins.permute(0, 2, 3, 4, 1).reshape(-1, h * w, 3),
                                               directions.permute(0, 2, 3, 4, 1).reshape(-1, h * w, 3))
    return centers.reshape(b, t, 3), directions


def _extrinsics(rot_bt33: torch.Tensor, centers_bt3: torch.Tensor) -> torch.Tensor:
    """[R | -R c] as (B, 4, 4, T)."""
    b, t = rot_bt33.shape[:2]
    ext = torch.zeros((b, t, 4, 4), dtype=rot_bt33.dtype, device=rot_bt33.device)
    ext[:, :, :3, :3] = rot_bt33
    ext[:, :, :3, 3] = -torch.matmul(rot_bt33, centers_bt3[..., None])[..., 0]
    ext[:, :, 3, 3] = 1.0
    return ext.permute(0, 2, 3, 1)


def _identity_rays(h: int, w: int, device) -> torch.Tensor:
    pix = _pixel_grid(h, w, device=device)
    return pix / torch.linalg.vector_norm(pix, dim=-1, keepdim=True)


def _k44(k_bt33: torch.Tensor, h: int, w: int, output_size: Tuple[int, int]) -> torch.Tensor:
    """(B, T, 3, 3) K in ray-grid pixels -> (B, 4, 4, T) scaled to output_size."""
    b, t = k_bt33.shape[:2]
    k44 = torch.zeros((b, 4, 4, t), dtype=torch.float32, device=k_bt33.device)
    k44[:, 3, 3] = 1.0
    k44[:, :3, :3] = k_bt33.permute(0, 2, 3, 1)
    return denormalize_intrinsics(normalize_intrinsics(k44, h, w), *output_size)


def rays_to_cameras(camray_b6thw: torch.Tensor, intrinsics_b44t: torch.Tensor,
                    ctr_only: bool = False) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Plucker rays + known normalised intrinsics -> (extrinsics (B, 4, 4, T),
    centres (B, T, 3)) (geometry_utils.py:331-406), one batched Kabsch."""
    dtype = intrinsics_b44t.dtype
    camray = camray_b6thw.to(dtype)
    b, _, t, h, w = camray.shape
    centers, directions = _centers(camray)
    if ctr_only:
        return None, centers
    k33 = denormalize_intrinsics(intrinsics_b44t, h, w)[:, :3, :3]
    pix = _pixel_grid(h, w, dtype, camray.device)
    rays_d = torch.einsum("btmn,hwn->bthwm", _inv(k33.permute(0, 3, 1, 2)), pix)
    rays_d = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    dirs = directions.permute(0, 2, 3, 4, 1).reshape(b, t, h * w, 3)
    rot = _kabsch_bt(rays_d.reshape(b, t, h * w, 3), dirs)
    return _extrinsics(rot.to(dtype), centers), centers


def rays_to_cameras_and_fixed_intrinsics(camray_b6thw: torch.Tensor, sample_idx: torch.Tensor,
                                         reproj_threshold: float = 0.2, output_size: Tuple[int, int] = (224, 224)
                                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rays -> extrinsics + one K per batch item estimated from frame 0
    (geometry_utils.py:493-579). sample_idx (B, trials, 4) draws over the
    h * w rays of frame 0. Returns (ext (B, 4, 4, T), centres (B, T, 3),
    K (B, 4, 4, T) scaled to output_size)."""
    camray = camray_b6thw.float()
    b, _, t, h, w = camray.shape
    centers, directions = _centers(camray)
    ident = _identity_rays(h, w, camray.device).reshape(1, h * w, 3).expand(b, -1, -1)
    dirs = directions.permute(0, 2, 3, 4, 1)  # (B, T, h, w, 3)
    _, k_b33, _ = compute_optimal_rotation_intrinsics(ident, dirs[:, 0].reshape(b, h * w, 3), sample_idx,
                                                      reproj_threshold=reproj_threshold)
    # rays with the estimated K, then one batched Kabsch over all frames
    rays_d = torch.einsum("bmn,hwn->bhwm", _inv(k_b33), _pixel_grid(h, w, device=camray.device))
    rays_d = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    rays_d = rays_d[:, None].expand(b, t, h, w, 3).reshape(b, t, h * w, 3)
    rot = _kabsch_bt(rays_d, dirs.reshape(b, t, h * w, 3))
    k_bt33 = k_b33[:, None].expand(b, t, 3, 3)
    return _extrinsics(rot, centers), centers, _k44(k_bt33, h, w, output_size)


def rays_to_cameras_and_variable_intrinsics(camray_b6thw: torch.Tensor, sample_idx: torch.Tensor,
                                            reproj_threshold: float = 0.2,
                                            output_size: Tuple[int, int] = (224, 224)
                                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A homography K and R per frame (geometry_utils.py:582-654).
    sample_idx (B * T, trials, 4), batch-major. Returns as
    `rays_to_cameras_and_fixed_intrinsics`."""
    camray = camray_b6thw.float()
    b, _, t, h, w = camray.shape
    centers, directions = _centers(camray)
    ident = _identity_rays(h, w, camray.device).reshape(1, h * w, 3).expand(b * t, -1, -1)
    dirs = directions.permute(0, 2, 3, 4, 1).reshape(b * t, h * w, 3)
    r_flat, k_flat, _ = compute_optimal_rotation_intrinsics(ident, dirs, sample_idx,
                                                            reproj_threshold=reproj_threshold)
    return (_extrinsics(r_flat.reshape(b, t, 3, 3), centers), centers,
            _k44(k_flat.reshape(b, t, 3, 3), h, w, output_size))
