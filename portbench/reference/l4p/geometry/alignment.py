"""Window-overlap aligners (counterpart of l4p_tpu/geometry/alignment.py;
reference aligner.py): the scale/shift depth aligners and the joint
depth + camray Sim(3) aligner, a fixed-trial RANSAC over batched Umeyama
solves. RANSAC draws no random numbers itself: the caller passes the
subsampling phase and the minimal samples, so a test can feed both packages
the same draws."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from portbench.reference.l4p.geometry.core import ransac_best
from portbench.reference.l4p.ops.misc import safe_inverse


def _batch_shape(sol: torch.Tensor, pred: torch.Tensor):
    return (sol.shape[0],) + (1,) * (pred.dim() - 1)


def lstsq_affine_solve(pred: torch.Tensor, target: torch.Tensor, pre_inverse: bool = True) -> torch.Tensor:
    """Per-batch (scale, shift) minimising ||s*pred + t - target||^2 over all
    elements, in disparity when `pre_inverse`. Returns (B, 2) fp32."""
    if pre_inverse:
        pred, target = safe_inverse(pred), safe_inverse(target)
    b = pred.shape[0]
    p = pred.reshape(b, -1).float()
    d = target.reshape(b, -1).float()
    pm = p.mean(-1, keepdim=True)
    dm = d.mean(-1, keepdim=True)
    cov = ((p - pm) * (d - dm)).sum(-1)
    var = ((p - pm) ** 2).sum(-1)
    s = cov / torch.clamp(var, min=1e-12)
    t = dm[:, 0] - s * pm[:, 0]
    return torch.stack([s, t], dim=-1)


def lstsq_affine_apply(sol_b2: torch.Tensor, pred: torch.Tensor, pre_inverse: bool = True) -> torch.Tensor:
    shape = _batch_shape(sol_b2, pred)
    s = sol_b2[:, 0].reshape(shape).to(pred.dtype)
    t = sol_b2[:, 1].reshape(shape).to(pred.dtype)
    if pre_inverse:
        pred = safe_inverse(pred)
    out = s * pred + t
    return safe_inverse(out) if pre_inverse else out


def linear_scale_solve(pred: torch.Tensor, target: torch.Tensor, pre_inverse: bool = False,
                       method: str = "mean") -> torch.Tensor:
    """Scale-only aligner (reference aligner.py:91-109). Returns (B,)."""
    if pre_inverse:
        pred, target = safe_inverse(pred), safe_inverse(target)
    b = pred.shape[0]
    ratios = target.reshape(b, -1) / (pred.reshape(b, -1) + 1e-8)
    if method == "mean":
        return ratios.mean(-1)
    # numpy's median: the mean of the two middle values for an even count
    # (torch.median would return the lower one)
    return torch.quantile(ratios.float(), 0.5, dim=-1).to(ratios.dtype)


def linear_scale_apply(sol_b: torch.Tensor, pred: torch.Tensor, pre_inverse: bool = False) -> torch.Tensor:
    s = sol_b.reshape(_batch_shape(sol_b, pred)).to(pred.dtype)
    if pre_inverse:
        pred = safe_inverse(pred)
    out = s * pred
    return safe_inverse(out) if pre_inverse else out


# ---------------------------------------------------------------------------
# Sim(3) Umeyama + RANSAC (reference aligner.py:121-265)
# ---------------------------------------------------------------------------

def umeyama_sim3(src_n3: torch.Tensor, dst_n3: torch.Tensor,
                 w_n: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted Umeyama similarity dst ~= s R src + t, batched over leading
    dims: (..., N, 3) -> (T (..., 4, 4) = [sR | t], s (...)), the math of
    skimage's SimilarityTransform.estimate. Degenerate geometry (coincident
    or non-finite points) gives the identity."""
    src, dst = src_n3.float(), dst_n3.float()
    w = torch.ones(src.shape[:-1], device=src.device) if w_n is None else w_n.float()
    wsum = torch.clamp(w.sum(-1), min=1e-8)
    mu_s = (src * w[..., None]).sum(-2) / wsum[..., None]
    mu_d = (dst * w[..., None]).sum(-2) / wsum[..., None]
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    cov = torch.matmul((dc * w[..., None]).transpose(-1, -2), sc) / wsum[..., None, None]  # dst^T src
    var_s = ((sc ** 2).sum(-1) * w).sum(-1) / wsum
    u, s_vals, vh = torch.linalg.svd(cov)
    flip = torch.linalg.det(u) * torch.linalg.det(vh) < 0
    ones = torch.ones_like(var_s)
    d = torch.stack([ones, ones, torch.where(flip, -ones, ones)], dim=-1)
    r = torch.matmul(u * d[..., None, :], vh)
    scale = (s_vals * d).sum(-1) / torch.clamp(var_s, min=1e-12)
    t = mu_d - scale[..., None] * torch.matmul(r, mu_s[..., None])[..., 0]
    ok = torch.isfinite(scale) & torch.isfinite(r).all(-1).all(-1) & torch.isfinite(t).all(-1) & (var_s > 1e-12)
    r = torch.where(ok[..., None, None], r, torch.eye(3, device=r.device).expand_as(r))
    scale = torch.where(ok, scale, ones)
    t = torch.where(ok[..., None], t, torch.zeros_like(t))
    tf = torch.zeros(r.shape[:-2] + (4, 4), device=r.device)
    tf[..., :3, :3] = scale[..., None, None] * r
    tf[..., :3, 3] = t
    tf[..., 3, 3] = 1.0
    return tf, scale


def _sim3_residuals(tf_44: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    pred = torch.matmul(src, tf_44[..., :3, :3].transpose(-1, -2)) + tf_44[..., None, :3, 3]
    return torch.sqrt(((pred - dst) ** 2).sum(-1))


def sim3_ransac(src_n3: torch.Tensor, dst_n3: torch.Tensor, sample_idx: torch.Tensor,
                residual_threshold: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-trial RANSAC Sim(3) per batch item (replaces
    skimage.measure.ransac, aligner.py:139-146). src, dst (B, N, 3);
    sample_idx (B, trials, min_samples); residual_threshold (B,). The best
    hypothesis (first on ties) is refit on its inliers, as skimage does.
    Returns (T (B, 4, 4), s (B,), inliers (B, N))."""
    bi = torch.arange(src_n3.shape[0], device=src_n3.device)
    tfs, _ = umeyama_sim3(src_n3[bi[:, None, None], sample_idx], dst_n3[bi[:, None, None], sample_idx])
    inl = _sim3_residuals(tfs, src_n3[:, None].float(), dst_n3[:, None].float()) < residual_threshold[:, None, None]
    best = ransac_best(inl)
    tf, s = umeyama_sim3(src_n3, dst_n3, inl[bi, best].float())
    return tf, s, _sim3_residuals(tf, src_n3.float(), dst_n3.float()) < residual_threshold[:, None]


def sim3_sample_counts(frames: int, h: int, w: int, frame_sample_step: int = 3, point_sample_ratio: float = 0.1,
                       min_samples: int = 10) -> Tuple[int, int]:
    """(n_keep, stride) of `sim3_overlap_solve`'s point subsample over an
    overlap of `frames` frames: every `frame_sample_step`-th frame, then
    every stride-th pixel from a random phase in [0, stride)."""
    n_total = -(-frames // frame_sample_step) * h * w
    # clamped so the stride never reaches 0 (l4p_tpu/geometry/alignment.py:203-205)
    n_keep = min(max(int(point_sample_ratio * n_total), min_samples), n_total)
    return n_keep, n_total // n_keep


def _points_at(depth_bthw: torch.Tensor, k44t: torch.Tensor, pose44t: torch.Tensor,
               sel: torch.Tensor) -> torch.Tensor:
    """World points of the selected pixels only (the math of
    generate_point_map, geometry_utils.py:13-53, at `sel` (B, n) flat
    indices into (t, H, W)), sanitised: degenerate poses can emit huge or
    non-finite coordinates that would overflow the fp32 solve."""
    b, _, h, w = depth_bthw.shape
    bi = torch.arange(b, device=sel.device)[:, None]
    dsel = depth_bthw.reshape(b, -1).gather(1, sel).float()
    t_i = torch.div(sel, h * w, rounding_mode="floor")
    rem = sel % (h * w)
    py = torch.div(rem, w, rounding_mode="floor").float()
    px = (rem % w).float()
    kinv = torch.linalg.inv_ex(k44t[:, :3, :3].float().permute(0, 3, 1, 2))[0][bi, t_i]  # (B, n, 3, 3)
    pix = torch.stack([px, py, torch.ones_like(px)], dim=-1)
    pts = torch.einsum("bnij,bnj->bni", kinv, pix) * dsel[..., None]
    tf = pose44t.float().permute(0, 3, 1, 2)[bi, t_i]  # (B, n, 4, 4)
    world = torch.einsum("bnij,bnj->bni", tf[..., :3, :3], pts) + tf[..., :3, 3]
    lim = 1e6
    return torch.clamp(torch.nan_to_num(world, posinf=lim, neginf=-lim), -lim, lim)


def sim3_overlap_solve(pred: Dict[str, torch.Tensor], target: Dict[str, torch.Tensor], phase: torch.Tensor,
                       sample_idx: torch.Tensor, frame_sample_step: int = 3, point_sample_ratio: float = 0.1,
                       reprojection_threshold: float = 0.01) -> Dict[str, torch.Tensor]:
    """Joint depth + camray overlap alignment (reference
    KabschUmeyama3DAligner.solve, aligner.py:177-237). pred/target:
    {'depth': (B, 1, T, H, W), 'camray': (B, 16, T) pose,
    'camray_intrinsics': (B, 4, 4, T)}; phase (B,) in [0, stride) and
    sample_idx (B, trials, min_samples) over the n_keep points of
    `sim3_sample_counts`. The inlier threshold scales with the 98th
    percentile of a 4 x 4-strided subsample of the overlap depth
    (l4p_tpu/geometry/alignment.py:184-192). Returns {'T': (B, 4, 4), 's': (B,)}."""
    depth_p = pred["depth"]
    b, _, t, h, w = depth_p.shape
    dr = torch.quantile(depth_p[:, :, :, ::4, ::4].reshape(b, -1).float(), 0.98, dim=-1)
    thresh = dr * reprojection_threshold
    step = frame_sample_step
    min_samples = sample_idx.shape[-1]  # the minimal sample size sets the floor of n_keep
    n_keep, stride = sim3_sample_counts(t, h, w, step, point_sample_ratio, min_samples)
    sel = torch.arange(n_keep, device=depth_p.device)[None] * stride + phase.to(depth_p.device)[:, None]

    def points(side):
        return _points_at(side["depth"][:, 0, ::step], side["camray_intrinsics"].reshape(b, 4, 4, -1)[..., ::step],
                          side["camray"].reshape(b, 4, 4, -1)[..., ::step], sel)

    tf, s, _ = sim3_ransac(points(pred), points(target), sample_idx.to(depth_p.device), thresh)
    return {"T": tf, "s": s}


def sim3_overlap_apply(rel: Dict[str, torch.Tensor], pred: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """pose' = T pose with the rotation de-scaled; depth *= s; intrinsics
    unchanged (reference aligner.py:239-265)."""
    out = {}
    tf, s = rel["T"], rel["s"]
    for name, val in pred.items():
        if name == "camray":
            b, t = val.shape[0], val.shape[-1]
            pose = torch.einsum("bij,bjkt->bikt", tf.to(val.dtype), val.reshape(b, 4, 4, t)).clone()
            pose[:, :3, :3] /= s[:, None, None, None].to(val.dtype)
            out[name] = pose.reshape(b, -1, t)
        elif name == "depth":
            out[name] = val * s[:, None, None, None, None].to(val.dtype)
        elif name == "camray_intrinsics":
            out[name] = val
        else:
            raise ValueError(f"sim3_overlap_apply: unknown task {name}")
    return out
