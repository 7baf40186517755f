"""Evaluation metrics of the five tasks (counterpart of l4p_tpu/metrics.py):
depth AbsRel / RMSE / delta < 1.25 after per-video median scaling, flow EPE,
dynamic-mask IoU, TAP-style track accuracy and pose errors, and
`l4p_metrics`, the reference's metrics-module contract
`(batch, out, metadata) -> (metrics, {})` (reference l4p/l4p.py:74-78).

Each function takes tensors on any device and returns 0-d fp32 tensors
there, computed as the JAX package computes them: fp32 sums, the medians of
an even count as the mean of the two middle values (`jnp.median`'s rule;
`torch.median` returns the lower one), the mask's sigmoid as
1 / (1 + exp(-x)).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch

Metrics = Dict[str, torch.Tensor]


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    x = x.float()
    if mask is None:
        return x.mean()
    m = mask.float().expand_as(x)
    return (x * m).sum() / torch.clamp(m.sum(), min=1.0)


def median(x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The median of x (of its entries where `mask`), the two middle order
    statistics averaged for an even count, NaN for none (jnp.median and
    jnp.nanmedian)."""
    v = x.flatten() if mask is None else x.masked_select(mask)
    n = v.numel()
    if n == 0:
        return torch.full((), math.nan, dtype=x.dtype, device=x.device)
    lo = torch.kthvalue(v, (n + 1) // 2).values
    return lo if n % 2 else (lo + torch.kthvalue(v, n // 2 + 1).values) / 2


def depth_metrics(pred_b1thw: torch.Tensor, gt_b1thw: torch.Tensor, valid: Optional[torch.Tensor] = None,
                  median_align: bool = True) -> Metrics:
    """AbsRel, RMSE and delta < 1.25, the prediction scaled by the ratio of
    the ground truth's median to its own first (over valid pixels only),
    as depth is evaluated up to scale (l4p_tpu/metrics.py:25-46)."""
    pred = pred_b1thw.float()
    gt = torch.clamp(gt_b1thw.float(), min=1e-6)
    if median_align:
        v = None if valid is None else (valid > 0).expand_as(gt)
        pred = pred * (median(gt, v) / torch.clamp(median(pred, v), min=1e-6))
    pred = torch.clamp(pred, min=1e-6)
    ratio = torch.maximum(pred / gt, gt / pred)
    return {"depth/absrel": _masked_mean((pred - gt).abs() / gt, valid),
            "depth/rmse": torch.sqrt(_masked_mean((pred - gt) ** 2, valid)),
            "depth/delta1": _masked_mean((ratio < 1.25).float(), valid)}


def flow_metrics(pred_b2thw: torch.Tensor, gt_b2thw: torch.Tensor, valid: Optional[torch.Tensor] = None) -> Metrics:
    """End-point error and the share within 1 and 3 pixels; a per-channel
    valid mask counts a pixel where both channels are valid."""
    epe = torch.sqrt(((pred_b2thw.float() - gt_b2thw.float()) ** 2).sum(1, keepdim=True))
    if valid is not None and valid.ndim == epe.ndim and valid.shape[1] != 1:
        valid = valid.amin(dim=1, keepdim=True)
    return {"flow/epe": _masked_mean(epe, valid),
            "flow/1px": _masked_mean((epe < 1.0).float(), valid),
            "flow/3px": _masked_mean((epe < 3.0).float(), valid)}


def dyn_mask_metrics(logits_b1thw: torch.Tensor, gt_b1thw: torch.Tensor, valid: Optional[torch.Tensor] = None,
                     threshold: float = 0.85) -> Metrics:
    """IoU of the mask at the reference's visualisation threshold
    (vis.py:82-84)."""
    pred = 1.0 / (1.0 + torch.exp(-logits_b1thw.float())) > threshold
    gt = gt_b1thw > 0.5
    if valid is not None:
        v = (valid > 0).expand_as(pred)
        pred, gt = pred & v, gt & v
    inter, union = (pred & gt).sum(), (pred | gt).sum()
    return {"dyn_mask/iou": inter.float() / torch.clamp(union, min=1).float()}


def track_metrics(pred_traj_bn2t: torch.Tensor, pred_vis_bn1t: Optional[torch.Tensor], gt_traj_bn2t: torch.Tensor,
                  gt_vis_bn1t: Optional[torch.Tensor], valid_bn1t: Optional[torch.Tensor] = None,
                  thresholds: Tuple[float, ...] = (1.0, 2.0, 4.0, 8.0, 16.0)) -> Metrics:
    """TAP-Vid-style delta_avg (position accuracy at pixel thresholds over
    visible points), average Jaccard and occlusion accuracy. Without a
    visibility estimate every point counts as predicted visible, without
    ground-truth visibility or validity as visible or valid. As in the JAX
    package, a Jaccard false positive is counted over `valid`, not over
    the visible valid points (l4p_tpu/metrics.py:98)."""
    err = torch.sqrt(((pred_traj_bn2t.float() - gt_traj_bn2t.float()) ** 2).sum(2, keepdim=True))
    gt_vis = torch.ones_like(err, dtype=torch.bool) if gt_vis_bn1t is None else gt_vis_bn1t > 0.5
    pred_vis = torch.ones_like(gt_vis) if pred_vis_bn1t is None else pred_vis_bn1t > 0.0
    valid = torch.ones_like(gt_vis) if valid_bn1t is None else valid_bn1t > 0
    eval_pts = gt_vis & valid
    deltas, jaccards = [], []
    for thr in thresholds:
        within = err < thr
        deltas.append(_masked_mean(within.float(), eval_pts))
        tp = (within & pred_vis & eval_pts).sum()
        fp = (pred_vis & (~within | ~gt_vis) & valid).sum()
        fn = (eval_pts & (~within | ~pred_vis)).sum()
        jaccards.append(tp.float() / torch.clamp(tp + fp + fn, min=1).float())
    return {"track/delta_avg": torch.stack(deltas).mean(), "track/aj": torch.stack(jaccards).mean(),
            "track/occ_acc": _masked_mean(((pred_vis == gt_vis) & valid).float(), valid)}


def pose_metrics(pred_pose_b16t: torch.Tensor, gt_pose_b16t: torch.Tensor) -> Metrics:
    """Rotation geodesic error (degrees) and translation RMSE of two pose
    trajectories (B, 16, T), each made relative to its first frame."""
    b, t = pred_pose_b16t.shape[0], pred_pose_b16t.shape[-1]
    p = pred_pose_b16t.reshape(b, 4, 4, t).permute(0, 3, 1, 2).float()
    g = gt_pose_b16t.reshape(b, 4, 4, t).permute(0, 3, 1, 2).float()
    p = torch.linalg.inv(p[:, :1]) @ p
    g = torch.linalg.inv(g[:, :1]) @ g
    r_rel = p[..., :3, :3].transpose(-1, -2) @ g[..., :3, :3]
    tr = r_rel.diagonal(dim1=-2, dim2=-1).sum(-1)
    ang = torch.rad2deg(torch.arccos(torch.clamp((tr - 1) / 2, -1, 1)))
    t_err = torch.sqrt(((p[..., :3, 3] - g[..., :3, 3]) ** 2).sum(-1))
    return {"pose/rot_deg": ang.mean(), "pose/trans_rmse": torch.sqrt((t_err ** 2).mean())}


def l4p_metrics(batch: Mapping[str, torch.Tensor], out: Mapping[str, torch.Tensor],
                metadata: Optional[Dict] = None) -> Tuple[Metrics, Dict]:
    """Every metric the batch has ground truth for (l4p_tpu/metrics.py:
    124-146). Batch entries may be numpy arrays; they are read on the
    outputs' device. The ground-truth pose is inv(extrinsics), flattened
    row-major to (B, 16, T)."""
    dev = next(iter(out.values())).device if out else None

    def get(key: str) -> Optional[torch.Tensor]:
        v = batch.get(key)
        return None if v is None else torch.as_tensor(v, device=dev)

    m: Metrics = {}
    if "depth_est_b1thw" in out and "depth_b1thw" in batch:
        m.update(depth_metrics(out["depth_est_b1thw"], get("depth_b1thw"), get("depth_valid_b1thw")))
    if "flow_2d_backward_est_b2thw" in out and "flow_2d_backward_b2thw" in batch:
        m.update(flow_metrics(out["flow_2d_backward_est_b2thw"], get("flow_2d_backward_b2thw"),
                              get("flow_2d_backward_valid_b2thw")))
    if "dyn_mask_est_b1thw" in out and "dyn_mask_b1thw" in batch:
        m.update(dyn_mask_metrics(out["dyn_mask_est_b1thw"], get("dyn_mask_b1thw"), get("dyn_mask_valid_b1thw")))
    if "track_2d_traj_est_bn2t" in out and "track_2d_traj_bn2t" in batch:
        m.update(track_metrics(out["track_2d_traj_est_bn2t"], out.get("track_2d_vis_est_bn1t"),
                               get("track_2d_traj_bn2t"), get("track_2d_vis_bn1t"), get("track_2d_valid_bn1t")))
    if "traj3d_est_b16t" in out and "extrinsics_b44t" in batch:
        ext = get("extrinsics_b44t")
        gt_pose = torch.linalg.inv(ext.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).reshape(-1, 16, ext.shape[-1])
        m.update(pose_metrics(out["traj3d_est_b16t"], gt_pose))
    return m, {}
