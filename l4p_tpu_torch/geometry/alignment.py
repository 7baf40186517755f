"""Scale/shift aligners for window overlaps (counterpart of
l4p_tpu/geometry/alignment.py:29-84; reference aligner.py:29-118).
The Sim(3) RANSAC aligner comes with the camray slice."""

from __future__ import annotations

import torch

from l4p_tpu_torch.ops.misc import safe_inverse


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
