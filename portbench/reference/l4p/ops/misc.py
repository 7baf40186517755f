"""Activation dispatch and guarded reciprocal (l4p_tpu/ops/misc.py:13-36)."""

from __future__ import annotations

import torch


def apply_fn(x: torch.Tensor, fn_type: str = "linear") -> torch.Tensor:
    """Activation by name (reference l4p/utils/misc.py:11-38)."""
    if fn_type == "log":
        out = torch.log(x)
    elif fn_type == "exp":
        out = torch.exp(x)
    elif fn_type == "sigmoid":
        out = torch.sigmoid(x)
    elif fn_type == "linear":
        out = x
    elif fn_type == "inverse":
        out = _masked_inverse(x, x.abs() > 1e-8)
    else:
        raise NotImplementedError(f"apply_fn: unknown fn_type {fn_type!r}")
    return out.to(x.dtype)


def _masked_inverse(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(mask, 1.0 / torch.where(mask, x, one), torch.zeros_like(x))


def safe_inverse(x: torch.Tensor, keep_above: float = 0.0) -> torch.Tensor:
    """1/x where x > keep_above, else 0 (reference l4p/utils/misc.py:48-62)."""
    return _masked_inverse(x, x > keep_above)
