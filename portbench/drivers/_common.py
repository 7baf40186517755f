"""What the drivers share: the dtype names of the configurations, the
reference's precision settings and the comparison's numbers."""

from __future__ import annotations

import gc
import math
from typing import Dict, Iterable

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(ctx, config: Dict) -> torch.dtype:
    return ctx.dtype or DTYPES[config["dtype"]]


def plain_fp32() -> None:
    """The reference's products in fp32 proper: TF32 off for matmuls and
    convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def rel_l2(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """||prog - ref|| / ||ref|| over every element, in float64."""
    p, r = prog.detach().double(), ref.detach().double().to(prog.device)
    if p.shape != r.shape:
        raise ValueError(f"shape {tuple(p.shape)} against the reference's {tuple(r.shape)}")
    den = r.norm().item()
    return (p - r).norm().item() / den if den > 0 else (0.0 if p.norm().item() == 0 else math.inf)


def rms_err(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The root mean square of prog - ref, in float64: for outputs whose own
    scale differs from seed to seed (flow, mask and visibility logits), where
    a relative error would follow the reference's scale."""
    p, r = prog.detach().double(), ref.detach().double().to(prog.device)
    if p.shape != r.shape:
        raise ValueError(f"shape {tuple(p.shape)} against the reference's {tuple(r.shape)}")
    return (p - r).square().mean().sqrt().item()


def all_finite(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """A device bool, without a synchronize: every value of every tensor finite."""
    flags = [torch.isfinite(t).all() for t in tensors if t.is_floating_point()]
    return torch.stack(flags).all() if flags else torch.ones((), dtype=torch.bool)


def worst(readings: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """Each number's largest reading; a NaN reading stays NaN."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            old = out.get(k, -math.inf)
            out[k] = v if math.isnan(v) or v > old else old
    return out


def nonfinite(tensors: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """{name: count of values that are not finite}, for the names that have any."""
    counts = {k: int((~torch.isfinite(v)).sum()) for k, v in tensors.items()
              if isinstance(v, torch.Tensor) and v.is_floating_point()}
    return {k: n for k, n in counts.items() if n}


def checks(numbers: Dict[str, float], limits) -> Dict[str, Dict[str, float]]:
    """Each number beside its limit; a number with no limit gets limit 0, and
    one whose limit is null (the control did not separate from the program
    on it) is not compared."""
    limits = limits or {}
    return {k: {"value": v, "limit": limits.get(k, 0.0)} for k, v in numbers.items() if
            limits.get(k, 0.0) is not None}
