"""The work of one temporal attention call of Video Depth Anything's motion
modules (`l4p_tpu_torch/models/vda.py`), from the attributes of the
program's `vda/temporal_attention` span: softmax(q k^T) v over `frames`
frames at each of `positions` positions, `heads` heads of `head_dim`. Its
FLOPs are the two products, 4 x positions x heads x frames^2 x head_dim; its
bytes q, k and v read once and o written once."""

from __future__ import annotations

from typing import Any, Dict, Tuple


def work(attrs: Dict[str, Any]) -> Tuple[float, float]:
    """(FLOPs, bytes) of the call."""
    seqs, t, d = attrs["positions"] * attrs["heads"], attrs["frames"], attrs["head_dim"]
    return 4.0 * seqs * t * t * d, 4.0 * seqs * t * d * attrs["itemsize"]
