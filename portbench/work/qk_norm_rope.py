"""The bytes one call of the port's attention prologue (q/k LayerNorm, 2D
RoPE and the q/k/v layout, `l4p_tpu_torch/ops/qk_norm_rope.py`) moves, from
the attributes of the program's `qk_norm_rope` span: q, k and v read once
from the QKV product and written once, the four norm vectors where it
norms, and the one-frame cos / sin table (fp32) where it rotates. Its FLOPs
(~12 an element of q and k, on the fp32 units) are left out: at 3.35 TB/s
the bytes take ~10x longer than they would at the fp32 peak."""

from __future__ import annotations

from typing import Any, Dict


def moved(attrs: Dict[str, Any]) -> int:
    d, e = attrs["head_dim"], attrs["itemsize"]
    qkv = 3 * attrs["tokens"] * attrs["heads"] * d * e
    norms = 4 * d * e if attrs["norm"] else 0
    return 2 * qkv + norms + 2 * attrs["table_rows"] * d * 4
