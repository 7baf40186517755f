"""The work of one attention call of SAM 2's memory attention
(`l4p_tpu_torch/models/sam2.py`), from the attributes of the program's
`sam2/memory_attention_call` span: softmax(q k^T) v of `batch` x `heads`
sequences, `queries` queries over `keys` keys, head dim `head_dim`. Its
FLOPs are the two products, 4 x batch x heads x queries x keys x head_dim;
its bytes q and o (queries rows each) and k and v (keys rows each), read or
written once."""

from __future__ import annotations

from typing import Any, Dict, Tuple


def work(attrs: Dict[str, Any]) -> Tuple[float, float]:
    """(FLOPs, bytes) of the call."""
    seqs, nq, nk, d = attrs["batch"] * attrs["heads"], attrs["queries"], attrs["keys"], attrs["head_dim"]
    return 4.0 * seqs * nq * nk * d, 2.0 * seqs * (nq + nk) * d * attrs["itemsize"]
