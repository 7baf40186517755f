"""The work of one call of each hand-written kernel of the port, from the
shapes the call was given: the FLOPs its algorithm needs and the bytes it
moves when each input is read once and each output written once (frozen
from chip_smoke.py's `nbytes` and per-kernel counts). The count is the
algorithm's at those shapes, not what a kernel does, so it reads the same
whatever implements the op.

A call is recorded as {"args": [...], "outs": [...]}, each entry the
(shape, bytes per element) of a tensor or None for anything else.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple


def nbytes(specs: Sequence) -> int:
    return sum(math.prod(s) * e for s, e in (x for x in specs if x is not None))


def moved(call: Dict) -> int:
    return nbytes(call["args"]) + nbytes(call["outs"])


def attention(call: Dict) -> Tuple[float, float]:
    """softmax(q k^T) v: q (B, H, Nq, D), k and v (B, H, Nk, D)."""
    (q, _), (k, _) = call["args"][0], call["args"][1]
    b, h, nq, d = q
    return 4.0 * b * h * nq * k[2] * d, moved(call)


def t2i(call: Dict) -> Tuple[float, float]:
    """keys (N, P, C), st (N, C, K): the logits and the weighted sum."""
    (keys, _), (st, _) = call["args"][0], call["args"][1]
    n, p, c = keys
    return 4.0 * n * p * c * st[2], moved(call)


def i2t(call: Dict) -> Tuple[float, float]:
    """keys (N, P, C), r (N, C, K), ..., st (N, C, K2): the image-to-token
    logits and product, then the next layer's t2i on the new keys."""
    args = call["args"]
    n, p, c = args[0][0]
    k, k2 = args[1][0][2], args[7][0][2]
    return 4.0 * n * p * c * k + 4.0 * n * p * c * k2, moved(call)


def upscale(call: Dict) -> Tuple[float, float]:
    """src (N, P, C), w1 (C, d1, kernel1), w2 (d1, d2, kernel2), hyper (N, M,
    d2): two deconvolutions as products over their offsets, then the
    hypernetwork dots."""
    args = call["args"]
    n, p, c = args[0][0]
    w1, w2, hyper = args[1][0], args[5][0], args[7][0]
    d1, k1 = w1[1], math.prod(w1[2:])
    d2, k2 = w2[1], math.prod(w2[2:])
    m = hyper[1]
    return 2.0 * n * p * k1 * (c * d1 + k2 * d1 * d2) + 2.0 * n * m * p * k1 * k2 * d2, moved(call)


WORK = {"attention": attention, "t2i": t2i, "i2t": i2t, "upscale": upscale}
