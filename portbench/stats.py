"""The statistics the harness reports, and the seeds of a run's streams."""

from __future__ import annotations

import hashlib


def rate(units: float, seconds: float) -> float:
    """Work completed over the whole window's time, stalls included."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return units / seconds


def derive_seed(seed: int, *labels) -> int:
    """A 63-bit seed for one stream of the run (weights, a request, the
    draws), the same for the same seed and labels on every machine."""
    h = hashlib.sha256(repr((int(seed), *labels)).encode()).digest()
    return int.from_bytes(h[:8], "little") & (2 ** 63 - 1)
