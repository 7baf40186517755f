"""Tracing and profiling utilities (counterpart of l4p_tpu/utils/profiling.py).

`trace` captures a `torch.profiler` trace (the card's kernels when CUDA is
available) and writes it as a Chrome trace; `PhaseTimer` accumulates wall
time per phase, synchronising the devices its results lie on at each
phase's end; `named_scope` labels a region in the trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict

import torch

named_scope = torch.profiler.record_function  # a labelled range in the trace


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def sync(tree) -> None:
    """Waits for the work that computes the tensors of `tree` (nested dicts,
    lists and tuples): synchronises each CUDA device they lie on. CPU
    tensors are ready when they exist."""
    for device in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profiles the block with torch.profiler (CPU, and CUDA where available)
    and writes `<log_dir>/trace.json`, a Chrome trace; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class PhaseTimer:
    """Accumulating per-phase wall timers, synchronising at each boundary."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, result_tree=None):
        """Times the block; at its end synchronises `holder['out']` (set it in
        the block) or `result_tree`."""
        t0 = time.time()
        holder = {}
        try:
            yield holder
        finally:
            sync(holder.get("out", result_tree))
            dt = time.time() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        """{phase: {"total_s": seconds to 4 places, "n": count}} as JSON, the longest first."""
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        return json.dumps({k: {"total_s": round(v, 4), "n": self.counts[k]} for k, v in rows})
