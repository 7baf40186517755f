"""The traced slice: spans recorded from the harness's own files around the
calls into the program's layers, a torch.profiler trace of a bounded steady
slice, and the reduction of that trace to device time per span.

A span is a `torch.profiler.record_function` range named `pb:<name>` that
the harness opens around a call it wraps (`Spans.patch`, `Spans.wrap`).
A device operation (kernel, copy, memset) belongs to every span whose host
interval holds the host call that launched it, matched by the profiler's
launch-to-kernel correlation id, so a span's device time counts whatever
kernel its calls launch, under any name, and a kernel launched by the
autograd engine's thread during a span counts in it too.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import json
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

PREFIX = "pb:"
SLICE = "slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class MissingEntry(RuntimeError):
    """A name the harness wraps is gone from the program."""


def _spec(x) -> Optional[Tuple[Tuple[int, ...], int]]:
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.element_size()
    return None


def _flat(out) -> List:
    return list(out) if isinstance(out, (tuple, list)) else [out]


class Spans:
    """Wrappers that record a span and, for an op, each call's shapes."""

    def __init__(self):
        self.calls: collections.Counter = collections.Counter()
        self.op_calls: Dict[str, List[Dict[str, Any]]] = collections.defaultdict(list)
        self._undo: List[Callable[[], None]] = []

    def wrap(self, name: str, fn: Callable, op: bool = False) -> Callable:
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(PREFIX + name):
                out = fn(*args, **kwargs)
            self.calls[name] += 1
            if op:
                self.op_calls[name].append({"args": [_spec(a) for a in args],
                                            "outs": [_spec(o) for o in _flat(out)]})
            return out

        return wrapped

    def patch(self, owner, attr: str, name: Optional[str] = None, op: bool = False) -> None:
        """Replaces owner.attr (a module's function or an object's method)
        by its wrapper until `restore`."""
        if not hasattr(owner, attr):
            raise MissingEntry(f"{getattr(owner, '__name__', type(owner).__name__)}.{attr} no longer exists")
        original = getattr(owner, attr)
        setattr(owner, attr, self.wrap(name or attr, original, op))
        self._undo.append(lambda: setattr(owner, attr, original))

    def restore(self) -> None:
        while self._undo:
            self._undo.pop()()


@contextlib.contextmanager
def profiled(device: torch.device):
    """Profiles the block as one `pb:slice` span ending in a synchronize;
    yields a dict that holds, after the block, the trace's events."""
    box: Dict[str, Any] = {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(PREFIX + SLICE):
            yield box
            torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")  # under TMPDIR
    os.close(fd)
    try:
        t0 = time.perf_counter()
        prof.export_chrome_trace(path)
        box["trace_bytes"] = os.path.getsize(path)
        with open(path) as f:
            box["events"] = json.load(f)["traceEvents"]
        box["export_s"] = time.perf_counter() - t0
    finally:
        os.remove(path)


class Reduced:
    """What one profiled slice says: device seconds per span, the slice's
    wall and busy time, and its breakdown."""

    def __init__(self, events: List[Dict[str, Any]]):
        spans = [e for e in events if e.get("ph") == "X" and str(e.get("name", "")).startswith(PREFIX)
                 and e.get("cat") == "user_annotation"]
        slices = [e for e in spans if e["name"] == PREFIX + SLICE]
        if len(slices) != 1:
            raise RuntimeError(f"the trace holds {len(slices)} slice spans, expected 1")
        s0 = float(slices[0]["ts"])
        s1 = s0 + float(slices[0]["dur"])
        launch = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"):
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launch[corr] = float(e["ts"])
        dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        if not any(e.get("cat") == "kernel" for e in dev):
            raise RuntimeError("the profiler recorded no kernel on the device")
        self.window_s = (s1 - s0) * 1e-6
        ivs = sorted((max(float(e["ts"]), s0), min(float(e["ts"]) + float(e["dur"]), s1)) for e in dev)
        merged: List[List[float]] = []
        for a, b in ivs:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) * 1e-6
        by_name: Dict[str, float] = collections.defaultdict(float)
        for e in dev:
            by_name[str(e.get("name"))] += float(e["dur"]) * 1e-6
        self.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

        # device seconds per span name, through the launching call's time
        launches = sorted((launch[c], float(e["dur"])) for e in dev
                          if (c := (e.get("args") or {}).get("correlation")) in launch)
        times = [t for t, _ in launches]
        cum = [0.0]
        for _, d in launches:
            cum.append(cum[-1] + d)
        self.span_device_s: Dict[str, float] = collections.defaultdict(float)
        self.span_count: collections.Counter = collections.Counter()
        named = []
        for e in spans:
            name = e["name"][len(PREFIX):]
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            lo, hi = bisect.bisect_left(times, a), bisect.bisect_left(times, b)
            self.span_device_s[name] += (cum[hi] - cum[lo]) * 1e-6
            self.span_count[name] += 1
            if name != SLICE:
                named.append((a, b, name))
        self.unattributed_s = sum(float(e["dur"]) for e in dev
                                  if (e.get("args") or {}).get("correlation") not in launch) * 1e-6

        # idle gaps, each named by the innermost span that holds its middle on the host
        gaps = [(merged[i + 1][0] - merged[i][1], (merged[i + 1][0] + merged[i][1]) / 2)
                for i in range(len(merged) - 1)]
        if merged:
            gaps += [(merged[0][0] - s0, (merged[0][0] + s0) / 2), (s1 - merged[-1][1], (s1 + merged[-1][1]) / 2)]
        gaps.sort(reverse=True)
        self.idle_gaps = []
        for g, mid in gaps[:10]:
            inside = [(b - a, n) for a, b, n in named if a <= mid < b]
            self.idle_gaps.append([min(inside)[1] if inside else "between spans", g * 1e-6])

    def device_s(self, *names: str) -> float:
        return sum(self.span_device_s.get(n, 0.0) for n in names)
