"""The port's tracing: spans on the request path, a counter of the host's
blocking synchronisations, and a Chrome-trace exporter.

`span(name, **attrs)` records only while a `torch.profiler` session runs.
Otherwise it is one check and returns a shared no-op context: no record, no
event, no change to PyTorch's sync debug mode. While recording, a span
opens `record_function("l4p/<name>")`, so it lies in the profiler's trace
on one clock with the device's operations, and keeps its host interval
(`time.perf_counter_ns`), its parent, its request's number and, on CUDA, a
timing event on the current stream at enter and at exit. The outermost
open span is the request (its trace name carries the number:
`l4p/request#<n>`); once it closes, its record joins a ring of the last
`RING` requests, and `requests(n)` returns the last n, resolving their
events then, never inside a request.

On CUDA a request also counts every call that blocks the host on the card
(`host_syncs`): PyTorch's sync debug mode is "warn" while the request runs,
each "called a synchronizing CUDA operation" warning is charged to the
innermost open span under the program's `file:line` that made the call,
and the previous mode and warning filters come back when the request ends,
whether it returns or raises. Other warnings pass through unchanged. On
the CPU the count is None: there is nothing to block on.

Requests are recorded from one thread at a time, as the session serves
them. `trace(log_dir)` profiles a block and writes `trace.json` (Chrome)
and the block's requests as `requests.json`.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import time
import warnings
from typing import Any, Dict, List, Optional

import torch

RING = 64  # completed requests kept
SYNC_WARNING = "called a synchronizing CUDA operation"  # c10's text in sync debug mode "warn"
_THIS = os.path.abspath(__file__)
_PACKAGE = os.path.dirname(os.path.dirname(_THIS))  # l4p_tpu_torch/
_OFF = contextlib.nullcontext()


def _site(filename: str, lineno: int) -> str:
    """The innermost frame of the program on the stack, as `file:line`
    relative to the package's parent; the warning's own place if no frame
    of the program is there."""
    f = sys._getframe(2)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path.startswith(_PACKAGE + os.sep) and path != _THIS:
            return f"{os.path.relpath(path, os.path.dirname(_PACKAGE))}:{f.f_lineno}"
        f = f.f_back
    return f"{filename}:{lineno}"


class _Span:
    """A span while recording: the context `span` returns, and its record."""

    __slots__ = ("name", "device", "attrs", "index", "parent", "host_ns", "events", "sites", "scope")

    def __init__(self, name: str, device, attrs: Dict[str, Any]):
        self.name, self.device, self.attrs = name, device, attrs

    def __enter__(self):
        _RECORDER.enter(self)

    def __exit__(self, *exc):
        _RECORDER.exit(self)
        return False


class _Request:
    """One request being recorded: its spans in the order they opened, the
    stack of those open, and on CUDA the sync watch."""

    def __init__(self, number: int, device: Optional[torch.device]):
        self.number, self.device = number, device
        self.cuda = device is not None and device.type == "cuda"
        self.spans: List[_Span] = []
        self.stack: List[_Span] = []
        self.record: Optional[Dict[str, Any]] = None  # resolved once read
        self._caught = None
        self._mode = None

    def watch(self) -> None:
        """Sync debug mode "warn" and a hook that charges its warnings."""
        self._caught = warnings.catch_warnings()
        self._caught.__enter__()
        try:
            warnings.filterwarnings("always", message=SYNC_WARNING, category=UserWarning)
            shown = warnings.showwarning

            def showwarning(message, category, filename, lineno, file=None, line=None):
                if issubclass(category, UserWarning) and str(message).startswith(SYNC_WARNING):
                    self.stack[-1].sites[_site(filename, lineno)] += 1
                else:
                    shown(message, category, filename, lineno, file, line)

            warnings.showwarning = showwarning
            self._mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        except BaseException:
            self._caught.__exit__(*sys.exc_info())
            raise

    def unwatch(self) -> None:
        try:
            torch.cuda.set_sync_debug_mode(self._mode)
        finally:
            self._caught.__exit__(None, None, None)

    def resolve(self) -> Dict[str, Any]:
        if self.record is None:
            origin = None
            if self.cuda:
                origin = self.spans[0].events[0]
                self.spans[0].events[1].synchronize()
            spans = []
            for s in self.spans:
                spans.append({
                    "name": s.name, "attrs": s.attrs, "parent": s.parent, "request": self.number,
                    "host_ns": list(s.host_ns),
                    "device_ms": [origin.elapsed_time(e) for e in s.events] if self.cuda else None,
                    "syncs": sum(s.sites.values()) if self.cuda else None,
                    "sync_sites": dict(s.sites) if self.cuda else None,
                })
                s.events = None
            self.record = {"request": self.number, "device": str(self.device),
                           "host_syncs": sum(x["syncs"] for x in spans) if self.cuda else None, "spans": spans}
        return self.record


class Recorder:
    """The requests recorded in this process: the one open and the last
    `ring` completed."""

    def __init__(self, ring: int = RING):
        self.done: collections.deque = collections.deque(maxlen=ring)
        self.count = 0  # requests recorded so far; the last one's number
        self.open: Optional[_Request] = None

    def enter(self, s: _Span) -> None:
        req = self.open
        root = req is None
        if root:
            self.count += 1
            req = _Request(self.count, None if s.device is None else torch.device(s.device))
        s.index, s.parent = len(req.spans), req.stack[-1].index if req.stack else None
        s.host_ns = [time.perf_counter_ns(), 0]
        s.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) if req.cuda else None
        s.sites = collections.Counter() if req.cuda else None
        req.spans.append(s)
        req.stack.append(s)
        if root:
            if req.cuda:
                req.watch()  # the stack holds the root first: a sync always has a span to go to
            self.open = req
        s.scope = torch.autograd.profiler.record_function(f"l4p/{s.name}#{req.number}" if root else f"l4p/{s.name}")
        s.scope.__enter__()
        if req.cuda:
            s.events[0].record(torch.cuda.current_stream(req.device))

    def exit(self, s: _Span) -> None:
        req = self.open
        try:
            if req.cuda:
                s.events[1].record(torch.cuda.current_stream(req.device))
            s.scope.__exit__(None, None, None)
        finally:
            s.host_ns[1] = time.perf_counter_ns()
            s.scope = None
            if len(req.stack) == 1:
                self.open = None
                self.done.append(req)
                if req.cuda:
                    req.unwatch()
            req.stack.pop()

    def requests(self, n: int = RING) -> List[Dict[str, Any]]:
        return [r.resolve() for r in list(self.done)[-n:]] if n > 0 else []


_RECORDER = Recorder()


def span(name: str, device=None, **attrs):
    """A span of the request path, recorded while a profiler runs. `device`
    (the outermost span's) says where the request runs: a CUDA device gets
    timing events and the sync count. `attrs` are kept with the span."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, device, attrs)


def requests(n: int = RING) -> List[Dict[str, Any]]:
    """The last n completed requests recorded (at most RING), the oldest
    first: {"request", "device", "host_syncs", "spans"}, each span
    {"name", "attrs", "parent" (an index into "spans", None at the root),
    "request", "host_ns" [enter, exit] on perf_counter_ns, "device_ms"
    [enter, exit] from the request's first event (None off CUDA), "syncs"
    charged to the span itself and "sync_sites" {file:line: count} (None
    off CUDA)}. Reading CUDA records waits for their last event."""
    return _RECORDER.requests(n)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profiles the block with torch.profiler (CPU, and CUDA where available)
    and writes `<log_dir>/trace.json`, a Chrome trace, and
    `<log_dir>/requests.json`, the requests recorded in the block; yields the
    profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    before = _RECORDER.count
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "requests.json"), "w") as f:
        json.dump([r for r in requests() if r["request"] > before], f, indent=1)
