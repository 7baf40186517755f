"""One run of one cell: set-up, the measured window, on `--trace 1` the
traced slice, then the comparison with the plain reference; prints the
result as the last line of standard output.

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, printing no result, where there is no CUDA card or fewer
than the cell asks for, where the program cannot be imported, and where
the process has loaded JAX or the JAX package by the time the window has
closed. `run_cell` is the same run on a device the caller names, without
the look for a card: the harness's CPU tests drive it at a tiny size.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

from portbench import manifest as mf

BANNED = ("jax", "jaxlib", "flax", "l4p_tpu")
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions", "CUDA_CACHE_PATH": "cuda"}


@dataclass
class Context:
    """What a driver is given: the cell, its files, the seed and the device."""

    cell: Dict[str, Any]
    traffic: Dict[str, Any]
    config_path: Path
    limits: Optional[Dict[str, float]]
    seed: int
    seconds: float
    trace: bool
    device: Any
    dtype: Any = None  # the configuration's dtype unless a test overrides it
    start: float = 0.0  # the process's start on time.perf_counter()

    def log(self, msg: str) -> None:
        print(f"[portbench] {msg}", file=sys.stderr, flush=True)

    def mark(self, phase: str) -> None:
        mark(self.start, phase)


def mark(start: float, phase: str) -> None:
    """Logs the seconds since the process started, at the end of a phase of
    set-up."""
    print(f"[portbench] set-up: {phase} done at {time.perf_counter() - start:.3f} s", file=sys.stderr, flush=True)


@dataclass
class Window:
    """The measured window's raw result."""

    attempted: int
    failed: int  # raised, or returned values that are not finite
    seconds: float
    end_to_end: Dict[str, float]
    flops: float = 0.0  # analytic FLOPs of the work completed


@dataclass
class TracedRun:
    """What the per-layer readers read (layers/*.py)."""

    spans: Any
    reduced: Any
    slice_units: int
    card: str
    window_s: float
    window_flops: float


def banned_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(BANNED))


def fixed_cache_dirs(root: Path) -> None:
    """Every kernel cache a library may keep goes to a fixed directory inside
    the checkout, so that only a cell's first run there builds."""
    for var, sub in CACHE_DIRS.items():
        path = root / "portbench_cache" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(bench: mf.Manifest, workload: str, seed: int, seconds: float, trace: bool, device,
             start: float, dtype=None, limits: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """Runs the cell on `device` and returns the result line as a dict, with
    its checks under `checks` (each {"value", "limit"}), last."""
    import torch

    cell = bench.cell(workload)
    traffic = bench.traffic(cell["traffic"])
    ctx = Context(cell, traffic, bench.config_path(cell["config"]),
                  bench.limits(workload) if limits is None else limits, seed, seconds, trace,
                  torch.device(device), dtype, start)
    if ctx.device.type == "cuda":
        torch.empty(1, device=ctx.device)  # the card's context
    ctx.mark("the card's context")
    drv = mf.driver(traffic["driver"])
    served = drv.Cell(ctx)
    setup_s = time.perf_counter() - start
    win = served.window(seconds)
    on_card = ctx.device.type == "cuda"
    mem_peak = torch.cuda.max_memory_allocated(ctx.device) if on_card else 0
    metrics: Dict[str, Dict[str, Any]] = {}
    device_rec: Dict[str, Any] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(ctx.device) if on_card else "cpu",
        "count": cell["chips"] if on_card else 1,
        "memory_peak_bytes": int(mem_peak),
    }
    breakdown = None
    values = dict(win.end_to_end, setup_s=setup_s)
    if trace:
        spans, reduced, units = served.traced_slice()
        run = TracedRun(spans, reduced, units, device_rec["kind"], win.seconds, win.flops)
        for m in bench.per_layer(workload):
            v = mf.reader(m["name"])(m["name"], run)
            if v is None:
                ctx.log(f"{m['name']}: nothing to read")
            else:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_rec.update(busy_s=reduced.busy_s, window_s=reduced.window_s)
        breakdown = {"device_ops": [list(x) for x in reduced.device_ops], "idle_gaps": reduced.idle_gaps}
        ctx.log(f"traced slice: {units} units, {reduced.window_s:.4f} s, busy {reduced.busy_s:.4f} s, "
                f"unattributed device time {reduced.unattributed_s:.6f} s")
    else:
        for m in bench.end_to_end(workload):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    found = banned_modules()
    if found:
        raise RuntimeError(f"the process has loaded {found} by the time the window closed")
    # `correct`: no request failed (raised, or answered with a value that is not finite), and every
    # number compared with the reference lies within its limit
    checks = {"failed": {"value": float(win.failed), "limit": 0.0}, **served.check()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    out: Dict[str, Any] = {"correct": correct, "attempted": win.attempted, "failed": win.failed,
                           "metrics": metrics, "device": device_rec}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["power_limit"] = power_limit() if on_card else "cpu"
    out["checks"] = checks
    return out


def main(argv=None, start: Optional[float] = None) -> int:
    start = time.perf_counter() if start is None else start
    ap = argparse.ArgumentParser(prog="python3 -m portbench", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fixed_cache_dirs(mf.ROOT)
    import torch

    mark(start, "import torch")
    try:
        bench = mf.Manifest.load()
        chips = bench.cell(args.workload)["chips"]
    except (OSError, KeyError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s), this machine has {n}", file=sys.stderr)
        return 2
    try:
        import l4p_tpu_torch  # noqa: F401 - the program under test
    except ImportError as e:
        print(f"portbench: the program l4p_tpu_torch cannot be imported: {e}", file=sys.stderr)
        return 2
    mark(start, "import l4p_tpu_torch")
    try:
        out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", start)
    except Exception:  # noqa: BLE001 - a failed run prints why and no result
        traceback.print_exc()
        return 1
    print(f"correct: {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():  # the last lines of standard error: each number and its limit
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0
