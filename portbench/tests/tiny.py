"""A tiny copy of the benchmark for the CPU tests: the package's files with
tiny configuration (configs/model_tiny.yaml's sizes), tiny traffic and
one cell per mix, written under a temporary directory."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import yaml

from portbench import manifest as mf

REPO = mf.ROOT
TASKS = ["flow_2d_backward", "track_2d", "depth", "dyn_mask", "camray"]


def l4p_tiny(dtype: str = "float32") -> dict:
    cfg = {"source": "configs/model_tiny.yaml", "reduced": [], "dtype": dtype}
    cfg.update(yaml.safe_load(open(REPO / "configs" / "model_tiny.yaml")))
    heads = cfg["init_args"]["l4p_model"]["init_args"]["task_heads"]["init_args"]["modules"]
    heads["track_2d"]["init_args"]["estimation_directions"] = [1]  # forward only, as the released config
    return cfg


TRAFFIC = {
    "tiny-all": {"driver": "offline", "frames": 8, "queries": 5, "tasks": TASKS, "query_margin_px": 4, "sample": 2,
                 "sample_from": 3, "slice_requests": 1},
    "tiny-nocam": {"driver": "offline", "frames": 8, "queries": 5, "tasks": [t for t in TASKS if t != "camray"],
                   "query_margin_px": 4, "sample": 2, "sample_from": 3, "slice_requests": 1},
    "tiny-dense": {"driver": "offline", "frames": 8, "queries": 0, "tasks": [t for t in TASKS if t != "track_2d"],
                   "query_margin_px": 4, "sample": 1, "sample_from": 2, "slice_requests": 1},
}
CELLS = {  # cell: (config, traffic, the end-to-end metric)
    "tiny-all": ("l4p_tiny", "tiny-all", "video_fps"),
    "tiny-nocam": ("l4p_tiny", "tiny-nocam", "video_fps"),
    "tiny-dense": ("l4p_tiny", "tiny-dense", "video_fps"),
}
UNITS = {"video_fps": "frames/s"}


def write(root: Path, dtype: str = "float32") -> mf.Manifest:
    """The tiny benchmark under root/; returns its manifest."""
    pkg = root / "portbench"
    shutil.copytree(mf.PACKAGE_DIR, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    (pkg / "configs" / "l4p_tiny.json").write_text(json.dumps(l4p_tiny(dtype)))
    for name, tr in TRAFFIC.items():
        (pkg / "traffic" / f"{name}.json").write_text(json.dumps(tr))
    bench = json.load(open(REPO / "BENCHMARK.json"))
    bench["configs"] = [{"name": n, "source": "x", "file": f"portbench/configs/{n}.json", "reduced": [], "why": "t"}
                        for n in ("l4p_tiny",)]
    bench["workloads"] = [{"name": c, "config": cf, "traffic": tr, "chips": 1, "why": "tiny"}
                          for c, (cf, tr, _) in CELLS.items()]
    bench["end_to_end"] = [{"name": m, "unit": UNITS[m], "better": "higher", "bound": 0.05, "source": "host_clock",
                            "workloads": [c for c, v in CELLS.items() if v[2] == m]} for m in UNITS]
    bench["end_to_end"].append({"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
                                "source": "host_clock"})
    bench["per_layer"] = []
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return mf.Manifest.load(root / "BENCHMARK.json", pkg)
