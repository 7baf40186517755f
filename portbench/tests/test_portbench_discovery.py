"""A configuration, a traffic mix, a cell and a per-layer metric are added
as new files and entries, in a copy of the benchmark, and found by name
with no file of the harness edited."""

import json
import shutil
import subprocess
import sys

from portbench.tests.tiny import REPO


def test_added_files_are_found(tmp_path):
    pkg = tmp_path / "portbench"
    shutil.copytree(REPO / "portbench", pkg, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(pkg): p.read_bytes() for p in pkg.rglob("*") if p.is_file()}
    (pkg / "configs" / "new_cfg.json").write_text(json.dumps({"source": "s", "reduced": [], "dtype": "bfloat16"}))
    (pkg / "traffic" / "new-mix.json").write_text(json.dumps({"driver": "offline", "frames": 48}))
    (pkg / "limits" / "new-cell.json").write_text(json.dumps({"limits": {"flow": 0.1}}))
    (pkg / "layers" / "newfamily.py").write_text("def read(metric, run):\n    return 42.0\n")
    bench = json.load(open(REPO / "BENCHMARK.json"))
    bench["configs"].append({"name": "new_cfg", "source": "s", "file": "portbench/configs/new_cfg.json",
                             "reduced": [], "why": "w"})
    bench["workloads"].append({"name": "new-cell", "config": "new_cfg", "traffic": "new-mix", "chips": 1, "why": "w"})
    bench["per_layer"].append({"name": "newfamily.offline", "unit": "%", "better": "higher", "source": "device_trace",
                               "layer": "new", "moves": "video_fps", "workloads": ["new-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("from portbench import manifest as mf\n"
            "b = mf.Manifest.load()\n"
            "c = b.cell('new-cell')\n"
            "print(b.traffic(c['traffic'])['frames'], b.config_path(c['config']).name, b.limits('new-cell')['flow'],"
            " mf.reader('newfamily.offline')('newfamily.offline', None), mf.driver('offline').__name__,"
            " [m['name'] for m in b.per_layer('new-cell')])")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, check=True,
                         env={"PYTHONPATH": str(tmp_path), "PATH": "/usr/bin:/bin"}, timeout=300).stdout.split()
    assert out[:5] == ["48", "new_cfg.json", "0.1", "42.0", "portbench.drivers.offline"]
    assert "'newfamily.offline']" in out[-1]
    after = {p.relative_to(pkg): p.read_bytes() for p in pkg.rglob("*") if p.is_file() and p.relative_to(pkg) in before}
    assert after == before  # no file that was there changed
