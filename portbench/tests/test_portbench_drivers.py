"""Each cell of the tiny benchmark end to end on the CPU at a tiny size, through
`run_cell` (the run without the look for a card), and the command itself,
which refuses to run without a card."""

import json
import subprocess
import sys
import time

import pytest

from portbench import run
from portbench.tests import tiny


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.write(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_driver_end_to_end(bench, cell):
    out = run.run_cell(bench, cell, 2 ** 31 + 11, 0.5, False, "cpu", time.perf_counter(), limits={})
    metric = tiny.CELLS[cell][2]
    assert set(out) == {"correct", "attempted", "failed", "metrics", "device", "power_limit", "checks"}
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {metric, "setup_s"}
    assert out["metrics"][metric]["value"] > 0 and out["metrics"]["setup_s"]["value"] > 0
    assert out["device"]["platform"] == "cpu"
    assert out["checks"] and all({"value", "limit"} == set(c) for c in out["checks"].values())
    json.dumps(out)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_fp32_program_equals_the_reference(bench, cell):
    # at fp32 the program's plain path and the reference compute the same
    out = run.run_cell(bench, cell, 7, 3.0, False, "cpu", time.perf_counter(), limits={})
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0.0 for c in out["checks"].values())


def test_the_same_seed_gives_the_same_requests(bench):
    from portbench.drivers.offline import Requests

    a, b = Requests(2 ** 33, 8, 5, (28, 28), 4, "cpu"), Requests(2 ** 33, 8, 5, (28, 28), 4, "cpu")
    for i in (0, 3):
        x, y = a(i), b(i)
        assert all(bool((x[k] == y[k]).all()) for k in x)
    assert not bool((a(0)["rgb_u8_bthw3"] == a(1)["rgb_u8_bthw3"]).all())
    q = a(0)["track_2d_pointquerries_bn3"]
    assert float(q[..., 1:].min()) >= 4 and float(q[..., 1:].max()) <= 24 and float(q[..., 0].max()) < 8


def test_the_command_refuses_without_a_card():
    proc = subprocess.run([sys.executable, "-m", "portbench", "--workload", "l4p_g-nocam-96f-128q", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=tiny.REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_the_command_refuses_without_the_program(tmp_path):
    import shutil

    shutil.copytree(tiny.REPO / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run([sys.executable, "-m", "portbench", "--workload", "l4p_g-nocam-96f-128q", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.gpu
def test_a_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, "-m", "portbench", "--workload", "l4p_g-nocam-96f-128q", "--seed", "5",
                           "--seconds", "3", "--trace", "0"], cwd=tiny.REPO, capture_output=True, text=True,
                          timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
