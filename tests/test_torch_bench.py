"""bench.py's port (l4p_tpu_torch.bench) and its FLOP counts
(l4p_tpu_torch.utils.flops) against the JAX package, on the CPU: the counts
equal l4p_tpu.utils.flops's for every stage, the request holds bench.py's
bytes, the measuring function prints bench.py's keys (no `mfu` off a known
card), and the command line with no card prints bench.py's error line."""

import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import l4p_tpu_torch.config as PC
from l4p_tpu_torch import bench
from l4p_tpu_torch.utils import flops as PF

torch.set_num_threads(1)

POINTS = {"configs/model.yaml": [(192, 128), (48, 64), (48, 200), (16, 1)],
          "configs/model_tiny.yaml": [(8, 5), (12, 16), (4, 40)]}


@pytest.mark.parametrize("path,frames,queries", [(p, f, q) for p, pts in POINTS.items() for f, q in pts])
def test_flop_counts_equal_the_jax_counts(path, frames, queries):
    """Every stage (encoder, each dense head, track, total), with the track
    head's chunk set to the point's queries as bench.py sets it, and at a
    chunk of 128 under 200 queries (a padded second chunk)."""
    from l4p_tpu.config import load_model_config
    from l4p_tpu.utils import flops as JF

    jcfg, tasks = load_model_config(path)
    pcfg, _ = PC.load_model_config(path)
    for chunk in (queries, 128):
        jc = dataclasses.replace(jcfg, track=dataclasses.replace(jcfg.track, max_queries=chunk))
        pc = dataclasses.replace(pcfg, track=dataclasses.replace(pcfg.track, max_queries=chunk))
        want = JF.alltask_video_flops(jc, tasks, frames, queries)
        got = PF.alltask_video_flops(pc, tasks, frames, queries)
        assert got == want and set(got) >= {"encoder", "track", "total", "dense/camray"}


def test_device_peak_flops_is_none_off_a_known_card():
    assert PF.device_peak_flops("cpu") is None
    assert PF.device_peak_flops(torch.device("cpu")) is None
    assert PF.mfu(1e12, 1.0, None) is None and PF.mfu(1e12, 2.0, 1e12) == 0.5


@pytest.mark.parametrize("u8", [True, False])
def test_request_holds_bench_py_bytes(monkeypatch, u8):
    """bench.py's own _measure_point builds the request; its forward is
    replaced by one that keeps the data and stops."""
    import importlib.util

    import l4p_tpu.config
    import l4p_tpu.inference

    spec = importlib.util.spec_from_file_location("bench_jax", "bench.py")
    bench_jax = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_jax)
    seen = {}

    class Stop(Exception):
        pass

    def forward(params, data):
        seen.update({k: np.asarray(v) for k, v in data.items()})
        raise Stop

    monkeypatch.setattr(l4p_tpu.config, "init_l4p_params", lambda *a, **k: {})
    monkeypatch.setattr(l4p_tpu.inference, "get_forward_fn", lambda cfg, tasks: forward)
    tasks = "flow_2d_backward,track_2d,depth,dyn_mask,camray"
    with pytest.raises(Stop):
        bench_jax._measure_point(types.SimpleNamespace(tasks=tasks, u8_ingest=u8, iters=1), 16, 8, {})
    cfg, _ = PC.load_model_config("configs/model.yaml")
    ours = bench.bench_request(cfg, tasks.split(","), 16, 8, u8)
    assert set(ours) == set(seen)
    for k, v in seen.items():
        if k == "rgb_b3thw":  # bench.py rounds the normal draws to bf16 on the host, the port on the device
            assert np.array_equal(torch.from_numpy(ours[k]).bfloat16().float().numpy(), v.astype(np.float32))
        else:
            assert ours[k].dtype == v.dtype and np.array_equal(ours[k], v), k


def test_measure_point_prints_bench_py_keys_on_the_cpu():
    """At the tiny config: bench.py's line and detail keys, its FLOP count,
    and no mfu (the CPU has no peak in utils.flops)."""
    cfg, tasks = PC.load_model_config("configs/model_tiny.yaml")
    out = bench.measure_point(cfg, tasks, 8, 5, "cpu", iters=1)
    json.dumps(out)
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert out["metric"] == "all_task_fps_per_chip_8f_5q" and out["unit"] == "fps" and out["value"] > 0
    d = out["detail"]
    assert set(d) == {"frames", "seconds_per_video", "compile_seconds", "tasks", "device", "model_tflops_per_video"}
    assert d["device"] == "cpu" and d["tasks"] == list(tasks)
    cfg5 = dataclasses.replace(cfg, track=dataclasses.replace(cfg.track, max_queries=5))
    assert d["model_tflops_per_video"] == round(PF.alltask_video_flops(cfg5, tasks, 8, 5)["total"] / 1e12, 2)


def test_command_line_without_a_card_prints_the_error_line():
    proc = subprocess.run([sys.executable, "-m", "l4p_tpu_torch.bench", "--frames", "16", "--iters", "1"],
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 1, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["metric"] == "all_task_fps_per_chip" and line["value"] == 0.0 and line["vs_baseline"] == 0.0
    assert "torch.cuda.is_available() is false" in line["error"] and "traceback_tail" in line
