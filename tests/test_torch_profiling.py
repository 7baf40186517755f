"""The port's profiling utilities (l4p_tpu_torch/utils/profiling.py) against
the JAX package's (l4p_tpu/utils/profiling.py): PhaseTimer's counts and
report on one clock, `sync` on CPU tensors, `trace` writing a Chrome trace
with a named scope in it."""

import itertools
import json
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from l4p_tpu_torch.utils import profiling as PP

PHASES = ["encode", "decode", "encode", "loss", "encode", "decode"]


@pytest.mark.parametrize("result", ["tensors", "none"])
def test_phase_timer_report_matches_jax(monkeypatch, result):
    from l4p_tpu.utils import profiling as JP

    reports = []
    for profiling, tree in ((JP, {"a": jnp.ones(3), "b": [jnp.zeros((2, 2))]}),
                            (PP, {"a": torch.ones(3), "b": [torch.zeros((2, 2))]})):
        clock = itertools.count()
        # the module's own clock: JAX's dispatch reads time.time too
        monkeypatch.setattr(profiling, "time", types.SimpleNamespace(time=lambda: 0.125 * next(clock) ** 2))
        timer = profiling.PhaseTimer()
        for i, name in enumerate(PHASES):
            out = tree if result == "tensors" else None
            if i % 2:
                with timer.phase(name) as holder:
                    holder["out"] = out
            else:
                with timer.phase(name, out):
                    pass
        monkeypatch.undo()
        reports.append((timer.report(), dict(timer.counts), dict(timer.totals)))
    (ref, ref_counts, ref_totals), (got, counts, totals) = reports
    assert got == ref
    assert counts == ref_counts == {"encode": 3, "decode": 2, "loss": 1}
    assert list(json.loads(got)) == ["encode", "decode", "loss"]  # the longest total first
    for k, v in ref_totals.items():
        np.testing.assert_allclose(totals[k], v, rtol=1e-12)


def test_sync_waits_on_nested_cpu_tensors_and_ignores_the_rest():
    tree = {"a": torch.ones(2), "b": [torch.zeros(3), (torch.arange(4), "label")], "c": None, "d": 3.0}
    assert PP.sync(tree) is None
    assert PP.sync(None) is None
    assert [t.numel() for t in PP._tensors(tree)] == [2, 3, 4]


def test_trace_writes_a_chrome_trace_with_the_named_scope(tmp_path):
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    with PP.trace(str(tmp_path / "trace")) as prof:
        with PP.named_scope("mae_step"):
            y = (x @ x).relu().sum()
    assert prof is not None and torch.isfinite(y)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "mae_step" for e in events)
