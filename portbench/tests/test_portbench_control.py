"""The comparison that decides `correct` fails where it should, at a tiny
size on the CPU: the control (the reference computed a precision lower)
fails a cell's limits, and a run whose timed path is broken underneath
(an answer altered where it is produced, a track step that leaves its
state as it was, an answer that never comes, an answer that is not
finite) comes out not correct. The cells' limits
are the benchmark's own (limits/<cell>.json)."""

import time

import pytest
import torch

from portbench import manifest as mf
from portbench import run
from portbench.calibrate import readings
from portbench.tests import tiny

CELL = "l4p_g-nocam-96f-128q"  # the benchmark's cell, whose limits every tiny cell is held to
LIMITS_OF = {"tiny-all": CELL, "tiny-nocam": CELL, "tiny-dense": CELL}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.write(tmp_path_factory.mktemp("tiny"))


def limits(cell):
    return mf.Manifest.load().limits(LIMITS_OF[cell])


def failing(numbers, lim):
    return sorted(k for k, v in numbers.items() if lim.get(k) is not None and not v <= lim[k])


@pytest.mark.parametrize("cell", sorted(LIMITS_OF))
def test_the_control_is_not_correct(bench, cell):
    got = readings(bench, cell, 3, True, "cpu", torch.bfloat16)
    assert failing(got["control"], limits(cell)), got["control"]


def scaled(fn, factor, key=None):
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs)
        if isinstance(out, dict):
            return {k: (v * factor if (key is None or key in k) and v.is_floating_point() else v)
                    for k, v in out.items()}
        if isinstance(out, tuple):
            return tuple(v * factor for v in out)
        return out * factor
    return broken


def run_broken(bench, cell, monkeypatch, patches):
    for owner, name, make in patches:
        monkeypatch.setattr(owner, name, make(getattr(owner, name)))
    return run.run_cell(bench, cell, 5, 3.0, False, "cpu", time.perf_counter(), limits=limits(cell))


def test_the_sound_run_is_correct(bench):
    out = run.run_cell(bench, "tiny-all", 5, 3.0, False, "cpu", time.perf_counter(), limits=limits("tiny-all"))
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("what", ["dense", "camera", "track"])
def test_an_answer_altered_where_it_is_produced(bench, monkeypatch, what):
    import l4p_tpu_torch.inference as inference

    name = {"dense": "run_dense_head", "camera": "camray_windows_to_cameras", "track": "run_track_chunked"}[what]
    out = run_broken(bench, "tiny-all", monkeypatch, [(inference, name, lambda f: scaled(f, 1.5))])
    assert not out["correct"], out["checks"]


def test_a_track_step_that_leaves_its_state_as_it_was(bench, monkeypatch):
    import l4p_tpu_torch.models.track as track

    def stale(step):
        def broken(head, cfg, carry, *args):
            _, emit = step(head, cfg, carry, *args)
            return carry, emit
        return broken

    out = run_broken(bench, "tiny-all", monkeypatch, [(track, "track_window_step", stale)])
    assert not out["correct"], out["checks"]


def test_an_answer_that_never_comes_is_not_correct(bench, monkeypatch):
    import l4p_tpu_torch.inference as inference

    def raising(f):
        def broken(*args, **kwargs):
            raise RuntimeError("the stage failed")
        return broken

    # set-up's warm requests run first, unbroken; the window's requests raise
    cell = mf.driver("offline").Cell
    original = cell.window

    def window(self, seconds):
        monkeypatch.setattr(inference, "stitch_dense_outputs", raising(None))
        return original(self, seconds)

    monkeypatch.setattr(cell, "window", window)
    out = run.run_cell(bench, "tiny-all", 5, 1.0, False, "cpu", time.perf_counter(), limits=limits("tiny-all"))
    assert not out["correct"] and out["failed"] == out["attempted"] > 0


@pytest.mark.parametrize("cell", sorted(LIMITS_OF))
def test_an_answer_that_is_not_finite_is_not_correct(bench, monkeypatch, cell):
    # the window's first request, which is not compared, answers nan depth; the compared requests are
    # sound, so only the count of failed requests makes the run not correct
    import l4p_tpu_torch.inference as inference

    driver = mf.driver("offline").Cell
    window = driver.window

    def nan_first_request(self, seconds):
        self.sample = [i + 1 for i in self.sample]
        stitch, calls = inference.stitch_dense_outputs, []

        def broken(*args, **kwargs):
            out = stitch(*args, **kwargs)
            calls.append(1)
            return {k: v * float("nan") if "depth" in k else v for k, v in out.items()} if len(calls) == 1 else out

        monkeypatch.setattr(inference, "stitch_dense_outputs", broken)
        return window(self, 0.0)

    monkeypatch.setattr(driver, "window", nan_first_request)
    out = run.run_cell(bench, cell, 5, 0.0, False, "cpu", time.perf_counter(), limits=limits(cell))
    assert not out["correct"] and out["failed"] == 1 and out["attempted"] >= 2
    assert all(c["value"] <= c["limit"] for k, c in out["checks"].items() if k != "failed"), out["checks"]
