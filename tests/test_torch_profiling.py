"""The port's tracing (l4p_tpu_torch/utils/profiling.py): spans that record
only under a profiler, the request's span tree on the tiny model, the span
names and request number in the Chrome trace and `requests.json`, the
host-sync counter's charging and sites (CUDA faked on the CPU: events on a
counter, the sync debug mode in a dict), the ring of 64, and the state a
request restores. The card test holds the counter against the trace's
synchronising runtime calls."""

import itertools
import json
import os
import sys
import warnings

import pytest
import torch

from l4p_tpu_torch import L4P, SLICE_TASKS, InferenceSession
from l4p_tpu_torch.ops.flash_attention import flash_attention_plain
from l4p_tpu_torch.utils import profiling as PP
from test_torch_gpu import tiny_cfg  # tests/ is on sys.path (pytest prepends it), with or without conftest.py

CPU = [torch.profiler.ProfilerActivity.CPU]
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def tiny_request(device, dtype=torch.float32, n=11, t=8):
    """The tiny model (tests/test_torch_gpu.py tiny_cfg) and a request of t
    frames (3 windows) and n queries (chunks of 8: two)."""
    cfg = tiny_cfg()
    g = torch.Generator(device=device).manual_seed(0)
    model = L4P(cfg, device=device, dtype=dtype).eval()
    model.init_weights(g)
    queries = torch.stack([torch.rand(n, generator=g, device=device) * t,
                           torch.rand(n, generator=g, device=device) * 28,
                           torch.rand(n, generator=g, device=device) * 28], -1)[None]
    data = {"rgb_u8_bthw3": torch.randint(0, 256, (1, t, 28, 28, 3), generator=g, device=device, dtype=torch.uint8),
            "track_2d_pointquerries_bn3": queries, "track_2d_pointlabels_bn": torch.ones((1, n), device=device)}
    return cfg, model, data


@pytest.fixture(scope="module")
def tiny():
    return tiny_request("cpu")


class FakeEvent:
    """A timing event whose time is the order it was recorded in, in ms."""

    clock = itertools.count()

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = next(FakeEvent.clock)

    def synchronize(self):
        assert self.t is not None

    def elapsed_time(self, end):
        return float(end.t - self.t)


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDA's events, stream and sync debug mode, faked; yields the mode."""
    mode = {"now": 0}
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode["now"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.__setitem__("now", {"default": 0, "warn": 1, "error": 2}.get(m, m)))
    return mode


@pytest.fixture
def recorder(monkeypatch):
    rec = PP.Recorder()
    monkeypatch.setattr(PP, "_RECORDER", rec)
    return rec


def test_without_a_profiler_a_span_is_one_check(monkeypatch, recorder, tiny):
    def refuse(*a, **k):
        raise AssertionError("touched CUDA with no profiler")

    for name in ("Event", "current_stream", "get_sync_debug_mode", "set_sync_debug_mode"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    filters = list(warnings.filters)
    assert not torch.autograd._profiler_enabled()
    assert PP.span("request", device="cuda", task="x") is PP.span("encode") is PP._OFF
    with PP.span("request", device="cuda"):
        with PP.span("encode"):
            pass
    cfg, model, data = tiny
    InferenceSession(cfg, SLICE_TASKS, "cpu")(model, data)
    assert recorder.count == 0 and PP.requests() == [] and recorder.open is None
    assert warnings.filters == filters


def test_a_profiled_request_records_its_span_tree(recorder, tiny):
    cfg, model, data = tiny
    with torch.profiler.profile(activities=CPU):
        InferenceSession(cfg, SLICE_TASKS, "cpu")(model, data)
    (req,) = PP.requests()
    assert req["request"] == 1 and req["device"] == "cpu" and req["host_syncs"] is None  # no count on the CPU
    spans = req["spans"]
    names = [s["name"] for s in spans]
    assert names[0] == "request" and spans[0]["parent"] is None
    assert names.count("encode") == 1 and names.count("stitch") == 1 and names.count("track") == 1
    assert "camera_solve" not in names
    assert sorted(s["attrs"]["task"] for s in spans if s["name"] == "dense_head") == sorted(
        ("flow_2d_backward", "depth", "dyn_mask"))
    track = names.index("track")
    windows = [s for s in spans if s["name"] == "track.window"]
    assert sorted((s["attrs"]["chunk"], s["attrs"]["window"]) for s in windows) == [(c, w) for c in (0, 1)
                                                                                     for w in range(3)]
    assert all(s["parent"] == track for s in windows)
    assert all(s["parent"] == 0 for s in spans if s["name"] in ("encode", "dense_head", "stitch", "track"))
    for s in spans:
        assert s["request"] == 1 and s["device_ms"] is None and s["syncs"] is None and s["sync_sites"] is None
        a, b = s["host_ns"]
        assert a <= b
        if s["parent"] is not None:
            pa, pb = spans[s["parent"]]["host_ns"]
            assert pa <= a and b <= pb
    json.dumps(req)


def test_the_chrome_trace_names_the_spans_and_the_request(recorder, tiny, tmp_path):
    cfg, model, data = tiny
    sess = InferenceSession(cfg, SLICE_TASKS, "cpu")
    with torch.profiler.profile(activities=CPU) as prof:
        sess(model, data)
        sess(model, data)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    names = [e["name"] for e in json.loads((tmp_path / "t.json").read_text())["traceEvents"]
             if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("l4p/")]
    assert sorted(n for n in names if n.startswith("l4p/request")) == ["l4p/request#1", "l4p/request#2"]
    for name in ("encode", "dense_head", "stitch", "track", "track.window"):
        assert names.count(f"l4p/{name}") == 2 * [s["name"] for s in PP.requests(1)[0]["spans"]].count(name)
    assert [r["request"] for r in PP.requests()] == [1, 2]


def test_a_sync_is_charged_to_the_innermost_span_with_its_site(fake_cuda, recorder, tiny):
    """Sync warnings from inside the program (the encoder's attention call)
    go to the `encode` span under the program's line; one from outside the
    program goes to the test's span under the test's line."""
    cfg, model, data = tiny
    sites = []

    def attention(*a):
        caller = sys._getframe(1)
        sites.append(f"{os.path.relpath(caller.f_code.co_filename, os.path.dirname(PP._PACKAGE))}:{caller.f_lineno}")
        warnings.warn(PP.SYNC_WARNING + " (Triggered internally)")
        return flash_attention_plain(*a)

    with torch.profiler.profile(activities=CPU):
        with PP.span("request", device="cuda"):
            assert fake_cuda["now"] == 1  # "warn" while the request runs
            InferenceSession(cfg, ("depth",), "cpu", attention=attention)(model, data)
            with PP.span("outside", kind="test"):
                line = sys._getframe().f_lineno + 1
                warnings.warn(PP.SYNC_WARNING)
    assert fake_cuda["now"] == 0
    (req,) = PP.requests()
    by_name = {s["name"]: s for s in req["spans"]}
    assert sites and all(s.startswith("l4p_tpu_torch/models/encoder.py:") for s in sites)
    assert by_name["encode"]["syncs"] == len(sites) and by_name["encode"]["sync_sites"] == {
        s: sites.count(s) for s in set(sites)}
    assert by_name["outside"]["sync_sites"] == {f"{__file__}:{line}": 1}
    assert req["host_syncs"] == len(sites) + 1
    assert sum(s["syncs"] for s in req["spans"] if s["name"] not in ("encode", "outside")) == 0
    # device intervals from the request's first event, each inside its parent's
    spans = req["spans"]
    assert spans[0]["device_ms"][0] == 0.0
    for s in spans[1:]:
        a, b = s["device_ms"]
        pa, pb = spans[s["parent"]]["device_ms"]
        assert pa < a < b < pb


def test_other_warnings_pass_through_unchanged(fake_cuda, recorder):
    with torch.profiler.profile(activities=CPU):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with PP.span("request", device="cuda"):
                warnings.warn("something else", DeprecationWarning)
                warnings.warn(PP.SYNC_WARNING)
    assert [(str(w.message), w.category) for w in caught] == [("something else", DeprecationWarning)]
    assert caught[0].filename == __file__
    assert PP.requests()[0]["host_syncs"] == 1


@pytest.mark.parametrize("ends", ["returns", "raises"])
def test_the_sync_mode_and_warning_filters_come_back(fake_cuda, recorder, ends):
    fake_cuda["now"] = 2  # "error", set by the caller
    filters, shown = list(warnings.filters), warnings.showwarning
    with torch.profiler.profile(activities=CPU):
        try:
            with PP.span("request", device="cuda"):
                with PP.span("encode"):
                    assert fake_cuda["now"] == 1 and warnings.showwarning is not shown
                    if ends == "raises":
                        raise KeyError("a stage failed")
        except KeyError:
            assert ends == "raises"
    assert fake_cuda["now"] == 2
    assert warnings.filters == filters and warnings.showwarning is shown
    assert recorder.open is None and [s["name"] for s in PP.requests()[0]["spans"]] == ["request", "encode"]


def test_the_ring_keeps_the_last_64_requests(recorder):
    with torch.profiler.profile(activities=CPU):
        for i in range(70):
            with PP.span("request", i=i):
                with PP.span("stage"):
                    pass
    got = PP.requests(100)
    assert len(got) == PP.RING == 64 and len(recorder.done) == 64
    assert [r["request"] for r in got] == list(range(7, 71))
    assert [r["spans"][0]["attrs"]["i"] for r in got] == list(range(6, 70))
    assert [r["request"] for r in PP.requests(2)] == [69, 70] and PP.requests(0) == []


def test_trace_writes_a_chrome_trace_and_the_requests(recorder, tmp_path):
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    with PP.span("before"):  # no profiler yet: not recorded
        pass
    with PP.trace(str(tmp_path / "trace")) as prof:
        with PP.span("mae_step", step=3):
            y = (x @ x).relu().sum()
    assert prof is not None and torch.isfinite(y)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "l4p/mae_step#1" for e in events)
    (req,) = json.loads((tmp_path / "trace" / "requests.json").read_text())
    assert req["request"] == 1 and [(s["name"], s["attrs"]) for s in req["spans"]] == [("mae_step", {"step": 3})]


@pytest.mark.gpu
def test_host_syncs_equal_the_traces_synchronising_calls(tmp_path):
    """One tiny bf16 request on the card under the profiler: the recorder's
    host_syncs equals the cudaStreamSynchronize, cudaDeviceSynchronize and
    cudaEventSynchronize calls inside its `l4p/request#n` span, and every
    site is a file of the program."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the count is of the card's synchronisations")
    cuda = torch.device("cuda")
    cfg, model, data = tiny_request(cuda, torch.bfloat16)
    sess = InferenceSession(cfg, SLICE_TASKS, cuda)
    sess(model, data)  # libraries loaded, kernels built
    torch.cuda.synchronize()
    with PP.trace(str(tmp_path)):
        sess(model, data)
    (req,) = json.loads((tmp_path / "requests.json").read_text())
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    (root,) = [e for e in events if e.get("ph") == "X" and e.get("name") == f"l4p/request#{req['request']}"]
    a, b = float(root["ts"]), float(root["ts"]) + float(root["dur"])
    calls = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
             and str(e.get("name")).startswith(SYNC_CALLS) and a <= float(e["ts"]) <= b]
    assert req["host_syncs"] == len(calls) > 0
    root_dir = os.path.dirname(PP._PACKAGE)
    for s in req["spans"]:
        for site in s["sync_sites"]:
            path = site.rsplit(":", 1)[0]
            assert path.startswith("l4p_tpu_torch/") and os.path.isfile(os.path.join(root_dir, path)), site
    assert req["spans"][0]["device_ms"][0] == 0.0 and req["spans"][0]["device_ms"][1] > 0
