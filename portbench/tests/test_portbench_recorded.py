"""The readers of the program's own spans and counter (`host_syncs`,
`idle_ms`): found by name, None off the card and where the program has no
recorder, a slice's count of requests held, and their arithmetic on
synthetic records."""

import types

import pytest

from portbench import manifest as mf

CARD = "NVIDIA H100 80GB HBM3"
METRICS = ["host_syncs.offline", "idle_ms.encoder.offline", "idle_ms.dense_heads.offline",
           "idle_ms.geometry.offline", "idle_ms.track.offline"]


def span(name, a, b, syncs=0):
    return {"name": name, "attrs": {}, "parent": 0, "request": 1, "host_ns": [0, 1], "device_ms": [a, b],
            "syncs": syncs, "sync_sites": {"l4p_tpu_torch/models/track.py:126": syncs} if syncs else {}}


def request(number, syncs):
    """A clip: encode 0-100 ms, three heads of 50 ms, the stitch 1 ms, the
    track stage 300 ms holding 11 windows; `syncs` charged to the windows."""
    spans = [span("request", 0.0, 500.0), span("encode", 1.0, 101.0)]
    spans += [span("dense_head", 101.0 + 50 * i, 151.0 + 50 * i) for i in range(3)]
    spans += [span("stitch", 251.0, 252.0), span("track", 252.0, 552.0)]
    spans += [span("track.window", 252.0 + 27 * w, 279.0 + 27 * w, syncs if w == 0 else 0) for w in range(11)]
    return {"request": number, "device": "cuda:0", "host_syncs": syncs, "spans": spans}


def traced(monkeypatch, records, units=2, card=CARD):
    from l4p_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "requests", lambda n=64: records[-n:])
    busy = {"encode_windows": 0.090, "run_dense_head": 0.140, "stitch_dense_outputs": 0.0015,
            "camray_windows_to_cameras": 0.0, "run_track_chunked": 0.500}  # seconds over the slice
    reduced = types.SimpleNamespace(device_s=lambda *names: sum(busy[n] for n in names))
    return types.SimpleNamespace(card=card, slice_units=units, reduced=reduced)


@pytest.mark.parametrize("metric", METRICS)
def test_found_by_name_and_none_off_the_card(monkeypatch, metric):
    run = traced(monkeypatch, [], card="cpu")
    assert mf.reader(metric)(metric, run) is None
    cpu = [dict(request(i, 0), device="cpu", host_syncs=None) for i in (1, 2)]
    for r in cpu:
        for s in r["spans"]:
            s.update(device_ms=None, syncs=None, sync_sites=None)
    assert mf.reader(metric)(metric, traced(monkeypatch, cpu)) is None


@pytest.mark.parametrize("metric", METRICS)
def test_none_where_the_program_has_no_recorder(monkeypatch, metric):
    from l4p_tpu_torch.utils import profiling

    run = traced(monkeypatch, [])
    monkeypatch.delattr(profiling, "requests")
    assert mf.reader(metric)(metric, run) is None


@pytest.mark.parametrize("records", [1, 3])
def test_a_count_other_than_the_slices_is_refused(monkeypatch, records):
    run = traced(monkeypatch, [request(i, 40) for i in range(records)])
    for metric in METRICS:
        with pytest.raises(RuntimeError, match="recorded"):
            mf.reader(metric)(metric, run)


def test_the_arithmetic(monkeypatch):
    run = traced(monkeypatch, [request(1, 40), request(2, 46)])
    read = {m: mf.reader(m)(m, run) for m in METRICS}
    assert read["host_syncs.offline"] == pytest.approx(43.0)
    # held per clip minus the harness's device time over the slice per clip
    assert read["idle_ms.encoder.offline"] == pytest.approx(100.0 - 90.0 / 2)
    assert read["idle_ms.dense_heads.offline"] == pytest.approx(150.0 - 140.0 / 2)
    assert read["idle_ms.geometry.offline"] == pytest.approx(1.0 - 1.5 / 2)
    assert read["idle_ms.track.offline"] == pytest.approx(300.0 - 500.0 / 2)
