"""The harness's arithmetic: a rate over a window that holds a stall, the
idle share and the device time per span from trace events, and the
roofline and mfu shares."""

import math
import types

import pytest

from portbench import stats, trace
from portbench.layers import device_idle_pct, mfu, roofline
from portbench.work import kernels, peaks

CARD = "NVIDIA H100 80GB HBM3"


def test_rate_counts_the_stall():
    # ten requests of 0.1 s and one stall of 1 s: the rate is over the whole window
    durations = [0.1] * 5 + [1.0] + [0.1] * 5
    assert stats.rate(len(durations), sum(durations)) == pytest.approx(11 / 2.0)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_derive_seed_is_stable_and_large_seeds_work():
    assert stats.derive_seed(2 ** 31 + 5, "weights") == stats.derive_seed(2 ** 31 + 5, "weights")
    assert stats.derive_seed(1, "a") != stats.derive_seed(1, "b")
    assert 0 <= stats.derive_seed(2 ** 40, "x") < 2 ** 63


def events():
    return [
        {"ph": "X", "cat": "user_annotation", "name": "pb:slice", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "pb:encode_windows", "ts": 0, "dur": 40},
        {"ph": "X", "cat": "user_annotation", "name": "pb:attention", "ts": 10, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12, "dur": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 30, "dur": 1, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 60, "dur": 1, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "attn", "ts": 15, "dur": 20, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 30, "dur": 15, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 70, "dur": 10, "args": {"correlation": 3}},
    ]


def test_idle_is_one_minus_the_union_of_intervals():
    r = trace.Reduced(events())
    # kernels cover [15, 45) and [70, 80): 40 of 100 us, the overlap counted once
    assert r.busy_s == pytest.approx(40e-6) and r.window_s == pytest.approx(100e-6)
    run = types.SimpleNamespace(reduced=r)
    assert device_idle_pct.read("device_idle_pct.x", run) == pytest.approx(60.0)


def test_device_time_follows_the_launch_not_the_name():
    r = trace.Reduced(events())
    assert r.device_s("attention") == pytest.approx(20e-6)  # launched at 12, inside the attention span
    assert r.device_s("encode_windows") == pytest.approx(35e-6)  # launches at 12 and 30
    assert r.idle_gaps[0] == ["between spans", pytest.approx(25e-6)]
    assert r.device_ops[0][0] in ("gemm", "attn")


def test_a_trace_without_kernels_is_refused():
    ev = [e for e in events() if e["cat"] != "kernel"]
    with pytest.raises(RuntimeError):
        trace.Reduced(ev)


def test_roofline_share():
    call = {"args": [((2, 16, 2048, 88), 2)] * 3 + [None], "outs": [((2, 16, 2048, 88), 2)]}
    flop, moved = kernels.attention(call)
    assert flop == 4 * 2 * 16 * 2048 * 2048 * 88 and moved == 4 * 2 * 16 * 2048 * 88 * 2
    least = peaks.least_seconds(flop, moved, CARD)
    assert least == pytest.approx(flop / 989e12)
    spans = types.SimpleNamespace(op_calls={"attention": [call, call]}, calls={"attention": 2})
    red = types.SimpleNamespace(device_s=lambda *n: 4 * least)
    run = types.SimpleNamespace(card=CARD, spans=spans, reduced=red)
    assert roofline.read("roofline.attention.x", run) == pytest.approx(50.0)
    run.card = "a card with no entry"
    assert roofline.read("roofline.attention.x", run) is None


def test_kernel_counts_match_chip_smokes():
    n, p, c, k, d1, d2, m = 128, 2048, 1408, 48, 352, 176, 3
    t2i = {"args": [((n, p, c), 2), ((n, c, k), 2), ((n, p, k), 4)], "outs": [((n, k, c), 4)]}
    assert kernels.t2i(t2i)[0] == 4 * n * p * c * k
    up = {"args": [((n, p, c), 2), ((c, d1, 2, 2, 2), 2), ((d1,), 4), ((d1,), 4), ((d1,), 4), ((d1, d2, 1, 2, 2), 2),
                   ((d2,), 4), ((n, m, d2), 2)], "outs": [((n, m, p, 8, 4), 4)]}
    assert kernels.upscale(up)[0] == 2 * n * p * 8 * (c * d1 + 4 * d1 * d2) + 2 * n * m * p * 32 * d2


def test_mfu_share():
    run = types.SimpleNamespace(card=CARD, window_flops=989e12 * 3, window_s=10.0)
    assert mfu.read("mfu.x", run) == pytest.approx(30.0)
    run.window_flops = 0.0
    assert mfu.read("mfu.x", run) is None


def test_rel_l2():
    import torch

    from portbench.drivers._common import rel_l2, worst

    r = torch.tensor([3.0, 4.0])
    assert rel_l2(r + torch.tensor([0.3, 0.4]), r) == pytest.approx(0.1)
    got = worst([{"a": 1.0}, {"a": float("nan")}, {"a": 2.0}])
    assert math.isnan(got["a"])
