"""`qk_norm_rope_roofline.<suffix>`: the attention prologue kernel's least
time over its device time, in %. Each launch lies in a span of the program's
own (`qk_norm_rope`, opened around the launch in
`l4p_tpu_torch/ops/qk_norm_rope.py`, its attributes the call's shapes); the
device time is the span's interval between its timing events, summed over
the traced slice's requests, and the least time is the bytes each call
moves (work/qk_norm_rope.py) over the card's memory rate. Nothing is read
off the card, where the card has no entry in work/peaks.py, or where the
program has no such span."""

from __future__ import annotations

from portbench.layers.host_syncs import recorded
from portbench.work.peaks import PEAKS, least_seconds
from portbench.work.qk_norm_rope import moved

SPAN = "qk_norm_rope"


def read(metric, run):
    if run.card not in PEAKS:
        return None
    got = recorded(run)
    if got is None:
        return None
    spans = [s for r in got for s in r["spans"] if s["name"] == SPAN]
    if not spans:
        return None
    least = sum(least_seconds(0.0, moved(s["attrs"]), run.card) for s in spans)
    spent = 1e-3 * sum(s["device_ms"][1] - s["device_ms"][0] for s in spans)
    return 100.0 * least / spent if spent > 0 else None
