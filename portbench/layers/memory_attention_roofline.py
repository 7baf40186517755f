"""`memory_attention_roofline.<suffix>`: SAM 2's memory-attention calls'
least time over their device time, in %: the attention kernel at head dim
256. Each call lies in a span of the program's own
(`sam2/memory_attention_call`, opened around the attention call in
`l4p_tpu_torch/models/sam2.py`, its attributes the call's shapes); the
device time is the span's interval between its timing events, summed over
the traced slice's requests, and the least time is the larger of the call's
FLOPs over the bf16 peak and its q, k, v and o bytes over the memory rate
(work/memory_attention.py). Nothing is read off the card, where the card
has no entry in work/peaks.py, or where the program has no such span."""

from __future__ import annotations

from portbench.layers.host_syncs import recorded
from portbench.work.memory_attention import work
from portbench.work.peaks import PEAKS, least_seconds

SPAN = "sam2/memory_attention_call"


def read(metric, run):
    if run.card not in PEAKS:
        return None
    got = recorded(run)
    if got is None:
        return None
    spans = [s for r in got for s in r["spans"] if s["name"] == SPAN]
    if not spans:
        return None
    least = sum(least_seconds(*work(s["attrs"]), run.card) for s in spans)
    spent = 1e-3 * sum(s["device_ms"][1] - s["device_ms"][0] for s in spans)
    return 100.0 * least / spent if spent > 0 else None
