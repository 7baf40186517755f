"""`sam2_ms.<part>.<suffix>`: device ms per request that the program's own
spans of a part of SAM 2 held (from the timing event at their enter to the
one at their exit, as `vda_ms` reads them), summed over the traced slice's
requests and divided by their count: `encode` the image encoder,
`memory_attention` memory attention over the bank, `decode` the decoder
(the mask choice and the upsampled logits included), `memory_encode` the
memory encoder and the bank's update. Nothing is read where the program
has no such span."""

from __future__ import annotations

from portbench.layers.host_syncs import recorded

PARTS = {
    "encode": "sam2/encode",
    "memory_attention": "sam2/memory_attention",
    "decode": "sam2/decode",
    "memory_encode": "sam2/memory_encode",
}


def read(metric, run):
    name = PARTS[metric.split(".")[1]]
    got = recorded(run)
    if got is None:
        return None
    spans = [s for r in got for s in r["spans"] if s["name"] == name]
    if not spans:
        return None
    return sum(s["device_ms"][1] - s["device_ms"][0] for s in spans) / run.slice_units
