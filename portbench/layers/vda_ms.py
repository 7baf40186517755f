"""`vda_ms.<part>.<suffix>`: device ms per request that the program's own
spans of a part of Video Depth Anything held (from the timing event at their
enter to the one at their exit, as `vggt_ms` reads them), summed over the
traced slice's requests and divided by their count: `encode` the encoder,
`motion` the four motion modules, `head` the whole temporal head (its
motion modules included), `stitch` the long-video stitch. Nothing is read
where the program has no such span."""

from __future__ import annotations

from portbench.layers.host_syncs import recorded

PARTS = {
    "encode": "vda/encode",
    "motion": "vda/motion",
    "head": "vda/head",
    "stitch": "vda/stitch",
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
