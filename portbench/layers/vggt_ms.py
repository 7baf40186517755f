"""`vggt_ms.<part>.<suffix>`: device ms per request that the program's own
spans of a part of VGGT held (from the timing event at their enter to the
one at their exit, as `idle_ms` reads them), summed over the traced slice's
requests and divided by their count. Nothing is read where the program has
no such span."""

from __future__ import annotations

from portbench.layers.host_syncs import recorded

PARTS = {
    "embed": ("vggt/embed",),
    "frame": ("vggt/frame_block",),
    "global": ("vggt/global_block",),
    "heads": ("vggt/camera_head", "vggt/dpt_head"),
}


def read(metric, run):
    names = PARTS[metric.split(".")[1]]
    got = recorded(run)
    if got is None:
        return None
    spans = [s for r in got for s in r["spans"] if s["name"] in names]
    if not spans:
        return None
    return sum(s["device_ms"][1] - s["device_ms"][0] for s in spans) / run.slice_units
