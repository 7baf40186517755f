"""`idle_ms.<stage>.<suffix>`: device ms per clip in which a stage held the
card's stream and ran nothing: the device interval of the program's own
spans of the stage (from the timing event at their enter to the one at
their exit: the stage's operations, the gaps between them and the wait for
its first launch) less the device time of the operations launched inside
the harness's spans of the same calls, over the traced slice's clips."""

from __future__ import annotations

from portbench.layers.host_syncs import recorded

# stage: (the program's spans, the harness's spans of the same calls)
STAGES = {
    "encoder": (("encode",), ("encode_windows",)),
    "dense_heads": (("dense_head",), ("run_dense_head",)),
    "geometry": (("camera_solve", "stitch"), ("camray_windows_to_cameras", "stitch_dense_outputs")),
    "track": (("track",), ("run_track_chunked",)),
}


def read(metric, run):
    program, harness = STAGES[metric.split(".")[1]]
    got = recorded(run)
    if got is None:
        return None
    spans = [s for r in got for s in r["spans"] if s["name"] in program]
    if not spans:
        return None
    held_ms = sum(s["device_ms"][1] - s["device_ms"][0] for s in spans)
    return (held_ms - 1e3 * run.reduced.device_s(*harness)) / run.slice_units
