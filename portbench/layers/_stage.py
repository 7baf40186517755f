"""Device time of one layer per unit of work (a clip, a step): the device
seconds of every kernel launched inside the layer's spans in the traced
slice, over the units the slice completed."""

from __future__ import annotations

from typing import Optional, Sequence


def per_unit_ms(run, spans: Sequence[str], minus: Sequence[str] = ()) -> Optional[float]:
    if not all(run.spans.calls.get(s) for s in spans):
        return None
    t = run.reduced.device_s(*spans) - run.reduced.device_s(*minus)
    return 1e3 * t / run.slice_units
