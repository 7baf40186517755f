"""`host_syncs.<suffix>`: the program's own count of calls that blocked the
host on the card, per recorded request (`host_syncs` of
`l4p_tpu_torch.utils.profiling.requests`), averaged over the traced slice.

`recorded` is the slice's requests as the program recorded them: None off
the card and where the program has no recorder; a count of requests other
than the slice's is refused."""

from __future__ import annotations

from typing import Any, Dict, List, Optional


def recorded(run) -> Optional[List[Dict[str, Any]]]:
    if run.card == "cpu":
        return None
    try:
        from l4p_tpu_torch.utils import profiling
    except ImportError:
        return None
    requests = getattr(profiling, "requests", None)
    if requests is None:
        return None
    got = requests(run.slice_units + 1)  # one more than the slice: a request recorded besides is seen
    if len(got) != run.slice_units:
        raise RuntimeError(f"the program recorded {len(got)} requests, the traced slice served {run.slice_units}")
    if any(r["host_syncs"] is None for r in got):
        return None
    return got


def read(metric, run):
    got = recorded(run)
    if got is None:
        return None
    return sum(r["host_syncs"] for r in got) / len(got)
