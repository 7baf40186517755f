"""`track_ms.<suffix>`: device ms per unit inside the `run_track_chunked` spans."""

from portbench.layers._stage import per_unit_ms


def read(metric, run):
    return per_unit_ms(run, ("run_track_chunked",))
