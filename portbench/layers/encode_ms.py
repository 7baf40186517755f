"""`encode_ms.<suffix>`: device ms per unit inside the `encode_windows` spans."""

from portbench.layers._stage import per_unit_ms


def read(metric, run):
    return per_unit_ms(run, ("encode_windows",))
