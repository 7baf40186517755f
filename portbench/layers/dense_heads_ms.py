"""`dense_heads_ms.<suffix>`: device ms per unit inside the `run_dense_head` spans."""

from portbench.layers._stage import per_unit_ms


def read(metric, run):
    return per_unit_ms(run, ("run_dense_head",))
