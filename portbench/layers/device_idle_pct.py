"""`device_idle_pct.<suffix>`: 100 x (1 - the union of device operation
intervals over the profiled slice's wall time)."""


def read(metric, run):
    return 100.0 * (1.0 - run.reduced.busy_s / run.reduced.window_s)
