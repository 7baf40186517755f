"""`mfu.<suffix>`: the analytic matmul FLOPs of the work the traced run's
window completed (work/flops.py), over the window's time, over the card's
bf16 peak, in %."""

from portbench.work.peaks import PEAKS


def read(metric, run):
    if run.card not in PEAKS or not run.window_flops:
        return None
    return 100.0 * run.window_flops / run.window_s / PEAKS[run.card]["bf16_flops"]
