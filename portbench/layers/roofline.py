"""`roofline.<op>.<suffix>`: the op's least time over the device time of
the kernels launched inside its calls, in %. The least time is the sum over
the slice's calls of the larger of FLOPs over the bf16 peak and bytes over
the memory rate, at each call's logged shapes (work/kernels.py). `keys`
is t2i_flash and i2t_ln_t2i together. Nothing is read where the op did not
run or the card has no entry in work/peaks.py."""

from portbench.work.kernels import WORK
from portbench.work.peaks import PEAKS, least_seconds

OPS = {"attention": ("attention",), "keys": ("t2i", "i2t"), "upscale": ("upscale",)}


def read(metric, run):
    ops = OPS[metric.split(".")[1]]
    if run.card not in PEAKS or not all(run.spans.op_calls.get(o) for o in ops):
        return None
    least = sum(least_seconds(*WORK[o](call), run.card) for o in ops for call in run.spans.op_calls[o])
    spent = run.reduced.device_s(*ops)
    return 100.0 * least / spent if spent > 0 else None
