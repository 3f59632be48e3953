"""The least time the card could take for the window's self-joins
(``portbench.roofline.least_seconds``, whatever kernel ran) over the
device's busy time in the traced window, in %."""

from portbench.roofline import least_seconds


def read(run):
    reqs = run.of("selfjoin")
    t = run.trace
    if t is None or t.busy_s <= 0 or not reqs:
        return None
    return 100.0 * sum(least_seconds(r.n, r.m, r.dtype) for r in reqs) / t.busy_s
