"""Kernel time in the traced window per append, in microseconds."""

from portbench.readings import per_append


def read(run):
    return None if run.trace is None else per_append(run, run.trace.kernel_s * 1e6)
