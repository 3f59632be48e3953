"""Kernel launches in the traced window per append."""

from portbench.readings import per_append


def read(run):
    return None if run.trace is None else per_append(run, run.trace.kernels)
