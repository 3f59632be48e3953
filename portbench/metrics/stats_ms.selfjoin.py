"""The statistics' time a self-join, in ms: the program's
``mpx_torch.statistics`` spans (the running mean, the window sums' uploads
and launch, the staging; on the host's clock, since nothing there waits
for the device) over the window's self-joins (``mpx_torch.matrix_profile``)."""

from portbench.spans import in_window, named


def read(run):
    recs = in_window(run)
    calls = named(recs, "matrix_profile")
    if not calls:
        return None
    return sum(s.end_ns - s.start_ns for s in named(recs, "statistics")) / len(calls) * 1e-6
