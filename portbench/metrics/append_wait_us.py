"""The read-back of an append's new distances, in us: the mean of the
program's ``mpx_torch.row_values`` spans in the window (the wait for the
queued device work, the copy to the host, the host's square root)."""

from portbench.spans import mean_us


def read(run):
    return mean_us(run, "row_values")
