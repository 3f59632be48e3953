"""The host's time in an append before it returns, in us: the mean of the
program's ``mpx_torch.append`` spans in the window (host statistics,
uploads, the enqueued sweep and merge; no wait for the device)."""

from portbench.spans import mean_us


def read(run):
    return mean_us(run, "append")
