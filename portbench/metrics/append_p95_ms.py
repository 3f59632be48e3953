"""95th percentile of one live-feed update (the append until the new
window's distance is on the host), over every append of the window."""

from portbench.readings import p95_ms


def read(run):
    return p95_ms(run, "append")
