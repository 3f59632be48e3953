"""The share of the traced window in which nothing ran on the device."""

from portbench.readings import idle_pct


def read(run):
    return idle_pct(run)
