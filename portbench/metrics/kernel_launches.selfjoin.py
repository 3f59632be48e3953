"""Hand-written kernel launches a self-join (K1, K3, the window
statistics), as the program counted them inside its
``mpx_torch.matrix_profile`` spans in the window."""

from portbench.spans import counted, in_window, named

LAUNCHES = ("launches.k1", "launches.k3", "launches.window_stats")


def read(run):
    calls = named(in_window(run), "matrix_profile")
    return counted(calls, LAUNCHES) / len(calls) if calls else None
