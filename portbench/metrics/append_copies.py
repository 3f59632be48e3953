"""Host-device copies an append, as the program counted them inside its
``mpx_torch.append`` and ``mpx_torch.row_values`` spans in the window."""

from portbench.spans import counted, in_window, named

COPIES = ("copies.append_h2d", "copies.append_d2h")


def read(run):
    recs = in_window(run)
    appends = named(recs, "append")
    if not appends:
        return None
    return counted(appends + named(recs, "row_values"), COPIES) / len(appends)
