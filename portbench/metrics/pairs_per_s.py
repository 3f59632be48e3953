"""Pairs w(w-1)/2 of every self-join completed in the window, over the
time from the window's start to the last completion."""


def read(run):
    reqs = run.of("selfjoin")
    if not reqs:
        return None
    return sum(r.pairs for r in reqs) / (max(r.t1 for r in reqs) - run.window[0])
