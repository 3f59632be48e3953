"""Closed-loop self-join requests, one caller: each request is one series
(``portbench.series``) through ``mpx_torch.matrix_profile(T, m,
dtype=...)`` with the library's defaults for kernel, band and chunk, timed
from the call until the profile and its index are numpy arrays on the
host.  The traced run makes the same call.

Traffic keys: ``warmup`` (requests run before the window, from a stream
of their own), ``warmup_length`` (cut them to this many points; absent:
whole), ``check`` = ``{"share": p, "rows": r | "all"}``: each request's
answer is compared with chance ``p`` drawn from the seed, on ``r`` rows
drawn from the seed or on all.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import roofline
from portbench.check import Tally, compare_rows
from portbench.series import Requests, rng


def _call(cell, T):
    import mpx_torch

    return mpx_torch.matrix_profile(T, cell.m, dtype=cell.dtype, device=cell.device)


def setup(cell):
    t = cell.traffic
    warm = Requests(cell.config, cell.seed + 1)
    cut = t.get("warmup_length")
    for i in range(int(t.get("warmup", 1))):
        T = warm.series(i)
        _call(cell, T[:cut] if cut else T)
    return Requests(cell.config, cell.seed), {}


def _kept(cell, i: int) -> bool:
    share = float(cell.traffic["check"]["share"])
    return rng(cell.seed, Requests.CHECK, i).random() < share


def window(cell, state, deadline: float):
    reqs, kept = state
    i = 0
    while time.perf_counter() < deadline:
        with cell.span("generate"):
            T = reqs.series(i)
        t0 = time.perf_counter()
        with cell.span("request"):
            MP, MPI = _call(cell, T)
        t1 = time.perf_counter()
        n = T.shape[0]
        cell.record("selfjoin", t0, t1, n, pairs=roofline.pairs(n, cell.m))
        if _kept(cell, i):
            kept[i] = (MP, MPI)
        i += 1


def finish(cell, state) -> dict:
    """The answers kept for the comparison, by request."""
    return state[1]


def check(cell, state, kept: dict) -> Tally:
    reqs = state[0]
    tally = Tally()
    rows_cfg = cell.traffic["check"]["rows"]
    for i, (MP, MPI) in kept.items():
        T = reqs.series(i)
        w = T.shape[0] - cell.m + 1
        if rows_cfg == "all" or int(rows_cfg) >= w:
            rows = np.arange(w)
        else:
            g = rng(cell.seed, Requests.CHECK, i, 1)
            rows = np.sort(g.choice(w, size=int(rows_cfg), replace=False))
        tally.add(compare_rows(cell.root, cell.config, T, rows, MP, MPI,
                               device=cell.device), cell.config)
    return tally
