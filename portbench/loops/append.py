"""A live feed: the configuration's series (request 0's) is bootstrapped
into ``mpx_torch.streaming.StreamingMatrixProfile`` in set-up (the
bootstrap is the feed's state, a self-join through ``mpx_torch.driver``), then the
window appends the walk's continuation ``points`` at a time, as STUMPY's
``stumpi.update`` takes them.  Each append is timed until the new
windows' distances are on the host (``row_values``, the port's O(k)
accessor).  After the window, ``profile()`` hands the whole profile and
index to the comparison.

Traffic keys: ``mode`` (``full``), ``points`` (a call), ``warmup_appends``
(appends made in set-up, part of the feed), ``check`` = ``{"old": r,
"improved": c}``: every window appended in the window is compared, with
what the feed read for it when it arrived; beside them ``c`` of the older
windows whose index now points into the appended part, and ``r`` older
windows, both drawn from the seed.
"""

from __future__ import annotations

import array
import itertools
import time

import numpy as np

from portbench.check import Tally, compare_rows, fit
from portbench.series import Requests, rng


class Feed:
    def __init__(self, smp, T0, points):
        self.smp = smp
        self.points = points
        # the series as the benchmark sent it: the comparison's input
        self.T0 = np.asarray(T0, np.float64)
        self.sent = array.array("d")
        self.w_boot = 0  # windows before the measured window
        # per window appended in the measured window: the windows the feed
        # held once it was appended, and the distance it read for it
        self.held = array.array("q")
        self.reads = array.array("d")
        self.n = self.T0.shape[0]


def setup(cell):
    from mpx_torch.streaming import StreamingMatrixProfile

    t = cell.traffic
    reqs = Requests(cell.config, cell.seed)
    T0 = reqs.series(0)
    smp = StreamingMatrixProfile(T0, cell.m, cell.dtype, mode=t["mode"], device=cell.device)
    feed = Feed(smp, T0, reqs.stream(float(T0[-1]), 1 << 16))
    k = int(t["points"])
    for _ in range(int(t.get("warmup_appends", 0))):
        _append(feed, k, cell.m)
    feed.w_boot = feed.n - cell.m + 1
    return feed


def _append(feed: Feed, k: int, m: int):
    pts = np.fromiter(itertools.islice(feed.points, k), np.float64, k)
    feed.sent.extend(pts)
    feed.n += k
    feed.smp.append(pts)
    w = feed.n - m + 1
    return feed.smp.row_values(w - k, w), w


def window(cell, feed: Feed, deadline: float):
    k, m = int(cell.traffic["points"]), cell.m
    while time.perf_counter() < deadline:
        t0 = time.perf_counter()
        with cell.span("append"):
            vals, w = _append(feed, k, m)
        t1 = time.perf_counter()
        cell.record("append", t0, t1, k)
        feed.held.extend([w] * k)
        # a read that does not come back counts as infinitely far
        feed.reads.extend(vals if len(vals) == k else [np.inf] * k)


def finish(cell, feed: Feed):
    """After the window: the feed's counters, its whole profile, and the
    program's state released."""
    smp, m = feed.smp, cell.m
    cell.counters.update(staged_elements=smp.staged_elements,
                         capacity_doublings=smp.capacity_doublings,
                         windows=feed.n - m + 1)
    MP, MPI = smp.profile()
    T = np.concatenate([feed.T0, np.frombuffer(feed.sent)])
    feed.smp = None  # the program's state goes before the reference runs
    return T, MP, MPI


def check(cell, feed: Feed, kept) -> Tally:
    T, MP, MPI = kept
    MP, MPI = fit(MP, MPI, T.shape[0] - cell.m + 1)
    tally = Tally()
    c = cell.traffic["check"]
    if feed.held:
        held = np.frombuffer(feed.held, np.int64)
        k = int(cell.traffic["points"])
        # the j-th of an append's k new windows is row held - k + j
        rows = held - k + np.tile(np.arange(k), held.size // k)
        tally.add(compare_rows(cell.root, cell.config, T, rows, MP, MPI, device=cell.device,
                               col_limit=held, reads=np.frombuffer(feed.reads)), cell.config)
    old = np.arange(feed.w_boot)
    improved = old[MPI[: feed.w_boot] >= feed.w_boot]
    g = rng(cell.seed, Requests.CHECK)
    picks = [g.choice(improved, size=min(int(c["improved"]), improved.size), replace=False),
             g.choice(old, size=min(int(c["old"]), old.size), replace=False)]
    rows = np.unique(np.concatenate(picks))
    tally.add(compare_rows(cell.root, cell.config, T, rows, MP, MPI, device=cell.device),
              cell.config)
    return tally
