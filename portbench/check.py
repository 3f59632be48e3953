"""The comparison that decides ``correct``: a program's profile rows
against the plain reference, with the reference's tie rule.

For each compared row, the gap between the program's distance and the
exact one (``dist_err``), and whether its index is wrong (``index_bad``):
an index other than the reference's first best is allowed only when the
exact distance of the pair it names ties the best within the
configuration's tolerance.  A row with no valid neighbour must carry
index -1.  Values a stream handed out as it went (``reads``) are held to
the best over the windows it held at that moment (``read_err``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench import files


@dataclasses.dataclass
class Tally:
    """Worst readings over every compared row of a run."""

    dist_err: float = 0.0
    index_bad: int = 0
    read_err: float = 0.0
    rows: int = 0
    reads: int = 0
    answers: int = 0
    answers_wrong: int = 0

    def add(self, other: "Tally", config: dict):
        """Fold in the tally of one answer (a profile a request returned)."""
        self.dist_err = max(self.dist_err, other.dist_err)
        self.read_err = max(self.read_err, other.read_err)
        self.index_bad += other.index_bad
        self.rows += other.rows
        self.reads += other.reads
        self.answers += 1
        self.answers_wrong += int(not other.within(config))

    def within(self, config: dict) -> bool:
        lim = limits(config)
        return (self.dist_err <= lim["dist_err"] and self.index_bad <= lim["index_bad"]
                and self.read_err <= lim["read_err"])


def compare_rows(root: str, config: dict, T: np.ndarray, rows: np.ndarray, MP: np.ndarray,
                 MPI: np.ndarray, *, device, col_limit=None, reads=None) -> Tally:
    """Hold the program's ``MP[rows]``, ``MPI[rows]`` (and, with
    ``col_limit``, the ``reads`` it handed out for those rows) to the
    reference recomputed from ``T``."""
    ref = files.module(root, "reference", config["reference"])
    m, tol = config["m"], config["tolerance"]
    rows = np.asarray(rows, np.int64)
    w = T.shape[0] - m + 1
    MP, MPI = fit(MP, MPI, w)
    best, eI, lim_best = ref.exact_rows(T, m, rows, col_limit=col_limit, device=device)
    live = np.isfinite(best)
    eMP = ref.distance(m, np.where(live, best, 0.0))
    got_d = np.asarray(MP, np.float64)[rows]
    derr = np.where(live, np.abs(got_d - eMP), 0.0)
    # A row without neighbours must say so: index -1 (its distance is the
    # program's sentinel and is not compared).
    got_i = np.asarray(MPI, np.int64)[rows]
    mism = got_i != eI
    in_range = (got_i >= 0) & (got_i < w)
    tie_ok = np.zeros(rows.shape[0], bool)
    check = mism & live & in_range
    if check.any():
        P = ref.correlations(T, m, rows[check], got_i[check], device=device)
        gotD = ref.distance(m, P)
        tie_ok[check] = (np.isfinite(P) & (np.abs(gotD - eMP[check]) <= tol)
                         & (np.abs(got_i[check] - rows[check]) >= m // 4))
    bad = mism & ~tie_ok
    t = Tally(dist_err=float(derr.max(initial=0.0)), index_bad=int(bad.sum()),
              rows=int(rows.shape[0]))
    if col_limit is not None:
        lim_live = np.isfinite(lim_best)
        eR = ref.distance(m, np.where(lim_live, lim_best, 0.0))
        rerr = np.where(lim_live, np.abs(np.asarray(reads, np.float64) - eR), 0.0)
        t.read_err = float(rerr.max(initial=0.0))
        t.reads = int(rows.shape[0])
    return t


def fit(MP, MPI, w: int):
    """The answer cut or padded to the ``w`` windows of the series the
    benchmark sent: a window the answer lacks reads as infinitely far,
    with no index."""
    MP = np.asarray(MP, np.float64)[:w]
    MPI = np.asarray(MPI, np.int64)[:w]
    short = w - MP.shape[0]
    if short:
        MP = np.concatenate([MP, np.full(short, np.inf)])
        MPI = np.concatenate([MPI, np.full(short, -2, np.int64)])
    return MP, MPI


def limits(config: dict) -> dict:
    """Each compared number's limit: the distances' tolerance the
    configuration states, and exact index agreement."""
    return {"dist_err": config["tolerance"], "index_bad": 0, "read_err": config["tolerance"]}


def verdict(tally: Tally, config: dict, with_reads: bool) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number within its
    limit, and at least one row compared."""
    lim = limits(config)
    names = ["dist_err", "index_bad"] + (["read_err"] if with_reads else [])
    numbers = {k: {"value": getattr(tally, k), "limit": lim[k]} for k in names}
    ok = tally.rows >= 1 and all(numbers[k]["value"] <= lim[k] for k in names)
    # Not a gap: how many rows were compared, which has to be one at least.
    numbers["rows"] = {"value": tally.rows, "limit": 1}
    return ok, numbers
