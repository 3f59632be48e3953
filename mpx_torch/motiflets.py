"""k-Motiflets: the k most similar occurrences of a motif.

Counterpart of ``mpx/motiflets.py`` (Schaefer & Leser, PVLDB 16(3),
2022).  A *k-motiflet* is the set of k non-overlapping windows with the
smallest **extent**, the largest pairwise z-normalized distance within
the set; the elbows of the extent over k show how often a motif repeats.

The O(n^2) work is the top-k profile (:func:`mpx_torch.topk.compute_topk_profile`,
the strict tile on ``config.device``), every window's nearest neighbors.
The host then runs the paper's approximate algorithm over it: seeds
ranked by their (k-1)-th neighbor distance (a lower bound on any extent
through the seed), each seed's non-overlapping neighbor set built
greedily, and exact pairwise extents.  A seed whose list runs out of
non-overlapping neighbors takes one exact host MASS row
(:func:`mpx_torch.analysis.mass`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from mpx_torch.config import MatrixProfileConfig, config_for
from mpx_torch.reference import exclusion_zone


class Motiflet(NamedTuple):
    indices: np.ndarray   # (k,) sorted window positions
    extent: float         # max pairwise z-norm distance within the set
    k: int


def _unit_windows(T64: np.ndarray, m: int, idx: np.ndarray) -> np.ndarray:
    """Unit-normalized windows at ``idx`` (host, |idx| x m)."""
    wins = np.stack([T64[i : i + m] for i in idx])
    v = wins - wins.mean(axis=1, keepdims=True)
    nrm = np.linalg.norm(v, axis=1, keepdims=True)
    nrm = np.where(nrm == 0.0, np.inf, nrm)
    return v / nrm


def pairwise_extent(T64: np.ndarray, m: int, idx: Sequence[int]) -> float:
    """Exact max pairwise z-norm distance among the windows at ``idx``."""
    idx = np.asarray(sorted(int(i) for i in idx), np.int64)
    U = _unit_windows(T64, m, idx)
    C = np.clip(U @ U.T, -1.0, 1.0)
    D = np.sqrt(np.maximum(2.0 * m * (1.0 - C), 0.0))
    np.fill_diagonal(D, 0.0)
    return float(D.max())


def _greedy_set(seed: int, order: np.ndarray, dists: np.ndarray,
                need: int, zone: int) -> tuple[list, bool]:
    """Take the ``need`` nearest candidates (ascending ``dists`` order)
    pairwise non-overlapping with ``seed`` and each other."""
    chosen: List[int] = [int(seed)]
    for j, d in zip(order, dists):
        if len(chosen) - 1 >= need:
            break
        j = int(j)
        if j < 0 or not np.isfinite(d):
            continue
        if all(abs(j - c) >= zone for c in chosen):
            chosen.append(j)
    return chosen, len(chosen) - 1 >= need


def k_motiflets(
    T,
    k: int,
    m: Optional[int] = None,
    config: Optional[MatrixProfileConfig] = None,
    *,
    candidates: int = 64,
) -> Motiflet:
    """The (approximate) k-motiflet of ``T``: k non-overlapping windows
    with minimal extent.  ``candidates`` bounds the seeds refined on the
    host, best bound first."""
    return _motiflets_impl(T, [k], m, config, candidates)[0]


def motiflet_elbows(
    T,
    kmax: int,
    m: Optional[int] = None,
    config: Optional[MatrixProfileConfig] = None,
    *,
    candidates: int = 64,
):
    """Motiflets for every k in 2..kmax (one shared top-k sweep) and the
    elbows, the k after which the extent jumps most.  Returns ``(results,
    elbows)``: a list of :class:`Motiflet` and the elbow k's, most
    significant first."""
    ks = list(range(2, kmax + 1))
    if not ks:
        raise ValueError("kmax must be >= 2")
    results = _motiflets_impl(T, ks, m, config, candidates)
    ext = np.asarray([r.extent for r in results])
    # the jump at elbow k is extent(k+1) / extent(k), guarded against 0/inf
    jumps = []
    for i in range(len(ks) - 1):
        lo = max(float(ext[i]), 1e-12)
        hi = float(ext[i + 1])
        if np.isfinite(hi):
            jumps.append((hi / lo, ks[i]))
    elbows = [kk for ratio, kk in sorted(jumps, reverse=True) if ratio > 1.0]
    return results, elbows


def _motiflets_impl(T, ks: Sequence[int], m, config, candidates: int) -> List[Motiflet]:
    from mpx_torch.analysis import mass
    from mpx_torch.topk import compute_topk_profile

    config = config_for(m, config)
    m = config.m
    ks = sorted(set(int(k) for k in ks))
    if ks[0] < 2:
        raise ValueError("a motiflet needs k >= 2 occurrences")
    T64 = np.asarray(T, np.float64)
    w = T64.shape[0] - m + 1
    dmax = ks[-1] - 1
    zone = max(exclusion_zone(m), m // 2)
    if (dmax + 1) * zone > w:
        raise ValueError(
            f"k={ks[-1]} non-overlapping windows of {m} do not fit in "
            f"{T64.shape[0]} points")

    # Per-window neighbor lists, at most 8 wide (mpx's cap); a seed that
    # needs more takes a host MASS row below.
    kk = min(max(dmax + 2, 4), 8)
    D, I = (x.cpu().numpy() for x in compute_topk_profile(T64, config=config, k=kk))
    D = D.astype(np.float64)

    # Seeds: the d-th neighbor distance bounds any extent of a set through
    # the seed from below; one pool for every k, ranked by the largest k's.
    bound = D[:, min(dmax - 1, kk - 1)]
    order = np.argsort(np.where(np.isfinite(bound), bound, np.inf))
    seeds: List[int] = []
    for i in order:
        if not np.isfinite(bound[i]) or len(seeds) >= candidates:
            break
        if all(abs(int(i) - s) >= zone for s in seeds):
            seeds.append(int(i))

    full_rows: dict = {}

    def row(i: int) -> np.ndarray:
        if i not in full_rows:
            r = mass(T64[i : i + m], T64)
            lo = max(0, i - zone + 1)
            r[lo : i + zone] = np.inf
            full_rows[i] = r
        return full_rows[i]

    out: List[Motiflet] = []
    for k in ks:
        need = k - 1
        best: Optional[Motiflet] = None
        for s in seeds:
            # D[s, j] ignores overlaps, so it bounds the extent of any
            # k-set through s from below (clamped to the list's width it
            # only weakens); inf: too few valid windows for this k.
            if best is not None and D[s, min(need - 1, kk - 1)] >= best.extent:
                continue
            chosen, ok = _greedy_set(s, I[s], D[s], need, zone)
            if not ok:
                # the list ran out to overlaps: one exact host row
                r = row(s)
                chosen, ok = _greedy_set(s, np.argsort(r), np.sort(r), need, zone)
                if not ok:
                    continue
            ext = pairwise_extent(T64, m, chosen)
            if best is None or ext < best.extent:
                best = Motiflet(indices=np.asarray(sorted(chosen), np.int64), extent=ext, k=k)
        if best is None:
            best = Motiflet(indices=np.zeros(0, np.int64), extent=float("inf"), k=k)
        out.append(best)
    return out
