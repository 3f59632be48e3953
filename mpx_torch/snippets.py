"""Time-series snippets: the k most representative segments.

Counterpart of ``mpx/snippets.py`` (Imani et al., Matrix Profile XIII).
A snippet is an L-length segment chosen so that the k snippets together
are the nearest representative of as much of the series as possible:

1. the candidates are the floor(n/L) non-overlapping L-segments;
2. each candidate's distance profile ``D_j[t]`` (the distance from
   ``T[t:t+m]`` to the candidate's nearest m-window) is the B -> A side of
   one AB-join (:func:`mpx_torch.abjoin.compute_ab_join`, K1 on the card);
3. a greedy cover picks, k times, the candidate that most reduces the
   area under the pointwise minimum of the chosen profiles;
4. every position goes to its nearest chosen snippet, and a snippet's
   ``fraction`` is the share of positions it represents.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

from mpx_torch.config import MatrixProfileConfig


class Snippet(NamedTuple):
    start: int        # segment start in T
    length: int       # = L
    fraction: float   # share of the series it represents
    index: int        # candidate ordinal (start // L)


def snippets(
    T,
    L: int,
    k: int = 2,
    m: Optional[int] = None,
    config: Optional[MatrixProfileConfig] = None,
) -> List[Snippet]:
    """The ``k`` most representative L-length segments of ``T``.

    ``m`` is the comparison window (default L // 2, at least 4).
    ``config`` carries the AB-joins' dtype, kernel and device; its ``m``
    is replaced by ``m``."""
    from dataclasses import replace

    from mpx_torch.abjoin import compute_ab_join

    T = np.asarray(T, np.float64)
    n = T.shape[0]
    if m is None:
        m = max(4, L // 2)
    if L < m:
        raise ValueError(f"snippet length L={L} must be >= m={m}")
    ncand = n // L
    if ncand < 1:
        raise ValueError(f"series of length {n} has no L={L} segment")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    k = min(k, ncand)
    config = MatrixProfileConfig(m=m) if config is None else replace(config, m=m)

    # One AB-join a candidate: mp_b is each window's distance to the
    # candidate's nearest window.
    D = np.empty((ncand, n - m + 1), np.float64)
    for j in range(ncand):
        res = compute_ab_join(T[j * L : (j + 1) * L], T, config=config)
        D[j] = res.mp_b.cpu().numpy()

    # Greedy minimum-area cover.
    chosen: List[int] = []
    best = np.full(n - m + 1, np.inf)
    for _ in range(k):
        areas = [np.minimum(best, D[j]).sum() if j not in chosen else np.inf
                 for j in range(ncand)]
        pick = int(np.argmin(areas))
        if not np.isfinite(areas[pick]):
            break
        chosen.append(pick)
        best = np.minimum(best, D[pick])

    # Coverage fractions by nearest-snippet assignment.
    assign = np.argmin(D[chosen], axis=0)
    return [Snippet(start=j * L, length=L, fraction=float(np.mean(assign == rank)), index=j)
            for rank, j in enumerate(chosen)]
