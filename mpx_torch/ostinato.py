"""Consensus motifs across several series (Ostinato, ICDM'19).

Counterpart of ``mpx/ostinato.py``.  Given k series, the consensus motif
is the window, in any series, with the smallest *radius*

    radius(i, p) = max over j != i of  min_q dist(T_i[p:p+m], T_j[q:q+m]),

the pattern with a close match in every other series.  Each unordered
pair of series is one AB-join (:func:`mpx_torch.abjoin.compute_ab_join`,
K1 on the card), which gives both directional profiles; a window's radius
is the elementwise max over its k - 1 profiles.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

from mpx_torch.config import MatrixProfileConfig, config_for


class ConsensusMotif(NamedTuple):
    series: int      # which series holds the consensus motif
    index: int       # subsequence start within that series
    radius: float    # max distance to its nearest neighbor per other series
    radii: list      # per-series radius profiles (ragged: one array per series)


def ostinato(
    series: Sequence,
    m: Optional[int] = None,
    *,
    config: Optional[MatrixProfileConfig] = None,
) -> ConsensusMotif:
    """The consensus motif across ``series`` (two or more 1-D arrays,
    lengths may differ): the best (series, index, radius), and each
    series' radius profile (``radii[i][p]`` for window p of series i)."""
    from mpx_torch.abjoin import compute_ab_join

    config = config_for(m, config)
    m = config.m
    k = len(series)
    if k < 2:
        raise ValueError("ostinato needs at least two series")
    series = [np.asarray(s) for s in series]

    radii = [np.zeros(s.shape[0] - m + 1, np.float64) for s in series]
    for i in range(k):
        for j in range(i + 1, k):
            res = compute_ab_join(series[i], series[j], config=config)
            np.maximum(radii[i], res.mp_a.cpu().numpy().astype(np.float64), out=radii[i])
            np.maximum(radii[j], res.mp_b.cpu().numpy().astype(np.float64), out=radii[j])

    best = (np.inf, -1, -1)
    for i, r in enumerate(radii):
        fin = np.isfinite(r)
        if not fin.any():
            continue
        p = int(np.where(fin, r, np.inf).argmin())
        if r[p] < best[0]:
            best = (float(r[p]), i, p)
    if best[1] < 0:
        raise ValueError("no finite radius — every window is degenerate")
    return ConsensusMotif(series=best[1], index=best[2], radius=best[0], radii=radii)
