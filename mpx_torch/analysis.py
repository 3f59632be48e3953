"""Matrix-profile analysis helpers: the corrected arc curve and regime
extraction (FLUSS-style semantic segmentation).

Counterpart of the first part of ``mpx/analysis.py``: nearest-neighbor
arcs rarely cross a regime boundary, so normalized arc-crossing counts
dip at change points.  These are numpy functions of a profile index
(FLOSS, :mod:`mpx_torch.floss`, scores its streaming right profile with
:func:`one_directional_cac`).  The motif, discord and other helpers of
mpx's module are not ported yet (ROADMAP.md queue 1 item 12).
"""

from __future__ import annotations

from typing import List

import numpy as np


def corrected_arc_curve(MPI, m: int) -> np.ndarray:
    """FLUSS corrected arc curve (CAC) from the profile index.

    For each position i, counts the nearest-neighbor arcs (j <-> MPI[j])
    spanning i (an O(n) +1/-1 sweep) and normalizes by the idealized
    parabola 2*i*(w-i)/w of boundary-free data.  Values near 1 mean as
    many crossings as random; dips toward 0 mark regime boundaries.  The
    first/last m positions are pinned to 1."""
    MPI = np.asarray(MPI)
    w = MPI.shape[0]
    src = np.nonzero(MPI >= 0)[0]
    dst = MPI[src]
    i = np.arange(w, dtype=np.float64)
    ideal = 2.0 * i * (w - i) / w
    return _arc_curve(np.minimum(src, dst), np.maximum(src, dst), ideal, m, w)


def _arc_curve(lo, hi, ideal, m: int, w: int) -> np.ndarray:
    """Shared CAC scaffolding: count arcs [lo, hi) spanning each position
    with a +1/-1 delta sweep, normalize by the null-model ``ideal`` curve,
    cap at 1, and pin the first/last min(m, w//2) positions."""
    delta = np.zeros(w + 1, np.float64)
    np.add.at(delta, lo, 1.0)
    np.add.at(delta, hi, -1.0)
    crossings = np.cumsum(delta[:-1])
    with np.errstate(divide="ignore", invalid="ignore"):
        cac = np.where(ideal > 0, crossings / ideal, 1.0)
    cac = np.minimum(cac, 1.0)
    edge = min(m, w // 2)
    cac[:edge] = 1.0
    cac[w - edge:] = 1.0
    return cac


def one_directional_cac(MPI_right, m: int) -> np.ndarray:
    """One-directional corrected arc curve (the FLOSS variant) from the
    RIGHT profile index: every arc points from a window to its nearest
    LATER neighbor, so the curve can be kept over a growing or sliding
    stream.

    Under the null model (each source j points to a uniformly random
    destination in (j, w-1]) the expected number of arcs spanning i is

        E[c_i] = (w-1-i) * (H_{w-1} - H_{w-2-i}),   H_k = sum_{t<=k} 1/t

    Windows without a right neighbor (MPI_right < 0) contribute no arc.
    The first/last m positions are pinned to 1."""
    MPI_right = np.asarray(MPI_right)
    w = MPI_right.shape[0]
    src = np.nonzero(MPI_right > np.arange(w))[0]
    dst = MPI_right[src]
    H = np.concatenate([[0.0], np.cumsum(1.0 / np.arange(1, w, dtype=np.float64))])
    r = w - 1 - np.arange(w)
    ideal = r * (H[w - 1] - H[np.maximum(r - 1, 0)])
    return _arc_curve(src, dst, ideal, m, w)


def extract_regimes(cac: np.ndarray, m: int, k: int = 1) -> List[int]:
    """k regime-change locations from a corrected arc curve: the k lowest
    valleys, each suppressing a 5*m zone (the FLUSS rule)."""
    cac = np.asarray(cac, np.float64).copy()
    zone = 5 * m
    out: List[int] = []
    while len(out) < k:
        i = int(cac.argmin())
        if not np.isfinite(cac[i]) or cac[i] >= 1.0:
            break
        out.append(i)
        lo = max(0, i - zone)
        cac[lo : i + zone + 1] = np.inf
    return out


def regimes(MPI, m: int, k: int = 1) -> List[int]:
    """k regime-change locations: the k lowest CAC valleys, each
    suppressing a 5*m zone."""
    return extract_regimes(corrected_arc_curve(MPI, m), m, k=k)
