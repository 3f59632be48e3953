"""Shared band-sweep kernel contract, counterpart of ``mpx/kernels/common.py``.

A *job* sweeps a row band ``r0 .. r0+S`` of the self-join against W
columns or diagonals, ``c0 = r0 + k0``:

* the windows-matmul kernels (K1 and its plain version) sweep the
  rectangle rows ``[r0, r0+S)`` x columns ``[c0, c0+W)``;
* the recurrence kernels (K3 and its plain version) sweep the rhombus
  rows ``[r0, r0+S)`` x diagonals ``[k0, k0+W)``: at local row ``i``,
  lane ``j`` touches column ``c0 + i + j``.

Outputs are (value, index) aggregate pairs:

* ``row`` — (S,)  row aggregates for rows r0..r0+S
* ``col`` — column aggregates from column c0 on: (W,) for the rectangle,
  (S + W,) for the rhombus

The driver max-merges these windows into global row/column profiles, so
jobs may run in any order.

Masking rules (per pair (r, c)):

* in-bounds:      r <= w-1 and c <= wc-1   (w = n - m + 1)
* exclusion zone: c - r >= excl            (excl = m // 4; NO_EXCL for
                                           an AB-join)
* finite stats:   inv[r] and inv[c] finite (zero-variance windows never match)

Masked pairs contribute the aggregate init (-1e12), never 0: a masked 0
would beat genuine negative correlations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mpx_torch.ops.precompute import sliding_dot_product
from mpx_torch.types import Aggregates


# The exclusion bound of an AB-join (mpx's ``NO_EXCL``): its pairs join
# two series, so none is trivial; ``c - r >= NO_EXCL`` holds for them all.
NO_EXCL = -(2**30)


class BandOut(NamedTuple):
    row: Aggregates  # (S,) rows r0 .. r0+S
    col: Aggregates  # (W,) or, for the recurrence, (S + W,) columns from c0


class BandGeometry(NamedTuple):
    S: int      # band rows
    W: int      # chunk diagonals
    m: int      # subsequence length
    w: int      # row-axis profile width (n - m + 1)
    excl: int   # exclusion zone m // 4
    tr: int     # tile rows (API parity with mpx; the kernels pick their own)
    tc: int     # tile diagonals (API parity with mpx)
    wc: int     # column-axis profile width (== w for self-joins)


def band_geometry(
    S: int, W: int, m: int, w: int, tr: int = 8, tc: int = 2048,
    wc: int | None = None, excl: int | None = None,
) -> BandGeometry:
    tr = min(tr, S)
    tc = min(tc, W)
    if S % tr or W % tc:
        raise ValueError(f"band {S} / chunk {W} must tile by ({tr}, {tc})")
    return BandGeometry(
        S=S, W=W, m=m, w=w,
        excl=m // 4 if excl is None else excl,
        tr=tr, tc=tc,
        wc=w if wc is None else wc,
    )


def seed_qt(stats, r0: int, c0: int, W: int, m: int, dtype=None) -> torch.Tensor:
    """Exact QT seed for row r0 against columns [c0, c0+W):

    ``QT(r0, c) = sum_j (T[r0+j] - mu[r0]) (T[c+j] - mu[c])``.  This closed
    form replaces the reference's row-serial QT carry and makes bands
    independent.

    It is evaluated in mpx's cancellation-resistant form: with a centered
    query ``qc = T[r0:r0+m] - mu[r0]`` and the column segment re-based to
    its own mean ``g``,

        QT(r0, c) = SDP(qc, T[seg] - g) - (mu[c] - g) * sum(qc),

    so every product is O(local deviation) and float32 keeps ~sqrt(m) ulps
    of the result.  ``dtype`` (default: the statistics') is the type it is
    computed in."""
    r0, c0 = int(r0), int(c0)
    dt = stats.T.dtype if dtype is None else dtype
    qc = stats.T[r0 : r0 + m].to(dt) - stats.mu[r0].to(dt)
    seg = stats.T[c0 : c0 + W + m - 1].to(dt)
    g = seg.mean()
    sdp = sliding_dot_product(qc, seg - g)
    # sum(qc) is ~0 up to rounding; the correction keeps the identity exact.
    return sdp - (stats.mu[c0 : c0 + W].to(dt) - g) * qc.sum()
