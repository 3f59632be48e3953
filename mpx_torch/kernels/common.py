"""Shared band-sweep kernel contract, counterpart of ``mpx/kernels/common.py``.

A *job* sweeps the rectangle rows ``[r0, r0+S)`` x columns
``[c0, c0+W)`` of the self-join, ``c0 = r0 + k0``.  Outputs are
(value, index) aggregate pairs:

* ``row`` — (S,)  row aggregates for rows r0..r0+S
* ``col`` — (W,)  column aggregates for columns c0..c0+W

The driver max-merges these windows into global row/column profiles, so
jobs may run in any order.

Masking rules (per pair (r, c)):

* in-bounds:      r <= w-1 and c <= wc-1   (w = n - m + 1)
* exclusion zone: c - r >= excl            (excl = m // 4)
* finite stats:   inv[r] and inv[c] finite (zero-variance windows never match)

Masked pairs contribute the aggregate init (-1e12), never 0: a masked 0
would beat genuine negative correlations.
"""

from __future__ import annotations

from typing import NamedTuple

from mpx_torch.types import Aggregates


class BandOut(NamedTuple):
    row: Aggregates  # (S,) rows r0 .. r0+S
    col: Aggregates  # (W,) columns c0 .. c0+W


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
