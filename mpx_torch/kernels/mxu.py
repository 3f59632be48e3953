"""Band sweep as a windows matmul: the plain PyTorch version of K1.

Counterpart of ``mpx/kernels/mxu.py:sweep_band_mxu``.  With unit-normalized
windows ``u_i = (T[i:i+m] - mu_i) * inv_i`` the Pearson correlation is a
dot product, so a job's (S x W) correlation tile is one matmul
``U_r @ U_c^T``; it is then masked and reduced to row and column
max/argmax with the smallest index winning ties.

This is the semantic reference of the fused CUDA kernel
(:mod:`mpx_torch.kernels.mxu_fused`), the path every CPU tensor takes,
and a deliberate user choice (``kernel='mxu'``) on the card.  It
materializes the whole tile in device memory.  Every sweep takes an
optional ``stats_c``: the column axis's statistics, an AB-join's second
series (mpx's ``stats_c``), bounded by ``geom.wc``.  The masked tile
itself (:func:`job_correlations`) is shared with the top-k and
sum-threshold epilogues.

The hybrid tier's float32 passes live here too (counterparts of mpx's
``sweep_band_max``, ``sweep_band_suspects`` and
``sweep_band_suspects_sparse``): the value-only max sweep (pass A's plain
version) and the suspect captures of pass B, as torch ops.  mpx lowers
them through XLA, not Pallas; their products are ``torch.matmul`` of
float32 panels in full FP32 (:func:`mpx_torch.dtypes.full_precision_matmul`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mpx_torch.dtypes import AGGREGATE_INIT, INDEX_INIT, full_precision_matmul, torch_dtype
from mpx_torch.kernels.common import BandGeometry, BandOut
from mpx_torch.types import Aggregates, Stats

# Calls of sweep_band_mxu and sweep_band_max, the plain versions of K1's
# sweep (a plain count; reset by whoever reads it).
CALLS = 0

# Sentinels for suspect-index capture (min-merged / max-merged).
SUSPECT_MIN_INIT = 2**30
SUSPECT_MAX_INIT = -1
# Suspect capture width per side: the K smallest and K largest suspect
# indices are kept per subsequence, so any count <= 2K is captured whole.
SUSPECT_K = 4
# Gathered pass-B panels are padded to a multiple of this many rows (and
# at least this many): the CPU's BLAS then gives each gathered row the
# bits it has in the full tile's product (it does not for a handful of
# rows), which keeps the sparse and the dense capture identical there.
PANEL_ROWS = 32


class SuspectWindow(NamedTuple):
    """Per-subsequence suspect summary: how many valid pairs reach the
    threshold, and the SUSPECT_K smallest (``mn``, ascending,
    SUSPECT_MIN_INIT pad) and largest (``mx``, descending, SUSPECT_MAX_INIT
    pad) neighbor indices among them.  Every field merges associatively
    (sum / k-smallest / k-largest), so the captured set is exact whenever
    the total count is <= 2 * SUSPECT_K."""

    cnt: torch.Tensor  # (L,) int32
    mn: torch.Tensor   # (L, SUSPECT_K) int32
    mx: torch.Tensor   # (L, SUSPECT_K) int32


class SuspectOut(NamedTuple):
    row: SuspectWindow  # subsequences of the job's rows, suspects among its columns
    col: SuspectWindow  # subsequences of the job's columns, suspects among its rows


def _columns(stats: Stats, stats_c: Stats | None) -> Stats:
    """The statistics of the column axis: ``stats_c`` (an AB-join's second
    series) or, for a self-join, ``stats`` itself."""
    return stats if stats_c is None else stats_c


def job_correlations(stats: Stats, r0: int, c0: int, geom: BandGeometry, dtype,
                     stats_c: Stats | None = None, two_sided: bool = False) -> torch.Tensor:
    """The shared (S, W) correlation tile of rows ``r0..`` and columns
    ``c0..`` (of ``stats_c`` when given: the AB-join), masked: every pair
    that :func:`pair_mask` rejects (with its ``two_sided`` exclusion zone)
    holds AGGREGATE_INIT.  Counterpart of mpx's ``_job_correlations``; the
    float32 product runs in full FP32."""
    U, Uc = stats.windows, _columns(stats, stats_c).windows
    if U is None or Uc is None:
        raise ValueError("stats.windows is required (see ops.precompute)")
    dt = torch_dtype(dtype)
    if U.dtype != dt or Uc.dtype != dt:
        raise ValueError(f"stats are {U.dtype}/{Uc.dtype}, sweep asked for {dt}")
    r0, c0 = int(r0), int(c0)
    with full_precision_matmul():
        P = U[r0 : r0 + geom.S] @ Uc[c0 : c0 + geom.W].T
    return _mask(P, stats, r0, c0, geom, stats_c, two_sided)


def _mask(P: torch.Tensor, stats: Stats, r0: int, c0: int, geom: BandGeometry,
          stats_c: Stats | None = None, two_sided: bool = False) -> torch.Tensor:
    """``P`` (rows r0.., columns c0..) with its invalid pairs set to
    AGGREGATE_INIT, in place."""
    S, W = P.shape
    rows = torch.arange(r0, r0 + S, dtype=torch.int32, device=P.device)
    cols = torch.arange(c0, c0 + W, dtype=torch.int32, device=P.device)
    valid = pair_mask(stats, rows, cols, geom, stats_c, two_sided)
    return P.masked_fill_(~valid, AGGREGATE_INIT)


def sweep_band_mxu(stats: Stats, r0: int, k0: int, geom: BandGeometry,
                   dtype, stats_c: Stats | None = None) -> BandOut:
    global CALLS
    CALLS += 1
    r0 = int(r0)
    c0 = r0 + int(k0)
    return _reduce(job_correlations(stats, r0, c0, geom, dtype, stats_c), r0, c0)


def reduce_tile(P: torch.Tensor, stats: Stats, r0: int, c0: int,
                geom: BandGeometry, stats_c: Stats | None = None) -> BandOut:
    """Mask the (S, W) correlation tile of rows r0.. and columns c0.. (in
    place) and reduce it to row and column max with the smallest index
    winning ties."""
    return _reduce(_mask(P, stats, r0, c0, geom, stats_c), r0, c0)


def _reduce(Pm: torch.Tensor, r0: int, c0: int) -> BandOut:
    """Row and column max of a masked tile, the smallest index on a tie."""
    dt, dev = Pm.dtype, Pm.device
    S, W = Pm.shape
    rows = torch.arange(r0, r0 + S, dtype=torch.int32, device=dev)
    cols = torch.arange(c0, c0 + W, dtype=torch.int32, device=dev)
    init_v = torch.tensor(AGGREGATE_INIT, dtype=dt, device=dev)

    # max + first-occurrence index via an iota-min over the tie mask.
    big = torch.tensor(2**30, dtype=torch.int32, device=dev)
    none = torch.tensor(INDEX_INIT, dtype=torch.int32, device=dev)
    row_v = Pm.amax(dim=1)
    ri = torch.where(Pm == row_v[:, None], cols[None, :], big).amin(dim=1)
    row_i = torch.where(row_v > init_v, ri, none)
    col_v = Pm.amax(dim=0)
    ci = torch.where(Pm == col_v[None, :], rows[:, None], big).amin(dim=0)
    col_i = torch.where(col_v > init_v, ci, none)
    return BandOut(row=Aggregates(row_v, row_i), col=Aggregates(col_v, col_i))


def pair_mask(stats: Stats, rows: torch.Tensor, cols: torch.Tensor,
              geom: BandGeometry, stats_c: Stats | None = None,
              two_sided: bool = False) -> torch.Tensor:
    """(len(rows), len(cols)) mask of the valid pairs: ``c - r >= excl``
    (the upper triangle of a self-join; an AB-join's excl lets every pair
    pass) or, ``two_sided``, ``|c - r| >= excl`` (a tile that straddles the
    diagonal keeps its pairs below it: mpx's ``two_sided``), ``r <= w - 1``,
    ``c <= wc - 1``, both windows of finite inverse norm (the columns'
    from ``stats_c`` when given).  ``rows``/``cols`` are global int32
    window indices."""
    fin_r = torch.isfinite(stats.inv.index_select(0, rows))[:, None]
    fin_c = torch.isfinite(_columns(stats, stats_c).inv.index_select(0, cols))[None, :]
    r, c = rows[:, None], cols[None, :]
    zone = (c - r).abs() >= geom.excl if two_sided else c - r >= geom.excl
    return zone & (r <= geom.w - 1) & (c <= geom.wc - 1) & fin_r & fin_c


def sweep_band_max(stats: Stats, r0: int, k0: int, geom: BandGeometry,
                   stats_c: Stats | None = None):
    """Value-only band sweep in the windows' dtype, the plain version of
    pass A: per-row and per-column max correlation of the masked tile, no
    index.  Returns ((S,) row maxima, (W,) column maxima), AGGREGATE_INIT
    where a row or column has no valid pair."""
    global CALLS
    CALLS += 1
    if stats.windows is None:
        raise ValueError("stats.windows is required (see ops.precompute)")
    r0 = int(r0)
    Pm = job_correlations(stats, r0, r0 + int(k0), geom, stats.windows.dtype, stats_c)
    return Pm.amax(dim=1), Pm.amax(dim=0)


def suspect_reduce(hit: torch.Tensor, idx: torch.Tensor, dim: int) -> SuspectWindow:
    """Summarize a hit mask along ``dim``: the count, and the SUSPECT_K
    smallest and largest of ``idx`` where it hits.  ``idx`` is the
    ascending (int32) window index of each position along ``dim``, so the
    K smallest hits are the first K and the K largest the last K: one
    running count ranks every hit, and a binary search per slot finds the
    position of the k-th.  Returns one summary per entry of the other
    axis."""
    K = SUSPECT_K
    rank = (hit if dim == 1 else hit.T).cumsum(1, dtype=torch.int32).contiguous()
    R, C = rank.shape
    cnt = rank[:, -1]
    k = torch.arange(K, dtype=torch.int32, device=hit.device)
    first = torch.searchsorted(rank, (k + 1).repeat(R, 1))
    last = torch.searchsorted(rank, (cnt[:, None] - k).clamp_min(1))
    found = k[None, :] < cnt[:, None]
    mn = torch.where(found, idx[first.clamp_max(C - 1)], SUSPECT_MIN_INIT)
    mx = torch.where(found, idx[last.clamp_max(C - 1)], SUSPECT_MAX_INIT)
    return SuspectWindow(cnt.contiguous(), mn, mx)


def sweep_band_suspects(stats: Stats, r0: int, k0: int, geom: BandGeometry,
                        thr: torch.Tensor, thr_col=None,
                        stats_c: Stats | None = None) -> SuspectOut:
    """Dense pass-B job: recompute the float32 tile and summarize, per
    subsequence, every valid pair whose correlation reaches ``thr`` (its
    global float32 maximum less twice the hybrid's margin).  The job grid
    covers each valid pair once, so counts add across jobs.  ``thr_col``
    (default ``thr``) is the column side's own threshold (the left/right
    profiles: rows find later neighbors, columns earlier ones; the
    AB-join: the second series' windows, ``stats_c``).  A threshold is
    above AGGREGATE_INIT, so the masked pairs never reach it."""
    S, W = geom.S, geom.W
    thr_c = thr if thr_col is None else thr_col
    r0 = int(r0)
    c0 = r0 + int(k0)
    Pm = job_correlations(stats, r0, c0, geom, torch.float32, stats_c)
    dev = Pm.device
    rows = torch.arange(r0, r0 + S, dtype=torch.int32, device=dev)
    cols = torch.arange(c0, c0 + W, dtype=torch.int32, device=dev)
    row = suspect_reduce(Pm >= thr[r0 : r0 + S, None], cols, 1)
    col = suspect_reduce(Pm >= thr_c[None, c0 : c0 + W], rows, 0)
    return SuspectOut(row=row, col=col)


def panel_rows(count: int) -> int:
    """Rows of a gathered panel that holds ``count`` flagged windows."""
    return max(PANEL_ROWS, -(-count // PANEL_ROWS) * PANEL_ROWS)


def compact_flags(flags: torch.Tensor, F: int) -> torch.Tensor:
    """Local indices of the set ``flags``, ascending, in F slots padded
    with ``len(flags)``: a running count ranks the set flags and a binary
    search finds the k-th, so the host never waits for the device."""
    rank = torch.cumsum(flags, 0, dtype=torch.int32)
    k = torch.arange(1, F + 1, dtype=torch.int32, device=flags.device)
    return torch.searchsorted(rank, k)


def sweep_band_suspects_sparse(stats: Stats, r0: int, k0: int, jrow: torch.Tensor,
                               jcol: torch.Tensor, geom: BandGeometry,
                               thr: torch.Tensor, nr: int, nc: int, thr_col=None,
                               stats_c: Stats | None = None):
    """Sparse pass-B job: re-examine only the rows and columns whose pass-A
    job maxima (``jrow`` (S,), ``jcol`` (W,)) reach the threshold.  A row
    below it provably holds no suspect in this job, so the (S x W) tile
    shrinks to a product of the flagged rows with the job's columns and
    one of the job's rows with the flagged columns.  ``nr``/``nc`` are the
    flag counts (known on the host); ``thr_col`` (default ``thr``) is the
    column side's threshold and ``stats_c`` the columns' statistics, as
    for :func:`sweep_band_suspects`.

    Returns (row side, column side), each (global window indices of the
    flagged rows / columns, their SuspectWindow), ``nr`` / ``nc`` long, or
    None when nothing is flagged there.

    A flagged window is a valid row or column (its threshold is finite), so
    only its partners are masked, and only by the tests this job's place
    can fail (the host knows which): the exclusion zone on the first
    chunk, the bounds past w - 1 (rows) or wc - 1 (columns), zero-variance
    partners always."""
    S, W, w, wc, excl = geom.S, geom.W, geom.w, geom.wc, geom.excl
    U, sc = stats.windows, _columns(stats, stats_c)
    Uc = sc.windows
    thr_c = thr if thr_col is None else thr_col
    r0, c0 = int(r0), int(r0) + int(k0)
    dev = U.device
    rows = torch.arange(r0, r0 + S, dtype=torch.int32, device=dev)
    cols = torch.arange(c0, c0 + W, dtype=torch.int32, device=dev)
    zone = c0 - (r0 + S - 1) < excl  # some pair of the job lies in the zone
    out = []
    if nr:
        # Flagged rows x all W columns.  Pad slots (local index S) read the
        # window after the band and never hit: their threshold is +inf.
        rf = (r0 + compact_flags(jrow >= thr[r0 : r0 + S], panel_rows(nr))).to(torch.int32)
        t = thr.index_select(0, rf)
        t[nr:] = torch.inf
        with full_precision_matmul():
            P = U.index_select(0, rf) @ Uc[c0 : c0 + W].T
        hit = P >= t[:, None]
        ok = torch.isfinite(sc.inv[c0 : c0 + W])
        if c0 + W > wc:
            ok &= cols <= wc - 1
        hit &= ok[None, :]
        if zone:
            hit &= cols[None, :] - rf[:, None] >= excl
        win = suspect_reduce(hit, cols, 1)
        out.append((rf[:nr], SuspectWindow(*(a[:nr] for a in win))))
    else:
        out.append(None)
    if nc:
        cf = (c0 + compact_flags(jcol >= thr_c[c0 : c0 + W], panel_rows(nc))).to(torch.int32)
        t = thr_c.index_select(0, cf)
        t[nc:] = torch.inf
        with full_precision_matmul():
            P = U[r0 : r0 + S] @ Uc.index_select(0, cf).T
        hit = P >= t[None, :]
        ok = torch.isfinite(stats.inv[r0 : r0 + S])
        if r0 + S > w:
            ok &= rows <= w - 1
        hit &= ok[:, None]
        if zone:
            hit &= cf[None, :] - rows[:, None] >= excl
        win = suspect_reduce(hit, rows, 0)
        out.append((cf[:nc], SuspectWindow(*(a[:nc] for a in win))))
    else:
        out.append(None)
    return tuple(out)
