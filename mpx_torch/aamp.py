"""Non-normalized (raw Euclidean) matrix profiles: the AAMP variant.

Counterpart of ``mpx/aamp.py``.  For each window, the smallest raw
Euclidean distance to another window (outside the exclusion zone
``m // 4``; an AB-join has none) and that window's index, the smallest
on a tie.  No window is masked for its variance: a constant window has a
well-defined raw distance.  The job grid, the tile and the merges are the
z-normalized tiers': one windows product per job, then a reduction of
the tile to row and column maxima, max-merged across jobs.

mpx scores a pair as ``2 dot - ssq_c`` (``D^2 = ssq_r - score``) over
windows of the series centered once, globally.  On a long drifting series
the window level then dwarfs its shape: at n = 2^20 a random walk sits
~1e3 from its mean, ``ssq`` is ~4e8 and one float32 rounding of it is
~16, against the D^2 of ~2.5e3 of a nearest neighbor.  The port
computes the same D^2 with each window centered on its own mean,

    D^2(r, c) = ssqc_r + ssqc_c - 2 dotc(r, c) + m (mu_r - mu_c)^2,

(``dotc`` the product of the centered windows, ``ssqc`` their squared
norms, both O(local deviation)), an identity of the raw distance, and
carries ``-D^2`` as the score: the aggregate floor is ``-inf`` (raw
scores are unbounded below, so the z-normalized tiers' -1e12 sentinel
would clobber valid large-amplitude pairs).  ``chip_smoke.py`` phase 26
measures mpx's form and the port's against an exact scan.

mpx computes this tier in XLA, not Pallas, so it runs as torch ops here:
``torch.matmul`` of panels sliced from one centered-window matrix in the
compute dtype (1 GiB in float32 at n = 2^20), float32 products in full
FP32, on the card unless ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mpx_torch.config import MatrixProfileConfig, config_for, make_job_grid
from mpx_torch.dtypes import full_precision_matmul, torch_dtype
from mpx_torch.ops.aggregates import (init_aggregates, merge_aggregates, merge_window,
                                      reduce_first)
from mpx_torch.ops.precompute import _padded_width
from mpx_torch.types import Aggregates

_KERNELS = ("auto", "mxu")
# Windows of one block of the host's sums of squares and of the device's
# window matrix.
_BLOCK = 1 << 16


def _check(config: MatrixProfileConfig) -> None:
    if (config.num_shards or 1) > 1:
        raise ValueError("the raw-distance (AAMP) tier is single-device; drop num_shards")
    if config.kernel not in _KERNELS:
        raise ValueError("the raw-distance (AAMP) tier has one kernel (raw-windows "
                         "matmul); use kernel='auto'")


class _Operand:
    """One series staged for the raw tiles: the centered windows ``U``
    ((pw, m), the compute dtype, zero past ``w``), their means ``mu`` and
    squared norms ``ssq`` (pw,), each computed in float64 on the host and
    cast."""

    def __init__(self, T64: np.ndarray, m: int, pw: int, dt, device):
        w = T64.shape[0] - m + 1
        wins = np.lib.stride_tricks.sliding_window_view(T64, m)
        mu, ssq = np.zeros(pw), np.zeros(pw)
        for o in range(0, w, _BLOCK):
            v = wins[o : o + _BLOCK]
            mu[o : o + v.shape[0]] = v.mean(axis=1)
            c = v - mu[o : o + v.shape[0], None]
            ssq[o : o + v.shape[0]] = np.einsum("ij,ij->i", c, c)
        T = torch.as_tensor(T64, device=device)
        mu64 = torch.as_tensor(mu, device=device)
        self.U = torch.zeros((pw, m), dtype=dt, device=device)
        for o in range(0, w, _BLOCK):
            e = min(o + _BLOCK, w)
            self.U[o:e] = (T.unfold(0, m, 1)[o:e] - mu64[o:e, None]).to(dt)
        self.mu, self.ssq = mu64.to(dt), torch.as_tensor(ssq, device=device).to(dt)


def _scores(a: _Operand, b: _Operand, r0: int, c0: int, S: int, W: int, m: int,
            valid) -> torch.Tensor:
    """The (S, W) tile of ``-D^2`` between windows r0.. of ``a`` and c0..
    of ``b``, ``-inf`` where ``valid`` (a mask, or None for all) fails."""
    with full_precision_matmul():
        P = a.U[r0 : r0 + S] @ b.U[c0 : c0 + W].T
    dmu = torch.sub(a.mu[r0 : r0 + S, None], b.mu[None, c0 : c0 + W]).square_()
    P.mul_(2).sub_(dmu, alpha=m)
    del dmu
    P.sub_(a.ssq[r0 : r0 + S, None]).sub_(b.ssq[None, c0 : c0 + W])
    return P if valid is None else P.masked_fill_(~valid, -torch.inf)


def _reduce(P: torch.Tensor, r0: int, c0: int):
    """Row and column maxima of a score tile with the first (smallest)
    index of each; -1 where a row or column has no valid pair."""
    return reduce_first(P, 1, c0), reduce_first(P, 0, r0)


def _distances(agg: Aggregates, w: int):
    v = agg.value[:w]
    D = torch.where(torch.isfinite(v), torch.sqrt(torch.clamp(-v, min=0.0)), torch.inf)
    return D, agg.index[:w].to(torch.int32)


def compute_aamp_profile(T, m: Optional[int] = None, *,
                         config: Optional[MatrixProfileConfig] = None):
    """Raw-Euclidean (non-normalized) self-join profile of ``T``.

    Returns (D, I) on ``config.device``: ``D[i]`` the smallest raw
    Euclidean distance from window i to any window outside the exclusion
    zone (the compute dtype), ``I[i]`` its index (int32, the smallest on a
    tie).  The same job grid and knobs as the z-normalized self-join; the
    series is quantized first when ``config.input_quant`` is set."""
    config = config_for(m, config)
    _check(config)
    m = config.m
    T64 = config.prepare_series(T)
    w = T64.shape[0] - m + 1
    config = config.shrink_to(w)
    S, W = config.band, config.chunk
    dt, dev = torch_dtype(config.dtype), torch.device(config.device)
    excl = m // 4
    op = _Operand(T64 - T64.mean(), m, _padded_width(w, S, W), dt, dev)
    rows, cols = (init_aggregates(w + S + W, dt, -torch.inf, dev) for _ in range(2))
    iS = torch.arange(S, dtype=torch.int32, device=dev)
    iW = torch.arange(W, dtype=torch.int32, device=dev)
    grid = make_job_grid(w, S, W)
    for r0, k0 in zip(grid.r0.tolist(), grid.k0.tolist()):
        c0 = r0 + k0
        valid = None
        # Only a job that reaches the zone or the bounds masks anything.
        if c0 - (r0 + S - 1) < excl or c0 + W > w or r0 + S > w:
            r, c = r0 + iS[:, None], c0 + iW[None, :]
            valid = (c - r >= excl) & (r <= w - 1) & (c <= w - 1)
        row, col = _reduce(_scores(op, op, r0, c0, S, W, m, valid), r0, c0)
        merge_window(rows, row, r0)
        merge_window(cols, col, c0)
    merged = merge_aggregates(Aggregates(rows.value[:w], rows.index[:w]),
                              Aggregates(cols.value[:w], cols.index[:w]))
    return _distances(merged, w)


def compute_aamp_ab_join(A, B, m: Optional[int] = None, *,
                         config: Optional[MatrixProfileConfig] = None):
    """Raw-Euclidean AB-join: both directional profiles of ``A`` against
    ``B`` without z-normalization and without an exclusion zone.  Returns
    an :class:`mpx_torch.abjoin.ABJoinResult` on ``config.device``:
    ``mp_a[i]`` the smallest raw distance from A's window i to any of B's,
    ``mpi_a[i]`` that window (int32), and the same from B to A.  Both
    series are quantized first when ``config.input_quant`` is set, as in
    the port's other AB-joins (mpx's raw AB-join leaves them as given)."""
    from mpx_torch.abjoin import ABJoinResult, ab_inputs, ab_jobs

    config = config_for(m, config)
    _check(config)
    m = config.m
    A64, B64, wa, wb, config = ab_inputs(A, B, config)
    S, W = config.band, config.chunk
    dt, dev = torch_dtype(config.dtype), torch.device(config.device)
    # A shift common to both series cancels in a - b: center by the joint
    # mean before the cast (mpx's rule; each window is then centered on
    # its own mean as well, see the module docstring).
    g = np.concatenate([A64, B64]).mean()
    # Rows r0 < wa step by S and columns c0 < wb by W: their panels end
    # within the widths rounded up to S and W.
    a = _Operand(A64 - g, m, -(-wa // S) * S, dt, dev)
    b = _Operand(B64 - g, m, -(-wb // W) * W, dt, dev)
    rows = init_aggregates(wa + S, dt, -torch.inf, dev)
    cols = init_aggregates(wb + W, dt, -torch.inf, dev)
    iS = torch.arange(S, dtype=torch.int32, device=dev)
    iW = torch.arange(W, dtype=torch.int32, device=dev)
    for r0, c0 in zip(*(x.tolist() for x in ab_jobs(wa, wb, S, W))):
        valid = None
        if r0 + S > wa or c0 + W > wb:
            valid = ((r0 + iS[:, None]) <= wa - 1) & ((c0 + iW[None, :]) <= wb - 1)
        row, col = _reduce(_scores(a, b, r0, c0, S, W, m, valid), r0, c0)
        merge_window(rows, row, r0)
        merge_window(cols, col, c0)
    (Da, Ia), (Db, Ib) = _distances(rows, wa), _distances(cols, wb)
    return ABJoinResult(mp_a=Da, mpi_a=Ia, mp_b=Db, mpi_b=Ib)


def aamp_mpdist(A, B, m: int, *, threshold: float = 0.05,
                config: Optional[MatrixProfileConfig] = None) -> float:
    """Raw-Euclidean MPdist (STUMPY's ``aampdist``): the k-th smallest
    value of the concatenated raw ABBA profiles, k = ceil(threshold *
    (len(A) + len(B)))."""
    from mpx_torch.analysis import mpdist_from_profiles

    res = compute_aamp_ab_join(A, B, m, config=config)
    return mpdist_from_profiles(res.mp_a, res.mp_b, np.asarray(A).shape[0],
                                np.asarray(B).shape[0], threshold=threshold)
