"""Sum-threshold and frequency profiles (SCAMP's SUM_THRESH analog).

Counterpart of ``mpx/thresh.py``: per window, the sum of its Pearson
correlations to every non-trivial neighbor strictly above a threshold,
and the count of those neighbors.  The tile is the masked tile of the
1-NN tiers (:func:`mpx_torch.kernels.mxu.job_correlations`: exclusion
zone, bounds and zero-variance windows masked alike); only the epilogue
changes, a masked sum and a count per row and per column.  Each valid pair
is visited once on the job grid, so sums and int32 counts add across jobs.
mpx computes it in XLA, not Pallas; here it runs as torch ops, on the
card unless ``device="cpu"``.  mpx's watchdog grouping of the jobs is not
ported (ROADMAP "Not to port").
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mpx_torch.abjoin import ab_inputs, ab_jobs, unit_windows
from mpx_torch.config import MatrixProfileConfig, config_for, make_job_grid
from mpx_torch.dtypes import torch_dtype
from mpx_torch.kernels.common import NO_EXCL, band_geometry
from mpx_torch.kernels.mxu import job_correlations
from mpx_torch.ops.precompute import precompute_statistics


def _check(config: MatrixProfileConfig, threshold: float) -> None:
    if not -1.0 <= threshold <= 1.0:
        raise ValueError(f"threshold must be in [-1, 1], got {threshold}")
    if config.num_shards and config.num_shards > 1:
        raise ValueError("the sum-threshold tier is single-device; drop num_shards")
    if config.kernel not in ("auto", "mxu"):
        raise ValueError("the sum-threshold tier has one kernel (windows matmul); use "
                         "kernel='auto'")


def _add_job(sums, cnts, Pm: torch.Tensor, thr: torch.Tensor, r0: int, c0=None) -> None:
    """Add a masked tile's pairs above ``thr`` to the rows' sums and counts
    at ``r0`` and, with ``c0``, to the columns' at ``c0``.  A masked pair
    holds AGGREGATE_INIT, below any threshold."""
    hit = Pm > thr
    Ph = torch.where(hit, Pm, torch.zeros((), dtype=Pm.dtype, device=Pm.device))
    S, W = Pm.shape
    sums[r0 : r0 + S] += Ph.sum(dim=1)
    cnts[r0 : r0 + S] += hit.sum(dim=1, dtype=torch.int32)
    if c0 is not None:
        sums[c0 : c0 + W] += Ph.sum(dim=0)
        cnts[c0 : c0 + W] += hit.sum(dim=0, dtype=torch.int32)


def compute_sum_thresh(T, m: Optional[int] = None, *,
                       config: Optional[MatrixProfileConfig] = None,
                       threshold: float = 0.0):
    """Sum-threshold and frequency profile of the self-join of ``T``:
    (sums (w,) in the compute dtype, counts (w,) int32) on
    ``config.device``."""
    config = config_for(m, config)
    m = config.m
    _check(config, threshold)
    T = config.prepare_series(T)
    w = T.shape[0] - m + 1
    config = config.shrink_to(w)
    S, W = config.band, config.chunk
    dt = torch_dtype(config.dtype)
    device = torch.device(config.device)
    stats = precompute_statistics(T, m, band=S, chunk=W, dtype=dt, device=device)
    geom = band_geometry(S, W, m, w, config.tile_rows, config.tile_cols)
    thr = torch.tensor(float(threshold), dtype=dt, device=device)
    sums = torch.zeros(w + S + W, dtype=dt, device=device)
    cnts = torch.zeros(w + S + W, dtype=torch.int32, device=device)
    grid = make_job_grid(w, S, W)
    for r0, k0 in zip(grid.r0.tolist(), grid.k0.tolist()):
        _add_job(sums, cnts, job_correlations(stats, r0, r0 + k0, geom, dt), thr, r0, r0 + k0)
    return sums[:w], cnts[:w]


def compute_sum_thresh_ab(A, B, m: Optional[int] = None, *,
                          config: Optional[MatrixProfileConfig] = None,
                          threshold: float = 0.0):
    """Sum-threshold and frequency profile of the AB-join: per window of
    ``A``, the sum of its correlations to the windows of ``B`` strictly
    above ``threshold`` and their count (credited to the A side only, as
    pyscamp's ``abjoin_sum``); no exclusion zone."""
    config = config_for(m, config)
    m = config.m
    _check(config, threshold)
    A, B, wa, wb, config = ab_inputs(A, B, config)
    S, W = config.band, config.chunk
    dt = torch_dtype(config.dtype)
    device = torch.device(config.device)
    stats_a, stats_b = (precompute_statistics(X, m, band=S, chunk=W, dtype=dt, device=device)
                        for X in (A, B))
    geom = band_geometry(S, W, m, wa, config.tile_rows, config.tile_cols, wc=wb,
                         excl=NO_EXCL)
    thr = torch.tensor(float(threshold), dtype=dt, device=device)
    sums = torch.zeros(wa + S, dtype=dt, device=device)
    cnts = torch.zeros(wa + S, dtype=torch.int32, device=device)
    for r0, c0 in zip(*(x.tolist() for x in ab_jobs(wa, wb, S, W))):
        _add_job(sums, cnts, job_correlations(stats_a, r0, c0, geom, dt, stats_b), thr, r0)
    return sums[:wa], cnts[:wa]


def _oracle(P: np.ndarray, valid: np.ndarray, threshold: float):
    hit = valid & (np.nan_to_num(P, nan=-np.inf) > threshold)
    return np.where(hit, P, 0.0).sum(axis=1), hit.sum(axis=1).astype(np.int64)


def brute_force_sum_thresh(T, m: int, threshold: float = 0.0):
    """O(n^2) numpy oracle: the masked correlation matrix's sums and counts
    above the threshold (exclusion zone ``|i - j| >= m // 4``)."""
    Z = unit_windows(np.asarray(T, np.float64), m)
    w = Z.shape[0]
    i = np.arange(w)
    return _oracle(Z @ Z.T, np.abs(i[:, None] - i[None, :]) >= m // 4, threshold)


def brute_force_sum_thresh_ab(A, B, m: int, threshold: float = 0.0):
    """O(wa * wb * m) numpy oracle of the AB sum-threshold profile."""
    Za, Zb = (unit_windows(np.asarray(X, np.float64), m) for X in (A, B))
    return _oracle(Za @ Zb.T, np.ones((Za.shape[0], Zb.shape[0]), bool), threshold)
