"""Pooled distance-matrix summaries (SCAMP's matrix summaries).

Counterpart of ``mpx/distmatrix.py``: the whole (w x wc) pairwise matrix
of a self-join (or of an AB-join, rows from ``A``, columns from ``B``)
reduced to an (mheight x mwidth) summary whose cell holds the largest
Pearson correlation over the pairs that pool into it, or the matching
smallest z-normalized distance: a heatmap of the whole join at any n.

A job is a square S = min(band, chunk) tile of the shared masked tile
(:func:`mpx_torch.kernels.mxu.job_correlations`, float32, full FP32
products), with mpx's two-sided exclusion zone ``|c - r| >= m // 4``, so a
diagonal tile keeps its pairs below the diagonal too.  The self-join
sweeps the upper-triangle grid and merges every tile also transposed (the
matrix is symmetric); the AB-join sweeps the full rectangle grid, with no
exclusion zone.  A tile pools to its cells by ``amax`` over row and column
groups: a padded reshape when a pool is narrower than the tile, slices at
the (at most one) cell boundary otherwise.  Cells with no valid pair read
-1 (distance ``sqrt(4m)``).  mpx computes this tier in XLA, not Pallas:
torch ops here, on the card unless ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mpx_torch.config import MatrixProfileConfig, config_for, make_job_grid
from mpx_torch.dtypes import AGGREGATE_INIT
from mpx_torch.kernels.common import band_geometry
from mpx_torch.kernels.mxu import job_correlations
from mpx_torch.ops.precompute import precompute_statistics, precompute_statistics_numpy


def _pool(X: torch.Tensor, o: int, pool: int) -> torch.Tensor:
    """Max-pool axis 0 of ``X`` (rows o.., o + len(X)) by ``pool``: one row
    per cell touched, from cell ``o // pool`` on."""
    S = X.shape[0]
    lead = o % pool
    if pool >= S:
        # At most two cells: split at the boundary.
        cut = pool - lead
        return X.amax(dim=0, keepdim=True) if cut >= S else torch.stack(
            [X[:cut].amax(dim=0), X[cut:].amax(dim=0)])
    cells = -(-(lead + S) // pool)
    padded = X.new_full((cells * pool, X.shape[1]), AGGREGATE_INIT)
    padded[lead : lead + S] = X
    return padded.view(cells, pool, X.shape[1]).amax(dim=1)


def _pool_tile(X: torch.Tensor, r0: int, c0: int, ph: int, pw: int) -> torch.Tensor:
    """The cells of tile ``X`` (rows r0.., columns c0..), from cell (r0 //
    ph, c0 // pw) on."""
    return _pool(_pool(X, r0, ph).T, c0, pw).T


def _merge(out: torch.Tensor, block: torch.Tensor, i: int, j: int) -> None:
    """Max-merge pooled cells into the summary ``out`` at (i, j), in place
    (cells past its edge hold only masked pairs)."""
    cur = out[i : i + block.shape[0], j : j + block.shape[1]]
    torch.maximum(cur, block[: cur.shape[0], : cur.shape[1]], out=cur)


def pooled_matrix(A, m: Optional[int] = None, *, mwidth: int = 50, mheight: int = 50,
                  B=None, pearson: bool = False,
                  config: Optional[MatrixProfileConfig] = None) -> np.ndarray:
    """(mheight, mwidth) pooled summary of the self-join of ``A`` (or of
    the AB-join rows-from-A x columns-from-B when ``B`` is given).

    Cell [i, j] covers rows ``i * ceil(w / mheight) ..`` and columns ``j *
    ceil(wc / mwidth) ..`` and holds the largest Pearson correlation of its
    valid pairs (``pearson=True``) or the matching smallest z-normalized
    distance ``sqrt(2m(1 - p))`` (default); a cell with no valid pair reads
    -1.0 / ``sqrt(4m)``.  Returns float64 numpy, as mpx."""
    config = config_for(m, config)
    m = config.m
    if mwidth < 1 or mheight < 1:
        raise ValueError("mwidth/mheight must be >= 1")
    if (config.num_shards or 1) > 1:
        raise ValueError("the matrix-summary tier is single-device; drop num_shards")
    if config.kernel not in ("auto", "mxu"):
        raise ValueError("the matrix-summary tier has one kernel (windows matmul); use "
                         "kernel='auto'")
    A = config.prepare_series(A)
    w = A.shape[0] - m + 1
    B = None if B is None else config.prepare_series(B)
    wc = w if B is None else B.shape[0] - m + 1
    config = config.shrink_to(max(w, wc))
    S = min(config.band, config.chunk)
    ph, pw = -(-w // mheight), -(-wc // mwidth)
    dev = torch.device(config.device)

    if B is None:
        grid = make_job_grid(w, S, S)
        jobs = zip(grid.r0.tolist(), (grid.r0 + grid.k0).tolist())
        excl, mirror = m // 4, True
    else:
        jobs = ((r0, c0) for r0 in range(0, w, S) for c0 in range(0, wc, S))
        excl, mirror = 0, False
    stats = precompute_statistics(A, m, band=S, chunk=S, dtype="float32", device=dev)
    stats_c = None if B is None else precompute_statistics(B, m, band=S, chunk=S,
                                                            dtype="float32", device=dev)
    geom = band_geometry(S, S, m, w, config.tile_rows, config.tile_cols, wc=wc, excl=excl)
    out = torch.full((mheight, mwidth), AGGREGATE_INIT, dtype=torch.float32, device=dev)
    for r0, c0 in jobs:
        X = job_correlations(stats, r0, c0, geom, "float32", stats_c, two_sided=True)
        block = _pool_tile(X, r0, c0, ph, pw)
        _merge(out, block, r0 // ph, c0 // pw)
        if mirror:
            # Square pools: the transposed tile's cells are the tile's.
            _merge(out, block.T if ph == pw else _pool_tile(X.T, c0, r0, ph, pw),
                   c0 // ph, r0 // pw)
    corr = out.double().clamp_(-1.0, 1.0).cpu().numpy()  # empty cells: the -1 floor
    if pearson:
        return corr
    return np.sqrt(np.maximum(2.0 * m * (1.0 - corr), 0.0))


def brute_force_pooled_matrix(A, m: int, *, mwidth: int = 50, mheight: int = 50, B=None,
                              pearson: bool = False) -> np.ndarray:
    """O(w * wc * m) numpy oracle (mpx's): exact pooled maxima of the dense
    float64 correlation matrix."""
    def units(X):
        s = precompute_statistics_numpy(X, m)
        fin = np.isfinite(s["inv"])
        U = (np.lib.stride_tricks.sliding_window_view(X, m) - s["mu"][:, None]) \
            * np.where(fin, s["inv"], 0.0)[:, None]
        return U, fin

    A = np.asarray(A, np.float64)
    Ua, fin_a = units(A)
    if B is None:
        Ub, fin_b, excl = Ua, fin_a, m // 4
    else:
        (Ub, fin_b), excl = units(np.asarray(B, np.float64)), 0
    w, wc = Ua.shape[0], Ub.shape[0]
    P = Ua @ Ub.T
    r, c = np.arange(w)[:, None], np.arange(wc)[None, :]
    P = np.where((np.abs(c - r) >= excl) & fin_a[:, None] & fin_b[None, :], P, -2.0)
    ph, pw = -(-w // mheight), -(-wc // mwidth)
    out = np.full((mheight, mwidth), -2.0)
    for i in range(0, w, ph):
        for j in range(0, wc, pw):
            out[i // ph, j // pw] = P[i : i + ph, j : j + pw].max()
    out = np.clip(out, -1.0, 1.0)
    if pearson:
        return out
    return np.sqrt(np.maximum(2.0 * m * (1.0 - out), 0.0))
