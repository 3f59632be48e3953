"""Top-k nearest-neighbor matrix profile.

Counterpart of ``mpx/topk.py``: for every window its k nearest
non-trivial neighbors, sorted by distance, on the same job grid and the
same masked tile as the 1-NN tiers (:func:`mpx_torch.kernels.mxu.job_correlations`),
with another epilogue: per job, the top k of each row and each column of
the tile; windows merge across jobs by concatenation and a new top k.  No
deduplication is needed: within a row, different jobs cover disjoint
columns, and the row side holds the later neighbors, the column side the
earlier ones.

mpx computes this tier in XLA, not Pallas, so it runs as torch ops here:
``torch.matmul`` for the product, on the card unless ``device="cpu"``.
float64 with ``kernel="hybrid"`` and k <= 2 * SUSPECT_K runs the top-k
hybrid (:func:`mpx_torch.hybrid.compute_topk_profile_f64_hybrid`: K1's
float32 pass A, then an exact float64 rescore of each row's suspects);
every other request takes the strict tile, which is exact on a card with
float64.  mpx's ``auto`` sends float64 with k <= 8 to its hybrid, because
the TPU has no float64; the port's ``auto`` keeps the strict tile
(ROADMAP queue 2 item 5 decides it on measurement).

**Tie order.** mpx's ``lax.top_k`` puts the lower position first among
equal values, and the merges concatenate the incumbent before the job's
window and the row side before the column side, so equal distances keep
a fixed order.  ``torch.topk`` leaves it unspecified; :func:`_topk_desc`
restores it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mpx_torch.abjoin import ab_inputs, ab_jobs, unit_windows
from mpx_torch.config import MatrixProfileConfig, config_for, make_job_grid
from mpx_torch.dtypes import AGGREGATE_INIT, INDEX_INIT, torch_dtype
from mpx_torch.kernels.common import NO_EXCL, band_geometry
from mpx_torch.kernels.mxu import job_correlations
from mpx_torch.kernels.mxu import SUSPECT_K
from mpx_torch.ops.precompute import precompute_statistics
from mpx_torch.utils.profile import phase


def _topk_desc(values: torch.Tensor, indices: torch.Tensor, k: int):
    """The k largest of ``values`` along the last axis, descending, the
    lower position first among equal values (``lax.top_k``'s order), and
    the entries of ``indices`` (broadcast against ``values``) at their
    positions.  Returns (values (..., k), indices (..., k)).

    ``torch.topk`` gives the k largest values; every entry above the k-th
    value is among its picks, but which of the entries equal to the k-th
    it takes, and the order of equal values, are unspecified.  So the
    entries equal to the k-th are found again by position (a running count
    of them, a binary search for the first ``need``), and the k picks are
    put in order by a stable sort of (position, then value)."""
    v, pos = values.topk(k, dim=-1)
    kth = v[..., -1:]
    above = v > kth
    need = k - above.sum(dim=-1, keepdim=True)  # slots for entries equal to the k-th
    rank = (values == kth).cumsum(dim=-1, dtype=torch.int32)
    slot = torch.arange(1, k + 1, dtype=torch.int32, device=values.device)
    tie_pos = torch.searchsorted(rank, slot.expand(*rank.shape[:-1], k).contiguous())
    # Candidates: topk's picks above the k-th value, then the first `need`
    # positions holding it; every other slot is pushed past the end.
    last = values.shape[-1]
    pos = torch.cat([torch.where(above, pos, last),
                     torch.where(slot <= need, tie_pos, last)], dim=-1)
    pos = pos.sort(dim=-1).values[..., :k]  # ascending positions
    val = values.gather(-1, pos)
    val, order = val.sort(dim=-1, descending=True, stable=True)
    pos = pos.gather(-1, order)
    return val, indices.expand(values.shape).gather(-1, pos)


def _merge_topk(gv: torch.Tensor, gi: torch.Tensor, wv: torch.Tensor, wi: torch.Tensor,
                offset: int, k: int) -> None:
    """Merge a job's (L, k) window into the global arrays at ``offset``,
    in place; the incumbent comes first among equal values."""
    cur_v, cur_i = gv[offset : offset + wv.shape[0]], gi[offset : offset + wv.shape[0]]
    v, i = _topk_desc(torch.cat([cur_v, wv], dim=1), torch.cat([cur_i, wi], dim=1), k)
    cur_v.copy_(v)
    cur_i.copy_(i)


def _to_distances(v: torch.Tensor, i: torch.Tensor, m: int) -> torch.Tensor:
    d = torch.sqrt(torch.clamp(2.0 * m * (1.0 - v), min=0.0))
    return torch.where(i >= 0, d, torch.inf)


def _init_topk(L: int, k: int, dt, device):
    return (torch.full((L, k), AGGREGATE_INIT, dtype=dt, device=device),
            torch.full((L, k), INDEX_INIT, dtype=torch.int32, device=device))


def compute_topk_profile(T, m: Optional[int] = None, k: int = 4,
                         config: Optional[MatrixProfileConfig] = None, *, profile=None):
    """k-NN matrix profile: (distances (w, k), indices (w, k)) on
    ``config.device``, each row ascending by distance; missing neighbors
    are (inf, -1).  ``profile`` (a BenchmarkProfile) takes the phase
    times (and the hybrid's counts)."""
    config = config_for(m, config)
    m = config.m
    if k < 1:
        raise ValueError("k must be >= 1")
    T = config.prepare_series(T)
    w = T.shape[0] - m + 1
    config = config.shrink_to(w)
    S, W = config.band, config.chunk
    if k > min(S, W):
        raise ValueError(f"k={k} exceeds the job extent min(band, chunk)")
    dt = torch_dtype(config.dtype)
    if dt == torch.float64 and config.kernel == "hybrid" and k <= 2 * SUSPECT_K:
        from mpx_torch.hybrid import compute_topk_profile_f64_hybrid

        return compute_topk_profile_f64_hybrid(T, k, config, profile=profile)
    device = torch.device(config.device)
    with phase(profile, "1. Pre-Computation", device=device):
        stats = precompute_statistics(T, m, band=S, chunk=W, dtype=dt, device=device,
                                      matmul_only=True)
    geom = band_geometry(S, W, m, w, config.tile_rows, config.tile_cols)
    grid = make_job_grid(w, S, W)
    rows_v, rows_i = _init_topk(w + S + W, k, dt, device)
    cols_v, cols_i = _init_topk(w + S + W, k, dt, device)
    iS = torch.arange(S, dtype=torch.int32, device=device)
    iW = torch.arange(W, dtype=torch.int32, device=device)
    with phase(profile, "2. Compute [topk tile]", device=device):
        for r0, k0 in zip(grid.r0.tolist(), grid.k0.tolist()):
            c0 = r0 + k0
            Pm = job_correlations(stats, r0, c0, geom, dt)
            _merge_topk(rows_v, rows_i, *_topk_desc(Pm, c0 + iW, k), r0, k)
            _merge_topk(cols_v, cols_i, *_topk_desc(Pm.T.contiguous(), r0 + iS, k), c0, k)
            del Pm
    # Row side (later neighbors) before column side (earlier ones), as mpx.
    v, i = _topk_desc(torch.cat([rows_v[:w], cols_v[:w]], dim=1),
                      torch.cat([rows_i[:w], cols_i[:w]], dim=1), k)
    return _to_distances(v, i, m), i


def compute_topk_ab(A, B, m: Optional[int] = None, k: int = 4,
                    config: Optional[MatrixProfileConfig] = None):
    """k-NN AB-join: for each window of ``A``, its ``k`` nearest neighbors
    in ``B``: (distances (wa, k), indices (wa, k)) on ``config.device``,
    rows ascending by distance, missing neighbors (inf, -1).  No exclusion
    zone, as the AB 1-NN tier; float64 is the strict tile."""
    config = config_for(m, config)
    m = config.m
    if k < 1:
        raise ValueError("k must be >= 1")
    if config.kernel not in ("auto", "mxu"):
        raise ValueError("the AB k-NN tier has one kernel (windows matmul); use "
                         "kernel='auto'")
    A, B, wa, wb, config = ab_inputs(A, B, config)
    S, W = config.band, config.chunk
    if k > W:
        raise ValueError(f"k={k} exceeds the job extent chunk={W}")
    dt = torch_dtype(config.dtype)
    device = torch.device(config.device)
    stats_a, stats_b = (precompute_statistics(X, m, band=S, chunk=W, dtype=dt, device=device,
                                              matmul_only=True) for X in (A, B))
    geom = band_geometry(S, W, m, wa, config.tile_rows, config.tile_cols, wc=wb,
                         excl=NO_EXCL)
    rows_v, rows_i = _init_topk(wa + S, k, dt, device)
    iW = torch.arange(W, dtype=torch.int32, device=device)
    for r0, c0 in zip(*(x.tolist() for x in ab_jobs(wa, wb, S, W))):
        Pm = job_correlations(stats_a, r0, c0, geom, dt, stats_b)
        _merge_topk(rows_v, rows_i, *_topk_desc(Pm, c0 + iW, k), r0, k)
        del Pm
    v, i = rows_v[:wa], rows_i[:wa]
    return _to_distances(v, i, m), i


def brute_force_topk_ab(A, B, m: int, k: int):
    """O(wa * wb * m) numpy oracle (mpx's): per A window, its k best B
    neighbors by an argsort of the full row."""
    A, B = np.asarray(A, np.float64), np.asarray(B, np.float64)
    wb = B.shape[0] - m + 1
    P = unit_windows(A, m) @ unit_windows(B, m).T
    P = np.where(np.isnan(P), -np.inf, P)
    kk = min(k, wb)
    order = np.argsort(-P, axis=1)[:, :kk]
    vals = np.take_along_axis(P, order, axis=1)
    D = np.where(np.isfinite(vals), np.sqrt(np.maximum(2.0 * m * (1.0 - vals), 0.0)), np.inf)
    I = np.where(np.isfinite(vals), order, -1)
    if kk < k:
        D = np.pad(D, ((0, 0), (0, k - kk)), constant_values=np.inf)
        I = np.pad(I, ((0, 0), (0, k - kk)), constant_values=-1)
    return D, I
