"""Anytime / approximate matrix profiles (SCRIMP-style job sampling).

Counterpart of ``mpx/anytime.py``.  Each (band x chunk) job of the grid
is an independent contribution to the profile and the max-merge is
associative, so any subset of jobs gives a valid profile whose distances
are upper bounds on the exact ones, converging monotonically as coverage
reaches 100 %.  Each batch of jobs is one :func:`mpx_torch.driver.run_jobs`
(under ``auto`` on the card K3 for float64 from ``K3_MIN_M_F64``, K1 else)
max-merged into global aggregates on the device.

Job order:

* ``'shuffled'`` (default) — uniform convergence everywhere (a seeded
  numpy permutation, mpx's, so both packages sweep the same subsets);
* ``'diagonal'`` — near-diagonal jobs first (PreSCRIMP's locality
  argument).

``anytime_matrix_profile`` yields ``(MP, MPI, fraction)`` as numpy after
each batch; the final yield equals :func:`mpx_torch.compute_matrix_profile`
on the same schedule up to equidistant ties (only the merge order
differs).
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from mpx_torch.config import MatrixProfileConfig, config_for, make_job_grid
from mpx_torch.driver import _agg_length, run_jobs
from mpx_torch.dtypes import AGGREGATE_INIT, torch_dtype
from mpx_torch.kernels import band_geometry, is_recurrence, needs_windows, resolve_kernel
from mpx_torch.ops.aggregates import init_aggregates, merge_aggregates, postcompute
from mpx_torch.ops.precompute import precompute_statistics
from mpx_torch.types import JobGrid


def _job_order(grid, order: str, seed: int) -> np.ndarray:
    num = grid.r0.shape[0]
    if order == "shuffled":
        return np.random.default_rng(seed).permutation(num)
    if order == "diagonal":
        # ascending by diagonal offset k0, ties by row
        return np.lexsort((grid.r0, grid.k0))
    raise ValueError(f"unknown job order {order!r}")


def anytime_matrix_profile(
    T,
    m: Optional[int] = None,
    *,
    config: Optional[MatrixProfileConfig] = None,
    batches: int = 16,
    order: str = "shuffled",
    seed: int = 0,
    _first_jobs: Optional[int] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
    """Yield successively better (MP, MPI, fraction) approximations.

    Each yielded MP is a pointwise upper bound on the exact profile and is
    non-increasing across batches.  ``_first_jobs`` (used by
    :func:`approx_matrix_profile`) makes the first batch exactly that many
    jobs and splits the rest over the remaining batches."""
    config = config_for(m, config)
    m = config.m
    if config.num_shards and config.num_shards > 1:
        raise ValueError("the anytime tier is single-device; drop num_shards")
    T = config.prepare_series(T)
    w = T.shape[0] - m + 1
    config = config.shrink_to(w)
    S, W = config.band, config.chunk
    dt = torch_dtype(config.dtype)
    if batches < 1:
        raise ValueError("batches must be >= 1")
    if config.kernel == "hybrid":
        raise ValueError("kernel='hybrid' is not a band sweep; the anytime tier "
                         "runs the strict kernels")
    device = torch.device(config.device)
    kernel = resolve_kernel(config.kernel, device, dt, m)

    grid = make_job_grid(w, S, W)
    perm = _job_order(grid, order, seed)
    num = perm.shape[0]
    if _first_jobs is not None:
        first = min(max(1, _first_jobs), num)
        splits = [perm[:first]]
        if first < num:
            splits += list(np.array_split(perm[first:], min(max(1, batches - 1), num - first)))
    else:
        splits = np.array_split(perm, min(batches, num))

    stats = precompute_statistics(T, m, band=S, chunk=W, dtype=dt, device=device,
                                  windows=needs_windows(kernel),
                                  exact_mean=is_recurrence(kernel))
    geom = band_geometry(S, W, m, w, config.tile_rows, config.tile_cols)
    L = _agg_length(w, S, W)
    rows_g = init_aggregates(L, dt, AGGREGATE_INIT, device)
    cols_g = init_aggregates(L, dt, AGGREGATE_INIT, device)
    done = 0
    for part in splits:
        sub = JobGrid(r0=grid.r0[part], k0=grid.k0[part], band=S, chunk=W)
        rows_b, cols_b = run_jobs(stats, sub, geom=geom, dtype=dt, kernel=kernel)
        rows_g = merge_aggregates(rows_g, rows_b)
        cols_g = merge_aggregates(cols_g, cols_b)
        done += part.shape[0]
        MP, MPI = postcompute(rows_g, cols_g, m, w)
        yield MP.cpu().numpy(), MPI.cpu().numpy(), done / num


def approx_matrix_profile(
    T,
    m: Optional[int] = None,
    *,
    config: Optional[MatrixProfileConfig] = None,
    fraction: float = 0.25,
    order: str = "shuffled",
    seed: int = 0,
):
    """One-shot approximate profile from ``fraction`` of the job grid.

    Returns (MP, MPI, actual_fraction) as numpy: distances are upper bounds
    on the exact profile; ``fraction=1`` is the exact computation.  The
    first batch is exactly ``ceil(fraction * jobs)`` jobs."""
    if not 0.0 < fraction <= 1.0:
        raise ValueError("fraction must be in (0, 1]")
    n = T.shape[0] if isinstance(T, torch.Tensor) else np.asarray(T).shape[0]
    gen = anytime_matrix_profile(
        T, m, config=config, order=order, seed=seed, batches=2,
        _first_jobs=max(1, math.ceil(fraction * _num_jobs(n, m, config))),
    )
    MP, MPI, frac = next(gen)
    gen.close()
    return MP, MPI, frac


def _num_jobs(n: int, m: Optional[int], config: Optional[MatrixProfileConfig]) -> int:
    cfg = config_for(m, config)
    w = n - cfg.m + 1
    cfg = cfg.shrink_to(w)
    return make_job_grid(w, cfg.band, cfg.chunk).r0.shape[0]
