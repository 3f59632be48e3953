"""Profiles for a fleet of many small series.

Counterpart of ``mpx/batch.py``.  mpx vmaps its one-dispatch fused tier
over a group of series so that XLA compiles one executable; the port has
no such tier.  It stages the statistics of ``group`` series at once,
runs each series' job grid through :func:`mpx_torch.driver.run_jobs`
(the kernel ``auto`` picks on the card) with no wait on the host between series,
and fetches the group's profiles in one copy.  Row b equals
:func:`mpx_torch.compute_matrix_profile` of ``batch[b]`` bit for bit: the
same statistics, job order and merges.  With ``config.num_shards > 1`` a
group's series are laid out over a mesh of that many devices, in
contiguous blocks (mpx's batch sharding): data parallelism, no
collectives.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mpx_torch.config import MatrixProfileConfig, config_for, make_job_grid
from mpx_torch.driver import run_jobs
from mpx_torch.dtypes import canonical_dtype, torch_dtype
from mpx_torch.io.apfixed import quantize
from mpx_torch.kernels import band_geometry, is_recurrence, needs_windows, resolve_kernel
from mpx_torch.ops.aggregates import postcompute
from mpx_torch.ops.precompute import _padded_width, precompute_statistics
from mpx_torch.parallel.mesh import default_mesh

# mpx's width caps of the fleet tier (its small-problem fused tier's):
# longer series are run one at a time.
MAX_W_F32 = 1 << 19
MAX_W_F64 = 1 << 16
# Bytes of the statistics (window matrix included) of one staged group.
WINDOWS_BUDGET = 4 << 30


def compute_batch_profiles(
    batch,
    m: Optional[int] = None,
    config: Optional[MatrixProfileConfig] = None,
    *,
    group: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Self-join profiles of a (B, n) batch of equal-length series.

    Returns ``(MP, MPI)`` as numpy, (B, n - m + 1): distances in the
    compute dtype and int32 indices.  ``group`` is the number of series
    staged at once (default: as many as ``WINDOWS_BUDGET`` holds on each
    device of the mesh)."""
    config = config_for(m, config)
    m = config.m
    if isinstance(batch, torch.Tensor):
        batch = batch.detach().cpu().numpy()
    batch = np.asarray(batch, np.float64)
    if batch.ndim != 2 or batch.shape[0] < 1:
        raise ValueError(
            f"batch must be 2-D (B >= 1, n) of equal-length series, got "
            f"shape {batch.shape}; pad or truncate ragged fleets first"
        )
    B, n = batch.shape
    config.validate_series(n)
    if not np.isfinite(batch).all():
        s, p = np.argwhere(~np.isfinite(batch))[0]
        raise ValueError(
            f"batch contains a non-finite value (series {s}, sample "
            f"{p}); NaN/inf would silently poison every correlation"
        )
    if config.input_quant is not None:
        batch = quantize(batch, config.input_quant)
    w = n - m + 1
    config = config.shrink_to(w)
    S, W = config.band, config.chunk
    npdt = canonical_dtype(config.dtype)
    dt = torch_dtype(config.dtype)
    if config.kernel == "hybrid":
        raise ValueError(
            "kernel='hybrid' cannot batch (it is a multi-pass tier ending in an "
            "exact rescore); use kernel='auto', the strict kernels at full dtype "
            "accuracy"
        )
    device = torch.device(config.device)
    kernel = resolve_kernel(config.kernel, device, dt, m)
    cap = MAX_W_F64 if npdt == np.dtype(np.float64) else MAX_W_F32
    if w > cap:
        raise ValueError(
            f"batched tier is for small series: w={w} > {cap} for dtype {npdt} "
            f"(run large series individually)"
        )

    shards = config.num_shards or 1
    mesh = (device,) if shards == 1 else default_mesh(shards, device=device)
    windows = needs_windows(kernel)
    pw = _padded_width(w, S, W)
    per_series = (pw * (m if windows else 0) + 6 * pw + m) * npdt.itemsize
    budget = max(1, WINDOWS_BUDGET // per_series) * shards
    group = budget if group is None else group
    if group < 1:
        raise ValueError("group must be >= 1")
    group = min(group, budget, B)

    grid = make_job_grid(w, S, W)
    geom = band_geometry(S, W, m, w, config.tile_rows, config.tile_cols)
    MP = np.empty((B, w), npdt)
    MPI = np.empty((B, w), np.int32)
    for lo in range(0, B, group):
        series = batch[lo : lo + group]
        # Series b of the group on shard b * shards // len(series): contiguous
        # blocks, every shard's work queued before the first fetch.
        on = [mesh[b * shards // len(series)] for b in range(len(series))]
        staged = [precompute_statistics(T, m, band=S, chunk=W, dtype=dt, device=dev,
                                        windows=windows, exact_mean=is_recurrence(kernel))
                  for T, dev in zip(series, on)]
        outs = [postcompute(*run_jobs(st, grid, geom=geom, dtype=dt, kernel=kernel), m, w)
                for st in staged]
        for dev in dict.fromkeys(on):  # one copy of each shard's block
            b0, b1 = on.index(dev), len(on) - on[::-1].index(dev)
            for out, k in ((MP, 0), (MPI, 1)):
                out[lo + b0 : lo + b1] = torch.stack([o[k] for o in outs[b0:b1]]).cpu().numpy()
    return MP, MPI
