"""Driver: job loop, on-device merging, and the public API.

Counterpart of ``mpx/driver.py``.  The statistics are staged once, then a
Python loop walks the job grid in mpx's order (k0 outer, r0 inner), sweeps
each job with the selected kernel, and max-merges its ``BandOut`` into
global (w + S + W,) row/column aggregates at offsets r0 and r0 + k0.  The
merge order is mpx's, so ties across jobs resolve to the same job.  Kernel
launches and merges are queued on the device's current stream; the host
never waits inside the loop.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mpx_torch.config import MatrixProfileConfig, config_for, make_job_grid
from mpx_torch.dtypes import AGGREGATE_INIT, torch_dtype
from mpx_torch.kernels import (
    band_geometry,
    get_sweep_fn,
    is_recurrence,
    needs_windows,
    resolve_kernel,
)
from mpx_torch.ops.aggregates import (
    init_aggregates,
    merge_window,
    postcompute,
    postcompute_left_right,
)
from mpx_torch.ops.precompute import precompute_statistics
from mpx_torch.types import Stats
from mpx_torch.utils.profile import phase


def _agg_length(w: int, S: int, W: int) -> int:
    # Column windows reach at most c0 + W with c0 <= w - 1; row windows r0 + S.
    return w + S + W


def sweep_jobs(stats: Stats, r0s, k0s, *, geom, dtype: torch.dtype, kernel: str,
               rows, cols, stats_c: Optional[Stats] = None):
    """Sweep the jobs (r0s[j], k0s[j]) one at a time with ``kernel``,
    max-merging each job's outputs into the ``rows`` and ``cols``
    aggregates in place; a generator that yields after each job's
    launches, so a caller can interleave the jobs of several devices.
    ``stats_c`` is the columns' statistics (a ring's visiting shard)."""
    sweep = get_sweep_fn(kernel)
    kw = {} if stats_c is None else {"stats_c": stats_c}
    for r0, k0 in zip(np.asarray(r0s).tolist(), np.asarray(k0s).tolist()):
        out = sweep(stats, r0, k0, geom, dtype, **kw)
        merge_window(rows, out.row, r0)
        merge_window(cols, out.col, r0 + k0)
        yield


def run_jobs(stats: Stats, grid, *, geom, dtype: torch.dtype, kernel: str):
    """Sweep every job of ``grid`` and merge the outputs.  Returns (row
    Aggregates, column Aggregates), each (w + S + W,)."""
    L = _agg_length(geom.w, geom.S, geom.W)
    dev = stats.T.device
    rows = init_aggregates(L, dtype, AGGREGATE_INIT, dev)
    cols = init_aggregates(L, dtype, AGGREGATE_INIT, dev)
    for _ in sweep_jobs(stats, grid.r0, grid.k0, geom=geom, dtype=dtype, kernel=kernel,
                        rows=rows, cols=cols):
        pass
    return rows, cols


def compute_matrix_profile(
    T,
    m: Optional[int] = None,
    config: Optional[MatrixProfileConfig] = None,
    *,
    stats: Optional[Stats] = None,
    profile=None,
    left_right: bool = False,
):
    """Compute the self-join matrix profile of ``T`` on ``config.device``.

    Returns (MP, MPI) as tensors on that device: z-normalized Euclidean
    distances in the compute dtype and int32 nearest-neighbor indices
    (untouched entries: sqrt(2m(1+1e12)) / -1).  With ``left_right=True``
    returns (MP_left, MPI_left, MP_right, MPI_right): the nearest earlier /
    later neighbor profiles.

    ``stats`` takes already staged statistics for the same series, band
    and chunk (with ``windows`` when the kernel reads them); ``profile`` a
    :class:`mpx_torch.utils.profile.BenchmarkProfile` for per-phase times.

    ``kernel='hybrid'`` runs :func:`mpx_torch.hybrid.compute_matrix_profile_f64_hybrid`
    (:func:`~mpx_torch.hybrid.compute_left_right_f64_hybrid` with
    ``left_right``): exact float64 distances, cast down for a float32
    request (as mpx).

    With ``config.input_quant`` (an ``ap*`` dtype) the series is first
    quantized to that fixed-point grid (:func:`mpx_torch.io.apfixed.quantize`),
    then computed through the tier ``config.kernel`` selects.

    ``config.num_shards > 1`` deals the jobs over a mesh of that many
    devices (:func:`mpx_torch.parallel.sharding.run_jobs_sharded`; the
    hybrid's passes A and B too); ``shard_mode='ring'`` shards the inputs
    instead (:mod:`mpx_torch.parallel.ring`).  The default mesh is the
    first cards of ``config.device``'s type, or virtual shards of the CPU.
    """
    config = config_for(m, config)
    m = config.m

    # With input_quant: the reference's double -> ap_fixed cast (range
    # check, then round toward zero), then the exact pipeline.
    T = config.prepare_series(T)
    n = T.shape[0]
    if config.kernel == "hybrid":
        return _hybrid(T, config, stats=stats, profile=profile, left_right=left_right)
    if config.shard_mode == "ring":
        return _ring(T, config, stats=stats, profile=profile, left_right=left_right)
    w = n - m + 1
    config = config.shrink_to(w)
    S, W = config.band, config.chunk
    dt = torch_dtype(config.dtype)
    device = torch.device(config.device)
    kernel = resolve_kernel(config.kernel, device, dt, m)
    windows = needs_windows(kernel)

    if stats is None:
        with phase(profile, "1. Pre-Computation", device=device):
            stats = precompute_statistics(T, m, band=S, chunk=W, dtype=dt,
                                          device=device, windows=windows,
                                          exact_mean=is_recurrence(kernel))
    elif stats.T.dtype != dt or (windows and (stats.windows is None
                                               or stats.windows.dtype != dt)):
        raise ValueError(f"stats must be in the compute dtype"
                         f"{' and carry windows' if windows else ''} for kernel={kernel!r}")

    grid = make_job_grid(w, S, W)
    num_shards = config.num_shards or 1
    if num_shards > 1:
        from mpx_torch.parallel.sharding import run_jobs_sharded

        with phase(profile, f"2. Compute [{kernel}, sharded x{num_shards}]", device=device):
            rows, cols = run_jobs_sharded(stats, grid, num_shards=num_shards, S=S, W=W, m=m,
                                          w=w, kernel=kernel, dtype=config.dtype,
                                          tr=config.tile_rows, tc=config.tile_cols)
    else:
        geom = band_geometry(S, W, m, w, config.tile_rows, config.tile_cols)
        with phase(profile, f"2. Compute [{kernel}]", device=device):
            rows, cols = run_jobs(stats, grid, geom=geom, dtype=dt, kernel=kernel)

    with phase(profile, "3. Post-Computation", device=device):
        if left_right:
            return postcompute_left_right(rows, cols, m, w)
        return postcompute(rows, cols, m, w)


def _hybrid(T, config: MatrixProfileConfig, *, stats, profile, left_right: bool):
    if stats is not None:
        raise ValueError("kernel='hybrid' computes its own statistics (float64 on "
                         "the host, float32 operands on the device); drop stats=")
    from mpx_torch import hybrid

    num_shards = config.num_shards or 1
    if left_right and num_shards > 1:
        raise ValueError("hybrid left/right profiles are single-device; drop "
                         "--shards or use --kernel mxu")
    if config.shard_mode == "ring" and not left_right:
        from mpx_torch.parallel.ring import run_ring_hybrid_f64

        c = config.shrink_to(T.shape[0] - config.m + 1)
        out = run_ring_hybrid_f64(T, c.m, num_shards=num_shards, band=c.band, chunk=c.chunk,
                                  profile=profile, device=c.device)
    else:
        run = (hybrid.compute_left_right_f64_hybrid if left_right
               else hybrid.compute_matrix_profile_f64_hybrid)
        out = run(T, config, profile=profile)
    # (MP, MPI) or (MP_left, MPI_left, MP_right, MPI_right): the exact
    # distances in the requested dtype.
    dt = torch_dtype(config.dtype)
    return tuple(o.to(dt) if o.is_floating_point() else o for o in out)


def _ring(T, config: MatrixProfileConfig, *, stats, profile, left_right: bool):
    """``shard_mode='ring'``, honoured at any shard count (a one-device ring
    is how the sharded-inputs tier runs on one card): float64 through the
    ring hybrid, float32 through the one-pass ring (K1 on the card;
    ``kernel='mxu'`` the plain sweep)."""
    if left_right:
        raise ValueError("ring sharding does not support --left-right")
    if stats is not None:
        raise ValueError("ring sharding restages statistics internally and cannot take "
                         "externally-provided stats (they would be silently ignored)")
    from mpx_torch.parallel.ring import run_ring_hybrid_f64, run_ring_sharded

    num_shards = config.num_shards or 1
    c = config.shrink_to(T.shape[0] - config.m + 1)
    if torch_dtype(c.dtype) == torch.float64:
        return run_ring_hybrid_f64(T, c.m, num_shards=num_shards, band=c.band,
                                   chunk=c.chunk, profile=profile, device=c.device)
    with phase(profile, f"2. Compute [ring sharded x{num_shards}]", device=c.device):
        return run_ring_sharded(T, c.m, num_shards=num_shards, band=c.band, chunk=c.chunk,
                                dtype=c.dtype, device=c.device,
                                kernel="mxu" if c.kernel == "mxu" else "mxu_fused")


def matrix_profile(T, m: int, **kwargs):
    """Convenience wrapper: numpy in, numpy out."""
    config = MatrixProfileConfig(m=m, **kwargs)
    MP, MPI = compute_matrix_profile(T, config=config)
    return MP.cpu().numpy(), MPI.cpu().numpy()
