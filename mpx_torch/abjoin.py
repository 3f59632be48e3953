"""AB-join: the matrix profile of series A against series B.

Counterpart of ``mpx/abjoin.py``.  For every window of ``A`` its nearest
neighbor among the windows of ``B``, and for every window of ``B`` its
nearest among ``A``'s: no trivial-match exclusion zone (the windows
belong to two series).  A job is the rectangle of A-rows ``[r0, r0+S)``
x B-columns ``[c0, c0+W)``, one windows product, and both profiles come
out of the same sweep: its row aggregates merge into the A->B profile,
its column aggregates into the B->A one.

Tiers (``config.kernel``):

* ``auto`` / ``mxu_fused`` — K1 with B's windows as its column operand
  (:func:`mpx_torch.kernels.mxu_fused.sweep_band_mxu_fused`) on a CUDA
  device, float32 and float64 alike; the plain sweep on the CPU.  mpx's
  ``auto`` sends float64 to its hybrid because the TPU has no float64;
  the H100 has, so K1 in float64 is exact here (ROADMAP queue 2 item 5);
* ``mxu`` — the plain PyTorch sweep, also on the card;
* ``hybrid`` — :func:`mpx_torch.hybrid.compute_ab_join_f64_hybrid`: float32
  sweeps, then an exact float64 rescore of the suspects (distances cast
  to the requested dtype);
* ``xla`` / ``pallas`` have no AB form: they raise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from mpx_torch.config import MatrixProfileConfig, config_for
from mpx_torch.dtypes import AGGREGATE_INIT, torch_dtype
from mpx_torch.kernels.common import NO_EXCL, band_geometry
from mpx_torch.ops.aggregates import init_aggregates, merge_window, pearson_to_euclidean
from mpx_torch.ops.precompute import host_statistics, precompute_statistics
from mpx_torch.utils.profile import phase

_AB_KERNELS = ("auto", "mxu", "mxu_fused", "hybrid")


class ABJoinResult(NamedTuple):
    mp_a: torch.Tensor   # (wa,) distance of each A window to its nearest B window
    mpi_a: torch.Tensor  # (wa,) int32 index into B
    mp_b: torch.Tensor   # (wb,) distance of each B window to its nearest A window
    mpi_b: torch.Tensor  # (wb,) int32 index into A


def ab_jobs(wa: int, wb: int, S: int, W: int):
    """The rectangle jobs of an AB-join, in mpx's order (r0 outer, c0
    inner): (r0s, c0s) int64 arrays."""
    r0s, c0s = np.meshgrid(np.arange(0, wa, S), np.arange(0, wb, W), indexing="ij")
    return r0s.ravel().astype(np.int64), c0s.ravel().astype(np.int64)


def ab_inputs(A, B, config: MatrixProfileConfig):
    """Both series as the config prepares them
    (:meth:`~mpx_torch.config.MatrixProfileConfig.prepare_series`) and the
    config shrunk to the wider profile.  Returns (A, B, wa, wb, config)."""
    A, B = config.prepare_series(A), config.prepare_series(B)
    wa, wb = A.shape[0] - config.m + 1, B.shape[0] - config.m + 1
    return A, B, wa, wb, config.shrink_to(max(wa, wb))


def compute_ab_join(A, B, m: Optional[int] = None,
                    config: Optional[MatrixProfileConfig] = None, *,
                    profile=None) -> ABJoinResult:
    """Both directional profiles of the AB-join, as tensors on
    ``config.device``: distances in the compute dtype and int32 indices
    (a zero-variance window, which has no neighbor: sqrt(2m(1+1e12)) / -1).
    ``profile`` takes the per-phase times."""
    config = config_for(m, config)
    m = config.m
    if config.kernel not in _AB_KERNELS:
        raise ValueError(f"kernel={config.kernel!r} has no AB-join; the AB-join runs on "
                         f"{_AB_KERNELS}")
    A, B, wa, wb, config = ab_inputs(A, B, config)
    dt = torch_dtype(config.dtype)
    if config.kernel == "hybrid":
        from mpx_torch.hybrid import compute_ab_join_f64_hybrid

        out = compute_ab_join_f64_hybrid(A, B, config, profile=profile)
        return ABJoinResult(*(o.to(dt) if o.is_floating_point() else o for o in out))

    device = torch.device(config.device)
    kernel = config.kernel
    if kernel == "auto":
        kernel = "mxu_fused" if device.type == "cuda" else "mxu"
    from mpx_torch.kernels import get_sweep_fn

    sweep = get_sweep_fn(kernel)
    S, W = config.band, config.chunk
    with phase(profile, "1. Pre-Computation", device=device):
        stats_a, stats_b = (precompute_statistics(X, m, band=S, chunk=W, dtype=dt,
                                                  device=device) for X in (A, B))
    geom = band_geometry(S, W, m, wa, config.tile_rows, config.tile_cols, wc=wb,
                         excl=NO_EXCL)
    with phase(profile, f"2. Compute [{kernel}, ab-join]", device=device):
        rows = init_aggregates(wa + S, dt, AGGREGATE_INIT, device)
        cols = init_aggregates(wb + W, dt, AGGREGATE_INIT, device)
        for r0, c0 in zip(*(x.tolist() for x in ab_jobs(wa, wb, S, W))):
            out = sweep(stats_a, r0, c0 - r0, geom, dt, stats_c=stats_b)
            merge_window(rows, out.row, r0)
            merge_window(cols, out.col, c0)
    with phase(profile, "3. Post-Computation", device=device):
        return ABJoinResult(
            mp_a=pearson_to_euclidean(rows.value[:wa], m), mpi_a=rows.index[:wa],
            mp_b=pearson_to_euclidean(cols.value[:wb], m), mpi_b=cols.index[:wb])


def unit_windows(X: np.ndarray, m: int) -> np.ndarray:
    """Exact float64 unit-normalized windows of a series, NaN rows where
    the window has zero variance by the statistics' rule (the oracles'
    operand)."""
    s = host_statistics(X, m, matmul_only=True, device="cpu")
    fin = np.isfinite(s["inv"])
    Z = (np.lib.stride_tricks.sliding_window_view(X, m) - s["mu"][:, None]) \
        * np.where(fin, s["inv"], 0.0)[:, None]
    Z[~fin] = np.nan
    return Z


def brute_force_ab_join(A, B, m: int):
    """Independent numpy oracle (mpx's): explicit z-normalized distances
    between every A window and every B window.  Returns (mp_a, mpi_a, mp_b,
    mpi_b); a zero-variance window's distances are inf (mpx's oracle takes
    the reference's statistics, which leave a constant run a tiny
    variance)."""
    A, B = np.asarray(A, np.float64), np.asarray(B, np.float64)
    with np.errstate(invalid="ignore"):
        D = np.sqrt(np.maximum(2.0 * m * (1.0 - unit_windows(A, m) @ unit_windows(B, m).T),
                               0.0))
    D = np.where(np.isnan(D), np.inf, D)
    return (D.min(axis=1), D.argmin(axis=1).astype(np.int32),
            D.min(axis=0), D.argmin(axis=0).astype(np.int32))
