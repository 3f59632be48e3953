"""Missing-data (NaN/inf gap) support.

Counterpart of ``mpx/missing.py``.  The default contract rejects
non-finite series (:meth:`mpx_torch.config.MatrixProfileConfig.validate_series`);
this tier implements the masked semantics instead: every window that
overlaps a non-finite sample is excluded from the join on both sides.  It
reports the untouched sentinel (distance sqrt(2m(1+1e12)), index -1, as a
zero-variance window) and is never another window's neighbor.

The result is exact, not approximate: gap samples are filled with 0 and
the windows overlapping them get ``inv = +inf`` in the host statistics,
the zero-variance marker every kernel's finite mask honours.  A good
window contains no filled sample, so its statistics and its products with
other good windows are those of the true series.  The statistics reach
the driver through its ``stats=`` hook (the window matrix only for the
kernels that read it: K1 and its plain version), so ``kernel='hybrid'``,
which computes its own, refuses gaps.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mpx_torch.config import MatrixProfileConfig, config_for
from mpx_torch.driver import compute_matrix_profile
from mpx_torch.kernels import is_recurrence, needs_windows, resolve_kernel
from mpx_torch.ops.precompute import precompute_statistics, precompute_statistics_numpy


def missing_window_mask(T, m: int) -> np.ndarray:
    """Boolean (w,) mask: True where window [i, i+m) overlaps a non-finite
    sample."""
    T = np.asarray(T, np.float64)
    bad = (~np.isfinite(T)).astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(bad)])
    return (cs[m:] - cs[:-m]) > 0


def compute_matrix_profile_masked(
    T,
    m: Optional[int] = None,
    config: Optional[MatrixProfileConfig] = None,
    *,
    profile=None,
    left_right: bool = False,
) -> tuple:
    """Self-join matrix profile of a series with gaps: ``(MP, MPI)``, or
    ``(MP_left, MPI_left, MP_right, MPI_right)`` with ``left_right=True``,
    as tensors on ``config.device`` (the driver's results).

    Finite input goes to :func:`mpx_torch.compute_matrix_profile` as is.
    Otherwise windows overlapping a gap report the untouched sentinel and
    every other value is the gap-free semantics' (see the module
    docstring)."""
    config = config_for(m, config)
    m = config.m
    if isinstance(T, torch.Tensor):
        T = T.detach().cpu().numpy()
    T = np.asarray(T, np.float64)
    finite = np.isfinite(T)
    if finite.all():
        return compute_matrix_profile(T, config=config, profile=profile,
                                      left_right=left_right)

    n = T.shape[0]
    if config.input_quant is not None:
        raise ValueError(
            "ap_fixed input tiers cannot carry gaps (the quantizer range-checks "
            "every sample); fill or drop gaps first"
        )
    if config.shard_mode == "ring":
        raise ValueError("masked gaps do not support shard_mode='ring'; use the "
                         "default 'jobs' sharding")
    if config.kernel == "hybrid":
        raise ValueError("kernel='hybrid' computes its own statistics and cannot mask "
                         "gaps; use kernel='auto' or a strict kernel")
    config.validate_series(n)  # shape checks only (T has known gaps)
    w = n - m + 1
    bad = missing_window_mask(T, m)
    if bad.all():
        raise ValueError(
            "every window overlaps a gap — no joinable subsequences "
            f"(n={n}, m={m}, {int((~finite).sum())} non-finite samples)"
        )
    T_fill = np.where(finite, T, 0.0)

    # The driver's schedule shrink, so that the padded widths agree.
    config = config.shrink_to(w)
    device = torch.device(config.device)
    kernel = resolve_kernel(config.kernel, device, config.dtype, m)
    s = precompute_statistics_numpy(T_fill, m, exact_mean=is_recurrence(kernel))
    s["inv"] = np.where(bad, np.inf, s["inv"])
    stats = precompute_statistics(T_fill, m, band=config.band, chunk=config.chunk,
                                  dtype=config.dtype, device=device,
                                  windows=needs_windows(kernel), host_stats=s)
    return compute_matrix_profile(T_fill, config=config, stats=stats, profile=profile,
                                  left_right=left_right)
