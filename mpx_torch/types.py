"""Core data containers (struct-of-arrays), counterpart of ``mpx/types.py``.

``Stats`` and ``Aggregates`` hold tensors on one device; ``JobGrid`` is a
host-side schedule of numpy arrays.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class Stats(NamedTuple):
    """Precomputed per-subsequence statistics (padded, device-resident).

    All vectors have length ``padded_w`` >= n - m + 1 and are zero in the
    pad region; ``T`` is padded to ``padded_w + m - 1``.  ``windows`` is
    the unit-normalized window matrix ``(padded_w, m)``, zero rows for
    zero-variance and padded windows: the sweep kernels slice their row
    and column panels from it.
    """

    T: torch.Tensor      # (padded_w + m - 1,) raw series
    mu: torch.Tensor     # (padded_w,) rolling means
    df: torch.Tensor     # (padded_w,) update coefficients
    dg: torch.Tensor     # (padded_w,)
    inv: torch.Tensor    # (padded_w,) inverse centered norms (inf: zero variance)
    qt0: torch.Tensor    # (padded_w,) first-row dot products QT(0, c)
    windows: Optional[torch.Tensor] = None  # (padded_w, m) unit windows


class Aggregates(NamedTuple):
    """Row/column-merged (max-correlation, neighbor-index) aggregates."""

    value: torch.Tensor  # Pearson correlations, aggregate-initialized
    index: torch.Tensor  # int32 neighbor indices, -1-initialized


class JobGrid(NamedTuple):
    """Decomposition of the upper-triangular join into (row-band r0,
    diagonal-chunk k0) jobs; each job is the rectangle rows
    ``[r0, r0+band)`` x columns ``[r0+k0, r0+k0+chunk)``."""

    r0: np.ndarray        # (num_jobs,) int32 band start rows
    k0: np.ndarray        # (num_jobs,) int32 chunk start diagonals
    band: int             # S: rows per band
    chunk: int            # W: diagonals per chunk
