"""Aggregate (max-correlation, index) merge operations, counterpart of
``mpx/ops/aggregates.py``.

* ``merge_aggregates`` — strict-greater max-merge; the incumbent wins
  ties, preserving first-seen semantics across jobs.
* ``merge_window``     — the same merge into a slice of a global
  aggregate array (how job outputs land in the row/column profiles);
  ``smaller=True`` is the strict-less min-merge of distance aggregates
  (mSTAMP);
* ``reduce_first``     — a tile's max (or min) along one axis with the
  first, i.e. smallest, index of each;
* ``postcompute``      — row/column merge + Pearson -> Euclidean.
"""

from __future__ import annotations

import torch

from mpx_torch.dtypes import INDEX_INIT
from mpx_torch.types import Aggregates


def merge_aggregates(a: Aggregates, b: Aggregates) -> Aggregates:
    """Elementwise max-merge; ``a`` (the incumbent) wins ties."""
    better = b.value > a.value
    return Aggregates(
        value=torch.where(better, b.value, a.value),
        index=torch.where(better, b.index, a.index),
    )


def merge_window(global_agg: Aggregates, window: Aggregates, offset: int,
                 smaller: bool = False) -> None:
    """Max-merge ``window`` into ``global_agg[..., offset : offset + len]``
    (the last axis: a stack of aggregates, one per level or dimension,
    merges in one call); with ``smaller`` the strict-less min-merge.

    Unlike mpx's functional version this updates ``global_agg`` IN PLACE
    (through views of its tensors), so a job merge allocates only the
    (len,) comparison mask."""
    size = window.value.shape[-1]
    cur_v = global_agg.value[..., offset : offset + size]
    cur_i = global_agg.index[..., offset : offset + size]
    better = window.value < cur_v if smaller else window.value > cur_v
    cur_v.copy_(torch.where(better, window.value, cur_v))
    cur_i.copy_(torch.where(better, window.index, cur_i))


def reduce_first(P: torch.Tensor, dim: int, base: int, largest: bool = True) -> Aggregates:
    """The max (``largest``) or min of ``P`` along ``dim`` and the first
    (smallest) index that reaches it, plus ``base``; index -1 where the
    extremum is not finite (a masked fill of -inf for a max, +inf for a
    min).  torch's max/min return the first index on a tie on every
    device: mpx's iota-min tie rule in one pass over the tile."""
    v, i = P.max(dim=dim) if largest else P.min(dim=dim)
    return Aggregates(v, torch.where(torch.isfinite(v), i.to(torch.int32) + base, INDEX_INIT))


def pearson_to_euclidean(P: torch.Tensor, m: int) -> torch.Tensor:
    """dist = sqrt(2m(1 - P)), clamped at 0: rounding can push the
    correlation of near-identical windows epsilon past 1."""
    return torch.sqrt(torch.clamp(2.0 * m * (1.0 - P), min=0.0))


def postcompute(rows: Aggregates, cols: Aggregates, m: int, w: int):
    """Final row/column merge + distance conversion, truncated to the
    true profile length ``w``.  Returns (MP distances, MPI int32)."""
    merged = merge_aggregates(
        Aggregates(rows.value[:w], rows.index[:w]),
        Aggregates(cols.value[:w], cols.index[:w]),
    )
    return pearson_to_euclidean(merged.value, m), merged.index.to(torch.int32)


def postcompute_left_right(rows: Aggregates, cols: Aggregates, m: int, w: int):
    """Left/right matrix profiles.  Every job pair (r, c) has c > r, so
    the row aggregates are the RIGHT profile and the column aggregates
    the LEFT one.  Returns (left MP, left MPI, right MP, right MPI)."""
    return (
        pearson_to_euclidean(cols.value[:w], m),
        cols.index[:w].to(torch.int32),
        pearson_to_euclidean(rows.value[:w], m),
        rows.index[:w].to(torch.int32),
    )


def init_aggregates(length: int, dtype: torch.dtype, init_value: float,
                    device) -> Aggregates:
    return Aggregates(
        value=torch.full((length,), init_value, dtype=dtype, device=device),
        index=torch.full((length,), INDEX_INIT, dtype=torch.int32, device=device),
    )
