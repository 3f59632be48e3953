"""The pan sweep: every window length in one pass over the pair grid.

Counterpart of ``mpx/pan_kernel.py``.  The centered cross-product panel

    C_r(i, j) = sum_{k < m_r} (T[i+k] - mu_r[i]) (T[j+k] - mu_r[j])

satisfies the exact update (mu' = mu_{r+1}, dmu = mu' - mu)

    C_{r+1} = C_r + dA @ dB^T - m_{r+1} * outer(dmu_i, dmu_j)

where dA/dB are the new window columns [m_r, m_{r+1}) centered at the old
means.  So a job computes level 0's product once and carries C across the
levels with a product of the new columns and a rank-1 correction; each
level's epilogue is the masked ``P = C * inv_r * inv_c``, reduced to row
and column max with the smallest index on a tie and max-merged into that
level's aggregates.  The matmul volume of the whole pan is O(n^2 m_max),
not O(n^2 sum(m_r)).

mpx computes this in XLA, not Pallas, so it runs as torch ops here, on
``device``:

* the raw panels are slices of one ``T.unfold`` of the float32 series;
* C is float32 and updated in place: one ``addmm_`` per level whose
  operands carry the new columns and the rank-1 term as one more column
  (``[dA, -m' dmu_r] @ [dB, dmu_c]^T``), in full FP32
  (:func:`mpx_torch.dtypes.full_precision_matmul`; mpx's products run at
  ``Precision.HIGH``, f32-grade; TF32's 10-bit mantissa would compound
  across the carried levels);
* the epilogue is two ``addcmul`` passes: ``C * inv_r + off_r``, then
  ``* inv_c + off_c``, where ``off`` is 0 for a valid window and -inf for
  a degenerate or padded one (whose factor is 1), so a valid pair gets
  mpx's ``(C * inv_r) * inv_c`` exactly and every other pair -inf; the
  exclusion zone is filled only in the jobs that reach it;
* the reduction is :func:`mpx_torch.ops.aggregates.reduce_first` (torch's
  first-index max), the levels' row and column outputs merged in one call
  each.

The statistics are float64 on the host (one
:func:`~mpx_torch.ops.precompute.precompute_statistics_numpy` per level),
with ``dmu`` taken in float64 before the cast, as mpx.  mpx's blocked
raw-panel build (``_PANEL_BLOCK``, which bounds XLA's program size) and its
watchdog-safe dispatch groups (``group_pairs``, ``pad_job_grid``) are not
ported (ROADMAP.md "Not to port").
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from mpx_torch.config import make_job_grid
from mpx_torch.dtypes import AGGREGATE_INIT, INDEX_INIT, full_precision_matmul
from mpx_torch.ops.aggregates import merge_window, postcompute, reduce_first
from mpx_torch.ops.precompute import _padded_width, precompute_statistics_numpy
from mpx_torch.types import Aggregates
from mpx_torch.utils.profile import phase


class PanStats(NamedTuple):
    """Device-resident multi-level statistics.

    ``mu``/``inv`` rows are per level (inv = +inf beyond w_r and for
    degenerate windows, the not-finite convention of ``Stats``); ``dmu``
    rows are mu_{r+1} - mu_r taken in float64 on the host (the difference
    of close means loses too much in float32)."""

    T: torch.Tensor    # (pw + m_max - 1,) float32, zero-padded
    mu: torch.Tensor   # (R, pw) float32
    dmu: torch.Tensor  # (R-1, pw) float32
    inv: torch.Tensor  # (R, pw) float32, +inf where invalid


def build_pan_stats(T, ms: Sequence[int], band: int, chunk: int, device="cuda") -> PanStats:
    """Host float64 per-level statistics, staged on ``device`` once for
    the whole pan."""
    T64 = np.asarray(T, np.float64)
    n = T64.shape[0]
    ms = [int(m) for m in ms]
    pw = _padded_width(n - ms[0] + 1, band, chunk)
    R = len(ms)
    mu = np.zeros((R, pw), np.float64)
    inv = np.full((R, pw), np.inf, np.float64)
    for r, m in enumerate(ms):
        s = precompute_statistics_numpy(T64, m)
        wr = n - m + 1
        mu[r, :wr] = s["mu"]
        inv[r, :wr] = s["inv"]
    dmu = mu[1:] - mu[:-1]
    Tp = np.zeros(pw + ms[-1] - 1, np.float32)
    Tp[:n] = T64.astype(np.float32)

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)

    return PanStats(T=dev(Tp), mu=dev(mu), dmu=dev(dmu), inv=dev(inv))


class _Level(NamedTuple):
    """One level's epilogue operands: the inverse norms with 1 at invalid
    windows, and the offsets (0 valid, -inf invalid)."""

    scale: torch.Tensor  # (pw,)
    off: torch.Tensor    # (pw,)


def _levels(ps: PanStats):
    fin = torch.isfinite(ps.inv)
    one = torch.ones((), dtype=ps.inv.dtype, device=ps.inv.device)
    scale = torch.where(fin, ps.inv, one)
    off = torch.zeros_like(ps.inv).masked_fill_(~fin, -torch.inf)
    return [_Level(s, o) for s, o in zip(scale, off)]


def _level_epilogue(C, P, lev: _Level, r0: int, c0: int, excl: int):
    """Masked ``P = C * inv_r * inv_c`` of one level into the buffer ``P``
    (-inf for an invalid pair), reduced to row and column max with the
    smallest index on a tie.  Returns (row Aggregates, column
    Aggregates); an index is -1 where a row or column has no valid
    pair."""
    S, W = C.shape
    torch.addcmul(lev.off[r0 : r0 + S, None], C, lev.scale[r0 : r0 + S, None], out=P)
    torch.addcmul(lev.off[None, c0 : c0 + W], P, lev.scale[None, c0 : c0 + W], out=P)
    if c0 - (r0 + S - 1) < excl:  # the job reaches the exclusion zone
        rows = torch.arange(r0, r0 + S, device=C.device)
        cols = torch.arange(c0, c0 + W, device=C.device)
        P.masked_fill_(cols[None, :] - rows[:, None] < excl, -torch.inf)
    return reduce_first(P, 1, c0), reduce_first(P, 0, r0)


def _stack(aggs) -> Aggregates:
    return Aggregates(torch.stack([a.value for a in aggs]), torch.stack([a.index for a in aggs]))


def _pan_job(ps: PanStats, levels, raw, r0: int, c0: int, *, S: int, W: int, ms, C, P):
    """All-level aggregates of one (S x W) rectangle of the pair grid: the
    rows' (R, S) and the columns' (R, W) Aggregates.  ``raw`` is the
    (pw, m_max) raw-window view of ``ps.T``; ``C`` and ``P`` are (S, W)
    float32 buffers."""
    rawA, rawB = raw[r0 : r0 + S], raw[c0 : c0 + W]
    mu_r, mu_c = ps.mu[0, r0 : r0 + S], ps.mu[0, c0 : c0 + W]
    with full_precision_matmul():
        torch.matmul(rawA[:, : ms[0]] - mu_r[:, None],
                     (rawB[:, : ms[0]] - mu_c[:, None]).T, out=C)
    rows, cols = [], []
    for r, m in enumerate(ms):
        row, col = _level_epilogue(C, P, levels[r], r0, c0, m // 4)
        rows.append(row)
        cols.append(col)
        if r + 1 < len(ms):
            m2 = ms[r + 1]
            mu_r, mu_c = ps.mu[r, r0 : r0 + S], ps.mu[r, c0 : c0 + W]
            dA = torch.cat([rawA[:, m:m2] - mu_r[:, None],
                            ps.dmu[r, r0 : r0 + S, None] * -float(m2)], dim=1)
            dB = torch.cat([rawB[:, m:m2] - mu_c[:, None],
                            ps.dmu[r, c0 : c0 + W, None]], dim=1)
            with full_precision_matmul():
                C.addmm_(dA, dB.T)
    return _stack(rows), _stack(cols)


def run_pan_jobs(T, ms: Sequence[int], *, band: int, chunk: int, device="cuda",
                 profile=None):
    """The full pan profile surface on ``device``.

    Returns (PMP (R, w0) float64 distances, +inf beyond each level's
    width; PMPI (R, w0) int32, -1 there) as tensors on ``device``;
    ``profile`` (:class:`mpx_torch.utils.profile.BenchmarkProfile`) takes
    the host statistics, the sweep and the post-computation times."""
    ms = tuple(int(m) for m in ms)
    if sorted(set(ms)) != list(ms):
        raise ValueError("ms must be strictly ascending")
    T = np.asarray(T)
    n = T.shape[0]
    R = len(ms)
    w0 = n - ms[0] + 1
    L = w0 + band + chunk
    dev = torch.device(device)

    with phase(profile, "1. Pre-Computation [pan host]", device=dev):
        ps = build_pan_stats(T, ms, band, chunk, dev)
        grid = make_job_grid(w0, band, chunk)

    rows = Aggregates(torch.full((R, L), AGGREGATE_INIT, dtype=torch.float32, device=dev),
                      torch.full((R, L), INDEX_INIT, dtype=torch.int32, device=dev))
    cols = Aggregates(rows.value.clone(), rows.index.clone())
    with phase(profile, f"2. Compute [pan x{R} levels]", device=dev):
        levels = _levels(ps)
        raw = ps.T.unfold(0, ms[-1], 1)
        C = torch.empty((band, chunk), dtype=torch.float32, device=dev)
        P = torch.empty_like(C)
        for r0, k0 in zip(grid.r0.tolist(), grid.k0.tolist()):
            c0 = r0 + k0
            row, col = _pan_job(ps, levels, raw, r0, c0, S=band, W=chunk, ms=ms, C=C, P=P)
            merge_window(rows, row, r0)
            merge_window(cols, col, c0)
        del C, P

    with phase(profile, "3. Post-Computation [pan]", device=dev):
        PMP = torch.full((R, w0), torch.inf, dtype=torch.float64, device=dev)
        PMPI = torch.full((R, w0), INDEX_INIT, dtype=torch.int32, device=dev)
        for r, m in enumerate(ms):
            wr = n - m + 1
            MP, MPI = postcompute(Aggregates(rows.value[r], rows.index[r]),
                                  Aggregates(cols.value[r], cols.index[r]), m, wr)
            PMP[r, :wr] = MP.double()
            PMPI[r, :wr] = MPI
    return PMP, PMPI
