"""K3's batched job loop on the CPU, against the per-job loop.

``driver.run_jobs`` with ``kernel='pallas'`` sweeps the grid a batch at a
time (``recurrence.sweep_batches``: on the CPU the plain sweep a job, then
``recurrence.merge_batch``, the plain version of the card's ``k3_merge``).
Its row and column aggregates must equal a per-job loop's (the same
sweep, then ``merge_window`` job after job, written out here) bit for
bit, values and indices, whatever the batch cap and the grid's order, on
a series whose repeated pattern gives exact ties between jobs, so the
merge order decides which index is kept.  A batch is any run of
consecutive jobs, so at caps above one batches hold jobs of several k0s.
"""

import numpy as np
import pytest
import torch

from mpx_torch.anytime import _job_order
from mpx_torch.config import make_job_grid
from mpx_torch.driver import _agg_length, run_jobs
from mpx_torch.dtypes import AGGREGATE_INIT
from mpx_torch.kernels import band_geometry, recurrence
from mpx_torch.kernels.xla import sweep_band_xla
from mpx_torch.ops.aggregates import init_aggregates, merge_window
from mpx_torch.ops.precompute import precompute_statistics
from mpx_torch.types import Aggregates, JobGrid
from mpx_torch.utils.profile import counters

N, M, S, W = 900, 16, 32, 96


def _tie_series(n: int, seed: int) -> np.ndarray:
    """A repeated pattern of small integers (its copies' windows are equal,
    and so, exactly, are many of their correlations), then a walk."""
    rng = np.random.default_rng(seed)
    pattern = rng.integers(-8, 9, 48).astype(np.float64)
    T = np.tile(pattern, n // 48 + 1)[:n]
    walk = np.cumsum(rng.integers(-3, 4, n)).astype(np.float64)
    T[2 * n // 3 :] = walk[2 * n // 3 :]
    return T


def _setup(dtype):
    T = _tie_series(N, 5)
    w = N - M + 1
    stats = precompute_statistics(T, M, band=S, chunk=W, dtype=dtype, device="cpu",
                                  windows=False, exact_mean=True)
    return stats, band_geometry(S, W, M, w), make_job_grid(w, S, W)


def _grid(grid: JobGrid, order: str) -> JobGrid:
    """The grid in mpx's order, anytime's shuffled order, or k0 outer with
    each k0's bands shuffled (batches whose rows run out of order)."""
    if order == "grid":
        return grid
    if order == "shuffled":
        perm = _job_order(grid, "shuffled", 3)
    else:
        rng = np.random.default_rng(4)
        perm = np.lexsort((rng.permutation(grid.r0.shape[0]), grid.k0))
    return JobGrid(grid.r0[perm], grid.k0[perm], grid.band, grid.chunk)


def _per_job(stats, grid, geom, dtype):
    L = _agg_length(geom.w, geom.S, geom.W)
    rows = init_aggregates(L, stats.T.dtype, AGGREGATE_INIT, "cpu")
    cols = init_aggregates(L, stats.T.dtype, AGGREGATE_INIT, "cpu")
    for r0, k0 in zip(grid.r0.tolist(), grid.k0.tolist()):
        out = sweep_band_xla(stats, r0, k0, geom, dtype)
        merge_window(rows, out.row, r0)
        merge_window(cols, out.col, r0 + k0)
    return rows, cols


def _assert_equal(a: Aggregates, b: Aggregates):
    assert torch.equal(a.value, b.value)
    assert torch.equal(a.index, b.index)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("cap", [1, 3, 64])
@pytest.mark.parametrize("order", ["grid", "shuffled", "k0_then_shuffled_bands"])
def test_batched_loop_equals_per_job_loop(monkeypatch, dtype, cap, order):
    stats, geom, grid = _setup(dtype)
    grid = _grid(grid, order)
    monkeypatch.setattr(recurrence, "BATCH_JOBS", cap)
    calls, launches = counters()["calls.xla"], counters()["launches.k3"]
    rows, cols = run_jobs(stats, grid, geom=geom, dtype=stats.T.dtype, kernel="pallas")
    assert counters()["calls.xla"] == calls + len(grid.r0)
    assert counters()["launches.k3"] == launches
    ref_rows, ref_cols = _per_job(stats, grid, geom, stats.T.dtype)
    _assert_equal(rows, ref_rows)
    _assert_equal(cols, ref_cols)


def test_cap_leaves_partial_batches_and_ties_decide_indices():
    """What the cases above cover: a cap of 3 divides neither the first
    k0's jobs nor every other k0's, so batches cross k0 changes, and the
    tie series has positions where merging the same jobs in reverse order
    keeps another index."""
    stats, geom, grid = _setup("float64")
    per_k0 = np.unique(grid.k0, return_counts=True)[1]
    assert (per_k0 % 3 != 0).any() and per_k0.max() < 64
    outs = [sweep_band_xla(stats, r0, k0, geom, "float64")
            for r0, k0 in zip(grid.r0.tolist(), grid.k0.tolist())]
    L = _agg_length(geom.w, S, W)
    fwd = init_aggregates(L, torch.float64, AGGREGATE_INIT, "cpu")
    rev = init_aggregates(L, torch.float64, AGGREGATE_INIT, "cpu")
    for o, r0, k0 in zip(outs, grid.r0.tolist(), grid.k0.tolist()):
        merge_window(fwd, o.col, r0 + k0)
    for o, r0, k0 in reversed(list(zip(outs, grid.r0.tolist(), grid.k0.tolist()))):
        merge_window(rev, o.col, r0 + k0)
    assert torch.equal(fwd.value, rev.value)
    assert (fwd.index != rev.index).sum() > 0


@pytest.mark.parametrize("cap", [1, 3, 64])
@pytest.mark.parametrize("order", ["grid", "shuffled", "k0_then_shuffled_bands"])
def test_job_batches_are_maximal_runs_of_the_list(cap, order):
    """Batches are runs of consecutive jobs in the list's order that cover
    it, each of ``cap`` jobs but the last, whatever their k0: at a cap of 3
    and 64 some batch holds jobs of two k0s."""
    *_, grid = _setup("float64")
    k0s = _grid(grid, order).k0.tolist()
    batches = recurrence.job_batches(len(k0s), cap)
    assert [a for a, _ in batches] == [0] + [b for _, b in batches[:-1]]
    assert batches[-1][1] == len(k0s)
    assert all(b - a == cap for a, b in batches[:-1])
    assert 0 < batches[-1][1] - batches[-1][0] <= cap
    assert any(len(set(k0s[a:b])) > 1 for a, b in batches) == (cap > 1)
    assert recurrence.job_batches(0, cap) == []


def test_merge_batch_keeps_the_per_window_order():
    """The plain batched merge on hand-made windows that overlap and tie,
    at unsorted offsets: equal to ``merge_window`` window after window."""
    rng = np.random.default_rng(9)
    L, n = 40, 12
    levels = torch.tensor([-1e12, 0.25, 0.5, 0.75], dtype=torch.float64)
    agg = Aggregates(levels[torch.from_numpy(rng.integers(0, 4, L))],
                     torch.from_numpy(rng.integers(-1, 99, L).astype(np.int32)))
    windows = [Aggregates(levels[torch.from_numpy(rng.integers(0, 4, n))],
                          torch.from_numpy(rng.integers(0, 99, n).astype(np.int32)))
               for _ in range(6)]
    offsets = [10, 3, 17, 3, 25, 0]
    ref = Aggregates(agg.value.clone(), agg.index.clone())
    for win, off in zip(windows, offsets):
        merge_window(ref, win, off)
    recurrence.merge_batch(agg, windows, offsets)
    _assert_equal(agg, ref)
