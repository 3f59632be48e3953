"""Job sharding over several devices, counterpart of ``mpx/parallel/sharding.py``.

The reference replicates its kernel over compute units, copies the input
to each unit's memory bank, deals the diagonal chunks out round-robin and
merges the partial aggregates on the host.  mpx does it over a 1-D mesh
with ``shard_map``; the port does it with one Python loop per shard:

* the job list is dealt round-robin over the shards (shard ``d`` takes
  jobs ``d, d + D, ...``: mpx's placement, without its padding dummy
  jobs, which only exist to give XLA equal static shapes);
* the statistics are copied once to each distinct device of the mesh,
  and each shard sweeps its jobs there with the selected kernel through
  the job loop (:func:`mpx_torch.kernels.sweep_jobs`) into its own
  partial aggregates;
* the shards' launches are issued in turns, one unit of each shard's
  loop at a time, so that distinct cards run at once and no card's launch
  queue holds the host back;
* the partial (value, index) aggregates are stacked on ``mesh[0]`` and
  merged with mpx's rule: the first maximum along the shard axis, the
  lowest shard on a tie.
"""

from __future__ import annotations

import torch

from mpx_torch.dtypes import AGGREGATE_INIT, torch_dtype
from mpx_torch.kernels import band_geometry, sweep_jobs
from mpx_torch.ops.aggregates import init_aggregates
from mpx_torch.parallel.mesh import mesh_for
from mpx_torch.types import Aggregates, JobGrid, Stats


def shard_jobs(grid: JobGrid, num_shards: int) -> list:
    """The round-robin share of each shard: ``num_shards`` JobGrids."""
    return [JobGrid(r0=grid.r0[d::num_shards], k0=grid.k0[d::num_shards],
                    band=grid.band, chunk=grid.chunk) for d in range(num_shards)]


def replicate(x, mesh: tuple) -> list:
    """``x`` (a tensor, a NamedTuple of tensors or None) on every device of
    ``mesh``, copied once to each distinct device."""
    copies = {}
    out = []
    for dev in mesh:
        if dev not in copies:
            copies[dev] = _to(x, dev)
        out.append(copies[dev])
    return out


def _to(x, dev):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(dev, non_blocking=True)
    return type(x)(*(_to(t, dev) for t in x))


def interleave(steps) -> None:
    """Advance each generator one step in turn until all are exhausted:
    the shards' launches are issued alternately."""
    done = object()
    live = list(steps)
    while live:
        live = [g for g in live if next(g, done) is not done]


def merge_stacked(parts: list, device) -> Aggregates:
    """Merge per-shard (L,) aggregates: the first (lowest shard) maximum
    along the shard axis (mpx's ``_merge_stacked``)."""
    v = torch.stack([p.value.to(device) for p in parts])
    i = torch.stack([p.index.to(device) for p in parts])
    best = torch.argmax(v, dim=0, keepdim=True)
    return Aggregates(v.gather(0, best)[0], i.gather(0, best)[0])


def run_jobs_sharded(
    stats: Stats,
    grid: JobGrid,
    *,
    num_shards: int,
    S: int,
    W: int,
    m: int,
    w: int,
    kernel: str,
    dtype: str,
    tr: int = 8,
    tc: int = 2048,
    mesh=None,
):
    """Shard the job grid over ``num_shards`` devices and merge profiles.

    Returns (row Aggregates, column Aggregates), each (w + S + W,), on
    ``mesh[0]`` (default mesh: the first ``num_shards`` devices of the
    statistics' device type)."""
    mesh = mesh_for(num_shards, mesh, stats.T.device)
    geom = band_geometry(S, W, m, w, tr, tc)
    dt = torch_dtype(dtype)
    L = w + S + W
    parts, steps = [], []
    for dev, st, jobs in zip(mesh, replicate(stats, mesh), shard_jobs(grid, num_shards)):
        rows = init_aggregates(L, dt, AGGREGATE_INIT, dev)
        cols = init_aggregates(L, dt, AGGREGATE_INIT, dev)
        parts.append((rows, cols))
        steps.append(sweep_jobs(st, jobs.r0, jobs.k0, geom=geom, dtype=dt, kernel=kernel,
                                rows=rows, cols=cols))
    interleave(steps)
    return (merge_stacked([p[0] for p in parts], mesh[0]),
            merge_stacked([p[1] for p in parts], mesh[0]))
