"""Several processes, counterpart of ``mpx/parallel/distributed.py``.

mpx joins JAX's coordination service and lays one mesh over every
process's chips.  The port opens a ``torch.distributed`` process group
instead (NCCL for the cards, Gloo for the CPU, rendezvous over
``tcp://``): each rank sweeps its round-robin share of the job list on
its own devices, the ranks' partial aggregates are all-gathered, and every
rank merges them with the lowest-rank rule and returns the full profile.

Environment bootstrap, used when no explicit arguments are given (mpx's
names): ``MPX_COORDINATOR`` (host:port), ``MPX_NUM_PROCESSES``,
``MPX_PROCESS_ID``.  One process is a no-op.

    MPX_COORDINATOR=localhost:29500 MPX_NUM_PROCESSES=2 MPX_PROCESS_ID=0 python run.py &
    MPX_COORDINATOR=localhost:29500 MPX_NUM_PROCESSES=2 MPX_PROCESS_ID=1 python run.py

with ``run.py`` calling :func:`initialize` and then
:func:`distributed_matrix_profile`.
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from mpx_torch.parallel.mesh import default_mesh

_ENV_COORD = "MPX_COORDINATOR"
_ENV_NPROC = "MPX_NUM_PROCESSES"
_ENV_PID = "MPX_PROCESS_ID"
# How long the rendezvous waits for every process.
_TIMEOUT = datetime.timedelta(minutes=5)


class GlobalMesh(NamedTuple):
    """A 1-D mesh over every process's devices: this process's ``local``
    devices are shards ``rank * len(local) ..`` of ``world * len(local)``
    (every process holds as many)."""

    local: tuple
    rank: int
    world: int


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the process group.  Arguments fall back to MPX_COORDINATOR /
    MPX_NUM_PROCESSES / MPX_PROCESS_ID.  Returns True when running
    distributed, False for the single-process no-op.  Safe to call twice.
    The group's backend is NCCL for CUDA tensors beside Gloo for CPU
    tensors where NCCL is available, else Gloo."""
    if is_initialized():
        return True
    coordinator = coordinator or os.environ.get(_ENV_COORD)
    if num_processes is None and _ENV_NPROC in os.environ:
        num_processes = int(os.environ[_ENV_NPROC])
    if process_id is None and _ENV_PID in os.environ:
        process_id = int(os.environ[_ENV_PID])
    if not coordinator or not num_processes or num_processes <= 1:
        return False
    nccl = torch.cuda.is_available() and dist.is_nccl_available()
    dist.init_process_group(
        backend="cpu:gloo,cuda:nccl" if nccl else "gloo",
        init_method=f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
        timeout=_TIMEOUT,
    )
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def global_mesh(axis: str = "jobs", device="cuda") -> GlobalMesh:
    """A mesh over every device of every process (this process's: every
    visible card, or one CPU shard).  ``axis`` as for
    :func:`mpx_torch.parallel.mesh.default_mesh`."""
    local = default_mesh(axis=axis, device=device)
    if not is_initialized():
        return GlobalMesh(local, 0, 1)
    return GlobalMesh(local, dist.get_rank(), dist.get_world_size())


def mesh_spans_processes(mesh) -> bool:
    return isinstance(mesh, GlobalMesh) and mesh.world > 1


def _all_gather(x: torch.Tensor, world: int) -> torch.Tensor:
    out = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(out, x)
    return torch.stack(out)


def distributed_matrix_profile(
    T,
    m: int,
    *,
    dtype: str = "float32",
    kernel: str = "mxu",
    band: int = 256,
    chunk: int = 512,
    tile_rows: int = 8,
    tile_cols: int = 2048,
    mesh=None,
    device="cuda",
):
    """Self-join matrix profile over a process-spanning mesh (default:
    :func:`global_mesh` on ``device``'s type; a tuple is this process's
    devices).  Every process computes the
    O(n) statistics, sweeps the jobs of its shards (the job list dealt
    round-robin over all ``world * len(local)`` shards), and the merged
    (MP, MPI) comes back on every process as numpy arrays.  Inside a
    process group the partials are all-gathered over it (one rank too).  ``kernel`` as
    for :class:`mpx_torch.config.MatrixProfileConfig` (``mxu`` is mpx's
    default, the plain sweep; ``auto`` or ``mxu_fused`` run K1 on the
    card)."""
    from mpx_torch.config import make_job_grid
    from mpx_torch.dtypes import torch_dtype
    from mpx_torch.kernels import is_recurrence, needs_windows, resolve_kernel
    from mpx_torch.ops.aggregates import postcompute
    from mpx_torch.ops.precompute import precompute_statistics
    from mpx_torch.parallel.sharding import run_jobs_sharded
    from mpx_torch.types import Aggregates, JobGrid

    if mesh is None:
        mesh = global_mesh(device=device)
    elif not isinstance(mesh, GlobalMesh):  # this process's devices
        mesh = GlobalMesh(tuple(mesh), *((dist.get_rank(), dist.get_world_size())
                                         if is_initialized() else (0, 1)))
    dt = torch_dtype(dtype)
    T = np.asarray(T, np.float64)
    w = T.shape[0] - m + 1
    local = tuple(torch.device(d) for d in mesh.local)
    kernel = resolve_kernel(kernel, local[0], dt, m)
    stats = precompute_statistics(T, m, band=band, chunk=chunk, dtype=dt, device=local[0],
                                  windows=needs_windows(kernel),
                                  exact_mean=is_recurrence(kernel))
    grid = make_job_grid(w, band, chunk)
    # This process's shards are global shards rank * k .. rank * k + k - 1
    # of world * k, and global shard g takes the jobs j = g mod world * k.
    # Those jobs in order, dealt round-robin over the k local shards, land
    # on the same shards.
    k = len(local)
    mine = np.arange(grid.r0.shape[0]) % (mesh.world * k) // k == mesh.rank
    sub = JobGrid(r0=grid.r0[mine], k0=grid.k0[mine], band=band, chunk=chunk)
    rows, cols = run_jobs_sharded(stats, sub, num_shards=k, S=band, W=chunk, m=m, w=w,
                                  kernel=kernel, dtype=dtype, tr=tile_rows, tc=tile_cols,
                                  mesh=local)
    if is_initialized():
        from mpx_torch.parallel.sharding import merge_stacked

        merged = []
        for agg in (rows, cols):
            v, i = _all_gather(agg.value, mesh.world), _all_gather(agg.index, mesh.world)
            merged.append(merge_stacked([Aggregates(v[r], i[r]) for r in range(mesh.world)],
                                        local[0]))
        rows, cols = merged
    MP, MPI = postcompute(rows, cols, m, w)
    return MP.cpu().numpy(), MPI.cpu().numpy()
