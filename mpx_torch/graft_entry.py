"""The driver entry points of the repo, counterpart of the root
``__graft_entry__.py``:

* :func:`entry` returns one single-device forward step with example
  arguments: one job batch of :func:`mpx_torch.driver.run_jobs` (K1 on
  the card, its plain version on the CPU);
* :func:`dryrun_multichip` runs the multi-device step on an n-device mesh:
  job sharding with the cross-device first-maximum merge against the
  golden; the other sharded tiers on the same mesh (the ring, the float64
  hybrid, mSTAMP, the fleet); then two processes that meet in a
  ``torch.distributed`` group through ``MPX_COORDINATOR`` /
  ``MPX_NUM_PROCESSES`` / ``MPX_PROCESS_ID`` and compute one profile.

::

    python -m mpx_torch dryrun -n 4 [--device cpu]

Both run on the card unless the caller passes ``device="cpu"``; on a
machine without a card, a call that asks for the card raises.  On fewer cards than the mesh asks for, the mesh
names the cards round-robin (:func:`mpx_torch.parallel.mesh.virtual_devices`;
on one card, four virtual shards of it).  mpx starts its virtual CPU mesh
in a subprocess, because XLA reads its device count before its backend
starts; torch has no such setting, so the mesh is laid in the calling
process.  The two processes share the card through Gloo: NCCL refuses two
ranks on one device.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from functools import partial

import numpy as np
import torch

# The seconds each process of the two-process phase may take.
PROCESS_TIMEOUT = 120.0


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(dev)!r} was requested but no CUDA device is "
                           f"available; pass device='cpu' to run the plain PyTorch path")
    return dev


def entry(device=None):
    """``(fn, example_args)``: ``fn(*example_args)`` sweeps every job of an
    n = 1024, m = 32 self-join (band 128, chunk 256, float32, a random walk
    from seed 0) and returns the (row, column) aggregates, as
    ``__graft_entry__.entry()``'s step does.  ``fn`` is
    :func:`mpx_torch.driver.run_jobs` with K1 on the card and the plain
    sweep on the CPU; ``example_args`` are the statistics and the job grid,
    its ``r0``/``k0`` as tensors on the device."""
    from mpx_torch.config import make_job_grid
    from mpx_torch.driver import run_jobs
    from mpx_torch.kernels import band_geometry, resolve_kernel
    from mpx_torch.ops.precompute import precompute_statistics
    from mpx_torch.types import JobGrid

    dev = _device(device)
    n, m = 1024, 32
    band, chunk = 128, 256
    w = n - m + 1
    T = np.cumsum(np.random.default_rng(0).standard_normal(n))
    stats = precompute_statistics(T, m, band=band, chunk=chunk, dtype="float32", device=dev)
    grid = make_job_grid(w, band, chunk)
    fn = partial(run_jobs, geom=band_geometry(band, chunk, m, w, 8, 256),
                 dtype=torch.float32, kernel=resolve_kernel("auto", dev))
    example_args = (stats, JobGrid(r0=torch.as_tensor(grid.r0, device=dev),
                                   k0=torch.as_tensor(grid.k0, device=dev),
                                   band=band, chunk=chunk))
    return fn, example_args


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the multi-device step on an ``n_devices`` mesh of ``device``'s
    type, then on two processes of ``max(1, n_devices // 2)`` shards each.
    Each phase prints mpx's ``OK`` line; any disagreement raises."""
    from mpx_torch.parallel.mesh import virtual_devices

    dev = _device(device)
    with virtual_devices(n_devices):
        dryrun_jobs(n_devices, dev)
        for tier in (dryrun_ring, dryrun_hybrid, dryrun_mstamp, dryrun_batch):
            tier(n_devices, dev)
    dryrun_multiprocess(2, max(1, n_devices // 2), dev)


def _golden_err(T, m: int, MP) -> float:
    from mpx_torch.reference import compute_matrix_profile_reference

    return float(np.abs(np.asarray(MP, np.float64)
                        - compute_matrix_profile_reference(T, m)[0]).max())


def _config(**kw):
    from mpx_torch.config import MatrixProfileConfig

    return MatrixProfileConfig(m=16, band=32, chunk=64, **kw)


def dryrun_jobs(n_devices: int, device) -> tuple:
    """The job list of an n = 512, m = 16 float32 self-join (band 32, chunk
    64, seed 1) dealt over the mesh, the shards' aggregates merged, against
    the golden within 2e-3.  Returns (MP, MPI) as numpy arrays."""
    from mpx_torch.config import make_job_grid
    from mpx_torch.kernels import resolve_kernel
    from mpx_torch.ops.aggregates import postcompute
    from mpx_torch.ops.precompute import precompute_statistics
    from mpx_torch.parallel.sharding import run_jobs_sharded

    n, m = 512, 16
    band, chunk = 32, 64
    w = n - m + 1
    T = np.cumsum(np.random.default_rng(1).standard_normal(n))
    stats = precompute_statistics(T, m, band=band, chunk=chunk, dtype="float32",
                                  device=device)
    rows, cols = run_jobs_sharded(stats, make_job_grid(w, band, chunk), num_shards=n_devices,
                                  S=band, W=chunk, m=m, w=w,
                                  kernel=resolve_kernel("auto", device), dtype="float32",
                                  tr=8, tc=64)
    MP, MPI = (x.cpu().numpy() for x in postcompute(rows, cols, m, w))
    if MP.shape != (w,) or not np.isfinite(MP).all():
        raise AssertionError(f"dryrun produced a profile of shape {MP.shape} with "
                             f"{int((~np.isfinite(MP)).sum())} non-finite values")
    err = _golden_err(T, m, MP)
    if not err < 2e-3:
        raise AssertionError(f"job-sharded profile off golden by {err}")
    print(f"dryrun_multichip({n_devices}): OK, MP[:3]={MP[:3]}, maxerr={err:.2e}", flush=True)
    return MP, MPI


def _ring_series() -> np.ndarray:
    return np.cumsum(np.random.default_rng(2).standard_normal(1024))


def dryrun_ring(n_devices: int, device) -> tuple:
    """The inputs sharded over the mesh (the ring, float32), n = 1024,
    m = 16, band = chunk = 64, seed 2, against the golden within 2e-3.
    Returns (MP, MPI) as numpy arrays."""
    from mpx_torch.parallel.ring import run_ring_sharded

    T = _ring_series()
    MP, MPI = (x.cpu().numpy() for x in run_ring_sharded(
        T, 16, num_shards=n_devices, band=64, chunk=64, device=device))
    err = _golden_err(T, 16, MP)
    if not err < 2e-3:
        raise AssertionError(f"ring-sharded profile off golden by {err}")
    print(f"dryrun ring({n_devices}): OK, maxerr={err:.2e}", flush=True)
    return MP, MPI


def dryrun_hybrid(n_devices: int, device) -> tuple:
    """The float64 hybrid with its passes A and B sharded over the mesh, on
    the ring's series, against the golden within 1e-8.  Returns (MP, MPI)
    as numpy arrays."""
    from mpx_torch.driver import compute_matrix_profile

    T = _ring_series()
    cfg = _config(dtype="float64", kernel="hybrid", tile_rows=8, tile_cols=32,
                  num_shards=n_devices, device=device)
    MP, MPI = (x.cpu().numpy() for x in compute_matrix_profile(T, config=cfg))
    err = _golden_err(T, 16, MP)
    if not err < 1e-8:
        raise AssertionError(f"sharded hybrid double off golden by {err}")
    print(f"dryrun hybrid-f64 sharded({n_devices}): OK, maxerr={err:.2e}", flush=True)
    return MP, MPI


def dryrun_mstamp(n_devices: int, device):
    """mSTAMP (3 dimensions of 512, m = 16, float32, seed 3) sharded over
    the mesh, bit-equal to one device.  Returns the sharded MultiProfile."""
    from mpx_torch.mstamp import compute_multidim_profile

    T = np.cumsum(np.random.default_rng(3).standard_normal((3, 512)), axis=1)
    one = compute_multidim_profile(T, config=_config(dtype="float32", device=device))
    shd = compute_multidim_profile(T, config=_config(dtype="float32", num_shards=n_devices,
                                                     device=device))
    err = float(np.abs(shd.PMP - one.PMP).max())
    if err != 0.0:
        raise AssertionError(f"sharded mSTAMP diverges from single-device: {err}")
    print(f"dryrun mstamp sharded({n_devices}): OK", flush=True)
    return shd


def dryrun_batch(n_devices: int, device) -> tuple:
    """The fleet (n_devices + 1 series of 384, m = 16, float32, seed 4)
    with its series laid over the mesh, bit-equal to one device.  Returns
    the sharded (MP, MPI), one row a series."""
    from mpx_torch.batch import compute_batch_profiles

    T = np.cumsum(np.random.default_rng(4).standard_normal((n_devices + 1, 384)), axis=1)
    MP1, MPI1 = compute_batch_profiles(T, config=_config(dtype="float32", device=device))
    MPn, MPIn = compute_batch_profiles(T, config=_config(dtype="float32",
                                                         num_shards=n_devices, device=device))
    if not ((MP1 == MPn).all() and (MPI1 == MPIn).all()):
        raise AssertionError("sharded batch tier diverges from single-device")
    print(f"dryrun batch sharded({n_devices}): OK", flush=True)
    return MPn, MPIn


# Each process: join the group over Gloo, lay its shards, compute the
# job-sharded profile over every process's shards and hold it to the golden.
_PROCESS = """
import sys
import numpy as np
import torch.distributed as dist
from mpx_torch.parallel.distributed import distributed_matrix_profile, initialize
from mpx_torch.parallel.mesh import virtual_devices
from mpx_torch.reference import compute_matrix_profile_reference
device, k = sys.argv[1], int(sys.argv[2])
assert initialize(backend="gloo"), "distributed initialize fell back to single-process"
try:
    T = np.cumsum(np.random.default_rng(7).standard_normal(768))
    with virtual_devices(k):
        MP, MPI = distributed_matrix_profile(T, 16, kernel="auto", band=64, chunk=64,
                                             tile_rows=8, tile_cols=32, device=device)
    err = float(np.abs(MP - compute_matrix_profile_reference(T, 16)[0]).max())
    assert err < 2e-3, f"multiprocess profile off golden by {err}"
    if dist.get_rank() == 0:
        print(f"dryrun multiprocess({dist.get_world_size()}x{k}): OK, maxerr={err:.2e}",
              flush=True)
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_processes(n_processes: int, per_process: int, device) -> tuple:
    """Start the processes and wait for all, each at most
    :data:`PROCESS_TIMEOUT` seconds (one that fails stops the others).
    Returns (rank, returncode, stdout, stderr) for each process, and
    whether the time ran out."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()  # bind, then close: another program may take it first
    procs = []
    for rank in range(n_processes):
        env = dict(os.environ, MPX_COORDINATOR=f"127.0.0.1:{port}",
                   MPX_NUM_PROCESSES=str(n_processes), MPX_PROCESS_ID=str(rank),
                   PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", _PROCESS, str(device), str(per_process)], cwd=repo,
            env=env, stdout=out, stderr=err, text=True), out, err))
    deadline = time.monotonic() + PROCESS_TIMEOUT
    timed_out = True
    try:
        while time.monotonic() < deadline:
            codes = [p.poll() for p, _, _ in procs]
            if all(c is not None for c in codes) or any(c for c in codes):
                timed_out = False
                break
            time.sleep(0.1)
    finally:
        for p, _, _ in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    results = []
    for rank, (p, out, err) in enumerate(procs):
        out.seek(0)
        err.seek(0)
        results.append((rank, p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    return results, timed_out


def dryrun_multiprocess(n_processes: int, per_process: int, device) -> None:
    """``n_processes`` local processes of ``per_process`` shards each join
    one group over Gloo and compute the job-sharded profile of an n = 768,
    m = 16 series (band = chunk = 64, seed 7) against the golden within
    2e-3.  A process that fails or outlasts :data:`PROCESS_TIMEOUT` seconds
    makes this raise with its standard error; a port taken between its
    choice and the group's rendezvous is retried once on a fresh port."""
    results, timed_out = _run_processes(n_processes, per_process, device)
    failed = [r for r in results if r[1] != 0]
    if any("address already in use" in r[3].lower() for r in failed):
        results, timed_out = _run_processes(n_processes, per_process, device)
        failed = [r for r in results if r[1] != 0]
    for _, _, out, _ in results:
        sys.stdout.write(out)
    sys.stdout.flush()
    if failed:
        # the process that failed first, not one stopped because of it
        rank, rc, _, err = min(failed, key=lambda r: r[1] == -9)
        why = f"timed out after {PROCESS_TIMEOUT:g} s" if timed_out else f"rc={rc}"
        raise RuntimeError(f"multiprocess dryrun: process {rank} failed ({why}):\n"
                           f"{err[-2000:]}")
