"""Several processes in mpx_torch (``mpx_torch.parallel.distributed``):
the single-process no-op and idempotence of ``initialize`` (mpx's cases),
and one two-process run on the CPU through a Gloo group opened from the
``MPX_*`` environment, whose profile matches the golden in each rank.
"""

import os
import socket
import subprocess
import sys

import numpy as np

from mpx_torch.parallel import distributed
from mpx_torch.reference import compute_matrix_profile_reference
from tests.conftest import REPO_ROOT, random_walk
from tests.helpers import assert_profile_close

_ENV = ("MPX_COORDINATOR", "MPX_NUM_PROCESSES", "MPX_PROCESS_ID")

# Each rank: join the group (twice: the second call reports it live),
# compute the job-sharded profile over both processes' shards, check its
# distances against the golden, save it and print one line.
_RANK = """
import numpy as np, sys
from mpx_torch.parallel import distributed
from mpx_torch.reference import compute_matrix_profile_reference
assert distributed.initialize() is True and distributed.initialize() is True
mesh = distributed.GlobalMesh(("cpu", "cpu"), *distributed.global_mesh(device="cpu")[1:])
assert distributed.mesh_spans_processes(mesh) and mesh.world == 2
T = np.cumsum(np.random.default_rng(41).standard_normal(1500))
MP, MPI = distributed.distributed_matrix_profile(T, 32, dtype="float64", band=64,
                                                 chunk=128, mesh=mesh, device="cpu")
assert np.abs(MP - compute_matrix_profile_reference(T, 32)[0]).max() <= 1e-8
np.save(sys.argv[1], np.stack([MP, MPI.astype(np.float64)]))
print("rank", mesh.rank, "ok")
"""


def test_initialize_noop_without_env(monkeypatch):
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    # an explicit single-process request is also a no-op
    assert distributed.initialize(num_processes=1) is False
    assert distributed.initialize(coordinator="localhost:1", num_processes=1) is False
    assert distributed.is_initialized() is False


def test_mesh_spans_processes_false_locally():
    mesh = distributed.global_mesh(device="cpu")
    assert mesh == distributed.GlobalMesh(distributed.default_mesh(device="cpu"), 0, 1)
    assert distributed.mesh_spans_processes(mesh) is False
    assert distributed.mesh_spans_processes(distributed.default_mesh(2, device="cpu")) is False


def test_single_process_profile_matches_golden():
    """Without a group the function runs on the local mesh (here three
    virtual CPU shards) and matches the golden."""
    T = random_walk(1024, seed=43)
    MP, MPI = distributed.distributed_matrix_profile(
        T, 32, dtype="float64", band=64, chunk=128, mesh=("cpu",) * 3, device="cpu")
    assert_profile_close(T, 32, MP, MPI, *compute_matrix_profile_reference(T, 32), eps=1e-8)


def test_two_process_gloo_profile(tmp_path):
    """Two processes x two virtual CPU shards, job-sharded over the four,
    partials all-gathered through Gloo: each rank returns the golden
    profile, and both ranks the same arrays."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, MPX_COORDINATOR=f"localhost:{port}", MPX_NUM_PROCESSES="2",
                   MPX_PROCESS_ID=str(rank), PYTHONPATH=REPO_ROOT)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK, str(tmp_path / f"r{rank}.npy")], cwd=REPO_ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {rank} ok" in out, out
    a, b = (np.load(tmp_path / f"r{r}.npy") for r in range(2))
    np.testing.assert_array_equal(a, b)
    T = np.cumsum(np.random.default_rng(41).standard_normal(1500))
    assert_profile_close(T, 32, a[0], a[1].astype(np.int32),
                         *compute_matrix_profile_reference(T, 32), eps=1e-8)
