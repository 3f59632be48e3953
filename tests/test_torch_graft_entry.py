"""The repo's root entry points in mpx_torch (``mpx_torch.graft_entry``)
against ``__graft_entry__``'s on the CPU: ``entry()``'s step on the same
series as mpx's, each phase of ``dryrun_multichip`` against mpx's function
of that phase on the same seed (job shards over a 4-device mesh, the ring,
the sharded float64 hybrid, sharded mSTAMP, the sharded fleet), the whole
dry run's OK lines through the API and the command line, and the
two-process phase's timeout and error report.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as mpx_graft
from mpx.config import MatrixProfileConfig as MpxConfig
from mpx.config import make_job_grid as mpx_job_grid
from mpx.ops.aggregates import postcompute as mpx_postcompute
from mpx.reference import compute_matrix_profile_reference
from mpx_torch import graft_entry
from mpx_torch.cli import main as cli_main
from mpx_torch.ops.aggregates import postcompute
from mpx_torch.parallel.distributed import initialize
from mpx_torch.parallel.mesh import default_mesh, virtual_devices
from tests.helpers import assert_profile_close

CPU = torch.device("cpu")
OK_LINES = ("dryrun_multichip(4): OK", "dryrun ring(4): OK", "dryrun hybrid-f64 sharded(4): OK",
            "dryrun mstamp sharded(4): OK", "dryrun batch sharded(4): OK",
            "dryrun multiprocess(2x2): OK")


def _walk(n, seed, shape=None):
    return np.cumsum(np.random.default_rng(seed).standard_normal(shape or n), axis=-1)


def test_entry_step_matches_mpx():
    """fn(*example_args) on the CPU (the plain sweep) against mpx's step on
    the same series: the distances after each side's postcompute within
    2e-3, indices equal or equidistant, and both against the golden."""
    fn, args = graft_entry.entry(device="cpu")
    mfn, margs = mpx_graft.entry()
    w = 1024 - 32 + 1
    MP, MPI = (x.numpy() for x in postcompute(*fn(*args), 32, w))
    mMP, mMPI = (np.asarray(x) for x in mpx_postcompute(*mfn(*margs), 32, w))
    T = _walk(1024, 0)
    assert_profile_close(T, 32, MP, MPI, mMP, mMPI, eps=2e-3)
    assert_profile_close(T, 32, MP, MPI, *compute_matrix_profile_reference(T, 32), eps=2e-3)


def test_entry_arguments_mirror_mpxs():
    """The plain sweep on the CPU, mpx's geometry, the job grid's r0/k0 as
    int32 tensors on the device equal to mpx's, and aggregates of mpx's
    length."""
    fn, (stats, grid) = graft_entry.entry(device="cpu")
    mfn, margs = mpx_graft.entry()
    r0, k0 = margs[1:]
    assert fn.keywords["kernel"] == "mxu" and fn.keywords["dtype"] == torch.float32
    g = fn.keywords["geom"]
    assert (g.S, g.W, g.m, g.w) == (128, 256, 32, 993)
    assert (g.S, g.W, g.m, g.w) == tuple(mfn.keywords[k] for k in ("S", "W", "m", "w"))
    for mine, theirs in ((grid.r0, r0), (grid.k0, k0)):
        assert isinstance(mine, torch.Tensor) and mine.device == CPU
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    assert stats.T.device == CPU and stats.windows.dtype == torch.float32
    rows, cols = fn(stats, grid)
    assert rows.value.shape == cols.value.shape == np.asarray(mfn(*margs)[0].value).shape


def test_entry_points_on_the_card_raise_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(4)


def test_virtual_devices_lay_the_cards_round_robin(monkeypatch):
    """Inside virtual_devices(k) a default mesh sees k devices: the one card
    named k times, or k CPU shards; outside it, the visible cards only."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with virtual_devices(4):
        assert default_mesh(device="cuda") == (torch.device("cuda", 0),) * 4
        assert default_mesh(3, device="cuda") == (torch.device("cuda", 0),) * 3
        assert default_mesh(device="cpu") == (CPU,) * 4
        with pytest.raises(ValueError, match="only 4 available"):
            default_mesh(5, device="cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with virtual_devices(3):
        assert default_mesh(device="cuda") == tuple(torch.device("cuda", i) for i in (0, 1, 0))
    assert default_mesh(device="cuda") == (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(ValueError, match="only 2 available"):
        default_mesh(4, device="cuda")


def test_job_shards_match_mpx():
    """mpx's first dryrun phase on the same inputs: its job-sharded
    profile over 4 devices against the port's over 4 CPU shards."""
    from mpx.ops.precompute import precompute_statistics
    from mpx.parallel.sharding import run_jobs_sharded

    MP, MPI = graft_entry.dryrun_jobs(4, CPU)
    T = _walk(512, 1)
    w = 512 - 16 + 1
    stats = precompute_statistics(T, 16, band=32, chunk=64, dtype="float32")
    rows, cols = run_jobs_sharded(stats, mpx_job_grid(w, 32, 64), num_shards=4, S=32, W=64,
                                  m=16, w=w, kernel="mxu", dtype="float32", tr=8, tc=64)
    mMP, mMPI = (np.asarray(x) for x in mpx_postcompute(rows, cols, 16, w))
    assert_profile_close(T, 16, MP, MPI, mMP, mMPI, eps=2e-3)


def _mpx_ring():
    from mpx.parallel.ring import run_ring_sharded

    return run_ring_sharded(_walk(1024, 2), 16, num_shards=4, band=64, chunk=64)


def _mpx_hybrid():
    from mpx.driver import compute_matrix_profile

    return compute_matrix_profile(_walk(1024, 2), config=MpxConfig(
        m=16, dtype="float64", kernel="hybrid", band=32, chunk=64, tile_rows=8,
        tile_cols=32, num_shards=4))


@pytest.mark.parametrize("tier, mpx_run, eps", [
    ("ring", _mpx_ring, 2e-3),
    ("hybrid", _mpx_hybrid, 1e-8),
])
def test_sharded_profile_matches_mpx_and_golden(tier, mpx_run, eps):
    """The ring and the float64 hybrid over 4 CPU shards: within ``eps``
    of mpx's same tier over 4 devices and of the golden."""
    with virtual_devices(4):
        MP, MPI = getattr(graft_entry, f"dryrun_{tier}")(4, CPU)
    T = _walk(1024, 2)
    assert_profile_close(T, 16, MP, MPI, *(np.asarray(x) for x in mpx_run()), eps=eps)
    assert_profile_close(T, 16, MP, MPI, *compute_matrix_profile_reference(T, 16), eps=eps)


def test_sharded_mstamp_bit_equal_and_matches_mpx():
    from mpx.mstamp import compute_multidim_profile as mpx_mstamp

    from mpx_torch.mstamp import compute_multidim_profile

    T = _walk(512, 3, (3, 512))
    shd = graft_entry.dryrun_mstamp(4, CPU)
    one = compute_multidim_profile(T, config=graft_entry._config(dtype="float32", device="cpu"))
    np.testing.assert_array_equal(shd.PMP, one.PMP)
    theirs = mpx_mstamp(T, config=MpxConfig(m=16, dtype="float32", band=32, chunk=64,
                                            num_shards=4))
    np.testing.assert_allclose(shd.PMP, theirs.PMP, atol=2e-3, rtol=0)


def test_sharded_batch_bit_equal_and_matches_mpx():
    from mpx.batch import compute_batch_profiles as mpx_batch

    from mpx_torch.batch import compute_batch_profiles

    T = _walk(384, 4, (5, 384))
    MP, MPI = graft_entry.dryrun_batch(4, CPU)
    MP1, MPI1 = compute_batch_profiles(T, config=graft_entry._config(dtype="float32",
                                                                     device="cpu"))
    np.testing.assert_array_equal(MP, MP1)
    np.testing.assert_array_equal(MPI, MPI1)
    mMP, mMPI = mpx_batch(T, config=MpxConfig(m=16, dtype="float32", band=32, chunk=64,
                                              num_shards=4))
    for b in range(T.shape[0]):
        assert_profile_close(T[b], 16, MP[b], MPI[b], mMP[b], mMPI[b], eps=2e-3)


@pytest.mark.parametrize("route", ["api", "cli"])
def test_dryrun_multichip_prints_every_ok_line(route, capsys):
    if route == "api":
        graft_entry.dryrun_multichip(4, device="cpu")
    else:
        assert cli_main(["dryrun", "-n", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for line in OK_LINES:
        assert line in out, out
    assert out.count(": OK") == len(OK_LINES)


def test_two_processes_finish_within_their_timeout(capsys):
    """Two processes of two CPU shards each, over Gloo: rank 0's OK line,
    well inside the 120 s each process is given."""
    assert graft_entry.PROCESS_TIMEOUT == 120
    graft_entry.dryrun_multiprocess(2, 2, CPU)
    out = capsys.readouterr().out
    assert "dryrun multiprocess(2x2): OK" in out
    err = float(out.split("maxerr=")[1].split()[0])
    assert err < 2e-3


def test_a_process_over_its_timeout_is_stopped_and_raises(monkeypatch):
    monkeypatch.setattr(graft_entry, "PROCESS_TIMEOUT", 0.2)
    with pytest.raises(RuntimeError, match=r"process \d failed \(timed out after 0.2 s\)"):
        graft_entry.dryrun_multiprocess(2, 1, CPU)


def test_a_failing_process_raises_with_its_stderr():
    # zero shards a process: each process raises inside virtual_devices
    with pytest.raises(RuntimeError, match="(?s)rc=1.*virtual_devices needs a positive count"):
        graft_entry.dryrun_multiprocess(2, 0, CPU)


def test_initialize_takes_an_explicit_backend(monkeypatch):
    """The group's backend is the caller's when given (Gloo for ranks that
    share a card), else NCCL beside Gloo where NCCL runs, else Gloo."""
    import torch.distributed as dist

    seen = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: seen.append(kw["backend"]))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    args = dict(coordinator="127.0.0.1:1", num_processes=2, process_id=0)
    assert initialize(**args, backend="gloo") is True
    assert initialize(**args) is True
    assert seen == ["gloo", "cpu:gloo,cuda:nccl"]
