"""Job sharding in mpx_torch (``mpx_torch.parallel``, on the CPU's virtual
shards) against mpx's sharded runs on its 8 virtual CPU devices and the
golden, on the same inputs: profiles within 1e-8 (float64) / 2e-3
(float32), indices equal or equidistant; a sharded run's values equal to
the single-device run's bit for bit (each pair is computed by the same
kernel whichever shard sweeps it).  Also the hybrid's sharded passes,
sharded mSTAMP and the fleet laid over a mesh.
"""

import numpy as np
import pytest
import torch

import mpx
from mpx.config import make_job_grid as mpx_grid
from mpx.config import pad_job_grid
from mpx.mstamp import compute_multidim_profile as mpx_mstamp
from mpx.reference import compute_matrix_profile_reference
from mpx_torch import MatrixProfileConfig, compute_matrix_profile
from mpx_torch.batch import compute_batch_profiles
from mpx_torch.config import make_job_grid
from mpx_torch.kernels import mxu, mxu_fused, recurrence, xla
from mpx_torch.mstamp import compute_multidim_profile
from mpx_torch.parallel import default_mesh
from mpx_torch.parallel.sharding import interleave, merge_stacked, shard_jobs
from mpx_torch.types import Aggregates
from tests.conftest import random_walk
from tests.helpers import assert_profile_close
from tests.test_mstamp import assert_multiprofile_close

EPS = {"float64": 1e-8, "float32": 2e-3}


def _np(out):
    return [o.numpy() for o in out]


def test_default_mesh(monkeypatch):
    assert default_mesh(3, device="cpu") == (torch.device("cpu"),) * 3
    assert default_mesh(device="cpu") == (torch.device("cpu"),)
    # One visible card: a mesh of one is it, a mesh of two is mpx's refusal.
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert default_mesh(1, device="cuda") == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="requested 2 devices, only 1 available"):
        default_mesh(2, device="cuda")


@pytest.mark.parametrize("num_shards", [2, 3, 8])
def test_round_robin_placement_is_mpxs(num_shards):
    """Shard d takes jobs d, d + D, ...: mpx's placement less its padding."""
    grid = make_job_grid(1000, 64, 256)
    ref = pad_job_grid(mpx_grid(1000, 64, 256), num_shards, dummy_r0=1000)
    per = ref.r0.shape[0] // num_shards
    order = np.arange(ref.r0.shape[0]).reshape(per, num_shards).T
    for d, jobs in enumerate(shard_jobs(grid, num_shards)):
        real = order[d][order[d] < grid.r0.shape[0]]
        np.testing.assert_array_equal(jobs.r0, ref.r0[real])
        np.testing.assert_array_equal(jobs.k0, ref.k0[real])


def test_merge_takes_the_lowest_shard_on_ties():
    parts = [Aggregates(torch.tensor([1.0, 2.0, 3.0]), torch.tensor([10, 11, 12])),
             Aggregates(torch.tensor([1.0, 5.0, 3.0]), torch.tensor([20, 21, 22]))]
    got = merge_stacked(parts, torch.device("cpu"))
    assert got.value.tolist() == [1.0, 5.0, 3.0] and got.index.tolist() == [10, 21, 12]


def test_interleave_alternates():
    seen = []

    def gen(name, k):
        for i in range(k):
            seen.append((name, i))
            yield

    interleave([gen("a", 3), gen("b", 1), gen("c", 2)])
    assert seen == [("a", 0), ("b", 0), ("c", 0), ("a", 1), ("c", 1), ("a", 2)]


@pytest.mark.parametrize("num_shards", [2, 8])
@pytest.mark.parametrize("kernel,dtype", [("xla", "float64"), ("pallas", "float64"),
                                          ("mxu", "float64"), ("mxu_fused", "float32"),
                                          ("auto", "float32")])
def test_sharded_matches_mpx_and_golden(num_shards, kernel, dtype):
    n, m = 1024, 32
    T = random_walk(n, seed=11)
    kw = dict(m=m, dtype=dtype, band=64, chunk=128, tile_rows=8, tile_cols=8,
              num_shards=num_shards)
    calls = (mxu.CALLS, xla.CALLS)
    MP, MPI = _np(compute_matrix_profile(T, config=MatrixProfileConfig(
        kernel=kernel, device="cpu", **kw)))
    # The plain versions ran for CPU tensors: K1 and K3 launched nothing.
    assert (mxu.CALLS, xla.CALLS) != calls
    # mpx's recurrence (its Pallas kernel's plain version) or windows matmul.
    mpx_kernel = "xla" if kernel in ("xla", "pallas") else "mxu"
    ref = mpx.compute_matrix_profile(T, config=mpx.MatrixProfileConfig(kernel=mpx_kernel, **kw))
    assert_profile_close(T, m, MP, MPI, *(np.asarray(x) for x in ref), eps=EPS[dtype])
    assert_profile_close(T, m, MP, MPI, *compute_matrix_profile_reference(T, m),
                         eps=EPS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sharded_values_equal_single_device(dtype):
    n, m = 512, 16
    T = random_walk(n, seed=13)
    base = dict(m=m, dtype=dtype, band=64, chunk=64, tile_rows=8, tile_cols=8, device="cpu")
    MP1, MPI1 = _np(compute_matrix_profile(T, config=MatrixProfileConfig(**base)))
    MP8, MPI8 = _np(compute_matrix_profile(T, config=MatrixProfileConfig(**base,
                                                                         num_shards=8)))
    np.testing.assert_array_equal(MP1, MP8)
    assert_profile_close(T, m, MP8, MPI8, MP1, MPI1, eps=EPS[dtype])


def test_sharded_launches_no_kernel_on_the_cpu():
    before = (mxu_fused.LAUNCHES, recurrence.LAUNCHES)
    compute_matrix_profile(random_walk(400, seed=2), config=MatrixProfileConfig(
        m=16, band=64, chunk=64, num_shards=4, device="cpu"))
    assert (mxu_fused.LAUNCHES, recurrence.LAUNCHES) == before


@pytest.mark.parametrize("num_shards", [2, 8])
def test_sharded_hybrid_matches_mpx_and_golden(num_shards):
    """The hybrid's passes A and B dealt over the shards (pass B dense)."""
    from mpx_torch.utils.profile import BenchmarkProfile

    n, m = 1500, 24
    T = random_walk(n, seed=17)
    kw = dict(m=m, dtype="float64", kernel="hybrid", band=64, chunk=128,
              num_shards=num_shards)
    prof = BenchmarkProfile()
    MP, MPI = _np(compute_matrix_profile(T, config=MatrixProfileConfig(device="cpu", **kw),
                                         profile=prof))
    assert prof.counts["pass_b"] == "dense"
    assert any("sharded x" in k for k in prof.category_totals())
    ref = mpx.compute_matrix_profile(T, config=mpx.MatrixProfileConfig(**kw))
    assert_profile_close(T, m, MP, MPI, *(np.asarray(x) for x in ref), eps=1e-8)
    assert_profile_close(T, m, MP, MPI, *compute_matrix_profile_reference(T, m), eps=1e-8)


def test_hybrid_refuses_what_mpx_refuses_with_shards(tmp_path):
    from mpx_torch.checkpoint import compute_with_checkpoint

    T = random_walk(300, seed=5)
    cfg = MatrixProfileConfig(m=16, dtype="float64", kernel="hybrid", num_shards=2,
                              device="cpu")
    with pytest.raises(ValueError, match="single-device"):
        compute_matrix_profile(T, config=cfg, left_right=True)
    with pytest.raises(ValueError, match="single-device"):
        compute_with_checkpoint(T, cfg, str(tmp_path / "c.npz"))


@pytest.mark.parametrize("num_shards", [2, 8])
def test_sharded_mstamp_matches_mpx(num_shards):
    rng = np.random.default_rng(23)
    T = np.cumsum(rng.standard_normal((3, 600)), axis=1)
    kw = dict(m=16, band=64, chunk=128, num_shards=num_shards)
    for dtype in ("float32", "float64"):
        ours = compute_multidim_profile(T, config=MatrixProfileConfig(dtype=dtype,
                                                                      device="cpu", **kw))
        one = compute_multidim_profile(T, config=MatrixProfileConfig(
            dtype=dtype, device="cpu", **{**kw, "num_shards": None}))
        ref = mpx_mstamp(T, config=mpx.MatrixProfileConfig(dtype=dtype, **kw))
        np.testing.assert_array_equal(ours.PMP, one.PMP)
        assert_multiprofile_close(ours, ref.PMP.astype(np.float64), ref.PMPI, EPS[dtype])


@pytest.mark.parametrize("num_shards", [2, 3])
def test_sharded_fleet_equals_single_runs(num_shards):
    batch = np.cumsum(np.random.default_rng(29).standard_normal((5, 300)), axis=1)
    cfg = MatrixProfileConfig(m=16, band=64, chunk=128, num_shards=num_shards, device="cpu")
    MP, MPI = compute_batch_profiles(batch, config=cfg, group=4)
    ref = mpx.compute_batch_profiles(batch, config=mpx.MatrixProfileConfig(
        m=16, band=64, chunk=128, num_shards=num_shards))
    for b in range(5):
        one = _np(compute_matrix_profile(batch[b], config=MatrixProfileConfig(
            m=16, band=64, chunk=128, device="cpu")))
        np.testing.assert_array_equal(MP[b], one[0])
        np.testing.assert_array_equal(MPI[b], one[1])
        assert_profile_close(batch[b], 16, MP[b], MPI[b], ref[0][b], ref[1][b], 2e-3)
