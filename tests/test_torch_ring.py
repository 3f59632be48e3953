"""The ring over sharded inputs in mpx_torch (``mpx_torch.parallel.ring``,
on the CPU's virtual shards) against mpx's ring on its virtual CPU devices
and the golden, on the same inputs: the one-pass float32 ring within 2e-3
and the float64 ring hybrid within 1e-8, indices equal or equidistant;
even and odd shard counts, a ragged tail, unequal band and chunk, the
hybrid's capture-overflow and capture-budget routes, the entry point's routes
and a series whose nearest neighbours sit just past the exclusion zone
across the shards' seams.
"""

import numpy as np
import pytest

import mpx
from mpx.parallel.ring import run_ring_hybrid_f64 as mpx_ring_hybrid
from mpx.parallel.ring import run_ring_sharded as mpx_ring
from mpx.reference import compute_matrix_profile_reference
from mpx_torch import MatrixProfileConfig, compute_matrix_profile
from mpx_torch.kernels import mxu, mxu_fused
from mpx_torch.parallel import ring
from mpx_torch.utils.profile import BenchmarkProfile
from tests.conftest import random_walk
from tests.helpers import assert_profile_close


def _ring(T, m, **kw):
    return [o.numpy() for o in ring.run_ring_sharded(T, m, device="cpu", **kw)]


def _hybrid(T, m, **kw):
    return [o.numpy() for o in ring.run_ring_hybrid_f64(T, m, device="cpu", **kw)]


def _check(T, m, got, eps, mpx_out=None):
    MP, MPI = got
    assert MP.shape == MPI.shape == (T.shape[0] - m + 1,)
    assert_profile_close(T, m, MP, MPI, *compute_matrix_profile_reference(T, m), eps=eps)
    if mpx_out is not None:
        assert_profile_close(T, m, MP, MPI, *(np.asarray(x) for x in mpx_out), eps=eps)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_ring_matches_mpx_and_golden_even(shards):
    T, m = random_walk(3000, seed=51), 32
    kw = dict(num_shards=shards, band=128, chunk=128)
    _check(T, m, _ring(T, m, **kw), 2e-3, mpx_ring(T, m, **kw))


@pytest.mark.parametrize("shards", [3, 5])
def test_ring_matches_mpx_and_golden_odd(shards):
    """Odd rings have no antipodal step: every device sweeps every step."""
    T, m = random_walk(1700, seed=52), 16
    kw = dict(num_shards=shards, band=64, chunk=64)
    _check(T, m, _ring(T, m, **kw), 2e-3, mpx_ring(T, m, **kw))


def test_ring_ragged_tail():
    """w not divisible by shards * band: the padded tail stays inert."""
    T, m = random_walk(1234, seed=53), 16
    _check(T, m, _ring(T, m, num_shards=4, band=64, chunk=64), 2e-3)


def test_ring_unequal_band_chunk():
    """W > S: the rectangle-tiled diagonal grid."""
    T, m = random_walk(3000, seed=55), 32
    kw = dict(num_shards=4, band=64, chunk=256)
    _check(T, m, _ring(T, m, **kw), 2e-3, mpx_ring(T, m, **kw))


def test_ring_rejects_f64():
    with pytest.raises(NotImplementedError):
        ring.run_ring_sharded(random_walk(600, seed=54), 16, num_shards=2, dtype="float64",
                              device="cpu")


def test_ring_plain_kernel_and_launch_counts():
    """``kernel='mxu'`` and the default both sweep with the plain version
    on CPU tensors (K1 launches nothing), one call a job."""
    T, m = random_walk(900, seed=60), 16
    before = (mxu.CALLS, mxu_fused.LAUNCHES)
    a = _ring(T, m, num_shards=3, band=64, chunk=64)
    b = _ring(T, m, num_shards=3, band=64, chunk=64, kernel="mxu")
    assert mxu_fused.LAUNCHES == before[1] and mxu.CALLS > before[0]
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("shards", [2, 3, 4, 8])
def test_ring_seam_exclusion_zone(shards):
    """A smooth series: each window's nearest neighbour is the first one
    past the exclusion zone, which for the windows beside a seam lies in
    the next shard (the pair straddles the seam) and the next one inside
    the zone must stay masked there."""
    n, m = 1100, 32
    t = np.arange(n)
    T = np.sin(2 * np.pi * t / 300.0) + 0.01 * random_walk(n, seed=62)
    kw = dict(num_shards=shards, band=64, chunk=64)
    MP, MPI = _ring(T, m, **kw)
    _check(T, m, (MP, MPI), 2e-3, mpx_ring(T, m, **kw))
    assert (np.abs(MPI - np.arange(MP.shape[0])) >= m // 4).all()
    sw = ring._shard_layout(n - m + 1, shards, 64, 64)
    seam = np.arange(1, shards) * sw
    seam = seam[seam < MP.shape[0]]
    near = np.concatenate([np.arange(s - m // 4, s) for s in seam])
    assert (MPI[near] >= seam.repeat(m // 4)).any()  # some nearest pairs cross


@pytest.mark.parametrize("shards", [1, 3, 4, 8])
def test_ring_hybrid_f64_exact(shards):
    T, m = random_walk(2500, seed=56), 24
    kw = dict(num_shards=shards, band=64, chunk=128)
    _check(T, m, _hybrid(T, m, **kw), 1e-8, mpx_ring_hybrid(T, m, **kw))


def test_ring_hybrid_f64_overflow_fallback():
    """A flag budget of 2 sends (nearly) every sparse pass-B job to the
    dense sweep; the result stays exact."""
    T, m = random_walk(1500, seed=58), 16
    prof = BenchmarkProfile()
    got = _hybrid(T, m, num_shards=2, band=64, chunk=64, suspect_f=2, profile=prof)
    assert prof.counts["pass_b"] == "sparse" and prof.counts["dense_jobs"] > 0
    _check(T, m, got, 1e-8,
           mpx_ring_hybrid(T, m, num_shards=2, band=64, chunk=64, suspect_f=2))


@pytest.mark.parametrize("shards", [1, 4])
def test_ring_hybrid_f64_capture_budget(monkeypatch, shards):
    """RING_CAPTURE_BUDGET = 0 (captures that would not fit the device):
    pass B sweeps every job densely, exact all the same."""
    monkeypatch.setattr(ring, "RING_CAPTURE_BUDGET", 0)
    T, m = random_walk(1800, seed=59), 24
    prof = BenchmarkProfile()
    got = _hybrid(T, m, num_shards=shards, band=64, chunk=128, profile=prof)
    assert prof.counts["pass_b"] == "dense"
    assert prof.counts["dense_jobs"] == prof.counts["jobs"] > 0
    _check(T, m, got, 1e-8)


def test_ring_hybrid_sharded_pass_c():
    """Twelve noisy repeats of a motif give overflowing suspect counts: the
    sharded pass C resolves them over the column shards, and the profile
    stays exact."""
    rng = np.random.default_rng(70)
    motif = np.cumsum(rng.standard_normal(40))
    T = random_walk(2000, seed=71)
    for at in range(100, 1900, 150):
        T[at : at + 40] = motif + T[at] + 1e-2 * rng.standard_normal(40)
    m = 32
    prof = BenchmarkProfile()
    got = _hybrid(T, m, num_shards=3, band=64, chunk=64, profile=prof)
    assert prof.counts["pass_c_rows"] > 0
    _check(T, m, got, 1e-8)


def test_ring_driver_routes():
    """float64 + ring runs the ring hybrid; float32 the one-pass ring; both
    honoured with num_shards 1 or unset (a one-device ring)."""
    T, m = random_walk(1800, seed=57), 16
    ref = compute_matrix_profile_reference(T, m)
    for ns in (4, 1, None):
        for dtype, eps in (("float64", 1e-8), ("float32", 2e-3)):
            prof = BenchmarkProfile()
            cfg = MatrixProfileConfig(m=m, dtype=dtype, band=64, chunk=64, num_shards=ns,
                                      shard_mode="ring", device="cpu")
            MP, MPI = (o.numpy() for o in compute_matrix_profile(T, config=cfg,
                                                                   profile=prof))
            assert MP.dtype == np.dtype(dtype)
            assert_profile_close(T, m, MP, MPI, *ref, eps=eps)
            assert any("ring" in k for k in prof.category_totals())


def test_ring_f32_auto_takes_the_one_pass_ring(monkeypatch):
    """mpx sends float32 rings with w >= HYBRID32_MIN_W to its ring hybrid
    (its one-pass f32 tile was slower on the TPU); the port's ``auto``
    keeps float32 on the one-pass ring through K1 (its split-TF32 tile is
    the fast route on the card) and casts nothing: the hybrid runs only
    for float64 or ``kernel='hybrid'``.  With mpx's threshold lowered both
    stay within the float32 tolerance of the golden."""
    import mpx.kernels as mpx_kernels

    monkeypatch.setattr(mpx_kernels, "HYBRID32_MIN_W", 256)
    T, m = random_walk(1024, seed=5), 16
    kw = dict(m=m, dtype="float32", shard_mode="ring", num_shards=2, band=64, chunk=128,
              tile_rows=8, tile_cols=64)
    calls = mxu.CALLS
    prof = BenchmarkProfile()
    MP, MPI = (o.numpy() for o in compute_matrix_profile(
        T, config=MatrixProfileConfig(device="cpu", **kw), profile=prof))
    assert mxu.CALLS > calls and "pass_b" not in prof.counts
    ref = mpx.compute_matrix_profile(T, config=mpx.MatrixProfileConfig(**kw))
    assert_profile_close(T, m, MP, MPI, *(np.asarray(x) for x in ref), eps=2e-3)
    hy = MatrixProfileConfig(device="cpu", kernel="hybrid", **kw)
    MPh, _ = compute_matrix_profile(T, config=hy, profile=prof)
    assert prof.counts["pass_b"] == "sparse" and MPh.dtype.is_floating_point
    assert np.abs(MPh.numpy().astype(np.float64)
                  - compute_matrix_profile_reference(T, m)[0]).max() < 1e-6


def test_ring_refuses_what_mpx_refuses():
    from mpx_torch.ops.precompute import precompute_statistics

    T, m = random_walk(600, seed=3), 16
    cfg = MatrixProfileConfig(m=m, band=64, chunk=64, shard_mode="ring", device="cpu")
    with pytest.raises(ValueError, match="left-right"):
        compute_matrix_profile(T, config=cfg, left_right=True)
    stats = precompute_statistics(T, m, band=64, chunk=64, device="cpu")
    with pytest.raises(ValueError, match="restages statistics"):
        compute_matrix_profile(T, config=cfg, stats=stats)
    with pytest.raises(ValueError, match="operand panels"):
        ring._check_budget(1 << 40, 256)
    with pytest.raises(ValueError, match="windows matmuls"):
        ring.run_ring_sharded(T, m, num_shards=2, kernel="xla", device="cpu")
