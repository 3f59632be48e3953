"""The hybrid tier of mpx_torch (``kernel='hybrid'``, CPU) against mpx and
the golden oracles.

On the CPU the port's pass A is the plain float32 sweep and passes B and C
are float32 products, like mpx's on the CPU; the exact stages are float64.
Every call to mpx's hybrid runs with ``MPX_HYBRID_CASCADE=0``, mpx's
default.  Tolerances: profiles 1e-8 (float64) / 2e-3 (float32) with the
tie rule (tests/helpers.py); 5e-8 against the brute-force oracle on the
smooth and repeated-motif series, where ``sqrt(2m(1 - P))`` amplifies
float64 cancellation (mpx's own bound, tests/test_hybrid_sparse.py);
exact stages 1e-12 against mpx's numpy path; thresholds 1e-5 (the two
packages' float32 products sum in other orders).
"""

import os

import numpy as np
import pytest
import torch

import mpx
import mpx.hybrid as mpx_hybrid
from mpx.reference import brute_force_matrix_profile, compute_matrix_profile_reference
from mpx_torch import MatrixProfileConfig, compute_matrix_profile, hybrid, matrix_profile
from mpx_torch.cli import main as port_main
from mpx_torch.config import make_job_grid
from mpx_torch.io.tsb import read_binary, read_series
from mpx_torch.kernels import mxu, mxu_fused
from mpx_torch.ops.precompute import precompute_statistics_numpy
from mpx_torch.utils.profile import BenchmarkProfile
from tests.conftest import DATA_DIR, random_walk
from tests.helpers import assert_profile_close
from tests.test_torch_split_tf32 import split_tf32_product

SHAPES = [(256, 16, 32, 64), (1024, 16, 128, 256), (1024, 128, 256, 256)]
EPS = {"float64": 1e-8, "float32": 2e-3}


@pytest.fixture(autouse=True)
def _mpx_default_pass_a(monkeypatch):
    monkeypatch.setenv("MPX_HYBRID_CASCADE", "0")


def _hybrid(T, m, band, chunk, dtype="float64"):
    """The port's hybrid on the CPU: (MP, MPI) as numpy and the profile's
    counts."""
    prof = BenchmarkProfile()
    cfg = MatrixProfileConfig(m=m, dtype=dtype, kernel="hybrid", band=band, chunk=chunk,
                              device="cpu")
    MP, MPI = compute_matrix_profile(T, config=cfg, profile=prof)
    return MP.numpy(), MPI.numpy(), prof.counts


def _repeated_motif(repeats: int, seed: int, motif_len: int = 24, noise: float = 1e-3):
    rng = np.random.default_rng(seed)
    motif = np.sin(np.linspace(0, 2 * np.pi, motif_len))
    T = rng.standard_normal(motif_len * repeats) * noise
    for r in range(repeats):
        T[r * motif_len : (r + 1) * motif_len] += motif
    return T


def _assert_brute(T, m, MP, MPI, eps=5e-8):
    """Against the brute-force oracle: degenerate windows (inf there) are
    unmatched sentinels here; elsewhere distances within eps and indices
    equidistant."""
    MP_exp, MPI_exp = brute_force_matrix_profile(T, m)
    fin = np.isfinite(MP_exp)
    MP_exp = np.where(fin, MP_exp, np.sqrt(2.0 * m * (1 + 1e12)))
    assert_profile_close(T, m, MP, MPI, MP_exp, np.where(fin, MPI_exp, -1), eps=eps)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n,m,band,chunk", SHAPES)
def test_hybrid_matches_golden(n, m, band, chunk, dtype):
    T = random_walk(n, seed=11)
    MP, MPI, counts = _hybrid(T, m, band, chunk, dtype)
    assert MP.dtype == np.dtype(dtype) and MPI.dtype == np.int32
    MP_exp, MPI_exp = compute_matrix_profile_reference(T, m)
    assert_profile_close(T, m, MP, MPI, MP_exp, MPI_exp, eps=EPS[dtype])
    assert counts["jobs"] == len(make_job_grid(n - m + 1, band, chunk).r0)


def test_hybrid_matches_mpx_hybrid():
    n, m, band, chunk = SHAPES[1]
    T = random_walk(n, seed=11)
    MP, MPI, _ = _hybrid(T, m, band, chunk)
    cfg = mpx.MatrixProfileConfig(m=m, dtype="float64", kernel="hybrid", band=band,
                                  chunk=chunk, tile_rows=8, tile_cols=64)
    MP_ref, MPI_ref = mpx_hybrid.compute_matrix_profile_f64_hybrid(T, cfg)
    assert_profile_close(T, m, MP, MPI, MP_ref, MPI_ref, eps=1e-8)


@pytest.mark.parametrize("case", ["pass_c", "row_scan", "constant", "plateau"])
def test_hybrid_escalations_match_brute_force(case):
    """The tie-heavy motif (12 exact repeats: more than the 8 capture
    slots, pass C), 80 repeats (more than pass C's 64: the exact row
    scan), a constant
    stretch (zero-variance windows: unmatched) and a smooth near-periodic
    series (plateau runs), each path counted as taken."""
    if case == "pass_c":
        rng = np.random.default_rng(7)
        T = rng.standard_normal(12 * 96) * 0.01
        for off in range(0, 12 * 96, 96):
            T[off : off + 32] += np.sin(np.linspace(0, 4 * np.pi, 32))
        m, band, chunk, path = 16, 64, 128, "pass_c_rows"
    elif case == "row_scan":
        T, m, band, chunk, path = _repeated_motif(80, 13), 16, 64, 128, "row_scan_rows"
    elif case == "constant":
        T = random_walk(300, seed=5)
        T[100:180] = 2.5
        m, band, chunk, path = 16, 32, 64, None
    else:
        t = np.arange(1024)
        T = np.sin(2 * np.pi * t / 700) + 1e-4 * np.cos(2 * np.pi * t / 97)
        m, band, chunk, path = 32, 64, 128, "plateau_rows"
    MP, MPI, counts = _hybrid(T, m, band, chunk)
    _assert_brute(T, m, MP, MPI)
    if path is not None:
        assert counts[path] > 0, counts
    else:
        assert (MPI == -1).sum() == 80 - m + 1  # the windows inside the stretch


def test_hybrid_near_constant_level_matches_strict():
    """A plateau with fine detail on it: windows whose spread is small
    beside their level.  The hybrid's float32 windows are the rounding of
    the exact unit windows, so the margin holds there too; the profile
    equals the strict float64 sweep's."""
    t = np.arange(1024.0)
    T = 1000 + np.tanh((t - 512) / 80) + 1e-3 * np.sin(t / 11)
    for m in (16, 32):
        MP, MPI, _ = _hybrid(T, m, 64, 128)
        MPs, MPIs = matrix_profile(T, m, dtype="float64", kernel="mxu", band=64,
                                   chunk=128, device="cpu")
        assert_profile_close(T, m, MP, MPI, MPs, MPIs, eps=1e-8)


def _suspects(T, m, band, chunk, sparse: bool):
    from mpx_torch.hybrid import (
        hybrid_statistics,
        run_max_jobs,
        run_suspect_jobs,
        run_suspect_jobs_sparse,
    )

    w = T.shape[0] - m + 1
    stats, _ = hybrid_statistics(T, m, band=band, chunk=chunk, device="cpu")
    grid = make_job_grid(w, band, chunk)
    kw = dict(S=band, W=chunk, m=m, w=w)
    margin = hybrid.default_margin(m)
    pw = stats.mu.shape[0]
    thr, cap = run_max_jobs(stats, grid.r0, grid.k0, margin, pw=pw, **kw)
    if sparse:
        return run_suspect_jobs_sparse(stats, thr, cap, **kw)
    return run_suspect_jobs(stats, thr, grid.r0, grid.k0, **kw)


@pytest.mark.parametrize("n,m,band,chunk,budget", [
    (512, 16, 64, 128, None), (1024, 32, 128, 256, None), (512, 16, 64, 128, 2)])
def test_sparse_suspects_match_dense(monkeypatch, n, m, band, chunk, budget):
    """The sparse pass B captures exactly the dense sweep's suspect sets;
    a budget of 2 sends every job with flags to the dense re-sweep."""
    if budget is not None:
        monkeypatch.setattr(hybrid, "_sparse_budget", lambda S, W: budget)
    T = random_walk(n, seed=5 if budget is None else 9)
    dense = _suspects(T, m, band, chunk, sparse=False)
    sparse = _suspects(T, m, band, chunk, sparse=True)
    assert int(dense.cnt.sum()) > 0
    for field in ("cnt", "mn", "mx"):
        np.testing.assert_array_equal(getattr(sparse, field).numpy(),
                                      getattr(dense, field).numpy(), err_msg=field)


def test_thresholds_match_mpx_run_max_jobs():
    import jax.numpy as jnp

    from mpx.ops.precompute import precompute_statistics as mpx_precompute

    n, m, band, chunk = SHAPES[1]
    T = random_walk(n, seed=11)
    w = n - m + 1
    grid = make_job_grid(w, band, chunk)
    margin = hybrid.default_margin(m)
    s = mpx_precompute(T, m, band=band, chunk=chunk, dtype="float32", windows=True)
    ref = mpx_hybrid.run_max_jobs(s, jnp.asarray(grid.r0), jnp.asarray(grid.k0),
                                  jnp.float32(margin), S=band, W=chunk, m=m, w=w, tr=8,
                                  tc=64, pw=s.mu.shape[0])
    stats, _ = hybrid.hybrid_statistics(T, m, band=band, chunk=chunk, device="cpu")
    ours, _ = hybrid.run_max_jobs(stats, grid.r0, grid.k0, margin, S=band, W=chunk, m=m,
                                  w=w, pw=stats.mu.shape[0])
    ref = np.asarray(ref)[:w]
    ours = ours.numpy()[:w]
    assert np.isfinite(ours).all() and (np.isinf(ours) == np.isinf(ref)).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def _exact_operands(T, m):
    s = precompute_statistics_numpy(T, m)
    return s["mu"], s["inv"], tuple(torch.from_numpy(np.asarray(a, np.float64))
                                    for a in (T, s["mu"], s["inv"]))


def test_rescore_pairs_matches_mpx_numpy(monkeypatch):
    from mpx import native

    monkeypatch.setattr(native, "is_available", lambda: False)
    T = random_walk(1500, seed=3)
    T[400:480] = T[400]  # zero-variance windows
    m = 32
    w = T.shape[0] - m + 1
    mu, inv, (Tt, mut, invt) = _exact_operands(T, m)
    rng = np.random.default_rng(0)
    rows = rng.integers(0, w, 5000).astype(np.int32)
    cols = rng.integers(-3, w, 5000).astype(np.int32)
    ref = mpx_hybrid._rescore_pairs(T, mu, inv, m, rows, cols)
    ours = hybrid._rescore_pairs(Tt, mut, invt, m, torch.from_numpy(rows),
                                 torch.from_numpy(cols)).numpy()
    assert (ours == -1e12).sum() == (ref == -1e12).sum() > 0
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)


def test_row_scan_matches_mpx_numpy(monkeypatch):
    from mpx import native

    monkeypatch.setattr(native, "is_available", lambda: False)
    T = random_walk(1200, seed=4)
    T[500:560] = T[500]
    m = 24
    w = T.shape[0] - m + 1
    mu, inv, (Tt, mut, invt) = _exact_operands(T, m)
    rows = np.array([0, 1, 7, 480, 500, 510, 600, w // 2, w - 2, w - 1], np.int32)
    refP, refI = mpx_hybrid._row_scan(T, mu, inv, m, w, m // 4, rows)
    P, I = hybrid._row_scan(Tt, mut, invt, m, w, m // 4, torch.from_numpy(rows))
    np.testing.assert_array_equal(I.numpy(), refI)
    np.testing.assert_allclose(P.numpy(), refP, rtol=0, atol=1e-12)
    assert (refI == -1).any() and (refI >= 0).any()


@pytest.mark.parametrize("m", [4, 16, 256, 4096])
def test_default_margin_is_mpxs(m):
    assert hybrid.default_margin(m) == mpx_hybrid.default_margin(m)


@pytest.mark.parametrize("m", [16, 64, 256])
def test_split_tf32_pass_a_within_quarter_margin(m):
    """K1's float32 arithmetic (split TF32, emulated) on the hybrid's
    float32 windows, against the exact float64 product, every pair of a
    band of a random walk: within a quarter of the margin (mpx's
    calibration rule)."""
    T = random_walk(4096 + m, seed=21) + 300.0  # a level well above the spread
    stats, exact = hybrid.hybrid_statistics(T, m, band=256, chunk=1024, device="cpu")
    from mpx_torch.ops.precompute import build_windows

    U64 = build_windows(exact, m).numpy()
    U32 = stats.windows.numpy()
    rows, cols = slice(1000, 1256), slice(1500, 2524)
    err = np.abs(split_tf32_product(U32[rows], U32[cols]) - U64[rows] @ U64[cols].T).max()
    assert err <= hybrid.default_margin(m) / 4, err


def test_pass_a_is_k1s_plain_sweep_on_cpu():
    """On CPU tensors pass A takes K1's plain version, once per job, and
    launches nothing."""
    n, m, band, chunk = SHAPES[1]
    T = random_walk(n, seed=2)
    jobs = len(make_job_grid(n - m + 1, band, chunk).r0)
    calls, launches = mxu.CALLS, mxu_fused.LAUNCHES
    _hybrid(T, m, band, chunk)
    assert mxu.CALLS - calls == jobs and mxu_fused.LAUNCHES == launches


def test_driver_matrix_profile_and_cli(tmp_path):
    n, m, band, chunk = SHAPES[1]
    T = random_walk(n, seed=11)
    MP_exp, MPI_exp = compute_matrix_profile_reference(T, m)
    for dtype in ("float64", "float32"):
        MP, MPI = matrix_profile(T, m, dtype=dtype, kernel="hybrid", band=band,
                                 chunk=chunk, device="cpu")
        assert isinstance(MP, np.ndarray) and MP.dtype == np.dtype(dtype)
        assert_profile_close(T, m, MP, MPI, MP_exp, MPI_exp, eps=EPS[dtype])
    inp = os.path.join(DATA_DIR, "binary", "1024.tsb")
    out = str(tmp_path / "ours")
    assert port_main(["compute", "-i", inp, "-m", "16", "--dtype", "float64",
                      "--kernel", "hybrid", "--band", "256", "--chunk", "512",
                      "--device", "cpu", "-o", out]) == 0
    T = read_series(inp)
    MP_exp, MPI_exp = compute_matrix_profile_reference(T, 16)
    assert_profile_close(T, 16, read_binary(out + ".mpb", "double"),
                         read_binary(out + ".mpib", "int"), MP_exp, MPI_exp, eps=1e-8)


def test_unsupported_hybrid_modes_raise():
    """``stats=`` is refused; ``left_right=True``, once refused, now runs
    and gives mpx's left/right hybrid profiles."""
    from mpx_torch.ops.precompute import precompute_statistics

    T = random_walk(300, seed=1)
    cfg = MatrixProfileConfig(m=16, dtype="float64", kernel="hybrid", band=64, chunk=64,
                              device="cpu")
    ours = [o.numpy() for o in compute_matrix_profile(T, config=cfg, left_right=True)]
    ref = mpx_hybrid.compute_left_right_f64_hybrid(T, mpx.MatrixProfileConfig(
        m=16, dtype="float64", kernel="hybrid", band=64, chunk=64, tile_rows=8,
        tile_cols=64))
    for side in (0, 2):
        assert_profile_close(T, 16, ours[side], ours[side + 1], ref[side], ref[side + 1],
                             eps=1e-8)
    stats = precompute_statistics(T, 16, band=64, chunk=64, dtype="float64", device="cpu")
    with pytest.raises(ValueError, match="stats"):
        compute_matrix_profile(T, config=cfg, stats=stats)


@pytest.mark.parametrize("dim", [0, 1])
def test_suspect_reduce_matches_mpx(dim):
    """The port's capture (a running count of the hits, then the first and
    last K) against mpx's K-round min/max capture, on rows with no hit,
    fewer than K, between K and 2K, and many."""
    import jax.numpy as jnp

    from mpx.kernels.mxu import _suspect_reduce
    from mpx_torch.kernels.mxu import suspect_reduce

    rng = np.random.default_rng(dim)
    R, C = 64, 300
    p = np.repeat([0.0, 0.005, 0.02, 0.3, 0.9], [4, 12, 16, 16, 16])[:, None]
    hit = rng.random((R, C)) < p
    hit[:, -1] |= rng.random(R) < 0.3  # hits on the last position too
    idx = np.arange(1000, 1000 + C, dtype=np.int32)
    hit_d = hit if dim == 1 else hit.T
    idx_b = idx[None, :] if dim == 1 else idx[:, None]
    ref = _suspect_reduce(jnp.asarray(hit_d), jnp.asarray(np.broadcast_to(idx_b, hit_d.shape)),
                          axis=dim)
    ours = suspect_reduce(torch.from_numpy(hit_d), torch.from_numpy(idx), dim)
    for field in ("cnt", "mn", "mx"):
        np.testing.assert_array_equal(getattr(ours, field).numpy(),
                                      np.asarray(getattr(ref, field)), err_msg=field)
