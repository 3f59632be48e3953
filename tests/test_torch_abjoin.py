"""The AB-join of mpx_torch (``mpx_torch.abjoin``, on the CPU) against
mpx and the numpy oracles: the plain sweep with a column operand job by
job, the strict tiers end to end, the hybrid, and its escalations.

Every call to mpx's hybrid runs with ``MPX_HYBRID_CASCADE=0``, mpx's
default.  Tolerances: distances 1e-8 (float64) / 2e-3 (float32), an
index differing only between neighbors equidistant within that (the
repo's rule, tests/helpers.py, here across two series); band values 1e-12
in float64; the exact stages 1e-12 against mpx's numpy path; the dense
and the sparse pass B exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpx
import mpx.hybrid as mpx_hybrid
from mpx.abjoin import brute_force_ab_join as mpx_brute
from mpx.abjoin import compute_ab_join as mpx_ab_join
from mpx.dtypes import x64_scope
from mpx.kernels import band_geometry as mpx_geometry
from mpx.kernels.mxu import sweep_band_mxu as mpx_sweep
from mpx.ops.precompute import precompute_statistics as mpx_precompute
from mpx_torch import MatrixProfileConfig, hybrid
from mpx_torch.abjoin import ab_jobs, brute_force_ab_join, compute_ab_join, unit_windows
from mpx_torch.config import make_job_grid
from mpx_torch.kernels import mxu, mxu_fused
from mpx_torch.kernels.common import NO_EXCL, band_geometry
from mpx_torch.kernels.mxu_fused import kernel_excl
from mpx_torch.ops.precompute import (
    precompute_statistics,
    precompute_statistics_numpy,
    stats_from_numpy,
)
from mpx_torch.utils.profile import BenchmarkProfile, counters
from tests.conftest import random_walk

EPS = {"float32": 2e-3, "float64": 1e-8}
# The shapes of mpx's own AB-join tests (tests/test_abjoin.py).
SHAPES = [(512, 300, 16, "float64"), (300, 512, 32, "float64"), (1024, 1024, 64, "float32")]
SENTINEL = lambda m: np.sqrt(2.0 * m * (1 + 1e12))  # noqa: E731


@pytest.fixture(autouse=True)
def _mpx_default_pass_a(monkeypatch):
    monkeypatch.setenv("MPX_HYBRID_CASCADE", "0")


def _with_constant_runs(na, nb, seed=1):
    A, B = random_walk(na, seed=seed), random_walk(nb, seed=seed + 1)
    A[na // 3 : na // 3 + 60] = A[na // 3]  # zero-variance windows in each series
    B[nb // 2 : nb // 2 + 50] = 2.5
    return A, B


def _motifs(repeats: int, seed: int, noise: float = 1e-3) -> np.ndarray:
    """``repeats`` copies of one 24-sample sine period under ``noise``."""
    rng = np.random.default_rng(seed)
    return (np.tile(np.sin(np.linspace(0, 2 * np.pi, 24)), repeats)
            + rng.standard_normal(24 * repeats) * noise)


def _ours(A, B, m, dtype, kernel="auto", band=128, chunk=128, profile=None, **kw):
    cfg = MatrixProfileConfig(m=m, dtype=dtype, kernel=kernel, band=band, chunk=chunk,
                              device="cpu", **kw)
    out = compute_ab_join(A, B, config=cfg, profile=profile)
    assert all(o.device.type == "cpu" for o in out)
    return [o.numpy() for o in out]


def _mpx(A, B, m, dtype, kernel, band=128, chunk=128, **kw):
    cfg = mpx.MatrixProfileConfig(m=m, dtype=dtype, kernel=kernel, band=band, chunk=chunk,
                                  tile_rows=8, tile_cols=8, **kw)
    return [np.asarray(o) for o in mpx_ab_join(A, B, config=cfg)]


def _pair_dist(Zq, Zt, i, j, m):
    return np.sqrt(max(2.0 * m * (1.0 - Zq[i] @ Zt[j]), 0.0))


def assert_ab_close(A, B, m, ours, ref, eps):
    """Both sides within eps; an index may differ only where the two
    candidates are equidistant within eps (exact float64 windows).  A
    window without a neighbor holds the sentinel distance in the output's
    dtype and index -1."""
    Za, Zb = unit_windows(A, m), unit_windows(B, m)
    for (mp, mpi, mp_r, mpi_r), (Zq, Zt) in (((*ours[:2], *ref[:2]), (Za, Zb)),
                                             ((*ours[2:], *ref[2:]), (Zb, Za))):
        none = np.asarray(mp_r) > SENTINEL(m) / 2
        assert (mp[none] > SENTINEL(m) / 2).all() and (mpi[none] == -1).all()
        mp, mp_r = np.where(none, 0, mp), np.where(none, 0, mp_r)
        np.testing.assert_allclose(np.asarray(mp, np.float64), mp_r, rtol=0, atol=eps)
        for i in np.nonzero(mpi != mpi_r)[0]:
            assert mpi[i] >= 0 and mpi_r[i] >= 0, (i, mpi[i], mpi_r[i])
            gap = abs(_pair_dist(Zq, Zt, i, mpi[i], m) - _pair_dist(Zq, Zt, i, mpi_r[i], m))
            assert gap <= max(eps, 1e-7), (i, mpi[i], mpi_r[i], gap)


def _brute(A, B, m):
    """The port's brute force with the tiers' sentinels where a window has
    no neighbor (zero variance)."""
    mpa, mpia, mpb, mpib = brute_force_ab_join(A, B, m)
    return [np.where(np.isfinite(mpa), mpa, SENTINEL(m)), np.where(np.isfinite(mpa), mpia, -1),
            np.where(np.isfinite(mpb), mpb, SENTINEL(m)), np.where(np.isfinite(mpb), mpib, -1)]


# ---------------------------------------------------------------- the sweep


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("fn", ["mxu", "mxu_fused"])
def test_sweep_with_column_operand_matches_mpx(dtype, fn):
    """Every job of an AB-join with constant runs in both series, the
    port's sweep (the plain one; K1's wrapper takes it for CPU tensors)
    against mpx's ``sweep_band_mxu(stats_c=)`` on the same statistics."""
    A, B = _with_constant_runs(900, 700)
    m, S, W = 16, 128, 256
    wa, wb = 900 - m + 1, 700 - m + 1
    s_mpx = [mpx_precompute(X, m, band=S, chunk=W, dtype=dtype, backend="numpy", windows=True)
             for X in (A, B)]
    ours = [stats_from_numpy({f: np.asarray(getattr(s, f)) for f in s._fields}, dtype, "cpu")
            for s in s_mpx]
    geom = band_geometry(S, W, m, wa, wc=wb, excl=NO_EXCL)
    ref_geom = mpx_geometry(S, W, m, wa, wc=wb, excl=-(2**30))
    sweep = mxu.sweep_band_mxu if fn == "mxu" else mxu_fused.sweep_band_mxu_fused
    tol = 1e-5 if dtype == "float32" else 1e-12
    Za, Zb = unit_windows(A, m), unit_windows(B, m)
    with x64_scope(dtype == "float64"):
        for r0, c0 in zip(*ab_jobs(wa, wb, S, W)):
            got = sweep(ours[0], r0, c0 - r0, geom, dtype, stats_c=ours[1])
            ref = mpx_sweep(s_mpx[0], jnp.int32(r0), jnp.int32(c0 - r0), ref_geom,
                            jnp.dtype(dtype), stats_c=s_mpx[1])
            for side, base, (Zq, Zt) in (("row", r0, (Za, Zb)), ("col", c0, (Zb, Za))):
                gv, gi = (getattr(got, side).value.double().numpy(),
                          getattr(got, side).index.numpy())
                rv, ri = (np.asarray(getattr(ref, side).value, np.float64),
                          np.asarray(getattr(ref, side).index))
                np.testing.assert_allclose(gv, rv, rtol=0, atol=tol)
                for k in np.nonzero(gi != ri)[0]:
                    assert gi[k] >= 0 and ri[k] >= 0
                    q = Zq[base + k]
                    assert abs(q @ Zt[gi[k]] - q @ Zt[ri[k]]) <= tol, (side, k)


def test_sweep_masks_bounds_and_zero_variance_of_each_series():
    A, B = _with_constant_runs(900, 700)
    m, S, W = 16, 128, 256
    wa, wb = 900 - m + 1, 700 - m + 1
    sa, sb = (precompute_statistics(X, m, band=S, chunk=W, dtype="float64", device="cpu")
              for X in (A, B))
    geom = band_geometry(S, W, m, wa, wc=wb, excl=NO_EXCL)
    out = mxu.sweep_band_mxu(sa, 768, 512 - 768, geom, "float64", stats_c=sb)  # both edges
    rows, cols = 768 + np.arange(S), 512 + np.arange(W)
    ri, ci = out.row.index.numpy(), out.col.index.numpy()
    assert (ri[rows > wa - 1] == -1).all() and (ci[cols > wb - 1] == -1).all()
    assert ((ri[rows <= wa - 1] >= 512) & (ri[rows <= wa - 1] <= wb - 1)).all()
    # Rows 256.. hold A's zero-variance windows, columns 256.. B's: they
    # get no neighbor and are nobody's.
    out = mxu.sweep_band_mxu(sa, 256, 0, geom, "float64", stats_c=sb)
    flat_a = np.nonzero(~np.isfinite(sa.inv.numpy()[:wa]))[0]
    flat_b = np.nonzero(~np.isfinite(sb.inv.numpy()[:wb]))[0]
    ri, ci = out.row.index.numpy(), out.col.index.numpy()
    assert np.isin(flat_a, 256 + np.arange(S)).all() and np.isin(flat_b, 256 + np.arange(W)).all()
    assert (ri[flat_a - 256] == -1).all() and (ci[flat_b - 256] == -1).all()
    assert not np.isin(ri, flat_b).any() and not np.isin(ci, flat_a).any()


@pytest.mark.parametrize("pw", [64, 4096, 2**30, 2**30 + 1, 2**31 - 1])
def test_kernel_excl_is_int32_and_passes_every_pair(pw):
    """The exclusion bound K1 is given: the AB-join's NO_EXCL becomes -pw,
    inside int32 for every pw the wrapper accepts (up to 2**31 - 1), and
    fails no pair a job can hold (rows below pw, columns from 0), also
    past 2**30 where NO_EXCL itself would; a self-join's bound stays."""
    ke = kernel_excl(NO_EXCL, pw)
    assert ke == -pw and -(2**31) < ke <= 0
    assert kernel_excl(16, pw) == 16 and kernel_excl(0, pw) == 0
    assert kernel_excl(-2 * pw, pw) == -pw
    r = np.array([0, 1, pw // 2, pw - 1], np.int64)
    c = np.array([0, 1, pw // 2, pw - 1, 2 * pw], np.int64)
    assert (c[None, :] - r[:, None] >= ke).all()


# ---------------------------------------------------------------- end to end


@pytest.mark.parametrize("na,nb,m,dtype", SHAPES)
def test_ab_join_matches_mpx_and_brute_force(na, nb, m, dtype):
    A, B = random_walk(na, seed=1), random_walk(nb, seed=2)
    kernel = "mxu" if dtype == "float64" else "auto"
    ours = _ours(A, B, m, dtype, kernel)
    assert ours[0].dtype == np.dtype(dtype) and ours[1].dtype == np.int32
    assert ours[0].shape == (na - m + 1,) and ours[2].shape == (nb - m + 1,)
    assert_ab_close(A, B, m, ours, _mpx(A, B, m, dtype, "mxu"), EPS[dtype])
    assert_ab_close(A, B, m, ours, list(mpx_brute(A, B, m)), EPS[dtype])
    assert_ab_close(A, B, m, ours, _brute(A, B, m), EPS[dtype])


@pytest.mark.parametrize("na,nb,m", [(512, 300, 16), (300, 512, 32), (900, 700, 24)])
def test_ab_hybrid_matches_mpx_hybrid(na, nb, m):
    """The port's float64 hybrid against mpx's (mpx's float64 ``auto``) and
    the brute force, on random walks."""
    A, B = random_walk(na, seed=3), random_walk(nb, seed=4)
    prof = BenchmarkProfile()
    ours = _ours(A, B, m, "float64", "hybrid", band=64, chunk=128, profile=prof)
    assert ours[0].dtype == np.float64
    assert_ab_close(A, B, m, ours, _mpx(A, B, m, "float64", "auto", band=64, chunk=128),
                    EPS["float64"])
    assert_ab_close(A, B, m, ours, _brute(A, B, m), EPS["float64"])
    assert prof.counts["pass_b"] == "sparse"
    assert {"plateau_rows_a", "pass_c_rows_a", "row_scan_rows_b"} <= set(prof.counts)


@pytest.mark.parametrize("dtype,kernel", [("float32", "auto"), ("float64", "mxu"),
                                          ("float64", "auto"), ("float64", "hybrid")])
def test_ab_join_with_constant_runs(dtype, kernel):
    """Zero-variance windows in both series have no neighbor and are
    nobody's: against mpx's strict sweep and the brute force."""
    A, B = _with_constant_runs(900, 700, seed=5)
    m = 16
    ours = _ours(A, B, m, dtype, kernel, band=64, chunk=128)
    ref = _mpx(A, B, m, dtype, "mxu", band=64, chunk=128)
    assert_ab_close(A, B, m, ours, ref, EPS[dtype])
    brute = _brute(A, B, m)
    if dtype == "float64":
        assert_ab_close(A, B, m, ours, brute, EPS[dtype])
    else:
        # A window of a constant run and one other sample z-normalizes to
        # the same step in both series (distance 0), where sqrt(2m(1 - P))
        # turns float32's 1e-6 on P into 5e-3: held in correlation.
        for mp, mpi, mp_r, mpi_r in ((*ours[:2], *brute[:2]), (*ours[2:], *brute[2:])):
            np.testing.assert_array_equal(mpi >= 0, mpi_r >= 0)
            live = mpi_r >= 0
            P, P_r = (1 - np.asarray(d[live], np.float64) ** 2 / (2 * m) for d in (mp, mp_r))
            np.testing.assert_allclose(P, P_r, rtol=0, atol=1e-5)
    for mp, mpi, X in ((ours[0], ours[1], A), (ours[2], ours[3], B)):
        flat = ~np.isfinite(precompute_statistics_numpy(X, m)["inv"])
        assert flat.any() and (mpi[flat] == -1).all()
    fa = ~np.isfinite(precompute_statistics_numpy(A, m)["inv"])
    fb = ~np.isfinite(precompute_statistics_numpy(B, m)["inv"])
    assert not np.isin(ours[1], np.nonzero(fb)[0]).any()
    assert not np.isin(ours[3], np.nonzero(fa)[0]).any()


@pytest.mark.parametrize("kernel", ["auto", "hybrid"])
def test_ab_join_fixed_point_input(kernel):
    """``dtype='ap32'`` quantizes both series first (float64 compute), as
    mpx's AB-join does."""
    A, B = random_walk(600, seed=6), random_walk(500, seed=7)
    m = 16
    ours = _ours(A, B, m, "ap32", kernel, band=64, chunk=128)
    assert ours[0].dtype == np.float64
    assert_ab_close(A, B, m, ours, _mpx(A, B, m, "ap32", "auto", band=64, chunk=128),
                    EPS["float64"])


def test_ab_join_motif_across_series():
    """mpx's planted-pattern check: a sine burst in each series finds its
    copy in the other."""
    rng = np.random.default_rng(9)
    A, B = rng.standard_normal(600) * 0.05, rng.standard_normal(700) * 0.05
    pattern = np.sin(np.linspace(0, 5 * np.pi, 80))
    A[100:180] += pattern
    B[400:480] += pattern
    mp_a, mpi_a, mp_b, mpi_b = _ours(A, B, 80, "float64")
    i, j = int(np.argmin(mp_a)), int(np.argmin(mp_b))
    assert abs(i - 100) <= 4 and abs(int(mpi_a[i]) - 400) <= 4
    assert abs(j - 400) <= 4 and abs(int(mpi_b[j]) - 100) <= 4


def test_ab_join_counts_one_sweep_per_job():
    A, B = random_walk(700, seed=10), random_walk(500, seed=11)
    m, band, chunk = 16, 128, 256
    jobs = len(ab_jobs(700 - m + 1, 500 - m + 1, band, chunk)[0])
    calls, launches = counters()["calls.mxu"], counters()["launches.k1"]
    _ours(A, B, m, "float32", band=band, chunk=chunk)
    assert counters()["calls.mxu"] - calls == jobs and counters()["launches.k1"] == launches
    calls = counters()["calls.mxu"]
    _ours(A, B, m, "float64", "hybrid", band=band, chunk=chunk)  # pass A: one sweep a job
    assert counters()["calls.mxu"] - calls == jobs


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_recurrence_kernels_have_no_ab_form(kernel):
    with pytest.raises(ValueError, match="mxu_fused"):
        _ours(random_walk(300, 1), random_walk(300, 2), 16, "float64", kernel)


def test_float32_hybrid_request_is_the_float64_result_cast_down():
    A, B = random_walk(500, seed=12), random_walk(400, seed=13)
    f64 = _ours(A, B, 16, "float64", "hybrid", band=64, chunk=128)
    f32 = _ours(A, B, 16, "float32", "hybrid", band=64, chunk=128)
    for a, b in zip(f32, f64):
        np.testing.assert_array_equal(a, b.astype(a.dtype))


# ---------------------------------------------------------------- hybrid internals


@pytest.mark.parametrize("case", ["pass_c", "row_scan"])
def test_ab_hybrid_escalations_match_brute_force(monkeypatch, case):
    """Two series of one repeated motif: every window has ~40 near-equal
    neighbors in the other series, past the 8 capture slots.  With plateau
    runs off (RUNCAP = 0) they go to pass C against the other series; with
    PASS_C_K = 2 on to the row scan.  Both sides counted, held to the
    brute force."""
    monkeypatch.setattr(hybrid, "RUNCAP", 0)
    monkeypatch.setattr(hybrid, "PASS_C_K", 128 if case == "pass_c" else 2)
    A, B, m = _motifs(40, 13), _motifs(36, 14), 16
    prof = BenchmarkProfile()
    ours = _ours(A, B, m, "float64", "hybrid", band=64, chunk=128, profile=prof)
    assert_ab_close(A, B, m, ours, _brute(A, B, m), EPS["float64"])
    for side in ("a", "b"):
        assert prof.counts[f"plateau_rows_{side}"] == 0
        assert prof.counts[f"pass_c_rows_{side}"] > 0
        scans = prof.counts[f"row_scan_rows_{side}"]
        assert scans == 0 if case == "pass_c" else scans > 0, prof.counts


def test_ab_hybrid_plateau_runs_match_brute_force():
    A, B, m = _motifs(40, 15), _motifs(36, 16), 16
    prof = BenchmarkProfile()
    ours = _ours(A, B, m, "float64", "hybrid", band=64, chunk=128, profile=prof)
    assert_ab_close(A, B, m, ours, _brute(A, B, m), EPS["float64"])
    assert_ab_close(A, B, m, ours, _mpx(A, B, m, "float64", "mxu", band=64, chunk=128),
                    EPS["float64"])


def test_ab_hybrid_dense_route_matches_sparse(monkeypatch):
    """With SPARSE_MAX_W at or below the wider width, pass A keeps no
    captures and pass B sweeps every job densely: the same profiles."""
    A, B, m, band, chunk = random_walk(1000, seed=17), random_walk(700, seed=18), 16, 64, 128
    out, counts = {}, {}
    for route, gate in (("sparse", hybrid.SPARSE_MAX_W), ("dense", 1000 - m + 1)):
        monkeypatch.setattr(hybrid, "SPARSE_MAX_W", gate)
        prof = BenchmarkProfile()
        out[route] = _ours(A, B, m, "float64", "hybrid", band=band, chunk=chunk, profile=prof)
        counts[route] = prof.counts
    jobs = len(ab_jobs(1000 - m + 1, 700 - m + 1, band, chunk)[0])
    assert counts["dense"]["pass_b"] == "dense" and counts["dense"]["capture_bytes"] == 0
    assert counts["dense"]["dense_jobs"] == jobs
    assert counts["sparse"]["capture_bytes"] == hybrid.capture_bytes(jobs, band, chunk)
    for a, b in zip(out["sparse"], out["dense"]):
        np.testing.assert_array_equal(a, b)


def test_ab_sparse_pass_b_equals_dense_over_the_budget(monkeypatch):
    """Sparse jobs over a lowered flag budget take the dense sweep: the
    same summaries."""
    A, B, m, band, chunk = random_walk(900, seed=19), random_walk(800, seed=20), 16, 64, 128
    base = _ours(A, B, m, "float64", "hybrid", band=band, chunk=chunk)
    monkeypatch.setattr(hybrid, "_sparse_budget", lambda S, W: 2)
    prof = BenchmarkProfile()
    low = _ours(A, B, m, "float64", "hybrid", band=band, chunk=chunk, profile=prof)
    assert prof.counts["dense_jobs"] > 0
    for a, b in zip(base, low):
        np.testing.assert_array_equal(a, b)


def test_ab_thresholds_match_mpx():
    """Pass A's per-series thresholds against mpx's ``run_max_jobs`` with
    the AB geometry (float32 products in other orders: 1e-5)."""
    A, B, m, S, W = random_walk(700, seed=21), random_walk(500, seed=22), 16, 64, 128
    wa, wb = 700 - m + 1, 500 - m + 1
    r0s, c0s = ab_jobs(wa, wb, S, W)
    margin = hybrid.default_margin(m)
    sa, sb = (mpx_precompute(X, m, band=S, chunk=W, dtype="float32", windows=True)
              for X in (A, B))
    ref = mpx_hybrid.run_max_jobs(sa, jnp.asarray(r0s, jnp.int32),
                                  jnp.asarray(c0s - r0s, jnp.int32), jnp.float32(margin),
                                  S=S, W=W, m=m, w=wa, tr=8, tc=W, pw=sa.mu.shape[0], wc=wb,
                                  excl=-(2**30), pwc=sb.mu.shape[0], stats_c=sb,
                                  combine=False)
    (pa, _), (pb, _) = (hybrid.hybrid_statistics(X, m, band=S, chunk=W, device="cpu")
                        for X in (A, B))
    ours, cap = hybrid.run_max_jobs(pa, r0s, c0s - r0s, margin, S=S, W=W, m=m, w=wa,
                                    pw=pa.mu.shape[0], combine=False, stats_c=pb, wc=wb,
                                    pwc=pb.mu.shape[0], excl=NO_EXCL)
    assert cap is not None
    for got, exp, width in zip(ours, ref, (wa, wb)):
        got, exp = got.numpy(), np.asarray(exp)
        assert got.shape == exp.shape and np.isinf(got[width:]).all()
        fin = np.isfinite(exp)
        assert (np.isfinite(got) == fin).all()
        np.testing.assert_allclose(got[fin], exp[fin], rtol=0, atol=1e-5)


def _exact(X, m):
    s = precompute_statistics_numpy(X, m)
    return s, tuple(torch.from_numpy(np.asarray(a, np.float64)) for a in (X, s["mu"], s["inv"]))


def test_rescore_pairs_ab_matches_mpx_numpy(monkeypatch):
    from mpx import native

    monkeypatch.setattr(native, "is_available", lambda: False)
    A, B = _with_constant_runs(1500, 1100, seed=23)
    m = 32
    (sa, ea), (sb, eb) = _exact(A, m), _exact(B, m)
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 1500 - m + 1, 5000).astype(np.int32)
    cols = rng.integers(-3, 1100 - m + 1, 5000).astype(np.int32)
    ref = mpx_hybrid._rescore_pairs_ab(A, sa["mu"], sa["inv"], B, sb["mu"], sb["inv"], m,
                                       rows, cols)
    ours = hybrid._rescore_pairs_ab(*ea, *eb, m, torch.from_numpy(rows),
                                    torch.from_numpy(cols)).numpy()
    assert (ours == -1e12).sum() == (ref == -1e12).sum() > 0
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)


def test_row_scan_ab_matches_mpx_numpy(monkeypatch):
    """The exact AB row scan: the first maximum on a tie, -1 for a
    zero-variance query."""
    from mpx import native

    monkeypatch.setattr(native, "is_available", lambda: False)
    A, B = _with_constant_runs(1200, 900, seed=24)
    m = 24
    wa, wb = 1200 - m + 1, 900 - m + 1
    (sa, ea), (sb, eb) = _exact(A, m), _exact(B, m)
    rows = np.array([0, 1, 7, 400, 410, 600, wa // 2, wa - 2, wa - 1], np.int32)
    refP, refI = mpx_hybrid._row_scan_ab(A, sa["mu"], sa["inv"], B, sb["mu"], sb["inv"], m,
                                         wb, rows)
    P, I = hybrid._row_scan_ab(*ea, *eb, m, wb, torch.from_numpy(rows))
    np.testing.assert_array_equal(I.numpy(), refI)
    np.testing.assert_allclose(P.numpy(), refP, rtol=0, atol=1e-12)
    assert (refI == -1).any() and (refI >= 0).any()


def test_resolve_side_self_join_matches_mpx(monkeypatch):
    """``_resolve_side`` with the target the query series itself (the
    self-join's call) against mpx's ``_resolve_side`` on the same suspect
    summary and thresholds, on the tie-heavy shape (80 repeats of a
    motif), where pass C and the row scans run: the same profile."""
    from mpx import native

    monkeypatch.setattr(native, "is_available", lambda: False)
    T, m, S, W = _motifs(80, 25), 16, 64, 128
    w = T.shape[0] - m + 1
    excl = m // 4
    stats, exact = hybrid.hybrid_statistics(T, m, band=S, chunk=W, device="cpu")
    grid = make_job_grid(w, S, W)
    thr, sus = hybrid._passes(stats, grid.r0, grid.k0, hybrid.default_margin(m), S=S, W=W,
                              m=m, w=w, pw=stats.mu.shape[0], combine=True, profile=None)
    ex = (exact.T, exact.mu[:w], exact.inv[:w])
    prof = BenchmarkProfile()
    P, I = hybrid._resolve_side(sus, w, m, stats_q=stats, stats_t=stats, thr_q=thr,
                                exact_q=ex, exact_t=ex, excl=excl, wt=w, profile=prof)
    assert prof.counts["pass_c_rows"] > 0 and prof.counts["row_scan_rows"] > 0

    s64 = precompute_statistics_numpy(T, m)
    s_mpx = mpx_precompute(T, m, band=S, chunk=W, dtype="float32", windows=True)
    sus_np = mpx_hybrid.SuspectWindow(*(a.numpy() for a in sus))
    refP, refI = mpx_hybrid._resolve_side(
        sus_np, w, m,
        rescore=lambda r, c: mpx_hybrid._rescore_pairs(T, s64["mu"], s64["inv"], m, r, c),
        stats_q=s_mpx, stats_t=s_mpx, thr_q=jnp.asarray(thr.numpy()), excl=excl, wt=w,
        escalate=lambda rows: mpx_hybrid._row_scan(T, s64["mu"], s64["inv"], m, w, excl,
                                                   rows),
        profile=None)
    np.testing.assert_array_equal(I.numpy(), refI)
    np.testing.assert_allclose(P.numpy(), refP, rtol=0, atol=1e-12)
