"""K3's arithmetic and summation order, emulated on the CPU, against mpx.

On the card K3 (``mpx_torch/csrc/band_recurrence.cu``) cuts a job's S rows
into segments of ``SEGMENT_ROWS`` rows and sweeps them in parallel.  It
never reseeds a segment: along each diagonal QT is a prefix sum of the
update terms ``U(i, j) = df_r[i] dg_c[i+j] + df_c[i+j] dg_r[i]``, so

* a first kernel sums each segment's update terms in row order (band row 0
  takes none: it is the seed alone);
* segment g starts from ``seed + sum_0 + ... + sum_{g-1}``, added in that
  order, and adds its own rows' terms one by one.

It computes in float64 for float32 statistics too and rounds only the
aggregates.  This file emulates exactly that order in numpy
(:func:`k3_order_sweep`) and holds it to mpx, as the card-only tests hold
the kernel to the plain version:

* float64: within 1e-12 of mpx's ``sweep_band_xla`` under x64;
* float32: within 1e-4 of mpx's Pallas kernel in interpret mode, with
  mpx's float32 seed;
* profiles of ``data/test/16384.txt`` within 1e-8 (f64) / 2e-3 (f32) of
  mpx's, indices equal or equidistant;
* with one segment the emulation is the plain ``sweep_band_xla`` bit for
  bit.

On products of float32 values the emulation's float64 ``a*b + c*d`` is the
kernel's ``fma(a, b, c*d)`` exactly (both products are exact in float64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpx
from mpx.dtypes import x64_scope
from mpx.kernels import band_geometry as mpx_geometry
from mpx.kernels.common import seed_qt as mpx_seed_qt
from mpx.kernels.pallas_tpu import sweep_band_pallas as mpx_pallas
from mpx.kernels.xla import sweep_band_xla as mpx_xla
from mpx.ops.precompute import precompute_statistics as mpx_precompute
from mpx_torch import MatrixProfileConfig, compute_matrix_profile, driver
from mpx_torch.dtypes import AGGREGATE_INIT, torch_dtype
from mpx_torch.kernels import xla
from mpx_torch.kernels.common import BandOut, band_geometry, seed_qt
from mpx_torch.kernels.recurrence import SEGMENT_ROWS
from mpx_torch.ops.precompute import precompute_statistics, stats_from_numpy
from mpx_torch.types import Aggregates
from tests.conftest import random_walk
from tests.helpers import assert_profile_close
from tests.test_torch_cuda import (K3_EXACT_TOL, PLAIN_EXACT_TOL, assert_near_exact,
                                   exact_band)
from tests.test_torch_driver import DATASETS, _load

TOL = {"float32": 1e-4, "float64": 1e-12}
# Three segments of SEGMENT_ROWS, the last ragged (256 + 256 + 184 rows);
# seven of 100 rows, the last 96.
N, M, S, W = 4096, 64, 696, 512
W_PROFILE = N - M + 1
SEGMENTS = [SEGMENT_ROWS, 100]
# (r0, k0): first band; the exclusion zone over the constant run; rows
# hanging past w-1; columns hanging past w-1.
EDGE_JOBS = [(0, 0), (1392, 0), (3480, 0), (2784, 512)]


def k3_order_qt(df_r, dg_r, df_c, dg_c, seed, S, W, R):
    """QT (S, W) in float64, summed in K3's order with segments of R rows."""
    cols = np.lib.stride_tricks.sliding_window_view
    U = df_r[:, None] * cols(dg_c, W)[:S] + cols(df_c, W)[:S] * dg_r[:, None]
    U[0] = 0.0  # band row 0 is the seed alone
    QT = np.empty((S, W))
    carry = seed.copy()
    for g0 in range(0, S, R):
        q = carry.copy()
        for i in range(g0, min(g0 + R, S)):
            q = q + U[i]
            QT[i] = q
        seg = np.zeros(W)
        for i in range(g0, min(g0 + R, S)):
            seg = seg + U[i]
        carry = carry + seg
    return QT


def k3_order_sweep(stats, r0, k0, geom, dtype, R=SEGMENT_ROWS, seed=None):
    """The band sweep with K3's arithmetic and order; ``seed`` (W,)
    replaces the float64 seed the wrapper computes."""
    S, W, m, w, excl = geom.S, geom.W, geom.m, geom.w, geom.excl
    r0, k0 = int(r0), int(k0)
    c0 = r0 + k0
    dt = torch_dtype(dtype)
    f64 = lambda x: x.double().numpy()  # noqa: E731
    df_r, dg_r, inv_r = (f64(x[r0 : r0 + S]) for x in (stats.df, stats.dg, stats.inv))
    df_c, dg_c, inv_c = (f64(x[c0 : c0 + S + W]) for x in (stats.df, stats.dg, stats.inv))
    if seed is None:
        seed = seed_qt(stats, r0, c0, W, m, torch.float64)
    QT = k3_order_qt(df_r, dg_r, df_c, dg_c, f64(seed), S, W, R)

    t = np.arange(S)[:, None] + np.arange(W)[None, :]  # column of pair (i, j)
    with np.errstate(invalid="ignore", over="ignore"):
        P = QT * inv_r[:, None] * inv_c[t]
    ok = ((k0 + np.arange(W) >= excl)[None, :]
          & ((r0 + np.arange(S) <= w - 1) & np.isfinite(inv_r))[:, None]
          & ((c0 + t <= w - 1) & np.isfinite(inv_c[t])) & (P == P))
    P = np.where(ok, P, AGGREGATE_INIT)
    dt_np = torch.empty((), dtype=dt).numpy().dtype
    init = np.asarray(AGGREGATE_INIT, dt_np)

    def aggregate(Pm, axis, base):
        arg = Pm.argmax(axis=axis)  # first occurrence: the smaller index
        v = Pm.max(axis=axis).astype(dt_np)
        idx = np.where(v > init, base + arg, -1).astype(np.int32)
        return Aggregates(torch.from_numpy(v), torch.from_numpy(idx))

    C = np.full((S, S + W), AGGREGATE_INIT)  # column-aligned: C[i, t] = P[i, t - i]
    C[np.arange(S)[:, None], t] = P
    return BandOut(row=aggregate(P, 1, c0 + np.arange(S)), col=aggregate(C, 0, r0))


@pytest.fixture(scope="module")
def series():
    T = random_walk(N, seed=7)
    T[1500:1700] = T[1500]  # zero-variance windows
    return T


def _both_stats(T, dtype):
    with x64_scope(dtype == "float64"):
        s = mpx_precompute(T, M, band=S, chunk=W, dtype=dtype, backend="numpy",
                           windows=True)
    arrays = {f: np.asarray(getattr(s, f)) for f in s._fields}
    return s, stats_from_numpy(arrays, dtype, "cpu", windows=False), \
        arrays["windows"].astype(np.float64)


def _assert_band_close(ours, ref, U64, r0, k0, tol):
    """Values within tol; an index may differ only between candidates whose
    exact correlations tie within tol."""
    for side, base, size in (("row", r0, S), ("col", r0 + k0, S + W)):
        ov = getattr(ours, side).value.double().numpy()
        oi = getattr(ours, side).index.numpy()
        rv = np.asarray(getattr(ref, side).value, np.float64).reshape(-1)
        ri = np.asarray(getattr(ref, side).index).reshape(-1)
        assert ov.shape == rv.shape == (size,) and oi.dtype == np.int32
        np.testing.assert_allclose(ov, rv, rtol=0, atol=tol, err_msg=side)
        for k in np.nonzero(oi != ri)[0]:
            assert oi[k] >= 0 and ri[k] >= 0, f"{side} {k}: masked vs unmasked"
            own = U64[base + k]
            assert abs(own @ U64[oi[k]] - own @ U64[ri[k]]) <= tol, (
                f"{side} {k}: index {oi[k]} vs {ri[k]} is not a tie")
    assert (ours.row.index.numpy() >= 0).any()


def test_emulation_segments_and_carries():
    """The order itself on a tiny case: segment sums in row order, carries
    in segment order, band row 0 the seed alone, every later row its own
    term (the first row of a segment included)."""
    rng = np.random.default_rng(0)
    S_, W_, R = 7, 3, 3
    df_r, dg_r = rng.standard_normal(S_), rng.standard_normal(S_)
    df_c, dg_c = rng.standard_normal(S_ + W_), rng.standard_normal(S_ + W_)
    seed = rng.standard_normal(W_)
    QT = k3_order_qt(df_r, dg_r, df_c, dg_c, seed, S_, W_, R)
    u = lambda i, j: df_r[i] * dg_c[i + j] + df_c[i + j] * dg_r[i]  # noqa: E731
    for j in range(W_):
        seg = [(0.0 + u(1, j)) + u(2, j), ((0.0 + u(3, j)) + u(4, j)) + u(5, j)]
        assert QT[0, j] == seed[j]
        assert QT[3, j] == (seed[j] + seg[0]) + u(3, j)
        assert QT[6, j] == ((seed[j] + seg[0]) + seg[1]) + u(6, j)
    assert -(-S // SEGMENT_ROWS) == 3 and S % SEGMENT_ROWS


@pytest.mark.parametrize("R", SEGMENTS)
@pytest.mark.parametrize("r0,k0", EDGE_JOBS)
def test_f64_segment_order_matches_mpx_xla(series, r0, k0, R):
    s_mpx, s_ours, U64 = _both_stats(series, "float64")
    ours = k3_order_sweep(s_ours, r0, k0, band_geometry(S, W, M, W_PROFILE), "float64", R)
    with x64_scope():
        ref = mpx_xla(s_mpx, jnp.int32(r0), jnp.int32(k0),
                      mpx_geometry(S, W, M, W_PROFILE), jnp.float64)
        ref = type(ref)(*(type(a)(np.asarray(a.value), np.asarray(a.index)) for a in ref))
    _assert_band_close(ours, ref, U64, r0, k0, TOL["float64"])


@pytest.mark.parametrize("R", SEGMENTS)
@pytest.mark.parametrize("r0,k0", EDGE_JOBS)
def test_f32_segment_order_matches_mpx_pallas_interpret(series, r0, k0, R):
    s_mpx, s_ours, U64 = _both_stats(series, "float32")
    seed = torch.tensor(np.asarray(mpx_seed_qt(s_mpx, jnp.int32(r0), jnp.int32(r0 + k0),
                                               W, M)), dtype=torch.float32)
    ours = k3_order_sweep(s_ours, r0, k0, band_geometry(S, W, M, W_PROFILE), "float32",
                          R, seed=seed)
    ref = mpx_pallas(s_mpx, jnp.int32(r0), jnp.int32(k0),
                     mpx_geometry(S, W, M, W_PROFILE, 8, 128), jnp.float32,
                     interpret=True)
    _assert_band_close(ours, ref, U64, r0, k0, TOL["float32"])


@pytest.mark.parametrize("r0,k0", EDGE_JOBS)
def test_one_segment_is_the_plain_version_bit_for_bit(series, r0, k0):
    _, stats, _ = _both_stats(series, "float64")
    geom = band_geometry(S, W, M, W_PROFILE)
    ours = k3_order_sweep(stats, r0, k0, geom, "float64", R=S)
    ref = xla.sweep_band_xla(stats, r0, k0, geom, "float64")
    for side in ("row", "col"):
        assert torch.equal(getattr(ours, side).value, getattr(ref, side).value), side
        assert torch.equal(getattr(ours, side).index, getattr(ref, side).index), side


@pytest.fixture(scope="module")
def near_constant():
    """A job grid beside a constant run (m = 37, 1000 x 700 jobs), where the
    near-constant windows' large inverse norms amplify the recurrence's
    rounding."""
    m, band, chunk = 37, 1000, 700
    n = 4 * band + chunk + m
    w = n - m + 1
    T = random_walk(n, seed=7)
    T[n // 3 : n // 3 + 400] = T[n // 3]
    jobs = [(0, 0), (n // 3 - band // 2, 0), (w - band // 2, 0),
            (w - chunk - band // 2, chunk)]
    stats = {dt: precompute_statistics(T, m, band=band, chunk=chunk, dtype=dt,
                                       device="cpu", windows=False)
             for dt in ("float32", "float64")}
    return stats, band_geometry(band, chunk, m, w), jobs


def _worst(a, b) -> float:
    return max((getattr(a, side).value.double() - getattr(b, side).value.double())
               .abs().max().item() for side in ("row", "col"))


def test_orders_agree_beside_near_constant_windows(near_constant):
    """There the segment order and the plain sequential order of the same
    float64 terms agree to 1e-10 (each is within 1e-11 of the exact
    recurrence: test_segment_order_near_exact_beside_constant_run)."""
    stats, geom, jobs = near_constant
    worst = max(_worst(k3_order_sweep(stats["float64"], r0, k0, geom, "float64"),
                       xla.sweep_band_xla(stats["float64"], r0, k0, geom, "float64"))
                for r0, k0 in jobs)
    assert worst < 1e-10


def test_f32_statistics_in_float64_arithmetic(near_constant):
    """K3's float64 arithmetic on float32 statistics is within 1e-6 of the
    plain recurrence in float64 on the same statistics."""
    stats, geom, jobs = near_constant
    s32 = stats["float32"]
    s64 = s32._replace(**{f: getattr(s32, f).double() for f in ("T", "mu", "df", "dg", "inv")})
    ours = 0.0
    for r0, k0 in jobs:
        exact = xla.sweep_band_xla(s64, r0, k0, geom, "float64")
        exact = type(exact)(*(type(a)(a.value.float(), a.index) for a in exact))
        ours = max(ours, _worst(k3_order_sweep(s32, r0, k0, geom, "float32"), exact))
    assert ours < 1e-6


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("job", range(4))
def test_segment_order_near_exact_beside_constant_run(near_constant, dtype, job):
    """K3's order (float64 arithmetic for both dtypes) and the plain
    version in the statistics' dtype, each against the exact recurrence of
    the same statistics, at the card-only test's bounds.  Prints the
    largest differences (the CPU readings in PERF.md)."""
    stats, geom, jobs = near_constant
    r0, k0 = jobs[job]
    exact = exact_band(stats[dtype], r0, k0, geom)
    ours = assert_near_exact(k3_order_sweep(stats[dtype], r0, k0, geom, dtype), exact,
                             r0, k0, K3_EXACT_TOL[dtype])
    plain = assert_near_exact(xla.sweep_band_xla(stats[dtype], r0, k0, geom, dtype), exact,
                              r0, k0, PLAIN_EXACT_TOL[dtype])
    print(f"\nK3 order readings {dtype} job ({r0}, {k0}): K3's order vs exact {ours:.3e}, "
          f"plain vs exact {plain:.3e}")


@pytest.mark.parametrize("r0,k0", EDGE_JOBS)
def test_exact_band_matches_mpx_xla(series, r0, k0):
    """The exact recurrence against mpx's float64 sweep under x64, on the
    module's series: mpx is one rounding of it."""
    s_mpx, s_ours, _ = _both_stats(series, "float64")
    with x64_scope():
        ref = mpx_xla(s_mpx, jnp.int32(r0), jnp.int32(k0),
                      mpx_geometry(S, W, M, W_PROFILE), jnp.float64)
        ref = BandOut(*(Aggregates(torch.from_numpy(np.array(a.value)),
                                   torch.from_numpy(np.array(a.index))) for a in ref))
    exact = exact_band(s_ours, r0, k0, band_geometry(S, W, M, W_PROFILE))
    assert_near_exact(ref, exact, r0, k0, PLAIN_EXACT_TOL["float64"])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_segment_order_profile_matches_mpx(monkeypatch, dtype):
    path, limit, m, band, chunk = DATASETS[1]  # data/test/16384.txt: 4 segments a band
    T = _load(path, limit)
    monkeypatch.setattr(driver, "get_sweep_fn", lambda kernel: k3_order_sweep)
    cfg = MatrixProfileConfig(m=m, dtype=dtype, kernel="xla", band=band, chunk=chunk,
                              device="cpu")
    MP, MPI = (o.numpy() for o in compute_matrix_profile(T, config=cfg))
    ref_cfg = mpx.MatrixProfileConfig(m=m, dtype=dtype, kernel="mxu", band=band, chunk=chunk)
    MP_ref, MPI_ref = (np.asarray(x) for x in mpx.compute_matrix_profile(T, config=ref_cfg))
    assert_profile_close(T, m, MP, MPI, MP_ref, MPI_ref,
                         eps={"float32": 2e-3, "float64": 1e-8}[dtype])
