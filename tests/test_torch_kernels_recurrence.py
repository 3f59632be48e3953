"""The recurrence tier of mpx_torch (plain ``sweep_band_xla`` and the K3
wrapper ``sweep_band_recurrence``, which takes the plain version on the CPU)
against mpx, on identical statistics.

Both packages get mpx's staged statistics, carried over with
``stats_from_numpy``.  Tolerances on the aggregate values:

* float64, against mpx's ``sweep_band_xla`` under x64: 1e-12 (the same
  recurrence; the seeds sum m products in another order).
* float32, against mpx's Pallas kernel in interpret mode: 1e-4, the bound
  mpx's own tests hold that kernel to against its XLA sweep.  The seed is
  mpx's own here, so the comparison is of the recurrence, masks and
  aggregates: the two packages' float32 seeds differ by a few ulps, and
  the recurrence carries that difference down the band, amplified by
  the inverse norms of near-constant windows (see
  ``test_f32_recurrence_is_near_exact_with_its_own_seed``).

An index may differ only where the two candidates' correlations tie
within the tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpx.dtypes import x64_scope
from mpx.kernels import band_geometry as mpx_geometry
from mpx.kernels.common import seed_qt as mpx_seed_qt
from mpx.kernels.pallas_tpu import sweep_band_pallas as mpx_pallas
from mpx.kernels.xla import sweep_band_xla as mpx_xla
from mpx.ops.precompute import precompute_statistics as mpx_precompute
from mpx.ops.precompute import sliding_dot_product as mpx_sdp
from mpx_torch.kernels import MXU_MAX_M, get_sweep_fn, recurrence, resolve_kernel, xla
from mpx_torch.kernels.common import band_geometry, seed_qt
from mpx_torch.ops.precompute import (
    precompute_statistics,
    sliding_dot_product,
    stats_from_numpy,
)
from tests.conftest import random_walk

TOL = {"float32": 1e-4, "float64": 1e-12}
N, M, S, W = 2048, 64, 256, 512
W_PROFILE = N - M + 1
# (r0, k0): first band; a band straddling the exclusion zone that holds the
# constant run; rows hanging past w-1; columns hanging past w-1.
EDGE_JOBS = [(0, 0), (768, 0), (1792, 0), (1280, 512)]
KERNELS = ["xla", "pallas"]


@pytest.fixture(scope="module")
def series():
    T = random_walk(N, seed=7)
    T[700:900] = T[700]  # zero-variance windows
    return T


def _both_stats(T, dtype):
    with x64_scope(dtype == "float64"):
        s = mpx_precompute(T, M, band=S, chunk=W, dtype=dtype, backend="numpy",
                           windows=True)
    arrays = {f: np.asarray(getattr(s, f)) for f in s._fields}
    ours = stats_from_numpy(arrays, dtype, "cpu", windows=False)
    assert ours.windows is None
    return s, ours, arrays["windows"].astype(np.float64)


def _host(out):
    return type(out)(*(type(a)(np.asarray(a.value), np.asarray(a.index)) for a in out))


def _assert_band_close(ours, ref, U64, r0, k0, tol):
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


@pytest.mark.parametrize("r0,k0", EDGE_JOBS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_f64_recurrence_matches_mpx_xla(series, r0, k0, kernel):
    s_mpx, s_ours, U64 = _both_stats(series, "float64")
    ours = get_sweep_fn(kernel)(s_ours, r0, k0, band_geometry(S, W, M, W_PROFILE),
                                "float64")
    assert ours.row.value.dtype == torch.float64
    with x64_scope():
        ref = _host(mpx_xla(s_mpx, jnp.int32(r0), jnp.int32(k0),
                            mpx_geometry(S, W, M, W_PROFILE), jnp.float64))
    _assert_band_close(ours, ref, U64, r0, k0, TOL["float64"])


@pytest.mark.parametrize("r0,k0", EDGE_JOBS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_f32_recurrence_matches_mpx_pallas_interpret(series, r0, k0, kernel,
                                                     monkeypatch):
    s_mpx, s_ours, U64 = _both_stats(series, "float32")

    def mpx_seed(stats, r0, c0, W, m):
        seed = mpx_seed_qt(s_mpx, jnp.int32(r0), jnp.int32(c0), W, m)
        return torch.tensor(np.asarray(seed), dtype=torch.float32)

    monkeypatch.setattr(xla, "seed_qt", mpx_seed)
    ours = get_sweep_fn(kernel)(s_ours, r0, k0, band_geometry(S, W, M, W_PROFILE),
                                "float32")
    ref = mpx_pallas(s_mpx, jnp.int32(r0), jnp.int32(k0),
                     mpx_geometry(S, W, M, W_PROFILE, 8, 128), jnp.float32,
                     interpret=True)
    _assert_band_close(ours, ref, U64, r0, k0, TOL["float32"])


@pytest.mark.parametrize("r0,k0", EDGE_JOBS)
def test_f32_recurrence_is_near_exact_with_its_own_seed(series, r0, k0):
    """With its own float32 seed the port's recurrence stays within 1e-4 of
    the same recurrence in float64 on the float32-rounded statistics."""
    _, s32, U64 = _both_stats(series, "float32")
    s64 = s32._replace(**{f: getattr(s32, f).double()
                          for f in ("T", "mu", "df", "dg", "inv", "qt0")})
    geom = band_geometry(S, W, M, W_PROFILE)
    ours = xla.sweep_band_xla(s32, r0, k0, geom, "float32")
    exact = xla.sweep_band_xla(s64, r0, k0, geom, "float64")
    # In float32, as the -1e12 sentinel is.
    exact = type(exact)(*(type(a)(a.value.float(), a.index) for a in exact))
    _assert_band_close(ours, exact, U64, r0, k0, TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_seed_and_sliding_dot_product_match_mpx(series, dtype):
    """Relative to the seeds' magnitude: 1e-12 (f64), 2e-6 (f32, ~sqrt(m)
    ulps of sums of m products in another order)."""
    rel = {"float64": 1e-12, "float32": 2e-6}[dtype]
    s_mpx, s_ours, _ = _both_stats(series, dtype)
    with x64_scope(dtype == "float64"):
        q, T = s_mpx.T[100 : 100 + M], s_mpx.T[:1500]
        sdp_ref = np.asarray(mpx_sdp(q, T), np.float64)
        seeds_ref = [np.asarray(mpx_seed_qt(s_mpx, jnp.int32(r0), jnp.int32(r0 + k0),
                                            W, M), np.float64) for r0, k0 in EDGE_JOBS]
    sdp = sliding_dot_product(s_ours.T[100 : 100 + M], s_ours.T[:1500]).double().numpy()
    np.testing.assert_allclose(sdp, sdp_ref, rtol=0, atol=rel * np.abs(sdp_ref).max())
    for (r0, k0), ref in zip(EDGE_JOBS, seeds_ref):
        got = seed_qt(s_ours, r0, r0 + k0, W, M)
        assert got.shape == (W,) and got.dtype == s_ours.T.dtype
        np.testing.assert_allclose(got.double().numpy(), ref, rtol=0,
                                   atol=rel * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("r0,k0", [(0, 0), (8192, 0), (4096, 4096)])
def test_f64_recurrence_exact_on_a_drifting_series(r0, k0):
    """On a long series far from zero the float64 recurrence, on the port's
    own statistics, keeps every row maximum within 1e-10 of the exact
    correlation (what 1e-8 on distances needs at m = 64 for d >= 0.64).
    It needs the running window mean: with the prefix-sum mean
    (``mean='cumsum'``) this job's rows drift by ~1e-9."""
    n, m, S, W = 16384, 64, 1024, 4096
    T = random_walk(n, seed=1) + 1e3
    w = n - m + 1
    stats = precompute_statistics(T, m, band=S, chunk=W, dtype="float64",
                                  device="cpu", windows=False)
    got = xla.sweep_band_xla(stats, r0, k0, band_geometry(S, W, m, w),
                             "float64").row.value.numpy()
    wv = np.lib.stride_tricks.sliding_window_view(T, m)
    Z = wv - wv.mean(axis=1, keepdims=True)
    Z /= np.linalg.norm(Z, axis=1, keepdims=True)
    lanes = np.arange(W)
    worst = 0.0
    for i in range(S):
        cols = r0 + k0 + i + lanes
        ok = (cols <= w - 1) & (k0 + lanes >= m // 4) & (r0 + i <= w - 1)
        if ok.any():
            worst = max(worst, abs(got[i] - (Z[cols[ok]] @ Z[r0 + i]).max()))
    assert worst <= 1e-10


def test_recurrence_wrapper_takes_plain_version_on_cpu(series):
    _, stats, _ = _both_stats(series, "float64")
    geom = band_geometry(S, W, M, W_PROFILE)
    calls, launches = xla.CALLS, recurrence.LAUNCHES
    a = recurrence.sweep_band_recurrence(stats, 256, 512, geom, "float64")
    b = xla.sweep_band_xla(stats, 256, 512, geom, "float64")
    assert xla.CALLS == calls + 2 and recurrence.LAUNCHES == launches
    for side in ("row", "col"):
        assert torch.equal(getattr(a, side).value, getattr(b, side).value)
        assert torch.equal(getattr(a, side).index, getattr(b, side).index)


def test_recurrence_masking_rules(series):
    """Masked pairs never win: zero-variance windows, the exclusion zone and
    out-of-range rows/columns keep the -1e12 / -1 sentinels; the last
    column of the rhombus is never touched."""
    _, stats, _ = _both_stats(series, "float64")
    geom = band_geometry(S, W, M, W_PROFILE)
    out = xla.sweep_band_xla(stats, 1792, 0, geom, "float64")
    rows = 1792 + np.arange(S)
    idx = out.row.index.numpy()
    no_partner = rows > W_PROFILE - 1 - M // 4
    assert (idx[no_partner] == -1).all()
    assert (out.row.value.numpy()[no_partner] == -1e12).all()
    live, live_rows = idx[~no_partner], rows[~no_partner]
    assert ((live - live_rows >= M // 4) & (live <= W_PROFILE - 1)).all()
    flat = np.nonzero(~np.isfinite(stats.inv.numpy()))[0]
    assert flat.size > 0
    out = xla.sweep_band_xla(stats, 512, 0, geom, "float64")
    cols = 512 + np.arange(S + W)
    assert not np.isin(out.col.index.numpy(), flat).any()
    assert (out.col.value.numpy()[np.isin(cols, flat)] == -1e12).all()
    assert out.col.value[-1] == -1e12 and out.col.index[-1] == -1


def test_resolve_kernel_for_large_m():
    for dev in ("cuda", torch.device("cuda:0")):
        assert resolve_kernel("auto", dev, "float64", MXU_MAX_M + 1) == "pallas"
        assert resolve_kernel("auto", dev, "float64", MXU_MAX_M) == "mxu_fused"
        assert resolve_kernel("auto", dev, "float32", 8192) == "mxu_fused"
    assert resolve_kernel("auto", "cpu", torch.float64, 8192) == "xla"
    assert resolve_kernel("auto", "cpu", "float64", 256) == "mxu"
    assert resolve_kernel("auto", "cpu", "float32", 8192) == "mxu"
    assert resolve_kernel("pallas", "cpu", "float32", 16) == "pallas"
    assert get_sweep_fn("pallas") is recurrence.sweep_band_recurrence
    assert get_sweep_fn("xla") is xla.sweep_band_xla
