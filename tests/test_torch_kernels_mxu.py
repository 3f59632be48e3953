"""Band sweeps of mpx_torch against mpx, on identical statistics.

Both packages get the same staged statistics (mpx's, carried over with
``stats_from_numpy``).  Tolerances on the aggregate values: 1e-5 for
float32 (sums of m products in another order than mpx's Pallas kernel,
run in interpret mode as mpx's own tests run it), 1e-12 for float64
(against mpx's XLA sweep under x64).  An index may differ only where
the two candidates' correlations tie within that tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpx.dtypes import x64_scope
from mpx.kernels import band_geometry as mpx_geometry
from mpx.kernels.mxu import sweep_band_mxu as mpx_sweep
from mpx.kernels.mxu_fused import sweep_band_mxu_fused as mpx_fused
from mpx.ops.precompute import precompute_statistics as mpx_precompute
from mpx_torch.kernels import (K3_MIN_M_F64, MXU_MAX_M, get_sweep_fn, mxu, mxu_fused,
                               resolve_kernel)
from mpx_torch.kernels.common import band_geometry
from mpx_torch.ops.precompute import stats_from_numpy
from mpx_torch.utils.profile import counters
from tests.conftest import random_walk

TOL = {"float32": 1e-5, "float64": 1e-12}
N, M, S, W = 2048, 64, 256, 512
W_PROFILE = N - M + 1
# (r0, k0): first band; a band straddling the exclusion zone that holds the
# constant run; rows hanging past w-1; columns hanging past w-1.
EDGE_JOBS = [(0, 0), (768, 0), (1792, 0), (1280, 512)]


@pytest.fixture(scope="module")
def series():
    T = random_walk(N, seed=7)
    T[700:900] = T[700]  # zero-variance windows
    return T


def _both_stats(T, dtype):
    s = mpx_precompute(T, M, band=S, chunk=W, dtype=dtype, backend="numpy",
                       windows=True)
    arrays = {f: np.asarray(getattr(s, f)) for f in s._fields}
    return s, stats_from_numpy(arrays, dtype, "cpu"), arrays["windows"].astype(np.float64)


def _assert_band_close(ours, ref, U64, r0, k0, tol):
    for side, base in (("row", r0), ("col", r0 + k0)):
        ov = getattr(ours, side).value.double().numpy()
        oi = getattr(ours, side).index.numpy()
        rv = np.asarray(getattr(ref, side).value, np.float64).reshape(-1)
        ri = np.asarray(getattr(ref, side).index).reshape(-1)
        assert ov.shape == rv.shape and oi.dtype == np.int32
        np.testing.assert_allclose(ov, rv, rtol=0, atol=tol, err_msg=side)
        for k in np.nonzero(oi != ri)[0]:
            assert oi[k] >= 0 and ri[k] >= 0, f"{side} {k}: masked vs unmasked"
            own = U64[base + k]
            assert abs(own @ U64[oi[k]] - own @ U64[ri[k]]) <= tol, (
                f"{side} {k}: index {oi[k]} vs {ri[k]} is not a tie")
    assert (ours.row.index.numpy() >= 0).any()


@pytest.mark.parametrize("r0,k0", EDGE_JOBS)
@pytest.mark.parametrize("fn", ["mxu", "mxu_fused"])
def test_f32_sweeps_match_mpx_fused_interpret(series, r0, k0, fn):
    s_mpx, s_ours, U64 = _both_stats(series, "float32")
    geom = band_geometry(S, W, M, W_PROFILE)
    ours = get_sweep_fn(fn)(s_ours, r0, k0, geom, "float32")
    ref = mpx_fused(s_mpx, jnp.int32(r0), jnp.int32(k0),
                    mpx_geometry(S, W, M, W_PROFILE, 8, 128), jnp.float32,
                    interpret=True)
    _assert_band_close(ours, ref, U64, r0, k0, TOL["float32"])


@pytest.mark.parametrize("r0,k0", EDGE_JOBS)
@pytest.mark.parametrize("fn", ["mxu", "mxu_fused"])
def test_f64_sweeps_match_mpx_mxu(series, r0, k0, fn):
    s_mpx, s_ours, U64 = _both_stats(series, "float64")
    geom = band_geometry(S, W, M, W_PROFILE)
    ours = get_sweep_fn(fn)(s_ours, r0, k0, geom, "float64")
    assert ours.row.value.dtype == torch.float64
    with x64_scope():
        ref = mpx_sweep(s_mpx, jnp.int32(r0), jnp.int32(k0),
                        mpx_geometry(S, W, M, W_PROFILE), jnp.float64)
        ref = type(ref)(*(type(a)(np.asarray(a.value), np.asarray(a.index))
                          for a in ref))
    _assert_band_close(ours, ref, U64, r0, k0, TOL["float64"])


def test_masking_rules(series):
    """Masked pairs never win: zero-variance windows, the exclusion zone
    and out-of-range rows/columns keep the -1e12 / -1 sentinels."""
    _, stats, _ = _both_stats(series, "float64")
    out = mxu.sweep_band_mxu(stats, 1792, 0, band_geometry(S, W, M, W_PROFILE),
                             "float64")
    rows = 1792 + np.arange(S)
    dead = rows > W_PROFILE - 1
    assert (out.row.value.numpy()[dead] == -1e12).all()
    assert (out.row.index.numpy()[dead] == -1).all()
    idx = out.row.index.numpy()
    no_partner = rows > W_PROFILE - 1 - M // 4  # every column in the zone or past w-1
    assert (idx[no_partner] == -1).all()
    live, live_rows = idx[~no_partner], rows[~no_partner]
    assert ((live - live_rows >= M // 4) & (live <= W_PROFILE - 1)).all()
    inv = stats.inv.numpy()
    flat = np.nonzero(~np.isfinite(inv))[0]
    assert flat.size > 0
    out = mxu.sweep_band_mxu(stats, 512, 0, band_geometry(S, W, M, W_PROFILE),
                             "float64")
    col_idx = out.col.index.numpy()
    assert not np.isin(col_idx, flat).any()
    assert (out.col.value.numpy()[np.isin(512 + np.arange(W), flat)] == -1e12).all()


def test_fused_wrapper_takes_plain_version_on_cpu(series):
    _, stats, _ = _both_stats(series, "float32")
    geom = band_geometry(S, W, M, W_PROFILE)
    calls, launches = counters()["calls.mxu"], counters()["launches.k1"]
    a = mxu_fused.sweep_band_mxu_fused(stats, 256, 512, geom, "float32")
    b = mxu.sweep_band_mxu(stats, 256, 512, geom, "float32")
    assert counters()["calls.mxu"] == calls + 2 and counters()["launches.k1"] == launches
    for side in ("row", "col"):
        assert torch.equal(getattr(a, side).value, getattr(b, side).value)
        assert torch.equal(getattr(a, side).index, getattr(b, side).index)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sweep_rejects_mismatched_dtype(series, dtype):
    _, stats, _ = _both_stats(series, dtype)
    other = "float64" if dtype == "float32" else "float32"
    with pytest.raises(ValueError):
        mxu.sweep_band_mxu(stats, 0, 0, band_geometry(S, W, M, W_PROFILE), other)


# (kernel, device, dtype, m, expected).  resolve_kernel reads only the
# device's type, so every route is checked without a card.
ROUTES = [
    # No dtype given: the device alone decides.
    *[("auto", dev, None, 0, "mxu") for dev in ("cpu", torch.device("cpu"))],
    *[("auto", dev, None, 0, "mxu_fused") for dev in ("cuda", "cuda:0", torch.device("cuda"))],
    # float64 on a card: K1 below the measured crossover, K3 from it up.
    *[("auto", "cuda", "float64", m, "mxu_fused") for m in (8, 16, 32, 64, K3_MIN_M_F64 - 1)],
    *[("auto", "cuda", "float64", m, "pallas")
      for m in (K3_MIN_M_F64, 256, 512, 1024, 2048, MXU_MAX_M, MXU_MAX_M + 1)],
    ("auto", torch.device("cuda:0"), torch.float64, 256, "pallas"),
    # float32 on a card: K1 at every m.
    *[("auto", "cuda", "float32", m, "mxu_fused")
      for m in (8, 64, K3_MIN_M_F64, 256, MXU_MAX_M, MXU_MAX_M + 1)],
    # The CPU: the plain sweep, the plain recurrence for float64 past MXU_MAX_M.
    *[("auto", "cpu", "float64", m, "mxu") for m in (8, K3_MIN_M_F64, 256, MXU_MAX_M)],
    ("auto", "cpu", "float64", MXU_MAX_M + 1, "xla"),
    ("auto", "cpu", "float32", MXU_MAX_M + 1, "mxu"),
    # Named kernels pass through whatever the device, dtype and m.
    ("mxu", "cuda", None, 0, "mxu"),
    ("mxu_fused", "cpu", None, 0, "mxu_fused"),
    ("mxu_fused", "cuda", "float64", 256, "mxu_fused"),
    ("mxu", "cuda", "float64", 256, "mxu"),
    ("xla", "cuda", "float64", 256, "xla"),
    ("pallas", "cuda", "float32", 64, "pallas"),
    ("hybrid", "cuda", "float64", 256, "hybrid"),
]


@pytest.mark.parametrize("kernel,device,dtype,m,expected", ROUTES,
                         ids=[f"{k}-{d}-{t}-{m}" for k, d, t, m, _ in ROUTES])
def test_resolve_kernel(kernel, device, dtype, m, expected):
    assert resolve_kernel(kernel, device, dtype, m) == expected


def test_hybrid_has_no_sweep_fn():
    with pytest.raises(ValueError):
        get_sweep_fn("hybrid")

