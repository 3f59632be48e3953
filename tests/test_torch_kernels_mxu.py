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
from mpx_torch.kernels import get_sweep_fn, mxu, mxu_fused, resolve_kernel
from mpx_torch.kernels.common import band_geometry
from mpx_torch.ops.precompute import stats_from_numpy
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
    calls, launches = mxu.CALLS, mxu_fused.LAUNCHES
    a = mxu_fused.sweep_band_mxu_fused(stats, 256, 512, geom, "float32")
    b = mxu.sweep_band_mxu(stats, 256, 512, geom, "float32")
    assert mxu.CALLS == calls + 2 and mxu_fused.LAUNCHES == launches
    for side in ("row", "col"):
        assert torch.equal(getattr(a, side).value, getattr(b, side).value)
        assert torch.equal(getattr(a, side).index, getattr(b, side).index)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sweep_rejects_mismatched_dtype(series, dtype):
    _, stats, _ = _both_stats(series, dtype)
    other = "float64" if dtype == "float32" else "float32"
    with pytest.raises(ValueError):
        mxu.sweep_band_mxu(stats, 0, 0, band_geometry(S, W, M, W_PROFILE), other)


def test_resolve_kernel():
    for dev in ("cpu", torch.device("cpu")):
        assert resolve_kernel("auto", dev) == "mxu"
    for dev in ("cuda", "cuda:0", torch.device("cuda")):
        assert resolve_kernel("auto", dev) == "mxu_fused"
    assert resolve_kernel("mxu", "cuda") == "mxu"
    assert resolve_kernel("mxu_fused", "cpu") == "mxu_fused"
    with pytest.raises(ValueError):
        get_sweep_fn("hybrid")

