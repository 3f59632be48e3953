"""The raw-Euclidean (AAMP) profiles of mpx_torch (``mpx_torch.aamp``, on
the CPU) against mpx's ``compute_aamp_profile`` / ``compute_aamp_ab_join``
and the numpy oracles of ``tests/test_aamp.py``.

Tolerances are mpx's: distances within 2e-4 (float32) / 1e-10 (float64)
of the largest oracle distance; an index may differ only where both
windows are equidistant within that.
"""

import numpy as np
import pytest
import torch

import mpx
from mpx.aamp import compute_aamp_ab_join as mpx_aamp_ab
from mpx.aamp import compute_aamp_profile as mpx_aamp
from mpx_torch import MatrixProfileConfig, compute_aamp_ab_join, compute_aamp_profile
from mpx_torch.aamp import aamp_mpdist
from tests.test_aamp import aamp_oracle

RTOL = {"float32": 2e-4, "float64": 1e-10}


def _cfg(m, dtype="float64", **kw):
    return MatrixProfileConfig(m=m, dtype=dtype, band=32, chunk=64, device="cpu", **kw)


def _raw(X, m, a, b, Y=None):
    wx = np.lib.stride_tricks.sliding_window_view(X, m)
    wy = wx if Y is None else np.lib.stride_tricks.sliding_window_view(Y, m)
    return np.sqrt(((wx[a] - wy[b]) ** 2).sum(axis=-1))


def assert_raw_close(T, m, D, I, eD, eI, tol, Y=None):
    """Distances within tol of the oracle's; where an index differs, the
    listed window lies at the oracle's distance within tol."""
    D, I = (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in (D, I))
    assert I.dtype == np.int32
    np.testing.assert_allclose(D, eD, rtol=0, atol=tol)
    diff = np.nonzero(I != eI)[0]
    np.testing.assert_allclose(_raw(T, m, diff, I[diff], Y), eD[diff], rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_aamp_matches_mpx_and_oracle(dtype):
    rng = np.random.default_rng(103)
    n, m = 600, 24
    T = np.cumsum(rng.standard_normal(n)) + 500.0  # offset + drift
    D, I = compute_aamp_profile(T, m, config=_cfg(m, dtype))
    assert D.dtype == (torch.float64 if dtype == "float64" else torch.float32)
    eD, eI = aamp_oracle(T, m)
    tol = RTOL[dtype] * eD.max()
    assert_raw_close(T, m, D, I, eD, eI, tol)
    rD, rI = mpx_aamp(T, m, config=mpx.MatrixProfileConfig(m=m, dtype=dtype, band=32,
                                                           chunk=64))
    assert_raw_close(T, m, D, I, np.asarray(rD, np.float64), np.asarray(rI), tol)


def test_aamp_constant_windows_are_valid():
    """The z-normalized tiers mask constant windows; the raw distance keeps
    them: two equal constant runs are each other's exact match."""
    rng = np.random.default_rng(107)
    n, m = 300, 16
    T = np.cumsum(rng.standard_normal(n))
    T[40 : 40 + m] = 7.0
    T[200 : 200 + m] = 7.0
    D, I = (x.numpy() for x in compute_aamp_profile(T, m, config=_cfg(m)))
    assert D[40] < 1e-9 and int(I[40]) == 200
    eD, eI = aamp_oracle(T, m)
    assert_raw_close(T, m, D, I, eD, eI, 1e-9)


def test_aamp_large_amplitude():
    """The -inf aggregate floor: raw scores of a large-amplitude series lie
    far below the z-normalized tiers' -1e12 sentinel, and every window
    still finds its neighbor (mpx's regression case, and a walk x 1e6 +
    1e7)."""
    rng = np.random.default_rng(127)
    n, m = 300, 16
    for T in (rng.standard_normal(n) * 1e6, np.cumsum(rng.standard_normal(n)) * 1e6 + 1e7):
        D, I = (x.numpy() for x in compute_aamp_profile(T, m, config=_cfg(m)))
        assert np.isfinite(D).all() and (I >= 0).all()
        eD, eI = aamp_oracle(T, m)
        assert_raw_close(T, m, D, I, eD, eI, 1e-10 * eD.max())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_aamp_ab_join_matches_mpx_and_brute_force(dtype):
    rng = np.random.default_rng(7)
    A = np.cumsum(rng.standard_normal(400))
    B = np.cumsum(rng.standard_normal(300))
    m = 20
    WA = np.lib.stride_tricks.sliding_window_view(A, m)
    WB = np.lib.stride_tricks.sliding_window_view(B, m)
    Dm = np.sqrt(((WA[:, None, :] - WB[None, :, :]) ** 2).sum(axis=2))
    cfg = MatrixProfileConfig(m=m, dtype=dtype, band=64, chunk=128, device="cpu")
    res = compute_aamp_ab_join(A, B, config=cfg)
    tol = RTOL[dtype] * max(Dm.min(axis=1).max(), Dm.min(axis=0).max())
    assert_raw_close(A, m, res.mp_a, res.mpi_a, Dm.min(axis=1), Dm.argmin(axis=1), tol, B)
    assert_raw_close(B, m, res.mp_b, res.mpi_b, Dm.min(axis=0), Dm.argmin(axis=0), tol, A)
    ref = mpx_aamp_ab(A, B, config=mpx.MatrixProfileConfig(m=m, dtype=dtype, band=64,
                                                           chunk=128))
    np.testing.assert_allclose(res.mp_a.numpy(), np.asarray(ref.mp_a), rtol=0, atol=tol)
    np.testing.assert_allclose(res.mp_b.numpy(), np.asarray(ref.mp_b), rtol=0, atol=tol)


def test_aamp_fixed_point_input():
    """``dtype="ap32"`` quantizes the series first (float64 compute), as
    mpx's self-join does."""
    T, m = np.cumsum(np.random.default_rng(11).standard_normal(400)), 16
    D, I = compute_aamp_profile(T, m, config=_cfg(m, "ap32"))
    rD, rI = mpx_aamp(T, m, config=mpx.MatrixProfileConfig(m=m, dtype="ap32", band=32,
                                                           chunk=64))
    from mpx_torch.io.apfixed import quantize

    Tq = quantize(T, "ap32")
    assert_raw_close(Tq, m, D, I, np.asarray(rD), np.asarray(rI), 1e-10 * float(D.max()))


def test_aamp_rejects_ignored_knobs():
    T = np.random.default_rng(131).standard_normal(200)
    with pytest.raises(ValueError, match="one kernel"):
        compute_aamp_profile(T, 16, config=_cfg(16, kernel="pallas"))
    with pytest.raises(ValueError, match="one kernel"):
        compute_aamp_ab_join(T, T, 16, config=_cfg(16, kernel="hybrid"))
    # The tier is single-device: a sharded config is refused by the tier,
    # as mpx's (aamp.py's "single-device" ValueError).
    with pytest.raises(ValueError, match="single-device"):
        compute_aamp_profile(T, 16, config=_cfg(16, num_shards=4))


def test_aamp_mpdist_is_not_ported():
    """Once refused; now mpx's raw MPdist over the port's raw AB-join,
    within mpx's float64 tolerance of the largest distance."""
    rng = np.random.default_rng(137)
    A, B = np.cumsum(rng.standard_normal(300)), np.cumsum(rng.standard_normal(260))
    for thr in (0.05, 0.2):
        got = aamp_mpdist(A, B, 16, threshold=thr, config=_cfg(16))
        exp = mpx.aamp.aamp_mpdist(A, B, 16, threshold=thr,
                                   config=mpx.MatrixProfileConfig(m=16, dtype="float64",
                                                                  band=32, chunk=64))
        scale = _raw(A, 16, np.arange(285)[:, None], np.arange(245)[None, :], B).max()
        assert abs(got - exp) <= RTOL["float64"] * scale
