"""The sum-threshold profiles of mpx_torch (``mpx_torch.thresh``, on the
CPU) against mpx's and the numpy oracles.

Tolerances: float64 counts exact and sums 1e-9; float32 counts may differ
only by the pairs whose exact correlation lies within 1e-5 of the
threshold, and sums by 1e-4 of their size plus those pairs' worth.
"""

import numpy as np
import pytest
import torch

import mpx
from mpx.thresh import brute_force_sum_thresh as mpx_brute
from mpx.thresh import brute_force_sum_thresh_ab as mpx_brute_ab
from mpx.thresh import compute_sum_thresh as mpx_thresh
from mpx.thresh import compute_sum_thresh_ab as mpx_thresh_ab
from mpx_torch import MatrixProfileConfig, compute_sum_thresh, compute_sum_thresh_ab
from mpx_torch.abjoin import unit_windows
from mpx_torch.thresh import brute_force_sum_thresh, brute_force_sum_thresh_ab
from tests.conftest import random_walk

NEAR = 1e-5


def _cfg(m, dtype, kernel="auto", band=64, chunk=128):
    return MatrixProfileConfig(m=m, dtype=dtype, kernel=kernel, band=band, chunk=chunk,
                               device="cpu")


def _mpx_cfg(m, dtype, band=64, chunk=128):
    return mpx.MatrixProfileConfig(m=m, dtype=dtype, band=band, chunk=chunk, tile_rows=8,
                                   tile_cols=chunk)


def _np(*xs):
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x) for x in xs]


def _near_counts(Zq, Zt, valid, threshold):
    """Per query window, its valid pairs whose exact correlation lies
    within NEAR of the threshold."""
    P = np.nan_to_num(Zq @ Zt.T, nan=-2.0)
    return (valid & (np.abs(P - threshold) <= NEAR)).sum(axis=1)


def assert_thresh_close(sums, cnts, ref_sums, ref_cnts, dtype, near):
    assert cnts.dtype == np.int32 and sums.dtype == np.dtype(dtype)
    sums, ref_sums = np.asarray(sums, np.float64), np.asarray(ref_sums, np.float64)
    if dtype == "float64":
        np.testing.assert_array_equal(cnts, ref_cnts)
        np.testing.assert_allclose(sums, ref_sums, rtol=0, atol=1e-9)
        return
    assert (np.abs(cnts.astype(np.int64) - ref_cnts) <= near).all()
    slack = 1e-4 * np.maximum(np.abs(ref_sums), 1.0) + near * 1.0
    assert (np.abs(sums - ref_sums) <= slack).all(), np.abs(sums - ref_sums).max()


@pytest.mark.parametrize("threshold", [0.0, 0.7])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sum_thresh_matches_mpx_and_brute_force(dtype, threshold):
    T, m = random_walk(900, seed=1), 16
    w = 900 - m + 1
    sums, cnts = _np(*compute_sum_thresh(T, config=_cfg(m, dtype), threshold=threshold))
    assert sums.shape == cnts.shape == (w,)
    Z = unit_windows(T, m)
    i = np.arange(w)
    near = _near_counts(Z, Z, np.abs(i[:, None] - i[None, :]) >= m // 4, threshold)
    for ref in (mpx_thresh(T, config=_mpx_cfg(m, dtype), threshold=threshold),
                brute_force_sum_thresh(T, m, threshold), mpx_brute(T, m, threshold)):
        assert_thresh_close(sums, cnts, *_np(*ref), dtype, near)
    assert cnts.sum() > 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sum_thresh_ab_matches_mpx_and_brute_force(dtype):
    A, B, m, thr = random_walk(700, seed=2), random_walk(500, seed=3), 24, 0.5
    sums, cnts = _np(*compute_sum_thresh_ab(A, B, config=_cfg(m, dtype), threshold=thr))
    assert sums.shape == (700 - m + 1,)
    Za, Zb = unit_windows(A, m), unit_windows(B, m)
    near = _near_counts(Za, Zb, np.ones((Za.shape[0], Zb.shape[0]), bool), thr)
    for ref in (mpx_thresh_ab(A, B, config=_mpx_cfg(m, dtype), threshold=thr),
                brute_force_sum_thresh_ab(A, B, m, thr), mpx_brute_ab(A, B, m, thr)):
        assert_thresh_close(sums, cnts, *_np(*ref), dtype, near)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_zero_variance_windows_count_nothing(dtype):
    """Zero-variance windows are masked as in the 1-NN tiers: sum 0 and
    count 0 for them, and they add to nobody's."""
    T, m = random_walk(800, seed=4), 16
    T[200:280] = T[200]
    w = 800 - m + 1
    sums, cnts = _np(*compute_sum_thresh(T, config=_cfg(m, dtype), threshold=-0.5))
    flat = ~np.isfinite(unit_windows(T, m)[:, 0])
    assert flat.any() and (cnts[flat] == 0).all() and (sums[flat] == 0).all()
    Z = unit_windows(T, m)
    i = np.arange(w)
    near = _near_counts(Z, Z, np.abs(i[:, None] - i[None, :]) >= m // 4, -0.5)
    assert_thresh_close(sums, cnts, *brute_force_sum_thresh(T, m, -0.5), dtype, near)
    A, B = T, random_walk(400, seed=5)
    sums, cnts = _np(*compute_sum_thresh_ab(B, A, config=_cfg(m, dtype), threshold=-0.5))
    Zb = unit_windows(B, m)
    near = _near_counts(Zb, Z, np.ones((Zb.shape[0], w), bool), -0.5)
    assert_thresh_close(sums, cnts, *brute_force_sum_thresh_ab(B, A, m, -0.5), dtype, near)
    assert (cnts <= w - flat.sum()).all() and cnts.max() > 0


def test_sum_thresh_fixed_point_input():
    T, m = random_walk(600, seed=6), 16
    sums, cnts = _np(*compute_sum_thresh(T, config=_cfg(m, "ap32"), threshold=0.3))
    ref = _np(*mpx_thresh(T, config=_mpx_cfg(m, "ap32"), threshold=0.3))
    assert_thresh_close(sums, cnts, *ref, "float64", None)


@pytest.mark.parametrize("kwargs,match", [
    ({"threshold": 1.5}, "threshold"), ({"threshold": -1.01}, "threshold"),
    ({"kernel": "mxu_fused"}, "one kernel"), ({"kernel": "hybrid"}, "one kernel"),
])
def test_sum_thresh_rejects_bad_arguments(kwargs, match):
    T = random_walk(300, seed=7)
    cfg = _cfg(16, "float32", kwargs.get("kernel", "auto"))
    thr = kwargs.get("threshold", 0.0)
    with pytest.raises(ValueError, match=match):
        compute_sum_thresh(T, config=cfg, threshold=thr)
    with pytest.raises(ValueError, match=match):
        compute_sum_thresh_ab(T, T, config=cfg, threshold=thr)
