"""The fleet tier of mpx_torch (``mpx_torch.batch``, on the CPU): each row
bit for bit the port's single-series profile, within 2e-3 (float32) /
1e-8 (float64) of ``mpx.compute_batch_profiles``, the same for any
``group``, and mpx's refusals with its width caps.
"""

import numpy as np
import pytest

import mpx
from mpx_torch import MatrixProfileConfig, compute_matrix_profile
from mpx_torch.batch import MAX_W_F32, MAX_W_F64, compute_batch_profiles
from tests.helpers import assert_profile_close

EPS = {"float64": 1e-8, "float32": 2e-3}


def make_batch(B, n, seed=0):
    return np.cumsum(np.random.default_rng(seed).standard_normal((B, n)), axis=1)


@pytest.mark.parametrize("dtype,kernel", [("float32", "auto"), ("float64", "auto"),
                                          ("float64", "xla")])
def test_rows_equal_single_runs_and_match_mpx(dtype, kernel):
    B, n, m = 5, 320, 16
    batch = make_batch(B, n, seed=1)
    batch[2, 100:140] = 3.0  # zero-variance windows in one series
    cfg = MatrixProfileConfig(m=m, dtype=dtype, kernel=kernel, band=64, chunk=128,
                              device="cpu")
    MP, MPI = compute_batch_profiles(batch, config=cfg)
    assert MP.shape == MPI.shape == (B, n - m + 1)
    assert MP.dtype == np.dtype(dtype) and MPI.dtype == np.int32
    MPr, MPIr = mpx.compute_batch_profiles(batch, config=mpx.MatrixProfileConfig(
        m=m, dtype=dtype, band=64, chunk=128))
    for b in range(B):
        one = [o.numpy() for o in compute_matrix_profile(batch[b], config=cfg)]
        np.testing.assert_array_equal(MP[b], one[0])
        np.testing.assert_array_equal(MPI[b], one[1])
        assert_profile_close(batch[b], m, MP[b], MPI[b], MPr[b], MPIr[b], EPS[dtype])


def test_group_invariance():
    batch = make_batch(7, 300, seed=3)
    cfg = MatrixProfileConfig(m=16, device="cpu")
    base = compute_batch_profiles(batch, config=cfg)
    for group in (1, 3, 7, 100):
        got = compute_batch_profiles(batch, config=cfg, group=group)
        np.testing.assert_array_equal(got[0], base[0])
        np.testing.assert_array_equal(got[1], base[1])


def test_input_quant_matches_single_runs():
    batch = make_batch(2, 200, seed=4)
    cfg = MatrixProfileConfig(m=16, dtype="ap32", device="cpu")
    MP, MPI = compute_batch_profiles(batch, config=cfg)
    for b in range(2):
        one = compute_matrix_profile(batch[b], config=cfg)
        np.testing.assert_array_equal(MP[b], one[0].numpy())


def test_refusals_match_mpx():
    cpu = dict(device="cpu")
    with pytest.raises(ValueError, match="2-D"):
        compute_batch_profiles(np.zeros(100), config=MatrixProfileConfig(m=8, **cpu))
    with pytest.raises(ValueError, match="2-D"):
        compute_batch_profiles(np.empty((0, 100)), config=MatrixProfileConfig(m=8, **cpu))
    assert (MAX_W_F32, MAX_W_F64) == (mpx.driver.SMALL_FUSED_MAX_W,
                                      mpx.driver.SMALL_FUSED_MAX_W_F64)
    for dtype, cap in (("float64", MAX_W_F64), ("float32", MAX_W_F32)):
        big = np.zeros((1, cap + 8))  # w = cap + 1
        for run in (lambda c: compute_batch_profiles(big, config=MatrixProfileConfig(
                        m=8, dtype=dtype, **cpu)),
                    lambda c: mpx.compute_batch_profiles(big, config=mpx.MatrixProfileConfig(
                        m=8, dtype=dtype))):
            with pytest.raises(ValueError, match="small series"):
                run(None)
    with pytest.raises(ValueError, match="group"):
        compute_batch_profiles(make_batch(2, 100), config=MatrixProfileConfig(m=8, **cpu),
                               group=0)
    bad = make_batch(3, 100)
    bad[1, 50] = np.nan
    with pytest.raises(ValueError, match=r"series 1, sample 50"):
        compute_batch_profiles(bad, config=MatrixProfileConfig(m=8, **cpu))
    with pytest.raises(ValueError, match="cannot batch"):
        compute_batch_profiles(make_batch(2, 100),
                               config=MatrixProfileConfig(m=8, kernel="hybrid", **cpu))
