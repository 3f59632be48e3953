"""Masked gaps in mpx_torch (``mpx_torch.missing``, on the CPU) against
mpx's ``missing`` tier and its independent brute force
(``tests/test_missing.py:masked_oracle``), plain and ``left_right``, on
the windows-matmul path (``mxu``) and the recurrence (``xla``), and mpx's
refusals.  Tolerances 1e-8 (float64) / 2e-3 (float32).
"""

import numpy as np
import pytest

import mpx
from mpx.missing import compute_matrix_profile_masked as mpx_masked
from mpx_torch import MatrixProfileConfig, compute_matrix_profile
from mpx_torch.missing import compute_matrix_profile_masked, missing_window_mask
from tests.helpers import assert_profile_close
from tests.test_missing import gapped_series, masked_oracle

EPS = {"float64": 1e-8, "float32": 2e-3}


def _cfg(dtype="float64", kernel="auto", m=24):
    return MatrixProfileConfig(m=m, dtype=dtype, kernel=kernel, band=64, chunk=128,
                               device="cpu")


@pytest.mark.parametrize("dtype,kernel", [("float64", "auto"), ("float32", "auto"),
                                          ("float64", "xla"), ("float32", "xla")])
def test_masked_matches_the_oracle_and_mpx(dtype, kernel):
    T = gapped_series()
    m = 24
    MP, MPI = (o.numpy() for o in compute_matrix_profile_masked(T, config=_cfg(dtype, kernel)))
    MPe, MPIe, bad = masked_oracle(T, m)
    np.testing.assert_array_equal(missing_window_mask(T, m), bad)
    assert (MPI[bad] == -1).all()
    assert np.all(MP[bad] == MP[bad][0]) and MP[bad][0] > 5e6  # the sentinel
    assert not np.isin(MPI[MPI >= 0], np.nonzero(bad)[0]).any()
    ok = MPIe >= 0
    np.testing.assert_array_equal(MPI >= 0, ok)
    assert np.abs(MP[ok].astype(np.float64) - MPe[ok]).max() <= EPS[dtype]
    MPr, MPIr = mpx_masked(T, config=mpx.MatrixProfileConfig(m=m, dtype=dtype, band=64,
                                                             chunk=128))
    Tf = np.where(np.isfinite(T), T, 0.0)
    assert_profile_close(Tf, m, np.where(ok, MP, np.asarray(MPr)), MPI, MPr, MPIr, EPS[dtype])


def test_masked_left_right_matches_mpx():
    T = gapped_series(n=700, seed=11)
    m = 16
    out = [o.numpy() for o in compute_matrix_profile_masked(T, config=_cfg(m=m),
                                                            left_right=True)]
    ref = mpx_masked(T, config=mpx.MatrixProfileConfig(m=m, dtype="float64", band=64,
                                                        chunk=128), left_right=True)
    bad = missing_window_mask(T, m)
    Tf = np.where(np.isfinite(T), T, 0.0)
    for (MP, MPI), (MPr, MPIr) in zip((out[:2], out[2:]), (ref[:2], ref[2:])):
        assert (MPI[bad] == -1).all()
        np.testing.assert_array_equal(MPI < 0, np.asarray(MPIr) < 0)
        assert_profile_close(Tf, m, np.where(MPI >= 0, MP, np.asarray(MPr)), MPI, MPr, MPIr,
                             1e-8)


def test_finite_input_goes_to_the_driver():
    T = np.cumsum(np.random.default_rng(3).standard_normal(300))
    cfg = _cfg(m=16)
    got = compute_matrix_profile_masked(T, config=cfg)
    want = compute_matrix_profile(T, config=cfg)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_refusals():
    with pytest.raises(ValueError, match="every window overlaps"):
        compute_matrix_profile_masked(np.full(100, np.nan), config=_cfg(m=8))
    T = gapped_series()
    with pytest.raises(ValueError, match="gaps"):
        compute_matrix_profile_masked(T, config=MatrixProfileConfig(m=16, dtype="ap16",
                                                                     device="cpu"))
    with pytest.raises(ValueError, match="hybrid"):
        compute_matrix_profile_masked(T, config=_cfg(kernel="hybrid"))
    with pytest.raises(ValueError, match="conflicts"):
        compute_matrix_profile_masked(T, 16, config=_cfg())
