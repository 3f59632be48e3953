"""The anytime tier of mpx_torch (``mpx_torch.anytime``, on the CPU): each
yield against mpx's for the same seed and order (the same job subsets),
the final yield against ``compute_matrix_profile``, and mpx's refusals.
Tolerances 1e-8 (float64) / 2e-3 (float32), indices only between
equidistant neighbours.
"""

import numpy as np
import pytest

import mpx
from mpx.anytime import anytime_matrix_profile as mpx_anytime
from mpx_torch import MatrixProfileConfig, compute_matrix_profile
from mpx_torch.anytime import _num_jobs, anytime_matrix_profile, approx_matrix_profile
from tests.helpers import assert_profile_close

EPS = {"float64": 1e-8, "float32": 2e-3}


def _cfg(dtype="float64", **kw):
    return MatrixProfileConfig(m=24, dtype=dtype, band=32, chunk=64, device="cpu", **kw)


def _walk(n, seed):
    return np.cumsum(np.random.default_rng(seed).standard_normal(n))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("order", ["shuffled", "diagonal"])
def test_each_yield_matches_mpx_and_the_last_the_full_profile(order, dtype):
    T = _walk(700, 71)
    cfg = _cfg(dtype)
    ref = mpx_anytime(T, config=mpx.MatrixProfileConfig(m=24, dtype=dtype, band=32,
                                                         chunk=64, kernel="mxu"),
                      batches=5, order=order, seed=3)
    prev, fracs = None, []
    for (MP, MPI, frac), (MPr, MPIr, fracr) in zip(
            anytime_matrix_profile(T, config=cfg, batches=5, order=order, seed=3), ref):
        assert isinstance(MP, np.ndarray) and frac == fracr
        # windows with no candidate yet are the sentinel in both
        np.testing.assert_array_equal(MPI < 0, np.asarray(MPIr) < 0)
        has = MPI >= 0
        assert_profile_close(T, 24, np.where(has, MP, np.asarray(MPr)), MPI, MPr, MPIr,
                             EPS[dtype])
        if prev is not None:
            assert (MP <= prev).all()  # non-increasing
        prev = MP
        fracs.append(frac)
    assert fracs == sorted(fracs) and fracs[-1] == 1.0 and len(fracs) == 5
    MPx, MPIx = (o.numpy() for o in compute_matrix_profile(T, config=cfg))
    assert_profile_close(T, 24, prev, MPI, MPx, MPIx, EPS[dtype])


def test_recurrence_kernel_and_one_batch():
    T = _walk(420, 79)
    cfg = MatrixProfileConfig(m=16, dtype="float64", kernel="xla", band=64, chunk=128,
                              device="cpu")
    (MP, MPI, frac), = anytime_matrix_profile(T, config=cfg, batches=1)
    assert frac == 1.0
    MPx, MPIx = (o.numpy() for o in compute_matrix_profile(T, config=cfg))
    assert_profile_close(T, 16, MP, MPI, MPx, MPIx, 1e-8)


def test_approx_takes_exactly_its_fraction_of_the_jobs_as_mpx():
    T = _walk(900, 73)
    cfg = _cfg("float32")
    MP, MPI, frac = approx_matrix_profile(T, config=cfg, fraction=0.25)
    num = _num_jobs(900, None, cfg)
    assert frac == np.ceil(0.25 * num) / num
    MPr, MPIr, fracr = mpx.approx_matrix_profile(
        T, config=mpx.MatrixProfileConfig(m=24, band=32, chunk=64, kernel="mxu"),
        fraction=0.25)
    assert frac == fracr
    np.testing.assert_array_equal(MPI < 0, np.asarray(MPIr) < 0)
    assert_profile_close(T, 24, np.where(MPI >= 0, MP, np.asarray(MPr)), MPI, MPr, MPIr,
                         2e-3)
    MPx, _ = compute_matrix_profile(T, config=cfg)
    assert (MP >= MPx.numpy() - 1e-6).all()  # upper bounds


def test_refusals():
    T = _walk(300, 5)
    with pytest.raises(ValueError, match="fraction"):
        approx_matrix_profile(T, config=_cfg(), fraction=0.0)
    with pytest.raises(ValueError, match="fraction"):
        approx_matrix_profile(T, config=_cfg(), fraction=1.5)
    with pytest.raises(ValueError, match="batches"):
        next(anytime_matrix_profile(T, config=_cfg(), batches=0))
    with pytest.raises(ValueError, match="order"):
        next(anytime_matrix_profile(T, config=_cfg(), order="random"))
    with pytest.raises(ValueError, match="hybrid"):
        next(anytime_matrix_profile(T, config=_cfg(kernel="hybrid")))
    with pytest.raises(ValueError, match="conflicts"):
        next(anytime_matrix_profile(T, 16, config=_cfg()))
