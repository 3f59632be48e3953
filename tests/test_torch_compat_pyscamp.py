"""mpx_torch's pyscamp shim (``mpx_torch/compat/pyscamp.py``) against
mpx's (``mpx/compat/pyscamp.py``), function for function, on the same
inputs: float32 within 2e-3, float64 within 1e-8, indices equal or
equidistant."""

import numpy as np
import pytest
import torch

import mpx.compat.pyscamp as ref
import mpx_torch.compat.pyscamp as psc
from tests.conftest import random_walk
from tests.helpers import assert_profile_close

A = random_walk(600, seed=7)
B = random_walk(400, seed=10)
M = 16


@pytest.mark.parametrize("precision,pearson,tol", [
    ("single", False, 2e-3), ("mixed", True, 2e-3), ("double", False, 1e-8),
    ("ultra", True, 1e-8),
])
def test_selfjoin_equals_mpxs(precision, pearson, tol):
    mp_, mpi = psc.selfjoin(A, M, precision=precision, pearson=pearson, device="cpu")
    want, wanti = ref.selfjoin(A, M, precision=precision, pearson=pearson)
    assert mpi.dtype == np.int64 and mp_.shape == want.shape
    if pearson:
        np.testing.assert_allclose(mp_, want, atol=tol, rtol=0)
    else:
        assert_profile_close(A, M, mp_, mpi, want, wanti, eps=tol)


def test_selfjoin_refuses_an_unknown_precision():
    with pytest.raises(ValueError, match="precision must be one of"):
        psc.selfjoin(A, M, precision="quad", device="cpu")


@pytest.mark.parametrize("precision,tol", [("single", 2e-3), ("double", 1e-8)])
def test_abjoin_equals_mpxs(precision, tol):
    mp_, mpi = psc.abjoin(A, B, M, precision=precision, threads=4, gpus=[0], device="cpu")
    want, wanti = ref.abjoin(A, B, M, precision=precision)
    np.testing.assert_allclose(mp_, want, atol=tol, rtol=0)
    assert mpi.dtype == np.int64 and (mpi == wanti).mean() > 0.99


@pytest.mark.parametrize("fn,args", [("selfjoin_sum", (A,)), ("abjoin_sum", (A, B))])
def test_sum_joins_equal_mpxs(fn, args):
    got = getattr(psc, fn)(*args, M, threshold=0.5, precision="double", device="cpu")
    want = getattr(ref, fn)(*args, M, threshold=0.5, precision="double")
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=1e-8, rtol=0)


@pytest.mark.parametrize("pearson", [False, True])
def test_selfjoin_knn_equals_mpxs(pearson):
    got = psc.selfjoin_knn(A, M, 3, precision="double", pearson=pearson, device="cpu")
    want = ref.selfjoin_knn(A, M, 3, precision="double", pearson=pearson)
    assert got.shape == want.shape and got.shape[1] == 3
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2], want[:, 2], atol=1e-8, rtol=0)


def test_abjoin_knn_equals_mpxs():
    got = psc.abjoin_knn(A, B, M, 2, precision="double", device="cpu")
    want = ref.abjoin_knn(A, B, M, 2, precision="double")
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2], want[:, 2], atol=1e-8, rtol=0)


@pytest.mark.parametrize("pearson", [False, True])
def test_matrix_summaries_equal_mpxs(pearson):
    got = psc.selfjoin_matrix(A, M, mwidth=6, mheight=5, pearson=pearson, device="cpu")
    want = ref.selfjoin_matrix(A, M, mwidth=6, mheight=5, pearson=pearson)
    assert got.shape == (5, 6)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
    got = psc.abjoin_matrix(A, B, M, mwidth=4, mheight=3, pearson=pearson, device="cpu")
    want = ref.abjoin_matrix(A, B, M, mwidth=4, mheight=3, pearson=pearson)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def test_device_queries():
    assert psc.gpu_supported() == torch.cuda.is_available()
    assert psc.tpu_supported() is False and ref.gpu_supported() is False
