"""The top-k profiles of mpx_torch (``mpx_torch.topk``, on the CPU)
against mpx's and the numpy oracles.

Tolerances: distances 1e-8 (float64) / 2e-3 (float32), an index differing
only between neighbors equidistant within that.  On a series of exactly
repeated segments every neighbor list is a run of ties, so the indices
must equal mpx's exactly (its ``lax.top_k`` order and merge order); the
distances there are sqrt(2m(1 - P)) of P within rounding of 1, so they are
held in correlation: 1e-12 (float64) / 1e-6 (float32).
"""

import numpy as np
import pytest
import torch

import mpx
from mpx.topk import brute_force_topk_ab as mpx_brute_ab
from mpx.topk import compute_topk_ab as mpx_topk_ab
from mpx.topk import compute_topk_profile as mpx_topk
from mpx_torch import MatrixProfileConfig, compute_matrix_profile
from mpx_torch.abjoin import unit_windows
from mpx_torch.topk import (
    _topk_desc,
    brute_force_topk_ab,
    compute_topk_ab,
    compute_topk_profile,
)
from tests.conftest import random_walk

EPS = {"float32": 2e-3, "float64": 1e-8}
CORR_EPS = {"float32": 1e-6, "float64": 1e-12}


def _cfg(m, dtype, kernel="auto", band=64, chunk=128):
    return MatrixProfileConfig(m=m, dtype=dtype, kernel=kernel, band=band, chunk=chunk,
                               device="cpu")


def _mpx_cfg(m, dtype, kernel="mxu", band=64, chunk=128):
    return mpx.MatrixProfileConfig(m=m, dtype=dtype, kernel=kernel, band=band, chunk=chunk,
                                   tile_rows=8, tile_cols=chunk)


def _np(*xs):
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x) for x in xs]


def _repeats(period: int = 40, copies: int = 20, seed: int = 3) -> np.ndarray:
    """Exact copies of one integer-valued segment: with m a power of two
    every statistic is exact, so each window's copies tie bit for bit."""
    motif = np.random.default_rng(seed).integers(-8, 9, period).astype(np.float64)
    return np.tile(motif, copies)


def assert_topk_close(Zq, Zt, m, D, I, Dr, Ir, eps):
    """Rows within eps (inf where both have no neighbor); an index may
    differ only where the two candidates are equidistant within eps."""
    assert D.shape == Dr.shape and I.dtype == np.int32
    np.testing.assert_array_equal(np.isinf(D), np.isinf(Dr))
    fin = np.isfinite(Dr)
    np.testing.assert_allclose(np.asarray(D, np.float64)[fin], Dr[fin], rtol=0, atol=eps)
    for r, j in zip(*np.nonzero(I != Ir)):
        assert I[r, j] >= 0 and Ir[r, j] >= 0, (r, j)
        d = [np.sqrt(max(2.0 * m * (1.0 - Zq[r] @ Zt[c]), 0.0)) for c in (I[r, j], Ir[r, j])]
        assert abs(d[0] - d[1]) <= max(eps, 1e-7), (r, j, I[r, j], Ir[r, j])


def _corr(D, m):
    return np.where(np.isfinite(D), 1 - np.asarray(D, np.float64) ** 2 / (2 * m), -2)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_topk_profile_matches_mpx(dtype, k):
    T, m = random_walk(900, seed=1), 16
    T[300:360] = T[300]  # zero-variance windows: fewer than k neighbors, none
    D, I = _np(*compute_topk_profile(T, k=k, config=_cfg(m, dtype)))
    assert D.dtype == np.dtype(dtype) and D.shape == (900 - m + 1, k)
    Dr, Ir = _np(*mpx_topk(T, k=k, config=_mpx_cfg(m, dtype)))
    Z = unit_windows(T, m)
    assert_topk_close(Z, Z, m, D, I, Dr, Ir, EPS[dtype])
    flat = ~np.isfinite(unit_windows(T, m)[:, 0])
    assert flat.any() and (I[flat] == -1).all() and np.isinf(D[flat]).all()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_topk_tie_order_matches_mpx_exactly(dtype):
    """Every window has 19 exact copies: the k-lists are runs of ties, and
    their indices must be mpx's, in mpx's order."""
    T, m, k = _repeats(), 16, 4
    D, I = _np(*compute_topk_profile(T, k=k, config=_cfg(m, dtype)))
    Dr, Ir = _np(*mpx_topk(T, k=k, config=_mpx_cfg(m, dtype)))
    np.testing.assert_array_equal(I, Ir)
    np.testing.assert_allclose(_corr(D, m), _corr(Dr, m), rtol=0, atol=CORR_EPS[dtype])
    # The ties are real: each window's k nearest are copies (distance ~0).
    assert (np.abs(I - np.arange(I.shape[0])[:, None]) % 40 == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_topk_ab_tie_order_matches_mpx_exactly(dtype):
    A, B, m, k = _repeats(copies=12), _repeats(copies=9), 16, 4
    D, I = _np(*compute_topk_ab(A, B, k=k, config=_cfg(m, dtype)))
    Dr, Ir = _np(*mpx_topk_ab(A, B, k=k, config=_mpx_cfg(m, dtype, kernel="auto")))
    np.testing.assert_array_equal(I, Ir)
    np.testing.assert_allclose(_corr(D, m), _corr(Dr, m), rtol=0, atol=CORR_EPS[dtype])


@pytest.mark.parametrize("na,nb,m,dtype", [(512, 300, 16, "float64"), (300, 512, 32, "float64"),
                                           (700, 600, 24, "float32")])
def test_topk_ab_matches_mpx_and_brute_force(na, nb, m, dtype):
    A, B, k = random_walk(na, seed=4), random_walk(nb, seed=5), 3
    D, I = _np(*compute_topk_ab(A, B, k=k, config=_cfg(m, dtype)))
    assert D.shape == (na - m + 1, k)
    Za, Zb = unit_windows(A, m), unit_windows(B, m)
    Dr, Ir = _np(*mpx_topk_ab(A, B, k=k, config=_mpx_cfg(m, dtype, kernel="auto")))
    assert_topk_close(Za, Zb, m, D, I, Dr, Ir, EPS[dtype])
    for ref in (brute_force_topk_ab(A, B, m, k), mpx_brute_ab(A, B, m, k)):
        assert_topk_close(Za, Zb, m, D, I, *ref, EPS[dtype])


def test_topk_ab_with_constant_runs_matches_brute_force():
    A, B, m = random_walk(600, seed=6), random_walk(500, seed=7), 16
    A[100:150] = A[100]
    B[200:260] = -1.0
    D, I = _np(*compute_topk_ab(A, B, k=4, config=_cfg(m, "float64")))
    Za, Zb = unit_windows(A, m), unit_windows(B, m)
    assert_topk_close(Za, Zb, m, D, I, *brute_force_topk_ab(A, B, m, 4), EPS["float64"])
    flat_b = np.nonzero(~np.isfinite(Zb[:, 0]))[0]
    assert flat_b.size and not np.isin(I, flat_b).any()


def test_top1_is_the_matrix_profile():
    T, m = random_walk(800, seed=8), 16
    D, I = _np(*compute_topk_profile(T, k=1, config=_cfg(m, "float64")))
    MP, MPI = _np(*compute_matrix_profile(T, config=_cfg(m, "float64", "mxu")))
    np.testing.assert_allclose(D[:, 0], MP, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(I[:, 0], MPI)


def test_topk_fixed_point_input():
    T, m = random_walk(700, seed=9), 16
    D, I = _np(*compute_topk_profile(T, k=3, config=_cfg(m, "ap32")))
    assert D.dtype == np.float64
    Dr, Ir = _np(*mpx_topk(T, k=3, config=_mpx_cfg(m, "ap32")))
    Z = unit_windows(T, m)
    assert_topk_close(Z, Z, m, D, I, Dr, Ir, EPS["float64"])


def test_topk_hybrid_is_not_ported():
    """Once a refusal, now the routing of kernel='hybrid': float64 runs the
    top-k hybrid (tests/test_torch_topk_hybrid.py), which gives the strict
    tile's lists; float32 ignores the kernel name, as mpx's does."""
    T = random_walk(300, seed=10)
    Z = unit_windows(T, 16)
    D, I = _np(*compute_topk_profile(T, k=4, config=_cfg(16, "float64", "hybrid")))
    Dr, Ir = _np(*compute_topk_profile(T, k=4, config=_cfg(16, "float64")))
    assert_topk_close(Z, Z, 16, D, I, Dr, Ir, EPS["float64"])
    # mpx's float32 top-k ignores the kernel name: the tile runs.
    D, _ = compute_topk_profile(T, k=2, config=_cfg(16, "float32", "hybrid"))
    assert D.shape == (285, 2)


def test_topk_rejects_bad_arguments():
    T = random_walk(300, seed=11)
    with pytest.raises(ValueError, match="k must be"):
        compute_topk_profile(T, k=0, config=_cfg(16, "float32"))
    with pytest.raises(ValueError, match="exceeds"):
        compute_topk_profile(T, k=65, config=_cfg(16, "float32"))
    with pytest.raises(ValueError, match="one kernel"):
        compute_topk_ab(T, T, k=2, config=_cfg(16, "float32", "mxu_fused"))
    with pytest.raises(ValueError, match="exceeds"):
        compute_topk_ab(T, T, k=129, config=_cfg(16, "float32"))


@pytest.mark.parametrize("shape,k,levels", [((7, 50), 4, 3), ((5, 64), 8, 2),
                                            ((3, 2, 33), 5, 4), ((6, 9), 9, 1)])
def test_topk_desc_is_position_stable(shape, k, levels):
    """The k largest with the lower position first among equal values
    (``lax.top_k``'s order), against a stable numpy sort, on values with
    many ties; the indices come from the picked positions."""
    rng = np.random.default_rng(sum(shape) + k)
    vals = rng.integers(0, levels, shape).astype(np.float64)
    idx = rng.permutation(np.prod(shape)).reshape(shape).astype(np.int32)
    v, i = _topk_desc(torch.from_numpy(vals), torch.from_numpy(idx), k)
    order = np.argsort(-vals, axis=-1, kind="stable")[..., :k]
    np.testing.assert_array_equal(v.numpy(), np.take_along_axis(vals, order, -1))
    np.testing.assert_array_equal(i.numpy(), np.take_along_axis(idx, order, -1))
