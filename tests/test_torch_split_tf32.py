"""K1's float32 arithmetic, emulated on the CPU, against mpx's float32 results.

On the card K1 computes its float32 correlation tile as split TF32: each
operand is split into two TF32 values, ``hi = cvt.rna.tf32(x)`` and
``lo = cvt.rna.tf32(x - hi)`` (round to nearest, ties away from zero, the
13 low mantissa bits cleared), and every k8 step adds ``lo.hi + hi.lo``,
then ``hi.hi``, to an f32 accumulator (``lo.lo`` is dropped).  This file
puts a numpy emulation of that product into the plain f32 sweep
(:func:`mpx_torch.kernels.mxu.reduce_tile` on the emulated tile) and holds
it to mpx, as the card-only tests hold the kernel to the plain sweep:

* band values within 1e-5 of mpx's f32 ``sweep_band_mxu_fused`` (its
  Pallas kernel in interpret mode) on the edge jobs of
  ``tests/test_torch_kernels_mxu.py``, indices equal or tied;
* profiles within 2e-3 of mpx's f32 profile, indices equal or
  equidistant.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpx
from mpx.kernels import band_geometry as mpx_geometry
from mpx.kernels.mxu_fused import sweep_band_mxu_fused as mpx_fused
from mpx_torch import MatrixProfileConfig, compute_matrix_profile, driver
from mpx_torch.kernels.common import band_geometry
from mpx_torch.kernels.mxu import reduce_tile
from tests.conftest import random_walk
from tests.helpers import assert_profile_close
from tests.test_torch_driver import DATASETS, _load
from tests.test_torch_kernels_mxu import (
    EDGE_JOBS,
    M,
    N,
    S,
    TOL,
    W,
    W_PROFILE,
    _assert_band_close,
    _both_stats,
)

MMA_K = 8  # the depth of one mma.sync m16n8k8 step


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round the float32 ``x`` to 10 mantissa bits,
    to nearest with ties away from zero, low 13 bits zero."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32_product(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """A @ B.T for float32 (S, m) and (W, m) as K1 computes it on the card."""
    Ah = tf32_rna(A)
    Al = tf32_rna(A - Ah)
    Bh = tf32_rna(B)
    Bl = tf32_rna(B - Bh)
    P = np.zeros((A.shape[0], B.shape[0]), np.float32)
    for k in range(0, A.shape[1], MMA_K):
        ks = slice(k, k + MMA_K)
        P += Al[:, ks] @ Bh[:, ks].T
        P += Ah[:, ks] @ Bl[:, ks].T
        P += Ah[:, ks] @ Bh[:, ks].T
    return P


def split_tf32_sweep(stats, r0, k0, geom, dtype):
    """The plain f32 sweep with K1's split-TF32 product."""
    assert stats.windows.dtype == torch.float32
    r0, c0 = int(r0), int(r0) + int(k0)
    U = stats.windows.numpy()
    P = split_tf32_product(U[r0 : r0 + geom.S], U[c0 : c0 + geom.W])
    return reduce_tile(torch.from_numpy(P), stats, r0, c0, geom)


def test_tf32_rounding_and_split():
    one = np.float32(1.0)
    ulp = np.float32(2.0**-10)  # TF32 spacing at 1
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 4, one + 3 * ulp / 4],
                 np.float32)
    np.testing.assert_array_equal(tf32_rna(x), [one + ulp, -(one + ulp), one, one + ulp])
    assert (tf32_rna(x).view(np.uint32) & 0x1FFF == 0).all()
    A = np.random.default_rng(0).standard_normal((64, 256)).astype(np.float32)
    hi = tf32_rna(A)
    rest = A.astype(np.float64) - hi - tf32_rna(A - hi)
    assert np.abs(rest).max() <= 2.0**-22 * np.abs(A).max()


@pytest.fixture(scope="module")
def series():
    T = random_walk(N, seed=7)
    T[700:900] = T[700]  # zero-variance windows
    return T


@pytest.mark.parametrize("r0,k0", EDGE_JOBS)
def test_split_tf32_band_matches_mpx_fused_interpret(series, r0, k0):
    s_mpx, s_ours, U64 = _both_stats(series, "float32")
    geom = band_geometry(S, W, M, W_PROFILE)
    ours = split_tf32_sweep(s_ours, r0, k0, geom, "float32")
    ref = mpx_fused(s_mpx, jnp.int32(r0), jnp.int32(k0),
                    mpx_geometry(S, W, M, W_PROFILE, 8, 128), jnp.float32,
                    interpret=True)
    _assert_band_close(ours, ref, U64, r0, k0, TOL["float32"])


@pytest.mark.parametrize("path,limit,m,band,chunk",
                         [DATASETS[0], DATASETS[2], DATASETS[3]])
def test_split_tf32_profile_matches_mpx(monkeypatch, path, limit, m, band, chunk):
    T = _load(path, limit)
    monkeypatch.setattr(driver, "get_sweep_fn", lambda kernel: split_tf32_sweep)
    cfg = MatrixProfileConfig(m=m, dtype="float32", band=band, chunk=chunk, device="cpu")
    MP, MPI = (o.numpy() for o in compute_matrix_profile(T, config=cfg))
    ref_cfg = mpx.MatrixProfileConfig(m=m, dtype="float32", kernel="mxu", band=band,
                                      chunk=chunk)
    MP_ref, MPI_ref = (np.asarray(x) for x in mpx.compute_matrix_profile(T, config=ref_cfg))
    assert_profile_close(T, m, MP, MPI, MP_ref, MPI_ref, eps=2e-3)
