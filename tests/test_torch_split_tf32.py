"""K1's float32 arithmetic, emulated on the CPU, against mpx's float32 results.

On the card K1 computes its float32 correlation tile as split TF32: each
operand is split into two TF32 values, ``hi = cvt.rna.tf32(x)`` and
``lo = cvt.rna.tf32(x - hi)`` (round to nearest, ties away from zero, the
13 low mantissa bits cleared), and every k8 step adds ``lo.hi + hi.lo``,
then ``hi.hi`` (``lo.lo`` is dropped).  The tensor cores add each MMA's
products into the f32 accumulator with truncation (round toward zero), so
K1 runs each 32-element slab of m (four k8 steps, 12 MMAs) into a zeroed
tile and folds it into the master accumulator with a round-to-nearest
add.  This file models that accumulation (and the single truncating chain
it replaced, which drifts with m), puts the emulated product into the
plain f32 sweep
(:func:`mpx_torch.kernels.mxu.reduce_tile` on the emulated tile) and holds
it to mpx, as the card-only tests hold the kernel to the plain sweep:

* band values within 1e-5 of mpx's f32 ``sweep_band_mxu_fused`` (its
  Pallas kernel in interpret mode) on the edge jobs of
  ``tests/test_torch_kernels_mxu.py``, indices equal or tied;
* profiles within 2e-3 of mpx's f32 profile, indices equal or
  equidistant;
* on walks with noisy planted copies at m = 1024 and 2048, the promoted
  order within 2e-3 of the exact distances where the single chain is not.
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
SLAB_K = 32  # float32 elements of m in one of K1's shared-memory slabs


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round the float32 ``x`` to 10 mantissa bits,
    to nearest with ties away from zero, low 13 bits zero."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def round_toward_zero_f32(x: np.ndarray) -> np.ndarray:
    """The float64 ``x`` rounded to float32 toward zero: how the tensor
    cores round an MMA's sum into an f32 accumulator."""
    y = np.asarray(x, np.float64).astype(np.float32)
    over = np.abs(y) > np.abs(x)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y


def _split(X: np.ndarray):
    hi = tf32_rna(X)
    return hi.astype(np.float64), tf32_rna(X - hi).astype(np.float64)


def split_tf32_accumulate(A: np.ndarray, B: np.ndarray, k_step, promote: bool = True):
    """K1's split-TF32 sum over m of the float32 operands ``A`` and ``B``
    (m last): every k8 step adds its three products (``lo.hi``, ``hi.lo``,
    ``hi.hi``, each summed exactly) with round-toward-zero, into a zeroed
    slab accumulator that a round-to-nearest add folds into the result
    every SLAB_K elements (``promote``, the kernel), or into one chain
    along the whole m axis (``promote=False``, the kernel before the
    repair).  ``k_step(X, Y, ks)`` is the exact sum of one step's products
    of X and Y over the k slice ``ks``."""
    (Ah, Al), (Bh, Bl) = _split(A), _split(B)
    m = A.shape[-1]
    acc = part = None
    for k in range(0, m, MMA_K):
        ks = slice(k, k + MMA_K)
        for X, Y in ((Al, Bh), (Ah, Bl), (Ah, Bh)):
            s = k_step(X, Y, ks)
            cur = part if promote else acc
            cur = round_toward_zero_f32(s if cur is None else cur.astype(np.float64) + s)
            if promote:
                part = cur
            else:
                acc = cur
        if promote and ((k + MMA_K) % SLAB_K == 0 or k + MMA_K >= m):
            acc = part if acc is None else (acc.astype(np.float64) + part).astype(np.float32)
            part = None
    return acc


def split_tf32_product(A: np.ndarray, B: np.ndarray, promote: bool = True) -> np.ndarray:
    """A @ B.T for float32 (S, m) and (W, m) as K1 computes it on the card."""
    return split_tf32_accumulate(A, B, lambda X, Y, ks: X[:, ks] @ Y[:, ks].T, promote)


def split_tf32_pair_dots(A: np.ndarray, B: np.ndarray, promote: bool = True) -> np.ndarray:
    """The K1 products of rows A[i] and B[i] only."""
    return split_tf32_accumulate(A, B, lambda X, Y, ks: (X[:, ks] * Y[:, ks]).sum(1), promote)


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


def test_round_toward_zero():
    one = np.float64(1.0)
    ulp = 2.0**-23  # float32 spacing at 1
    x = np.array([one + 0.75 * ulp, -(one + 0.75 * ulp), one + 0.25 * ulp, 1.5], np.float64)
    np.testing.assert_array_equal(round_toward_zero_f32(x), np.float32([1.0, -1.0, 1.0, 1.5]))


def planted_pairs(m: int, seed: int, copies: int = 20):
    """A walk of 16 m samples with ``copies`` noisy copies (noise 0.05 of
    the segment's spread) of segments of its first half planted in its
    second half: the exact float64 unit windows of each (source, copy)
    pair."""
    rng = np.random.default_rng(seed)
    n = 16 * m
    T = np.cumsum(rng.standard_normal(n))
    src = rng.integers(0, n // 2 - m, copies)
    dst = n // 2 + rng.integers(0, n // 2 - m, copies)
    for s, d in zip(src, dst):
        seg = T[s : s + m]
        T[d : d + m] = seg - seg.mean() + T[d] + 0.05 * seg.std() * rng.standard_normal(m)

    def unit(idx):
        c = np.lib.stride_tricks.sliding_window_view(T, m)[idx]
        c = c - c.mean(axis=1, keepdims=True)
        return c / np.sqrt((c * c).sum(axis=1, keepdims=True))

    return unit(src), unit(dst)


@pytest.mark.parametrize("m", [1024, 2048])
def test_promoted_accumulation_holds_large_m(m):
    """K1's per-slab promotion keeps the f32 distances of near neighbours
    within 2e-3 of the exact ones at m = 1024 and 2048; the single
    truncating chain it replaced drifts past 2e-3 there (its bias grows
    with the 3m/8 MMAs of the chain)."""
    Ua, Ub = planted_pairs(m, seed=m)
    exact = np.sqrt(np.maximum(2.0 * m * (1.0 - (Ua * Ub).sum(axis=1)), 0.0))
    A, B = Ua.astype(np.float32), Ub.astype(np.float32)
    err = {}
    for promote in (True, False):
        P = split_tf32_pair_dots(A, B, promote).astype(np.float64)
        err[promote] = np.abs(np.sqrt(np.maximum(2.0 * m * (1.0 - P), 0.0)) - exact).max()
    assert err[True] <= 2e-3 < err[False], err
    # A window against itself: the chain's truncation reads d ~ 0.1, the
    # promoted order several times less.
    own = {p: split_tf32_pair_dots(A[:1], A[:1], p)[0] for p in (True, False)}
    assert 1.0 - own[True] < (1.0 - own[False]) / 2


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
