"""The pooled distance-matrix summary of mpx_torch
(``mpx_torch.distmatrix``, on the CPU) against mpx's ``pooled_matrix`` and
the dense numpy oracle, within mpx's own 2e-3 (float32 tiles)."""

import numpy as np
import pytest
import torch

import mpx
from mpx.distmatrix import brute_force_pooled_matrix as mpx_brute
from mpx.distmatrix import pooled_matrix as mpx_pooled
from mpx_torch import MatrixProfileConfig, pooled_matrix
from mpx_torch.distmatrix import brute_force_pooled_matrix
from mpx_torch.kernels.common import band_geometry
from mpx_torch.kernels.mxu import pair_mask
from mpx_torch.ops.precompute import precompute_statistics

TOL = 2e-3


def _walk(n, seed):
    return np.cumsum(np.random.default_rng(seed).standard_normal(n))


def _cfg(m, band=4096, chunk=4096):
    return MatrixProfileConfig(m=m, band=band, chunk=chunk, device="cpu")


def assert_matches_mpx(A, m, band=4096, **kw):
    got = pooled_matrix(A, m, config=_cfg(m, band, band), **kw)
    exp = brute_force_pooled_matrix(A, m, **kw)
    assert got.shape == (kw.get("mheight", 50), kw.get("mwidth", 50))
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, exp, rtol=0, atol=TOL)
    np.testing.assert_allclose(exp, mpx_brute(A, m, **kw), rtol=0, atol=1e-12)
    ref = mpx_pooled(A, m, config=mpx.MatrixProfileConfig(m=m, band=band, chunk=band), **kw)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    return got


@pytest.mark.parametrize("mh,mw,band", [(10, 10, 4096), (7, 13, 128), (1, 1, 128),
                                        (64, 3, 128)])
def test_selfjoin_matrix_matches_mpx(mh, mw, band):
    """Square jobs of S = min(band, chunk): one tile (4096) or a grid of
    them (128), pools wider and narrower than a tile."""
    assert_matches_mpx(_walk(700, 3), 24, band, mwidth=mw, mheight=mh)


def test_selfjoin_matrix_pearson_and_symmetry():
    got = assert_matches_mpx(_walk(512, 4), 16, 64, mwidth=12, mheight=12, pearson=True)
    # square pooling of a self-join is symmetric
    np.testing.assert_allclose(got, got.T, rtol=0, atol=TOL)


def test_matrix_finer_than_w_identity_pooling():
    """mheight > w: pools of one window; the cells past w - 1 stay empty."""
    m, n = 8, 80
    w = n - m + 1
    got = assert_matches_mpx(_walk(n, 5), m, 32, mwidth=90, mheight=90, pearson=True)
    assert (got[w:, :] == -1.0).all() and (got[:, w:] == -1.0).all()


def test_abjoin_matrix_matches_mpx():
    A, B = _walk(700, 6), _walk(500, 7)
    for band in (4096, 128):
        got = pooled_matrix(A, 24, mwidth=9, mheight=11, B=B, config=_cfg(24, band, band))
        np.testing.assert_allclose(got, brute_force_pooled_matrix(A, 24, mwidth=9,
                                                                  mheight=11, B=B),
                                   rtol=0, atol=TOL)
        ref = mpx_pooled(A, 24, mwidth=9, mheight=11, B=B,
                         config=mpx.MatrixProfileConfig(m=24, band=band, chunk=band))
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_empty_cells_read_floor():
    """A huge exclusion zone leaves the cells near the diagonal empty: -1,
    distance sqrt(4m)."""
    T, m = _walk(64, 8), 32  # excl = 8, w = 33
    got = assert_matches_mpx(T, m, mwidth=33, mheight=33, pearson=True)
    assert got[0, 0] == -1.0
    D = pooled_matrix(T, m, mwidth=33, mheight=33, config=_cfg(m))
    assert D[0, 0] == np.sqrt(4.0 * m)


def test_pair_mask_two_sided():
    """``two_sided`` keeps the pairs below the diagonal of a tile that
    straddles it (|c - r| >= excl); the one-sided mask keeps only c - r >=
    excl.  On a diagonal tile the pooled maxima agree either way once the
    tile is also merged transposed, as the self-join's summary merges it."""
    T, m = _walk(300, 9), 16
    w = T.shape[0] - m + 1
    stats = precompute_statistics(T, m, band=64, chunk=64, dtype="float32", device="cpu")
    geom = band_geometry(64, 64, m, w)
    rows = torch.arange(0, 64, dtype=torch.int32)
    one = pair_mask(stats, rows, rows, geom)
    two = pair_mask(stats, rows, rows, geom, two_sided=True)
    d = rows[None, :] - rows[:, None]
    assert torch.equal(one, d >= m // 4)
    assert torch.equal(two, d.abs() >= m // 4)
    from mpx_torch.kernels.mxu import job_correlations

    P1 = job_correlations(stats, 0, 0, geom, "float32")
    P2 = job_correlations(stats, 0, 0, geom, "float32", two_sided=True)
    assert torch.equal(torch.maximum(P1, P1.T), P2)
    from mpx_torch.distmatrix import _pool_tile

    for pool in (5, 64):
        def pooled(X):
            return _pool_tile(X, 0, 0, pool, pool)

        assert torch.equal(torch.maximum(pooled(P1), pooled(P1.T)), pooled(P2))
        assert torch.equal(pooled(P1.T), pooled(P1).T)


def test_matrix_rejects_bad_arguments():
    T = _walk(200, 10)
    with pytest.raises(ValueError, match="mwidth/mheight"):
        pooled_matrix(T, 16, mwidth=0, config=_cfg(16))
    with pytest.raises(ValueError, match="one kernel"):
        pooled_matrix(T, 16, config=MatrixProfileConfig(m=16, kernel="pallas",
                                                        device="cpu"))
