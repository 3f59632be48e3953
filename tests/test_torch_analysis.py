"""The analysis helpers of mpx_torch (``mpx_torch.analysis``, on the CPU)
against mpx's ``mpx.analysis``.

The host helpers get the same numpy inputs as mpx's and must agree
exactly (motifs, discords, annotation vectors, chains, MPdist from
profiles) or within 1e-10 (MASS, whose statistics are computed apart;
at a self-match, where the distance is ~0, its square).
``mpdist`` runs each package's AB-join: within 1e-8 (float64) / 2e-3
(float32).  And ``mpx_torch.__all__`` covers ``mpx.__all__``.
"""

import numpy as np
import pytest
import torch

import mpx
import mpx.analysis as mpx_analysis
import mpx_torch
from mpx_torch import MatrixProfileConfig, analysis, compute_matrix_profile
from tests.conftest import random_walk

EPS = {"float32": 2e-3, "float64": 1e-8}
M = 32


@pytest.fixture(scope="module")
def walk():
    T = random_walk(2500, seed=53)
    T[1200:1264] = T[300:364] + 0.01 * np.sin(np.arange(64))  # a motif
    T[2000:2040] += 6 * np.random.default_rng(54).standard_normal(40)  # a discord
    return T


@pytest.fixture(scope="module")
def profile(walk):
    MP, MPI = compute_matrix_profile(walk, config=MatrixProfileConfig(
        m=M, dtype="float64", band=256, chunk=512, device="cpu"))
    return MP.numpy(), MPI.numpy()


def test_all_covers_mpxs():
    assert set(mpx.__all__) <= set(mpx_torch.__all__), \
        sorted(set(mpx.__all__) - set(mpx_torch.__all__))


@pytest.mark.parametrize("k", [1, 3, 8])
def test_motifs_and_discords_equal_mpxs(profile, k):
    MP, MPI = profile
    assert analysis.top_motifs(MP, MPI, M, k=k) == mpx_analysis.top_motifs(MP, MPI, M, k=k)
    assert analysis.top_discords(MP, MPI, M, k=k) == mpx_analysis.top_discords(MP, MPI, M, k=k)
    # tensors are accepted too
    assert analysis.top_motifs(torch.as_tensor(MP), torch.as_tensor(MPI), M, k=k) \
        == mpx_analysis.top_motifs(MP, MPI, M, k=k)


def test_planted_motif_and_discord_are_found(profile):
    MP, MPI = profile
    a, b, _ = analysis.top_motifs(MP, MPI, M, k=1)[0]
    assert abs(a - 300) < 32 and abs(b - 1200) < 32
    assert abs(analysis.top_discords(MP, MPI, M, k=1)[0].index - 2000) < 64


@pytest.mark.parametrize("mode", ["motif", "discord"])
def test_annotation_vectors_equal_mpxs(walk, profile, mode):
    MP, _ = profile
    AV = analysis.complexity_annotation(walk, M)
    np.testing.assert_array_equal(AV, mpx_analysis.complexity_annotation(walk, M))
    np.testing.assert_array_equal(analysis.apply_annotation_vector(MP, AV, mode=mode),
                                  mpx_analysis.apply_annotation_vector(MP, AV, mode=mode))
    np.testing.assert_array_equal(analysis.complexity_annotation(np.ones(100), 8),
                                  np.ones(93))
    for bad, match in ((AV[:-1], "shape"), (AV + 2, r"\[0, 1\]")):
        with pytest.raises(ValueError, match=match):
            analysis.apply_annotation_vector(MP, bad, mode=mode)
    with pytest.raises(ValueError, match="mode"):
        analysis.apply_annotation_vector(MP, AV, mode="x")


def test_chains_equal_mpxs(walk):
    out = compute_matrix_profile(walk, config=MatrixProfileConfig(
        m=M, dtype="float64", band=256, chunk=512, device="cpu"), left_right=True)
    il, ir = out[1].numpy(), out[3].numpy()
    assert analysis.all_chains(il, ir) == mpx_analysis.all_chains(il, ir)
    np.testing.assert_array_equal(analysis.unanchored_chain(il, ir),
                                  mpx_analysis.unanchored_chain(il, ir))


@pytest.mark.parametrize("threshold", [0.01, 0.05, 0.5, 2.0])
def test_mpdist_from_profiles_equals_mpxs(threshold):
    rng = np.random.default_rng(59)
    a, b = rng.random(400), rng.random(300)
    b[::7] = np.inf
    assert analysis.mpdist_from_profiles(a, b, 431, 331, threshold) == \
        mpx_analysis.mpdist_from_profiles(a, b, 431, 331, threshold)
    assert analysis.mpdist_from_profiles(np.full(3, np.inf), np.full(2, np.inf), 9, 8) \
        == float("inf")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mpdist_within_tolerance_of_mpxs(dtype):
    A, B = random_walk(1200, seed=61), random_walk(900, seed=62)
    B[100:200] = A[500:600]
    got = analysis.mpdist(A, B, M, config=MatrixProfileConfig(
        m=M, dtype=dtype, band=256, chunk=512, device="cpu"))
    exp = mpx_analysis.mpdist(A, B, M, config=mpx.MatrixProfileConfig(
        m=M, dtype=dtype, band=256, chunk=512))
    assert abs(got - exp) <= EPS[dtype], (got, exp)


def assert_mass_close(got, exp, tol=1e-10):
    """MASS profiles within ``tol``: squared distances everywhere, and
    distances where they are not ~0 (a window matched against itself is
    at the square root of a rounding error, ~1e-7, in either package)."""
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(exp))
    fin = np.isfinite(exp)
    g, e = got[fin], exp[fin]
    np.testing.assert_allclose(g * g, e * e, rtol=0, atol=tol)
    far = e > 1e-3
    np.testing.assert_allclose(g[far], e[far], rtol=0, atol=tol)


@pytest.mark.parametrize("method", ["auto", "fft", "direct"])
@pytest.mark.parametrize("normalize", [True, False])
def test_mass_within_1e10_of_mpxs(walk, method, normalize):
    T = walk.copy()
    T[700:760] = T[700]  # flat windows: +inf z-normalized
    Q = walk[1200:1240]
    got = analysis.mass(Q, T, method=method, normalize=normalize)
    exp = mpx_analysis.mass(Q, T, method=method, normalize=normalize)
    assert got.dtype == np.float64 and got.shape == (T.shape[0] - 39,)
    assert_mass_close(got, exp)


def test_mass_refusals_match_mpxs(walk):
    for fn in (analysis.mass, mpx_analysis.mass):
        with pytest.raises(ValueError, match="zero variance"):
            fn(np.ones(16), walk)
        with pytest.raises(ValueError, match="at least 4"):
            fn(walk[:3], walk)
        with pytest.raises(ValueError, match="shorter"):
            fn(walk[:64], walk[:32])
        with pytest.raises(ValueError, match="unknown method"):
            fn(walk[:16], walk, method="x")


@pytest.mark.parametrize("kwargs", [{}, {"max_matches": 2}, {"max_distance": 3.0}])
def test_match_equals_mpxs(walk, kwargs):
    Q = walk[300:364]
    got, D = analysis.match(Q, walk, return_profile=True, **kwargs)
    exp, Dx = mpx_analysis.match(Q, walk, return_profile=True, **kwargs)
    assert [g.index for g in got] == [e.index for e in exp]
    np.testing.assert_allclose([g.distance for g in got], [e.distance for e in exp],
                               rtol=0, atol=1e-10)
    assert got and got[0].index == 300 and got[0].distance < 1e-6
    assert_mass_close(D, Dx)
    assert analysis.match(Q, walk, **kwargs) == got
