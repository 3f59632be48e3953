"""The contrast profile of mpx_torch (``mpx_torch.contrast``, on the CPU)
against mpx's ``mpx.contrast`` and the brute-force oracles.

Both joins run in each package (the port's plain sweeps here, K1 on the
card; mpx's hybrid in float64): the two profiles within 1e-8 (float64) /
2e-3 (float32), and CP, a difference of them over sqrt(2m), within the
same.  The host helpers (motif extraction, the pan's best) get the same
inputs and agree exactly.  ``run_contrast_benchmark`` validates its
sampled rows against the float64 row scans.
"""

import numpy as np
import pytest

import mpx
import mpx.contrast as mpx_contrast
from mpx_torch import MatrixProfileConfig, contrast
from mpx_torch.bench import run_contrast_benchmark
from tests.conftest import random_walk

EPS = {"float32": 2e-3, "float64": 1e-8}
M = 32


@pytest.fixture(scope="module")
def pair():
    plus = random_walk(1800, seed=71)
    minus = random_walk(1500, seed=72)
    # a pattern repeated in T+ only, under noise (an exact copy sits at
    # distance ~0, where sqrt turns rounding into ~1e-7 in any f64 tier)
    pat = 3 * np.sin(np.linspace(0, 6 * np.pi, 48))
    noise = np.random.default_rng(70).standard_normal((3, 48)) * 0.05
    for at, e in zip((200, 900, 1500), noise):
        plus[at : at + 48] = plus[at] + pat + e
    return plus, minus


def _cfg(dtype):
    return MatrixProfileConfig(m=M, dtype=dtype, band=256, chunk=512, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_contrast_profile_within_tolerance_of_mpxs(pair, dtype):
    ours = contrast.contrast_profile(*pair, config=_cfg(dtype))
    ref = mpx_contrast.contrast_profile(*pair, config=mpx.MatrixProfileConfig(
        m=M, dtype=dtype, band=256, chunk=512))
    for name in ("cp", "mp_aa", "mp_ab"):
        got = getattr(ours, name)
        assert isinstance(got, np.ndarray) and got.shape == (1800 - M + 1,)
        np.testing.assert_allclose(got.astype(np.float64),
                                   np.asarray(getattr(ref, name), np.float64),
                                   rtol=0, atol=EPS[dtype], err_msg=name)
    if dtype == "float64":
        np.testing.assert_array_equal(ours.mpi_aa, np.asarray(ref.mpi_aa))
        np.testing.assert_array_equal(ours.mpi_ab, np.asarray(ref.mpi_ab))
    # the motif helper on the same result
    assert contrast.top_contrast_motifs(ours, M, k=3) == \
        mpx_contrast.top_contrast_motifs(ours, M, k=3)
    top = contrast.top_contrast_motifs(ours, M, k=1)[0]
    assert any(abs(top.index - at) < 48 for at in (200, 900, 1500))


def test_contrast_profile_matches_the_brute_force(pair):
    ours = contrast.contrast_profile(*pair, config=_cfg("float64")).cp
    np.testing.assert_allclose(ours, contrast.brute_force_contrast_profile(*pair, M),
                               rtol=0, atol=EPS["float64"])
    np.testing.assert_allclose(contrast.brute_force_contrast_profile(*pair, M),
                               mpx_contrast.brute_force_contrast_profile(*pair, M),
                               rtol=0, atol=1e-10)


def test_contrast_from_profiles_gates_equal_mpxs():
    rng = np.random.default_rng(73)
    aa, ab = rng.random(50) * 8, rng.random(50) * 8
    ia, ib = rng.integers(-1, 40, 50), rng.integers(-1, 40, 50)
    aa[3] = np.inf
    np.testing.assert_array_equal(contrast._contrast_from_profiles(aa, ab, ia, ib, 16),
                                  mpx_contrast._contrast_from_profiles(aa, ab, ia, ib, 16))


def test_pan_contrast_and_best_equal_mpxs(pair):
    ms = [24, 32, 24]
    ours = contrast.pan_contrast_profile(*pair, ms, config=_cfg("float64"))
    ref = mpx_contrast.pan_contrast_profile(*pair, ms, config=mpx.MatrixProfileConfig(
        m=M, dtype="float64", band=256, chunk=512))
    assert [m for m, _ in ours] == [m for m, _ in ref] == [24, 32]
    for (_, a), (_, b) in zip(ours, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=EPS["float64"])
    assert contrast.best_contrast(ours) == mpx_contrast.best_contrast(ours)
    m, i, score = contrast.best_contrast(ours)
    assert 0 < score <= 1 and m in (24, 32)


@pytest.mark.parametrize("dtype", ["float64", "double", "float32"])
def test_contrast_benchmark_validates(dtype):
    res = run_contrast_benchmark(2048, M, dtype=dtype, band=256, chunk=512, validate=16,
                                 warmup=False, device="cpu")
    w = 2048 - M + 1
    assert res["pairs"] == w * (w - 1) / 2 + float(w) * w
    assert res["validation"]["rows"] == 16
    assert res["validation"]["max_abs_err"] <= res["validation"]["tol"]
    assert res["validation"]["tol"] == (2e-3 if dtype == "float32" else 1e-8)
    assert res["pairs_per_sec"] > 0


def test_refusals():
    with pytest.raises(ValueError, match="conflicts"):
        contrast.contrast_profile(np.arange(100.0), np.arange(100.0), m=16,
                                  config=_cfg("float64"))
