"""mpx_torch statistics and unit windows against mpx.ops.precompute.

Tolerances: the host statistics run the same float64 numpy code in both
packages, so they must agree exactly; the staged, padded vectors are the
same casts, so they agree exactly too.  The window matrix is built on
each package's device from those staged vectors: within 1e-12 (float64)
and 1e-6 (float32).
"""

import numpy as np
import pytest
import torch

from mpx.ops.precompute import precompute_statistics as mpx_precompute
from mpx.ops.precompute import precompute_statistics_numpy as mpx_stats_numpy
from mpx_torch.ops.precompute import (
    build_windows,
    precompute_statistics,
    precompute_statistics_numpy,
    stats_from_numpy,
)
from tests.conftest import random_walk

WINDOW_TOL = {"float64": 1e-12, "float32": 1e-6}
FIELDS = ("T", "mu", "df", "dg", "inv", "qt0")


def _series(kind: str) -> np.ndarray:
    if kind == "walk":
        return random_walk(3000, seed=5)
    if kind == "constant-run":
        T = random_walk(3000, seed=6)
        T[1200:1400] = T[1200]
        return T
    return np.loadtxt("data/test/1024.txt")


def _mpx_arrays(T, m, band, chunk, dtype) -> dict:
    s = mpx_precompute(T, m, band=band, chunk=chunk, dtype=dtype,
                       backend="numpy", windows=True)
    return {f: np.asarray(getattr(s, f)) for f in FIELDS + ("windows",)}


@pytest.mark.parametrize("kind", ["walk", "constant-run", "1024"])
@pytest.mark.parametrize("m", [16, 100])
def test_host_statistics_exact(kind, m):
    T = _series(kind)
    ours = precompute_statistics_numpy(T, m)
    ref = mpx_stats_numpy(T, m)
    for name in ("mu", "df", "dg", "inv", "qt0"):
        np.testing.assert_array_equal(ours[name], ref[name], err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind,m,band,chunk", [
    ("walk", 32, 256, 512),
    ("constant-run", 64, 128, 1024),
    ("1024", 16, 4096, 16384),
])
def test_staged_stats_and_windows(kind, m, band, chunk, dtype):
    T = _series(kind)
    ours = precompute_statistics(T, m, band=band, chunk=chunk, dtype=dtype,
                                 device="cpu")
    ref = _mpx_arrays(T, m, band, chunk, dtype)
    for name in FIELDS:
        got = getattr(ours, name).numpy()
        assert got.dtype == ref[name].dtype, name
        np.testing.assert_array_equal(got, ref[name], err_msg=name)
    U = ours.windows.numpy()
    assert U.shape == ref["windows"].shape
    np.testing.assert_allclose(U, ref["windows"], rtol=0, atol=WINDOW_TOL[dtype])
    # Zero-variance and padded windows are zero rows.
    dead = ~np.isfinite(ref["inv"]) | (np.arange(U.shape[0]) >= T.shape[0] - m + 1)
    assert not U[dead].any()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_stats_from_numpy_carries_mpx_stats(dtype):
    T = _series("constant-run")
    m, band, chunk = 32, 256, 512
    ref = _mpx_arrays(T, m, band, chunk, dtype)
    with_windows = stats_from_numpy(ref, dtype, "cpu")
    np.testing.assert_array_equal(with_windows.windows.numpy(), ref["windows"])
    no_windows = stats_from_numpy({k: v for k, v in ref.items() if k != "windows"},
                                  dtype, "cpu")
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(no_windows, name).numpy(), ref[name])
    np.testing.assert_allclose(no_windows.windows.numpy(), ref["windows"],
                               rtol=0, atol=WINDOW_TOL[dtype])
    assert no_windows.windows.dtype == (torch.float64 if dtype == "float64"
                                        else torch.float32)


def test_build_windows_matches_definition():
    """Row i of the window matrix is (T[i:i+m] - mu[i]) * inv[i], in f64."""
    T = random_walk(700, seed=9)
    m = 24
    stats = precompute_statistics(T, m, band=64, chunk=64, dtype="float64",
                                  device="cpu")
    U = build_windows(stats, m).numpy()
    w = T.shape[0] - m + 1
    s = precompute_statistics_numpy(T, m)
    expect = (np.lib.stride_tricks.sliding_window_view(T, m) - s["mu"][:, None]) \
        * s["inv"][:, None]
    np.testing.assert_allclose(U[:w], expect, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.linalg.norm(U[:w], axis=1), 1.0, atol=1e-12)
