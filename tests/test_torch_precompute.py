"""mpx_torch statistics and unit windows against mpx.ops.precompute.

Tolerances: the host window mean is mpx's native backend's running mean,
so ``mu`` (and with it ``df`` and ``dg``) agrees bit for bit, and the
staged, padded ``T``, ``mu``, ``df`` and ``dg`` are the same casts, so they
agree exactly too.  ``inv`` and ``qt0`` sum in another order than that
backend's C loop: 1e-14 relative, and 1e-12 of ``m * max(T^2)``, the scale
``qt0``'s prefix form cancels from; staged in float32 they may round one
float32 step apart.  The window matrix is built on each package's device
from the staged vectors: within 1e-12 (float64) and 1e-6 (float32).
"""

import numpy as np
import pytest
import torch

from mpx import native as mpx_native
from mpx.ops.precompute import precompute_statistics as mpx_precompute
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
                       backend="native", windows=True)
    return {f: np.asarray(getattr(s, f)) for f in FIELDS + ("windows",)}


def _assert_inv_qt0(ours_inv, ours_qt0, ref_inv, ref_qt0, T, m, rtol=0.0):
    np.testing.assert_array_equal(np.isfinite(ours_inv), np.isfinite(ref_inv))
    live = np.isfinite(ref_inv)
    np.testing.assert_allclose(ours_inv[live], ref_inv[live], rtol=1e-14 + rtol, atol=0)
    np.testing.assert_allclose(ours_qt0, ref_qt0, rtol=rtol,
                               atol=1e-12 * m * np.max(T * T))


@pytest.mark.parametrize("kind", ["walk", "constant-run", "1024"])
@pytest.mark.parametrize("m", [16, 100])
def test_host_statistics_exact(kind, m):
    T = _series(kind)
    ours = precompute_statistics_numpy(T, m)
    ref = mpx_native.precompute(T, m)
    for name in ("mu", "df", "dg"):
        np.testing.assert_array_equal(ours[name], ref[name], err_msg=name)
    _assert_inv_qt0(ours["inv"], ours["qt0"], ref["inv"], ref["qt0"], T, m)


@pytest.mark.parametrize("kind", ["walk", "constant-run", "1024"])
@pytest.mark.parametrize("m", [16, 100])
def test_running_mean_keeps_recurrence_identity(kind, m):
    """The recurrence assumes mu[i] - mu[i-1] = 2 df[i] / m; the running
    mean keeps it to one rounding of mu per step (a difference of prefix
    sums misses it by hundreds of those on these series)."""
    T = _series(kind)
    s = precompute_statistics_numpy(T, m)
    mu = s["mu"]
    step = np.diff(mu) - 2 * s["df"][1:] / m
    bound = np.finfo(np.float64).eps * np.maximum(np.abs(mu[1:]), np.abs(mu[:-1]))
    assert np.all(np.abs(step) <= bound)


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
        assert getattr(ours, name).numpy().dtype == ref[name].dtype, name
    for name in ("T", "mu", "df", "dg"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), ref[name], err_msg=name)
    f32_step = np.finfo(np.float32).eps if dtype == "float32" else 0.0
    _assert_inv_qt0(ours.inv.numpy().astype(np.float64), ours.qt0.numpy().astype(np.float64),
                    ref["inv"].astype(np.float64), ref["qt0"].astype(np.float64),
                    T, m, rtol=f32_step)
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


def test_precompute_statistics_defaults_to_the_card():
    """Like every entry point of the port, the statistics run on the card
    unless the caller asks for the CPU: the default device is CUDA, and
    without a card a call that names no device fails instead of staging
    on the CPU."""
    import inspect

    default = inspect.signature(precompute_statistics).parameters["device"].default
    assert torch.device(default).type == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            precompute_statistics(random_walk(200, seed=3), 16, band=64, chunk=64)
