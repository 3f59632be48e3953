"""mpx_torch statistics and unit windows against mpx.ops.precompute.

Tolerances: the host window mean is mpx's native backend's running mean,
on every backend (``numpy``, ``native``, ``device``), so ``mu`` (and with
it ``df`` and ``dg``) agrees bit for bit with that backend's, and the
staged, padded ``T``, ``mu``, ``df`` and ``dg`` are the same casts, so they
agree exactly too.  ``inv`` and ``qt0`` sum in another order than that
backend's C loop: 1e-14 relative, and 1e-12 of ``m * max(T^2)``, the scale
``qt0``'s prefix form cancels from; staged in float32 they may round one
float32 step apart.  The window matrix is built on each package's device
from the staged vectors: within 1e-12 (float64) and 1e-6 (float32).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from mpx import native as mpx_native
from mpx.ops.precompute import precompute_statistics as mpx_precompute
from mpx_torch.kernels.stats import window_stats_cuda, window_stats_torch
from mpx_torch.ops.precompute import (
    build_windows,
    host_statistics,
    precompute_statistics,
    precompute_statistics_numpy,
    resolve_backend,
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
    if kind == "tanh-step":
        t = np.arange(1024.0)
        return 1000 + np.tanh((t - 512) / 80) + 1e-3 * np.sin(t / 11)
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


# ------------------------------------------------------------ the backends
SERIES = ["walk", "constant-run", "1024", "tanh-step"]
PORT_BACKENDS = ["numpy", "native", "device"]


def _mpx_stats64(T, m, backend, matmul_only=False) -> dict:
    """mpx's float64 statistics of the unpadded windows on ``backend``."""
    s = mpx_precompute(T, m, band=64, chunk=64, dtype=np.float64, backend=backend,
                       windows=False, matmul_only=matmul_only)
    w = T.shape[0] - m + 1
    return {f: np.asarray(getattr(s, f))[:w] for f in ("mu", "df", "dg", "inv", "qt0")}


@pytest.mark.parametrize("kind", SERIES)
@pytest.mark.parametrize("m", [16, 100])
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_backends_against_mpx(backend, kind, m):
    """Each backend (``device`` through the kernel's plain version here)
    against mpx's ``native`` and ``jax`` backends: ``mu``, ``df`` and
    ``dg`` bit-equal to native's (mpx's ``jax`` backend takes a
    prefix-sum mean instead, so there only ``inv`` and ``qt0`` are held),
    ``inv`` within 1e-14 relative with the same zero-variance windows,
    ``qt0`` within 1e-12 of ``m * max(T^2)``."""
    T = _series(kind)
    ours = host_statistics(T, m, backend=backend, device="cpu")
    for ref_backend in ("native", "jax"):
        ref = _mpx_stats64(T, m, ref_backend)
        if ref_backend == "native":
            for name in ("mu", "df", "dg"):
                np.testing.assert_array_equal(ours[name], ref[name], err_msg=name)
        _assert_inv_qt0(ours["inv"], ours["qt0"], ref["inv"], ref["qt0"], T, m)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_matmul_only_zero_fill_as_mpx(backend, dtype):
    """``matmul_only`` stages ``T``, ``mu`` and ``inv`` and zero-fills
    ``df``, ``dg`` and ``qt0``, as mpx does."""
    T = _series("constant-run")
    m, band, chunk = 32, 256, 512
    ours = precompute_statistics(T, m, band=band, chunk=chunk, dtype=dtype, device="cpu",
                                 backend=backend, matmul_only=True, windows=False)
    ref = mpx_precompute(T, m, band=band, chunk=chunk, dtype=dtype, backend="native",
                         windows=False, matmul_only=True)
    for name in ("df", "dg", "qt0"):
        assert not np.asarray(getattr(ref, name)).any()
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)))
    for name in ("T", "mu"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)))
    inv, ref_inv = ours.inv.numpy().astype(np.float64), np.asarray(ref.inv, np.float64)
    np.testing.assert_array_equal(np.isfinite(inv), np.isfinite(ref_inv))
    live = np.isfinite(ref_inv)
    f32_step = np.finfo(np.float32).eps if dtype == "float32" else 0.0
    np.testing.assert_allclose(inv[live], ref_inv[live], rtol=1e-14 + f32_step, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("exact_mean", [False, True])
@pytest.mark.parametrize("kind", ["constant-run", "tanh-step"])
def test_device_backend_stages_as_the_host_backends(kind, exact_mean, dtype):
    """``precompute_statistics(backend='device')`` stages on the device
    what the host backends stage from numpy: ``T``, ``mu``, ``df`` and
    ``dg`` equal to the numpy backend's without the correction (within
    1e-14 of max |T| with it), ``inv`` and ``qt0`` to rounding, the window
    matrix within the window tolerance."""
    T = _series(kind)
    m, band, chunk = 16, 128, 256
    kw = dict(band=band, chunk=chunk, dtype=dtype, device="cpu", exact_mean=exact_mean)
    dev = precompute_statistics(T, m, backend="device", **kw)
    ref = precompute_statistics(T, m, backend="numpy", **kw)
    for name in FIELDS:
        assert getattr(dev, name).dtype == getattr(ref, name).dtype
        assert getattr(dev, name).shape == getattr(ref, name).shape
    f32_step = np.finfo(np.float32).eps if dtype == "float32" else 0.0
    np.testing.assert_array_equal(dev.T.numpy(), ref.T.numpy())
    for name in ("mu", "df", "dg"):
        a, b = getattr(dev, name).numpy(), getattr(ref, name).numpy()
        if exact_mean:
            np.testing.assert_allclose(a, b, rtol=f32_step, atol=1e-14 * np.max(np.abs(T)),
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    _assert_inv_qt0(dev.inv.numpy().astype(np.float64), dev.qt0.numpy().astype(np.float64),
                    ref.inv.numpy().astype(np.float64), ref.qt0.numpy().astype(np.float64),
                    T, m, rtol=f32_step)
    np.testing.assert_allclose(dev.windows.numpy(), ref.windows.numpy(), rtol=0,
                               atol=WINDOW_TOL[dtype])


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_matmul_only_keeps_mu_and_inv(backend):
    T = _series("tanh-step")
    full = host_statistics(T, 16, backend=backend, device="cpu")
    only = host_statistics(T, 16, backend=backend, device="cpu", matmul_only=True)
    np.testing.assert_array_equal(only["mu"], full["mu"])
    for name in ("df", "dg", "qt0"):
        assert only[name].shape == full[name].shape and not only[name].any()
    if backend == "native":  # precompute_stats: another summation order
        np.testing.assert_allclose(only["inv"], full["inv"], rtol=1e-14, atol=0)
    else:
        np.testing.assert_array_equal(only["inv"], full["inv"])


@pytest.mark.parametrize("kind", SERIES)
@pytest.mark.parametrize("m", [16, 100])
def test_exact_mean_numpy_and_device_agree(kind, m):
    """The corrected mean on ``numpy`` and ``device``: the residuals sum
    in another order, so ``mu`` and ``dg`` agree within 1e-14 of max |T|,
    ``qt0`` within its tolerance, ``inv`` exactly as without the
    correction."""
    T = _series(kind)
    a = host_statistics(T, m, backend="numpy", device="cpu", exact_mean=True)
    d = host_statistics(T, m, backend="device", device="cpu", exact_mean=True)
    scale = np.max(np.abs(T))
    for name in ("mu", "dg"):
        np.testing.assert_allclose(d[name], a[name], rtol=0, atol=1e-14 * scale, err_msg=name)
    np.testing.assert_array_equal(d["df"], a["df"])
    _assert_inv_qt0(d["inv"], d["qt0"], a["inv"], a["qt0"], T, m)
    np.testing.assert_array_equal(
        d["inv"], host_statistics(T, m, backend="device", device="cpu")["inv"])


def test_backend_refusals():
    T = _series("walk")
    with pytest.raises(ValueError, match="'device'"):
        host_statistics(T, 16, backend="jax", device="cpu")
    with pytest.raises(ValueError, match="'device'"):
        precompute_statistics(T, 16, band=64, chunk=64, device="cpu", backend="jax")
    with pytest.raises(ValueError, match="exact_mean"):
        host_statistics(T, 16, backend="native", device="cpu", exact_mean=True)
    with pytest.raises(ValueError, match="unknown precompute backend"):
        host_statistics(T, 16, backend="gpu", device="cpu")
    with pytest.raises(ValueError, match="m must be"):
        host_statistics(T, 3, backend="native", device="cpu")


def test_auto_resolves_from_the_device():
    """``auto`` is ``numpy`` on the CPU (no CPU number moves) and
    ``device`` on a CUDA device, whatever builds."""
    assert resolve_backend("auto", "cpu") == "numpy"
    assert resolve_backend("auto", torch.device("cuda", 0)) == "device"
    assert resolve_backend("native", "cuda") == "native"
    T = _series("1024")
    auto = host_statistics(T, 16, device="cpu")
    for name, x in precompute_statistics_numpy(T, 16).items():
        np.testing.assert_array_equal(auto[name], x, err_msg=name)


@pytest.mark.parametrize("m", [5, 16, 100])
def test_window_stats_plain_version(m):
    """The kernel's wrapper on CPU tensors is its plain version: ``inv``
    as the numpy backend's, ``qt0`` the centered first-row product
    (native's), the residuals ``sum_k (T[i+k] - mu[i])``."""
    T = _series("constant-run")[:1500]
    ref = mpx_native.precompute(T, m)
    Tt, mut = torch.as_tensor(T), torch.as_tensor(ref["mu"])
    inv, qt0, resid = window_stats_cuda(Tt, mut, m, qt0=True, resid=True)
    plain = window_stats_torch(Tt, mut, m, qt0=True, resid=True)
    for a, b in zip((inv, qt0, resid), plain):
        assert torch.equal(a, b)
    _assert_inv_qt0(inv.numpy(), qt0.numpy(), ref["inv"], ref["qt0"], T, m)
    cent = np.lib.stride_tricks.sliding_window_view(T, m) - ref["mu"][:, None]
    np.testing.assert_allclose(resid.numpy(), cent.sum(1), rtol=0,
                               atol=1e-13 * m * np.max(np.abs(T)))
    inv_only = window_stats_cuda(Tt, mut, m)
    assert inv_only[1] is None and inv_only[2] is None and torch.equal(inv_only[0], inv)
    with pytest.raises(ValueError, match="float64"):
        window_stats_cuda(Tt.float(), mut, m)
    with pytest.raises(ValueError, match="window means"):
        window_stats_cuda(Tt, mut[:-1], m)


def test_kernel_library_covers_the_stats_source(tmp_path, monkeypatch):
    """The kernel build globs ``csrc/*.cu``: the window statistics source
    is the third, and the library's name (a hash of every source) changes
    with it."""
    from mpx_torch.kernels import _build

    sources = _build._sources()
    assert [os.path.basename(p) for p in sources] == [
        "band_recurrence.cu", "mxu_fused.cu", "precompute.cu"]
    full = _build.library_path()
    for src in sources[:2]:
        shutil.copy(src, tmp_path)
    monkeypatch.setattr(_build, "_CSRC", str(tmp_path))
    assert _build.library_path() != full
