"""O(n) precomputation of SCAMP statistics, counterpart of
``mpx/ops/precompute.py``.

The statistics are float64: the window mean is mpx's native backend's
running mean, on the host for every backend, and the O(n·m) sums (the
two-pass sum of squares behind ``inv``, ``qt0``'s first-row products,
the corrected mean's residuals) run on the backend the caller chooses
(:func:`host_statistics`: ``numpy``, the host C++ library ``native``, or
the card's window statistics kernel ``device``; ``auto`` takes ``device``
on a CUDA device and ``numpy`` on the CPU).  They are then cast to the
compute dtype, zero-padded and staged on the device.  The unit-window
matrix that the sweep kernels read is built on the device in the compute
dtype, exactly as mpx builds it, when the sweep kernel reads it
(``windows=True``: K1 and its plain version; the recurrence tier reads
only ``T, mu, df, dg, inv``, and takes a corrected window mean,
``exact_mean=True``).
"""

from __future__ import annotations

import numpy as np
import torch

from mpx_torch.dtypes import full_precision_matmul, torch_dtype
from mpx_torch.types import Stats
from mpx_torch.utils.profile import span

# A window's centered sum-of-squares below REL * (its raw sum-of-squares)
# is numerically indistinguishable from a constant subsequence; those
# windows get inv = inf and every kernel masks them.
ZERO_VARIANCE_REL = 1e-10

_WINDOWS_BLOCK = 8192
# Bytes of a materialized block of windows: the host's centered block
# (float64) and the window copy of one block of sliding_dot_product.
_BLOCK_BYTES = 128 << 20

BACKENDS = ("auto", "numpy", "native", "device")
# What ``auto`` takes on a CUDA device: the backend that chip_smoke.py's
# phase 51 measures fastest there (the whole precompute_statistics at
# n = 2^20, m = 256 and n = 2^18, m = 4096).  It depends on the device
# alone, never on whether a library builds.
CUDA_AUTO_BACKEND = "device"


def _padded_width(w: int, band: int, chunk: int) -> int:
    """Pad the subsequence count so every job's panel slice is in bounds
    (a job reads rows up to w - 1 + band and columns up to
    w - 1 + chunk), rounded up to 8192 like mpx."""
    pw = int(w + band + chunk)
    return ((pw + _WINDOWS_BLOCK - 1) // _WINDOWS_BLOCK) * _WINDOWS_BLOCK


def _check_series(n: int, m: int) -> int:
    if m < 4:
        raise ValueError("m must be >= 4")
    if n < m:
        raise ValueError("n must be >= m")
    return n - m + 1


def _running_mean(T: np.ndarray, m: int) -> np.ndarray:
    """The reference's running mean ``mu[i] = mu[i-1] + (T[i+m-1] -
    T[i-1]) / m``: sequential sums (np.cumsum) in the native loop's order,
    so bit for bit mpx native's ``mu``."""
    w = T.shape[0] - m + 1
    steps = np.concatenate([[np.cumsum(T[:m])[-1] / m], (T[m:] - T[:w - 1]) / m])
    return np.cumsum(steps)


def _df_dg(T: np.ndarray, mu: np.ndarray, m: int):
    w = mu.shape[0]
    df = np.zeros(w, dtype=np.float64)
    dg = np.zeros(w, dtype=np.float64)
    df[1:] = (T[m:] - T[:w - 1]) / 2
    dg[1:] = (T[m:] - mu[1:]) + (T[:w - 1] - mu[:w - 1])
    return df, dg


def precompute_statistics_numpy(T: np.ndarray, m: int, *, exact_mean: bool = False,
                                matmul_only: bool = False) -> dict:
    """Float64 statistics of an unpadded series (host-side, BLAS).

    The window mean is the reference's running mean
    (``mu[i] = mu[i-1] + (T[i+m-1] - T[i-1]) / m``), bit for bit what
    mpx's default, native backend computes; so are ``df``, ``dg``,
    ``inv`` and ``qt0``.  The windows-matmul tiers read only ``mu`` and
    ``inv``, and the running mean's drift from the exact window mean
    (~5e-10 on a unit-step walk at level 1e5) costs them nothing
    measurable.  ``matmul_only`` computes only those two and zero-fills
    ``df``, ``dg`` and ``qt0``.

    ``exact_mean`` is for the recurrence tier (``xla`` and ``pallas``),
    whose update ``df[i] dg[j] + df[j] dg[i]`` integrates any error of
    ``dg`` along a diagonal: a drifting mean there misses 1e-8 on
    distances.  It corrects each window's mean by one more reduction of
    the centered block that the sum of squares materializes anyway,
    ``mu + sum(T[i:i+m] - mu) / m`` (within about one ulp of the exact
    mean), and builds ``dg`` and ``qt0`` from it.  The recurrence's seed
    does not read ``qt0`` (:func:`mpx_torch.kernels.common.seed_qt`
    recomputes it per job); it is rebuilt only so the fields agree.
    ``inv``, and with it the zero-variance classification, is the same
    with or without the correction, so every tier masks the same
    windows."""
    T = np.asarray(T, dtype=np.float64)
    w = _check_series(T.shape[0], m)
    mu = _running_mean(T, m)

    # Two-pass centered sum-of-squares: the same estimator as mpx's native
    # and streaming paths, so the zero-variance classification agrees.
    windows = np.lib.stride_tricks.sliding_window_view(T, m)
    ssq = np.empty(w, dtype=np.float64)
    sumsq = np.empty(w, dtype=np.float64)
    resid = np.empty(w, dtype=np.float64) if exact_mean else None
    blk = max(1, _BLOCK_BYTES // (8 * m))
    for o in range(0, w, blk):
        wv = windows[o : o + blk]
        cent = wv - mu[o : o + blk, None]
        ssq[o : o + blk] = np.einsum("ij,ij->i", cent, cent)
        sumsq[o : o + blk] = np.einsum("ij,ij->i", wv, wv)
        if exact_mean:
            resid[o : o + blk] = cent.sum(axis=1)
    ssq = np.where(ssq <= ZERO_VARIANCE_REL * np.abs(sumsq), 0.0, ssq)
    with np.errstate(divide="ignore"):
        inv = 1.0 / np.sqrt(ssq)
    if exact_mean:
        mu = mu + resid / m
    if matmul_only:
        return _zero_filled({"mu": mu, "inv": inv})

    df, dg = _df_dg(T, mu, m)
    sdp0 = windows @ T[:m]
    qt0 = sdp0 - m * mu[0] * mu

    return {"mu": mu, "df": df, "dg": dg, "inv": inv, "qt0": qt0}


def _zero_filled(s: dict) -> dict:
    """``mu`` and ``inv`` with ``df``, ``dg`` and ``qt0`` zero-filled (the
    windows-matmul operands alone, as mpx's ``matmul_only``)."""
    zero = np.zeros_like(s["mu"])
    return {"mu": s["mu"], "df": zero, "dg": zero, "inv": s["inv"], "qt0": zero}


def resolve_backend(backend: str, device) -> str:
    """The statistics backend that ``backend`` names on ``device``:
    ``auto`` is :data:`CUDA_AUTO_BACKEND` on a CUDA device and ``numpy``
    elsewhere."""
    if backend == "jax":
        raise ValueError("backend='jax' is mpx's on-device backend; the port's "
                         "counterpart is backend='device'")
    if backend not in BACKENDS:
        raise ValueError(f"unknown precompute backend {backend!r}; one of {BACKENDS}")
    if backend != "auto":
        return backend
    return CUDA_AUTO_BACKEND if torch.device(device).type == "cuda" else "numpy"


def _window_sums(T: np.ndarray, m: int, device, *, matmul_only: bool,
                 exact_mean: bool):
    """The ``device`` backend's O(n·m) sums: the running mean on the host as
    :func:`precompute_statistics_numpy` computes it, ``T`` and the mean to
    ``device``, the window statistics kernel there (its plain version on
    the CPU).  Under ``exact_mean`` the mean is corrected by the kernel's
    residuals on the host, as the numpy backend corrects it, and ``qt0``
    moves with it: with ``r`` the residuals, the centered product about
    the corrected means is ``qt0 - r[i] r[0] / m``.  Returns (mu as numpy,
    then ``T``, ``inv`` and ``qt0`` (None under ``matmul_only``) as float64
    tensors on ``device``)."""
    from mpx_torch.kernels.stats import window_stats_cuda

    _check_series(T.shape[0], m)
    with span("statistics.host"):
        mu = _running_mean(T, m)
    with span("statistics.window_sums"):
        dev = torch.device(device)
        Tt = torch.as_tensor(T, device=dev)
        inv, qt0, resid = window_stats_cuda(Tt, torch.as_tensor(mu, device=dev), m,
                                            qt0=not matmul_only, resid=exact_mean)
        if exact_mean:
            r = resid.cpu().numpy()
            mu = mu + r / m
            if qt0 is not None:
                qt0 = qt0 - resid * (r[0] / m)
    return mu, Tt, inv, qt0


def host_statistics(T, m: int, *, backend: str = "auto", matmul_only: bool = False,
                    exact_mean: bool = False, device="cuda") -> dict:
    """Float64 statistics of an unpadded series as numpy arrays (``mu``,
    ``df``, ``dg``, ``inv``, ``qt0``), with mpx's backend names:

    * ``'numpy'``  -- :func:`precompute_statistics_numpy` on the host;
    * ``'native'`` -- the host C++ library (:mod:`mpx_torch.native`):
      ``precompute``, or ``precompute_stats`` under ``matmul_only``.  It
      has no corrected mean, so ``exact_mean`` raises;
    * ``'device'`` -- the window statistics kernel on ``device``
      (:func:`_window_sums`), copied back: mpx's ``'jax'`` backend's
      counterpart;
    * ``'auto'``   -- ``device`` on a CUDA device (:data:`CUDA_AUTO_BACKEND`,
      the measured fastest there) and ``numpy`` elsewhere: the choice
      depends on the device alone, never on whether a library builds.

    Every backend computes the same running mean, ``df`` and ``dg`` (bit
    for bit); ``inv`` and ``qt0`` agree to rounding (1e-14 relative at m
    up to 100, at most m 2^-53 beyond, and 1e-12 of ``m * max(T^2)``),
    with the same zero-variance windows.
    ``matmul_only`` computes ``mu`` and ``inv`` alone (the windows-matmul
    tiers' operands) and zero-fills the rest, skipping ``qt0``'s O(n·m)
    product."""
    T = np.asarray(T, dtype=np.float64)
    backend = resolve_backend(backend, device)
    if backend == "numpy":
        return precompute_statistics_numpy(T, m, exact_mean=exact_mean,
                                           matmul_only=matmul_only)
    if backend == "device":
        mu, _, inv, qt0 = _window_sums(T, m, device, matmul_only=matmul_only,
                                       exact_mean=exact_mean)
        if matmul_only:
            return _zero_filled({"mu": mu, "inv": inv.cpu().numpy()})
        df, dg = _df_dg(T, mu, m)
        return {"mu": mu, "df": df, "dg": dg, "inv": inv.cpu().numpy(),
                "qt0": qt0.cpu().numpy()}
    if exact_mean:
        raise ValueError("backend='native' has no corrected window mean (exact_mean); "
                         "use 'numpy' or 'device'")
    from mpx_torch import native

    _check_series(T.shape[0], m)
    if matmul_only:
        return _zero_filled(native.precompute_stats(T, m))
    return native.precompute(T, m)


def sliding_dot_product(q: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """SDP(c) = sum_k q[k] * T[c+k] for c in [0, len(T) - m + 1), m = len(q).

    A plain matrix product of the sliding windows:
    mpx lowers it as a convolution at ``Precision.HIGHEST``; here a float32
    convolution would run in TF32 through cuDNN, and the seed that uses
    this cancels later, so it stays a matmul in full precision.  The
    product copies the overlapping window view, so it runs in blocks of
    ``_BLOCK_BYTES``."""
    U = T.unfold(0, q.shape[0], 1)
    blk = max(1, _BLOCK_BYTES // (U.shape[1] * U.element_size()))
    with full_precision_matmul():
        if U.shape[0] <= blk:
            return U @ q
        return torch.cat([U[o : o + blk] @ q for o in range(0, U.shape[0], blk)])


def build_windows(stats: Stats, m: int, dtype=None) -> torch.Tensor:
    """Unit-normalized window matrix (padded_w, m) on the stats' device:
    ``(T[i:i+m] - mu[i]) * inv[i]``, with zero rows for zero-variance
    (inv = inf) and padded (inv = 0) windows.  Computed in the stats' dtype
    and stored in ``dtype`` (default: the same); a narrower ``dtype`` is
    filled in blocks, so only the stored matrix is allocated whole."""
    pw = stats.mu.shape[0]
    invc = torch.where(torch.isfinite(stats.inv), stats.inv,
                       torch.zeros((), dtype=stats.inv.dtype, device=stats.inv.device))
    if dtype is None or dtype == stats.T.dtype:
        U = stats.T.unfold(0, m, 1)[:pw] - stats.mu[:, None]
        return U.mul_(invc[:, None])  # in place: one (pw, m) allocation
    U = torch.empty((pw, m), dtype=dtype, device=stats.T.device)
    blk = max(1, _BLOCK_BYTES // (m * stats.T.element_size()))
    for o in range(0, pw, blk):
        e = min(o + blk, pw)
        U[o:e] = (stats.T.unfold(0, m, 1)[o:e] - stats.mu[o:e, None]) * invc[o:e, None]
    return U


def stats_from_numpy(arrays: dict, dtype, device, windows: bool = True) -> Stats:
    """Stage padded statistics given as numpy arrays (the fields of a
    ``Stats``, e.g. mpx's) as a device ``Stats`` in ``dtype``.  With
    ``windows`` the window matrix is taken from ``arrays['windows']`` when
    present, else built; without it the stats carry none."""
    dt = torch_dtype(dtype)

    def t(name):
        return torch.tensor(np.asarray(arrays[name]), dtype=dt, device=device)

    stats = Stats(T=t("T"), mu=t("mu"), df=t("df"), dg=t("dg"),
                  inv=t("inv"), qt0=t("qt0"))
    if not windows:
        return stats
    if arrays.get("windows") is not None:
        return stats._replace(windows=t("windows").contiguous())
    m = stats.T.shape[0] - stats.mu.shape[0] + 1
    return stats._replace(windows=build_windows(stats, m))


def precompute_statistics(T, m: int, *, band: int, chunk: int,
                          dtype="float32", device="cuda", windows: bool = True,
                          exact_mean: bool = False,
                          host_stats: dict | None = None, backend: str = "auto",
                          matmul_only: bool = False) -> Stats:
    """Device-resident, padded statistics in the compute dtype, with the
    unit-window matrix when ``windows`` (the (padded_w, m) matrix only the
    windows-matmul kernels read).  Accumulation is float64
    (:func:`host_statistics` on ``backend``, or ``host_stats``, its result
    for the same series and ``exact_mean`` when the caller already has
    it; ``exact_mean`` for the recurrence tier); the pad region
    is zero so out-of-range lanes behave like the reference's
    ``InputDataPack(0)``.  ``matmul_only`` stages ``T``, ``mu`` and
    ``inv`` and zero-fills ``df``, ``dg`` and ``qt0``, as mpx does: the
    windows-matmul tiers read no more.  The ``device`` backend's ``inv``
    and ``qt0`` stay on the device (:func:`_stage_on_device`).  ``device``
    defaults to the card, as :class:`~mpx_torch.config.MatrixProfileConfig`
    does; pass ``"cpu"`` for the plain path."""
    T64 = np.asarray(T, dtype=np.float64)
    w = T64.shape[0] - m + 1
    pw = _padded_width(w, band, chunk)
    if host_stats is None and resolve_backend(backend, device) == "device":
        return _stage_on_device(T64, m, pw, torch_dtype(dtype), device, windows=windows,
                                matmul_only=matmul_only, exact_mean=exact_mean)
    if host_stats is None:
        with span("statistics.host"):
            s = host_statistics(T64, m, backend=backend, matmul_only=matmul_only,
                                exact_mean=exact_mean, device=device)
    else:
        s = _zero_filled(host_stats) if matmul_only else host_stats
    npdt = np.float64 if torch_dtype(dtype) == torch.float64 else np.float32

    def padn(x, width):
        out = np.zeros(width, dtype=npdt)
        out[: x.shape[0]] = x.astype(npdt)
        return out

    with span("statistics.stage"):
        arrays = {"T": padn(T64, pw + m - 1)}
        for name in ("mu", "df", "dg", "inv", "qt0"):
            arrays[name] = padn(s[name], pw)
        return stats_from_numpy(arrays, dtype, device, windows=windows)


def _stage_on_device(T: np.ndarray, m: int, pw: int, dt: torch.dtype, device, *,
                     windows: bool, matmul_only: bool, exact_mean: bool) -> Stats:
    """The ``device`` backend staged where it was computed: ``inv`` and
    ``qt0`` from the kernel and ``T`` stay on the device; the host's
    ``mu``, ``df`` and ``dg`` go up once.  The same casts and zero pad as
    the host backends' staging, so the same values; the window matrix
    built there when ``windows``."""
    mu, Tt, inv, qt0 = _window_sums(T, m, device, matmul_only=matmul_only,
                                    exact_mean=exact_mean)
    with span("statistics.host"):
        df, dg = (None, None) if matmul_only else _df_dg(T, mu, m)
    dev = Tt.device
    npdt = np.float64 if dt == torch.float64 else np.float32

    def pad(x, width):
        out = torch.zeros(width, dtype=dt, device=dev)
        if x is not None:
            out[: x.shape[0]] = (x.to(dt) if isinstance(x, torch.Tensor)
                                 else torch.as_tensor(x.astype(npdt), device=dev))
        return out

    with span("statistics.stage"):
        stats = Stats(T=pad(Tt, pw + m - 1), mu=pad(mu, pw), df=pad(df, pw), dg=pad(dg, pw),
                      inv=pad(inv, pw), qt0=pad(qt0, pw))
        return stats._replace(windows=build_windows(stats, m)) if windows else stats
