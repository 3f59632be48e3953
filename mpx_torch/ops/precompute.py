"""O(n) precomputation of SCAMP statistics, counterpart of
``mpx/ops/precompute.py``.

The statistics are accumulated in float64 on the host with numpy (the
window mean of mpx's default, native backend and the same two-pass
sum-of-squares estimator as its numpy and native backends), cast to the
compute dtype, zero-padded and staged on the device.  The unit-window
matrix that the sweep kernels read is then built on the device in the
compute dtype, exactly as mpx builds it, when the sweep kernel reads it
(``windows=True``: K1 and its plain version; the recurrence tier reads
only ``T, mu, df, dg, inv``, and takes a corrected window mean,
``exact_mean=True``).
"""

from __future__ import annotations

import numpy as np
import torch

from mpx_torch.dtypes import full_precision_matmul, torch_dtype
from mpx_torch.types import Stats

# A window's centered sum-of-squares below REL * (its raw sum-of-squares)
# is numerically indistinguishable from a constant subsequence; those
# windows get inv = inf and every kernel masks them.
ZERO_VARIANCE_REL = 1e-10

_WINDOWS_BLOCK = 8192
# Bytes of a materialized block of windows: the host's centered block
# (float64) and the window copy of one block of sliding_dot_product.
_BLOCK_BYTES = 128 << 20


def _padded_width(w: int, band: int, chunk: int) -> int:
    """Pad the subsequence count so every job's panel slice is in bounds
    (a job reads rows up to w - 1 + band and columns up to
    w - 1 + chunk), rounded up to 8192 like mpx."""
    pw = int(w + band + chunk)
    return ((pw + _WINDOWS_BLOCK - 1) // _WINDOWS_BLOCK) * _WINDOWS_BLOCK


def precompute_statistics_numpy(T: np.ndarray, m: int, *, exact_mean: bool = False) -> dict:
    """Float64 statistics of an unpadded series (host-side, BLAS).

    The window mean is the reference's running mean
    (``mu[i] = mu[i-1] + (T[i+m-1] - T[i-1]) / m``), bit for bit what
    mpx's default, native backend computes; so are ``df``, ``dg``,
    ``inv`` and ``qt0``.  The windows-matmul tiers read only ``mu`` and
    ``inv``, and the running mean's drift from the exact window mean
    (~5e-10 on a unit-step walk at level 1e5) costs them nothing
    measurable.

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
    n = T.shape[0]
    if m < 4:
        raise ValueError("m must be >= 4")
    if n < m:
        raise ValueError("n must be >= m")
    w = n - m + 1

    # Sequential sums (np.cumsum), in the native loop's order.
    steps = np.concatenate([[np.cumsum(T[:m])[-1] / m], (T[m:] - T[:w - 1]) / m])
    mu = np.cumsum(steps)

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

    df = np.zeros(w, dtype=np.float64)
    dg = np.zeros(w, dtype=np.float64)
    df[1:] = (T[m:] - T[:w - 1]) / 2
    dg[1:] = (T[m:] - mu[1:]) + (T[:w - 1] - mu[:w - 1])

    sdp0 = windows @ T[:m]
    qt0 = sdp0 - m * mu[0] * mu

    return {"mu": mu, "df": df, "dg": dg, "inv": inv, "qt0": qt0}


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
                          host_stats: dict | None = None) -> Stats:
    """Device-resident, padded statistics in the compute dtype, with the
    unit-window matrix when ``windows`` (the (padded_w, m) matrix only the
    windows-matmul kernels read).  Accumulation is float64 on the host
    (:func:`precompute_statistics_numpy`, or ``host_stats``, its result
    for the same series and ``exact_mean`` when the caller already has
    it; ``exact_mean`` for the recurrence tier); the pad region
    is zero so out-of-range lanes behave like the reference's
    ``InputDataPack(0)``.  ``device`` defaults to the card, as
    :class:`~mpx_torch.config.MatrixProfileConfig` does; pass ``"cpu"``
    for the plain path."""
    T64 = np.asarray(T, dtype=np.float64)
    w = T64.shape[0] - m + 1
    pw = _padded_width(w, band, chunk)
    s = (precompute_statistics_numpy(T64, m, exact_mean=exact_mean)
         if host_stats is None else host_stats)
    npdt = np.float64 if torch_dtype(dtype) == torch.float64 else np.float32

    def padn(x, width):
        out = np.zeros(width, dtype=npdt)
        out[: x.shape[0]] = x.astype(npdt)
        return out

    arrays = {"T": padn(T64, pw + m - 1)}
    for name in ("mu", "df", "dg", "inv", "qt0"):
        arrays[name] = padn(s[name], pw)
    return stats_from_numpy(arrays, dtype, device, windows=windows)
