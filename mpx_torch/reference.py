"""Golden SCAMP reference implementation (pure numpy, float64).

Behavioral port of the reference's independent test oracle
(test/include/MatrixProfileReference.hpp:30-136): rolling statistics, the
O(n^2) diagonal sweep with the O(1) QT update, the trivial-match exclusion
zone ``column - row < m/4``, and the final Pearson -> Euclidean conversion
``MP = sqrt(2m(1 - P))``.  Aggregates are initialized to (-1e12, -1).

This module is the correctness oracle for every kernel in mpx_torch
(carried over from mpx/reference.py so it runs without JAX).  It is
deliberately simple and row-sequential (vectorized across the diagonal axis
only) — do not optimize it.
"""

from __future__ import annotations

import numpy as np

from mpx_torch.dtypes import AGGREGATE_INIT, INDEX_INIT


def rolling_statistics(T: np.ndarray, m: int):
    """mu, df, dg, inv exactly as MatrixProfileReference.hpp:30-69.

    mu uses the sequential rolling update; inv uses the centered two-pass
    sum of squares.  Returns float64 arrays of length n - m + 1.
    """
    T = np.asarray(T, dtype=np.float64)
    n = T.shape[0]
    w = n - m + 1

    mu = np.empty(w, dtype=np.float64)
    mu[0] = np.sum(T[:m]) / m
    for i in range(1, w):
        mu[i] = mu[i - 1] + (T[i + m - 1] - T[i - 1]) / m

    df = np.zeros(w, dtype=np.float64)
    dg = np.zeros(w, dtype=np.float64)
    df[1:] = (T[m:] - T[:w - 1]) / 2
    dg[1:] = (T[m:] - mu[1:]) + (T[:w - 1] - mu[:w - 1])

    inv = np.empty(w, dtype=np.float64)
    windows = np.lib.stride_tricks.sliding_window_view(T, m)
    centered = windows - mu[:, None]
    with np.errstate(divide="ignore"):
        inv = 1.0 / np.sqrt(np.sum(centered * centered, axis=1))
    return mu, df, dg, inv


def exclusion_zone(m: int) -> int:
    """Width of the trivial-match exclusion zone: pairs with
    column - row < m // 4 are skipped (MatrixProfileReference.hpp:72-79)."""
    return m // 4


def compute_matrix_profile_reference(T: np.ndarray, m: int):
    """Self-join matrix profile via the naive diagonal sweep.

    Returns (MP, MPI): float64 distances and int32 neighbor indices, with
    untouched entries left at sqrt(2m(1 + 1e12)) / -1 like the reference.

    Mirrors MatrixProfileReference.hpp:91-136 with the inner loop
    vectorized over the diagonal; update order across rows is preserved so
    first-seen tie-breaking matches the reference for the row aggregates.
    NaN correlations (zero-variance subsequences) never update aggregates,
    matching the C++ `>` comparison semantics.
    """
    T = np.asarray(T, dtype=np.float64)
    n = T.shape[0]
    w = n - m + 1
    if m < 4:
        raise ValueError("m must be >= 4")
    if w < 1:
        raise ValueError("n must be >= m")

    mu, df, dg, inv = rolling_statistics(T, m)
    excl = exclusion_zone(m)

    MP = np.full(w, AGGREGATE_INIT, dtype=np.float64)
    MPI = np.full(w, INDEX_INIT, dtype=np.int32)

    windows = np.lib.stride_tricks.sliding_window_view(T, m)
    centered0 = T[:m] - mu[0]
    # First-row QT: QT[i] = sum_k (T[i+k] - mu[i]) (T[k] - mu[0])
    QT = (windows - mu[:, None]) @ centered0

    def update_row(row, cols, P):
        # Row-wise aggregate: max over this row's valid pairs, first-seen
        # tie-break (np.argmax returns the first maximum, matching the
        # reference's strict `>` scan order).  NaN never wins.
        if P.size == 0:
            return
        Pc = np.where(np.isnan(P), -np.inf, P)
        j = int(np.argmax(Pc))
        if Pc[j] > MP[row]:
            MP[row] = Pc[j]
            MPI[row] = cols[j]

    def update_cols(cols, row, P):
        # Column-wise aggregates: indices are distinct within one row, so
        # the vectorized fancy-index assignment is race-free.
        with np.errstate(invalid="ignore"):
            better = P > MP[cols]
        MP[cols] = np.where(better, P, MP[cols])
        MPI[cols] = np.where(better, row, MPI[cols])

    # Row 0 (MatrixProfileReference.hpp:106-118)
    cols = np.arange(w)
    with np.errstate(invalid="ignore"):
        P = QT * inv[0] * inv
    valid = cols >= excl  # exclusion for row 0: column - 0 < m/4
    update_row(0, cols[valid], P[valid])
    update_cols(cols[valid], 0, P[valid])

    # Diagonal sweep (MatrixProfileReference.hpp:120-131); k indexes the
    # diagonal offset column - row, QT[k] carries along the k-th diagonal.
    for row in range(1, w):
        k = np.arange(w - row)
        col = k + row
        QT[k] = QT[k] + df[row] * dg[col] + df[col] * dg[row]
        with np.errstate(invalid="ignore"):
            P = QT[k] * inv[row] * inv[col]
        valid = k >= excl
        update_row(row, col[valid], P[valid])
        update_cols(col[valid], row, P[valid])

    MP = np.sqrt(2.0 * m * (1.0 - MP))
    return MP, MPI


def band_recurrence_exact(T, mu, df, dg, inv, r0: int, k0: int, S: int, W: int,
                          m: int, w: int, excl: int, block: int = 1024):
    """One band job of the SCAMP recurrence on given statistics, summed in
    extended precision (numpy longdouble with a 64-bit significand).

    The statistics (float64 arrays, or float32 values widened) are taken
    as exact.  With c0 = r0 + k0, diagonal j of band row i is column
    c0 + i + j and

        QT(0, j) = sum_k (T[r0+k] - mu[r0]) (T[c0+j+k] - mu[c0+j]),
        QT(i, j) = QT(i-1, j) + df[r0+i] dg[c0+i+j] + df[c0+i+j] dg[r0+i],
        P(i, j)  = QT(i, j) inv[r0+i] inv[c0+i+j],

    masked as the band sweeps mask it (exclusion zone k0 + j < excl, rows
    and columns past w - 1, non-finite inverse norms) to AGGREGATE_INIT.
    Every float32 or float64 sweep of the band is a rounding of this
    function, so it measures their error.  Returns (row_v, row_i, col_v,
    col_i, P): the row (S,) and column (S + W,) maxima with the smallest
    index (INDEX_INIT where nothing is valid) and P (S, W), values rounded
    to float64; ``block`` diagonals at a time bound the memory."""
    L = np.longdouble
    if np.finfo(L).nmant < 63:
        raise RuntimeError("band_recurrence_exact needs an 80-bit or wider longdouble")
    c0 = r0 + k0
    cut = lambda a, lo, n: np.asarray(a, dtype=L)[lo : lo + n]  # noqa: E731
    df_r, dg_r, inv_r = (cut(a, r0, S) for a in (df, dg, inv))
    df_c, dg_c, inv_c = (cut(a, c0, S + W) for a in (df, dg, inv))
    qc = cut(T, r0, m) - L(mu[r0])
    Tc, muc = cut(T, c0, W + m - 1), cut(mu, c0, W)
    row_ok = ((r0 + np.arange(S)) <= w - 1) & np.isfinite(inv_r)
    col_ok = ((c0 + np.arange(S + W)) <= w - 1) & np.isfinite(inv_c)
    window = np.lib.stride_tricks.sliding_window_view
    P = np.empty((S, W))
    for j0 in range(0, W, block):  # diagonals [j0, j0 + block)
        Wb = min(block, W - j0)
        diag = lambda a: window(a[j0 : j0 + S + Wb - 1], Wb)[:S]  # noqa: E731
        U = df_r[:, None] * diag(dg_c) + diag(df_c) * dg_r[:, None]
        U[0] = ((window(Tc[j0 : j0 + Wb + m - 1], m) - muc[j0 : j0 + Wb, None]) * qc).sum(1)
        with np.errstate(invalid="ignore", over="ignore"):
            Pb = (np.cumsum(U, axis=0) * inv_r[:, None] * diag(inv_c)).astype(np.float64)
        ok = (k0 + j0 + np.arange(Wb) >= excl)[None, :] & row_ok[:, None] & diag(col_ok)
        P[:, j0 : j0 + Wb] = np.where(ok & (Pb == Pb), Pb, AGGREGATE_INIT)

    def best(V, axis, base):
        v = V.max(axis=axis)  # argmax: the first, so the smallest index
        return v, np.where(v > AGGREGATE_INIT, base + V.argmax(axis=axis),
                           INDEX_INIT).astype(np.int32)

    rows = np.arange(S)[:, None]
    C = np.full((S, S + W), AGGREGATE_INIT)  # column-aligned: C[i, i + j] = P[i, j]
    C[rows, rows + np.arange(W)] = P
    row_v, row_i = best(P, 1, c0 + np.arange(S))
    col_v, col_i = best(C, 0, r0)
    return row_v, row_i, col_v, col_i, P


def znormalized_distance_matrix(T: np.ndarray, m: int):
    """Second, fully independent oracle: direct z-normalized Euclidean
    distances between all subsequence pairs, O(n^2 m).  Used to validate
    the golden reference itself on tiny inputs."""
    T = np.asarray(T, dtype=np.float64)
    n = T.shape[0]
    w = n - m + 1
    windows = np.lib.stride_tricks.sliding_window_view(T, m).astype(np.float64)
    mu = windows.mean(axis=1, keepdims=True)
    sd = windows.std(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        Z = (windows - mu) / sd
    D = np.empty((w, w), dtype=np.float64)
    for i in range(w):
        diff = Z - Z[i]
        D[i] = np.sqrt(np.sum(diff * diff, axis=1))
    return D


def brute_force_matrix_profile(T: np.ndarray, m: int):
    """Matrix profile from the explicit distance matrix with the exclusion
    zone applied.  Independent of the QT recurrence entirely."""
    T = np.asarray(T, dtype=np.float64)
    n = T.shape[0]
    w = n - m + 1
    D = znormalized_distance_matrix(T, m)
    excl = exclusion_zone(m)
    i, j = np.meshgrid(np.arange(w), np.arange(w), indexing="ij")
    banned = np.abs(i - j) < excl
    D = np.where(banned, np.inf, D)
    D = np.where(np.isnan(D), np.inf, D)
    MP = D.min(axis=1)
    MPI = np.where(np.isfinite(MP), D.argmin(axis=1), INDEX_INIT).astype(np.int32)
    return MP, MPI
