"""The plain reference: exact float64 rows of a self-join matrix profile.

A frozen copy of the port's row oracle (``mpx_torch/bench.py``:
``_unit_windows`` / ``_exact_rows`` / ``validate_sampled_rows``), written
in plain torch so that it runs blockwise on the card after a run and on
the CPU in the tests.  It imports nothing of the port and takes nothing
the port made: every input is the series the benchmark generated.

A window is z-normalized in two passes (mean, then the centered norm);
one whose centered sum of squares is at most ``ZERO_VARIANCE_REL`` of its
raw one is constant and has no neighbour.  A row's neighbours are the
windows ``j`` with ``|i - j| >= m // 4``; its distance is
``sqrt(2 m (1 - max_j P[i, j]))`` and its index the first ``j`` reaching
the maximum.  Every product is float64.
"""

from __future__ import annotations

import numpy as np
import torch

ZERO_VARIANCE_REL = 1e-10
# Bytes of one block of column windows, and of one block of products.
_BLOCK_BYTES = 256 << 20


def unit_windows(T: torch.Tensor, m: int, idx: torch.Tensor):
    """Z-normalized windows at the indices ``idx`` of the float64 series
    ``T`` and their constant-window mask (rows of zeros there)."""
    win = T.unfold(0, m, 1)[idx]
    cent = win - win.mean(dim=1, keepdim=True)
    ssq = (cent * cent).sum(dim=1)
    flat = ssq <= ZERO_VARIANCE_REL * (win * win).sum(dim=1)
    Z = cent / torch.sqrt(ssq)[:, None]
    Z[flat] = 0.0
    return Z, flat


def correlations(T: np.ndarray, m: int, rows: np.ndarray, cols: np.ndarray, *,
                 device="cpu") -> np.ndarray:
    """Exact P[rows[k], cols[k]] for each k (``-inf`` where either window
    is constant)."""
    Tt = torch.as_tensor(np.asarray(T, np.float64), device=device)
    r = torch.as_tensor(np.asarray(rows, np.int64), device=device)
    c = torch.as_tensor(np.asarray(cols, np.int64), device=device)
    Zr, fr = unit_windows(Tt, m, r)
    Zc, fc = unit_windows(Tt, m, c)
    P = (Zr * Zc).sum(dim=1)
    P[fr | fc] = -torch.inf
    return P.cpu().numpy()


def exact_rows(T: np.ndarray, m: int, rows: np.ndarray, *, col_limit=None,
               device="cpu"):
    """Each row's exact best correlation and its first index over every
    window; with ``col_limit`` (one bound per row) also the best over the
    windows ``j < col_limit[k]`` only (what a stream held when that row
    arrived).  Returns numpy ``(best, index, best_limited or None)``;
    ``-inf`` / ``-1`` where a row has no valid neighbour."""
    T64 = torch.as_tensor(np.asarray(T, np.float64), device=device)
    w = T64.shape[0] - m + 1
    excl = m // 4
    rows_np = np.asarray(rows, np.int64)
    nr = rows_np.shape[0]
    best = torch.full((nr,), -torch.inf, dtype=torch.float64, device=device)
    idx = torch.full((nr,), -1, dtype=torch.int64, device=device)
    lim_best = None
    if col_limit is not None:
        lim_best = torch.full((nr,), -torch.inf, dtype=torch.float64, device=device)
        lim = torch.as_tensor(np.asarray(col_limit, np.int64), device=device)
    r_all = torch.as_tensor(rows_np, device=device)
    Zr_all, flat_r_all = unit_windows(T64, m, r_all)
    rblk = max(1, min(nr, _BLOCK_BYTES // (8 * 4096)))
    cblk = max(1, min(w, _BLOCK_BYTES // (8 * max(m, rblk))))
    for c0 in range(0, w, cblk):
        c1 = min(c0 + cblk, w)
        cols = torch.arange(c0, c1, device=device)
        Zc, flat_c = unit_windows(T64, m, cols)
        for r0 in range(0, nr, rblk):
            r1 = min(r0 + rblk, nr)
            r = r_all[r0:r1]
            P = Zr_all[r0:r1] @ Zc.T
            P[(cols[None, :] - r[:, None]).abs() < excl] = -torch.inf
            P[:, flat_c] = -torch.inf
            P[flat_r_all[r0:r1]] = -torch.inf
            v, j = P.max(dim=1)  # first index of the maximum in the block
            better = v > best[r0:r1]  # an earlier block keeps a tie
            best[r0:r1] = torch.where(better, v, best[r0:r1])
            idx[r0:r1] = torch.where(better, j + c0, idx[r0:r1])
            if lim_best is not None:
                P[cols[None, :] >= lim[r0:r1, None]] = -torch.inf
                lim_best[r0:r1] = torch.maximum(lim_best[r0:r1], P.max(dim=1).values)
    idx = torch.where(torch.isfinite(best), idx, torch.full_like(idx, -1))
    return (best.cpu().numpy(), idx.cpu().numpy(),
            None if lim_best is None else lim_best.cpu().numpy())


def distance(m: int, corr: np.ndarray) -> np.ndarray:
    """``sqrt(2 m (1 - P))`` (0 where rounding puts P above 1)."""
    with np.errstate(invalid="ignore"):
        return np.sqrt(np.maximum(2.0 * m * (1.0 - corr), 0.0))
