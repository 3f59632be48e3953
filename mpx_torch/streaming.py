"""Streaming (incremental) self-join matrix profile.

Counterpart of ``mpx/streaming.py``.  The series' statistics, unit
windows and (correlation, index) aggregates live on the device in padded
tensors of capacity ``cap`` (a power of two, doubled on overflow, the old
state copied on the device).  Appending ``k`` points costs one product of
the ``k`` new unit windows against the ``w`` live ones, O(k * n) pairs
instead of the O(n^2) of a recompute, plus O(k * m) host statistics for
the new windows only; the host sends O(k) elements to the device and
nothing O(n) comes back until :meth:`~StreamingMatrixProfile.profile`.

The column windows are kept as device state: each append writes only its
``k`` new rows of the (cap, m) window matrix.  The append itself is torch
ops, as mpx's is XLA (``jax.lax.dot_general``, not Pallas): the product
(in full FP32 for float32), the masks, a first-index max per row and per
column (:func:`mpx_torch.ops.aggregates.reduce_first`), and mpx's merge
order: the new rows write their own slots, then every column max-merges
with a strict ``>`` (the new columns are also new rows).

Three modes, as mpx:

* ``full``  — the self-join profile (``|c - r| >= m // 4``);
* ``right`` — each window's nearest LATER neighbor (FLOSS): a new row's
  neighbors lie to its right, and it can improve only columns to its
  left; :meth:`~StreamingMatrixProfile.trim_head` drops the oldest
  windows;
* ``left``  — each window's nearest EARLIER neighbor (DAMP): no column
  merge, so a value is final when its window arrives.

mpx pads each append to a bucket of rows so that XLA compiles one shape
per bucket; the port sweeps exactly the ``k`` new rows and has no
buckets (no ``compile_keys``).  State is Pearson correlation; distances
are materialized on demand.
"""

from __future__ import annotations

import numpy as np
import torch

from mpx_torch.config import MatrixProfileConfig
from mpx_torch.driver import compute_matrix_profile
from mpx_torch.dtypes import (
    AGGREGATE_INIT,
    INDEX_INIT,
    canonical_dtype,
    full_precision_matmul,
    torch_dtype,
)
from mpx_torch.ops.aggregates import reduce_first
from mpx_torch.ops.precompute import ZERO_VARIANCE_REL, precompute_statistics_numpy

_MIN_CAP = 1024
# Bytes of one block of the (rows, w) product of an append: a long append
# is swept in blocks of new rows.
_TILE_BYTES = 256 << 20


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


class StreamingMatrixProfile:
    """Self-join matrix profile with O(k*n) appends.

    >>> smp = StreamingMatrixProfile(T0, m=64, device="cpu")
    >>> smp.append(new_points)
    >>> MP, MPI = smp.profile()
    """

    def __init__(self, T, m: int, dtype: str = "float32", mode: str = "full", *,
                 device: str = "cuda"):
        if mode not in ("full", "right", "left"):
            raise ValueError("mode must be 'full', 'right', or 'left'")
        self.m = m
        self.mode = mode
        self.dtype = canonical_dtype(dtype)
        self._dt = torch_dtype(self.dtype)
        # raises here, before any work, when the device is not available
        self._config = MatrixProfileConfig(m=m, dtype=str(self.dtype), device=device)
        self._device = torch.device(device)
        T = np.asarray(T, np.float64)
        if T.shape[0] < m + m // 4:
            raise ValueError("initial series too short for a self-join")
        self._n = T.shape[0]
        self._T = T.copy()  # host buffer; the series is self._T[: self._n]
        self._excl = m // 4
        # stream position of the series' first point (advanced by trim_head)
        self.offset = 0
        # instrumentation: elements moved host -> device, capacity doublings
        self.staged_elements: int = 0
        self.capacity_doublings: int = 0
        s = precompute_statistics_numpy(T, m)
        self._bootstrap(s["mu"], s["inv"])

    # -- host-side bookkeeping -------------------------------------------

    @property
    def _w(self) -> int:
        return self._n - self.m + 1

    @property
    def series(self) -> np.ndarray:
        return self._T[: self._n]

    def _extend_stats(self, old_w: int):
        """Statistics of the new windows only, O(k * m) per append (the
        existing windows' mu/inv never change): the centered two-pass form
        with the batch statistics' relative zero-variance rule."""
        win = np.lib.stride_tricks.sliding_window_view(self.series[old_w:], self.m)
        mu_new = win.mean(axis=1)
        cent = win - mu_new[:, None]
        ssq = np.sum(cent * cent, axis=1)
        sumsq = np.sum(win * win, axis=1)
        ssq = np.where(ssq <= ZERO_VARIANCE_REL * sumsq, 0.0, ssq)
        with np.errstate(divide="ignore"):
            inv_new = 1.0 / np.sqrt(ssq)
        return mu_new, inv_new

    def _bootstrap(self, mu: np.ndarray, inv: np.ndarray):
        """The initial profile through the driver (``auto``: K1 on the card,
        K3 for float64 with m > 4096), converted back to correlations
        (``P = 1 - d^2 / (2m)``) on the device."""
        if self.mode == "full":
            MP, MPI = compute_matrix_profile(self.series, config=self._config)
        else:
            MPl, MPIl, MPr, MPIr = compute_matrix_profile(
                self.series, config=self._config, left_right=True)
            MP, MPI = (MPr, MPIr) if self.mode == "right" else (MPl, MPIl)
        d = MP.to(torch.float64)
        val = torch.where(MPI >= 0, 1.0 - d * d / (2.0 * self.m), AGGREGATE_INIT)
        w, dev, dt = self._w, self._device, self._dt
        cap = _next_pow2(max(w, _MIN_CAP))
        self._cap = cap
        self._T_dev = torch.zeros(cap + self.m - 1, dtype=dt, device=dev)
        self._T_dev[: self._n] = torch.as_tensor(self.series, device=dev).to(dt)
        self._mu_dev = torch.zeros(cap, dtype=dt, device=dev)
        self._inv_dev = torch.zeros(cap, dtype=dt, device=dev)
        self._mu_dev[:w] = torch.as_tensor(mu, device=dev).to(dt)
        self._inv_dev[:w] = torch.as_tensor(inv, device=dev).to(dt)
        self._U_dev = torch.zeros((cap, self.m), dtype=dt, device=dev)
        self._write_windows(0, w)
        self._val_dev = torch.full((cap,), AGGREGATE_INIT, dtype=dt, device=dev)
        self._idx_dev = torch.full((cap,), INDEX_INIT, dtype=torch.int32, device=dev)
        self._val_dev[:w] = val.to(dt)
        self._idx_dev[:w] = MPI
        self.staged_elements += self._n + 2 * w

    def _write_windows(self, lo: int, hi: int):
        """Unit windows [lo, hi) from the device series and statistics, as
        the batch window matrix is built: ``(T - mu) * inv``, zero rows for
        zero-variance windows."""
        inv = self._inv_dev[lo:hi]
        invc = torch.where(torch.isfinite(inv), inv, torch.zeros((), dtype=inv.dtype,
                                                                  device=inv.device))
        win = self._T_dev.unfold(0, self.m, 1)[lo:hi]
        self._U_dev[lo:hi] = (win - self._mu_dev[lo:hi, None]) * invc[:, None]

    def _grow(self, w: int):
        """Move the state into tensors of the next capacity that holds ``w``
        windows, on the device."""
        cap = _next_pow2(max(w, _MIN_CAP))

        def grown(x, length, fill):
            out = torch.full((length,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                             device=x.device)
            out[: x.shape[0]] = x
            return out

        m = self.m
        self._T_dev = grown(self._T_dev, cap + m - 1, 0)
        self._mu_dev = grown(self._mu_dev, cap, 0)
        self._inv_dev = grown(self._inv_dev, cap, 0)
        self._U_dev = grown(self._U_dev, cap, 0)
        self._val_dev = grown(self._val_dev, cap, AGGREGATE_INIT)
        self._idx_dev = grown(self._idx_dev, cap, INDEX_INIT)
        while self._cap < cap:
            self._cap *= 2
            self.capacity_doublings += 1

    # -- the append step --------------------------------------------------

    def _sweep(self, r_off: int, w: int):
        """The new rows [r_off, w) against the w live columns: returns the
        rows' (value, index) and, but for ``left``, the columns' best new
        row (value -inf where none is valid)."""
        dev, m, excl, mode = self._device, self.m, self._excl, self.mode
        U = self._U_dev
        fin = torch.isfinite(self._inv_dev[:w])
        neg = -torch.inf
        rows_v, rows_i = [], []
        cv = torch.full((w,), neg, dtype=self._dt, device=dev)
        ci = torch.full((w,), INDEX_INIT, dtype=torch.int32, device=dev)
        blk = max(1, _TILE_BYTES // (w * U.element_size()))
        for o in range(r_off, w, blk):
            e = min(o + blk, w)
            with full_precision_matmul():
                P = U[o:e] @ U[:w].T
            P.masked_fill_(~fin[None, :], neg)
            P.masked_fill_(~fin[o:e, None], neg)
            # Columns left of t0 are at least excl before every row of the
            # block; only the tail [t0, w) can fall inside a zone.
            t0 = max(0, o - excl + 1)
            delta = (torch.arange(t0, w, device=dev)[None, :]
                     - torch.arange(o, e, device=dev)[:, None])
            tail = P[:, t0:]
            if mode == "right":
                # rows: later neighbors (c - r >= excl) lie in the tail only
                row = reduce_first(tail.masked_fill(delta < excl, neg), 1, t0)
                tail.masked_fill_(-delta < excl, neg)  # columns: r - c >= excl
            elif mode == "left":
                tail.masked_fill_(-delta < excl, neg)  # rows: r - c >= excl
                row = reduce_first(P, 1, 0)
            else:
                tail.masked_fill_(delta.abs() < excl, neg)
                row = reduce_first(P, 1, 0)
            rows_v.append(row.value)
            rows_i.append(row.index)
            if mode != "left":
                col = reduce_first(P, 0, o)
                better = col.value > cv  # an earlier block keeps a tie
                cv = torch.where(better, col.value, cv)
                ci = torch.where(better, col.index, ci)
        return torch.cat(rows_v), torch.cat(rows_i), (cv, ci)

    def append(self, points):
        """Append new points and update the profile incrementally: O(k * n)
        pairs on the device, O(k * m) host work, O(k) elements staged."""
        points = np.atleast_1d(np.asarray(points, np.float64))
        k = points.shape[0]
        if k == 0:
            return
        if self._n + k > self._T.shape[0]:
            buf = np.empty(_next_pow2(self._n + k), np.float64)
            buf[: self._n] = self.series
            self._T = buf
        old_w, old_n = self._w, self._n
        self._T[old_n : old_n + k] = points
        self._n += k
        w = self._w
        mu_new, inv_new = self._extend_stats(old_w)
        if w > self._cap:
            self._grow(w)
        dev, dt = self._device, self._dt
        self._T_dev[old_n : old_n + k] = torch.as_tensor(points, device=dev).to(dt)
        self._mu_dev[old_w:w] = torch.as_tensor(mu_new, device=dev).to(dt)
        self._inv_dev[old_w:w] = torch.as_tensor(inv_new, device=dev).to(dt)
        self.staged_elements += 3 * k
        self._write_windows(old_w, w)

        rv, ri, (cv, ci) = self._sweep(old_w, w)
        # New rows own their slots (AGGREGATE_INIT / -1 where no pair is
        # valid); then the columns max-merge, the new slots included.
        self._val_dev[old_w:w] = torch.where(torch.isfinite(rv), rv, AGGREGATE_INIT)
        self._idx_dev[old_w:w] = ri
        if self.mode != "left":
            val, idx = self._val_dev[:w], self._idx_dev[:w]
            better = cv > val
            val.copy_(torch.where(better, cv, val))
            idx.copy_(torch.where(better, ci, idx))

    def trim_head(self, drop: int):
        """Drop the ``drop`` oldest points (= the ``drop`` oldest windows) and
        rebase the state on the device: the sliding-window egress step.

        Only valid in ``mode='right'``: right arcs point from older to newer
        windows, so discarding the head never orphans a surviving window's
        neighbor (an old window may be a survivor's nearest neighbor in the
        other modes).  ``self.offset`` keeps absolute stream positions."""
        if self.mode != "right":
            raise ValueError(
                "trim_head requires mode='right' (bidirectional arcs may "
                "point at the discarded head)"
            )
        if drop <= 0:
            return
        if self._n - drop < self.m + self._excl:
            raise ValueError(
                f"trim_head({drop}) would leave fewer than m + m//4 = "
                f"{self.m + self._excl} points of the current {self._n}"
            )
        w = self._w
        idx = self._idx_dev[drop:w]
        self._idx_dev[: w - drop] = torch.where(idx >= 0, idx - drop, idx)
        for x, fill in ((self._val_dev, AGGREGATE_INIT), (self._mu_dev, 0),
                        (self._inv_dev, 0), (self._U_dev, 0)):
            x[: w - drop] = x[drop:w].clone()
            x[w - drop : w] = fill
        self._idx_dev[w - drop : w] = INDEX_INIT
        self._T_dev[: self._n - drop] = self._T_dev[drop : self._n].clone()
        self._T_dev[self._n - drop : self._n] = 0
        self._T = self._T[drop : self._n].copy()
        self._n -= drop
        self.offset += drop

    # -- results ----------------------------------------------------------

    def row_values(self, lo: int, hi: int) -> np.ndarray:
        """Distances of window slots [lo, hi) only: an O(hi - lo) fetch (the
        per-append consumers such as the DAMP scorer must not pay O(n) a
        step).  Slots are local (after trims); add ``self.offset`` for
        stream positions."""
        lo = max(0, lo)
        hi = min(hi, self._w)
        if hi <= lo:
            return np.zeros(0, np.float64)
        val = self._val_dev[lo:hi].cpu().numpy().astype(np.float64)
        return np.sqrt(np.maximum(2.0 * self.m * (1.0 - val), 0.0))

    def profile(self):
        """Current (MP float64, MPI int32) as numpy arrays."""
        w = self._w
        val = self._val_dev[:w].cpu().numpy().astype(np.float64)
        MP = np.sqrt(np.maximum(2.0 * self.m * (1.0 - val), 0.0))
        return MP, self._idx_dev[:w].cpu().numpy().astype(np.int32)
