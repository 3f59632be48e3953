"""Band sweep as a windows matmul: the plain PyTorch version of K1.

Counterpart of ``mpx/kernels/mxu.py:sweep_band_mxu``.  With unit-normalized
windows ``u_i = (T[i:i+m] - mu_i) * inv_i`` the Pearson correlation is a
dot product, so a job's (S x W) correlation tile is one matmul
``U_r @ U_c^T``; it is then masked and reduced to row and column
max/argmax with the smallest index winning ties.

This is the semantic reference of the fused CUDA kernel
(:mod:`mpx_torch.kernels.mxu_fused`), the path every CPU tensor takes,
and a deliberate user choice (``kernel='mxu'``) on the card.  It
materializes the whole tile in device memory.
"""

from __future__ import annotations

import torch

from mpx_torch.dtypes import AGGREGATE_INIT, INDEX_INIT, torch_dtype
from mpx_torch.kernels.common import BandGeometry, BandOut
from mpx_torch.types import Aggregates, Stats

# Calls of sweep_band_mxu (a plain count; reset by whoever reads it).
CALLS = 0


def sweep_band_mxu(stats: Stats, r0: int, k0: int, geom: BandGeometry,
                   dtype) -> BandOut:
    global CALLS
    CALLS += 1
    S, W = geom.S, geom.W
    U = stats.windows
    if U is None:
        raise ValueError("stats.windows is required (see ops.precompute)")
    dt = torch_dtype(dtype)
    if U.dtype != dt:
        raise ValueError(f"stats are {U.dtype}, sweep asked for {dt}")
    if U.device.type == "cuda":
        # Full-precision products: TF32 keeps ~3 decimal digits, far
        # outside the distance tolerance.
        torch.backends.cuda.matmul.allow_tf32 = False
    r0, k0 = int(r0), int(k0)
    c0 = r0 + k0
    return reduce_tile(U[r0 : r0 + S] @ U[c0 : c0 + W].T, stats, r0, c0, geom)


def reduce_tile(P: torch.Tensor, stats: Stats, r0: int, c0: int,
                geom: BandGeometry) -> BandOut:
    """Mask the (S, W) correlation tile of rows r0.. and columns c0.. (in
    place) and reduce it to row and column max with the smallest index
    winning ties."""
    w, excl = geom.w, geom.excl
    dt, dev = P.dtype, P.device
    S, W = P.shape
    rows = torch.arange(r0, r0 + S, dtype=torch.int32, device=dev)[:, None]
    cols = torch.arange(c0, c0 + W, dtype=torch.int32, device=dev)[None, :]
    fin_r = torch.isfinite(stats.inv[r0 : r0 + S])[:, None]
    fin_c = torch.isfinite(stats.inv[c0 : c0 + W])[None, :]
    valid = (cols - rows >= excl) & (rows <= w - 1) & (cols <= geom.wc - 1) & fin_r & fin_c
    init_v = torch.tensor(AGGREGATE_INIT, dtype=dt, device=dev)
    Pm = P.masked_fill_(~valid, AGGREGATE_INIT)
    del valid  # free the mask before the reductions allocate

    # max + first-occurrence index via an iota-min over the tie mask.
    big = torch.tensor(2**30, dtype=torch.int32, device=dev)
    none = torch.tensor(INDEX_INIT, dtype=torch.int32, device=dev)
    row_v = Pm.amax(dim=1)
    ri = torch.where(Pm == row_v[:, None], cols, big).amin(dim=1)
    row_i = torch.where(row_v > init_v, ri, none)
    col_v = Pm.amax(dim=0)
    ci = torch.where(Pm == col_v[None, :], rows, big).amin(dim=0)
    col_i = torch.where(col_v > init_v, ci, none)
    return BandOut(row=Aggregates(row_v, row_i), col=Aggregates(col_v, col_i))
