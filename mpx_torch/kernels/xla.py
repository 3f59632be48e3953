"""Band sweep as the SCAMP diagonal recurrence: the plain PyTorch version
of K3.

Counterpart of ``mpx/kernels/xla.py:sweep_band_xla``.  Lane ``j`` carries
QT along diagonal ``k0 + j``; row 0 of the band takes the exact seed
(:func:`mpx_torch.kernels.common.seed_qt`), every later row adds the O(1)
update ``df_r[i]*dg_c[i+j] + df_c[i+j]*dg_r[i]``.  Each row is a handful of
vector ops over the W lanes, in a Python loop over the S rows (mpx's
``lax.scan``).  Column aggregates are column-aligned: the carry shifts
one lane per row and lane 0 is streamed out as the expiring column.

This is the semantic reference of the CUDA kernel
(:mod:`mpx_torch.kernels.recurrence`), the path every CPU tensor takes,
and a deliberate user choice (``kernel='xla'``) on the card.
"""

from __future__ import annotations

import torch

from mpx_torch.dtypes import AGGREGATE_INIT, INDEX_INIT, torch_dtype
from mpx_torch.kernels.common import BandGeometry, BandOut, seed_qt
from mpx_torch.types import Aggregates, Stats
from mpx_torch.utils.profile import count


def sweep_band_xla(stats: Stats, r0: int, k0: int, geom: BandGeometry,
                   dtype) -> BandOut:
    count("calls.xla")
    S, W, m, w, excl = geom.S, geom.W, geom.m, geom.w, geom.excl
    dt = torch_dtype(dtype)
    if stats.df.dtype != dt:
        raise ValueError(f"stats are {stats.df.dtype}, sweep asked for {dt}")
    dev = stats.df.device
    r0, k0 = int(r0), int(k0)
    c0 = r0 + k0

    df_r, dg_r, inv_r = (x[r0 : r0 + S] for x in (stats.df, stats.dg, stats.inv))
    df_c, dg_c, inv_c = (x[c0 : c0 + S + W] for x in (stats.df, stats.dg, stats.inv))
    qt = seed_qt(stats, r0, c0, W, m)

    lanes = torch.arange(W, dtype=torch.int32, device=dev)
    diag_ok = (k0 + lanes) >= excl
    col_ok = ((c0 + torch.arange(S + W, device=dev)) <= w - 1) & torch.isfinite(inv_c)
    row_ok = ((r0 + torch.arange(S, device=dev)) <= w - 1) & torch.isfinite(inv_r)
    init_v = torch.tensor(AGGREGATE_INIT, dtype=dt, device=dev)
    none = torch.tensor(INDEX_INIT, dtype=torch.int32, device=dev)

    # Row 0's values come from the seed; later rows update in place.
    row_v = torch.empty(S, dtype=dt, device=dev)
    row_i = torch.empty(S, dtype=torch.int32, device=dev)
    exp_v = torch.empty(S, dtype=dt, device=dev)
    exp_i = torch.empty(S, dtype=torch.int32, device=dev)
    cv = torch.full((W,), AGGREGATE_INIT, dtype=dt, device=dev)
    ci = torch.full((W,), INDEX_INIT, dtype=torch.int32, device=dev)
    for i in range(S):
        if i > 0:
            qt = qt + (df_r[i] * dg_c[i : i + W] + df_c[i : i + W] * dg_r[i])
        p = qt * inv_r[i] * inv_c[i : i + W]
        pm = torch.where(diag_ok & col_ok[i : i + W] & row_ok[i], p, init_v)

        # Row aggregate: max + first-occurrence argmax.
        rv, rj = pm.max(dim=0)
        row_v[i] = rv
        row_i[i] = torch.where(rv > init_v, c0 + i + rj.to(torch.int32), none)

        # Column aggregates: shift the column-aligned carry by one lane
        # (lane 0, column c0 + i - 1, was streamed out last row), then
        # max-update with this row's correlations.
        cvs = torch.cat([cv[1:], init_v.reshape(1)])
        cis = torch.cat([ci[1:], none.reshape(1)])
        better = pm > cvs
        cv = torch.where(better, pm, cvs)
        ci = torch.where(better, r0 + i, cis)
        exp_v[i], exp_i[i] = cv[0], ci[0]

    # Column window [c0, c0+S+W): the S expired columns, then the surviving
    # tail shifted once more; its last lane, column c0+S+W-1, is never
    # touched by this band.
    col_v = torch.cat([exp_v, cv[1:], init_v.reshape(1)])
    col_i = torch.cat([exp_i, ci[1:], none.reshape(1)])
    return BandOut(row=Aggregates(row_v, row_i), col=Aggregates(col_v, col_i))
