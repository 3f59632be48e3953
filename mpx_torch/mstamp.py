"""Multi-dimensional matrix profile (mSTAMP, Yeh/Kamgar/Keogh KDD'17).

Counterpart of ``mpx/mstamp.py``.  For every subsequence pair the
z-normalized distance is computed per dimension, the per-pair distances
are sorted across dimensions, and the k-dimensional distance is the mean
of the k smallest, giving d stacked profiles ``PMP[k-1]`` (the best
k-dimensional motif ends at ``argmin(PMP[k-1])``).

mpx computes the tile in XLA, not Pallas, so it runs as torch ops here,
on ``config.device``, over the job grid of the 1-D driver:

* the d unit-window matrices are built once on the device in the compute
  dtype; a job's panels are slices of them, and its d correlation tiles
  are one ``torch.bmm`` (float32 in full FP32);
* ``dist = sqrt(max(2m(1 - P), 0))``, +inf in a dimension where the row
  or the column window is flat; the dimensions are ordered per pair with
  ``torch.sort`` over the leading axis (ascending, descending for
  ``discords``; ``include`` dimensions first, each group sorted by
  itself) and prefix-averaged;
* each k-profile's row and column minimum takes the smallest index on a
  tie, min-merged (strict ``<``) into carried (d, L) arrays.

A job's rows are cut into sub-bands so that each (d, S', W) tensor stays
within ``_TILE_BYTES``; rows are independent and the column side is
merged once a job, so the outputs do not depend on the cut (but for the
last bit where the BLAS takes another product kernel for the narrower
shape).  mpx's Batcher comparator sort is not ported (ROADMAP.md "Not to
port").  With ``config.num_shards > 1`` the jobs are dealt over a mesh
(:func:`_run_mstamp_sharded`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from mpx_torch.config import MatrixProfileConfig, config_for, make_job_grid
from mpx_torch.dtypes import INDEX_INIT, full_precision_matmul, torch_dtype
from mpx_torch.ops.aggregates import merge_window, reduce_first
from mpx_torch.ops.precompute import ZERO_VARIANCE_REL, _padded_width, host_statistics
from mpx_torch.types import Aggregates

# Bytes of one (d, S', W) tensor of a job's sub-band (a job's epilogue
# holds a few of them at once).
_TILE_BYTES = 256 << 20


class MultiProfile(NamedTuple):
    """Stacked k-dimensional profiles: row ``k-1`` is the k-dim profile."""

    PMP: np.ndarray   # (d, w) float, k-dim z-norm distances
    PMPI: np.ndarray  # (d, w) int32, matching subsequence index (-1: none)


class _Panels(NamedTuple):
    U: torch.Tensor    # (d, pw, m) unit windows, 0 where invalid
    fin: torch.Tensor  # (d, pw) bool, valid windows


def _stack_stats(T: np.ndarray, m: int, pw: int, dt: torch.dtype, device) -> _Panels:
    """Per-dimension host float64 statistics, padded and staged in the
    compute dtype, and the unit windows ``(T[i:i+m] - mu_i) * inv_i``
    built from them on the device (inv = 0 where degenerate or padded; the
    finite mask carries validity)."""
    d, n = T.shape
    w = n - m + 1
    npdt = np.float64 if dt == torch.float64 else np.float32
    Tb = np.zeros((d, pw + m - 1), npdt)
    mub = np.zeros((d, pw), npdt)
    invb = np.zeros((d, pw), npdt)
    finb = np.zeros((d, pw), bool)
    for t in range(d):
        s = host_statistics(T[t].astype(np.float64), m, matmul_only=True, device=device)
        fin = np.isfinite(s["inv"])
        Tb[t, :n] = T[t].astype(npdt)
        mub[t, :w] = s["mu"].astype(npdt)
        invb[t, :w] = np.where(fin, s["inv"], 0.0).astype(npdt)
        finb[t, :w] = fin
    Tb, mub, invb = (torch.as_tensor(x, device=device) for x in (Tb, mub, invb))
    U = (Tb.unfold(1, m, 1)[:, :pw] - mub[:, :, None]).mul_(invb[:, :, None])
    return _Panels(U, torch.as_tensor(finb, device=device))


def _order_dims(dist: torch.Tensor, include: tuple, discords: bool) -> torch.Tensor:
    """Per-pair dimension ordering for the prefix means: ascending (the
    k-dim distance is the mean of the k smallest), descending with
    ``discords`` (the mean of the k largest); ``include`` dimensions
    first, each group sorted by itself."""
    if not include:
        return torch.sort(dist, dim=0, descending=discords).values
    inc = list(include)
    rest = [t for t in range(dist.shape[0]) if t not in set(include)]
    parts = [torch.sort(dist[inc], dim=0, descending=discords).values]
    if rest:
        parts.append(torch.sort(dist[rest], dim=0, descending=discords).values)
    return torch.cat(parts, dim=0)


def _sub_band(pn: _Panels, r0: int, c0: int, S: int, W: int, *, m: int, w: int, excl: int,
              include: tuple, discords: bool):
    """The (d, S, W) k-dim distances of rows r0.. and columns c0.., reduced
    to per-k row and column minima (smallest index on a tie; -1 where
    none is finite)."""
    d = pn.U.shape[0]
    with full_precision_matmul():
        P = torch.bmm(pn.U[:, r0 : r0 + S], pn.U[:, c0 : c0 + W].transpose(1, 2))
    dist = P.neg_().add_(1.0).mul_(2.0 * m).clamp_(min=0.0).sqrt_()
    dist.masked_fill_(~pn.fin[:, r0 : r0 + S, None], torch.inf)
    dist.masked_fill_(~pn.fin[:, None, c0 : c0 + W], torch.inf)
    Dk = torch.cumsum(_order_dims(dist, include, discords), dim=0)
    del dist, P
    Dk.div_(torch.arange(1, d + 1, dtype=Dk.dtype, device=Dk.device)[:, None, None])
    if c0 - (r0 + S - 1) < excl or r0 + S > w or c0 + W > w:
        rows = torch.arange(r0, r0 + S, device=Dk.device)[:, None]
        cols = torch.arange(c0, c0 + W, device=Dk.device)[None, :]
        Dk.masked_fill_(~((cols - rows >= excl) & (rows <= w - 1) & (cols <= w - 1)),
                        torch.inf)
    return reduce_first(Dk, 2, c0, largest=False), reduce_first(Dk, 1, r0, largest=False)


def _run_jobs(pn: _Panels, grid, *, S: int, W: int, m: int, w: int, excl: int,
              include: tuple, discords: bool):
    """Every job of ``grid``, min-merged into (d, L) value and index
    arrays; returns them cut to ``w``."""
    d = pn.U.shape[0]
    dt, dev = pn.U.dtype, pn.U.device
    L = w + S + W
    vals = Aggregates(torch.full((d, L), torch.inf, dtype=dt, device=dev),
                      torch.full((d, L), INDEX_INIT, dtype=torch.int32, device=dev))
    sb = max(1, min(S, _TILE_BYTES // (d * W * pn.U.element_size())))
    job_cols = Aggregates(torch.empty((d, W), dtype=dt, device=dev),
                          torch.empty((d, W), dtype=torch.int32, device=dev))
    kw = dict(m=m, w=w, excl=excl, include=include, discords=discords)
    for r0, k0 in zip(grid.r0.tolist(), grid.k0.tolist()):
        c0 = r0 + k0
        job_cols.value.fill_(torch.inf)
        job_cols.index.fill_(INDEX_INIT)
        for s0 in range(0, S, sb):
            row, col = _sub_band(pn, r0 + s0, c0, min(sb, S - s0), W, **kw)
            merge_window(vals, row, r0 + s0, smaller=True)
            merge_window(job_cols, col, 0, smaller=True)
        merge_window(vals, job_cols, c0, smaller=True)
    return vals.value[:, :w], vals.index[:, :w]


def _run_mstamp_sharded(pn: _Panels, grid, *, num_shards: int, S: int, W: int, m: int,
                        w: int, excl: int, include: tuple, discords: bool, mesh=None):
    """Job-sharded mSTAMP (mpx's ``_run_mstamp_sharded``): the panels on
    each device of a mesh (default: ``num_shards`` devices of the panels'
    type), the jobs dealt round-robin over the shards, and the (d, w)
    partial profiles merged on ``mesh[0]`` with a first (lowest shard)
    minimum."""
    from mpx_torch.parallel.mesh import mesh_for
    from mpx_torch.parallel.sharding import replicate, shard_jobs

    mesh = mesh_for(num_shards, mesh, pn.U.device)
    parts = [_run_jobs(p, jobs, S=S, W=W, m=m, w=w, excl=excl, include=include,
                       discords=discords)
             for p, jobs in zip(replicate(pn, mesh), shard_jobs(grid, num_shards))]
    vals = torch.stack([v.to(mesh[0]) for v, _ in parts])
    idxs = torch.stack([i.to(mesh[0]) for _, i in parts])
    best = torch.argmin(vals, dim=0, keepdim=True)
    return vals.gather(0, best)[0], idxs.gather(0, best)[0]


def compute_multidim_profile(
    T,
    m: Optional[int] = None,
    *,
    config: Optional[MatrixProfileConfig] = None,
    include=None,
    discords: bool = False,
) -> MultiProfile:
    """mSTAMP self-join of a (d, n) multi-dimensional series.

    Returns :class:`MultiProfile` (numpy, as mpx's) with ``PMP[k-1, i]``
    the smallest mean-of-k-best-dimension z-norm distance from subsequence
    ``i`` to any non-trivial subsequence, and ``PMPI[k-1, i]`` its index.
    Row 0 (k=1) is the best single-dimension profile, row d-1 (k=d) the
    all-dimensions profile.  ``config`` supplies dtype (float32 or
    float64), the (band, chunk) schedule and the device.

    ``include``: dimension indices that must be part of every chosen
    k-subset (the mSTAMP paper's constrained search).  ``discords=True``
    averages the k largest per-dim distances instead (multi-dimensional
    discord search: discords = argmax of the resulting profile).
    """
    T = T.detach().cpu().numpy() if isinstance(T, torch.Tensor) else np.asarray(T)
    if T.ndim == 1:
        T = T[None, :]
    if T.ndim != 2:
        raise ValueError(f"expected (d, n) series, got shape {T.shape}")
    d, n = T.shape
    if d > n:
        raise ValueError(f"series is (d={d}, n={n}): dimensions in rows; transpose?")
    inc = tuple(sorted(int(t) for t in include)) if include else ()
    if inc and not all(0 <= t < d for t in inc):
        raise ValueError(f"include={inc} out of range for d={d}")
    config = config_for(m, config)
    m = config.m
    if config.kernel not in ("auto", "mxu"):
        raise ValueError("mSTAMP has one kernel (batched windows matmul); use kernel='auto'")
    for t in range(d):  # NaN/inf in any dimension poisons correlations
        config.validate_series(n, T[t])
    if config.input_quant is not None:
        from mpx_torch.io.apfixed import quantize

        T = quantize(np.asarray(T, np.float64), config.input_quant)
    w = n - m + 1
    config = config.shrink_to(w)
    S, W = config.band, config.chunk
    pn = _stack_stats(T, m, _padded_width(w, S, W), torch_dtype(config.dtype),
                      torch.device(config.device))
    kw = dict(S=S, W=W, m=m, w=w, excl=m // 4, include=inc, discords=discords)
    grid = make_job_grid(w, S, W)
    num_shards = config.num_shards or 1
    if num_shards > 1:
        vals, idxs = _run_mstamp_sharded(pn, grid, num_shards=num_shards, **kw)
    else:
        vals, idxs = _run_jobs(pn, grid, **kw)
    return MultiProfile(PMP=vals.cpu().numpy(), PMPI=idxs.cpu().numpy())


def multidim_motif(profile: MultiProfile, k: int) -> tuple[int, int, float]:
    """The best k-dimensional motif pair from an mSTAMP result:
    ``(i, j, distance)`` with i the argmin of the k-dim profile."""
    P, I = profile.PMP[k - 1], profile.PMPI[k - 1]
    if not np.isfinite(P).any():
        raise ValueError(
            f"the k={k} profile has no valid pairs (a flat dimension "
            "makes the all-dimensions profile +inf; see docs/numerics.md)")
    i = int(np.nanargmin(np.where(np.isfinite(P), P, np.nan)))
    return i, int(I[i]), float(P[i])


def multidim_discord(profile: MultiProfile, k: int) -> tuple[int, float]:
    """The strongest k-dimensional discord from a ``discords=True``
    mSTAMP result: ``(i, distance)`` with i the argmax of the k-dim
    profile (the subsequence farthest from its nearest neighbor)."""
    P = profile.PMP[k - 1]
    if not np.isfinite(P).any():
        raise ValueError(
            f"the k={k} profile has no valid pairs (a flat dimension "
            "masks pairs entirely in discord mode; see docs/numerics.md)")
    i = int(np.nanargmax(np.where(np.isfinite(P), P, np.nan)))
    return i, float(P[i])


class MdlResult(NamedTuple):
    best_k: int            # dimensionality with the largest bit save
    bitsaves: np.ndarray   # (d,) float, bits saved at each k (1-based)
    motifs: list           # per k: (i, j) motif pair used
    subspaces: list        # per k: the k dimension indices used


def multidim_mdl(T, m: int, *, profile: MultiProfile | None = None,
                 bits: int = 4, include=None,
                 config=None) -> MdlResult:
    """Which dimensionality k is meaningful: the MDL-based unconstrained
    search (the mSTAMP paper's third tool, Matrix Profile VI §IV-C).

    For each k, the best k-dim motif pair is scored by how many bits the
    pair saves when one subsequence is encoded relative to the other
    instead of raw.  Each selected dimension's subsequences are
    z-normalized and discretized to ``bits`` bits on the pair's shared
    min-max grid; encoding the residual ``disc(B) - disc(A)`` costs
    ``m * log2(u) + u * bits`` (u = distinct residual values, the second
    term the dictionary), versus ``m * bits`` raw:

        bitsave(k) = sum over the k subspace dims of
                     m*bits - (m*log2(u_t) + u_t*bits)

    The save peaks at the natural dimensionality and ``best_k`` is its
    argmax.  A z-degenerate (flat) dimension contributes ``-m*bits``.
    Host-side O(d^2 m) given the profile; computes the mSTAMP profile
    first (on ``config.device``) when not supplied."""
    T = np.asarray(T, np.float64)
    if T.ndim == 1:
        T = T[None, :]
    d, n = T.shape
    if bits < 1:
        raise ValueError("bits must be >= 1")
    if profile is None:
        profile = compute_multidim_profile(T, m, config=config, include=include)
    if profile.PMP.shape[0] != d:
        raise ValueError(f"profile has {profile.PMP.shape[0]} rows for d={d} series")

    def _dl_given(a: np.ndarray, b: np.ndarray) -> float:
        """Bits saved encoding z-norm(b) relative to z-norm(a)."""
        ca, cb = a - a.mean(), b - b.mean()
        sa, sb = ca @ ca, cb @ cb
        if sa <= ZERO_VARIANCE_REL * (a @ a) or sb <= ZERO_VARIANCE_REL * (b @ b):
            return -float(m * bits)
        za, zb = ca / np.sqrt(sa), cb / np.sqrt(sb)
        lo = min(za.min(), zb.min())
        hi = max(za.max(), zb.max())
        scale = (2**bits - 1) / (hi - lo) if hi > lo else 0.0
        da = np.round((za - lo) * scale).astype(np.int64)
        db = np.round((zb - lo) * scale).astype(np.int64)
        u = np.unique(db - da).shape[0]
        return float(m * bits - (m * np.log2(max(u, 1)) + u * bits))

    bitsaves = np.full(d, -np.inf)
    motifs, subspaces = [], []
    for k in range(1, d + 1):
        try:
            i, j, _ = multidim_motif(profile, k)
        except ValueError:  # no valid pairs at this k (flat dimension)
            motifs.append(None)
            subspaces.append(None)
            continue
        dims = multidim_subspace(T, m, i, j, k, include=include)
        bitsaves[k - 1] = sum(_dl_given(T[t, i : i + m], T[t, j : j + m]) for t in dims)
        motifs.append((i, j))
        subspaces.append(dims)
    if not np.isfinite(bitsaves).any():
        raise ValueError("no dimensionality has a valid motif pair")
    best_k = int(np.argmax(bitsaves)) + 1
    return MdlResult(best_k=best_k, bitsaves=bitsaves, motifs=motifs, subspaces=subspaces)


def multidim_subspace(T, m: int, i: int, j: int, k: int,
                      include=None, discords: bool = False) -> np.ndarray:
    """Which k dimensions form the motif (or discord) pair ``(i, j)``: the
    per-dimension z-norm distances between subsequences ``i`` and ``j``,
    sorted ascending (descending in discord mode), with any ``include``
    dimensions pinned first; the first k dimension indices are returned
    (the subset whose mean is the k-dim profile value at ``i``).

    Host-side O(d*m): two subsequences only, no sweep.  Flat
    (zero-variance) subsequences get +inf distance and sort last in both
    modes (an undefined correlation never justifies a subspace).
    """
    T = np.asarray(T, np.float64)
    if T.ndim == 1:
        T = T[None, :]
    d, n = T.shape
    if not (1 <= k <= d):
        raise ValueError(f"k={k} out of range for d={d}")
    for p in (i, j):
        if not (0 <= p <= n - m):
            raise ValueError(f"subsequence {p} out of range (w={n - m + 1})")
    inc = tuple(sorted(int(t) for t in include)) if include else ()
    if inc and not all(0 <= t < d for t in inc):
        raise ValueError(f"include={inc} out of range for d={d}")
    # len(inc) may exceed k: like the device ordering, the prefix then
    # takes the k closest include dimensions.
    dist = np.full(d, np.inf)
    for t in range(d):
        a, b = T[t, i : i + m], T[t, j : j + m]
        ca, cb = a - a.mean(), b - b.mean()
        sa, sb = ca @ ca, cb @ cb
        # The kernels' relative zero-variance clamp, so a numerically
        # constant dimension the profile masked never enters the subspace.
        if sa > ZERO_VARIANCE_REL * (a @ a) and sb > ZERO_VARIANCE_REL * (b @ b):
            p = np.clip((ca @ cb) / np.sqrt(sa * sb), -1.0, 1.0)
            dist[t] = np.sqrt(2.0 * m * (1.0 - p))

    fin = np.isfinite(dist)
    key = np.where(fin, -dist if discords else dist, np.inf)
    order = np.argsort(key, kind="stable")
    if inc:
        inc_sorted = sorted(inc, key=lambda t: key[t])
        rest = [t for t in order if t not in set(inc)]
        order = np.asarray(inc_sorted + rest)
    return order[:k].astype(np.int64)
