"""Self-join with SHARDED inputs: the ring schedule, counterpart of
``mpx/parallel/ring.py``.

:mod:`mpx_torch.parallel.sharding` copies the statistics to every device;
here each shard of the mesh owns one contiguous slice of the subsequence
axis instead: its slice of the series (with the m - 1 halo), its means
and inverse norms, and the profile state of its windows.  The shards'
columns visit each other as in mpx's ring:

* step 0 sweeps each shard against itself (the upper triangle of its
  block, rectangle jobs with ``c0 + W > r0``);
* step s = 1 .. D // 2 moves every shard's column bundle (series, means,
  inverse norms and, in the hybrid's pass B, thresholds) one device down
  the ring (``.to(device, non_blocking=True)``: a no-op between virtual
  shards of one card) and sweeps the pair {d, (d + s) % D} on device d,
  once for each unordered pair (at s = D / 2 only the lower half of the
  devices sweeps);
* each pair gives row and column results, which are sent to the devices
  of their shards and max-merged there (mpx carries the column side in
  the bundle and sends it home after the last step: the same merges).

Each device builds the unit-window panel of its own shard once and that
of each visiting bundle on arrival, so the jobs are the single-device
kernels' (K1 on the card).  K1 masks in its operands' local coordinates
with a one-sided zone (``c - r >= excl``), so a pair is oriented with the
lower global shard as its rows and the bound shifted by the shards'
distance, ``excl - (hi - lo) * shard_w`` (at most one seam's worth of
pairs is inside the zone); each shard's valid width bounds its rows or
columns, so the pad past the series stays masked.  The kernels' indices
are local to the partner's panel and are moved to global coordinates
before they merge.

Two tiers share the schedule:

* :func:`run_ring_sharded` — the one-pass float32 profile (max and
  argmax; K1's f32 launch on the card, the plain sweep for ``kernel='mxu'``
  and on the CPU);
* :func:`run_ring_hybrid_f64` — the exact double tier: pass A (K1's f32
  maxima over the ring, with captures within RING_CAPTURE_BUDGET), each
  shard's thresholds, pass B over the ring (sparse from the captures with
  RING_SUSPECT_F flags a job, else dense), then a pass C sharded over the
  column shards and the exact float64 rescore of
  :func:`mpx_torch.hybrid._resolve_side` on ``mesh[0]``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mpx_torch.dtypes import AGGREGATE_INIT, INDEX_INIT
from mpx_torch.kernels import band_geometry
from mpx_torch.kernels.mxu import SUSPECT_MAX_INIT, SUSPECT_MIN_INIT, SuspectWindow
from mpx_torch.ops.aggregates import init_aggregates, merge_window, pearson_to_euclidean
from mpx_torch.ops.precompute import build_windows, precompute_statistics_numpy
from mpx_torch.parallel.mesh import mesh_for
from mpx_torch.parallel.sharding import interleave
from mpx_torch.types import Aggregates, Stats
from mpx_torch.utils.profile import phase

# mpx's budgets, read from the same environment variables.
# Per-device bytes of the two (shard_w, m) float32 operand panels;
# exceeding it means the shard is too wide for this device count.
RING_PANEL_BUDGET = int(os.environ.get("MPX_RING_PANEL_BUDGET", 10 << 30))
# Flagged rows or columns of a sparse pass-B job in the hybrid ring; a job
# with more is swept densely.
RING_SUSPECT_F = int(os.environ.get("MPX_RING_SUSPECT_F", 256))
# Per-device bytes of pass A's captures (each job's row and column maxima);
# within it pass B is sparse, beyond it dense.
RING_CAPTURE_BUDGET = int(os.environ.get("MPX_RING_CAPTURE_BUDGET", 2 << 30))


def _ring_capture_bytes(D: int, shard_w: int, S: int, W: int) -> int:
    """Per-device bytes of pass A's captures: one (S,) and one (W,) float32
    vector per diagonal job and per rectangle job of each rotation step
    (mpx keeps them as u16, the port as float32)."""
    nr, nc = shard_w // S, shard_w // W
    rr, cc = np.meshgrid(np.arange(nr) * S, np.arange(nc) * W, indexing="ij")
    gd = int((cc.ravel() + W > rr.ravel()).sum())
    gr = nr * nc
    return (gd + (D // 2) * gr) * (S + W) * 4


def _shard_layout(w: int, D: int, band: int, chunk: int) -> int:
    """Per-device shard width: a multiple of both job tile sizes."""
    shard_w = int(np.ceil(w / (D * band)) * band)
    shard_w = max(shard_w, chunk)
    if shard_w % chunk:
        shard_w = int(np.ceil(shard_w / chunk) * chunk)
    if shard_w % band:
        shard_w = int(np.ceil(shard_w / band) * band)
    return shard_w


def _stage_shards(T64, host_stats, w: int, m: int, D: int, shard_w: int, dt, tail: int = 0):
    """Explicit (D, shard) input layouts with the m-1 series halo
    duplicated; pads beyond w carry zeros and are masked by each shard's
    valid width.  Each shard carries ``tail`` more zero windows past its
    own: a sparse pass-B job's pad slots index one window past its tile."""
    pw = shard_w + tail
    Tb = np.zeros((D, pw + m - 1), dt)
    mub = np.zeros((D, pw), dt)
    invb = np.zeros((D, pw), dt)
    Tpad = np.zeros(D * shard_w + m - 1, np.float64)
    Tpad[: T64.shape[0]] = T64
    for d in range(D):
        o = d * shard_w
        Tb[d, : shard_w + m - 1] = Tpad[o : o + shard_w + m - 1].astype(dt)
        sl = host_stats["mu"][o : o + shard_w]
        mub[d, : sl.shape[0]] = sl.astype(dt)
        sl = host_stats["inv"][o : o + shard_w]
        invb[d, : sl.shape[0]] = sl.astype(dt)
    return Tb, mub, invb


def _ring_grids(shard_w: int, S: int, W: int):
    """(diagonal-pair jobs, rectangle-pair jobs) as (r0s, k0s) with
    ``k0 = c0 - r0``: both are rectangle tilings aligned to S and W; the
    diagonal pair keeps only the tiles touching its upper triangle
    (``c0 + W > r0``).  A diagonal-chunk grid would reach past the shard
    when W > S."""
    nr, nc = shard_w // S, shard_w // W
    rr, cc = np.meshgrid(np.arange(nr, dtype=np.int64) * S,
                         np.arange(nc, dtype=np.int64) * W, indexing="ij")
    rr, cc = rr.ravel(), cc.ravel()
    keep = cc + W > rr
    return (rr[keep], cc[keep] - rr[keep]), (rr, cc - rr)


def _check_budget(shard_w: int, m: int, itemsize: int = 4):
    need = 2 * shard_w * m * itemsize
    if need > RING_PANEL_BUDGET:
        raise ValueError(
            f"ring operand panels need {need / 2**30:.1f} GiB/device "
            f"(shard_w={shard_w}, m={m}); raise num_shards or "
            f"MPX_RING_PANEL_BUDGET"
        )


def _ring_setup(T, m: int, D: int, band: int, chunk: int, mesh, host_stats, device,
                dt=np.float32):
    """Shared staging of the ring tiers: host statistics, the shard layout,
    each shard's (series, means, inverse norms) in ``dt`` on its device,
    the job grids and the shards' valid widths."""
    T64 = np.asarray(T, np.float64)
    w = T64.shape[0] - m + 1
    if host_stats is None:
        host_stats = precompute_statistics_numpy(T64, m)
    shard_w = _shard_layout(w, D, band, chunk)
    _check_budget(shard_w, m)
    mesh = mesh_for(D, mesh, device)
    S, W = min(band, shard_w), min(chunk, shard_w)
    Tb, mub, invb = _stage_shards(T64, host_stats, w, m, D, shard_w, dt, tail=max(S, W))
    blocks = [tuple(torch.as_tensor(x[d]).to(mesh[d]) for x in (Tb, mub, invb))
              for d in range(D)]
    diag, rect = _ring_grids(shard_w, S, W)
    return dict(T64=T64, host_stats=host_stats, w=w, m=m, D=D, shard_w=shard_w, mesh=mesh,
                pw=shard_w + max(S, W), blocks=blocks, S=S, W=W, diag=diag, rect=rect,
                widths=[int(np.clip(w - d * shard_w, 0, shard_w)) for d in range(D)])


def _local_stats(block, m: int) -> Stats:
    """A shard's float32 Stats on its device: its float32 unit-window panel
    and inverse norms, the recurrence fields unused.  The panel is built in
    the block's dtype: from float32 series and means (the one-pass ring,
    as the single-device statistics are) or rounded from the exact
    float64 windows (the hybrid ring, as :func:`mpx_torch.hybrid.hybrid_statistics`)."""
    T_blk, mu_blk, inv_blk = block
    dummy = T_blk.new_zeros(1)
    st = Stats(T=T_blk, mu=mu_blk, df=dummy, dg=dummy, inv=inv_blk, qt0=dummy)
    U = build_windows(st, m, torch.float32)
    return Stats(*(x.float() for x in st[:6]), windows=U)


def _steps(D: int) -> list:
    """The ring's steps: for step s, the (device, visiting shard) pairs it
    sweeps.  Step 0 pairs each shard with itself; step s >= 1 pairs device
    d with shard (d + s) % D, for every d while s <= (D - 1) // 2 and, at
    s = D / 2 (even D), for the lower half only: each unordered pair once."""
    out = [[(d, d) for d in range(D)]]
    for s in range(1, D // 2 + 1):
        out.append([(d, (d + s) % D) for d in range(D)
                    if s <= (D - 1) // 2 or d < D // 2])
    return out


def _pair(env, lo: int, hi: int):
    """The jobs and geometry of the pair of shards lo <= hi (rows of lo,
    columns of hi): the tiles that hold a valid pair, and the exclusion
    bound in the pair's local coordinates."""
    S, W, m, sw = env["S"], env["W"], env["m"], env["shard_w"]
    r0s, k0s = env["diag"] if lo == hi else env["rect"]
    wr, wc = env["widths"][lo], env["widths"][hi]
    keep = (r0s < wr) & (r0s + k0s < wc)
    geom = band_geometry(S, W, m, wr, 8, min(2048, W), wc=wc,
                         excl=m // 4 - (hi - lo) * sw)
    return r0s[keep], k0s[keep], geom


def _ring(env, sweep_pair, carried=None):
    """Walk the ring schedule.  ``carried[d]`` is a tuple of shard d's
    tensors that travel with its column bundle (its thresholds).
    ``sweep_pair(dev, lo, hi, st_lo, st_hi, carried_lo, carried_hi, r0s,
    k0s, geom)`` sweeps the pair of shards lo <= hi on device ``dev``
    (``st_hi`` and ``carried_hi`` None for a shard with itself) and returns
    a generator over its jobs; each step's pairs are interleaved across
    devices."""
    D, mesh, m = env["D"], env["mesh"], env["m"]
    carried = carried or [()] * D
    own = [_local_stats(env["blocks"][d], m) for d in range(D)]
    bundles = [(env["blocks"][b], carried[b]) for b in range(D)]
    for s, pairs in enumerate(_steps(D)):
        if s:
            # Bundle b sits on device (b - s) % D at step s.
            bundles = [tuple(tuple(t.to(mesh[(b - s) % D], non_blocking=True) for t in x)
                             for x in bundles[b]) for b in range(D)]
        gens = []
        for d, b in pairs:
            lo, hi = min(d, b), max(d, b)
            r0s, k0s, geom = _pair(env, lo, hi)
            if not len(r0s):
                continue
            if d == b:
                gens.append(sweep_pair(mesh[d], d, d, own[d], None, carried[d], None,
                                       r0s, k0s, geom))
                continue
            sides = {d: (own[d], carried[d]),
                     b: (_local_stats(bundles[b][0], m), bundles[b][1])}
            gens.append(sweep_pair(mesh[d], lo, hi, sides[lo][0], sides[hi][0], sides[lo][1],
                                   sides[hi][1], r0s, k0s, geom))
        interleave(gens)


def _global(idx: torch.Tensor, offset: int, pad: int) -> torch.Tensor:
    """Local window indices of a shard as global ones, the pad value kept."""
    return torch.where(idx == pad, idx, idx + offset)


def run_ring_sharded(
    T,
    m: int,
    *,
    num_shards: int,
    band: int = 4096,
    chunk: int = 16384,
    dtype: str = "float32",
    mesh=None,
    host_stats: dict | None = None,
    kernel: str = "mxu_fused",
    device="cuda",
):
    """One-pass float32 self-join with inputs sharded over a mesh of
    ``num_shards`` devices (default: that many devices of ``device``'s
    type).  ``kernel`` sweeps the jobs: ``mxu_fused`` (K1 on the card, its
    plain version for CPU tensors) or ``mxu`` (the plain sweep).  Returns
    (MP float32, MPI int32) tensors on ``mesh[0]``.  float64 requests run
    :func:`run_ring_hybrid_f64` (`compute_matrix_profile` routes them there)."""
    from mpx_torch.driver import sweep_jobs
    from mpx_torch.dtypes import canonical_dtype

    if canonical_dtype(dtype) == np.dtype(np.float64):
        raise NotImplementedError(
            "one-pass ring sharding is float32; float64 rings run the "
            "exact hybrid tier (run_ring_hybrid_f64)"
        )
    if kernel not in ("mxu", "mxu_fused"):
        raise ValueError(f"the ring sweeps windows matmuls: kernel 'mxu' or 'mxu_fused', "
                         f"got {kernel!r}")
    env = _ring_setup(T, m, num_shards, band, chunk, mesh, host_stats, device)
    sw, mesh = env["shard_w"], env["mesh"]
    state = [init_aggregates(sw, torch.float32, AGGREGATE_INIT, dev) for dev in mesh]

    def sweep_pair(dev, lo, hi, st_r, st_c, _cr, _cc, r0s, k0s, geom):
        rows = init_aggregates(sw, torch.float32, AGGREGATE_INIT, dev)
        cols = init_aggregates(sw, torch.float32, AGGREGATE_INIT, dev)
        yield from sweep_jobs(st_r, r0s, k0s, geom=geom, dtype=torch.float32, kernel=kernel,
                              rows=rows, cols=cols, stats_c=st_c)
        for d, agg, off in ((lo, rows, hi * sw), (hi, cols, lo * sw)):
            merge_window(state[d], Aggregates(agg.value.to(mesh[d]),
                                              _global(agg.index, off, INDEX_INIT).to(mesh[d])), 0)

    _ring(env, sweep_pair)
    w, widths = env["w"], env["widths"]
    V = torch.cat([st.value[:wd].to(mesh[0]) for st, wd in zip(state, widths)])
    I = torch.cat([st.index[:wd].to(mesh[0]) for st, wd in zip(state, widths)])
    return pearson_to_euclidean(V[:w], m), I[:w]


def _ring_pass_c(env, *, excl: int, thr_host: torch.Tensor, exact):
    """The sharded pass C: ``passc_fn(flagged) -> (values, indices,
    counts)`` for :func:`mpx_torch.hybrid._resolve_side`.  The flagged
    rows' float32 unit windows are rounded from their exact float64 ones
    (no device holds the whole query axis), each shard scans its own
    columns (global indices through its offset), and the shards' top-K
    merge into one; the shards' counts add up to the row's count, so a
    count <= K still proves the top-K complete."""
    from mpx_torch.hybrid import _ROW_BLOCK, PASS_C_K, scan_rows

    mesh, sw, m = env["mesh"], env["shard_w"], env["m"]
    T, mu, inv = exact
    panels = []

    def passc_fn(flagged: torch.Tensor):
        if not panels:
            panels.extend(_local_stats(env["blocks"][d], m) for d in range(env["D"]))
        outs = []
        for o in range(0, flagged.shape[0], _ROW_BLOCK):
            fi = flagged[o : o + _ROW_BLOCK].to(T.device).long()
            invf = inv[fi]
            fin_f = torch.isfinite(invf)
            Uf = ((T.unfold(0, m, 1)[fi] - mu[fi][:, None])
                  * torch.where(fin_f, invf, 0.0)[:, None]).float()
            thr_f = thr_host[fi]
            parts = []
            for d, (dev, st) in enumerate(zip(mesh, panels)):
                if env["widths"][d]:
                    part = scan_rows(Uf.to(dev), fin_f.to(dev), thr_f.to(dev),
                                     fi.to(dev, torch.int32), st, w=env["widths"][d],
                                     excl=excl, col_offset=d * sw)
                    parts.append([t.to(T.device) for t in part])
            bv, sel = torch.cat([p[0] for p in parts], dim=1).topk(PASS_C_K, dim=1)
            bi = torch.cat([p[1] for p in parts], dim=1).gather(1, sel)
            outs.append((bv, bi, sum(p[2] for p in parts)))
        return tuple(torch.cat(x) for x in zip(*outs))

    return passc_fn


def run_ring_hybrid_f64(
    T,
    m: int,
    *,
    num_shards: int,
    band: int = 4096,
    chunk: int = 16384,
    margin: float | None = None,
    mesh=None,
    host_stats: dict | None = None,
    suspect_f: int | None = None,
    profile=None,
    device="cuda",
):
    """Exact double-precision self-join with SHARDED inputs: the hybrid's
    evidence chain (:mod:`mpx_torch.hybrid`: float32 passes bound the
    float64 optimum, an exact rescore decides) over the ring schedule.

    1. ring pass A: K1's f32 row and column maxima of every pair's jobs
       (captured when they fit RING_CAPTURE_BUDGET), folded per shard;
    2. each shard's thresholds ``gmax32 - 2 margin``;
    3. ring pass B: the suspects of every pair, sparse from the captures
       (a job with more than ``suspect_f`` (RING_SUSPECT_F) flagged rows or
       columns dense) or dense without captures;
    4. :func:`mpx_torch.hybrid._resolve_side` on ``mesh[0]``: the exact
       float64 rescore, plateau runs, the sharded pass C and row scans.

    Returns (MP float64, MPI int32) tensors on ``mesh[0]``; ``profile``
    takes the phases and, in ``profile.counts``, pass B's route, jobs and
    the escalated rows."""
    from mpx_torch.hybrid import (
        _build_thr,
        _combine_suspects,
        _init_suspects,
        _resolve_side,
        default_margin,
        max_jobs,
        run_suspect_jobs,
        run_suspect_jobs_sparse,
    )
    from mpx_torch.utils.profile import BenchmarkProfile

    D = num_shards
    margin = default_margin(m) if margin is None else margin
    F = RING_SUSPECT_F if suspect_f is None else suspect_f
    with phase(profile, "1. Pre-Computation [host f64]"):
        env = _ring_setup(T, m, D, band, chunk, mesh, host_stats, device, np.float64)
    mesh, sw, w, S, W = env["mesh"], env["shard_w"], env["w"], env["S"], env["W"]
    widths, excl, pw = env["widths"], m // 4, env["pw"]
    sparse = _ring_capture_bytes(D, sw, S, W) <= RING_CAPTURE_BUDGET

    gmax = [torch.full((pw,), AGGREGATE_INIT, dtype=torch.float32, device=dev) for dev in mesh]
    caps = {}

    def pass_a(dev, lo, hi, st_r, st_c, _cr, _cc, r0s, k0s, geom):
        rmax, cmax, caps[lo, hi] = max_jobs(st_r, r0s, k0s, geom, capture=sparse,
                                            stats_c=st_c)
        yield
        for d, v in ((lo, rmax), (hi, cmax)):
            g = gmax[d][: v.shape[0]]
            torch.maximum(g, v[: g.shape[0]].to(mesh[d]), out=g)

    with phase(profile, f"2. Compute [ring f32 pass A x{D}]", device=mesh[0]):
        _ring(env, pass_a)
        # gmax32 - 2 margin (in float32, as mpx), +inf where no valid pair
        # was seen and past the shard's valid width.
        thr = [_build_thr(g, g, margin, w=wd, pw=pw) for g, wd in zip(gmax, widths)]

    sus = [_init_suspects(wd, dev) for wd, dev in zip(widths, mesh)]
    counted = BenchmarkProfile()
    jobs = dense = 0

    def pass_b(dev, lo, hi, st_r, st_c, cr, cc, r0s, k0s, geom):
        nonlocal jobs, dense
        kw = dict(S=S, W=W, m=m, w=widths[lo], thr_col=None if cc is None else cc[0],
                  combine=False, stats_c=st_c, wc=widths[hi], excl=geom.excl)
        if sparse:
            rows, cols = run_suspect_jobs_sparse(st_r, cr[0], caps.pop((lo, hi)),
                                                 profile=counted, budget=F, **kw)
            dense += counted.counts["dense_jobs"]
        else:
            rows, cols = run_suspect_jobs(st_r, cr[0], r0s, k0s, **kw)
            dense += len(r0s)
        jobs += len(r0s)
        yield
        for d, win, off in ((lo, rows, hi * sw), (hi, cols, lo * sw)):
            win = SuspectWindow(win.cnt.to(mesh[d]),
                                _global(win.mn, off, SUSPECT_MIN_INIT).to(mesh[d]),
                                _global(win.mx, off, SUSPECT_MAX_INIT).to(mesh[d]))
            sus[d] = _combine_suspects(sus[d], win)

    with phase(profile, f"2. Compute [ring f32 pass B x{D}]", device=mesh[0]):
        _ring(env, pass_b, carried=[(t,) for t in thr])
    if profile is not None:
        profile.counts.update({"pass_b": "sparse" if sparse else "dense", "jobs": jobs,
                               "dense_jobs": dense, "shards": D})

    dev0 = mesh[0]
    hs = env["host_stats"]
    exact = tuple(torch.as_tensor(np.asarray(x, np.float64), device=dev0)
                  for x in (env["T64"], hs["mu"][:w], hs["inv"][:w]))
    thr_host = torch.cat([t[:wd].to(dev0) for t, wd in zip(thr, widths)])
    allsus = SuspectWindow(*(torch.cat([getattr(x, f).to(dev0) for x in sus])
                             for f in SuspectWindow._fields))
    bestP, bestI = _resolve_side(
        allsus, w, m, stats_q=None, stats_t=None, thr_q=None, exact_q=exact, exact_t=exact,
        excl=excl, wt=w, profile=profile,
        passc_fn=_ring_pass_c(env, excl=excl, thr_host=thr_host, exact=exact))
    with phase(profile, "4. Post-Computation", device=dev0):
        return torch.sqrt(torch.clamp(2.0 * m * (1.0 - bestP), min=0.0)), bestI
