"""Hybrid double-precision tier: float32 sweeps + exact float64 rescoring.

Counterpart of ``mpx/hybrid.py`` (``kernel='hybrid'``): the self-join
(:func:`compute_matrix_profile_f64_hybrid`), the left/right profiles
(:func:`compute_left_right_f64_hybrid`), the AB-join
(:func:`compute_ab_join_f64_hybrid`: rows from one series, columns from
the other, no exclusion zone; each series is one side) and the k nearest
neighbors (:func:`compute_topk_profile_f64_hybrid`: the same passes in
rounds of per-row threshold descent, see there).  All O(n^2) work
runs in float32; only the few suspects of each subsequence are scored in
float64:

1. **Pass A** — K1's float32 sweep (split TF32 on the card,
   :func:`mpx_torch.kernels.mxu_fused.sweep_band_max_fused`) gives every
   job's per-row and per-column maxima.  Below ``SPARSE_MAX_W`` windows,
   and when they fit the device, they are kept (the captures).  They are
   folded into each subsequence's maximum ``gmax32`` and its threshold
   ``thr = gmax32 - 2 * margin``; the left/right profiles and the AB-join
   keep one threshold per side (rows: later neighbors or the first
   series, columns: earlier ones or the second).
2. **Pass B** — with captures (sparse), each job re-examines only the rows
   and columns whose pass-A job maximum reaches ``thr``: every valid pair
   at or above ``thr`` is counted and the SUSPECT_K smallest and largest
   neighbor indices are kept (associative merges; the job grid covers
   each pair once).  The flag counts of all jobs are fetched once; a job
   whose count exceeds :func:`_sparse_budget` is swept densely instead.
   Without captures every job is swept densely.
3. **Resolve** — the captured suspects are rescored exactly in float64 on
   the run's device.  A subsequence whose count overflows the 2K slots
   rescores its whole captured index interval when that is <= 64 wide
   (plateau runs); otherwise **pass C** recomputes its full row in float32
   with a streaming top-64 and a count at or above ``thr``, and the top-64
   are rescored.  A count above 64 gets an exact float64 row scan.  The
   left/right profiles resolve each side on its own, every stage kept to
   that side's neighbors; the AB-join resolves each series against the
   other.

Correctness needs only that each float32 pass be within ``margin`` of the
float64 truth for every pair: the true argmax c* then has
``P32(c*) >= P64(c*) - margin >= gmax32 - 2 margin = thr``, so it is always a
suspect, and a pair below ``thr`` has ``P64 < gmax32 - margin <= best64``,
so it can never win (per side, with that side's maximum, for the
left/right profiles).  Passes A and B may therefore use different float32
arithmetic (split TF32 in K1, FP32 products in passes B and C on the
card).  The rescored values are exact float64, so the profile does not
depend on them.

Passes B and C are torch ops (``torch.matmul`` of float32 panels in full
FP32), as mpx lowers them through XLA; the exact stages use mpx's formula
(centered-window dot x inv x inv) in float64 tensors on the run's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mpx_torch.config import MatrixProfileConfig, config_for, make_job_grid
from mpx_torch.dtypes import AGGREGATE_INIT, INDEX_INIT, full_precision_matmul
from mpx_torch.kernels.common import NO_EXCL, band_geometry
from mpx_torch.kernels.mxu import (
    SUSPECT_K,
    SUSPECT_MAX_INIT,
    SUSPECT_MIN_INIT,
    SuspectWindow,
    sweep_band_suspects,
    sweep_band_suspects_sparse,
)
from mpx_torch.kernels.mxu_fused import sweep_band_max_fused
from mpx_torch.ops.precompute import (
    build_windows,
    precompute_statistics,
    precompute_statistics_numpy,
)
from mpx_torch.types import Stats
from mpx_torch.utils.logging import Logger
from mpx_torch.utils.profile import phase

# The arithmetic of the float32 passes.  mpx runs them at its HIGH
# precision (three bf16 passes); the port's are at least as exact: pass A
# is K1's split TF32 (three TF32 products, ~2^-22 relative each), passes B
# and C are full FP32 products.  Phase 11 of chip_smoke.py measures both
# against float64 on the card.
HYBRID_PRECISION = "split-TF32 (pass A, K1), FP32 (passes B and C)"
# mpx's measured bound on its HIGH products' truncation, kept in the
# margin so the port's margin is mpx's (see default_margin).
_HIGH_TRUNC_BOUND = 2e-5

# Capture-overflow escalation: plateau-run width and pass C's top-K.
RUNCAP = 64
PASS_C_K = 64
PASS_C_COLS = 16384
# Rows of one pass-C / row-scan block, and windows of one column block of
# the row scan (bounded device memory at any width).
_ROW_BLOCK = 2048
_SCAN_COLS = 65536
# Bytes of the window operands of one rescoring block.
_RESCORE_BYTES = 256 << 20
# The top-k hybrid's knobs, mpx's defaults (mpx reads them from
# MPX_TOPK_CAP, MPX_TOPK_K1, MPX_TOPK_K2 and MPX_TOPK_RUNCAP; the port reads
# no environment variable).  TOPK_CAP: how far below the 1-NN threshold the
# seeded k-NN threshold may start; TOPK_K1 / TOPK_K2: pass C's slots on a
# row's first and its wide scan; TOPK_RUNCAP: the widest plateau bracket
# that is rescored whole.  They move rows between stages, never results.
TOPK_CAP = 8e-3
TOPK_K1 = 64
TOPK_K2 = 512
TOPK_RUNCAP = 512
# Rounds of threshold descent before the rows left take the exact scan.
TOPK_MAX_IT = 8
# Rows of one plateau-bracket rescore of the top-k hybrid.
_TOPK_ROW_CHUNK = 16384
# Jobs whose captures one step of _job_kth_max folds in.
_KTH_GROUP = 256
# Widths from which pass A keeps no captures and pass B sweeps every job
# densely: mpx's gate (``_sparse_ok``), whose captures cost (S + W) x 4
# bytes a job (38.8 GB at w = 2^23, band 4096, chunk 32768).
SPARSE_MAX_W = 2**23
# Device memory left free beside the captures: pass B's dense tile and its
# masks (~2 GB at S = 4096, W = 32768) and the row scans' blocks (~1.5 GB).
_CAPTURE_HEADROOM = 4 << 30
# Jobs between two saves of a checkpointed run (mpx_torch.checkpoint): pass
# A's groups and pass B's merge groups.  Part of the checkpoint's
# fingerprint.
CKPT_JOBS = 256


def default_margin(m: int) -> float:
    """Per-pair error budget of the float32 passes: mpx's value at its
    HIGH precision, ``max(1e-4, 4e-7 m) + 4 * 2e-5`` (its worst reading,
    2.4e-5 at m = 256 over 5.5e11 pairs, with a 4x safety factor, linear in
    m, plus 4x its bf16-pass truncation bound).  The port's passes must
    stay within a quarter of it: ``chip_smoke.py`` phase 11 reads them on
    the card."""
    return max(1e-4, 4e-7 * m) + 4 * _HIGH_TRUNC_BOUND


def capture_bytes(jobs: int, S: int, W: int) -> int:
    """Bytes of pass A's captures: every job's (S,) row and (W,) column
    maxima in float32."""
    return jobs * (S + W) * 4


def _sparse_ok(w: int, nbytes: int, device) -> bool:
    """Whether pass A keeps its captures (``nbytes`` of them) for the
    sparse pass B: widths below SPARSE_MAX_W, as mpx, and on a card only
    when they fit its free memory less _CAPTURE_HEADROOM."""
    if w >= SPARSE_MAX_W:
        return False
    if torch.device(device).type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return nbytes <= free - _CAPTURE_HEADROOM
    return True


def _side_zone(delta: torch.Tensor, excl: int, side: int) -> torch.Tensor:
    """Pairs (r, r + delta) outside the exclusion zone on the given side:
    +1 later neighbors (``delta >= excl``), -1 earlier ones
    (``-delta >= excl``), 0 both."""
    if side > 0:
        return delta >= excl
    if side < 0:
        return -delta >= excl
    return delta.abs() >= excl


def _combine_suspects(a: SuspectWindow, b: SuspectWindow) -> SuspectWindow:
    """Elementwise merge of two suspect summaries over the same axis:
    counts add; the K smallest (largest) of the union come from a sort of
    the two K-vectors side by side."""
    K = SUSPECT_K
    return SuspectWindow(
        cnt=a.cnt + b.cnt,
        mn=torch.cat([a.mn, b.mn], dim=1).sort(dim=1).values[:, :K],
        mx=torch.cat([a.mx, b.mx], dim=1).sort(dim=1, descending=True).values[:, :K],
    )


def _init_suspects(L: int, device) -> SuspectWindow:
    return SuspectWindow(
        cnt=torch.zeros(L, dtype=torch.int32, device=device),
        mn=torch.full((L, SUSPECT_K), SUSPECT_MIN_INIT, dtype=torch.int32, device=device),
        mx=torch.full((L, SUSPECT_K), SUSPECT_MAX_INIT, dtype=torch.int32, device=device),
    )


def _merge_suspects_at(g: SuspectWindow, win: SuspectWindow, offset: int) -> None:
    """Merge a job's summary ``win`` into the global summary ``g`` in
    place, at ``offset``."""
    cur = SuspectWindow(*(a[offset : offset + win.cnt.shape[0]] for a in g))
    for a, b in zip(cur, _combine_suspects(cur, win)):
        a.copy_(b)


def _merge_many(g: SuspectWindow, pos: torch.Tensor, win: SuspectWindow) -> None:
    """Merge many summaries into ``g`` in place, entry i at position
    ``pos[i]`` (positions may repeat): counts add; each position keeps the
    K smallest ``mn`` and K largest ``mx`` of its entries and its own.  One
    sort of (position, value) keys does it for all positions at once."""
    K, L = SUSPECT_K, g.cnt.shape[0]
    p = pos.long()
    g.cnt.index_add_(0, p, win.cnt)
    at = torch.cat([torch.arange(L, device=p.device), p]).repeat_interleave(K) << 32
    for dst, src, desc in ((g.mn, win.mn, False), (g.mx, win.mx, True)):
        # Values lie in [-1, 2^30]: an offset (ascending) or a reflection
        # (descending) maps them into 32 bits below the position.
        v = torch.cat([dst, src]).reshape(-1).long()
        key = (at | ((2**30 - v) if desc else (v + 1))).sort().values
        p_s = key >> 32
        v_s = key & (2**32 - 1)
        v_s = (2**30 - v_s) if desc else (v_s - 1)
        rank = torch.arange(key.shape[0], device=p.device) - torch.searchsorted(p_s, p_s)
        slot = torch.where(rank < K, p_s * K + rank, L * K)  # the rest to a dropped slot
        flat = dst.new_empty(L * K + 1)
        flat.scatter_(0, slot, v_s.to(dst.dtype))
        dst.copy_(flat[: L * K].view(L, K))


def _finish_suspects(rows_g: SuspectWindow, cols_g: SuspectWindow, *, w: int,
                     combine: bool, wc: Optional[int] = None):
    """The global row-axis and column-axis summaries cut to the profiles
    (``w`` rows, ``wc`` columns, default ``w``): folded into one per
    subsequence (``combine``, the self-join), or apart as (row side: later
    neighbors or the first series, column side: earlier ones or the
    second)."""
    rows = SuspectWindow(*(a[:w] for a in rows_g))
    cols = SuspectWindow(*(a[: w if wc is None else wc] for a in cols_g))
    return _combine_suspects(rows, cols) if combine else (rows, cols)


def _sparse_budget(S: int, W: int) -> int:
    """Flag budget of a sparse pass-B job (mpx's): a job with more flagged
    rows or columns is swept densely."""
    return min(S, W, max(256, (S + W) // 32))


# ---------------------------------------------------------------- pass A


def _build_thr(rmax, cmax, margin: float, *, w: int, pw: int, combine: bool = True,
               wc: Optional[int] = None, pwc: Optional[int] = None):
    """Fold pass A's maxima into the suspect thresholds, (pw,) float32:
    ``gmax32 - 2 margin`` (in float32, as mpx), +inf for windows with no
    valid pair (they would flag in every job) and in the pad tail.  With
    ``combine`` one threshold from both maxima; without, (rows from the
    row maxima only, columns from the column maxima only: (pwc,) over the
    ``wc`` columns, defaults ``pw`` and ``w``)."""
    dev = rmax.device
    two_eps = (torch.tensor(2.0, dtype=torch.float32)
               * torch.tensor(margin, dtype=torch.float32)).to(dev)

    def fold(gmax, width, padded):
        thr = torch.full((padded,), torch.inf, dtype=torch.float32, device=dev)
        thr[:width] = torch.where(gmax[:width] > AGGREGATE_INIT, gmax[:width] - two_eps,
                                  torch.inf)
        return thr

    if combine:
        return fold(torch.maximum(rmax[:w], cmax[:w]), w, pw)
    return (fold(rmax, w, pw),
            fold(cmax, w if wc is None else wc, pw if pwc is None else pwc))


def run_max_jobs(stats, r0s, k0s, margin: float, *, S: int, W: int, m: int, w: int,
                 pw: int, combine: bool = True, capture: bool = True, stats_c=None,
                 wc: Optional[int] = None, pwc: Optional[int] = None,
                 excl: Optional[int] = None, ckpt=None):
    """Pass A: one K1 float32 launch per job (the plain sweep for CPU
    tensors), max-merged into (w + S,) row and (wc + W,) column maxima and
    folded into the thresholds (see :func:`_build_thr`; a pair
    ``(rows, columns)`` without ``combine``).  ``stats_c``, ``wc``,
    ``pwc`` and ``excl`` carry an AB-join's geometry (the columns' series,
    width, padded width, and :data:`NO_EXCL`); by default the self-join's.
    Returns (thresholds, captures): with ``capture`` the captures
    ``(r0s, k0s, jrow (J, S), jcol (J, W))`` are each job's per-row and
    per-column maxima, pass B's skip oracle; without, None and nothing is
    kept.

    ``ckpt`` (:class:`mpx_torch.checkpoint.HybridCheckpoint`, self-join
    only) persists the maxima after every :data:`CKPT_JOBS` jobs and
    resumes from a saved group; the jobs before it have no captures and are
    listed in ``ckpt.uncaptured`` for a dense pass B."""
    geom = band_geometry(S, W, m, w, wc=wc, excl=excl)
    rmax, cmax, cap = max_jobs(stats, r0s, k0s, geom, capture=capture, stats_c=stats_c,
                               ckpt=ckpt)
    thr = _build_thr(rmax, cmax, margin, w=w, pw=pw, combine=combine, wc=wc, pwc=pwc)
    return thr, cap


def max_jobs(stats, r0s, k0s, geom, *, capture: bool, stats_c=None, ckpt=None):
    """Pass A's sweep (see :func:`run_max_jobs`): the (w + S,) row and
    (wc + W,) column maxima over the jobs, AGGREGATE_INIT where nothing
    valid was seen, and the captures (or None)."""
    S, W, w = geom.S, geom.W, geom.w
    dev = stats.windows.device
    r0s, k0s = np.asarray(r0s, np.int64), np.asarray(k0s, np.int64)
    rmax = torch.full((w + S,), AGGREGATE_INIT, dtype=torch.float32, device=dev)
    cmax = torch.full((geom.wc + W,), AGGREGATE_INIT, dtype=torch.float32, device=dev)
    if capture:
        jrow = torch.empty((len(r0s), S), dtype=torch.float32, device=dev)
        jcol = torch.empty((len(r0s), W), dtype=torch.float32, device=dev)
    start = 0
    if ckpt is not None and (st := ckpt.load_a()) is not None:
        rmax.copy_(torch.as_tensor(st[0]))
        cmax.copy_(torch.as_tensor(st[1]))
        start = min(st[2] * CKPT_JOBS, len(r0s))
        ckpt.uncaptured = np.arange(start)
        Logger.info(f"hybrid pass A: resuming at job {start}/{len(r0s)}")
    for j in range(start, len(r0s)):
        r0, k0 = int(r0s[j]), int(k0s[j])
        rv, cv = sweep_band_max_fused(stats, r0, k0, geom, stats_c)
        seg_r, seg_c = rmax[r0 : r0 + S], cmax[r0 + k0 : r0 + k0 + W]
        torch.maximum(seg_r, rv, out=seg_r)
        torch.maximum(seg_c, cv, out=seg_c)
        if capture:
            jrow[j].copy_(rv)
            jcol[j].copy_(cv)
        if ckpt is not None and ((j + 1) % CKPT_JOBS == 0 or j + 1 == len(r0s)):
            ckpt.save_a(rmax, cmax, -(-(j + 1) // CKPT_JOBS))
    return rmax, cmax, ((r0s, k0s, jrow, jcol) if capture else None)


# ---------------------------------------------------------------- pass B


def _dense_jobs(stats, thr, r0s, k0s, geom, rows_g: SuspectWindow,
                cols_g: SuspectWindow, thr_col=None, stats_c=None, ckpt=None) -> None:
    """Sweep the jobs' whole tiles, merging each job's summaries into the
    global row-axis and column-axis ones; with ``ckpt``, the state is saved
    and the jobs marked done after every :data:`CKPT_JOBS` of them."""
    r0s, k0s = np.asarray(r0s).tolist(), np.asarray(k0s).tolist()
    for j, (r0, k0) in enumerate(zip(r0s, k0s)):
        out = sweep_band_suspects(stats, r0, k0, geom, thr, thr_col, stats_c)
        _merge_suspects_at(rows_g, out.row, r0)
        _merge_suspects_at(cols_g, out.col, r0 + k0)
        if ckpt is not None and ((j + 1) % CKPT_JOBS == 0 or j + 1 == len(r0s)):
            lo = j // CKPT_JOBS * CKPT_JOBS
            ckpt.mark_done_and_save(rows_g, cols_g, r0s[lo : j + 1], k0s[lo : j + 1])


def run_suspect_jobs(stats, thr, r0s, k0s, *, S: int, W: int, m: int, w: int,
                     thr_col=None, combine: bool = True, stats_c=None,
                     wc: Optional[int] = None, excl: Optional[int] = None, ckpt=None):
    """Dense pass B over the given jobs (the reference of the sparse pass
    B, and the route without captures).  ``thr_col`` is the column side's
    threshold (default ``thr``), ``stats_c``/``wc``/``excl`` an AB-join's
    geometry (:func:`run_max_jobs`); returns one summary per subsequence,
    or the row and column sides apart without ``combine``
    (:func:`_finish_suspects`).  ``ckpt`` as for :func:`_dense_jobs`."""
    dev = stats.windows.device
    geom = band_geometry(S, W, m, w, wc=wc, excl=excl)
    rows_g, cols_g = _init_suspects(w + S, dev), _init_suspects(geom.wc + W, dev)
    _dense_jobs(stats, thr, r0s, k0s, geom, rows_g, cols_g, thr_col, stats_c, ckpt)
    return _finish_suspects(rows_g, cols_g, w=w, wc=wc, combine=combine)


def _flag_counts(thr, r0s, k0s, jrow, jcol, *, S: int, W: int, thr_col=None,
                 block: int = 256) -> np.ndarray:
    """(J, 2) flagged rows and columns of every job, from pass A's
    captures, with the comparisons the sparse jobs make (the columns
    against ``thr_col``, default ``thr``); computed on the device in blocks
    of jobs and fetched once."""
    dev = thr.device
    r0 = torch.as_tensor(r0s, dtype=torch.int64, device=dev)
    c0 = r0 + torch.as_tensor(k0s, dtype=torch.int64, device=dev)
    tr = thr.unfold(0, S, 1)
    tc = (thr if thr_col is None else thr_col).unfold(0, W, 1)
    out = []
    for o in range(0, r0.shape[0], block):
        sl = slice(o, o + block)
        nr = (jrow[sl] >= tr.index_select(0, r0[sl])).sum(dim=1, dtype=torch.int32)
        nc = (jcol[sl] >= tc.index_select(0, c0[sl])).sum(dim=1, dtype=torch.int32)
        out.append(torch.stack([nr, nc], dim=1))
    return torch.cat(out).cpu().numpy()


def run_suspect_jobs_sparse(stats, thr, cap, *, S: int, W: int, m: int, w: int,
                            thr_col=None, combine: bool = True, profile=None,
                            stats_c=None, wc: Optional[int] = None,
                            excl: Optional[int] = None, ckpt=None,
                            budget: Optional[int] = None):
    """Sparse pass B: each job re-examines only the rows and columns its
    pass-A captures flag, at its exact flag counts (fetched once for all
    jobs); a job with more flagged rows or columns than ``budget``
    (default :func:`_sparse_budget`) takes the dense sweep.  Same result as
    :func:`run_suspect_jobs` over all jobs (and the same arguments).

    With ``ckpt`` the sparse jobs merge and are saved in groups of
    :data:`CKPT_JOBS` (without it, in one merge); the jobs whose captures
    a resumed pass A lost (``ckpt.uncaptured``) take the dense sweep, and
    every dense job stays pending until its own sweep lands."""
    r0s, k0s, jrow, jcol = cap
    geom = band_geometry(S, W, m, w, wc=wc, excl=excl)
    dev = stats.windows.device
    rows_g, cols_g = _init_suspects(w + S, dev), _init_suspects(geom.wc + W, dev)
    with phase(profile, "2. Compute [pass B sparse]", device=dev):
        counts = _flag_counts(thr, r0s, k0s, jrow, jcol, S=S, W=W, thr_col=thr_col)
        lost = np.zeros(len(r0s), bool)
        if ckpt is not None:
            lost[ckpt.uncaptured] = True
            counts[lost] = 0  # their captures were never written
        budget = _sparse_budget(S, W) if budget is None else budget
        dense = lost | (counts.max(axis=1) > budget)
        sparse = np.nonzero(~dense)[0]
        step = CKPT_JOBS if ckpt is not None else max(1, len(sparse))
        for lo in range(0, len(sparse), step):
            group = sparse[lo : lo + step]
            found = ([], [])  # (positions, summaries) of the row and column sides
            for j in group[counts[group].max(axis=1) > 0].tolist():
                for side, got in zip(found, sweep_band_suspects_sparse(
                        stats, r0s[j], k0s[j], jrow[j], jcol[j], geom, thr,
                        *(int(x) for x in counts[j]), thr_col=thr_col, stats_c=stats_c)):
                    if got is not None:
                        side.append(got)
            # One merge for the group's jobs: their summaries land in one sort.
            for g, side in zip((rows_g, cols_g), found):
                if side:
                    pos, wins = zip(*side)
                    _merge_many(g, torch.cat(pos), SuspectWindow(*map(torch.cat, zip(*wins))))
            if ckpt is not None:
                ckpt.mark_done_and_save(rows_g, cols_g, r0s[group], k0s[group])
    if dense.any():
        Logger.verbose_log(f"hybrid sparse pass B: {int(dense.sum())} job(s) over the "
                           "flag budget or without captures to the dense sweep")
    with phase(profile, "2. Compute [pass B dense]", device=dev):
        _dense_jobs(stats, thr, r0s[dense], k0s[dense], geom, rows_g, cols_g, thr_col,
                    stats_c, ckpt)
    if profile is not None:
        flags = counts.max(axis=1)
        profile.counts.update({
            "jobs": int(len(flags)), "flags_per_job_mean": float(flags.mean()),
            "flags_per_job_p99": float(np.percentile(flags, 99)),
            "flags_per_job_max": int(flags.max()), "dense_jobs": int(dense.sum()),
            "jobs_without_flags": int((flags == 0).sum())})
    return _finish_suspects(rows_g, cols_g, w=w, wc=wc, combine=combine)


# ---------------------------------------------------------------- sharded passes
# Passes A and B with the jobs dealt over a mesh (mpx's multi-chip route,
# as :mod:`mpx_torch.parallel.sharding`): each shard sweeps its share into
# its own maxima or suspect summaries, which merge with the same
# associative operators on ``mesh[0]``.  Pass C and the exact stages stay
# on one device: they are O(flagged), not O(n^2).


def _shard_jobs(grid, num_shards: int, stats, mesh):
    """The mesh (default: ``num_shards`` devices of the statistics' type),
    the statistics on each of its devices, and each shard's round-robin
    share of the jobs."""
    from mpx_torch.parallel.mesh import mesh_for
    from mpx_torch.parallel.sharding import replicate, shard_jobs

    mesh = mesh_for(num_shards, mesh, stats.windows.device)
    return mesh, replicate(stats, mesh), shard_jobs(grid, num_shards)


def run_max_jobs_sharded(stats, grid, margin: float, *, num_shards: int, S: int, W: int,
                         m: int, w: int, tr: int, tc: int, pw: int, mesh=None):
    """Sharded pass A: each shard max-sweeps its jobs (K1's f32 launch on
    the card); the maxima max-merge into one threshold array on
    ``mesh[0]`` (:func:`_build_thr`)."""
    mesh, sts, shares = _shard_jobs(grid, num_shards, stats, mesh)
    geom = band_geometry(S, W, m, w, tr, tc)
    parts = [max_jobs(st, jobs.r0, jobs.k0, geom, capture=False)[:2]
             for st, jobs in zip(sts, shares)]
    rmax, cmax = (torch.stack([p[k].to(mesh[0]) for p in parts]).amax(dim=0) for k in (0, 1))
    return _build_thr(rmax, cmax, margin, w=w, pw=pw)


def run_suspect_jobs_sharded(stats, thr, grid, *, num_shards: int, S: int, W: int, m: int,
                             w: int, tr: int, tc: int, mesh=None):
    """Sharded pass B (dense): each shard's suspect summaries, folded over
    the shards on ``mesh[0]`` (counts add, the K smallest and largest
    indices kept), then the row and column sides per subsequence."""
    from mpx_torch.parallel.sharding import replicate

    mesh, sts, shares = _shard_jobs(grid, num_shards, stats, mesh)
    geom = band_geometry(S, W, m, w, tr, tc)
    parts = []
    for dev, st, t, jobs in zip(mesh, sts, replicate(thr, mesh), shares):
        parts.append((_init_suspects(w + S, dev), _init_suspects(w + W, dev)))
        _dense_jobs(st, t, jobs.r0, jobs.k0, geom, *parts[-1])
    folded = [SuspectWindow(*(a.to(mesh[0]) for a in g)) for g in parts[0]]
    for part in parts[1:]:
        folded = [_combine_suspects(a, SuspectWindow(*(x.to(mesh[0]) for x in b)))
                  for a, b in zip(folded, part)]
    return _finish_suspects(*folded, w=w, combine=True)


# ---------------------------------------------------------------- pass C


def scan_flagged_rows(stats, thr, flag_idx, *, w: int, excl: int, side: int = 0,
                      stats_t=None, K: Optional[int] = None):
    """Pass C: for each flagged subsequence, recompute its full float32
    correlation row in PASS_C_COLS columns at a time, keep the top K
    (default PASS_C_K; the top-k hybrid's wide scan takes more) by a
    streaming merge, and count the pairs at or above ``thr``: a count <= K
    proves the top-K holds every suspect.  ``side`` keeps the neighbors of
    one side (:func:`_side_zone`: +1 later, -1 earlier, 0 both).
    ``stats_t`` is the target series (an AB-join's other one; default
    ``stats``) and ``w`` its width.  Returns (values (F, K), indices (F,
    K), -1 where empty; counts (F,))."""
    stats_t = stats if stats_t is None else stats_t
    dev = stats_t.windows.device
    outs = []
    for o in range(0, flag_idx.shape[0], _ROW_BLOCK):
        fi = flag_idx[o : o + _ROW_BLOCK].to(dev, torch.int32)
        outs.append(scan_rows(stats.windows.index_select(0, fi),
                              torch.isfinite(stats.inv.index_select(0, fi)),
                              thr.index_select(0, fi), fi, stats_t, w=w, excl=excl,
                              side=side, K=K))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def scan_rows(Uf, fin_f, thr_f, fi, stats_t, *, w: int, excl: int, side: int = 0,
              K: Optional[int] = None, col_offset: int = 0):
    """Pass C over one block of query rows given by their float32 unit
    windows ``Uf``, finite masks ``fin_f``, thresholds ``thr_f`` and global
    indices ``fi``, against the first ``w`` windows of ``stats_t``, whose
    window j is global window ``col_offset + j`` (a ring's column shard);
    see :func:`scan_flagged_rows`.  Indices are global."""
    K, CW = PASS_C_K if K is None else K, PASS_C_COLS
    U = stats_t.windows
    dev = U.device
    fin = torch.isfinite(stats_t.inv)
    F = fi.shape[0]
    bv = torch.full((F, K), AGGREGATE_INIT, dtype=torch.float32, device=dev)
    bi = torch.full((F, K), INDEX_INIT, dtype=torch.int32, device=dev)
    cnt = torch.zeros(F, dtype=torch.int32, device=dev)
    for c0 in range(0, w, CW):
        c1 = min(c0 + CW, w)
        cols = torch.arange(col_offset + c0, col_offset + c1, dtype=torch.int32, device=dev)
        valid = (_side_zone(cols[None, :] - fi[:, None], excl, side)
                 & fin_f[:, None] & fin[c0:c1][None, :])
        with full_precision_matmul():
            P = Uf @ U[c0:c1].T
        P.masked_fill_(~valid, AGGREGATE_INIT)
        cnt += (P >= thr_f[:, None]).sum(dim=1, dtype=torch.int32)
        v, loc = P.topk(min(K, c1 - c0), dim=1)
        av = torch.cat([bv, v], dim=1)
        ai = torch.cat([bi, loc.to(torch.int32) + col_offset + c0], dim=1)
        bv, sel = av.topk(K, dim=1)
        bi = ai.gather(1, sel)
    return bv, torch.where(bv > AGGREGATE_INIT, bi, INDEX_INIT), cnt


# ---------------------------------------------------------------- exact stages


def _rescore_pairs_ab(Tq, muq, invq, Tt, mut, invt, m: int, rows, cols) -> torch.Tensor:
    """Exact float64 Pearson correlation of the pairs (query rows[i],
    target cols[i]), mpx's formula (centered-window dot x inv x inv);
    AGGREGATE_INIT where cols[i] < 0 or either window has zero variance.
    Float64 tensors on the run's device; only the valid pairs are
    gathered."""
    dev = Tq.device
    rows = torch.as_tensor(rows, device=dev).long()
    cols = torch.as_tensor(cols, device=dev).long()
    P = torch.full(rows.shape, AGGREGATE_INIT, dtype=torch.float64, device=dev)
    cc = cols.clamp_min(0)
    ok = (cols >= 0) & torch.isfinite(invt)[cc] & torch.isfinite(invq)[rows]
    idx = torch.nonzero(ok).flatten()
    win_q, win_t = Tq.unfold(0, m, 1), Tt.unfold(0, m, 1)
    blk = max(1, _RESCORE_BYTES // (16 * m))
    for o in range(0, idx.shape[0], blk):
        sel = idx[o : o + blk]
        a, b = rows[sel], cc[sel]
        wa = win_q[a] - muq[a][:, None]
        wb = win_t[b] - mut[b][:, None]
        P[sel] = (wa * wb).sum(dim=1) * invq[a] * invt[b]
    return P


def _rescore_pairs(T64, mu, inv, m: int, rows, cols) -> torch.Tensor:
    """:func:`_rescore_pairs_ab` of a series against itself."""
    return _rescore_pairs_ab(T64, mu, inv, T64, mu, inv, m, rows, cols)


def _exact_row_blocks(Tq, muq, invq, Tt, mut, invt, m: int, wt: int, rows, *,
                      excl: int, side: int):
    """Exact float64 correlations of the given query rows with ALL ``wt``
    target windows, in blocks: yields (offset into ``rows``, the block's
    rows, first column, P (rows, columns)), P = AGGREGATE_INIT outside the
    exclusion zone on the given side (:func:`_side_zone`) and for windows
    of infinite inverse norm.  The columns of a row arrive in ascending
    blocks."""
    dev = Tq.device
    win_q, win_t = Tq.unfold(0, m, 1), Tt.unfold(0, m, 1)[:wt]
    fin_q, fin_t = torch.isfinite(invq), torch.isfinite(invt)
    for o in range(0, rows.shape[0], _ROW_BLOCK):
        rr = rows[o : o + _ROW_BLOCK]
        Q = win_q[rr] - muq[rr][:, None]
        for c0 in range(0, wt, _SCAN_COLS):
            c1 = min(c0 + _SCAN_COLS, wt)
            qt = Q @ (win_t[c0:c1] - mut[c0:c1][:, None]).T
            P = qt * invt[c0:c1][None, :] * invq[rr][:, None]
            cols = torch.arange(c0, c1, device=dev)
            bad = (~_side_zone(cols[None, :] - rr[:, None], excl, side)
                   | ~fin_t[c0:c1][None, :] | ~fin_q[rr][:, None])
            yield o, rr, c0, P.masked_fill_(bad, AGGREGATE_INIT)


def _row_scan_ab(Tq, muq, invq, Tt, mut, invt, m: int, wt: int, rows, *,
                 excl: int = NO_EXCL, side: int = 0):
    """Exact float64 best target neighbor of each given query row over ALL
    its valid pairs (outside the exclusion zone on the given side, see
    :func:`_side_zone`, none by default; finite inverse norms): the first
    maximum, the smallest index, on a tie.  Returns (bestP float64, bestI
    int32)."""
    dev = Tq.device
    rows = torch.as_tensor(rows, device=dev).long()
    bestP = torch.full(rows.shape, AGGREGATE_INIT, dtype=torch.float64, device=dev)
    bestI = torch.full(rows.shape, INDEX_INIT, dtype=torch.int64, device=dev)
    for o, rr, c0, P in _exact_row_blocks(Tq, muq, invq, Tt, mut, invt, m, wt, rows,
                                          excl=excl, side=side):
        bp, bi = bestP[o : o + rr.shape[0]], bestI[o : o + rr.shape[0]]
        v, i = P.max(dim=1)
        upd = v > bp  # strictly: an earlier block keeps a tie
        bp.copy_(torch.where(upd, v, bp))
        bi.copy_(torch.where(upd, i + c0, bi))
    bestI = torch.where(bestP > AGGREGATE_INIT, bestI, INDEX_INIT).to(torch.int32)
    return bestP, bestI


def _row_scan(T64, mu, inv, m: int, w: int, excl: int, rows, side: int = 0):
    """:func:`_row_scan_ab` of a series against itself, outside its
    exclusion zone: ``side=+1``/``-1`` is mpx's ``_row_scan_sided``."""
    return _row_scan_ab(T64, mu, inv, T64, mu, inv, m, w, rows, excl=excl, side=side)


def _best_of(P, cand):
    """Per row, the best exact score and the smallest candidate index that
    reaches it (-1 where none is valid)."""
    big = 2**30
    best = P.amax(dim=1)
    tie = (P >= best[:, None]) & (cand >= 0)
    idx = torch.where(tie, cand, big).amin(dim=1)
    idx = torch.where((best > AGGREGATE_INIT) & (idx < big), idx, INDEX_INIT)
    return best, idx.to(torch.int32)


def _resolve_side(sus: SuspectWindow, wq: int, m: int, *, stats_q, stats_t, thr_q,
                  exact_q, exact_t, excl: int, wt: int, profile, side: int = 0,
                  name: str = "", passc_fn=None):
    """Rescore the captured candidates exactly, run pass C for
    capture-overflow rows whose captured interval is wide, and hand rows
    with more than PASS_C_K near-maximal pairs to the exact row scan.
    ``sus`` is the summary over the ``wq`` query windows on the device,
    ``stats_q``/``thr_q`` pass C's float32 query operands and ``stats_t``
    its ``wt`` target windows (the same series but for the AB-join),
    ``exact_q``/``exact_t`` the float64 (T, mu, inv) of each; ``side``
    keeps every stage to one side's neighbors (+1 the right profile, -1 the
    left, 0 both) and ``excl`` is the exclusion zone (:data:`NO_EXCL` for
    the AB-join).  Phases and counts carry the side's ``name``.  ``passc_fn``
    (flagged rows -> pass C's (values, indices, counts)) replaces
    :func:`scan_flagged_rows` where no device holds the whole window
    matrix (the ring tier's sharded pass C)."""
    dev = sus.cnt.device
    tag, key = (f", {name}", f"_{name}") if name else ("", "")

    def rescore(rows, cols):
        return _rescore_pairs_ab(*exact_q, *exact_t, m, rows, cols)

    cnt = sus.cnt[:wq]
    # All 2K capture slots, ascending: the K smallest, then the K largest.
    cand = torch.cat([sus.mn[:wq], sus.mx[:wq].flip(1)], dim=1)
    nslots = cand.shape[1]
    over = cnt > nslots
    mn1, mx1 = sus.mn[:wq, 0], sus.mx[:wq, 0]
    spread = mx1.long() - mn1.long() + 1
    narrow = over & (mn1 != SUSPECT_MIN_INIT) & (spread <= RUNCAP)
    nrows = torch.nonzero(narrow).flatten()
    flagged = torch.nonzero(over & ~narrow).flatten()

    passc = None
    if flagged.numel():
        with phase(profile, f"2. Compute [pass C{tag}]", device=dev):
            passc = (passc_fn(flagged) if passc_fn is not None else
                     scan_flagged_rows(stats_q, thr_q, flagged, w=wt, excl=excl, side=side,
                                       stats_t=stats_t))

    with phase(profile, f"3. Rescore [f64 slots{tag}]", device=dev):
        # Sentinels and repeated slots (a count <= 2K repeats indices in
        # both halves) -> -1: rescore gives them AGGREGATE_INIT.
        cand = torch.where(cand == SUSPECT_MIN_INIT, -1, cand)
        for j in range(1, nslots):
            dup = (cand[:, :j] == cand[:, j : j + 1]).any(dim=1)
            cand[:, j] = torch.where(dup, -1, cand[:, j])
        rows_idx = torch.arange(wq, device=dev).repeat_interleave(nslots)
        P = rescore(rows_idx, cand.reshape(-1)).reshape(wq, nslots)
        bestP, bestI = _best_of(P, cand)

    if nrows.numel():
        # Every suspect lies in the captured interval [mn1, mx1]; when it is
        # narrow (correlation plateaus), rescore the whole interval, less
        # the pairs inside the zone or on the other side.
        with phase(profile, f"3. Rescore [f64 plateau runs{tag}]", device=dev):
            runs = mn1[nrows][:, None] + torch.arange(RUNCAP, device=dev, dtype=torch.int32)
            runs = torch.where(runs <= mx1[nrows][:, None], runs, -1)
            runs = torch.where(_side_zone(runs - nrows[:, None], excl, side), runs, -1)
            rP = rescore(nrows.repeat_interleave(RUNCAP), runs.reshape(-1)).reshape(-1, RUNCAP)
            bestP[nrows], bestI[nrows] = _best_of(rP, runs)

    scanned = flagged[:0]
    if flagged.numel():
        with phase(profile, f"3. Rescore [f64 pass C top-64{tag}]", device=dev):
            bv, bi, ccnt = passc
            eP = rescore(flagged.repeat_interleave(PASS_C_K), bi.reshape(-1))
            eP = eP.reshape(-1, PASS_C_K).masked_fill_(
                (bi < 0) | (bv <= torch.tensor(AGGREGATE_INIT, dtype=torch.float32)),
                AGGREGATE_INIT)
            bestP[flagged], bestI[flagged] = _best_of(eP, bi)
            # More than K pairs reach thr: the top-K may miss the winner.
            scanned = flagged[ccnt > PASS_C_K]
        if scanned.numel():
            if scanned.numel() > 1000:
                Logger.warning(f"hybrid tier: {scanned.numel()} subsequences have more "
                               f"than {PASS_C_K} near-maximal pairs; exact row scans "
                               f"may dominate the runtime")
            with phase(profile, f"3. Rescore [f64 row scans{tag}]", device=dev):
                bestP[scanned], bestI[scanned] = _row_scan_ab(
                    *exact_q, *exact_t, m, wt, scanned, excl=excl, side=side)
    if profile is not None:
        profile.counts.update({f"plateau_rows{key}": int(nrows.numel()),
                               f"pass_c_rows{key}": int(flagged.numel()),
                               f"row_scan_rows{key}": int(scanned.numel())})
    return bestP, bestI


def hybrid_statistics(T64, m: int, *, band: int, chunk: int, device, host_stats=None):
    """The hybrid's operands on ``device``, from one set of host float64
    statistics: the float64 statistics (the exact stages' ``T``, ``mu``,
    ``inv``) and float32 statistics whose window matrix is the float32
    rounding of the exact float64 unit windows.

    mpx builds its float32 windows from float32 ``T`` and ``mu``; there
    the rounding of ``T`` (relative to |T|) is amplified by ``inv`` (one
    over the window's spread), so a window whose spread is small beside
    its level (a plateau with fine detail on it) can pass the margin and
    lose its true neighbor.  Rounding the exact unit windows keeps every
    element within one float32 rounding of itself whatever the series'
    level and scale.  Returns (float32 Stats, float64 Stats without
    windows)."""
    exact = precompute_statistics(T64, m, band=band, chunk=chunk, dtype="float64",
                                  device=device, windows=False, host_stats=host_stats)
    stats = Stats(*(x.float() for x in exact[:6]),
                  windows=build_windows(exact, m, torch.float32))
    return stats, exact


def _host_f64(T) -> np.ndarray:
    T = T.detach().cpu().numpy() if isinstance(T, torch.Tensor) else np.asarray(T)
    return np.asarray(T, dtype=np.float64)


def _passes(stats, r0s, k0s, margin: float, *, S: int, W: int, m: int, w: int, pw: int,
            combine: bool, profile, stats_c=None, wc: Optional[int] = None,
            pwc: Optional[int] = None, excl: Optional[int] = None, ckpt=None):
    """Passes A and B over the given jobs: the thresholds and the suspect
    summaries (one of each, or the row and column sides' with
    ``combine=False``).  Pass B's route comes from the capture gate on the
    wider axis, and lands in ``profile.counts``; ``stats_c`` .. ``excl``
    carry an AB-join's geometry (:func:`run_max_jobs`).  ``ckpt``
    (:class:`mpx_torch.checkpoint.HybridCheckpoint`, the self-join only)
    persists both passes and resumes them: from a pass-B state, the jobs
    still pending sweep densely into it."""
    dev = stats.windows.device
    if ckpt is not None and (state := ckpt.load_b()) is not None:
        thr = torch.as_tensor(state["thr"], device=dev)
        rows_g, cols_g = (SuspectWindow(*(torch.as_tensor(state[f"{side}_{f}"], device=dev)
                                          for f in ("cnt", "mn", "mx")))
                          for side in ("rows", "cols"))
        r0p, k0p = ckpt.pending_jobs()
        Logger.info(f"hybrid pass B: resuming, {len(r0p)} of {ckpt.njobs} jobs pending")
        with phase(profile, "2. Compute [pass B resume dense]", device=dev):
            _dense_jobs(stats, thr, r0p, k0p, band_geometry(S, W, m, w), rows_g, cols_g,
                        ckpt=ckpt)
        return thr, _finish_suspects(rows_g, cols_g, w=w, combine=True)
    jobs = len(r0s)
    nbytes = capture_bytes(jobs, S, W)
    sparse = _sparse_ok(max(w, w if wc is None else wc), nbytes, dev)
    ab = dict(stats_c=stats_c, wc=wc, excl=excl)
    with phase(profile, "2. Compute [pass A]", device=dev):
        thr, cap = run_max_jobs(stats, r0s, k0s, margin, S=S, W=W, m=m, w=w, pw=pw,
                                pwc=pwc, combine=combine, capture=sparse, ckpt=ckpt, **ab)
    thr_r, thr_c = (thr, None) if combine else thr
    if ckpt is not None:
        ckpt.begin_b(thr)
    kw = dict(S=S, W=W, m=m, w=w, thr_col=thr_c, combine=combine, ckpt=ckpt, **ab)
    if sparse:
        sus = run_suspect_jobs_sparse(stats, thr_r, cap, profile=profile, **kw)
        del cap  # the captured job maxima
    else:
        with phase(profile, "2. Compute [pass B dense]", device=dev):
            sus = run_suspect_jobs(stats, thr_r, r0s, k0s, **kw)
        if profile is not None:
            profile.counts.update({"jobs": jobs, "dense_jobs": jobs})
    if profile is not None:
        profile.counts.update({"pass_b": "sparse" if sparse else "dense",
                               "capture_bytes": nbytes if sparse else 0})
    return thr, sus


def _distances(P: torch.Tensor, m: int) -> torch.Tensor:
    return torch.sqrt(torch.clamp(2.0 * m * (1.0 - P), min=0.0))


def _run(T, config: MatrixProfileConfig, *, margin, profile, left_right: bool, ckpt=None):
    """The hybrid tier end to end: the self-join's (bestP, bestI) or, with
    ``left_right``, the left and right sides' (bestP, bestI) each, as
    distances (see the public functions)."""
    if ckpt is not None and left_right:
        raise ValueError("checkpointed hybrid runs compute the self-join profile only; "
                         "drop left_right")
    if (config.num_shards or 1) > 1:
        if ckpt is not None:
            raise ValueError("hybrid checkpointing is single-device")
        if left_right:
            raise ValueError("hybrid left/right profiles are single-device; drop "
                             "--shards or use --kernel mxu")
    m = config.m
    T64 = _host_f64(T)
    n = T64.shape[0]
    config.validate_series(n, T64)
    w = n - m + 1
    config = config.shrink_to(w)
    S, W = config.band, config.chunk
    excl = m // 4
    if margin is None:
        margin = default_margin(m)
    dev = torch.device(config.device)

    with phase(profile, "1. Pre-Computation [host f64]"):
        s64 = precompute_statistics_numpy(T64, m)
    with phase(profile, "1. Pre-Computation [device]", device=dev):
        stats, exact = hybrid_statistics(T64, m, band=S, chunk=W, device=dev, host_stats=s64)

    grid = make_job_grid(w, S, W)
    num_shards = config.num_shards or 1
    if num_shards > 1:
        # mpx's sharded route: passes A and B over the mesh, pass B dense.
        kw = dict(num_shards=num_shards, S=S, W=W, m=m, w=w, tr=config.tile_rows,
                  tc=config.tile_cols)
        with phase(profile, f"2. Compute [pass A, sharded x{num_shards}]", device=dev):
            thr = run_max_jobs_sharded(stats, grid, margin, pw=stats.mu.shape[0], **kw)
        with phase(profile, f"2. Compute [pass B dense, sharded x{num_shards}]", device=dev):
            sus = run_suspect_jobs_sharded(stats, thr, grid, **kw)
        if profile is not None:
            profile.counts.update({"pass_b": "dense", "capture_bytes": 0,
                                   "jobs": len(grid.r0), "dense_jobs": len(grid.r0)})
    else:
        thr, sus = _passes(stats, grid.r0, grid.k0, margin, S=S, W=W, m=m, w=w,
                           pw=stats.mu.shape[0], combine=not left_right, profile=profile,
                           ckpt=ckpt)
    ex = (exact.T, exact.mu[:w], exact.inv[:w])
    resolve = dict(stats_q=stats, stats_t=stats, exact_q=ex, exact_t=ex, excl=excl, wt=w,
                   profile=profile)
    if left_right:
        # The job grid covers the upper triangle: the row side is the
        # right profile, the column side the left.
        sides = [_resolve_side(sus[1], w, m, thr_q=thr[1], side=-1, name="left", **resolve),
                 _resolve_side(sus[0], w, m, thr_q=thr[0], side=+1, name="right", **resolve)]
    else:
        sides = [_resolve_side(sus, w, m, thr_q=thr, **resolve)]
    with phase(profile, "4. Post-Computation", device=dev):
        return tuple(x for P, I in sides for x in (_distances(P, m), I))


def compute_ab_join_f64_hybrid(A, B, config: MatrixProfileConfig, *,
                               margin: Optional[float] = None, profile=None):
    """Exact double-precision AB-join through the hybrid tier (port of
    mpx's ``compute_ab_join_f64_hybrid``).

    Passes A and B sweep the rectangle jobs of :func:`mpx_torch.abjoin.ab_jobs`
    (rows of ``A``, columns of ``B``, no exclusion zone) with one
    threshold per series; each series' suspects are then resolved against
    the other's windows.  Returns an :class:`mpx_torch.abjoin.ABJoinResult`
    of float64 distances and int32 indices on ``config.device``; a
    zero-variance window has no neighbor (sqrt(2m(1+1e12)) / -1).
    ``profile`` as for :func:`compute_matrix_profile_f64_hybrid`, the
    escalation counts and resolve phases named by series (``a``, ``b``)."""
    from mpx_torch.abjoin import ABJoinResult, ab_jobs

    m = config.m
    A64, B64 = _host_f64(A), _host_f64(B)
    config.validate_series(A64.shape[0], A64)
    config.validate_series(B64.shape[0], B64)
    wa, wb = A64.shape[0] - m + 1, B64.shape[0] - m + 1
    config = config.shrink_to(max(wa, wb))
    S, W = config.band, config.chunk
    if margin is None:
        margin = default_margin(m)
    dev = torch.device(config.device)

    with phase(profile, "1. Pre-Computation [host f64]"):
        sa, sb = (precompute_statistics_numpy(X, m) for X in (A64, B64))
    with phase(profile, "1. Pre-Computation [device]", device=dev):
        (stats_a, exact_a), (stats_b, exact_b) = (
            hybrid_statistics(X, m, band=S, chunk=W, device=dev, host_stats=s)
            for X, s in ((A64, sa), (B64, sb)))

    r0s, c0s = ab_jobs(wa, wb, S, W)
    (thr_a, thr_b), (sus_a, sus_b) = _passes(
        stats_a, r0s, c0s - r0s, margin, S=S, W=W, m=m, w=wa, pw=stats_a.mu.shape[0],
        combine=False, profile=profile, stats_c=stats_b, wc=wb, pwc=stats_b.mu.shape[0],
        excl=NO_EXCL)
    ex_a = (exact_a.T, exact_a.mu[:wa], exact_a.inv[:wa])
    ex_b = (exact_b.T, exact_b.mu[:wb], exact_b.inv[:wb])
    Pa, Ia = _resolve_side(sus_a, wa, m, stats_q=stats_a, stats_t=stats_b, thr_q=thr_a,
                           exact_q=ex_a, exact_t=ex_b, excl=NO_EXCL, wt=wb, profile=profile,
                           name="a")
    Pb, Ib = _resolve_side(sus_b, wb, m, stats_q=stats_b, stats_t=stats_a, thr_q=thr_b,
                           exact_q=ex_b, exact_t=ex_a, excl=NO_EXCL, wt=wa, profile=profile,
                           name="b")
    with phase(profile, "4. Post-Computation", device=dev):
        return ABJoinResult(mp_a=_distances(Pa, m), mpi_a=Ia, mp_b=_distances(Pb, m), mpi_b=Ib)


def compute_matrix_profile_f64_hybrid(T, config: MatrixProfileConfig, *,
                                      margin: Optional[float] = None, profile=None,
                                      ckpt=None):
    """Exact double-precision self-join profile through the hybrid tier.

    Returns (MP float64 distances, MPI int32) tensors on ``config.device``;
    untouched entries are sqrt(2m(1+1e12)) / -1, as on the other tiers.
    ``profile`` (:class:`mpx_torch.utils.profile.BenchmarkProfile`) takes
    the per-phase times and, in ``profile.counts``, pass B's route
    (``pass_b``: sparse or dense) and capture bytes, the flags per job and
    the escalated rows.  ``ckpt`` (:class:`mpx_torch.checkpoint.HybridCheckpoint`)
    makes passes A and B resumable (:func:`mpx_torch.checkpoint.compute_hybrid_with_checkpoint`)."""
    return _run(T, config, margin=margin, profile=profile, left_right=False, ckpt=ckpt)


def compute_left_right_f64_hybrid(T, config: MatrixProfileConfig, *,
                                  margin: Optional[float] = None, profile=None):
    """Exact double-precision left/right profiles through the hybrid tier:
    each subsequence's nearest earlier (left) and later (right) neighbor.

    Passes A and B run with per-side thresholds, and each side resolves on
    its own with every escalation kept to that side.  Returns (MP_left,
    MPI_left, MP_right, MPI_right), float64 and int32 tensors on
    ``config.device``; a side with no valid neighbor (the first and last
    ``m // 4`` windows, zero-variance ones) is sqrt(2m(1+1e12)) / -1.
    ``profile`` as for :func:`compute_matrix_profile_f64_hybrid`, with the
    escalation counts and resolve phases named by side."""
    return _run(T, config, margin=margin, profile=profile, left_right=True)


# ---------------------------------------------------------------- top-k


def _job_kth_max(cap, k: int, L: int) -> torch.Tensor:
    """Fold pass A's captures into each position's k largest job maxima,
    (L, k) float32, descending (port of mpx's ``_job_kth_max_group``).

    The k-th largest lower-bounds the position's k-th best pair: only the
    k - 1 pairs above it can lift a job's maximum above it, so at most
    k - 1 job maxima exceed it.  ``cap`` is (r0s, k0s, jrow (J, S), jcol
    (J, W)); a job's row maxima land at r0.., its column maxima at r0 +
    k0...  Each step sorts the (position, value) pairs of a group of jobs
    together with the running top-k by value and then, stably, by
    position, and keeps each position's first k."""
    r0s, k0s, jrow, jcol = cap
    dev = jrow.device
    S, W = jrow.shape[1], jcol.shape[1]
    r0 = torch.as_tensor(r0s, dtype=torch.int64, device=dev)
    c0 = r0 + torch.as_tensor(k0s, dtype=torch.int64, device=dev)
    iS, iW = torch.arange(S, device=dev), torch.arange(W, device=dev)
    own = torch.arange(L, device=dev).repeat_interleave(k)
    gv = torch.full((L * k,), AGGREGATE_INIT, dtype=torch.float32, device=dev)
    for o in range(0, r0.shape[0], _KTH_GROUP):
        g = slice(o, o + _KTH_GROUP)
        pos = torch.cat([own, (r0[g, None] + iS).flatten(), (c0[g, None] + iW).flatten()])
        val, by_val = torch.cat([gv, jrow[g].flatten(), jcol[g].flatten()]).sort(
            descending=True)
        pos, by_pos = pos[by_val].sort(stable=True)
        val = val[by_pos]
        rank = torch.arange(pos.shape[0], device=dev) - torch.searchsorted(pos, pos)
        # Each position holds at least its own k entries: every slot is
        # written; the rest go to a dropped slot.
        slot = torch.where(rank < k, pos * k + rank, L * k)
        gv = gv.new_empty(L * k + 1).scatter_(0, slot, val)[: L * k]
    return gv.view(L, k)


def _row_topk_scan(T64, mu, inv, m: int, w: int, excl: int, rows, k: int):
    """Exact float64 top-k of each given row over ALL its valid pairs (both
    sides, outside the exclusion zone; the last resort of the top-k
    hybrid): descending, the smaller index first among equal values.
    Returns (values (R, k) float64, AGGREGATE_INIT where missing; indices
    (R, k) int32, -1 where missing)."""
    from mpx_torch.topk import _topk_desc

    dev = T64.device
    rows = torch.as_tensor(rows, device=dev).long()
    R = rows.shape[0]
    topv = torch.full((R, k), AGGREGATE_INIT, dtype=torch.float64, device=dev)
    topi = torch.full((R, k), INDEX_INIT, dtype=torch.int64, device=dev)
    for o, rr, c0, P in _exact_row_blocks(T64, mu, inv, T64, mu, inv, m, w, rows,
                                          excl=excl, side=0):
        cols = torch.arange(c0, c0 + P.shape[1], device=dev)
        v, i = _topk_desc(P, cols, min(k, P.shape[1]))
        bv, bi = topv[o : o + rr.shape[0]], topi[o : o + rr.shape[0]]
        # The incumbents come first: their columns are the smaller.
        v, i = _topk_desc(torch.cat([bv, v], dim=1), torch.cat([bi, i], dim=1), k)
        bv.copy_(v)
        bi.copy_(i)
    return topv, torch.where(topv > AGGREGATE_INIT, topi, INDEX_INIT).to(torch.int32)


def _best_k(P: torch.Tensor, cand: torch.Tensor, k: int):
    """Each row's rescored candidates in descending exact score, the
    smaller index first among equal scores (mpx's ``best_of``).  Returns
    (values (R, k), indices (R, k) int32 (-1 where invalid), the count of
    valid candidates, the k-th value or -inf where fewer than k)."""
    key = torch.where(cand >= 0, cand.long(), 2**31)
    by_idx = key.argsort(dim=1, stable=True)
    P, cand = P.gather(1, by_idx), cand.gather(1, by_idx)
    by_val = P.argsort(dim=1, descending=True, stable=True)
    P, cand = P.gather(1, by_val), cand.gather(1, by_val)
    if P.shape[1] < k:
        P = torch.nn.functional.pad(P, (0, k - P.shape[1]), value=AGGREGATE_INIT)
        cand = torch.nn.functional.pad(cand, (0, k - cand.shape[1]), value=INDEX_INIT)
    nreal = (P > AGGREGATE_INIT).sum(dim=1)
    vk = torch.where(nreal >= k, P[:, k - 1], -torch.inf)
    idx = torch.where(P > AGGREGATE_INIT, cand, INDEX_INIT).to(torch.int32)
    return P[:, :k], idx[:, :k], nreal, vk


def compute_topk_profile_f64_hybrid(T, k: int = 4, config: Optional[MatrixProfileConfig] = None,
                                    *, m: Optional[int] = None,
                                    margin: Optional[float] = None, profile=None):
    """Exact double-precision k-NN profile through the hybrid tier (port of
    mpx's ``compute_topk_profile_f64_hybrid``).

    The 1-NN hybrid's passes with a per-row threshold descent.  Pass A
    (K1's float32 launch) gives the 1-NN thresholds and, with captures,
    each row's k-th largest job maximum, which seeds the k-NN threshold
    (:func:`_job_kth_max`; clamped to TOPK_CAP below the 1-NN threshold).
    Each round, pass B captures the suspects at the current thresholds
    and every row not yet certified is resolved by the cheapest stage that
    holds all its suspects: its capture slots (at most 2 SUSPECT_K
    suspects), its plateau bracket (at most TOPK_RUNCAP wide), pass C's
    top-TOPK_K1, the wide pass C's top-TOPK_K2, else the exact row scan.
    A row is certified when its k-th rescored candidate clears ``thr +
    margin`` (every other pair has P32 < thr, so P64 < thr + margin), or
    pass C's K-th float32 value plus the margin; certified rows get thr =
    +inf, so the next sparse pass B skips them, and the others descend by
    doubling steps.  After TOPK_MAX_IT rounds the rows left take the exact
    row scan.  The thresholds move work, never results.

    Requires ``1 <= k <= 2 * SUSPECT_K`` (the capture width).  Returns
    (distances (w, k) float64, indices (w, k) int32) on ``config.device``,
    each row ascending, ties in index order; missing neighbors are (inf,
    -1).  ``profile`` takes the phase times and, in ``profile.counts``,
    pass B's route, the rounds taken and the rows each stage resolved per
    round."""
    from mpx_torch.utils.profile import BenchmarkProfile

    if k < 1 or k > 2 * SUSPECT_K:
        raise ValueError(f"hybrid top-k requires 1 <= k <= {2 * SUSPECT_K}, got {k}")
    config = config_for(m, config)
    m = config.m
    T64 = _host_f64(T)
    n = T64.shape[0]
    config.validate_series(n, T64)
    w = n - m + 1
    config = config.shrink_to(w)
    S, W = config.band, config.chunk
    excl = m // 4
    margin = default_margin(m) if margin is None else float(margin)
    dev = torch.device(config.device)

    with phase(profile, "1. Pre-Computation [host f64]"):
        s64 = precompute_statistics_numpy(T64, m)
    with phase(profile, "1. Pre-Computation [device]", device=dev):
        stats, exact = hybrid_statistics(T64, m, band=S, chunk=W, device=dev, host_stats=s64)
    grid = make_job_grid(w, S, W)
    pw = stats.mu.shape[0]
    nbytes = capture_bytes(len(grid.r0), S, W)
    sparse = _sparse_ok(w, nbytes, dev)
    kw = dict(S=S, W=W, m=m, w=w)
    with phase(profile, "2. Compute [pass A]", device=dev):
        thr, cap = run_max_jobs(stats, grid.r0, grid.k0, margin, pw=pw, capture=sparse, **kw)
    if sparse:
        with phase(profile, "2. Compute [topk thr estimate]", device=dev):
            est = _job_kth_max(cap, k, w + S + W)[:w, k - 1]
            # The captures are the exact float32 job maxima (mpx's are
            # u16-encoded and subtract their quantum here): nothing to undo.
            seeded = torch.where(est > AGGREGATE_INIT / 2, est - 2.0 * margin, -torch.inf)
            # The k-th job maximum COLLAPSES on plateau data: a row's top-k
            # pairs are usually consecutive columns of ONE job, so the k-th
            # largest job maximum is the maximum of the k-th best job, far
            # below v_k.  Unclamped, that seeded thresholds so low that
            # mpx's round-4 hardware sent 98% of all rows to the full-width
            # pass C.  So the descent starts at most TOPK_CAP below the 1-NN
            # threshold: raising thr is always sound (certification checks
            # itself; rows that fail descend), and the cap is sized from the
            # suspect-band density mpx measured (19.5 suspects a row at 8e-3
            # on random walks) so the band stays within the capture slots
            # and the plateau bracket.
            thr[:w] = torch.maximum(seeded, thr[:w] - TOPK_CAP)

    ex = (exact.T, exact.mu[:w], exact.inv[:w])

    def rescore(rows, cols):
        return _rescore_pairs(*ex, m, rows, cols)

    nslots = 2 * SUSPECT_K
    topv = torch.full((w, k), AGGREGATE_INIT, dtype=torch.float64, device=dev)
    topi = torch.full((w, k), INDEX_INIT, dtype=torch.int32, device=dev)
    certified = torch.zeros(w, dtype=torch.bool, device=dev)
    delta = torch.zeros(w, dtype=torch.float32, device=dev)
    stages = ("small", "narrow", "pass_c", "pass_c_wide", "row_scan")
    resolved = {name: [] for name in stages}
    flags = []

    def settle(rows, cand, P, bar, free):
        """Commit the rows whose k-th candidate clears ``bar`` (or that
        ``free`` certifies); returns the mask of those rows."""
        vals, idxs, nreal, vk = _best_k(P, cand, k)
        ok = ((nreal >= k) & (vk >= bar)) | free
        topv[rows] = torch.where(ok[:, None], vals, topv[rows])
        topi[rows] = torch.where(ok[:, None], idxs, topi[rows])
        certified[rows] |= ok
        return ok

    def pass_c(rows, K, name):
        """Pass C at K slots over ``rows``; the mask of the rows settled."""
        with phase(profile, f"2. Compute [topk {name}]", device=dev):
            bv, bi, _ = scan_flagged_rows(stats, thr, rows, w=w, excl=excl, K=K)
        with phase(profile, f"3. Rescore [f64 topk {name}]", device=dev):
            P = rescore(rows.repeat_interleave(K), bi.reshape(-1)).reshape(-1, K)
            # Slots pass C filled with init (a row with fewer than K valid
            # pairs) carry no pair.
            P.masked_fill_((bi < 0) | (bv <= torch.tensor(AGGREGATE_INIT, dtype=torch.float32)),
                           AGGREGATE_INIT)
            # Any pair outside the top-K has P32 <= bv[K-1], so P64 <=
            # bv[K-1] + margin: a k-th rescored candidate at or above that
            # cannot be displaced.  bv[K-1] = init: every valid pair is a
            # candidate.
            last = bv[:, K - 1].double()
            return settle(rows, bi, P, last + margin, last <= AGGREGATE_INIT)

    for it in range(TOPK_MAX_IT):
        counted = BenchmarkProfile() if profile is not None else None
        with phase(profile, f"2. Compute [topk pass B, round {it}]", device=dev):
            if sparse:
                sus = run_suspect_jobs_sparse(stats, thr, cap, profile=counted, **kw)
            else:
                sus = run_suspect_jobs(stats, thr, grid.r0, grid.k0, **kw)
        if counted is not None and sparse:
            flags.append({key: counted.counts[key] for key in
                          ("flags_per_job_mean", "flags_per_job_max", "dense_jobs",
                           "jobs_without_flags")})
        done = {name: torch.zeros((), dtype=torch.int64, device=dev) for name in stages}
        cnt = sus.cnt[:w]
        # All 2K capture slots: the K smallest, then the K largest.
        cand = torch.cat([sus.mn[:w], sus.mx[:w].flip(1)], dim=1)
        cand = torch.where(cand == SUSPECT_MIN_INIT, -1, cand)
        todo = ~certified
        thr_w = thr[:w].double()
        # Every pair is a suspect: the threshold is below any correlation.
        allin = thr_w <= -1.0

        small = torch.nonzero(todo & (cnt <= nslots)).flatten()
        if small.numel():
            with phase(profile, "3. Rescore [f64 topk slots]", device=dev):
                sl = cand[small]
                # A count <= 2K repeats indices in both halves.
                for j in range(1, nslots):
                    dup = (sl[:, :j] == sl[:, j : j + 1]).any(dim=1)
                    sl[:, j] = torch.where(dup, -1, sl[:, j])
                P = rescore(small.repeat_interleave(nslots), sl.reshape(-1)).reshape(-1, nslots)
                done["small"] += settle(small, sl, P, thr_w[small] + margin, allin[small]).sum()

        over = todo & (cnt > nslots)
        # Narrow plateau rows: every suspect lies in the captured bracket
        # [mn1, mx1]; when it is at most TOPK_RUNCAP wide, rescoring it
        # whole enumerates every suspect without pass C.  Rows go in
        # chunks sorted by spread, each rescored at its own widest.
        mn1, mx1 = sus.mn[:w, 0], sus.mx[:w, 0]
        spread = mx1.long() - mn1.long() + 1
        narrow = over & (mn1 != SUSPECT_MIN_INIT) & (spread <= TOPK_RUNCAP)
        nrows_all = torch.nonzero(narrow).flatten()
        if nrows_all.numel():
            with phase(profile, "3. Rescore [f64 topk plateau runs]", device=dev):
                nrows_all = nrows_all[spread[nrows_all].argsort(stable=True)]
                for o in range(0, nrows_all.numel(), _TOPK_ROW_CHUNK):
                    nrows = nrows_all[o : o + _TOPK_ROW_CHUNK]
                    rc = max(8, (int(spread[nrows].max()) + 7) // 8 * 8)
                    runs = mn1[nrows][:, None] + torch.arange(rc, dtype=torch.int32, device=dev)
                    runs = torch.where(runs <= mx1[nrows][:, None], runs, -1)
                    runs = torch.where(_side_zone(runs - nrows[:, None], excl, 0), runs, -1)
                    P = rescore(nrows.repeat_interleave(rc), runs.reshape(-1)).reshape(-1, rc)
                    done["narrow"] += settle(nrows, runs, P, thr_w[nrows] + margin,
                                             allin[nrows]).sum()

        big = torch.nonzero(over & ~narrow).flatten()
        if big.numel():
            ok = pass_c(big, TOPK_K1, "pass C")
            done["pass_c"] += ok.sum()
            # The k-th within the margin of the K1-th (a tie plateau wider
            # than K1): one more pass C at the wide K2, whose proof is the
            # same, before the exact scan.
            wild = big[~ok]
            if wild.numel() and TOPK_K2 > TOPK_K1:
                ok = pass_c(wild, min(TOPK_K2, pw), "pass C wide")
                done["pass_c_wide"] += ok.sum()
                wild = wild[~ok]
            if wild.numel():
                with phase(profile, "3. Rescore [f64 topk row scan]", device=dev):
                    topv[wild], topi[wild] = _row_topk_scan(*ex, m, w, excl, wild, k)
                    certified[wild] = True
                done["row_scan"] += wild.numel()
        for name, value in zip(stages, torch.stack(list(done.values())).tolist()):
            resolved[name].append(value)
        rem = ~certified
        left = int(rem.sum())
        Logger.verbose_log(f"hybrid top-k round {it}: "
                           + " ".join(f"{name}={resolved[name][-1]}" for name in stages)
                           + f" left={left}/{w}")
        if not left:
            break
        # The rows left descend by doubling steps; certified rows leave
        # the next sparse pass B.
        delta = torch.where(rem, torch.clamp(2 * delta, min=4 * margin), delta)
        thr[:w] = torch.where(rem, thr[:w] - delta, torch.inf)
    else:
        left_rows = torch.nonzero(~certified).flatten()
        Logger.warning(f"hybrid top-k: {left_rows.numel()} row(s) did not converge in "
                       f"{TOPK_MAX_IT} rounds; exact row scans")
        with phase(profile, "3. Rescore [f64 topk row scan]", device=dev):
            topv[left_rows], topi[left_rows] = _row_topk_scan(*ex, m, w, excl, left_rows, k)
        resolved["row_scan"].append(left_rows.numel())
    del cap
    if profile is not None:
        profile.counts.update({"pass_b": "sparse" if sparse else "dense",
                               "capture_bytes": nbytes if sparse else 0,
                               "jobs": len(grid.r0), "rounds": it + 1,
                               **{f"resolved_{name}": resolved[name] for name in stages},
                               "pass_b_flags_per_round": flags})
    with phase(profile, "4. Post-Computation", device=dev):
        D = torch.where(topi >= 0, _distances(topv, m), torch.inf)
    return D, topi
