"""K3: the SCAMP diagonal-recurrence band sweep (``kernel='pallas'``).

Counterpart of ``mpx/kernels/pallas_tpu.py:sweep_band_pallas``; the kernel
itself is ``mpx_torch/csrc/band_recurrence.cu`` (CUDA C++ for sm_90a, f32
and f64: the H100 has native FP64, so unlike mpx's Pallas kernel this is
also the strict float64 tier, and it computes in float64 for float32
statistics too, rounding only its outputs).  A block of the sweep carries
256 diagonals of one job from their exact seed down one row segment,
staging ``SEGMENT_ROWS`` rows at a time.  :func:`segment_rows` picks the
segment once a call from the job's shape and the card alone: the fewest
segments for which one full batch of jobs fills the card.  At the
library's band and chunk that is one segment, so each diagonal is carried
from the seed down all S rows in the plain recurrence's own row order.
Where a chunk is too narrow to fill the card, a job has several segments,
and each starts its diagonals from the seed plus the earlier segments'
sums of the same update terms, which a first kernel writes
(``launches.k3_segsum`` counts those batches).  Only per-block (value,
index) partials reach device memory.  Scratch is allocated here; the
kernels allocate nothing.

The library has one entry, a batch: :func:`sweep_batches` sweeps a job
list a batch at a time (:func:`job_batches`: runs of up to ``BATCH_JOBS``
consecutive jobs, at any k0), each batch one call that computes every
job's seed on the card (in :func:`mpx_torch.kernels.common.seed_qt`'s
form, the plain version's seed) and max-merges every job's partials
straight into the global aggregates, in the jobs' order
(:func:`merge_batch` is the plain version of that merge).  The checks,
the library, the segment and one scratch arena are set up once a call,
not once a job.  :func:`sweep_band_recurrence`, the band-sweep contract's
one job, is a batch of one, and rounds as the same job does in any batch.

A CPU tensor takes the plain PyTorch version
(:func:`mpx_torch.kernels.xla.sweep_band_xla`); a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from mpx_torch.dtypes import AGGREGATE_INIT, torch_dtype
from mpx_torch.kernels.common import BandGeometry, BandOut
from mpx_torch.kernels.xla import sweep_band_xla
from mpx_torch.ops.aggregates import init_aggregates, merge_window
from mpx_torch.types import Aggregates, Stats
from mpx_torch.utils.profile import count, span

# Rows the kernel stages at a time, its R: a segment is a multiple of it
# (checked against the built library).
SEGMENT_ROWS = 256
# Diagonals a block of the sweep, the kernel's BW (checked likewise).
BLOCK_DIAGONALS = 256
# A full batch's blocks must fill this share of one wave of the sweep's
# blocks on the card (segment_rows).
WAVE_FILL = 0.9
# Jobs one batched call sweeps at most.  On an H100 a 2^20-point float64
# self-join (S = 4096, W = 16384, m = 256) took the same time from 8 jobs a
# batch up to 96, 7 % longer at 4 and 20 % at 1 (PERF.md section 6); 16 is
# twice the knee, and its scratch, ~17.8 MB a job there, stays at 0.28 GB.
BATCH_JOBS = 16


def sweep_band_recurrence(stats: Stats, r0: int, k0: int, geom: BandGeometry,
                          dtype) -> BandOut:
    """One job's ``BandOut`` (rows (S,), columns (S + W,)): a batch of one
    (:func:`sweep_batches`) into aggregates that start at the init."""
    if stats.df.device.type == "cpu":
        return sweep_band_xla(stats, r0, k0, geom, dtype)
    r0, k0 = int(r0), int(k0)
    c0, S, W = r0 + k0, geom.S, geom.W
    dt, dev = torch_dtype(dtype), stats.df.device
    rows = init_aggregates(c0 + S + W, dt, AGGREGATE_INIT, dev)
    cols = init_aggregates(c0 + S + W, dt, AGGREGATE_INIT, dev)
    for _ in sweep_batches(stats, [r0], [k0], geom=geom, dtype=dtype, rows=rows, cols=cols):
        pass
    return BandOut(row=Aggregates(rows.value[r0:r0 + S], rows.index[r0:r0 + S]),
                   col=Aggregates(cols.value[c0:c0 + S + W], cols.index[c0:c0 + S + W]))


def _check(stats: Stats, geom: BandGeometry, dt: torch.dtype, r0s, k0s) -> None:
    """What every launch needs: the statistics on one card in ``dt``, a
    self-join geometry, and every job's rows [r0, r0 + S) and columns
    [c0, c0 + S + W) inside the statistics."""
    if stats.df.device.type != "cuda":
        raise ValueError(f"the recurrence kernel runs on CUDA tensors, got {stats.df.device}")
    S, W, m = geom.S, geom.W, geom.m
    pw = stats.df.shape[0]
    for v in (stats.df, stats.dg, stats.inv, stats.mu):
        if v.dtype != dt or v.shape != (pw,) or not v.is_contiguous() \
                or v.device != stats.df.device:
            raise ValueError(f"stats must be contiguous ({pw},) {dt} vectors on one "
                             f"device, got {v.dtype} {tuple(v.shape)}")
    if stats.T.dtype != dt or stats.T.shape != (pw + m - 1,) or not stats.T.is_contiguous() \
            or stats.T.device != stats.df.device:
        raise ValueError(f"stats.T must be contiguous ({pw + m - 1},) {dt} on the stats' device")
    if geom.wc != geom.w:
        raise ValueError("the recurrence kernel is a self-join kernel (wc must equal w)")
    if pw + m >= 2**31:
        raise ValueError("profile width exceeds the kernel's int32 indices")
    r0, k0 = np.asarray(r0s, np.int64), np.asarray(k0s, np.int64)
    bad = (np.minimum(r0, k0) < 0) | (r0 + S > pw) | (r0 + k0 + S + W > pw)
    if bad.any():
        j = int(np.argmax(bad))
        c0 = int(r0[j] + k0[j])
        raise ValueError(f"job rows [{r0[j]}, {r0[j] + S}) / columns [{c0}, {c0 + S + W}) "
                         f"outside the {pw}-wide statistics")


def segment_rows(S: int, W: int, sms: int, resident: int, cap: int) -> int:
    """Rows of a K3 job's row segment, a multiple of ``SEGMENT_ROWS``.  Of
    G = 1, 2, 4, ... up to ceil(S / SEGMENT_ROWS) segments a job (that
    count the last candidate), the fewest for which a full batch of ``cap``
    jobs, cap x ceil(W / BLOCK_DIAGONALS) x G blocks of the sweep, fills
    ``WAVE_FILL`` of one wave of ``sms`` SMs holding ``resident`` blocks
    each; the last candidate if none does.  The segment is ceil(S / G)
    rounded up to ``SEGMENT_ROWS`` rows, so a job has ceil(S / segment)
    segments, the last one ragged where S is not a multiple.  It reads the
    job's shape, the card and the cap, never a batch's own size: a job
    rounds the same in every batch."""
    chunks = -(-S // SEGMENT_ROWS)
    blocks = cap * -(-W // BLOCK_DIAGONALS)
    G = 1
    while G < chunks and blocks * G < WAVE_FILL * sms * resident:
        G = min(2 * G, chunks)
    return -(-chunks // G) * SEGMENT_ROWS


def _segment_rows_on(lib, geom: BandGeometry, dt: torch.dtype, device) -> int:
    """:func:`segment_rows` for ``device`` (the current device), its wave
    the SM count times the sweep's resident blocks an SM."""
    if lib.mpx_k3_segment_rows() != SEGMENT_ROWS or lib.mpx_k3_block_w() != BLOCK_DIAGONALS:
        raise RuntimeError(f"K3 was built with {lib.mpx_k3_segment_rows()} rows a chunk and "
                           f"{lib.mpx_k3_block_w()} diagonals a block, the wrapper expects "
                           f"{SEGMENT_ROWS} and {BLOCK_DIAGONALS}")
    resident = lib.mpx_k3_resident_blocks(int(dt == torch.float64), 1)
    if resident <= 0:
        raise RuntimeError(f"K3's occupancy query failed: cudaError_t {-resident}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return segment_rows(geom.S, geom.W, sms, resident, BATCH_JOBS)


def _scratch(jobs: int, geom: BandGeometry, L: int, dt: torch.dtype, device):
    """Seeds, segment sums and partials for ``jobs`` jobs of segments of
    ``L`` rows, each job's after the one before (the layout the library's
    entries read)."""
    S, W = geom.S, geom.W
    nbj, G = -(-W // BLOCK_DIAGONALS), -(-S // L)
    # The kernel computes in float64 for both dtypes (csrc header).
    return (torch.empty((jobs, W), dtype=torch.float64, device=device),
            torch.empty((jobs, G - 1, W), dtype=torch.float64, device=device),
            torch.empty((jobs, nbj, S), dtype=dt, device=device),
            torch.empty((jobs, nbj, S), dtype=torch.int32, device=device),
            torch.empty((jobs, G * nbj, L + BLOCK_DIAGONALS - 1), dtype=dt, device=device),
            torch.empty((jobs, G * nbj, L + BLOCK_DIAGONALS - 1), dtype=torch.int32,
                        device=device))


def _ptrs(args) -> list:
    return [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]


def job_batches(jobs: int, cap: int) -> list:
    """Cut a list of ``jobs`` jobs into batches: runs of ``cap`` consecutive
    jobs in the list's order, whatever their k0, the last one shorter where
    ``cap`` does not divide ``jobs``.  Returns (start, stop) pairs."""
    return [(a, min(a + cap, jobs)) for a in range(0, jobs, cap)]


def merge_batch(agg: Aggregates, windows, offsets) -> None:
    """The plain version of K3's batched merge (``k3_merge``): max-merge
    the equal-length ``windows`` (Aggregates) into ``agg`` at ``offsets``,
    in place.  At each position the first window in order whose value beats
    the earlier ones' strictly is kept, and replaces the incumbent only if
    it beats it strictly: the incumbent, then the earlier window, wins a
    tie, so ``agg`` ends as ``merge_window`` window after window leaves it."""
    n = windows[0].value.shape[-1]
    lo, hi = min(offsets), max(offsets) + n
    best = init_aggregates(hi - lo, agg.value.dtype, AGGREGATE_INIT, agg.value.device)
    for win, off in zip(windows, offsets):
        merge_window(best, win, off - lo)
    merge_window(agg, best, lo)


def sweep_batches(stats: Stats, r0s, k0s, *, geom: BandGeometry, dtype,
                  rows: Aggregates, cols: Aggregates):
    """Sweep the jobs (r0s[j], k0s[j]) (lists of ints) of a self-join a batch
    at a time (:func:`job_batches` with ``BATCH_JOBS``), max-merging their
    outputs into the global ``rows`` and ``cols`` aggregates in place, in
    the jobs' order: the aggregates end as the per-job loop's of the same
    ``BandOut`` values.  A generator that yields after each batch.  Each
    batch is one call of the library (seeds, sweep, reduce and merge on the
    card: one ``launches.k3``, a ``jobs.k3`` a job, and a
    ``launches.k3_segsum`` where a job has more than one segment) inside a
    ``jobs.batch`` span; on the CPU the plain sweep a job and
    :func:`merge_batch`."""
    batches = job_batches(len(r0s), BATCH_JOBS)
    c0s = [r + k for r, k in zip(r0s, k0s)]
    if stats.df.device.type == "cpu":
        for a, b in batches:
            with span("jobs.batch"):
                outs = [sweep_band_xla(stats, r0s[j], k0s[j], geom, dtype) for j in range(a, b)]
                merge_batch(rows, [o.row for o in outs], r0s[a:b])
                merge_batch(cols, [o.col for o in outs], c0s[a:b])
            yield
        return
    yield from _sweep_batches_cuda(stats, r0s, k0s, c0s, batches, geom, torch_dtype(dtype),
                                   rows, cols)


def _sweep_batches_cuda(stats, r0s, k0s, c0s, batches, geom, dt, rows, cols):
    from mpx_torch.kernels import _build

    if not batches:
        return
    _check(stats, geom, dt, r0s, k0s)
    S, W, dev = geom.S, geom.W, stats.df.device
    for (v, i), hi in ((rows, max(r0s) + S), (cols, max(c0s) + S + W)):
        if not (v.dtype == dt and i.dtype == torch.int32 and v.dim() == 1
                and v.shape == i.shape and v.shape[0] >= hi and v.is_contiguous()
                and i.is_contiguous() and v.device == i.device == dev):
            raise ValueError(f"aggregates must be contiguous {dt} / int32 vectors of at "
                             f"least {hi} on {dev}")
    lib = _build.load()
    with torch.cuda.device(dev):
        L = _segment_rows_on(lib, geom, dt, dev)
    scratch = _scratch(max(b - a for a, b in batches), geom, L, dt, dev)
    segsum = L < S
    jobs = torch.from_numpy(np.asarray([r0s, k0s], dtype=np.int32)).to(dev)
    fn = lib.mpx_k3_sweep_batch_f64 if dt == torch.float64 else lib.mpx_k3_sweep_batch_f32
    head = _ptrs((stats.T, stats.mu, stats.df, stats.dg, stats.inv))
    tail = _ptrs((*scratch, rows.value, rows.index, cols.value, cols.index))
    r0p, k0p, size = jobs[0].data_ptr(), jobs[1].data_ptr(), jobs.element_size()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for a, b in batches:
        # The device is made current a batch at a time, not across a yield:
        # the caller may sweep another device's jobs in between.
        with span("jobs.batch"), torch.cuda.device(dev):
            r0b, c0b = r0s[a:b], c0s[a:b]
            err = fn(*head, r0p + a * size, k0p + a * size, b - a, geom.m, S, W, L, geom.w,
                     geom.excl, min(r0b), max(r0b) + S, min(c0b), max(c0b) + S + W,
                     *tail, stream)
            if err != 0:
                raise RuntimeError(f"recurrence kernel launch failed: cudaError_t {err}")
            count("launches.k3")
            if segsum:
                count("launches.k3_segsum")
            count("jobs.k3", b - a)
        yield
