#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mpx_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line of findings (any failure raises, and the
script exits nonzero without the final line):

0. device: the card's name and power limit, torch and CUDA versions;
1. build: compile K1, K3 and the window statistics kernel
   (mpx_torch/csrc/*.cu, one nvcc for each, together) for sm_90a, with
   ptxas's registers and the count of tensor-core instructions (DMMA,
   HMMA) in each of K1's kernels, from ``cuobjdump -sass`` of the
   library, and the registers, spills and shared memory of K3's three
   kernels (k3_segsum, k3_tiles, k3_merge) and of the four
   instantiations of ``window_stats``; the instructions of
   ``k3_tiles<double>``'s sub-tile loop by class, per pair;
2. K1 against its plain PyTorch version on the card, band level, f32 and
   f64, at the main path's job shape (S=4096, W=16384, m=256) on edge
   jobs, with CUDA-event times of both, of one ``torch.matmul`` of the
   same panels (TF32 off; the yardstick, never called by the port), K1's
   bound, and K1's time on the same job at m = 64, 128 and 512 and at
   W = 32768;
3. end to end, f64, n=131072, m=128 (data/benchmark/131072.txt.gz) through
   kernel='mxu_fused' (K1; ``auto`` takes K3 there), against kernel='mxu'
   on the card and against an exact float64 numpy row scan on 64 sampled
   rows;
4. end to end, f32, n=2^20, m=256, band 4096, chunk 32768 (a random walk
   from a fixed seed) through K1 and one launch of the window statistics
   kernel, against the exact row scan;
5. the command line: ``python -m mpx_torch compute`` on data/binary/16384.tsb;
51. (run after 5) the statistics backends on phase 4's walk (n=2^20,
    m=256) and on a walk of n=2^18 at m=4096, each with a planted constant
    run: the window statistics kernel against its plain version on the
    card (inv within 1e-14 relative, the same zero-variance windows, qt0
    and the corrected mean's residuals), the share of its inv bit-equal to
    the host library's ``precompute_stats``, ``native`` against ``numpy``
    on the card's host; the kernel's CUDA-event times (inv alone, with
    qt0, with the residuals), its plain version's and its bound; each
    backend's ``host_statistics`` and whole ``precompute_statistics`` on
    the host clock, ``auto``'s choice (``device``) held to the fastest;
6. K3 against its plain PyTorch version (``sweep_band_xla``) on the card,
   band level, f32 and f64, on phase 2's series and edge jobs, with
   CUDA-event times of K3's wrapper (seed, allocations and launches, as
   the driver calls it; K3's ``ms``), of its kernels alone (the job's
   launches), of a job inside a full batch (16 jobs in one call, its
   CUDA-event and kernel times over 16), of the plain version and of K1
   at the same job shape; the rows of a segment the wrapper picks;
   K3 at W = 32768 too, its grid, resident blocks per SM and share of the
   bound; and K3's and K1's wrapper times (with K3's kernels alone) per m
   (64, 128, 256, 512) and chunk (16384, 32768);
7. the f64 showcase through K3 (``kernel='pallas'``): n=2^20, m=256, band
   4096, chunk 32768, a random walk from a fixed seed, one K3 launch per
   job and no plain call, against the exact row scan; its sweep time per
   job beside phase 6's K3 times (wrapper, kernels alone) at W = 32768;
   the same rows read with the running mean's statistics (what the
   recurrence tier read before its corrected means) beside, and the host
   statistics (``auto``: the window statistics kernel) timed with and
   without the correction;
8. parity: ``kernel='pallas'`` and ``kernel='hybrid'`` in f64 and f32 on
   phase 3's series against phase 3's K1 f64 profile;
9. ``auto`` for f64 at m=8192 (n=65536): K3, no K1 and no window matrix
   (peak device memory), against ``kernel='mxu_fused'`` on the same series;
10. the f64 showcase through K1 (``kernel='mxu_fused'``; ``auto`` takes
    K3 there): n=2^20, m=256, band 4096, chunk 32768, a random walk from
    its own fixed seed, one K1 launch per job and no plain call, against
    the exact row scan;
11. the hybrid's margin probe on phase 7's series, S=4096, W=32768, three
    edge jobs, m = 64, 256, 512: the worst difference between K1's f32 and
    f64 row/column maxima of the same job (pass A) and between the f32 and
    f64 products over the masked tile (pass B), each held to a quarter of
    ``default_margin(m)``;
12. the f64 showcase through ``kernel='hybrid'`` on phase 7's series: one
    K1 f32 launch per job (pass A) and no plain call, against the exact row
    scan and phase 7's K3 profile; its phase split, flags per job,
    escalated rows, peak device memory, clock and power; then 400 of pass
    B's sparse jobs alone under ``torch.profiler`` (device time, launches
    and the device's busy share per job);
13. a tie-heavy series on the card (80 exact repeats of a motif,
    n=65520, m=64) through ``kernel='hybrid'``: pass C and the float64 row
    scans run, against the exact row scan;
14. the f64 left/right profiles through ``kernel='hybrid'`` (n=2^19, cut
    from the showcase's 2^20 to keep the script under 600 s;
    m=256, band 4096, chunk 32768): one K1 f32 launch per job and no plain
    call, each side against an exact sided float64 row scan, and the
    nearer of the two sides against the K1 f64 self-join of the same
    series; its phase split, flags, escalated rows per
    side, capture bytes, peak device memory, clock and power beside phase
    12's;
15. the hybrid's width gate on phase 3's series: with ``SPARSE_MAX_W``
    lowered below w the self-join and the left/right hybrid take the dense
    pass B with no captures, and give the sparse runs' profiles; the peak
    device memory of both routes;
16. the new surfaces: ``python -m mpx_torch bench`` (the f64 showcase
    shape through K3, validated on 64 rows) as a subprocess, ``compute
    --left-right --kernel hybrid`` and ``compute --dtype ap32`` on
    data/binary/16384.tsb, and ``tsbin -e``/``-d`` round trips;
18. K1 with a column operand: AB jobs of S=4096 x W=32768, m=256, on two
    random walks (65,536 and 49,152 samples, a constant run each), an
    interior job, one over both constant runs and the ragged edge, against
    the plain ``sweep_band_mxu(stats_c=)``, f32 and f64; K1's time per AB
    job and share of the bound; the self-join through the two-operand
    launch (``stats_c=stats``) bit-equal to ``stats_c=None``, timed beside
    phase 2;
19. the AB-join end to end through ``auto`` (K1), f32 and f64: A = 2^19,
    B = 2^18 samples (cut from 2^20 x 2^19 to keep the script under 600
    s once phases 24-28 came) with 8 planted copies of A's segments under
    1e-3 noise, m=256, band 4096, chunk 32768: 1,024 K1 launches per dtype
    and no plain call; 64 A windows and 64 B windows (outside the copies)
    against exact f64 scans of the other series, and every copy found;
20. the same AB-join in f64 through ``kernel='hybrid'``: 1,024 K1 f32
    launches (pass A), each side against the exact scans and phase 19's
    f64 profiles; its phase split, flags, captures and peak memory;
21. top-k on the card (m=256, k=4, f64 strict, band 4096, chunk 32768:
    ``topk-f64-1048576-k4`` without its hybrid, cut to n=2^19 because n=2^20
    takes 75 s on an H100 at 700 W), 32 rows against an exact scan;
    ``compute_topk_ab`` f32 on phase 3's series in halves;
22. sum-threshold on the card (m=256, threshold 0.7, f32, band 4096,
    chunk 16384: ``thresh-f32-1048576`` cut from n=2^20 to 2^19 to keep the
    script under 600 s once phases 24-28 came), 32 rows against exact f64
    sums and counts;
23. the ``abjoin``, ``topk`` and ``thresh`` command lines on
    data/binary/16384.tsb, each file equal to the API's result;
24. the float64 top-k hybrid (m=256, k=4, band 4096, chunk 32768) on
    the first n=2^18 samples of phase 21's series (``topk-f64-1048576-k4``
    cut from n=2^20 to 2^19 once phases 29-32 came, and to 2^18 once phases
    48-50 came): one K1 float32 launch per job (pass A) and no plain sweep,
    32 rows against the exact scan, equal to the strict tile of the same
    series within 1e-10, the strict tile's time beside; phase split, rows
    resolved per stage and round, rounds, peak memory, clock and power;
25. the top-k hybrid on phase 13's tie-heavy series at k=4 and k=8 against
    the strict float64 tile, pass C, the wide pass C and the exact row
    scan each resolving rows (a knob set between the series' tie counts);
26. the raw-Euclidean (AAMP) profiles: the self-join f32 at n=2^19 (cut
    from 2^20 to keep the script under 600 s) and
    f64 at n=2^18, the AB-join f32 (A = 2^19, B = 2^18), a large-amplitude
    f64 series (a walk x 1e6 + 1e7, n=2^16), 64 rows each against an exact
    f64 raw scan (mpx's 2e-4 / 1e-10 of the largest distance), and mpx's
    globally centered f32 form on the same rows beside;
27. the pooled distance matrix at ``matrix-f32-1048576``'s shape (n=2^20,
    m=256, 64 x 64, band = chunk = 4096): 8 cells recomputed exactly in
    f64, symmetry, and an AB summary against ``brute_force_pooled_matrix``;
28. the ``compute --raw``, ``matrix`` (with and without ``-b``) and ``topk
    --dtype float64`` command lines, each file equal to the API's result;
29. mSTAMP at ``mstamp-f32-d4-131072``'s shape (n=2^17, m=256, d=4, f32,
    band 2048, chunk 4096), 8 rows across all k against an exact f64
    oracle within 2e-3; f64 at n=2^15 with a flat segment, plain,
    ``include=(1,)`` and ``discords=True``, 8 rows each within 1e-8; wall,
    dimension-pairs/s, ms a job, peak memory;
30. the pan surface, n=2^16, ``pan_m_range(64, 8192, 8)``: the fused f32
    sweep (torch ops) and the exact f64 surface through ``auto`` (K1 at
    m = 64, K3 from m = 128 up, no plain sweep), the fused rows within 2e-3 of the exact rows,
    16 exact windows within 1e-8 of an exact f64 row scan on the card; ms
    per level per job of the fused sweep;
31. MERLIN at ``merlin-f32-524288-16``'s lengths (256..271) cut from
    n=2^19 to 2^18 to keep the script under 570 s once phases 48-50 came
    (``bench --suite`` measures the full shape): the suite runner's
    validation, the discords at 256 and 271 equal to the full f64
    profile's maximum (K3) within 1e-9, the survey and refine times,
    candidates and observed survey error per length beside eps; motifs at
    n=2^16, lengths 64..71, each within 1e-9 of the exact f64 profile's
    minimum;
32. the ``mstamp``, ``pan --motifs --discords`` and ``merlin`` command
    lines, each file and table equal to the API's result;
33. streaming at ``streaming-f32-262144``'s full shape (n=2^18, m=256,
    f32, 50 appends of 64): append ms, appended pairs/s, the recompute
    pairs, elements staged an append, capacity doublings, five appends
    under ``torch.profiler``, 32 rows against the exact scan; FLOSS and
    online DAMP (n=2^16, m=128, f64, 64 appends of 256; bootstrapped
    through K3): the right and left states within 1e-8 of the card's batch
    profiles, the planted burst alerts;
34. the anytime profile (n=2^19, m=256, f32, band 4096, chunk 16384) in
    both orders: yields non-increasing, the last equal to
    ``compute_matrix_profile``; ``approx_matrix_profile(0.25)``'s wall;
35. checkpoints: K3 (f64, n=2^19, ``kernel='pallas'``) killed after half
    its groups and resumed, bit-equal, with its overhead; the hybrid (f64,
    n=2^19) killed in pass A and in pass B, each resume bit-equal; K3 and
    the hybrid each within 1e-8 of the exact scan on the 8 rows where they
    differ most;
36. the fleet at ``batch-f32-256x8192``'s full shape (B=256, n=8192,
    m=64): wall, ms a series, K1 launches, the device idle share; 8 series
    bit-equal to single runs, 4 validated on 16 rows;
37. masked gaps (n=2^19, m=256, ~1 % NaN in runs): K1 f32 and K3 f64 and
    a f32 left/right run, gap windows at the sentinel, good rows against
    the exact masked scan;
38. DAMP at ``damp-f64-524288``'s full shape (n=2^19, m=256, f64, band
    4096, chunk 32768; through K3): wall, pairs/s, 16 rows' left values
    within 1e-8;
39. ``compute --checkpoint`` (resuming a killed run), ``--approx``,
    ``--allow-missing``, ``damp``, ``batch`` and ``floss``, each equal to
    the library;
40. the contrast profile at ``contrast-f64-524288``'s full shape (n=2^19,
    m=256, f64, band 4096, chunk 32768) through ``run_contrast_benchmark``:
    one timed run, the self-join's K3 and the AB-join's K1 f64 launches,
    32 sampled rows within 1e-8; wall and pairs/s;
41. the other compositions at moderate sizes: ``compute_chains`` (f32,
    n=2^18), ``ostinato`` (f64, 3 x 2^16, a planted motif), ``snippets``
    (f32, n=2^15, L=1024), ``cluster_series`` (f64, 4 x 2^15), ``k_motiflets``
    (f32, n=2^16, m=128, k=5) and ``aamp_mpdist`` (f64), each against the
    driver, exact host scans or the CPU run;
42. the ``analyze``, ``chains``, ``contrast``, ``ostinato``, ``snippets``,
    ``cluster``, ``motiflets``, ``query`` and ``abjoin --mpdist`` command
    lines, each printed value and file equal to the API's result;
43. K1 f32 through one job of 4096 x 16384 at m = 256, 512, 1024, 2048
    and 4096 on walks with noisy planted copies: the largest distance error
    over 64 rows against the exact f64 row scan (self-matches left out),
    gated at 2e-3, the plain sweep's reading and the exact copy's distance
    beside, and the readings of the single accumulation chain the per-slab
    promotion replaced (measured before the repair);
44. job sharding over 4 virtual shards of cuda:0 (n=2^18, m=256, band
    4096, chunk 16384): f32 through K1 and f64 through K3, values bit-equal
    to the single-device run, indices equal or equidistant, both walls;
45. ``ring-f32-1048576`` at full shape (n=2^20, m=256, f32, shards 1,
    band 4096, chunk 16384) through ``compute_matrix_profile``'s ring (K1): wall, pairs/s,
    K1 launches, 64 rows against the exact scan; a 4-virtual-shard ring at
    n=2^18 equal to the one-shard ring;
46. ``ring-f64-1048576`` at full shape through the ring hybrid: wall, pass
    A/B/C split and counts, 64 rows within 1e-8 of the exact scan;
47. ``distributed_matrix_profile`` in a one-rank NCCL group the phase opens
    and closes (n=2^18, f32 through K1), equal to the single-device run;
    ``compute --shards 1 --shard-mode ring`` and ``batch --shards 1`` on
    data/binary/16384.tsb, each file equal to the API's;
48. ``DeviceContext`` on the card (``finish`` after a staged product, the
    round trip) and ``python -m mpx_torch --version`` as a subprocess
    (started before phase 46, read after phase 49, so reported after 49);
49. ``python -m mpx_torch serve`` as a subprocess on the card, a pipe
    server and a TCP server (both started before phase 46, so that their
    imports overlap phases 46-47; every request line is encoded before the
    first is sent): ``ping``, ``compute`` on
    phase 4's n=2^20 f32 walk (m=256, band 4096, chunk 32768) twice, each
    bit-equal to phase 4's profile, and in f64 at n=2^17 bit-equal to a
    direct call and 64 rows against the exact scan, the client's latency
    beside the direct call's wall; ``stream.create`` sessions in ``full``,
    ``floss`` and ``damp`` mode at ``streaming-f32-262144``'s shape (the
    ``full`` profile against phase 33's stream); a malformed line and an
    unknown op; over TCP a ``compute`` at n=2^14, a client reset and
    ``shutdown``; each server's K1 and K3 launches (printed at its exit)
    equal to those of the same work in this process;
50. ``python -m mpx_torch bench --suite --only ... --table --out`` as a
    subprocess for ``vanilla-f32-8192``, ``tiled-f32-131072``,
    ``real-sudden-cardiac-death``, ``real-italian-power-f64`` and
    ``streaming-f32-262144``: each row measured and validated, the table
    printed;
52. ``mpx_torch.entry()`` on the card (n=1024, m=32, band 128, chunk 256,
    f32): one call of ``fn(*example_args)``, one K1 launch a job, against
    the same call of ``entry(device="cpu")`` after ``postcompute`` (2e-3);
53. ``mpx_torch.dryrun_multichip(4)`` on the card: job shards, the ring,
    the f64 hybrid, mSTAMP and the fleet on four virtual shards of cuda:0,
    then two processes of two virtual shards in one Gloo group with their
    tensors on the card; every ``OK`` line, the time before each;
54. ``python -m mpx_torch.bench_line``'s showcase job (f64, n=2^20,
    m=256, ``auto`` = K3; a warm-up, a timed run, 64 validated rows)
    through its ``main``: the JSON line parsed, checked and printed;
17. TF32: the script sets ``allow_tf32`` before phase 2 and the port
    leaves it so through every phase (checked after each, reported last).

The line before the last but one is a JSON object with one entry per
kernel and dtype (launches counted in that kernel's main-path runs: the
window statistics kernel in phases 4, 7, 10 and 52-54, one a
statistics call; K1 in
phases 10 and 4, the AB-joins of phase 19, (f32) the top-k hybrid's
pass A of phase 24 and MERLIN's escalations in phase 31, (f64) the exact
pan's m = 64 level in phase 30, phases 33–37's f32 runs of the new entry
points (the checkpointed hybrids' pass A in phase 35 included), the
contrast profile's AB-join in phase 40 (f64) and phase 41's compositions
(chains and snippets f32, ostinato and the clustering's AB-joins f64),
and (f32) the sharded runs of phases 44-47 (the ring hybrid's pass A in
46) and the served requests and stream bootstraps of phase 49, the entry
step of phase 52 and this process's dry run of phase 53; K3 in phases 7,
8 and (f64) the exact pan's other levels in 30, the FLOSS/DAMP
bootstraps of 33, 35, 37, 38, the contrast profile's self-join in 40,
44, the served f64 request of 49 and the bench line of 54; the bound and the library call's time at the
band-level shape; the other 1-NN hybrids' K1 launches are in phase 12's,
14's and 20's lines; top-k, sum-threshold, AAMP, the pooled
matrix, mSTAMP and the fused pan are otherwise torch ops); the line before the last is
the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or mpx.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20260101
K1_SOURCE = "mpx_torch/csrc/mxu_fused.cu"
K1_REPLACES = "mpx/kernels/mxu_fused.py:50"
K3_SOURCE = "mpx_torch/csrc/band_recurrence.cu"
K3_REPLACES = "mpx/kernels/pallas_tpu.py:55"
# The window statistics kernel has no Pallas counterpart: it replaces mpx's
# on-device statistics backend (backend='jax') and its host C++ one.
STATS_SOURCE = "mpx_torch/csrc/precompute.cu"
STATS_REPLACES = "mpx/ops/precompute.py:289"
# Band-level tolerances (values) and end-to-end distance tolerances.  K1
# and its plain version sum the same m products; K3 and its plain version
# carry the recurrence's rounding down the band's rows in another order
# (1e-4 in f32, the bound mpx holds its Pallas kernel to against its XLA
# sweep).
BAND_TOL = {"float32": 1e-5, "float64": 1e-12}
K3_BAND_TOL = {"float32": 1e-4, "float64": 1e-12}
DIST_TOL = {"float32": 2e-3, "float64": 1e-8}
ZERO_VARIANCE_REL = 1e-10
# Peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet; dense,
# no sparsity), for the bounds.  K1 runs f64 on the FP64 tensor cores and
# f32 as three TF32 products.  K3's work is counted in instructions of the
# data's type (an FMA is one, at half the FLOP rate): FP32 for float32
# statistics, FP64 for float64.  That band_recurrence.cu computes in
# float64 for both is the kernel's choice, not part of the work.
MEM_BYTES_PER_S = 3.35e12
K1_FLOPS = {"float64": 67e12, "float32": 495e12 / 3}
K3_OPS_PER_S = {"float64": 34e12 / 2, "float32": 67e12 / 2}
# Floating-point instructions per pair in K3's bound: the QT update
# (multiply, FMA, add), P = QT * inv_r * inv_c (two multiplies), the NaN
# test, and the row and column comparisons.  band_recurrence.cu issues six
# (the update as two FMAs, the NaN test folded into the comparisons); the
# bound keeps the algorithm's count.
K3_OPS_PER_PAIR = 8
# Pairs a lane sweeps in one pass of k3_tiles' sub-tile loop: TR = 16 rows
# of D = 8 diagonals (band_recurrence.cu), for the loop's census.
K3_LOOP_PAIRS = 16 * 8
# FP64 instructions per window element in the window statistics kernel
# (precompute.cu): the subtraction and the two FMAs of the sums of squares,
# one FMA more for qt0, one add more for the residuals.
STATS_OPS_PER_ELEMENT = 3


def inv_tol(chain: int) -> float:
    """Relative tolerance on inv where one side sums a window's squares in
    chains of ``chain`` terms: 1e-14 up to 128 terms (the kernel's two
    chains at m = 256), beyond that the worst-case relative error of such
    a chain of positive terms, chain * 2^-53 (the host library's single
    chain at m = 256 and 4096, the kernel's at m = 4096)."""
    return 1e-14 if chain <= 128 else chain * 2.0 ** -53


def require(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def say(phase: str, **fields) -> None:
    print(f"[phase {phase}] " + json.dumps(fields), flush=True)


def random_walk(n: int, seed: int) -> np.ndarray:
    return np.cumsum(np.random.default_rng(seed).standard_normal(n))


# ---------------------------------------------------------------- oracle


def unit_windows64(T: np.ndarray, m: int, lo: int, hi: int):
    """Exact float64 unit-normalized windows [lo, hi) (two-pass mean and
    norm per window) and their degenerate (zero-variance) mask."""
    wv = np.lib.stride_tricks.sliding_window_view(T, m)[lo:hi]
    cent = wv - wv.mean(axis=1, keepdims=True)
    ssq = np.einsum("ij,ij->i", cent, cent)
    degenerate = ssq <= ZERO_VARIANCE_REL * np.einsum("ij,ij->i", wv, wv)
    with np.errstate(divide="ignore", invalid="ignore"):
        Z = cent / np.sqrt(ssq)[:, None]
    Z[degenerate] = 0.0
    return Z, degenerate


def row_corr64(T: np.ndarray, m: int, rows: np.ndarray, target=None) -> np.ndarray:
    """Exact Pearson correlations (len(rows), wt) of the sampled windows of
    ``T`` to every window of ``target`` (default ``T``: the self-join,
    NaN inside the exclusion zone), NaN for degenerate windows; blockwise
    so memory stays bounded."""
    Tt = T if target is None else target
    wt = Tt.shape[0] - m + 1
    q = [unit_windows64(T, m, r, r + 1) for r in rows]
    Zq, deg_q = np.stack([z[0] for z, _ in q]), np.array([d[0] for _, d in q])
    P = np.empty((len(rows), wt))
    blk = max(1, (128 << 20) // (8 * m))  # ~128 MB of windows per block
    for o in range(0, wt, blk):
        Z, deg = unit_windows64(Tt, m, o, min(o + blk, wt))
        P[:, o : o + Z.shape[0]] = Zq @ Z.T
        P[:, o : o + Z.shape[0]][:, deg] = np.nan
    if target is None:
        cols = np.arange(wt)
        P[np.abs(cols[None, :] - rows[:, None]) < m // 4] = np.nan
    P[deg_q] = np.nan
    return P


def row_scan64(T: np.ndarray, m: int, rows: np.ndarray, target=None) -> np.ndarray:
    """Exact z-normalized distances of :func:`row_corr64`'s pairs, +inf
    where it has NaN."""
    P = row_corr64(T, m, rows, target)
    with np.errstate(invalid="ignore"):
        D = np.sqrt(np.maximum(2.0 * m * (1.0 - P), 0.0))
    return np.where(np.isnan(P), np.inf, D)


def check_rows(T, m, MP, MPI, rows, tol, side: int = 0, D=None) -> float:
    """MP/MPI on the sampled rows against the exact scan (``D``, when the
    caller has it); an index may differ from the scan's argmin only when
    equidistant within tol.  ``side`` +1 (-1) keeps only the later (earlier)
    neighbors: the right (left) profile."""
    D = row_scan64(T, m, rows) if D is None else D.copy()
    cols = np.arange(D.shape[1])
    if side:
        D[side * (cols[None, :] - rows[:, None]) < 0] = np.inf
    worst = 0.0
    for k, r in enumerate(rows):
        best = D[k].min()
        if not np.isfinite(best):
            require(MPI[r] == -1, f"row {r}: no valid neighbor, got MPI {MPI[r]}")
            continue
        err = abs(float(MP[r]) - best)
        worst = max(worst, err)
        require(err <= tol, f"row {r}: MP {MP[r]} vs exact {best} (tol {tol})")
        j = int(MPI[r])
        require(0 <= j and abs(D[k, j] - best) <= tol,
                f"row {r}: MPI {j} at distance {D[k, j]}, exact nearest {best}")
    return worst


def pair_distances64(T, m, a, b, target=None) -> np.ndarray:
    """Exact z-normalized distances between windows a[k] of ``T`` and b[k]
    of ``target`` (default ``T``)."""
    wv = np.lib.stride_tricks.sliding_window_view(T, m)
    wt = wv if target is None else np.lib.stride_tricks.sliding_window_view(target, m)
    za, zb = (v[x] - v[x].mean(axis=1, keepdims=True) for v, x in ((wv, a), (wt, b)))
    P = np.einsum("ij,ij->i", za, zb) / np.sqrt(
        np.einsum("ij,ij->i", za, za) * np.einsum("ij,ij->i", zb, zb))
    return np.sqrt(np.maximum(2.0 * m * (1.0 - P), 0.0))


def check_profiles_agree(T, m, MP, MPI, MP2, MPI2, tol, target=None) -> float:
    """Two profiles of one series (against ``target``, for an AB-join):
    distances within tol, indices equal or equidistant within tol."""
    err = float(np.abs(MP.astype(np.float64) - MP2).max())
    require(err <= tol, f"profiles differ by {err} (tol {tol})")
    diff = np.nonzero(MPI != MPI2)[0]
    require(bool(((MPI[diff] >= 0) & (MPI2[diff] >= 0)).all()),
            "a row has a neighbor in one profile and none in the other")
    gap = np.abs(pair_distances64(T, m, diff, MPI[diff], target)
                 - pair_distances64(T, m, diff, MPI2[diff], target))
    require(bool((gap <= tol).all()),
            f"{int((gap > tol).sum())} rows: indices differ and are not equidistant")
    return err


# ---------------------------------------------------------------- phases


def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say("0 device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, devices=torch.cuda.device_count())
    return smi


def phase_build():
    from mpx_torch.kernels import _build

    # Build from the checkout's sources in this run, even where an earlier
    # run left the library: the ptxas report below comes from the build.
    if os.path.exists(_build.library_path()):
        os.remove(_build.library_path())
    t0 = time.perf_counter()
    _build.load()
    seconds = time.perf_counter() - t0
    regs = [ln.strip() for ln in (_build.BUILD_LOG or "").splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln]
    sass = library_sass(_build)
    mma = tensor_core_counts(sass)
    for name, counted in mma.items():
        kind = "DMMA" if "double" in name else "HMMA"
        require(counted[kind] > 0, f"{name} has no {kind} instruction: {counted}")
    say("1 build", seconds=seconds, library=os.path.relpath(
        _build.library_path(), REPO), ptxas=regs, sass_mma=mma,
        k3_ptxas=ptxas_report(_build.BUILD_LOG or "", K3_MANGLED),
        k3_tiles_f64_loop_per_pair=k3_loop_census(sass),
        stats_ptxas=ptxas_report(_build.BUILD_LOG or "", STATS_MANGLED))


K3_MANGLED = {f"{k}<{t}>": f"{len(k)}{k}{c}" for k in ("k3_segsum", "k3_tiles", "k3_merge")
              for t, c in (("float", "If"), ("double", "Id"))}
STATS_MANGLED = {f"window_stats<{q}, {r}>": f"12window_statsILb{int(q)}ELb{int(r)}E"
                 for q in (False, True) for r in (False, True)}


def ptxas_report(log: str, mangled: dict) -> dict:
    """Registers, spill bytes and static shared memory of the kernels named
    in ``mangled`` (name -> a piece of the mangled name), from ptxas's
    report in the build log."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = next((k for k, c in mangled.items() if c in ln), None)
        elif name and "spill stores" in ln:
            w = ln.split()
            out.setdefault(name, {}).update(spill_store_bytes=int(w[w.index("spill") - 2]),
                                            spill_load_bytes=int(w[-4]))
        elif name and "registers" in ln:
            w = ln.replace(",", " ").split()
            out.setdefault(name, {})["registers"] = int(w[w.index("registers") - 1])
            out[name]["smem_bytes"] = int(w[w.index("smem") - 2]) if "smem" in w else 0
    require(len(out) == len(mangled), f"ptxas report incomplete: {sorted(out)}")
    return out


K1_TILES = {f"k1_tiles<{t}, {ab}>": f"k1_tilesI{c}Lb{int(ab == 'true')}E"
            for t, c in (("double", "d"), ("float", "f")) for ab in ("false", "true")}


def library_sass(_build) -> str:
    """``cuobjdump -sass`` of the built library."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", _build.library_path()],
                          capture_output=True, text=True, check=True).stdout


def tensor_core_counts(sass: str) -> dict:
    """DMMA and HMMA instructions in each of K1's tile kernels (per dtype,
    the self-join's and the two-operand instantiation), counted in the
    library's SASS."""
    out = {}
    for section in sass.split("Function : ")[1:]:
        name = section.split(None, 1)[0]
        for key, mangled in K1_TILES.items():
            if mangled in name:
                ops = [op for ln in section.splitlines() if "*/" in ln
                       for op in ln.split("*/", 1)[1].split()[:2]]  # [predicate] opcode
                out[key] = {kind: sum(op.startswith(kind + ".") or op == kind
                                      for op in ops) for kind in ("DMMA", "HMMA")}
    require(set(out) == set(K1_TILES), f"K1's tile kernels not found in the SASS: {sorted(out)}")
    return out


def sass_class(op: str) -> str:
    base = op.split(".")[0]
    if base in ("DFMA", "DMUL", "DADD", "DSETP", "DMNMX"):
        return "fp64"
    if base in ("SEL", "FSEL", "MOV") or op.startswith("IMAD.MOV"):
        return "selects_moves"
    return {"LDS": "shared_loads", "SHFL": "shuffles"}.get(base, "other")


def k3_loop_census(sass: str) -> dict:
    """The instructions of ``k3_tiles<double>``'s sub-tile loop (from the
    target of its longest innermost backward branch to the branch) by class, per pair a
    lane sweeps in one pass (K3_LOOP_PAIRS), from the library's SASS."""
    section = next(sec for sec in sass.split("Function : ")[1:]
                   if K3_MANGLED["k3_tiles<double>"] in sec.split(None, 1)[0])
    ins = []
    for ln in section.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", ln)
        if m:
            words = m.group(2).split()
            ins.append((int(m.group(1), 16), words[1] if words[0].startswith("@") else words[0],
                        words[-1]))
    back = [(int(last, 16), at) for at, op, last in ins
            if op.startswith("BRA") and last.startswith("0x") and int(last, 16) < at]
    require(bool(back), "k3_tiles<double> has no loop in the SASS")
    # The sub-tile loop: the longest loop with no loop inside it (the chunk
    # loop around it also stages the next chunk).
    inner = [(lo, hi) for lo, hi in back
             if not any((lo, hi) != (a, b) and lo <= a and b <= hi for a, b in back)]
    lo, hi = max(inner, key=lambda b: b[1] - b[0])
    counts = {}
    for at, op, _ in ins:
        if lo <= at <= hi:
            counts[sass_class(op)] = counts.get(sass_class(op), 0) + 1
    out = {k: v / K3_LOOP_PAIRS for k, v in sorted(counts.items())}
    out["all"] = sum(counts.values()) / K3_LOOP_PAIRS
    return out


def time_ms(torch, fn, reps: int = 5) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def band_setup(dtype: str, m: int = 256, W: int = 16384):
    """The band-level series, statistics (with windows), geometry and
    edge jobs at the main path's job shape (S=4096, W=16384, m=256)."""
    from mpx_torch.kernels.common import band_geometry
    from mpx_torch.ops.precompute import precompute_statistics

    n, S = 65536, 4096
    T = random_walk(n, SEED)
    T[30000:30700] = T[30000]  # a constant run: zero-variance windows
    w = n - m + 1
    stats = precompute_statistics(T, m, band=S, chunk=W, dtype=dtype, device="cuda")
    geom = band_geometry(S, W, m, w)
    jobs = {
        "first band": (0, 0),
        "exclusion zone": (8192, 0),
        "constant run": (28672, 0),
        "rows past w-1": ((w - 1) // S * S, 0),
        "columns past w-1": ((w - W - 1) // S * S, W),
    }
    return stats, geom, jobs


def compare_band(torch, what: str, a, b, U64, r0: int, k0: int, tol: float,
                 U64c=None) -> float:
    """Band outputs a (plain) and b (kernel): values within tol, indices
    equal or tied within tol on the exact unit windows U64 (of the rows)
    and U64c (of the columns, default U64)."""
    U64c = U64 if U64c is None else U64c
    worst = 0.0
    for side, base, own_w, cand_w in (("row", r0, U64, U64c), ("col", r0 + k0, U64c, U64)):
        pa, pb = getattr(a, side), getattr(b, side)
        require(pa.value.shape == pb.value.shape, f"{what} {side}: shapes differ")
        err = float((pa.value.double() - pb.value.double()).abs().max())
        worst = max(worst, err)
        require(err <= tol, f"{what} {side}: kernel vs plain {err} > {tol}")
        ia, ib = pa.index.long(), pb.index.long()
        bad = torch.nonzero(ia != ib).flatten()
        require(bool(((ia[bad] >= 0) & (ib[bad] >= 0)).all()),
                f"{what} {side}: a masked aggregate differs")
        own = own_w[base + bad]
        gap = ((own * cand_w[ia[bad]]).sum(1) - (own * cand_w[ib[bad]]).sum(1)).abs()
        require(bool((gap <= tol).all()),
                f"{what} {side}: index differs where values do not tie")
    return worst


def phase_band(torch, dtype: str) -> dict:
    """K1 vs sweep_band_mxu on the card at the main path's job shape."""
    from mpx_torch.kernels.mxu import sweep_band_mxu
    from mpx_torch.kernels.mxu_fused import sweep_band_mxu_fused

    stats, geom, jobs = band_setup(dtype)
    S, W, m = geom.S, geom.W, geom.m
    tol = BAND_TOL[dtype]
    U64 = stats.windows.double()
    worst = 0.0
    for what, (r0, k0) in jobs.items():
        a = sweep_band_mxu(stats, r0, k0, geom, dtype)
        b = sweep_band_mxu_fused(stats, r0, k0, geom, dtype)
        torch.cuda.synchronize()
        worst = max(worst, compare_band(torch, f"K1 {dtype} {what}", a, b, U64,
                                        r0, k0, tol))
    r0, k0 = 4096, W  # an interior job of the main path's grid
    c0 = r0 + k0
    Ur, Uc = stats.windows[r0 : r0 + S], stats.windows[c0 : c0 + W]
    # The yardstick: one library product of the same panels, in full
    # precision (TF32 would keep ~3 digits); no mask, no reduction.
    from mpx_torch.dtypes import full_precision_matmul

    def library():
        with full_precision_matmul():
            return torch.matmul(Ur, Uc.T)

    plain1 = time_ms(torch, lambda: sweep_band_mxu(stats, r0, k0, geom, dtype))
    k1a = time_ms(torch, lambda: sweep_band_mxu_fused(stats, r0, k0, geom, dtype))
    lib1 = time_ms(torch, library)
    lib2 = time_ms(torch, library)
    k1b = time_ms(torch, lambda: sweep_band_mxu_fused(stats, r0, k0, geom, dtype))
    plain2 = time_ms(torch, lambda: sweep_band_mxu(stats, r0, k0, geom, dtype))
    ms, plain_ms, library_ms = (k1a + k1b) / 2, (plain1 + plain2) / 2, (lib1 + lib2) / 2
    flops = 2.0 * S * W * m
    # K1's time per m at the same job (the work is O(m), K3's is not), and
    # at the showcase runs' chunk, W = 32768.
    by_m = {}
    del Ur, Uc
    for m2 in (64, 128, 512):
        stats2, geom2, _ = band_setup(dtype, m2)
        by_m[m2] = time_ms(torch, lambda: sweep_band_mxu_fused(stats2, r0, k0, geom2, dtype))
        del stats2
    by_m[m] = ms
    stats2, geom2, _ = band_setup(dtype, m, 2 * W)
    ms_w2 = time_ms(torch, lambda: sweep_band_mxu_fused(stats2, r0, 2 * W, geom2, dtype))
    del stats2
    bound = k1_bound(S, W, m, stats.windows.element_size(), dtype)
    say(f"2 band {dtype}", shape=dict(S=S, W=W, m=m), jobs=list(jobs),
        max_abs_err=worst, tol=tol, k1_ms=[k1a, k1b], plain_ms=[plain1, plain2],
        library_ms=[lib1, lib2], allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        **bound, k1_share_of_bound=bound["bound_ms"] / ms,
        k1_tflops=flops / ms / 1e9, plain_tflops=flops / plain_ms / 1e9,
        library_tflops=flops / library_ms / 1e9, k1_ms_by_m=dict(sorted(by_m.items())),
        k1_ms_w32768=ms_w2)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **bound,
            "library_ms": library_ms}


def bound_of(nbytes: float, ops: float, rate: float) -> dict:
    """The least time for the work: the larger of the bytes over the
    memory rate and the operations over their peak rate."""
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, ops / rate
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes > t_ops else "operations"}


def k1_bound(S: int, W: int, m: int, itemsize: int, dtype: str) -> dict:
    """K1 on one job: the S + W windows and inverse norms read once, the
    S + W (value, index) aggregates written once; 2m FLOPs a pair."""
    nbytes = (S + W) * (m + 1) * itemsize + (S + W) * (itemsize + 4)
    return bound_of(nbytes, 2.0 * S * W * m, K1_FLOPS[dtype])


def k3_bound(S: int, W: int, itemsize: int, dtype: str) -> dict:
    """K3 on one job: df, dg and inv of S rows and S + W columns and the W
    seeds read once, the S + (S + W) aggregates written once;
    K3_OPS_PER_PAIR instructions a pair."""
    nbytes = (3 * S + 3 * (S + W) + W) * itemsize + (2 * S + W) * (itemsize + 4)
    return bound_of(nbytes, float(K3_OPS_PER_PAIR) * S * W, K3_OPS_PER_S[dtype])


def stats_bound(n: int, m: int, qt0: bool, resid: bool) -> dict:
    """The window statistics kernel on one series: T (n,) and mu (w,) read
    once, inv (and qt0, the residuals) written once; STATS_OPS_PER_ELEMENT
    FP64 instructions a window element, one more each for qt0 and the
    residuals, at the FP64 instruction rate (K3's float64 rate)."""
    w = n - m + 1
    nbytes = 8.0 * (n + w + (1 + qt0 + resid) * w)
    ops = float(w) * m * (STATS_OPS_PER_ELEMENT + qt0 + resid)
    return bound_of(nbytes, ops, K3_OPS_PER_S["float64"])


# The port's counters (``mpx_torch.utils.profile.counters()``) at the last
# reset_counts(): the counts below are differences from it.
_COUNTS_AT_RESET: dict = {}


def reset_counts():
    global _COUNTS_AT_RESET
    from mpx_torch.utils.profile import counters

    _COUNTS_AT_RESET = counters()


def _since_reset(name: str) -> int:
    from mpx_torch.utils.profile import counters

    return counters()[name] - _COUNTS_AT_RESET.get(name, 0)


def stats_launches() -> int:
    """Launches of the window statistics kernel since the last reset (kept
    out of ``counts()``: every sweep path launches it once a run)."""
    return _since_reset("launches.window_stats")


def counts() -> dict:
    """Launches of K1, jobs of K3 (``jobs.k3``: a batch of them a launch),
    calls of their plain versions."""
    return {"k1": _since_reset("launches.k1"), "mxu": _since_reset("calls.mxu"),
            "k3": _since_reset("jobs.k3"), "xla": _since_reset("calls.xla")}


# The kernels' names in the closing JSON line, by launch counter.
COUNTER_KERNEL = {"k1": "mxu_fused", "k3": "band_recurrence"}


def auto_counter(dtype: str, m: int) -> str:
    """The launch counter of the sweep ``auto`` takes on the card for
    ``dtype`` and ``m`` (K1, or K3 for float64 from ``K3_MIN_M_F64``)."""
    from mpx_torch.kernels import resolve_kernel

    return {"mxu_fused": "k1", "pallas": "k3"}[resolve_kernel("auto", "cuda", dtype, m)]


def require_only(c: dict, kernel: str, what: str, launches=None) -> int:
    """The run launched ``kernel`` (``launches`` times, when given) and
    nothing else of the four counted paths."""
    others = {k: v for k, v in c.items() if k != kernel}
    ok = c[kernel] > 0 if launches is None else c[kernel] == launches
    require(ok and not any(others.values()),
            f"{what}: counts {c}, expected only {kernel}"
            f"{'' if launches is None else f' x{launches}'}")
    return c[kernel]


class CardSampler:
    """The card's SM clock (MHz) and power draw (W), sampled by nvidia-smi
    every 200 ms while the block runs; the process is stopped on exit."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "200"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=10)
        vals = []
        for ln in out.splitlines():
            try:
                vals.append([float(x) for x in ln.split(",")][:2])
            except ValueError:  # "[N/A]" or a line cut by the stop
                continue
        vals = np.array([v for v in vals if len(v) == 2]).reshape(-1, 2)
        self.summary = {"samples": len(vals)} if not len(vals) else {
            "samples": len(vals), "sm_mhz_median": float(np.median(vals[:, 0])),
            "power_w_median": float(np.median(vals[:, 1])),
            "sm_mhz_max": float(vals[:, 0].max()),
            "power_w_max": float(vals[:, 1].max())}
        return False


def run_profile(torch, T, cfg, prof=None, left_right: bool = False):
    """Returns MP, MPI (with ``left_right``: MP_left, MPI_left, MP_right,
    MPI_right), wall seconds, phase seconds and the card's clock and power
    during the run; ``prof`` (a BenchmarkProfile) keeps what the run
    counted."""
    from mpx_torch import compute_matrix_profile
    from mpx_torch.utils.profile import BenchmarkProfile

    prof = BenchmarkProfile() if prof is None else prof
    torch.cuda.synchronize()
    with CardSampler() as card:
        t0 = time.perf_counter()
        out = compute_matrix_profile(T, config=cfg, profile=prof, left_right=left_right)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = [o.cpu().numpy() for o in out]
    w = T.shape[0] - cfg.m + 1
    for MP, MPI in zip(out[::2], out[1::2]):
        require(MP.shape == (w,) and MPI.shape == (w,), f"shapes {MP.shape} {MPI.shape}")
        require(np.isfinite(MP).all(), "non-finite distances")
        require(((MPI >= -1) & (MPI < w)).all(), "index out of range")
    phases = {k: v / 1e9 for k, v in prof.category_totals().items()}
    return (*out, wall, phases, card.summary)


def sample_rows(w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.sort(np.concatenate([[0, w - 1], rng.choice(w, 62, replace=False)]))


def parity_series():
    from mpx_torch.io.tsb import read_series

    return read_series(os.path.join(REPO, "data", "benchmark", "131072.txt.gz")), 128


def phase_e2e_f64(torch):
    """Returns K1's profile of the series."""
    from mpx_torch import MatrixProfileConfig

    T, m = parity_series()
    tol = DIST_TOL["float64"]
    w = T.shape[0] - m + 1
    cfg = MatrixProfileConfig(m=m, dtype="float64", kernel="mxu_fused", device="cuda")
    reset_counts()
    MP, MPI, wall, phases, card = run_profile(torch, T, cfg)
    launches = require_only(counts(), "k1", "K1 f64 run")
    reset_counts()
    MPp, MPIp, wall_plain, _, _ = run_profile(
        torch, T, MatrixProfileConfig(m=m, dtype="float64", kernel="mxu", device="cuda"))
    require_only(counts(), "mxu", "kernel='mxu' f64 run")
    vs_plain = check_profiles_agree(T, m, MP, MPI, MPp, MPIp, tol)
    vs_exact = check_rows(T, m, MP, MPI, sample_rows(w, SEED), tol)
    pairs = w * (w - 1) / 2
    say("3 e2e f64", n=T.shape[0], m=m, band=cfg.band, chunk=cfg.chunk,
        k1_launches=launches, plain_calls=0, wall_s=wall,
        pairs_per_s=pairs / wall, phases_s=phases, card=card, plain_wall_s=wall_plain,
        max_err_vs_plain=vs_plain, max_err_vs_exact_64_rows=vs_exact, tol=tol)
    return MP, MPI


def phase_e2e_f32(torch) -> dict:
    from mpx_torch import MatrixProfileConfig

    n, m, tol = 1 << 20, 256, DIST_TOL["float32"]
    T = random_walk(n, SEED + 1)
    w = n - m + 1
    cfg = MatrixProfileConfig(m=m, dtype="float32", band=4096, chunk=32768,
                              device="cuda")
    reset_counts()
    MP, MPI, wall, phases, card = run_profile(torch, T, cfg)
    launches = require_only(counts(), "k1", "auto f32 run")
    st = stats_launches()
    require(st == 1, f"auto f32 run: {st} window statistics launches, expected 1")
    vs_exact = check_rows(T, m, MP, MPI, sample_rows(w, SEED + 1), tol)
    pairs = w * (w - 1) / 2
    say("4 e2e f32", n=n, m=m, band=cfg.band, chunk=cfg.chunk,
        k1_launches=launches, stats_launches=st, plain_calls=0, wall_s=wall,
        pairs_per_s=pairs / wall, phases_s=phases, card=card,
        max_err_vs_exact_64_rows=vs_exact, tol=tol)
    return {"launches": launches, "stats_launches": st, "T": T, "MP": MP, "MPI": MPI,
            "wall_s": wall, "band": cfg.band, "chunk": cfg.chunk}


def phase_cli():
    src = os.path.join(REPO, "data", "binary", "16384.tsb")
    m = 256
    w = os.path.getsize(src) // 8 - m + 1
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "mpx_torch", "compute", "-i", src, "-m", str(m),
             "-o", out], cwd=REPO, capture_output=True, text=True, timeout=600,
        )
        require(proc.returncode == 0, f"CLI failed:\n{proc.stdout}{proc.stderr}")
        sizes = (os.path.getsize(out + ".mpb"), os.path.getsize(out + ".mpib"))
        require(sizes == (8 * w, 4 * w), f"output sizes {sizes}, expected w={w}")
        MP = np.fromfile(out + ".mpb", "<f8")
        require(np.isfinite(MP).all(), "CLI wrote non-finite distances")
        say("5 cli", command="python -m mpx_torch compute -i data/binary/16384.tsb "
            f"-m {m} -o <tmp>/out", seconds=time.perf_counter() - t0,
            mpb_bytes=sizes[0], mpib_bytes=sizes[1])


def phase_stats_backends(torch, T4) -> dict:
    """The statistics backends on phase 4's walk (n=2^20, m=256) and on a
    walk of n=2^18 at m=4096, each with a constant run of 2m samples
    planted at n/4: the window statistics kernel against its plain version
    on the same card tensors (inv within ``inv_tol(m / 2)`` relative,
    1e-14 at m = 256, with the same zero-variance windows, qt0 within
    1e-12 of m max T^2, the residuals within 1e-13 of m max |T|) and the
    share of its inv bit-equal to the host library's
    ``precompute_stats``; ``native`` against ``numpy`` on this host (mu,
    df, dg bit-equal, the same zero-variance windows, inv within
    ``inv_tol(m)``, qt0 as above); the kernel's
    CUDA-event times (inv alone as the hybrid launches it, with qt0 as the
    driver does, with the residuals as the recurrence tier does), its
    plain version's, its bound; each backend's ``host_statistics`` and
    whole ``precompute_statistics`` (f32, windows, band 4096, chunk 32768,
    as phase 4 stages them) on the host clock, and ``auto``'s choice held
    to the fastest whole call at the showcase shape."""
    from mpx_torch import native
    from mpx_torch.kernels.stats import window_stats_cuda, window_stats_torch
    from mpx_torch.ops.precompute import (
        CUDA_AUTO_BACKEND,
        _running_mean,
        host_statistics,
        precompute_statistics,
        resolve_backend,
    )

    require(resolve_backend("auto", "cuda") == CUDA_AUTO_BACKEND,
            f"auto on the card is {resolve_backend('auto', 'cuda')}")
    out, main = {}, None
    for n, m, T in ((1 << 20, 256, T4), (1 << 18, 4096, random_walk(1 << 18, SEED + 51))):
        T = np.array(T[:n], np.float64)
        T[n // 4 : n // 4 + 2 * m] = T[n // 4]
        w, tmax = n - m + 1, float(np.max(np.abs(T)))
        Tt = torch.as_tensor(T, device="cuda")
        mut = torch.as_tensor(_running_mean(T, m), device="cuda")
        inv, qt0, resid = window_stats_cuda(Tt, mut, m, qt0=True, resid=True)
        torch.cuda.synchronize()
        rinv, rqt0, rresid = window_stats_torch(Tt, mut, m, qt0=True, resid=True)
        fin = torch.isfinite(rinv)
        require(torch.equal(torch.isfinite(inv), fin) and not bool(fin.all()),
                f"m={m}: zero-variance windows differ from the plain version")
        inv_rel = float((inv[fin] / rinv[fin] - 1).abs().max())
        inv_abs = float((inv[fin] - rinv[fin]).abs().max())
        qt0_err = float((qt0 - rqt0).abs().max())
        resid_err = float((resid - rresid).abs().max())
        require(inv_rel <= inv_tol(m // 2), f"m={m}: inv {inv_rel} from the plain version")
        require(qt0_err <= 1e-12 * m * tmax ** 2, f"m={m}: qt0 {qt0_err}")
        require(resid_err <= 1e-13 * m * tmax, f"m={m}: residuals {resid_err}")
        inv_only = window_stats_cuda(Tt, mut, m)[0]
        require(torch.equal(inv_only, inv), f"m={m}: inv alone differs from inv with qt0")
        nat_stats = native.precompute_stats(T, m)
        bit_equal = float((inv_only.cpu().numpy() == nat_stats["inv"]).mean())

        ms = {"inv": time_ms(torch, lambda: window_stats_cuda(Tt, mut, m), reps=20),
              "inv_qt0": time_ms(torch, lambda: window_stats_cuda(Tt, mut, m, qt0=True),
                                 reps=20),
              "inv_qt0_resid": time_ms(torch, lambda: window_stats_cuda(
                  Tt, mut, m, qt0=True, resid=True), reps=20)}
        plain_ms = time_ms(torch, lambda: window_stats_torch(Tt, mut, m, qt0=True), reps=2)
        bound = stats_bound(n, m, qt0=True, resid=False)

        host, whole, s = {}, {}, {}
        for b in ("device", "native", "numpy", "native", "device"):
            t0 = time.perf_counter()
            s[b] = host_statistics(T, m, backend=b, device="cuda")
            host.setdefault(b, []).append(time.perf_counter() - t0)
        for b in ("device", "native", "numpy", "native", "device"):
            whole.setdefault(b, []).append(direct(torch, lambda: precompute_statistics(
                T, m, band=4096, chunk=32768, dtype="float32", device="cuda", backend=b))[1])
        for name in ("mu", "df", "dg"):
            for b in ("native", "device"):
                require(np.array_equal(s[b][name], s["numpy"][name]),
                        f"m={m}: {b} {name} differs from numpy's")
        errs = {}
        for b in ("native", "device"):
            f = np.isfinite(s["numpy"]["inv"])
            require(np.array_equal(np.isfinite(s[b]["inv"]), f),
                    f"m={m}: {b} zero-variance windows differ from numpy's")
            errs[b] = {"inv_rel": float(np.abs(s[b]["inv"][f] / s["numpy"]["inv"][f] - 1).max()),
                       "qt0_abs": float(np.abs(s[b]["qt0"] - s["numpy"]["qt0"]).max())}
            require(errs[b]["inv_rel"] <= inv_tol(m if b == "native" else m // 2) and
                    errs[b]["qt0_abs"] <= 1e-12 * m * tmax ** 2, f"m={m}: {b} vs numpy {errs[b]}")
        fastest = min(whole, key=lambda b: min(whole[b]))
        if m == 256:
            require(fastest == CUDA_AUTO_BACKEND,
                    f"auto takes {CUDA_AUTO_BACKEND}, the fastest here is {fastest}: {whole}")
            main = {"max_abs_err": inv_abs, "ms": ms["inv_qt0"], "plain_ms": plain_ms,
                    **bound, "library_ms": None}
        out[f"n={n} m={m}"] = dict(
            w=w, zero_variance_windows=int((~fin).sum()), inv_max_rel_err=inv_rel,
            inv_max_abs_err=inv_abs, qt0_max_abs_err=qt0_err, resid_max_abs_err=resid_err,
            inv_bit_equal_share_vs_native_precompute_stats=bit_equal,
            kernel_ms=ms, plain_ms=plain_ms, **bound, share_of_bound=bound["bound_ms"] / ms[
                "inv_qt0"], host_statistics_s=host, precompute_statistics_s=whole,
            fastest=fastest, backends_vs_numpy=errs)
        del Tt, mut, inv, qt0, resid, rinv, rqt0, rresid, inv_only
    say("51 statistics backends", auto=CUDA_AUTO_BACKEND, native=native.is_available(),
        **out)
    return main


K3_KERNELS = ("k3_seed", "k3_segsum", "k3_tiles", "k3_merge")


def k3_traced_ms(torch, fn, calls: int, reps: int) -> float:
    """The device time of K3's kernels in one run of ``fn`` (``calls``
    calls of the library: seed, sweep and merge once a call, the segment
    sums once a call or never, one segment a job): each kernel's mean
    torch.profiler time over ``reps`` runs after a warm-up, times
    ``calls``, summed.  The profiler can miss a launch at its start, so a
    kernel may be seen one time fewer."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = {k: [] for k in K3_KERNELS}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for k in K3_KERNELS:
                if f"{k}<" in e.name:
                    us[k].append(e.time_range.elapsed_us())
    n = calls * reps
    require(all(n - 1 <= len(v) <= n or (k == "k3_segsum" and not v) for k, v in us.items()),
            f"K3 kernels traced: { {k: len(v) for k, v in us.items()} } for {n} calls")
    return sum(sum(v) / len(v) for v in us.values() if v) * calls / 1e3


def k3_kernel_ms(torch, stats, r0, k0, geom, dtype, reps: int = 20) -> float:
    """K3's kernels alone on one job: the summed torch.profiler device
    time of the kernels (seed, segment sums where the job has several
    segments, sweep, merge) of one ``sweep_band_recurrence`` call."""
    from mpx_torch.kernels.recurrence import sweep_band_recurrence

    return k3_traced_ms(torch, lambda: sweep_band_recurrence(stats, r0, k0, geom, dtype),
                        1, reps)


def k3_batch_ms(torch, stats, geom, dtype, reps: int = 10) -> dict:
    """A job's time inside a full batch (``BATCH_JOBS`` jobs of the grid
    from its ninth on, across its first k0 change, in one library call):
    the batch's CUDA-event time through ``sweep_batches`` and its kernels'
    profiler time, each over the batch's jobs."""
    from mpx_torch.config import make_job_grid
    from mpx_torch.dtypes import AGGREGATE_INIT, torch_dtype
    from mpx_torch.kernels.recurrence import BATCH_JOBS, sweep_batches
    from mpx_torch.ops.aggregates import init_aggregates

    grid = make_job_grid(geom.w, geom.S, geom.W)
    r0s, k0s = (x[8:8 + BATCH_JOBS].tolist() for x in (grid.r0, grid.k0))
    require(len(r0s) == BATCH_JOBS and len(set(k0s)) > 1,
            f"a full batch across a k0 change: {list(zip(r0s, k0s))}")
    pw = stats.df.shape[0]
    dt = torch_dtype(dtype)
    rows, cols = (init_aggregates(pw, dt, AGGREGATE_INIT, stats.df.device) for _ in range(2))

    def batch():
        for _ in sweep_batches(stats, r0s, k0s, geom=geom, dtype=dtype, rows=rows, cols=cols):
            pass

    return {"events_ms_per_job": time_ms(torch, batch, reps) / BATCH_JOBS,
            "kernels_ms_per_job": k3_traced_ms(torch, batch, 1, reps) / BATCH_JOBS}


def k3_wrapper_ms(torch, stats, r0, k0, geom, dtype, reps: int = 50) -> float:
    """CUDA-event time of one job through K3's wrapper, a batch of one (the
    checks, the allocations and the four launches).  Its host
    work can set the pace, and the host's clock is noisy: many runs."""
    from mpx_torch.kernels.recurrence import sweep_band_recurrence

    return time_ms(torch, lambda: sweep_band_recurrence(stats, r0, k0, geom, dtype), reps)


def phase_band_k3(torch, dtype: str) -> dict:
    """K3 vs sweep_band_xla on the card on phase 2's series and jobs,
    timed beside the plain version and K1 at the same job shape; K3 and K1
    per m and chunk."""
    from mpx_torch.kernels import _build
    from mpx_torch.kernels.mxu_fused import sweep_band_mxu_fused
    from mpx_torch.kernels.recurrence import _segment_rows_on, sweep_band_recurrence
    from mpx_torch.kernels.xla import sweep_band_xla

    stats, geom, jobs = band_setup(dtype)
    S, W, m = geom.S, geom.W, geom.m
    tol = K3_BAND_TOL[dtype]
    U64 = stats.windows.double()
    worst = 0.0
    for what, (r0, k0) in jobs.items():
        a = sweep_band_xla(stats, r0, k0, geom, dtype)
        b = sweep_band_recurrence(stats, r0, k0, geom, dtype)
        torch.cuda.synchronize()
        require(b.col.value.shape == (S + W,), f"K3 column window {b.col.value.shape}")
        worst = max(worst, compare_band(torch, f"K3 {dtype} {what}", a, b, U64,
                                        r0, k0, tol))
    r0, k0 = 4096, W  # an interior job of the main path's grid
    # K3's time is its wrapper's, as the driver calls it and as K1's is
    # taken (seed, allocations and launches; its host work is part of the
    # job); its kernels alone are timed beside it.
    k3 = lambda: k3_wrapper_ms(torch, stats, r0, k0, geom, dtype)  # noqa: E731
    alone = lambda: k3_kernel_ms(torch, stats, r0, k0, geom, dtype)  # noqa: E731
    k1 = lambda: time_ms(torch, lambda: sweep_band_mxu_fused(  # noqa: E731
        stats, r0, k0, geom, dtype))
    # The plain version is a Python loop of ~S x 15 launches: one run each.
    plain = lambda: time_ms(torch, lambda: sweep_band_xla(  # noqa: E731
        stats, r0, k0, geom, dtype), reps=1)
    plain1 = plain()
    k3a, alonea, k1a, k1b, aloneb, k3b = (f() for f in (k3, alone, k1, k1, alone, k3))
    in_batch = [k3_batch_ms(torch, stats, geom, dtype) for _ in range(2)]
    plain2 = plain()
    ms, alone_ms = (k3a + k3b) / 2, (alonea + aloneb) / 2
    k1_ms, plain_ms = (k1a + k1b) / 2, (plain1 + plain2) / 2
    pairs = float(S * W)
    bound = k3_bound(S, W, stats.df.element_size(), dtype)
    del U64
    # K3 and K1 per m and chunk, wrapper against wrapper (the crossover
    # `auto` needs; K3's kernels do O(1) work a pair whatever m, its seed
    # O(m) a diagonal), and K3's kernels alone.
    by_shape = {}
    for W2 in (W, 2 * W):
        for m2 in (64, 128, 256, 512):
            stats2, geom2, _ = band_setup(dtype, m2, W2)
            args = (stats2, r0, W2, geom2, dtype)
            by_shape[f"W={W2} m={m2}"] = {
                "k3_ms": k3_wrapper_ms(torch, *args),
                "k1_ms": time_ms(torch, lambda: sweep_band_mxu_fused(*args)),
                "k3_kernels_ms": k3_kernel_ms(torch, *args)}
            del stats2
    lib = _build.load()
    f64 = int(dtype == "float64")
    w2 = by_shape[f"W={2 * W} m={m}"]
    bound_w2 = k3_bound(S, 2 * W, stats.df.element_size(), dtype)["bound_ms"]
    nbj = -(-W // lib.mpx_k3_block_w())
    L = _segment_rows_on(lib, geom, stats.df.dtype, stats.df.device)
    G = -(-S // L)
    say(f"6 band K3 {dtype}", shape=dict(S=S, W=W, m=m), jobs=list(jobs),
        max_abs_err=worst, tol=tol, k3_ms=[k3a, k3b], k3_kernels_ms=[alonea, aloneb],
        full_batch_per_job=in_batch,
        k3_full_batch_share_of_bound=bound["bound_ms"] / min(
            b["kernels_ms_per_job"] for b in in_batch),
        k1_ms=[k1a, k1b], plain_ms=[plain1, plain2], **bound,
        k3_share_of_bound=bound["bound_ms"] / ms,
        k3_kernels_share_of_bound=bound["bound_ms"] / alone_ms,
        k3_pairs_per_s=pairs / ms * 1e3, k1_pairs_per_s=pairs / k1_ms * 1e3,
        plain_pairs_per_s=pairs / plain_ms * 1e3,
        grid={"k3_segsum": [nbj, G - 1], "k3_tiles": [nbj, G], "threads": 32,
              "segment_rows": L, "chunk_rows": lib.mpx_k3_segment_rows()},
        resident_blocks_per_sm={k: lib.mpx_k3_resident_blocks(f64, i) for i, k in
                                enumerate(("k3_segsum", "k3_tiles", "k3_merge"))},
        k3_ms_w32768=w2["k3_ms"], k3_kernels_ms_w32768=w2["k3_kernels_ms"],
        k3_share_of_bound_w32768=bound_w2 / w2["k3_ms"],
        k3_kernels_share_of_bound_w32768=bound_w2 / w2["k3_kernels_ms"],
        by_chunk_and_m=by_shape)
    # No single library call computes the recurrence.
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **bound,
            "library_ms": None, "_w32768": w2}


def phase_showcase(torch, phase: str, kernel: str, counter: str, seed: int,
                   band_ms_per_job=None) -> tuple:
    """The reference's showcase job in double precision (n=2^20, m=256,
    band 4096, chunk 32768) through ``kernel``: one launch of K1 a job, or
    of K3 a batch of jobs, and no plain call, against the exact row scan.
    With
    ``band_ms_per_job`` (phase 6's times of one such job: the wrapper's
    ``k3_ms`` and the kernels' ``k3_kernels_ms``), the sweep's time per
    job is printed beside them.  Through K3, the same run is read again
    with the running mean's statistics (``exact_mean=False``, what the
    recurrence tier read before it took corrected means) on the same
    rows, beside the gated reading (that run is not counted), and the
    host statistics (``auto``: the window statistics kernel) are timed with
    and without the corrected mean.  Returns (launches of the counted
    kernel, of the window statistics kernel, the profile, the wall)."""
    from mpx_torch import MatrixProfileConfig, compute_matrix_profile
    from mpx_torch.config import make_job_grid
    from mpx_torch.ops.precompute import host_statistics, precompute_statistics

    n, m, tol = 1 << 20, 256, DIST_TOL["float64"]
    T = random_walk(n, seed)
    w = n - m + 1
    cfg = MatrixProfileConfig(m=m, dtype="float64", kernel=kernel, band=4096,
                              chunk=32768, device="cuda")
    grid = cfg.shrink_to(w)
    job_grid = make_job_grid(w, grid.band, grid.chunk)
    jobs = len(job_grid.r0)
    reset_counts()
    MP, MPI, wall, phases, card = run_profile(torch, T, cfg)
    launches = require_only(counts(), counter, f"kernel={kernel!r} f64 showcase", jobs)
    if counter == "k3":
        from mpx_torch.kernels.recurrence import BATCH_JOBS, job_batches

        batched = _since_reset("launches.k3")
        require(batched == len(job_batches(jobs, BATCH_JOBS)),
                f"K3 f64 showcase: {batched} batched launches for {jobs} jobs")
    st = stats_launches()
    require(st == 1, f"kernel={kernel!r} f64 showcase: {st} window statistics launches")
    rows = sample_rows(w, seed)
    D = row_scan64(T, m, rows)
    vs_exact = check_rows(T, m, MP, MPI, rows, tol, D=D)
    pairs = w * (w - 1) / 2
    per_job = {}
    if band_ms_per_job is not None:
        sweep = next(v for k, v in phases.items() if k.startswith("2. Compute"))
        per_job = {"sweep_ms_per_job": sweep / jobs * 1e3,
                   "band_level_ms_per_job": band_ms_per_job}
    if kernel == "pallas":
        t0 = time.perf_counter()
        host = host_statistics(T, m, device="cuda")
        t1 = time.perf_counter()
        host_statistics(T, m, device="cuda", exact_mean=True)
        per_job["host_stats_s"] = {"running_mean": t1 - t0,
                                   "exact_mean": time.perf_counter() - t1}
        running = precompute_statistics(T, m, band=grid.band, chunk=grid.chunk, dtype="float64",
                                        device="cuda", windows=False, host_stats=host)
        MPr = compute_matrix_profile(T, config=cfg, stats=running)[0].cpu().numpy()
        per_job["max_err_vs_exact_64_rows_running_mean"] = float(
            np.abs(MPr[rows] - D.min(axis=1)).max())
        del running, MPr, host
    if counter == "k3":
        per_job["k3_batched_launches"] = batched
    say(phase, n=n, m=m, kernel=kernel, band=cfg.band, chunk=cfg.chunk, jobs=jobs,
        **{f"{counter}_launches": launches}, stats_launches=st, plain_calls=0,
        wall_s=wall, pairs_per_s=pairs / wall, phases_s=phases, card=card, **per_job,
        max_err_vs_exact_64_rows=vs_exact, tol=tol)
    return launches, st, (MP, MPI), wall


def phase_parity(torch, k1_profile) -> int:
    """kernel='pallas' and kernel='hybrid' in f64 and f32 against phase 3's
    K1 f64 profile of the same series.  Returns K3's launches in the f32
    run."""
    from mpx_torch import MatrixProfileConfig
    from mpx_torch.config import make_job_grid

    T, m = parity_series()
    MP1, MPI1 = k1_profile
    w = T.shape[0] - m + 1
    out = {}
    for kernel, counter in (("pallas", "k3"), ("hybrid", "k1")):
        for dt in ("float64", "float32"):
            cfg = MatrixProfileConfig(m=m, dtype=dt, kernel=kernel, device="cuda")
            # The hybrid's pass A is one K1 f32 launch per job.
            jobs = len(make_job_grid(w, cfg.band, cfg.chunk).r0) if kernel == "hybrid" else None
            reset_counts()
            MP, MPI, wall, _, _ = run_profile(torch, T, cfg)
            launches = require_only(counts(), counter, f"kernel={kernel!r} {dt} run", jobs)
            require(MP.dtype == np.dtype(dt), f"kernel={kernel!r} {dt}: MP is {MP.dtype}")
            err = check_profiles_agree(T, m, MP, MPI, MP1, MPI1, DIST_TOL[dt])
            out[f"{kernel} {dt}"] = {f"{counter}_launches": launches, "wall_s": wall,
                                     "max_err_vs_k1_f64": err,
                                     "index_differs": int((MPI != MPI1).sum()),
                                     "tol": DIST_TOL[dt]}
    say("8 parity K3 and hybrid vs K1", n=T.shape[0], m=m, **out)
    return out["pallas float32"]["k3_launches"]


def phase_margin_probe(torch):
    """The hybrid's float32 passes against float64 on the card: on phase
    7's series, S=4096, W=32768, three edge jobs, m = 64, 256, 512, the
    worst |K1 f32 - K1 f64| of the row and column maxima of the same job
    (pass A; K1 f64 is held to 1e-12 of exact in phase 2) and the worst
    |f32 product - f64 product| over the masked tile (pass B's product),
    each on the hybrid's own operands and held to default_margin(m) / 4."""
    from mpx_torch.dtypes import full_precision_matmul
    from mpx_torch.hybrid import default_margin, hybrid_statistics
    from mpx_torch.kernels.common import band_geometry
    from mpx_torch.kernels.mxu import pair_mask
    from mpx_torch.kernels.mxu_fused import sweep_band_mxu_fused
    from mpx_torch.ops.precompute import build_windows

    n, S, W = 1 << 20, 4096, 32768
    T = random_walk(n, SEED + 2)
    out = {}
    for m in (64, 256, 512):
        w = n - m + 1
        stats, exact = hybrid_statistics(T, m, band=S, chunk=W, device="cuda")
        exact = exact._replace(windows=build_windows(exact, m))
        geom = band_geometry(S, W, m, w)
        jobs = {"first band": (0, 0), "interior": (w // 2 // S * S, W),
                "rows past w-1": ((w - 1) // S * S, 0)}
        pass_a = pass_b = 0.0
        for r0, k0 in jobs.values():
            a = sweep_band_mxu_fused(stats, r0, k0, geom, "float32")
            b = sweep_band_mxu_fused(exact, r0, k0, geom, "float64")
            for side in ("row", "col"):
                va, vb = getattr(a, side).value.double(), getattr(b, side).value
                live = vb >= -2  # a correlation, not the aggregate init
                require(bool((live == (va >= -2)).all()), f"m={m}: masks differ")
                if bool(live.any()):
                    pass_a = max(pass_a, float((va - vb)[live].abs().max()))
            c0 = r0 + k0
            with full_precision_matmul():
                P = (stats.windows[r0 : r0 + S] @ stats.windows[c0 : c0 + W].T).double()
            P -= exact.windows[r0 : r0 + S] @ exact.windows[c0 : c0 + W].T
            valid = pair_mask(exact, torch.arange(r0, r0 + S, dtype=torch.int32, device="cuda"),
                              torch.arange(c0, c0 + W, dtype=torch.int32, device="cuda"), geom)
            if bool(valid.any()):
                pass_b = max(pass_b, float(P.abs_()[valid].max()))
            del P, valid
        margin = default_margin(m)
        require(pass_a <= margin / 4 and pass_b <= margin / 4,
                f"m={m}: pass A {pass_a}, pass B {pass_b} beyond margin / 4 = {margin / 4}")
        out[f"m={m}"] = {"pass_a_k1_max_err": pass_a, "pass_b_product_err": pass_b,
                         "margin": margin, "margin_over_4": margin / 4}
        del stats, exact
    say("11 margin probe", n=n, S=S, W=W, jobs=list(jobs), **out)


def hybrid_split(phases: dict, sides=("left", "right")) -> dict:
    """The hybrid's phase seconds, grouped as phases 12, 14 and 20 report
    them (the rescore per side: left/right, or the AB-join's a/b)."""
    def total(*prefixes, side=""):
        return sum(v for k, v in phases.items()
                   if k.startswith(prefixes) and (not side or k.endswith(f", {side}]")))
    return {"statistics": total("1. "), "pass_a": total("2. Compute [pass A]"),
            "pass_b_sparse": total("2. Compute [pass B sparse]"),
            "pass_b_dense": total("2. Compute [pass B dense]"),
            "pass_c": total("2. Compute [pass C"), "rescore": total("3. "),
            **{f"rescore_{side}": total("3. ", side=side) for side in sides},
            "post": total("4. ")}


def run_hybrid(torch, T, m, left_right: bool = False, **cfg_kwargs):
    """One f64 run through kernel='hybrid' with its K1 launches checked
    (one per job, no plain call).  Returns MP, MPI (the four left/right
    arrays with ``left_right``), wall, phases, card, the run's counts and
    its peak device memory."""
    from mpx_torch import MatrixProfileConfig
    from mpx_torch.config import make_job_grid
    from mpx_torch.utils.profile import BenchmarkProfile

    cfg = MatrixProfileConfig(m=m, dtype="float64", kernel="hybrid", device="cuda",
                              **cfg_kwargs)
    w = T.shape[0] - m + 1
    grid = cfg.shrink_to(w)
    jobs = len(make_job_grid(w, grid.band, grid.chunk).r0)
    prof = BenchmarkProfile()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    *out, wall, phases, card = run_profile(torch, T, cfg, prof, left_right)
    peak = torch.cuda.max_memory_allocated() - base
    launches = require_only(counts(), "k1", f"kernel='hybrid' n={T.shape[0]} (pass A)", jobs)
    return (*out, wall, phases, card, dict(prof.counts, k1_launches=launches), peak)


def profile_pass_b(torch, T, m: int, S: int, W: int, jobs=range(1000, 1400)) -> dict:
    """Pass B's sparse jobs alone, at the run's shape: pass A again for its
    captures, then a window of jobs timed by the host clock and traced by
    torch.profiler (device kernel time, kernel launches, the device's busy
    share of the window)."""
    from torch.profiler import ProfilerActivity, profile

    from mpx_torch import hybrid
    from mpx_torch.config import make_job_grid
    from mpx_torch.kernels.common import band_geometry
    from mpx_torch.kernels.mxu import sweep_band_suspects_sparse

    w = T.shape[0] - m + 1
    stats, _ = hybrid.hybrid_statistics(T, m, band=S, chunk=W, device="cuda")
    grid = make_job_grid(w, S, W)
    thr, (r0s, k0s, jrow, jcol) = hybrid.run_max_jobs(
        stats, grid.r0, grid.k0, hybrid.default_margin(m), S=S, W=W, m=m, w=w,
        pw=stats.mu.shape[0])
    counts = hybrid._flag_counts(thr, r0s, k0s, jrow, jcol, S=S, W=W)
    geom = band_geometry(S, W, m, w)

    def window():
        for j in jobs:
            sweep_band_suspects_sparse(stats, r0s[j], k0s[j], jrow[j], jcol[j], geom, thr,
                                       *(int(x) for x in counts[j]))
        torch.cuda.synchronize()

    window()
    t0 = time.perf_counter()
    window()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    span = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
    launches = sum(e.count for e in prof.key_averages() if e.key == "cudaLaunchKernel")
    top = sorted(((e.key, e.self_device_time_total / len(jobs)) for e in prof.key_averages()
                  if e.key.startswith("aten::")), key=lambda x: -x[1])[:5]
    return {"jobs": f"{jobs.start}..{jobs.stop - 1}",
            "flags_per_job_mean": float(counts[list(jobs)].max(axis=1).mean()),
            "ms_per_job": wall / len(jobs) * 1e3,
            "profiled_device_us_per_job": busy / len(jobs),
            "profiled_launches_per_job": launches / len(jobs),
            "profiled_device_busy_share": busy / span,
            "top_ops_device_us_per_job": dict(top)}


def phase_showcase_hybrid(torch, k3_profile, k3_wall_s, k1_wall_s):
    """The f64 showcase through kernel='hybrid' on phase 7's series, held
    to the exact row scan and to phase 7's K3 profile; then pass B's sparse
    jobs profiled alone (:func:`profile_pass_b`)."""
    n, m, tol = 1 << 20, 256, DIST_TOL["float64"]
    T = random_walk(n, SEED + 2)
    w = n - m + 1
    MP, MPI, wall, phases, card, cnt, peak = run_hybrid(torch, T, m, band=4096,
                                                        chunk=32768)
    vs_exact = check_rows(T, m, MP, MPI, sample_rows(w, SEED + 2), tol)
    vs_k3 = check_profiles_agree(T, m, MP, MPI, *k3_profile, tol)
    pairs = w * (w - 1) / 2
    split = hybrid_split(phases)
    say("12 showcase f64 hybrid", n=n, m=m, band=4096, chunk=32768, plain_calls=0,
        wall_s=wall, pairs_per_s=pairs / wall, split_s=split,
        pass_b_sparse_ms_per_job=split["pass_b_sparse"] / cnt["jobs"] * 1e3,
        counts=cnt, peak_device_bytes=peak, card=card, phases_s=phases,
        max_err_vs_exact_64_rows=vs_exact, max_err_vs_k3=vs_k3,
        index_differs_vs_k3=int((MPI != k3_profile[1]).sum()), tol=tol,
        same_job_shape_wall_s={"hybrid": wall, "k3 (phase 7)": k3_wall_s,
                               "k1 (phase 10)": k1_wall_s})
    say("12 pass B sparse profiled", **profile_pass_b(torch, T, m, 4096, 32768))
    return {"profile": (MP, MPI), "wall_s": wall, "pairs_per_s": pairs / wall,
            "split_s": split, "counts": cnt, "peak_device_bytes": peak, "card": card}


def phase_tie_heavy(torch):
    """80 exact repeats of a random-walk motif under 1e-3 noise (n=65520,
    m=64): every window has 79 near-equal neighbors, past the 8 capture
    slots and pass C's 64, so pass C and the float64 row scans run on the
    card; held to the exact row scan."""
    repeats, L, m, tol = 80, 819, 64, DIST_TOL["float64"]
    rng = np.random.default_rng(SEED + 6)
    motif = np.cumsum(rng.standard_normal(L))
    T = np.tile(motif, repeats) + rng.standard_normal(L * repeats) * 1e-3
    w = T.shape[0] - m + 1
    MP, MPI, wall, phases, card, cnt, peak = run_hybrid(torch, T, m)
    require(cnt["pass_c_rows"] > 0 and cnt["row_scan_rows"] > 0,
            f"tie-heavy series: pass C / row scans did not run: {cnt}")
    vs_exact = check_rows(T, m, MP, MPI, sample_rows(w, SEED + 6), tol)
    say("13 tie-heavy hybrid", n=T.shape[0], m=m, repeats=repeats, wall_s=wall,
        split_s=hybrid_split(phases), counts=cnt, peak_device_bytes=peak,
        max_err_vs_exact_64_rows=vs_exact, tol=tol)


def phase_left_right_hybrid(torch, p12: dict):
    """The f64 left/right profiles through kernel='hybrid' at n=2^19 (the
    showcase's m, band and chunk; cut from n=2^20): one K1 f32
    launch per job and no plain call; each side within 1e-8 of the exact
    sided row scan on 64 sampled rows (indices only between equidistant
    neighbors); the nearer side within 1e-10 of the K1 f64 self-join of the
    same series; phase 12's numbers beside."""
    from mpx_torch import MatrixProfileConfig, make_job_grid

    n, m, tol = 1 << 19, 256, DIST_TOL["float64"]
    T = random_walk(n, SEED + 14)
    w = n - m + 1
    jobs = len(make_job_grid(w, 4096, 32768).r0)
    MPl, MPIl, MPr, MPIr, wall, phases, card, cnt, peak = run_hybrid(
        torch, T, m, left_right=True, band=4096, chunk=32768)
    require(cnt["k1_launches"] == jobs, f"left/right hybrid: {cnt['k1_launches']} K1 launches")
    rows = sample_rows(w, SEED + 14)
    D = row_scan64(T, m, rows)
    vs_exact = {side: check_rows(T, m, MP, MPI, rows, tol, sign, D)
                for side, sign, MP, MPI in (("left", -1, MPl, MPIl), ("right", 1, MPr, MPIr))}
    MPk, MPIk, *_ = run_profile(torch, T, MatrixProfileConfig(
        m=m, dtype="float64", kernel="mxu_fused", band=4096, chunk=32768, device="cuda"))
    nearer = np.minimum(MPl, MPr)
    vs_p12 = float(np.abs(nearer - MPk).max())
    require(vs_p12 <= 1e-10, f"min(left, right) vs the K1 self-join: {vs_p12}")
    pairs = w * (w - 1) / 2
    split = hybrid_split(phases)
    say("14 left/right f64 hybrid", n=n, m=m, band=4096, chunk=32768,
        k1_launches=cnt["k1_launches"], plain_calls=0, wall_s=wall,
        pairs_per_s=pairs / wall, split_s=split, counts=cnt, peak_device_bytes=peak,
        card=card, phases_s=phases, max_err_vs_exact_sided_64_rows=vs_exact, tol=tol,
        max_err_min_left_right_vs_k1_self_join=vs_p12,
        index_differs_vs_k1_self_join=int((np.where(MPr < MPl, MPIr, MPIl) != MPIk).sum()),
        phase_12={k: v for k, v in p12.items() if k != "profile"})


def phase_width_gate(torch):
    """SPARSE_MAX_W lowered below w on phase 3's series: the self-join and
    the left/right hybrid take the dense pass B, pass A keeps no captures,
    and the profiles equal the sparse runs' within 1e-12; peak device
    memory of both routes."""
    from mpx_torch import hybrid

    T, m = parity_series()
    w = T.shape[0] - m + 1
    tol = 1e-12
    out = {}
    gate, run_max_jobs = hybrid.SPARSE_MAX_W, hybrid.run_max_jobs
    try:
        for left_right in (False, True):
            runs = {}
            for route, width in (("sparse", gate), ("dense", w)):
                hybrid.SPARSE_MAX_W = width
                captured = []
                hybrid.run_max_jobs = lambda *a, **k: captured.append(
                    k["capture"]) or run_max_jobs(*a, **k)
                *prof, wall, _, _, cnt, peak = run_hybrid(torch, T, m, left_right=left_right)
                require(cnt["pass_b"] == route and captured == [route == "sparse"]
                        and (cnt["capture_bytes"] == 0) == (route == "dense"),
                        f"width gate {route}: {cnt}, capture={captured}")
                runs[route] = (prof, wall, cnt, peak)
            (a, *_), (b, *_) = runs["sparse"], runs["dense"]
            err = max(check_profiles_agree(T, m, a[i], a[i + 1], b[i], b[i + 1], tol)
                      for i in range(0, len(a), 2))
            out["left/right" if left_right else "self-join"] = {
                route: {"wall_s": wall, "pass_b": cnt["pass_b"],
                        "capture_bytes": cnt["capture_bytes"],
                        "dense_jobs": cnt["dense_jobs"], "peak_device_bytes": peak}
                for route, (_, wall, cnt, peak) in runs.items()} | {"max_err": err}
    finally:
        hybrid.SPARSE_MAX_W, hybrid.run_max_jobs = gate, run_max_jobs
    say("15 width gate", n=T.shape[0], m=m, w=w, lowered_to=w, tol=tol, **out)


def run_cli(*args, subprocess_: bool = False, timeout: int = 600) -> str:
    """``python -m mpx_torch ARGS`` as a subprocess, or its ``main`` in this
    process; returns what it printed and fails on a nonzero exit."""
    if subprocess_:
        proc = subprocess.run([sys.executable, "-m", "mpx_torch", *args], cwd=REPO,
                              capture_output=True, text=True, timeout=timeout)
        require(proc.returncode == 0, f"{args[0]} failed:\n{proc.stdout}{proc.stderr}")
        return proc.stdout
    import contextlib
    import io

    from mpx_torch.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(args))
    require(rc == 0, f"{args[0]} returned {rc}:\n{buf.getvalue()}")
    return buf.getvalue()


def phase_surfaces(torch):
    """The bench subcommand (a subprocess at the f64 showcase shape through
    K3, its validation on 64 rows), compute --left-right --kernel hybrid
    and compute --dtype ap32 on data/binary/16384.tsb, tsbin round trips."""
    from mpx_torch import MatrixProfileConfig, compute_matrix_profile
    from mpx_torch.io.apfixed import quantize
    from mpx_torch.io.tsb import read_ascii, read_binary, read_series

    t0 = time.perf_counter()
    cmd = ["bench", "-n", "1048576", "-m", "256", "--dtype", "float64", "--kernel",
           "pallas", "--chunk", "32768", "--validate", "64"]
    lines = run_cli(*cmd, subprocess_=True).strip().splitlines()
    last, detail = json.loads(lines[-1]), json.loads(lines[-2])
    require(set(last) == {"metric", "value", "unit", "vs_baseline"} and last["value"] > 0,
            f"bench's last line: {lines[-1]}")
    require(detail["validation"]["rows"] == 64, f"bench's validation: {detail}")
    bench = {"command": "python -m mpx_torch " + " ".join(cmd), "seconds":
             time.perf_counter() - t0, "device_line": lines[0], "last_line": last,
             "wall_s": detail["wall_s"], "compute_s": detail["compute_s"],
             "validation": detail["validation"]}

    src = os.path.join(REPO, "data", "binary", "16384.tsb")
    T, m = read_series(src), 256
    w = T.shape[0] - m + 1
    compute = {}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out")
        t0 = time.perf_counter()
        run_cli("compute", "-i", src, "-m", str(m), "--dtype", "float64", "--kernel",
                "hybrid", "--left-right", "-o", out)
        lr = [read_binary(out + s + e, k) for s in (".left", ".right")
              for e, k in ((".mpb", "double"), (".mpib", "int"))]
        require(all(a.shape == (w,) for a in lr) and np.isfinite(lr[0]).all()
                and np.isfinite(lr[2]).all(), "compute --left-right wrote bad files")
        MP, _ = compute_matrix_profile(T, config=MatrixProfileConfig(
            m=m, dtype="float64", kernel="hybrid", device="cuda"))
        err = float(np.abs(np.minimum(lr[0], lr[2]) - MP.cpu().numpy()).max())
        require(err <= 1e-10, f"compute --left-right: min(left, right) vs the hybrid {err}")
        compute["left_right_hybrid"] = {"seconds": time.perf_counter() - t0,
                                        "max_err_min_vs_self_join": err}
        t0 = time.perf_counter()
        run_cli("compute", "-i", src, "-m", str(m), "--dtype", "ap32", "-o", out)
        MPq = read_binary(out + ".mpb", "double")
        MPk, _ = compute_matrix_profile(quantize(T, "ap32"), config=MatrixProfileConfig(
            m=m, dtype="float64", device="cuda"))
        err = float(np.abs(MPq - MPk.cpu().numpy()).max())
        require(MPq.shape == (w,) and err <= DIST_TOL["float64"],
                f"compute --dtype ap32 vs the quantized series through K1: {err}")
        compute["ap32"] = {"seconds": time.perf_counter() - t0, "max_err_vs_quantized": err}

        txt = os.path.join(REPO, "data", "test", "16384.txt")
        ref = read_ascii(txt)
        tsbin = {}
        for kind in ("double", "ap32"):
            enc, dec = os.path.join(tmp, f"t.{kind}"), os.path.join(tmp, f"t.{kind}.txt")
            run_cli("tsbin", "-e", txt, "-o", enc, "-t", kind)
            run_cli("tsbin", "-d", enc, "-o", dec, "-t", kind)
            back = read_ascii(dec)
            want = ref if kind == "double" else quantize(ref, kind)
            require(np.array_equal(back, want), f"tsbin {kind} round trip differs")
            tsbin[kind] = {"values": int(back.shape[0]), "encoded_bytes": os.path.getsize(enc)}
    say("16 surfaces", bench=bench, compute=compute, tsbin=tsbin)


def phase_auto_large_m(torch):
    """auto in f64 at m > MXU_MAX_M goes through K3 and builds no window
    matrix; K1 on the same series agrees."""
    from mpx_torch import MatrixProfileConfig
    from mpx_torch.kernels import MXU_MAX_M

    n, m, tol = 65536, 8192, DIST_TOL["float64"]
    require(m > MXU_MAX_M, "m must exceed MXU_MAX_M")
    T = random_walk(n, SEED + 3)
    w = n - m + 1
    windows_bytes = w * m * 8  # the unpadded window matrix K1 reads
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    MP, MPI, wall, phases, _ = run_profile(
        torch, T, MatrixProfileConfig(m=m, dtype="float64", device="cuda"))
    peak = torch.cuda.max_memory_allocated() - base
    launches = require_only(counts(), "k3", "auto f64 m=8192 run")
    require(peak < windows_bytes / 4,
            f"auto f64 m={m}: peak {peak} B, a window matrix is {windows_bytes} B")
    reset_counts()
    MP1, MPI1, wall1, _, _ = run_profile(
        torch, T, MatrixProfileConfig(m=m, dtype="float64", kernel="mxu_fused",
                                      device="cuda"))
    require_only(counts(), "k1", "kernel='mxu_fused' f64 m=8192 run")
    err = check_profiles_agree(T, m, MP, MPI, MP1, MPI1, tol)
    say("9 auto f64 large m", n=n, m=m, k3_launches=launches, wall_s=wall,
        phases_s=phases, peak_bytes=peak, window_matrix_bytes=windows_bytes,
        k1_wall_s=wall1, max_err_vs_k1=err, tol=tol)


def ab_band_setup(dtype: str, m: int = 256, S: int = 4096, W: int = 32768):
    """Phase 18's two series (65,536 and 49,152 samples of random walks,
    each with a constant run), their statistics, the AB geometry and its
    jobs (r0, c0): an interior one, one over both constant runs, and the
    ragged edge (rows past wa - 1, columns past wb - 1).  A's run opens
    A and B's closes B: runs inside both would give the two series
    identical step windows (a run and one other sample: P = 1), where two
    float32 summation orders differ most (1.07e-5 in the first run of this
    phase, past phase 2's 1e-5)."""
    from mpx_torch.kernels.common import NO_EXCL, band_geometry
    from mpx_torch.ops.precompute import precompute_statistics

    A, B = random_walk(65536, SEED + 7), random_walk(49152, SEED + 8)
    A[:700] = A[700]
    B[-600:] = B[-601]
    wa, wb = A.shape[0] - m + 1, B.shape[0] - m + 1
    sa, sb = (precompute_statistics(X, m, band=S, chunk=W, dtype=dtype, device="cuda")
              for X in (A, B))
    geom = band_geometry(S, W, m, wa, wc=wb, excl=NO_EXCL)
    jobs = {"interior": (4096, 0), "constant runs": (0, 32768),
            "ragged edge": ((wa - 1) // S * S, (wb - 1) // W * W)}
    return sa, sb, geom, jobs


def phase_ab_band(torch, dtype: str, self_join_ms: float) -> dict:
    """K1 with a column operand (an AB job, S=4096 x W=32768, m=256)
    against the plain ``sweep_band_mxu(stats_c=)`` on the card, its time
    per job and share of the bound; and K1's self-join launch (the same
    matrix passed twice, ``stats_c=stats``) bit-equal to ``stats_c=None``,
    timed beside phase 2's time."""
    from mpx_torch.kernels.mxu import sweep_band_mxu
    from mpx_torch.kernels.mxu_fused import sweep_band_mxu_fused

    sa, sb, geom, jobs = ab_band_setup(dtype)
    S, W, m = geom.S, geom.W, geom.m
    tol = BAND_TOL[dtype]
    Ua, Ub = sa.windows.double(), sb.windows.double()
    worst = 0.0
    for what, (r0, c0) in jobs.items():
        a = sweep_band_mxu(sa, r0, c0 - r0, geom, dtype, stats_c=sb)
        b = sweep_band_mxu_fused(sa, r0, c0 - r0, geom, dtype, stats_c=sb)
        torch.cuda.synchronize()
        worst = max(worst, compare_band(torch, f"K1 AB {dtype} {what}", a, b, Ua, r0,
                                        c0 - r0, tol, Ub))
    del Ua, Ub
    r0, c0 = jobs["interior"]
    ms = time_ms(torch, lambda: sweep_band_mxu_fused(sa, r0, c0 - r0, geom, dtype, stats_c=sb))
    bound = k1_bound(S, W, m, sa.windows.element_size(), dtype)
    del sa, sb
    # The self-join through the two-operand launch: phase 2's interior job.
    stats, geom2, _ = band_setup(dtype)
    r0, k0 = 4096, geom2.W
    one = sweep_band_mxu_fused(stats, r0, k0, geom2, dtype)
    two = sweep_band_mxu_fused(stats, r0, k0, geom2, dtype, stats_c=stats)
    require(all(torch.equal(getattr(one, s).value, getattr(two, s).value)
                and torch.equal(getattr(one, s).index, getattr(two, s).index)
                for s in ("row", "col")), "K1 self-join: stats_c=stats differs from None")
    self_ms = time_ms(torch, lambda: sweep_band_mxu_fused(stats, r0, k0, geom2, dtype))
    say(f"18 K1 AB band {dtype}", shape=dict(S=S, W=W, m=m), jobs=list(jobs),
        max_abs_err=worst, tol=tol, k1_ab_ms=ms, **bound,
        k1_ab_share_of_bound=bound["bound_ms"] / ms,
        k1_ab_tflops=2.0 * S * W * m / ms / 1e9,
        self_join_bit_equal=True, self_join_ms_now=self_ms, self_join_ms_phase_2=self_join_ms)
    return {"k1_ab_ms": ms, "bound_ms": bound["bound_ms"]}


PLANTED_LEN = 4096


def planted_ab(seed: int, copies: int = 8, L: int = PLANTED_LEN):
    """A (2^19) and B (2^18) random walks; B carries ``copies`` copies of
    L-sample segments of A under 1e-3 noise, one in each 1/copies of B.
    Returns A, B and the (A start, B start) of each copy."""
    rng = np.random.default_rng(seed)
    A = np.cumsum(rng.standard_normal(1 << 19))
    B = np.cumsum(rng.standard_normal(1 << 18))
    part = B.shape[0] // copies
    src = rng.choice(A.shape[0] // L - 1, copies, replace=False) * L
    dst = np.arange(copies) * part + rng.integers(0, part - L, copies)
    for s, d in zip(src, dst):
        B[d : d + L] = A[s : s + L] - A[s] + B[d] + rng.standard_normal(L) * 1e-3
    return A, B, list(zip(src.tolist(), dst.tolist()))


def run_ab(torch, A, B, cfg):
    """One AB-join on the card: its four arrays, wall seconds, phase
    seconds, the card's clock and power, and the run's profile."""
    from mpx_torch.abjoin import compute_ab_join
    from mpx_torch.utils.profile import BenchmarkProfile

    prof = BenchmarkProfile()
    torch.cuda.synchronize()
    with CardSampler() as card:
        t0 = time.perf_counter()
        out = compute_ab_join(A, B, config=cfg, profile=prof)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = [o.cpu().numpy() for o in out]
    for (MP, MPI), X, Y in ((out[:2], A, B), (out[2:], B, A)):
        wq, wt = X.shape[0] - cfg.m + 1, Y.shape[0] - cfg.m + 1
        require(MP.shape == (wq,) and MPI.shape == (wq,), f"AB shapes {MP.shape}")
        require(np.isfinite(MP).all() and ((MPI >= -1) & (MPI < wt)).all(),
                "AB: non-finite distance or index out of range")
    phases = {k: v / 1e9 for k, v in prof.category_totals().items()}
    return out, wall, phases, card.summary, prof


def ab_jobs_of(cfg, wa: int, wb: int) -> int:
    from mpx_torch.abjoin import ab_jobs

    c = cfg.shrink_to(max(wa, wb))
    return len(ab_jobs(wa, wb, c.band, c.chunk)[0])


def rows_outside(w: int, seed: int, starts, L: int, m: int) -> np.ndarray:
    """Phase 19's 64 sampled windows: the first, the last and 62 drawn at
    random, none overlapping a planted copy (``starts``, L samples each).
    A copy's windows lie within float32's rounding of distance 0, where
    sqrt(2m(1 - P)) turns it into ~5e-3: they are held by their index."""
    rng = np.random.default_rng(seed)
    ok = np.ones(w, bool)
    for s in starts:
        ok[max(s - m + 1, 0) : s + L] = False
    pick = rng.choice(np.nonzero(ok[1:-1])[0] + 1, 62, replace=False)
    return np.sort(np.concatenate([[0, w - 1], pick]))


def check_ab(A, B, m, out, scans, tol, copies) -> dict:
    """Both directions on the sampled windows against the exact scans,
    and every planted copy found in both directions."""
    (rows_a, D_a), (rows_b, D_b) = scans
    err = {"a_to_b": check_rows(A, m, out[0], out[1], rows_a, tol, D=D_a),
           "b_to_a": check_rows(B, m, out[2], out[3], rows_b, tol, D=D_b)}
    for s, d in copies:
        for off in (256, 2048):
            require(out[1][s + off] == d + off and out[3][d + off] == s + off,
                    f"planted copy A[{s}] -> B[{d}] not found at offset {off}: "
                    f"{out[1][s + off]}, {out[3][d + off]}")
    return err


def phase_ab_e2e(torch) -> dict:
    """The AB-join end to end through ``auto`` (K1) in f32 and f64: A = 2^19,
    B = 2^18 with 8 planted copies of A's segments, m=256, band 4096, chunk
    32768: 128 x 8 = 1,024 K1 launches per dtype and no plain call; 64 A
    windows and 64 B windows against exact f64 scans of the other series;
    every copy found."""
    from mpx_torch import MatrixProfileConfig

    m = 256
    A, B, copies = planted_ab(SEED + 9)
    wa, wb = A.shape[0] - m + 1, B.shape[0] - m + 1
    L = PLANTED_LEN
    rows_a = rows_outside(wa, SEED + 9, [s for s, _ in copies], L, m)
    rows_b = rows_outside(wb, SEED + 10, [d for _, d in copies], L, m)
    scans = ((rows_a, row_scan64(A, m, rows_a, target=B)),
             (rows_b, row_scan64(B, m, rows_b, target=A)))
    out = {"scans": scans, "series": (A, B, copies)}
    for dt in ("float32", "float64"):
        cfg = MatrixProfileConfig(m=m, dtype=dt, band=4096, chunk=32768, device="cuda")
        jobs = ab_jobs_of(cfg, wa, wb)
        require(jobs == 1024, f"AB job grid: {jobs} jobs")
        reset_counts()
        res, wall, phases, card, _ = run_ab(torch, A, B, cfg)
        launches = require_only(counts(), "k1", f"AB auto {dt}", jobs)
        err = check_ab(A, B, m, res, scans, DIST_TOL[dt], copies)
        sweep = next(v for k, v in phases.items() if k.startswith("2. Compute"))
        say(f"19 AB-join {dt} auto (K1)", na=A.shape[0], nb=B.shape[0], m=m, band=4096,
            chunk=32768, jobs=jobs, k1_launches=launches, plain_calls=0, wall_s=wall,
            pairs_per_s=wa * wb / wall, phases_s=phases,
            split_s={"statistics": phases.get("1. Pre-Computation", 0.0), "sweep": sweep,
                     "sweep_ms_per_job": sweep / jobs * 1e3},
            card=card, max_err_vs_exact_64_windows=err, copies_found=len(copies),
            tol=DIST_TOL[dt])
        out[dt] = {"launches": launches, "profile": res, "wall_s": wall}
    return out


def phase_ab_hybrid(torch, p19: dict):
    """The AB-join in f64 through ``kernel='hybrid'`` on phase 19's series:
    1,024 K1 f32 launches (pass A), each side within 1e-8 of the exact
    scans and within 1e-10 of phase 19's f64 profiles (indices only between
    equidistant neighbors; in the planted copies, equal indices and
    correlations within 1e-13); its phase split, flags, captures and peak
    memory."""
    from mpx_torch import MatrixProfileConfig

    m = 256
    A, B, copies = p19["series"]
    wa, wb = A.shape[0] - m + 1, B.shape[0] - m + 1
    cfg = MatrixProfileConfig(m=m, dtype="float64", kernel="hybrid", band=4096, chunk=32768,
                              device="cuda")
    jobs = ab_jobs_of(cfg, wa, wb)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res, wall, phases, card, prof = run_ab(torch, A, B, cfg)
    peak = torch.cuda.max_memory_allocated() - base
    launches = require_only(counts(), "k1", "AB hybrid (pass A)", jobs)
    err = check_ab(A, B, m, res, p19["scans"], DIST_TOL["float64"], copies)
    ref = p19["float64"]["profile"]
    vs_k1 = {}
    for name, (X, Y, starts, MP, MPI, MP2, MPI2) in (
            ("a_to_b", (A, B, [s for s, _ in copies], res[0], res[1], ref[0], ref[1])),
            ("b_to_a", (B, A, [d for _, d in copies], res[2], res[3], ref[2], ref[3]))):
        # A planted copy's windows lie near distance 0, where sqrt(2m(1 - P))
        # turns the two tiers' float64 roundings of P (~1e-15) into ~3e-10:
        # there the indices must be equal and the correlations within 1e-13.
        near = np.zeros(MP.shape[0], bool)
        for s in starts:
            near[max(s - m + 1, 0) : s + PLANTED_LEN] = True
        require(bool((MPI[near] == MPI2[near]).all()), f"AB hybrid {name}: copy indices")
        dP = np.abs(MP[near] ** 2 - MP2[near] ** 2) / (2 * m)
        require(float(dP.max()) <= 1e-13, f"AB hybrid {name}: copy correlations {dP.max()}")
        vs_k1[name] = {"max_err_outside_copies": check_profiles_agree(
            X, m, MP, MPI, np.where(near, MP, MP2), np.where(near, MPI, MPI2), 1e-10, Y),
            "max_corr_err_in_copies": float(dP.max())}
    split = hybrid_split(phases, sides=("a", "b"))
    say("20 AB-join f64 hybrid", na=A.shape[0], nb=B.shape[0], m=m, band=4096, chunk=32768,
        jobs=jobs, k1_launches=launches, plain_calls=0, wall_s=wall,
        pairs_per_s=wa * wb / wall, split_s=split,
        pass_b_sparse_ms_per_job=split["pass_b_sparse"] / jobs * 1e3,
        counts=dict(prof.counts), peak_device_bytes=peak, card=card, phases_s=phases,
        max_err_vs_exact_64_windows=err, max_err_vs_phase_19_f64=vs_k1,
        index_differs_vs_phase_19={"a": int((res[1] != ref[1]).sum()),
                                   "b": int((res[3] != ref[3]).sum())},
        phase_19_f64_wall_s=p19["float64"]["wall_s"], tol=DIST_TOL["float64"])


def check_topk_rows(D, I, rows, Dx, k: int, tol: float) -> float:
    """Each sampled row's k-list against the exact scan ``Dx`` of that row:
    the k distances within tol of the k smallest, and each index at its
    listed distance (so the index set is exact up to equidistant ties)."""
    worst = 0.0
    for j, r in enumerate(rows):
        best = np.sort(Dx[j])[:k]
        live = np.isfinite(best)
        require((np.isfinite(D[r]) == live).all() and (I[r][~live] == -1).all(),
                f"row {r}: missing neighbors differ")
        err = float(np.abs(D[r][live] - best[live]).max(initial=0.0))
        worst = max(worst, err)
        require(err <= tol, f"row {r}: top-{k} {D[r]} vs exact {best}")
        at = Dx[j][I[r][live]]
        require(bool((np.abs(at - best[live]) <= tol).all()),
                f"row {r}: indices {I[r]} at {at}, exact {best}")
    return worst


def phase_topk(torch, n: int = 1 << 19):
    """Top-k on the card: the suite row's shape (m=256, k=4, f64 strict,
    band 4096, chunk 32768) cut from n=2^20 to 2^19, as torch ops (no K1,
    no plain sweep), 32 sampled rows against an exact f64 scan; then
    ``compute_topk_ab`` in f32 on phase 3's series split in two halves."""
    from mpx_torch import MatrixProfileConfig, make_job_grid
    from mpx_torch.topk import compute_topk_ab, compute_topk_profile

    m, k = 256, 4
    T = random_walk(n, SEED + 11)
    w = n - m + 1
    cfg = MatrixProfileConfig(m=m, dtype="float64", band=4096, chunk=32768, device="cuda")
    reset_counts()
    torch.cuda.synchronize()
    with CardSampler() as card:
        t0 = time.perf_counter()
        D, I = compute_topk_profile(T, k=k, config=cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    require(not any(counts().values()), f"top-k launched a band sweep: {counts()}")
    D, I = D.cpu().numpy(), I.cpu().numpy()
    require(D.shape == (w, k) and I.dtype == np.int32, f"top-k shapes {D.shape}")
    rows = sample_rows(w, SEED + 11)[::2]
    err = check_topk_rows(D, I, rows, row_scan64(T, m, rows), k, DIST_TOL["float64"])
    T3, m3 = parity_series()
    A, B = T3[: T3.shape[0] // 2], T3[T3.shape[0] // 2 :]
    cfg3 = MatrixProfileConfig(m=m3, dtype="float32", device="cuda")
    t0 = time.perf_counter()
    Dab, Iab = (x.cpu().numpy() for x in compute_topk_ab(A, B, k=k, config=cfg3))
    wall_ab = time.perf_counter() - t0
    rows_ab = sample_rows(A.shape[0] - m3 + 1, SEED + 12)[::2]
    err_ab = check_topk_rows(Dab, Iab, rows_ab, row_scan64(A, m3, rows_ab, target=B), k,
                             DIST_TOL["float32"])
    say("21 top-k", n=n, m=m, k=k, dtype="float64", band=4096, chunk=32768,
        jobs=len(make_job_grid(w, 4096, 32768).r0), wall_s=wall,
        pairs_per_s=w * (w - 1) / 2 / wall, card=card.summary,
        max_err_vs_exact_32_rows=err, tol=DIST_TOL["float64"],
        ab_f32={"na": A.shape[0], "nb": B.shape[0], "m": m3, "wall_s": wall_ab,
                "max_err_vs_exact_32_rows": err_ab, "tol": DIST_TOL["float32"]})
    return {"T": T}


def phase_thresh(torch):
    """Sum-threshold on the card at ``thresh-f32-1048576``'s shape cut to
    n=2^19 (m=256, threshold 0.7, f32, band 4096, chunk 16384) as torch ops; 32
    sampled rows against exact f64 sums and counts: a count may differ only
    by pairs whose exact correlation is within 1e-5 of the threshold, a sum
    by 1e-4 of itself plus those pairs."""
    from mpx_torch import MatrixProfileConfig, compute_sum_thresh, make_job_grid

    n, m, thr, near_tol = 1 << 19, 256, 0.7, 1e-5
    T = random_walk(n, SEED + 13)
    w = n - m + 1
    cfg = MatrixProfileConfig(m=m, dtype="float32", band=4096, chunk=16384, device="cuda")
    reset_counts()
    torch.cuda.synchronize()
    with CardSampler() as card:
        t0 = time.perf_counter()
        sums, cnts = compute_sum_thresh(T, config=cfg, threshold=thr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    require(not any(counts().values()), f"thresh launched a band sweep: {counts()}")
    sums, cnts = sums.cpu().numpy().astype(np.float64), cnts.cpu().numpy()
    require(sums.shape == cnts.shape == (w,) and np.isfinite(sums).all(), "thresh outputs")
    rows = sample_rows(w, SEED + 13)[::2]
    P = np.nan_to_num(row_corr64(T, m, rows), nan=-2.0)
    hit = P > thr
    exact_s, exact_c = np.where(hit, P, 0.0).sum(1), hit.sum(1)
    near = (np.abs(P - thr) <= near_tol).sum(1)
    dc = np.abs(cnts[rows].astype(np.int64) - exact_c)
    ds = np.abs(sums[rows] - exact_s)
    require(bool((dc <= near).all()), f"thresh counts off by {dc} (near pairs {near})")
    require(bool((ds <= 1e-4 * np.abs(exact_s) + near).all()), f"thresh sums off by {ds}")
    say("22 sum-threshold", n=n, m=m, threshold=thr, dtype="float32", band=4096,
        chunk=16384, jobs=len(make_job_grid(w, 4096, 16384).r0), wall_s=wall,
        pairs_per_s=w * (w - 1) / 2 / wall, card=card.summary, max_count_diff=int(dc.max()),
        near_pairs_max=int(near.max()),
        max_sum_rel_err=float((ds / np.maximum(np.abs(exact_s), 1.0)).max()),
        counts_of_8_rows=exact_c.tolist()[:8])


def phase_epilogue_cli(torch):
    """``abjoin`` (A and B the halves of data/binary/16384.tsb), ``topk``
    and ``thresh`` (threshold 0.2: the series' windows rarely correlate
    more) on the card through the command line: each file equal to the
    API's result on the card."""
    from mpx_torch import MatrixProfileConfig, compute_ab_join, compute_sum_thresh
    from mpx_torch.io.tsb import read_binary, read_series, write_binary
    from mpx_torch.topk import compute_topk_profile

    src = os.path.join(REPO, "data", "binary", "16384.tsb")
    T, m = read_series(src), 256
    A, B = T[: T.shape[0] // 2], T[T.shape[0] // 2 :]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        a, b, base = (os.path.join(tmp, x) for x in ("a.tsb", "b.tsb", "out"))
        write_binary(a, A)
        write_binary(b, B)
        t0 = time.perf_counter()
        run_cli("abjoin", "-a", a, "-b", b, "-m", str(m), "-o", base)
        files = [read_binary(base + s + e, k) for s in (".a", ".b")
                 for e, k in ((".mpb", "double"), (".mpib", "int"))]
        api = compute_ab_join(A, B, config=MatrixProfileConfig(m=m, band=4096, chunk=4096,
                                                               device="cuda"))
        require(all(np.array_equal(f, x.cpu().numpy()) for f, x in zip(files, api)),
                "abjoin's files differ from compute_ab_join on the card")
        out["abjoin"] = {"seconds": time.perf_counter() - t0, "wa": int(files[0].shape[0])}
        t0 = time.perf_counter()
        run_cli("topk", "-i", src, "-m", str(m), "-k", "4", "-o", base)
        got = np.load(base + ".topk.npz")
        D, I = compute_topk_profile(T, k=4, config=MatrixProfileConfig(
            m=m, band=4096, chunk=4096, device="cuda"))
        require(np.array_equal(got["distances"], D.cpu().numpy())
                and np.array_equal(got["indices"], I.cpu().numpy()),
                "topk's file differs from compute_topk_profile on the card")
        out["topk"] = {"seconds": time.perf_counter() - t0, "shape": list(D.shape)}
        t0 = time.perf_counter()
        run_cli("thresh", "-i", src, "-m", str(m), "--threshold", "0.2", "-o", base)
        got = np.load(base + ".thresh.npz")
        sums, cnts = compute_sum_thresh(T, config=MatrixProfileConfig(m=m, device="cuda"),
                                        threshold=0.2)
        require(np.array_equal(got["sums"], sums.cpu().numpy())
                and np.array_equal(got["counts"], cnts.cpu().numpy()),
                "thresh's file differs from compute_sum_thresh on the card")
        out["thresh"] = {"seconds": time.perf_counter() - t0, "count_max": int(cnts.max())}
    say("23 epilogue commands", input="data/binary/16384.tsb", m=m, **out)


def topk_split(phases: dict) -> dict:
    """The top-k hybrid's phase seconds, grouped: pass B per round, the
    pass-C scans and the exact stages per path."""
    def total(*prefixes):
        return sum(v for k, v in phases.items() if k.startswith(prefixes))
    rounds = {k.split("round ")[1].rstrip("]"): v for k, v in phases.items()
              if k.startswith("2. Compute [topk pass B, round")}
    return {"statistics": total("1. "), "pass_a": total("2. Compute [pass A]"),
            "thr_estimate": total("2. Compute [topk thr estimate]"),
            "pass_b": sum(rounds.values()), "pass_b_per_round": rounds,
            "pass_c": total("2. Compute [topk pass C]"),
            "pass_c_wide": total("2. Compute [topk pass C wide]"),
            "rescore_slots": total("3. Rescore [f64 topk slots]"),
            "rescore_plateau_runs": total("3. Rescore [f64 topk plateau runs]"),
            "rescore_pass_c": total("3. Rescore [f64 topk pass C"),
            "row_scan": total("3. Rescore [f64 topk row scan]"), "post": total("4. ")}


def run_topk(torch, T, m: int, k: int, **cfg_kwargs):
    """One top-k run through ``compute_topk_profile`` on the card, timed,
    with its profile, the card's clock and power and its peak device
    memory.  Returns (D, I, wall, phases, counts, card, peak, launches)."""
    from mpx_torch import MatrixProfileConfig
    from mpx_torch.topk import compute_topk_profile
    from mpx_torch.utils.profile import BenchmarkProfile

    cfg = MatrixProfileConfig(m=m, dtype="float64", device="cuda", **cfg_kwargs)
    prof = BenchmarkProfile()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with CardSampler() as card:
        t0 = time.perf_counter()
        D, I = compute_topk_profile(T, k=k, config=cfg, profile=prof)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    launches = counts()
    D, I = D.cpu().numpy(), I.cpu().numpy()
    w = T.shape[0] - m + 1
    require(D.shape == I.shape == (w, k) and I.dtype == np.int32, f"top-k shapes {D.shape}")
    require(bool((np.isfinite(D) == (I >= 0)).all()), "top-k: inf distances and -1 apart")
    phases = {k_: v / 1e9 for k_, v in prof.category_totals().items()}
    return D, I, wall, phases, dict(prof.counts), card.summary, peak, launches


def check_topk_agree(T, m, D, I, D2, I2, tol: float, tie_tol: float) -> float:
    """Two top-k lists of one series: distances within tol, and where an
    index differs both neighbors lie at distances within tie_tol."""
    fin = np.isfinite(D2)
    require(bool((np.isfinite(D) == fin).all()), "top-k: missing neighbors differ")
    err = float(np.abs(D[fin] - D2[fin]).max(initial=0.0))
    require(err <= tol, f"top-k lists differ by {err} (tol {tol})")
    r, j = np.nonzero(I != I2)
    gap = np.abs(pair_distances64(T, m, r, I[r, j]) - pair_distances64(T, m, r, I2[r, j]))
    require(bool((gap <= tie_tol).all()),
            f"{int((gap > tie_tol).sum())} top-k indices differ and are not equidistant")
    return err


def phase_topk_hybrid(torch, p21: dict) -> int:
    """The float64 top-k hybrid (m=256, k=4, band 4096, chunk 32768) on the
    first n=2^18 samples of phase 21's series (``topk-f64-1048576-k4`` cut
    from n=2^20 to 2^19 in PR 9 and to 2^18 to keep the script under 570 s
    once phases 48-50 came; ``bench --suite`` measures the full shape): one
    K1 float32 launch per job (pass A) and no plain sweep, 32 sampled rows
    against the exact scan, and the profile held to the strict tile of the
    same series within 1e-10, the strict tile's time beside.  Returns the
    K1 launches."""
    from mpx_torch import MatrixProfileConfig
    from mpx_torch.config import make_job_grid
    from mpx_torch.topk import compute_topk_profile

    m, k, tol, n = 256, 4, DIST_TOL["float64"], 1 << 18
    shape = dict(band=4096, chunk=32768)
    T, w = p21["T"][:n], n - m + 1
    jobs = len(make_job_grid(w, 4096, 32768).r0)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Ds, Is = compute_topk_profile(T, k=k, config=MatrixProfileConfig(
        m=m, dtype="float64", device="cuda", **shape))
    torch.cuda.synchronize()
    strict_wall = time.perf_counter() - t0
    require(not any(counts().values()), f"the strict top-k launched a band sweep: {counts()}")
    Ds, Is = Ds.cpu().numpy(), Is.cpu().numpy()
    D, I, wall, phases, cnt, card, peak, launched = run_topk(torch, T, m, k, kernel="hybrid",
                                                             **shape)
    launches = require_only(launched, "k1", "top-k hybrid n=2^18 (pass A)", jobs)
    rows = sample_rows(w, SEED + 15)[::2]
    err = check_topk_rows(D, I, rows, row_scan64(T, m, rows), k, tol)
    vs_strict = check_topk_agree(T, m, D, I, Ds, Is, 1e-10, tol)
    say("24 top-k f64 hybrid vs strict", n=n, m=m, k=k, band=4096, chunk=32768,
        jobs=jobs, k1_launches=launches, plain_calls=0, wall_s=wall,
        pairs_per_s=w * (w - 1) / 2 / wall, strict_wall_s=strict_wall,
        split_s=topk_split(phases), counts=cnt, peak_device_bytes=peak, card=card,
        max_err_vs_exact_32_rows=err, max_err_vs_strict=vs_strict,
        index_differs_vs_strict=int((I != Is).sum()), tol=1e-10)
    return launches


def phase_topk_ties(torch):
    """Phase 13's tie-heavy series (80 repeats of a motif, n=65520, m=64)
    through the top-k hybrid at k=4 and k=8, against the strict float64
    tile on the card.  Every window has 78 or 79 near-equal neighbors: with
    the defaults pass C (64 slots) certifies none and the wide pass C (512)
    all, so the runs set a knob between the two counts: k=4 with TOPK_K1 =
    79 (pass C settles the 78-neighbor rows, the wide pass the rest), k=8
    with TOPK_K2 = 79 (the wide pass settles the 78-neighbor rows, the exact
    row scan the rest)."""
    from mpx_torch import hybrid

    repeats, L, m = 80, 819, 64
    rng = np.random.default_rng(SEED + 6)
    motif = np.cumsum(rng.standard_normal(L))
    T = np.tile(motif, repeats) + rng.standard_normal(L * repeats) * 1e-3
    out, stages = {}, set()
    for k, knob in ((4, "TOPK_K1"), (8, "TOPK_K2")):
        default = getattr(hybrid, knob)
        setattr(hybrid, knob, 79)
        try:
            D, I, wall, phases, cnt, _, peak, launched = run_topk(torch, T, m, k,
                                                                  kernel="hybrid")
        finally:
            setattr(hybrid, knob, default)
        require_only(launched, "k1", f"top-k hybrid ties k={k} (pass A)")
        Ds, Is, wall_s, _, _, _, _, _ = run_topk(torch, T, m, k)
        err = check_topk_agree(T, m, D, I, Ds, Is, 1e-10, DIST_TOL["float64"])
        resolved = {key[9:]: v for key, v in cnt.items() if key.startswith("resolved_")}
        stages |= {name for name, v in resolved.items() if sum(v)}
        out[f"k={k}"] = {"knob": f"{knob} {default} -> 79", "wall_s": wall,
                         "strict_wall_s": wall_s, "rounds": cnt["rounds"],
                         "resolved": resolved, "split_s": topk_split(phases),
                         "peak_device_bytes": peak, "max_err_vs_strict": err,
                         "index_differs_vs_strict": int((I != Is).sum())}
    require({"pass_c", "pass_c_wide", "row_scan"} <= stages,
            f"tie-heavy top-k: stages reached {sorted(stages)}")
    say("25 top-k hybrid ties", n=T.shape[0], m=m, repeats=repeats, tol=1e-10, **out)


def raw_row_scan64(T, m: int, rows, target=None) -> np.ndarray:
    """Exact float64 raw Euclidean distances (len(rows), wt) of the sampled
    windows of ``T`` to every window of ``target`` (default ``T``: the
    self-join, +inf inside the exclusion zone), each window centered on its
    own two-pass mean: D^2 = |a - mu_a|^2 + |b - mu_b|^2 - 2 (a - mu_a).(b -
    mu_b) + m (mu_a - mu_b)^2; blockwise."""
    Tt = T if target is None else target
    wq = np.lib.stride_tricks.sliding_window_view(T, m)[rows]
    mq = wq.mean(axis=1)
    cq = wq - mq[:, None]
    sq = np.einsum("ij,ij->i", cq, cq)
    wt = np.lib.stride_tricks.sliding_window_view(Tt, m)
    D2 = np.empty((len(rows), wt.shape[0]))
    blk = max(1, (128 << 20) // (8 * m))
    for o in range(0, wt.shape[0], blk):
        v = wt[o : o + blk]
        mt = v.mean(axis=1)
        ct = v - mt[:, None]
        D2[:, o : o + v.shape[0]] = (sq[:, None] + np.einsum("ij,ij->i", ct, ct)[None, :]
                                     - 2.0 * cq @ ct.T + m * (mq[:, None] - mt[None, :]) ** 2)
    D = np.sqrt(np.maximum(D2, 0.0))
    if target is None:
        cols = np.arange(D.shape[1])
        D[np.abs(cols[None, :] - np.asarray(rows)[:, None]) < m // 4] = np.inf
    return D


def check_raw_rows(D, I, rows, Dx, rel: float) -> tuple:
    """A raw profile on the sampled rows against the exact scan ``Dx``:
    distances within rel x the largest exact distance of these rows, and
    each index at its row's exact distance within the same.  Returns (worst
    error, the tolerance)."""
    best = Dx.min(axis=1)
    tol = rel * float(best.max())
    err = np.abs(D[rows] - best)
    require(bool((err <= tol).all()), f"raw profile off by {err.max()} (tol {tol})")
    at = Dx[np.arange(len(rows)), I[rows]]
    require(bool((I[rows] >= 0).all() and (np.abs(at - best) <= tol).all()),
            "raw profile: an index is not at its row's nearest distance")
    return float(err.max()), tol


def global_centered_f32_errors(torch, T, m: int, rows, Dx) -> float:
    """mpx's float32 form on the card for the sampled rows: the series
    centered once, raw windows and squared norms cast to float32, score 2
    dot - ssq_c, D^2 = ssq_r - score; the worst distance error against the
    exact scan (what the port's per-window centering avoids)."""
    from mpx_torch.dtypes import full_precision_matmul

    T0 = T - T.mean()
    wins = np.lib.stride_tricks.sliding_window_view(T0, m)
    ssq = torch.tensor(np.einsum("ij,ij->i", wins, wins), device="cuda").float()
    U = torch.tensor(T0, device="cuda").unfold(0, m, 1).float()
    with full_precision_matmul():
        score = 2.0 * (U[torch.as_tensor(rows, device="cuda")] @ U.T) - ssq[None, :]
    cols = torch.arange(U.shape[0], device="cuda")
    r = torch.as_tensor(rows, device="cuda")
    score.masked_fill_((cols[None, :] - r[:, None]).abs() < m // 4, -torch.inf)
    D = torch.sqrt(torch.clamp(ssq[r] - score.max(dim=1).values, min=0.0)).double()
    return float(np.abs(D.cpu().numpy() - Dx.min(axis=1)).max())


def phase_aamp(torch):
    """The raw-Euclidean profiles on the card: the self-join in float32 at
    n=2^19 (m=256, band 4096, chunk 32768; cut from n=2^20) and in float64 at n=2^18, the
    AB-join in float32 (A = 2^19, B = 2^18), and a large-amplitude series
    (a walk x 1e6 + 1e7, float64, n=2^16); 64 sampled rows of each against
    an exact float64 raw scan, within mpx's tolerances (2e-4 float32, 1e-10
    float64) of the largest exact distance of those rows.  Beside the
    float32 self-join, mpx's globally centered float32 form on the same
    rows."""
    from mpx_torch import MatrixProfileConfig, compute_aamp_ab_join, compute_aamp_profile
    from mpx_torch.abjoin import ab_jobs
    from mpx_torch.config import make_job_grid

    m, S, W = 256, 4096, 32768
    rel = {"float32": 2e-4, "float64": 1e-10}
    out = {}

    def timed(fn):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = [x.cpu().numpy() for x in fn()]
        wall = time.perf_counter() - t0
        require(not any(counts().values()), f"AAMP launched a band sweep: {counts()}")
        return res, wall

    for name, n, dtype, scale, seed in (("self f32", 1 << 19, "float32", None, 16),
                                         ("self f64", 1 << 18, "float64", None, 17),
                                         ("large amplitude f64", 1 << 16, "float64", 1e6, 18)):
        T = random_walk(n, SEED + seed)
        if scale:
            T = T * scale + 1e7
        w = n - m + 1
        cfg = MatrixProfileConfig(m=m, dtype=dtype, band=S, chunk=W, device="cuda")
        (D, I), wall = timed(lambda: compute_aamp_profile(T, config=cfg))
        require(D.shape == I.shape == (w,) and np.isfinite(D).all(), f"AAMP {name} outputs")
        rows = sample_rows(w, SEED + seed)
        Dx = raw_row_scan64(T, m, rows)
        err, tol = check_raw_rows(D, I, rows, Dx, rel[dtype])
        out[name] = {"n": n, "dtype": dtype, "jobs": len(make_job_grid(w, S, W).r0),
                     "wall_s": wall, "pairs_per_s": w * (w - 1) / 2 / wall,
                     "max_err_64_rows": err, "tol": tol}
        if name == "self f32":
            out[name]["mpx_form_max_err_64_rows"] = global_centered_f32_errors(
                torch, T, m, rows, Dx)
        del D, I, Dx
    A, B = random_walk(1 << 19, SEED + 19), random_walk(1 << 18, SEED + 20)
    wa, wb = A.shape[0] - m + 1, B.shape[0] - m + 1
    cfg = MatrixProfileConfig(m=m, dtype="float32", band=S, chunk=W, device="cuda")
    (Da, Ia, Db, Ib), wall = timed(lambda: compute_aamp_ab_join(A, B, config=cfg))
    ab = {"na": A.shape[0], "nb": B.shape[0], "dtype": "float32",
          "jobs": len(ab_jobs(wa, wb, S, W)[0]), "wall_s": wall, "pairs_per_s": wa * wb / wall}
    for side, X, Y, D, I, seed in (("a", A, B, Da, Ia, 21), ("b", B, A, Db, Ib, 22)):
        rows = sample_rows(X.shape[0] - m + 1, SEED + seed)
        ab[f"max_err_64_rows_{side}"], ab[f"tol_{side}"] = check_raw_rows(
            D, I, rows, raw_row_scan64(X, m, rows, target=Y), rel["float32"])
    out["ab f32"] = ab
    say("26 aamp", m=m, band=S, chunk=W, **out)


def exact_cell(torch, T, m: int, i: int, j: int, ph: int, pw: int) -> float:
    """The exact float64 largest correlation of pooled cell (i, j) of the
    self-join (|c - r| >= m // 4, zero-variance windows excluded), on the
    card from the exact unit windows; -1 when the cell has no valid pair."""
    w = T.shape[0] - m + 1
    r0, r1, c0, c1 = i * ph, min((i + 1) * ph, w), j * pw, min((j + 1) * pw, w)
    Zr, dr = unit_windows64(T, m, r0, r1)
    Zr = torch.tensor(Zr, device="cuda")
    best = -2.0
    for o in range(c0, c1, 4096):
        Zc, dc = unit_windows64(T, m, o, min(o + 4096, c1))
        P = Zr @ torch.tensor(Zc, device="cuda").T
        rr = torch.arange(r0, r1, device="cuda")[:, None]
        cc = torch.arange(o, o + Zc.shape[0], device="cuda")[None, :]
        bad = ((cc - rr).abs() < m // 4) | torch.tensor(dr, device="cuda")[:, None] \
            | torch.tensor(dc, device="cuda")[None, :]
        best = max(best, float(P.masked_fill_(bad, -2.0).max()))
    return max(best, -1.0)


def phase_pooled_matrix(torch):
    """The pooled summary at ``matrix-f32-1048576``'s shape (n=2^20, m=256,
    64 x 64, band = chunk = 4096) on the card: 8 cells (two on the
    diagonal, the ragged last row and column) recomputed exactly in float64
    within mpx's 2e-3, and the summary symmetric within 2e-3; an AB summary
    (n_a = n_b = 8192, m=64) against ``brute_force_pooled_matrix``."""
    from mpx_torch import MatrixProfileConfig, make_job_grid, pooled_matrix
    from mpx_torch.distmatrix import brute_force_pooled_matrix

    n, m, cells, S, tol = 1 << 20, 256, 64, 4096, 2e-3
    T = random_walk(n, SEED + 23)
    w = n - m + 1
    cfg = MatrixProfileConfig(m=m, band=S, chunk=S, device="cuda")
    reset_counts()
    torch.cuda.synchronize()
    with CardSampler() as card:
        t0 = time.perf_counter()
        M = pooled_matrix(T, m, mwidth=cells, mheight=cells, config=cfg)
        wall = time.perf_counter() - t0
    require(not any(counts().values()), f"pooled matrix launched a band sweep: {counts()}")
    require(M.shape == (cells, cells) and np.isfinite(M).all(), f"pooled matrix {M.shape}")
    ph = -(-w // cells)
    picks = [(0, 0), (31, 31), (0, 63), (63, 0), (63, 63), (63, 17), (40, 63), (12, 50)]
    worst = 0.0
    for i, j in picks:
        exact = np.sqrt(max(2.0 * m * (1.0 - exact_cell(torch, T, m, i, j, ph, ph)), 0.0))
        worst = max(worst, abs(M[i, j] - exact))
        require(abs(M[i, j] - exact) <= tol, f"cell ({i}, {j}): {M[i, j]} vs exact {exact}")
    asym = float(np.abs(M - M.T).max())
    require(asym <= tol, f"pooled self-join matrix not symmetric: {asym}")
    A, B = random_walk(8192, SEED + 24), random_walk(8192, SEED + 25)
    t0 = time.perf_counter()
    Mab = pooled_matrix(A, 64, B=B, config=MatrixProfileConfig(m=64, device="cuda"))
    wall_ab = time.perf_counter() - t0
    ab_err = float(np.abs(Mab - brute_force_pooled_matrix(A, 64, B=B)).max())
    require(ab_err <= tol, f"AB pooled matrix vs brute force: {ab_err}")
    say("27 pooled matrix", n=n, m=m, cells=[cells, cells], band=S, chunk=S,
        jobs=len(make_job_grid(w, S, S).r0), wall_s=wall, pairs_per_s=w * (w - 1) / 2 / wall,
        card=card.summary, exact_cells=picks, max_err_exact_cells=worst,
        max_asymmetry=asym, tol=tol,
        ab={"na": 8192, "nb": 8192, "m": 64, "wall_s": wall_ab, "max_err_vs_brute": ab_err})


def phase_new_cli(torch):
    """``compute --raw``, ``matrix`` (the self-join, and with ``-b`` the
    AB-join of the halves) and ``topk --dtype float64`` on
    data/binary/16384.tsb (m=256) on the card: each file equal to the API's
    result on the card."""
    from mpx_torch import MatrixProfileConfig, compute_aamp_profile, pooled_matrix
    from mpx_torch.io.tsb import read_binary, read_series, write_binary
    from mpx_torch.topk import compute_topk_profile

    src = os.path.join(REPO, "data", "binary", "16384.tsb")
    T, m = read_series(src), 256
    A, B = T[: T.shape[0] // 2], T[T.shape[0] // 2 :]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        a, b, base = (os.path.join(tmp, x) for x in ("a.tsb", "b.tsb", "out"))
        write_binary(a, A)
        write_binary(b, B)
        t0 = time.perf_counter()
        run_cli("compute", "-i", src, "-m", str(m), "--raw", "-o", base)
        D, I = (read_binary(base + e, k) for e, k in ((".mpb", "double"), (".mpib", "int")))
        api = compute_aamp_profile(T, config=MatrixProfileConfig(m=m, device="cuda"))
        require(np.array_equal(D, api[0].cpu().numpy()) and np.array_equal(I, api[1].cpu().numpy()),
                "compute --raw's files differ from compute_aamp_profile on the card")
        out["compute_raw"] = {"seconds": time.perf_counter() - t0, "w": int(D.shape[0])}
        for name, args, X, kw in (("matrix", ["-i", src], T, {}),
                                  ("matrix_b", ["-i", a, "-b", b], A, {"B": B})):
            t0 = time.perf_counter()
            run_cli("matrix", *args, "-m", str(m), "-o", base)
            got = np.load(base + ".dm.npy")
            want = pooled_matrix(X, m, config=MatrixProfileConfig(m=m, band=4096, chunk=4096,
                                                                  device="cuda"), **kw)
            require(np.array_equal(got, want), f"{name}'s file differs from pooled_matrix")
            out[name] = {"seconds": time.perf_counter() - t0, "shape": list(got.shape)}
        t0 = time.perf_counter()
        run_cli("topk", "-i", src, "-m", str(m), "-k", "4", "--dtype", "float64", "-o", base)
        got = np.load(base + ".topk.npz")
        D, I = compute_topk_profile(T, k=4, config=MatrixProfileConfig(
            m=m, dtype="float64", band=4096, chunk=4096, device="cuda"))
        require(np.array_equal(got["distances"], D.cpu().numpy())
                and np.array_equal(got["indices"], I.cpu().numpy()),
                "topk --dtype float64's file differs from compute_topk_profile")
        out["topk_f64"] = {"seconds": time.perf_counter() - t0, "shape": list(D.shape)}
    say("28 new commands", input="data/binary/16384.tsb", m=m, **out)


# ---------------------------------------------------------------- slice 9


def row_scan64_card(torch, T, m: int, rows) -> np.ndarray:
    """:func:`row_scan64` computed in float64 on the card (the same
    two-pass windows, zero-variance rule and exclusion zone), for long
    windows where the host scan would take minutes."""
    Tt = torch.tensor(T, dtype=torch.float64, device="cuda")
    wins = Tt.unfold(0, m, 1)
    w = wins.shape[0]

    def unit(v):
        c = v - v.mean(dim=1, keepdim=True)
        ssq = (c * c).sum(dim=1)
        deg = ssq <= ZERO_VARIANCE_REL * (v * v).sum(dim=1)
        return (c / ssq.sqrt()[:, None]).masked_fill_(deg[:, None], 0.0), deg

    r = torch.as_tensor(np.asarray(rows), device="cuda")
    Zq, deg_q = unit(wins[r])
    D = torch.empty((len(rows), w), dtype=torch.float64, device="cuda")
    blk = max(1, (256 << 20) // (8 * m))
    for o in range(0, w, blk):
        Z, deg = unit(wins[o : o + blk])
        P = Zq @ Z.T
        D[:, o : o + Z.shape[0]] = torch.sqrt(torch.clamp(2.0 * m * (1.0 - P), min=0.0)) \
            .masked_fill_(deg[None, :], torch.inf)
    cols = torch.arange(w, device="cuda")
    D.masked_fill_((cols[None, :] - r[:, None]).abs() < m // 4, torch.inf)
    D.masked_fill_(deg_q[:, None], torch.inf)
    return D.cpu().numpy()


def mstamp_rows64(T: np.ndarray, m: int, rows, include=(), discords: bool = False):
    """The exact float64 k-dimensional distances (len(rows), d, w) of the
    sampled rows to every window (``run_mstamp_benchmark``'s oracle:
    per-dimension distances, +inf where either window is flat in that
    dimension, ordered across dimensions with ``include`` first, prefix
    means; +inf inside the exclusion zone)."""
    d, n = T.shape
    w = n - m + 1
    dims = [unit_windows64(T[t], m, 0, w) for t in range(d)]
    inc = list(include)
    rest = [t for t in range(d) if t not in inc]
    out = np.empty((len(rows), d, w))
    cols = np.arange(w)
    for k, i in enumerate(rows):
        dist = np.empty((d, w))
        for t, (Z, deg) in enumerate(dims):
            dist[t] = np.sqrt(np.maximum(2.0 * m * (1.0 - Z @ Z[i]), 0.0))
            dist[t][deg] = np.inf
            if deg[i]:
                dist[t] = np.inf
        dist[:, np.abs(cols - i) < m // 4] = np.inf

        def srt(x):
            x = np.sort(x, axis=0)
            return x[::-1] if discords else x

        dist = np.concatenate([srt(dist[inc]), srt(dist[rest])] if inc and rest
                              else [srt(dist)])
        out[k] = np.cumsum(dist, axis=0) / np.arange(1, d + 1)[:, None]
    return out


def check_mstamp_rows(prof, Dk, rows, tol) -> float:
    """An mSTAMP profile's sampled rows against the exact ``Dk``: every
    k-profile within tol, +inf and -1 where no pair is finite, each index
    at its row's exact k-dim minimum within tol."""
    worst = 0.0
    for k, i in enumerate(rows):
        exp = Dk[k].min(axis=1)
        got, idx = prof.PMP[:, i].astype(np.float64), prof.PMPI[:, i]
        fin = np.isfinite(exp)
        require(bool((np.isinf(got[~fin]).all() and (idx[~fin] == -1).all())),
                f"row {i}: a k-profile without a finite pair is {got[~fin]} / {idx[~fin]}")
        err = float(np.abs(got[fin] - exp[fin]).max()) if fin.any() else 0.0
        worst = max(worst, err)
        require(err <= tol, f"row {i}: mSTAMP off by {err} (tol {tol})")
        at = Dk[k][np.nonzero(fin)[0], idx[fin]]
        require(bool((idx[fin] >= 0).all() and (np.abs(at - exp[fin]) <= tol).all()),
                f"row {i}: an mSTAMP index is not at its row's exact minimum")
    return worst


def phase_mstamp(torch):
    """mSTAMP at ``mstamp-f32-d4-131072``'s shape (n=2^17, m=256, d=4, f32,
    band 2048, chunk 4096; the suite runner's walks from seed 0): 8 rows
    across all k against the exact float64 oracle within 2e-3; then f64 at
    n=2^15 with a flat segment in one dimension, plain, ``include=(1,)``
    and ``discords=True``, 8 rows each within 1e-8.  Torch ops only (no K1
    or K3 launch)."""
    from mpx_torch import MatrixProfileConfig, make_job_grid
    from mpx_torch.mstamp import compute_multidim_profile

    n, m, d, S, W = 1 << 17, 256, 4, 2048, 4096
    T = np.cumsum(np.random.default_rng(0).standard_normal((d, n)), axis=1)
    w = n - m + 1
    jobs = len(make_job_grid(w, S, W).r0)
    cfg = MatrixProfileConfig(m=m, dtype="float32", band=S, chunk=W, device="cuda")
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with CardSampler() as card:
        t0 = time.perf_counter()
        prof = compute_multidim_profile(T, config=cfg)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    require(not any(counts().values()), f"mSTAMP launched a band sweep: {counts()}")
    require(prof.PMP.shape == (d, w) and np.isfinite(prof.PMP).all(), "mSTAMP f32 outputs")
    rows = np.sort(np.random.default_rng(1).choice(w, 8, replace=False))
    err = check_mstamp_rows(prof, mstamp_rows64(T, m, rows), rows, DIST_TOL["float32"])
    f32 = {"n": n, "m": m, "d": d, "band": S, "chunk": W, "jobs": jobs, "wall_s": wall,
           "dimension_pairs_per_s": d * w * (w - 1) / 2 / wall, "ms_per_job": wall / jobs * 1e3,
           "peak_bytes": peak, "card": card.summary, "max_err_8_rows": err,
           "tol": DIST_TOL["float32"]}
    del prof

    n64 = 1 << 15
    T = np.cumsum(np.random.default_rng(SEED + 29).standard_normal((d, n64)), axis=1)
    T[2, 9000:9600] = T[2, 9000]  # a flat segment in one dimension
    w = n64 - m + 1
    rows = np.sort(np.concatenate([[9100], np.random.default_rng(SEED + 30).choice(
        w, 7, replace=False)]))
    f64 = {}
    for name, kw in (("plain", {}), ("include_1", {"include": (1,)}),
                     ("discords", {"discords": True})):
        cfg = MatrixProfileConfig(m=m, dtype="float64", band=S, chunk=W, device="cuda")
        t0 = time.perf_counter()
        prof = compute_multidim_profile(T, config=cfg, **kw)
        wall = time.perf_counter() - t0
        Dk = mstamp_rows64(T, m, rows, include=kw.get("include", ()),
                           discords=kw.get("discords", False))
        f64[name] = {"wall_s": wall, "max_err_8_rows": check_mstamp_rows(
            prof, Dk, rows, DIST_TOL["float64"])}
    say("29 mstamp", f32=f32, f64={"n": n64, "d": d, "flat": "dim 2, 9000:9600",
                                   "tol": DIST_TOL["float64"], **f64})


def phase_pan(torch) -> dict:
    """The pan surface on the card, n=2^16, ``ms = pan_m_range(64, 8192,
    8)`` (the top level above ``MXU_MAX_M``): ``method='fused'`` (f32, torch
    ops, no K1 or K3 launch) and ``method='exact'`` (f64 through ``auto``: K1
    launches for the levels below ``K3_MIN_M_F64``, K3 from it up, no plain
    sweep) on one random walk;
    the fused rows within 2e-3 of the exact rows (indices only between
    equidistant windows) and 16 windows of the exact surface (2 a level)
    within 1e-8 of the exact row scan.  Returns the exact run's K1 and K3
    launches."""
    from mpx_torch import MatrixProfileConfig, make_job_grid
    from mpx_torch.pan import compute_pan_profile, pan_m_range
    from mpx_torch.utils.profile import BenchmarkProfile

    n = 1 << 16
    ms = pan_m_range(64, 8192, 8)
    T = random_walk(n, SEED + 30)
    S, W = 4096, 16384
    jobs = {int(m): len(make_job_grid(n - int(m) + 1, S, W).r0) for m in ms}
    runs = {}
    for method, dtype in (("fused", "float32"), ("exact", "float64")):
        cfg = MatrixProfileConfig(m=int(ms[0]), dtype=dtype, band=S, chunk=W, device="cuda")
        prof = BenchmarkProfile()
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pan = compute_pan_profile(T, ms, config=cfg, method=method, profile=prof)
        wall = time.perf_counter() - t0
        runs[method] = (pan, wall, prof, counts(), torch.cuda.max_memory_allocated())
    pan_f, wall_f, prof_f, c_f, peak_f = runs["fused"]
    require(not any(c_f.values()), f"the fused pan launched a band sweep: {c_f}")
    pan_x, wall_x, _, c_x, peak_x = runs["exact"]
    k1_want = sum(j for m, j in jobs.items() if auto_counter("float64", m) == "k1")
    k3_want = sum(j for m, j in jobs.items() if auto_counter("float64", m) == "k3")
    require(c_x == {"k1": k1_want, "mxu": 0, "k3": k3_want, "xla": 0},
            f"exact pan: counts {c_x}, expected K1 x{k1_want} and K3 x{k3_want} only")
    worst_fused, worst_exact = 0.0, 0.0
    for r, m in enumerate(int(x) for x in ms):
        wm = n - m + 1
        worst_fused = max(worst_fused, check_profiles_agree(
            T, m, pan_f.PMP[r, :wm], pan_f.PMPI[r, :wm], pan_x.PMP[r, :wm],
            pan_x.PMPI[r, :wm], DIST_TOL["float32"]))
        rows = np.sort(np.random.default_rng(SEED + 31 + r).choice(wm, 2, replace=False))
        worst_exact = max(worst_exact, check_rows(
            T, m, pan_x.PMP[r, :wm], pan_x.PMPI[r, :wm], rows, DIST_TOL["float64"],
            D=row_scan64_card(torch, T, m, rows)))
    sweep = prof_f.category_totals()[f"2. Compute [pan x{len(ms)} levels]"] / 1e9
    fused_jobs = jobs[int(ms[0])]
    say("30 pan", n=n, ms=[int(m) for m in ms], band=S, chunk=W,
        fused={"wall_s": wall_f, "phases_s": {k: v / 1e9 for k, v in
                                              prof_f.category_totals().items()},
               "jobs": fused_jobs, "ms_per_level_per_job": sweep / (len(ms) * fused_jobs) * 1e3,
               "peak_bytes": peak_f},
        exact={"wall_s": wall_x, "k1_f64_launches": c_x["k1"], "k3_f64_launches": c_x["k3"],
               "plain_calls": 0, "peak_bytes": peak_x},
        max_err_fused_vs_exact=worst_fused, tol_fused=DIST_TOL["float32"],
        max_err_exact_vs_scan_16_windows=worst_exact, tol_exact=DIST_TOL["float64"])
    return {"k1": c_x["k1"], "k3": c_x["k3"]}


def merlin_split(prof) -> dict:
    phases = {k: v / 1e9 for k, v in prof.category_totals().items()}
    refine = sum(v for k, v in phases.items() if k.startswith("4. Refine"))
    return {"survey_s": sum(v for k, v in phases.items() if "[pan" in k),
            "refine_s": refine, "phases_s": phases}


def phase_merlin(torch) -> int:
    """MERLIN at ``merlin-f32-524288-16``'s lengths (256..271) on the suite
    runner's walk from seed 0, cut from n=2^19 to 2^18 (``bench --suite``
    measures the full shape) on the card: the
    runner's own validation (16 sampled rows at 4 lengths: no exact NN
    distance exceeds the reported discord), and at lengths 256 and 271 the
    reported discord equal to the largest value of the full f64 profile
    through ``auto`` (K3) within 1e-9; then ``multi_length_motifs`` at
    n=2^16, lengths 64..71, each pair equal to the smallest value of the
    exact f64 profile within 1e-9.  Returns the K1 f32 launches of the
    escalations (the hybrid's pass A)."""
    from mpx_torch import MatrixProfileConfig, compute_matrix_profile, make_job_grid
    from mpx_torch.merlin import _DEFAULT_EPS, _exact_row_rescore
    from mpx_torch.merlin import multi_length_discords, multi_length_motifs
    from mpx_torch.utils.profile import BenchmarkProfile

    n, lo, hi = 1 << 18, 256, 271
    T = np.cumsum(np.random.default_rng(0).standard_normal(n))
    ms = np.arange(lo, hi + 1)
    pairs = float(sum((n - m + 1) * (n - m) / 2 for m in ms))
    cfg = MatrixProfileConfig(m=lo, device="cuda")
    jobs = len(make_job_grid(n - lo + 1, cfg.band, cfg.chunk).r0)
    prof = BenchmarkProfile()
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with CardSampler() as card:
        t0 = time.perf_counter()
        res = multi_length_discords(T, lo, hi, config=cfg, profile=prof)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    c = counts()
    require(not (c["mxu"] or c["k3"] or c["xla"]), f"MERLIN: counts {c}")
    if not res.escalated_lengths:
        require(c["k1"] == 0, f"MERLIN launched K1 without an escalation: {c}")
    require([d.m for d in res.per_length] == list(ms) and res.exact,
            f"MERLIN per-length entries {[d.m for d in res.per_length]}, exact {res.exact}")
    rng = np.random.default_rng(1)
    checked = 0
    for d in res.per_length[:: max(1, len(res.per_length) // 3)]:
        w = n - d.m + 1
        rows = np.sort(rng.choice(w, size=16, replace=False)).astype(np.int32)
        D, _ = _exact_row_rescore(T, d.m, rows, "cuda")
        require(D.max() <= d.distance + 1e-9,
                f"m={d.m}: sampled row NN {D.max()} exceeds the reported discord {d.distance}")
        checked += rows.shape[0]
    exact = {}
    for d in (res.per_length[0], res.per_length[-1]):
        MP, MPI = (x.cpu().numpy() for x in compute_matrix_profile(T, config=MatrixProfileConfig(
            m=d.m, dtype="float64", device="cuda")))
        best = float(MP[MPI >= 0].max())
        require(abs(best - d.distance) <= 1e-9,
                f"m={d.m}: discord {d.distance} vs the exact profile's maximum {best}")
        exact[d.m] = {"discord": d.distance, "exact_max": best, "err": abs(best - d.distance)}
    per_len = {int(m): {"candidates": prof.counts.get(f"candidates_m{m}"),
                        "survey_err": prof.counts.get(f"survey_err_m{m}")} for m in ms}
    split = merlin_split(prof)
    sweep = split["phases_s"][f"2. Compute [pan x{len(ms)} levels]"]
    discords = {"n": n, "lengths": [lo, hi], "band": cfg.band, "chunk": cfg.chunk, "jobs": jobs,
                "wall_s": wall, "pairs": pairs, "pairs_per_s": pairs / wall, **split,
                "ms_per_level_per_job": sweep / (len(ms) * jobs) * 1e3,
                "per_length": per_len, "eps": _DEFAULT_EPS,
                "max_survey_err": max(v["survey_err"] or 0.0 for v in per_len.values()),
                "escalated": res.escalated_lengths, "truncated": res.truncated_lengths,
                "k1_f32_launches": c["k1"], "peak_bytes": peak, "card": card.summary,
                "validation_rows": checked, "exact_check": exact,
                "top": [d._asdict() for d in res.top]}

    n2, lo2, hi2 = 1 << 16, 64, 71
    T2 = random_walk(n2, SEED + 32)
    prof2 = BenchmarkProfile()
    reset_counts()
    t0 = time.perf_counter()
    mot = multi_length_motifs(T2, lo2, hi2, config=MatrixProfileConfig(m=lo2, device="cuda"),
                              profile=prof2)
    wall2 = time.perf_counter() - t0
    c2 = counts()
    require(not (c2["mxu"] or c2["k3"] or c2["xla"]), f"MERLIN motifs: counts {c2}")
    require([d.m for d in mot.per_length] == list(range(lo2, hi2 + 1)), "motif lengths")
    worst = 0.0
    for d in mot.per_length:
        MP, MPI = (x.cpu().numpy() for x in compute_matrix_profile(T2, config=MatrixProfileConfig(
            m=d.m, dtype="float64", device="cuda")))
        err = abs(float(MP[MPI >= 0].min()) - d.distance)
        worst = max(worst, err)
        require(err <= 1e-9, f"motif m={d.m}: {d.distance} vs the exact minimum, off {err}")
    motifs = {"n": n2, "lengths": [lo2, hi2], "wall_s": wall2, **merlin_split(prof2),
              "escalated": mot.escalated_lengths, "k1_f32_launches": c2["k1"],
              "max_err_vs_exact_min": worst}
    say("31 merlin", discords=discords, motifs=motifs, tol=1e-9)
    return c["k1"] + c2["k1"]


def phase_slice9_cli(torch):
    """``mstamp`` (two dimensions: the halves of data/binary/16384.tsb in
    temporary files), ``pan --motifs --discords`` and ``merlin`` on
    data/binary/16384.tsb on the card: each file and each printed table
    equal to the API's result on the card."""
    from mpx_torch import MatrixProfileConfig
    from mpx_torch.io.tsb import read_series, write_binary
    from mpx_torch.merlin import multi_length_discords
    from mpx_torch.mstamp import compute_multidim_profile
    from mpx_torch.pan import compute_pan_profile, pan_discords, pan_m_range, pan_motifs

    src = os.path.join(REPO, "data", "binary", "16384.tsb")
    T = read_series(src)
    A, B = T[: T.shape[0] // 2], T[T.shape[0] // 2 :]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        a, b, base = (os.path.join(tmp, x) for x in ("a.tsb", "b.tsb", "out"))
        write_binary(a, A)
        write_binary(b, B)
        t0 = time.perf_counter()
        run_cli("mstamp", "-i", a, "-i", b, "-m", "64", "-o", base)
        got = np.load(base + ".mstamp.npz")
        api = compute_multidim_profile(np.stack([A, B]),
                                       config=MatrixProfileConfig(m=64, device="cuda"))
        require(np.array_equal(got["PMP"], api.PMP) and np.array_equal(got["PMPI"], api.PMPI),
                "mstamp's file differs from compute_multidim_profile on the card")
        out["mstamp"] = {"seconds": time.perf_counter() - t0, "shape": list(api.PMP.shape)}

        t0 = time.perf_counter()
        printed = run_cli("pan", "-i", src, "--m-lo", "64", "--m-hi", "512", "--count", "4",
                          "--motifs", "3", "--discords", "3", "-o", base)
        got = np.load(base + ".pan.npz")
        ms = pan_m_range(64, 512, 4)
        pan = compute_pan_profile(T, ms, config=MatrixProfileConfig(m=64, device="cuda"))
        require(np.array_equal(got["PMP"], pan.PMP) and np.array_equal(got["PMPI"], pan.PMPI),
                "pan's file differs from compute_pan_profile on the card")
        lines = [f"  {x.m:6d} {x.a:8d} {x.b:8d} {x.distance:.4f} {x.score:.4f}"
                 for x in pan_motifs(pan, k=3) + pan_discords(pan, k=3)]
        table = [ln for ln in printed.splitlines() if ln.startswith("  ")]
        require(table == lines, f"pan's tables differ from the API's:\n{printed}")
        out["pan"] = {"seconds": time.perf_counter() - t0, "ms": [int(m) for m in ms]}

        t0 = time.perf_counter()
        printed = run_cli("merlin", "-i", src, "--lo", "64", "--hi", "71", "-k", "3")
        res = multi_length_discords(T, 64, 71, k=3, config=MatrixProfileConfig(m=64,
                                                                               device="cuda"))
        lines = [f"  m={d.m:5d} idx={d.index:8d} nn={d.nn_index:8d} "
                 f"dist={d.distance:.6f} score={d.score:.4f}" for d in res.top]
        table = [ln for ln in printed.splitlines() if ln.startswith("  m=")]
        require(table == lines, f"merlin's table differs from the API's:\n{printed}")
        out["merlin"] = {"seconds": time.perf_counter() - t0, "top": len(lines)}
    say("32 slice-9 commands", input="data/binary/16384.tsb", **out)


# ---------------------------------------------------------------- slice 10


def busy_share(torch, fn) -> dict:
    """``fn`` traced by torch.profiler: the device's busy share (kernel
    time over the span from the first kernel's start to the last one's
    end), the kernels' time and the launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    span = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
    launches = sum(e.count for e in prof.key_averages() if e.key == "cudaLaunchKernel")
    top = sorted(((e.key, e.self_device_time_total) for e in prof.key_averages()
                  if e.key.startswith("aten::")), key=lambda x: -x[1])[:6]
    return {"profiled_wall_s": wall, "device_busy_us": busy, "span_us": span,
            "device_idle_share": 1.0 - busy / span, "launches": launches,
            "top_ops_device_us": dict(top)}


def masked_scan_card(torch, T, m: int, rows, bad) -> np.ndarray:
    """:func:`row_scan64_card` of the gap-filled series without the gap
    windows (``bad``) as neighbors: the exact masked scan."""
    D = row_scan64_card(torch, T, m, rows)
    D[:, bad] = np.inf
    return D


def planted_stream(n: int, m: int, seed: int, at: int):
    """A noisy sine of n samples with a burst of m // 2 samples at ``at``
    (``tests/test_damp.py``'s anomaly, scaled)."""
    rng = np.random.default_rng(seed)
    T = np.sin(2 * np.pi * np.arange(n) / 50) + 0.05 * rng.standard_normal(n)
    T[at : at + m // 2] += rng.normal(0, 1.5, m // 2)
    return T


def phase_streaming(torch) -> dict:
    """Streaming at ``streaming-f32-262144``'s full shape (n = 2^18, m = 256,
    f32, 50 appends of 64 points, the suite runner's walk from seed 0):
    the bootstrap through K1, one warm-up append, 49 timed appends, five
    more under torch.profiler; 24 sampled rows and 8 of the appended
    windows against the exact f64 scan within 2e-3.  Then FLOSS (window 2^16, slack 1.2: one trim) and online
    DAMP at n = 2^16, m = 128, f64, 64 appends of 256 on a noisy sine with
    a planted burst: bootstrapped through ``auto`` (K3 at this m), the
    right and left states within 1e-8 of the card's batch right and left
    profiles of the retained series, and the burst alerts.  Returns the
    bootstraps' launches by dtype, the float64 ones' counter and the
    stream's checked profile (after its 50 appends)."""
    from mpx_torch import MatrixProfileConfig, compute_matrix_profile
    from mpx_torch.damp import OnlineAnomalyDetector
    from mpx_torch.floss import Floss
    from mpx_torch.streaming import StreamingMatrixProfile

    n, m, append, rounds = 1 << 18, 256, 64, 50
    T = np.cumsum(np.random.default_rng(0).standard_normal(n + append * (rounds + 5)))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    smp = StreamingMatrixProfile(T[:n], m, "float32", device="cuda")
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    smp.append(T[n : n + append])  # warm-up
    staged0, pos = smp.staged_elements, n + append
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds - 1):
        smp.append(T[pos : pos + append])
        pos += append
    MP, MPI = smp.profile()
    wall = time.perf_counter() - t0
    c = counts()
    k1_f32 = require_only(c, "k1", "streaming bootstrap")
    staged = (smp.staged_elements - staged0) / (rounds - 1)
    tail = T[pos : pos + 5 * append]

    def five_appends():
        for o in range(0, 5 * append, append):
            smp.append(tail[o : o + append])

    traced = busy_share(torch, five_appends)  # appended after the checked profile
    done = rounds - 1
    pairs = sum((append + m - 1) * (n + append * (i + 1)) for i in range(1, rounds))
    recompute = sum(((n + append * (i + 1)) - m + 1) * ((n + append * (i + 1)) - m) / 2
                    for i in range(1, rounds))
    w = pos - m + 1
    rng = np.random.default_rng(1)
    rows = np.sort(np.concatenate([rng.choice(n - m, 24, replace=False),
                                   rng.choice(np.arange(n - m + 1, w), 8, replace=False)]))
    err = check_rows(T[:pos], m, MP, MPI, rows, DIST_TOL["float32"],
                     D=row_scan64_card(torch, T[:pos], m, rows))
    stream = {"n": n, "m": m, "append": append, "appends_timed": done,
              "bootstrap_s": boot_s, "bootstrap_k1_launches": k1_f32,
              "append_ms": wall / done * 1e3, "appended_pairs_per_s": pairs / wall,
              "recompute_pairs": recompute, "recompute_pairs_per_s_equivalent": recompute / wall,
              "staged_elements_per_append": staged,
              "capacity": smp._cap, "capacity_doublings": smp.capacity_doublings,
              "five_appends_profiled": traced,
              "max_err_32_rows": err, "tol": DIST_TOL["float32"]}
    require(smp.capacity_doublings == 1, f"expected one capacity doubling: {stream}")
    del smp

    n2, m2, k2, chunks = 1 << 16, 128, 256, 64
    at = n2 + 8000
    T2 = planted_stream(n2 + k2 * chunks, m2, SEED + 33, at)
    cfg = MatrixProfileConfig(m=m2, dtype="float64", device="cuda")
    reset_counts()
    fl = Floss(T2[:n2], m2, window=n2, dtype="float64", slack=1.2, device="cuda")
    det = OnlineAnomalyDetector(T2[:n2], config=cfg)
    alerts, t_fl, t_det = [], 0.0, 0.0
    for o in range(n2, n2 + k2 * chunks, k2):
        t0 = time.perf_counter()
        fl.append(T2[o : o + k2])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        alerts += det.append(T2[o : o + k2])
        t_fl, t_det = t_fl + t1 - t0, t_det + time.perf_counter() - t1
    boot64 = auto_counter("float64", m2)
    k_f64 = require_only(counts(), boot64, "FLOSS/DAMP bootstraps")
    require(fl.offset > 0, "FLOSS never trimmed")
    kept = T2[fl.offset :]
    out = [o.cpu().numpy() for o in compute_matrix_profile(kept, config=cfg, left_right=True)]
    err_r = check_profiles_agree(kept, m2, *fl.profile(), out[2], out[3], DIST_TOL["float64"])
    out = [o.cpu().numpy() for o in compute_matrix_profile(T2, config=cfg, left_right=True)]
    err_l = check_profiles_agree(T2, m2, *det.profile(), out[0], out[1], DIST_TOL["float64"])
    hit = [a for a in alerts if abs(a.index - at) <= m2]
    require(hit and abs(det.discord.index - at) <= m2,
            f"the planted burst at {at} did not alert: {alerts[-3:]}, discord {det.discord}")
    say("33 streaming", card=torch.cuda.get_device_name(0), stream=stream,
        floss={"n": n2, "m": m2, "appends": chunks, "append": k2, "window": n2,
               "offset": fl.offset, "append_ms": t_fl / chunks * 1e3,
               "max_err_right_vs_batch": err_r, "regimes": fl.regimes(k=1)},
        damp={"append_ms": t_det / chunks * 1e3, "alerts": len(alerts),
              "planted_at": at, "discord": list(det.discord),
              "max_err_left_vs_batch": err_l},
        **{f"bootstrap_{boot64}_f64_launches": k_f64}, tol=DIST_TOL["float64"])
    return {"float32": k1_f32, "float64": k_f64, "float64_counter": boot64,
            "profile": (MP, MPI)}


def phase_anytime(torch) -> int:
    """The anytime profile at n = 2^19, m = 256, f32, band 4096, chunk
    16384, 16 batches, both orders: every yield non-increasing, the final
    one equal to ``compute_matrix_profile`` within 2e-3 (indices equal or
    equidistant); ``approx_matrix_profile(fraction=0.25)``'s wall beside
    the full run's.  Returns the K1 launches of the anytime runs."""
    from mpx_torch import MatrixProfileConfig, make_job_grid
    from mpx_torch.anytime import anytime_matrix_profile, approx_matrix_profile

    n, m = 1 << 19, 256
    T = random_walk(n, SEED + 34)
    cfg = MatrixProfileConfig(m=m, dtype="float32", band=4096, chunk=16384, device="cuda")
    jobs = len(make_job_grid(n - m + 1, 4096, 16384).r0)
    MPx, MPIx, full_wall, _, _ = run_profile(torch, T, cfg)
    runs, launches = {}, 0
    for order in ("shuffled", "diagonal"):
        reset_counts()
        prev, yields, first = None, 0, None
        t0 = time.perf_counter()
        for MP, MPI, frac in anytime_matrix_profile(T, config=cfg, order=order):
            if prev is not None:
                require(bool((MP <= prev).all()), f"{order}: a yield increased")
            first = first or (time.perf_counter() - t0, frac)
            prev, yields = MP, yields + 1
        wall = time.perf_counter() - t0
        launches += require_only(counts(), "k1", f"anytime {order}", launches=jobs)
        err = check_profiles_agree(T, m, prev, MPI, MPx, MPIx, DIST_TOL["float32"])
        runs[order] = {"wall_s": wall, "yields": yields, "first_yield_s": first[0],
                       "first_fraction": first[1], "max_err_final_vs_full": err}
    reset_counts()
    t0 = time.perf_counter()
    MPa, _, frac = approx_matrix_profile(T, config=cfg, fraction=0.25)
    approx_wall = time.perf_counter() - t0
    launches += require_only(counts(), "k1", "approx 0.25", launches=-(-jobs // 4))
    require(bool((MPa >= MPx - 1e-6).all()), "approx: a distance under the exact one")
    say("34 anytime", card=torch.cuda.get_device_name(0), n=n, m=m, band=4096, chunk=16384,
        jobs=jobs, full_wall_s=full_wall, orders=runs,
        approx={"fraction": frac, "wall_s": approx_wall,
                "finite_share": float((MPa < 1e5).mean())},
        k1_f32_launches=launches, tol=DIST_TOL["float32"])
    return launches


class Killed(RuntimeError):
    pass


def phase_checkpoint(torch) -> dict:
    """Checkpoints on the card.  K3: f64, n = 2^19, m = 256, band 4096,
    chunk 32768, ``kernel='pallas'``, groups of 64 jobs: killed after half
    the groups, resumed, bit-equal to an uninterrupted checkpointed run and
    to the driver; the overhead against the driver's run.  The hybrid (f64,
    same shape): killed once in pass A and once in pass B, each resumed
    run bit-equal to an uninterrupted ``kernel='hybrid'`` run; the rows
    where K3 and the hybrid differ most, against the exact scan, each held
    to 1e-8.  Returns the K3 f64 and the hybrids' K1 f32 launches."""
    from mpx_torch import MatrixProfileConfig, checkpoint, hybrid, make_job_grid
    from mpx_torch.checkpoint import HybridCheckpoint, compute_with_checkpoint
    from mpx_torch.utils.profile import BenchmarkProfile

    n, m, S, W = 1 << 19, 256, 4096, 32768
    T = random_walk(n, SEED + 35)
    jobs = len(make_job_grid(n - m + 1, S, W).r0)
    out = {"n": n, "m": m, "band": S, "chunk": W, "jobs": jobs}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "k3.npz")
        cfg = MatrixProfileConfig(m=m, dtype="float64", kernel="pallas", band=S, chunk=W,
                                  device="cuda")
        MPd, MPId, plain_wall, _, _ = run_profile(torch, T, cfg)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        MP0, MPI0 = compute_with_checkpoint(T, cfg, path)
        ck_wall = time.perf_counter() - t0
        k3 = require_only(counts(), "k3", "checkpointed K3 run", launches=jobs)
        require(np.array_equal(MP0, MPd) and np.array_equal(MPI0, MPId),
                "the checkpointed K3 run differs from the driver's")
        groups = -(-jobs // 64)
        real_save, saves = checkpoint._save, []

        def dying_save(*args):
            real_save(*args)
            saves.append(1)
            if len(saves) == groups // 2:
                raise Killed

        checkpoint._save = dying_save
        reset_counts()
        try:
            compute_with_checkpoint(T, cfg, path)
            require(False, "the K3 run was not killed")
        except Killed:
            pass
        finally:
            checkpoint._save = real_save
        t0 = time.perf_counter()
        MP1, MPI1 = compute_with_checkpoint(T, cfg, path)
        resume_wall = time.perf_counter() - t0
        k3 += require_only(counts(), "k3", "killed + resumed K3 runs", launches=jobs)
        require(np.array_equal(MP0, MP1) and np.array_equal(MPI0, MPI1),
                "the resumed K3 run is not bit-equal")
        require(not os.listdir(tmp), f"files left: {os.listdir(tmp)}")
        out["k3"] = {"driver_wall_s": plain_wall, "checkpointed_wall_s": ck_wall,
                     "overhead": ck_wall / plain_wall - 1.0, "groups": groups,
                     "killed_after_groups": groups // 2, "resumed_wall_s": resume_wall,
                     "k3_f64_launches": k3, "bit_equal": True}

        hcfg = MatrixProfileConfig(m=m, dtype="float64", kernel="hybrid", band=S, chunk=W,
                                   device="cuda")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        MPh, MPIh = (o.cpu().numpy() for o in hybrid.compute_matrix_profile_f64_hybrid(T, hcfg))
        h_wall = time.perf_counter() - t0
        k1 = require_only(counts(), "k1", "hybrid run", launches=jobs)
        hpath = os.path.join(tmp, "hy.npz")
        # The hybrid's exact values beside K3's recurrence: the rows where
        # they differ most, each held (the hybrid) or read (K3) against the
        # exact scan.
        gap = np.abs(MPh - MP0)
        rows = np.sort(np.argsort(gap)[-8:])
        D = row_scan64_card(torch, T, m, rows)
        hy = {"uninterrupted_wall_s": h_wall, "ckpt_jobs": hybrid.CKPT_JOBS,
              "max_diff_vs_k3": float(gap.max()),
              "rows_over_tol_vs_k3": int((gap > DIST_TOL["float64"]).sum()),
              "worst_8_rows": [int(r) for r in rows],
              "hybrid_max_err_worst_8_rows": check_rows(T, m, MPh, MPIh, rows,
                                                        DIST_TOL["float64"], D=D),
              "k3_max_err_worst_8_rows": float(np.abs(MP0[rows] - D.min(axis=1)).max())}
        require(hy["k3_max_err_worst_8_rows"] <= DIST_TOL["float64"],
                f"K3 f64 on the rows farthest from the hybrid: "
                f"{hy['k3_max_err_worst_8_rows']} (tol {DIST_TOL['float64']})")
        # killed after pass A's first group of CKPT_JOBS and pass B's fourth
        for stage, after in (("A", 1), ("B", 4)):

            class Dying(HybridCheckpoint):
                saves = 0

                def save_a(self, *a):
                    super().save_a(*a)
                    self._maybe("A")

                def mark_done_and_save(self, *a, **kw):
                    super().mark_done_and_save(*a, **kw)
                    self._maybe("B")

                def _maybe(self, s):
                    if s == stage:
                        Dying.saves += 1
                        if Dying.saves == after:
                            raise Killed

            reset_counts()
            t0 = time.perf_counter()
            try:
                checkpoint.compute_hybrid_with_checkpoint(T, hcfg, hpath, _ckpt_cls=Dying)
                require(False, f"the hybrid was not killed in pass {stage}")
            except Killed:
                pass
            killed = time.perf_counter() - t0
            t0 = time.perf_counter()
            prof = BenchmarkProfile()
            MPr, MPIr = compute_with_checkpoint(T, hcfg, hpath, profile=prof)
            resumed = time.perf_counter() - t0
            c = counts()
            # pass A's jobs split between the killed and the resumed run
            k1 += require_only(c, "k1", f"hybrid killed in {stage} + resumed", launches=jobs)
            require(np.array_equal(MPr, MPh) and np.array_equal(MPIr, MPIh),
                    f"the hybrid resumed from pass {stage} is not bit-equal")
            hy[stage] = {"killed_after_saves": after, "killed_run_s": killed,
                         "resumed_s": resumed, "k1_launches_both": c["k1"],
                         "dense_jobs": prof.counts.get("dense_jobs"), "bit_equal": True,
                         "phases_s": {k: v / 1e9 for k, v in prof.category_totals().items()}}
        require(not os.listdir(tmp), f"files left: {os.listdir(tmp)}")
        out["hybrid"] = hy
    say("35 checkpoint", card=torch.cuda.get_device_name(0), **out)
    return {"k3_float64": k3, "k1_float32": k1}


def phase_batch(torch) -> int:
    """The fleet at ``batch-f32-256x8192``'s full shape (B = 256, n = 8192,
    m = 64, band = chunk = 1024, f32, the runner's walks from seed 0): the
    wall, ms a series, K1 launches, and the device's idle share of the
    first 16 series' call under torch.profiler; 8 series bit-equal to
    single runs, 4 series on 16 sampled rows each against the exact f64
    scan.  Returns the K1 launches."""
    from mpx_torch import MatrixProfileConfig, compute_matrix_profile, make_job_grid
    from mpx_torch.batch import compute_batch_profiles

    B, n, m, S = 256, 8192, 64, 1024
    batch = np.cumsum(np.random.default_rng(0).standard_normal((B, n)), axis=1)
    w = n - m + 1
    cfg = MatrixProfileConfig(m=m, dtype="float32", band=S, chunk=S, device="cuda")
    jobs = len(make_job_grid(w, S, S).r0)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    MP, MPI = compute_batch_profiles(batch, config=cfg)
    wall = time.perf_counter() - t0
    launches = require_only(counts(), "k1", "fleet", launches=B * jobs)
    # the trace of 16 series (its events of all 256 take about a minute to read)
    traced = busy_share(torch, lambda: compute_batch_profiles(batch[:16], config=cfg))
    for b in range(8):
        one = [o.cpu().numpy() for o in compute_matrix_profile(batch[b], config=cfg)]
        require(np.array_equal(MP[b], one[0]) and np.array_equal(MPI[b], one[1]),
                f"fleet row {b} differs from its single run")
    worst = 0.0
    picks = np.random.default_rng(1).choice(B, 4, replace=False)
    for s in picks:
        rows = np.sort(np.random.default_rng(2).choice(w, 16, replace=False))
        worst = max(worst, check_rows(batch[s], m, MP[s], MPI[s], rows, DIST_TOL["float32"]))
    say("36 batch", card=torch.cuda.get_device_name(0), B=B, n=n, m=m, band=S, chunk=S,
        jobs_per_series=jobs, wall_s=wall, series_ms=wall / B * 1e3,
        pairs_per_s=B * w * (w - 1) / 2 / wall, k1_f32_launches=launches,
        k1_us_per_launch_wall=wall / launches * 1e6, profiled=traced,
        bit_equal_series=8, validated_series=[int(s) for s in picks],
        max_err_16_rows=worst, tol=DIST_TOL["float32"])
    return launches


def gapped_walk(n: int, seed: int, runs: int = 52, length: int = 100) -> np.ndarray:
    """A random walk with ``runs`` NaN runs of about ``length`` samples
    (~1 % of n = 2^19 for the defaults), one +inf sample among them."""
    rng = np.random.default_rng(seed)
    T = np.cumsum(rng.standard_normal(n))
    for s in rng.choice(n - 2 * length, runs, replace=False):
        T[s : s + int(rng.integers(length // 2, 2 * length))] = np.nan
    T[int(rng.integers(0, n))] = np.inf
    return T


def phase_masked(torch) -> dict:
    """Masked gaps at n = 2^19, m = 256 (~1 % of samples NaN in 52 runs):
    f32 ``auto`` (K1) and f64 ``kernel='pallas'`` (K3), band 4096, chunk
    16384: gap windows report the sentinel and -1; 32 sampled good rows
    within 2e-3 / 1e-8 of the exact masked f64 scan; then f32 ``auto``
    ``left_right``, 16 rows a side against the sided masked scan.  Returns
    the K1 f32 and K3 f64 launches."""
    from mpx_torch import MatrixProfileConfig, make_job_grid
    from mpx_torch.missing import compute_matrix_profile_masked, missing_window_mask

    n, m = 1 << 19, 256
    T = gapped_walk(n, SEED + 37)
    bad = missing_window_mask(T, m)
    Tf = np.where(np.isfinite(T), T, 0.0)
    w = n - m + 1
    jobs = len(make_job_grid(w, 4096, 16384).r0)
    rows = np.sort(np.random.default_rng(SEED + 38).choice(np.nonzero(~bad)[0], 32,
                                                            replace=False))
    D = masked_scan_card(torch, Tf, m, rows, bad)
    sentinel = np.sqrt(2.0 * m * (1.0 + 1e12))
    out, launches = {}, {"k1": 0, "k3": 0}
    for dtype, kernel, counter in (("float32", "auto", "k1"), ("float64", "pallas", "k3")):
        cfg = MatrixProfileConfig(m=m, dtype=dtype, kernel=kernel, device="cuda")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        MP, MPI = (o.cpu().numpy() for o in compute_matrix_profile_masked(T, config=cfg))
        wall = time.perf_counter() - t0
        launches[counter] += require_only(counts(), counter, f"masked {dtype}", launches=jobs)
        require(bool((MPI[bad] == -1).all()) and np.allclose(MP[bad], sentinel, rtol=1e-6),
                f"masked {dtype}: a gap window has a neighbor")
        require(not np.isin(MPI[MPI >= 0], np.nonzero(bad)[0]).any(),
                f"masked {dtype}: a gap window is someone's neighbor")
        err = check_rows(Tf, m, MP, MPI, rows, DIST_TOL[dtype], D=D)
        out[f"{kernel}_{dtype}"] = {"wall_s": wall, "max_err_32_rows": err,
                                    "tol": DIST_TOL[dtype]}
    cfg = MatrixProfileConfig(m=m, dtype="float32", device="cuda")
    reset_counts()
    lr = [o.cpu().numpy() for o in compute_matrix_profile_masked(T, config=cfg, left_right=True)]
    launches["k1"] += require_only(counts(), "k1", "masked left/right", launches=jobs)
    sides = {}
    for name, side, (MP, MPI) in (("left", -1, lr[:2]), ("right", 1, lr[2:])):
        require(bool((MPI[bad] == -1).all()), f"masked {name}: a gap window has a neighbor")
        sides[name] = check_rows(Tf, m, MP, MPI, rows[:16], DIST_TOL["float32"],
                                 side=side, D=D[:16])
    say("37 masked", card=torch.cuda.get_device_name(0), n=n, m=m,
        nan_samples=int((~np.isfinite(T)).sum()), gap_windows=int(bad.sum()), runs=out,
        left_right_f32_max_err_16_rows=sides)
    return launches


def phase_damp(torch) -> dict:
    """Batch DAMP at ``damp-f64-524288``'s full shape (n = 2^19, m = 256,
    f64, band 4096, chunk 32768, k = 3; the runner's walk from seed 0):
    one left/right run through ``auto`` (K3 at this m); wall and pairs/s;
    16 sampled rows' left values within 1e-8 of the exact f64 scan of
    earlier windows.  Returns the launches by counter."""
    from mpx_torch import MatrixProfileConfig, make_job_grid
    from mpx_torch.damp import compute_damp

    n, m = 1 << 19, 256
    T = np.cumsum(np.random.default_rng(0).standard_normal(n))
    w = n - m + 1
    cfg = MatrixProfileConfig(m=m, dtype="float64", band=4096, chunk=32768, device="cuda")
    jobs = len(make_job_grid(w, 4096, 32768).r0)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = compute_damp(T, config=cfg, k=3)
    wall = time.perf_counter() - t0
    counter = auto_counter("float64", m)
    launches = require_only(counts(), counter, "damp", launches=jobs)
    rows = np.sort(np.random.default_rng(1).choice(np.arange(m // 4 + 1, w), 16,
                                                   replace=False))
    D = row_scan64_card(torch, T, m, rows)
    exp = np.where(np.arange(w)[None, :] < rows[:, None], D, np.inf).min(axis=1)
    err = float(np.abs(res.scores[rows] - exp).max())
    require(err <= DIST_TOL["float64"], f"damp rows off by {err}")
    say("38 damp", card=torch.cuda.get_device_name(0), n=n, m=m, band=4096, chunk=32768,
        wall_s=wall, pairs_per_s=w * (w - 1) / 2 / wall, **{f"{counter}_f64_launches": launches},
        discords=[list(a) for a in res.discords], max_err_16_rows=err,
        tol=DIST_TOL["float64"])
    return {counter: launches}


def phase_slice10_cli(torch):
    """The command lines on data/binary/16384.tsb, each equal to the
    library on the card: ``compute --checkpoint`` resuming a run killed
    after its first group (band 256, chunk 512), ``--approx 0.25``,
    ``--allow-missing`` on a copy with two NaN runs, ``damp``, ``batch``
    (four quarters of the series) and ``floss``."""
    from mpx_torch import MatrixProfileConfig, checkpoint
    from mpx_torch.analysis import extract_regimes
    from mpx_torch.anytime import approx_matrix_profile
    from mpx_torch.batch import compute_batch_profiles
    from mpx_torch.checkpoint import compute_with_checkpoint
    from mpx_torch.damp import compute_damp
    from mpx_torch.floss import Floss
    from mpx_torch.io.tsb import read_binary, read_series, write_binary
    from mpx_torch.missing import compute_matrix_profile_masked

    src = os.path.join(REPO, "data", "binary", "16384.tsb")
    T, m = read_series(src), 64
    out = {}

    def files(base):
        return read_binary(base + ".mpb", "double"), read_binary(base + ".mpib", "int")

    def same(got, want, what):
        require(all(np.array_equal(a, np.asarray(b)) for a, b in zip(got, want)),
                f"{what}: the command's files differ from the library's")

    with tempfile.TemporaryDirectory() as tmp:
        base, ck = os.path.join(tmp, "out"), os.path.join(tmp, "run.npz")
        cfg = MatrixProfileConfig(m=m, band=256, chunk=512, device="cuda")
        want = compute_with_checkpoint(T, cfg, ck)
        real_save = checkpoint._save

        def dying_save(*args):
            real_save(*args)
            raise Killed

        checkpoint._save = dying_save
        try:
            compute_with_checkpoint(T, cfg, ck)
        except Killed:
            pass
        finally:
            checkpoint._save = real_save
        require(os.path.exists(ck), "no checkpoint after the kill")
        t0 = time.perf_counter()
        printed = run_cli("compute", "-i", src, "-m", str(m), "--band", "256", "--chunk",
                          "512", "--checkpoint", ck, "-o", base)
        require("resuming from checkpoint: group 1/" in printed, printed)
        same(files(base), want, "compute --checkpoint")
        out["checkpoint"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        run_cli("compute", "-i", src, "-m", str(m), "--approx", "0.25", "-o", base)
        same(files(base), approx_matrix_profile(T, config=MatrixProfileConfig(
            m=m, device="cuda"), fraction=0.25)[:2], "compute --approx")
        out["approx"] = time.perf_counter() - t0

        G = T.copy()
        G[3000:3100] = np.nan
        G[9000:9010] = np.nan
        gap = os.path.join(tmp, "gap.tsb")
        write_binary(gap, G)
        t0 = time.perf_counter()
        run_cli("compute", "-i", gap, "-m", str(m), "--allow-missing", "-o", base)
        same(files(base), [o.cpu().numpy() for o in compute_matrix_profile_masked(
            G, config=MatrixProfileConfig(m=m, device="cuda"))], "compute --allow-missing")
        out["allow_missing"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        printed = run_cli("damp", "-i", src, "-m", str(m), "--split", "1000", "--dtype",
                          "float64", "-o", base)
        res = compute_damp(T, config=MatrixProfileConfig(m=m, dtype="float64", device="cuda"),
                           split=1000)
        lines = [f"  {a.index:>8}  distance {a.distance:.6f}" for a in res.discords]
        require([ln for ln in printed.splitlines() if ln.startswith("  ")] == lines
                and np.array_equal(np.load(base + ".damp.npy"), res.scores),
                f"damp differs from compute_damp:\n{printed}")
        out["damp"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        quarters = T.reshape(4, -1)
        paths = []
        for b, q in enumerate(quarters):
            paths += ["-i", os.path.join(tmp, f"q{b}.tsb")]
            write_binary(paths[-1], q)
        run_cli("batch", "-m", str(m), *paths, "-o", base)
        MP, MPI = compute_batch_profiles(quarters, config=MatrixProfileConfig(m=m,
                                                                              device="cuda"))
        for b in range(4):
            same(files(f"{base}.q{b}"), (MP[b], MPI[b]), "batch")
        out["batch"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        printed = run_cli("floss", "-i", src, "-m", str(m), "--step", "512", "--window",
                          "8192", "-k", "2", "--threshold", "1.0")
        fl = Floss(T[: 4 * m], m, window=8192, device="cuda")
        for s in range(4 * m, T.shape[0], 512):
            fl.append(T[s : s + 512])
        cac = fl.cac()
        lines = [f"  {fl.offset + r:8d} {cac[r]:.3f}" for r in extract_regimes(cac, m, k=2)
                 if cac[r] < 1.0]
        require([ln for ln in printed.splitlines() if ln.startswith("  ")] == lines
                and f"window [{fl.offset}, {T.shape[0]})" in printed,
                f"floss differs from Floss:\n{printed}")
        out["floss"] = time.perf_counter() - t0
    say("39 slice-10 commands", card=torch.cuda.get_device_name(0),
        input="data/binary/16384.tsb", seconds=out)

# ---------------------------------------------------------------- slice 11
def phase_contrast(torch) -> dict:
    """The contrast profile at the suite row ``contrast-f64-524288``
    (n = 2^19, m = 256, f64, band 4096, chunk 32768; the runner's walks
    from seeds 0 and 7) through ``run_contrast_benchmark``: one timed run
    (the kernels were built in phase 1, so no warm-up), the self-join's
    launches through ``auto`` (K3 at this m) and the AB-join's K1 f64
    launches and nothing else, its 32 sampled rows within 1e-8 of the f64
    row scans; wall, pairs/s, clock and power.  Returns the launches by
    counter."""
    from mpx_torch import MatrixProfileConfig, make_job_grid
    from mpx_torch.abjoin import ab_jobs
    from mpx_torch.bench import run_contrast_benchmark

    n, m, S, W = 1 << 19, 256, 4096, 32768
    w = n - m + 1
    g = MatrixProfileConfig(m=m, band=S, chunk=W, device="cuda").shrink_to(w)
    self_jobs = len(make_job_grid(w, g.band, g.chunk).r0)
    cross_jobs = len(ab_jobs(w, w, g.band, g.chunk)[0])
    reset_counts()
    torch.cuda.synchronize()
    with CardSampler() as card:
        res = run_contrast_benchmark(n, m, dtype="double", band=S, chunk=W, seed=0,
                                     validate=32, warmup=False, device="cuda")
    launches = {"k1": cross_jobs, "mxu": 0, "k3": 0, "xla": 0}
    launches[auto_counter("float64", m)] += self_jobs
    require(counts() == launches, f"contrast profile: counts {counts()}, expected {launches}")
    launches = {k: v for k, v in launches.items() if v}
    val = res["validation"]
    require(val["rows"] == 32 and val["max_abs_err"] <= DIST_TOL["float64"],
            f"contrast validation: {val}")
    say("40 contrast", card_name=torch.cuda.get_device_name(0), suite_row="contrast-f64-524288",
        n=n, m=m, band=S, chunk=W, wall_s=res["wall_s"], pairs=res["pairs"],
        pairs_per_s=res["pairs_per_sec"], f64_launches=launches,
        self_join_jobs=self_jobs, ab_jobs=cross_jobs, card=card.summary,
        validation=val, cp_head=res["mp_head"])
    return launches


def planted_walk(n: int, seed: int, starts, shape, noise: float) -> np.ndarray:
    """A random walk with a noisy copy of ``shape`` at each start (a
    noisy copy: an exact one would sit at distance ~0, where the square
    root turns any rounding into ~1e-7)."""
    rng = np.random.default_rng(seed)
    T = np.cumsum(rng.standard_normal(n))
    for at in starts:
        T[at : at + shape.shape[0]] = T[at] + shape + noise * rng.standard_normal(shape.shape[0])
    return T


def phase_compositions(torch) -> dict:
    """The other compositions on the card, each against the port's CPU
    run or an exact host check: ``compute_chains`` (f32, n = 2^18, m =
    256), its left/right indices equal to the driver's; ``ostinato`` (f64,
    3 walks of 2^16 with a planted motif), the planted motif found and its
    radius within 1e-8 of exact scans of the other series; ``snippets``
    (f32, n = 2^15, L = 1024), 32 sampled positions (outside the chosen
    segments) of the chosen candidates' profiles within 2e-3 of exact
    scans and the fractions
    equal to the assignment of those profiles; ``mpdist_matrix`` /
    ``cluster_series`` (f64, 4 series of 2^15 in two families), the
    families recovered and one pair's MPdist equal to the plain sweep's
    (``kernel='mxu'``) within 1e-8; ``k_motiflets`` (f32, n = 2^16, m =
    128, k = 5), the five planted copies found and the extent equal to
    the exact pairwise extent; ``aamp_mpdist`` (f64, 2^14 x 2^13) within
    1e-10 of the largest distance of the CPU run.  K1 launches of each are counted over
    its own run.  Returns the K1 launches per dtype."""
    import dataclasses

    from mpx_torch import MatrixProfileConfig, compute_ab_join, compute_matrix_profile
    from mpx_torch.aamp import aamp_mpdist, compute_aamp_ab_join
    from mpx_torch.chains import compute_chains
    from mpx_torch.cluster import cluster_series
    from mpx_torch.analysis import mpdist, mpdist_from_profiles
    from mpx_torch.motiflets import k_motiflets, pairwise_extent
    from mpx_torch.ostinato import ostinato
    from mpx_torch.snippets import snippets

    out, k1 = {}, {"float32": 0, "float64": 0}

    def timed(dtype, what, fn, expect="k1"):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        c = counts()
        if expect == "k1":
            k1[dtype] += require_only(c, "k1", what)
        else:
            require(not any(c.values()), f"{what}: counts {c}, expected none")
        return res, sec, c["k1"]

    # chains: f32 left/right through K1, indices equal to the driver's
    n, m = 1 << 18, 256
    T = np.cumsum(np.random.default_rng(SEED + 41).standard_normal(n))
    cfg = MatrixProfileConfig(m=m, device="cuda")
    res, sec, n1 = timed("float32", "compute_chains", lambda: compute_chains(T, cfg))
    lr = compute_matrix_profile(T, config=cfg, left_right=True)
    require(np.array_equal(res.mpi_left, lr[1].cpu().numpy())
            and np.array_equal(res.mpi_right, lr[3].cpu().numpy()),
            "compute_chains' left/right indices differ from the driver's")
    out["chains"] = {"n": n, "m": m, "dtype": "float32", "seconds": sec, "k1_launches": n1,
                     "longest": res.length, "windows_in_chains": int((res.lengths > 1).sum())}

    # ostinato: f64, three walks with a planted motif
    n, m = 1 << 16, 256
    shape = 5 * np.sin(np.linspace(0, 8 * np.pi, 300)) + np.cumsum(
        np.random.default_rng(SEED + 42).standard_normal(300))
    starts = (10000, 30000, 50000)
    series = [planted_walk(n, SEED + 43 + i, [starts[i]], shape, 0.05) for i in range(3)]
    cfg = MatrixProfileConfig(m=m, dtype="float64", device="cuda")
    res, sec, n1 = timed("float64", "ostinato", lambda: ostinato(series, config=cfg))
    at = starts[res.series]
    require(at <= res.index <= at + 300 - m, f"ostinato found {res.series}@{res.index}")
    exact = max(row_scan64(series[res.series], m, np.array([res.index]), target=series[j]).min()
                for j in range(3) if j != res.series)
    err = abs(res.radius - exact)
    require(err <= DIST_TOL["float64"], f"ostinato radius {res.radius} vs exact {exact}")
    out["ostinato"] = {"n": n, "series": 3, "m": m, "dtype": "float64", "seconds": sec,
                       "k1_launches": n1, "found": [res.series, res.index],
                       "radius": res.radius, "radius_err_vs_exact": err}

    # snippets: f32, n = 2^15 (cut from 2^16 to keep the script under
    # 570 s), L = 1024 (m = 512); three regimes
    n, L = 1 << 15, 1024
    t = np.arange(n)
    Ts = np.where(t < n // 3, np.sin(t / 20.0), np.where(t < 2 * n // 3, np.sign(np.sin(
        t / 37.0)), np.sin(t / 11.0) ** 3)) + 0.05 * np.random.default_rng(SEED + 44) \
        .standard_normal(n)
    cfg = MatrixProfileConfig(m=L // 2, device="cuda")
    res, sec, n1 = timed("float32", "snippets", lambda: snippets(Ts, L, k=3, config=cfg))
    picks = [s.index for s in res]
    mS = L // 2
    Dk = np.stack([compute_ab_join(Ts[j * L : (j + 1) * L], Ts, config=cfg).mp_b.cpu()
                   .numpy().astype(np.float64) for j in picks])
    assign = np.argmin(Dk, axis=0)
    require(all(abs(s.fraction - float(np.mean(assign == r))) < 1e-12
                for r, s in enumerate(res)), "snippets' fractions differ from the assignment")
    # A window inside a chosen segment matches itself at distance 0, where
    # the square root turns any rounding of the correlation into
    # sqrt(2m eps): the positions are sampled outside them.
    inside = np.zeros(n - mS + 1, bool)
    for j in picks:
        inside[j * L : j * L + L - mS + 1] = True
    pos = np.sort(np.random.default_rng(SEED + 45).choice(np.nonzero(~inside)[0], 32,
                                                          replace=False))
    err = plain_err = 0.0
    pcfg = dataclasses.replace(cfg, kernel="mxu")
    for r, j in enumerate(picks):
        exact = row_scan64(Ts, mS, pos, target=Ts[j * L : (j + 1) * L]).min(axis=1)
        err = max(err, float(np.abs(Dk[r, pos] - exact).max()))
        # read, not gated: the plain sweep (FP32 matmul) on the same rows
        Dp = compute_ab_join(Ts[j * L : (j + 1) * L], Ts, config=pcfg).mp_b.cpu().numpy()
        plain_err = max(plain_err, float(np.abs(Dp[pos] - exact).max()))
    require(err <= DIST_TOL["float32"], f"snippets' profiles off by {err}")
    # read, not gated: 8 self-match positions of the first pick (exact 0)
    own = np.arange(picks[0] * L, picks[0] * L + L - mS + 1, (L - mS) // 7)[:8]
    self_err = float(np.abs(Dk[0, own]).max())
    out["snippets"] = {"n": n, "L": L, "m": mS, "dtype": "float32", "seconds": sec,
                       "k1_launches": n1, "starts": [s.start for s in res],
                       "fractions": [s.fraction for s in res],
                       "max_err_32_positions": err,
                       "plain_sweep_max_err_32_positions": plain_err,
                       "self_match_distance_max_8_positions": self_err}

    # cluster: f64, 4 series of 2^15 in two families
    n, m = 1 << 15, 256
    bases = [np.cumsum(np.random.default_rng(SEED + 46 + f).standard_normal(4096))
             for f in range(2)]
    fam = []
    for i in range(4):
        X = np.cumsum(np.random.default_rng(SEED + 50 + i).standard_normal(n))
        b = bases[i % 2]
        for at in (2000, 12000, 22000):
            X[at : at + 4096] = X[at] - b[0] + b + 0.05 * np.random.default_rng(
                SEED + 60 + i + at).standard_normal(4096)
        fam.append(X)
    cfg = MatrixProfileConfig(m=m, dtype="float64", device="cuda")
    res, sec, n1 = timed("float64", "cluster_series",
                         lambda: cluster_series(fam, n_clusters=2, threshold=0.05, config=cfg))
    require(res.labels.tolist() == [0, 1, 0, 1], f"cluster labels {res.labels.tolist()}")
    reset_counts()
    plain = mpdist(fam[0], fam[1], m, config=dataclasses.replace(cfg, kernel="mxu"))
    err = abs(plain - res.distances[0, 1])
    require(err <= DIST_TOL["float64"], f"mpdist vs the plain sweep: {err}")
    out["cluster"] = {"series": 4, "n": n, "m": m, "dtype": "float64", "seconds": sec,
                      "k1_launches": n1, "labels": res.labels.tolist(),
                      "distances": res.distances.round(6).tolist(),
                      "mpdist_err_vs_plain": err}

    # motiflets: f32, n = 2^16, m = 128, k = 5 (the strict top-k tile: torch ops)
    n, m = 1 << 16, 128
    shape = 4 * np.sin(np.linspace(0, 6 * np.pi, 160)) + np.cumsum(
        np.random.default_rng(SEED + 47).standard_normal(160))
    starts = (5000, 18000, 31000, 44000, 57000)
    Tm = planted_walk(n, SEED + 48, starts, shape, 0.1)
    res, sec, _ = timed("float32", "k_motiflets", lambda: k_motiflets(
        Tm, 5, config=MatrixProfileConfig(m=m, device="cuda")), expect=None)
    require(all(any(a <= i <= a + 160 - m for i in res.indices) for a in starts),
            f"motiflet {res.indices.tolist()} misses a planted copy")
    require(res.extent == pairwise_extent(Tm, m, res.indices), "motiflet extent")
    out["motiflets"] = {"n": n, "m": m, "k": 5, "dtype": "float32", "seconds": sec,
                        "indices": res.indices.tolist(), "extent": res.extent}

    # aamp_mpdist: f64 raw AB-join (torch ops) against the CPU run
    A = np.cumsum(np.random.default_rng(SEED + 49).standard_normal(1 << 14))
    B = np.cumsum(np.random.default_rng(SEED + 50).standard_normal(1 << 13))
    kw = dict(m=256, dtype="float64")
    got, sec, _ = timed("float64", "aamp_mpdist", lambda: aamp_mpdist(
        A, B, 256, config=MatrixProfileConfig(device="cuda", **kw)), expect=None)
    cpu = compute_aamp_ab_join(A, B, 256, config=MatrixProfileConfig(device="cpu", **kw))
    exp = mpdist_from_profiles(cpu.mp_a, cpu.mp_b, A.shape[0], B.shape[0])
    # mpx's float64 AAMP tolerance: 1e-10 of the largest distance
    rel = abs(got - exp) / float(max(cpu.mp_a.max(), cpu.mp_b.max()))
    require(rel <= 1e-10, f"aamp_mpdist {got} vs the CPU's {exp}")
    out["aamp_mpdist"] = {"na": A.shape[0], "nb": B.shape[0], "m": 256, "seconds": sec,
                          "value": got, "err_vs_cpu_of_largest_distance": rel}
    say("41 compositions", card=torch.cuda.get_device_name(0), **out,
        seconds_total=sum(v["seconds"] for v in out.values()))
    return k1


def phase_slice11_cli(torch):
    """The ``analyze`` (``--regimes --chain --av complexity``, and saved
    results), ``chains --all``, ``contrast`` (``-o``), ``ostinato``,
    ``snippets``, ``cluster``, ``motiflets``, ``query`` (``i:j``, ``-o``)
    and ``abjoin --mpdist`` command lines on data/binary/16384.tsb (its
    halves or quarters where a command takes several series), each
    printed value and file equal to the API's result on the card."""
    from mpx_torch import MatrixProfileConfig, compute_ab_join, compute_matrix_profile
    from mpx_torch.analysis import (apply_annotation_vector, complexity_annotation, match,
                                    mpdist_from_profiles, regimes, top_discords, top_motifs,
                                    unanchored_chain)
    from mpx_torch.chains import all_chains, compute_chains
    from mpx_torch.cluster import cluster_series
    from mpx_torch.contrast import contrast_profile, top_contrast_motifs
    from mpx_torch.io.tsb import read_binary, read_series, write_binary, write_results
    from mpx_torch.motiflets import k_motiflets
    from mpx_torch.ostinato import ostinato
    from mpx_torch.snippets import snippets

    src = os.path.join(REPO, "data", "binary", "16384.tsb")
    T, m = read_series(src), 64
    cfg = MatrixProfileConfig(m=m, device="cuda")
    out = {}

    def lines(printed, prefix="  "):
        return [ln for ln in printed.splitlines() if ln.startswith(prefix)]

    def check(name, printed, want, prefix="  "):
        require(lines(printed, prefix) == want,
                f"{name}: the command's lines differ from the API's:\n{printed}\n{want}")

    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "out")
        halves = [T[: T.shape[0] // 2], T[T.shape[0] // 2 :]]
        quarters = list(T.reshape(4, -1))
        paths = []
        for i, X in enumerate(halves + quarters):
            paths.append(os.path.join(tmp, f"s{i}.tsb"))
            write_binary(paths[-1], X)
        hp, qp = paths[:2], paths[2:]

        t0 = time.perf_counter()
        printed = run_cli("analyze", "-i", src, "-m", str(m), "--regimes", "2", "--chain",
                          "--av", "complexity")
        MPl, MPIl, MPr, MPIr = (o.cpu().numpy() for o in
                                compute_matrix_profile(T, config=cfg, left_right=True))
        lw = MPl <= MPr
        MP, MPI = np.where(lw, MPl, MPr), np.where(lw, MPIl, MPIr)
        AV = complexity_annotation(T, m)
        want = [f"  {x.a:8d} {x.b:8d} {(MP[x.a] if MPI[x.a] == x.b else MP[x.b]):.6f}"
                for x in top_motifs(apply_annotation_vector(MP, AV, "motif"), MPI, m)]
        want += [f"  {d.index:8d} {MP[d.index]:.6f}"
                 for d in top_discords(apply_annotation_vector(MP, AV, "discord"), MPI, m)]
        want += [f"  {r:8d}" for r in regimes(MPI, m, k=2)]
        want += ["  " + " -> ".join(str(int(c)) for c in unanchored_chain(MPIl, MPIr))]
        check("analyze", printed, want)
        MPs, MPIs = (o.cpu().numpy() for o in compute_matrix_profile(T, config=cfg))
        write_results(base, MPs, MPIs)
        printed = run_cli("analyze", "-i", base, "-m", str(m))
        want = [f"  {x.a:8d} {x.b:8d} {(MPs[x.a] if MPIs[x.a] == x.b else MPs[x.b]):.6f}"
                for x in top_motifs(MPs, MPIs, m)]
        want += [f"  {d.index:8d} {MPs[d.index]:.6f}" for d in top_discords(MPs, MPIs, m)]
        check("analyze (saved results)", printed, want)
        out["analyze"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        printed = run_cli("chains", "-i", src, "-m", str(m), "--all")
        res = compute_chains(T, cfg)
        want = [f"chain (longest unanchored): length {res.length}",
                "  " + " -> ".join(str(int(i)) for i in res.chain)]
        want += [f"chain {k}: length {len(c)}: " + " -> ".join(str(int(i)) for i in c)
                 for k, c in enumerate(all_chains(res.mpi_left, res.mpi_right))]
        require(printed.splitlines() == want, f"chains differ from compute_chains:\n{printed}")
        out["chains"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        printed = run_cli("contrast", "-p", hp[0], "-n", hp[1], "-m", str(m), "-o", base)
        ccfg = MatrixProfileConfig(m=m, band=4096, chunk=4096, device="cuda")
        cres = contrast_profile(*halves, config=ccfg)
        require(np.array_equal(np.load(base + ".cp.npy"), cres.cp),
                "contrast's file differs from contrast_profile")
        check("contrast", printed,
              [f"contrast motif @ {x.index}  (in-class neighbor {x.neighbor})  "
               f"score {x.score:.4f}" for x in top_contrast_motifs(cres, m)], "contrast ")
        out["contrast"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        printed = run_cli("ostinato", "-m", str(m), *sum((["-i", p] for p in qp), []))
        res = ostinato(quarters, config=cfg)
        check("ostinato", printed, [f"consensus motif: series {res.series} ({qp[res.series]}) "
                                    f"@ {res.index}, radius {res.radius:.6f}"], "consensus")
        out["ostinato"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        printed = run_cli("snippets", "-i", src, "-L", "1024", "-k", "2")
        res = snippets(T, 1024, k=2, config=MatrixProfileConfig(m=512, device="cuda"))
        check("snippets", printed, [f"  {s.start:8d} {s.length:6d} {s.fraction:.3f}"
                                    for s in res])
        out["snippets"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        printed = run_cli("cluster", "-m", str(m), *sum((["-i", p] for p in qp), []))
        res = cluster_series(quarters, n_clusters=2, config=cfg)
        want = ["  " + " ".join(f"{d:8.4f}" for d in row) for row in res.distances]
        want += [f"cluster {c.label}: medoid {qp[c.medoid]} radius {c.radius:.4f} :: "
                 + ", ".join(qp[i] for i in c.members) for c in res.clusters]
        require(lines(printed) + lines(printed, "cluster ") == want,
                f"cluster differs from cluster_series:\n{printed}")
        out["cluster"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        printed = run_cli("motiflets", "-i", src, "-m", str(m), "-k", "3")
        res = k_motiflets(T, 3, config=cfg)
        check("motiflets", printed, [f"  occurrences: {' '.join(str(int(i)) for i in res.indices)}"])
        require(f"3-motiflet: extent {res.extent:.6f}" in printed, printed)
        out["motiflets"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        printed = run_cli("query", "-i", src, "-q", "1000:1064", "-k", "3", "-o", base)
        ms, D = match(T[1000:1064], T, max_matches=3, return_profile=True)
        require(np.array_equal(read_binary(base + ".mpb", "double"), D),
                "query's file differs from match's profile")
        check("query", printed, [f"match @ {r.index}  distance {r.distance:.6f}" for r in ms],
              "match ")
        out["query"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        printed = run_cli("abjoin", "-a", hp[0], "-b", hp[1], "-m", str(m), "--mpdist",
                          "-o", base)
        ab = [o.cpu().numpy() for o in compute_ab_join(*halves, config=ccfg)]
        d = mpdist_from_profiles(ab[0], ab[2], halves[0].shape[0], halves[1].shape[0])
        check("abjoin --mpdist", printed, [f"MPdist: {d:.6f}"], "MPdist")
        out["abjoin_mpdist"] = time.perf_counter() - t0
    say("42 slice-11 commands", card=torch.cuda.get_device_name(0),
        input="data/binary/16384.tsb", seconds=out)


K1_ACCURACY_MS = (256, 512, 1024, 2048, 4096)


def k1_accuracy_series(m: int):
    """A walk of 16384 + m - 1 samples (one job of S = 4096 rows against
    all W = 16384 windows) with noisy copies (noise 0.05 of the segment's
    spread) of segments of the job's rows planted among the later columns,
    and one exact copy; returns the series, the sources and the exact
    copy's source row."""
    n, rng = 16384 + m - 1, np.random.default_rng(SEED + m)
    T = np.cumsum(rng.standard_normal(n))
    copies = max(2, min(16, (n - 8192) // m - 1))
    src = np.sort(rng.choice(4096 - m // 4, copies, replace=False))
    for k, s in enumerate(src):
        seg = T[s : s + m]
        at = 8192 + k * m
        noise = 0.0 if k == 0 else 0.05 * seg.std()
        T[at : at + m] = seg - seg[0] + T[at] + noise * rng.standard_normal(m)
    return T, src, int(src[0])


def phase_k1_accuracy(torch) -> dict:
    """K1 f32 (``sweep_band_mxu_fused``) through one job of 4096 x 16384
    at m = 256 .. 4096 on :func:`k1_accuracy_series`: the largest |d - d
    exact| over 64 sampled rows (the planted sources and random rows)
    against the exact f64 right-side row scan (``hybrid._row_scan``),
    leaving out self-matches (exact d < 1e-3); the plain sweep's reading
    on the same rows, and both sweeps' distance at the exact copy."""
    from mpx_torch.hybrid import _row_scan
    from mpx_torch.kernels.common import band_geometry
    from mpx_torch.kernels.mxu import sweep_band_mxu
    from mpx_torch.kernels.mxu_fused import sweep_band_mxu_fused
    from mpx_torch.ops.precompute import precompute_statistics

    S, W, out = 4096, 16384, {}
    for m in K1_ACCURACY_MS:
        T, src, twin = k1_accuracy_series(m)
        w = T.shape[0] - m + 1
        rng = np.random.default_rng(SEED + m + 1)
        rows = np.unique(np.concatenate([src, rng.choice(S - m // 4, 64 - src.size,
                                                         replace=False)]))
        stats = precompute_statistics(T, m, band=S, chunk=W, dtype="float32", device="cuda")
        ex = precompute_statistics(T, m, band=S, chunk=W, dtype="float64", device="cuda",
                                   windows=False)
        geom = band_geometry(S, W, m, w)
        bestP, _ = _row_scan(ex.T, ex.mu[:w], ex.inv[:w], m, w, m // 4, rows, side=+1)
        exact = torch.sqrt(torch.clamp(2.0 * m * (1.0 - bestP), min=0.0)).cpu().numpy()
        reading = {}
        for name, sweep in (("k1", sweep_band_mxu_fused), ("plain", sweep_band_mxu)):
            P = sweep(stats, 0, 0, geom, "float32").row.value.double()
            d = torch.sqrt(torch.clamp(2.0 * m * (1.0 - P), min=0.0)).cpu().numpy()
            far = exact >= 1e-3
            reading[name] = float(np.abs(d[rows] - exact)[far].max())
            reading[f"{name}_self_match_d"] = float(d[twin])
        del stats, ex
        out[m] = reading
    return out


# Phase 43's readings of K1 with the single f32 accumulation chain that the
# per-slab promotion replaced (the parent commit's kernel, measured by
# scripts/torch_k1_accum.py on an NVIDIA H100 80GB HBM3 at 700 W): the
# largest |d - d exact| over the sampled rows, and the exact copy's d.
K1_SINGLE_CHAIN = {256: (1.164e-3, 0.0354), 512: (3.512e-3, 0.0558),
                   1024: (6.968e-3, 0.1424), 2048: (2.082e-2, 0.2679),
                   4096: (1.051e-1, 0.5154)}


def phase_k1_accuracy_gate(torch):
    """Phase 43: :func:`phase_k1_accuracy`, gated at 2e-3 at every m."""
    got = phase_k1_accuracy(torch)
    for m, r in got.items():
        require(r["k1"] <= DIST_TOL["float32"],
                f"K1 f32 at m={m}: {r['k1']} from the exact scan (tol 2e-3)")
    say("43 K1 f32 accuracy by m", card=torch.cuda.get_device_name(0), job="4096 x 16384",
        rows=64, readings=got, tol=DIST_TOL["float32"],
        single_chain_before_repair={m: {"k1": v[0], "k1_self_match_d": v[1]}
                                    for m, v in K1_SINGLE_CHAIN.items()})


def virtual_mesh(torch, k: int) -> tuple:
    """``k`` virtual shards of the one card."""
    return (torch.device("cuda", 0),) * k


def phase_job_shards(torch) -> dict:
    """Phase 44: job sharding over 4 virtual shards of cuda:0 at n = 2^18,
    m = 256, band 4096, chunk 16384: f32 through K1 and f64 through K3
    (``kernel='pallas'``), each against the single-device run (values
    bit-equal, indices equal or equidistant), wall times of both.  Returns
    the sharded runs' launches."""
    from mpx_torch import MatrixProfileConfig, compute_matrix_profile, make_job_grid
    from mpx_torch.ops.aggregates import postcompute
    from mpx_torch.ops.precompute import precompute_statistics
    from mpx_torch.parallel.sharding import run_jobs_sharded

    n, m, S, W = 1 << 18, 256, 4096, 16384
    T = random_walk(n, SEED + 44)
    w = n - m + 1
    out, launches = {}, {}
    for dtype, kernel, counter in (("float32", "mxu_fused", "k1"), ("float64", "pallas", "k3")):
        cfg = MatrixProfileConfig(m=m, dtype=dtype, kernel=kernel, band=S, chunk=W,
                                  device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        MP1, MPI1 = (o.cpu().numpy() for o in compute_matrix_profile(T, config=cfg))
        wall1 = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        stats = precompute_statistics(T, m, band=S, chunk=W, dtype=dtype, device="cuda",
                                      windows=counter == "k1", exact_mean=counter == "k3")
        rows, cols = run_jobs_sharded(stats, make_job_grid(w, S, W), num_shards=4, S=S, W=W,
                                      m=m, w=w, kernel=kernel, dtype=dtype,
                                      mesh=virtual_mesh(torch, 4))
        MP4, MPI4 = (o.cpu().numpy() for o in postcompute(rows, cols, m, w))
        wall4 = time.perf_counter() - t0
        launches[counter] = require_only(counts(), counter, f"4 virtual shards {dtype}",
                                         launches=len(make_job_grid(w, S, W).r0))
        require(np.array_equal(MP1, MP4), f"sharded {dtype} values differ from one device")
        check_profiles_agree(T, m, MP4, MPI4, MP1, MPI1, DIST_TOL[dtype])
        out[dtype] = {"kernel": kernel, "launches": launches[counter], "wall_s_d1": wall1,
                      "wall_s_d4": wall4, "values_bit_equal": True,
                      "index_differences": int((MPI1 != MPI4).sum())}
    say("44 job shards x4 virtual", card=torch.cuda.get_device_name(0), n=n, m=m, band=S,
        chunk=W, mesh="4 x cuda:0", **out)
    return launches


def phase_ring_f32(torch) -> int:
    """Phase 45: ``ring-f32-1048576`` at the suite row's full shape (n =
    2^20, m = 256, f32, shards 1, band 4096, chunk 16384) through
    ``compute_matrix_profile``'s ring route (K1): wall, pairs/s, K1 launches, 64 sampled rows
    against the exact f64 scan; then a 4-virtual-shard ring at n = 2^18
    against the one-shard ring there (values bit-equal, indices equal or
    equidistant).  Returns the K1 launches of the full-shape run."""
    from mpx_torch import MatrixProfileConfig
    from mpx_torch.parallel.ring import run_ring_sharded

    n, m, S, W = 1 << 20, 256, 4096, 16384
    T = random_walk(n, SEED + 45)
    w = n - m + 1
    cfg = MatrixProfileConfig(m=m, dtype="float32", band=S, chunk=W, num_shards=1,
                              shard_mode="ring", device="cuda")
    reset_counts()
    MP, MPI, wall, phases, card = run_profile(torch, T, cfg)
    launches = require_only(counts(), "k1", "ring f32")
    rows = sample_rows(w, SEED + 45)
    err = check_rows(T, m, MP, MPI, rows, DIST_TOL["float32"],
                     D=row_scan64_card(torch, T, m, rows))
    T18 = T[: 1 << 18]
    one = [o.cpu().numpy() for o in run_ring_sharded(T18, m, num_shards=1, band=S, chunk=W,
                                                     device="cuda")]
    t0 = time.perf_counter()
    four = [o.cpu().numpy() for o in run_ring_sharded(T18, m, num_shards=4, band=S, chunk=W,
                                                      mesh=virtual_mesh(torch, 4))]
    wall4 = time.perf_counter() - t0
    require(np.array_equal(one[0], four[0]), "4-shard ring values differ from 1 shard")
    check_profiles_agree(T18, m, four[0], four[1], one[0], one[1], DIST_TOL["float32"])
    say("45 ring f32 (ring-f32-1048576)", card=torch.cuda.get_device_name(0), n=n, m=m,
        band=S, chunk=W, shards=1, wall_s=wall, pairs_per_s=w * (w - 1) / 2 / wall,
        k1_launches=launches, phases_s=phases, card_clock_power=card,
        max_err_64_rows=err, tol=DIST_TOL["float32"],
        virtual_ring_n=T18.shape[0], virtual_ring_d4_wall_s=wall4,
        virtual_ring_values_bit_equal=True,
        virtual_ring_index_differences=int((one[1] != four[1]).sum()))
    return launches


def phase_ring_f64(torch) -> int:
    """Phase 46: ``ring-f64-1048576`` at the suite row's full shape (n =
    2^20, m = 256, f64, shards 1, band 4096, chunk 16384) through
    ``compute_matrix_profile``'s ring route (the ring hybrid: K1's f32 launch in pass A): wall,
    the pass A / B / C split and counts, 64 rows against the exact f64
    scan.  Returns the K1 f32 launches."""
    from mpx_torch import MatrixProfileConfig
    from mpx_torch.utils.profile import BenchmarkProfile

    n, m, S, W = 1 << 20, 256, 4096, 16384
    T = random_walk(n, SEED + 46)
    w = n - m + 1
    cfg = MatrixProfileConfig(m=m, dtype="float64", band=S, chunk=W, num_shards=1,
                              shard_mode="ring", device="cuda")
    prof = BenchmarkProfile()
    reset_counts()
    MP, MPI, wall, phases, card = run_profile(torch, T, cfg, prof)
    c = counts()
    require(c["k1"] > 0 and not c["k3"] and not c["xla"],
            f"ring hybrid: counts {c}, expected K1 (pass A) and plain passes B/C only")
    rows = sample_rows(w, SEED + 46)
    err = check_rows(T, m, MP, MPI, rows, DIST_TOL["float64"],
                     D=row_scan64_card(torch, T, m, rows))
    say("46 ring f64 hybrid (ring-f64-1048576)", card=torch.cuda.get_device_name(0), n=n,
        m=m, band=S, chunk=W, shards=1, wall_s=wall, pairs_per_s=w * (w - 1) / 2 / wall,
        k1_f32_launches=c["k1"], plain_calls=c["mxu"], phases_s=phases,
        counts=dict(prof.counts), card_clock_power=card, max_err_64_rows=err,
        tol=DIST_TOL["float64"])
    return c["k1"]


def phase_process_group(torch) -> int:
    """Phase 47: ``distributed_matrix_profile`` inside a one-rank NCCL group
    that the phase opens and closes (n = 2^18, m = 256, f32 through K1,
    band 4096, chunk 16384), equal to the single-device run; ``compute
    --shards 1 --shard-mode ring`` and ``batch --shards 1`` on
    data/binary/16384.tsb, each file equal to the API's.  Returns the
    group run's K1 launches."""
    import socket

    import torch.distributed as dist

    from mpx_torch import MatrixProfileConfig, compute_batch_profiles, compute_matrix_profile
    from mpx_torch.io.tsb import read_binary, read_series
    from mpx_torch.parallel import distributed

    n, m, S, W = 1 << 18, 256, 4096, 16384
    T = random_walk(n, SEED + 47)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    import datetime

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=120),
                            device_id=torch.device("cuda", 0))
    try:
        reset_counts()
        t0 = time.perf_counter()
        MPd, MPId = distributed.distributed_matrix_profile(
            T, m, dtype="float32", kernel="auto", band=S, chunk=W, device="cuda")
        wall = time.perf_counter() - t0
        launches = require_only(counts(), "k1", "one-rank group")
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    cfg = MatrixProfileConfig(m=m, dtype="float32", band=S, chunk=W, device="cuda")
    MP1, MPI1 = (o.cpu().numpy() for o in compute_matrix_profile(T, config=cfg))
    require(np.array_equal(MPd, MP1), "the group's profile differs from one device's")
    check_profiles_agree(T, m, MPd, MPId, MP1, MPI1, DIST_TOL["float32"])
    src = os.path.join(REPO, "data", "binary", "16384.tsb")
    Tc = read_series(src)
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "out")
        run_cli("compute", "-i", src, "-m", "256", "--shards", "1", "--shard-mode", "ring",
                "-o", base)
        ring = [o.cpu().numpy() for o in compute_matrix_profile(Tc, config=MatrixProfileConfig(
            m=256, num_shards=1, shard_mode="ring", device="cuda"))]
        require(np.array_equal(read_binary(base + ".mpb", "double"), ring[0].astype(np.float64))
                and np.array_equal(read_binary(base + ".mpib", "int"), ring[1]),
                "compute --shard-mode ring's files differ from the API's")
        run_cli("batch", "-i", src, "-m", "64", "--shards", "1", "-o", base)
        MPb, MPIb = compute_batch_profiles(Tc[None], config=MatrixProfileConfig(
            m=64, num_shards=1, device="cuda"))
        require(np.array_equal(read_binary(base + ".16384.mpb", "double"),
                               MPb[0].astype(np.float64))
                and np.array_equal(read_binary(base + ".16384.mpib", "int"), MPIb[0]),
                "batch --shards 1's files differ from the API's")
    say("47 process group and command lines", card=torch.cuda.get_device_name(0), n=n, m=m,
        backend=backend, world_size=1, wall_s=wall, k1_launches=launches,
        equal_to_one_device=True, commands=["compute --shards 1 --shard-mode ring",
                                            "batch --shards 1"],
        two_rank_nccl="not measured: NCCL refuses two ranks on one card")
    return launches


# ---------------------------------------------------------------- slice 13
def start_version_banner():
    """``python -m mpx_torch --version`` started as a subprocess (its import
    overlaps phases 46-47; phase 48 collects it)."""
    return time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "mpx_torch", "--version"], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def phase_runtime_version(torch, banner_proc):
    """``DeviceContext`` on the card (a staged f64 product, ``finish``,
    the round trip) and the ``--version`` subprocess's lines."""
    from mpx_torch.runtime import DeviceContext, devices

    x = np.random.default_rng(SEED + 48).standard_normal((4096, 4096))
    ctx = DeviceContext("cuda")
    d = ctx.to_device(x)
    y = d @ d
    ns = ctx.finish(y)
    require(ns > 0 and ctx._pending == [] and ctx.platform == "gpu",
            f"DeviceContext.finish: {ns} ns, pending {len(ctx._pending)}, {ctx.platform}")
    require(np.array_equal(ctx.to_host(d), x), "DeviceContext round trip changed the values")
    require(devices() == [torch.device("cuda", i) for i in range(torch.cuda.device_count())],
            f"devices(): {devices()}")
    stats = ctx.memory_stats()
    t0, proc = banner_proc
    out, err = proc.communicate(timeout=120)
    version_s = time.perf_counter() - t0
    banner = out.splitlines()
    require(proc.returncode == 0 and banner[0].startswith("mpx_torch ")
            and torch.cuda.get_device_name(0) in banner[2]
            and "kernel library (K1, K3, stats): built" in banner[3]
            and banner[4] == "  native host library: built"
            and banner[5] == "  statistics backend (auto): device", f"--version: {out}{err}")
    say("48 runtime, --version", finish_ns=ns, devices=[str(x) for x in devices()],
        allocated_bytes=stats["allocated_bytes.all.current"], version_lines=banner,
        version_subprocess_s=version_s)


# The server's K1/K3 counts as ``counts()`` takes them, printed on its
# standard error when it exits (the counters live in the server's process).
_SERVE_WRAPPER = (
    "import atexit, json, runpy, sys\n"
    "from mpx_torch.utils.profile import counters\n"
    "atexit.register(lambda: print('COUNTS ' + json.dumps({k: counters()[c] for k, c in ("
    "('k1', 'launches.k1'), ('mxu', 'calls.mxu'), ('k3', 'jobs.k3'), "
    "('xla', 'calls.xla'))}), file=sys.stderr, flush=True))\n"
    "sys.argv = ['mpx_torch', 'serve', *sys.argv[1:]]\n"
    "runpy.run_module('mpx_torch', run_name='__main__', alter_sys=True)\n"
)


class ServeProcess:
    """``python -m mpx_torch serve ARGS`` in a subprocess on the card (run
    through a wrapper that prints its kernel counts at exit); ``call``
    writes one request line and reads one response line, timed.  The
    process is stopped on exit."""

    def __init__(self, *args):
        self.err = tempfile.TemporaryFile(mode="w+")
        self.proc = subprocess.Popen([sys.executable, "-c", _SERVE_WRAPPER, *args], cwd=REPO,
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                     stderr=self.err, text=True)

    def __enter__(self):
        return self

    def call(self, line: str):
        t0 = time.perf_counter()
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()
        out = self.proc.stdout.readline()
        dt = time.perf_counter() - t0
        require(out, f"the server closed its output: {self.stderr()[-2000:]}")
        return json.loads(out), dt

    def stderr(self) -> str:
        self.err.seek(0)
        return self.err.read()

    def counts(self, timeout: float = 120) -> dict:
        """Wait for the server to exit and return its kernel counts."""
        require(self.proc.wait(timeout=timeout) == 0,
                f"the server exited {self.proc.returncode}: {self.stderr()[-2000:]}")
        lines = [ln for ln in self.stderr().splitlines() if ln.startswith("COUNTS ")]
        require(len(lines) == 1, f"no counts from the server: {self.stderr()[-2000:]}")
        return json.loads(lines[0][len("COUNTS "):])

    def __exit__(self, *exc):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.err.close()
        return False


def direct(torch, fn):
    """``fn()`` in this process: its result, wall seconds (ending in a
    synchronize) and K1/K3 counts."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, counts()


def start_servers(stack) -> tuple:
    """Phase 49's servers, ``python -m mpx_torch serve`` on the card over a
    pipe and over TCP (``--port 0 --ready-file``), started ahead of the
    phase (their imports overlap phases 46-47); ``stack`` (an ExitStack)
    stops them.  Returns (pipe server, TCP server, ready file)."""
    tmp = stack.enter_context(tempfile.TemporaryDirectory())
    ready = os.path.join(tmp, "addr")
    return (stack.enter_context(ServeProcess()),
            stack.enter_context(ServeProcess("--port", "0", "--ready-file", ready,
                                             "--idle-timeout", "30")), ready)


def phase_serve(torch, p4: dict, p33: dict, servers: tuple) -> dict:
    """``python -m mpx_torch serve`` on the card: the pipe server and the
    TCP server of :func:`start_servers`.  Over the pipe:
    ``ping``; ``compute`` on phase 4's n=2^20 f32 walk (m=256, band 4096,
    chunk 32768, the showcase shape) twice, each bit-equal to phase 4's
    ``compute_matrix_profile`` of the same config in this process, with
    the client's latency (line written to line read) beside phase 4's wall;
    ``compute`` in f64 at n=2^17, bit-equal to a direct call and 64 rows
    against the exact scan; stream sessions in ``full``, ``floss`` and
    ``damp`` mode at ``streaming-f32-262144``'s shape (n=2^18, m=256, 50
    appends of 64; the suite runner's walk): the ``full`` session's
    ``stream.profile`` against phase 33's ``StreamingMatrixProfile`` after
    the same appends (within 2e-3, indices equal or equidistant; whether
    bit-equal is reported), FLOSS's score in [0, 1] and its regime inside
    the stream, DAMP's alerts scored; a malformed line and an unknown op
    answered with errors and the loop alive.  Over TCP: a ``compute`` at
    n=2^14 equal to the direct call, a client reset mid-session, and
    ``shutdown`` from a second connection.  Each server's K1 launches
    (printed at its exit) equal those of the same work in this process
    (phase 4's run a request, phase 33's bootstrap a session), and so do
    its K3 launches (the f64 request's, through ``auto`` at m = 256).
    Returns the served K1 launches by dtype and the K3 launches."""
    import socket
    import struct

    from mpx_torch import MatrixProfileConfig, compute_matrix_profile

    m = 256
    expect = {"float32": 0, "float64": 0}
    k3 = 0
    latency = {}
    T17 = random_walk(1 << 17, SEED + 50)
    T14 = random_walk(1 << 14, SEED + 52)
    n, app, rounds = 1 << 18, 64, 50
    Ts = np.cumsum(np.random.default_rng(0).standard_normal(n + app * rounds))
    srv, tcp, ready = servers
    # every request line encoded before the first is sent
    line20 = json.dumps({"op": "compute", "series": p4["T"].tolist(), "m": m,
                         "dtype": "float32", "band": p4["band"], "chunk": p4["chunk"]})
    line17 = json.dumps({"op": "compute", "series": T17.tolist(), "m": m, "dtype": "float64",
                         "band": 4096, "chunk": 32768})
    modes = ("full", "floss", "damp")
    creates = {mode: json.dumps({"op": "stream.create", "sid": mode, "series": Ts[:n].tolist(),
                                 "m": m, "mode": mode}) for mode in modes}
    appends = {mode: [json.dumps({"op": "stream.append", "sid": mode,
                                  "points": Ts[o : o + app].tolist()})
                      for o in range(n, n + app * rounds, app)] for mode in modes}
    t0 = time.perf_counter()
    cfg17 = MatrixProfileConfig(m=m, dtype="float64", band=4096, chunk=32768, device="cuda")
    (MP17, MPI17), wall17, c17 = direct(torch, lambda: compute_matrix_profile(T17,
                                                                              config=cfg17))
    require_only(c17, auto_counter("float64", m), "compute f64 n=2^17 (direct)")
    cfg14 = MatrixProfileConfig(m=64, device="cuda")
    (MP14, MPI14), _, c14 = direct(torch, lambda: compute_matrix_profile(T14, config=cfg14))
    require_only(c14, "k1", "compute f32 n=2^14 (direct)")
    ping, ping_s = srv.call(json.dumps({"op": "ping", "id": 0}))
    require(ping == {"ok": True, "devices": torch.cuda.device_count(), "streams": [],
                     "id": 0}, f"ping: {ping}")

    def served(label, line, T, dtype, MP, MPI, wall, c):
        """``c``: the direct call's counts."""
        nonlocal k3
        resp, dt = srv.call(line)
        require("error" not in resp, f"{label}: {resp}")
        require(np.array_equal(np.asarray(resp["mp"], np.float64), MP.astype(np.float64))
                and np.array_equal(np.asarray(resp["mpi"], np.int64), MPI),
                f"{label}: the served profile is not bit-equal to the direct call")
        expect[dtype] += c["k1"]
        k3 += c["k3"]
        latency[label] = {"n": T.shape[0], "dtype": dtype, "served_s": dt,
                          "direct_s": wall, "json_and_pipe_s": dt - wall,
                          "request_bytes": len(line), "k1_launches": c["k1"],
                          "k3_launches": c["k3"]}

    for i in (1, 2):
        served(f"compute f32 n=2^20 #{i}", line20, p4["T"], "float32", p4["MP"],
               p4["MPI"], p4["wall_s"], {"k1": p4["launches"], "k3": 0})
    MP17, MPI17 = MP17.cpu().numpy(), MPI17.cpu().numpy()
    served("compute f64 n=2^17", line17, T17, "float64", MP17, MPI17, wall17, c17)
    rows = sample_rows(T17.shape[0] - m + 1, SEED + 50)
    err17 = check_rows(T17, m, MP17, MPI17, rows, DIST_TOL["float64"],
                       D=row_scan64_card(torch, T17, m, rows))

    streams = {}
    for mode in modes:
        resp, create_s = srv.call(creates[mode])
        require(resp == {"ok": True}, f"stream.create {mode}: {resp}")
        expect["float32"] += p33["float32"]  # the bootstrap phase 33 made
        answers, times = [], []
        for o, line in zip(range(n, n + app * rounds, app), appends[mode]):
            resp, dt = srv.call(line)
            # a FLOSS window trims its head at twice its length
            require(resp.get("n") == o + app or mode == "floss" and 0 < resp["n"] < o + app,
                    f"stream {mode} append at {o}: {resp}")
            answers.append(resp)
            times.append(dt)
        prof, prof_s = srv.call(json.dumps({"op": "stream.profile", "sid": mode}))
        MP, MPI = np.asarray(prof["mp"], np.float64), np.asarray(prof["mpi"], np.int64)
        live = MPI >= 0
        require(MP.shape == (answers[-1]["n"] - m + 1,) and np.isfinite(MP[live]).all(),
                f"stream {mode}: profile {MP.shape}")
        info = {"create_s": create_s, "served_append_ms": float(np.mean(times)) * 1e3,
                "served_append_ms_median": float(np.median(times)) * 1e3,
                "profile_s": prof_s}
        if mode == "full":
            MP33, MPI33 = p33["profile"]
            info["max_err_vs_phase_33"] = check_profiles_agree(
                Ts, m, MP, MPI, MP33, MPI33, DIST_TOL["float32"])
            info["bit_equal_to_phase_33"] = bool(
                np.array_equal(MP, MP33.astype(np.float64)) and np.array_equal(MPI, MPI33))
        elif mode == "floss":
            last = answers[-1]
            require(all(0.0 <= a["score"] <= 1.0 for a in answers)
                    and all(0 <= r < Ts.shape[0] for r in last["regimes"]),
                    f"stream floss: {last}")
            info.update(score=last["score"], regimes=last["regimes"])
        else:
            alerts = [a for r in answers for a in r["alerts"]]
            require(all(np.isfinite(a["distance"]) and n - m < a["index"] < Ts.shape[0]
                        for a in alerts), f"stream damp alerts {alerts[:3]}")
            info.update(alerts=len(alerts), discord=answers[-1].get("discord"))
        streams[mode] = info
    bad, _ = srv.call("{not json")
    unknown, _ = srv.call(json.dumps({"op": "nope", "id": "u"}))
    alive, _ = srv.call(json.dumps({"op": "ping"}))
    require(bad["error"].startswith("JSONDecodeError: ")
            and unknown == {"error": "ValueError: unknown op 'nope'", "id": "u"}
            and alive["streams"] == sorted(modes),
            f"bad lines: {bad}, {unknown}, then {alive}")
    bye, _ = srv.call(json.dumps({"op": "shutdown"}))
    require(bye == {"ok": True}, f"shutdown: {bye}")
    session_s = time.perf_counter() - t0

    for _ in range(1200):
        if os.path.exists(ready) and open(ready).read().endswith("\n"):
            break
        require(tcp.proc.poll() is None, f"the TCP server exited: {tcp.stderr()[-2000:]}")
        time.sleep(0.05)
    host, port = open(ready).read().strip().split(":")
    with socket.create_connection((host, int(port)), timeout=300) as c1:
        f1 = c1.makefile("rw", encoding="utf-8")
        t1 = time.perf_counter()
        f1.write(json.dumps({"op": "compute", "series": T14.tolist(), "m": 64}) + "\n")
        f1.flush()
        resp = json.loads(f1.readline())
        tcp_s = time.perf_counter() - t1
        require(np.array_equal(np.asarray(resp["mp"]), MP14.cpu().numpy().astype(np.float64))
                and np.array_equal(np.asarray(resp["mpi"]), MPI14.cpu().numpy()),
                "TCP compute differs from the direct call")
        f1.write(json.dumps({"op": "ping"}) + "\n")
        f1.flush()
        # reset the connection without reading the response
        c1.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
        f1.close()
    with socket.create_connection((host, int(port)), timeout=60) as c2:
        f2 = c2.makefile("rw", encoding="utf-8")
        answers = []
        for req in ({"op": "ping"}, {"op": "shutdown"}):
            f2.write(json.dumps(req) + "\n")
            f2.flush()
            answers.append(json.loads(f2.readline()))
    require(answers[0]["ok"] and answers[1] == {"ok": True}, f"after the drop: {answers}")
    c = srv.counts()
    ct = tcp.counts()
    require("dropped" in tcp.stderr(), f"TCP server stderr {tcp.stderr()[-500:]}")
    total = expect["float32"] + expect["float64"]
    require(c["k1"] == total and c["k3"] == k3 and not (c["mxu"] or c["xla"]),
            f"the server's counts {c}, expected K1 x{total} and K3 x{k3}")
    require(ct["k1"] == c14["k1"] and not (ct["mxu"] or ct["k3"] or ct["xla"]),
            f"TCP server counts {ct} (direct {c14})")
    expect["float32"] += ct["k1"]
    say("49 serve", card=torch.cuda.get_device_name(0), ping_s=ping_s, requests=latency,
        f64_max_err_64_rows=err17, tol=DIST_TOL["float64"],
        streams={"n": n, "m": m, "appends": rounds, "append": app, **streams},
        bad_lines={"malformed": bad, "unknown_op": unknown}, session_s=session_s,
        server_counts=c, tcp={"n": 1 << 14, "m": 64, "compute_s": tcp_s,
                              "k1_launches": ct["k1"], "client_reset": "survived"},
        k1_launches=expect, k3_launches=k3)
    return {**expect, "k3": k3}


SUITE_ROWS = ("vanilla-f32-8192", "tiled-f32-131072", "real-sudden-cardiac-death",
              "real-italian-power-f64", "streaming-f32-262144")


def phase_bench_suite(torch):
    """``python -m mpx_torch bench --suite --only ... --table --out`` as a
    subprocess on the card for the rows that take seconds: each row
    measured (no ``failed`` key), validated and carrying its provenance;
    the table printed."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "suite.json")
        args = ["bench", "--suite", "--table", "--out", out]
        for name in SUITE_ROWS:
            args += ["--only", name]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "mpx_torch", *args], cwd=REPO,
                              capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        require(proc.returncode == 0, f"bench --suite failed:\n{proc.stdout}{proc.stderr}")
        rows = json.load(open(out))
    require([r["name"] for r in rows] == list(SUITE_ROWS), f"suite rows {rows}")
    for r in rows:
        require("failed" not in r and r.get("validation"), f"suite row {r['name']}: {r}")
        require(r["provenance"]["device"].startswith(torch.cuda.get_device_name(0)),
                f"suite row {r['name']} provenance {r['provenance']}")
    table = [ln for ln in proc.stderr.splitlines() if ln.startswith("|")]
    require(len(table) == 2 + len(SUITE_ROWS), f"suite table: {proc.stderr[-2000:]}")
    say("50 bench --suite", rows={r["name"]: {k: r.get(k) for k in (
        "n", "m", "dtype", "wall_s", "append_ms", "pairs_per_sec", "vs_baseline",
        "validation")} for r in rows}, subprocess_s=wall)
    for ln in table:
        print(ln, flush=True)


# ---------------------------------------------------------------- slice 17
class TimedLines:
    """A stdout stand-in that keeps each line written with the script's
    clock reading when it was written."""

    def __init__(self):
        self.lines, self._part = [], ""

    def write(self, text: str) -> int:
        self._part += text
        *done, self._part = self._part.split("\n")
        self.lines += [(time.perf_counter(), ln) for ln in done]
        return len(text)

    def flush(self) -> None:
        pass


def phase_entry(torch) -> dict:
    """Phase 52: ``mpx_torch.entry()`` on the card (n = 1024, m = 32, band
    128, chunk 256, f32): its statistics (one window statistics launch),
    then one call of ``fn(*example_args)``, one K1 launch a job, against the
    same call of ``entry(device="cpu")`` (the plain sweep) after
    ``postcompute``: distances within 2e-3, indices equal or equidistant.
    Returns the launches."""
    from mpx_torch import entry
    from mpx_torch.ops.aggregates import postcompute

    n, m = 1024, 32
    w = n - m + 1
    reset_counts()
    t0 = time.perf_counter()
    fn, args = entry()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rows, cols = fn(*args)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    jobs = len(args[1].r0)
    launches = require_only(counts(), "k1", "entry()'s step", launches=jobs)
    st = stats_launches()
    require(st == 1 and args[1].r0.is_cuda and fn.keywords["kernel"] == "mxu_fused",
            f"entry(): {st} statistics launches, grid on {args[1].r0.device}, "
            f"kernel {fn.keywords['kernel']}")
    MP, MPI = (o.cpu().numpy() for o in postcompute(rows, cols, m, w))
    fc, ac = entry(device="cpu")
    MPc, MPIc = (o.numpy() for o in postcompute(*fc(*ac), m, w))
    T = np.cumsum(np.random.default_rng(0).standard_normal(n))
    err = check_profiles_agree(T, m, MP, MPI, MPc, MPIc, DIST_TOL["float32"])
    say("52 entry()", card=torch.cuda.get_device_name(0), n=n, m=m, band=128, chunk=256,
        kernel=fn.keywords["kernel"], jobs=jobs, k1_launches=launches, stats_launches=st,
        entry_s=t1 - t0, step_s=t2 - t1, max_err_vs_cpu_plain=err, tol=DIST_TOL["float32"],
        index_differences=int((MPI != MPIc).sum()))
    return {"k1": launches, "stats": st}


DRYRUN_OK = ("dryrun_multichip(4): OK", "dryrun ring(4): OK",
             "dryrun hybrid-f64 sharded(4): OK", "dryrun mstamp sharded(4): OK",
             "dryrun batch sharded(4): OK", "dryrun multiprocess(2x2): OK")


def phase_dryrun(torch) -> dict:
    """Phase 53: ``mpx_torch.dryrun_multichip(4)`` on the card: job shards,
    the ring, the f64 hybrid, mSTAMP and the fleet on four virtual shards
    of cuda:0 (K1 in all but mSTAMP's torch ops), then two processes of
    two virtual shards each in one Gloo group with their tensors on the
    card; every ``OK`` line printed, with the script's time since the
    previous line.  Returns this process's launches (the two processes'
    are their own)."""
    from mpx_torch import dryrun_multichip

    out = TimedLines()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        dryrun_multichip(4)
    wall = time.perf_counter() - t0
    c, st = counts(), stats_launches()
    require(c["k1"] > 0 and not c["k3"] and not c["xla"],
            f"dryrun_multichip: counts {c}, expected K1 and no K3")
    texts = [ln for _, ln in out.lines]
    for want in DRYRUN_OK:
        require(any(ln.startswith(want) for ln in texts),
                f"dryrun_multichip printed no '{want}' line: {texts}")
    prev, split = t0, []
    for when, ln in out.lines:
        print(ln, flush=True)
        split.append({"line": ln, "s": when - prev})
        prev = when
    say("53 dryrun_multichip(4)", card=torch.cuda.get_device_name(0),
        mesh="4 x cuda:0", processes="2 x 2 virtual shards, Gloo", wall_s=wall,
        k1_launches=c["k1"], plain_calls=c["mxu"], stats_launches=st, lines=split)
    return {"k1": c["k1"], "stats": st}


def phase_bench_line(torch, smi: str) -> dict:
    """Phase 54: ``python -m mpx_torch.bench_line``'s job at the showcase
    shape (f64, n = 2^20, m = 256, band 4096, chunk 32768, ``auto`` = K3; a
    warm-up run, a timed run, 64 rows against the exact oracle), through
    its ``main``: one JSON line with the root script's keys, the card's
    name and power limit those of nvidia-smi, ``vs_baseline`` the value
    over the roofline.  Returns the launches by counter."""
    import io

    from mpx_torch import make_job_grid
    from mpx_torch.bench import BASELINE_PAIRS_PER_SEC
    from mpx_torch.bench_line import SHOWCASE, main as bench_line_main

    out = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = bench_line_main([])
    wall = time.perf_counter() - t0
    w = SHOWCASE["n"] - SHOWCASE["m"] + 1
    jobs = len(make_job_grid(w, SHOWCASE["band"], SHOWCASE["chunk"]).r0)
    counter = auto_counter("float64", SHOWCASE["m"])
    launches = require_only(counts(), counter, "bench line", launches=2 * jobs)
    st = stats_launches()
    lines = out.getvalue().splitlines()
    require(rc == 0 and len(lines) == 1, f"bench line: rc {rc}, output {lines}")
    line = json.loads(lines[0])
    require({"metric", "value", "unit", "vs_baseline"} <= set(line)
            and line["value"] > 0 and line["unit"] == "pairs/s"
            and line["vs_baseline"] == line["value"] / BASELINE_PAIRS_PER_SEC
            and f"{line['device']}, {line['power_limit']}" == smi,
            f"bench line {line} (nvidia-smi: {smi})")
    print(lines[0], flush=True)
    say("54 bench line", card=torch.cuda.get_device_name(0), **{f"{counter}_launches": launches},
        stats_launches=st, subprocess=False, wall_s=wall, line=line)
    return {counter: launches, "stats": st}


def main() -> int:
    import torch

    t_start = time.perf_counter()
    smi = phase_device(torch)
    sys.path.insert(0, REPO)
    # Phase 17: the caller's TF32 setting survives every phase (the port
    # clears it only around its own float32 products).
    torch.backends.cuda.matmul.allow_tf32 = True
    tf32_after = []

    def tf32_kept(after: str):
        require(torch.backends.cuda.matmul.allow_tf32 is True,
                f"allow_tf32 was changed by phase {after}")
        tf32_after.append(after)

    phase_build()
    band = {dt: phase_band(torch, dt) for dt in ("float32", "float64")}
    tf32_kept("2")
    k1_profile = phase_e2e_f64(torch)
    tf32_kept("3")
    p4 = phase_e2e_f32(torch)
    launches = {"mxu_fused": {"float32": p4["launches"]}}
    tf32_kept("4")
    phase_cli()
    stats_times = phase_stats_backends(torch, p4["T"])
    tf32_kept("51")
    band_k3 = {dt: phase_band_k3(torch, dt) for dt in ("float32", "float64")}
    tf32_kept("6")
    k3_w32768 = {dt: band_k3[dt].pop("_w32768") for dt in band_k3}
    k3_launches, st7, k3_profile, k3_wall = phase_showcase(
        torch, "7 showcase f64 K3", "pallas", "k3", SEED + 2, k3_w32768["float64"])
    tf32_kept("7")
    launches["band_recurrence"] = {"float64": k3_launches,
                                   "float32": phase_parity(torch, k1_profile)}
    tf32_kept("8")
    phase_auto_large_m(torch)
    tf32_kept("9")
    launches["mxu_fused"]["float64"], st10, _, k1_wall = phase_showcase(
        torch, "10 showcase f64 K1", "mxu_fused", "k1", SEED + 4)
    launches["window_stats"] = {"float64": p4["stats_launches"] + st7 + st10}
    tf32_kept("10")
    phase_margin_probe(torch)
    tf32_kept("11")
    p12 = phase_showcase_hybrid(torch, k3_profile, k3_wall, k1_wall)
    tf32_kept("12")
    del k3_profile
    phase_tie_heavy(torch)
    tf32_kept("13")
    phase_left_right_hybrid(torch, p12)
    tf32_kept("14")
    del p12
    phase_width_gate(torch)
    tf32_kept("15")
    phase_surfaces(torch)
    tf32_kept("16")
    for dt in ("float32", "float64"):
        phase_ab_band(torch, dt, band[dt]["ms"])
    tf32_kept("18")
    p19 = phase_ab_e2e(torch)
    tf32_kept("19")
    phase_ab_hybrid(torch, p19)
    tf32_kept("20")
    for dt in ("float32", "float64"):
        launches["mxu_fused"][dt] += p19[dt]["launches"]
    del p19
    p21 = phase_topk(torch)
    tf32_kept("21")
    phase_thresh(torch)
    tf32_kept("22")
    phase_epilogue_cli(torch)
    tf32_kept("23")
    launches["mxu_fused"]["float32"] += phase_topk_hybrid(torch, p21)
    tf32_kept("24")
    del p21
    phase_topk_ties(torch)
    tf32_kept("25")
    phase_aamp(torch)
    tf32_kept("26")
    phase_pooled_matrix(torch)
    tf32_kept("27")
    phase_new_cli(torch)
    tf32_kept("28")
    phase_mstamp(torch)
    tf32_kept("29")
    p30 = phase_pan(torch)
    launches["mxu_fused"]["float64"] += p30["k1"]
    launches["band_recurrence"]["float64"] += p30["k3"]
    tf32_kept("30")
    launches["mxu_fused"]["float32"] += phase_merlin(torch)
    tf32_kept("31")
    phase_slice9_cli(torch)
    tf32_kept("32")
    p33 = phase_streaming(torch)
    launches["mxu_fused"]["float32"] += p33["float32"]
    launches[COUNTER_KERNEL[p33["float64_counter"]]]["float64"] += p33["float64"]
    tf32_kept("33")
    launches["mxu_fused"]["float32"] += phase_anytime(torch)
    tf32_kept("34")
    p35 = phase_checkpoint(torch)
    launches["band_recurrence"]["float64"] += p35["k3_float64"]
    launches["mxu_fused"]["float32"] += p35["k1_float32"]
    tf32_kept("35")
    launches["mxu_fused"]["float32"] += phase_batch(torch)
    tf32_kept("36")
    p37 = phase_masked(torch)
    launches["mxu_fused"]["float32"] += p37["k1"]
    launches["band_recurrence"]["float64"] += p37["k3"]
    tf32_kept("37")
    for counter, n1 in phase_damp(torch).items():
        launches[COUNTER_KERNEL[counter]]["float64"] += n1
    tf32_kept("38")
    phase_slice10_cli(torch)
    tf32_kept("39")
    for counter, n1 in phase_contrast(torch).items():
        launches[COUNTER_KERNEL[counter]]["float64"] += n1
    tf32_kept("40")
    for dt, n1 in phase_compositions(torch).items():
        launches["mxu_fused"][dt] += n1
    tf32_kept("41")
    phase_slice11_cli(torch)
    tf32_kept("42")
    phase_k1_accuracy_gate(torch)
    tf32_kept("43")
    p44 = phase_job_shards(torch)
    launches["mxu_fused"]["float32"] += p44["k1"]
    launches["band_recurrence"]["float64"] += p44["k3"]
    tf32_kept("44")
    launches["mxu_fused"]["float32"] += phase_ring_f32(torch)
    tf32_kept("45")
    with contextlib.ExitStack() as stack:
        # phase 49's servers and phase 48's --version start here: their
        # imports overlap phases 46-47
        servers = start_servers(stack)
        banner = start_version_banner()
        stack.callback(banner[1].kill)
        launches["mxu_fused"]["float32"] += phase_ring_f64(torch)
        tf32_kept("46")
        launches["mxu_fused"]["float32"] += phase_process_group(torch)
        tf32_kept("47")
        p49 = phase_serve(torch, p4, p33, servers)
        for dt in ("float32", "float64"):
            launches["mxu_fused"][dt] += p49[dt]
        launches["band_recurrence"]["float64"] += p49["k3"]
        tf32_kept("49")
        phase_runtime_version(torch, banner)
        tf32_kept("48")
    phase_bench_suite(torch)
    tf32_kept("50")
    p52 = phase_entry(torch)
    tf32_kept("52")
    p53 = phase_dryrun(torch)
    tf32_kept("53")
    p54 = phase_bench_line(torch, smi)
    tf32_kept("54")
    launches["mxu_fused"]["float32"] += p52["k1"] + p53["k1"]
    for counter, kernel in COUNTER_KERNEL.items():
        launches[kernel]["float64"] += p54.get(counter, 0)
    launches["window_stats"]["float64"] += p52["stats"] + p53["stats"] + p54["stats"]
    say("17 tf32", allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        unchanged_after_phases=tf32_after, script_s=time.perf_counter() - t_start)
    kernels = [
        {"name": f"{name}[{dt}]", "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name][dt], **times[dt]}
        for name, source, replaces, times in (
            ("mxu_fused", K1_SOURCE, K1_REPLACES, band),
            ("band_recurrence", K3_SOURCE, K3_REPLACES, band_k3))
        for dt in ("float32", "float64")
    ] + [{"name": "window_stats[float64]", "route": "cuda", "source": STATS_SOURCE,
          "replaces": STATS_REPLACES, "launches": launches["window_stats"]["float64"],
          **stats_times}]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
