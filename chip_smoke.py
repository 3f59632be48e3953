#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mpx_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line of findings (any failure raises, and the
script exits nonzero without the final line):

0. device: the card's name and power limit, torch and CUDA versions;
1. build: compile K1 and K3 (mpx_torch/csrc/*.cu, one nvcc over both) for
   sm_90a, with ptxas's registers and the count of tensor-core
   instructions (DMMA, HMMA) in each of K1's kernels, from
   ``cuobjdump -sass`` of the library, and the registers, spills and
   shared memory of K3's three kernels (k3_segsum, k3_tiles, k3_reduce);
2. K1 against its plain PyTorch version on the card, band level, f32 and
   f64, at the main path's job shape (S=4096, W=16384, m=256) on edge
   jobs, with CUDA-event times of both, of one ``torch.matmul`` of the
   same panels (TF32 off; the yardstick, never called by the port), K1's
   bound, and K1's time on the same job at m = 64, 128 and 512 and at
   W = 32768;
3. end to end, f64, n=131072, m=128 (data/benchmark/131072.txt.gz) through
   kernel='auto' (K1), against kernel='mxu' on the card and against an
   exact float64 numpy row scan on 64 sampled rows;
4. end to end, f32, n=2^20, m=256, band 4096, chunk 32768 (a random walk
   from a fixed seed) through K1, against the exact row scan;
5. the command line: ``python -m mpx_torch compute`` on data/binary/16384.tsb;
6. K3 against its plain PyTorch version (``sweep_band_xla``) on the card,
   band level, f32 and f64, on phase 2's series and edge jobs, with
   CUDA-event times of K3's wrapper (seed, allocations and launches, as
   the driver calls it; K3's ``ms``), of its kernels alone (the job's
   three launches), of the plain version and of K1 at the same job shape;
   K3 at W = 32768 too, its grid, resident blocks per SM and share of the
   bound; and K3's and K1's wrapper times (with K3's kernels alone) per m
   (64, 128, 256, 512) and chunk (16384, 32768);
7. the f64 showcase through K3 (``kernel='pallas'``): n=2^20, m=256, band
   4096, chunk 32768, a random walk from a fixed seed, one K3 launch per
   job and no plain call, against the exact row scan; its sweep time per
   job beside phase 6's K3 times (wrapper, kernels alone) at W = 32768;
8. parity: ``kernel='pallas'`` and ``kernel='hybrid'`` in f64 and f32 on
   phase 3's series against phase 3's K1 f64 profile;
9. ``auto`` for f64 at m=8192 (n=65536): K3, no K1 and no window matrix
   (peak device memory), against ``kernel='mxu_fused'`` on the same series;
10. the f64 showcase through ``auto`` (K1): n=2^20, m=256, band 4096,
    chunk 32768, a random walk from its own fixed seed, one K1 launch per
    job and no plain call, against the exact row scan;
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
14. the f64 left/right profiles through ``kernel='hybrid'`` on phase 7's
    series (n=2^20, m=256, band 4096, chunk 32768): one K1 f32 launch per
    job and no plain call, each side against an exact sided float64 row
    scan, and the nearer of the two sides against phase 12's profile; its
    phase split, flags, escalated rows per side, capture bytes, peak
    device memory, clock and power beside phase 12's;
15. the hybrid's width gate on phase 3's series: with ``SPARSE_MAX_W``
    lowered below w the self-join and the left/right hybrid take the dense
    pass B with no captures, and give the sparse runs' profiles; the peak
    device memory of both routes;
16. the new surfaces: ``python -m mpx_torch bench`` (the f64 showcase
    shape through K3, validated on 64 rows) as a subprocess, ``compute
    --left-right --kernel hybrid`` and ``compute --dtype ap32`` on
    data/binary/16384.tsb, and ``tsbin -e``/``-d`` round trips;
17. TF32: the script sets ``allow_tf32`` before phase 2 and the port
    leaves it so through every phase.

The line before the last but one is a JSON object with one entry per
kernel and dtype (launches counted in that kernel's main-path run: K1 in
phases 10 and 4, K3 in phases 7 and 8; the bound and the library call's
time at the band-level shape; the hybrid adds no kernel, and its K1
launches are in phase 12's and 14's lines); the line before the last is the
card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or mpx.
"""

from __future__ import annotations

import json
import os
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
# Floating-point instructions per pair in K3 (band_recurrence.cu): the QT
# update (multiply, FMA, add), P = QT * inv_r * inv_c (two multiplies), the
# NaN test, and the row and column comparisons.
K3_OPS_PER_PAIR = 8


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


def row_scan64(T: np.ndarray, m: int, rows: np.ndarray) -> np.ndarray:
    """Exact z-normalized distances (len(rows), w) of the sampled rows to
    every window, +inf inside the exclusion zone and for degenerate
    windows; blockwise so memory stays bounded."""
    w = T.shape[0] - m + 1
    Zq = np.stack([unit_windows64(T, m, r, r + 1)[0][0] for r in rows])
    degenerate = np.zeros(w, bool)
    D = np.empty((len(rows), w))
    blk = max(1, (128 << 20) // (8 * m))  # ~128 MB of windows per block
    for o in range(0, w, blk):
        Z, deg = unit_windows64(T, m, o, min(o + blk, w))
        degenerate[o : o + Z.shape[0]] = deg
        P = Zq @ Z.T
        D[:, o : o + Z.shape[0]] = np.sqrt(np.maximum(2.0 * m * (1.0 - P), 0.0))
    cols = np.arange(w)
    D[np.abs(cols[None, :] - rows[:, None]) < m // 4] = np.inf
    D[:, degenerate] = np.inf
    D[degenerate[rows]] = np.inf
    return D


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


def pair_distances64(T, m, a, b) -> np.ndarray:
    """Exact z-normalized distances between windows a[k] and b[k]."""
    wv = np.lib.stride_tricks.sliding_window_view(T, m)
    za, zb = (wv[x] - wv[x].mean(axis=1, keepdims=True) for x in (a, b))
    P = np.einsum("ij,ij->i", za, zb) / np.sqrt(
        np.einsum("ij,ij->i", za, za) * np.einsum("ij,ij->i", zb, zb))
    return np.sqrt(np.maximum(2.0 * m * (1.0 - P), 0.0))


def check_profiles_agree(T, m, MP, MPI, MP2, MPI2, tol) -> float:
    """Two profiles of one series: distances within tol, indices equal
    or equidistant within tol."""
    err = float(np.abs(MP.astype(np.float64) - MP2).max())
    require(err <= tol, f"profiles differ by {err} (tol {tol})")
    diff = np.nonzero(MPI != MPI2)[0]
    require(bool(((MPI[diff] >= 0) & (MPI2[diff] >= 0)).all()),
            "a row has a neighbor in one profile and none in the other")
    gap = np.abs(pair_distances64(T, m, diff, MPI[diff])
                 - pair_distances64(T, m, diff, MPI2[diff]))
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

    t0 = time.perf_counter()
    _build.load()
    seconds = time.perf_counter() - t0
    regs = [ln.strip() for ln in (_build.BUILD_LOG or "").splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln]
    mma = tensor_core_counts(_build)
    for name, kind in (("k1_tiles<double>", "DMMA"), ("k1_tiles<float>", "HMMA")):
        require(mma[name][kind] > 0, f"{name} has no {kind} instruction: {mma[name]}")
    say("1 build", seconds=seconds, library=os.path.relpath(
        _build.library_path(), REPO), ptxas=regs, sass_mma=mma,
        k3_ptxas=k3_ptxas(_build.BUILD_LOG or ""))


def k3_ptxas(log: str) -> dict:
    """Registers, spill bytes and static shared memory of K3's kernels,
    from ptxas's report in the build log."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = next((f"{k}<{t}>" for k in ("k3_segsum", "k3_tiles", "k3_reduce")
                         for t, c in (("float", "If"), ("double", "Id"))
                         if f"{len(k)}{k}{c}" in ln), None)
        elif name and "spill stores" in ln:
            w = ln.split()
            out.setdefault(name, {}).update(spill_store_bytes=int(w[w.index("spill") - 2]),
                                            spill_load_bytes=int(w[-4]))
        elif name and "registers" in ln:
            w = ln.replace(",", " ").split()
            out.setdefault(name, {})["registers"] = int(w[w.index("registers") - 1])
            out[name]["smem_bytes"] = int(w[w.index("smem") - 2]) if "smem" in w else 0
    require(len(out) == 6, f"ptxas report of K3's kernels incomplete: {sorted(out)}")
    return out


def tensor_core_counts(_build) -> dict:
    """DMMA and HMMA instructions in each of K1's tile kernels, counted in
    ``cuobjdump -sass`` of the built library."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", _build.library_path()],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for section in sass.split("Function : ")[1:]:
        name = section.split(None, 1)[0]
        for key, mangled in (("k1_tiles<double>", "k1_tilesIdE"),
                             ("k1_tiles<float>", "k1_tilesIfE")):
            if mangled in name:
                ops = [op for ln in section.splitlines() if "*/" in ln
                       for op in ln.split("*/", 1)[1].split()[:2]]  # [predicate] opcode
                out[key] = {kind: sum(op.startswith(kind + ".") or op == kind
                                      for op in ops) for kind in ("DMMA", "HMMA")}
    require(set(out) == {"k1_tiles<double>", "k1_tiles<float>"},
            f"K1's tile kernels not found in the SASS: {sorted(out)}")
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


def compare_band(torch, what: str, a, b, U64, r0: int, k0: int, tol: float) -> float:
    """Band outputs a (plain) and b (kernel): values within tol, indices
    equal or tied within tol on the exact unit windows U64."""
    worst = 0.0
    for side, base in (("row", r0), ("col", r0 + k0)):
        pa, pb = getattr(a, side), getattr(b, side)
        require(pa.value.shape == pb.value.shape, f"{what} {side}: shapes differ")
        err = float((pa.value.double() - pb.value.double()).abs().max())
        worst = max(worst, err)
        require(err <= tol, f"{what} {side}: kernel vs plain {err} > {tol}")
        ia, ib = pa.index.long(), pb.index.long()
        bad = torch.nonzero(ia != ib).flatten()
        require(bool(((ia[bad] >= 0) & (ib[bad] >= 0)).all()),
                f"{what} {side}: a masked aggregate differs")
        own = U64[base + bad]
        gap = ((own * U64[ia[bad]]).sum(1) - (own * U64[ib[bad]]).sum(1)).abs()
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


def reset_counts():
    from mpx_torch.kernels import mxu, mxu_fused, recurrence, xla

    mxu.CALLS = xla.CALLS = 0
    mxu_fused.LAUNCHES = recurrence.LAUNCHES = 0


def counts() -> dict:
    """Launches of K1 and K3, calls of their plain versions."""
    from mpx_torch.kernels import mxu, mxu_fused, recurrence, xla

    return {"k1": mxu_fused.LAUNCHES, "mxu": mxu.CALLS,
            "k3": recurrence.LAUNCHES, "xla": xla.CALLS}


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
    cfg = MatrixProfileConfig(m=m, dtype="float64", device="cuda")
    reset_counts()
    MP, MPI, wall, phases, card = run_profile(torch, T, cfg)
    launches = require_only(counts(), "k1", "auto f64 run")
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


def phase_e2e_f32(torch) -> int:
    from mpx_torch import MatrixProfileConfig

    n, m, tol = 1 << 20, 256, DIST_TOL["float32"]
    T = random_walk(n, SEED + 1)
    w = n - m + 1
    cfg = MatrixProfileConfig(m=m, dtype="float32", band=4096, chunk=32768,
                              device="cuda")
    reset_counts()
    MP, MPI, wall, phases, card = run_profile(torch, T, cfg)
    launches = require_only(counts(), "k1", "auto f32 run")
    vs_exact = check_rows(T, m, MP, MPI, sample_rows(w, SEED + 1), tol)
    pairs = w * (w - 1) / 2
    say("4 e2e f32", n=n, m=m, band=cfg.band, chunk=cfg.chunk,
        k1_launches=launches, plain_calls=0, wall_s=wall,
        pairs_per_s=pairs / wall, phases_s=phases, card=card,
        max_err_vs_exact_64_rows=vs_exact, tol=tol)
    return launches


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


def k3_kernel_ms(torch, stats, r0, k0, geom, dtype, reps: int = 20) -> float:
    """CUDA-event time of K3's kernels alone on one job: the job's seed and
    buffers made once, then its three launches repeated (not counted)."""
    from mpx_torch.kernels.recurrence import prepare_launch

    launch, _ = prepare_launch(stats, r0, k0, geom, dtype)
    stream = torch.cuda.current_stream().cuda_stream
    return time_ms(torch, lambda: require(launch(stream) == 0, "K3 launch failed"), reps)


def k3_wrapper_ms(torch, stats, r0, k0, geom, dtype, reps: int = 50) -> float:
    """CUDA-event time of one job through K3's wrapper, as the driver
    calls it (the seed, the allocations and the three launches).  Its host
    work can set the pace, and the host's clock is noisy: many runs."""
    from mpx_torch.kernels.recurrence import sweep_band_recurrence

    return time_ms(torch, lambda: sweep_band_recurrence(stats, r0, k0, geom, dtype), reps)


def phase_band_k3(torch, dtype: str) -> dict:
    """K3 vs sweep_band_xla on the card on phase 2's series and jobs,
    timed beside the plain version and K1 at the same job shape; K3 and K1
    per m and chunk."""
    from mpx_torch.kernels import _build
    from mpx_torch.kernels.mxu_fused import sweep_band_mxu_fused
    from mpx_torch.kernels.recurrence import SEGMENT_ROWS, sweep_band_recurrence
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
    nbj, G = -(-W // lib.mpx_k3_block_w()), -(-S // SEGMENT_ROWS)
    say(f"6 band K3 {dtype}", shape=dict(S=S, W=W, m=m), jobs=list(jobs),
        max_abs_err=worst, tol=tol, k3_ms=[k3a, k3b], k3_kernels_ms=[alonea, aloneb],
        k1_ms=[k1a, k1b], plain_ms=[plain1, plain2], **bound,
        k3_share_of_bound=bound["bound_ms"] / ms,
        k3_kernels_share_of_bound=bound["bound_ms"] / alone_ms,
        k3_pairs_per_s=pairs / ms * 1e3, k1_pairs_per_s=pairs / k1_ms * 1e3,
        plain_pairs_per_s=pairs / plain_ms * 1e3,
        grid={"k3_segsum": [nbj, G - 1], "k3_tiles": [nbj, G], "threads": 32,
              "segment_rows": SEGMENT_ROWS},
        resident_blocks_per_sm={k: lib.mpx_k3_resident_blocks(f64, i) for i, k in
                                enumerate(("k3_segsum", "k3_tiles", "k3_reduce"))},
        k3_ms_w32768=w2["k3_ms"], k3_kernels_ms_w32768=w2["k3_kernels_ms"],
        k3_share_of_bound_w32768=bound_w2 / w2["k3_ms"],
        k3_kernels_share_of_bound_w32768=bound_w2 / w2["k3_kernels_ms"],
        by_chunk_and_m=by_shape)
    # No single library call computes the recurrence.
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **bound,
            "library_ms": None, "_w32768": w2}


def phase_showcase(torch, phase: str, kernel: str, counter: str, seed: int,
                   band_ms_per_job=None) -> int:
    """The reference's showcase job in double precision (n=2^20, m=256,
    band 4096, chunk 32768) through ``kernel``: one launch of the counted
    kernel per job and no plain call, against the exact row scan.  With
    ``band_ms_per_job`` (phase 6's times of one such job: the wrapper's
    ``k3_ms`` and the kernels' ``k3_kernels_ms``), the sweep's time per
    job is printed beside them."""
    from mpx_torch import MatrixProfileConfig
    from mpx_torch.config import make_job_grid

    n, m, tol = 1 << 20, 256, DIST_TOL["float64"]
    T = random_walk(n, seed)
    w = n - m + 1
    cfg = MatrixProfileConfig(m=m, dtype="float64", kernel=kernel, band=4096,
                              chunk=32768, device="cuda")
    grid = cfg.shrink_to(w)
    jobs = len(make_job_grid(w, grid.band, grid.chunk).r0)
    reset_counts()
    MP, MPI, wall, phases, card = run_profile(torch, T, cfg)
    launches = require_only(counts(), counter, f"kernel={kernel!r} f64 showcase", jobs)
    vs_exact = check_rows(T, m, MP, MPI, sample_rows(w, seed), tol)
    pairs = w * (w - 1) / 2
    per_job = {}
    if band_ms_per_job is not None:
        sweep = next(v for k, v in phases.items() if k.startswith("2. Compute"))
        per_job = {"sweep_ms_per_job": sweep / jobs * 1e3,
                   "band_level_ms_per_job": band_ms_per_job}
    say(phase, n=n, m=m, kernel=kernel, band=cfg.band, chunk=cfg.chunk, jobs=jobs,
        **{f"{counter}_launches": launches}, plain_calls=0, wall_s=wall,
        pairs_per_s=pairs / wall, phases_s=phases, card=card, **per_job,
        max_err_vs_exact_64_rows=vs_exact, tol=tol)
    return launches, (MP, MPI), wall


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


def hybrid_split(phases: dict) -> dict:
    """The hybrid's phase seconds, grouped as phases 12 and 14 report them
    (the left/right run's rescore per side)."""
    def total(*prefixes, side=""):
        return sum(v for k, v in phases.items()
                   if k.startswith(prefixes) and (not side or k.endswith(f"{side}]")))
    return {"statistics": total("1. "), "pass_a": total("2. Compute [pass A]"),
            "pass_b_sparse": total("2. Compute [pass B sparse]"),
            "pass_b_dense": total("2. Compute [pass B dense]"),
            "pass_c": total("2. Compute [pass C"), "rescore": total("3. "),
            "rescore_left": total("3. ", side=", left"),
            "rescore_right": total("3. ", side=", right"), "post": total("4. ")}


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
    """The f64 left/right profiles through kernel='hybrid' on phase 7's
    series at the showcase shape: one K1 f32 launch per job and no plain
    call; each side within 1e-8 of the exact sided row scan on 64 sampled
    rows (indices only between equidistant neighbors); the nearer side
    within 1e-10 of phase 12's profile; phase 12's numbers beside."""
    n, m, tol = 1 << 20, 256, DIST_TOL["float64"]
    T = random_walk(n, SEED + 2)
    w = n - m + 1
    MPl, MPIl, MPr, MPIr, wall, phases, card, cnt, peak = run_hybrid(
        torch, T, m, left_right=True, band=4096, chunk=32768)
    require(cnt["k1_launches"] == 4224, f"left/right hybrid: {cnt['k1_launches']} K1 launches")
    rows = sample_rows(w, SEED + 2)
    D = row_scan64(T, m, rows)
    vs_exact = {side: check_rows(T, m, MP, MPI, rows, tol, sign, D)
                for side, sign, MP, MPI in (("left", -1, MPl, MPIl), ("right", 1, MPr, MPIr))}
    MP12, MPI12 = p12["profile"]
    nearer = np.minimum(MPl, MPr)
    vs_p12 = float(np.abs(nearer - MP12).max())
    require(vs_p12 <= 1e-10, f"min(left, right) vs phase 12's profile: {vs_p12}")
    pairs = w * (w - 1) / 2
    split = hybrid_split(phases)
    say("14 left/right f64 hybrid", n=n, m=m, band=4096, chunk=32768,
        k1_launches=cnt["k1_launches"], plain_calls=0, wall_s=wall,
        pairs_per_s=pairs / wall, split_s=split, counts=cnt, peak_device_bytes=peak,
        card=card, phases_s=phases, max_err_vs_exact_sided_64_rows=vs_exact, tol=tol,
        max_err_min_left_right_vs_phase_12=vs_p12,
        index_differs_vs_phase_12=int((np.where(MPr < MPl, MPIr, MPIl) != MPI12).sum()),
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


def main() -> int:
    import torch

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
    launches = {"mxu_fused": {"float32": phase_e2e_f32(torch)}}
    tf32_kept("4")
    phase_cli()
    band_k3 = {dt: phase_band_k3(torch, dt) for dt in ("float32", "float64")}
    tf32_kept("6")
    k3_w32768 = {dt: band_k3[dt].pop("_w32768") for dt in band_k3}
    k3_launches, k3_profile, k3_wall = phase_showcase(
        torch, "7 showcase f64 K3", "pallas", "k3", SEED + 2, k3_w32768["float64"])
    tf32_kept("7")
    launches["band_recurrence"] = {"float64": k3_launches,
                                   "float32": phase_parity(torch, k1_profile)}
    tf32_kept("8")
    phase_auto_large_m(torch)
    tf32_kept("9")
    launches["mxu_fused"]["float64"], _, k1_wall = phase_showcase(
        torch, "10 showcase f64 auto (K1)", "auto", "k1", SEED + 4)
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
    say("17 tf32", allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        unchanged_after_phases=tf32_after)
    kernels = [
        {"name": f"{name}[{dt}]", "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name][dt], **times[dt]}
        for name, source, replaces, times in (
            ("mxu_fused", K1_SOURCE, K1_REPLACES, band),
            ("band_recurrence", K3_SOURCE, K3_REPLACES, band_k3))
        for dt in ("float32", "float64")
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
