"""Benchmark harness, counterpart of ``mpx/bench.py``: one run, or the
suite of every ``BASELINE.md`` configuration::

    python -m mpx_torch bench -n 1048576 -m 256 --dtype float64 \\
        --kernel pallas --chunk 32768 --validate 64
    python -m mpx_torch bench --suite [--only NAME ...] [--table] [--out F]

Headline metric: distance pairs per second of one self-join (pairs =
w(w-1)/2, the upper triangle, exclusion-zone pairs included), timed on the
host clock around a run that ends in ``torch.cuda.synchronize()``, after a
warm-up run that builds the kernels.  ``vs_baseline`` compares it with
``BASELINE_PAIRS_PER_SEC``, the reference FPGA build's ideal roofline
(BASELINE.md).  Every result is held to an exact float64 oracle on sampled
rows before it is reported.  The suite's other tiers (streaming, top-k,
contrast, sum-threshold, DAMP, mSTAMP, the fleet, the pooled matrix,
MERLIN) have runners of their own, each with mpx's metric and validation.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from mpx_torch.analysis import _host

# The reference's Alveo U250 showcase roofline, pairs/s (32 PEs x ~300 MHz
# x 3 compute units; BASELINE.md).
BASELINE_PAIRS_PER_SEC = 3.0e10
# A window whose centered sum of squares is below this share of its raw
# one is constant: no neighbor (the statistics' rule).
_ZERO_VARIANCE_REL = 1e-10
# Bytes of the windows the oracle z-normalizes at a time.
_ORACLE_BLOCK_BYTES = 128 << 20


class ValidationError(AssertionError):
    pass


def _unit_windows(T: np.ndarray, m: int, sel):
    """Exact float64 z-normalized windows ``sel`` (a slice or indices;
    two-pass mean and norm) and their zero-variance mask."""
    wv = np.lib.stride_tricks.sliding_window_view(T, m)[sel]
    cent = wv - wv.mean(axis=1, keepdims=True)
    ssq = np.einsum("ij,ij->i", cent, cent)
    flat = ssq <= _ZERO_VARIANCE_REL * np.einsum("ij,ij->i", wv, wv)
    with np.errstate(divide="ignore", invalid="ignore"):
        Z = cent / np.sqrt(ssq)[:, None]
    Z[flat] = 0.0
    return Z, flat


def _exact_rows(T: np.ndarray, m: int, rows: np.ndarray):
    """The oracle: each row's exact float64 correlations with every window
    (numpy on the host, blockwise), -inf inside the exclusion zone and for
    zero-variance windows.  Returns (best correlation, first index reaching
    it, -1 where none; the (rows, w) correlations)."""
    w = T.shape[0] - m + 1
    Zq, flat_q = _unit_windows(T, m, rows)
    P = np.empty((rows.shape[0], w))
    flat = np.zeros(w, bool)
    blk = max(1, _ORACLE_BLOCK_BYTES // (8 * m))
    for o in range(0, w, blk):
        Z, f = _unit_windows(T, m, slice(o, o + blk))
        flat[o : o + Z.shape[0]] = f
        P[:, o : o + Z.shape[0]] = Zq @ Z.T
    P[np.abs(np.arange(w)[None, :] - rows[:, None]) < m // 4] = -np.inf
    P[:, flat] = -np.inf
    P[flat_q] = -np.inf
    best = P.max(axis=1)
    idx = np.where(np.isfinite(best), P.argmax(axis=1), -1).astype(np.int32)
    return best, idx, P


def validate_sampled_rows(T, m: int, MP, MPI, k: int = 64, seed: int = 1,
                          tol: float | None = None) -> dict:
    """Exact-oracle spot check of a computed profile: ``k`` random rows are
    rescanned in full float64 with numpy on the host (code apart from every
    tier it checks) and each distance must be within ``tol`` of the exact
    one; an index other than the scan's is allowed only when its exact
    distance ties the best within ``tol`` (the reference's tie rule).  A
    row with no valid neighbor must carry index -1.

    Raises ValidationError on any mismatch: a number with a wrong profile
    is worse than no number."""
    T64 = np.asarray(T, np.float64)
    w = T64.shape[0] - m + 1
    if tol is None:
        tol = 1e-8 if np.asarray(MP).dtype == np.float64 else 2e-3
    MP = np.asarray(MP, np.float64)
    MPI = np.asarray(MPI)
    rows = np.sort(np.random.default_rng(seed).choice(w, size=min(k, w), replace=False))
    best, eI, P = _exact_rows(T64, m, rows)
    live = np.isfinite(best)
    eMP = np.sqrt(np.maximum(2.0 * m * (1.0 - np.where(live, best, 0.0)), 0.0))
    derr = np.where(live, np.abs(MP[rows] - eMP), 0.0)
    bad_d = derr > tol
    got = MPI[rows].astype(np.int64)
    mism = got != eI
    ok = (got >= 0) & (got < w)
    gotP = np.where(ok, P[np.arange(rows.shape[0]), np.clip(got, 0, w - 1)], -np.inf)
    gotD = np.sqrt(np.maximum(2.0 * m * (1.0 - gotP), 0.0))
    tie_ok = live & ok & np.isfinite(gotP) & (np.abs(gotD - eMP) <= tol)
    bad_i = mism & ~tie_ok
    if bad_d.any() or bad_i.any():
        raise ValidationError(
            f"sampled-row validation FAILED: {int(bad_d.sum())} distance "
            f"mismatches (max err {derr.max():.3e}, rows "
            f"{rows[bad_d][:5].tolist()}), {int(bad_i.sum())} non-tie index "
            f"mismatches (rows {rows[bad_i][:5].tolist()})"
        )
    return {"rows": int(rows.shape[0]), "max_abs_err": float(derr.max()),
            "tie_indices": int((mism & tie_ok).sum()), "tol": tol}


def device_line(device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or the
    device's name off the card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return f"device: {dev}"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(dev.index if dev.index is not None else torch.cuda.current_device())],
        capture_output=True, text=True, check=True).stdout.strip()


def _sync(device) -> None:
    """Wait for the card's queued work, so a host clock read after it
    times the work and not its enqueue."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _device_name(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


def _stats64(T64: np.ndarray, m: int, device):
    """Host float64 statistics of ``T64`` and the series, ``mu`` and
    ``inv`` as float64 tensors on ``device`` (the oracles' inputs)."""
    from mpx_torch.ops.precompute import host_statistics

    s = host_statistics(T64, m, matmul_only=True, device=device)
    return s, [torch.as_tensor(np.asarray(x, np.float64), device=device)
               for x in (T64, s["mu"], s["inv"])]


def run_benchmark(n: int = 1 << 20, m: int = 256, dtype: str = "float32",
                  kernel: str = "auto", band: int = 4096, chunk: int = 4096,
                  shards=None, shard_mode: str = "jobs",
                  seed: int = 0, verbose: bool = False, input_path=None,
                  validate: int = 64, warmup: bool = True, device: str = "cuda"):
    """One self-join, timed: a warm-up run (kernel builds), then a run on
    the host clock that ends in ``torch.cuda.synchronize()``.  ``shards`` /
    ``shard_mode`` are the config's ``num_shards`` / ``shard_mode`` (the
    ring rows).  Returns mpx's keys (``pairs_per_sec``, ``compute_s``,
    ``validation``, ...)."""
    from mpx_torch import MatrixProfileConfig, compute_matrix_profile
    from mpx_torch.dtypes import distance_epsilon
    from mpx_torch.io.apfixed import quantize
    from mpx_torch.utils.profile import BenchmarkProfile

    if input_path:
        from mpx_torch.io.tsb import read_series

        T = read_series(input_path)
        n = T.shape[0]
    else:
        T = np.cumsum(np.random.default_rng(seed).standard_normal(n))
    w = n - m + 1
    pairs = w * (w - 1) / 2
    cfg = MatrixProfileConfig(m=m, dtype=dtype, kernel=kernel, band=band, chunk=chunk,
                              num_shards=shards, shard_mode=shard_mode, device=device)

    def run(prof):
        t0 = time.perf_counter()
        MP, MPI = compute_matrix_profile(T, config=cfg, profile=prof)
        _sync(device)
        return MP, MPI, time.perf_counter() - t0

    if warmup:
        prof = BenchmarkProfile()
        _, _, first = run(prof)
        if verbose:
            print(f"# warmup (incl. kernel builds): {first:.1f}s", file=sys.stderr)
            prof.report(file=sys.stderr)
    prof = BenchmarkProfile()
    MP, MPI, wall = run(prof)
    MP, MPI = MP.cpu().numpy(), MPI.cpu().numpy()
    if verbose:
        prof.report(file=sys.stderr)
    compute_ns = sum(v for k, v in prof.category_totals().items() if k.startswith("2."))

    val = None
    if validate:
        tol = distance_epsilon(cfg.dtype)
        # An ap* run computes the profile of the quantized series.
        Tq = T if cfg.input_quant is None else quantize(T, cfg.input_quant)
        val = validate_sampled_rows(Tq, m, MP, MPI, k=validate, seed=seed + 1, tol=tol)
        if verbose:
            print(f"# validated {val['rows']} sampled rows: max err "
                  f"{val['max_abs_err']:.2e}", file=sys.stderr)
    return {
        "validation": val, "n": n, "m": m, "dtype": dtype, "kernel": kernel,
        "device": _device_name(device),
        "pairs": pairs, "wall_s": wall, "compute_s": compute_ns / 1e9,
        "pairs_per_sec": pairs / wall,
        "pairs_per_sec_compute": pairs / (compute_ns / 1e9) if compute_ns else None,
        "counts": dict(prof.counts), "mp_head": MP[:4].tolist(),
    }


def run_contrast_benchmark(n: int, m: int, dtype: str = "double",
                           band: int = 4096, chunk: int = 16384,
                           seed: int = 0, validate: int = 32,
                           verbose: bool = False, warmup: bool = True,
                           device: str = "cuda"):
    """Contrast-profile benchmark (the suite's ``contrast-*`` rows): one
    self-join and one AB-join at the same n (:mod:`mpx_torch.contrast`).
    The metric is distance pairs swept per second, w(w-1)/2 self pairs
    plus w*w cross pairs.  ``validate`` sampled rows are recomputed exactly
    (the self and the AB nearest neighbor through the float64 row scans
    ``hybrid._row_scan`` / ``_row_scan_ab`` on ``device``), and each CP
    entry must match to 1e-8 (f64) / 2e-3 (f32).  ``warmup`` runs the
    profile once first (the kernel builds), as mpx does."""
    from mpx_torch import MatrixProfileConfig
    from mpx_torch.contrast import contrast_profile
    from mpx_torch.dtypes import canonical_dtype
    from mpx_torch.hybrid import _row_scan, _row_scan_ab
    from mpx_torch.ops.precompute import host_statistics

    rng = np.random.default_rng(seed)
    Tp = np.cumsum(rng.standard_normal(n))
    Tm = np.cumsum(np.random.default_rng(seed + 7).standard_normal(n))
    w = n - m + 1
    pairs = w * (w - 1) / 2 + float(w) * w
    cfg = MatrixProfileConfig(m=m, dtype=dtype, band=band, chunk=chunk, device=device)

    def run():
        t0 = time.perf_counter()
        res = contrast_profile(Tp, Tm, config=cfg)  # numpy: the copy synchronizes
        return res, time.perf_counter() - t0

    if warmup:
        run()
    res, wall = run()
    cp = res.cp

    val = None
    if validate:
        sp, sm = (host_statistics(X, m, matmul_only=True, device=device) for X in (Tp, Tm))
        rows = np.sort(np.random.default_rng(seed + 1).choice(
            w, size=min(validate, w), replace=False)).astype(np.int32)

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float64), device=device)

        aaP, _ = _row_scan(t(Tp), t(sp["mu"]), t(sp["inv"]), m, w, m // 4, rows)
        abP, _ = _row_scan_ab(t(Tp), t(sp["mu"]), t(sp["inv"]), t(Tm), t(sm["mu"]),
                              t(sm["inv"]), m, w, rows)
        aaP, abP = aaP.cpu().numpy(), abP.cpu().numpy()
        d_aa = np.sqrt(np.maximum(2.0 * m * (1.0 - aaP), 0.0))
        d_ab = np.sqrt(np.maximum(2.0 * m * (1.0 - abP), 0.0))
        expect = np.clip((d_ab - d_aa) / np.sqrt(2.0 * m), 0.0, 1.0)
        tol = 1e-8 if canonical_dtype(dtype) == "float64" else 2e-3
        err = np.abs(cp[rows] - expect)
        if err.size and err.max() > tol:
            raise ValidationError(f"contrast sampled-row validation FAILED: "
                                  f"max err {err.max():.3e}")
        val = {"rows": int(rows.shape[0]),
               "max_abs_err": float(err.max()) if err.size else 0.0, "tol": tol}
        if verbose:
            print(f"# validated {val['rows']} contrast rows: "
                  f"max err {val['max_abs_err']:.2e}", file=sys.stderr)

    return {
        "validation": val, "n": n, "m": m, "dtype": dtype,
        "device": _device_name(device),
        "pairs": pairs, "wall_s": wall, "pairs_per_sec": pairs / wall,
        "mp_head": cp[:4].tolist(),
    }


# The benchmark suite: the configurations BASELINE.md asks for, with mpx's
# names and shapes (``mpx/bench.py:SUITE``).  band/chunk are schedule knobs
# (the reference's w = MP_SIZE_W chunks); n/m/dtype define the workload.  A
# row flagged ``huge`` runs only when named with ``--only``.
SUITE = [
    # the reference's default build (CMakeLists.txt:30-46)
    {"name": "vanilla-f32-8192",
     "n": 8192, "m": 32, "dtype": "float32", "band": 1024, "chunk": 1024},
    # the Tiled build's float tier (w = 4096 diagonal chunks)
    {"name": "tiled-f32-131072",
     "n": 131072, "m": 128, "dtype": "float32", "band": 4096, "chunk": 4096},
    # the showcase job's shape in float32
    {"name": "headline-f32-1048576",
     "n": 1 << 20, "m": 256, "dtype": "float32", "band": 4096, "chunk": 32768},
    # the showcase job (README.md:35): double, n = 2^20, m = 256
    {"name": "showcase-f64-1048576",
     "n": 1 << 20, "m": 256, "dtype": "double", "band": 4096, "chunk": 32768},
    # real datasets (data/real), float32 and double
    {"name": "real-sudden-cardiac-death",
     "input": "sudden-cardiac-death.txt", "m": 128, "dtype": "float32",
     "band": 4096, "chunk": 4096},
    {"name": "real-italian-power-f64",
     "input": "italianpowerdemand.txt", "m": 128, "dtype": "double",
     "band": 4096, "chunk": 4096},
    # four times the showcase's pairs, float32
    {"name": "scale-f32-2097152",
     "n": 1 << 21, "m": 256, "dtype": "float32", "band": 4096, "chunk": 32768},
    # the sharded-inputs ring on a one-device mesh, float32 and double
    {"name": "ring-f32-1048576",
     "n": 1 << 20, "m": 256, "dtype": "float32",
     "shards": 1, "shard_mode": "ring", "band": 4096, "chunk": 16384},
    {"name": "ring-f64-1048576",
     "n": 1 << 20, "m": 256, "dtype": "double",
     "shards": 1, "shard_mode": "ring", "band": 4096, "chunk": 16384},
    # incremental appends after a bootstrap
    {"name": "streaming-f32-262144",
     "streaming": True, "n": 1 << 18, "m": 256, "append": 64, "rounds": 50},
    # the k nearest neighbors at the showcase's scale, double
    {"name": "topk-f64-1048576-k4",
     "topk": True, "n": 1 << 20, "m": 256, "k": 4, "dtype": "double",
     "band": 4096, "chunk": 32768},
    # the contrast profile: one self-join and one AB-join
    {"name": "contrast-f64-524288",
     "contrast": True, "n": 1 << 19, "m": 256, "dtype": "double",
     "band": 4096, "chunk": 32768},
    # DAMP: the exact left profile and ranked causal discords
    {"name": "damp-f64-524288",
     "damp": True, "n": 1 << 19, "m": 256, "dtype": "double",
     "band": 4096, "chunk": 32768},
    # the sum-threshold (pattern density) profile
    {"name": "thresh-f32-1048576",
     "thresh": True, "n": 1 << 20, "m": 256, "threshold": 0.7,
     "dtype": "float32", "band": 4096, "chunk": 16384},
    # the multi-dimensional profile, d = 4 (metric: dimension-pairs/s)
    {"name": "mstamp-f32-d4-131072",
     "mstamp": True, "n": 1 << 17, "m": 256, "d": 4,
     "dtype": "float32", "band": 2048, "chunk": 4096},
    # a fleet of 256 short series
    {"name": "batch-f32-256x8192",
     "batch": True, "n": 8192, "m": 64, "b": 256,
     "dtype": "float32", "band": 1024, "chunk": 1024},
    # the pooled 64 x 64 summary of the whole join
    {"name": "matrix-f32-1048576",
     "matrix": True, "n": 1 << 20, "m": 256,
     "mwidth": 64, "mheight": 64, "band": 4096, "chunk": 4096},
    # exact discords at 16 consecutive lengths
    {"name": "merlin-f32-524288-16",
     "merlin": True, "n": 1 << 19, "lo": 256, "hi": 271},
    # the 16M-point pod-scale workload on one device through the plain
    # sweep; run only when named
    {"name": "pod-f32-16777216",
     "n": 1 << 24, "m": 256, "dtype": "float32", "kernel": "mxu",
     "band": 4096, "chunk": 16384, "huge": True, "warmup": False,
     "validate": 32},
]

def run_streaming_benchmark(n: int, m: int, append: int, rounds: int,
                            seed: int = 0, verbose: bool = False,
                            device: str = "cuda"):
    """Incremental-append throughput: bootstrap an n-point profile, then
    time ``rounds`` appends of ``append`` points each (the first one a
    warm-up).  Metric = appended pairs/s (each append sweeps ~append * n
    pairs); ``recompute_pairs`` is the work a batch-only engine would do
    re-running the full self-join after every append, which ``run_suite``
    scores against the reference's roofline."""
    from mpx_torch.streaming import StreamingMatrixProfile

    rng = np.random.default_rng(seed)
    T = np.cumsum(rng.standard_normal(n + append * rounds))
    smp = StreamingMatrixProfile(T[:n], m=m, dtype="float32", device=device)
    smp.append(T[n : n + append])
    _sync(device)
    t0 = time.perf_counter()
    pos = n + append
    for _ in range(rounds - 1):
        smp.append(T[pos : pos + append])
        pos += append
    MP, MPI = smp.profile()  # the copy to the host synchronizes
    _sync(device)
    wall = time.perf_counter() - t0
    done = rounds - 1
    pairs = sum((append + m - 1) * (n + append * (i + 1)) for i in range(1, rounds))
    recompute_pairs = 0.0
    for i in range(1, rounds):
        wi = (n + append * (i + 1)) - m + 1
        recompute_pairs += wi * (wi - 1) / 2
    # the stream computes in float32 (stored float64): float32 tolerance
    val = validate_sampled_rows(T[:pos], m, MP, MPI, k=32, seed=seed + 1, tol=2e-3)
    return {
        "validation": val, "n": n, "m": m, "dtype": "float32",
        "device": _device_name(device),
        "pairs": float(pairs), "recompute_pairs": float(recompute_pairs),
        "baseline_model": "full recompute per append at U250 roofline",
        "wall_s": wall, "appends": done, "append_ms": wall / done * 1e3,
        "pairs_per_sec": pairs / wall, "mp_head": MP[:4].tolist(),
    }


def run_topk_benchmark(n: int, m: int, k: int, dtype: str = "double",
                       band: int = 4096, chunk: int = 16384,
                       seed: int = 0, validate: int = 32,
                       verbose: bool = False, device: str = "cuda"):
    """k-NN profile benchmark (:func:`mpx_torch.topk.compute_topk_profile`
    through ``auto``).  Metric = distance pairs swept per second.
    Validation: ``validate`` random rows rescanned exactly
    (``hybrid._row_topk_scan``, float64 tensors on ``device``); all k
    distances within 1e-8 (f64) / 2e-3 (f32), index disagreements only
    between equidistant neighbors."""
    from mpx_torch import MatrixProfileConfig
    from mpx_torch.dtypes import canonical_dtype
    from mpx_torch.hybrid import _rescore_pairs, _row_topk_scan
    from mpx_torch.topk import compute_topk_profile

    T = np.cumsum(np.random.default_rng(seed).standard_normal(n))
    w = n - m + 1
    pairs = w * (w - 1) / 2
    cfg = MatrixProfileConfig(m=m, dtype=dtype, band=band, chunk=chunk, device=device)

    compute_topk_profile(T, k=k, config=cfg)  # warm-up (kernel builds)
    _sync(device)
    t0 = time.perf_counter()
    D, I = compute_topk_profile(T, k=k, config=cfg)
    _sync(device)
    wall = time.perf_counter() - t0
    D, I = _host(D).astype(np.float64), _host(I).astype(np.int64)

    val = None
    if validate:
        tol = 1e-8 if canonical_dtype(dtype) == np.dtype(np.float64) else 2e-3
        _, (T64, mu, inv) = _stats64(np.asarray(T, np.float64), m, device)
        rows = np.sort(np.random.default_rng(seed + 1).choice(
            w, size=min(validate, w), replace=False))
        eP, eI = (_host(x) for x in _row_topk_scan(T64, mu, inv, m, w, m // 4, rows, k))
        eD = np.sqrt(np.maximum(2.0 * m * (1.0 - eP), 0.0))
        got = D[rows]
        # a missing neighbor: index -1 in the oracle, +inf in the profile
        fin = eI >= 0
        if np.isfinite(got[~fin]).any():
            raise ValidationError("top-k rows report neighbors where the oracle has none")
        derr = np.abs(got - eD)[fin]
        if derr.size and derr.max() > tol:
            raise ValidationError(f"top-k sampled-row validation FAILED: max err {derr.max():.3e}")
        # an index other than the oracle's must be an equidistant tie
        mism = (I[rows] != eI) & fin
        if mism.any():
            rr, cc = np.nonzero(mism)
            cP = _host(_rescore_pairs(T64, mu, inv, m, rows[rr], I[rows][rr, cc]))
            cD = np.sqrt(np.maximum(2.0 * m * (1.0 - cP), 0.0))
            if np.abs(cD - eD[rr, cc]).max() > tol:
                raise ValidationError("top-k non-tie index mismatches")
        val = {"rows": int(rows.shape[0]),
               "max_abs_err": float(derr.max()) if derr.size else 0.0,
               "tie_indices": int(mism.sum()), "tol": tol}
        if verbose:
            print(f"# validated {val['rows']} top-{k} rows: "
                  f"max err {val['max_abs_err']:.2e}", file=sys.stderr)

    return {
        "validation": val, "n": n, "m": m, "k": k, "dtype": dtype,
        "device": _device_name(device), "pairs": pairs, "wall_s": wall,
        "pairs_per_sec": pairs / wall, "mp_head": D[:2, :2].tolist(),
    }


def run_thresh_benchmark(n: int, m: int, dtype: str = "float32",
                         threshold: float = 0.7,
                         band: int = 4096, chunk: int = 16384,
                         seed: int = 0, validate: int = 16,
                         verbose: bool = False, device: str = "cuda"):
    """Sum-threshold / frequency profile benchmark
    (:mod:`mpx_torch.thresh`).  Metric = pairs/s over the w(w-1)/2
    unordered pairs.  Validation: ``validate`` sampled rows' sums and
    counts recomputed by a blocked host float64 product over ALL columns.
    A pair within ``delta`` of the threshold may fall either side in
    float32, so float32 is held to an interval: the sum and count must lie
    between the oracle's at threshold + delta and at threshold - delta
    (plus an accumulation tolerance); float64 is exact (delta 0)."""
    from mpx_torch import MatrixProfileConfig
    from mpx_torch.ops.precompute import host_statistics
    from mpx_torch.thresh import compute_sum_thresh

    T = np.cumsum(np.random.default_rng(seed).standard_normal(n))
    w = n - m + 1
    pairs = w * (w - 1) / 2
    cfg = MatrixProfileConfig(m=m, dtype=dtype, band=band, chunk=chunk, device=device)

    compute_sum_thresh(T, config=cfg, threshold=threshold)  # warm-up
    _sync(device)
    t0 = time.perf_counter()
    sums, cnts = compute_sum_thresh(T, config=cfg, threshold=threshold)
    _sync(device)
    wall = time.perf_counter() - t0
    sums, cnts = _host(sums).astype(np.float64), _host(cnts).astype(np.int64)

    val = None
    if validate:
        f64 = dtype in ("double", "float64")
        T64 = np.asarray(T, np.float64)
        s = host_statistics(T64, m, matmul_only=True, device=device)
        mu = np.asarray(s["mu"], np.float64)
        inv = np.asarray(s["inv"], np.float64)
        rows = np.sort(np.random.default_rng(seed + 1).choice(
            w, size=min(validate, w), replace=False))
        wins = np.lib.stride_tricks.sliding_window_view(T64, m)
        Ur = (wins[rows] - mu[rows, None]) * inv[rows, None]
        excl = m // 4
        delta = 0.0 if f64 else 1e-3
        lo_s = np.zeros(rows.shape[0])
        hi_s = np.zeros(rows.shape[0])
        lo_c = np.zeros(rows.shape[0], np.int64)
        hi_c = np.zeros(rows.shape[0], np.int64)
        blk = 1 << 16
        for o in range(0, w, blk):
            e = min(o + blk, w)
            P = Ur @ ((wins[o:e] - mu[o:e, None]) * inv[o:e, None]).T
            ok = ((np.abs(rows[:, None] - np.arange(o, e)[None, :]) >= excl)
                  & np.isfinite(inv[rows])[:, None] & np.isfinite(inv[o:e])[None, :])
            tight = ok & (P > threshold + delta)
            loose = ok & (P > threshold - delta)
            lo_s += np.where(tight, P, 0.0).sum(axis=1)
            hi_s += np.where(loose, P, 0.0).sum(axis=1)
            lo_c += tight.sum(axis=1)
            hi_c += loose.sum(axis=1)
        tol = 1e-8 if f64 else max(2e-2, 1e-6 * float(hi_s.max(initial=0.0)))
        got_s, got_c = sums[rows], cnts[rows]
        sum_viol = np.maximum(lo_s - tol - got_s, got_s - hi_s - tol)
        cnt_viol = np.maximum(lo_c - got_c, got_c - hi_c)
        if (sum_viol.size and sum_viol.max() > 0) or cnt_viol.max(initial=0) > 0:
            raise ValidationError(
                f"thresh sampled-row validation FAILED: sum violation "
                f"{sum_viol.max():.3e}, count violation {cnt_viol.max()}")
        val = {"rows": int(rows.shape[0]),
               "max_sum_slack": float(np.maximum(sum_viol, 0.0).max()) if sum_viol.size else 0.0,
               "band_delta": delta, "tol": tol}
        if verbose:
            print(f"# validated {val['rows']} thresh rows "
                  f"(interval, delta={delta}, tol={tol:.2e})", file=sys.stderr)

    return {
        "validation": val, "n": n, "m": m, "dtype": dtype, "threshold": threshold,
        "device": _device_name(device), "pairs": pairs, "wall_s": wall,
        "pairs_per_sec": pairs / wall, "mp_head": sums[:4].tolist(),
    }


def run_damp_benchmark(n: int, m: int, dtype: str = "double",
                       band: int = 4096, chunk: int = 16384,
                       seed: int = 0, validate: int = 16,
                       verbose: bool = False, device: str = "cuda"):
    """DAMP (left-profile anomaly) benchmark: one left/right sweep at
    ``n`` (:func:`mpx_torch.damp.compute_damp`).  Metric = pairs/s over
    the w(w-1)/2 join pairs.  Validation: ``validate`` sampled rows' left
    maxima recomputed by a blocked host float64 product over the strictly
    earlier columns."""
    from mpx_torch import MatrixProfileConfig
    from mpx_torch.damp import compute_damp
    from mpx_torch.ops.precompute import host_statistics

    T = np.cumsum(np.random.default_rng(seed).standard_normal(n))
    w = n - m + 1
    pairs = w * (w - 1) / 2
    cfg = MatrixProfileConfig(m=m, dtype=dtype, band=band, chunk=chunk, device=device)

    compute_damp(T, config=cfg, k=0)  # warm-up
    _sync(device)
    t0 = time.perf_counter()
    res = compute_damp(T, config=cfg, k=3)  # numpy scores: the copy synchronizes
    wall = time.perf_counter() - t0

    val = None
    if validate:
        T64 = np.asarray(T, np.float64)
        s = host_statistics(T64, m, matmul_only=True, device=device)
        mu = np.asarray(s["mu"], np.float64)
        inv = np.asarray(s["inv"], np.float64)
        excl = m // 4
        rows = np.sort(np.random.default_rng(seed + 1).choice(
            np.arange(excl + 1, w), size=min(validate, w - excl - 1), replace=False))
        wins = np.lib.stride_tricks.sliding_window_view(T64, m)
        Ur = (wins[rows] - mu[rows, None]) * inv[rows, None]
        best = np.full(rows.shape[0], -np.inf)
        blk = 1 << 16
        for o in range(0, w, blk):
            e = min(o + blk, w)
            P = Ur @ ((wins[o:e] - mu[o:e, None]) * inv[o:e, None]).T
            ok = (((rows[:, None] - np.arange(o, e)[None, :]) >= excl)
                  & np.isfinite(inv[o:e])[None, :])
            best = np.maximum(best, np.where(ok, P, -np.inf).max(axis=1))
        exp = np.sqrt(np.maximum(2.0 * m * (1.0 - best), 0.0))
        tol = 1e-8 if dtype in ("double", "float64") else 2e-3
        fin = np.isfinite(exp)
        err = np.abs(res.scores[rows][fin] - exp[fin])
        if err.size and err.max() > tol:
            raise ValidationError(f"damp sampled-row validation FAILED: max err {err.max():.3e}")
        val = {"rows": int(fin.sum()),
               "max_abs_err": float(err.max()) if err.size else 0.0, "tol": tol}
        if verbose:
            print(f"# validated {val['rows']} damp rows: max err "
                  f"{val['max_abs_err']:.2e}", file=sys.stderr)

    return {
        "validation": val, "n": n, "m": m, "dtype": dtype,
        "device": _device_name(device), "pairs": pairs, "wall_s": wall,
        "pairs_per_sec": pairs / wall, "mp_head": res.scores[m : m + 4].tolist(),
    }


def run_mstamp_benchmark(n: int, m: int, d: int, dtype: str = "float32",
                         band: int = 4096, chunk: int = 4096,
                         seed: int = 0, validate: int = 8,
                         verbose: bool = False, device: str = "cuda"):
    """Multi-dimensional (mSTAMP) benchmark
    (:func:`mpx_torch.mstamp.compute_multidim_profile`).  Metric =
    dimension-pairs/s (d distances per subsequence pair).  Validation:
    ``validate`` sampled rows recomputed by a host float64 oracle
    (per-dimension distances, sorted across dimensions, prefix means) at
    every k."""
    from mpx_torch import MatrixProfileConfig
    from mpx_torch.mstamp import compute_multidim_profile

    T = np.cumsum(np.random.default_rng(seed).standard_normal((d, n)), axis=1)
    w = n - m + 1
    pairs = d * w * (w - 1) / 2
    cfg = MatrixProfileConfig(m=m, dtype=dtype, band=band, chunk=chunk, device=device)
    compute_multidim_profile(T, config=cfg)  # warm-up
    _sync(device)
    t0 = time.perf_counter()
    prof = compute_multidim_profile(T, config=cfg)  # numpy: the copy synchronizes
    wall = time.perf_counter() - t0

    val = None
    if validate:
        tol = 1e-8 if dtype in ("double", "float64") else 2e-3
        excl = m // 4
        rows = np.random.default_rng(seed + 1).choice(w, size=min(validate, w), replace=False)
        U = []
        for t in range(d):
            wv = np.lib.stride_tricks.sliding_window_view(T[t].astype(np.float64), m)
            c = wv - wv.mean(axis=1, keepdims=True)
            U.append(c / np.sqrt((c * c).sum(axis=1, keepdims=True)))
        maxerr = 0.0
        for i in rows:
            dist = np.empty((d, w))
            for t in range(d):
                dist[t] = np.sqrt(np.maximum(2.0 * m * (1.0 - U[t] @ U[t][i]), 0.0))
            dist[:, max(0, i - excl + 1) : i + excl] = np.inf
            dk = np.cumsum(np.sort(dist, axis=0), axis=0) / np.arange(1, d + 1)[:, None]
            exp = dk.min(axis=1)
            got = np.asarray(prof.PMP[:, i], np.float64)
            fin = np.isfinite(exp)
            err = float(np.abs(got[fin] - exp[fin]).max()) if fin.any() else 0.0
            maxerr = max(maxerr, err)
            if err > tol:
                raise ValidationError(f"mstamp sampled-row {i} FAILED: max err {err:.3e}")
        val = {"rows": int(rows.size), "max_abs_err": maxerr, "tol": tol}
        if verbose:
            print(f"# validated {rows.size} rows x {d} k-levels: "
                  f"max err {maxerr:.2e}", file=sys.stderr)

    return {
        "validation": val, "n": n, "m": m, "d": d, "dtype": dtype,
        "device": _device_name(device), "pairs": pairs, "wall_s": wall,
        "pairs_per_sec": pairs / wall, "work_factor": d,
        "baseline_model": ("d-weighted dimension-pairs vs the 1-D U250 roofline; each "
                           "pair also pays a cross-dimension sort and prefix means "
                           "for every k"),
        "mp_head": np.asarray(prof.PMP[:2, :2], np.float64).tolist(),
    }


def run_matrix_benchmark(n: int, m: int, mwidth: int = 64,
                         mheight: int = 64, band: int = 4096,
                         chunk: int = 4096, seed: int = 0,
                         validate: int = 32, verbose: bool = False,
                         device: str = "cuda"):
    """Pooled distance-matrix summary benchmark
    (:func:`mpx_torch.distmatrix.pooled_matrix`, Pearson cells).  Metric =
    pairs/s over the w(w-1)/2 join pairs.  Validation: for ``validate``
    sampled rows, the exact float64 best pair (``hybrid._row_scan`` on
    ``device``) must be dominated by its pooled cell: the cell covering
    (row, best column) at most 2e-3 below that correlation."""
    from mpx_torch import MatrixProfileConfig
    from mpx_torch.distmatrix import pooled_matrix
    from mpx_torch.hybrid import _row_scan

    T = np.cumsum(np.random.default_rng(seed).standard_normal(n))
    w = n - m + 1
    pairs = w * (w - 1) / 2
    cfg = MatrixProfileConfig(m=m, band=band, chunk=chunk, device=device)

    pooled_matrix(T, m, mwidth=mwidth, mheight=mheight, pearson=True, config=cfg)
    _sync(device)
    t0 = time.perf_counter()
    M = pooled_matrix(T, m, mwidth=mwidth, mheight=mheight, pearson=True,
                      config=cfg)  # numpy: the copy synchronizes
    wall = time.perf_counter() - t0

    val = None
    if validate:
        _, (T64, mu, inv) = _stats64(np.asarray(T, np.float64), m, device)
        rows = np.sort(np.random.default_rng(seed + 1).choice(
            w, size=min(validate, w), replace=False))
        eP, eI = (_host(x) for x in _row_scan(T64, mu, inv, m, w, m // 4, rows))
        ph, pw = -(-w // mheight), -(-w // mwidth)
        ok = eI >= 0
        slack = float((M[rows[ok] // ph, eI[ok] // pw] - eP[ok]).min())
        if slack < -2e-3:
            raise ValidationError(f"pooled cell below its own row's best pair by {-slack}")
        val = {"rows": int(ok.sum()), "min_dominance_slack": slack}

    res = {
        "n": n, "m": m, "dtype": "float32", "mwidth": mwidth, "mheight": mheight,
        "device": _device_name(device), "pairs": pairs, "wall_s": wall,
        "pairs_per_sec": pairs / wall, "matrix_max_corr": float(M.max()),
    }
    if val:
        res["validation"] = val
    return res


def run_merlin_benchmark(n: int, lo: int, hi: int, seed: int = 0,
                         validate: int = 16, verbose: bool = False,
                         device: str = "cuda"):
    """Multi-length exact discord benchmark
    (:func:`mpx_torch.merlin.multi_length_discords`): one fused pan survey
    over every length in [lo, hi] and the per-length float64 rescore.
    Metric = pairs/s over the summed per-length join pairs.  Validation:
    for ``validate`` sampled rows at a few lengths, no exact row
    nearest-neighbor distance may exceed the reported discord."""
    from mpx_torch import MatrixProfileConfig
    from mpx_torch.merlin import _exact_row_rescore, multi_length_discords

    T = np.cumsum(np.random.default_rng(seed).standard_normal(n))
    ms = np.arange(lo, hi + 1)
    pairs = float(sum((n - m + 1) * (n - m) / 2 for m in ms))
    # the survey reads its device from the config and ignores its m
    cfg = MatrixProfileConfig(m=lo, device=device)

    multi_length_discords(T, lo, hi, config=cfg)  # warm-up
    _sync(device)
    t0 = time.perf_counter()
    result = multi_length_discords(T, lo, hi, config=cfg)
    _sync(device)
    wall = time.perf_counter() - t0

    val = None
    if validate:
        T64 = np.asarray(T, np.float64)
        rng = np.random.default_rng(seed + 1)
        checked = 0
        for d in result.per_length[:: max(1, len(result.per_length) // 3)]:
            w = n - d.m + 1
            rows = np.sort(rng.choice(w, size=min(validate, w), replace=False))
            D, _ = _exact_row_rescore(T64, d.m, rows, device=device)
            if D.max() > d.distance + 1e-9:
                raise ValidationError(f"m={d.m}: sampled row NN {D.max()} exceeds the "
                                      f"reported discord {d.distance}")
            checked += rows.shape[0]
        val = {"rows": checked}

    res = {
        "n": n, "m": int(ms[-1]), "dtype": "float32", "lengths": int(ms.size),
        "device": _device_name(device), "pairs": pairs, "wall_s": wall,
        "pairs_per_sec": pairs / wall,
        "top_discord": {"m": result.top[0].m, "index": result.top[0].index,
                        "score": result.top[0].score} if result.top else None,
    }
    if val:
        res["validation"] = val
    return res


def run_batch_benchmark(n: int, m: int, b: int, dtype: str = "float32",
                        band: int = 1024, chunk: int = 1024,
                        seed: int = 0, validate: int = 4,
                        verbose: bool = False, device: str = "cuda"):
    """Fleet benchmark: ``b`` equal-length series through
    :func:`mpx_torch.batch.compute_batch_profiles`.  Metric = total pairs/s
    across the fleet; ``series_ms`` is the wall a series.  Validation:
    ``validate`` sampled series, 16 rows each, against the exact float64
    oracle."""
    from mpx_torch import MatrixProfileConfig
    from mpx_torch.batch import compute_batch_profiles

    batch = np.cumsum(np.random.default_rng(seed).standard_normal((b, n)), axis=1)
    w = n - m + 1
    pairs = b * w * (w - 1) / 2
    cfg = MatrixProfileConfig(m=m, dtype=dtype, band=band, chunk=chunk, device=device)

    compute_batch_profiles(batch, config=cfg)  # warm-up
    _sync(device)
    t0 = time.perf_counter()
    MP, MPI = compute_batch_profiles(batch, config=cfg)  # numpy: the copy synchronizes
    wall = time.perf_counter() - t0

    val = None
    if validate:
        tol = 1e-8 if dtype in ("double", "float64") else 2e-3
        picks = np.random.default_rng(seed + 1).choice(b, size=min(validate, b), replace=False)
        worst = 0.0
        for s in picks:
            v = validate_sampled_rows(batch[s], m, MP[s], MPI[s], k=16, seed=seed + 2, tol=tol)
            worst = max(worst, v["max_abs_err"])
        val = {"series": int(picks.size), "rows_each": 16, "max_abs_err": worst, "tol": tol}
        if verbose:
            print(f"# validated {picks.size} fleet series: max err {worst:.2e}",
                  file=sys.stderr)

    return {
        "validation": val, "n": n, "m": m, "b": b, "dtype": dtype,
        "device": _device_name(device), "pairs": pairs, "wall_s": wall,
        "series_ms": wall / b * 1e3, "pairs_per_sec": pairs / wall,
        "baseline_model": ("total fleet pairs vs the U250 roofline; a series of w~8k "
                           "windows cannot fill the card, so compare series_ms too"),
        "mp_head": np.asarray(MP[0, :4], np.float64).tolist(),
    }


# The row kinds: the flag a SUITE row carries, and its runner (a row with
# none of them is a self-join through run_benchmark).
_RUNNERS = (("streaming", run_streaming_benchmark), ("topk", run_topk_benchmark),
            ("mstamp", run_mstamp_benchmark), ("contrast", run_contrast_benchmark),
            ("thresh", run_thresh_benchmark), ("damp", run_damp_benchmark),
            ("batch", run_batch_benchmark), ("matrix", run_matrix_benchmark),
            ("merlin", run_merlin_benchmark))


def run_suite(names=None, verbose: bool = False, on_row=None,
              device: str = "cuda") -> list:
    """Run the benchmark suite on ``device``; returns one result dict a
    row, each with ``vs_baseline`` against the U250 roofline and its
    ``provenance``.  ``names`` restricts it to those rows (and is the only
    way to run a ``huge`` row).  ``on_row(row)`` fires after every row,
    measured or failed.  A ValidationError (a wrong result) is raised; any
    other failure of a row is recorded as a row with a ``failed`` key and
    the suite goes on."""
    from mpx_torch.io.datasets import dataset_path

    flags = {flag for flag, _ in _RUNNERS}
    results = []
    for cfg in SUITE:
        if names and cfg["name"] not in names:
            continue
        if cfg.get("huge") and not names:
            continue
        kwargs = {k: v for k, v in cfg.items()
                  if k not in ("name", "input", "huge") and k not in flags}
        if "input" in cfg:
            kwargs["input_path"] = dataset_path(cfg["input"], category="real")
        runner = next((fn for flag, fn in _RUNNERS if cfg.get(flag)), run_benchmark)
        if verbose:
            print(f"# running {cfg['name']} ...", file=sys.stderr)
        try:
            res = runner(verbose=verbose, device=device, **kwargs)
        except ValidationError:
            raise  # a wrong result fails the suite
        except Exception as e:  # noqa: BLE001 - one row must not lose the others
            print(f"# {cfg['name']} FAILED: {e!r} — continuing", file=sys.stderr)
            results.append({"name": cfg["name"], "failed": repr(e),
                            "provenance": _provenance(device)})
            if on_row is not None:
                on_row(results[-1])
            continue
        res["name"] = cfg["name"]
        if "recompute_pairs" in res:
            # an incremental tier: speedup over full recomputation at the
            # reference's roofline (see run_streaming_benchmark)
            res["vs_baseline"] = (res["recompute_pairs"] / BASELINE_PAIRS_PER_SEC) / res["wall_s"]
        else:
            res["vs_baseline"] = res["pairs_per_sec"] / BASELINE_PAIRS_PER_SEC
        res["provenance"] = _provenance(device)
        results.append(res)
        if on_row is not None:
            on_row(res)
    return results


def _git_commit() -> str:
    """Short commit hash of the benchmarked tree ('?' outside git)."""
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             capture_output=True, text=True, timeout=10)
        return out.stdout.strip() or "?"
    except (OSError, subprocess.SubprocessError):
        return "?"


def _provenance(device="cuda") -> dict:
    """Measurement provenance, the analog of the reference's generated
    build-info.txt (CMakeLists.txt:145-149): the versions, the card's name
    and power limit, whether TF32 was allowed for the caller's float32
    products, whether the host C++ library loads (``native``), the
    statistics backend ``auto`` takes on ``device``, and when and on which
    commit the row was measured."""
    import mpx_torch
    from mpx_torch import native
    from mpx_torch.ops.precompute import resolve_backend

    return {
        "mpx_torch": mpx_torch.__version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": device_line(device),
        "device_count": torch.cuda.device_count() if torch.device(device).type == "cuda" else 1,
        "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "native": native.is_available(),
        "stats_backend": resolve_backend("auto", device),
        "measured_at": datetime.datetime.now(datetime.timezone.utc)
        .strftime("%Y-%m-%dT%H:%M:%SZ"),
        "commit": _git_commit(),
    }


def suite_table(results: list) -> str:
    """Markdown table of suite results."""
    lines = [
        "| config | n | m | dtype | wall (s) | pairs/s | vs U250 roofline |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in results:
        if "failed" in r:  # attempted but unmeasured
            when = r.get("provenance", {}).get("measured_at", "?")
            lines.append(f"| {r['name']} | — | — | — | FAILED ({when}) | — | — |")
            continue
        if "append_ms" in r:  # the stream: a latency an append, and the
            # speedup over full recomputation at the roofline
            wall = f"{r['append_ms']:.3f} ms/append"
            vs = (f"{r['vs_baseline']:.1f}x vs recompute" if "vs_baseline" in r
                  else "(incremental tier)")
        else:
            wall = f"{r['wall_s']:.3f}"
            vs = f"{r['vs_baseline']:.3f}x"
        lines.append(f"| {r['name']} | {r['n']:,} | {r['m']} | {r['dtype']} "
                     f"| {wall} | {r['pairs_per_sec']:.4e} | {vs} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mpx_torch bench")
    p.add_argument("-n", type=int, default=1 << 20)
    p.add_argument("-m", type=int, default=256)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--kernel", default="auto")
    p.add_argument("--band", type=int, default=4096)
    p.add_argument("--chunk", type=int, default=4096)
    p.add_argument("--input", default=None,
                   help="benchmark a dataset file instead of a random walk")
    p.add_argument("--validate", type=int, default=64,
                   help="spot-check this many rows against the exact float64 "
                        "oracle (0 disables); a mismatch fails the bench")
    p.add_argument("--shards", type=int, default=None,
                   help="the config's num_shards (the job list over that many devices)")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--suite", action="store_true",
                   help="run every BASELINE.md configuration; prints one JSON array")
    p.add_argument("--only", action="append", default=None,
                   help="restrict --suite to named configs (repeatable)")
    p.add_argument("--table", action="store_true",
                   help="with --suite: also print the markdown table to stderr")
    p.add_argument("--out", default=None, help="with --suite: write the JSON array to a file")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)

    print(device_line(args.device), flush=True)
    if args.suite:
        results = run_suite(names=args.only, verbose=args.verbose, device=args.device)
        blob = json.dumps(results, indent=2)
        print(blob)
        if args.out:
            with open(args.out, "w") as f:
                f.write(blob + "\n")
        if args.table:
            print(suite_table(results), file=sys.stderr)
        return 0

    res = run_benchmark(n=args.n, m=args.m, dtype=args.dtype, kernel=args.kernel,
                        band=args.band, chunk=args.chunk, shards=args.shards,
                        verbose=args.verbose, input_path=args.input, validate=args.validate,
                        device=args.device)
    print(json.dumps({k: res[k] for k in ("device", "n", "m", "dtype", "kernel", "wall_s",
                                          "compute_s", "validation", "counts")}))
    print(json.dumps({
        "metric": f"self-join distance-pairs/sec (n={res['n']}, m={args.m}, {args.dtype})",
        "value": res["pairs_per_sec"],
        "unit": "pairs/s",
        "vs_baseline": res["pairs_per_sec"] / BASELINE_PAIRS_PER_SEC,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
