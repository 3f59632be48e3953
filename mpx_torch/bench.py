"""Benchmark's single run, counterpart of ``mpx/bench.py`` (``main`` without
``--suite``)::

    python -m mpx_torch bench -n 1048576 -m 256 --dtype float64 \\
        --kernel pallas --chunk 32768 --validate 64

Headline metric: distance pairs per second of one self-join (pairs =
w(w-1)/2, the upper triangle, exclusion-zone pairs included), timed on the
host clock around a run that ends in ``torch.cuda.synchronize()``, after a
warm-up run that builds the kernels.  ``vs_baseline`` compares it with
``BASELINE_PAIRS_PER_SEC``, the reference FPGA build's ideal roofline
(BASELINE.md).  The result is held to an exact float64 numpy row scan on
sampled rows before it is printed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

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


def run_benchmark(n: int = 1 << 20, m: int = 256, dtype: str = "float32",
                  kernel: str = "auto", band: int = 4096, chunk: int = 4096,
                  seed: int = 0, verbose: bool = False, input_path=None,
                  validate: int = 64, warmup: bool = True, device: str = "cuda"):
    """One self-join, timed: a warm-up run (kernel builds), then a run on
    the host clock that ends in ``torch.cuda.synchronize()``.  Returns
    mpx's keys (``pairs_per_sec``, ``compute_s``, ``validation``, ...)."""
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
                              device=device)
    cuda = torch.device(device).type == "cuda"

    def run(prof):
        t0 = time.perf_counter()
        MP, MPI = compute_matrix_profile(T, config=cfg, profile=prof)
        if cuda:
            torch.cuda.synchronize(device)
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
        "device": torch.cuda.get_device_name(device) if cuda else str(device),
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
    from mpx_torch.ops.precompute import precompute_statistics_numpy

    rng = np.random.default_rng(seed)
    Tp = np.cumsum(rng.standard_normal(n))
    Tm = np.cumsum(np.random.default_rng(seed + 7).standard_normal(n))
    w = n - m + 1
    pairs = w * (w - 1) / 2 + float(w) * w
    cfg = MatrixProfileConfig(m=m, dtype=dtype, band=band, chunk=chunk, device=device)
    cuda = torch.device(device).type == "cuda"

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
        sp, sm = precompute_statistics_numpy(Tp, m), precompute_statistics_numpy(Tm, m)
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
        "device": torch.cuda.get_device_name(device) if cuda else str(device),
        "pairs": pairs, "wall_s": wall, "pairs_per_sec": pairs / wall,
        "mp_head": cp[:4].tolist(),
    }


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
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--suite", action="store_true",
                   help="every BASELINE.md configuration (not ported)")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    if args.suite:
        raise NotImplementedError(
            "mpx_torch bench --suite is not ported yet: ROADMAP.md queue 1 item 14 "
            "(its rows need tiers the port does not have yet)")

    print(device_line(args.device), flush=True)
    res = run_benchmark(n=args.n, m=args.m, dtype=args.dtype, kernel=args.kernel,
                        band=args.band, chunk=args.chunk, verbose=args.verbose,
                        input_path=args.input, validate=args.validate,
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
