"""K1 against K3 per job in float64, through the driver's job loop: the
measurement behind ``auto``'s float64 route on a CUDA device
(``mpx_torch.kernels.K3_MIN_M_F64``).

    python3 scripts/torch_k3_route.py [--n 1048576] [--band 4096]
        [--chunks 16384,32768] [--ms 8,16,32,64,128,256,512,1024,2048,4096]
        [--jobs 64] [--reps 3] [--out chiprun_out/k3_route.json] [--device cuda]

For each chunk W and window length m it stages a random walk's float64
statistics once for each kernel, as the driver does for it (K1: the
unit-window matrix; K3: the corrected means), then times
``driver.run_jobs`` over ``--jobs`` jobs taken at even steps from the
self-join's job grid: each job's seed, launches and both merges, between
two CUDA events around the whole loop, so a host slower than the card
sets the pace, as it does in a self-join.  One warm-up pass of the same
jobs, then ``--reps`` timed passes; a job's time is the median pass over
the job count.  It prints the card's name and power limit, one line per
(W, m), and writes the table as JSON.  ``--device cpu`` runs the plain
versions on the host clock, to rehearse the script at a small ``--n``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from mpx_torch.bench import device_line  # noqa: E402
from mpx_torch.config import make_job_grid  # noqa: E402
from mpx_torch.driver import run_jobs  # noqa: E402
from mpx_torch.kernels import band_geometry, is_recurrence, needs_windows  # noqa: E402
from mpx_torch.ops.precompute import precompute_statistics  # noqa: E402
from mpx_torch.types import JobGrid  # noqa: E402

KERNELS = {"k1": "mxu_fused", "k3": "pallas"}


def _ints(text: str) -> list:
    return [int(x) for x in text.split(",")]


def time_jobs(stats, grid, geom, kernel: str, device, reps: int) -> float:
    """Median milliseconds a job over ``reps`` passes of ``grid`` after one
    warm-up pass."""
    cuda = device.type == "cuda"
    jobs = len(grid.r0)
    passes = []
    for rep in range(reps + 1):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize(device)
            start.record()
            run_jobs(stats, grid, geom=geom, dtype=torch.float64, kernel=kernel)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            run_jobs(stats, grid, geom=geom, dtype=torch.float64, kernel=kernel)
            ms = (time.perf_counter() - t0) * 1e3
        if rep:
            passes.append(ms / jobs)
    return statistics.median(passes)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=1 << 20)
    p.add_argument("--band", type=int, default=4096)
    p.add_argument("--chunks", type=_ints, default=[16384, 32768])
    p.add_argument("--ms", type=_ints, default=[8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096])
    p.add_argument("--jobs", type=int, default=64)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--seed", type=int, default=20)
    p.add_argument("--out", default="chiprun_out/k3_route.json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    card = device_line(device)
    clock = "CUDA events" if device.type == "cuda" else "host clock"
    print(f"# {card}; torch {torch.__version__}; {clock}", flush=True)
    T = np.cumsum(np.random.default_rng(args.seed).standard_normal(args.n))
    rows = []
    for W in args.chunks:
        for m in args.ms:
            w = args.n - m + 1
            full = make_job_grid(w, args.band, W)
            pick = np.unique(np.linspace(0, len(full.r0) - 1, args.jobs).round().astype(int))
            grid = JobGrid(r0=full.r0[pick], k0=full.k0[pick], band=args.band, chunk=W)
            geom = band_geometry(args.band, W, m, w)
            row = {"m": m, "W": W, "S": args.band, "n": args.n, "jobs": len(pick)}
            for name, kernel in KERNELS.items():
                stats = precompute_statistics(T, m, band=args.band, chunk=W,
                                              dtype=torch.float64, device=device,
                                              windows=needs_windows(kernel),
                                              exact_mean=is_recurrence(kernel))
                row[f"{name}_ms"] = time_jobs(stats, grid, geom, kernel, device, args.reps)
                del stats
                if device.type == "cuda":
                    torch.cuda.empty_cache()
            row["k1_over_k3"] = row["k1_ms"] / row["k3_ms"]
            rows.append(row)
            print(f"W={W} m={m}: K1 {row['k1_ms']:.4f} ms, K3 {row['k3_ms']:.4f} ms a job "
                  f"(K1/K3 {row['k1_over_k3']:.2f}; {row['jobs']} jobs)", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": card, "torch": torch.__version__, "clock": clock,
                       "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
