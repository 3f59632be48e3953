"""K3's batch cap: whole float64 self-joins through ``auto`` (K3 on a card)
at several caps (``mpx_torch.kernels.recurrence.BATCH_JOBS``), the
measurement behind the cap's value.

    python3 scripts/torch_k3_batch_cap.py [--n 1048576] [--m 256]
        [--caps 1,4,16,64,96] [--reps 3] [--seed 22] [--out caps.json]
        [--device cuda]

For each cap, in turn and then again in reverse order, it runs one
self-join of a random walk to warm up and ``--reps`` timed ones through
``mpx_torch.matrix_profile`` (statistics, the job loop, the copy back:
what the benchmark's self-join cell times), each between two host clock
reads after a synchronize, and the card's peak memory over them.  It
prints the card's name and power limit and one line per cap and pass,
and with ``--out`` writes them as JSON.  ``--device cpu`` runs the plain
versions, to rehearse the script at a small ``--n``.
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
import mpx_torch  # noqa: E402
from mpx_torch.bench import device_line  # noqa: E402
from mpx_torch.kernels import recurrence  # noqa: E402


def run_cap(T, m: int, cap: int, reps: int, device) -> dict:
    cuda = device.type == "cuda"
    recurrence.BATCH_JOBS = cap
    mpx_torch.matrix_profile(T, m, dtype="float64", kernel="pallas", device=str(device))
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    walls = []
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        mpx_torch.matrix_profile(T, m, dtype="float64", kernel="pallas", device=str(device))
        walls.append(time.perf_counter() - t0)
    w = T.shape[0] - m + 1
    med = statistics.median(walls)
    return {"cap": cap, "walls_s": walls, "median_s": med,
            "pairs_per_s": w * (w - 1) / 2 / med,
            "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--m", type=int, default=256)
    ap.add_argument("--caps", default="1,4,16,64,96")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=22)
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    print(device_line(device), flush=True)
    T = np.cumsum(np.random.default_rng(args.seed).standard_normal(args.n))
    caps = [int(x) for x in args.caps.split(",")]
    rows = []
    for cap in caps + caps[::-1]:
        row = run_cap(T, args.m, cap, args.reps, device)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": device_line(device), "n": args.n, "m": args.m, "rows": rows},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
