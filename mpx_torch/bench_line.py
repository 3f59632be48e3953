"""The one-line benchmark contract, counterpart of the root ``bench.py``::

    python -m mpx_torch.bench_line [--device cpu] [-n N]

runs the reference's showcase job (the root script's ``SHOWCASE``: double,
n = 2^20, m = 256, band 4096, chunk 32768) through ``kernel='auto'`` (K3
on the card) with :func:`mpx_torch.bench.run_benchmark`: a warm-up run, a
timed run, 64 sampled rows held to the exact float64 oracle.  It prints one
JSON line: the root script's ``metric`` / ``value`` / ``unit`` /
``vs_baseline``, and beside them the device's name and power limit as
``nvidia-smi --query-gpu=name,power.limit`` reports them.  ``vs_baseline``
is the root script's: pairs/s over ``bench.BASELINE_PAIRS_PER_SEC``, the
reference build's roofline, because ``BASELINE.json`` publishes no
measured number; the line carries the file's ``published`` entry as
``baseline_published``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

# The root bench.py's SHOWCASE job.
SHOWCASE = {"n": 1 << 20, "m": 256, "dtype": "double", "band": 4096, "chunk": 32768}
BASELINE_JSON = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "BASELINE.json")


def baseline_published(path: str = BASELINE_JSON) -> dict:
    """``BASELINE.json``'s published reference numbers."""
    with open(path) as f:
        return json.load(f)["published"]


def bench_line(n: int = SHOWCASE["n"], device: str = "cuda") -> dict:
    """The showcase job at length ``n`` on ``device``, measured and
    validated: the line's keys."""
    from mpx_torch.bench import BASELINE_PAIRS_PER_SEC, device_line, run_benchmark

    job = dict(SHOWCASE, n=n)
    published = baseline_published()
    res = run_benchmark(**job, kernel="auto", validate=64, device=device)
    if torch.device(device).type == "cuda":
        name, _, limit = device_line(device).partition(", ")
    else:
        name, limit = str(torch.device(device)), None
    return {
        "metric": f"self-join distance-pairs/sec (n={res['n']}, m={job['m']}, {job['dtype']})",
        "value": res["pairs_per_sec"],
        "unit": "pairs/s",
        "vs_baseline": res["pairs_per_sec"] / BASELINE_PAIRS_PER_SEC,
        "device": name,
        "power_limit": limit,
        "baseline_published": published,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m mpx_torch.bench_line")
    p.add_argument("-n", type=int, default=SHOWCASE["n"], help="series length")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)
    print(json.dumps(bench_line(args.n, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
