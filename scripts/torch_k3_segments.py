"""K3 on one tree of the repo: a full batch's kernels, a lone job, small
float64 self-joins and the anytime tier, the readings behind K3's segment
rule (``mpx_torch.kernels.recurrence.segment_rows``).

    python3 scripts/torch_k3_segments.py --tree TREE [--label NAME]
        [--reps 5] [--seed 25] [--out readings.jsonl] [--skip-anytime]

``TREE`` is a checkout of the repo (this one, or another commit unpacked
beside it): its ``mpx_torch`` is imported, so two trees are compared by
running the script once for each in one call to the card.  It prints the
card's name and power limit, then one JSON line for each reading:

* ``full_batch``: 16 jobs of one k0 (S = 4096, W = 16384, m = 256, on a
  2^20-point walk) in one ``sweep_batches`` call, its CUDA-event time and
  each K3 kernel's profiler time, over 16;
* ``spread_batch``: 16 jobs of that k0 65,536 rows apart, the span of the
  whole profile (as anytime's shuffled batches), the same readings;
* ``lone_job``: one such job through ``sweep_band_recurrence`` (a batch of
  one), the same readings;
* ``small``: float64 self-joins through ``auto`` at m = 256, n = 2^14 and
  2^16, the median wall time of a call (host clock after a synchronize,
  the profile in numpy);
* ``selfjoin``: the 2^20-point float64 self-join's wall time, and each K3
  kernel's device time in one traced self-join;
* ``anytime``: the 2^20-point anytime tier (16 shuffled parts, numpy after
  each) to its end, its wall time, and each K3 kernel's device time and
  launch count in one traced run.

``--out`` appends the lines to a file as well.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
import time


def _kernel_times(torch, fn) -> dict:
    """Device time (ms) and launches of each K3 kernel over one run of
    ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        found = re.search(r"k3_\w+<\w+>", e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA and found:
            name = found.group(0)
            ms, n = out.get(name, (0.0, 0))
            out[name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return {k: {"ms": v[0], "launches": v[1]} for k, v in sorted(out.items())}


def _wall(torch, fn, reps: int) -> list:
    fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=25)
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-anytime", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))

    import numpy as np
    import torch

    import mpx_torch
    from mpx_torch.anytime import anytime_matrix_profile
    from mpx_torch.bench import device_line
    from mpx_torch.config import MatrixProfileConfig
    from mpx_torch.dtypes import AGGREGATE_INIT
    from mpx_torch.kernels.common import band_geometry
    from mpx_torch.kernels.recurrence import sweep_band_recurrence, sweep_batches
    from mpx_torch.ops.aggregates import init_aggregates
    from mpx_torch.ops.precompute import precompute_statistics

    label = args.label or args.tree
    print(device_line(torch.device("cuda")), flush=True)

    def say(what: str, **kw):
        line = json.dumps({"tree": label, "reading": what, **kw})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    rng = np.random.default_rng(args.seed)
    n, m, S, W = 1 << 20, 256, 4096, 16384
    T = np.cumsum(rng.standard_normal(n))
    w = n - m + 1
    stats = precompute_statistics(T, m, band=S, chunk=W, dtype="float64", device="cuda",
                                  windows=False, exact_mean=True)
    geom = band_geometry(S, W, m, w)
    k0s = [W] * 16
    rows, cols = (init_aggregates(w + S + W, torch.float64, AGGREGATE_INIT, "cuda")
                  for _ in range(2))

    def batch(r0s):
        for _ in sweep_batches(stats, r0s, k0s, geom=geom, dtype="float64", rows=rows,
                               cols=cols):
            pass

    def lone():
        sweep_band_recurrence(stats, 3 * S, W, geom, "float64")

    for what, fn, jobs in (("full_batch", lambda: batch([j * S for j in range(16)]), 16),
                           ("spread_batch", lambda: batch([j * 65536 for j in range(16)]), 16),
                           ("lone_job", lone, 1)):
        walls = _wall(torch, fn, 20)
        kernels = _kernel_times(torch, fn)
        say(what, jobs=jobs, wall_ms_per_job=statistics.median(walls) * 1e3 / jobs,
            kernels_ms_per_job={k: v["ms"] / jobs for k, v in kernels.items()},
            kernels_total_ms_per_job=sum(v["ms"] for v in kernels.values()) / jobs,
            launches={k: v["launches"] for k, v in kernels.items()})
    del stats, rows, cols

    for small_n in (1 << 14, 1 << 16):
        Ts = np.cumsum(rng.standard_normal(small_n))
        walls = _wall(torch, lambda: mpx_torch.matrix_profile(Ts, m, dtype="float64"),
                      5 * args.reps)
        say("small", n=small_n, m=m, walls_ms=[x * 1e3 for x in walls],
            median_ms=statistics.median(walls) * 1e3)

    run = lambda: mpx_torch.matrix_profile(T, m, dtype="float64")  # noqa: E731
    walls = _wall(torch, run, args.reps)
    say("selfjoin", n=n, m=m, walls_s=walls, median_s=statistics.median(walls),
        pairs_per_s=w * (w - 1) / 2 / statistics.median(walls),
        kernels=_kernel_times(torch, run))

    if not args.skip_anytime:
        cfg = MatrixProfileConfig(m=m, dtype="float64", device="cuda")

        def anytime():
            for _ in anytime_matrix_profile(T, config=cfg, batches=16, order="shuffled"):
                pass

        walls = _wall(torch, anytime, max(2, args.reps // 2))
        say("anytime", n=n, m=m, walls_s=walls, median_s=statistics.median(walls),
            kernels=_kernel_times(torch, anytime))
    return 0


if __name__ == "__main__":
    sys.exit(main())
