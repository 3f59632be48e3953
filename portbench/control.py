"""Readings that the limits of ``correct`` are set from, at a cell's own
size, in one process (set-up is paid once for the kernel library):

    python3 -m portbench.control --workload <cell> --seconds <s> --seeds <n> ... [--dtype float32]

Each seed is one whole run of the cell (``harness.run_cell``) and prints
one JSON line with the numbers compared.  Without ``--dtype`` these are
sound runs of the program (the lower readings); ``--dtype float32`` runs
the program's own float32 path in place of the configuration's float64,
the nearest precision below it (the control, whose readings are the upper
ones and have to come out as not correct).  The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import files, harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--dtype", default=None)
    args = p.parse_args(argv)
    overrides = {"config": {"dtype": args.dtype}} if args.dtype else None
    for seed in args.seeds:
        t = time.perf_counter()
        r = harness.run_cell(files.ROOT, args.workload, seed, args.seconds, False,
                             device="cuda", overrides=overrides)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "dtype": args.dtype or "as configured", "correct": r["correct"],
                          "attempted": r["attempted"], "failed": r["failed"],
                          "checks": {k: v["value"] for k, v in r["checks"].items()},
                          "wall_s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
