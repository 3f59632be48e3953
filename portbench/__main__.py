"""``python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``:
one run of one cell; its last line on standard output is the result."""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python -m portbench", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse()
    from portbench import harness

    sys.exit(harness.main(args, _T_START))
