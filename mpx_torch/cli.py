"""Command-line interface, counterpart of ``mpx/cli.py``.

Only the ``compute`` subcommand is ported::

    python -m mpx_torch compute -i data/binary/16384.tsb -m 256 -o out

writes ``out.mpb`` / ``out.mpib`` byte-compatible with mpx's.
"""

from __future__ import annotations

import argparse
import sys


def _add_compute(sub):
    p = sub.add_parser("compute", help="compute a self-join matrix profile")
    p.add_argument("-i", "--input", required=True, help=".tsb/.txt[.gz] time series")
    p.add_argument("-o", "--output", help="output base path (writes .mpb/.mpib)")
    p.add_argument("-m", type=int, default=32, help="subsequence length")
    p.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    p.add_argument("--kernel", default="auto",
                   choices=("auto", "mxu", "mxu_fused", "xla", "pallas", "hybrid"))
    p.add_argument("--band", type=int, default=4096, help="rows per job (band height)")
    p.add_argument("--chunk", type=int, default=16384, help="diagonals per job")
    p.add_argument("--left-right", action="store_true",
                   help="emit left/right profiles (<o>.left/.right .mpb/.mpib)")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--verbose", action="store_true")
    return p


def _cmd_compute(args) -> int:
    from mpx_torch.config import MatrixProfileConfig
    from mpx_torch.driver import compute_matrix_profile
    from mpx_torch.io.tsb import read_series, write_results
    from mpx_torch.utils.profile import BenchmarkProfile

    T = read_series(args.input)
    if args.verbose:
        print(f"read {T.shape[0]} values from {args.input}")
    cfg = MatrixProfileConfig(
        m=args.m, dtype=args.dtype, kernel=args.kernel, band=args.band,
        chunk=args.chunk, device=args.device,
    )
    prof = BenchmarkProfile()
    out = compute_matrix_profile(T, config=cfg, profile=prof,
                                 left_right=args.left_right)
    out = [o.cpu().numpy() for o in out]
    if args.left_right:
        named = [(".left", out[0], out[1]), (".right", out[2], out[3])]
    else:
        named = [("", out[0], out[1])]
    if args.output:
        for suffix, MP, MPI in named:
            mpb, mpib = write_results(args.output + suffix, MP, MPI)
            print(f"wrote {mpb}, {mpib}")
    else:
        for row in zip(*(o[:10] for o in out)):
            print(*row)
        if out[0].shape[0] > 10:
            print(f"... ({out[0].shape[0]} total; pass -o to persist)")
    if args.verbose:
        prof.report(file=sys.stdout)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="mpx_torch", description="matrix-profile framework (PyTorch/CUDA port)"
    )
    sub = parser.add_subparsers(dest="command")
    _add_compute(sub)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if args.command is None:
        parser.print_help()
        return 2
    try:
        return _cmd_compute(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
