"""Command-line interface, counterpart of ``mpx/cli.py``.

* ``compute``  — a self-join matrix profile (``--left-right`` for the
  left/right profiles, ``--dtype ap16|ap24|ap32|ap64`` for the
  fixed-point input tier, ``--raw`` for the raw-Euclidean AAMP profile,
  ``--checkpoint`` for a resumable run, ``--approx`` for the anytime
  tier's upper bounds, ``--allow-missing`` for masked gaps);
* ``abjoin``   — the AB-join of two series (``<o>.a``/``<o>.b``
  ``.mpb``/``.mpib``);
* ``topk``     — the k nearest neighbors of every window (``<o>.topk.npz``);
* ``thresh``   — the sum-threshold and frequency profile
  (``<o>.thresh.npz``);
* ``matrix``   — the pooled distance-matrix summary (``<o>.dm.npy``);
* ``mstamp``   — the multi-dimensional profile, one ``-i`` a dimension
  (``<o>.mstamp.npz``);
* ``pan``      — the pan profile over a range of window sizes
  (``<o>.pan.npz``);
* ``merlin``   — the exact discord (``--motifs``: motif pair) at every
  window length in a range;
* ``damp``     — DAMP anomalies: the left-profile discords after a split
  (``<o>.damp.npy``);
* ``batch``    — the profiles of a fleet of equal-length series, one
  ``-i`` each (``<o>.<stem>.mpb``/``.mpib``);
* ``floss``    — online segmentation: the series replayed through FLOSS
  in ``--step`` chunks;
* ``analyze``  — motifs and discords of a series or saved results
  (``--regimes``, ``--chain``, ``--av complexity``);
* ``chains``   — the longest (or ``--anchor``) time series chain;
* ``contrast`` — the contrast profile of two series (``<o>.cp.npy``;
  ``--pan`` over several window lengths, ``<o>.pancp.npz``);
* ``ostinato`` — the consensus motif of several series;
* ``snippets`` — the k most representative L-length segments;
* ``cluster``  — series clustered by MPdist;
* ``motiflets`` — the k-motiflet (``--elbows`` for the extent curve);
* ``query``    — occurrences of a query window (MASS on the host,
  ``<o>.mpb`` the distance profile);
* ``tsbin``    — encode/decode binary series files (ascii <-> .tsb / int /
  MPXQ fixed-point containers);
* ``golden``   — golden MP/MPI through the numpy oracle
  (:mod:`mpx_torch.reference`);
* ``datasets`` — list the datasets under ``data/``;
* ``bench``    — the benchmark's single run (:mod:`mpx_torch.bench`).

::

    python -m mpx_torch compute -i data/binary/16384.tsb -m 256 -o out

writes ``out.mpb`` / ``out.mpib``; every subcommand writes the same bytes
as mpx's.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from mpx_torch.utils.logging import Logger

_DTYPES = ("float32", "float64", "ap16", "ap24", "ap32", "ap64")


def _add_compute(sub):
    p = sub.add_parser("compute", help="compute a self-join matrix profile")
    p.add_argument("-i", "--input", required=True, help=".tsb/.txt[.gz] time series")
    p.add_argument("-o", "--output", help="output base path (writes .mpb/.mpib)")
    p.add_argument("-m", type=int, default=32, help="subsequence length")
    p.add_argument("--dtype", default="float32", choices=_DTYPES,
                   help="compute dtype; ap* = fixed-point input tier")
    p.add_argument("--kernel", default="auto",
                   choices=("auto", "mxu", "mxu_fused", "xla", "pallas", "hybrid"))
    p.add_argument("--band", type=int, default=4096, help="rows per job (band height)")
    p.add_argument("--chunk", type=int, default=16384, help="diagonals per job")
    p.add_argument("--shards", type=int, default=None, help="device count")
    p.add_argument("--shard-mode", default="jobs", choices=("jobs", "ring"),
                   help="'jobs' replicates stats and shards the job list; "
                        "'ring' shards the inputs (memory per device O(n / shards))")
    p.add_argument("--left-right", action="store_true",
                   help="emit left/right profiles (<o>.left/.right .mpb/.mpib)")
    p.add_argument("--raw", action="store_true",
                   help="raw Euclidean (non-normalized, AAMP) profile")
    p.add_argument("--checkpoint", help="checkpoint file for resumable runs")
    p.add_argument("--approx", type=float, default=None, metavar="FRACTION",
                   help="anytime tier: sweep only this fraction of the job grid "
                        "(distances are upper bounds, exact at 1.0)")
    p.add_argument("--allow-missing", action="store_true",
                   help="masked gaps: windows overlapping a NaN/inf sample are "
                        "excluded from both sides of the join")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--verbose", action="store_true")
    return p


def _cmd_compute(args) -> int:
    from mpx_torch.config import MatrixProfileConfig
    from mpx_torch.driver import compute_matrix_profile
    from mpx_torch.io.tsb import read_series, write_results
    from mpx_torch.utils.profile import BenchmarkProfile

    # mpx's refusals of flag combinations it would silently ignore.
    if args.left_right and args.checkpoint:
        raise SystemExit("--left-right does not support --checkpoint")
    if args.checkpoint and args.shards:
        raise SystemExit("--checkpoint does not support --shards "
                         "(checkpointed runs execute single-device)")
    if args.approx is not None and (args.checkpoint or args.left_right or args.shards):
        raise SystemExit("--approx is a single-device full-profile mode")
    if args.raw and (args.checkpoint or args.left_right or args.shards
                     or args.approx is not None):
        raise SystemExit("--raw is a single-device full-profile mode")
    if args.allow_missing and (args.checkpoint or args.approx is not None or args.raw):
        raise SystemExit("--allow-missing supports the plain and --left-right/--shards "
                         "profile modes only")
    Logger.verbose = args.verbose
    T = read_series(args.input)
    Logger.verbose_log(f"read {T.shape[0]} values from {args.input}")
    cfg = MatrixProfileConfig(
        m=args.m, dtype=args.dtype, kernel=args.kernel, band=args.band,
        chunk=args.chunk, num_shards=args.shards, shard_mode=args.shard_mode,
        device=args.device,
    )
    prof = BenchmarkProfile()
    if args.allow_missing:
        from mpx_torch.missing import compute_matrix_profile_masked as _compute
    else:
        _compute = compute_matrix_profile
    if args.checkpoint:
        from mpx_torch.checkpoint import compute_with_checkpoint

        out = compute_with_checkpoint(T, cfg, args.checkpoint, profile=prof)
    elif args.approx is not None:
        from mpx_torch.anytime import approx_matrix_profile

        *out, frac = approx_matrix_profile(T, config=cfg, fraction=args.approx)
        Logger.info(f"approximate profile from {frac:.0%} of the job grid "
                    f"(upper-bound distances)")
    elif args.raw:
        from mpx_torch.aamp import compute_aamp_profile

        out = compute_aamp_profile(T, config=cfg)
    else:
        out = _compute(T, config=cfg, profile=prof, left_right=args.left_right)
    # checkpointed and anytime runs return numpy, the driver tensors
    out = [o if isinstance(o, np.ndarray) else o.cpu().numpy() for o in out]
    if args.left_right:
        named = [(".left", out[0], out[1]), (".right", out[2], out[3])]
    else:
        named = [("", out[0], out[1])]
    if args.output:
        for suffix, MP, MPI in named:
            mpb, mpib = write_results(args.output + suffix, MP, MPI)
            Logger.info(f"wrote {mpb}, {mpib}")
    else:
        for row in zip(*(o[:10] for o in out)):
            print(*row)
        if out[0].shape[0] > 10:
            print(f"... ({out[0].shape[0]} total; pass -o to persist)")
    if args.verbose:
        prof.report(file=sys.stdout)
    return 0


def _add_abjoin(sub):
    p = sub.add_parser("abjoin", help="AB-join: profile of series A against series B")
    p.add_argument("-a", "--input-a", required=True)
    p.add_argument("-b", "--input-b", required=True)
    p.add_argument("-o", "--output", help="base path; writes <o>.a.mpb/.mpib and <o>.b.mpb/.mpib")
    p.add_argument("-m", type=int, default=32)
    p.add_argument("--dtype", default="float32", choices=_DTYPES)
    p.add_argument("--band", type=int, default=4096)
    p.add_argument("--chunk", type=int, default=4096)
    p.add_argument("--mpdist", action="store_true",
                   help="also print MPdist(A, B) (k-th smallest of the "
                        "ABBA-join profiles, k = 5%% of len(A)+len(B))")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--verbose", action="store_true")
    return p


def _cmd_abjoin(args) -> int:
    from mpx_torch.abjoin import compute_ab_join
    from mpx_torch.config import MatrixProfileConfig
    from mpx_torch.io.tsb import read_series, write_results
    from mpx_torch.utils.profile import BenchmarkProfile

    Logger.verbose = args.verbose
    A, B = read_series(args.input_a), read_series(args.input_b)
    cfg = MatrixProfileConfig(m=args.m, dtype=args.dtype, band=args.band, chunk=args.chunk,
                              device=args.device)
    prof = BenchmarkProfile()
    res = [o.cpu().numpy() for o in compute_ab_join(A, B, config=cfg, profile=prof)]
    if args.output:
        write_results(args.output + ".a", res[0], res[1])
        write_results(args.output + ".b", res[2], res[3])
        Logger.info(f"wrote {args.output}.a/.b .mpb/.mpib")
    else:
        for d, i in zip(res[0][:10], res[1][:10]):
            print(d, i)
    if args.mpdist:
        from mpx_torch.analysis import mpdist_from_profiles

        d = mpdist_from_profiles(res[0], res[2], A.shape[0], B.shape[0])
        print(f"MPdist: {d:.6f}")
    if args.verbose:
        prof.report(file=sys.stdout)
    return 0


def _add_topk(sub):
    p = sub.add_parser("topk", help="k nearest neighbors per subsequence")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-m", type=int, required=True)
    p.add_argument("-k", type=int, default=4)
    p.add_argument("-o", "--output", help="writes <o>.topk.npz (distances, indices)")
    p.add_argument("--dtype", default="float32", choices=_DTYPES)
    p.add_argument("--band", type=int, default=4096)
    p.add_argument("--chunk", type=int, default=4096)
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    return p


def _cmd_topk(args) -> int:
    from mpx_torch.config import MatrixProfileConfig
    from mpx_torch.io.tsb import read_series
    from mpx_torch.topk import compute_topk_profile

    cfg = MatrixProfileConfig(m=args.m, dtype=args.dtype, band=args.band, chunk=args.chunk,
                              device=args.device)
    D, I = (o.cpu().numpy() for o in compute_topk_profile(read_series(args.input), k=args.k,
                                                          config=cfg))
    if args.output:
        np.savez(args.output + ".topk", distances=D, indices=I)
        Logger.info(f"wrote {args.output}.topk.npz")
    else:
        for row_d, row_i in zip(D[:5], I[:5]):
            print(" ".join(f"{d:.4f}@{i}" for d, i in zip(row_d, row_i)))
        if D.shape[0] > 5:
            print(f"... ({D.shape[0]} rows; pass -o to persist)")
    return 0


def _add_thresh(sub):
    p = sub.add_parser(
        "thresh", help="sum-threshold / frequency profile (pattern density)",
        description="Per window: the SUM of Pearson correlations to every non-trivial "
        "neighbor above --threshold, and the COUNT of such neighbors (SCAMP's "
        "SUM_THRESH / FREQUENCY_THRESH profile types).")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-m", type=int, required=True)
    p.add_argument("--threshold", type=float, default=0.0,
                   help="correlation threshold in [-1, 1] (default 0)")
    p.add_argument("-k", type=int, default=5, help="print the k densest windows (default 5)")
    p.add_argument("-o", "--output", help="write <out>.thresh.npz (sums, counts)")
    p.add_argument("--band", type=int, default=None,
                   help="job band rows (default: config default)")
    p.add_argument("--chunk", type=int, default=None,
                   help="job diagonal chunk (default: config default)")
    p.add_argument("--dtype", default="float32", choices=_DTYPES)
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--verbose", action="store_true")
    return p


def _cmd_thresh(args) -> int:
    from mpx_torch.config import MatrixProfileConfig
    from mpx_torch.io.tsb import read_series
    from mpx_torch.thresh import compute_sum_thresh

    Logger.verbose = args.verbose
    kw = {k: v for k, v in (("band", args.band), ("chunk", args.chunk)) if v is not None}
    cfg = MatrixProfileConfig(m=args.m, dtype=args.dtype, device=args.device, **kw)
    sums, cnts = (o.cpu().numpy() for o in compute_sum_thresh(
        read_series(args.input), config=cfg, threshold=args.threshold))
    if args.output:
        np.savez(args.output + ".thresh.npz", sums=sums, counts=cnts)
        print(f"wrote {args.output}.thresh.npz")
    print(f"densest windows (threshold {args.threshold}):")
    for i in np.argsort(-sums)[: max(args.k, 0)]:
        print(f"  {int(i):>8}  sum {sums[i]:.6f}  count {int(cnts[i])}")
    return 0


def _add_matrix(sub):
    p = sub.add_parser("matrix",
                       help="pooled distance-matrix summary (heatmap of the whole join)")
    p.add_argument("-i", "--input", required=True,
                   help=".tsb/.txt[.gz] time series (rows)")
    p.add_argument("-b", "--b-input", default=None,
                   help="second series (AB-join columns); omit: self-join")
    p.add_argument("-m", type=int, default=32, help="subsequence length")
    p.add_argument("--mwidth", type=int, default=50, help="summary columns")
    p.add_argument("--mheight", type=int, default=50, help="summary rows")
    p.add_argument("--pearson", action="store_true",
                   help="emit max correlations instead of min distances")
    p.add_argument("-o", "--output", help="writes <o>.dm.npy (float64 mheight x mwidth)")
    p.add_argument("--band", type=int, default=4096)
    p.add_argument("--chunk", type=int, default=4096)
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--verbose", action="store_true")
    return p


def _cmd_matrix(args) -> int:
    from mpx_torch.config import MatrixProfileConfig
    from mpx_torch.distmatrix import pooled_matrix
    from mpx_torch.io.tsb import read_series

    Logger.verbose = args.verbose
    T = read_series(args.input)
    B = read_series(args.b_input) if args.b_input else None
    cfg = MatrixProfileConfig(m=args.m, band=args.band, chunk=args.chunk,
                              device=args.device)
    M = pooled_matrix(T, args.m, mwidth=args.mwidth, mheight=args.mheight, B=B,
                      pearson=args.pearson, config=cfg)
    kind = "max correlation" if args.pearson else "min distance"
    print(f"pooled {M.shape[0]} x {M.shape[1]} summary ({kind})")
    r, c = divmod(int(np.argmax(M) if args.pearson else np.argmin(M)), M.shape[1])
    print(f"  best cell: ({r}, {c}) value {M[r, c]:.6f}")
    if args.output:
        np.save(args.output + ".dm.npy", M)
        Logger.info(f"wrote {args.output}.dm.npy")
    return 0


def _add_mstamp(sub):
    p = sub.add_parser("mstamp", help="multi-dimensional matrix profile (one -i per dimension)")
    p.add_argument("-i", "--input", action="append", required=True,
                   help="one series file per dimension (equal lengths); repeatable")
    p.add_argument("-m", type=int, required=True)
    p.add_argument("-o", "--output", help="writes <o>.mstamp.npz (PMP, PMPI)")
    p.add_argument("--dtype", default="float32", choices=_DTYPES)
    p.add_argument("--include", type=int, action="append", default=None,
                   help="dimension index that must be in every k-subset "
                        "(repeatable; constrained mSTAMP search)")
    p.add_argument("--discords", action="store_true",
                   help="average the k LARGEST per-dim distances "
                        "(multi-dimensional discord search)")
    p.add_argument("--mdl", action="store_true",
                   help="pick the meaningful dimensionality k by minimum description "
                        "length (motif mode only)")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--verbose", action="store_true")
    return p


def _cmd_mstamp(args) -> int:
    from mpx_torch.config import MatrixProfileConfig
    from mpx_torch.io.tsb import read_series
    from mpx_torch.mstamp import (
        compute_multidim_profile,
        multidim_discord,
        multidim_mdl,
        multidim_motif,
        multidim_subspace,
    )

    Logger.verbose = args.verbose
    series = [read_series(p) for p in args.input]
    lengths = {s.shape[0] for s in series}
    if len(lengths) != 1:
        raise ValueError(f"dimension series differ in length: {sorted(lengths)}")
    T = np.stack(series)
    prof = compute_multidim_profile(
        T, config=MatrixProfileConfig(m=args.m, dtype=args.dtype, device=args.device),
        include=args.include, discords=args.discords)
    if args.output:
        np.savez_compressed(args.output + ".mstamp.npz", PMP=prof.PMP, PMPI=prof.PMPI)
        Logger.info(f"wrote {args.output}.mstamp.npz "
                    f"({prof.PMP.shape[0]} x {prof.PMP.shape[1]})")
    if args.discords:
        print("k, strongest k-dimensional discord (i, distance, dims):")
    else:
        print("k, best k-dimensional motif (i, j, distance, dims):")
    for k in range(1, T.shape[0] + 1):
        if not np.isfinite(prof.PMP[k - 1]).any():
            print(f"  {k:3d} (no valid pairs)")
            continue
        if args.discords:
            i, dist = multidim_discord(prof, k)
            dims = multidim_subspace(T, args.m, i, int(prof.PMPI[k - 1, i]), k,
                                     include=args.include, discords=True)
            print(f"  {k:3d} ({i}) d={dist:.4f} dims={dims.tolist()}")
        else:
            i, j, dist = multidim_motif(prof, k)
            dims = multidim_subspace(T, args.m, i, j, k, include=args.include)
            print(f"  {k:3d} ({i}, {j}) d={dist:.4f} dims={dims.tolist()}")
    if args.mdl:
        if args.discords:
            raise ValueError("--mdl selects motif dimensionality; drop --discords")
        res = multidim_mdl(T, args.m, profile=prof, include=args.include)
        print(f"MDL: best k = {res.best_k} "
              f"(bit saves {np.round(res.bitsaves, 1).tolist()})")
    return 0


def _add_pan(sub):
    p = sub.add_parser("pan", help="pan matrix profile over a range of window sizes")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("--m-lo", type=int, required=True, help="smallest m")
    p.add_argument("--m-hi", type=int, required=True, help="largest m")
    p.add_argument("--count", type=int, default=16, help="number of log-spaced window sizes")
    p.add_argument("-o", "--output", help="writes <o>.pan.npz (ms, PMP, PMPI)")
    p.add_argument("--dtype", default="float32", choices=_DTYPES)
    p.add_argument("--kernel", default="auto",
                   choices=("auto", "mxu", "mxu_fused", "xla", "pallas", "hybrid"))
    p.add_argument("--method", default="auto", choices=("auto", "fused", "exact"),
                   help="fused = all window sizes in one sweep (f32); "
                        "exact = one exact run per m")
    p.add_argument("--motifs", type=int, default=None, metavar="K",
                   help="also print the K best variable-length motifs")
    p.add_argument("--discords", type=int, default=None, metavar="K",
                   help="also print the K strongest variable-length discords")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--verbose", action="store_true")
    return p


def _cmd_pan(args) -> int:
    from mpx_torch.config import MatrixProfileConfig
    from mpx_torch.io.tsb import read_series
    from mpx_torch.pan import compute_pan_profile, pan_discords, pan_m_range, pan_motifs

    Logger.verbose = args.verbose
    T = read_series(args.input)
    ms = pan_m_range(args.m_lo, args.m_hi, args.count)
    cfg = MatrixProfileConfig(m=int(ms[0]), dtype=args.dtype, kernel=args.kernel,
                              device=args.device)
    pan = compute_pan_profile(T, ms, config=cfg, method=args.method)
    if args.motifs:
        print("variable-length motifs (m, a, b, dist, score):")
        for mo in pan_motifs(pan, k=args.motifs):
            print(f"  {mo.m:6d} {mo.a:8d} {mo.b:8d} {mo.distance:.4f} {mo.score:.4f}")
    if args.discords:
        print("variable-length discords (m, index, nn, dist, score):")
        for di in pan_discords(pan, k=args.discords):
            print(f"  {di.m:6d} {di.a:8d} {di.b:8d} {di.distance:.4f} {di.score:.4f}")
    if args.output:
        np.savez_compressed(args.output + ".pan.npz", ms=pan.ms, PMP=pan.PMP, PMPI=pan.PMPI)
        Logger.info(f"wrote {args.output}.pan.npz "
                    f"({pan.ms.size} window sizes x {pan.PMP.shape[1]})")
    else:
        norm = pan.normalized
        print("m, min(normalized distance), argmin:")
        for r, m in enumerate(pan.ms):
            row = norm[r]
            i = int(np.nanargmin(row))
            print(f"  {int(m):6d} {row[i]:.4f} @ {i}")
    return 0


def _add_merlin(sub):
    p = sub.add_parser("merlin",
                       help="exact discord at EVERY window length in a range (MERLIN)")
    p.add_argument("-i", "--input", required=True, help=".tsb/.txt[.gz] time series")
    p.add_argument("--lo", type=int, required=True, help="smallest window length (>= 4)")
    p.add_argument("--hi", type=int, required=True, help="largest window length")
    p.add_argument("-k", type=int, default=3, help="strongest cross-length discords to report")
    p.add_argument("--eps", type=float, default=None,
                   help="survey error allowance (default 5e-3)")
    p.add_argument("--motifs", action="store_true",
                   help="exact top MOTIF pair per length instead (the VALMOD question)")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--verbose", action="store_true")
    return p


def _cmd_merlin(args) -> int:
    from mpx_torch.config import MatrixProfileConfig
    from mpx_torch.io.tsb import read_series
    from mpx_torch.merlin import multi_length_discords, multi_length_motifs

    Logger.verbose = args.verbose
    T = read_series(args.input)
    kw = {} if args.eps is None else {"eps": args.eps}
    fn = multi_length_motifs if args.motifs else multi_length_discords
    res = fn(T, args.lo, args.hi, k=args.k,
             config=MatrixProfileConfig(m=args.lo, device=args.device), **kw)
    kind = "motifs" if args.motifs else "discords"
    print(f"exact {kind} at {len(res.per_length)} lengths [{args.lo}, {args.hi}]:")
    if res.escalated_lengths:
        print(f"  ({len(res.escalated_lengths)} length(s) escalated to full exact "
              f"profiles: {res.escalated_lengths})")
    for d in res.top:
        print(f"  m={d.m:5d} idx={d.index:8d} nn={d.nn_index:8d} "
              f"dist={d.distance:.6f} score={d.score:.4f}")
    if args.verbose:
        for d in res.per_length:
            Logger.info(f"m={d.m} idx={d.index} dist={d.distance:.6f}")
    return 0


def _add_analyze(sub):
    p = sub.add_parser("analyze", help="extract motifs and discords")
    p.add_argument("-i", "--input", required=True,
                   help="time series OR base path of .mpb/.mpib results")
    p.add_argument("-m", type=int, required=True)
    p.add_argument("-k", type=int, default=3, help="top-k motifs/discords")
    p.add_argument("--regimes", type=int, default=0,
                   help="also report this many regime changes (FLUSS CAC)")
    p.add_argument("--chain", action="store_true",
                   help="also report the unanchored time-series chain "
                        "(needs the time series input, not saved results)")
    p.add_argument("--av", default=None, choices=("complexity",),
                   help="guided search: bias motifs/discords by an "
                        "annotation vector (needs the time series input)")
    p.add_argument("--dtype", default="float32", choices=_DTYPES)
    p.add_argument("--kernel", default="auto",
                   choices=("auto", "mxu", "mxu_fused", "xla", "pallas", "hybrid"))
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    return p


def _cmd_analyze(args) -> int:
    from mpx_torch.analysis import top_discords, top_motifs
    from mpx_torch.config import MatrixProfileConfig
    from mpx_torch.driver import compute_matrix_profile
    from mpx_torch.io.tsb import read_binary, read_series

    T = None
    MPIl = MPIr = None
    if os.path.exists(args.input + ".mpb"):
        if args.chain:
            raise SystemExit(
                "--chain needs the raw time series input (left/right "
                "profiles are recomputed), not a saved .mpb/.mpib base path"
            )
        MP = read_binary(args.input + ".mpb", "double")
        MPI = read_binary(args.input + ".mpib", "int")
    else:
        T = read_series(args.input)
        cfg = MatrixProfileConfig(m=args.m, dtype=args.dtype, kernel=args.kernel,
                                  device=args.device)
        if args.chain:
            # One left/right run serves both outputs: the profile is the
            # elementwise min-merge of the two sides.
            MPl, MPIl, MPr, MPIr = (o.cpu().numpy() for o in
                                    compute_matrix_profile(T, config=cfg, left_right=True))
            left_wins = MPl <= MPr
            MP = np.where(left_wins, MPl, MPr)
            MPI = np.where(left_wins, MPIl, MPIr)
        else:
            MP, MPI = (o.cpu().numpy() for o in compute_matrix_profile(T, config=cfg))

    MP_motif = MP_discord = MP
    if args.av:
        from mpx_torch.analysis import apply_annotation_vector, complexity_annotation

        if T is None:
            raise SystemExit("--av needs the raw time series input "
                             "(the annotation vector is computed from it)")
        AV = complexity_annotation(T, args.m)
        MP_motif = apply_annotation_vector(MP, AV, mode="motif")
        MP_discord = apply_annotation_vector(MP, AV, mode="discord")
        print(f"annotation vector: {args.av} "
              f"(mean {AV.mean():.3f}, min {AV.min():.3f})")
    # Rank on the (biased) profile, print the pair's true distance.
    print("motifs (a, b, distance):")
    for mo in top_motifs(MP_motif, MPI, args.m, k=args.k):
        true_d = MP[mo.a] if MPI[mo.a] == mo.b else MP[mo.b]
        print(f"  {mo.a:8d} {mo.b:8d} {true_d:.6f}")
    print("discords (index, distance):")
    for d in top_discords(MP_discord, MPI, args.m, k=args.k):
        print(f"  {d.index:8d} {MP[d.index]:.6f}")
    if args.regimes:
        from mpx_torch.analysis import regimes

        print("regime changes (index):")
        for r in regimes(MPI, args.m, k=args.regimes):
            print(f"  {r:8d}")
    if args.chain:
        from mpx_torch.analysis import unanchored_chain

        chain = unanchored_chain(MPIl, MPIr)
        print(f"unanchored chain ({len(chain)} links):")
        print("  " + " -> ".join(str(int(c)) for c in chain))
    return 0


def _add_chains(sub):
    p = sub.add_parser(
        "chains",
        help="time series chains: drifting patterns (ATSC/ALLC)",
        description="Extract the longest unanchored time series chain "
        "(or the chain anchored at --anchor) from the left/right "
        "matrix profile: temporally ordered subsequences where each "
        "is the bidirectional nearest neighbor of the previous one "
        "(Matrix Profile VII).",
    )
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-m", type=int, required=True)
    p.add_argument("--anchor", type=int, default=None,
                   help="anchor window index (default: longest chain)")
    p.add_argument("--all", action="store_true", dest="all_chains",
                   help="print every maximal chain (length >= 2)")
    p.add_argument("--dtype", default="float32", choices=_DTYPES)
    p.add_argument("--kernel", default="auto",
                   choices=("auto", "mxu", "mxu_fused", "xla", "pallas", "hybrid"))
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--verbose", action="store_true")
    return p


def _cmd_chains(args) -> int:
    from mpx_torch.chains import all_chains, compute_chains
    from mpx_torch.config import MatrixProfileConfig
    from mpx_torch.io.tsb import read_series

    Logger.verbose = args.verbose
    T = read_series(args.input)
    cfg = MatrixProfileConfig(m=args.m, dtype=args.dtype, kernel=args.kernel,
                              device=args.device)
    res = compute_chains(T, cfg, anchor=args.anchor)
    kind = (f"anchored @ {args.anchor}" if args.anchor is not None
            else "longest unanchored")
    print(f"chain ({kind}): length {res.length}")
    print("  " + " -> ".join(str(int(i)) for i in res.chain))
    if args.all_chains:
        for k, c in enumerate(all_chains(res.mpi_left, res.mpi_right)):
            print(f"chain {k}: length {len(c)}: " + " -> ".join(str(int(i)) for i in c))
    return 0


def _add_contrast(sub):
    p = sub.add_parser(
        "contrast",
        help="contrast profile: patterns present in series PLUS and "
             "absent from series MINUS")
    p.add_argument("-p", "--plus", required=True,
                   help="positive series (contains the behavior of interest)")
    p.add_argument("-n", "--minus", required=True, help="negative series (does not)")
    p.add_argument("-m", type=int, default=None,
                   help="window length; omit with --pan to sweep")
    p.add_argument("--pan", default=None,
                   help="comma-separated window lengths (pan contrast "
                        "profile); reports the best (m, index) pattern")
    p.add_argument("-k", type=int, default=3, help="number of contrast motifs to report")
    p.add_argument("-o", "--output", help="writes <o>.cp.npy (float64 contrast profile)")
    p.add_argument("--dtype", default="float32", choices=_DTYPES)
    p.add_argument("--band", type=int, default=4096)
    p.add_argument("--chunk", type=int, default=4096)
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--verbose", action="store_true")
    return p


def _cmd_contrast(args) -> int:
    from mpx_torch.config import MatrixProfileConfig
    from mpx_torch.contrast import (
        best_contrast,
        contrast_profile,
        pan_contrast_profile,
        top_contrast_motifs,
    )
    from mpx_torch.io.tsb import read_series
    from mpx_torch.utils.profile import BenchmarkProfile

    Logger.verbose = args.verbose
    Tp, Tm = read_series(args.plus), read_series(args.minus)
    if args.pan:
        ms = [int(s) for s in args.pan.split(",") if s.strip()]
        if not ms:
            raise ValueError("--pan needs at least one window size, "
                             "e.g. --pan 64,128,256")
        cfg = MatrixProfileConfig(m=ms[0], dtype=args.dtype, band=args.band,
                                  chunk=args.chunk, device=args.device)
        pan = pan_contrast_profile(Tp, Tm, ms, config=cfg)
        best_m, best_i, score = best_contrast(pan)
        print(f"pan contrast over m={sorted(set(ms))}")
        print(f"best contrast: m={best_m} @ {best_i}  score {score:.4f}")
        if args.output:
            np.savez(args.output + ".pancp", **{f"m{mm}": cp for mm, cp in pan})
            Logger.info(f"wrote {args.output}.pancp.npz")
        return 0
    if args.m is None:
        print("error: -m is required (or pass --pan)", file=sys.stderr)
        return 1
    cfg = MatrixProfileConfig(m=args.m, dtype=args.dtype, band=args.band,
                              chunk=args.chunk, device=args.device)
    prof = BenchmarkProfile()
    res = contrast_profile(Tp, Tm, config=cfg, profile=prof)
    for mot in top_contrast_motifs(res, args.m, k=args.k):
        print(f"contrast motif @ {mot.index}  (in-class neighbor "
              f"{mot.neighbor})  score {mot.score:.4f}")
    if args.output:
        np.save(args.output + ".cp", res.cp)
        Logger.info(f"wrote {args.output}.cp.npy")
    if args.verbose:
        prof.report(file=sys.stdout)
    return 0


def _add_ostinato(sub):
    p = sub.add_parser("ostinato",
                       help="consensus motif across several series (one -i each)")
    p.add_argument("-i", "--input", action="append", required=True,
                   help="series file; repeat for each series (>= 2)")
    p.add_argument("-m", type=int, required=True)
    p.add_argument("--dtype", default="float32", choices=_DTYPES)
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--verbose", action="store_true")
    return p


def _cmd_ostinato(args) -> int:
    from mpx_torch.config import MatrixProfileConfig
    from mpx_torch.io.tsb import read_series
    from mpx_torch.ostinato import ostinato

    Logger.verbose = args.verbose
    series = [read_series(p) for p in args.input]
    res = ostinato(series, config=MatrixProfileConfig(m=args.m, dtype=args.dtype,
                                                      device=args.device))
    print(f"consensus motif: series {res.series} "
          f"({args.input[res.series]}) @ {res.index}, "
          f"radius {res.radius:.6f}")
    return 0


def _add_snippets(sub):
    p = sub.add_parser("snippets", help="k most representative L-length segments")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-L", "--length", type=int, required=True, help="snippet length")
    p.add_argument("-k", type=int, default=2)
    p.add_argument("-m", type=int, default=None,
                   help="comparison subsequence length (default L/2)")
    p.add_argument("--dtype", default="float32", choices=_DTYPES)
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    return p


def _cmd_snippets(args) -> int:
    from mpx_torch.config import MatrixProfileConfig
    from mpx_torch.io.tsb import read_series
    from mpx_torch.snippets import snippets

    T = read_series(args.input)
    cfg = MatrixProfileConfig(m=args.m if args.m else max(4, args.length // 2),
                              dtype=args.dtype, device=args.device)
    print("snippets (start, length, fraction):")
    for s in snippets(T, args.length, k=args.k, m=args.m, config=cfg):
        print(f"  {s.start:8d} {s.length:6d} {s.fraction:.3f}")
    return 0


def _add_cluster(sub):
    p = sub.add_parser(
        "cluster",
        help="cluster several series by MPdist (one -i each)",
        description="Pairwise MPdist matrix from AB-joins, then "
        "hierarchical agglomerative clustering on the host; prints the "
        "distance matrix, per-series labels, and each cluster's medoid.",
    )
    p.add_argument("-i", "--input", action="append", required=True,
                   help="series file; repeat for each series (>= 2)")
    p.add_argument("-m", type=int, required=True, help="subsequence length")
    p.add_argument("-k", "--clusters", type=int, default=2)
    p.add_argument("--linkage", default="average",
                   choices=("single", "complete", "average"))
    p.add_argument("--threshold", type=float, default=0.05,
                   help="MPdist quantile threshold")
    p.add_argument("--dtype", default="float32", choices=_DTYPES)
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--verbose", action="store_true")
    return p


def _cmd_cluster(args) -> int:
    from mpx_torch.cluster import cluster_series
    from mpx_torch.config import MatrixProfileConfig
    from mpx_torch.io.tsb import read_series

    Logger.verbose = args.verbose
    series = [read_series(p) for p in args.input]
    res = cluster_series(
        series, n_clusters=args.clusters, linkage=args.linkage, threshold=args.threshold,
        config=MatrixProfileConfig(m=args.m, dtype=args.dtype, device=args.device))
    k = len(series)
    print(f"MPdist matrix ({k}x{k}, m={args.m}, threshold={args.threshold}):")
    for row in res.distances:
        print("  " + " ".join(f"{d:8.4f}" for d in row))
    for c in res.clusters:
        names = ", ".join(args.input[i] for i in c.members)
        print(f"cluster {c.label}: medoid {args.input[c.medoid]} "
              f"radius {c.radius:.4f} :: {names}")
    return 0


def _add_motiflets(sub):
    p = sub.add_parser(
        "motiflets",
        help="k-motiflets: the k most similar motif occurrences",
        description="Find the set of k non-overlapping windows with "
        "minimal extent (max pairwise z-norm distance): set-motif "
        "discovery parameterized by occurrence count instead of a "
        "radius (Schaefer & Leser 2022). --elbows sweeps k and reports "
        "the natural occurrence counts.",
    )
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-m", type=int, required=True)
    p.add_argument("-k", type=int, default=None, help="occurrence count (omit with --elbows)")
    p.add_argument("--elbows", type=int, default=None, metavar="KMAX",
                   help="sweep k=2..KMAX, print extents + elbow k's")
    p.add_argument("--candidates", type=int, default=64,
                   help="seeds refined on host (default 64)")
    p.add_argument("--dtype", default="float32", choices=_DTYPES)
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--verbose", action="store_true")
    return p


def _cmd_motiflets(args) -> int:
    from mpx_torch.config import MatrixProfileConfig
    from mpx_torch.io.tsb import read_series
    from mpx_torch.motiflets import k_motiflets, motiflet_elbows

    Logger.verbose = args.verbose
    T = read_series(args.input)
    cfg = MatrixProfileConfig(m=args.m, dtype=args.dtype, device=args.device)
    if args.elbows is not None:
        results, elbows = motiflet_elbows(T, kmax=args.elbows, config=cfg,
                                          candidates=args.candidates)
        for r in results:
            idx = " ".join(str(int(i)) for i in r.indices)
            print(f"k={r.k}: extent {r.extent:.6f}  [{idx}]")
        print("elbows (descending significance): "
              + (" ".join(str(k) for k in elbows) or "none"))
        return 0
    if args.k is None:
        print("error: -k is required (or pass --elbows)", file=sys.stderr)
        return 1
    res = k_motiflets(T, k=args.k, config=cfg, candidates=args.candidates)
    idx = " ".join(str(int(i)) for i in res.indices)
    print(f"{args.k}-motiflet: extent {res.extent:.6f}")
    print(f"  occurrences: {idx}")
    return 0


def _add_query(sub):
    p = sub.add_parser(
        "query",
        help="similarity search: find occurrences of a query subsequence "
             "(MASS distance profile + non-overlapping matches)")
    p.add_argument("-i", "--input", required=True, help="series to search")
    p.add_argument("-q", "--query", required=True,
                   help="query: a .tsb/.txt file, or i:j to slice the "
                        "input series itself")
    p.add_argument("-k", "--max-matches", type=int, default=None)
    p.add_argument("--max-distance", type=float, default=None,
                   help="report matches at distance <= this "
                        "(default: max(min(D), mean(D)-2*std(D)))")
    p.add_argument("-o", "--output", help="also write the full distance profile to <o>.mpb")
    p.add_argument("--method", default="auto", choices=("auto", "fft", "direct"))
    p.add_argument("--verbose", action="store_true")
    return p


def _cmd_query(args) -> int:
    """MASS is float64 host work (as in mpx), so ``query`` has no
    ``--device``."""
    from mpx_torch.analysis import match
    from mpx_torch.io.tsb import read_series, write_binary

    Logger.verbose = args.verbose
    T = read_series(args.input)
    if ":" in args.query and not os.path.exists(args.query):
        lo, hi = args.query.split(":", 1)
        Q = T[int(lo):int(hi)]
    else:
        Q = read_series(args.query)
    matches, D = match(Q, T, max_distance=args.max_distance, max_matches=args.max_matches,
                       method=args.method, return_profile=True)
    for r in matches:
        print(f"match @ {r.index}  distance {r.distance:.6f}")
    if not matches:
        print("no matches under the distance threshold")
    if args.output:
        write_binary(args.output + ".mpb", D, "double")
        Logger.info(f"wrote {args.output}.mpb ({D.shape[0]} distances)")
    return 0


def _add_tsbin(sub):
    p = sub.add_parser("tsbin", help="encode/decode binary time series files")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("-d", "--decode", action="store_true")
    g.add_argument("-e", "--encode", action="store_true")
    p.add_argument("input", nargs=1)
    p.add_argument("-o", "--output")
    p.add_argument("-t", "--type", default="double",
                   choices=("double", "int", "ap16", "ap24", "ap32", "ap64"),
                   help="element type; ap* = fixed-point quantized container (MPXQ)")
    p.add_argument("-n", type=int, help="expected element count")
    p.add_argument("-l", "--limit", type=int)
    p.add_argument("--offset", type=int)
    p.add_argument("--oneline", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _cmd_tsbin(args) -> int:
    from mpx_torch.io.apfixed import read_quantized, write_quantized
    from mpx_torch.io.tsb import read_ascii, read_binary, write_ascii, write_binary

    Logger.verbose = args.verbose
    path = args.input[0]
    for flag, value in (("-n", args.n), ("-l/--limit", args.limit),
                        ("--offset", args.offset)):
        if value is not None and value < 0:
            raise SystemExit(f"{flag} must have a non-negative value")

    def window(data):
        off = args.offset or 0
        return data[off : off + args.limit if args.limit is not None else len(data)]

    ap = args.type.startswith("ap")
    if args.encode:
        if not args.output:
            raise SystemExit("-o/--output has to be specified in -e/--encode mode")
        data = read_ascii(path)
        if args.n is not None and len(data) != args.n:
            raise SystemExit(f"expected {args.n} values, decoded {len(data)}")
        data = window(data)
        if ap:
            write_quantized(args.output, data, args.type)
        else:
            if args.type == "int":
                data = np.asarray(data, dtype=np.int64)
            write_binary(args.output, data, args.type)
        Logger.info(f"encoded {len(data)} '{args.type}' values -> {args.output}")
    else:
        if ap:
            data = window(read_quantized(path, args.n))
        else:
            data = window(read_binary(path, args.type, args.n))
        if args.output:
            write_ascii(args.output, data, oneline=args.oneline)
            Logger.info(f"decoded {len(data)} values -> {args.output}")
        else:
            print(*data.tolist(), sep=(", " if args.oneline else "\n"))
    return 0


def _add_damp(sub):
    p = sub.add_parser(
        "damp", help="DAMP anomaly detection: left-profile discords",
        description="Score every window by its distance to the nearest EARLIER "
        "window (the left profile, exact) and report the strongest anomalies "
        "after --split.  Scores are causal: each one is final when its window "
        "arrives.")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-m", type=int, required=True)
    p.add_argument("--split", type=int, default=0,
                   help="training prefix: windows before this index are never "
                        "reported (default 0)")
    p.add_argument("-k", type=int, default=3, help="anomalies to report (default 3)")
    p.add_argument("-o", "--output", help="write <out>.damp.npy (float64 scores)")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--verbose", action="store_true")
    return p


def _cmd_damp(args) -> int:
    from mpx_torch.config import MatrixProfileConfig
    from mpx_torch.damp import compute_damp
    from mpx_torch.io.tsb import read_series

    Logger.verbose = args.verbose
    T = read_series(args.input)
    res = compute_damp(T, config=MatrixProfileConfig(m=args.m, dtype=args.dtype,
                                                     device=args.device),
                       split=args.split, k=args.k)
    if args.output:
        np.save(args.output + ".damp", res.scores)
        print(f"wrote {args.output}.damp.npy")
    print(f"anomalies (left-profile discords, split {res.split}):")
    for a in res.discords:
        print(f"  {a.index:>8}  distance {a.distance:.6f}")
    if not res.discords:
        print("  none (no scorable window after the split)")
    return 0


def _add_batch(sub):
    p = sub.add_parser(
        "batch", help="profiles for a fleet of equal-length series (one -i each)",
        description="The fleet tier: every series' profile, staged in groups; "
        "writes <out>.<stem>.mpb/.mpib per input.")
    p.add_argument("-i", "--input", action="append", required=True,
                   help="series file; repeat for each series (>= 1)")
    p.add_argument("-m", type=int, required=True)
    p.add_argument("-o", "--output", help="output prefix (default: print per-series minima)")
    p.add_argument("--group", type=int, default=None,
                   help="series staged at once (default: as many as fit the budget)")
    p.add_argument("--shards", type=int, default=None, help="device count")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--verbose", action="store_true")
    return p


def _cmd_batch(args) -> int:
    from mpx_torch.batch import compute_batch_profiles
    from mpx_torch.config import MatrixProfileConfig
    from mpx_torch.io.tsb import read_series, write_results

    Logger.verbose = args.verbose
    series = [read_series(p) for p in args.input]
    lengths = {s.shape[0] for s in series}
    if len(lengths) != 1:
        raise ValueError(f"batch requires equal-length series, got lengths {sorted(lengths)}")
    cfg = MatrixProfileConfig(m=args.m, dtype=args.dtype, num_shards=args.shards,
                              device=args.device)
    MP, MPI = compute_batch_profiles(np.stack(series), config=cfg, group=args.group)
    if args.output:
        stems = [os.path.splitext(os.path.basename(p))[0] for p in args.input]
        # same-named inputs from different directories: on any collision every
        # output gets its index appended
        if len(set(stems)) != len(stems):
            stems = [f"{s}.{b}" for b, s in enumerate(stems)]
        for b, stem in enumerate(stems):
            mpb, mpib = write_results(f"{args.output}.{stem}", MP[b], MPI[b])
            Logger.verbose_log(f"wrote {mpb}, {mpib}")
        print(f"wrote {len(args.input)} profile pairs to {args.output}.*.mpb/.mpib")
    else:
        print("series  min-dist  @motif-pair")
        for b, path in enumerate(args.input):
            i = int(MP[b].argmin())
            print(f"  {path}: {MP[b][i]:.6f} @ ({i}, {MPI[b][i]})")
    return 0


def _add_floss(sub):
    p = sub.add_parser(
        "floss", help="online semantic segmentation (streaming FLOSS)",
        description="Stream a series through the FLOSS online segmenter: the "
        "file is replayed in --step chunks against a --window sliding window, "
        "printing the strongest regime boundaries seen.")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-m", type=int, required=True, help="subsequence length")
    p.add_argument("--window", type=int, default=None,
                   help="retained points (default: whole series)")
    p.add_argument("--init", type=int, default=None,
                   help="warmup points before streaming (default 4*m)")
    p.add_argument("--step", type=int, default=256, help="points per append chunk")
    p.add_argument("-k", type=int, default=1, help="boundaries to report")
    p.add_argument("--threshold", type=float, default=0.45,
                   help="only report boundaries with CAC below this")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    return p


def _cmd_floss(args) -> int:
    import time

    from mpx_torch.analysis import extract_regimes
    from mpx_torch.floss import Floss
    from mpx_torch.io.tsb import read_series

    if args.step < 1:
        raise ValueError(f"--step must be >= 1 (got {args.step})")
    T = read_series(args.input)
    init = args.init if args.init is not None else 4 * args.m
    if init < args.m + args.m // 4:
        raise ValueError(f"--init {init} < m + m//4 = {args.m + args.m // 4} "
                         "(too short for a self-join warmup)")
    if init >= T.shape[0]:
        raise ValueError(f"--init {init} consumes the whole series ({T.shape[0]})")
    # the default window is the whole series (Floss's own default, the
    # warmup's length, would keep only a tail here)
    window = args.window if args.window is not None else T.shape[0]
    fl = Floss(T[:init], m=args.m, window=window, dtype=args.dtype, device=args.device)
    t0 = time.perf_counter()
    for start in range(init, T.shape[0], args.step):
        fl.append(T[start : start + args.step])
    elapsed = time.perf_counter() - t0
    streamed = T.shape[0] - init
    cac = fl.cac()
    print(f"streamed {streamed} points in {elapsed:.3f}s "
          f"({streamed / max(elapsed, 1e-9):.0f} points/s), "
          f"window [{fl.offset}, {fl.offset + fl.series.shape[0]})")
    found = [(fl.offset + r, cac[r]) for r in extract_regimes(cac, args.m, k=args.k)
             if cac[r] < args.threshold]
    if not found:
        print(f"no boundary below CAC {args.threshold} (min {cac.min():.3f})")
    else:
        print("regime boundaries (position, CAC):")
        for r, c in found:
            print(f"  {r:8d} {c:.3f}")
    return 0


def _add_golden(sub):
    p = sub.add_parser("golden", help="golden MP/MPI via the numpy oracle")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True, help="output base path")
    p.add_argument("-m", type=int, required=True)
    return p


def _cmd_golden(args) -> int:
    from mpx_torch.io.tsb import read_series, write_results
    from mpx_torch.reference import compute_matrix_profile_reference

    MP, MPI = compute_matrix_profile_reference(read_series(args.input), args.m)
    mpb, mpib = write_results(args.output, MP, MPI)
    Logger.info(f"wrote {mpb}, {mpib}")
    return 0


def _cmd_datasets(args) -> int:
    from mpx_torch.io.datasets import list_datasets

    for cat, names in list_datasets().items():
        print(f"{cat}:")
        for name in names:
            print(f"  {name}")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    # The benchmark parses its own flags (argparse's REMAINDER would not
    # pass leading ones through).
    if argv and argv[0] == "bench":
        from mpx_torch import bench

        return bench.main(argv[1:])
    parser = argparse.ArgumentParser(
        prog="mpx_torch", description="matrix-profile framework (PyTorch/CUDA port)"
    )
    sub = parser.add_subparsers(dest="command")
    _add_compute(sub)
    _add_abjoin(sub)
    _add_topk(sub)
    _add_thresh(sub)
    _add_matrix(sub)
    _add_mstamp(sub)
    _add_pan(sub)
    _add_merlin(sub)
    _add_damp(sub)
    _add_batch(sub)
    _add_floss(sub)
    _add_analyze(sub)
    _add_chains(sub)
    _add_contrast(sub)
    _add_ostinato(sub)
    _add_snippets(sub)
    _add_cluster(sub)
    _add_motiflets(sub)
    _add_query(sub)
    _add_tsbin(sub)
    _add_golden(sub)
    sub.add_parser("datasets", help="list the datasets under data/")
    sub.add_parser("bench", help="run the benchmark (python -m mpx_torch bench -h)")
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return 2
    try:
        return {"compute": _cmd_compute, "abjoin": _cmd_abjoin, "topk": _cmd_topk,
                "thresh": _cmd_thresh, "matrix": _cmd_matrix, "mstamp": _cmd_mstamp,
                "pan": _cmd_pan, "merlin": _cmd_merlin, "damp": _cmd_damp,
                "batch": _cmd_batch, "floss": _cmd_floss, "analyze": _cmd_analyze,
                "chains": _cmd_chains, "contrast": _cmd_contrast, "ostinato": _cmd_ostinato,
                "snippets": _cmd_snippets, "cluster": _cmd_cluster,
                "motiflets": _cmd_motiflets, "query": _cmd_query, "tsbin": _cmd_tsbin,
                "golden": _cmd_golden,
                "datasets": _cmd_datasets}[args.command](args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
