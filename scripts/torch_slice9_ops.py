"""Where a job's time goes in the torch-op tiers of mSTAMP and the pan sweep,
on one card: each stage of one job timed alone with CUDA events, at the
shapes ``chip_smoke.py`` phases 29 and 31 run.

    python3 scripts/torch_slice9_ops.py

* the pan sweep (``mpx_torch/pan_kernel.py``), one 4096 x 16384 job of a
  random walk (n = 2^17, m = 256..271): the level-0 product, then per
  level the carried update (``addmm_``, K = 2), the epilogue (two
  ``addcmul`` passes), the row and the column reductions
  (``reduce_first``), and a whole level as the sweep runs it;
* mSTAMP (``mpx_torch/mstamp.py``), one 4 x 2048 x 4096 job (d = 4,
  m = 256, float32): the ``torch.bmm``, the distance passes, the two flat
  masks, ``torch.sort`` over the dimensions, the prefix means and the two
  reductions.

Each stage is run ``REPS`` times between two events after a warm-up; the
tile-sized ones are also given as bytes moved over time (each operand
read once, each output written once).  Prints one JSON line per tier,
after a line with the card's name and power limit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mpx_torch.dtypes import full_precision_matmul  # noqa: E402
from mpx_torch.mstamp import _order_dims, _stack_stats  # noqa: E402
from mpx_torch.ops.aggregates import reduce_first  # noqa: E402
from mpx_torch.ops.precompute import _padded_width  # noqa: E402
from mpx_torch.pan_kernel import _level_epilogue, _levels, build_pan_stats  # noqa: E402

REPS = 20


def timed(fn) -> float:
    """Milliseconds per call of ``fn`` on the card, after one warm-up."""
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(REPS):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / REPS


def stage(ms: float, nbytes: float) -> dict:
    return {"ms": ms, "gb_per_s": nbytes / ms / 1e6}


def pan_job() -> dict:
    n, ms, S, W = 1 << 17, list(range(256, 272)), 4096, 16384
    T = np.cumsum(np.random.default_rng(0).standard_normal(n))
    ps = build_pan_stats(T, ms, S, W, "cuda")
    levels = _levels(ps)
    raw = ps.T.unfold(0, ms[-1], 1)
    r0, c0 = 4096, 4096 + 16384
    C = torch.empty((S, W), dtype=torch.float32, device="cuda")
    P = torch.empty_like(C)
    tile = S * W * 4
    rawA, rawB = raw[r0 : r0 + S], raw[c0 : c0 + W]

    def level0():
        with full_precision_matmul():
            torch.matmul(rawA[:, : ms[0]] - ps.mu[0, r0 : r0 + S, None],
                         (rawB[:, : ms[0]] - ps.mu[0, c0 : c0 + W, None]).T, out=C)

    dA = torch.cat([rawA[:, 256:257] - ps.mu[0, r0 : r0 + S, None],
                    ps.dmu[0, r0 : r0 + S, None] * -257.0], dim=1)
    dB = torch.cat([rawB[:, 256:257] - ps.mu[0, c0 : c0 + W, None],
                    ps.dmu[0, c0 : c0 + W, None]], dim=1)

    def update():
        with full_precision_matmul():
            C.addmm_(dA, dB.T)

    lev = levels[0]

    def epilogue():
        torch.addcmul(lev.off[r0 : r0 + S, None], C, lev.scale[r0 : r0 + S, None], out=P)
        torch.addcmul(lev.off[None, c0 : c0 + W], P, lev.scale[None, c0 : c0 + W], out=P)

    level0()
    epilogue()
    out = {"n": n, "levels": len(ms), "S": S, "W": W,
           "level0_product": stage(timed(level0), (S + W) * 256 * 4 + tile),
           "update_addmm_k2": stage(timed(update), 2 * tile),
           "epilogue_addcmul_x2": stage(timed(epilogue), 4 * tile),
           "reduce_rows": stage(timed(lambda: reduce_first(P, 1, c0)), tile),
           "reduce_cols": stage(timed(lambda: reduce_first(P, 0, r0)), tile),
           "whole_level": stage(timed(lambda: (update(), _level_epilogue(
               C, P, lev, r0, c0, 64))), 8 * tile)}
    return out


def mstamp_job() -> dict:
    n, m, d, S, W = 1 << 17, 256, 4, 2048, 4096
    T = np.cumsum(np.random.default_rng(0).standard_normal((d, n)), axis=1)
    pn = _stack_stats(T, m, _padded_width(n - m + 1, S, W), torch.float32, "cuda")
    r0, c0 = 8192, 8192 + 4096
    tile = d * S * W * 4
    Ur, Uc = pn.U[:, r0 : r0 + S], pn.U[:, c0 : c0 + W].transpose(1, 2)
    P = torch.empty((d, S, W), dtype=torch.float32, device="cuda")

    def product():
        with full_precision_matmul():
            torch.bmm(Ur, Uc, out=P)

    def distances():
        P.neg_().add_(1.0).mul_(2.0 * m).clamp_(min=0.0).sqrt_()

    def masks():
        P.masked_fill_(~pn.fin[:, r0 : r0 + S, None], torch.inf)
        P.masked_fill_(~pn.fin[:, None, c0 : c0 + W], torch.inf)

    product()
    srt = _order_dims(P, (), False)
    kdiv = torch.arange(1, d + 1, dtype=P.dtype, device="cuda")[:, None, None]
    Dk = torch.cumsum(srt, dim=0).div_(kdiv)
    return {"n": n, "d": d, "m": m, "S": S, "W": W,
            "bmm": stage(timed(product), (S + W) * d * m * 4 + tile),
            "distance_passes_x5": stage(timed(distances), 10 * tile),
            "flat_masks_x2": stage(timed(masks), 4 * tile),
            "sort_dims": stage(timed(lambda: _order_dims(P, (), False)), 2 * tile + 2 * tile),
            "prefix_means": stage(timed(lambda: torch.cumsum(srt, dim=0).div_(kdiv)), 4 * tile),
            "reduce_rows": stage(timed(lambda: reduce_first(Dk, 2, c0, largest=False)), tile),
            "reduce_cols": stage(timed(lambda: reduce_first(Dk, 1, r0, largest=False)), tile)}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_slice9_ops: no CUDA device is available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    print(json.dumps({"pan_job": pan_job()}), flush=True)
    print(json.dumps({"mstamp_job": mstamp_job()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
