"""Kernel backends, counterpart of ``mpx/kernels/__init__.py``.

Four implementations of the same band-sweep contract
(:mod:`mpx_torch.kernels.common`):

* ``mxu_fused`` — K1, the hand-written CUDA tile sweep
  (``csrc/mxu_fused.cu``); ``auto``'s choice on a CUDA device for float32
  at every m, and for float64 below ``K3_MIN_M_F64``;
* ``mxu``       — the plain PyTorch matmul-mask-reduce; ``auto``'s choice on
  the CPU, and on the card only when asked for by name;
* ``pallas``    — K3, the hand-written CUDA SCAMP diagonal recurrence
  (``csrc/band_recurrence.cu``), O(1) work per pair; ``auto``'s choice on
  a CUDA device for float64 from ``K3_MIN_M_F64`` up (the H100 has native
  FP64); named after the mpx kernel it ports so calls read the same;
* ``xla``       — the plain PyTorch recurrence, K3's reference.

``auto`` decides from what a call can observe: the device type, the dtype
and m.  On a CUDA device float64 takes K3 from ``K3_MIN_M_F64`` up, where
measurement on the card puts it ahead of K1 (K1's product does 2m FLOPs a
pair, the recurrence's update 4), and K1 below; float32 takes K1 at every
m.  On the CPU it follows mpx's policy for large m: float64 with
``m > MXU_MAX_M`` takes the plain recurrence, everything else the plain
sweep.  ``hybrid`` (:mod:`mpx_torch.hybrid`) is not a band sweep: the
driver hands it the whole self-join, and it is reached by name only.
How a kernel's jobs are looped and merged is decided here too, by
:func:`sweep_jobs`: K3 a batch of jobs a call, every other kernel a job at
a time.  Beside the sweeps, :mod:`mpx_torch.kernels.stats` holds the window
statistics kernel (``csrc/precompute.cu``) behind
``precompute_statistics``' ``device`` backend.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mpx_torch.dtypes import torch_dtype
from mpx_torch.kernels.common import BandOut, band_geometry
from mpx_torch.ops.aggregates import merge_window
from mpx_torch.types import Stats

# mpx's ceiling for the windows-matmul tiers; past it float64 runs the
# strict recurrence (mpx/kernels/__init__.py).  The CPU's route.
MXU_MAX_M = 4096
# The smallest m at which float64 on a CUDA device takes K3.  Per job of the
# driver's loop (seed and merges included) at the default chunk W = 16384,
# K1 wins all readings below m = 128 but one (by 4 % at m = 112), K3 two of
# three at m = 128 and every one above; at W = 32768 K3 wins from m = 48
# (PERF.md section 6, the crossover table of scripts/torch_k3_route.py on an
# H100 at 700 W).
K3_MIN_M_F64 = 128


def resolve_kernel(kernel: str, device, dtype=None, m: int = 0) -> str:
    if kernel != "auto":
        return kernel
    f64 = dtype is not None and torch_dtype(dtype) == torch.float64
    if torch.device(device).type == "cuda":
        return "pallas" if f64 and m >= K3_MIN_M_F64 else "mxu_fused"
    return "xla" if f64 and m > MXU_MAX_M else "mxu"


def needs_windows(kernel: str) -> bool:
    """Whether the sweep reads the (padded_w, m) unit-window matrix (the
    hybrid's float32 passes do, in float32)."""
    return kernel in ("mxu", "mxu_fused", "hybrid")


def is_recurrence(kernel: str) -> bool:
    """Whether the sweep is the diagonal recurrence, which reads ``df``/``dg``
    and so takes statistics with ``exact_mean`` (:mod:`mpx_torch.ops.precompute`)."""
    return kernel in ("xla", "pallas")


def get_sweep_fn(kernel: str):
    if kernel == "mxu":
        from mpx_torch.kernels.mxu import sweep_band_mxu

        return sweep_band_mxu
    if kernel == "mxu_fused":
        from mpx_torch.kernels.mxu_fused import sweep_band_mxu_fused

        return sweep_band_mxu_fused
    if kernel == "xla":
        from mpx_torch.kernels.xla import sweep_band_xla

        return sweep_band_xla
    if kernel == "pallas":
        from mpx_torch.kernels.recurrence import sweep_band_recurrence

        return sweep_band_recurrence
    raise ValueError(f"unknown kernel {kernel!r}")


def _ints(x) -> list:
    """Job offsets (an array, a list or a tensor on any device) as ints."""
    return x.tolist() if isinstance(x, torch.Tensor) else np.asarray(x).tolist()


def sweep_jobs(stats: Stats, r0s, k0s, *, geom, dtype, kernel: str, rows, cols,
               stats_c: Optional[Stats] = None):
    """Sweep the jobs (r0s[j], k0s[j]) with ``kernel``, max-merging their
    outputs into the ``rows`` and ``cols`` aggregates in place, in the
    jobs' order; a generator that yields after each unit of work, so a
    caller can interleave the jobs of several devices.  K3's unit is a
    batch (:func:`mpx_torch.kernels.recurrence.sweep_batches`), every other
    kernel's a job: its sweep, then :func:`merge_window` twice.
    ``stats_c`` is the columns' statistics (a ring's visiting shard); K3 is
    a self-join kernel and takes none."""
    r0s, k0s = _ints(r0s), _ints(k0s)
    if kernel == "pallas":
        from mpx_torch.kernels.recurrence import sweep_batches

        if stats_c is not None:
            raise ValueError("kernel='pallas' is a self-join kernel: it takes no stats_c")
        yield from sweep_batches(stats, r0s, k0s, geom=geom, dtype=dtype, rows=rows,
                                 cols=cols)
        return
    sweep = get_sweep_fn(kernel)
    kw = {} if stats_c is None else {"stats_c": stats_c}
    for r0, k0 in zip(r0s, k0s):
        out = sweep(stats, r0, k0, geom, dtype, **kw)
        merge_window(rows, out.row, r0)
        merge_window(cols, out.col, r0 + k0)
        yield


__all__ = ["BandOut", "band_geometry", "resolve_kernel", "needs_windows",
           "is_recurrence", "get_sweep_fn", "sweep_jobs", "MXU_MAX_M", "K3_MIN_M_F64"]
