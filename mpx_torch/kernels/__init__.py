"""Kernel backends, counterpart of ``mpx/kernels/__init__.py``.

Four implementations of the same band-sweep contract
(:mod:`mpx_torch.kernels.common`):

* ``mxu_fused`` — K1, the hand-written CUDA tile sweep
  (``csrc/mxu_fused.cu``); ``auto``'s choice on a CUDA device, for float32
  and float64 alike (the H100 has native FP64);
* ``mxu``       — the plain PyTorch matmul-mask-reduce; ``auto``'s choice on
  the CPU, and on the card only when asked for by name;
* ``pallas``    — K3, the hand-written CUDA SCAMP diagonal recurrence
  (``csrc/band_recurrence.cu``), O(1) work per pair; named after the mpx
  kernel it ports so calls read the same;
* ``xla``       — the plain PyTorch recurrence, K3's reference.

``auto`` follows mpx's policy for large m: float64 with ``m > MXU_MAX_M``
takes the recurrence (K3 on the card, the plain version on the CPU).
``hybrid`` (:mod:`mpx_torch.hybrid`) is not a band sweep: the driver hands
it the whole self-join, and it is reached by name only.
"""

from __future__ import annotations

import torch

from mpx_torch.dtypes import torch_dtype
from mpx_torch.kernels.common import BandOut, band_geometry

# mpx's ceiling for the windows-matmul tiers; past it float64 runs the
# strict recurrence (mpx/kernels/__init__.py).
MXU_MAX_M = 4096


def resolve_kernel(kernel: str, device, dtype=None, m: int = 0) -> str:
    if kernel != "auto":
        return kernel
    cuda = torch.device(device).type == "cuda"
    if dtype is not None and torch_dtype(dtype) == torch.float64 and m > MXU_MAX_M:
        return "pallas" if cuda else "xla"
    return "mxu_fused" if cuda else "mxu"


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


__all__ = ["BandOut", "band_geometry", "resolve_kernel", "needs_windows",
           "is_recurrence", "get_sweep_fn", "MXU_MAX_M"]
