"""Kernel backends, counterpart of ``mpx/kernels/__init__.py``.

Two implementations of the same band-sweep contract
(:mod:`mpx_torch.kernels.common`):

* ``mxu_fused`` — K1, the hand-written CUDA tile sweep
  (``csrc/mxu_fused.cu``); ``auto``'s choice on a CUDA device, for float32
  and float64 alike (the H100 has native FP64);
* ``mxu``       — the plain PyTorch matmul-mask-reduce; ``auto``'s choice on
  the CPU, and on the card only when asked for by name.
"""

from __future__ import annotations

import torch

from mpx_torch.kernels.common import BandOut, band_geometry


def resolve_kernel(kernel: str, device) -> str:
    if kernel != "auto":
        return kernel
    return "mxu_fused" if torch.device(device).type == "cuda" else "mxu"


def get_sweep_fn(kernel: str):
    if kernel == "mxu":
        from mpx_torch.kernels.mxu import sweep_band_mxu

        return sweep_band_mxu
    if kernel == "mxu_fused":
        from mpx_torch.kernels.mxu_fused import sweep_band_mxu_fused

        return sweep_band_mxu_fused
    raise ValueError(f"unknown kernel {kernel!r}")


__all__ = ["BandOut", "band_geometry", "resolve_kernel", "get_sweep_fn"]
