"""Dtype policy and aggregate initialization constants.

Counterpart of ``mpx/dtypes.py``.  Aggregates are (Pearson-correlation
value, neighbor index) pairs initialized to ``value = -1e12`` /
``index = -1``, so any genuine correlation (P in [-1, 1]) wins the
max-merge and untouched entries survive to the output as sentinels.

PyTorch has native float64 on every device, so there is no x64 scope.
Float32 products on the card run in full FP32 inside
:func:`full_precision_matmul`, which leaves the caller's TF32 setting as
it found it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

AGGREGATE_INIT = -1e12
INDEX_INIT = -1

_SUPPORTED = {
    "float32": np.float32,
    "float64": np.float64,
    "f32": np.float32,
    "f64": np.float64,
    "double": np.float64,
    "float": np.float32,
}


def canonical_dtype(dtype) -> np.dtype:
    """Resolve a user-facing dtype spec (``double``/``float``, numpy or
    torch names, or a ``torch.dtype``) to a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        key = dtype.lower()
        if key in _SUPPORTED:
            return np.dtype(_SUPPORTED[key])
        raise ValueError(
            f"Unsupported data type '{dtype}'. Data type has to be one of: "
            f"double(float64), float(float32)."
        )
    dt = np.dtype(dtype)
    if dt not in (np.dtype(np.float32), np.dtype(np.float64)):
        raise ValueError(f"Unsupported data type '{dt}'.")
    return dt


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a user-facing dtype spec."""
    return torch.float64 if canonical_dtype(dtype) == np.float64 else torch.float32


def distance_epsilon(dtype) -> float:
    """Default absolute tolerance on output distances: 1e-8 for float64
    (the reference harness epsilon), 2e-3 for float32."""
    return 1e-8 if canonical_dtype(dtype) == np.dtype(np.float64) else 2e-3


@contextlib.contextmanager
def full_precision_matmul():
    """Float32 matmuls in full FP32 for the block: TF32 keeps ~3 decimal
    digits, far outside the distance tolerance and the hybrid's margin.
    Saves ``torch.backends.cuda.matmul.allow_tf32``, clears it, and
    restores it on exit (cuBLAS reads the flag when a product is
    enqueued, so the products inside keep full precision).  The
    hand-written kernels do not read the flag."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
