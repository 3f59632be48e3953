"""The window statistics kernel: the O(n·m) sums of the SCAMP statistics.

No Pallas kernel of mpx computes these; the counterparts are mpx's host
C++ ``mpx_precompute`` (``mpx/native/scamp_host.cpp:61-100``) and the
``'jax'`` backend of ``mpx/ops/precompute.py``.  The kernel is
``mpx_torch/csrc/precompute.cu`` (CUDA C++ for sm_90a, one thread a
window, float64): from the series and the host's window means it writes
``inv`` (``+inf`` for a numerically constant window) and, on request, the
centered first-row products ``qt0`` and the residuals ``sum_k (T[i+k] -
mu[i])`` that correct a running mean.

:func:`window_stats_cuda` launches the kernel for CUDA tensors (or raises)
and takes the plain PyTorch version, :func:`window_stats_torch`, for CPU
tensors.
"""

from __future__ import annotations

import torch

from mpx_torch.ops.precompute import ZERO_VARIANCE_REL
from mpx_torch.utils.profile import count

# Bytes of one block of windows in the plain version.
_BLOCK_BYTES = 128 << 20


def _check(T: torch.Tensor, mu: torch.Tensor, m: int) -> int:
    if T.dtype != torch.float64 or mu.dtype != torch.float64:
        raise ValueError(f"window statistics take float64 T and mu, got {T.dtype}/{mu.dtype}")
    if T.dim() != 1 or mu.dim() != 1 or mu.device != T.device:
        raise ValueError("T and mu must be 1-d tensors on one device")
    w = T.shape[0] - int(m) + 1
    if m < 1 or w < 1 or mu.shape[0] != w:
        raise ValueError(f"mu must hold the {w} window means of a {T.shape[0]}-long "
                         f"series at m={m}, got {mu.shape[0]}")
    return w


def window_stats_torch(T: torch.Tensor, mu: torch.Tensor, m: int, *, qt0: bool = False,
                       resid: bool = False):
    """Plain PyTorch version, float64 on ``T``'s device: the window view in
    blocks of ``_BLOCK_BYTES``.  Returns (inv, qt0 or None, resid or None)."""
    w = _check(T, mu, m)
    U = T.unfold(0, m, 1)
    c0 = T[:m] - mu[0]
    inv = torch.empty(w, dtype=torch.float64, device=T.device)
    q = torch.empty_like(inv) if qt0 else None
    r = torch.empty_like(inv) if resid else None
    blk = max(1, _BLOCK_BYTES // (8 * m))
    for o in range(0, w, blk):
        e = min(o + blk, w)
        cent = U[o:e] - mu[o:e, None]
        ssq = (cent * cent).sum(1)
        sumsq = (U[o:e] * U[o:e]).sum(1)
        inv[o:e] = torch.where(ssq <= ZERO_VARIANCE_REL * sumsq,
                               torch.full_like(ssq, float("inf")), 1.0 / torch.sqrt(ssq))
        if qt0:
            q[o:e] = cent @ c0
        if resid:
            r[o:e] = cent.sum(1)
    return inv, q, r


def window_stats_cuda(T: torch.Tensor, mu: torch.Tensor, m: int, *, qt0: bool = False,
                      resid: bool = False):
    """``inv`` and, on request, ``qt0`` and the residuals of the windows of
    ``T`` (float64) with means ``mu``.  A CUDA tensor launches the kernel
    (counted as ``launches.window_stats``) or raises; a CPU tensor takes
    :func:`window_stats_torch`."""
    if T.device.type == "cpu":
        return window_stats_torch(T, mu, m, qt0=qt0, resid=resid)
    w = _check(T, mu, m)
    if T.device.type != "cuda":
        raise ValueError(f"the window statistics kernel runs on CUDA tensors, got {T.device}")
    if T.shape[0] >= 2**31:
        raise ValueError("series exceeds the kernel's int32 indices")
    from mpx_torch.kernels import _build

    lib = _build.load()
    T, mu = T.contiguous(), mu.contiguous()
    inv = torch.empty(w, dtype=torch.float64, device=T.device)
    q = torch.empty_like(inv) if qt0 else None
    r = torch.empty_like(inv) if resid else None
    with torch.cuda.device(T.device):
        err = lib.mpx_window_stats(T.data_ptr(), mu.data_ptr(), w, int(m), inv.data_ptr(),
                                   None if q is None else q.data_ptr(),
                                   None if r is None else r.data_ptr(),
                                   torch.cuda.current_stream(T.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window statistics kernel launch failed: cudaError_t {err}")
    count("launches.window_stats")
    return inv, q, r
