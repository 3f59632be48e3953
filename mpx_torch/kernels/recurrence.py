"""K3: the SCAMP diagonal-recurrence band sweep (``kernel='pallas'``).

Counterpart of ``mpx/kernels/pallas_tpu.py:sweep_band_pallas``; the kernel
itself is ``mpx_torch/csrc/band_recurrence.cu`` (CUDA C++ for sm_90a, f32
and f64: the H100 has native FP64, so unlike mpx's Pallas kernel this is
also the strict float64 tier).  One thread carries QT along one diagonal;
the exact seed comes from :func:`mpx_torch.kernels.common.seed_qt`,
computed here, outside the kernel.  Only per-block (value, index) partials
reach device memory, and a second kernel in the same source reduces them
to the job's ``BandOut`` (rows (S,), columns (S + W,)).

A CPU tensor takes the plain PyTorch version
(:func:`mpx_torch.kernels.xla.sweep_band_xla`); a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from mpx_torch.dtypes import torch_dtype
from mpx_torch.kernels.common import BandGeometry, BandOut, seed_qt
from mpx_torch.kernels.xla import sweep_band_xla
from mpx_torch.types import Aggregates, Stats

# Launches of the CUDA kernel pair (a plain count; reset by whoever reads it).
LAUNCHES = 0


def sweep_band_recurrence(stats: Stats, r0: int, k0: int, geom: BandGeometry,
                          dtype) -> BandOut:
    global LAUNCHES
    if stats.df.device.type == "cpu":
        return sweep_band_xla(stats, r0, k0, geom, dtype)
    if stats.df.device.type != "cuda":
        raise ValueError(f"the recurrence kernel runs on CUDA tensors, got {stats.df.device}")

    dt = torch_dtype(dtype)
    S, W, m, w, excl = geom.S, geom.W, geom.m, geom.w, geom.excl
    r0, k0 = int(r0), int(k0)
    c0 = r0 + k0
    pw = stats.df.shape[0]
    vecs = (stats.df, stats.dg, stats.inv, stats.mu)
    for v in vecs:
        if v.dtype != dt or v.shape != (pw,) or not v.is_contiguous() \
                or v.device != stats.df.device:
            raise ValueError(f"stats must be contiguous ({pw},) {dt} vectors on one "
                             f"device, got {v.dtype} {tuple(v.shape)}")
    if stats.T.dtype != dt or stats.T.shape != (pw + m - 1,):
        raise ValueError(f"stats.T must be ({pw + m - 1},) {dt}")
    if geom.wc != w:
        raise ValueError("the recurrence kernel is a self-join kernel (wc must equal w)")
    if min(r0, k0) < 0 or r0 + S > pw or c0 + S + W > pw:
        raise ValueError(f"job rows [{r0}, {r0 + S}) / columns [{c0}, {c0 + S + W}) "
                         f"outside the {pw}-wide statistics")
    if pw + m >= 2**31:
        raise ValueError("profile width exceeds the kernel's int32 indices")

    from mpx_torch.kernels import _build

    lib = _build.load()
    nbj, ncol = -(-W // lib.mpx_k3_block_w()), lib.mpx_k3_block_columns(S)
    dev = stats.df.device
    seed = seed_qt(stats, r0, c0, W, m).contiguous()
    part_rv = torch.empty((nbj, S), dtype=dt, device=dev)
    part_ri = torch.empty((nbj, S), dtype=torch.int32, device=dev)
    part_cv = torch.empty((nbj, ncol), dtype=dt, device=dev)
    part_ci = torch.empty((nbj, ncol), dtype=torch.int32, device=dev)
    row_v = torch.empty(S, dtype=dt, device=dev)
    row_i = torch.empty(S, dtype=torch.int32, device=dev)
    col_v = torch.empty(S + W, dtype=dt, device=dev)
    col_i = torch.empty(S + W, dtype=torch.int32, device=dev)

    rows = [v[r0 : r0 + S] for v in vecs[:3]]
    cols = [v[c0 : c0 + S + W] for v in vecs[:3]]
    fn = lib.mpx_k3_sweep_f64 if dt == torch.float64 else lib.mpx_k3_sweep_f32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(x.data_ptr() for x in rows + cols), seed.data_ptr(),
                 r0, k0, S, W, w, excl,
                 part_rv.data_ptr(), part_ri.data_ptr(),
                 part_cv.data_ptr(), part_ci.data_ptr(),
                 row_v.data_ptr(), row_i.data_ptr(),
                 col_v.data_ptr(), col_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"recurrence kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return BandOut(row=Aggregates(row_v, row_i), col=Aggregates(col_v, col_i))
