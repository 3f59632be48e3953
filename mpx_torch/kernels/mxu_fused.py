"""K1: the fused tile sweep (matmul + masked max/argmax in one kernel).

Counterpart of ``mpx/kernels/mxu_fused.py`` (the Pallas TPU kernel
``_kernel``); the kernel itself is ``mpx_torch/csrc/mxu_fused.cu``, CUDA
C++ for sm_90a on the tensor cores.  float64 runs on the FP64 tensor cores
(DMMA), bound by their 67 TFLOP/s; float32 runs as split TF32 (three TF32
products per f32 product, ~2^-22 relative each, where plain TF32 keeps
three decimal digits), bound by 495 / 3 TFLOP/s.  Each 128 x 64 block
(two per SM in f64, three in f32) stages the m axis through a 3-slab
``cp.async`` ring in shared memory.  The correlation tile never reaches
device memory: only per-tile (value, index) partials do, and a second
kernel in the same source reduces them to the job's ``BandOut``.

A CPU tensor takes the plain PyTorch version
(:func:`mpx_torch.kernels.mxu.sweep_band_mxu`); a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from mpx_torch.dtypes import torch_dtype
from mpx_torch.kernels.common import BandGeometry, BandOut
from mpx_torch.kernels.mxu import sweep_band_max, sweep_band_mxu
from mpx_torch.types import Aggregates, Stats

# Launches of the CUDA kernel pair (a plain count; reset by whoever reads it).
LAUNCHES = 0


def sweep_band_mxu_fused(stats: Stats, r0: int, k0: int, geom: BandGeometry,
                         dtype) -> BandOut:
    global LAUNCHES
    U, inv = stats.windows, stats.inv
    if U is None:
        raise ValueError("stats.windows is required (see ops.precompute)")
    if U.device.type == "cpu":
        return sweep_band_mxu(stats, r0, k0, geom, dtype)
    if U.device.type != "cuda":
        raise ValueError(f"mxu_fused runs on CUDA tensors, got {U.device}")

    dt = torch_dtype(dtype)
    S, W, m, w, excl = geom.S, geom.W, geom.m, geom.w, geom.excl
    r0, k0 = int(r0), int(k0)
    c0 = r0 + k0
    pw = U.shape[0]
    if U.dtype != dt or inv.dtype != dt:
        raise ValueError(f"stats are {U.dtype}/{inv.dtype}, sweep asked for {dt}")
    if U.dim() != 2 or U.shape[1] != m or not U.is_contiguous():
        raise ValueError(f"windows must be a contiguous (pw, {m}) matrix, got "
                         f"{tuple(U.shape)} contiguous={U.is_contiguous()}")
    if inv.shape != (pw,) or not inv.is_contiguous() or inv.device != U.device:
        raise ValueError("inv must be a contiguous (pw,) vector beside windows")
    if geom.wc != w:
        raise ValueError("mxu_fused is a self-join kernel (wc must equal w)")
    if min(r0, c0) < 0 or r0 + S > pw or c0 + W > pw:
        raise ValueError(f"job rows [{r0}, {r0 + S}) / columns [{c0}, {c0 + W}) "
                         f"outside the {pw}-row window matrix")
    if pw >= 2**31:
        raise ValueError("profile width exceeds the kernel's int32 indices")

    from mpx_torch.kernels import _build

    lib = _build.load()
    BM, BN = lib.mpx_k1_block_m(), lib.mpx_k1_block_n()
    nbn, nbm = -(-W // BN), -(-S // BM)
    dev = U.device
    part_rv = torch.empty((nbn, S), dtype=dt, device=dev)
    part_ri = torch.empty((nbn, S), dtype=torch.int32, device=dev)
    part_cv = torch.empty((nbm, W), dtype=dt, device=dev)
    part_ci = torch.empty((nbm, W), dtype=torch.int32, device=dev)
    row_v = torch.empty(S, dtype=dt, device=dev)
    row_i = torch.empty(S, dtype=torch.int32, device=dev)
    col_v = torch.empty(W, dtype=dt, device=dev)
    col_i = torch.empty(W, dtype=torch.int32, device=dev)

    fn = lib.mpx_k1_sweep_f64 if dt == torch.float64 else lib.mpx_k1_sweep_f32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(U.data_ptr(), inv.data_ptr(), m, r0, c0, S, W, w, excl,
                 part_rv.data_ptr(), part_ri.data_ptr(),
                 part_cv.data_ptr(), part_ci.data_ptr(),
                 row_v.data_ptr(), row_i.data_ptr(),
                 col_v.data_ptr(), col_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mxu_fused launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return BandOut(row=Aggregates(row_v, row_i), col=Aggregates(col_v, col_i))


def sweep_band_max_fused(stats: Stats, r0: int, k0: int, geom: BandGeometry):
    """Pass A of the hybrid tier (counterpart of mpx's value-only
    ``sweep_band_max``): K1's float32 launch as it is, keeping the row and
    column maxima and dropping the indices.  A CPU tensor takes the plain
    :func:`mpx_torch.kernels.mxu.sweep_band_max`."""
    if stats.windows is not None and stats.windows.device.type == "cpu":
        return sweep_band_max(stats, r0, k0, geom)
    out = sweep_band_mxu_fused(stats, r0, k0, geom, "float32")
    return out.row.value, out.col.value
