"""K1: the fused tile sweep (matmul + masked max/argmax in one kernel).

Counterpart of ``mpx/kernels/mxu_fused.py`` (the Pallas TPU kernel
``_kernel``); the kernel itself is ``mpx_torch/csrc/mxu_fused.cu``, CUDA
C++ for sm_90a on the tensor cores.  float64 runs on the FP64 tensor cores
(DMMA), bound by their 67 TFLOP/s; float32 runs as split TF32 (three TF32
products per f32 product, ~2^-22 relative each, where plain TF32 keeps
three decimal digits), bound by 495 / 3 TFLOP/s; each 32-element slab of
m is summed in a zeroed register tile and folded into the master
accumulator with a round-to-nearest add, because the tensor cores
truncate what they add into f32.  Each 128 x 64 block (two per SM)
stages the m axis through a 3-slab ``cp.async`` ring in shared memory.  The correlation tile never reaches
device memory: only per-tile (value, index) partials do, and a second
kernel in the same source reduces them to the job's ``BandOut``.  The
rows come from one window matrix and the columns from the same one (the
self-join) or from a second series' (``stats_c``: the AB-join).

A CPU tensor takes the plain PyTorch version
(:func:`mpx_torch.kernels.mxu.sweep_band_mxu`); a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from mpx_torch.dtypes import torch_dtype
from mpx_torch.kernels.common import NO_EXCL, BandGeometry, BandOut
from mpx_torch.kernels.mxu import sweep_band_max, sweep_band_mxu
from mpx_torch.types import Aggregates, Stats
from mpx_torch.utils.profile import count


def kernel_excl(excl: int, pw: int) -> int:
    """The exclusion bound the kernel is given: ``excl`` itself, or ``-pw``
    for the AB-join's "no zone" (:data:`NO_EXCL` or below) and for any
    bound below ``-pw``.  Every pair of a job has ``c - r > -pw`` (its rows
    lie below the row matrix's ``pw``), so ``-pw`` lets every pair pass at
    any width, where NO_EXCL itself would fail pairs more than 2**30 apart,
    and it stays inside int32 for every ``pw < 2**31``, which the wrapper
    checks."""
    excl, pw = int(excl), int(pw)
    return -pw if excl <= NO_EXCL or excl < -pw else excl


def _check_operand(U: torch.Tensor, inv: torch.Tensor, m: int, dt, what: str) -> None:
    if U.dtype != dt or inv.dtype != dt:
        raise ValueError(f"{what} stats are {U.dtype}/{inv.dtype}, sweep asked for {dt}")
    if U.dim() != 2 or U.shape[1] != m or not U.is_contiguous():
        raise ValueError(f"{what} windows must be a contiguous (pw, {m}) matrix, got "
                         f"{tuple(U.shape)} contiguous={U.is_contiguous()}")
    if inv.shape != (U.shape[0],) or not inv.is_contiguous() or inv.device != U.device:
        raise ValueError(f"{what} inv must be a contiguous (pw,) vector beside its windows")
    if U.shape[0] >= 2**31:
        raise ValueError(f"{what} profile width exceeds the kernel's int32 indices")


def sweep_band_mxu_fused(stats: Stats, r0: int, k0: int, geom: BandGeometry,
                         dtype, stats_c: Stats | None = None) -> BandOut:
    """One job through K1: rows ``[r0, r0+S)`` of ``stats`` against columns
    ``[c0, c0+W)``, ``c0 = r0 + k0``, of ``stats_c`` (an AB-join's second
    series, bounded by ``geom.wc``) or, without it, of ``stats`` again."""
    sc = stats if stats_c is None else stats_c
    U, inv, Uc, inv_c = stats.windows, stats.inv, sc.windows, sc.inv
    if U is None or Uc is None:
        raise ValueError("stats.windows is required (see ops.precompute)")
    if U.device.type == "cpu" and Uc.device.type == "cpu":
        return sweep_band_mxu(stats, r0, k0, geom, dtype, stats_c)
    if U.device.type != "cuda" or Uc.device != U.device:
        raise ValueError(f"mxu_fused runs on CUDA tensors of one device, got "
                         f"{U.device} and {Uc.device}")

    dt = torch_dtype(dtype)
    S, W, m, w, wc = geom.S, geom.W, geom.m, geom.w, geom.wc
    r0, k0 = int(r0), int(k0)
    c0 = r0 + k0
    pw, pwc = U.shape[0], Uc.shape[0]
    _check_operand(U, inv, m, dt, "row")
    _check_operand(Uc, inv_c, m, dt, "column")
    if min(r0, c0) < 0 or r0 + S > pw or c0 + W > pwc:
        raise ValueError(f"job rows [{r0}, {r0 + S}) / columns [{c0}, {c0 + W}) "
                         f"outside the {pw}-row / {pwc}-row window matrices")

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
        err = fn(U.data_ptr(), inv.data_ptr(), Uc.data_ptr(), inv_c.data_ptr(), m, r0, c0,
                 S, W, w, wc, kernel_excl(geom.excl, pw),
                 part_rv.data_ptr(), part_ri.data_ptr(),
                 part_cv.data_ptr(), part_ci.data_ptr(),
                 row_v.data_ptr(), row_i.data_ptr(),
                 col_v.data_ptr(), col_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mxu_fused launch failed: cudaError_t {err}")
    count("launches.k1")
    return BandOut(row=Aggregates(row_v, row_i), col=Aggregates(col_v, col_i))


def sweep_band_max_fused(stats: Stats, r0: int, k0: int, geom: BandGeometry,
                         stats_c: Stats | None = None):
    """Pass A of the hybrid tier (counterpart of mpx's value-only
    ``sweep_band_max``): K1's float32 launch as it is, keeping the row and
    column maxima and dropping the indices; ``stats_c`` as for
    :func:`sweep_band_mxu_fused`.  A CPU tensor takes the plain
    :func:`mpx_torch.kernels.mxu.sweep_band_max`."""
    if stats.windows is not None and stats.windows.device.type == "cpu":
        return sweep_band_max(stats, r0, k0, geom, stats_c)
    out = sweep_band_mxu_fused(stats, r0, k0, geom, "float32", stats_c)
    return out.row.value, out.col.value
