"""K3: the SCAMP diagonal-recurrence band sweep (``kernel='pallas'``).

Counterpart of ``mpx/kernels/pallas_tpu.py:sweep_band_pallas``; the kernel
itself is ``mpx_torch/csrc/band_recurrence.cu`` (CUDA C++ for sm_90a, f32
and f64: the H100 has native FP64, so unlike mpx's Pallas kernel this is
also the strict float64 tier, and it computes in float64 for float32
statistics too, rounding only its outputs).  The band's rows are cut into
segments of ``SEGMENT_ROWS`` rows, swept in parallel; each segment starts
its diagonals from the job's one exact seed
(:func:`mpx_torch.kernels.common.seed_qt`, computed here, outside the
kernel) plus the earlier segments' sums of the same update terms, which a
first kernel writes.  Only per-block (value, index) partials reach device
memory, and a last kernel reduces them to the job's ``BandOut`` (rows
(S,), columns (S + W,)).  Scratch is allocated here; the kernels allocate
nothing.

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

# Launches of the CUDA kernels of one job (a plain count; reset by whoever
# reads it).
LAUNCHES = 0
# Rows per segment, the kernel's R (checked against the built library).
SEGMENT_ROWS = 256


def sweep_band_recurrence(stats: Stats, r0: int, k0: int, geom: BandGeometry,
                          dtype) -> BandOut:
    global LAUNCHES
    if stats.df.device.type == "cpu":
        return sweep_band_xla(stats, r0, k0, geom, dtype)
    launch, out = prepare_launch(stats, r0, k0, geom, dtype)
    with torch.cuda.device(stats.df.device):
        err = launch(torch.cuda.current_stream(stats.df.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"recurrence kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out


def prepare_launch(stats: Stats, r0: int, k0: int, geom: BandGeometry, dtype):
    """Check the job, compute its seed and allocate the outputs and scratch
    on the card.  Returns (launch, out): ``launch(stream)`` launches the
    job's kernels on the CUDA stream handle ``stream`` and returns a
    cudaError_t, without counting; ``out`` is the ``BandOut`` they fill."""
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
    if lib.mpx_k3_segment_rows() != SEGMENT_ROWS:
        raise RuntimeError(f"K3 was built with {lib.mpx_k3_segment_rows()} rows per "
                           f"segment, the wrapper expects {SEGMENT_ROWS}")
    nbj, ncol = -(-W // lib.mpx_k3_block_w()), lib.mpx_k3_block_columns()
    G = -(-S // SEGMENT_ROWS)
    dev = stats.df.device
    # The kernel computes in float64 for both dtypes (csrc header).
    seed = seed_qt(stats, r0, c0, W, m, torch.float64).contiguous()
    seg = torch.empty((max(G - 1, 1), W), dtype=torch.float64, device=dev)
    part_rv = torch.empty((nbj, S), dtype=dt, device=dev)
    part_ri = torch.empty((nbj, S), dtype=torch.int32, device=dev)
    part_cv = torch.empty((G * nbj, ncol), dtype=dt, device=dev)
    part_ci = torch.empty((G * nbj, ncol), dtype=torch.int32, device=dev)
    out = BandOut(row=Aggregates(torch.empty(S, dtype=dt, device=dev),
                                 torch.empty(S, dtype=torch.int32, device=dev)),
                  col=Aggregates(torch.empty(S + W, dtype=dt, device=dev),
                                 torch.empty(S + W, dtype=torch.int32, device=dev)))
    rows = [v[r0 : r0 + S] for v in vecs[:3]]
    cols = [v[c0 : c0 + S + W] for v in vecs[:3]]
    fn = lib.mpx_k3_sweep_f64 if dt == torch.float64 else lib.mpx_k3_sweep_f32
    args = (*rows, *cols, seed, r0, k0, S, W, w, excl, seg, part_rv, part_ri,
            part_cv, part_ci, out.row.value, out.row.index, out.col.value, out.col.index)

    def launch(stream):
        return fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
                  stream)

    return launch, out
