"""Job-level checkpoint / resume.

Counterpart of ``mpx/checkpoint.py``.  The job grid is processed in
groups, and after each group the partial row/column aggregates (with a
fingerprint of the input and configuration and the next group's index)
are written atomically to an ``.npz`` (a temp file, then ``os.replace``).
A rerun with the same input and configuration resumes at the first
unfinished group; a mismatched or unreadable file is ignored with a
warning and the run starts fresh.

Two tiers are resumable:

* the strict sweeps (``auto``, ``mxu``, ``mxu_fused``, ``xla``,
  ``pallas``; any dtype) through :func:`compute_with_checkpoint`'s group
  loop: groups are consecutive slices of the job grid (the last may be
  short), each one :func:`mpx_torch.driver.run_jobs`;
* the hybrid float64 tier (``kernel='hybrid'``) through
  :class:`HybridCheckpoint`, which persists pass A's maxima every
  :data:`mpx_torch.hybrid.CKPT_JOBS` jobs and pass B's suspect state
  after each group of merged jobs (see the class docstring).

Both resume bit for bit: maxima and suspect merges do not depend on the
order of the jobs, and the strict loop merges its groups in the driver's
order.  Checkpoints of mpx and of this package do not mix: their
fingerprints name different kernels and product precisions.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile

import numpy as np
import torch

from mpx_torch import hybrid
from mpx_torch.config import MatrixProfileConfig, make_job_grid
from mpx_torch.driver import _agg_length, run_jobs
from mpx_torch.dtypes import AGGREGATE_INIT, canonical_dtype, torch_dtype
from mpx_torch.kernels import band_geometry, is_recurrence, needs_windows, resolve_kernel
from mpx_torch.ops.aggregates import init_aggregates, merge_aggregates, postcompute
from mpx_torch.ops.precompute import precompute_statistics
from mpx_torch.types import Aggregates, JobGrid
from mpx_torch.utils.logging import Logger
from mpx_torch.utils.profile import phase

# The products each strict kernel computes with, per dtype: part of the
# fingerprint, since aggregates of another arithmetic would merge within
# tolerance but not reproduce an uninterrupted run.
_PRECISION = {
    "mxu_fused": {"float32": "split-TF32 (three TF32 mma.sync)", "float64": "FP64 DMMA"},
    "mxu": {"float32": "FP32 matmul", "float64": "FP64 matmul"},
    "pallas": {"float32": "float64 recurrence", "float64": "float64 recurrence"},
    "xla": {"float32": "float32 recurrence", "float64": "float64 recurrence"},
}


def _digest(T: np.ndarray, meta: dict) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(np.asarray(T, np.float64)).tobytes())
    h.update(json.dumps(meta, sort_keys=True).encode())
    return h.hexdigest()


def _fingerprint(T: np.ndarray, cfg: MatrixProfileConfig, w: int, group_jobs: int = 0,
                 kernel: str = "") -> str:
    dtype = str(canonical_dtype(cfg.dtype))
    return _digest(T, {
        "m": cfg.m, "dtype": dtype, "band": cfg.band, "chunk": cfg.chunk, "w": w,
        # what next_group indexes
        "group_jobs": group_jobs,
        "kernel": kernel,
        "precision": _PRECISION.get(kernel, {}).get(dtype, ""),
    })


def _hybrid_fingerprint(T: np.ndarray, cfg: MatrixProfileConfig, w: int,
                        margin: float) -> str:
    return _digest(T, {
        "m": cfg.m, "band": cfg.band, "chunk": cfg.chunk, "w": w, "kernel": "hybrid",
        "margin": margin, "precision": hybrid.HYBRID_PRECISION, "ckpt_jobs": hybrid.CKPT_JOBS,
    })


def _save_npz(path: str, **arrays):
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)) or ".")
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp + ".npz", path)
    finally:
        # a crash between savez and replace leaves no stray temp file
        for stray in (tmp, tmp + ".npz"):
            if os.path.exists(stray):
                os.remove(stray)


def _load_raw(path: str, fp: str):
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as data:
            data = dict(data)
    except Exception as e:  # corrupt checkpoint -> start fresh
        Logger.warning(f"ignoring unreadable checkpoint {path}: {e}")
        return None
    if str(data.get("fingerprint")) != fp:
        Logger.warning(f"checkpoint {path} does not match input/config; ignoring")
        return None
    return data


def _save(path: str, rows: Aggregates, cols: Aggregates, next_group: int, fp: str):
    _save_npz(path, rows_value=rows.value.cpu().numpy(), rows_index=rows.index.cpu().numpy(),
              cols_value=cols.value.cpu().numpy(), cols_index=cols.index.cpu().numpy(),
              next_group=next_group, fingerprint=fp)


def _load(path: str, fp: str, device):
    data = _load_raw(path, fp)
    if data is None:
        return None

    def agg(side):
        return Aggregates(torch.as_tensor(data[f"{side}_value"], device=device),
                          torch.as_tensor(data[f"{side}_index"], device=device))

    return agg("rows"), agg("cols"), int(data["next_group"])


class HybridCheckpoint:
    """Pass-level checkpoint of the hybrid float64 tier (self-join, one
    device).

    Stage ``A`` persists pass A's partial row and column maxima and the
    next group of :data:`mpx_torch.hybrid.CKPT_JOBS` jobs after every
    group.  Each job's captured maxima (the sparse pass B's skip oracle)
    are not persisted: the jobs whose captures a crash lost are listed in
    ``uncaptured`` and sweep densely in pass B, which captures exactly the
    suspects the sparse sweep would.

    Stage ``B`` persists the threshold, the partial suspect summaries and
    a done mask over the job grid after each group of merged jobs.  Only
    jobs whose suspects merged are marked done: a job over the sparse flag
    budget stays pending until its dense sweep lands.  On resume the
    pending jobs sweep densely into the loaded state.

    Counts add and the K smallest / largest indices of a union do not
    depend on order, so the resumed profile equals an uninterrupted run's
    bit for bit.  The resolution stages (rescore, pass C, row scans) rerun
    from scratch on resume."""

    STAGE_A = "A"
    STAGE_B = "B"

    def __init__(self, path: str, fp: str, grid):
        self.path = path
        self.fp = fp
        self._r0 = np.asarray(grid.r0)
        self._k0 = np.asarray(grid.k0)
        self._index = {(int(r), int(k)): i for i, (r, k) in enumerate(zip(self._r0, self._k0))}
        self.njobs = len(self._index)
        self.done = np.zeros(self.njobs, bool)
        self.thr = None
        # stage-A resume: positions in the grid of the jobs whose captures
        # were lost (pass B sweeps them densely)
        self.uncaptured = np.zeros(0, np.int64)
        self._state = _load_raw(path, fp)

    # -- stage A ----------------------------------------------------
    def load_a(self):
        if self._state is None or str(self._state["stage"]) != self.STAGE_A:
            return None
        return self._state["rmax"], self._state["cmax"], int(self._state["next_group"])

    def save_a(self, rmax, cmax, next_group: int):
        _save_npz(self.path, stage=self.STAGE_A, rmax=rmax.cpu().numpy(),
                  cmax=cmax.cpu().numpy(), next_group=next_group, fingerprint=self.fp)

    # -- stage B ----------------------------------------------------
    def begin_b(self, thr):
        self.thr = thr.cpu().numpy()

    def load_b(self):
        if self._state is None or str(self._state["stage"]) != self.STAGE_B:
            return None
        self.thr = self._state["thr"]
        self.done = self._state["done"].astype(bool)
        return self._state

    def mark_done_and_save(self, rows_g, cols_g, r0s, k0s, keep=None):
        """Mark the group's jobs done (those ``keep`` selects, default all)
        and persist the suspect state."""
        for i, (r, k) in enumerate(zip(np.asarray(r0s).tolist(), np.asarray(k0s).tolist())):
            if keep is None or keep[i]:
                self.done[self._index[(r, k)]] = True
        _save_npz(self.path, stage=self.STAGE_B, thr=self.thr,
                  **{f"{side}_{f}": getattr(g, f).cpu().numpy()
                     for side, g in (("rows", rows_g), ("cols", cols_g))
                     for f in ("cnt", "mn", "mx")},
                  done=self.done, fingerprint=self.fp)

    def pending_jobs(self):
        todo = ~self.done
        return self._r0[todo].astype(np.int64), self._k0[todo].astype(np.int64)

    def finalize(self):
        if os.path.exists(self.path):
            os.remove(self.path)


def compute_hybrid_with_checkpoint(T, cfg: MatrixProfileConfig, checkpoint_path: str, *,
                                   profile=None, keep_checkpoint: bool = False,
                                   _ckpt_cls=None):
    """Resumable hybrid float64 self-join (one device): killed in pass A or
    pass B, a rerun with the same input and configuration resumes (see
    :class:`HybridCheckpoint`).  Returns (MP, MPI) as numpy: float64
    distances (cast to float32 for a float32 request) and int32 indices."""
    T = cfg.prepare_series(T)
    w = T.shape[0] - cfg.m + 1
    cfg = cfg.shrink_to(w)
    if cfg.num_shards and cfg.num_shards > 1:
        raise ValueError("checkpointed hybrid runs execute single-device")
    margin = hybrid.default_margin(cfg.m)
    fp = _hybrid_fingerprint(T, cfg, w, margin)
    grid = make_job_grid(w, cfg.band, cfg.chunk)
    ckpt = (HybridCheckpoint if _ckpt_cls is None else _ckpt_cls)(checkpoint_path, fp, grid)
    MP, MPI = hybrid.compute_matrix_profile_f64_hybrid(T, cfg, margin=margin, profile=profile,
                                                       ckpt=ckpt)
    MP, MPI = MP.cpu().numpy(), MPI.cpu().numpy()
    if canonical_dtype(cfg.dtype) == np.dtype(np.float32):
        MP = MP.astype(np.float32)  # exact float64 values, float32 storage
    if not keep_checkpoint:
        ckpt.finalize()
    return MP, MPI


def compute_with_checkpoint(T, cfg: MatrixProfileConfig, checkpoint_path: str, *,
                            group_jobs: int = 64, profile=None,
                            keep_checkpoint: bool = False):
    """Resumable matrix-profile computation (one device).

    Sweeps the job grid in groups of ``group_jobs`` jobs, persisting the
    aggregates after each group; ``kernel='hybrid'`` goes to
    :func:`compute_hybrid_with_checkpoint`.  The input is quantized to
    ``cfg.input_quant`` first, so the fingerprint covers what is computed.
    Returns (MP, MPI) as numpy and removes the checkpoint on success unless
    ``keep_checkpoint``."""
    if group_jobs < 1:
        raise ValueError("group_jobs must be >= 1")
    if cfg.kernel == "hybrid":
        return compute_hybrid_with_checkpoint(T, cfg, checkpoint_path, profile=profile,
                                              keep_checkpoint=keep_checkpoint)
    T = cfg.prepare_series(T)
    m = cfg.m
    w = T.shape[0] - m + 1
    cfg = cfg.shrink_to(w)
    S, W = cfg.band, cfg.chunk
    dt = torch_dtype(cfg.dtype)
    device = torch.device(cfg.device)
    kernel = resolve_kernel(cfg.kernel, device, dt, m)
    fp = _fingerprint(T, cfg, w, group_jobs, kernel)

    with phase(profile, "1. Pre-Computation", device=device):
        stats = precompute_statistics(T, m, band=S, chunk=W, dtype=dt, device=device,
                                      windows=needs_windows(kernel),
                                      exact_mean=is_recurrence(kernel))
    grid = make_job_grid(w, S, W)
    num_groups = -(-grid.r0.shape[0] // group_jobs)
    geom = band_geometry(S, W, m, w, cfg.tile_rows, cfg.tile_cols)

    state = _load(checkpoint_path, fp, device)
    if state is None:
        L = _agg_length(w, S, W)
        rows = init_aggregates(L, dt, AGGREGATE_INIT, device)
        cols = init_aggregates(L, dt, AGGREGATE_INIT, device)
        start = 0
    else:
        rows, cols, start = state
        Logger.info(f"resuming from checkpoint: group {start}/{num_groups}")
    for g in range(start, num_groups):
        sl = slice(g * group_jobs, (g + 1) * group_jobs)
        with phase(profile, f"2. Compute [{kernel}]", device=device):
            g_rows, g_cols = run_jobs(stats, JobGrid(grid.r0[sl], grid.k0[sl], S, W),
                                      geom=geom, dtype=dt, kernel=kernel)
            rows = merge_aggregates(rows, g_rows)
            cols = merge_aggregates(cols, g_cols)
        _save(checkpoint_path, rows, cols, g + 1, fp)

    with phase(profile, "3. Post-Computation", device=device):
        MP, MPI = postcompute(rows, cols, m, w)
        MP, MPI = MP.cpu().numpy(), MPI.cpu().numpy()
    if not keep_checkpoint and os.path.exists(checkpoint_path):
        os.remove(checkpoint_path)
    return MP, MPI
