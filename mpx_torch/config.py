"""Runtime configuration, counterpart of ``mpx/config.py``.

* ``m``          — subsequence length
* ``dtype``      — compute dtype: float32 or float64; or a fixed-point
  format ``ap16``/``ap24`` (float32 compute) or ``ap32``/``ap64`` (float64),
  which sets ``input_quant``
* ``input_quant`` — quantize the input to this ap_fixed format before
  computing (mpx_torch.io.apfixed)
* ``kernel``     — 'auto' | 'mxu' | 'mxu_fused' | 'xla' | 'pallas' (see
  mpx_torch.kernels) | 'hybrid' (mpx_torch.hybrid)
* ``band``       — rows per job
* ``chunk``      — diagonals per job
* ``tile_rows`` / ``tile_cols`` — kept for API parity with mpx: they only
  round ``band``/``chunk`` in ``shrink_to``; the CUDA kernels pick their
  own tiles and mask the ragged edges
* ``num_shards`` — device count for the sharded path: the job list is
  dealt over a mesh of that many devices (:mod:`mpx_torch.parallel`)
* ``shard_mode`` — 'jobs' (statistics replicated, job list sharded) or
  'ring' (the inputs sharded, a column shard visits each device)
* ``device``     — torch device every tensor of the run lives on (with
  shards: the device type of the default mesh, and where results land)

Options that mpx has and the port does not yet implement are accepted as
fields so that calls read the same, and raise ``NotImplementedError``
naming the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mpx_torch.dtypes import canonical_dtype
from mpx_torch.io.apfixed import FORMATS, get_format, quantize
from mpx_torch.types import JobGrid

_KERNELS = ("auto", "mxu", "mxu_fused", "xla", "pallas", "hybrid")


def _unported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported to mpx_torch yet: {item}")


@dataclasses.dataclass(frozen=True)
class MatrixProfileConfig:
    m: int = 32
    dtype: str = "float32"
    kernel: str = "auto"
    band: int = 4096
    chunk: int = 16384
    tile_rows: int = 8
    tile_cols: int = 2048
    num_shards: Optional[int] = None
    input_quant: Optional[str] = None
    shard_mode: str = "jobs"
    dispatch_group: Optional[int] = None
    device: str = "cuda"

    def __post_init__(self):
        # An ap_fixed dtype selects the quantized-input tier with the
        # narrowest exact compute dtype (ap16/ap24 mantissas fit float32,
        # ap32/ap64 need float64), as mpx.
        key = self.dtype.lower() if isinstance(self.dtype, str) else None
        if key in FORMATS:
            if self.input_quant not in (None, key):
                raise ValueError(f"dtype={self.dtype!r} conflicts with "
                                 f"input_quant={self.input_quant!r}")
            object.__setattr__(self, "input_quant", key)
            object.__setattr__(self, "dtype",
                               "float32" if key in ("ap16", "ap24") else "float64")
        elif self.input_quant is not None:
            get_format(self.input_quant)  # raises on unknown
        canonical_dtype(self.dtype)  # raises on unsupported
        if self.kernel not in _KERNELS:
            raise ValueError(f"kernel must be one of {_KERNELS}, got {self.kernel!r}")
        if self.shard_mode not in ("jobs", "ring"):
            raise ValueError(
                f"shard_mode must be 'jobs' or 'ring', got {self.shard_mode!r}"
            )
        if self.dispatch_group is not None:
            _unported("dispatch_group",
                      "ROADMAP.md 'Not to port' (a TPU relay watchdog workaround)")
        if self.m < 4:
            raise ValueError("m must be >= 4 (exclusion zone is m/4)")
        for name in ("band", "chunk", "tile_rows", "tile_cols"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be positive")
        object.__setattr__(self, "tile_rows", min(self.tile_rows, self.band))
        object.__setattr__(self, "tile_cols", min(self.tile_cols, self.chunk))
        if self.band % self.tile_rows != 0:
            raise ValueError("band must be a multiple of tile_rows")
        if self.chunk % self.tile_cols != 0:
            raise ValueError("chunk must be a multiple of tile_cols")
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device={self.device!r} was requested but no CUDA device is "
                f"available; pass device='cpu' to run the plain PyTorch path"
            )

    def validate_series(self, n: int, T=None):
        if n < self.m:
            raise ValueError(f"series length n={n} must be >= m={self.m}")
        if n - self.m + 1 < 2:
            raise ValueError("need at least 2 subsequences for a self-join")
        if T is not None:
            Tn = np.asarray(T)
            if not np.isfinite(Tn).all():
                bad = int(np.nonzero(~np.isfinite(Tn))[0][0])
                raise ValueError(
                    f"series contains a non-finite value at index {bad}; "
                    f"NaN/inf would silently poison every correlation"
                )

    def prepare_series(self, T) -> np.ndarray:
        """``T`` (array-like or tensor) as a float64 numpy array, validated
        and quantized to ``input_quant`` when that is set (mpx's order:
        quantize, then route to a tier): what every entry point computes
        on."""
        T = T.detach().cpu().numpy() if isinstance(T, torch.Tensor) else T
        T = np.asarray(T, dtype=np.float64)
        self.validate_series(T.shape[0], T)
        return T if self.input_quant is None else quantize(T, self.input_quant)

    def shrink_to(self, w: int) -> "MatrixProfileConfig":
        """Clamp band/chunk to the actual profile width so tiny inputs do
        not pay for full-size padded jobs."""
        band = min(self.band, _round_up(w, self.tile_rows))
        chunk = min(self.chunk, _round_up(w, self.tile_cols))
        if band == self.band and chunk == self.chunk:
            return self
        return dataclasses.replace(self, band=band, chunk=chunk)


def config_for(m: Optional[int], config: Optional[MatrixProfileConfig]) -> MatrixProfileConfig:
    """An entry point's config: ``config``, or a default one for ``m``
    (mpx's rule: an ``m`` given beside a config must agree with it)."""
    if config is None:
        return MatrixProfileConfig(m=m if m is not None else 32)
    if m is not None and m != config.m:
        raise ValueError(f"m={m} conflicts with config.m={config.m}")
    return config


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def make_job_grid(w: int, band: int, chunk: int) -> JobGrid:
    """Decompose the upper triangle of the (w x w) join into jobs: chunk
    k0 covers diagonals [k0, k0+chunk) and rows [0, w - k0); bands cut
    those rows into height-``band`` strips.  Order: k0 outer, r0 inner."""
    r0s, k0s = [], []
    for k0 in range(0, w, chunk):
        for r0 in range(0, w - k0, band):
            r0s.append(r0)
            k0s.append(k0)
    return JobGrid(
        r0=np.asarray(r0s, dtype=np.int32),
        k0=np.asarray(k0s, dtype=np.int32),
        band=band,
        chunk=chunk,
    )


def pad_job_grid(grid: JobGrid, multiple: int, dummy_r0: int) -> JobGrid:
    """Pad the job list to a multiple with dummy jobs whose rows are
    entirely out of range; max-merges make them no-ops."""
    num = grid.r0.shape[0]
    pad = _round_up(num, multiple) - num
    if not pad:
        return grid
    return JobGrid(
        r0=np.concatenate([grid.r0, np.full(pad, dummy_r0, np.int32)]),
        k0=np.concatenate([grid.k0, np.zeros(pad, np.int32)]),
        band=grid.band,
        chunk=grid.chunk,
    )
