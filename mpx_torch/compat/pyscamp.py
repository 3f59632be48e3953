"""pyscamp-compatible API on the port, counterpart of
``mpx/compat/pyscamp.py``.

The reference repository's own golden tooling is written against
pyscamp (util/matrix_profile.py:1-17: ``import pyscamp as mp;
mp.selfjoin(ts, 4)``), so a user switching from matrix-profile-hls most
likely holds pyscamp call sites.  This module mirrors the pyscamp
module surface one-for-one on top of mpx_torch tiers:

====================  =========================================
pyscamp               mpx_torch tier
====================  =========================================
``selfjoin``          :func:`mpx_torch.compute_matrix_profile`
``abjoin``            :func:`mpx_torch.compute_ab_join`
``selfjoin_sum``      :func:`mpx_torch.compute_sum_thresh` (sums)
``abjoin_sum``        AB variant of the sum-threshold epilogue
``selfjoin_knn``      :func:`mpx_torch.compute_topk_profile`
``abjoin_knn``        :func:`mpx_torch.topk.compute_topk_ab`
``selfjoin_matrix``   :func:`mpx_torch.distmatrix.pooled_matrix`
``abjoin_matrix``     :func:`mpx_torch.distmatrix.pooled_matrix` (B set)
``gpu_supported``     whether a CUDA card is there
====================  =========================================

Argument mapping and documented divergences (mpx's):

* ``pearson=True`` returns Pearson correlations (converted from the
  z-normalized distances via ``p = 1 - d^2 / (2m)``); default is the
  z-normalized Euclidean distance, like pyscamp.
* ``precision`` maps 'single'/'mixed' -> float32 (full-precision float32
  products, never TF32, which is pyscamp's 'mixed' spirit) and
  'double'/'ultra' -> float64.
* ``threads`` / ``gpus`` are accepted and ignored — device placement is
  ``device=`` here ("cuda" by default), not a per-call device list.
  ``mp_filename``-style file outputs are not reproduced; use
  ``python -m mpx_torch compute -o``.
* ``selfjoin_knn`` / ``abjoin_knn`` return a ``(count, 3)`` float array
  of ``(col, row, value)`` matches (k per row, rows ascending, best
  first within a row) — pyscamp's tuple-list shape — built from the k-NN
  profile tiers (self-join and AB rectangle grids).
* matrix summaries: empty cells read correlation -1.0 / distance
  ``sqrt(4m)`` (:mod:`mpx_torch.distmatrix`), and the self-join applies
  the standard m//4 exclusion zone.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mpx_torch.analysis import _host
from mpx_torch.config import MatrixProfileConfig

_PRECISIONS = {
    "single": "float32",
    "mixed": "float32",
    "double": "double",
    "ultra": "double",
}


def _config(window: int, precision: str, device) -> MatrixProfileConfig:
    try:
        dtype = _PRECISIONS[precision]
    except KeyError:
        raise ValueError(
            f"precision must be one of {sorted(_PRECISIONS)}, got {precision!r}"
        ) from None
    return MatrixProfileConfig(m=window, dtype=dtype, device=device)


def _to_pearson(dist, m: int) -> np.ndarray:
    d = np.asarray(dist, np.float64)
    return np.clip(1.0 - d * d / (2.0 * m), -1.0, 1.0)


def gpu_supported() -> bool:
    """pyscamp reports CUDA availability: whether a CUDA card is there."""
    return torch.cuda.is_available()


def tpu_supported() -> bool:
    """mpx's extension, kept for its callers: the port runs on no TPU."""
    return False


def selfjoin(a, window: int, threads: int = 0, gpus=None,
             precision: str = "single", pearson: bool = False,
             verbose: bool = False, *, device: str = "cuda") -> Tuple[np.ndarray, np.ndarray]:
    """1-NN self-join: (profile, index), pyscamp.selfjoin-compatible."""
    del threads, gpus, verbose
    from mpx_torch.driver import compute_matrix_profile

    cfg = _config(window, precision, device)
    MP, MPI = compute_matrix_profile(np.asarray(a), config=cfg)
    MP = _host(MP)
    if pearson:
        MP = _to_pearson(MP, window)
    return MP, _host(MPI).astype(np.int64)


def abjoin(a, b, window: int, threads: int = 0, gpus=None,
           precision: str = "single", pearson: bool = False,
           verbose: bool = False, *, device: str = "cuda") -> Tuple[np.ndarray, np.ndarray]:
    """AB-join (rows from ``a``, nearest neighbor in ``b``):
    (profile, index), pyscamp.abjoin-compatible."""
    del threads, gpus, verbose
    from mpx_torch.abjoin import compute_ab_join

    cfg = _config(window, precision, device)
    res = compute_ab_join(np.asarray(a), np.asarray(b), window, config=cfg)
    MP = _host(res.mp_a)
    if pearson:
        MP = _to_pearson(MP, window)
    return MP, _host(res.mpi_a).astype(np.int64)


def selfjoin_sum(a, window: int, threshold: float = 0.0,
                 threads: int = 0, gpus=None,
                 precision: str = "single",
                 verbose: bool = False, *, device: str = "cuda") -> np.ndarray:
    """Per-window sum of correlations above ``threshold``
    (pyscamp.selfjoin_sum / SCAMP SUM_THRESH)."""
    del threads, gpus, verbose
    from mpx_torch.thresh import compute_sum_thresh

    cfg = _config(window, precision, device)
    sums, _ = compute_sum_thresh(np.asarray(a), window, config=cfg, threshold=threshold)
    return _host(sums).astype(np.float64)


def abjoin_sum(a, b, window: int, threshold: float = 0.0,
               threads: int = 0, gpus=None,
               precision: str = "single",
               verbose: bool = False, *, device: str = "cuda") -> np.ndarray:
    """AB variant of :func:`selfjoin_sum`: for each window of ``a``, the
    sum of its above-threshold correlations to windows of ``b``."""
    del threads, gpus, verbose
    from mpx_torch.thresh import compute_sum_thresh_ab

    cfg = _config(window, precision, device)
    sums, _ = compute_sum_thresh_ab(np.asarray(a), np.asarray(b), window,
                                    config=cfg, threshold=threshold)
    return _host(sums).astype(np.float64)


def selfjoin_knn(a, window: int, k: int, threads: int = 0, gpus=None,
                 precision: str = "single", pearson: bool = False,
                 verbose: bool = False, *, device: str = "cuda") -> np.ndarray:
    """k-NN self-join as a ``(count, 3)`` array of (col, row, value)
    matches — k per row (fewer where neighbors run out), rows ascending,
    best-first within a row; value is distance or correlation."""
    del threads, gpus, verbose
    from mpx_torch.topk import compute_topk_profile

    cfg = _config(window, precision, device)
    D, I = compute_topk_profile(np.asarray(a), window, k=k, config=cfg)
    return _knn_matches(D, I, window, pearson)


def _knn_matches(D, I, window: int, pearson: bool) -> np.ndarray:
    """(w, k) top-k arrays -> pyscamp's (count, 3) (col, row, value)."""
    D = _host(D).astype(np.float64)
    I = _host(I)
    w = D.shape[0]
    rows = np.repeat(np.arange(w), D.shape[1])
    cols = I.ravel()
    vals = D.ravel()
    keep = cols >= 0
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    if pearson:
        vals = _to_pearson(vals, window)
    return np.column_stack([cols.astype(np.float64), rows.astype(np.float64), vals])


def abjoin_knn(a, b, window: int, k: int, threads: int = 0, gpus=None,
               precision: str = "single", pearson: bool = False,
               verbose: bool = False, *, device: str = "cuda") -> np.ndarray:
    """k-NN AB-join: ``(count, 3)`` array of (col-in-b, row-in-a, value)
    matches — k per row of ``a`` (fewer where B runs out), rows
    ascending, best-first within a row."""
    del threads, gpus, verbose
    from mpx_torch.topk import compute_topk_ab

    cfg = _config(window, precision, device)
    D, I = compute_topk_ab(np.asarray(a), np.asarray(b), window, k=k, config=cfg)
    return _knn_matches(D, I, window, pearson)


def selfjoin_matrix(a, window: int, mwidth: int = 50, mheight: int = 50,
                    threads: int = 0, gpus=None,
                    precision: str = "single", pearson: bool = False,
                    verbose: bool = False, *, device: str = "cuda") -> np.ndarray:
    """Pooled (mheight x mwidth) summary of the self-join distance
    matrix (pyscamp.selfjoin_matrix / SCAMP matrix summaries)."""
    del threads, gpus, precision, verbose  # the summary tier is f32-only
    from mpx_torch.distmatrix import pooled_matrix

    return pooled_matrix(np.asarray(a), window, mwidth=mwidth, mheight=mheight,
                         pearson=pearson, config=MatrixProfileConfig(m=window, device=device))


def abjoin_matrix(a, b, window: int, mwidth: int = 50, mheight: int = 50,
                  threads: int = 0, gpus=None,
                  precision: str = "single", pearson: bool = False,
                  verbose: bool = False, *, device: str = "cuda") -> np.ndarray:
    """Pooled (mheight x mwidth) summary of the AB-join distance matrix
    (rows pool windows of ``a``, columns windows of ``b``)."""
    del threads, gpus, precision, verbose
    from mpx_torch.distmatrix import pooled_matrix

    return pooled_matrix(np.asarray(a), window, mwidth=mwidth, mheight=mheight,
                         B=np.asarray(b), pearson=pearson,
                         config=MatrixProfileConfig(m=window, device=device))
