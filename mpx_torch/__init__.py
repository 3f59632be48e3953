"""mpx_torch: the matrix-profile framework in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``mpx`` (which stays the reference); module names
match mpx's.  This package imports ``torch`` and never ``jax`` or ``mpx``.
Ported so far: the single-series self-join (``matrix_profile``,
``compute_matrix_profile``) through the fused tile-sweep kernel K1
(``kernels/mxu_fused.py``, ``csrc/mxu_fused.cu``), the SCAMP recurrence K3
(``kernels/recurrence.py``, ``csrc/band_recurrence.cu``) and the hybrid
float64 tier (``hybrid.py``, ``kernel='hybrid'``), and the ``compute``
command line (``python -m mpx_torch compute``).
"""

from mpx_torch.config import MatrixProfileConfig, make_job_grid
from mpx_torch.driver import compute_matrix_profile, matrix_profile
from mpx_torch.types import Aggregates, JobGrid, Stats

__version__ = "0.1.0"

__all__ = [
    "MatrixProfileConfig",
    "make_job_grid",
    "compute_matrix_profile",
    "matrix_profile",
    "Aggregates",
    "JobGrid",
    "Stats",
]
