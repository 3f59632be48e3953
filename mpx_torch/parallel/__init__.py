"""Several devices and processes, counterpart of ``mpx/parallel``:
job sharding (:mod:`~mpx_torch.parallel.sharding`), the ring over sharded
inputs (:mod:`~mpx_torch.parallel.ring`) and process groups
(:mod:`~mpx_torch.parallel.distributed`)."""

from mpx_torch.parallel.mesh import default_mesh
from mpx_torch.parallel.sharding import run_jobs_sharded

__all__ = ["default_mesh", "run_jobs_sharded"]
