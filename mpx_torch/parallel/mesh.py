"""Device meshes, counterpart of ``mpx/parallel/mesh.py``.

mpx lays a 1-D ``jax.sharding.Mesh`` over the chips and shards the job
list over it.  The port's mesh is a tuple of ``torch.device``: shard ``d``
runs on ``mesh[d]``.  On CUDA it is the first visible cards; on the CPU it
is ``num_devices`` virtual shards of the one CPU (the counterpart of the
virtual CPU devices mpx's tests run on).  A caller may also name one card
more than once (``(torch.device("cuda", 0),) * 4``): virtual shards of
that card, which the sharded code runs like distinct devices.  No entry
point builds such a mesh by itself.
"""

from __future__ import annotations

from typing import Optional

import torch


def default_mesh(num_devices: Optional[int] = None, axis: str = "jobs",
                 device="cuda") -> tuple:
    """A 1-D mesh of ``num_devices`` devices of ``device``'s type (default:
    every visible card, or one CPU shard).  ``axis`` names the mesh axis in
    mpx; the port's mesh is a plain tuple and keeps it for the same calls."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return (dev,) * (num_devices or 1)
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(
                f"requested {num_devices} devices, only {len(devices)} available"
            )
        devices = devices[:num_devices]
    return tuple(devices)


def mesh_for(num_shards: int, mesh, device) -> tuple:
    """``mesh`` as a tuple of ``num_shards`` devices, or the default mesh of
    that size on ``device``'s type."""
    mesh = default_mesh(num_shards, device=device) if mesh is None else tuple(
        torch.device(d) for d in mesh)
    if len(mesh) != num_shards:
        raise ValueError(f"mesh has {len(mesh)} devices for num_shards={num_shards}")
    return mesh
