"""Device meshes for the collective data plane.

The JAX package builds a single-controller ``jax.sharding.Mesh`` over all
devices; the port runs one process per rank (PyTorch's idiom) and builds a
``torch.distributed.device_mesh.DeviceMesh`` over the initialised process
group, whose dimensions carry the same roles (``replicated`` and
``sharded_on`` give the ``torch.distributed.tensor`` placements that stand
for the JAX package's ``NamedSharding`` specs):

- ``client`` — data-parallel fan-in of request shards (many client
  connections / ParallelChannel sub-calls).
- ``shard`` — tensor-parallel partitioning of the served state
  (PartitionChannel's N/M server groups), and the ring of ring attention.

The mesh lives on CUDA when the group's backend is NCCL and on the CPU for
gloo. Collectives then run over ``mesh.get_group(axis)``
(parallel/collectives.py).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

CLIENT_AXIS = "client"
SHARD_AXIS = "shard"


def _factor(n: int, max_shard: int = 8) -> tuple[int, int]:
    """Splits n ranks into (client, shard): shard is the smallest
    power-of-two divisor of n that is >= sqrt(n) (square-ish), capped at
    max_shard; falls back to the largest power-of-two divisor."""
    root = math.sqrt(n)
    shard = 1
    while shard < min(n, max_shard) and n % (shard * 2) == 0:
        shard *= 2
        if shard >= root:
            break
    return (n // shard, shard)


def _group_device_type() -> str:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "torch.distributed.init_process_group first (or "
                           "parallel.launch.run_ranks)")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(client: Optional[int] = None,
              shard: Optional[int] = None) -> DeviceMesh:
    """A 2-D (client x shard) mesh over every rank of the process group."""
    device_type = _group_device_type()
    n = dist.get_world_size()
    if client is None or shard is None:
        client, shard = _factor(n)
    if client * shard != n:
        raise ValueError(f"{client}x{shard} != {n} ranks")
    return DeviceMesh(device_type, torch.arange(n).reshape(client, shard),
                      mesh_dim_names=(CLIENT_AXIS, SHARD_AXIS))


def ring_mesh() -> DeviceMesh:
    """A 1-D mesh over every rank — the streaming / ring-attention ring."""
    device_type = _group_device_type()
    return DeviceMesh(device_type, torch.arange(dist.get_world_size()),
                      mesh_dim_names=(SHARD_AXIS,))


def replicated(mesh: DeviceMesh) -> list:
    """Placements that replicate a tensor over every mesh dimension."""
    return [Replicate()] * mesh.ndim


def sharded_on(mesh: DeviceMesh, axis: str, dim: int = 0) -> list:
    """Placements that split tensor dimension ``dim`` over the mesh
    dimension named ``axis`` and replicate over the others."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no dimension {axis!r} (it has {names})")
    return [Shard(dim) if n == axis else Replicate() for n in names]
