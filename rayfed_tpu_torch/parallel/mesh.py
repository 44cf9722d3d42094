"""Device-mesh construction for a party's world of ranks.

The port of ``rayfed_tpu/parallel/mesh.py``.  Axis-name conventions used
across the framework (models, sharding strategies, ring attention):

- ``dp``   — data parallel (batch split; gradients all-reduced)
- ``fsdp`` — fully-sharded data parallel (params sharded over this axis)
- ``tp``   — tensor/model parallel (matmul contracting or feature dims)
- ``sp``   — sequence/context parallel (ring attention / Ulysses)
- ``ep``   — expert parallel (MoE experts spread over this axis)
- ``pp``   — pipeline parallel (layer stages)

The reference lays a ``jax.sharding.Mesh`` over the devices one controller
sees.  Here a mesh is a ``torch.distributed`` :class:`DeviceMesh` over the
ranks of an initialized world, one process per rank
(:func:`rayfed_tpu_torch.parallel.collectives.init_world`): every rank of
the world calls :func:`create_mesh` with the same arguments.
``create_mesh({'dp': 2, 'tp': 2})`` lays the world's ranks out in that
order; a trailing axis may be -1 to absorb the remaining ranks.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from rayfed_tpu_torch.utils.platform import resolve_device

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_TP = "tp"
AXIS_SP = "sp"
AXIS_EP = "ep"
AXIS_PP = "pp"

STANDARD_AXES = (AXIS_DP, AXIS_FSDP, AXIS_TP, AXIS_SP, AXIS_EP, AXIS_PP)


def _world_ranks() -> list:
    if not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed world: start one process per rank and call "
            "rayfed_tpu_torch.parallel.collectives.init_world in each first"
        )
    return list(range(dist.get_world_size()))


def create_mesh(
    shape: Optional[Dict[str, int]] = None,
    devices: Optional[Sequence[int]] = None,
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> DeviceMesh:
    """Build a named mesh over this world's ranks.

    ``shape`` maps axis name → size, in the order given (insertion order is
    the rank-grid order: put the most-communicating axis last).  One axis
    may be -1.  With ``shape=None`` the mesh is 1-D data-parallel over all
    ranks.  ``devices`` is a list of global ranks (default: the whole
    world), so a mesh may cover a part of the world, as the reference's
    ``jax.devices()[:4]`` does; every rank of the world still calls this.
    The mesh's device type is the card's unless ``device`` says otherwise
    (``device="cpu"`` for a gloo world on the CPU).
    """
    if devices is None:
        devices = _world_ranks()
    devices = [int(r) for r in devices]
    n = len(devices)
    if not shape:
        shape = {AXIS_DP: n}
    names = list(shape.keys())
    sizes = list(shape.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if known <= 0 or n % known:
            raise ValueError(
                f"cannot infer -1 axis: {n} devices not divisible by {known}"
            )
        sizes[sizes.index(-1)] = n // known
    total = math.prod(sizes)
    if total != n:
        raise ValueError(
            f"mesh shape {dict(zip(names, sizes))} requires {total} devices, "
            f"but {n} are visible"
        )
    _world_ranks()
    grid = torch.tensor(devices, dtype=torch.int64).reshape(sizes)
    return DeviceMesh(resolve_device(device).type, grid, mesh_dim_names=tuple(names))


def single_device_mesh(device: Optional[Union[str, torch.device]] = None) -> DeviceMesh:
    """A 1-rank ``dp`` mesh — lets sharded code paths run unchanged.

    Needs a world of one rank; with no world yet, one is started in this
    process (gloo over an in-process store, no port).
    """
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_world_size() != 1:
        raise ValueError(
            f"single_device_mesh needs a world of one rank, this one has "
            f"{dist.get_world_size()}; use create_mesh(devices=[rank]) on every rank"
        )
    return DeviceMesh(dev.type, torch.tensor([0]), mesh_dim_names=(AXIS_DP,))


def mesh_axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The size of ``axis`` in ``mesh``; 1 for an axis the mesh lacks."""
    return dict(zip(mesh.mesh_dim_names or (), mesh.mesh.shape)).get(axis, 1)
