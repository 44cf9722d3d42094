"""Sharding strategies: how a party's compute maps onto its mesh.

The port of ``rayfed_tpu/parallel/sharding.py``.  A
:class:`ShardingStrategy` bundles the mesh with partition rules for params
and batch.  Where the reference places ``jax.Array``s with
``NamedSharding``s and lets XLA insert the collectives, here the params and
the batch become ``torch.distributed.tensor`` DTensors with one placement
per mesh dim (``Shard(dim)`` or ``Replicate()``), and DTensor's sharding
propagation inserts the collectives op by op.

A rule's spec is the reference's ``PartitionSpec`` as a plain tuple, one
entry per tensor dim: ``None``, an axis name, or a tuple of axis names (the
dim split over those mesh axes, in mesh order).  :func:`shard_params_by_rules`
prunes the axes the mesh lacks, so one rule set serves every mesh shape,
and gives each leaf a :class:`NamedSharding` whose ``spec`` compares leaf
for leaf with the reference's.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils import _pytree as pytree

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.parallel.mesh import AXIS_DP, AXIS_FSDP, AXIS_TP

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A pruned spec on a mesh and the DTensor placements it stands for."""

    mesh: DeviceMesh
    spec: Spec

    @property
    def placements(self) -> tuple:
        return spec_placements(self.mesh, self.spec)


def spec_placements(mesh: DeviceMesh, spec: Spec) -> tuple:
    """One placement per mesh dim: ``Shard(d)`` where tensor dim ``d``'s
    entry names that mesh axis, else ``Replicate()``."""
    names = mesh.mesh_dim_names or ()
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            if axis is None:
                continue
            i = names.index(axis)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {axis!r} shards two dims in spec {spec}")
            out[i] = Shard(dim)
    return tuple(out)


def replicated(mesh: DeviceMesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def _path_str(path) -> str:
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "name"):
            parts.append(str(p.name))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return "/".join(parts)


def shard_params_by_rules(
    mesh: DeviceMesh,
    params: Any,
    rules: Sequence[Tuple[str, Spec]],
    default: Optional[Spec] = None,
) -> Any:
    """A :class:`NamedSharding` tree for ``params`` from (regex, spec) rules.

    First matching rule wins (t5x-style partitioning rules, applied to the
    '/'-joined tree path).  Unmatched leaves use ``default`` (replicated if
    None).  Specs naming axes absent from the mesh degrade to None on that
    dim.
    """
    default = tuple(default) if default is not None else ()
    compiled = [(re.compile(pat), tuple(spec)) for pat, spec in rules]
    axis_names = set(mesh.mesh_dim_names or ())

    def _prune(spec: Spec) -> Spec:
        pruned = []
        for entry in spec:
            if entry is None:
                pruned.append(None)
            elif isinstance(entry, (tuple, list)):
                kept = tuple(a for a in entry if a in axis_names)
                pruned.append(kept if kept else None)
            else:
                pruned.append(entry if entry in axis_names else None)
        return tuple(pruned)

    def _assign(path, leaf):
        path_s = _path_str(path)
        for pat, spec in compiled:
            if pat.search(path_s):
                return NamedSharding(mesh, _prune(spec))
        return NamedSharding(mesh, _prune(default))

    return pytree.tree_map_with_path(_assign, params)


def _distribute(x: torch.Tensor, mesh: DeviceMesh, placements) -> DTensor:
    """``x``'s shard on this rank.  Every rank passes the same values (the
    reference's one controller places one host copy), so no data moves."""
    return distribute_tensor(x.to(mesh.device_type), mesh, placements, src_data_rank=None)


@dataclasses.dataclass
class ShardingStrategy:
    """Declarative parallelism plan for a party's compute.

    - ``batch_axes``: mesh axes the leading batch dim is split over (DP).
    - ``param_rules``: (regex, spec) rules for model params — FSDP ≈ shard
      large kernels over 'fsdp'; TP ≈ shard feature dims over 'tp'; EP ≈
      shard the expert dim over 'ep'.
    - ``seq_axis``: mesh axis for sequence parallelism (ring attention /
      Ulysses), consumed by the attention ops.
    - ``pp_axis``: mesh axis for pipeline stages
      (:mod:`rayfed_tpu_torch.parallel.pipeline`).
    """

    mesh: DeviceMesh
    batch_axes: Tuple[str, ...] = (AXIS_DP,)
    param_rules: Tuple[Tuple[str, Spec], ...] = ()
    param_default: Optional[Spec] = None
    seq_axis: Optional[str] = None
    pp_axis: Optional[str] = None

    def batch_sharding(self, ndim: int = 2) -> NamedSharding:
        axes = tuple(a for a in self.batch_axes if a in (self.mesh.mesh_dim_names or ()))
        return NamedSharding(self.mesh, (axes if axes else None,) + (None,) * (ndim - 1))

    def param_shardings(self, params: Any) -> Any:
        return shard_params_by_rules(self.mesh, params, self.param_rules, self.param_default)

    def shard_params(self, params: Any) -> Any:
        return pytree.tree_map(
            lambda x, s: _distribute(x, self.mesh, s.placements),
            params, self.param_shardings(params),
        )

    def shard_batch(self, batch: Any) -> Any:
        def _put(x):
            return _distribute(x, self.mesh, self.batch_sharding(ndim=max(1, x.ndim)).placements)

        return tree_util.tree_map(_put, batch)

    def replicate(self, tree: Any) -> Any:
        return tree_util.tree_map(
            lambda x: _distribute(x, self.mesh, replicated(self.mesh).placements), tree
        )

    def jit_step(self, step_fn: Callable) -> Callable:
        """``step_fn`` run on this strategy's DTensors (the reference's
        ``jax.jit`` under the mesh; the name is kept for the reader).

        Nothing is compiled: the step runs eagerly, DTensor's sharding
        propagation inserts each collective, and plain tensors the step
        meets (ids, tables) count as replicated over the mesh
        (``implicit_replication``).  Eager steps donate nothing, so the
        reference's ``donate_argnums`` and jit keywords have no counterpart.
        """

        def _call(*args, **kwargs):
            with implicit_replication():
                return step_fn(*args, **kwargs)

        return _call


def sharded_attn_fn(mesh: DeviceMesh, attn_fn: Callable, head_axis: str = AXIS_TP) -> Callable:
    """Run an attention written for plain tensors (the flash kernels) on
    DTensor q/k/v [B, T, H, D]: the heads split over ``head_axis``, every
    other mesh dim replicated, each rank attending over its own heads.

    The reference needs no such wrapper: XLA places the kernel call itself.
    """
    names = mesh.mesh_dim_names or ()
    placements = tuple(Shard(2) if n == head_axis else Replicate() for n in names)

    def apply(q, k, v, **kw):
        if not isinstance(q, DTensor):
            return attn_fn(q, k, v, **kw)
        local = (x.redistribute(mesh, placements).to_local() for x in (q, k, v))
        return DTensor.from_local(attn_fn(*local, **kw), mesh, placements)

    return apply


def data_parallel(mesh: DeviceMesh) -> ShardingStrategy:
    return ShardingStrategy(mesh=mesh, batch_axes=(AXIS_DP,))


def fsdp(mesh: DeviceMesh, min_shard_dim: int = 2) -> ShardingStrategy:
    """Batch over dp+fsdp; every ≥2-D kernel sharded over 'fsdp' on dim 0."""
    del min_shard_dim
    return ShardingStrategy(
        mesh=mesh,
        batch_axes=(AXIS_DP, AXIS_FSDP),
        param_rules=((r"(kernel|embedding|scale.*|w[0-9]*)$", (AXIS_FSDP,)),),
    )
