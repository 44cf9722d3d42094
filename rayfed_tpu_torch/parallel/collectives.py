"""The collectives of the party-local parallel ops, over ``torch.distributed``.

The reference gets three collective forms from XLA inside ``shard_map``;
here each is a function on the local shard and a process group (one axis
of a :class:`~torch.distributed.device_mesh.DeviceMesh`,
``mesh.get_group("sp")``):

- :func:`ppermute` — the ring shift ``j → j+1`` of ``lax.ppermute`` (ring
  attention rotates K/V with it), by ``dist.batch_isend_irecv``;
  :func:`ppermute_start` returns the rotation in flight so that a ring step
  computes while the next block travels;
- :func:`broadcast` — one rank's tensor on every rank (the pipeline's
  replicated loss and outputs, the reference's ``psum`` of values that
  only the last stage holds);
- :func:`all_to_all` — the tiled ``lax.all_to_all(split_axis,
  concat_axis)`` (Ulysses), by ``dist.all_to_all_single``;
- :func:`all_gather` and :func:`local_shard` — the out and in specs of a
  ``shard_map`` over one axis: every rank runs the same program on the
  same global values (the reference's single controller), takes its shard
  in and gathers the result out.

Gradients follow that replicated view: every rank holds the same loss, so
the backward of :func:`all_gather` takes the rank's own slice of the
gradient and the backward of :func:`local_shard` gathers the slices.
:func:`all_reduce_sum` (backward: identity) and :func:`copy_to_group`
(forward: identity, backward: all-reduce) are the pair around a
computation split over a group (the expert-parallel MoE combine).

**Backends.**  :func:`init_world` starts one rank's world: ``nccl`` when
each rank has a card of its own, ``gloo`` when ranks share one (NCCL
refuses two ranks of one communicator on one device).  gloo's send and
receive take only CPU tensors (a CUDA tensor aborts the process), so on a
gloo group this module stages a CUDA tensor explicitly: a copy into a
pinned host buffer, the collective on the host, a copy back onto the card.
The kernels run on the card either way.  :data:`STAGING` counts the bytes
and the host milliseconds of those copies.  gloo's other collectives take
CUDA tensors, except the all-gather of the functional collectives that
DTensor runs (``_c10d_functional::all_gather_into_tensor``: a segfault on the
H100 with torch 2.11, where ``dist.all_gather_into_tensor`` works), so
:func:`init_world` gives that op a CUDA implementation that stages the same
way in a world of gloo ranks on the card.
"""

from __future__ import annotations

import dataclasses
import datetime
import time
from typing import List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from rayfed_tpu_torch.utils.platform import resolve_device


@dataclasses.dataclass
class StagingStats:
    """Copies between the card and pinned host buffers on gloo groups."""

    bytes: int = 0  # device-to-host plus host-to-device
    ms: float = 0.0  # host wall of those copies, each waited for

    def reset(self) -> None:
        self.bytes, self.ms = 0, 0.0


STAGING = StagingStats()


def backend_for(device: torch.device, world_size: int) -> str:
    """``nccl`` when every rank of a world on the card has a card of its
    own, ``gloo`` otherwise (ranks sharing a card, or the CPU)."""
    if device.type == "cuda" and world_size <= torch.cuda.device_count() and dist.is_nccl_available():
        return "nccl"
    return "gloo"


def init_world(
    rank: int,
    world_size: int,
    port: Optional[int] = None,
    *,
    store: Optional[dist.Store] = None,
    device: Optional[Union[str, torch.device]] = None,
    local_rank: Optional[int] = None,
    timeout_s: float = 300.0,
) -> torch.device:
    """Join a world of ``world_size`` ranks rendezvousing on
    ``tcp://127.0.0.1:port`` (take the port from
    :func:`rayfed_tpu_torch.utils.ports.free_loopback_ports`), or on a
    ``store`` the caller made (a multi-process party's,
    :class:`~rayfed_tpu_torch.distributed.PartyProcessGroup`); return this
    rank's device.

    The device is ``cuda:(local_rank % device_count)`` (``local_rank``
    defaults to ``rank``) unless ``device`` is given (``"cpu"`` for a CPU
    world); the backend is :func:`backend_for`'s.
    """
    if (port is None) == (store is None):
        raise ValueError("init_world needs exactly one of a port and a store")
    if device is None:
        resolve_device(None)  # raises without a card
        lr = rank if local_rank is None else local_rank
        device = torch.device("cuda", lr % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend_for(device, world_size)
    rendezvous = {"store": store} if store is not None else {"init_method": f"tcp://127.0.0.1:{port}"}
    dist.init_process_group(
        backend,
        rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
        **rendezvous,
    )
    if backend == "gloo" and device.type == "cuda":
        _stage_functional_all_gather()
    return device


_STAGED_OPS = []  # the torch.library registrations of _stage_functional_all_gather


def _gloo_group(group_name):
    if isinstance(group_name, dist.ProcessGroup):
        return group_name
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(group_name)


def _staged_all_gather_into_tensor(input, group_size, group_name):
    """``[group_size·d0, ...]``: every rank's ``input`` along dim 0, gathered
    by gloo on pinned host copies."""
    host = _to_host([input.contiguous()])[0]
    out = torch.empty((group_size * host.shape[0],) + tuple(host.shape[1:]), dtype=host.dtype, pin_memory=True)
    dist.all_gather(list(out.chunk(group_size)), host, group=_gloo_group(group_name))
    return _to_device([out], input.device)[0]


def _staged_all_gather_coalesced(inputs, group_size, group_name):
    return [_staged_all_gather_into_tensor(x, group_size, group_name) for x in inputs]


def _stage_functional_all_gather() -> None:
    """Give the functional all-gather (DTensor's) a CUDA implementation that
    stages through pinned host buffers; once per process, in a process
    whose world is gloo on the card (its groups are all gloo)."""
    if _STAGED_OPS:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", _staged_all_gather_into_tensor, "CUDA")
    lib.impl("all_gather_into_tensor_coalesced", _staged_all_gather_coalesced, "CUDA")
    _STAGED_OPS.append(lib)


def _staged(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Pinned host copies of CUDA tensors, complete on return."""
    t0 = time.perf_counter()
    hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(hosts, tensors):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream().synchronize()
    STAGING.ms += (time.perf_counter() - t0) * 1e3
    STAGING.bytes += sum(h.numel() * h.element_size() for h in hosts)
    return hosts


def _to_device(hosts: Sequence[torch.Tensor], device: torch.device) -> List[torch.Tensor]:
    t0 = time.perf_counter()
    outs = [h.to(device, non_blocking=True) for h in hosts]
    torch.cuda.current_stream(device).synchronize()
    STAGING.ms += (time.perf_counter() - t0) * 1e3
    STAGING.bytes += sum(h.numel() * h.element_size() for h in hosts)
    return outs


# ---------------------------------------------------------------------------
# ppermute: the ring shift
# ---------------------------------------------------------------------------


class PendingPermute:
    """A ring shift in flight; :meth:`wait` returns the received tensors."""

    def __init__(self, works, sent, received, device, staged):
        self._works, self._sent, self._received = works, sent, received
        self._device, self._staged = device, staged

    def wait(self) -> List[torch.Tensor]:
        for w in self._works:
            w.wait()
        if self._staged:
            return _to_device(self._received, self._device)
        return self._received


def ppermute_start(
    tensors: Sequence[torch.Tensor],
    group,
    shift: int = 1,
    *,
    send: bool = True,
    recv: bool = True,
    tag: int = 0,
) -> PendingPermute:
    """Send each tensor to group rank ``r + shift`` and receive the same
    shapes from ``r − shift`` (mod the group size); returns at once.

    ``send=False`` or ``recv=False`` drops this rank's half of the shift: the
    tensors are then only the shapes of what is received, or nothing is
    received (:meth:`PendingPermute.wait` returns ``[]``).  A pipeline's hop
    is such a half shift, posted by the sending and the receiving stage
    alone.  ``tag`` offsets the message tags, so that two shifts in flight
    between the same pair of ranks cannot match each other's messages.

    On a gloo group CUDA tensors go through pinned host buffers: the copy
    out completes here, the copy back in :meth:`PendingPermute.wait`.
    """
    tensors = [t.contiguous() for t in tensors]
    n, me = dist.get_world_size(group), dist.get_rank(group)
    if n == 1 or not tensors or not (send or recv):
        return PendingPermute([], tensors, tensors if recv else [], None, False)
    device = tensors[0].device
    staged = _staged(group, tensors[0])
    out = (_to_host(tensors) if staged else tensors) if send else []
    inbox = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) if staged else torch.empty_like(t)
             for t in tensors] if recv else []
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    ops = [dist.P2POp(dist.isend, t, dst, group, tag + i) for i, t in enumerate(out)]
    ops += [dist.P2POp(dist.irecv, t, src, group, tag + i) for i, t in enumerate(inbox)]
    return PendingPermute(dist.batch_isend_irecv(ops), out, inbox, device, staged)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, shift, *tensors):
        ctx.group, ctx.shift = group, shift
        ctx.like = [torch.empty_like(t, device="meta") for t in tensors]
        ctx.device = tensors[0].device
        return tuple(ppermute_start(tensors, group, shift).wait())

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros_like(m, device=ctx.device) if g is None else g
                 for m, g in zip(ctx.like, grads)]
        back = ppermute_start(grads, ctx.group, -ctx.shift).wait()
        return (None, None, *back)


def ppermute(tensors: Sequence[torch.Tensor], group, shift: int = 1) -> List[torch.Tensor]:
    """:func:`ppermute_start` then wait; differentiable (the gradient
    shifts back)."""
    if dist.get_world_size(group) == 1:
        return list(tensors)
    return list(_PPermute.apply(group, shift, *tensors))


# ---------------------------------------------------------------------------
# all_to_all, all_gather, all_reduce
# ---------------------------------------------------------------------------


def _all_to_all_raw(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    inp = torch.stack(x.chunk(n, dim=split_axis), 0).contiguous()
    staged = _staged(group, inp)
    src = _to_host([inp])[0] if staged else inp
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    if staged:
        out = _to_device([out], x.device)[0]
    return torch.cat(out.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _all_to_all_raw(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _all_to_all_raw(g, group, concat_axis, split_axis), None, None, None


def all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """The tiled all-to-all: ``x`` splits into group-size chunks along
    ``split_axis``, chunk ``j`` goes to group rank ``j``, and the received
    chunks concatenate along ``concat_axis`` in rank order.  Differentiable."""
    if x.shape[split_axis] % dist.get_world_size(group):
        raise ValueError(
            f"all_to_all: dim {split_axis} ({x.shape[split_axis]}) is not divisible by "
            f"the group size ({dist.get_world_size(group)})"
        )
    return _AllToAll.apply(x, group, split_axis, concat_axis)


def _all_gather_raw(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    x = x.contiguous()
    staged = _staged(group, x)
    src = _to_host([x])[0] if staged else x
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    if staged:
        parts = _to_device(parts, x.device)
    return torch.cat(parts, dim=dim)


def _my_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x.chunk(dist.get_world_size(group), dim=dim)[dist.get_rank(group)].contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return _all_gather_raw(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        return _my_slice(g, group, dim), None, None


class _LocalShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return _my_slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        return _all_gather_raw(g, group, dim), None, None


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (a
    ``shard_map`` out spec).  The gradient is this rank's slice."""
    if dist.get_world_size(group) == 1:
        return x
    return _AllGather.apply(x, group, dim)


def local_shard(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's contiguous shard of a global ``x`` along ``dim`` (a
    ``shard_map`` in spec).  The gradient gathers every rank's shard."""
    if x.shape[dim] % dist.get_world_size(group):
        raise ValueError(
            f"dim {dim} ({x.shape[dim]}) is not divisible by the group size ({dist.get_world_size(group)})"
        )
    if dist.get_world_size(group) == 1:
        return x
    return _LocalShard.apply(x, group, dim)


def broadcast(x: torch.Tensor, group, src: int) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank of ``group`` (the other ranks'
    ``x`` gives only the shape and dtype).  Not differentiable: the
    pipeline's schedules replicate their results with it."""
    if dist.get_world_size(group) == 1:
        return x
    x = x.contiguous()
    staged = _staged(group, x)
    if staged:  # the source's values go out through a pinned copy; the others only receive
        mine = dist.get_rank(group) == src
        buf = _to_host([x])[0] if mine else torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    else:
        buf = x.clone()
    dist.broadcast(buf, dist.get_global_rank(group, src), group=group)
    return _to_device([buf], x.device)[0] if staged else buf


def _all_reduce_raw(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    staged = _staged(group, x)
    buf = _to_host([x])[0] if staged else x.clone()
    dist.all_reduce(buf, group=group)
    return _to_device([buf], x.device)[0] if staged else buf


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_raw(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x``.  Each rank's part of a replicated
    result is the whole, so the gradient passes through unchanged."""
    if dist.get_world_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; its gradient is summed over the group (each rank
    holds only its part of the gradient of a computation split over it)."""
    if dist.get_world_size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group)
