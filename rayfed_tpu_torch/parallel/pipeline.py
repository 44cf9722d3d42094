"""Pipeline parallelism over the ``pp`` axis of a party mesh (GPipe, 1F1B,
interleaved).

The port of ``rayfed_tpu/parallel/pipeline.py``.  Stages are shards of a
*stacked* layer tree over ``pp`` (leading dim = layers); activations hop
stage → stage by :func:`~rayfed_tpu_torch.parallel.collectives.ppermute_start`
(through pinned host buffers on a gloo group, counted in
:data:`~rayfed_tpu_torch.parallel.collectives.STAGING`), one process a
stage.  Three schedules, each the reference's tick for tick:

- :func:`pipeline_collective` — GPipe's forward: stage ``s`` runs
  microbatch ``i − s`` on tick ``i``; ``M + S − 1`` ticks.  It is
  differentiable: its backward runs the ticks in reverse, recomputing each
  stage's forward from its saved input;
- :func:`pipeline_train_collective` — one forward and one backward a tick
  (1F1B): microbatch ``t − s`` forward, ``t − 2(S−1) + s`` backward, the
  backward recomputing the forward from the input saved in one of ``2S``
  slots; ``M + 2(S−1)`` ticks;
- :func:`pipeline_train_interleaved_collective` — ``v`` chunks a device,
  virtual stage ``c·S + d``; a forward pass of ``M·v + S − 1`` fine ticks
  that saves every chunk input, then its exact time reversal.

Constraints (the classic equal-width contract): stage input and output
shapes and dtypes are identical; every leaf of the stacked params has a
leading dim divisible by the stage count (times ``v``).

The collective forms take this rank's stage slice and the ``pp`` process
group (``mesh.get_group("pp")``).  The ``make_*`` functions keep the reference's
global view, as the ring attention's do: every rank passes the same global
``stacked_params`` and batch, takes its stage slice with
:func:`~rayfed_tpu_torch.parallel.collectives.local_shard` on dim 0, and
gets back the whole output, or the loss and the whole gradient tree in the
caller's layer order.

Differences the eager host allows (results equal the reference's):

- the stage is a Python int, so which ticks are live is decided on the
  host and only those run ``stage_fn``; the reference runs it on every
  tick and drops the idle ones with ``jnp.where``.  A rank's launches are
  then exactly ``M`` stage forwards (GPipe), or ``2M`` forwards and ``M``
  backwards (1F1B, and per chunk the interleaved schedule);
- a hop is posted by its two stages alone (a half ``ppermute``), not a
  ring shift of every rank, and only when the receiver consumes it; the
  last stage's results reach every rank by a broadcast where the
  reference ``psum``s zeros from the others.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from rayfed_tpu_torch.parallel import collectives as coll
from rayfed_tpu_torch.parallel.mesh import mesh_axis_size


@dataclasses.dataclass
class PipelineStats:
    """What this rank's schedules ran, summed over calls."""

    ticks: int = 0  # ticks of the schedules (per direction for the interleaved one)
    live: int = 0  # ticks that ran the stage's forward
    hops: int = 0  # activations and cotangents sent to a neighbouring stage
    hop_bytes: int = 0  # their bytes

    def reset(self) -> None:
        self.ticks = self.live = self.hops = self.hop_bytes = 0


STATS = PipelineStats()


def _hop(tensor: Optional[torch.Tensor], like: torch.Tensor, group, shift: int,
         send: bool, recv: bool, tag: int) -> coll.PendingPermute:
    """Post this stage's half of one hop: send ``tensor`` to the stage at
    ``+shift`` and/or receive a ``like``-shaped one from ``−shift``."""
    if send and dist.get_world_size(group) > 1:
        STATS.hops += 1
        STATS.hop_bytes += tensor.numel() * tensor.element_size()
    return coll.ppermute_start([tensor if send else like], group, shift, send=send, recv=recv, tag=tag)


def _received(pending: Optional[coll.PendingPermute]) -> Optional[torch.Tensor]:
    if pending is None:
        return None
    got = pending.wait()
    return got[0] if got else None


def _grad_leaves(stage_fn, spec, leaves, x, g, want_x, seed_fn=None):
    """Recompute ``y = stage_fn(params, x)`` and pull ``g`` back through it
    (``g=None``: ``seed_fn(y)``'s cotangent, from this one recompute): the
    gradients of the param leaves (zeros where unused) and, with
    ``want_x``, of ``x``."""
    with torch.enable_grad():
        p = [leaf.detach().requires_grad_(True) for leaf in leaves]
        xs = x.detach().requires_grad_(want_x)
        y = stage_fn(pytree.tree_unflatten(p, spec), xs)
        if g is None:
            g = seed_fn(y.detach())
        outs = torch.autograd.grad(y, p + ([xs] if want_x else []), g.to(y.dtype), allow_unused=True)
    gp = [torch.zeros_like(leaf) if o is None else o for leaf, o in zip(leaves, outs)]
    return gp, (outs[-1] if want_x else None)


def _seed(loss_fn, y, tgt):
    """``(loss, dloss/dy)`` of one microbatch's output."""
    with torch.enable_grad():
        yv = y.detach().requires_grad_(True)
        loss = loss_fn(yv, tgt)
        (g,) = torch.autograd.grad(loss, yv)
    return loss.detach(), g


# ---------------------------------------------------------------------------
# GPipe forward
# ---------------------------------------------------------------------------


def _gpipe_forward(leaves, spec, x_mbs, stage_fn, group, keep_inputs):
    """Run the forward ticks; return the last stage's banked outputs (other
    ranks: None) and, with ``keep_inputs``, this stage's input per
    microbatch."""
    n, s = dist.get_world_size(group), dist.get_rank(group)
    m = x_mbs.shape[0]
    params = pytree.tree_unflatten(leaves, spec)
    outputs = torch.empty_like(x_mbs) if s == n - 1 else None
    inputs: List[Optional[torch.Tensor]] = [None] * m
    pending = None
    with torch.no_grad():
        for i in range(m + n - 1):
            state = _received(pending)
            j = i - s  # this stage's microbatch on tick i
            y = None
            if 0 <= j < m:
                x_in = x_mbs[j] if s == 0 else state
                y = stage_fn(params, x_in)
                STATS.live += 1
                if keep_inputs:
                    inputs[j] = x_in
                if s == n - 1:
                    outputs[j] = y
            STATS.ticks += 1
            # Stage s hands microbatch j to s + 1, which runs it on tick i + 1.
            pending = _hop(y, x_mbs[0], group, 1, send=s < n - 1 and 0 <= j < m,
                           recv=s > 0 and 0 <= i + 1 - s < m, tag=0)
    _received(pending)
    return outputs, inputs


def _gpipe_backward(leaves, spec, inputs, g_out, stage_fn, group):
    """The forward's ticks reversed, each live one recomputing its stage
    from the saved input: this stage's param gradients and (stage 0) the
    gradient of every microbatch input."""
    n, s = dist.get_world_size(group), dist.get_rank(group)
    m = g_out.shape[0]
    grads = [torch.zeros_like(leaf) for leaf in leaves]
    dx = torch.zeros_like(g_out) if s == 0 else None
    pending = None
    for i in reversed(range(m + n - 1)):
        g_state = _received(pending)
        j = i - s
        gx = None
        if 0 <= j < m:
            g = g_out[j] if s == n - 1 else g_state
            gp, gx = _grad_leaves(stage_fn, spec, leaves, inputs[j], g, want_x=True)
            for acc, gl in zip(grads, gp):
                acc.add_(gl)
            if s == 0:
                dx[j] = gx
        pending = _hop(gx, g_out[0], group, -1, send=s > 0 and 0 <= j < m,
                       recv=s < n - 1 and 0 <= i - 1 - s < m, tag=0)
    _received(pending)
    return grads, dx


def _from_last_stage(outputs, like, group):
    """The last stage's banked ``outputs`` on every stage of ``group``."""
    n = dist.get_world_size(group)
    return coll.broadcast(outputs if dist.get_rank(group) == n - 1 else torch.empty_like(like), group, n - 1)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, spec, group, x_mbs, *leaves):
        outputs, inputs = _gpipe_forward(list(leaves), spec, x_mbs, stage_fn, group, keep_inputs=True)
        ctx.stage_fn, ctx.spec, ctx.group = stage_fn, spec, group
        ctx.inputs = inputs
        ctx.save_for_backward(*leaves)
        return _from_last_stage(outputs, x_mbs, group)

    @staticmethod
    def backward(ctx, g_out):
        # Every rank holds the same gradient of the replicated output; the
        # last stage pulls it back through the ring of stages.
        leaves = list(ctx.saved_tensors)
        grads, dx = _gpipe_backward(leaves, ctx.spec, ctx.inputs, g_out.contiguous(), ctx.stage_fn, ctx.group)
        ctx.inputs = None
        dx = coll.broadcast(dx if dx is not None else torch.empty_like(g_out), ctx.group, 0)
        return (None, None, None, dx, *grads)


def pipeline_collective(
    stage_params: Any,
    x_microbatches: torch.Tensor,
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    *,
    group,
) -> torch.Tensor:
    """Collective form — every rank of ``group`` (the ``pp`` axis) calls it.

    ``stage_params``: this stage's slice of the stacked params (leading
    dim = layers per stage).  ``x_microbatches``: [M, mb, ...], the same on
    every stage (only stage 0 reads it).  Returns [M, mb, ...] outputs on
    every stage.  Differentiable in the params and the input: the backward
    recomputes each stage from its saved microbatch inputs.
    """
    leaves, spec = pytree.tree_flatten(stage_params)
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in [x_microbatches, *leaves])
    if needs_grad:
        return _GPipe.apply(stage_fn, spec, group, x_microbatches, *leaves)
    outputs, _ = _gpipe_forward(leaves, spec, x_microbatches, stage_fn, group, keep_inputs=False)
    return _from_last_stage(outputs, x_microbatches, group)


def make_pipeline(
    mesh,
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    *,
    axis_name: str = "pp",
    num_microbatches: int,
):
    """Build a pipelined apply: (stacked_params, x) → y.

    ``stacked_params``: a tree whose leaves have leading dim = total layers
    (divisible by the ``pp`` axis size), split over ``axis_name`` on dim 0.
    ``x``: [B, ...] with B divisible by ``num_microbatches``; returns
    [B, ...].  Every rank of the mesh calls it with the same global values.
    """
    n_stages = mesh_axis_size(mesh, axis_name)
    group = mesh.get_group(axis_name)

    def apply(stacked_params, x):
        leaves, spec = pytree.tree_flatten(stacked_params)
        for leaf in leaves:
            if leaf.shape[0] % n_stages:
                raise ValueError(
                    f"stacked param leading dim {leaf.shape[0]} not divisible "
                    f"by {n_stages} pipeline stages"
                )
        b = x.shape[0]
        if b % num_microbatches:
            raise ValueError(
                f"batch {b} not divisible by {num_microbatches} microbatches"
            )
        mbs = x.reshape(num_microbatches, b // num_microbatches, *x.shape[1:])
        local = [coll.local_shard(leaf, group, 0) for leaf in leaves]
        out = pipeline_collective(pytree.tree_unflatten(local, spec), mbs, stage_fn, group=group)
        return out.reshape(b, *out.shape[2:])

    return apply


def stack_params(params_list) -> Any:
    """Stack per-layer param trees into one stacked tree (dim 0 = layer)."""
    return pytree.tree_map(lambda *xs: torch.stack(xs), *params_list)


# ---------------------------------------------------------------------------
# 1F1B training schedule
# ---------------------------------------------------------------------------


def pipeline_train_collective(
    stage_params: Any,
    x_microbatches: torch.Tensor,
    target_microbatches: torch.Tensor,
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    *,
    group,
):
    """One-forward-one-backward training schedule — every rank of ``group``
    calls it.

    Tick ``t`` runs the forward of microbatch ``t − s`` and the backward of
    microbatch ``t − 2(S−1) + s`` on stage ``s``.  The backward recomputes
    the stage forward from its saved *input* (one of ``2S`` slots) under
    ``torch.enable_grad()`` and pulls the cotangent back with
    ``torch.autograd.grad``.  The last stage seeds it with
    ``dloss/dy · (1/M)`` of the microbatch it has just finished, cast to the
    output's dtype; gradients accumulate in the params' dtype.  The forward
    hop (to ``s + 1``) and the backward hop (to ``s − 1``) of a tick are both
    posted before either is waited for.

    Returns ``(loss, param_grads)``: the loss (the mean of ``loss_fn`` over
    microbatches, f32) on every stage, the grads with the stage slice's
    shapes.
    """
    n, s = dist.get_world_size(group), dist.get_rank(group)
    m = x_microbatches.shape[0]
    num_slots = 2 * n  # in flight on stage s: 2(S−1−s)+1 ≤ 2S−1 microbatches
    leaves, spec = pytree.tree_flatten(stage_params)
    params = pytree.tree_unflatten(leaves, spec)
    grads = [torch.zeros_like(leaf) for leaf in leaves]
    slots: List[Optional[torch.Tensor]] = [None] * num_slots
    like = x_microbatches[0]
    loss_acc = torch.zeros((), dtype=torch.float32, device=like.device)
    inv_m = 1.0 / m
    pend_f = pend_b = None
    seed = None
    for t in range(m + 2 * (n - 1)):
        fwd_state, bwd_state = _received(pend_f), _received(pend_b)
        fi = t - s  # forward microbatch this tick
        bi = t - 2 * (n - 1) + s  # backward microbatch this tick
        do_f, do_b = 0 <= fi < m, 0 <= bi < m
        STATS.ticks += 1

        y = None
        if do_f:
            x_in = x_microbatches[fi] if s == 0 else fwd_state
            with torch.no_grad():
                y = stage_fn(params, x_in)
            STATS.live += 1
            slots[fi % num_slots] = x_in
            if s == n - 1:
                # The loss of the microbatch finished this tick, and the
                # backward seed dL/dy for that same microbatch (fi == bi).
                mb_loss, seed = _seed(loss_fn, y, target_microbatches[fi])
                loss_acc = loss_acc + mb_loss * inv_m

        gx = None
        if do_b:
            x_saved = slots[bi % num_slots]
            g_in = (seed.to(like.dtype) * inv_m) if s == n - 1 else bwd_state
            gp, gx = _grad_leaves(stage_fn, spec, leaves, x_saved, g_in, want_x=s > 0)
            for acc, g in zip(grads, gp):
                acc.add_(g)

        pend_f = _hop(y, like, group, 1, send=do_f and s < n - 1,
                      recv=s > 0 and 0 <= t + 1 - s < m, tag=0)
        pend_b = _hop(gx, like, group, -1, send=do_b and s > 0,
                      recv=s < n - 1 and 0 <= t + 1 - 2 * (n - 1) + s < m, tag=1)
    _received(pend_f), _received(pend_b)
    # The loss lives on the last stage; replicate it.
    loss = coll.broadcast(loss_acc, group, n - 1)
    return loss, pytree.tree_unflatten(grads, spec)


# ---------------------------------------------------------------------------
# Interleaved (virtual-stage) schedule
# ---------------------------------------------------------------------------


def _decode_unit(u: int, n: int, v: int, m: int):
    """Fine-tick offset u = τ − d → (chunk, microbatch, valid)."""
    g = u // (n * v)
    rem = u % (n * v)
    c = rem // n
    r = rem % n
    mb = g * n + r
    return c, mb, (u >= 0 and 0 <= mb < m)


def pipeline_train_interleaved_collective(
    stage_params: Any,
    x_microbatches: torch.Tensor,
    target_microbatches: torch.Tensor,
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    *,
    group,
    num_chunks: int,
):
    """Interleaved-schedule training — every rank of ``group`` calls it.

    Each device hosts ``v = num_chunks`` model chunks, virtual stage
    ``c·S + d`` (chunk ``c`` on device ``d``); microbatch ``m = g·S + r``
    runs its chunk-``c`` unit on device ``d`` at fine tick
    ``τ = d + g·S·v + c·S + r``, so every dependency is met with a margin of
    exactly one tick and one forward ring hop a tick carries both the
    stage → stage hop and the chunk wrap (device S−1 → device 0).  The
    forward pass saves every chunk input; the backward pass is its exact
    time reversal on the reverse ring, each unit recomputing its chunk from
    the saved input.  ``2·(M·v + S − 1)`` fine ticks.

    Returns ``(loss, param_grads)`` like :func:`pipeline_train_collective`;
    the device's param slice is ``[v·layers_per_chunk, ...]`` with its
    chunks contiguous in chunk order (see :func:`make_pipeline_train`).
    """
    n, d = dist.get_world_size(group), dist.get_rank(group)
    v = num_chunks
    m = x_microbatches.shape[0]
    span = m * v + n - 1  # fine ticks per direction
    leaves, spec = pytree.tree_flatten(stage_params)
    like = x_microbatches[0]
    inv_m = 1.0 / m

    def chunk(tensors, c):
        return [x[c * (x.shape[0] // v):(c + 1) * (x.shape[0] // v)] for x in tensors]

    # Device ``dev`` reads the ring on forward tick τ unless its unit is a
    # fresh microbatch (virtual stage 0) or there is none; the backward
    # mirror: unless its unit is the last virtual stage, which seeds.
    def reads_fwd(dev, tau):
        c, _, valid = _decode_unit(tau - dev, n, v, m)
        return valid and not (dev == 0 and c == 0)

    def reads_bwd(dev, tau_b):
        c, _, valid = _decode_unit(span - 1 - tau_b - dev, n, v, m)
        return valid and not (dev == n - 1 and c == v - 1)

    # ---- forward: compute + save every chunk input ------------------------
    in_store = {}
    loss_acc = torch.zeros((), dtype=torch.float32, device=like.device)
    pending = None
    with torch.no_grad():
        for tau in range(span):
            state = _received(pending)
            c, mb, valid = _decode_unit(tau - d, n, v, m)
            y = None
            if valid:
                # Fresh microbatches enter only at virtual stage 0 (device 0
                # chunk 0); every other unit consumes the ring.
                x_in = x_microbatches[mb] if (d == 0 and c == 0) else state
                y = stage_fn(pytree.tree_unflatten(chunk(leaves, c), spec), x_in)
                STATS.live += 1
                in_store[(c, mb)] = x_in
                if d == n - 1 and c == v - 1:
                    # The loss banks at the last virtual stage.
                    loss_acc = loss_acc + loss_fn(y, target_microbatches[mb]) * inv_m
            STATS.ticks += 1
            pending = _hop(y, like, group, 1, send=reads_fwd((d + 1) % n, tau + 1),
                           recv=reads_fwd(d, tau + 1), tag=0)
        _received(pending)

    # ---- backward: exact time-reversal of the forward schedule ------------
    grads = [torch.zeros_like(leaf) for leaf in leaves]
    pending = None
    for tau_b in range(span):
        g_state = _received(pending)
        c, mb, valid = _decode_unit(span - 1 - tau_b - d, n, v, m)
        gx = None
        if valid:
            x_saved = in_store.pop((c, mb))
            seed_fn = None
            if d == n - 1 and c == v - 1:
                # Seed at the last virtual stage: dL/dy of this unit's own
                # microbatch, from the recomputed output.
                tgt = target_microbatches[mb]
                seed_fn = lambda y, tgt=tgt: _seed(loss_fn, y, tgt)[1].to(like.dtype) * inv_m  # noqa: E731
                g_state = None
            gp, gx = _grad_leaves(stage_fn, spec, chunk(leaves, c), x_saved, g_state, want_x=True,
                                  seed_fn=seed_fn)
            for acc, g in zip(chunk(grads, c), gp):
                acc.add_(g)
        STATS.ticks += 1
        pending = _hop(gx, like, group, -1, send=reads_bwd((d - 1) % n, tau_b + 1),
                       recv=reads_bwd(d, tau_b + 1), tag=0)
    _received(pending)
    loss = coll.broadcast(loss_acc, group, n - 1)
    return loss, pytree.tree_unflatten(grads, spec)


def make_pipeline_train(
    mesh,
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    *,
    axis_name: str = "pp",
    num_microbatches: int,
    virtual_stages: int = 1,
):
    """Build a pipelined training step: (stacked_params, x, targets) → (loss, grads).

    ``loss_fn(y_mb, target_mb) -> scalar``; the returned loss is its mean
    over microbatches and ``grads`` matches ``stacked_params``, whole on
    every rank.  Gradient-equivalent to autograd through the
    :func:`make_pipeline` forward (tested).

    ``virtual_stages=1`` (default): the 1F1B schedule — O(S) per-stage
    activation memory, ramp bubble 2(S−1) stage times.
    ``virtual_stages=v>1``: the interleaved schedule — each device hosts
    ``v`` model chunks and the bubble shrinks to 2(S−1)/v stage times
    (see :func:`pipeline_train_interleaved_collective`); ``stage_fn``
    then receives chunks of ``total_layers/(S·v)`` layers.
    """
    n_stages = mesh_axis_size(mesh, axis_name)
    v = int(virtual_stages)
    if v < 1:
        raise ValueError(f"virtual_stages must be >= 1, got {v}")
    group = mesh.get_group(axis_name)
    # Virtual-stage blocks reordered so that the contiguous split hands
    # device d its chunks [d, S+d, …] in chunk order, and back.
    order = [c * n_stages + d for d in range(n_stages) for c in range(v)]
    inverse = [order.index(b) for b in range(n_stages * v)]

    def _permute_blocks(leaf, perm):
        blocks = leaf.reshape((n_stages * v, leaf.shape[0] // (n_stages * v)) + tuple(leaf.shape[1:]))
        return blocks[torch.tensor(perm, device=leaf.device)].reshape(leaf.shape)

    def train(stacked_params, x, targets):
        leaves, spec = pytree.tree_flatten(stacked_params)
        for leaf in leaves:
            if leaf.shape[0] % (n_stages * v):
                raise ValueError(
                    f"stacked param leading dim {leaf.shape[0]} not divisible "
                    f"by {n_stages} stages x {v} virtual stages"
                )
        b = x.shape[0]
        if b % num_microbatches:
            raise ValueError(
                f"batch {b} not divisible by {num_microbatches} microbatches"
            )
        if v > 1 and num_microbatches % n_stages:
            # The interleaved slot formula m = g*S + r schedules
            # microbatches in groups of S; a trailing partial group's
            # units would land past the span and silently drop their
            # loss/grad contributions (same constraint as Megatron-LM's
            # interleaved schedule).
            raise ValueError(
                f"interleaved schedule needs num_microbatches "
                f"({num_microbatches}) divisible by the {n_stages} "
                f"pipeline stages (virtual_stages={v})"
            )
        mb = b // num_microbatches
        mbs = x.reshape(num_microbatches, mb, *x.shape[1:])
        tgts = targets.reshape(num_microbatches, mb, *targets.shape[1:])
        leaves = [leaf.detach() for leaf in leaves]
        if v > 1:
            leaves = [_permute_blocks(leaf, order) for leaf in leaves]
        local = pytree.tree_unflatten([coll.local_shard(leaf, group, 0) for leaf in leaves], spec)
        if v == 1:
            loss, grads = pipeline_train_collective(local, mbs, tgts, stage_fn, loss_fn, group=group)
        else:
            loss, grads = pipeline_train_interleaved_collective(
                local, mbs, tgts, stage_fn, loss_fn, group=group, num_chunks=v)
        full = [coll.all_gather(g, group, 0) for g in pytree.tree_leaves(grads)]
        if v > 1:
            full = [_permute_blocks(g, inverse) for g in full]
        return loss, pytree.tree_unflatten(full, spec)

    return train
