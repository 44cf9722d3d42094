"""Split / vertical federated learning: activations forward, gradients back.

The port of ``rayfed_tpu/fl/split.py``: BASELINE.md config #5, encoder at
alice, head at bob.  Per step:

1. the encoder party runs its half and *pushes* the activations to the head
   party;
2. the head party computes the loss and the gradients w.r.t. its params and
   the activations, updates its head and pushes the activation gradient back;
3. the encoder party closes the backward and updates.

Both halves keep their params on their own card between steps (actor
state); only the [B, D] activations and their gradients cross the silo
boundary.  The encoder's backward recomputes its forward under autograd from
the saved input (the reference's ``jax.vjp`` inside ``jit``), so no graph
outlives a call.

Two stepping modes, as in the reference:

- :meth:`SplitTrainer.step`: one batch, strictly serialized (forward → push
  → head → push → backward).
- :meth:`SplitTrainer.step_pipelined`: GPipe-style microbatches across the
  silo boundary; all K encoder forwards are issued first, both halves
  accumulate their gradients and apply one mean update at the end, the same
  step as one batch of the concatenated microbatches.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import torch

from rayfed_tpu_torch import tree_util


def _grads_of(fn: Callable, tree: Any, *extra: torch.Tensor):
    """Run ``fn(tree, *extra)`` under autograd from detached copies of the
    tree's leaves and the extra tensors; returns ``(out, grad_fn)``, where
    ``grad_fn(out_grad)`` gives ``(tree_grads, extra_grads)`` (zeros for a
    leaf the output does not reach)."""
    leaves, treedef = tree_util.tree_flatten(tree)
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in leaves]
        extra = [x.detach().requires_grad_(True) for x in extra]
        out = fn(tree_util.tree_unflatten(leaves, treedef), *extra)

    def grad_fn(out_grad=None):
        inputs = leaves + extra
        grads = torch.autograd.grad(out, inputs, out_grad, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]
        return tree_util.tree_unflatten(grads[: len(leaves)], treedef), grads[len(leaves):]

    return out, grad_fn


class _GradAccum:
    """Shared accumulate-then-apply state for both split halves.

    Holds the running gradient sum (the first gradients, owned, then summed
    into in place); the update applies ``p − lr·acc/count`` once (GPipe
    semantics: the same step as one on the concatenated batch).
    """

    def __init__(self, lr: float):
        self._lr = lr
        self._acc = None
        self._count = 0

    @torch.no_grad()
    def add(self, grads) -> None:
        if self._acc is None:
            self._acc = grads  # fresh tensors of the backward: ours to sum into
        else:
            tree_util.tree_map(lambda a, g: a.add_(g), self._acc, grads)
        self._count += 1

    @torch.no_grad()
    def apply(self, params):
        """Returns new params, or ``None`` when nothing accumulated."""
        if self._acc is None:
            return None

        scalars = {}  # per device: f32 0-d lr and count, the reference's operands

        def update(p, a):
            if a.device not in scalars:
                scalars[a.device] = torch.tensor([self._lr, float(self._count)],
                                                 dtype=torch.float32, device=a.device)
            lr, count = scalars[a.device]
            return p - lr * a / count

        params = tree_util.tree_map(update, params, self._acc)
        self._acc = None
        self._count = 0
        return params


class _SplitHalf:
    """Shared actor plumbing: params + accumulator + apply/get."""

    _params: Any
    _accum: _GradAccum

    def apply_update(self):
        updated = self._accum.apply(self._params)
        if updated is None:
            return False
        self._params = updated
        return True

    def get_params(self):
        return self._params


class _EncoderActor(_SplitHalf):
    """Party-local encoder half: a forward without a graph, and a backward
    that recomputes the forward under autograd from the saved input.

    Many microbatches may be in flight: each ``forward`` saves its input
    under a microbatch id; ``backward`` produces that microbatch's param
    gradients and accumulates them; ``apply_update`` applies the mean once.
    """

    def __init__(self, params: Any, apply_fn: Callable, lr: float, wire_dtype=None):
        self._params = params
        self._apply_fn = apply_fn
        self._wire_dtype = wire_dtype
        self._saved: Dict[int, Any] = {}
        self._accum = _GradAccum(lr)

    def forward(self, x, microbatch: int = 0):
        self._saved[microbatch] = x
        with torch.no_grad():
            h = self._apply_fn(self._params, x)
        return h.to(self._wire_dtype) if self._wire_dtype is not None else h

    def backward(self, g, microbatch: int = 0):
        x = self._saved.pop(microbatch, None)
        if x is None:
            raise RuntimeError(f"backward for microbatch {microbatch} before its forward")
        out, grad_fn = _grads_of(lambda p: self._apply_fn(p, x), self._params)
        grads, _ = grad_fn(g.to(out.dtype))
        self._accum.add(grads)
        return True


class _HeadActor(_SplitHalf):
    """Party-local head half: loss and gradients for the head and the
    activations."""

    def __init__(self, params: Any, apply_fn: Callable, loss_fn: Callable, lr: float,
                 wire_dtype=None):
        self._params = params
        self._apply_fn = apply_fn
        self._loss_fn = loss_fn
        self._wire_dtype = wire_dtype
        self._accum = _GradAccum(lr)

    def _grads(self, h, y):
        # Wire-compressed activations compute in f32; the activation
        # gradient goes back to the wire in the compressed dtype.
        hc = h.to(torch.float32) if self._wire_dtype is not None else h
        loss, grad_fn = _grads_of(lambda p, h_: self._loss_fn(self._apply_fn(p, h_), y),
                                  self._params, hc)
        g_params, (g_h,) = grad_fn()
        if self._wire_dtype is not None:
            g_h = g_h.to(self._wire_dtype)
        return g_params, g_h, loss.detach()

    def step(self, h, y):
        """Gradients and an immediate update (the serialized one-batch path)."""
        g_h, loss = self.step_accum(h, y)
        self.apply_update()
        return g_h, loss

    def step_accum(self, h, y):
        """Like :meth:`step` but accumulates the head gradient instead of
        applying it (microbatch pipelining)."""
        g_params, g_h, loss = self._grads(h, y)
        self._accum.add(g_params)
        return g_h, loss


class SplitTrainer:
    """Wire a split model across two parties over the fed API.

    Call from the shared (multi-controller) program after ``fed.init``.
    ``encoder_apply(params, x) -> activations``;
    ``head_apply(params, h) -> logits``; ``loss_fn(logits, y) -> scalar``.

    ``wire_dtype`` (e.g. ``torch.bfloat16``): cast the activations and their
    gradients to this dtype for the cross-silo hop (half the wire bytes of
    f32); the head upcasts to f32 for its compute.  ``None`` exchanges the
    encoder's own dtype.
    """

    def __init__(
        self,
        *,
        encoder_party: str,
        head_party: str,
        encoder_params: Any,
        encoder_apply: Callable,
        head_params: Any,
        head_apply: Callable,
        loss_fn: Callable,
        lr: float = 0.1,
        wire_dtype=None,
    ):
        import rayfed_tpu_torch as fed

        self._fed = fed
        self._encoder = (
            fed.remote(_EncoderActor)
            .party(encoder_party)
            .remote(encoder_params, encoder_apply, lr, wire_dtype)
        )
        self._head = (
            fed.remote(_HeadActor)
            .party(head_party)
            .remote(head_params, head_apply, loss_fn, lr, wire_dtype)
        )

    def step(self, x_obj, y_obj):
        """One split step; ``x_obj`` owned by the encoder party, ``y_obj`` by
        the head party.  Returns the loss as a FedObject owned by the head
        party (``fed.get`` it on any party)."""
        h = self._encoder.forward.remote(x_obj)
        g_h, loss = self._head.step.options(num_returns=2).remote(h, y_obj)
        self._encoder.backward.remote(g_h)
        self._encoder.apply_update.remote()
        return loss

    def step_pipelined(self, x_objs: Sequence[Any], y_objs: Sequence[Any]) -> List[Any]:
        """One accumulated split step over K microbatches with transfer and
        compute overlapped: all K forwards are issued before any backward,
        both parties accumulate and apply one mean update at the end.
        Returns the per-microbatch losses (FedObjects owned by the head
        party)."""
        if len(x_objs) != len(y_objs):
            raise ValueError("need one y per x microbatch")
        hs = [self._encoder.forward.remote(x, mb) for mb, x in enumerate(x_objs)]
        losses, g_hs = [], []
        for h, y in zip(hs, y_objs):
            g_h, loss = self._head.step_accum.options(num_returns=2).remote(h, y)
            g_hs.append(g_h)
            losses.append(loss)
        for mb, g_h in enumerate(g_hs):
            self._encoder.backward.remote(g_h, mb)
        self._encoder.apply_update.remote()
        self._head.apply_update.remote()
        return losses

    def encoder_params(self):
        return self._encoder.get_params.remote()

    def head_params(self):
        return self._head.get_params.remote()
