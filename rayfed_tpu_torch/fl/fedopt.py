"""Server-side federated optimization (FedOpt) and FedProx.

- **FedOpt** (Reddi et al., "Adaptive Federated Optimization", 2021):
  treat the round's aggregate as a *pseudo-gradient*
  ``Δ = global − average(client updates)`` and apply a server optimizer
  (SGD+momentum / Adam / Yogi) instead of plain replacement.  Plain FedAvg
  is the special case lr=1, no momentum.
- **FedProx** (Li et al., 2020): a client-side proximal term
  ``(μ/2)·‖w − w_global‖²``, as a loss wrapper so any local step works.

Per-leaf tensor arithmetic on the driver's decompressed tree, in f32: every
controller computes the identical update on the identical aggregate.  These
are the legacy (unpacked-tree) optimizers of the JAX package's
``fl.fedopt``; the packed ones are :mod:`rayfed_tpu_torch.fl.server_opt`.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from rayfed_tpu_torch import tree_util


class ServerOptimizer(NamedTuple):
    """A server optimizer as an (init, apply) pair.

    ``init(params) -> state``; ``apply(params, round_average, state) ->
    (new_params, new_state)`` where ``round_average`` is the plain FedAvg
    aggregate of the round's client updates.  Both are pure and
    deterministic: every controller computes the identical result.
    """

    init: Callable[[Any], Any]
    apply: Callable[[Any, Any, Any], tuple]


def _tree_zeros(params: Any) -> Any:
    return tree_util.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params
    )


def _delta(params: Any, avg: Any) -> Any:
    return tree_util.tree_map(
        lambda p, a: p.to(torch.float32) - a.to(torch.float32), params, avg
    )


def server_sgd(lr: float = 1.0, momentum: float = 0.0) -> ServerOptimizer:
    """FedAvgM: pseudo-gradient SGD with (optional) server momentum.

    ``lr=1, momentum=0`` reproduces plain FedAvg exactly.
    """

    def init(params):
        return _tree_zeros(params) if momentum else ()

    def apply(params, avg, state):
        delta = _delta(params, avg)
        if momentum:
            state = tree_util.tree_map(lambda m, d: momentum * m + d, state, delta)
            step = state
        else:
            step = delta
        new = tree_util.tree_map(
            lambda p, s: (p.to(torch.float32) - lr * s).to(p.dtype), params, step
        )
        return new, state

    return ServerOptimizer(init, apply)


def _adaptive(lr: float, b1: float, b2: float, eps: float, yogi: bool) -> ServerOptimizer:
    def init(params):
        return {"m": _tree_zeros(params), "v": _tree_zeros(params)}

    def apply(params, avg, state):
        delta = _delta(params, avg)
        m = tree_util.tree_map(lambda m, d: b1 * m + (1 - b1) * d, state["m"], delta)
        if yogi:
            # Yogi: additive, sign-controlled second-moment update (Reddi
            # et al. §3).
            v = tree_util.tree_map(
                lambda v, d: v - (1 - b2) * torch.sign(v - d * d) * d * d,
                state["v"], delta,
            )
        else:
            v = tree_util.tree_map(lambda v, d: b2 * v + (1 - b2) * d * d, state["v"], delta)
        new = tree_util.tree_map(
            lambda p, m, v: (p.to(torch.float32) - lr * m / (torch.sqrt(v) + eps)).to(p.dtype),
            params, m, v,
        )
        return new, {"m": m, "v": v}

    return ServerOptimizer(init, apply)


def server_adam(
    lr: float = 0.01, b1: float = 0.9, b2: float = 0.99, eps: float = 1e-3
) -> ServerOptimizer:
    """FedAdam (Reddi et al. alg. 2; their recommended eps is large)."""
    return _adaptive(lr, b1, b2, eps, yogi=False)


def server_yogi(
    lr: float = 0.01, b1: float = 0.9, b2: float = 0.99, eps: float = 1e-3
) -> ServerOptimizer:
    """FedYogi (Reddi et al. alg. 2 with Yogi's second moment)."""
    return _adaptive(lr, b1, b2, eps, yogi=True)


def fedprox_loss(loss_fn: Callable[..., torch.Tensor], mu: float) -> Callable[..., torch.Tensor]:
    """Wrap a local loss with FedProx's proximal term.

    ``loss_fn(params, *batch) -> scalar`` becomes
    ``wrapped(params, global_params, *batch) -> scalar`` adding
    ``(μ/2)·‖params − global_params‖²``.  ``mu=0`` is plain FedAvg.
    """

    def wrapped(params, global_params, *batch):
        base = loss_fn(params, *batch)
        # tree_map, not a zip of flat leaves: a structure mismatch must
        # raise, not pair leaves against the wrong counterparts.
        sq_tree = tree_util.tree_map(
            lambda p, g: torch.sum((p.to(torch.float32) - g.to(torch.float32)) ** 2),
            params, global_params,
        )
        sq = sum(tree_util.tree_leaves(sq_tree))
        return base + 0.5 * mu * sq

    return wrapped
