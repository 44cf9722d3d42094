"""Logistic regression + small MLP — the horizontal-FL baseline models.

The port of ``rayfed_tpu/models/logistic.py``.  Params are dict trees with
the reference's names and ``x @ w`` orientation (``{"w", "b"}``;
``{"layer0": {"kernel", "bias"}, ...}``), so a tree converted from the
reference (:func:`~rayfed_tpu_torch.models.convert.params_from_jax`)
computes the same function here.  :class:`Logistic` and :class:`MLP` hold
such a tree as an ``nn.Module``; the functional ``apply_*`` and
:func:`make_train_step` are what a FedAvg trainer exchanges trees with.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.utils.platform import resolve_device

Params = Dict[str, Any]


def init_logistic(
    num_features: int, num_classes: int, device: Optional[torch.device] = None
) -> Params:
    device = resolve_device(device)
    return {
        "w": torch.zeros((num_features, num_classes), dtype=torch.float32, device=device),
        "b": torch.zeros((num_classes,), dtype=torch.float32, device=device),
    }


def apply_logistic(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def init_mlp(
    generator: torch.Generator,
    num_features: int,
    hidden: Tuple[int, ...],
    num_classes: int,
    device: Optional[torch.device] = None,
) -> Params:
    """He-normal kernels drawn from ``generator`` (other numbers than
    ``jax.random`` for any seed), zero biases."""
    device = resolve_device(device)
    dims = (num_features,) + tuple(hidden) + (num_classes,)
    params: Params = {}
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        kernel = torch.randn((d_in, d_out), generator=generator) * (2.0 / d_in) ** 0.5
        params[f"layer{i}"] = {
            "kernel": kernel.to(device),
            "bias": torch.zeros((d_out,), device=device),
        }
    return params


def apply_mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    n = len(params)
    for i in range(n):
        layer = params[f"layer{i}"]
        x = x @ layer["kernel"] + layer["bias"]
        if i < n - 1:
            x = torch.relu(x)
    return x


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy; ``labels`` are int class ids."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.take_along_dim(logp, labels.long()[:, None], dim=1))


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, dim=-1) == labels).to(torch.float32))


def value_and_grad(loss_fn: Callable, tree: Any, *args, has_aux: bool = False):
    """``(loss, grads)`` (``((loss, aux), grads)`` with ``has_aux``) of
    ``loss_fn(tree, *args)`` w.r.t. every tensor leaf of ``tree``; the
    inputs are left intact."""
    leaves, treedef = tree_util.tree_flatten(tree)
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in leaves]
        out = loss_fn(tree_util.tree_unflatten(leaves, treedef), *args)
        loss = out[0] if has_aux else out
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    grads = tree_util.tree_unflatten(grads, treedef)
    if has_aux:
        aux = tree_util.tree_map(
            lambda a: a.detach() if isinstance(a, torch.Tensor) else a, out[1]
        )
        return (loss.detach(), aux), grads
    return loss.detach(), grads


def make_train_step(apply_fn: Callable, lr: float = 0.1):
    """SGD train step: ``(params, x, y) -> (params, loss)``; the inputs are
    left intact and new tensors returned."""

    def loss_fn(params, x, y):
        return softmax_cross_entropy(apply_fn(params, x), y)

    def step(params, x, y):
        loss, grads = value_and_grad(loss_fn, params, x, y)
        params = tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
        return params, loss

    return step


class Logistic(nn.Module):
    """Logistic regression as a module: parameters ``w`` and ``b``."""

    def __init__(self, num_features: int, num_classes: int,
                 device: Optional[torch.device] = None):
        super().__init__()
        params = init_logistic(num_features, num_classes, device)
        self.w = nn.Parameter(params["w"])
        self.b = nn.Parameter(params["b"])

    def params(self) -> Params:
        return {"w": self.w, "b": self.b}

    def load_params(self, params: Params) -> None:
        with torch.no_grad():
            self.w.copy_(params["w"])
            self.b.copy_(params["b"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_logistic(self.params(), x)


class MLP(nn.Module):
    """The MLP as a module: one ``{"kernel", "bias"}`` pair per layer."""

    def __init__(self, params: Params):
        super().__init__()
        self.layers = nn.ModuleList()
        for i in range(len(params)):
            layer = nn.Module()
            layer.kernel = nn.Parameter(params[f"layer{i}"]["kernel"])
            layer.bias = nn.Parameter(params[f"layer{i}"]["bias"])
            self.layers.append(layer)

    def params(self) -> Params:
        return {
            f"layer{i}": {"kernel": m.kernel, "bias": m.bias}
            for i, m in enumerate(self.layers)
        }

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_mlp(self.params(), x)
