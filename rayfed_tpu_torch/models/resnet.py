"""ResNet (v1.5) — the cross-silo CV workload.

The port of ``rayfed_tpu/models/resnet.py``: NHWC activations, HWIO
kernels, batch-norm running statistics carried in an explicit ``state``
tree (FedAvg averages params and states alike), and a CIFAR-style stem
option (3×3 conv, no max-pool) for 32×32 inputs.  The trees keep the
reference's names and layouts, so a tree converted from the reference
(:func:`~rayfed_tpu_torch.models.convert.params_from_jax`) computes the
same function here.  Convolutions run as ``conv2d`` on NCHW views with the
reference's ``"SAME"`` padding (the extra pixel, when there is one, at the
end).  :class:`ResNet` holds the trees as an ``nn.Module``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.models.logistic import softmax_cross_entropy, value_and_grad
from rayfed_tpu_torch.utils.platform import resolve_device

Params = Dict[str, Any]
State = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Sequence[int] = (2, 2, 2, 2)  # ResNet-18
    num_classes: int = 10
    width: int = 64
    small_inputs: bool = True  # CIFAR stem: 3x3/1 conv, no maxpool
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5
    dtype: Any = torch.float32


def resnet18(num_classes: int = 10, **kw) -> ResNetConfig:
    return ResNetConfig(stage_sizes=(2, 2, 2, 2), num_classes=num_classes, **kw)


def resnet34(num_classes: int = 10, **kw) -> ResNetConfig:
    return ResNetConfig(stage_sizes=(3, 4, 6, 3), num_classes=num_classes, **kw)


def _block_names(config: ResNetConfig):
    """``(name, stride, c_in, c_out)`` of every residual block, in order."""
    c_in = config.width
    for stage, num_blocks in enumerate(config.stage_sizes):
        c_out = config.width * (2**stage)
        for block in range(num_blocks):
            stride = 2 if (block == 0 and stage > 0) else 1
            yield f"stage{stage}_block{block}", stride, c_in, c_out
            c_in = c_out


def init_resnet(
    generator: torch.Generator,
    config: ResNetConfig,
    input_channels: int = 3,
    device: Optional[torch.device] = None,
) -> Tuple[Params, State]:
    """He-normal kernels drawn from ``generator`` (other numbers than
    ``jax.random`` for any seed), unit BN scales, zero biases and head."""
    device = resolve_device(device)

    def conv(kh, kw, c_in, c_out):
        fan_in = kh * kw * c_in
        w = torch.randn((kh, kw, c_in, c_out), generator=generator) * (2.0 / fan_in) ** 0.5
        return w.to(device)

    def bn_params(c):
        return {"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device)}

    def bn_state(c):
        return {"mean": torch.zeros(c, device=device), "var": torch.ones(c, device=device)}

    stem_k = 3 if config.small_inputs else 7
    params: Params = {
        "stem": {"conv": conv(stem_k, stem_k, input_channels, config.width),
                 "bn": bn_params(config.width)},
    }
    state: State = {"stem": bn_state(config.width)}
    c_last = config.width
    for name, stride, c_in, c_out in _block_names(config):
        bp: Params = {
            "conv1": conv(3, 3, c_in, c_out), "bn1": bn_params(c_out),
            "conv2": conv(3, 3, c_out, c_out), "bn2": bn_params(c_out),
        }
        bs: State = {"bn1": bn_state(c_out), "bn2": bn_state(c_out)}
        if stride != 1 or c_in != c_out:
            bp["proj"] = conv(1, 1, c_in, c_out)
            bp["proj_bn"] = bn_params(c_out)
            bs["proj_bn"] = bn_state(c_out)
        params[name] = bp
        state[name] = bs
        c_last = c_out
    params["head"] = {
        "kernel": torch.zeros((c_last, config.num_classes), device=device),
        "bias": torch.zeros((config.num_classes,), device=device),
    }
    return params, state


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: ``(low, high)``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC ``x`` ⊛ HWIO ``kernel`` with ``"SAME"`` padding."""
    kh, kw = kernel.shape[0], kernel.shape[1]
    ph = _same_pads(x.shape[1], kh, stride)
    pw = _same_pads(x.shape[2], kw, stride)
    xc = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    w = kernel.to(x.dtype).permute(3, 2, 0, 1)
    return F.conv2d(xc, w, stride=stride).permute(0, 2, 3, 1)


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3×3/2 max pool of NHWC ``x`` with ``"SAME"`` padding (-inf)."""
    ph = _same_pads(x.shape[1], 3, 2)
    pw = _same_pads(x.shape[2], 3, 2)
    xc = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(xc, 3, 2).permute(0, 2, 3, 1)


def _batch_norm(x, p, s, *, train: bool, momentum: float, eps: float):
    if train:
        mean = torch.mean(x, dim=(0, 1, 2))
        var = torch.var(x, dim=(0, 1, 2), unbiased=False)
        new_s = {
            "mean": momentum * s["mean"] + (1 - momentum) * mean,
            "var": momentum * s["var"] + (1 - momentum) * var,
        }
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    inv = torch.rsqrt(var + eps) * p["scale"]
    out = (x - mean.to(x.dtype)) * inv.to(x.dtype) + p["bias"].to(x.dtype)
    return out, new_s


def apply_resnet(
    params: Params,
    state: State,
    x: torch.Tensor,
    config: ResNetConfig,
    *,
    train: bool = False,
) -> Tuple[torch.Tensor, State]:
    """Forward pass: NHWC images → logits.  Returns updated BN state."""
    bn = dict(train=train, momentum=config.bn_momentum, eps=config.bn_eps)
    new_state: State = {}
    x = x.to(config.dtype)
    x = _conv(x, params["stem"]["conv"], stride=1 if config.small_inputs else 2)
    x, new_state["stem"] = _batch_norm(x, params["stem"]["bn"], state["stem"], **bn)
    x = torch.relu(x)
    if not config.small_inputs:
        x = _max_pool_same(x)

    for name, stride, _c_in, _c_out in _block_names(config):
        bp, bs = params[name], state[name]
        nbs: State = {}
        residual = x
        y = _conv(x, bp["conv1"], stride=stride)
        y, nbs["bn1"] = _batch_norm(y, bp["bn1"], bs["bn1"], **bn)
        y = torch.relu(y)
        y = _conv(y, bp["conv2"])
        y, nbs["bn2"] = _batch_norm(y, bp["bn2"], bs["bn2"], **bn)
        if "proj" in bp:
            residual = _conv(x, bp["proj"], stride=stride)
            residual, nbs["proj_bn"] = _batch_norm(residual, bp["proj_bn"], bs["proj_bn"], **bn)
        x = torch.relu(y + residual)
        new_state[name] = nbs

    x = torch.mean(x, dim=(1, 2))  # global average pool
    logits = x @ params["head"]["kernel"].to(x.dtype) + params["head"]["bias"]
    return logits.to(torch.float32), new_state


# (regex, spec) rules for parallel.sharding.shard_params_by_rules: the
# reference's PartitionSpecs as plain tuples (HWIO kernels over fsdp on O).
PARTITION_RULES = (
    (r"conv|proj$", (None, None, None, "fsdp")),
    (r"head/kernel", (None, ("fsdp", "tp"))),
)


def _make_sgd_step(config: ResNetConfig, lr: float, momentum: float):
    """Shared step body of both train-step factories."""

    def loss_fn(params, state, x, y):
        logits, new_state = apply_resnet(params, state, x, config, train=True)
        return softmax_cross_entropy(logits, y), new_state

    def step(params, state, opt, x, y):
        (loss, new_state), grads = value_and_grad(loss_fn, params, state, x, y, has_aux=True)
        new_opt = tree_util.tree_map(lambda m, g: momentum * m + g, opt, grads)
        new_params = tree_util.tree_map(lambda p, m: p - lr * m, params, new_opt)
        return new_params, new_state, new_opt, loss

    return step


def make_train_step(config: ResNetConfig, lr: float = 0.1, momentum: float = 0.9):
    """SGD-with-momentum train step: ``(params, state, opt, x, y) → (params,
    state, opt, loss)``; the inputs are left intact."""
    return _make_sgd_step(config, lr, momentum)


def init_opt_state(params: Params) -> Params:
    return tree_util.tree_map(torch.zeros_like, params)


def make_fed_train_step(
    config: ResNetConfig,
    lr: float = 0.1,
    momentum: float = 0.9,
    *,
    wire_dtype: Any = torch.bfloat16,
    local_steps: int = 1,
):
    """One FedAvg round's local work: ``(wire_bundle, x, y) -> (wire_bundle,
    loss)`` where ``wire_bundle`` is the ``(params, state)`` tree in
    ``wire_dtype`` as it crosses parties — the per-leaf form or the packed
    :class:`~rayfed_tpu_torch.fl.PackedTree`; the step returns the form it
    was given (decompress, fresh momentum, ``local_steps`` SGD steps,
    recompress)."""
    from rayfed_tpu_torch.fl.compression import (
        PackedTree,
        cast_floats,
        pack_tree,
        unpack_tree,
    )

    step = _make_sgd_step(config, lr, momentum)

    def fed_step(wire_bundle, x, y):
        packed = isinstance(wire_bundle, PackedTree)
        params, state = (
            unpack_tree(wire_bundle, torch.float32)
            if packed
            else cast_floats(wire_bundle, torch.float32)
        )
        opt = init_opt_state(params)
        loss = torch.zeros((), dtype=torch.float32)
        for _ in range(local_steps):
            params, state, opt, loss = step(params, state, opt, x, y)
        out = (
            pack_tree((params, state), wire_dtype)
            if packed
            else cast_floats((params, state), wire_dtype)
        )
        return out, loss

    return fed_step


class ResNet(nn.Module):
    """The param and BN-state trees as a module: each param leaf is a
    parameter and each state leaf a buffer, named by its tree path with
    ``__`` between keys (``stem__conv``, ``bn__stage0_block0__bn1__mean``).
    ``forward(x, train=True)`` updates the buffers as the reference's
    returned state would be."""

    def __init__(self, config: ResNetConfig, params: Params, state: State):
        super().__init__()
        self.config = config
        self._param_def = tree_util.tree_flatten(params)[1]
        self._state_def = tree_util.tree_flatten(state)[1]
        self._param_names = _paths(params)
        self._state_names = _paths(state)
        self.weights = nn.ParameterDict({
            k.replace(".", "__"): nn.Parameter(v)
            for k, v in zip(self._param_names, tree_util.tree_leaves(params))
        })
        for k, v in zip(self._state_names, tree_util.tree_leaves(state)):
            self.register_buffer("bn__" + k.replace(".", "__"), v)

    def params(self) -> Params:
        leaves = [self.weights[k.replace(".", "__")] for k in self._param_names]
        return tree_util.tree_unflatten(leaves, self._param_def)

    def state(self) -> State:
        leaves = [getattr(self, "bn__" + k.replace(".", "__")) for k in self._state_names]
        return tree_util.tree_unflatten(leaves, self._state_def)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        logits, new_state = apply_resnet(self.params(), self.state(), x, self.config, train=train)
        if train:
            with torch.no_grad():
                for k, v in zip(self._state_names, tree_util.tree_leaves(new_state)):
                    getattr(self, "bn__" + k.replace(".", "__")).copy_(v)
        return logits


def _paths(tree: Any, prefix: str = "") -> list:
    """'.'-joined key paths of a nested dict's leaves, in flatten order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_paths(tree[k], f"{prefix}{k}."))
        return out
    return [prefix[:-1]]
