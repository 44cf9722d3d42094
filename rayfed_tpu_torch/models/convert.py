"""Carry model trees across from the reference: Llama, BERT and MoE weights,
LoRA adapters, Adam state, the FL baselines' trees (logistic, MLP, ResNet params
and BN state) and the packed server optimizer's state, which also goes back.

The reference's trees are nested dicts (and tuples, for the Adam state
``(count, m, v)``) of arrays; converted to numpy (``np.asarray`` per leaf)
they arrive here and leave as the same tree of torch tensors, key for key,
since the port keeps the reference's names and ``x @ w`` orientation.
Every leaf is carried bit for bit (bf16 through its 16-bit patterns), 0-d
leaves (a LoRA ``scale``, the Adam count) included.  The reference's int8
weights (its ``QTensor``, a node of JAX's pytree registry and so a leaf
here) are recognised by their ``q`` and ``scale`` attributes, without an
import of the reference, and arrive as this package's
:class:`~rayfed_tpu_torch.models.quant.QTensor`; a ``dtype`` cast leaves
them as they are.  Each helper runs on
the card unless ``device`` says otherwise.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from rayfed_tpu_torch.models.quant import QTensor
from rayfed_tpu_torch.utils.platform import resolve_device


def _leaf(x: Any, device: torch.device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy rejects: carry the
        # 16-bit patterns across unchanged (a float round trip could not
        # be bit-exact).  np.array copies, so the tensor owns its memory.
        t = torch.from_numpy(np.array(a.view(np.uint16), order="C")).view(torch.bfloat16)
    elif a.dtype.kind in "fiub":
        t = torch.from_numpy(np.array(a, order="C"))
    else:
        raise TypeError(f"cannot convert a leaf of dtype {a.dtype}")
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def _is_qtensor(x: Any) -> bool:
    return hasattr(x, "q") and hasattr(x, "scale")


def _tree_from_jax(tree: Any, device: Optional[torch.device], dtype: Optional[torch.dtype]) -> Any:
    device = resolve_device(device)

    def convert(x):
        if _is_qtensor(x):
            return QTensor(_leaf(x.q, device, None), _leaf(x.scale, device, None))
        return _leaf(x, device, dtype)

    return pytree.tree_map(convert, tree, is_leaf=_is_qtensor)


def llama_params_from_jax(
    tree: Any,
    device: Optional[torch.device] = None,
    dtype: Optional[torch.dtype] = None,
) -> Any:
    """The reference's Llama param tree (numpy leaves) as torch tensors.

    ``dtype`` casts every float leaf (default: keep each leaf's dtype, bf16
    bit-exact); an int8 base's ``QTensor`` leaves keep their int8 codes and
    f32 scales.
    """
    return _tree_from_jax(tree, device, dtype)


def lora_from_jax(tree: Any, device: Optional[torch.device] = None) -> Any:
    """The reference's LoRA tree (``{"a", "b", "scale"}`` entries) as torch
    tensors, each leaf in its own dtype."""
    return _tree_from_jax(tree, device, None)


def adam_from_jax(opt: Any, device: Optional[torch.device] = None) -> Any:
    """The reference's Adam state ``(count, m, v)`` as torch tensors: the
    int32 count, ``m`` in the params' dtype and ``v`` in f32, as they were."""
    return _tree_from_jax(opt, device, None)


def params_from_jax(tree: Any, device: Optional[torch.device] = None) -> Any:
    """Any of the reference's param or state trees (the logistic and MLP
    params, ResNet's params and BN state) as torch tensors, each leaf in its
    own dtype and layout (the port keeps NHWC activations and HWIO kernels)."""
    return _tree_from_jax(tree, device, None)


def bert_params_from_jax(
    tree: Any,
    device: Optional[torch.device] = None,
    dtype: Optional[torch.dtype] = None,
) -> Any:
    """The reference's BERT param tree (numpy leaves; whole, or one side of
    ``split_params``) as torch tensors under the same keys; ``dtype`` casts
    every leaf (default: keep each leaf's dtype)."""
    return _tree_from_jax(tree, device, dtype)


def moe_params_from_jax(tree: Any, device: Optional[torch.device] = None) -> Any:
    """The reference's MoE layer params (``gate``, the stacked ``w_in`` and
    ``w_out``) as torch tensors, each leaf in its own dtype."""
    return _tree_from_jax(tree, device, None)


def server_state_from_jax(state: Any, device: Optional[torch.device] = None) -> Any:
    """The reference's packed server-optimizer state (its
    ``PackedServerState``: a kind, the hyperparameters and f32 buffers) as
    this package's :class:`~rayfed_tpu_torch.fl.server_opt.PackedServerState`
    with its buffers on ``device``, bit for bit.  Read by attribute, so the
    reference's class need not be imported."""
    from rayfed_tpu_torch.fl.server_opt import PackedServerState

    device = resolve_device(device)
    bufs = tuple(_leaf(b, device, None).reshape(-1) for b in state.bufs)
    return PackedServerState(state.kind, state.hyper, bufs)


def server_state_to_jax(state: Any) -> Any:
    """This package's packed server-optimizer state with host numpy
    buffers, the reference's form of it: on the wire it pickles under the
    reference's module path and a JAX party reads it as its own class."""
    from rayfed_tpu_torch.fl.server_opt import PackedServerState
    from rayfed_tpu_torch.transport.wire import tensor_to_numpy

    bufs = tuple(tensor_to_numpy(b) if isinstance(b, torch.Tensor) else np.asarray(b) for b in state.bufs)
    return PackedServerState(state.kind, state.hyper, bufs)
