"""Weight-only int8 quantization for frozen base models (the port of
``rayfed_tpu/models/quant.py``).

A LoRA fine-tune never updates the base weights, so they can live on the
card as int8 with a per-output-channel scale: Llama-3-8B's base takes 8.55
GB instead of 16.06 GB in bf16.  A product with an int8 weight
(:func:`matmul`) keeps the scale on the OUTPUT, ``(x @ q.to(dtype)) *
scale``: the weight-side op is a pure convert.  Under XLA that convert fuses
into the dot's operand feed; here ``q.to(dtype)`` is a copy of the weight in
the activation dtype, made for the product and dropped after it.  Under
autograd the product saves the int8 ``q`` and the scale, not that copy, and
converts again in its backward (:class:`_Int8Matmul`), so no dequantized
copy of a weight outlives its layer.

:class:`QTensor` is a node of :mod:`rayfed_tpu_torch.tree_util` (children
``(q, scale)``) and a leaf of ``torch.utils._pytree``, which the model and
LoRA code walk: an adapter mirrors the logical weight, not its children.
It slices along its leading (layer) axis and moves between devices like a
tensor.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils import _pytree as pytree

from rayfed_tpu_torch import tree_util


class QTensor:
    """An int8 weight plus its per-output-channel dequantization scale.

    ``q``: int8, the stored weight.  ``scale``: f32, broadcastable to
    ``q``'s shape (per-channel: size 1 on every axis except the channel
    axis, and the layer axis of a stacked weight).  Logical value:
    ``q * scale``.
    """

    __slots__ = ("q", "scale")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor) -> None:
        self.q = q
        self.scale = scale

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def dtype(self) -> torch.dtype:  # storage dtype; dequantized dtype is the caller's
        return self.q.dtype

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def nbytes(self) -> int:
        return self.q.numel() + self.scale.numel() * self.scale.element_size()

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self.q.to(dtype) * self.scale.to(dtype)

    def __getitem__(self, index) -> "QTensor":
        """Index the leading axis (an int or a slice): a stacked weight's
        layer ``i`` is ``q[i]`` with scale ``scale[i]``.  A scale of lower
        rank, or of size 1 on that axis, broadcasts over it."""
        if not isinstance(index, (int, slice)):
            raise TypeError(f"QTensor indexes its leading axis by int or slice, got {index!r}")
        scale = self.scale
        if scale.ndim == self.q.ndim:
            if scale.shape[0] != 1:
                scale = scale[index]
            elif isinstance(index, int):
                scale = scale[0]
        return QTensor(self.q[index], scale)

    def to(self, device: Any) -> "QTensor":
        """Both children on ``device`` (the int8 codes stay int8)."""
        return QTensor(self.q.to(device), self.scale.to(device))

    def __repr__(self) -> str:  # pragma: no cover
        return f"QTensor(q={tuple(self.q.shape)} {self.q.dtype}, scale={tuple(self.scale.shape)})"


tree_util.register_pytree_node(
    QTensor, lambda t: ((t.q, t.scale), None), lambda _aux, ch: QTensor(*ch)
)


def _f32_scalar(value: float, device: torch.device) -> torch.Tensor:
    """A 0-d f32 tensor on ``device``: dividing by it is a true division on
    the card too (a Python scalar divisor there becomes a product with its
    reciprocal)."""
    return torch.full((), value, dtype=torch.float32, device=device)


def quantize_int8(
    w: torch.Tensor, *, channel_axis: int = -1, batch_axes: tuple = ()
) -> QTensor:
    """Symmetric per-channel int8 quantization.

    ``channel_axis``: the output-feature axis whose scale is kept per
    channel.  ``batch_axes``: further axes that keep their own scale (the
    stacked-layer axis 0 of a [L, din, dout] weight).  Max-abs scaling:
    values map onto [-127, 127], zero exactly.
    """
    keep = {channel_axis % w.ndim} | {a % w.ndim for a in batch_axes}
    axes = tuple(i for i in range(w.ndim) if i not in keep)
    wf = w.to(torch.float32)
    absmax = torch.amax(torch.abs(wf), dim=axes, keepdim=True) if axes else torch.abs(wf)
    scale = torch.clamp(absmax, min=1e-12) / _f32_scalar(127.0, w.device)
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return QTensor(q=q.to(torch.int8), scale=scale)


def as_weight(w: Any, dtype: torch.dtype) -> torch.Tensor:
    """A weight leaf for a matmul: QTensors dequantized, tensors cast."""
    if isinstance(w, QTensor):
        return w.dequantize(dtype)
    return w.to(dtype)


def _scale_is_per_last_axis(scale: torch.Tensor) -> bool:
    return all(d == 1 for d in scale.shape[:-1])


def output_scale(w: Any) -> Optional[torch.Tensor]:
    """The flat ``[D_out]`` output-side scale of a :class:`QTensor` whose
    scale is constant along every contracted axis, else None."""
    if isinstance(w, QTensor) and _scale_is_per_last_axis(w.scale):
        return w.scale.reshape(-1)
    return None


def split_output_scale(w: Any, dtype: torch.dtype):
    """``(operand, out_scale)`` for a matmul contracting ``w``'s leading axes.

    For a :class:`QTensor` whose scale is constant along every contracted
    axis (size 1 everywhere but the last axis), the dequantization commutes
    with the contraction: the operand is the int8 weight converted to
    ``dtype`` and the flat ``[D_out]`` scale goes on the product's output
    (a 0-d scale becomes a shape-(1,) one).  Anything else gives ``(dense
    weight, None)``.
    """
    out_scale = output_scale(w)
    if out_scale is not None:
        return w.q.to(dtype), out_scale
    return as_weight(w, dtype), None


class _Int8Matmul(torch.autograd.Function):
    """``(x @ q.to(dtype)) * scale.to(dtype)`` saving the int8 ``q`` and the
    scale for the backward, which converts ``q`` again: the converted copy
    of the weight lives only inside each call."""

    @staticmethod
    def forward(ctx, x, q, scale, dtype):
        ctx.save_for_backward(q, scale)
        ctx.op_dtype = dtype
        return (x @ q.to(dtype)) * scale.to(dtype)

    @staticmethod
    def backward(ctx, grad):
        q, scale = ctx.saved_tensors
        dtype = ctx.op_dtype
        return (grad * scale.to(dtype)) @ q.to(dtype).transpose(-1, -2), None, None, None


def int8_product(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``(x @ q.to(dtype)) * scale.to(dtype)`` for an int8 ``q`` [D_in, D_out]
    and a ``[D_out]`` (or ``[1]``) scale; differentiable in ``x``."""
    return _Int8Matmul.apply(x, q, scale, dtype)


def matmul(x: torch.Tensor, w: Any, dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` in ``dtype``.

    For a per-output-channel :class:`QTensor` the scale goes on the OUTPUT,
    ``(x @ q.to(dtype)) * scale``: algebraically ``x @ (q * scale)``, since
    the scale is constant along the contracted axis, with a pure convert on
    the weight side (:func:`int8_product`).  Other scale layouts dequantize
    explicitly.  Dense weights: one product in ``dtype`` (on the card: f32
    accumulation, one rounding).
    """
    out_scale = output_scale(w)
    if out_scale is not None:
        return int8_product(x, w.q, out_scale, dtype)
    return x @ as_weight(w, dtype)


def is_quantized(w: Any) -> bool:
    return isinstance(w, QTensor)


def _path_str(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def quantize_tree(
    params: Any,
    *,
    predicate: Optional[Callable[[str, torch.Tensor], bool]] = None,
    channel_axis: int = -1,
) -> Any:
    """Quantize matching tensor leaves of a param tree to :class:`QTensor`.

    ``predicate(path_str, leaf) -> bool`` selects leaves (default: every
    float leaf with ndim >= 2, i.e. matmul weights; norms and biases stay).
    """

    def _default(_path: str, leaf: torch.Tensor) -> bool:
        return leaf.ndim >= 2 and leaf.is_floating_point()

    pred = predicate or _default

    def _maybe(path, leaf):
        if isinstance(leaf, torch.Tensor) and pred(_path_str(path), leaf):
            return quantize_int8(leaf, channel_axis=channel_axis)
        return leaf

    return pytree.tree_map_with_path(_maybe, params)


def tree_nbytes(params: Any) -> int:
    """Storage bytes of a (possibly quantized) param tree."""
    return sum(
        leaf.nbytes if isinstance(leaf, QTensor) else leaf.numel() * leaf.element_size()
        for leaf in pytree.tree_leaves(params)
        if isinstance(leaf, (QTensor, torch.Tensor))
    )


__all__ = [
    "QTensor",
    "as_weight",
    "int8_product",
    "is_quantized",
    "matmul",
    "output_scale",
    "quantize_int8",
    "quantize_tree",
    "split_output_scale",
    "tree_nbytes",
]
