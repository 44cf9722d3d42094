"""Weight helpers for the model matmuls (the port of ``rayfed_tpu/models/quant.py``).

Only dense weights are ported: int8 weights (:class:`QTensor`) come with the
int8 slice, and constructing one raises until then.
"""

from __future__ import annotations

import torch


class QTensor:
    """An int8 weight plus its per-output-channel scale — not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("int8 weights (QTensor) come with the int8 slice")


def as_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Materialize a weight leaf for a matmul in ``dtype``."""
    return w.to(dtype)


def split_output_scale(w: torch.Tensor, dtype: torch.dtype):
    """``(operand, out_scale)`` for a matmul contracting ``w``'s leading axes.

    Only int8 weights carry an output-side scale, so a dense weight gives
    ``(w in dtype, None)``.
    """
    return as_weight(w, dtype), None


def matmul(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` in ``dtype`` (on the card: f32 accumulation, one rounding)."""
    return x @ as_weight(w, dtype)
