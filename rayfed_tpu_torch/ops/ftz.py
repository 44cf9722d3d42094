"""The round's f32 arithmetic with subnormals flushed, as the JAX package
computes it.

XLA runs its CPU programs with the x86 denormal flags set (DAZ and FTZ),
and the TPU the JAX package targets flushes too: a subnormal f32 operand of
an arithmetic op reads as a zero of its sign, and a result that is tiny
writes a zero of its sign.  Tiny is x86's rule, detected after rounding: the
exact result rounded to 24 bits as if the exponent were unbounded is smaller
than 2^-126 in magnitude.  So a product whose exact value is 2^-126 − 2^-150
is tiny and flushes, where gradual underflow would round it up to 2^-126.

The port's round programs flush the same way on either device: the fold
kernel (``csrc/fold_fma.cu``) and its plain versions in their own arithmetic,
and the elementwise passes around them through these helpers, which take
tensors (and host numbers): on the CPU PyTorch's ops with the flushing
written out below (the plain version), on the card one launch of the fold
kernel's binary form (``ops/fold.py`` ``ftz_binary``).  Never the
process-wide ``torch.set_flush_denormal``: it would change the model paths
as well.

A multiply or divide decides tininess at a result of exactly ±2^-126 by
doing the same operation once more with one operand scaled by 2^64, exactly,
which puts the exact result in the normal range: rounded there, it is the
24-bit rounding of the exact value.  An add or subtract of two normal f32
values is exact whenever its result is below 2^-126, so its result is
flushed as it is.
"""

from __future__ import annotations

import math
from typing import Union

import numpy as np
import torch

FLT_MIN = 2.0 ** -126
# 2^64: scales a product or quotient near FLT_MIN into the normal range.
_UP = 2.0 ** 64

Operand = Union[torch.Tensor, float]


def flush(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) with every subnormal element a zero of its sign, as a new
    tensor."""
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)


def flush_number(w: float) -> float:
    """A host number, its f32 value flushed: a subnormal is a zero of its
    sign."""
    return math.copysign(0.0, w) if abs(w) < FLT_MIN else w


def _operands(a: Operand, b: Operand, flushed: bool = True):
    """Both operands as f32 tensors on one device, flushed unless
    ``flushed`` is False: a host number becomes a 0-d tensor on the other
    operand's device (a CPU scalar beside a card tensor would turn a
    division into a product with a reciprocal)."""
    like = a if isinstance(a, torch.Tensor) else b
    a, b = (x.to(torch.float32) if isinstance(x, torch.Tensor) else
            torch.full((), flush_number(float(np.float32(x))), dtype=torch.float32, device=like.device)
            for x in (a, b))
    return (flush(a), flush(b)) if flushed else (a, b)


def _out(r: torch.Tensor, tiny: torch.Tensor) -> torch.Tensor:
    return torch.where(tiny, r * 0.0, r)


def _tiny(r: torch.Tensor, scaled: torch.Tensor) -> torch.Tensor:
    """Whether a product or quotient ``r`` is tiny after rounding, given the
    same operation with its first operand times 2^64 (``scaled``)."""
    m = r.abs()
    return (m < FLT_MIN) | ((m == FLT_MIN) & (scaled.abs() < FLT_MIN * _UP))


def _on_card(op: str, a: Operand, b: Operand):
    """The kernel's result when an operand lies on the card, else None."""
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in (a, b)):
        from rayfed_tpu_torch.ops import fold

        a, b = _operands(a, b, flushed=False)
        return fold.ftz_binary(op, a, b)
    return None


def add(a: Operand, b: Operand) -> torch.Tensor:
    """``a + b`` in f32, operands and result flushed."""
    got = _on_card("add", a, b)
    if got is not None:
        return got
    a, b = _operands(a, b)
    return flush(a + b)


def sub(a: Operand, b: Operand) -> torch.Tensor:
    """``a − b`` in f32, operands and result flushed."""
    got = _on_card("sub", a, b)
    if got is not None:
        return got
    a, b = _operands(a, b)
    return flush(a - b)


def mul(a: Operand, b: Operand) -> torch.Tensor:
    """``a·b`` in f32, operands flushed, the result flushed when it is tiny
    after rounding."""
    got = _on_card("mul", a, b)
    if got is not None:
        return got
    a, b = _operands(a, b)
    r = a * b
    return _out(r, _tiny(r, (a * _UP) * b))


def div(a: Operand, b: Operand) -> torch.Tensor:
    """``a / b`` in f32 (a true division), operands flushed, the result
    flushed when it is tiny after rounding."""
    got = _on_card("div", a, b)
    if got is not None:
        return got
    a, b = _operands(a, b)
    r = a / b
    return _out(r, _tiny(r, (a * _UP) / b))
