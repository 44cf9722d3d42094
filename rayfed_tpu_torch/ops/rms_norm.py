"""RMSNorm: a CUDA kernel for the forward, one for the backward, and the
formula as PyTorch ops.

The Llama decoder's norm over the last axis, in f32 whatever the input's
type: ``r = rsqrt(mean(x²) + eps)``, ``y = cast((x·r)·scale)``.  The JAX
package has no kernel for it (XLA fuses its jnp ops); on the card PyTorch
runs the formula as about ten passes over f32 copies of the row, and
autograd's backward as many again.  ``csrc/rms_norm.cu`` reads the row once
and writes the output once in each direction:

- :func:`rms_norm` is differentiable (:class:`_RMSNorm`): the forward saves
  ``x`` and one f32 ``rstd`` a row, no f32 copy of the row; the backward
  computes ``dx = r·(g − x̂·mean(g·x̂))`` with ``x̂ = x·r`` and ``g =
  dy·scale``, and ``dscale = Σ_rows dy·x̂`` only when the scale needs a
  gradient (deterministic: per-block partials and a second reduce).
- It takes every norm on the card (:func:`takes_kernel`: x and a ``[width]``
  scale of f32, bf16 or f16 on one card, any width) and raises on anything
  else.  A DTensor runs the kernels on its local rows: a width split over
  ranks, or partial sums, are first gathered, as
  ``parallel.sharding.sharded_attn_fn`` gathers heads.
- :func:`rms_norm_plain` is the formula as PyTorch ops: the model's CPU
  form (``models/llama.py``) and the yardstick the kernels are held to.

Launches are counted where each kernel is launched: ``rms_norm.fwd_launches``,
``.bwd_launches`` and ``.dscale_launches`` (the reduce of dscale's
partials); :func:`reset_launches` zeroes them.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

# The kernels' element types, by their numbering.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The norm as PyTorch ops, in the kernels' order of rounding."""
    xf = x.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * r * scale.float()).to(x.dtype)


def takes_kernel(x: torch.Tensor, scale: torch.Tensor) -> bool:
    """Whether the kernels take this norm: by the inputs' device, types and
    shapes alone."""
    width = x.shape[-1] if x.dim() else 0
    return (
        x.device.type == "cuda"
        and isinstance(scale, torch.Tensor)
        and scale.device == x.device
        and x.dtype in _DTYPES
        and scale.dtype in _DTYPES
        and tuple(scale.shape) == (width,)
        and width > 0
    )


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    if not takes_kernel(x, scale):
        raise ValueError(
            f"the RMSNorm kernels take x of f32, bf16 or f16 on a CUDA card and a [width] scale of "
            f"one of those types on the same card; got x {x.dtype} {tuple(x.shape)} on {x.device}, "
            f"scale {getattr(scale, 'dtype', type(scale))} {tuple(getattr(scale, 'shape', ()))} on "
            f"{getattr(scale, 'device', None)}"
        )


@functools.lru_cache(maxsize=None)
def _resident(backward: bool, width: int, x_dtype: int, scale_dtype: int, device: int) -> int:
    """The blocks the card holds at once of a kernel (asked once a key)."""
    from rayfed_tpu_torch.ops._build import rms_norm_lib

    lib = rms_norm_lib()
    blocks = lib.rf_rms_norm_resident(int(backward), width, x_dtype, scale_dtype, device)
    _raise(lib, "rms_norm_resident", max(-blocks, 0))
    return blocks


def _card_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous from a 16-byte-aligned address (a copy only where it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _raise(lib, name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.rf_cuda_error_string(err).decode()}")


def _forward(x: torch.Tensor, scale: torch.Tensor, eps: float,
             want_rstd: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(y, rstd)`` on the card; ``rstd`` is None unless ``want_rstd``."""
    _check(x, scale)
    from rayfed_tpu_torch.ops._build import rms_norm_lib

    width = x.shape[-1]
    rows = x.numel() // width
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rstd = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device) if want_rstd else None
    if rows == 0:
        return y, rstd
    xd, sd, device = _DTYPES[x.dtype], _DTYPES[scale.dtype], x.device.index
    blocks = min(rows, _resident(False, width, xd, sd, device))
    xc, sc = _card_operand(x), _card_operand(scale)
    lib = rms_norm_lib()
    err = lib.rf_rms_norm_fwd(
        y.data_ptr(), None if rstd is None else rstd.data_ptr(), xc.data_ptr(), sc.data_ptr(),
        rows, width, xd, sd, float(eps), blocks, device, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise(lib, "rms_norm_fwd", err)
    rms_norm.fwd_launches += 1
    return y, rstd


def _backward(dy: torch.Tensor, x: torch.Tensor, rstd: torch.Tensor, scale: torch.Tensor,
              want_dscale: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(dx, dscale)`` on the card from the forward's ``x`` and ``rstd``."""
    _check(x, scale)
    if dy.shape != x.shape or rstd.shape != (*x.shape[:-1], 1) or rstd.dtype != torch.float32:
        raise ValueError(
            f"dy {tuple(dy.shape)} and f32 rstd {tuple(rstd.shape)} ({rstd.dtype}) do not fit "
            f"x {tuple(x.shape)}"
        )
    from rayfed_tpu_torch.ops._build import rms_norm_lib

    width = x.shape[-1]
    rows = x.numel() // width
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dscale = torch.zeros(width, dtype=scale.dtype, device=x.device) if want_dscale else None
    if rows == 0:
        return dx, dscale
    xd, sd, device = _DTYPES[x.dtype], _DTYPES[scale.dtype], x.device.index
    blocks = min(rows, _resident(True, width, xd, sd, device))
    part = torch.empty((blocks, width), dtype=torch.float32, device=x.device) if want_dscale else None
    dyc = _card_operand(dy.to(x.dtype))
    xc, sc, rc = _card_operand(x), _card_operand(scale), rstd.contiguous()
    lib = rms_norm_lib()
    err = lib.rf_rms_norm_bwd(
        dx.data_ptr(), None if dscale is None else dscale.data_ptr(), None if part is None else part.data_ptr(),
        dyc.data_ptr(), xc.data_ptr(), rc.data_ptr(), sc.data_ptr(), rows, width, xd, sd, blocks, device,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise(lib, "rms_norm_bwd", err)
    rms_norm.bwd_launches += 1
    rms_norm.dscale_launches += int(want_dscale)
    return dx, dscale


class _RMSNorm(torch.autograd.Function):
    """The norm with the kernel's backward as its gradient.  Saves ``x``, the
    scale (a parameter: no copy) and the f32 ``rstd`` a row."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        y, rstd = _forward(x, scale, eps, want_rstd=True)
        ctx.save_for_backward(x, scale, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, rstd = ctx.saved_tensors
        dx, dscale = _backward(dy, x, rstd, scale, want_dscale=ctx.needs_input_grad[1])
        return (dx if ctx.needs_input_grad[0] else None), dscale, None


def _local(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, float(eps))
    return _forward(x, scale, eps, want_rstd=False)[0]


def _is_dtensor(t) -> bool:
    return type(t).__module__.startswith("torch.distributed")


def _on_ranks(x, scale, eps: float):
    """The norm of a DTensor ``x`` on each rank's whole rows: x's width and
    any partial sums gathered (its other splits kept), the scale replicated;
    the scale's gradient is a partial sum over the ranks that split x's rows."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh, last = x.device_mesh, x.dim() - 1
    rows = tuple(Replicate() if p.is_partial() or (p.is_shard() and p.dim % x.dim() == last) else p
                 for p in x.placements)
    whole = tuple(Replicate() for _ in rows)
    if _is_dtensor(scale):
        grad = tuple(Partial() if p.is_shard() else Replicate() for p in rows)
        scale = scale.redistribute(mesh, whole).to_local(grad_placements=grad)
    y = _local(x.redistribute(mesh, rows).to_local(), scale, eps)
    return DTensor.from_local(y, mesh, rows, shape=x.shape, stride=torch.empty(x.shape, device="meta").stride())


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """``cast((x·r)·scale)`` with ``r = rsqrt(mean(x²) + eps)`` over the last
    axis, computed in f32 on the card; differentiable in ``x`` and ``scale``.
    Where no gradient is wanted (serving, ``torch.no_grad``) the forward
    writes no ``rstd``.  A DTensor ``x`` returns a DTensor."""
    if _is_dtensor(x):
        return _on_ranks(x, scale, eps)
    return _local(x, scale, eps)


# Counted where each kernel is launched.
rms_norm.fwd_launches = 0
rms_norm.bwd_launches = 0
rms_norm.dscale_launches = 0


def reset_launches() -> None:
    """Zero the three counts."""
    rms_norm.fwd_launches = 0
    rms_norm.bwd_launches = 0
    rms_norm.dscale_launches = 0
