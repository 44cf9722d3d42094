"""Exactly rounded fused multiply-adds: the float fold's CUDA kernel and the
plain version.

XLA on the CPU compiles some multiply-adds of the JAX package's jitted
programs into fused multiply-adds (one rounding): the float fold's (the
streamed step ``fl/streaming.py`` ``_accum_kernel`` and the one-shot chain
``fl/fedavg.py`` ``_packed_reduce_jit``) and two of the codec's
(``fl/quantize.py``).  The port computes each as an exactly rounded FMA, so
its bytes equal the reference's on the CPU and are the same on the card:

- :func:`fma` is the plain version, on any device: the f32 product is exact
  in f64, TwoSum gives the sum's rounding error, rounding to odd keeps it,
  and rounding that to f32 is the correctly rounded FMA (53 ≥ 2·24 + 2
  bits).  The codec uses it on both devices.
- :func:`fold_fma_` (``acc = fma(w, x, acc)``, in place) and
  :func:`fold_fma_pair` (``fma(w, x, v·y)``, the one-shot chain's first two
  terms) are the fold's two forms.  CPU tensors run :func:`fma`; CUDA tensors
  launch ``csrc/fold_fma.cu`` (``__fmaf_rn``, one pass) or raise.
"""

from __future__ import annotations

from typing import Optional

import torch

# Rows of an operand per slice of fma: its f64 temporaries stay near 128 MiB
# each whatever the buffer's size.
_FMA_SLICE_ELEMS = 1 << 24


def _fma_f64_to_odd(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a·b + c`` in f64, rounded to odd: a nonzero TwoSum error moves an
    even result one f64 step toward it."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bp = s - c
    err = (c - (s - bp)) + (p - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The f32 fused multiply-add ``a·b + c`` with one rounding, for ``b``
    and ``c`` of one shape and ``a`` either 0-d or one row per row of ``b``
    ([nblocks, 1] beside [nblocks, chunk]); computed a slice of rows at a
    time, into ``out`` (which may be ``c``) or a new f32 tensor."""
    rows = max(1, _FMA_SLICE_ELEMS // max(1, b[0].numel()))
    if out is None:
        out = torch.empty(b.shape, dtype=torch.float32, device=b.device)
    for lo in range(0, b.shape[0], rows):
        hi = lo + rows
        a_rows = a if a.dim() == 0 else a[lo:hi]
        out[lo:hi] = _fma_f64_to_odd(a_rows, b[lo:hi], c[lo:hi]).to(torch.float32)
    return out


def fold_fma_(acc: torch.Tensor, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``acc = fma(w, f32(x), acc)`` in place and returned.  ``acc``: a
    contiguous f32 [n] (a slice of an accumulator); ``x``: [n] wire
    elements; ``w``: an f32 0-d tensor on ``acc``'s device."""
    if acc.device.type == "cpu":
        return fma(w, x.to(torch.float32), acc, out=acc)
    _launch(acc, acc, x, w, None, None)
    return acc


def fold_fma_pair(w: torch.Tensor, x: torch.Tensor, v: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``fma(w, f32(x), v·f32(y))`` with ``v·y`` rounded first, as a new f32
    tensor: the first two terms of the one-shot fold as XLA contracts them."""
    if x.device.type == "cpu":
        return fma(w, x.to(torch.float32), v * y.to(torch.float32))
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    _launch(out, None, x, w, y, v)
    return out


def _launch(out, acc, x, w, y, v):
    """One launch of ``csrc/fold_fma.cu`` on the current stream; raise if
    the inputs do not fit it or the launch fails."""
    if x.device.type != "cuda":
        raise RuntimeError(f"the fold kernel runs on cuda, not {x.device}")
    wire = (x.dtype,) if y is None else (x.dtype, y.dtype)
    if len(set(wire)) > 1 or x.dtype not in (torch.float32, torch.bfloat16):
        # The reference's astype(float32) first: exact for the float wire
        # dtypes, the reference's rounding for integer buffers.
        x = x.to(torch.float32)
        y = None if y is None else y.to(torch.float32)
    tensors = [t for t in (out, acc, x, w, y, v) if t is not None]
    if any(t.device != out.device for t in tensors):
        raise ValueError("the fold's tensors must lie on one device")
    if out.dtype != torch.float32 or (acc is not None and acc.data_ptr() != out.data_ptr()):
        raise ValueError("the fold writes an f32 output, in place when it adds into an accumulator")
    if any(s is not None and (s.dtype != torch.float32 or s.numel() != 1) for s in (w, v)):
        raise TypeError("the fold's weights are f32 0-d tensors on the card")
    if not out.is_contiguous() or x.numel() != out.numel() or (y is not None and y.numel() != x.numel()):
        raise ValueError("the fold takes contiguous operands of one length")
    x = x.contiguous()
    y = None if y is None else y.contiguous()
    from rayfed_tpu_torch.ops._build import fold_lib

    lib = fold_lib()
    err = lib.rf_fold_fma(
        out.data_ptr(), None if acc is None else acc.data_ptr(), x.data_ptr(), w.data_ptr(),
        None if y is None else y.data_ptr(), None if v is None else v.data_ptr(),
        x.numel(), int(x.dtype == torch.bfloat16), out.device.index,
        torch.cuda.current_stream(out.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fold_fma launch failed: {lib.rf_cuda_error_string(err).decode()}")
    fold_fma_.launches += 1


# CUDA kernel launches (both forms: one kernel), counted where it is launched.
fold_fma_.launches = 0
