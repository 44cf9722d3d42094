"""Exactly rounded fused multiply-adds: the float fold's CUDA kernel and its
plain versions.

XLA on the CPU compiles some multiply-adds of the JAX package's jitted
programs into fused multiply-adds (one rounding): the float fold's (the
streamed step ``fl/streaming.py`` ``_accum_kernel`` and the one-shot chain
``fl/fedavg.py`` ``_packed_reduce_jit``) and two of the codec's
(``fl/quantize.py``).  The port computes each as an exactly rounded FMA, so
its bytes equal the reference's on the CPU and are the same on the card:

- :func:`fma` is the plain arithmetic, on any device: the f32 product is
  exact in f64, TwoSum gives the sum's rounding error, rounding to odd keeps
  it, and rounding that to f32 is the correctly rounded FMA (53 ≥ 2·24 + 2
  bits).
- The kernel ``csrc/fold_fma.cu`` has five forms, each a wrapper here with
  its plain version beside it: :func:`fold_fma_` (the streamed step ``acc =
  fma(w, x, acc)``, in place), :func:`fold_fma_pair` (``fma(w, x, v·y)``),
  :func:`fold_chain` (the whole one-shot fold, ``fma(w0, x0, w1·x1)``, then
  ``fma(wk, xk, t)``, then ``cast(t / total)``, in one launch of up to
  :data:`MAX_OPS` operands), :func:`finalize` (a streamed fold's
  ``cast(acc / total)``) and :func:`fma_rows` (``fma(±s[r], b − z[r], c)``
  over rows, the codec's two FMAs); and :func:`ftz_binary`, the round's
  elementwise add, subtract, multiply and divide with subnormals flushed
  (its plain version is ``ops/ftz.py``'s PyTorch ops).  CPU tensors run
  the plain version; CUDA tensors launch the kernel on the current stream
  or raise.
- Every form flushes subnormals as the JAX package's programs do (DAZ and
  FTZ, ``ops/ftz.py``): :func:`fma_ftz` is the plain versions' FMA, while
  :func:`fma` keeps subnormals for the model programs ``ops/xla_cpu.py``
  emulates.

Weights are host numbers (Python floats, or CPU 0-d tensors), passed to the
kernel by value as the f32 :func:`f32_arg` makes of them: the bits that
``fl.fedavg.f32_scalar`` puts on a device.  A weight on the card is refused:
reading it would wait for its stream.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from rayfed_tpu_torch.ops import ftz

# Rows of an operand per slice of fma: its f64 temporaries stay near 128 MiB
# each whatever the buffer's size.
_FMA_SLICE_ELEMS = 1 << 24

# Operands of one chain launch (``kMaxOps`` of csrc/fold_fma.cu); a longer
# chain carries its f32 running value from launch to launch.
MAX_OPS = 8

# The element types the kernel reads, by its numbering: wire operands and
# outputs, and the rows form's ``b`` (the codec's codes).
_WIRE = {torch.float32: 0, torch.bfloat16: 1}
_ROWS_B = {torch.float32: 0, torch.uint8: 3, torch.int8: 4}


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


def _fma_slices(a, b, c, out, flushed: bool) -> torch.Tensor:
    rows = max(1, _FMA_SLICE_ELEMS // max(1, b[0].numel()))
    if out is None:
        out = torch.empty(b.shape, dtype=torch.float32, device=b.device)
    for lo in range(0, b.shape[0], rows):
        hi = lo + rows
        ops = (a if a.dim() == 0 else a[lo:hi], b[lo:hi], c[lo:hi])
        if flushed:
            ops = [ftz.flush(t.to(torch.float32)) for t in ops]
        s = _fma_f64_to_odd(*ops)
        r = s.to(torch.float32)
        if flushed:
            # Tiny after rounding: the exact value, scaled by 2^64 into the
            # normal range and rounded there, is below 2^-62.
            r = torch.where((s * 2.0 ** 64).to(torch.float32).abs() < ftz.FLT_MIN * 2.0 ** 64, r * 0.0, r)
        out[lo:hi] = r
    return out


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The f32 fused multiply-add ``a·b + c`` with one rounding, for ``b``
    and ``c`` of one shape and ``a`` either 0-d or one row per row of ``b``
    ([nblocks, 1] beside [nblocks, chunk]); computed a slice of rows at a
    time, into ``out`` (which may be ``c``) or a new f32 tensor.  Subnormals
    are kept (gradual underflow): the form XLA:CPU's model programs are
    emulated with (``ops/xla_cpu.py``)."""
    return _fma_slices(a, b, c, out, flushed=False)


def fma_ftz(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`fma` with subnormals flushed as the round's programs flush
    them (``ops/ftz.py``): subnormal operands read as zeros of their sign,
    and a result that is tiny after rounding is a zero of its sign.  The
    fold kernel's arithmetic."""
    return _fma_slices(a, b, c, out, flushed=True)


def f32_arg(w) -> float:
    """A weight as the kernel's by-value f32 argument: ``np.float32`` of a
    host number (a CPU 0-d tensor is read as its value), as a Python float
    that ctypes passes without rounding again.  The kernel reads it flushed,
    as the plain versions do."""
    if isinstance(w, torch.Tensor):
        if w.device.type != "cpu":
            raise TypeError(
                f"the fold's weights are host numbers, not a tensor on {w.device}: "
                f"reading it would wait for its stream"
            )
        w = w.item()
    return float(np.float32(w))


def _scalar(w, device: torch.device) -> torch.Tensor:
    """A weight as a 0-d f32 tensor on ``device``, for the plain versions."""
    return torch.full((), f32_arg(w), dtype=torch.float32, device=device)


# -- plain versions (any device; the wrappers take them for CPU tensors) ----


def step_plain(acc: torch.Tensor, w, x: torch.Tensor) -> torch.Tensor:
    """``acc = fma(w, f32(x), acc)`` in place, returned."""
    return fma_ftz(_scalar(w, acc.device), x.to(torch.float32), acc, out=acc)


def pair_plain(w, x: torch.Tensor, v, y: torch.Tensor) -> torch.Tensor:
    """``fma(w, f32(x), v·f32(y))``, ``v·y`` rounded first, as a new f32
    tensor."""
    return fma_ftz(_scalar(w, x.device), x.to(torch.float32), ftz.mul(_scalar(v, x.device), y.to(torch.float32)))


def chain_plain(xs: Sequence[torch.Tensor], ws: Sequence, total, out_dtype: torch.dtype) -> torch.Tensor:
    """The one-shot fold op by op: ``w0·x0`` for one operand, else the pair
    ``fma(w0, x0, w1·x1)``; then one step per further operand; then
    ``(t / total)`` (a true f32 division) cast to ``out_dtype``."""
    if len(xs) == 1:
        t = ftz.mul(_scalar(ws[0], xs[0].device), xs[0].to(torch.float32))
    else:
        t = pair_plain(ws[0], xs[0], ws[1], xs[1])
    for x, w in zip(xs[2:], ws[2:]):
        step_plain(t, w, x)
    return finalize_plain(t, total, out_dtype)


def finalize_plain(acc: torch.Tensor, total, out_dtype: torch.dtype) -> torch.Tensor:
    """``(acc / total)`` (a true f32 division) cast to ``out_dtype``."""
    return ftz.div(acc, _scalar(total, acc.device)).to(out_dtype)


def rows_plain(s: torch.Tensor, b: torch.Tensor, c: torch.Tensor, z: Optional[torch.Tensor] = None,
               negate: bool = False) -> torch.Tensor:
    """``fma(±s[r], f32(b) − z[r], c)`` over ``b`` and ``c`` [rows, width],
    ``s`` and ``z`` one f32 a row, as a new f32 tensor."""
    s = s.reshape(-1, 1)
    d = b.to(torch.float32)
    if z is not None:
        d = ftz.sub(d, z.reshape(-1, 1))
    return fma_ftz(-s if negate else s, d, c)


# -- the kernel's wrappers ---------------------------------------------------


def fold_fma_(acc: torch.Tensor, w, x: torch.Tensor) -> torch.Tensor:
    """``acc = fma(w, f32(x), acc)`` in place and returned (the streamed
    step).  ``acc``: a contiguous f32 [n] (a slice or run of an
    accumulator); ``x``: [n] wire elements; ``w``: a host number.  The
    streamed fold launches it once per run of blocks, so its host side is
    kept to attribute reads: the full checks run only when a quick one
    fails."""
    if not acc.is_cuda:
        return _off_card(acc, step_plain, acc, w, x)
    if x.dtype not in _WIRE:
        x = x.to(torch.float32)
    n, dev = acc.numel(), acc.get_device()
    if not (acc.dtype is torch.float32 and x.get_device() == dev and x.numel() == n
            and acc.is_contiguous() and x.is_contiguous()):
        _check("step", acc, x)
    lib = _LIB or _lib()
    _done("step", lib, lib.rf_fold_step(acc.data_ptr(), x.data_ptr(), f32_arg(w), n, _WIRE[x.dtype], dev,
                                        _stream(dev)))
    return acc


def fold_fma_pair(w, x: torch.Tensor, v, y: torch.Tensor) -> torch.Tensor:
    """``fma(w, f32(x), v·f32(y))`` with ``v·y`` rounded first, as a new f32
    tensor: the first two terms of the one-shot fold as XLA contracts them,
    and the server step's contractions."""
    if not x.is_cuda:
        return _off_card(x, pair_plain, w, x, v, y)
    if x.dtype != y.dtype or x.dtype not in _WIRE:
        x, y = x.to(torch.float32), y.to(torch.float32)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    _check("pair", out, x, y)
    lib, dev = _LIB or _lib(), out.get_device()
    _done("pair", lib, lib.rf_fold_pair(out.data_ptr(), x.data_ptr(), f32_arg(w), y.data_ptr(), f32_arg(v),
                                        out.numel(), _WIRE[x.dtype], dev, _stream(dev)))
    return out


def fold_chain(xs: Sequence[torch.Tensor], ws: Sequence, total, out_dtype: torch.dtype) -> torch.Tensor:
    """The one-shot fold: ``cast((w0·x0 ⊕ w1·x1 ⊕ ...) / total)`` with the
    chain's roundings (:func:`chain_plain`), as a new ``out_dtype`` tensor.
    On the card one launch reads every operand once and writes the output
    once, for up to :data:`MAX_OPS` operands; a longer chain carries its f32
    running value through a scratch buffer from launch to launch (4 bytes an
    element written and read again per extra launch).  An output dtype the
    kernel does not write (not f32 or bf16) is cast from its f32
    quotient, which is what the op-by-op fold does."""
    xs = list(xs)
    if not xs or len(ws) != len(xs):
        raise ValueError(f"the chain takes one weight per operand: {len(ws)} weights, {len(xs)} operands")
    if not xs[0].is_cuda:
        return _off_card(xs[0], chain_plain, xs, ws, total, out_dtype)
    if len({x.dtype for x in xs}) > 1 or xs[0].dtype not in _WIRE:
        xs = [x.to(torch.float32) for x in xs]
    direct = out_dtype in _WIRE
    out = torch.empty(xs[0].shape, dtype=out_dtype if direct else torch.float32, device=xs[0].device)
    _check("chain", out, *xs)
    lib, dev = _LIB or _lib(), out.get_device()
    wire, stream = _WIRE[xs[0].dtype], _stream(dev)
    n = len(xs)
    carry = None if n <= MAX_OPS else torch.empty(out.shape, dtype=torch.float32, device=dev)
    for lo in range(0, n, MAX_OPS):
        group = xs[lo:lo + MAX_OPS]
        last = lo + MAX_OPS >= n
        dst = out if last else carry
        ptrs = (ctypes.c_void_p * len(group))(*[x.data_ptr() for x in group])
        wts = (ctypes.c_float * len(group))(*[f32_arg(w) for w in ws[lo:lo + MAX_OPS]])
        _done("chain", lib, lib.rf_fold_chain(
            dst.data_ptr(), None if lo == 0 else carry.data_ptr(), ptrs, wts, len(group), out.numel(),
            wire, _WIRE[dst.dtype], f32_arg(total), int(last), dev, stream))
    return out if direct else out.to(out_dtype)


def finalize(acc: torch.Tensor, total, out_dtype: torch.dtype) -> torch.Tensor:
    """The finalize of a streamed or striped fold: ``cast(acc / total)``
    (:func:`finalize_plain`) as a new ``out_dtype`` tensor; ``acc``: a
    contiguous f32 [n].  On the card one launch of the chain kernel that
    continues from ``acc`` with no operand: it reads ``acc`` once and writes
    the output once."""
    if not acc.is_cuda:
        return _off_card(acc, finalize_plain, acc, total, out_dtype)
    if acc.dtype != torch.float32:
        raise ValueError(f"the finalize divides an f32 accumulator, not {acc.dtype}")
    direct = out_dtype in _WIRE
    out = torch.empty(acc.shape, dtype=out_dtype if direct else torch.float32, device=acc.device)
    _check("finalize", out, acc)
    lib, dev = _LIB or _lib(), out.get_device()
    _done("finalize", lib, lib.rf_fold_chain(out.data_ptr(), acc.data_ptr(), None, None, 0, out.numel(), 0,
                                             _WIRE[out.dtype], f32_arg(total), 1, dev, _stream(dev)))
    return out if direct else out.to(out_dtype)


def fma_rows(s: torch.Tensor, b: torch.Tensor, c: torch.Tensor, z: Optional[torch.Tensor] = None,
             negate: bool = False) -> torch.Tensor:
    """``fma(±s[r], b − z[r], c)`` over ``b`` and ``c`` [rows, width] with
    one f32 scale ``s`` and zero point ``z`` (optional) a row, as a new f32
    tensor: the codec's residual ``fma(−scale, q − zp, a)`` and reference add
    ``fma(scale, q − zp, ref)``.  ``b``: f32, or the codes (uint8, int8),
    read as f32; ``c``: f32."""
    if b.dim() != 2 or c.shape != b.shape:
        raise ValueError(f"the rows form takes b and c of one [rows, width] shape, got {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    if c.dtype != torch.float32:
        raise ValueError(f"the rows form adds an f32 c, not {c.dtype}")
    rows = b.shape[0]
    vecs = [s] if z is None else [s, z]
    if any(t.dtype != torch.float32 or t.numel() != rows or not t.is_contiguous() for t in vecs):
        raise ValueError(f"the rows form takes one contiguous f32 scale and zero point per row ({rows})")
    if not b.is_cuda:
        return _off_card(b, rows_plain, s, b, c, z, negate)
    b = b if b.dtype in _ROWS_B else b.to(torch.float32)
    out = torch.empty(b.shape, dtype=torch.float32, device=b.device)
    _check("rows", out, b, c)
    if any(t.device != out.device for t in vecs):
        raise ValueError("the fold's tensors must lie on one device")
    lib, dev = _LIB or _lib(), out.get_device()
    _done("rows", lib, lib.rf_fold_rows(
        out.data_ptr(), b.data_ptr(), c.data_ptr(), s.data_ptr(), None if z is None else z.data_ptr(),
        int(negate), out.numel(), b.shape[1], _ROWS_B[b.dtype], dev, _stream(dev)))
    return out


_BINARY_OPS = {"add": 0, "sub": 1, "mul": 2, "div": 3}
_GRID_ROWS = 65535  # the most rows of one launch of the binary form (the grid's y)


def ftz_binary(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a op b`` (``"add"``, ``"sub"``, ``"mul"`` or ``"div"``, a true
    division) in f32 with subnormals flushed (``ops/ftz.py``), broadcast as
    PyTorch broadcasts, as a new f32 tensor on the card: one launch of the
    kernel's binary form, each operand read whole, one value a row of the
    last dimension, or one value; other broadcasts are expanded first.  CUDA
    tensors only (a one-element operand may be a CPU tensor); the CPU's
    version is :mod:`rayfed_tpu_torch.ops.ftz`'s PyTorch ops."""
    dev = a.device if a.is_cuda else b.device
    if dev.type != "cuda":
        raise RuntimeError(f"the fold kernel runs on cuda, not {dev}")
    a, b = (t.to(device=dev, dtype=torch.float32) for t in (a, b))
    shape = torch.broadcast_shapes(a.shape, b.shape)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    n = out.numel()
    if n == 0:
        return out
    width = shape[-1] if len(shape) else 1
    rows = n // width
    per_row = tuple(shape[:-1]) + (1,)

    def mode(t):
        if t.numel() == 1:
            return 2, t
        if tuple(t.shape) == tuple(shape) and t.is_contiguous():
            return 0, t
        if rows <= _GRID_ROWS and tuple(t.shape) == per_row and t.is_contiguous():
            return 1, t
        return 0, t.expand(shape).contiguous()

    (am, a), (bm, b) = mode(a), mode(b)
    if rows > _GRID_ROWS:  # one row of every element
        rows, width = 1, n
    lib = _LIB or _lib()
    _done("ftz", lib, lib.rf_ftz_binary(out.data_ptr(), a.data_ptr(), am, b.data_ptr(), bm, _BINARY_OPS[op],
                                        rows, width, out.get_device(), _stream(out.get_device())))
    return out


def vector_head(*ts: torch.Tensor) -> int:
    """The head the kernel's launcher plans for operands at these addresses:
    the elements it folds one by one before every operand sits on the
    boundary of its vector loads, or -1 when no head aligns them all and the
    scalar kernel runs.  Reads the built library's own rule."""
    lib = _LIB or _lib()
    ptrs = (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    sizes = (ctypes.c_int * len(ts))(*[t.element_size() for t in ts])
    return lib.rf_fold_head(ptrs, sizes, len(ts))


# -- launching ---------------------------------------------------------------

_LIB = None


def _lib():
    """The built library, loaded once (``ops/_build.py``)."""
    global _LIB
    if _LIB is None:
        from rayfed_tpu_torch.ops._build import fold_lib

        _LIB = fold_lib()
    return _LIB


def _stream(index: int) -> int:
    """The raw handle of the current stream of card ``index``: one lookup,
    no ``torch.cuda.Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(index)


def _off_card(t: torch.Tensor, plain, *args):
    """A tensor not on a card: the plain version on the CPU, else raise."""
    if t.device.type == "cpu":
        return plain(*args)
    raise RuntimeError(f"the fold kernel runs on cuda, not {t.device}")


def _check(form: str, out: torch.Tensor, *ins: torch.Tensor) -> None:
    """Raise unless the kernel takes these: all on one CUDA device,
    contiguous, of one length, the output f32 (or, for the chain, a dtype it
    writes)."""
    dev = out.device
    if dev.type != "cuda":
        raise RuntimeError(f"the fold kernel runs on cuda, not {dev}")
    n = out.numel()
    for t in (out, *ins):
        if t.device != dev:
            raise ValueError("the fold's tensors must lie on one device")
        if t.numel() != n:
            raise ValueError(f"the fold's {form} takes operands of one length: {t.numel()} vs {n}")
        if not t.is_contiguous():
            raise ValueError(f"the fold's {form} takes contiguous operands")
    if form not in ("chain", "finalize") and out.dtype != torch.float32:
        raise ValueError(f"the fold's {form} writes an f32 output, not {out.dtype}")


def _done(form: str, lib, err: int) -> None:
    """Raise if the launch was refused; else count it."""
    if err != 0:
        raise RuntimeError(f"fold_fma {form} launch failed: {lib.rf_cuda_error_string(err).decode()}")
    fold_fma_.launches += 1
    fold_fma_.by_form[form] += 1


# CUDA kernel launches, counted where they are launched: every form
# together, and each form apart.
fold_fma_.launches = 0
fold_fma_.by_form = dict.fromkeys(("step", "pair", "chain", "rows", "finalize", "ftz"), 0)


def reset_launches() -> None:
    """Set every launch count to 0."""
    fold_fma_.launches = 0
    fold_fma_.by_form.update(dict.fromkeys(fold_fma_.by_form, 0))
