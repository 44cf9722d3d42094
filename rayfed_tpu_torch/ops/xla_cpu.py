"""XLA:CPU's compiled forms of the JAX package's ops, where they differ from
PyTorch's in the last bit.

The JAX package's bytes on the CPU are those of the program XLA compiles,
not of the op as written.  Each function here reproduces one such program,
as read from XLA's dumps (``XLA_FLAGS=--xla_dump_to=DIR``: the
``*.cpu_after_optimizations.txt`` HLO and the ``*.ir-with-opt.ll`` LLVM IR)
on an x86-64 host with AVX2, jaxlib 0.9.  This module owns every
assumption those programs rest on; the models and the folds call it and
hold no codegen detail of their own.  ``tests/test_torch_xla_cpu_ops.py``
probes each assumption against the installed jaxlib (``python -m
tests.test_torch_xla_cpu_ops`` prints the probe) and fails naming the one
that no longer holds.

The assumptions:

- ``REDUCE_WINDOW``: the RMSNorm's row sum of squares.  XLA's tree
  reduction rewriter turns a row longer than 32 into a ``reduce-window`` of
  32 after padding it with zeros to a multiple of 32, half the padding
  (rounded down) before the row and the rest after; it repeats that on the
  window sums while more than 32 remain, then sums what is left.  Each
  window, and the last sum, adds in index order from 0.0.  Within one jitted
  program (the JAX package's decode and train steps), a row of at most 32
  fuses its squares into the sum, and LLVM contracts each step into an FMA
  ``fma(x, x, acc)``, except at 5 to 8 elements, where the row becomes one
  vector that is squared before it is summed; the mean's ``·(1/D) + eps``
  then contracts into ``fma(sum, f32(1/D), eps)``.  Op by op (its prefill
  and ``apply_llama``), the squares, the sum, the product with f32(1/D) and
  the ``+ eps`` round one by one.  Read from the dumps at D = 8, 16, 48, 64,
  96, 384, 2048 and 4096, eager and jitted; probed at every width to 4099.
- The rsqrt: ``xla.rsqrt.f32`` is the hardware estimate (``vrsqrtps``,
  read through ``native/xla_cpu_math.cc``) and two Newton steps that LLVM
  contracts into FMAs, the raw estimate kept for special inputs.
- ``cos`` and ``sin``: XLA lowers ``llvm.cos``/``llvm.sin`` to one call of
  the C library's ``cosf``/``sinf`` per element (glibc's, resolved in the
  process), unrolled 16 wide but never vectorised, so the bytes do not
  depend on the table's length; the port calls the same functions through
  ``native/xla_cpu_math.cc``.  PyTorch's vectorised ``cos``/``sin`` differ
  from them by an ulp in a few percent of the elements.
- RoPE's frequencies ``1/θ^e``: op by op (the JAX package's prefill and
  ``apply_llama`` run eagerly) XLA divides 1 by libm's ``powf(θ, e)``;
  inside a jitted program (its decode step) the frequencies are constants,
  and XLA's simplifier rewrites ``1/pow(θ, e)`` to ``pow(θ, −e)`` before
  its constant folder takes libm's ``powf``, one rounding instead of two.
- ``VECTOR_WIDTH`` and ``UNROLL``: the compressed-domain finalize's loop
  runs 8-wide unrolled twice, then 4-wide epilogues, and its scalar
  remainder fuses ``acc − zp·W`` into an FMA.
- A division by a constant is a product with the constant's f32
  reciprocal (XLA's algebraic simplifier rewrites it before codegen).

Which device follows which: the RMSNorm's form and ``cos``/``sin`` apply
to CPU tensors only (the card's norm and RoPE tables are PyTorch's, within
an ulp, as the model tests' tolerances allow).  The reciprocal and the finalize's fused tail apply on
every device, so that a round's bytes do not depend on the device that
finalized them: the ring's stripe owners, a hub coordinator and the
coordinator fallback may each run on the card or on the CPU, beside
parties of the JAX package, and all must give the JAX package's bytes.

The float fold's fused multiply-add, which XLA:CPU also contracts, lives
with the fold kernel it is the plain version of (``ops/fold.py``).
"""

from __future__ import annotations

import torch

from rayfed_tpu_torch.ops.fold import fma

REDUCE_WINDOW = 32
VECTOR_WIDTH, UNROLL = 8, 2


def _tree_sum(sq: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis as XLA:CPU's tree reduction computes it."""
    while sq.shape[-1] > REDUCE_WINDOW:
        n = sq.shape[-1]
        nw = -(-n // REDUCE_WINDOW)
        lo = (nw * REDUCE_WINDOW - n) // 2
        hi = nw * REDUCE_WINDOW - n - lo
        sq = torch.cat([sq.new_zeros(*sq.shape[:-1], lo), sq, sq.new_zeros(*sq.shape[:-1], hi)], dim=-1)
        windows = sq.reshape(*sq.shape[:-1], nw, REDUCE_WINDOW)
        sq = windows.new_zeros(windows.shape[:-1])
        for i in range(REDUCE_WINDOW):
            sq = sq + windows[..., i]
    total = sq.new_zeros(sq.shape[:-1])
    for i in range(sq.shape[-1]):
        total = total + sq[..., i]
    return total


def _fuses_squares(d: int) -> bool:
    """Whether a jitted program's row sum of ``d`` squares is an FMA chain."""
    return d <= REDUCE_WINDOW and not 5 <= d <= 8


def sum_sq(xf: torch.Tensor, jitted: bool) -> torch.Tensor:
    """``sum(xf², axis=-1)`` of a CPU f32 tensor in XLA:CPU's order, inside
    a jitted program (``jitted``) or op by op."""
    d = xf.shape[-1]
    if jitted and _fuses_squares(d):
        total = xf.new_zeros(xf.shape[:-1])
        for i in range(d):
            col = xf[..., i].contiguous()
            total = fma(col, col, total)
        return total
    return _tree_sum(xf * xf)


def rms_rsqrt(xf: torch.Tensor, eps: float, jitted: bool = False) -> torch.Tensor:
    """``rsqrt(mean(xf²) + eps)`` [..., 1] of a CPU f32 tensor, as XLA:CPU
    compiles the JAX package's RMSNorm inside a jitted program
    (``jitted``) or op by op."""
    total = sum_sq(xf, jitted)
    inv_d = torch.full_like(total, 1.0 / xf.shape[-1])
    if jitted:
        mean_eps = fma(total, inv_d, torch.full_like(total, eps))
    else:
        mean_eps = total * inv_d + eps
    return rsqrt(mean_eps)[..., None]


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.rsqrt`` of a CPU f32 tensor: the hardware estimate, then
    two Newton steps ``y ← fma(y·(−½), fma(x·y, y, −1), y)``, the raw
    estimate kept where the input is not a positive finite."""
    from rayfed_tpu_torch.native import rsqrt_estimate

    flat = x.reshape(-1)
    y0 = rsqrt_estimate(flat)
    y, minus_one = y0, torch.full_like(flat, -1.0)
    for _ in range(2):
        e = fma(flat * y, y, minus_one)
        y = fma(y * -0.5, e, y)
    return torch.where(torch.isfinite(flat) & (flat > 0), y, y0).reshape(x.shape)


def cos(x: torch.Tensor) -> torch.Tensor:
    """``jnp.cos`` of a CPU f32 tensor as XLA:CPU computes it: libm's
    ``cosf`` of each element."""
    from rayfed_tpu_torch.native import libm_cos

    return libm_cos(x)


def sin(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sin`` of a CPU f32 tensor as XLA:CPU computes it: libm's
    ``sinf`` of each element."""
    from rayfed_tpu_torch.native import libm_sin

    return libm_sin(x)


def rope_freqs(exponents: torch.Tensor, theta: float, folded: bool) -> torch.Tensor:
    """RoPE's ``1/θ^e`` of a CPU f32 tensor of exponents: as XLA folds it
    inside a jitted program (``folded``), else as its eager ops compute it."""
    from rayfed_tpu_torch.native import libm_pow

    if folded:
        return libm_pow(theta, -exponents)
    return 1.0 / libm_pow(theta, exponents)


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a constant ``c``, as XLA compiles it: ``x`` times the
    f32 reciprocal of ``c``."""
    return x * torch.full((), 1.0 / c, dtype=torch.float32, device=x.device)


def _scalar_tail(nblocks: int, total_elems: int) -> int:
    """How many trailing elements of the finalize's loop run in scalar code:
    the loop takes ``VECTOR_WIDTH·UNROLL`` elements an iteration, then
    4-wide epilogue iterations when 8 or more remain, and SLP packs shorter
    remainders in 4s and 2s.  With one block ``zp·W`` is loop-invariant and
    nothing fuses."""
    if nblocks < 2:
        return 0
    r = total_elems % (VECTOR_WIDTH * UNROLL)
    return r % 4 if r >= VECTOR_WIDTH else r % 2


def sub_scaled(a: torch.Tensor, zp: torch.Tensor, w: torch.Tensor, total_elems: int) -> torch.Tensor:
    """The f32 finalize's ``a − zp·W`` over the block grid ``a`` [nblocks,
    chunk] (``zp`` [nblocks, 1], ``W`` 0-d), with the elements XLA:CPU's loop
    leaves to scalar code fused into one FMA each."""
    inner = a - zp * w
    n, ce = int(total_elems), a.shape[1]
    k = _scalar_tail(a.shape[0], n)
    if k:
        rows = torch.arange(n - k, n, device=a.device) // ce
        inner.reshape(-1)[n - k : n] = fma(-zp.reshape(-1)[rows], w.expand(k).contiguous(),
                                          a.reshape(-1)[n - k : n])
    return inner
