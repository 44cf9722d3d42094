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

- ``REDUCE_WINDOW``: the row sum of the RMSNorm's ``mean(x²)`` is a
  ``reduce-window`` of 32, each window summed in index order from 0.0 and
  the window sums then added in order from 0.0.  Read at D = 64; the bytes
  also equal XLA's at D = 128 and 256, and not at narrower rows or at 96,
  whose programs were not read.
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


def mean_sq(xf: torch.Tensor) -> torch.Tensor:
    """``mean(xf², axis=-1, keepdims=True)`` summed in XLA:CPU's order:
    zero-padded windows of ``REDUCE_WINDOW``, each in index order from 0.0,
    then the window sums in order from 0.0, times ``1/D``."""
    d = xf.shape[-1]
    sq = xf * xf
    nw = -(-d // REDUCE_WINDOW)
    pad = nw * REDUCE_WINDOW - d
    if pad:
        sq = torch.cat([sq, sq.new_zeros(*sq.shape[:-1], pad)], dim=-1)
    windows = sq.reshape(*sq.shape[:-1], nw, REDUCE_WINDOW)
    partial = windows.new_zeros(windows.shape[:-1])
    for i in range(REDUCE_WINDOW):
        partial = partial + windows[..., i]
    total = partial.new_zeros(partial.shape[:-1])
    for j in range(nw):
        total = total + partial[..., j]
    return (total / d)[..., None]


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


def rms_rsqrt(xf: torch.Tensor, eps: float) -> torch.Tensor:
    """``rsqrt(mean(xf²) + eps)`` [..., 1] of a CPU f32 tensor, as XLA:CPU
    compiles the JAX package's RMSNorm."""
    return rsqrt(mean_sq(xf) + eps)


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
