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
- A whole array's sum (``fl.dp``'s per-leaf sum of squares): unit
  dimensions dropped, every dimension longer than ``REDUCE_WINDOW`` is cut
  into windows as above (each dimension padded on its own), and each
  window, then the window sums, add over XLA's loop nest as LLVM optimizes
  it (the adds are ``reassoc``): it unrolls the innermost loop and, when
  a row holds at most 8 elements and neither of the two innermost
  dimensions is padded, vectorizes the rows loop (``_vector_factor``: 2 to
  8 lanes by the row count, lane 0 starting from the running sum, the
  lanes added as a tree, the remainder rows one by one); a dimension
  padded by one element at its end has its last index split off and added
  after the rest of the window.  A leaf with no dimension longer than 32
  fuses its squares: FMAs, in lanes where the rows loop is vectorized (up
  to 4 elements a row; wider rows square apart, then add).  Read from the
  dumps at (64, b) for b up to 8, (26, 63), (67, 63), (64, 30, 5), (32, 7)
  and (5, 2, 5), and from the final reduce of every shape up to (3, 3, 3);
  probed over random shapes of ranks 1 to 3 and dimensions to 300.
  Its operands and products flush subnormals (``ops/ftz.py``), as every
  float program of the round does; a sum of non-negative normal values is
  never tiny, so the adds need no flushing.
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

import numpy as np
import torch

from rayfed_tpu_torch.ops import ftz
from rayfed_tpu_torch.ops.fold import fma, fma_ftz, fma_rows

REDUCE_WINDOW = 32
VECTOR_WIDTH, UNROLL = 8, 2


def _tree_sum(sq: torch.Tensor, add=torch.add) -> torch.Tensor:
    """The sum over the last axis as XLA:CPU's tree reduction computes it,
    each step ``add(acc, x)`` (``ftz.add`` where the program's operands
    and sums may be subnormal)."""
    while sq.shape[-1] > REDUCE_WINDOW:
        n = sq.shape[-1]
        nw = -(-n // REDUCE_WINDOW)
        lo = (nw * REDUCE_WINDOW - n) // 2
        hi = nw * REDUCE_WINDOW - n - lo
        sq = torch.cat([sq.new_zeros(*sq.shape[:-1], lo), sq, sq.new_zeros(*sq.shape[:-1], hi)], dim=-1)
        windows = sq.reshape(*sq.shape[:-1], nw, REDUCE_WINDOW)
        sq = windows.new_zeros(windows.shape[:-1])
        for i in range(REDUCE_WINDOW):
            sq = add(sq, windows[..., i])
    total = sq.new_zeros(sq.shape[:-1])
    for i in range(sq.shape[-1]):
        total = add(total, sq[..., i])
    return total


def _fuses_squares(d: int) -> bool:
    """Whether a jitted program's row sum of ``d`` squares is an FMA chain."""
    return d <= REDUCE_WINDOW and not 5 <= d <= 8


def _fma_sum_sq(xf: torch.Tensor) -> torch.Tensor:
    """``sum(xf², axis=-1)`` as the FMA chain ``fma(x, x, acc)`` from 0.0."""
    total = xf.new_zeros(xf.shape[:-1])
    for i in range(xf.shape[-1]):
        col = xf[..., i].contiguous()
        total = fma(col, col, total)
    return total


def sum_sq(xf: torch.Tensor, jitted: bool) -> torch.Tensor:
    """``sum(xf², axis=-1)`` of a CPU f32 tensor in XLA:CPU's order, inside
    a jitted program (``jitted``) or op by op."""
    if jitted and _fuses_squares(xf.shape[-1]):
        return _fma_sum_sq(xf)
    return _tree_sum(xf * xf)


def _seq_sum(a: np.ndarray, acc=None) -> np.ndarray:
    """The sum over the last axis in index order, from ``acc`` (0.0 when
    None), in f32 (numpy's ``add.accumulate`` is sequential in the array's
    dtype)."""
    if acc is not None:
        a = np.concatenate([np.asarray(acc, np.float32)[..., None], a], axis=-1)
    if a.shape[-1] == 0:
        return np.zeros(a.shape[:-1], np.float32)
    return np.add.accumulate(a, axis=-1, dtype=np.float32)[..., -1]


def _vector_factor(rows: int, inner: int, squares: bool = False) -> int:
    """The lanes LLVM's loop vectorizer gives a reduction's rows loop whose
    ``inner`` elements per row it unrolled (1: not vectorized), read from
    XLA:CPU's programs for every ``rows`` to 32 and ``inner`` to 8 (``squares``:
    the loop squares its elements too): a short loop only when the lanes
    divide it, else the width whose main part and scalar remainder cost
    least."""
    if inner > 8 or rows < 2:
        return 1
    if rows < 16:
        return rows if rows in (2, 4, 8) else 1
    if (inner >= 7 and not squares) or 20 <= rows < 24 or (28 <= rows < 32 and inner > 2):
        return 4
    return 8


def _tree_lanes(lanes: np.ndarray) -> np.ndarray:
    """A vector's horizontal sum (the last axis), halves added pairwise."""
    while lanes.shape[-1] > 1:
        h = lanes.shape[-1] // 2
        lanes = lanes[..., :h] + lanes[..., h:]
    return lanes[..., 0]


def _nest_sum(blocks: np.ndarray, acc: np.ndarray, vectorize: bool) -> np.ndarray:
    """``acc`` plus each block's sum (the leading axis indexes the blocks) as
    XLA's loop nest adds it once LLVM has unrolled the innermost loop:
    outer dimensions in row-major order; with ``vectorize`` and few enough
    elements per row, the rows loop as vector lanes (lane ``l`` adds rows
    ``l``, ``l + vf``, ... from ``acc`` in lane 0, then the lanes add as a
    tree and the remainder rows one by one), else every element in turn."""
    n = blocks.shape[0]
    if blocks.ndim < 3 or not vectorize:
        return _seq_sum(blocks.reshape(n, -1), acc)
    rows, inner = blocks.shape[-2:]
    vf = _vector_factor(rows, inner)
    if vf == 1:
        return _seq_sum(blocks.reshape(n, -1), acc)
    main = rows // vf * vf
    for sub in blocks.reshape(n, -1, rows, inner).transpose(1, 0, 2, 3):
        lanes = np.zeros((n, vf), np.float32)
        lanes[:, 0] = acc
        for r0 in range(0, main, vf):
            for c in range(inner):
                lanes += sub[:, r0 : r0 + vf, c]
        acc = _seq_sum(sub[:, main:].reshape(n, -1), _tree_lanes(lanes))
    return acc


def _window_sums(a: np.ndarray) -> np.ndarray:
    """One level of XLA:CPU's tree reduction rewriter: every dimension
    longer than ``REDUCE_WINDOW`` zero-padded to a multiple of it (half the
    padding, rounded down, before) and cut into windows of it, a shorter one
    one window of its whole length.  The reduce-window's loop nest adds
    each window from 0.0 (:func:`_nest_sum`; the rows loop is vectorized
    only when neither of the two innermost dimensions is padded).  A
    dimension padded by one element at its end (lo 0, hi 1) has its last
    index split off by LLVM: it adds after the rest of the window."""
    pads, split = [], []
    for d in a.shape:
        if d > REDUCE_WINDOW:
            n = -(-d // REDUCE_WINDOW)
            lo = (n * REDUCE_WINDOW - d) // 2
            pads.append((lo, n * REDUCE_WINDOW - d - lo))
            split += [n, REDUCE_WINDOW]
        else:
            pads.append((0, 0))
            split += [1, d]
    rank = a.ndim
    counts = split[0::2]
    blocks = np.pad(a, pads).reshape(split)
    blocks = blocks.transpose([2 * i for i in range(rank)] + [2 * i + 1 for i in range(rank)])
    blocks = blocks.reshape(-1, *split[1::2])
    tail = [k for k, p in enumerate(pads) if p == (0, 1)]
    moved = None
    if tail:
        k = tail[-1]
        moved = np.take(blocks, [REDUCE_WINDOW - 1], axis=k + 1)
        blocks = np.take(blocks, range(REDUCE_WINDOW - 1), axis=k + 1)
    vectorize = rank >= 2 and all(pads[k] in ((0, 0), (0, 1)) for k in (rank - 2, rank - 1))
    vectorize = vectorize and pads[rank - 1] == (0, 0)
    sums = _nest_sum(blocks, np.zeros(blocks.shape[0], np.float32), vectorize)
    if moved is not None:
        sums = _seq_sum(moved.reshape(moved.shape[0], -1), sums)
    return sums.reshape(counts)


def _window_sum_all(a: np.ndarray) -> np.ndarray:
    """A whole-array f32 sum as XLA:CPU compiles it: unit dimensions
    dropped; while any dimension exceeds ``REDUCE_WINDOW``, a level of
    window sums (:func:`_window_sums`); then one reduce of what is left,
    its loop nest as :func:`_nest_sum` adds it."""
    a = a.reshape([d for d in a.shape if d != 1])
    while any(d > REDUCE_WINDOW for d in a.shape):
        a = _window_sums(a)
        a = a.reshape([d for d in a.shape if d != 1])
    return _nest_sum(a[None], np.zeros(1, np.float32), True)[0]


def leaf_sum_sq(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sum(x ** 2)`` over every axis of a CPU f32 tensor, as XLA:CPU
    compiles it inside a jitted program: a leaf with a dimension longer
    than ``REDUCE_WINDOW`` squares, then sums as :func:`_window_sum_all`
    lays it out; a smaller one fuses its squares into the sum, each step
    ``fma(x, x, acc)``, over the loop nest :func:`_nest_sum` describes
    (vector lanes of FMAs where LLVM vectorized the rows loop).  Returns a
    0-d f32 tensor."""
    x = ftz.flush(x.detach().to(torch.float32))
    a = x.numpy()
    if any(d > REDUCE_WINDOW for d in a.shape):
        return torch.from_numpy(np.asarray(_window_sum_all(ftz.mul(x, x).numpy()), np.float32).reshape(()))
    a = torch.from_numpy(np.ascontiguousarray(a).reshape([d for d in a.shape if d != 1]))
    rows, inner = a.shape[-2:] if a.ndim >= 2 else (1, a.numel())
    vf = _vector_factor(rows, inner, squares=True)
    acc = torch.zeros(1, dtype=torch.float32)
    if vf == 1:
        for v in a.reshape(-1, 1):
            acc = fma_ftz(v, v, acc)
        return acc.reshape(())
    main = rows // vf * vf
    for sub in a.reshape(-1, rows, inner):
        lanes = torch.zeros(vf, dtype=torch.float32)
        lanes[0] = acc[0]
        for r0 in range(0, main, vf):
            for c in range(inner):
                col = sub[r0 : r0 + vf, c].contiguous()
                # Up to 4 per row the vector squares contract into the
                # adds; wider rows square apart, then add (but the last
                # column of two rows of 5, which the backend contracts).
                fused = inner <= 4 or (vf, inner, c) == (2, 5, 4)
                lanes = fma_ftz(col, col, lanes) if fused else lanes + ftz.mul(col, col)
        acc = torch.from_numpy(_tree_lanes(lanes.numpy()).reshape(1))
        for v in sub[main:].reshape(-1, 1):
            acc = fma_ftz(v, v, acc)
    return acc.reshape(())


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


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
               jitted: bool = False) -> torch.Tensor:
    """``(x − mean)·rsqrt(var + eps)·scale + bias`` over the last axis of a
    CPU f32 tensor, as XLA:CPU compiles the JAX package's LayerNorm
    (``jnp.mean``, ``jnp.var``) inside a jitted program (``jitted``) or op
    by op.  Both sum rows in the tree order (``_tree_sum``) and take the
    mean as ``sum·f32(1/D)``; the variance sums the squares of ``x −
    mean`` (a separate loop: no FMA).  Op by op the variance divides its
    sum by ``D`` and every later op rounds alone; inside a jitted program
    the division is ``·f32(1/D)`` contracted with ``+ eps`` into one FMA,
    and the affine tail ``t·scale + bias`` into another."""
    d = x.shape[-1]
    inv_d = torch.full((), 1.0 / d, dtype=torch.float32)
    mean = (_tree_sum(x) * inv_d)[..., None]
    c = x - mean
    # ``jnp.var`` is one program even op by op: a row of at most 32 fuses
    # its squares into the sum as an FMA chain, at every such width (unlike
    # the RMSNorm's row, which XLA vectorizes at 5 to 8).
    s = _fma_sum_sq(c) if d <= REDUCE_WINDOW else _tree_sum(c * c)
    if jitted:
        mean_eps = fma(s, inv_d.expand(s.shape).contiguous(), torch.full_like(s, eps))
    else:
        mean_eps = s / d + eps
    t = c * rsqrt(mean_eps)[..., None]
    if not jitted:
        return t * scale + bias
    lead = t.reshape(-1, d)
    out = fma(scale.expand(lead.shape).contiguous(), lead, bias.expand(lead.shape).contiguous())
    return out.reshape(x.shape)


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
        # One FMA an element (a row of one): the fold kernel's rows form on
        # the card, its plain version on the CPU.
        inner.reshape(-1)[n - k : n] = fma_rows(
            zp.reshape(-1)[rows], w.expand(k).reshape(k, 1).contiguous(),
            a.reshape(-1)[n - k : n].reshape(k, 1).contiguous(), negate=True,
        ).reshape(-1)
    return inner
