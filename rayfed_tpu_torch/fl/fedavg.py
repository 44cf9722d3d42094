"""FedAvg: cross-party weighted parameter averaging.

Multi-controller semantics (every party runs the same line): each party
contributes its local update as a ``FedObject``; :func:`aggregate` fetches
the contributions and averages them.  Packed contributions
(:class:`~rayfed_tpu_torch.fl.compression.PackedTree`) reduce as one chain
over the packed buffers on their device, as XLA compiles the JAX package's
on the CPU: ``fma(w0, x0, w1·x1)``, then one exactly rounded fused
multiply-add per further party, then one divide and one cast (on the card
one launch of the fold kernel's chain form, :mod:`rayfed_tpu_torch.ops.
fold`), so this one-shot fold gives the JAX package's one-shot bytes on the
CPU and on the card.

Integer-code contributions (:class:`~rayfed_tpu_torch.fl.quantize.
QuantizedPackedTree`, the compressed-domain round) fold in i32: per party an
in-place ``acc[off:off+n] += w·q`` on an owned accumulator padded onto the
block grid, exact and associative in any order, then ONE rescale
(:func:`finalize_packed_quantized`), as the JAX package's.  A secure round's
codes are masked on the sender (:func:`masked_code_kernel`) and its dropout
correction subtracted in place (:func:`masked_correction_kernel`), both as
int32 adds on bitcast views of the JAX package's ``uint32`` words.
"""

from __future__ import annotations

import functools
import math
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.fl import compression
from rayfed_tpu_torch.fl.compression import PackedTree, PackSpec
from rayfed_tpu_torch.ops import ftz, xla_cpu
from rayfed_tpu_torch.ops.fold import finalize, fold_chain, fold_fma_, fold_fma_pair

# Elements per block of the canonical chunk grid: one 4 MB bf16 wire chunk.
DEFAULT_CHUNK_ELEMS = 1 << 21

def _check_weights(weights: Sequence[float]) -> float:
    """Validated total of a weight vector.

    An empty, all-zero or non-finite weight vector would divide the
    aggregate by 0 — raise a ValueError naming the problem instead."""
    if len(weights) == 0:
        raise ValueError("weights must be non-empty")
    total = float(sum(float(w) for w in weights))
    if total == 0.0:
        raise ValueError(
            "weights sum to zero (e.g. every party reported 0 examples) "
            "— the weighted average is undefined; drop the round or pass "
            "weights=None for a plain mean"
        )
    if not math.isfinite(total):
        raise ValueError(f"weights sum to a non-finite value ({total})")
    return total


def _f32(leaf: Any) -> Any:
    if isinstance(leaf, torch.Tensor):
        return leaf.to(torch.float32)
    return np.asarray(leaf).astype(np.float32)


def _mean_leaf(*leaves):
    """Mean of one leaf position: floats accumulate in f32 and cast back;
    everything else keeps its library's promoting arithmetic (an int mean
    is a float, never a truncated int)."""
    if compression._is_float_leaf(leaves[0]):
        dt = leaves[0].dtype
        acc = _f32(leaves[0])
        for leaf in leaves[1:]:
            acc = acc + _f32(leaf)
        if isinstance(acc, torch.Tensor):
            # A tensor divisor: on the card a CPU scalar one turns the
            # division into a product with its reciprocal.
            return (acc / f32_scalar(len(leaves), acc.device)).to(dt)
        return (acc / len(leaves)).astype(dt)
    return sum(leaves[1:], start=leaves[0]) / len(leaves)


def tree_weighted_sum(trees: Sequence[Any], weights: Sequence[float]) -> Any:
    """Weighted sum of param pytrees (weights need not be normalized).

    Raises :class:`ValueError` on an empty or zero-sum weight vector.
    """
    total = _check_weights(weights)
    norm = [w / total for w in weights]

    def _leaf(*leaves):
        floating = compression._is_float_leaf(leaves[0])
        acc = _f32(leaves[0]) if floating else leaves[0]
        acc = acc * norm[0]
        for leaf, w in zip(leaves[1:], norm[1:]):
            acc = acc + (_f32(leaf) if floating else leaf) * w
        if not floating:
            return acc
        dt = leaves[0].dtype
        return acc.to(dt) if isinstance(acc, torch.Tensor) else acc.astype(dt)

    return tree_util.tree_map(_leaf, *trees)


def as_tensor(buf: Any, device: Optional[torch.device] = None) -> torch.Tensor:
    """A packed buffer as a tensor: a tensor as it is (on ``device`` when
    given), an ``np.ndarray`` (a JAX party's host buffer) through its bytes
    — bfloat16 needs nothing of numpy that way."""
    if not isinstance(buf, torch.Tensor):
        arr = np.ascontiguousarray(buf)
        dt = compression.torch_dtype(arr.dtype.name)
        raw = torch.from_numpy(arr.reshape(-1).view(np.uint8).copy())
        buf = raw.view(dt).reshape(arr.shape)
    return buf if device is None else buf.to(device)


def _fold_device(bufs: Sequence[Any]) -> torch.device:
    """The device a fold of ``bufs`` runs on: the first tensor's."""
    for b in bufs:
        if isinstance(b, torch.Tensor):
            return b.device
    return torch.device("cpu")


def f32_scalar(value: float, device: torch.device) -> torch.Tensor:
    """``value`` as a 0-d f32 tensor on ``device``, made by a fill kernel
    (no host-to-device copy, so nothing waits for the stream's queue)."""
    return torch.full((), float(np.float32(value)), dtype=torch.float32, device=device)


def _packed_reduce(bufs, weights: Sequence[float], total_w: float, out_dtype) -> torch.Tensor:
    """The one-shot fold as XLA compiles the JAX package's program on the
    CPU: the zero init's add folds away, the first two terms become
    ``fma(w0, x0, w1·x1)`` (the second product rounded, the first fused),
    each further party one more fused multiply-add, rounded once; then the
    finalize's divide and cast (:func:`finalize_packed_stripe`'s bytes).  On
    the card one launch of the fold kernel's chain form does all of it
    (:func:`rayfed_tpu_torch.ops.fold.fold_chain`).  Where a product is
    inexact (f32 wire buffers, fractional weights) this is not the streamed
    fold's order, in the reference as here."""
    device = _fold_device(bufs)
    xs = [as_tensor(b, device).reshape(-1) for b in bufs]
    return fold_chain(xs, weights, total_w, compression.torch_dtype(out_dtype))


def packed_block_grid(total_elems: int, chunk_elems: Optional[int] = None) -> int:
    """Number of blocks in the packed buffer's canonical chunk grid
    (``chunk_elems`` per block, default :data:`DEFAULT_CHUNK_ELEMS`; the
    last block short)."""
    if chunk_elems is None:
        chunk_elems = DEFAULT_CHUNK_ELEMS
    if total_elems < 0:
        raise ValueError(f"total_elems must be >= 0, got {total_elems}")
    return max(1, -(-total_elems // int(chunk_elems)))


def packed_stripe_schedule(nblocks: int, n_stripes: int) -> List[List[int]]:
    """Round-robin assignment of the chunk grid to ``n_stripes`` stripes:
    block ``b`` belongs to stripe ``b % n_stripes`` (a cross-party
    contract, like the wire format)."""
    if n_stripes < 1:
        raise ValueError(f"n_stripes must be >= 1, got {n_stripes}")
    return [list(range(k, nblocks, n_stripes)) for k in range(n_stripes)]


def finalize_packed_stripe(acc: torch.Tensor, total_w: float, total_elems: int, out_dtype):
    """THE packed-aggregate finalize: ``(acc[:n] / total_w).to(out)``, a
    true f32 division with subnormals flushed: on the card one launch of the
    fold kernel's finalize form (:func:`rayfed_tpu_torch.ops.fold.finalize`),
    on the CPU its plain version.
    """
    return finalize(acc[: int(total_elems)], total_w, compression.torch_dtype(out_dtype))


def _packed_result(buf, passthrough, spec: PackSpec, out_name: str) -> PackedTree:
    """Plain (float) PackedTree around a finalized aggregate buffer."""
    if out_name != spec.wire_dtype:
        spec = PackSpec(spec.entries, spec.treedef, out_name)
    return PackedTree(buf, passthrough, spec)


def _reduce_passthrough(passthroughs, weights, total):
    """Average the non-float (passthrough) leaf tuples of N PackedTrees
    with :func:`tree_average`'s per-leaf semantics (shared by the one-shot
    and streaming reduces)."""
    if not passthroughs[0]:
        return ()
    if weights is None:
        return tuple(_mean_leaf(*ls) for ls in zip(*passthroughs))
    norm = [float(x) / total for x in weights]

    def _pt(*leaves):
        acc = leaves[0] * norm[0]
        for leaf, wt in zip(leaves[1:], norm[1:]):
            acc = acc + leaf * wt
        return acc

    return tuple(_pt(*ls) for ls in zip(*passthroughs))


def packed_weighted_sum(
    packed_trees: Sequence[Any],
    weights: Optional[Sequence[float]] = None,
    out_dtype: Any = None,
) -> PackedTree:
    """One reduce over PackedTree contributions on their device.

    The whole model reduces as one chain over the packed buffers — the
    math the streaming path applies chunk by chunk, so the two give the
    same bytes.  Passthrough leaves keep :func:`tree_average`'s per-leaf
    semantics.  ``out_dtype`` defaults to the contributions' wire dtype;
    pass f32 when the aggregate feeds a server optimizer or an
    error-feedback loop.
    """
    from rayfed_tpu_torch.fl.quantize import QuantizedPackedTree

    packeds = list(packed_trees)
    if not packeds:
        raise ValueError("packed_weighted_sum needs at least one tree")
    if any(isinstance(p, QuantizedPackedTree) for p in packeds):
        raise ValueError(
            "packed_weighted_sum got QuantizedPackedTree contributions "
            "— their buffers are integer CODES, not values; fold them "
            "with packed_quantized_sum (the compressed-domain reduce)"
        )
    if not isinstance(packeds[0], PackedTree):
        raise ValueError(
            f"contribution 0 is not a PackedTree "
            f"(got {type(packeds[0]).__name__}) — pack updates with "
            f"fl.compress(tree, packed=True)"
        )
    spec = packeds[0].spec
    for i, p in enumerate(packeds[1:], 1):
        if not isinstance(p, PackedTree) or p.spec != spec:
            raise ValueError(
                f"contribution {i} is not a PackedTree with the same "
                f"spec — all parties must pack the identical structure"
            )
    n = len(packeds)
    if weights is None:
        w = [1.0] * n
        total = float(n)
    else:
        if len(weights) != n:
            raise ValueError(f"{len(weights)} weights for {n} trees")
        total = _check_weights(weights)
        w = [float(x) for x in weights]
    out_name = compression.dtype_name(
        out_dtype if out_dtype is not None else spec.wire_dtype
    )
    buf = _packed_reduce([p.buf for p in packeds], w, total, out_name)
    passthrough = _reduce_passthrough([p.passthrough for p in packeds], weights, total)
    return _packed_result(buf, passthrough, spec, out_name)


# ---------------------------------------------------------------------------
# Compressed-domain (shared-grid integer) aggregation: the aggregator half of
# the fl.quantize codec.  sum_i w_i*x_i == scale_b*(sum_i w_i*q_i - zp_b*W),
# so the fold is an exact i32 multiply-add over the codes and the rescale
# happens ONCE at finalize; streamed and one-shot folds agree in any order.
# ---------------------------------------------------------------------------


def quant_weights(
    weights: Optional[Sequence[float]], n: int
) -> Tuple[List[int], int]:
    """Integer weight vector for the compressed-domain fold.

    The i32 accumulator holds ``sum_i w_i * q_i`` exactly only for
    non-negative **integral** weights (FedAvg example counts are).  Returns
    ``(per-source ints, total)``; raises naming the offending weight
    otherwise.
    """
    if weights is None:
        return [1] * n, n
    if len(weights) != n:
        raise ValueError(f"{len(weights)} weights for {n} sources")
    out: List[int] = []
    for i, w in enumerate(weights):
        f = float(w)
        if not np.isfinite(f) or f < 0 or f != int(f):
            raise ValueError(
                f"compressed-domain aggregation needs non-negative "
                f"integral weights (example counts); weight {i} is "
                f"{w!r} — pre-scale to integers or use the float path"
            )
        out.append(int(f))
    total = sum(out)
    if total == 0:
        raise ValueError(
            "weights sum to zero — the weighted average is undefined"
        )
    return out, total


def quantized_accum_kernel(acc: torch.Tensor, off: int, chunk: torch.Tensor, w: int) -> None:
    """The i32 fold step ``acc[off:off+n] += w * q``, in place on the
    accumulator the caller owns: the integer sibling of the streaming float
    fold (``streaming._fold_block``, same signature).  Integer adds are
    exact, so every fold order gives the same accumulator."""
    acc[off : off + chunk.numel()].add_(chunk.to(torch.int32) * int(w))


def _ring_words(x: Any, device: torch.device) -> torch.Tensor:
    """uint32 words (a host array, or a uint32/int32 tensor) as their int32
    bitcast on ``device``; a host array goes to a card through pinned
    staging."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int32) if x.dtype == torch.uint32 else x
        return x.to(device)
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint32).view(np.int32))
    if device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=torch.int32, pin_memory=True)
    host.copy_(t)
    return host.to(device, non_blocking=True)


def masked_code_kernel(q: torch.Tensor, w: int, net_mask: Any) -> torch.Tensor:
    """The weight-and-mask step of a secure round (``fl.secagg``):
    ``bitcast_i32(u32(w·q) + net_mask)`` over the whole code buffer, on the
    codes' device.  The codes widen to i32 and take the party's own integral
    weight (``|w·q| ≤ qabs_max·W`` is exact in i32); the net mask's uint32
    words are added as their int32 bitcast, the same ring mod 2³².  The
    receiver folds the result with :func:`quantized_accum_kernel` at weight
    1, so once every pair mask met its negative the accumulator holds
    exactly ``Σ w_i·q_i``."""
    v = q.to(torch.int32) * int(w)
    return v.add_(_ring_words(net_mask, v.device).reshape(v.shape))


def masked_correction_kernel(acc: torch.Tensor, corr: Any) -> torch.Tensor:
    """Subtract a dropout round's orphaned-mask correction
    (``fl.secagg.mask_correction``, uint32 words) from the i32 accumulator
    the caller owns, in place, mod 2³²; returns ``acc``."""
    return acc.sub_(_ring_words(corr, acc.device).reshape(acc.shape))


def _quant_reduce(bufs, weights: Sequence[int], nblocks: int, chunk_elems: int,
                  device: torch.device) -> torch.Tensor:
    """One-shot integer reduce into an i32 accumulator padded onto the
    block grid (the shape the streaming fold carries)."""
    acc = torch.zeros(nblocks * chunk_elems, dtype=torch.int32, device=device)
    for b, w in zip(bufs, weights):
        quantized_accum_kernel(acc, 0, as_tensor(b, device).reshape(-1), w)
    return acc


def finalize_packed_quantized(
    acc, scales, zps, total_w: float, total_elems: int,
    chunk_elems: int, out_dtype, ref=None,
):
    """THE compressed-domain finalize: ``[ref +] (scale_b * (acc − zp_b·W))
    / W`` over a block-grid-padded i32 accumulator holding ``sum_i w_i·q_i``,
    on the accumulator's device.

    ``ref`` (delta-coded rounds): the shared reference buffer the codes were
    taken against, ``total_elems`` elements (a tensor or an array).  ``W``
    is an f32 0-d tensor on the accumulator's device, so the divide is a
    true division there too.  Every op flushes subnormals as the JAX
    package's program does (:mod:`rayfed_tpu_torch.ops.ftz`); the grid's
    vectors are read flushed.
    """
    from rayfed_tpu_torch.fl.quantize import _f32_on

    device = acc.device
    if ref is not None:
        ref = _f32_on(ref, device)
        if ref.numel() != int(total_elems):
            raise ValueError(
                f"reference has {ref.numel()} elements, finalize covers "
                f"{total_elems}"
            )
    w = f32_scalar(total_w, device)
    n, ce = int(total_elems), int(chunk_elems)
    a = acc.reshape(-1, ce).to(torch.float32)
    zp = ftz.flush(_f32_on(zps, device)[:, None])
    # An f32 output's a − zp·W as XLA compiles it (fused in its scalar tail);
    # integers both, so exact.
    inner = xla_cpu.sub_scaled(a, zp, w, n) if compression.dtype_name(out_dtype) == "float32" else a - zp * w
    x = ftz.mul(_f32_on(scales, device)[:, None], inner)
    x = ftz.div(x.reshape(-1)[:n], w)
    if ref is not None:
        # Delta-coded rounds: the codes summed to W·(mean delta); the
        # shared reference adds back AFTER the divide.
        x = ftz.add(ref, x)
    return x.to(compression.torch_dtype(out_dtype))


def _server_bufs(*bufs):
    """The operands of the step or the resync as f32 [n] tensors on the
    device of the first tensor among them, never copies of a tensor already
    there in f32."""
    device = _fold_device(bufs)
    return [as_tensor(b, device).reshape(-1).to(torch.float32) for b in bufs]


def _blend(y: torch.Tensor, z: torch.Tensor, beta: float) -> torch.Tensor:
    """``(1−β)·y + β·z`` as XLA:CPU compiles it: ``fma(1−β, y, f32(β·z))``,
    except at ``1−β = β``, where its simplifier factors the shared constant
    out, ``(y + z)·β``."""
    if 1.0 - beta == beta:
        return ftz.mul(ftz.add(y, z), beta)
    return fold_fma_pair(1.0 - beta, y, beta, z)


@functools.lru_cache(maxsize=None)
def server_step_kernel(kind: str, hyper: Tuple[float, ...]):
    """One server-optimization step over packed f32 buffers,
    ``step(x, avg, *state) -> x'``: ``x`` the round's shared starting
    buffer, ``avg`` the finalized aggregate, ``state`` the packed auxiliary
    sequence (:mod:`rayfed_tpu_torch.fl.server_opt`).  Runs on the
    aggregate's device and writes one new buffer: ``avg`` and the state
    are read, never written or aliased by the output.

    The JAX package's program, as XLA:CPU compiles it, contracts the
    multiply-adds; the port computes each contraction as one exactly
    rounded FMA (the fold's forms, :mod:`rayfed_tpu_torch.ops.fold`: ``fma``
    on CPU tensors, ``csrc/fold_fma.cu`` on the card), so the bytes are the
    reference's on the CPU and the same on the card, subnormals flushed as
    it flushes them (:mod:`rayfed_tpu_torch.ops.ftz`).  With ``Δ = x − avg``:

    - ``"momentum"`` ``(lr, momentum)``: ``fma(−lr, fma(momentum, m, Δ),
      x)``; ``lr=1, momentum=0`` returns ``avg`` itself (plain FedAvg).
    - ``"fedac"`` ``(lam, gamma, beta)``: ``fma(1−β, fma(−λ, Δ, x),
      f32(β·fma(−γ, Δ, z)))`` (``(y' + z')·β`` at ``1−β = β``, where XLA
      factors the constant out); ``lam=1, beta=0`` returns ``avg`` itself.

    The state advances only through :func:`server_resync_kernel`.
    """
    if kind == "momentum":
        lr, momentum = (float(h) for h in hyper)

        def _step(x, avg, m):
            avg, x, m = _server_bufs(avg, x, m)
            if momentum == 0.0 and lr == 1.0:
                return avg  # plain FedAvg, bit-exactly
            t = ftz.sub(x, avg)
            fold_fma_(t, momentum, m)
            return fold_fma_pair(-lr, t, 1.0, x)

        return _step
    if kind == "fedac":
        lam, gamma, beta = (float(h) for h in hyper)

        def _step(x, avg, z):
            avg, x, z = _server_bufs(avg, x, z)
            if beta == 0.0 and lam == 1.0:
                return avg  # plain FedAvg, bit-exactly
            delta = ftz.sub(x, avg)
            y_new = fold_fma_pair(-lam, delta, 1.0, x)
            z_new = fold_fma_pair(-gamma, delta, 1.0, z)
            return _blend(y_new, z_new, beta)

        return _step
    raise ValueError(
        f"unknown server-opt kind {kind!r} — one of 'momentum', 'fedac'"
    )


@functools.lru_cache(maxsize=None)
def server_resync_kernel(kind: str, hyper: Tuple[float, ...]):
    """Advance the packed server-opt state from the round's broadcast pair,
    ``resync(x, x_new, *state) -> new state tuple``: a function of buffers
    every controller already holds byte for byte, so every replica of the
    state stays byte-identical.  New buffers, on ``x_new``'s device; the
    old state is not written.

    - ``"momentum"``: ``m' = (x − x_new)·f32(1/lr)``, the step the
      broadcast realized.
    - ``"fedac"``: ``z' = fma(−c, fma(1−β, x, f32(β·z)) − x_new, z)`` with
      ``c = f32(γ/D)`` and ``D = (1−β)·λ + β·γ``, the reference's
      ``z − (γ/D)·((1−β)·x + β·z − x_new)`` as XLA:CPU contracts it; at
      ``1−β = β`` its simplifier factors the constant out first, and the
      inner term is ``fma(β, x + z, −x_new)``.
    """
    if kind == "momentum":
        lr, _momentum = (float(h) for h in hyper)

        def _resync(x, x_new, m):
            del m  # replaced wholesale by the realized step
            x_new, x = _server_bufs(x_new, x)
            inv_lr = 1.0 / f32_scalar(lr, x.device)
            return (ftz.mul(ftz.sub(x, x_new), inv_lr),)

        return _resync
    if kind == "fedac":
        lam, gamma, beta = (float(h) for h in hyper)
        denom = (1.0 - beta) * lam + beta * gamma

        def _resync(x, x_new, z):
            x_new, x, z = _server_bufs(x_new, x, z)
            if 1.0 - beta == beta:
                # Factored as in the step, then contracted with − x_new.
                inner = fold_fma_pair(beta, ftz.add(x, z), -1.0, x_new)
            else:
                inner = ftz.sub(fold_fma_pair(1.0 - beta, x, beta, z), x_new)
            return (fold_fma_pair(-(gamma / denom), inner, 1.0, z),)

        return _resync
    raise ValueError(
        f"unknown server-opt kind {kind!r} — one of 'momentum', 'fedac'"
    )


def packed_quantized_sum(
    quantized_trees: Sequence[Any],
    weights: Optional[Sequence[float]] = None,
    out_dtype: Any = None,
    ref: Any = None,
):
    """The one-shot compressed-domain reduce over QuantizedPackedTree
    contributions sharing one grid: the reference every streamed integer
    fold equals byte for byte.

    ``ref``: the shared reference buffer of delta-coded contributions.
    ``out_dtype`` defaults to **float32**.  Runs on the device of the first
    tensor among the code buffers and ``ref`` (host codes and a host
    reference: the CPU).
    """
    from rayfed_tpu_torch.fl.quantize import QuantizedPackedTree, _check_ref, _device_of

    packeds = list(quantized_trees)
    if not packeds:
        raise ValueError("packed_quantized_sum needs at least one tree")
    for i, p in enumerate(packeds):
        if not isinstance(p, QuantizedPackedTree):
            raise ValueError(
                f"contribution {i} is not a QuantizedPackedTree (got "
                f"{type(p).__name__}) — quantize with "
                f"fl.quantize.quantize_packed(tree, grid)"
            )
    gmeta = packeds[0].gmeta
    spec = packeds[0].spec
    for i, p in enumerate(packeds[1:], 1):
        if p.gmeta != gmeta or p.spec != spec:
            raise ValueError(
                f"contribution {i} was coded on a different grid "
                f"(fp={p.gmeta.fp:#010x} vs {gmeta.fp:#010x}) — all "
                f"parties must quantize onto the round's shared grid"
            )
    n = len(packeds)
    iw, itotal = quant_weights(weights, n)
    grid = packeds[0].grid()
    grid.check_weight_headroom(itotal)
    ref = _check_ref(grid, ref)
    nblocks = packed_block_grid(gmeta.total_elems, gmeta.chunk_elems)
    device = _device_of(*(p.buf for p in packeds), ref)
    acc = _quant_reduce([p.buf for p in packeds], iw, nblocks, gmeta.chunk_elems, device)
    total_w = float(itotal)
    out_name = compression.dtype_name(out_dtype if out_dtype is not None else torch.float32)
    buf = finalize_packed_quantized(
        acc, grid.scales, grid.zps, total_w, gmeta.total_elems,
        gmeta.chunk_elems, out_name, ref=ref,
    )
    passthrough = _reduce_passthrough(
        [p.passthrough for p in packeds],
        None if weights is None else list(weights),
        total_w,
    )
    return _packed_result(buf, passthrough, spec, out_name)


def tree_average(trees: Sequence[Any], weights: Optional[Sequence[float]] = None):
    """Mean (or example-count-weighted mean) of param pytrees.

    PackedTree contributions with a shared spec take the one-chain reduce
    (:func:`packed_weighted_sum`); abs-coded QuantizedPackedTrees the
    integer one (:func:`packed_quantized_sum`).
    """
    from rayfed_tpu_torch.fl.quantize import QuantizedPackedTree

    trees = list(trees)
    if not trees:
        raise ValueError("tree_average needs at least one tree")
    if weights is not None and len(weights) != len(trees):
        raise ValueError(f"{len(weights)} weights for {len(trees)} trees")
    if all(isinstance(t, QuantizedPackedTree) for t in trees):
        if trees[0].gmeta.mode != "abs":
            # Delta codes mean something only against the round's shared
            # reference, which this signature cannot carry.
            raise ValueError(
                "tree_average cannot fold delta-coded "
                "QuantizedPackedTree contributions (the codes are "
                "relative to the round's shared reference) — call "
                "packed_quantized_sum(trees, weights, ref=<shared "
                "reference buffer>) directly"
            )
        return packed_quantized_sum(trees, weights)
    if all(isinstance(t, PackedTree) for t in trees) and all(
        t.spec == trees[0].spec for t in trees[1:]
    ):
        return packed_weighted_sum(trees, weights)
    if weights is None:
        return tree_util.tree_map(_mean_leaf, *trees)
    return tree_weighted_sum(trees, tuple(float(w) for w in weights))


def aggregate(
    fed_objects: Sequence[Any],
    weights: Optional[Sequence[float]] = None,
    *,
    mode: str = "auto",
    coordinator: Optional[str] = None,
    materialize: bool = True,
    reducer: Optional[Any] = None,
):
    """FedAvg round: fetch every party's update and reduce (mean by default).

    Every party calls this with the same list at the same point in the
    program, so all parties return the identical averaged tree.

    ``mode``: ``"all_to_all"`` (every owner pushes to every peer, each
    party averages locally), ``"coordinator"`` (contributions go to one
    party — default the owner of ``fed_objects[0]`` — which averages and
    broadcasts) or ``"auto"`` (coordinator when more than two objects or
    ``materialize=False``).  ``materialize=False`` (coordinator only)
    returns the average as a FedObject, so consecutive rounds pipeline.
    ``reducer(values) -> tree`` replaces the mean (exclusive with
    ``weights``).
    """
    import rayfed_tpu_torch as fed

    if reducer is not None and weights is not None:
        raise ValueError(
            "reducer and weights are mutually exclusive (a custom "
            "reducer defines its own weighting)"
        )

    objs = list(fed_objects)
    if mode == "auto":
        mode = "coordinator" if len(objs) > 2 or not materialize else "all_to_all"
    if mode == "all_to_all":
        if not materialize:
            raise ValueError(
                'materialize=False requires mode="coordinator" (all_to_all '
                "averages locally, which must fetch the contributions)"
            )
        values = fed.get(objs)
        if reducer is not None:
            return reducer(values)
        return tree_average(values, weights)
    if mode != "coordinator":
        raise ValueError(f"unknown aggregate mode {mode!r}")

    coord = coordinator or objs[0].get_party()
    w = None if weights is None else tuple(float(x) for x in weights)

    def _reduce(*trees):
        if reducer is not None:
            return reducer(list(trees))
        return tree_average(trees, w)

    avg_obj = fed.remote(_reduce).party(coord).remote(*objs)
    if not materialize:
        return avg_obj
    return fed.get(avg_obj)


class FedAvgActorBase:
    """Template for a party-local training actor (wrap with ``@fed.remote``).

    Holds params (+ optional extra state) on its device between rounds;
    subclass or compose with a concrete ``train_step``.
    """

    def __init__(self, params: Any):
        self._params = params

    def get_params(self) -> Any:
        return self._params

    def set_params(self, params: Any) -> None:
        self._params = params

    def train_local(self, step_fn, batches) -> Any:
        """Run ``step_fn(params, *batch) -> (params, loss)`` over batches."""
        loss = None
        for batch in batches:
            self._params, loss = step_fn(self._params, *batch)
        return self._params, loss
