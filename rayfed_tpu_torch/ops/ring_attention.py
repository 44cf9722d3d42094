"""Ring attention: sequence parallelism over the ``sp`` axis of a party mesh.

The port of ``rayfed_tpu/ops/ring_attention.py``.  Long-context attention
where the sequence is sharded across ranks and K/V shards rotate around
the ring (:func:`rayfed_tpu_torch.parallel.collectives.ppermute`) while
each rank accumulates its queries' attention (Liu et al., Ring Attention
with Blockwise Transformers, 2023).  Three inner-step forms:

- :func:`ring_attention` — the online-softmax recurrence
  (:func:`rayfed_tpu_torch.ops.attention.blockwise_accumulate`), on any
  device; its gradient is autograd's through the differentiable ring shift;
- :func:`ring_flash_attention` — each ring step launches the flash forward
  kernel on the resident K/V block and the per-step ``(o, lse)`` partials
  merge by log-sum-exp (:func:`_merge_partial`); the backward (a
  ``torch.autograd.Function``) rings the blocks a second time, launching
  the dQ and dK/dV kernels per step with the *final* lse and delta, and
  accumulates dK/dV onto buffers that rotate with their block, so each
  block arrives home carrying its whole gradient;
- :func:`zigzag_ring_flash_attention` — the load-balanced causal ring (see
  the note above :func:`_zigzag_flash_fwd_inner`).

On the card every step runs the port's Hopper kernels (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``); on CPU tensors their plain versions.  No new kernel
and no library attention.

The collective forms take this rank's ``[B, T_local, H, D]`` shard and the
``sp`` process group (``mesh.get_group("sp")``); shard *i* holds global
positions ``[i·T_local, (i+1)·T_local)``.  :func:`make_ring_attention`
keeps the reference's global view: ``[B, T, H, D]`` in and out, each rank
taking its shard (or zigzag chunk pair) of the same global tensors and
gathering the output.

Differences the eager host allows (results equal the reference's):

- the rank is a Python int, so causal visibility (``src < my``) is
  decided on the host, and a block the causal mask hides entirely is not
  launched (its rotation still runs); the reference computes it and drops
  it with ``jnp.where``, which exists there only as the NaN guard;
- zigzag picks its gated operands on the host instead of by ``jnp.where``,
  and keeps the low and high halves as separate contiguous buffers, so no
  step copies a strided half;
- the forward starts each rotation before the step's kernel and waits for
  it after, so the transfer of the next block overlaps the kernel.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from rayfed_tpu_torch.ops.attention import (
    as_attn_fn,
    blockwise_accumulate,
    blockwise_finalize,
    init_blockwise_state,
)
from rayfed_tpu_torch.ops.flash_attention import (
    NEG_INF,
    _bht_to_bthd,
    _bthd_to_bht,
    _flash_backward,
    _flash_forward,
    _lse_delta,
)
from rayfed_tpu_torch.parallel import collectives as coll


def _rotate(tensors, group):
    return coll.ppermute_start(tensors, group).wait()


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Collective blockwise ring attention over ``group``.

    ``q``/``k``/``v``: this rank's sequence shard, [B, T_local, H, D].
    Returns the attention output for the local queries, same shape/dtype.
    """
    n, my = dist.get_world_size(group), dist.get_rank(group)
    t_local = q.shape[1]
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    o, m, l = init_blockwise_state(q)
    k_cur, v_cur = k, v
    for step in range(n):
        # Blocks rotate "forward" (rank d hands its block to d+1), so at
        # step i rank d holds the block of rank (d - i) mod n.
        src = (my - step) % n
        o, m, l = blockwise_accumulate(
            q, k_cur, v_cur, o, m, l, scale=scale, q_offset=my * t_local,
            kv_offset=src * t_local, causal=causal,
        )
        if step + 1 < n:
            k_cur, v_cur = coll.ppermute([k_cur, v_cur], group)
    return blockwise_finalize(o, l, q.dtype)


# ---------------------------------------------------------------------------
# Flash-inner ring: the kernels per step, lse-merge across steps
# ---------------------------------------------------------------------------


def _merge_partial(o_acc, lse_acc, o_i, lse_i):
    """Log-sum-exp merge of two *normalized* partial attention results.

    ``o_acc`` f32 [BH, T, D] with normalizer ``lse_acc`` [BH, T]; fully
    absent partials carry ``lse == NEG_INF`` and contribute nothing.
    """
    m = torch.maximum(lse_acc, lse_i)
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    w_acc = torch.exp(torch.where(lse_acc <= NEG_INF / 2, NEG_INF, lse_acc) - m_safe)
    w_i = torch.exp(torch.where(lse_i <= NEG_INF / 2, NEG_INF, lse_i) - m_safe)
    denom = w_acc + w_i
    denom_safe = torch.where(denom == 0.0, 1.0, denom)
    o = o_acc * (w_acc / denom_safe)[..., None] + o_i.float() * (w_i / denom_safe)[..., None]
    return o, m + torch.log(denom_safe)


def _ring_flash_fwd_inner(q, k, v, group, causal, scale):
    """[BH, T, D] ring forward → (o f32, lse f32).

    Step 0 is every rank's own (diagonal) block, the only one that needs
    the kernel's causal mask; a later block is entirely visible (its owner
    sits before this rank) or entirely hidden, and a hidden one is not
    launched.  Partials stay f32 (``out_dtype``) and round once at the end.
    """
    n, my = dist.get_world_size(group), dist.get_rank(group)
    flash = functools.partial(_flash_forward, scale=scale, out_dtype=torch.float32)
    pending = coll.ppermute_start([k, v], group) if n > 1 else None
    o_acc, lse_acc = flash(q, k, v, causal=causal)
    for step in range(1, n):
        k_cur, v_cur = pending.wait()
        if step + 1 < n:
            pending = coll.ppermute_start([k_cur, v_cur], group)
        if causal and (my - step) % n > my:
            continue
        o_i, lse_i = flash(q, k_cur, v_cur, causal=False)
        o_acc, lse_acc = _merge_partial(o_acc, lse_acc, o_i, lse_i)
    return o_acc, lse_acc


def _ring_flash_bwd(q, k, v, out, lse, do, group, causal, scale):
    """Backward ring: K/V make a second full loop, dK/dV ride along.

    Each visible step runs the flash backward kernels (dQ, then dK/dV)
    against the resident block with the *final* lse and delta, hoisted
    once (:func:`_lse_delta`); the dK/dV partials (f32) accumulate onto
    buffers that rotate with their block, and one last hop brings each
    block's gradient home.
    """
    n, my = dist.get_world_size(group), dist.get_rank(group)
    bwd = functools.partial(
        _flash_backward, scale=scale, out_dtype=torch.float32, lse_delta=_lse_delta(out, lse, do)
    )
    dq_acc, dk_cur, dv_cur = bwd(q, k, v, out, lse, do, causal=causal)
    k_cur, v_cur = k, v
    for step in range(1, n):
        k_cur, v_cur, dk_cur, dv_cur = _rotate([k_cur, v_cur, dk_cur, dv_cur], group)
        if causal and (my - step) % n > my:
            continue
        dq_i, dk_i, dv_i = bwd(q, k_cur, v_cur, out, lse, do, causal=False)
        dq_acc += dq_i
        dk_cur += dk_i
        dv_cur += dv_i
    dk_cur, dv_cur = _rotate([dk_cur, dv_cur], group)
    return dq_acc.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    """The flash ring on [BH, T_local, D] with the backward ring as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        o, lse = _ring_flash_fwd_inner(q, k, v, group, causal, scale)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, causal, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        grads = _ring_flash_bwd(q, k, v, out, lse, do.to(out.dtype).contiguous(), *ctx.args)
        return (*grads, None, None, None)


def ring_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Ring attention with the flash kernels as the inner step.

    Same contract as :func:`ring_attention`; each step's block attention
    runs the flash forward kernel and the partials merge by log-sum-exp.
    The kernels tile for themselves, so the reference's ``block_q``,
    ``block_k`` and ``interpret`` have no counterpart.
    """
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    b, _, h, _ = q.shape
    oh = _RingFlash.apply(_bthd_to_bht(q), _bthd_to_bht(k), _bthd_to_bht(v), group, causal, scale)
    return _bht_to_bthd(oh, b, h)


# ---------------------------------------------------------------------------
# Zigzag layout: load-balanced causal ring
# ---------------------------------------------------------------------------
#
# A contiguous causal ring wastes half its steps: a block whose owner sits
# after this rank is entirely hidden.  The zigzag layout (T split into 2n
# chunks; rank d holds chunks (d, 2n−1−d)) balances the causal triangle:
#
#   - (q_lo, kv_hi): the peer's high chunk is always in q_lo's future —
#     no kernel at all;
#   - (q_hi, kv_lo): the peer's low chunk is always in q_hi's past — a
#     full (unmasked) kernel;
#   - (q_lo, kv_lo) is visible iff src < my and (q_hi, kv_hi) iff src > my —
#     exactly one per step, so ONE kernel on the operands the host picks.
#
# Per step every rank runs two half-chunk kernels of useful work: the
# forward launches 2n+1 times per rank (three at step 0, two per later
# step), the backward's dQ and dK/dV kernels 2n+1 times each.


def _halves(x, tc):
    return x[:, :tc].contiguous(), x[:, tc:].contiguous()


def _zigzag_flash_fwd_inner(q, k, v, group, scale):
    """Zigzag forward on (lo, hi) pairs of contiguous [BH, Tc, D] halves →
    ((o_lo, o_hi) f32, (lse_lo, lse_hi))."""
    n, my = dist.get_world_size(group), dist.get_rank(group)
    flash = functools.partial(_flash_forward, scale=scale, out_dtype=torch.float32)
    (q_lo, q_hi), (k_lo, k_hi), (v_lo, v_hi) = q, k, v
    pending = coll.ppermute_start([k_lo, k_hi, v_lo, v_hi], group) if n > 1 else None

    # Step 0: both within-chunk diagonals (causal kernels) plus the
    # always-full (q_hi, kv_lo) block.
    o_lo, lse_lo = flash(q_lo, k_lo, v_lo, causal=True)
    o_hi, lse_hi = flash(q_hi, k_hi, v_hi, causal=True)
    o_hi, lse_hi = _merge_partial(o_hi, lse_hi, *flash(q_hi, k_lo, v_lo, causal=False))
    for step in range(1, n):
        kl, kh, vl, vh = pending.wait()
        if step + 1 < n:
            pending = coll.ppermute_start([kl, kh, vl, vh], group)
        o_hi, lse_hi = _merge_partial(o_hi, lse_hi, *flash(q_hi, kl, vl, causal=False))
        if (my - step) % n < my:
            o_lo, lse_lo = _merge_partial(o_lo, lse_lo, *flash(q_lo, kl, vl, causal=False))
        else:
            o_hi, lse_hi = _merge_partial(o_hi, lse_hi, *flash(q_hi, kh, vh, causal=False))
    return (o_lo, o_hi), (lse_lo, lse_hi)


def _zigzag_flash_bwd(q, k, v, out, lse, do, group, scale):
    """Backward mirrors the forward's block schedule; dK/dV ride the ring.

    ``q, k, v, out, do`` are (lo, hi) pairs of contiguous halves, ``lse``
    likewise."""
    n, my = dist.get_world_size(group), dist.get_rank(group)
    (q_lo, q_hi), (k_lo, k_hi), (v_lo, v_hi) = q, k, v
    (out_lo, out_hi), (lse_lo, lse_hi), (do_lo, do_hi) = out, lse, do
    ld_lo = _lse_delta(out_lo, lse_lo, do_lo)
    ld_hi = _lse_delta(out_hi, lse_hi, do_hi)

    def bwd_lo(kb, vb, causal):
        return _flash_backward(q_lo, kb, vb, out_lo, lse_lo, do_lo, scale=scale, causal=causal,
                               out_dtype=torch.float32, lse_delta=ld_lo)

    def bwd_hi(kb, vb, causal):
        return _flash_backward(q_hi, kb, vb, out_hi, lse_hi, do_hi, scale=scale, causal=causal,
                               out_dtype=torch.float32, lse_delta=ld_hi)

    # Step 0: the two diagonals and the static full block, all local.
    dq_lo, dkl, dvl = bwd_lo(k_lo, v_lo, True)
    dq_hi, dkh, dvh = bwd_hi(k_hi, v_hi, True)
    dq_f, dk_f, dv_f = bwd_hi(k_lo, v_lo, False)
    dq_hi += dq_f
    dkl += dk_f
    dvl += dv_f
    kl, kh, vl, vh = k_lo, k_hi, v_lo, v_hi
    for step in range(1, n):
        kl, kh, vl, vh, dkl, dkh, dvl, dvh = _rotate([kl, kh, vl, vh, dkl, dkh, dvl, dvh], group)
        dq_f, dk_f, dv_f = bwd_hi(kl, vl, False)  # the static full block
        dq_hi += dq_f
        dkl += dk_f
        dvl += dv_f
        if (my - step) % n < my:  # the gated block: (q_lo, kv_lo) ...
            dq_g, dk_g, dv_g = bwd_lo(kl, vl, False)
            dq_lo += dq_g
            dkl += dk_g
            dvl += dv_g
        else:  # ... or (q_hi, kv_hi)
            dq_g, dk_g, dv_g = bwd_hi(kh, vh, False)
            dq_hi += dq_g
            dkh += dk_g
            dvh += dv_g
    dkl, dkh, dvl, dvh = _rotate([dkl, dkh, dvl, dvh], group)
    return dq_lo, dq_hi, dkl, dkh, dvl, dvh


class _ZigzagFlash(torch.autograd.Function):
    """The zigzag ring on [BH, 2·Tc, D] with its backward ring as the gradient."""

    @staticmethod
    def forward(ctx, q, k, v, group, scale):
        tc = q.shape[1] // 2
        q2, k2, v2 = _halves(q, tc), _halves(k, tc), _halves(v, tc)
        (o_lo, o_hi), (lse_lo, lse_hi) = _zigzag_flash_fwd_inner(q2, k2, v2, group, scale)
        out_lo, out_hi = o_lo.to(q.dtype), o_hi.to(q.dtype)
        ctx.save_for_backward(*q2, *k2, *v2, out_lo, out_hi, lse_lo, lse_hi)
        ctx.args = (group, scale, tc, q.dtype)
        return torch.cat([out_lo, out_hi], dim=1)

    @staticmethod
    def backward(ctx, do):
        q_lo, q_hi, k_lo, k_hi, v_lo, v_hi, out_lo, out_hi, lse_lo, lse_hi = ctx.saved_tensors
        group, scale, tc, dtype = ctx.args
        dq_lo, dq_hi, dkl, dkh, dvl, dvh = _zigzag_flash_bwd(
            (q_lo, q_hi), (k_lo, k_hi), (v_lo, v_hi), (out_lo, out_hi), (lse_lo, lse_hi),
            _halves(do.to(dtype), tc), group, scale,
        )
        cat = lambda a, b: torch.cat([a, b], dim=1).to(dtype)  # noqa: E731
        return cat(dq_lo, dq_hi), cat(dkl, dkh), cat(dvl, dvh), None, None


def zigzag_ring_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Collective zigzag causal ring attention over ``group``.

    Shard layout: with 2n chunks of the global sequence, this rank's
    [B, T_local, H, D] block is ``concat(chunk_d, chunk_{2n−1−d})`` —
    :func:`make_ring_attention` with ``layout="zigzag"`` applies the chunk
    permutation on global tensors.  Always causal (a non-causal ring has no
    imbalance to fix).
    """
    if q.shape[1] % 2:
        raise ValueError(
            f"zigzag shards hold a (low, high) chunk pair — T_local "
            f"({q.shape[1]}) must be even"
        )
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    b, _, h, _ = q.shape
    oh = _ZigzagFlash.apply(_bthd_to_bht(q), _bthd_to_bht(k), _bthd_to_bht(v), group, scale)
    return _bht_to_bthd(oh, b, h)


def _zigzag_perm(t: int, n_shards: int):
    """(perm, inv): chunk reorder so contiguous shard d = chunks
    (d, 2n−1−d) of the original sequence."""
    chunks = 2 * n_shards
    if t % chunks:
        raise ValueError(
            f"zigzag layout needs T ({t}) divisible by 2·axis_size ({chunks})"
        )
    tc = t // chunks
    order = []
    for d in range(n_shards):
        order.extend([d, chunks - 1 - d])
    idx = np.concatenate([np.arange(c * tc, (c + 1) * tc) for c in order])
    return idx, np.argsort(idx)


def make_ring_attention(
    mesh,
    seq_axis: str = "sp",
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    use_flash: bool = False,
    layout: str = "contiguous",
):
    """Build a global-view ring attention over ``mesh``'s ``seq_axis``.

    The returned fn maps [B, T, H, D] → [B, T, H, D] (every rank passes the
    same global tensors and gets the whole output back), T split over
    ``seq_axis`` (T must divide evenly).  ``use_flash=True`` runs the flash
    kernels per ring step.  ``layout="zigzag"`` (requires ``causal=True,
    use_flash=True``) balances the causal triangle: each shard holds chunks
    (d, 2n−1−d) of the sequence, applied and undone here by a chunk
    permutation.
    """
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "zigzag" and not (causal and use_flash):
        raise ValueError(
            "layout='zigzag' requires causal=True and use_flash=True "
            "(a non-causal ring has no imbalance to fix)"
        )
    group = mesh.get_group(seq_axis)
    if layout == "zigzag":

        def apply_zigzag(qg, kg, vg):
            idx, inv = (torch.from_numpy(a).to(qg.device)
                        for a in _zigzag_perm(qg.shape[1], dist.get_world_size(group)))
            q, k, v = (coll.local_shard(x.index_select(1, idx), group, 1) for x in (qg, kg, vg))
            out = zigzag_ring_flash_attention(q, k, v, group=group, sm_scale=sm_scale)
            return coll.all_gather(out, group, 1).index_select(1, inv)

        return as_attn_fn(apply_zigzag, causal, sm_scale, "make_ring_attention")
    if use_flash:
        fn = functools.partial(ring_flash_attention, group=group, causal=causal, sm_scale=sm_scale)
    else:
        fn = functools.partial(ring_attention, group=group, causal=causal, sm_scale=sm_scale)

    def apply(qg, kg, vg):
        q, k, v = (coll.local_shard(x, group, 1) for x in (qg, kg, vg))
        return coll.all_gather(fn(q, k, v), group, 1)

    return as_attn_fn(apply, causal, sm_scale, "make_ring_attention")
