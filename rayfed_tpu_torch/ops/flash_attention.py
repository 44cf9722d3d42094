"""Flash attention: hand-written Hopper kernels and their plain versions.

The port of ``rayfed_tpu/ops/flash_attention.py``.  :func:`flash_attention`
keeps the reference's signature and validation and is differentiable (a
``torch.autograd.Function`` in place of the reference's ``jax.custom_vjp``).
:func:`_flash_forward` keeps the ``[BH, T, D] -> (o, lse)`` contract and
:func:`_flash_backward` the ``-> (dq, dk, dv)`` one, both of which the
ring-attention slice will call.  Dispatch is by the tensors' device only:

- CPU tensors run :func:`_flash_forward_reference` and
  :func:`_flash_backward_reference`, the plain PyTorch versions (dense f32
  scores, the kernels' rounding and masked-row results);
- CUDA tensors launch the kernels in ``csrc/flash_fwd.cu`` and
  ``csrc/flash_bwd.cu`` or raise.  There is no fallback from one to the
  other.

On the card the dtype picks the kernel, by a fixed rule: bf16 inputs run
all three kernels (the forward, dQ and dK/dV) on the tensor cores (wgmma fed
by TMA, so q, k, v and dO must be 16-byte aligned), f32 inputs run all three
on the CUDA cores in f32 (tensor cores would break the f32 tolerance).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

NEG_INF = -1e30
HEAD_DIMS = (64, 128)  # head dims the CUDA kernel is instantiated for
_DTYPES = (torch.float32, torch.bfloat16)


def _flash_forward_reference(
    q, k, v, *, scale, causal, q_offset=0, kv_offset=0, out_dtype=None,
    window=None,
):
    """Plain version of the kernel on ``[BH, T, D]``: ``(o, lse)``.

    Dense f32 scores, scaled after the dot; p is rounded to v's dtype before
    the P·V product, as in the kernel.  A row that sees no key gives o = 0
    and lse = NEG_INF + log(1e-37) (== NEG_INF in f32).
    """
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = kv_offset + torch.arange(k.shape[1], device=q.device)
        visible = q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            visible = visible & (q_pos[:, None] - k_pos[None, :] < window)
        s = torch.where(visible, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    o = o / torch.where(l == 0.0, 1.0, l)
    lse = m + torch.log(torch.clamp(l, min=1e-37))
    return o.to(out_dtype or q.dtype), lse[..., 0]


def _check_tma_aligned(*tensors):
    """TMA reads a bf16 tensor from a 16-byte-aligned base; raise otherwise."""
    for x in tensors:
        if x.dtype == torch.bfloat16 and x.data_ptr() % 16:
            raise ValueError(
                f"the bf16 kernels read through TMA and need 16-byte-aligned "
                f"tensors; got one at address {x.data_ptr():#x} (pass a fresh "
                f"contiguous copy)"
            )


def _hopper_probe(a, b, v, p):
    """Known-answer probe of the bf16 kernels' building blocks, on the card.

    ``a``: bf16 ``[2, t_a, D]``; ``b``, ``v``: ``[1, N, D]``; ``p``:
    ``[64, N]``; D, N in {64, 128}.  One warpgroup TMA-loads the first 64
    rows of head 1 of ``a`` (rows past ``t_a`` read as zeros) and head 0 of
    ``b`` and ``v``, then returns ``(s, o, a_tile)``: ``s = A·Bᵀ`` (f32
    ``[64, N]``, wgmma with both operands from shared memory), ``o = P·V``
    (f32 ``[64, D]``, wgmma with P from registers and V transposed in shared
    memory) and the A tile read back through the 128-byte swizzle (bf16
    ``[64, D]``).  Not a launch of the main path: it counts nothing.
    """
    from rayfed_tpu_torch.ops._build import flash_fwd_lib

    d, n = a.shape[-1], b.shape[1]
    if not (a.ndim == 3 and a.shape[0] == 2 and 0 < a.shape[1] and d in HEAD_DIMS
            and n in (64, 128) and b.shape == v.shape == (1, n, d) and p.shape == (64, n)):
        raise ValueError(
            f"probe shapes: a [2, t, D], b and v [1, N, D], p [64, N] with D and N "
            f"in (64, 128); got {[tuple(x.shape) for x in (a, b, v, p)]}"
        )
    if any(x.dtype != torch.bfloat16 or x.device.type != "cuda" for x in (a, b, v, p)):
        raise TypeError("the probe takes bf16 CUDA tensors")
    a, b, v, p = (x.contiguous() for x in (a, b, v, p))
    _check_tma_aligned(a, b, v, p)
    s = torch.empty((64, n), dtype=torch.float32, device=a.device)
    o = torch.empty((64, d), dtype=torch.float32, device=a.device)
    a_tile = torch.empty((64, d), dtype=torch.bfloat16, device=a.device)
    lib = flash_fwd_lib()
    err = lib.rf_hopper_probe(
        a.data_ptr(), b.data_ptr(), v.data_ptr(), p.data_ptr(), s.data_ptr(),
        o.data_ptr(), a_tile.data_ptr(), a.device.index, a.shape[1], d, n,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"hopper probe failed: {lib.rf_cuda_error_string(err).decode()}")
    return s, o, a_tile


def _flash_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool,
    q_offset: int = 0,
    kv_offset: int = 0,
    out_dtype: Optional[torch.dtype] = None,
    window: Optional[int] = None,
):
    """Flash forward on ``[BH, T, D]`` inputs; returns ``(o, lse)``.

    ``o`` is ``[BH, Tq, D]`` in q's dtype or ``out_dtype`` (f32 for ring
    callers); ``lse`` is ``[BH, Tq]`` f32.  Any sequence length works: the
    kernel masks the ragged edge itself.
    """
    if q.device.type == "cpu":
        return _flash_forward_reference(
            q, k, v, scale=scale, causal=causal, q_offset=q_offset,
            kv_offset=kv_offset, out_dtype=out_dtype, window=window,
        )
    if q.device.type != "cuda":
        raise RuntimeError(f"flash attention runs on cpu or cuda, not {q.device}")
    bh, t_q, d = q.shape
    t_k = k.shape[1]
    out_dtype = out_dtype or q.dtype
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must lie on one device")
    if q.dtype not in _DTYPES or not (k.dtype == v.dtype == q.dtype):
        raise TypeError(
            f"the CUDA kernel takes q, k, v all float32 or all bfloat16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if out_dtype not in (q.dtype, torch.float32):
        raise TypeError(f"out_dtype must be {q.dtype} or float32, got {out_dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not supported; the kernel takes {HEAD_DIMS}")
    if k.shape != (bh, t_k, d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    o = torch.empty((bh, t_q, d), dtype=out_dtype, device=q.device)
    lse = torch.empty((bh, t_q), dtype=torch.float32, device=q.device)
    if bh == 0 or t_q == 0:
        return o, lse
    if t_k == 0:
        raise ValueError("flash attention needs at least one key")
    from rayfed_tpu_torch.ops._build import flash_fwd_lib

    lib = flash_fwd_lib()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_tma_aligned(q, k, v)
    err = lib.rf_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        q.device.index,
        bh, t_q, t_k, d,
        int(q.dtype == torch.bfloat16), int(out_dtype == torch.float32),
        float(scale), int(causal), int(q_offset), int(kv_offset),
        0 if window is None else int(window),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"flash_fwd launch failed: {lib.rf_cuda_error_string(err).decode()}"
        )
    flash_attention.fwd_launches += 1
    return o, lse


def _lse_delta(o, lse, do):
    """``(lse, delta)`` for the backward: ``delta = rowsum(dO ∘ O)`` in f32.

    Both depend only on (o, lse, do), so ring callers compute them once and
    pass them to every :func:`_flash_backward` call as ``lse_delta``.  The
    reference broadcasts both to 128 lanes for the TPU's (8, 128) tiling;
    here they stay ``[BH, Tq]``.
    """
    delta = (do.float() * o.float()).sum(dim=-1)
    return lse, delta


def _bwd_p_ds(q, k, v, do, lse, delta, *, scale, causal, q_offset, kv_offset, window):
    """``P = exp(s − lse)`` (zero where masked) and ``dS = P∘(dP − δ)``, in f32,
    as each backward kernel recomputes them."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = kv_offset + torch.arange(k.shape[1], device=q.device)
        visible = q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            visible = visible & (q_pos[:, None] - k_pos[None, :] < window)
        p = torch.where(visible, p, 0.0)
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def _flash_bwd_dq_reference(
    q, k, v, do, lse, delta, *, scale, causal, q_offset=0, kv_offset=0,
    window=None, out_dtype=None,
):
    """Plain version of the dQ kernel: ``dQ = scale·dS·K``, dS rounded to K's dtype."""
    _, ds = _bwd_p_ds(q, k, v, do, lse, delta, scale=scale, causal=causal,
                      q_offset=q_offset, kv_offset=kv_offset, window=window)
    dq = torch.einsum("bqk,bkd->bqd", ds.to(k.dtype).float(), k.float()) * scale
    return dq.to(out_dtype or q.dtype)


def _flash_bwd_dkv_reference(
    q, k, v, do, lse, delta, *, scale, causal, q_offset=0, kv_offset=0,
    window=None, out_dtype=None,
):
    """Plain version of the dK/dV kernel: ``dK = scale·dSᵀ·Q`` (dS rounded to
    Q's dtype) and ``dV = Pᵀ·dO`` (P rounded to dO's dtype)."""
    p, ds = _bwd_p_ds(q, k, v, do, lse, delta, scale=scale, causal=causal,
                      q_offset=q_offset, kv_offset=kv_offset, window=window)
    dk = torch.einsum("bqk,bqd->bkd", ds.to(q.dtype).float(), q.float()) * scale
    dv = torch.einsum("bqk,bqd->bkd", p.to(do.dtype).float(), do.float())
    return dk.to(out_dtype or k.dtype), dv.to(out_dtype or v.dtype)


def _flash_backward_reference(
    q, k, v, o, lse, do, *, scale, causal, q_offset=0, kv_offset=0,
    window=None, out_dtype=None, lse_delta=None,
):
    """Plain version of the backward kernels on ``[BH, T, D]``: ``(dq, dk, dv)``.

    Repeats the kernels' rounding: f32 scores scaled after the dot;
    ``P = exp(s − lse)``, zero where the pair is masked; P rounded to dO's
    dtype before Pᵀ·dO; ``dS = P∘(dP − δ)`` in f32, rounded to K's/Q's dtype
    before dS·K and dSᵀ·Q; ``scale`` applied at the end to dQ and dK only.
    """
    lse, delta = lse_delta if lse_delta is not None else _lse_delta(o, lse, do)
    kw = dict(scale=scale, causal=causal, q_offset=q_offset, kv_offset=kv_offset,
              window=window, out_dtype=out_dtype)
    dq = _flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw)
    return (dq, *_flash_bwd_dkv_reference(q, k, v, do, lse, delta, **kw))


def _bwd_launch(name, inputs, outputs, *, scale, causal, q_offset=0, kv_offset=0,
                window=None):
    """Launch ``rf_<name>`` of ``csrc/flash_bwd.cu`` on contiguous CUDA tensors
    ``inputs = (q, k, v, do, lse, delta)``; raise if the launch fails."""
    from rayfed_tpu_torch.ops._build import flash_bwd_lib

    q, k = inputs[0], inputs[1]
    bh, t_q, d = q.shape
    lib = flash_bwd_lib()
    err = getattr(lib, f"rf_{name}")(
        *(x.data_ptr() for x in inputs), *(x.data_ptr() for x in outputs),
        q.device.index, bh, t_q, k.shape[1], d,
        int(q.dtype == torch.bfloat16), int(outputs[0].dtype == torch.float32),
        float(scale), int(causal), int(q_offset), int(kv_offset),
        0 if window is None else int(window),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.rf_cuda_error_string(err).decode()}")


def _flash_bwd_dq(q, k, v, do, lse, delta, *, out_dtype=None, **kw):
    """The dQ kernel on checked, contiguous CUDA inputs (see :func:`_flash_backward`)."""
    _check_tma_aligned(q, k, v, do)
    dq = torch.empty(q.shape, dtype=out_dtype or q.dtype, device=q.device)
    _bwd_launch("flash_bwd_dq", (q, k, v, do, lse, delta), (dq,), **kw)
    flash_attention.bwd_dq_launches += 1
    return dq


def _flash_bwd_dkv(q, k, v, do, lse, delta, *, out_dtype=None, **kw):
    """The dK/dV kernel on checked, contiguous CUDA inputs."""
    _check_tma_aligned(q, k, v, do)
    dk = torch.empty(k.shape, dtype=out_dtype or k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=out_dtype or v.dtype, device=v.device)
    _bwd_launch("flash_bwd_dkv", (q, k, v, do, lse, delta), (dk, dv), **kw)
    flash_attention.bwd_dkv_launches += 1
    return dk, dv


def _flash_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    scale: float,
    causal: bool,
    q_offset: int = 0,
    kv_offset: int = 0,
    window: Optional[int] = None,
    out_dtype: Optional[torch.dtype] = None,
    lse_delta=None,
):
    """Flash backward on ``[BH, T, D]`` inputs; returns ``(dq, dk, dv)``.

    ``o``/``lse`` are :func:`_flash_forward`'s outputs and ``do`` the
    gradient of ``o``.  ``lse_delta`` (from :func:`_lse_delta`) reuses
    ``(lse, delta)`` across calls that share (o, lse, do); ``out_dtype``
    (f32 for ring callers) overrides the gradients' dtype.  On the card two
    kernels run, dQ and then dK/dV, with no atomics: the gradients are
    deterministic.
    """
    kw = dict(scale=scale, causal=causal, q_offset=q_offset, kv_offset=kv_offset,
              window=window)
    if q.device.type == "cpu":
        return _flash_backward_reference(
            q, k, v, o, lse, do, out_dtype=out_dtype, lse_delta=lse_delta, **kw
        )
    if q.device.type != "cuda":
        raise RuntimeError(f"flash attention runs on cpu or cuda, not {q.device}")
    bh, t_q, d = q.shape
    t_k = k.shape[1]
    out_dtype = out_dtype or q.dtype
    if not all(x.device == q.device for x in (k, v, o, do)):
        raise ValueError("q, k, v, o and do must lie on one device")
    if q.dtype not in _DTYPES or not (k.dtype == v.dtype == do.dtype == q.dtype):
        raise TypeError(
            f"the CUDA kernels take q, k, v, do all float32 or all bfloat16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}, {do.dtype}"
        )
    if out_dtype not in (q.dtype, torch.float32):
        raise TypeError(f"out_dtype must be {q.dtype} or float32, got {out_dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not supported; the kernels take {HEAD_DIMS}")
    if k.shape != (bh, t_k, d) or v.shape != k.shape or do.shape != q.shape:
        raise ValueError(
            f"k/v/do shapes {tuple(k.shape)}, {tuple(v.shape)}, {tuple(do.shape)} "
            f"do not fit q {tuple(q.shape)}"
        )
    lse, delta = lse_delta if lse_delta is not None else _lse_delta(o, lse, do)
    if lse.shape != (bh, t_q) or delta.shape != (bh, t_q):
        raise ValueError(
            f"lse/delta must be [{bh}, {t_q}], got {tuple(lse.shape)}, {tuple(delta.shape)}"
        )
    if t_k == 0 and bh and t_q:
        raise ValueError("flash attention needs at least one key")
    if bh == 0 or t_q == 0 or t_k == 0:  # nothing to launch; no query sees a key
        zeros = functools.partial(torch.zeros, dtype=out_dtype, device=q.device)
        return zeros(q.shape), zeros(k.shape), zeros(v.shape)
    inputs = (q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous(),
              lse.float().contiguous(), delta.float().contiguous())
    dq = _flash_bwd_dq(*inputs, out_dtype=out_dtype, **kw)
    return (dq, *_flash_bwd_dkv(*inputs, out_dtype=out_dtype, **kw))


def _bthd_to_bht(x):  # [B,T,H,D] -> [B*H, T, D]
    b, t, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, t, d)


def _bht_to_bthd(x, b, h):  # [B*H, T, D] -> [B,T,H,D]
    bh, t, d = x.shape
    return x.reshape(b, h, t, d).transpose(1, 2)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    block_q: int = 1024,
    block_k: int = 1024,
    q_offset: int = 0,
    kv_offset: int = 0,
    mask: Optional[torch.Tensor] = None,
    interpret: Optional[bool] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Tiled flash attention, BTHD layout — drop-in for
    :func:`rayfed_tpu_torch.ops.attention.dot_product_attention`.

    ``q_offset``/``kv_offset`` are the global positions of the first q/kv
    token.  A dense ``mask`` is not supported (use ``dot_product_attention``).
    ``window`` (requires ``causal=True``): query q sees keys in
    ``(q − window, q]``; kv tiles outside the band are skipped.

    ``block_q``, ``block_k`` and ``interpret`` are accepted for drop-in
    parity with the TPU version and are ignored: on the card the kernel's
    tiles are its own, and on the CPU the plain version runs.
    """
    if mask is not None:
        raise ValueError(
            "flash_attention does not support a dense mask; use "
            "dot_product_attention (or causal=True with offsets)"
        )
    if window is not None:
        if not causal:
            raise ValueError("window= requires causal=True (Mistral SWA)")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    return _FlashBTHD.apply(
        q, k, v, scale, causal, int(q_offset), int(kv_offset),
        None if window is None else int(window),
    )


class _FlashBTHD(torch.autograd.Function):
    """Flash attention on BTHD tensors with the flash backward as its gradient.

    Forward saves the ``[BH, T, D]`` q, k, v, o and lse; backward runs
    :func:`_flash_backward` on them and maps the gradients back to BTHD.
    """

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, q_offset, kv_offset, window):
        b, _, h, _ = q.shape
        q_, k_, v_ = _bthd_to_bht(q), _bthd_to_bht(k), _bthd_to_bht(v)
        o, lse = _flash_forward(
            q_, k_, v_, scale=scale, causal=causal, q_offset=q_offset,
            kv_offset=kv_offset, window=window,
        )
        ctx.save_for_backward(q_, k_, v_, o, lse)
        ctx.attrs = (b, h, scale, causal, q_offset, kv_offset, window)
        return _bht_to_bthd(o, b, h)

    @staticmethod
    def backward(ctx, g):
        q_, k_, v_, o, lse = ctx.saved_tensors
        b, h, scale, causal, q_offset, kv_offset, window = ctx.attrs
        dq, dk, dv = _flash_backward(
            q_, k_, v_, o, lse, _bthd_to_bht(g.to(o.dtype)), scale=scale,
            causal=causal, q_offset=q_offset, kv_offset=kv_offset, window=window,
        )
        grads = (_bht_to_bthd(x, b, h) for x in (dq, dk, dv))
        return (*grads, None, None, None, None, None)


# CUDA kernel launches, counted where each kernel is launched.
flash_attention.fwd_launches = 0
flash_attention.bwd_dq_launches = 0
flash_attention.bwd_dkv_launches = 0


def _fit_block(t: int, want: int) -> int:
    """Largest block <= want that divides t (8-aligned when possible).

    The TPU kernel's tiling rule, kept for the ring-attention slice's callers;
    the CUDA kernel masks ragged tiles and needs no divisor.
    """
    b = min(want, t)
    while b > 8 and (t % b or b % 8):
        b -= 8
    if t % b == 0:
        return b
    while b > 1 and t % b:
        b -= 1
    return max(b, 1)
