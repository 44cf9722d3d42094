"""Flash attention forward: a hand-written Hopper kernel and its plain version.

The port of ``rayfed_tpu/ops/flash_attention.py``.  :func:`flash_attention`
keeps the reference's signature and validation; :func:`_flash_forward` keeps
its ``[BH, T, D] -> (o, lse)`` contract, which the ring-attention slice will
call.  Dispatch is by the tensors' device only:

- CPU tensors run :func:`_flash_forward_reference`, the plain PyTorch
  version (dense f32 scores, the kernel's rounding and masked-row results);
- CUDA tensors launch the kernel in ``csrc/flash_fwd.cu`` or raise.  There
  is no fallback from one to the other.

The backward kernels come with the training slice; until then an input
that needs a gradient raises instead of differentiating the plain version.
"""

from __future__ import annotations

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
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward yet: the backward kernels come "
            "with the training (LoRA fine-tune) slice; run under torch.no_grad() "
            "or use dot_product_attention"
        )
    b, _, h, _ = q.shape
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    o, _ = _flash_forward(
        _bthd_to_bht(q), _bthd_to_bht(k), _bthd_to_bht(v),
        scale=scale, causal=causal, q_offset=int(q_offset),
        kv_offset=int(kv_offset), window=None if window is None else int(window),
    )
    return _bht_to_bthd(o, b, h)


flash_attention.fwd_launches = 0  # CUDA kernel launches, counted in _flash_forward


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
