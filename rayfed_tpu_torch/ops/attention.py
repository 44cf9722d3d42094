"""Reference softmax attention (the port of ``rayfed_tpu/ops/attention.py``).

:func:`dot_product_attention` is the plain O(T²) attention the model uses
by default and the oracle the flash kernel is held against.  Layout is
``[batch, seq, heads, head_dim]`` (BTHD); scores and softmax are float32
whatever the input dtype.  :func:`mha` is the full multi-head block on
top of it.  ``as_attn_fn`` and the blockwise/ring helpers come with the ring
attention slice.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps exp() flushable


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
    q_offset: int = 0,
    kv_offset: int = 0,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Plain softmax attention, BTHD layout.

    ``q_offset``/``kv_offset`` are the global positions of the first query
    / key token (q and k may be shards of a longer sequence).  ``window``
    (requires ``causal``) restricts each query to its last ``window`` keys.
    """
    if window is not None:
        if not causal:
            raise ValueError("window= requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    orig_dtype = q.dtype
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    qf = q.float() * scale
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = kv_offset + torch.arange(k.shape[1], device=q.device)
        visible = q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            visible = visible & (q_pos[:, None] - k_pos[None, :] < window)
        s = torch.where(visible[None, None], s, NEG_INF)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    # Fully-masked rows (every key in the future of a causal shard) give
    # zeros, not the uniform softmax of an all-NEG_INF row.
    p = torch.softmax(s, dim=-1)
    p = torch.where(s.amax(dim=-1, keepdim=True) <= NEG_INF / 2, 0.0, p)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(orig_dtype)


def mha(
    x: torch.Tensor,
    wq: torch.Tensor,
    wk: torch.Tensor,
    wv: torch.Tensor,
    wo: torch.Tensor,
    *,
    num_heads: int,
    causal: bool = False,
    attn_fn=None,
) -> torch.Tensor:
    """Full MHA block: project, attend, merge.  ``x``: [B, T, D_model].

    ``wq/wk/wv``: [D_model, H*Dh]; ``wo``: [H*Dh, D_model].  ``attn_fn``
    swaps in another attention with :func:`dot_product_attention`'s
    signature (the flash kernel's ``flash_attention``).
    """
    b, t, _ = x.shape
    attn_fn = attn_fn or dot_product_attention
    q = (x @ wq).reshape(b, t, num_heads, -1)
    k = (x @ wk).reshape(b, t, num_heads, -1)
    v = (x @ wv).reshape(b, t, num_heads, -1)
    o = attn_fn(q, k, v, causal=causal)
    return o.reshape(b, t, -1) @ wo


def as_attn_fn(sharded, built_causal: bool, built_scale, builder: str):
    """Give a ring or Ulysses ``(q, k, v)`` attention the ``attn_fn`` signature.

    Model code (:func:`mha`, ``apply_llama``) calls ``attn_fn(q, k, v,
    causal=..., sm_scale=...)``; a builder bakes masking and scale in at
    build time, so the wrapper accepts those keywords and rejects
    *conflicting* values instead of ignoring them.
    """

    def apply(q, k, v, *, causal=None, sm_scale=None, mask=None, window=None):
        if mask is not None:
            raise ValueError(f"{builder} attention does not support a dense mask")
        if window is not None:
            # Accepted-then-rejected so LlamaConfig(sliding_window=...) with
            # a ring/Ulysses attn_fn fails with this explanation, not a bare
            # unexpected-keyword TypeError.
            raise ValueError(
                f"{builder} attention does not support sliding-window "
                f"attention (window={window}); drop sliding_window or use "
                f"the flash/dense attention path"
            )
        if causal is not None and bool(causal) != built_causal:
            raise ValueError(
                f"causal={causal} conflicts with the {builder}(...) "
                f"build-time setting causal={built_causal}"
            )
        if sm_scale is not None:
            # An explicit value equal to the effective scale (d**-0.5 when
            # the builder got None) agrees; isclose covers f32 provenance.
            effective = built_scale if built_scale is not None else q.shape[-1] ** -0.5
            if not math.isclose(sm_scale, effective, rel_tol=1e-6):
                raise ValueError(
                    f"sm_scale={sm_scale} conflicts with the {builder}(...) "
                    f"build-time scale {effective}"
                )
        return sharded(q, k, v)

    return apply


def blockwise_accumulate(
    q: torch.Tensor,
    k_blk: torch.Tensor,
    v_blk: torch.Tensor,
    o_acc: torch.Tensor,
    m_acc: torch.Tensor,
    l_acc: torch.Tensor,
    *,
    scale: float,
    q_offset: int,
    kv_offset: int,
    causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One online-softmax step over a K/V block (the flash recurrence).

    State: ``o_acc`` [B,Tq,H,D] un-normalized output, ``m_acc``/``l_acc``
    [B,H,Tq] running row max and normalizer, all float32.  The
    global-position causal mask also handles fully-future blocks (every
    element masked gives a zero contribution through the m/l guards).
    """
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k_blk.float())
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = kv_offset + torch.arange(k_blk.shape[1], device=q.device)
        s = torch.where((q_pos[:, None] >= k_pos[None, :])[None, None], s, NEG_INF)
    m_new = torch.maximum(m_acc, s.amax(dim=-1))
    # exp(NEG_INF - NEG_INF) would be 1 on fully-masked rows; clamp the
    # shift so masked rows contribute exp(NEG_INF - 0) == 0 instead.
    m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
    p = torch.exp(s - m_safe[..., None])
    correction = torch.exp(torch.where(m_acc <= NEG_INF / 2, NEG_INF, m_acc) - m_safe)
    l_new = l_acc * correction + p.sum(dim=-1)
    o_blk = torch.einsum("bhqk,bkhd->bqhd", p, v_blk.float())
    o_new = o_acc * correction.transpose(1, 2)[..., None] + o_blk
    return o_new, m_new, l_new


def blockwise_finalize(o_acc: torch.Tensor, l_acc: torch.Tensor, dtype) -> torch.Tensor:
    """Normalize the accumulated output; fully-masked rows become zeros."""
    l_safe = torch.where(l_acc == 0.0, 1.0, l_acc)
    return (o_acc / l_safe.transpose(1, 2)[..., None]).to(dtype)


def init_blockwise_state(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, tq, h, d = q.shape
    o = torch.zeros((b, tq, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)
    return o, m, l
