"""Reference softmax attention (the port of ``rayfed_tpu/ops/attention.py``).

:func:`dot_product_attention` is the plain O(T²) attention the model uses
by default and the oracle the flash kernel is held against.  Layout is
``[batch, seq, heads, head_dim]`` (BTHD); scores and softmax are float32
whatever the input dtype.  :func:`mha` is the full multi-head block on
top of it.  ``as_attn_fn`` and the blockwise/ring helpers come with the ring
attention slice.
"""

from __future__ import annotations

from typing import Optional

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
