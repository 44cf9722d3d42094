"""Ulysses (DeepSpeed-style) sequence parallelism via all-to-all.

The port of ``rayfed_tpu/ops/ulysses.py``.  Instead of rotating K/V around
a ring, one tiled all-to-all
(:func:`rayfed_tpu_torch.parallel.collectives.all_to_all`) re-shards the
activations from sequence-sharded [B, T/n, H, D] to head-sharded
[B, T, H/n, D]; each rank then runs attention for its head group over the
whole sequence (``attn_fn``: the dense reference by default, or the port's
``flash_attention``, whose forward and backward kernels then run inside)
and a second all-to-all restores sequence sharding.  Requires
``num_heads % axis_size == 0``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from rayfed_tpu_torch.ops.attention import as_attn_fn, dot_product_attention
from rayfed_tpu_torch.parallel import collectives as coll


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    attn_fn=None,
) -> torch.Tensor:
    """Collective Ulysses attention over ``group``.

    Inputs are sequence shards [B, T_local, H, D]; the output likewise.
    ``attn_fn`` runs the per-head-group attention (defaults to
    :func:`dot_product_attention`).
    """
    n = dist.get_world_size(group)
    if q.shape[2] % n:
        raise ValueError(
            f"ulysses requires heads ({q.shape[2]}) divisible by axis size ({n})"
        )
    attn_fn = attn_fn or dot_product_attention
    # [B, T/n, H, D] -> [B, T, H/n, D]
    qh, kh, vh = (coll.all_to_all(x, group, split_axis=2, concat_axis=1) for x in (q, k, v))
    oh = attn_fn(qh, kh, vh, causal=causal, sm_scale=sm_scale)
    # [B, T, H/n, D] -> [B, T/n, H, D]
    return coll.all_to_all(oh, group, split_axis=1, concat_axis=2)


def make_ulysses_attention(
    mesh,
    seq_axis: str = "sp",
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    attn_fn=None,
):
    """Global-view Ulysses attention over ``mesh``'s ``seq_axis``.

    The returned fn maps [B, T, H, D] → [B, T, H, D] (every rank passes the
    same global tensors and gets the whole output back); T splits over
    ``seq_axis`` and H must divide by its size.
    """
    group = mesh.get_group(seq_axis)

    def apply(qg, kg, vg):
        q, k, v = (coll.local_shard(x, group, 1) for x in (qg, kg, vg))
        out = ulysses_attention(q, k, v, group=group, causal=causal, sm_scale=sm_scale, attn_fn=attn_fn)
        return coll.all_gather(out, group, 1)

    return as_attn_fn(apply, causal, sm_scale, "make_ulysses_attention")
