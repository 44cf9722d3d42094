"""Mixture-of-Experts layer with expert parallelism over the ``ep`` axis.

The port of ``rayfed_tpu/models/moe.py``.  Experts are a stacked weight
tensor ``[E, d, f]``; routing is dense top-k softmax gating with a capacity
factor (Switch/GShard style) and an auxiliary load-balancing loss, so every
buffer has a static shape.  Token dispatch and combine are a scatter and a
gather into ``[B, E, C, d]`` expert buffers (``dispatch="scatter"``, the
default) or einsums against a one-hot mask (``"einsum"``, the reference
form, guarded at scale).

Expert parallelism: with ``ep_group`` (``mesh.get_group("ep")``) each of
the group's n ranks holds E/n experts (``Shard(0)`` of the stacked weights,
:data:`PARTITION_RULES`), computes the routing (replicated), dispatches and
runs only its own experts' part, and the combine sums the parts over the
group.  The result equals the one-rank layer's; the gradients of the
replicated inputs (``x``, the gate) are summed over the group where they
come from the split part.

``init_moe`` draws from a ``torch.Generator`` (the reference's shapes and
scales, other numbers than ``jax.random``'s); weights carry across with
:func:`rayfed_tpu_torch.models.convert.moe_params_from_jax`.  The experts'
activation is ``jax.nn.gelu``'s default, the tanh form.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from rayfed_tpu_torch.parallel import collectives as coll
from rayfed_tpu_torch.utils.platform import resolve_device

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    d_model: int = 64
    d_ff: int = 256
    aux_loss_weight: float = 0.01


def init_moe(
    config: MoeConfig,
    generator: torch.Generator,
    device: Optional[torch.device] = None,
) -> Params:
    """Random f32 params with the reference's shapes and scales, drawn from
    ``generator`` (which must live on ``device``)."""
    device = resolve_device(device)
    e, d, f = config.num_experts, config.d_model, config.d_ff

    def normal(*shape, std):
        return torch.randn(shape, generator=generator, device=device) * std

    return {
        "gate": normal(d, e, std=d**-0.5),
        "w_in": normal(e, d, f, std=d**-0.5),
        "w_out": normal(e, f, d, std=f**-0.5),
    }


# Experts shard over ep; inner dims over tp when present (the reference's
# PartitionSpecs as plain tuples).
PARTITION_RULES = (
    (r"w_(in|out)$", ("ep", None, "tp")),
    (r"gate$", (None, None)),
)


# Above this many elements the einsum path's [B,T,k,E,C] one-hot mask is a
# memory and FLOP blowup (tens of GB at T=8192, E=64): refuse it and point
# at the scatter path, which is the default.
_EINSUM_DISPATCH_MAX_ELEMENTS = 1 << 30


def _route(params: Params, x: torch.Tensor, config: MoeConfig):
    """Shared top-k routing: gate values, expert ids, capacity ranks."""
    b, t, _ = x.shape
    e, k = config.num_experts, config.top_k
    logits = x @ params["gate"].to(x.dtype)  # [B, T, E]
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)  # [B, T, k]
    # Renormalize over the selected k (GShard/Mixtral convention).
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    # Rank of each (token, choice) within its expert's capacity buffer, in
    # (t, k)-lexicographic priority order.
    onehot = F.one_hot(expert_idx, e).to(torch.int32)  # [B, T, k, E]
    flat = onehot.reshape(b, t * k, e)
    pos_in_expert = (torch.cumsum(flat, dim=1) * flat).reshape(b, t, k, e) - 1
    return probs, gate_vals, expert_idx, onehot, pos_in_expert


def _expert_ffn(w_in: torch.Tensor, w_out: torch.Tensor, expert_in: torch.Tensor) -> torch.Tensor:
    """[B, E, C, d] → [B, E, C, d]; E is a batched matmul dim."""
    h = F.gelu(torch.einsum("becd,edf->becf", expert_in, w_in.to(expert_in.dtype)), approximate="tanh")
    return torch.einsum("becf,efd->becd", h, w_out.to(expert_in.dtype))


def _local_experts(w, e: int, n: int) -> torch.Tensor:
    """This rank's E/n experts of a stacked weight (a DTensor's local shard,
    placed by ``PARTITION_RULES``, or the local stack itself)."""
    if type(w).__module__.startswith("torch.distributed"):
        w = w.to_local()
    if w.shape[0] != e // n:
        raise ValueError(f"expert weights {tuple(w.shape)}: want {e // n} experts per rank "
                         f"({e} over {n} ranks)")
    return w


def apply_moe(
    params: Params,
    x: torch.Tensor,
    config: MoeConfig,
    *,
    return_aux: bool = False,
    dispatch: str = "scatter",
    ep_group=None,
):
    """[B, T, d] → [B, T, d] with top-k expert routing.

    Every expert processes a fixed capacity ``C = ceil(k·T·cf / E)`` tokens
    per batch row; overflow tokens are dropped (Switch behavior) and their
    output for that expert slot is 0.  ``dispatch="scatter"`` scatters
    tokens into the ``[B, E, C, d]`` buffers (ranks ≥ C drop in the scatter)
    and gathers the outputs back; ``"einsum"`` is the GShard one-hot mask
    form, refused above ``_EINSUM_DISPATCH_MAX_ELEMENTS``.  Both share the
    routing, so they agree.  ``ep_group``: split the experts over that
    process group (see the module note); ``E`` must divide by its size.
    """
    b, t, d = x.shape
    e, k = config.num_experts, config.top_k
    capacity = max(1, math.ceil(config.capacity_factor * k * t / e))
    if dispatch not in ("scatter", "einsum"):
        raise ValueError(f"unknown dispatch mode {dispatch!r}")
    if dispatch == "einsum":
        mask_elements = b * t * k * e * capacity
        if mask_elements > _EINSUM_DISPATCH_MAX_ELEMENTS:
            raise ValueError(
                f"einsum dispatch mask would hold {mask_elements} elements "
                f"([B={b}, T={t}, k={k}, E={e}, C={capacity}]); use "
                f'dispatch="scatter" at this scale'
            )
    n = 1 if ep_group is None else dist.get_world_size(ep_group)
    r = 0 if ep_group is None else dist.get_rank(ep_group)
    if e % n:
        raise ValueError(f"{e} experts do not split over {n} ranks")
    e_local, e_lo = e // n, r * (e // n)
    w_in = _local_experts(params["w_in"], e, n)
    w_out = _local_experts(params["w_out"], e, n)

    probs, gate_vals, expert_idx, onehot, pos_in_expert = _route(params, x, config)
    keep = (pos_in_expert >= 0) & (pos_in_expert < capacity)
    x_part, gate_part = x, gate_vals
    if n > 1:
        # The split part's gradients are partial on each rank: sum them.
        x_part = coll.copy_to_group(x, ep_group)
        gate_part = coll.copy_to_group(gate_vals, ep_group)

    if dispatch == "scatter":
        # Each assignment's rank under ITS expert: [B, T, k].
        pos_assign = (pos_in_expert * onehot).amax(dim=-1)
        sel = (pos_assign < capacity) & (expert_idx >= e_lo) & (expert_idx < e_lo + e_local)
        bi, ti, ki = sel.nonzero(as_tuple=True)
        slot = (bi, expert_idx[bi, ti, ki] - e_lo, pos_assign[bi, ti, ki])
        expert_in = torch.zeros((b, e_local, capacity, d), dtype=x.dtype, device=x.device)
        expert_in = expert_in.index_put(slot, x_part[bi, ti], accumulate=True)
        expert_out = _expert_ffn(w_in, w_out, expert_in)
        # Combine: each kept assignment's output back (dropped ones stay 0),
        # weighted by its gate value, summed over k.
        gathered = torch.zeros((b, t, k, d), dtype=x.dtype, device=x.device)
        gathered = gathered.index_put((bi, ti, ki), expert_out[slot])
        out = torch.sum(gathered * gate_part[..., None].to(x.dtype), dim=2)
    else:
        pos_clamped = torch.clamp(pos_in_expert, 0, capacity - 1)
        dispatch_mask = (
            F.one_hot(pos_clamped.long(), capacity).to(x.dtype)
            * keep[..., None].to(x.dtype)
            * onehot[..., None].to(x.dtype)
        )[:, :, :, e_lo:e_lo + e_local]  # [B, T, k, E_local, C]
        dispatch_tok = dispatch_mask.sum(dim=2)  # [B, T, E_local, C]
        combine = (dispatch_mask * gate_part[..., None, None].to(x.dtype)).sum(dim=2)
        expert_in = torch.einsum("btec,btd->becd", dispatch_tok, x_part)
        expert_out = _expert_ffn(w_in, w_out, expert_in)
        out = torch.einsum("btec,becd->btd", combine, expert_out)
    if n > 1:
        out = coll.all_reduce_sum(out, ep_group)

    if not return_aux:
        return out
    # Load-balancing auxiliary loss (Switch eq. 4): E · Σ_e f_e · P_e.
    frac_tokens = F.one_hot(expert_idx[..., 0], e).float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = config.aux_loss_weight * e * torch.sum(frac_tokens * frac_probs)
    return out, {
        "aux_loss": aux,
        "dropped_fraction": 1.0 - keep.any(dim=-1).float().mean(),
    }
