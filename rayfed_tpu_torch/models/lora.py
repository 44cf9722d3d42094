"""LoRA adapters over nested param trees (the port of ``rayfed_tpu/models/lora.py``).

Low-Rank Adaptation for the federated fine-tune: each party trains only the
small A/B factors.  ``init_lora`` matches leaves by path regex and creates
factors over the *last two* dims, treating leading dims (the stacked layer
axis of :mod:`rayfed_tpu_torch.models.llama`) as batch.  The compute path
never materializes ``W + AB``: the model adds the low-rank bypass
``(x@A)@B·scale`` (``llama._linear``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from rayfed_tpu_torch.models.quant import QTensor
from rayfed_tpu_torch.utils.platform import resolve_device

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: Sequence[str] = (r"w[qv]$",)  # regexes over '/'-joined paths
    init_scale: float = 0.01

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def _path_str(path) -> str:
    """A pytree key path (dict keys, sequence indices) joined by '/'."""
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:  # pragma: no cover
            parts.append(str(p))
    return "/".join(parts)


def init_lora(
    params: Params,
    config: LoraConfig,
    generator: torch.Generator,
    device: Optional[torch.device] = None,
) -> Params:
    """Build a LoRA tree mirroring the subtrees of matched ≥2-D leaves.

    The returned tree has the same *container* structure as ``params`` but
    only the matched leaves, each replaced by ``{"a", "b", "scale"}``: A is
    Gaussian times ``init_scale``, B is zero (the adapter starts as the
    identity), both f32; ``scale`` is a 0-d f32 tensor.  The draws come from
    ``generator`` (which must live on ``device``), leaf by leaf; they differ
    from the reference's ``jax.random`` draws for the same seed.  Runs on
    the card unless ``device`` says otherwise.
    """
    device = resolve_device(device)
    compiled = [re.compile(pat) for pat in config.targets]
    out: Params = {}
    # A QTensor is one leaf here: the adapter mirrors the LOGICAL weight.
    for path, leaf in pytree.tree_flatten_with_path(params)[0]:
        path_s = _path_str(path)
        if leaf.ndim < 2 or not any(c.search(path_s) for c in compiled):
            continue
        lead = tuple(leaf.shape[:-2])
        d_in, d_out = leaf.shape[-2], leaf.shape[-1]
        a = torch.randn((*lead, d_in, config.rank), generator=generator, device=device)
        entry = {
            "a": a * config.init_scale,
            "b": torch.zeros((*lead, config.rank, d_out), device=device),
            "scale": torch.tensor(config.scaling, dtype=torch.float32, device=device),
        }
        # Insert at the same nested position.
        node = out
        keys = path_s.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = entry
    return out


def lora_delta(entry: Params) -> torch.Tensor:
    """Materialized AB·scale delta (for merging only, not the hot path)."""
    return torch.einsum("...ir,...ro->...io", entry["a"], entry["b"]) * entry["scale"]


def _is_entry(node) -> bool:
    return isinstance(node, dict) and set(node) == {"a", "b", "scale"}


def merge_lora(params: Params, lora: Params) -> Params:
    """Fold adapters into the base weights: W ← W + AB·scale (new tensors)."""

    def _merge(base_node, lora_node):
        if _is_entry(lora_node):
            if isinstance(base_node, QTensor):
                raise TypeError(
                    "cannot merge LoRA into an int8-quantized base; "
                    "dequantize first (QTensor.dequantize) or keep the "
                    "adapter separate"
                )
            return (base_node + lora_delta(lora_node)).to(base_node.dtype)
        if isinstance(lora_node, dict):
            return {
                k: _merge(base_node[k], lora_node[k]) if k in lora_node else base_node[k]
                for k in base_node
            }
        return base_node

    return _merge(params, lora)


def num_lora_params(lora: Params) -> int:
    return sum(
        x.numel()
        for path, x in pytree.tree_flatten_with_path(lora)[0]
        if not _path_str(path).endswith("scale")
    )
