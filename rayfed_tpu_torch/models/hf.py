"""Hugging Face Llama checkpoint interop.

The port of ``rayfed_tpu/models/hf.py``.  :func:`from_hf_llama` converts a
``transformers`` Llama model (or its state dict of torch tensors) into this
package's param tree and :class:`~rayfed_tpu_torch.models.llama.LlamaConfig`,
so pretrained weights drop into every path here: training, LoRA, the int8
base, the KV-cache decode and the federated exchanges.  The module imports
nothing of ``transformers``: it reads the state dict and, given a model, its
``config`` attributes.

Two convention differences are handled:

- **Weight orientation**: ``nn.Linear`` stores ``[out, in]``; this package
  right-multiplies ``x @ W`` with ``[in, out]``, so every projection is
  transposed.
- **RoPE layout**: HF rotates half-split pairs ``(j, j+Dh/2)``; this package
  rotates interleaved pairs ``(2j, 2j+1)``.  A static permutation of each
  head's output channels of ``wq``/``wk`` makes the logits identical.

The params come back in f32, as the reference's do, on the device of the
state dict's tensors (no round trip through the host).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from rayfed_tpu_torch.models.llama import LlamaConfig

Params = Dict[str, Any]


def _rope_perm(head_dim: int, device: Optional[torch.device] = None) -> torch.Tensor:
    """Channel permutation taking HF's half-split RoPE layout to the
    interleaved one: out[2j] = j, out[2j+1] = j + Dh/2."""
    half = head_dim // 2
    idx = torch.arange(half, device=device)
    return torch.stack([idx, idx + half], dim=1).reshape(head_dim)


def _permute_heads(w: torch.Tensor, num_heads: int, head_dim: int) -> torch.Tensor:
    """Apply the RoPE channel permutation per head on the out axis of a
    transposed projection ``[in, H·Dh]`` (``ValueError`` if it is not one)."""
    if w.shape[-1] != num_heads * head_dim:
        raise ValueError(
            f"projection [in, out] = {tuple(w.shape)} does not split into "
            f"{num_heads} heads of {head_dim}"
        )
    d_in = w.shape[0]
    w = w.reshape(d_in, num_heads, head_dim)
    return w[:, :, _rope_perm(head_dim, w.device)].reshape(d_in, num_heads * head_dim)


def config_from_hf(hf_config) -> LlamaConfig:
    """Map a ``transformers.LlamaConfig`` onto :class:`LlamaConfig`.

    Features this package does not implement are refused: dropped silently
    they would pass the shape audit and diverge at every position.
    """
    if getattr(hf_config, "rope_scaling", None):
        raise NotImplementedError(
            "rope_scaling (Llama-3.1+ long-context scaling) is not "
            "implemented by rayfed_tpu_torch.models.llama.rope_tables — "
            "convert a checkpoint without it or extend rope_tables first"
        )
    if getattr(hf_config, "attention_bias", False) or getattr(hf_config, "mlp_bias", False):
        raise NotImplementedError(
            "attention_bias/mlp_bias checkpoints are not supported "
            "(this package's Llama projections are bias-free)"
        )
    implied = hf_config.hidden_size // hf_config.num_attention_heads
    explicit = getattr(hf_config, "head_dim", None)
    if explicit is not None and explicit != implied:
        raise NotImplementedError(
            f"explicit head_dim={explicit} != hidden_size//num_heads="
            f"{implied}: this package derives head_dim from the config"
        )
    return LlamaConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=getattr(hf_config, "num_key_value_heads", hf_config.num_attention_heads),
        intermediate_size=hf_config.intermediate_size,
        rope_theta=float(getattr(hf_config, "rope_theta", 10000.0)),
        rms_eps=float(hf_config.rms_norm_eps),
        max_seq_len=int(hf_config.max_position_embeddings),
        tie_embeddings=bool(getattr(hf_config, "tie_word_embeddings", False)),
        sliding_window=getattr(hf_config, "sliding_window", None),
        dtype=torch.float32,
        param_dtype=torch.float32,
    )


def from_hf_llama(
    model_or_state: Any, config: Optional[LlamaConfig] = None
) -> Tuple[Params, LlamaConfig]:
    """Convert an HF Llama (model or state dict) → ``(params, config)``.

    ``model_or_state``: a ``transformers`` ``LlamaForCausalLM`` (config
    derived from it) or its ``state_dict()`` (pass ``config``).  The params
    are f32 tensors, each a copy, on the device of the tensor it came from,
    in the stacked ``[L, ...]`` layout; cast them or
    :func:`~rayfed_tpu_torch.models.llama.quantize_llama_base` them as
    needed.
    """
    if hasattr(model_or_state, "state_dict"):
        state = model_or_state.state_dict()
        if config is None:
            config = config_from_hf(model_or_state.config)
    else:
        state = dict(model_or_state)
        if config is None:
            raise ValueError("pass config= when converting a raw state dict")

    d, dh = config.hidden_size, config.head_dim
    h, kvh, L = config.num_heads, config.num_kv_heads, config.num_layers

    def get(name: str, copy: bool = True) -> torch.Tensor:
        if name not in state:
            raise KeyError(
                f"HF checkpoint is missing {name!r} — not a Llama-family state dict?"
            )
        return state[name].detach().to(torch.float32, copy=copy)

    def proj(name: str) -> torch.Tensor:
        return get(name, copy=False).t()  # [out, in] -> [in, out]

    layers: Dict[str, list] = {
        k: [] for k in ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down")
    }
    for i in range(L):
        p = f"model.layers.{i}."
        layers["attn_norm"].append(get(p + "input_layernorm.weight", copy=False))
        layers["wq"].append(_permute_heads(proj(p + "self_attn.q_proj.weight"), h, dh))
        layers["wk"].append(_permute_heads(proj(p + "self_attn.k_proj.weight"), kvh, dh))
        layers["wv"].append(proj(p + "self_attn.v_proj.weight"))
        layers["wo"].append(proj(p + "self_attn.o_proj.weight"))
        layers["mlp_norm"].append(get(p + "post_attention_layernorm.weight", copy=False))
        layers["w_gate"].append(proj(p + "mlp.gate_proj.weight"))
        layers["w_up"].append(proj(p + "mlp.up_proj.weight"))
        layers["w_down"].append(proj(p + "mlp.down_proj.weight"))

    params: Params = {
        "embed": get("model.embed_tokens.weight"),
        "layers": {k: torch.stack(v) for k, v in layers.items()},  # stack copies
        "final_norm": get("model.norm.weight"),
    }
    if not config.tie_embeddings:
        params["lm_head"] = proj("lm_head.weight").contiguous()

    # Shape audit: a silent mismatch (a wrong num_kv_heads) would otherwise
    # surface as an obscure einsum error deep inside the forward.
    expect = {"embed": (config.vocab_size, d), "final_norm": (d,)}
    for name, shape in expect.items():
        if tuple(params[name].shape) != shape:
            raise ValueError(f"{name}: got {tuple(params[name].shape)}, expected {shape}")
    if tuple(params["layers"]["wq"].shape) != (L, d, h * dh):
        raise ValueError(
            f"wq: got {tuple(params['layers']['wq'].shape)}, expected {(L, d, h * dh)}"
        )
    if tuple(params["layers"]["wk"].shape) != (L, d, kvh * dh):
        raise ValueError(
            f"wk: got {tuple(params['layers']['wk'].shape)}, expected {(L, d, kvh * dh)}"
        )
    return params, config
