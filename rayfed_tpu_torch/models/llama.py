"""Llama-3-style decoder (RMSNorm, RoPE, GQA, SwiGLU): the serving path.

The port of ``rayfed_tpu/models/llama.py`` for serving: the training forward
:func:`apply_llama`, :func:`prefill` and the KV-cache decode step behind
:func:`generate`.  Parameters stay the reference's stacked tree — a leading
layer dim, the reference's names and the ``x @ w`` orientation
(``wq: [L, D, H·Dh]``, not ``nn.Linear``'s ``[out, in]``) — so weights carry
across key for key (:mod:`rayfed_tpu_torch.models.convert`).  The
reference's ``lax.scan`` over layers is a Python loop over ``L``; its donated
KV cache is a cache updated in place.

Not ported yet, and raising ``NotImplementedError``: LoRA, ``remat`` (the
training slice), ``kv_quant`` and the rolling cache (the int8 slice).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rayfed_tpu_torch.models.quant import matmul, split_output_scale
from rayfed_tpu_torch.ops.attention import NEG_INF, dot_product_attention
from rayfed_tpu_torch.utils.platform import resolve_device

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    intermediate_size: int = 14336
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    max_seq_len: int = 8192
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16  # activation dtype
    param_dtype: Any = torch.float32  # storage dtype of the params
    remat: bool = False
    remat_policy: Optional[str] = None
    kv_quant: bool = False
    # Sliding-window attention (Mistral style): each query sees only its
    # last `sliding_window` keys, in the forward, prefill and decode mask.
    sliding_window: Optional[int] = None

    def __post_init__(self):
        if self.sliding_window is not None and self.sliding_window < 1:
            raise ValueError(
                f"sliding_window must be >= 1, got {self.sliding_window}"
            )
        if self.remat_policy not in (None, "dots"):
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r} "
                f"(expected None or 'dots')"
            )
        if self.remat_policy is not None and not self.remat:
            raise ValueError(
                "remat_policy is set but remat=False — the policy would "
                "silently never apply; enable remat or drop the policy"
            )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def llama3_8b(**kw) -> LlamaConfig:
    return LlamaConfig(**kw)


def llama_tiny(**kw) -> LlamaConfig:
    """Test-scale config (runs on the CPU in milliseconds)."""
    defaults = dict(
        vocab_size=256,
        hidden_size=64,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        intermediate_size=128,
        max_seq_len=128,
        dtype=torch.float32,
    )
    defaults.update(kw)
    return LlamaConfig(**defaults)


def _no_kv_quant(config: LlamaConfig) -> None:
    if config.kv_quant:
        raise NotImplementedError("kv_quant=True (int8 KV cache) comes with the int8 slice")


def init_llama(
    config: LlamaConfig,
    generator: torch.Generator,
    device: Optional[torch.device] = None,
) -> Params:
    """Random params (the reference's scales), drawn from ``generator``.

    ``generator`` must live on ``device`` (``torch.Generator(device=...)``).
    Values are drawn in f32 and stored in ``config.param_dtype``; they differ
    from the reference's ``jax.random`` draws for the same seed.
    """
    device = resolve_device(device)
    d, dh = config.hidden_size, config.head_dim
    h, kv = config.num_heads, config.num_kv_heads
    f, L = config.intermediate_size, config.num_layers
    pdt = config.param_dtype

    def normal(*shape, std):
        x = torch.randn(shape, generator=generator, device=device)
        return (x * std).to(pdt)

    def ones(*shape):
        return torch.ones(shape, dtype=pdt, device=device)

    params: Params = {
        "embed": normal(config.vocab_size, d, std=0.02 * d**0.5),
        "layers": {
            "attn_norm": ones(L, d),
            "wq": normal(L, d, h * dh, std=d**-0.5),
            "wk": normal(L, d, kv * dh, std=d**-0.5),
            "wv": normal(L, d, kv * dh, std=d**-0.5),
            "wo": normal(L, h * dh, d, std=(h * dh) ** -0.5),
            "mlp_norm": ones(L, d),
            "w_gate": normal(L, d, f, std=d**-0.5),
            "w_up": normal(L, d, f, std=d**-0.5),
            "w_down": normal(L, f, d, std=f**-0.5),
        },
        "final_norm": ones(d),
    }
    if not config.tie_embeddings:
        params["lm_head"] = normal(d, config.vocab_size, std=d**-0.5)
    return params


class Llama(nn.Module):
    """The param tree as a module: ``state_dict`` keys are the reference's
    tree paths (``embed``, ``layers.wq``, …, ``lm_head``).  The weights are
    frozen: this slice serves, the backward comes with the training slice."""

    def __init__(self, config: LlamaConfig, params: Params):
        super().__init__()
        self.config = config

        def frozen(t):
            return nn.Parameter(t, requires_grad=False)

        self.embed = frozen(params["embed"])
        self.layers = nn.ParameterDict(
            {k: frozen(v) for k, v in params["layers"].items()}
        )
        self.final_norm = frozen(params["final_norm"])
        head = params.get("lm_head")
        self.lm_head = None if head is None else frozen(head)

    def params(self) -> Params:
        tree: Params = {
            "embed": self.embed,
            "layers": dict(self.layers),
            "final_norm": self.final_norm,
        }
        if self.lm_head is not None:
            tree["lm_head"] = self.lm_head
        return tree

    def forward(self, input_ids, *, attn_fn: Callable = dot_product_attention):
        return apply_llama(self.params(), input_ids, self.config, attn_fn=attn_fn)


def _rms_norm(x, scale, eps):
    xf = x.float()
    norm = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (norm * scale.float()).to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables [T, head_dim/2] (f32) for the given absolute positions."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / theta ** (exponents / head_dim)
    angles = positions.float()[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs (x[..., ::2], x[..., 1::2]); x: [B, T, H, Dh].

    Not HF's ``rotate_half``: the pairs are neighbours, re-interleaved by
    stack + reshape.  The f32 tables are cast to x's dtype before multiplying.
    """
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    c = cos[None, :, None, :].to(x.dtype)
    s = sin[None, :, None, :].to(x.dtype)
    r1 = x1 * c - x2 * s
    r2 = x2 * c + x1 * s
    return torch.stack([r1, r2], dim=-1).reshape(x.shape)


def _linear(x, w, dtype):
    """x @ w in ``dtype``.  The reference's LoRA bypass comes with the LoRA slice."""
    return matmul(x, w, dtype)


def _qkv_proj(y, lp, config, b, t):
    """Project + reshape q/k/v — shared by the forward and the decode step."""
    h, kv, dh = config.num_heads, config.num_kv_heads, config.head_dim
    dtype = config.dtype
    q = _linear(y, lp["wq"], dtype).reshape(b, t, h, dh)
    k = _linear(y, lp["wk"], dtype).reshape(b, t, kv, dh)
    v = _linear(y, lp["wv"], dtype).reshape(b, t, kv, dh)
    return q, k, v


def _attn_out(x, attn, lp, config, b, t):
    flat = attn.reshape(b, t, config.num_heads * config.head_dim)
    return x + _linear(flat, lp["wo"], config.dtype)


def _mlp_block(x, lp, config):
    """RMSNorm + SwiGLU MLP residual — shared by the forward and decode."""
    dtype = config.dtype
    y = _rms_norm(x, lp["mlp_norm"], config.rms_eps)
    gate = F.silu(_linear(y, lp["w_gate"], dtype))
    up = _linear(y, lp["w_up"], dtype)
    return x + _linear(gate * up, lp["w_down"], dtype)


def _layer_fwd(x, lp, config, cos, sin, attn_fn, b, t, emit_kv=False):
    """One decoder layer (norm→qkv→RoPE→GQA attn→out→MLP), behind both the
    forward and prefill.  With ``emit_kv`` also returns the pre-repeat k/v."""
    h, kv = config.num_heads, config.num_kv_heads
    y = _rms_norm(x, lp["attn_norm"], config.rms_eps)
    q, k, v = _qkv_proj(y, lp, config, b, t)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    k_out, v_out = k, v
    if kv != h:
        # GQA: each kv head serves h/kv CONSECUTIVE query heads (jnp.repeat).
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    if config.sliding_window is not None:
        attn = attn_fn(q, k, v, causal=True, window=config.sliding_window)
    else:
        attn = attn_fn(q, k, v, causal=True)
    x = _attn_out(x, attn, lp, config, b, t)
    x = _mlp_block(x, lp, config)
    return (x, (k_out, v_out)) if emit_kv else (x, None)


def _layer(params: Params, i: int) -> Params:
    return {name: w[i] for name, w in params["layers"].items()}


def _lm_head(x, params, config):
    """Final norm + vocabulary projection ([..., D] → [..., V] f32).

    The reference multiplies bf16 operands into an f32 result.  A bf16
    matmul here would round the logits to bf16 and move greedy argmaxes, so
    both operands are upcast: every bf16 product is exact in f32 and the
    sums are f32, the same arithmetic at the price of an f32 copy of the
    head (``torch.mm(out_dtype=)`` has no CPU kernel).
    """
    x = _rms_norm(x, params["final_norm"], config.rms_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].to(config.dtype).T
    else:
        head, _ = split_output_scale(head, config.dtype)
    return x.to(config.dtype).float() @ head.float()


def apply_llama(
    params: Params,
    input_ids: torch.Tensor,
    config: LlamaConfig,
    *,
    lora: Optional[Params] = None,
    attn_fn: Callable = dot_product_attention,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Forward: [B, T] ids → [B, T, V] float32 logits (causal LM)."""
    if lora is not None:
        raise NotImplementedError("LoRA comes with the LoRA fine-tune slice")
    if config.remat:
        raise NotImplementedError("remat comes with the training slice")
    b, t = input_ids.shape
    x = params["embed"].to(config.dtype)[input_ids]
    if positions is None:
        positions = torch.arange(t, device=input_ids.device)
    cos, sin = rope_tables(positions, config.head_dim, config.rope_theta)
    for i in range(config.num_layers):
        x, _ = _layer_fwd(x, _layer(params, i), config, cos, sin, attn_fn, b, t)
    return _lm_head(x, params, config)


# ---------------------------------------------------------------------------
# KV-cache decoding (autoregressive inference)
# ---------------------------------------------------------------------------


def init_kv_cache(
    config: LlamaConfig, batch: int, max_len: int, device: Optional[torch.device] = None
) -> Params:
    """Static-shape KV cache: ``k``/``v`` are zeros [L, B, max_len, KV, Dh]."""
    _no_kv_quant(config)
    device = resolve_device(device)
    shape = (config.num_layers, batch, max_len, config.num_kv_heads, config.head_dim)
    return {
        "k": torch.zeros(shape, dtype=config.dtype, device=device),
        "v": torch.zeros(shape, dtype=config.dtype, device=device),
    }


def make_decode_step(config: LlamaConfig, rolling: bool = False):
    """One-token autoregressive step.

    Returns ``step(params, cache, token_ids, pos) -> (cache, logits)``:
    ``token_ids`` is [B] (this position's token per sequence), ``pos`` the
    position as an int; ``logits`` is [B, V] float32 for the NEXT token.
    The cache is written in place (the reference donates it) and returned.

    Attention over the cache is plain torch: bf16 operands are upcast so
    scores and the P·V sum are f32 with exact products, as the reference's
    ``preferred_element_type=f32`` einsums; p is rounded to the activation
    dtype before P·V, as there.
    """
    if rolling:
        raise NotImplementedError("the rolling KV cache comes with the int8/rolling-cache slice")
    _no_kv_quant(config)
    h, kvh, dh = config.num_heads, config.num_kv_heads, config.head_dim
    g = h // kvh
    dtype = config.dtype

    @torch.no_grad()
    def step(params, cache, token_ids, pos):
        pos = int(pos)
        b = token_ids.shape[0]
        max_len = cache["k"].shape[2]
        if not 0 <= pos < max_len:
            raise ValueError(f"position {pos} is outside the {max_len}-slot cache")
        device = token_ids.device
        x = params["embed"].to(dtype)[token_ids][:, None, :]  # [B,1,D]
        cos, sin = rope_tables(torch.tensor([pos], device=device), dh, config.rope_theta)
        positions = torch.arange(max_len, device=device)
        valid = positions <= pos
        if config.sliding_window is not None:
            valid = valid & (positions > pos - config.sliding_window)
        for i in range(config.num_layers):
            lp = _layer(params, i)
            k_cache = cache["k"][i]  # [B, T, KV, Dh] view into the cache
            v_cache = cache["v"][i]
            y = _rms_norm(x, lp["attn_norm"], config.rms_eps)
            q, k, v = _qkv_proj(y, lp, config, b, 1)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
            k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
            v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
            qs = (q.reshape(b, h, dh) * dh**-0.5).to(dtype).reshape(b, kvh, g, dh)
            s = torch.einsum(
                "bngd,btnd->bngt", qs.float(), k_cache.to(dtype).float()
            )
            s = torch.where(valid, s, NEG_INF)
            p = torch.softmax(s, dim=-1)
            attn = torch.einsum(
                "bngt,btnd->bngd", p.to(dtype).float(), v_cache.to(dtype).float()
            )
            attn = attn.reshape(b, 1, h, dh).to(dtype)
            x = _attn_out(x, attn, lp, config, b, 1)
            x = _mlp_block(x, lp, config)
        return cache, _lm_head(x[:, 0, :], params, config)

    return step


@torch.no_grad()
def prefill(
    params: Params,
    config: LlamaConfig,
    prompt_ids: torch.Tensor,
    max_len: int,
    *,
    attn_fn: Callable = dot_product_attention,
) -> Tuple[Params, torch.Tensor]:
    """Process the whole prompt in ONE causal pass and return
    ``(cache, last_logits)`` ready for :func:`make_decode_step`.

    Same layer math as :func:`apply_llama`; each layer's k/v is written into
    the first ``T0`` slots of a zeroed [L, B, max_len, KV, Dh] cache.
    """
    b, t0 = prompt_ids.shape
    if t0 > max_len:
        raise ValueError(f"prompt length {t0} exceeds cache max_len {max_len}")
    x = params["embed"].to(config.dtype)[prompt_ids]
    cos, sin = rope_tables(
        torch.arange(t0, device=prompt_ids.device), config.head_dim, config.rope_theta
    )
    cache = init_kv_cache(config, b, max_len, device=prompt_ids.device)
    for i in range(config.num_layers):
        x, (k_out, v_out) = _layer_fwd(
            x, _layer(params, i), config, cos, sin, attn_fn, b, t0, emit_kv=True
        )
        cache["k"][i, :, :t0] = k_out
        cache["v"][i, :, :t0] = v_out
    return cache, _lm_head(x[:, -1, :], params, config)


def _pick(logits, temperature, top_k, generator):
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    scaled = logits / temperature
    if top_k is not None:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled >= kth, scaled, -torch.inf)
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(
    params: Params,
    config: LlamaConfig,
    prompt_ids: torch.Tensor,
    max_new_tokens: int,
    *,
    attn_fn: Callable = dot_product_attention,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Autoregressive decoding: [B, T0] prompt → [B, T0+max_new_tokens].

    One batched causal pass over the prompt (:func:`prefill`; pass
    ``attn_fn=flash_attention`` for long prompts), then one decode step per
    new token but the last, whose logits nobody reads.

    ``temperature=0`` (default) is greedy argmax.  With a positive
    temperature, samples from softmax(logits/temperature), optionally cut
    to the ``top_k`` most likely tokens; ``generator`` (on the logits'
    device) is then required.
    """
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) requires generator=")
    if temperature == 0.0 and (generator is not None or top_k is not None):
        raise ValueError(
            "generator/top_k are sampling arguments — pass temperature > 0 "
            "(or drop them for greedy decoding)"
        )
    if top_k is not None and not 0 < top_k <= config.vocab_size:
        raise ValueError(
            f"top_k must be in [1, vocab_size={config.vocab_size}], got {top_k}"
        )
    b, t0 = prompt_ids.shape
    cache, logits = prefill(
        params, config, prompt_ids, t0 + max_new_tokens, attn_fn=attn_fn
    )
    step = make_decode_step(config)
    out = [prompt_ids]
    for i in range(max_new_tokens):
        token = _pick(logits, temperature, top_k, generator).to(prompt_ids.dtype)
        out.append(token[:, None])
        if i + 1 < max_new_tokens:
            cache, logits = step(params, cache, token, t0 + i)
    return torch.cat(out, dim=1)


def greedy_generate(
    params: Params,
    config: LlamaConfig,
    prompt_ids: torch.Tensor,
    max_new_tokens: int,
    *,
    attn_fn: Callable = dot_product_attention,
) -> torch.Tensor:
    """Greedy decoding (temperature-0 :func:`generate`)."""
    return generate(params, config, prompt_ids, max_new_tokens, attn_fn=attn_fn)
