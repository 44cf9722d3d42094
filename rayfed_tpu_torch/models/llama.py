"""Llama-3-style decoder (RMSNorm, RoPE, GQA, SwiGLU): serving and training.

The port of ``rayfed_tpu/models/llama.py``: the forward :func:`apply_llama`
(with LoRA adapters and ``remat``), :func:`prefill` and the KV-cache decode
step behind :func:`generate` (with the int8 KV cache, ``kv_quant``, and the
O(W) rolling cache of a sliding window), the int8 base
(:func:`quantize_llama_base`, :func:`init_llama_int8`), and the training
steps — LoRA-only and full-parameter Adam (:func:`make_lora_train_step`,
:func:`make_train_step` and their loops).  Parameters stay the reference's
stacked tree — a leading layer dim, the reference's names and the
``x @ w`` orientation (``wq: [L, D, H·Dh]``, not ``nn.Linear``'s ``[out,
in]``) — so weights carry across key for key
(:mod:`rayfed_tpu_torch.models.convert`).  The
reference's ``lax.scan`` over layers is a Python loop over ``L``; its donated
KV cache is a cache updated in place; its ``jax.checkpoint`` is
``torch.utils.checkpoint``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from rayfed_tpu_torch.models.quant import (
    QTensor,
    int8_product,
    matmul,
    output_scale,
    quantize_int8,
    split_output_scale,
)
from rayfed_tpu_torch.ops import ftz, xla_cpu
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
    # int8 KV cache: per-(position, head) symmetric scales over the head
    # dim; the decode step reads the int8 planes raw and puts the scales on
    # the scores and the probabilities.
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


_QUANT_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_llama_base(params: Params) -> Params:
    """int8-quantize the frozen base for a LoRA fine-tune.

    The seven stacked [L, din, dout] matmul weights get per-(layer,
    output-channel) scales; ``lm_head`` a per-column scale; embeddings and
    norms stay in their float dtype.  Use with :func:`make_lora_train_step`
    (the base must stay frozen: int8 leaves carry no gradient) or for
    serving.
    """
    out = dict(params)
    out["layers"] = {
        k: quantize_int8(v, channel_axis=-1, batch_axes=(0,)) if k in _QUANT_LEAVES else v
        for k, v in params["layers"].items()
    }
    if "lm_head" in params:
        out["lm_head"] = quantize_int8(params["lm_head"], channel_axis=-1)
    return out


def init_llama_int8(
    config: LlamaConfig,
    generator: torch.Generator,
    device: Optional[torch.device] = None,
) -> Params:
    """Random int8 base, built without a full-precision pass.

    Each matmul weight is drawn directly as int8, uniform in [-127, 127],
    with a fan-in-scaled per-channel scale 1/(73·√fan_in) (E[q²] ≈ 127²/3),
    so the peak memory of the init is the int8 tree itself.  The embedding
    is drawn as :func:`init_llama`'s, in ``config.param_dtype``.  Draws come
    from ``generator`` (on ``device``) and differ from the reference's
    ``jax.random`` draws for the same seed.
    """
    device = resolve_device(device)
    d, dh = config.hidden_size, config.head_dim
    h, kv = config.num_heads, config.num_kv_heads
    f, L = config.intermediate_size, config.num_layers
    pdt = config.param_dtype

    def qdense(*shape, fan_in):
        q = torch.randint(-127, 128, shape, dtype=torch.int8, generator=generator, device=device)
        scale_shape = (shape[0], *([1] * (len(shape) - 2)), shape[-1])
        scale = torch.full(scale_shape, (fan_in**-0.5) / 73.0, dtype=torch.float32, device=device)
        return QTensor(q=q, scale=scale)

    def ones(*shape):
        return torch.ones(shape, dtype=pdt, device=device)

    embed = torch.randn((config.vocab_size, d), generator=generator, device=device)
    params: Params = {
        "embed": (embed * (0.02 * d**0.5)).to(pdt),
        "layers": {
            "attn_norm": ones(L, d),
            "wq": qdense(L, d, h * dh, fan_in=d),
            "wk": qdense(L, d, kv * dh, fan_in=d),
            "wv": qdense(L, d, kv * dh, fan_in=d),
            "wo": qdense(L, h * dh, d, fan_in=h * dh),
            "mlp_norm": ones(L, d),
            "w_gate": qdense(L, d, f, fan_in=d),
            "w_up": qdense(L, d, f, fan_in=d),
            "w_down": qdense(L, f, d, fan_in=f),
        },
        "final_norm": ones(d),
    }
    del embed
    if not config.tie_embeddings:
        head = torch.randint(-127, 128, (d, config.vocab_size), dtype=torch.int8,
                             generator=generator, device=device)
        params["lm_head"] = QTensor(
            q=head,
            scale=torch.full((1, config.vocab_size), (d**-0.5) / 73.0, dtype=torch.float32, device=device),
        )
    return params


class _QLeaf(nn.Module):
    """An int8 weight of the module: buffers ``q`` and ``scale``, never a
    ``Parameter`` (it carries no gradient)."""

    def __init__(self, w: QTensor):
        super().__init__()
        self.register_buffer("q", w.q)
        self.register_buffer("scale", w.scale)

    def value(self) -> QTensor:
        return QTensor(self.q, self.scale)


def _attach(parent: nn.Module, name: str, w: Any) -> None:
    """A frozen ``Parameter``, or an int8 weight's buffers under ``name``."""
    if isinstance(w, QTensor):
        parent.add_module(name, _QLeaf(w))
    else:
        parent.register_parameter(name, nn.Parameter(w, requires_grad=False))


def _attached(parent: nn.Module, name: str) -> Any:
    w = getattr(parent, name)
    return w.value() if isinstance(w, _QLeaf) else w


class Llama(nn.Module):
    """The param tree as a module: ``state_dict`` keys are the reference's
    tree paths (``embed``, ``layers.wq``, …, ``lm_head``; an int8 weight's
    as ``layers.wq.q`` and ``layers.wq.scale`` buffers).  The weights are
    frozen: a LoRA fine-tune trains adapters beside them (``forward(lora=)``)."""

    def __init__(self, config: LlamaConfig, params: Params):
        super().__init__()
        self.config = config
        _attach(self, "embed", params["embed"])
        self.layers = nn.Module()
        self._layer_names = tuple(params["layers"])
        for k, v in params["layers"].items():
            _attach(self.layers, k, v)
        _attach(self, "final_norm", params["final_norm"])
        head = params.get("lm_head")
        self._has_head = head is not None
        if head is not None:
            _attach(self, "lm_head", head)

    def params(self) -> Params:
        tree: Params = {
            "embed": self.embed,
            "layers": {k: _attached(self.layers, k) for k in self._layer_names},
            "final_norm": self.final_norm,
        }
        if self._has_head:
            tree["lm_head"] = _attached(self, "lm_head")
        return tree

    def forward(self, input_ids, *, lora: Optional[Params] = None,
                attn_fn: Callable = dot_product_attention):
        return apply_llama(self.params(), input_ids, self.config, lora=lora, attn_fn=attn_fn)


def _sharded(x) -> bool:
    """A DTensor (``parallel.sharding``): it holds no storage of its own for
    the native XLA:CPU forms to read, so it takes PyTorch's ops."""
    return type(x).__module__.startswith("torch.distributed")


def _rms_norm(x, scale, eps, jitted=False):
    """RMSNorm.  ``jitted``: the JAX package runs this call site inside one
    jitted program (its decode and train steps), whose CPU bytes differ
    from its op-by-op ones (ops/xla_cpu.py).  On CPU tensors the value is
    that program's, subnormals flushed, and the gradient PyTorch's."""
    xf = x.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    out = (xf * r * scale.float()).to(x.dtype)
    if xf.device.type == "cpu" and not _sharded(xf):
        out = xla_cpu.ForwardValue.apply(out, xla_cpu.rms_norm(x.detach(), scale.detach(), eps, jitted))
    return out


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float, *, folded: bool = False):
    """cos/sin tables [T, head_dim/2] (f32) for the given absolute positions.

    On CPU tensors the bytes are XLA:CPU's (ops/xla_cpu.py): ``folded``
    takes the frequencies as the JAX package's jitted decode step folds
    them, else as its eager prefill computes them.  The card's tables are
    PyTorch's."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    if positions.device.type == "cpu":
        angles = ftz.mul(positions.float()[:, None], xla_cpu.rope_freqs(exponents, theta, folded)[None, :])
        return xla_cpu.cos(angles), xla_cpu.sin(angles)
    freqs = 1.0 / theta ** exponents
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


def _linear(x, w, lora_entry, dtype):
    """x @ w in ``dtype``, with an optional LoRA bypass (x@A)@B · scale.

    A and B are cast to ``dtype``; ``scale`` is detached, as the
    reference's ``stop_gradient``."""
    out = matmul(x, w, dtype)
    if lora_entry is not None:
        a = lora_entry["a"].to(dtype)
        b = lora_entry["b"].to(dtype)
        scale = lora_entry["scale"].detach().to(dtype)
        out = out + (x @ a) @ b * scale
    return out


def _no_lora(name):
    return None


def _qkv_proj(y, lp, config, b, t, lget=_no_lora):
    """Project + reshape q/k/v — shared by the forward and the decode step."""
    h, kv, dh = config.num_heads, config.num_kv_heads, config.head_dim
    dtype = config.dtype
    q = _linear(y, lp["wq"], lget("wq"), dtype).reshape(b, t, h, dh)
    k = _linear(y, lp["wk"], lget("wk"), dtype).reshape(b, t, kv, dh)
    v = _linear(y, lp["wv"], lget("wv"), dtype).reshape(b, t, kv, dh)
    return q, k, v


def _attn_out(x, attn, lp, config, b, t, lget=_no_lora):
    flat = attn.reshape(b, t, config.num_heads * config.head_dim)
    return x + _linear(flat, lp["wo"], lget("wo"), config.dtype)


def _mlp_block(x, lp, config, lget=_no_lora, jitted=False):
    """RMSNorm + SwiGLU MLP residual — shared by the forward and decode."""
    dtype = config.dtype
    y = _rms_norm(x, lp["mlp_norm"], config.rms_eps, jitted)
    gate = F.silu(_linear(y, lp["w_gate"], lget("w_gate"), dtype))
    up = _linear(y, lp["w_up"], lget("w_up"), dtype)
    return x + _linear(gate * up, lp["w_down"], lget("w_down"), dtype)


def _layer_fwd(x, lp, config, cos, sin, attn_fn, b, t, lget=_no_lora, emit_kv=False, jitted=False):
    """One decoder layer (norm→qkv→RoPE→GQA attn→out→MLP), behind both the
    forward and prefill.  With ``emit_kv`` also returns the pre-repeat k/v."""
    h, kv = config.num_heads, config.num_kv_heads
    y = _rms_norm(x, lp["attn_norm"], config.rms_eps, jitted)
    q, k, v = _qkv_proj(y, lp, config, b, t, lget)
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
    x = _attn_out(x, attn, lp, config, b, t, lget)
    x = _mlp_block(x, lp, config, lget, jitted)
    return (x, (k_out, v_out)) if emit_kv else (x, None)


def _layer(params: Params, i: int) -> Params:
    return {name: w[i] for name, w in params["layers"].items()}


def _save_weight_products(ctx, op, *args, **kwargs):
    """``remat_policy="dots"``: keep the outputs of 2-D products (``aten.mm``:
    the weight matmuls, which have no batch dims) and recompute the rest —
    the reference's ``dots_with_no_batch_dims_saveable``."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _lm_head(x, params, config, jitted=False):
    """Final norm + vocabulary projection ([..., D] → [..., V] f32).

    The reference multiplies bf16 operands into an f32 result.  A bf16
    matmul here would round the logits to bf16 and move greedy argmaxes, so
    both operands are upcast: every bf16 product is exact in f32 and the
    sums are f32, the same arithmetic at the price of an f32 copy of the
    head (``torch.mm(out_dtype=)`` has no CPU kernel).  An int8 head's codes
    convert to f32 exactly and its ``[V]`` scale multiplies the logits
    (:func:`~rayfed_tpu_torch.models.quant.split_output_scale`); that
    product saves the int8 codes for the backward, not the f32 copy.
    """
    x = _rms_norm(x, params["final_norm"], config.rms_eps, jitted)
    head = params.get("lm_head")
    xf = x.to(config.dtype).float()
    if head is None:
        return xf @ params["embed"].to(config.dtype).T.float()
    out_scale = output_scale(head)
    if out_scale is not None:
        return int8_product(xf, head.q, out_scale, torch.float32)
    head, _ = split_output_scale(head, config.dtype)
    return xf @ head.float()


def apply_llama(
    params: Params,
    input_ids: torch.Tensor,
    config: LlamaConfig,
    *,
    lora: Optional[Params] = None,
    attn_fn: Callable = dot_product_attention,
    positions: Optional[torch.Tensor] = None,
    jitted: bool = False,
) -> torch.Tensor:
    """Forward: [B, T] ids → [B, T, V] float32 logits (causal LM).

    ``jitted``: the caller stands for a jitted program of the JAX package
    (its train steps); on CPU tensors the norms then take that program's
    bytes (:func:`_rms_norm`).

    ``lora`` is a tree from :func:`rayfed_tpu_torch.models.lora.init_lora`;
    its ``layers`` entries add their bypass to the matching projections.
    With ``config.remat`` each layer runs under ``torch.utils.checkpoint``
    (non-reentrant, so the backward re-runs the layer's forward, flash
    kernel included); ``remat_policy="dots"`` keeps the weight products.
    """
    b, t = input_ids.shape
    x = params["embed"].to(config.dtype)[input_ids]
    if positions is None:
        positions = torch.arange(t, device=input_ids.device)
    cos, sin = rope_tables(positions, config.head_dim, config.rope_theta)
    lora_layers = (lora or {}).get("layers") or {}

    def layer_body(x, i):
        def lget(name):
            entry = lora_layers.get(name)
            if entry is None:
                return None
            return {"a": entry["a"][i], "b": entry["b"][i], "scale": entry["scale"]}

        x, _ = _layer_fwd(x, _layer(params, i), config, cos, sin, attn_fn, b, t, lget, jitted=jitted)
        return x

    if config.remat:
        # The layers draw no random numbers: no RNG state to stash.
        kw: Dict[str, Any] = dict(use_reentrant=False, preserve_rng_state=False)
        if config.remat_policy == "dots":
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _save_weight_products
            )
        elif config.remat_policy is not None:  # unreachable past __post_init__
            raise AssertionError(config.remat_policy)
        body = layer_body
        layer_body = lambda x, i: checkpoint(body, x, i, **kw)  # noqa: E731
    for i in range(config.num_layers):
        x = layer_body(x, i)
    return _lm_head(x, params, config, jitted)


# ---------------------------------------------------------------------------
# KV-cache decoding (autoregressive inference)
# ---------------------------------------------------------------------------


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the trailing (head) dim: [..., Dh] → (int8
    [..., Dh], f32 scale [..., 1]).  Zero vectors quantize to zeros (scale
    floor), so fresh cache slots stay exact.  ``x / scale`` is a true
    division; the scale's ``/ 127`` is XLA's (``xla_cpu.div_const``)."""
    xf = x.to(torch.float32)
    absmax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = xla_cpu.div_const(torch.clamp(absmax, min=1e-12), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def init_kv_cache(
    config: LlamaConfig, batch: int, max_len: int, device: Optional[torch.device] = None
) -> Params:
    """Static-shape KV cache: ``k``/``v`` are zeros [L, B, max_len, KV, Dh].

    With ``config.kv_quant`` the k/v planes are int8 and per-(position,
    head) f32 scales ride alongside as ``k_scale``/``v_scale`` [L, B,
    max_len, KV, 1]: 0.53× the bf16 cache's bytes at head dim 128.
    """
    device = resolve_device(device)
    shape = (config.num_layers, batch, max_len, config.num_kv_heads, config.head_dim)
    if config.kv_quant:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=device),
            "v_scale": torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=config.dtype, device=device),
        "v": torch.zeros(shape, dtype=config.dtype, device=device),
    }


def init_rolling_kv_cache(
    config: LlamaConfig, batch: int, device: Optional[torch.device] = None
) -> Params:
    """Ring-buffer cache of exactly ``sliding_window`` slots: decode memory
    stays O(W) for unbounded generation (pair with
    ``make_decode_step(config, rolling=True)``)."""
    if config.sliding_window is None:
        raise ValueError("a rolling cache requires config.sliding_window")
    return init_kv_cache(config, batch, config.sliding_window, device=device)


def roll_kv_cache(cache: Params, config: LlamaConfig, t0: int) -> Params:
    """Re-layout a (prefilled) linear cache into the rolling ring buffer.

    ``t0``: tokens already in the cache (the prefill length).  Slot ``i`` of
    the ring receives the newest cached position congruent to ``i`` mod W;
    slots whose position would be negative (``t0 < W``) hold whatever the
    clamped source held, which the rolling step's validity arithmetic masks
    out.  Returns new planes (the linear cache is left as it was).
    """
    w = config.sliding_window
    if w is None:
        raise ValueError("roll_kv_cache requires config.sliding_window")
    max_len = cache["k"].shape[2]
    last = t0 - 1
    slots = torch.arange(w, device=cache["k"].device)
    src = last - torch.remainder(last - slots, w)  # absolute position of slot i
    src_idx = torch.clamp(src, 0, max_len - 1)
    return {name: plane.index_select(2, src_idx) for name, plane in cache.items()}


def make_decode_step(config: LlamaConfig, rolling: bool = False):
    """One-token autoregressive step.

    Returns ``step(params, cache, token_ids, pos) -> (cache, logits)``:
    ``token_ids`` is [B] (this position's token per sequence), ``pos`` the
    position as an int; ``logits`` is [B, V] float32 for the NEXT token.
    The cache is written in place (the reference donates it) and returned.

    Attention over the cache is plain torch: bf16 operands are upcast so
    scores and the P·V sum are f32 with exact products, as the reference's
    ``preferred_element_type=f32`` einsums; p is rounded to the activation
    dtype before P·V, as there.  With ``config.kv_quant`` the new k/v are
    quantized into the int8 planes (:func:`_quantize_kv`), the planes are
    read raw (int8 converts exactly), the k scale goes onto the scores and
    the v scale onto p before p is rounded: the cache is never dequantized.

    A linear cache needs ``0 <= pos < max_len`` (else ``ValueError``; the
    reference's write would clamp onto the last slot).  ``rolling``
    (requires ``config.sliding_window``): the cache is a ring of exactly
    ``W`` slots (:func:`init_rolling_kv_cache`, :func:`roll_kv_cache`,
    else ``ValueError``); token ``pos`` writes slot ``pos % W`` and slot
    ``i`` is live iff its absolute position ``pos − ((pos − i) mod W)`` is
    ≥ 0 (the band and causality follow, since every resident position lies
    in ``(pos − W, pos]``).

    A linear cache is read over its live slots only: the prefix ``[0, pos]``
    without a window; with one, the band ``(pos − W, pos]`` gathered in ring
    order (slot ``i`` holds the position ≡ ``i`` mod W), so the linear and
    the rolling step reduce over the same W slots in the same order and give
    the same bytes.  (The reference reduces over all ``max_len`` slots, the
    masked ones as zeros; that changes the reduction's rounding, not what it
    computes.)
    """
    if rolling and config.sliding_window is None:
        raise ValueError("rolling=True requires config.sliding_window")
    h, kvh, dh = config.num_heads, config.num_kv_heads, config.head_dim
    g = h // kvh
    dtype = config.dtype
    quant = config.kv_quant

    @torch.no_grad()
    def step(params, cache, token_ids, pos):
        pos = int(pos)
        b = token_ids.shape[0]
        max_len = cache["k"].shape[2]
        device = token_ids.device
        if rolling:
            # The ring modulus IS the window: a linear cache here would
            # silently widen the attention window.
            if max_len != config.sliding_window:
                raise ValueError(
                    f"rolling decode needs a {config.sliding_window}-slot "
                    f"ring cache (init_rolling_kv_cache/roll_kv_cache), "
                    f"got {max_len} slots"
                )
            if pos < 0:
                raise ValueError(f"position {pos} is negative")
        elif not 0 <= pos < max_len:
            raise ValueError(f"position {pos} is outside the {max_len}-slot cache")
        write_pos = pos % max_len if rolling else pos
        w = config.sliding_window
        if w is None:
            valid, band = None, slice(0, pos + 1)  # the live prefix
        else:
            # Slot i of a W-slot ring holds position pos − ((pos − i) mod W),
            # live iff ≥ 0; a linear cache gathers those positions in order.
            src = pos - torch.remainder(pos - torch.arange(w, device=device), w)
            valid = src >= 0
            band = None if rolling else src.clamp(min=0)

        def live(plane):  # [B, T, ...] -> the slots this step attends to
            if band is None:
                return plane
            if isinstance(band, slice):
                return plane[:, band]
            return plane.index_select(1, band)

        x = params["embed"].to(dtype)[token_ids][:, None, :]  # [B,1,D]
        # The JAX package's decode step is one jitted program.
        cos, sin = rope_tables(torch.tensor([pos], device=device), dh, config.rope_theta, folded=True)
        for i in range(config.num_layers):
            lp = _layer(params, i)
            k_cache = cache["k"][i]  # [B, T, KV, Dh] view into the cache
            v_cache = cache["v"][i]
            y = _rms_norm(x, lp["attn_norm"], config.rms_eps, jitted=True)
            q, k, v = _qkv_proj(y, lp, config, b, 1)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
            if quant:
                k_q, k_s = _quantize_kv(k[:, 0])
                v_q, v_s = _quantize_kv(v[:, 0])
                k_cache[:, write_pos] = k_q
                v_cache[:, write_pos] = v_q
                cache["k_scale"][i][:, write_pos] = k_s
                cache["v_scale"][i][:, write_pos] = v_s
            else:
                k_cache[:, write_pos] = k[:, 0].to(k_cache.dtype)
                v_cache[:, write_pos] = v[:, 0].to(v_cache.dtype)
            qs = (q.reshape(b, h, dh) * dh**-0.5).to(dtype).reshape(b, kvh, g, dh)
            s = torch.einsum(
                "bngd,btnd->bngt", qs.float(), live(k_cache).to(dtype).float()
            )
            if quant:
                # The per-(position, head) k scale is constant over the
                # contracted head dim: it lands on the [B, KV, g, T] scores.
                s = s * live(cache["k_scale"][i])[..., 0].transpose(1, 2)[:, :, None, :]
            if valid is not None:
                s = torch.where(valid, s, NEG_INF)
            p = torch.softmax(s, dim=-1)
            if quant:
                p = p * live(cache["v_scale"][i])[..., 0].transpose(1, 2)[:, :, None, :]
            attn = torch.einsum(
                "bngt,btnd->bngd", p.to(dtype).float(), live(v_cache).to(dtype).float()
            )
            attn = attn.reshape(b, 1, h, dh).to(dtype)
            x = _attn_out(x, attn, lp, config, b, 1)
            x = _mlp_block(x, lp, config, jitted=True)
        return cache, _lm_head(x[:, 0, :], params, config, jitted=True)

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
    the first ``T0`` slots of a zeroed [L, B, max_len, KV, Dh] cache (under
    ``kv_quant`` quantized by the decode step's quantizer, position by
    position).
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
        if config.kv_quant:
            k_q, k_s = _quantize_kv(k_out)
            v_q, v_s = _quantize_kv(v_out)
            cache["k"][i, :, :t0] = k_q
            cache["v"][i, :, :t0] = v_q
            cache["k_scale"][i, :, :t0] = k_s
            cache["v_scale"][i, :, :t0] = v_s
        else:
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


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def lm_loss(logits: torch.Tensor, targets: torch.Tensor, mask=None) -> torch.Tensor:
    """Next-token cross entropy; ``targets``[i] is the label for pos i."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


# (regex, spec) rules for parallel.sharding.shard_params_by_rules: the
# reference's PartitionSpecs as plain tuples (stacked layers lead with L).
PARTITION_RULES = (
    (r"layers/w[qkv]$", (None, "fsdp", "tp")),
    (r"layers/wo$", (None, "tp", "fsdp")),
    (r"layers/w_(gate|up)$", (None, "fsdp", "tp")),
    (r"layers/w_down$", (None, "tp", "fsdp")),
    (r"^embed$", ("tp", "fsdp")),
    (r"^lm_head$", ("fsdp", "tp")),
)


def _adam_update(params, grads, opt, lr, b1, b2, eps, *, inplace=False):
    """Adam step; arithmetic in float32 whatever the storage dtype (params
    and ``m`` may be bfloat16, ``v`` is float32 — see :func:`init_adam`).

    Returns new tensors, or with ``inplace`` writes the results into
    ``params``, ``m``, ``v`` and ``count`` and returns those same tensors.
    """
    count, m, v = opt
    f32 = torch.float32
    new_count = count + 1

    def put(old, new):
        new = new.to(old.dtype)
        return old.copy_(new) if inplace else new

    m = pytree.tree_map(lambda m_, g: put(m_, b1 * m_.to(f32) + (1 - b1) * g.to(f32)), m, grads)
    v = pytree.tree_map(lambda v_, g: put(v_, b2 * v_.to(f32) + (1 - b2) * g.to(f32) ** 2), v, grads)
    # Bias corrections in f32 from the int32 count, as the reference's.
    step = new_count.to(f32)
    mhat_scale = 1.0 / (1 - torch.tensor(b1, dtype=f32, device=step.device) ** step)
    vhat_scale = 1.0 / (1 - torch.tensor(b2, dtype=f32, device=step.device) ** step)
    params = pytree.tree_map(
        lambda p, m_, v_: put(
            p,
            p.to(f32) - lr * (m_.to(f32) * mhat_scale) / (torch.sqrt(v_.to(f32) * vhat_scale) + eps),
        ),
        params, m, v,
    )
    return params, (put(count, new_count), m, v)


def _value_and_grad(loss_fn, tree, *args):
    """``(loss, grads)`` of ``loss_fn(tree, *args)`` w.r.t. every leaf of
    ``tree``.  Leaves are detached aliases (the inputs are not touched); a
    LoRA ``scale`` leaf is used detached by the model and gets a zero grad."""
    leaves, spec = pytree.tree_flatten(tree)
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in leaves]
        loss = loss_fn(pytree.tree_unflatten(leaves, spec), *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    return loss.detach(), pytree.tree_unflatten(grads, spec)


def _lora_loss(config, attn_fn):
    def loss_fn(lora, base_params, ids):
        logits = apply_llama(base_params, ids, config, lora=lora, attn_fn=attn_fn, jitted=True)
        return lm_loss(logits[:, :-1], ids[:, 1:])

    return loss_fn


def _full_loss(config, attn_fn):
    def loss_fn(params, ids):
        logits = apply_llama(params, ids, config, attn_fn=attn_fn, jitted=True)
        return lm_loss(logits[:, :-1], ids[:, 1:])

    return loss_fn


def make_lora_train_step(
    config: LlamaConfig,
    lr: float = 1e-4,
    *,
    attn_fn: Callable = dot_product_attention,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    donate: bool = False,
):
    """Adam train step over **LoRA params only** (base weights frozen).

    Signature: (lora, opt, base_params, ids) → (lora, opt, loss); the
    next-token targets are ``ids`` shifted left.  ``opt`` = (step, m, v)
    from :func:`init_adam`.  By default the inputs are left intact and new
    tensors returned; ``donate=True`` updates ``lora`` and ``opt`` in place
    (the reference donates their buffers) and returns them.
    """
    loss_fn = _lora_loss(config, attn_fn)

    def step(lora, opt, base_params, ids):
        loss, grads = _value_and_grad(loss_fn, lora, base_params, ids)
        lora, opt = _adam_update(lora, grads, opt, lr, b1, b2, eps, inplace=donate)
        return lora, opt, loss

    return step


def make_train_step(
    config: LlamaConfig,
    lr: float = 3e-4,
    *,
    attn_fn: Callable = dot_product_attention,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    donate: bool = False,
):
    """Full-parameter Adam train step: (params, opt, ids) → (params, opt, loss).

    The reference always donates params and both moments; here the inputs
    are left intact unless ``donate=True``, which updates them in place.
    """
    loss_fn = _full_loss(config, attn_fn)

    def step(params, opt, ids):
        loss, grads = _value_and_grad(loss_fn, params, ids)
        params, opt = _adam_update(params, grads, opt, lr, b1, b2, eps, inplace=donate)
        return params, opt, loss

    return step


def make_train_loop(
    config: LlamaConfig,
    num_steps: int,
    lr: float = 3e-4,
    *,
    attn_fn: Callable = dot_product_attention,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    donate: bool = False,
):
    """N full-param Adam steps: (params, opt, ids) → (params, opt, losses[num_steps]).

    The reference's one compiled ``lax.scan``; here N calls of
    :func:`make_train_step`'s step (``donate`` as there).
    """
    step = make_train_step(config, lr, attn_fn=attn_fn, b1=b1, b2=b2, eps=eps, donate=donate)

    def run(params, opt, ids):
        losses = []
        for _ in range(num_steps):
            params, opt, loss = step(params, opt, ids)
            losses.append(loss)
        return params, opt, torch.stack(losses)

    return run


def make_lora_train_loop(
    config: LlamaConfig,
    num_steps: int,
    lr: float = 1e-4,
    *,
    attn_fn: Callable = dot_product_attention,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    donate: bool = False,
):
    """N LoRA Adam steps: (lora, opt, base_params, ids) → (lora, opt, losses[num_steps]).

    N calls of :func:`make_lora_train_step`'s step (``donate`` as there).
    """
    step = make_lora_train_step(
        config, lr, attn_fn=attn_fn, b1=b1, b2=b2, eps=eps, donate=donate
    )

    def run(lora, opt, base_params, ids):
        losses = []
        for _ in range(num_steps):
            lora, opt, loss = step(lora, opt, base_params, ids)
            losses.append(loss)
        return lora, opt, torch.stack(losses)

    return run


def param_count(params: Params, *, exclude_embed: bool = False) -> int:
    """Total parameter count (optionally excluding the embedding table).

    Reads only shapes, so a tree of ``meta`` tensors counts without
    allocating.
    """
    return sum(
        math.prod(leaf.shape)
        for path, leaf in pytree.tree_flatten_with_path(params)[0]
        if not (exclude_embed and "embed" in pytree.keystr(path))
    )


def init_adam(params: Params):
    """Adam state (step, m, v): a 0-d int32 count and zero moments.

    ``v`` is float32 whatever the param storage dtype: with b2=0.999 the
    0.1% per-step EMA change is under half a bf16 ulp, so a bfloat16 second
    moment could grow but never decay.  ``m`` follows the param dtype.  The
    count lives on the params' device.
    """
    leaves = pytree.tree_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")
    return (
        torch.zeros((), dtype=torch.int32, device=device),
        pytree.tree_map(torch.zeros_like, params),
        pytree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
    )
