"""BERT-style transformer encoder: the split (vertical) FL workload.

The port of ``rayfed_tpu/models/bert.py``.  It covers BASELINE.md config
#5: alice runs the encoder and pushes pooled activations across the silo
boundary, bob runs the classification head and pushes their gradients back.
:func:`apply_encoder` (with :func:`apply_pooler`) and :func:`apply_head` are
separate functions over separate param subtrees (:func:`split_params`).

Post-LN BERT with learned positions.  Params are a nested dict with the
reference's key names (``embeddings/word``, ``layer{i}/attn/wq``, ...) and
``x @ w`` orientation, so a reference tree converts leaf for leaf
(:func:`rayfed_tpu_torch.models.convert.bert_params_from_jax`).  Attention
is pluggable through ``attn_fn``: :func:`dot_product_attention` by default,
or ``flash_attention``, which on the card runs the Hopper kernels (head dim
64, non-causal at BERT-base's widths) and refuses a dense ``attention_mask``
as the reference's does.  :data:`PARTITION_RULES` are the tensor-parallel
rules for :func:`rayfed_tpu_torch.parallel.sharding.shard_params_by_rules`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from rayfed_tpu_torch.ops import xla_cpu
from rayfed_tpu_torch.ops.attention import dot_product_attention
from rayfed_tpu_torch.utils.platform import resolve_device

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 256
    num_layers: int = 4
    num_heads: int = 4
    intermediate_size: int = 1024
    max_position: int = 512
    num_classes: int = 2
    layer_norm_eps: float = 1e-12
    dtype: Any = torch.float32  # activation dtype


def bert_base(**kw) -> BertConfig:
    """BERT-base's published widths (``bert-base-uncased``): hidden 768, 12
    layers, 12 heads of 64, FFN 3072, vocab 30522, 512 positions."""
    return BertConfig(
        hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072, **kw
    )


def init_bert(
    config: BertConfig,
    generator: torch.Generator,
    device: Optional[torch.device] = None,
) -> Params:
    """Random f32 params (the reference's N(0, 0.02) weights, zero biases,
    unit LayerNorm scales), drawn from ``generator``, which must live on
    ``device``.  The draws differ from the reference's ``jax.random`` ones
    for the same seed."""
    device = resolve_device(device)
    d, f = config.hidden_size, config.intermediate_size

    def dense(d_in, d_out, scale=0.02):
        return torch.randn(d_in, d_out, generator=generator, device=device) * scale

    def zeros(n):
        return torch.zeros(n, device=device)

    def ln(n):
        return {"scale": torch.ones(n, device=device), "bias": zeros(n)}

    params: Params = {
        "embeddings": {
            "word": dense(config.vocab_size, d),
            "position": dense(config.max_position, d),
            "ln": ln(d),
        }
    }
    for i in range(config.num_layers):
        params[f"layer{i}"] = {
            "attn": {
                "wq": dense(d, d), "wk": dense(d, d), "wv": dense(d, d), "wo": dense(d, d),
                "bq": zeros(d), "bk": zeros(d), "bv": zeros(d), "bo": zeros(d),
            },
            "ln1": ln(d),
            "mlp": {"wi": dense(d, f), "bi": zeros(f), "wo": dense(f, d), "bo": zeros(d)},
            "ln2": ln(d),
        }
    params["pooler"] = {"kernel": dense(d, d), "bias": zeros(d)}
    params["head"] = {"kernel": dense(d, config.num_classes), "bias": zeros(config.num_classes)}
    return params


def _layer_norm(x, p, eps, jitted=False):
    """LayerNorm in the activation dtype, population variance.  On f32 CPU
    tensors the value is XLA:CPU's program of the JAX package's norm, op by
    op or inside one jitted program (``jitted``; ops/xla_cpu.py), and the
    gradient PyTorch's."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    out = (x - mean) * torch.rsqrt(var + eps)
    scale, bias = p["scale"].to(x.dtype), p["bias"].to(x.dtype)
    out = out * scale + bias
    if x.device.type == "cpu" and x.dtype == torch.float32:
        exact = xla_cpu.layer_norm(x.detach(), scale.detach(), bias.detach(), eps, jitted)
        out = xla_cpu.ForwardValue.apply(out, exact)
    return out


def apply_encoder(
    params: Params,
    input_ids: torch.Tensor,
    config: BertConfig,
    *,
    attention_mask: Optional[torch.Tensor] = None,
    attn_fn: Callable = dot_product_attention,
    jitted: bool = False,
) -> torch.Tensor:
    """Encoder: [B, T] token ids → [B, T, D] contextual embeddings.

    ``attention_mask`` [B, T] (1 = attend) masks keys; ``flash_attention``
    raises on it.  ``jitted``: the caller stands for a jitted program of the
    JAX package (its split encoder step), whose CPU norms differ from its
    op-by-op ones in the last bit (:func:`_layer_norm`).
    """
    b, t = input_ids.shape
    d, h = config.hidden_size, config.num_heads
    dtype = config.dtype
    emb = params["embeddings"]
    # Gather, then cast: the rows the reference's cast-then-gather gives.
    x = emb["word"][input_ids].to(dtype)
    x = x + emb["position"][:t].to(dtype)[None]
    x = _layer_norm(x, emb["ln"], config.layer_norm_eps, jitted)

    mask = None
    if attention_mask is not None:
        mask = attention_mask[:, None, None, :].bool()  # [B,1,1,T]

    for i in range(config.num_layers):
        layer = params[f"layer{i}"]
        a = layer["attn"]

        def proj(w, bias):
            return (x @ w.to(x.dtype) + bias.to(x.dtype)).reshape(b, t, h, -1)

        q, k, v = proj(a["wq"], a["bq"]), proj(a["wk"], a["bk"]), proj(a["wv"], a["bv"])
        attn = attn_fn(q, k, v, mask=mask) if mask is not None else attn_fn(q, k, v)
        attn = attn.reshape(b, t, d) @ a["wo"].to(x.dtype) + a["bo"].to(x.dtype)
        x = _layer_norm(x + attn, layer["ln1"], config.layer_norm_eps, jitted)

        m = layer["mlp"]
        y = F.gelu(x @ m["wi"].to(x.dtype) + m["bi"].to(x.dtype), approximate="tanh")
        y = y @ m["wo"].to(x.dtype) + m["bo"].to(x.dtype)
        x = _layer_norm(x + y, layer["ln2"], config.layer_norm_eps, jitted)
    return x


def apply_pooler(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """[B, T, D] → [B, D]: the tanh-projected [CLS] (position 0) embedding.
    The bias is added as stored, so f32 params give an f32 result."""
    p = params["pooler"]
    return torch.tanh(hidden[:, 0, :] @ p["kernel"].to(hidden.dtype) + p["bias"])


def apply_head(params: Params, pooled: torch.Tensor) -> torch.Tensor:
    """Classification head over pooled activations: [B, D] → [B, C] f32."""
    p = params["head"]
    return (pooled @ p["kernel"].to(pooled.dtype) + p["bias"]).to(torch.float32)


def apply_bert(
    params: Params,
    input_ids: torch.Tensor,
    config: BertConfig,
    *,
    attention_mask: Optional[torch.Tensor] = None,
    attn_fn: Callable = dot_product_attention,
) -> torch.Tensor:
    """Full model: ids → logits (encoder, pooler and head in one party)."""
    hidden = apply_encoder(
        params, input_ids, config, attention_mask=attention_mask, attn_fn=attn_fn
    )
    return apply_head(params, apply_pooler(params, hidden))


# (regex, spec) rules for parallel.sharding.shard_params_by_rules: the
# reference's PartitionSpecs as plain tuples.
PARTITION_RULES = (
    (r"attn/w[qkv]", (None, "tp")),
    (r"attn/wo", ("tp", None)),
    (r"mlp/wi", (None, "tp")),
    (r"mlp/wo", ("tp", None)),
    (r"embeddings/word", ("fsdp", None)),
    (r"pooler/kernel|head/kernel", (None, None)),
)


def split_params(params: Params) -> Tuple[Params, Params]:
    """Params for split FL: (encoder side, head side).

    The encoder side keeps the embeddings, layers and pooler (alice); the
    head side is the classifier (bob).  The keys are disjoint.
    """
    encoder = {k: v for k, v in params.items() if k != "head"}
    head = {"head": params["head"]}
    return encoder, head
