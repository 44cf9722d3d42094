"""Port's BERT encoder (``rayfed_tpu_torch.models.bert``) and ``mha`` vs the
JAX reference (CPU, f32).

Params are drawn by the reference's ``init_bert`` and carried across with
``convert.bert_params_from_jax``; token ids and activations come from numpy
with a fixed seed.  Attention runs through ``dot_product_attention`` and
through ``flash_attention`` (the reference's Pallas kernel in interpret
mode, the port's plain version on CPU tensors).  Both sides compute in f32
and differ in summation order only: outputs, logits and gradients are held
at atol = rtol = 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayfed_tpu.models import bert as jax_bert
from rayfed_tpu.models.logistic import softmax_cross_entropy as jax_xent
from rayfed_tpu.ops import attention as jax_attention
from rayfed_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.models import bert
from rayfed_tpu_torch.models.convert import bert_params_from_jax
from rayfed_tpu_torch.models.logistic import softmax_cross_entropy, value_and_grad
from rayfed_tpu_torch.ops import attention
from rayfed_tpu_torch.ops.flash_attention import flash_attention

TOL = dict(atol=1e-5, rtol=1e-5)
CPU = torch.device("cpu")
TINY = dict(vocab_size=100, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position=64, num_classes=3)


def _pair(**kw):
    """(jax config, jax params, port config, port params)."""
    jcfg = jax_bert.BertConfig(**{**TINY, **kw})
    jparams = jax_bert.init_bert(jax.random.PRNGKey(0), jcfg)
    params = bert_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device=CPU)
    return jcfg, jparams, bert.BertConfig(**{**TINY, **kw}), params


def _ids(b, t, vocab=100, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, t)).astype(np.int32)


def _jax_flash(q, k, v, **kw):
    return jax_flash_attention(q, k, v, block_q=8, block_k=8, interpret=True, **kw)


ATTN = {"dense": (jax_attention.dot_product_attention, attention.dot_product_attention),
        "flash": (_jax_flash, flash_attention)}


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_bert_base_widths():
    cfg = bert.bert_base()
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.intermediate_size) == (768, 12, 12, 3072)
    assert (cfg.vocab_size, cfg.max_position, cfg.num_classes) == (30522, 512, 2)
    assert cfg.hidden_size // cfg.num_heads == 64


def test_init_bert_has_the_reference_tree():
    jcfg, jparams, cfg, _ = _pair()
    params = bert.init_bert(cfg, torch.Generator().manual_seed(0), device=CPU)
    jleaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    leaves = {"/".join(p): x for p, x in _paths(params)}
    assert sorted(leaves) == sorted("/".join(k.key for k in path) for path, _ in jleaves)
    for path, want in jleaves:
        got = leaves["/".join(k.key for k in path)]
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert torch.all(params["layer1"]["ln2"]["scale"] == 1) and torch.all(params["head"]["bias"] == 0)
    assert abs(params["embeddings"]["word"].std().item() - 0.02) < 2e-3


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_convert_carries_every_leaf_bit_for_bit():
    _, jparams, _, params = _pair()
    for path, want in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        got = params
        for k in path:
            got = got[k.key]
        assert got.numpy().tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_encoder_pooler_head_and_bert_match_the_reference(attn):
    jcfg, jparams, cfg, params = _pair()
    jfn, fn = ATTN[attn]
    ids = _ids(2, 16)
    tids = torch.from_numpy(ids).long()
    jhidden = jax_bert.apply_encoder(jparams, jnp.asarray(ids), jcfg, attn_fn=jfn)
    hidden = bert.apply_encoder(params, tids, cfg, attn_fn=fn)
    _close(hidden, jhidden)
    jpooled = jax_bert.apply_pooler(jparams, jhidden)
    pooled = bert.apply_pooler(params, hidden)
    _close(pooled, jpooled)
    logits = bert.apply_head(params, pooled)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (2, 3)
    _close(logits, jax_bert.apply_head(jparams, jpooled))
    _close(bert.apply_bert(params, tids, cfg, attn_fn=fn),
           jax_bert.apply_bert(jparams, jnp.asarray(ids), jcfg, attn_fn=jfn))


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_encoder_gradients_match_the_reference(attn):
    """The split path's backward: gradients of a classification loss through
    the whole model, flash's through the backward kernels' plain versions."""
    jcfg, jparams, cfg, params = _pair()
    jfn, fn = ATTN[attn]
    ids = _ids(4, 16, seed=2)
    labels = (ids[:, 0] % 3).astype(np.int32)

    def jloss(p):
        return jax_xent(jax_bert.apply_bert(p, jnp.asarray(ids), jcfg, attn_fn=jfn), jnp.asarray(labels))

    jl, jg = jax.value_and_grad(jloss)(jparams)
    loss, grads = value_and_grad(
        lambda p: softmax_cross_entropy(bert.apply_bert(p, torch.from_numpy(ids).long(), cfg, attn_fn=fn),
                                        torch.from_numpy(labels).long()), params)
    _close(loss, jl)
    for path, want in jax.tree_util.tree_flatten_with_path(jg)[0]:
        got = grads
        for k in path:
            got = got[k.key]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=str(path), **TOL)


def test_attention_mask_matches_the_reference_and_flash_refuses_it():
    jcfg, jparams, cfg, params = _pair()
    ids = _ids(2, 8)
    mask = np.array([[1, 1, 1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 1, 1, 0]], np.int32)
    want = jax_bert.apply_encoder(jparams, jnp.asarray(ids), jcfg, attention_mask=jnp.asarray(mask))
    got = bert.apply_encoder(params, torch.from_numpy(ids).long(), cfg, attention_mask=torch.from_numpy(mask))
    _close(got, want)
    with pytest.raises(ValueError, match="dense mask"):
        jax_bert.apply_encoder(jparams, jnp.asarray(ids), jcfg, attention_mask=jnp.asarray(mask),
                               attn_fn=_jax_flash)
    with pytest.raises(ValueError, match="dense mask"):
        bert.apply_encoder(params, torch.from_numpy(ids).long(), cfg,
                           attention_mask=torch.from_numpy(mask), attn_fn=flash_attention)


def test_bert_split_equals_full():
    """tests/test_models.py's test on the port."""
    cfg = bert.BertConfig(vocab_size=100, hidden_size=32, num_layers=2, num_heads=2,
                          intermediate_size=64, max_position=64, num_classes=3)
    params = bert.init_bert(cfg, torch.Generator().manual_seed(0), device=CPU)
    ids = torch.from_numpy(_ids(2, 16))
    full = bert.apply_bert(params, ids, cfg)
    assert tuple(full.shape) == (2, 3)
    enc_params, head_params = bert.split_params(params)
    hidden = bert.apply_encoder(enc_params, ids, cfg)
    pooled = bert.apply_pooler(enc_params, hidden)
    split_logits = bert.apply_head(head_params, pooled)
    np.testing.assert_allclose(full.numpy(), split_logits.numpy(), atol=1e-6)
    assert "head" not in enc_params and set(head_params) == {"head"}


def test_bert_attention_mask():
    """tests/test_models.py's test on the port: changing masked-out tokens
    does not change the unmasked outputs."""
    cfg = bert.BertConfig(vocab_size=50, hidden_size=16, num_layers=1, num_heads=2,
                          intermediate_size=32, max_position=32)
    params = bert.init_bert(cfg, torch.Generator().manual_seed(0), device=CPU)
    ids = torch.from_numpy(_ids(1, 8, vocab=50))
    mask = torch.tensor([[1, 1, 1, 1, 0, 0, 0, 0]])
    out = bert.apply_encoder(params, ids, cfg, attention_mask=mask)
    ids2 = ids.clone()
    ids2[0, 5] = (ids[0, 5] + 7) % 50
    out2 = bert.apply_encoder(params, ids2, cfg, attention_mask=mask)
    np.testing.assert_allclose(out[:, :4].numpy(), out2[:, :4].numpy(), atol=1e-5)
    assert not np.allclose(out[:, 5:].numpy(), out2[:, 5:].numpy())


def test_bf16_activations_keep_f32_params_and_logits():
    """BERT on the card runs bf16 activations over f32 params: the encoder
    gives bf16, the pooler's f32 bias promotes it to f32, the head f32."""
    _, _, cfg, params = _pair(dtype=torch.bfloat16)
    ids = torch.from_numpy(_ids(2, 16))
    hidden = bert.apply_encoder(params, ids, cfg, attn_fn=flash_attention)
    assert hidden.dtype == torch.bfloat16 and tuple(hidden.shape) == (2, 16, 32)
    pooled = bert.apply_pooler(params, hidden)
    assert pooled.dtype == torch.float32
    f32 = bert.apply_encoder(params, ids, bert.BertConfig(**TINY))
    assert torch.allclose(hidden.float(), f32, atol=0.1)
    assert all(x.dtype == torch.float32 for x in tree_util.tree_leaves(params))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_mha_matches_the_reference(causal, attn):
    jfn, fn = ATTN[attn]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    ws = [(rng.standard_normal((32, 32)) * 0.2).astype(np.float32) for _ in range(4)]
    want = jax_attention.mha(jnp.asarray(x), *map(jnp.asarray, ws), num_heads=2, causal=causal, attn_fn=jfn)
    got = attention.mha(torch.from_numpy(x), *map(torch.from_numpy, ws), num_heads=2, causal=causal, attn_fn=fn)
    _close(got, want)


def test_mha_defaults_to_dense_attention():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 8, 16)).astype(np.float32))
    ws = [torch.from_numpy((rng.standard_normal((16, 16)) * 0.2).astype(np.float32)) for _ in range(4)]
    want = attention.mha(x, *ws, num_heads=4, attn_fn=attention.dot_product_attention)
    assert torch.equal(attention.mha(x, *ws, num_heads=4), want)
