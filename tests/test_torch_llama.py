"""Port's Llama serving path vs the JAX reference (CPU, f32, llama_tiny).

Params are drawn by the reference's ``init_llama`` and carried across with
``convert.llama_params_from_jax``; token ids come from numpy with a fixed
seed.  Both sides compute in f32, so they differ only in summation order:
logits and caches are held at atol = rtol = 1e-4, greedy tokens exactly.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from rayfed_tpu.models import llama as jax_llama
from rayfed_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from rayfed_tpu_torch.models import llama
from rayfed_tpu_torch.models.convert import llama_params_from_jax
from rayfed_tpu_torch.models.quant import QTensor
from rayfed_tpu_torch.ops.attention import dot_product_attention
from rayfed_tpu_torch.ops.flash_attention import flash_attention

TOL = dict(atol=1e-4, rtol=1e-4)
CPU = torch.device("cpu")


def _pair(**kw):
    """(jax config, jax params, port config, port params) for llama_tiny."""
    jcfg = jax_llama.llama_tiny(**kw)
    jparams = jax_llama.init_llama(jax.random.PRNGKey(0), jcfg)
    tparams = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device=CPU)
    return jcfg, jparams, llama.llama_tiny(**kw), tparams


def _ids(b, t, vocab=256, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, t)).astype(np.int32)


def _jax_flash(q, k, v, **kw):
    return jax_flash_attention(q, k, v, block_q=8, block_k=8, **kw)


@pytest.mark.parametrize("attn", ["dense", "flash"])
@pytest.mark.parametrize("window", [None, 8])
def test_apply_llama_logits_match(attn, window):
    jcfg, jparams, cfg, params = _pair(sliding_window=window)
    ids = _ids(2, 24)
    ref = jax_llama.apply_llama(
        jparams, jnp.asarray(ids), jcfg,
        attn_fn=_jax_flash if attn == "flash" else jax_llama.dot_product_attention,
    )
    out = llama.apply_llama(
        params, torch.from_numpy(ids).long(), cfg,
        attn_fn=flash_attention if attn == "flash" else dot_product_attention,
    )
    assert out.dtype == torch.float32 and out.shape == (2, 24, 256)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_prefill_cache_and_decode_step_match():
    jcfg, jparams, cfg, params = _pair()
    ids = _ids(2, 12, seed=1)
    jcache, jlogits = jax_llama.prefill(jparams, jcfg, jnp.asarray(ids), 20)
    cache, logits = llama.prefill(
        params, cfg, torch.from_numpy(ids).long(), 20, attn_fn=flash_attention
    )
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for name in ("k", "v"):
        assert cache[name].shape == (2, 2, 20, 2, 16)
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]), **TOL)

    token = np.argmax(np.asarray(jlogits), axis=-1).astype(np.int32)
    jcache, jnext = jax_llama.make_decode_step(jcfg)(jparams, jcache, jnp.asarray(token), 12)
    k_before = cache["k"]
    cache, nxt = llama.make_decode_step(cfg)(params, cache, torch.from_numpy(token).long(), 12)
    assert cache["k"] is k_before  # written in place
    np.testing.assert_allclose(nxt.numpy(), np.asarray(jnext), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]), **TOL)


@pytest.mark.parametrize("window", [None, 8])
def test_greedy_generate_tokens_identical(window):
    jcfg, jparams, cfg, params = _pair(sliding_window=window)
    ids = _ids(2, 10, seed=2)
    ref = jax_llama.greedy_generate(jparams, jcfg, jnp.asarray(ids), 8)
    out = llama.greedy_generate(
        params, cfg, torch.from_numpy(ids).long(), 8, attn_fn=flash_attention
    )
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_decode_matches_forward_at_each_position():
    _, _, cfg, params = _pair(sliding_window=5)
    ids = torch.from_numpy(_ids(1, 12, seed=3)).long()
    full = llama.apply_llama(params, ids, cfg)
    cache, logits = llama.prefill(params, cfg, ids[:, :4], 12)
    step = llama.make_decode_step(cfg)
    for pos in range(4, 12):
        torch.testing.assert_close(logits, full[:, pos - 1], **TOL)
        cache, logits = step(params, cache, ids[:, pos], pos)
    with pytest.raises(ValueError, match="outside"):
        step(params, cache, ids[:, 0], 12)


def test_sampling_is_seeded_and_top1_is_greedy():
    _, _, cfg, params = _pair()
    ids = torch.from_numpy(_ids(2, 6, seed=4)).long()

    def sample(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        return llama.generate(params, cfg, ids, 6, temperature=0.7, generator=g, **kw)

    a, b = sample(0), sample(0)
    assert torch.equal(a, b) and a.shape == (2, 12)
    assert torch.all((a >= 0) & (a < cfg.vocab_size))
    assert torch.equal(sample(1, top_k=1), llama.greedy_generate(params, cfg, ids, 6))


@pytest.mark.parametrize(
    "kw",
    [
        dict(temperature=-1.0),
        dict(temperature=0.5),
        dict(top_k=3),
        dict(temperature=0.5, top_k=0, generator=torch.Generator()),
    ],
)
def test_generate_validation(kw):
    _, _, cfg, params = _pair()
    with pytest.raises(ValueError):
        llama.generate(params, cfg, torch.zeros(1, 4, dtype=torch.long), 2, **kw)


def test_convert_bf16_is_bit_exact():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((5, 7), dtype=np.float32).astype(ml_dtypes.bfloat16)
    a[0, :4] = [np.nan, np.inf, -0.0, 1e-40]  # NaN, inf, signed zero, subnormal
    jax_tree = {"w": np.asarray(jnp.asarray(a)), "layers": {"n": np.ones(3, np.float32)}}
    out = llama_params_from_jax(jax_tree, device=CPU)
    assert out["w"].dtype == torch.bfloat16 and out["layers"]["n"].dtype == torch.float32
    np.testing.assert_array_equal(
        out["w"].view(torch.int16).numpy().view(np.uint16), a.view(np.uint16)
    )
    assert llama_params_from_jax(jax_tree, device=CPU, dtype=torch.float32)["w"].dtype == torch.float32


def test_bf16_params_carry_across_and_run():
    jcfg = jax_llama.llama_tiny(param_dtype=jnp.bfloat16, dtype=jnp.bfloat16)
    jparams = jax_llama.init_llama(jax.random.PRNGKey(1), jcfg)
    params = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device=CPU)
    for name, w in params["layers"].items():
        ref = np.asarray(jparams["layers"][name]).view(np.uint16)
        np.testing.assert_array_equal(w.view(torch.int16).numpy().view(np.uint16), ref)
    cfg = llama.llama_tiny(param_dtype=torch.bfloat16, dtype=torch.bfloat16)
    out = llama.greedy_generate(params, cfg, torch.from_numpy(_ids(1, 8)).long(), 4,
                                attn_fn=flash_attention)
    assert out.shape == (1, 12)


def test_module_state_dict_keys_are_tree_paths():
    jcfg, jparams, cfg, params = _pair()
    model = llama.Llama(cfg, params)
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    jax_keys = {".".join(p.key for p in path) for path, _ in flat}
    assert set(model.state_dict()) == jax_keys
    assert model.state_dict()["layers.wq"].shape == (2, 64, 64)  # [L, D, H·Dh]
    ids = torch.from_numpy(_ids(1, 8)).long()
    torch.testing.assert_close(model(ids), llama.apply_llama(params, ids, cfg))


def test_init_llama_shapes_and_seed():
    cfg = llama.llama_tiny()
    a = llama.init_llama(cfg, torch.Generator().manual_seed(0), device=CPU)
    b = llama.init_llama(cfg, torch.Generator().manual_seed(0), device=CPU)
    ref = jax.eval_shape(lambda: jax_llama.init_llama(jax.random.PRNGKey(0), jax_llama.llama_tiny()))
    flat_ref = {".".join(p.key for p in path): leaf.shape
                for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]}
    flat = {k: v.shape for k, v in llama.Llama(cfg, a).state_dict().items()}
    assert flat == {k: torch.Size(s) for k, s in flat_ref.items()}
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])


def test_config_validation_matches_reference():
    for kw in (dict(sliding_window=0), dict(remat_policy="x"), dict(remat_policy="dots")):
        with pytest.raises(ValueError):
            jax_llama.llama_tiny(**kw)
        with pytest.raises(ValueError):
            llama.llama_tiny(**kw)
    cfg = llama.llama3_8b()
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
            cfg.intermediate_size, cfg.vocab_size, cfg.head_dim) == (32, 4096, 32, 8, 14336, 128256, 128)


def test_unported_features_raise():
    """Every feature of the reference's model is ported: the int8 KV cache,
    the rolling cache and int8 weights construct, and only a rolling step
    without a window raises, as the reference's does."""
    _, _, cfg, params = _pair()
    ids = torch.zeros(1, 4, dtype=torch.long)
    cache = llama.init_kv_cache(llama.llama_tiny(kv_quant=True), 1, 8, device=CPU)
    assert cache["k"].dtype == torch.int8 and cache["k_scale"].shape == (2, 1, 8, 2, 1)
    llama.make_decode_step(llama.llama_tiny(sliding_window=4), rolling=True)
    with pytest.raises(ValueError, match="sliding_window"):
        llama.make_decode_step(cfg, rolling=True)
    assert QTensor(torch.zeros(2, 3, dtype=torch.int8), torch.ones(1, 3)).shape == (2, 3)
    # LoRA and remat are ported: an empty adapter tree and remat change nothing.
    base = llama.apply_llama(params, ids, cfg)
    assert torch.equal(llama.apply_llama(params, ids, cfg, lora={"layers": {}}), base)
    assert torch.equal(llama.apply_llama(params, ids, llama.llama_tiny(remat=True)), base)
