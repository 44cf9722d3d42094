"""Port's int8 weights (``models/quant.py``) and the int8 Llama base vs the JAX
reference (CPU, f32 activations, llama_tiny), after ``tests/test_quant.py``.

Inputs are drawn with numpy from fixed seeds.  Integer codes and their f32
scales are integer arithmetic or the same float chain on both sides, so they
are held byte for byte.  Products differ only in summation order: logits,
losses and gradients are held at atol = rtol = 1e-4 (TOL), Adam-updated
adapters at STEP_TOL as in ``tests/test_torch_lora.py``.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from rayfed_tpu.models import llama as jax_llama
from rayfed_tpu.models import lora as jax_lora
from rayfed_tpu.models import quant as jax_quant
from rayfed_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.models import llama, lora, quant
from rayfed_tpu_torch.models.convert import adam_from_jax, llama_params_from_jax, lora_from_jax
from rayfed_tpu_torch.ops.attention import dot_product_attention
from rayfed_tpu_torch.ops.flash_attention import flash_attention

TOL = dict(atol=1e-4, rtol=1e-4)
STEP_TOL = dict(atol=2e-5, rtol=1e-4)
CPU = torch.device("cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _assert_q_equal(got, ref):
    assert isinstance(got, quant.QTensor) and isinstance(ref, jax_quant.QTensor)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert tuple(got.q.shape) == ref.q.shape and tuple(got.scale.shape) == ref.scale.shape
    assert _bytes(got.q) == _bytes(ref.q)
    assert _bytes(got.scale) == _bytes(ref.scale)


def _ids(b, t, seed=1, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, t)).astype(np.int32)


def _jax_flash(q, k, v, **kw):
    return jax_flash_attention(q, k, v, block_q=8, block_k=8, **kw)


def _int8_pair(seed=0):
    """(jax cfg, jax int8 params, port cfg, port int8 params): the reference
    quantizes its float base and the port carries the QTensors across."""
    jcfg = jax_llama.llama_tiny()
    jq = jax_llama.quantize_llama_base(jax_llama.init_llama(jax.random.PRNGKey(seed), jcfg))
    return jcfg, jq, llama.llama_tiny(), llama_params_from_jax(_np(jq), device=CPU)


@pytest.mark.parametrize("case", [
    dict(shape=(64, 32), kw={}),
    dict(shape=(4, 16, 8), kw=dict(channel_axis=-1, batch_axes=(0,))),
    dict(shape=(64, 32), kw=dict(channel_axis=0)),
    dict(shape=(48, 40), kw={}, dtype="bfloat16"),
], ids=["per_column", "stacked", "per_row", "bf16"])
def test_quantize_int8_bytes_equal_the_reference(case):
    rng = np.random.default_rng(0)
    w = (0.05 * rng.standard_normal(case["shape"])).astype(np.float32)
    if case.get("dtype") == "bfloat16":
        w = w.astype(ml_dtypes.bfloat16)
        tw = torch.from_numpy(w.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        tw = torch.from_numpy(w)
    ref = jax_quant.quantize_int8(jnp.asarray(w), **case["kw"])
    got = quant.quantize_int8(tw, **case["kw"])
    _assert_q_equal(got, ref)
    assert got.nbytes == ref.nbytes and got.shape == ref.shape and got.ndim == ref.ndim
    assert got.dtype == torch.int8


def test_quantize_roundtrip_error_small():
    rng = np.random.default_rng(1)
    w = torch.from_numpy((0.05 * rng.standard_normal((64, 32))).astype(np.float32))
    qt = quant.quantize_int8(w)
    back = qt.dequantize()
    # Per-channel max-abs int8: the worst error is half a scale per entry.
    assert float((back - w).abs().max()) <= float(qt.scale.max()) / 2 + 1e-7
    x = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))
    ref = x @ w
    assert float((x @ back - ref).abs().max()) <= 2e-2 * float(ref.abs().max())


def test_quantize_batch_axes_per_layer_scales():
    rng = np.random.default_rng(2)
    w = torch.from_numpy(np.stack(
        [(0.01 * (i + 1) * rng.standard_normal((16, 8))).astype(np.float32) for i in range(4)]
    ))
    qt = quant.quantize_int8(w, channel_axis=-1, batch_axes=(0,))
    assert tuple(qt.scale.shape) == (4, 1, 8)
    back = qt.dequantize()
    for layer in range(4):
        rel = float((back[layer] - w[layer]).abs().max() / w[layer].abs().max())
        assert rel < 0.01, (layer, rel)
    # Slicing a layer keeps its own scales.
    one = qt[2]
    assert tuple(one.q.shape) == (16, 8) and tuple(one.scale.shape) == (1, 8)
    assert torch.equal(one.dequantize(), back[2])
    assert tuple(qt[1:3].scale.shape) == (2, 1, 8)


def test_quantize_tree_and_nbytes_equal_the_reference():
    rng = np.random.default_rng(3)
    tree = {"w": rng.standard_normal((8, 8)).astype(np.float32), "norm": np.ones(8, np.float32),
            "blocks": [rng.standard_normal((2, 4, 6)).astype(np.float32)]}
    ref = jax_quant.quantize_tree(jax.tree_util.tree_map(jnp.asarray, tree))
    got = quant.quantize_tree(pytree.tree_map(torch.from_numpy, tree))
    _assert_q_equal(got["w"], ref["w"])
    _assert_q_equal(got["blocks"][0], ref["blocks"][0])
    assert not quant.is_quantized(got["norm"]) and torch.equal(got["norm"], torch.ones(8))
    assert quant.tree_nbytes(got) == jax_quant.tree_nbytes(ref)
    assert quant.tree_nbytes(got) < quant.tree_nbytes(pytree.tree_map(torch.from_numpy, tree))
    picked = quant.quantize_tree(pytree.tree_map(torch.from_numpy, tree),
                                 predicate=lambda path, leaf: path.startswith("blocks"))
    assert quant.is_quantized(picked["blocks"][0]) and not quant.is_quantized(picked["w"])


def test_quantize_llama_base_bytes_equal_the_reference():
    jcfg = jax_llama.llama_tiny()
    jparams = jax_llama.init_llama(jax.random.PRNGKey(0), jcfg)
    ref = jax_llama.quantize_llama_base(jparams)
    got = llama.quantize_llama_base(llama_params_from_jax(_np(jparams), device=CPU))
    for name in llama._QUANT_LEAVES:
        _assert_q_equal(got["layers"][name], ref["layers"][name])
    _assert_q_equal(got["lm_head"], ref["lm_head"])
    for name in ("attn_norm", "mlp_norm"):
        assert _bytes(got["layers"][name]) == _bytes(ref["layers"][name])
    assert _bytes(got["embed"]) == _bytes(ref["embed"])
    # int8 layers and head: under half the f32 storage, as the reference's.
    full = llama_params_from_jax(_np(jparams), device=CPU)
    assert quant.tree_nbytes(got) == jax_quant.tree_nbytes(ref) < 0.45 * quant.tree_nbytes(full)


def test_convert_carries_a_reference_qtensor_tree_bit_exact():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((6, 5)).astype(np.float32)
    jtree = {"w": jax_quant.quantize_int8(jnp.asarray(w)), "b": jnp.ones(5, jnp.bfloat16),
             "stack": jax_quant.quantize_int8(jnp.asarray(rng.standard_normal((3, 6, 5)), jnp.float32),
                                              batch_axes=(0,))}
    got = llama_params_from_jax(_np(jtree), device=CPU)
    _assert_q_equal(got["w"], jtree["w"])
    _assert_q_equal(got["stack"], jtree["stack"])
    assert got["b"].dtype == torch.bfloat16
    # A dtype cast reaches the float leaves only.
    cast = llama_params_from_jax(_np(jtree), device=CPU, dtype=torch.float32)
    assert cast["b"].dtype == torch.float32 and cast["w"].q.dtype == torch.int8
    # The port's tree_util sees a QTensor as a node of (q, scale).
    leaves, treedef = tree_util.tree_flatten(got["w"])
    assert len(leaves) == 2 and leaves[0] is got["w"].q
    assert isinstance(tree_util.tree_unflatten(leaves, treedef), quant.QTensor)


def test_init_llama_int8_shapes_dtypes_and_module():
    jcfg = jax_llama.llama_tiny()
    ref = jax.eval_shape(lambda: jax_llama.init_llama_int8(jax.random.PRNGKey(0), jcfg))
    cfg = llama.llama_tiny()
    params = llama.init_llama_int8(cfg, torch.Generator().manual_seed(0), device=CPU)

    def spec(tree, qcls):
        flat = pytree.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, qcls))[0] \
            if qcls is quant.QTensor else jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, qcls))[0]
        out = {}
        for path, leaf in flat:
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            if isinstance(leaf, qcls):
                out[key] = (tuple(leaf.q.shape), str(leaf.q.dtype).split(".")[-1],
                            tuple(leaf.scale.shape), str(leaf.scale.dtype).split(".")[-1])
            else:
                out[key] = (tuple(leaf.shape), str(leaf.dtype).split(".")[-1])
        return out

    assert spec(params, quant.QTensor) == spec(ref, jax_quant.QTensor)
    wq = params["layers"]["wq"]
    assert int(wq.q.min()) >= -127 and int(wq.q.max()) <= 127
    torch.testing.assert_close(wq.scale, torch.full_like(wq.scale, 64**-0.5 / 73.0))
    again = llama.init_llama_int8(cfg, torch.Generator().manual_seed(0), device=CPU)
    assert torch.equal(again["layers"]["w_up"].q, params["layers"]["w_up"].q)
    logits = llama.apply_llama(params, torch.from_numpy(_ids(2, 16)).long(), cfg)
    assert logits.shape == (2, 16, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    # The module holds int8 weights as buffers, never as parameters.
    model = llama.Llama(cfg, params)
    state = model.state_dict()
    assert state["layers.wq.q"].dtype == torch.int8 and state["lm_head.scale"].shape == (1, 256)
    assert all(p.dtype != torch.int8 for p in model.parameters())
    assert {n for n, _ in model.named_parameters()} == {
        "embed", "final_norm", "layers.attn_norm", "layers.mlp_norm"}
    torch.testing.assert_close(model(torch.from_numpy(_ids(2, 16)).long()), logits, rtol=0, atol=0)


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_int8_forward_matches_the_reference(attn):
    jcfg, jq, cfg, params = _int8_pair()
    ids = _ids(2, 16)
    ref = jax_llama.apply_llama(jq, jnp.asarray(ids), jcfg,
                                attn_fn=_jax_flash if attn == "flash" else jax_llama.dot_product_attention)
    got = llama.apply_llama(params, torch.from_numpy(ids).long(), cfg,
                            attn_fn=flash_attention if attn == "flash" else dot_product_attention)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # Weight-only int8 stays close to the float forward (the reference's
    # own bound).
    fparams = llama_params_from_jax(_np(jax_llama.init_llama(jax.random.PRNGKey(0), jcfg)), device=CPU)
    full = llama.apply_llama(fparams, torch.from_numpy(ids).long(), cfg)
    assert float((got - full).abs().max()) / (float(full.abs().max()) + 1e-6) < 0.1


def _int8_lora(seed=0):
    jcfg, jq, cfg, params = _int8_pair(seed)
    jl = jax_lora.init_lora(jax.random.PRNGKey(seed + 1), jq, jax_lora.LoraConfig(rank=4))
    rng = np.random.default_rng(seed)
    for entry in jl["layers"].values():  # B != 0: A gets a gradient
        entry["b"] = jnp.asarray(0.05 * rng.standard_normal(entry["b"].shape, dtype=np.float32))
    return jcfg, jq, jl, cfg, params, lora_from_jax(_np(jl), device=CPU)


def test_lora_over_int8_base_logits_and_grads_match_the_reference():
    jcfg, jq, jl, cfg, params, tl = _int8_lora(seed=2)
    ids = _ids(2, 16, seed=2)
    # The adapters mirror the logical weights through QTensor leaves.
    got_init = lora.init_lora(params, lora.LoraConfig(rank=4), torch.Generator().manual_seed(1), device=CPU)
    assert set(got_init["layers"]) == set(jl["layers"]) == {"wq", "wv"}
    assert tuple(got_init["layers"]["wq"]["a"].shape) == jl["layers"]["wq"]["a"].shape

    def jax_loss(tree):
        logits = jax_llama.apply_llama(jq, jnp.asarray(ids), jcfg, lora=tree)
        return jax_llama.lm_loss(logits[:, :-1], jnp.asarray(ids)[:, 1:]), logits

    (ref_loss, ref_logits), ref_grads = jax.value_and_grad(jax_loss, has_aux=True)(jl)
    tids = torch.from_numpy(ids).long()
    logits = llama.apply_llama(params, tids, cfg, lora=tl)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits), **TOL)
    loss, grads = llama._value_and_grad(llama._lora_loss(cfg, dot_product_attention), tl, params, tids)
    np.testing.assert_allclose(float(loss), float(ref_loss), **TOL)
    for name in ("wq", "wv"):
        for leaf in ("a", "b"):
            np.testing.assert_allclose(grads["layers"][name][leaf].numpy(),
                                       np.asarray(ref_grads["layers"][name][leaf]), err_msg=name, **TOL)


def test_lora_train_steps_over_int8_base_match_the_reference():
    jcfg, jq, jl, cfg, params, tl = _int8_lora(seed=3)
    ids = _ids(2, 16, seed=3)
    jstep = jax_llama.make_lora_train_step(jcfg, lr=1e-3)
    jopt = jax_llama.init_adam(jl)
    step = llama.make_lora_train_step(cfg, lr=1e-3)
    opt = adam_from_jax(_np(jopt), device=CPU)
    tids = torch.from_numpy(ids).long()
    q_before = params["layers"]["wq"].q.clone()
    losses = []
    for _ in range(4):
        jl, jopt, jloss = jstep(jl, jopt, jq, jnp.asarray(ids))
        tl, opt, loss = step(tl, opt, params, tids)
        np.testing.assert_allclose(float(loss), float(jloss), **TOL)
        losses.append(float(loss))
    assert losses[-1] < losses[0] and np.isfinite(losses[-1])
    assert torch.equal(params["layers"]["wq"].q, q_before)  # the base stays frozen
    for name in ("wq", "wv"):
        for leaf in ("a", "b"):
            np.testing.assert_allclose(tl["layers"][name][leaf].numpy(),
                                       np.asarray(jl["layers"][name][leaf]), err_msg=name, **STEP_TOL)


def test_int8_product_saves_the_codes_and_matches_autograd():
    rng = np.random.default_rng(5)
    qt = quant.quantize_int8(torch.from_numpy(rng.standard_normal((32, 24)).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((3, 5, 32)).astype(np.float32)).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.dtype) or t, lambda t: t):
        out = quant.matmul(x, qt, torch.float32)
    assert saved == [torch.int8, torch.float32]  # q and the [D_out] scale, no converted copy
    (g,) = torch.autograd.grad(out.square().sum(), x)
    x2 = x.detach().requires_grad_(True)
    plain = (x2 @ qt.q.to(torch.float32)) * qt.scale.reshape(-1)
    (g2,) = torch.autograd.grad(plain.square().sum(), x2)
    assert torch.equal(out.detach(), plain.detach()) and torch.equal(g, g2)


def test_merge_lora_rejects_an_int8_base():
    _, jq, jl, _, params, tl = _int8_lora()
    with pytest.raises(TypeError, match="quantized"):
        jax_lora.merge_lora(jq, jl)
    with pytest.raises(TypeError, match="quantized"):
        lora.merge_lora(params, tl)


def test_output_scale_equivalence_matches_the_reference():
    rng = np.random.default_rng(6)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    for kw in ({}, dict(channel_axis=0)):  # output-side scale, then the dequantize fallback
        qt = quant.quantize_int8(tw, **kw)
        out = quant.matmul(tx, qt, torch.float32)
        torch.testing.assert_close(out, tx @ qt.dequantize(torch.float32), rtol=1e-5, atol=1e-5)
        ref = jax_quant.matmul(jnp.asarray(x), jax_quant.quantize_int8(jnp.asarray(w), **kw), jnp.float32)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    operand, out_scale = quant.split_output_scale(quant.quantize_int8(tw), torch.float32)
    assert operand.dtype == torch.float32 and tuple(out_scale.shape) == (32,)
    assert quant.split_output_scale(quant.quantize_int8(tw, channel_axis=0), torch.float32)[1] is None
    torch.testing.assert_close(quant.matmul(tx, tw, torch.float32), tx @ tw, rtol=1e-6, atol=0)


def test_zero_dim_scale():
    rng = np.random.default_rng(7)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    q = np.clip(np.round(w / 0.01), -127, 127).astype(np.int8)
    qt = quant.QTensor(torch.from_numpy(q), torch.tensor(0.01))
    operand, out_scale = quant.split_output_scale(qt, torch.float32)
    assert tuple(out_scale.shape) == (1,)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    out = quant.matmul(torch.from_numpy(x), qt, torch.float32)
    torch.testing.assert_close(out, torch.from_numpy(x) @ qt.dequantize(torch.float32), rtol=1e-5, atol=1e-5)
    ref = jax_quant.matmul(jnp.asarray(x), jax_quant.QTensor(jnp.asarray(q), jnp.asarray(0.01, jnp.float32)),
                           jnp.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert tuple(qt[3].q.shape) == (8,) and qt[3].scale.ndim == 0


def test_int8_decode_matches_the_int8_forward_and_the_reference():
    jcfg, jq, cfg, params = _int8_pair()
    ids = _ids(2, 8)
    forward = llama.apply_llama(params, torch.from_numpy(ids).long(), cfg)
    cache = llama.init_kv_cache(cfg, 2, 8, device=CPU)
    jcache = jax_llama.init_kv_cache(jcfg, 2, 8)
    step, jstep = llama.make_decode_step(cfg), jax_llama.make_decode_step(jcfg)
    for t in range(8):
        cache, logits = step(params, cache, torch.from_numpy(ids[:, t]).long(), t)
        jcache, jlogits = jstep(jq, jcache, jnp.asarray(ids[:, t]), t)
        np.testing.assert_allclose(logits.numpy(), forward[:, t].numpy(), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
