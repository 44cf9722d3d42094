"""Port's LoRA adapters and training steps vs the JAX reference (CPU, f32, llama_tiny).

Base params and adapters are drawn by the reference (``init_llama``,
``init_lora``), B is set non-zero from numpy (with B = 0 the gradient of A
is exactly 0 and a comparison of it is empty), and both are carried across
with ``convert``.  Token ids come from numpy with a fixed seed.  Both sides
compute in f32, so they differ only in summation order: logits, losses and
gradients are held at atol = rtol = 1e-4.  After Adam steps the tolerance
is atol 2e-5 (2% of the lr=1e-3 step) + rtol 1e-4: Adam divides by
sqrt(v), so an element whose gradient is near zero moves by up to a step
on noise alone.
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
from rayfed_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from rayfed_tpu_torch.models import llama, lora
from rayfed_tpu_torch.models.convert import adam_from_jax, llama_params_from_jax, lora_from_jax
from rayfed_tpu_torch.ops.attention import dot_product_attention
from rayfed_tpu_torch.ops.flash_attention import flash_attention

TOL = dict(atol=1e-4, rtol=1e-4)
STEP_TOL = dict(atol=2e-5, rtol=1e-4)
CPU = torch.device("cpu")
LCFG = dict(rank=4, targets=(r"w[qv]$",))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_flash(q, k, v, **kw):
    return jax_flash_attention(q, k, v, block_q=8, block_k=8, **kw)


def _setup(seed=0, **cfg_kw):
    """(jax cfg, jax params, jax lora, port cfg, port params, port lora, ids)."""
    jcfg = jax_llama.llama_tiny(**cfg_kw)
    jparams = jax_llama.init_llama(jax.random.PRNGKey(seed), jcfg)
    jl = jax_lora.init_lora(jax.random.PRNGKey(seed + 1), jparams, jax_lora.LoraConfig(**LCFG))
    rng = np.random.default_rng(seed)
    for entry in jl["layers"].values():
        entry["b"] = jnp.asarray(0.05 * rng.standard_normal(entry["b"].shape, dtype=np.float32))
    ids = rng.integers(0, 256, size=(2, 16)).astype(np.int32)
    params = llama_params_from_jax(_np(jparams), device=CPU)
    tl = lora_from_jax(_np(jl), device=CPU)
    return jcfg, jparams, jl, llama.llama_tiny(**cfg_kw), params, tl, ids


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_tree_close(port_tree, ref_tree, **tol):
    ref = _flat(ref_tree)
    got = _flat(jax.tree_util.tree_map(lambda t: t.numpy(), port_tree))
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], err_msg=name, **tol)


@pytest.mark.parametrize("targets", [(r"w[qv]$",), (r"w[qv]$", r"lm_head$")], ids=["wqv", "wqv_lm_head"])
def test_init_lora_tree_and_shapes_match_reference(targets):
    jcfg = jax_llama.llama_tiny()
    jparams = jax_llama.init_llama(jax.random.PRNGKey(0), jcfg)
    ref = jax_lora.init_lora(jax.random.PRNGKey(1), jparams, jax_lora.LoraConfig(rank=4, targets=targets))
    params = llama_params_from_jax(_np(jparams), device=CPU)
    out = lora.init_lora(params, lora.LoraConfig(rank=4, targets=targets), torch.Generator().manual_seed(1), device=CPU)
    ref_flat = {k: (v.shape, v.dtype) for k, v in _flat(ref).items()}
    got_flat = {k: (v.shape, v.dtype) for k, v in _flat(out).items()}
    assert got_flat == ref_flat
    for path, entry in [(("layers", "wq"), out["layers"]["wq"])] + (
        [(("lm_head",), out["lm_head"])] if len(targets) == 2 else []
    ):
        assert torch.all(entry["b"] == 0) and entry["a"].abs().max() > 0
        assert entry["scale"].dtype == torch.float32 and float(entry["scale"]) == 16.0 / 4
    assert lora.num_lora_params(out) == jax_lora.num_lora_params(ref)
    # Seeded: the same generator seed gives the same draws.
    again = lora.init_lora(params, lora.LoraConfig(rank=4, targets=targets), torch.Generator().manual_seed(1), device=CPU)
    assert torch.equal(again["layers"]["wq"]["a"], out["layers"]["wq"]["a"])


def test_merge_lora_matches_bypass_and_reference():
    jcfg, jparams, jl, cfg, params, tl, ids = _setup()
    merged = lora.merge_lora(params, tl)
    ref_merged = jax_lora.merge_lora(jparams, jl)
    _assert_tree_close(merged, ref_merged, atol=1e-6, rtol=1e-6)
    assert merged["layers"]["wk"] is params["layers"]["wk"]  # untouched leaves shared
    tids = torch.from_numpy(ids).long()
    torch.testing.assert_close(
        llama.apply_llama(merged, tids, cfg), llama.apply_llama(params, tids, cfg, lora=tl), **TOL
    )
    delta = lora.lora_delta(tl["layers"]["wq"])
    np.testing.assert_allclose(delta.numpy(), np.asarray(jax_lora.lora_delta(jl["layers"]["wq"])), atol=1e-7)


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_lora_logits_and_adapter_grads_match_jax(attn):
    jcfg, jparams, jl, cfg, params, tl, ids = _setup(seed=2)
    jattn = _jax_flash if attn == "flash" else jax_llama.dot_product_attention
    tattn = flash_attention if attn == "flash" else dot_product_attention

    def jax_loss(lora_tree):
        logits = jax_llama.apply_llama(jparams, jnp.asarray(ids), jcfg, lora=lora_tree, attn_fn=jattn)
        return jax_llama.lm_loss(logits[:, :-1], jnp.asarray(ids)[:, 1:]), logits

    (ref_loss, ref_logits), ref_grads = jax.value_and_grad(jax_loss, has_aux=True)(jl)
    tids = torch.from_numpy(ids).long()
    logits = llama.apply_llama(params, tids, cfg, lora=tl, attn_fn=tattn)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits), **TOL)

    def loss_fn(tree, base, ids):
        out = llama.apply_llama(base, ids, cfg, lora=tree, attn_fn=tattn)
        return llama.lm_loss(out[:, :-1], ids[:, 1:])

    loss, grads = llama._value_and_grad(loss_fn, tl, params, tids)
    np.testing.assert_allclose(float(loss), float(ref_loss), **TOL)
    assert float(grads["layers"]["wq"]["a"].abs().max()) > 0  # B != 0: A has a gradient
    _assert_tree_close(grads, ref_grads, **TOL)


def test_lora_train_steps_match_reference_and_keep_scale():
    jcfg, jparams, jl, cfg, params, tl, ids = _setup(seed=3)
    jstep = jax_llama.make_lora_train_step(jcfg, lr=1e-3)
    jopt = jax_llama.init_adam(jl)
    tstep = llama.make_lora_train_step(cfg, lr=1e-3)
    opt = adam_from_jax(_np(jopt), device=CPU)
    tids = torch.from_numpy(ids).long()
    scale_before = tl["layers"]["wq"]["scale"].clone()
    tl0, a_before = tl, tl["layers"]["wq"]["a"].clone()
    for _ in range(3):
        jl, jopt, jloss = jstep(jl, jopt, jparams, jnp.asarray(ids))
        tl_new, opt, loss = tstep(tl, opt, params, tids)
        np.testing.assert_allclose(float(loss), float(jloss), **TOL)
        tl = tl_new
    assert torch.equal(tl0["layers"]["wq"]["a"], a_before)  # inputs intact without donate
    _assert_tree_close(tl, jl, **STEP_TOL)
    assert int(opt[0]) == int(jopt[0]) == 3 and opt[0].dtype == torch.int32
    _assert_tree_close(opt[1], jopt[1], **STEP_TOL)
    _assert_tree_close(opt[2], jopt[2], atol=1e-9, rtol=1e-3)
    for entry in tl["layers"].values():
        assert torch.equal(entry["scale"], scale_before)


def test_full_train_step_matches_reference():
    """One full-parameter Adam step, port against reference.

    The loss and the step's gradients are held at TOL and the first moments
    at STEP_TOL.  The updated params are held at STEP_TOL wherever the
    reference's |g| is at least 1e-6.  Below that, Adam's first step,
    lr·g/(|g| + eps) with eps = 1e-8, turns a gradient difference far
    inside TOL into a large share of an lr-sized move: an element with a
    gradient of a few eps moves by anything up to lr, depending on the
    host's summation order (seen: ``layers/wq[0, 56, 1]``, gradient ~5e-8,
    the two updates 7.09e-5 apart).  There each move is held to Adam's own
    bound, |Δw| <= lr·(1 + 1e-3), and, where the reference's g is larger
    than the gap between the two gradients (so its sign is settled), to the
    sign of the reference's move.
    """
    lr = 1e-3
    jcfg, jparams, _, cfg, params, _, ids = _setup(seed=4)
    jopt = jax_llama.init_adam(jparams)
    opt = adam_from_jax(_np(jopt), device=CPU)
    tids = torch.from_numpy(ids).long()

    def jax_loss(p):
        logits = jax_llama.apply_llama(p, jnp.asarray(ids), jcfg)
        return jax_llama.lm_loss(logits[:, :-1], jnp.asarray(ids)[:, 1:])

    _, ref_grads = jax.value_and_grad(jax_loss)(jparams)
    _, grads = llama._value_and_grad(llama._full_loss(cfg, dot_product_attention), params, tids)
    _assert_tree_close(grads, ref_grads, **TOL)

    # The reference donates params and opt: hand it copies.
    jp, jopt, jloss = jax_llama.make_train_step(jcfg, lr=lr)(
        jax.tree_util.tree_map(jnp.copy, jparams), jopt, jnp.asarray(ids)
    )
    embed_before = params["embed"].clone()
    new, opt, loss = llama.make_train_step(cfg, lr=lr)(params, opt, tids)
    assert torch.equal(params["embed"], embed_before)  # inputs intact without donate
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    _assert_tree_close(opt[1], jopt[1], **STEP_TOL)

    ref_new, ref_old, ref_g = _flat(jp), _flat(jparams), _flat(ref_grads)
    got_new = _flat(jax.tree_util.tree_map(lambda t: t.numpy(), new))
    got_g = _flat(jax.tree_util.tree_map(lambda t: t.numpy(), grads))
    assert set(got_new) == set(ref_new)
    for name in ref_new:
        g = np.abs(ref_g[name])
        steady = g >= 1e-6
        np.testing.assert_allclose(got_new[name][steady], ref_new[name][steady], err_msg=name, **STEP_TOL)
        move = got_new[name] - ref_old[name]
        assert np.all(np.abs(move[~steady]) <= lr * (1 + 1e-3)), name
        settled = ~steady & (g > np.abs(got_g[name] - ref_g[name]))
        ref_move = ref_new[name] - ref_old[name]
        assert np.array_equal(np.sign(move[settled]), np.sign(ref_move[settled])), name


@pytest.mark.parametrize("policy", [None, "dots"])
def test_remat_gradients_are_bit_identical(policy):
    _, _, _, cfg, params, tl, ids = _setup(seed=5)
    tids = torch.from_numpy(ids).long()
    grads = []
    for c in (cfg, llama.llama_tiny(remat=True, remat_policy=policy)):
        def loss_fn(tree, base, ids, c=c):
            out = llama.apply_llama(base, ids, c, lora=tree, attn_fn=flash_attention)
            return llama.lm_loss(out[:, :-1], ids[:, 1:])

        grads.append(llama._value_and_grad(loss_fn, tl, params, tids))
    (loss_a, ga), (loss_b, gb) = grads
    assert torch.equal(loss_a, loss_b)
    for x, y in zip(pytree.tree_leaves(ga), pytree.tree_leaves(gb)):
        assert torch.equal(x, y)


def test_remat_reruns_the_layer_forward():
    _, _, _, _, params, tl, ids = _setup(seed=5)
    cfg = llama.llama_tiny(remat=True)
    calls = []

    def counting_attn(q, k, v, **kw):
        calls.append(1)
        return flash_attention(q, k, v, **kw)

    llama.make_lora_train_step(cfg, lr=1e-3, attn_fn=counting_attn)(
        tl, llama.init_adam(tl), params, torch.from_numpy(ids).long()
    )
    assert len(calls) == 2 * cfg.num_layers  # forward + recompute


@pytest.mark.parametrize("which", ["lora", "full"])
def test_train_loops_equal_repeated_steps(which):
    _, _, _, cfg, params, tl, ids = _setup(seed=6)
    tids = torch.from_numpy(ids).long()
    if which == "lora":
        step = llama.make_lora_train_step(cfg, lr=1e-3)
        tree, opt = tl, llama.init_adam(tl)
        losses = []
        for _ in range(3):
            tree, opt, loss = step(tree, opt, params, tids)
            losses.append(loss)
        loop_tree, loop_opt, loop_losses = llama.make_lora_train_loop(cfg, 3, lr=1e-3)(
            tl, llama.init_adam(tl), params, tids
        )
    else:
        step = llama.make_train_step(cfg, lr=1e-3)
        tree, opt = params, llama.init_adam(params)
        losses = []
        for _ in range(2):
            tree, opt, loss = step(tree, opt, tids)
            losses.append(loss)
        loop_tree, loop_opt, loop_losses = llama.make_train_loop(cfg, 2, lr=1e-3)(
            params, llama.init_adam(params), tids
        )
    assert torch.equal(loop_losses, torch.stack(losses))
    for x, y in zip(pytree.tree_leaves(loop_tree), pytree.tree_leaves(tree)):
        assert torch.equal(x, y)
    assert int(loop_opt[0]) == len(losses)


def test_donate_updates_in_place_and_matches():
    _, _, _, cfg, params, tl, ids = _setup(seed=7)
    tids = torch.from_numpy(ids).long()
    ref_tree, ref_opt, ref_loss = llama.make_lora_train_step(cfg, lr=1e-3)(
        tl, llama.init_adam(tl), params, tids
    )
    opt = llama.init_adam(tl)
    a = tl["layers"]["wq"]["a"]
    out_tree, out_opt, loss = llama.make_lora_train_step(cfg, lr=1e-3, donate=True)(tl, opt, params, tids)
    assert out_tree["layers"]["wq"]["a"] is a and out_opt[1]["layers"]["wq"]["a"] is opt[1]["layers"]["wq"]["a"]
    assert torch.equal(loss, ref_loss) and int(opt[0]) == 1
    for x, y in zip(pytree.tree_leaves(out_tree), pytree.tree_leaves(ref_tree)):
        assert torch.equal(x, y)


def test_adam_bf16_storage_and_scale_leaf():
    g = torch.Generator().manual_seed(0)
    p = {"w": torch.randn(4, 3, generator=g).bfloat16(), "scale": torch.tensor(2.0)}
    grads = {"w": torch.randn(4, 3, generator=g), "scale": torch.zeros(())}
    opt = llama.init_adam(p)
    assert opt[1]["w"].dtype == torch.bfloat16 and opt[2]["w"].dtype == torch.float32
    new, (count, m, v) = llama._adam_update(p, grads, opt, 1e-2, 0.9, 0.999, 1e-8)
    jp = {"w": jnp.asarray(p["w"].float().numpy()).astype(jnp.bfloat16), "scale": jnp.asarray(2.0)}
    jg = {"w": jnp.asarray(grads["w"].numpy()), "scale": jnp.zeros(())}
    ref, (jcount, jm, jv) = jax_llama._adam_update(jp, jg, jax_llama.init_adam(jp), 1e-2, 0.9, 0.999, 1e-8)
    assert new["w"].dtype == torch.bfloat16 and float(new["scale"]) == 2.0
    np.testing.assert_array_equal(
        new["w"].view(torch.int16).numpy().view(np.uint16), np.asarray(ref["w"]).view(np.uint16)
    )
    np.testing.assert_allclose(v["w"].numpy(), np.asarray(jv["w"]), rtol=1e-6)


def test_lm_loss_and_param_count_match_reference():
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((2, 5, 11), dtype=np.float32)
    targets = rng.integers(0, 11, size=(2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.4).astype(np.float32)
    for m in (None, mask):
        ref = jax_llama.lm_loss(jnp.asarray(logits), jnp.asarray(targets), None if m is None else jnp.asarray(m))
        out = llama.lm_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)
    jcfg = jax_llama.llama_tiny()
    abstract = jax.eval_shape(lambda: jax_llama.init_llama(jax.random.PRNGKey(0), jcfg))
    meta = jax.tree_util.tree_map(lambda s: torch.empty(s.shape, device="meta"), abstract)
    for ex in (False, True):
        assert llama.param_count(meta, exclude_embed=ex) == jax_llama.param_count(abstract, exclude_embed=ex)


def test_convert_lora_and_adam_state_bit_exact():
    rng = np.random.default_rng(9)
    b = rng.standard_normal((2, 3, 4), dtype=np.float32).astype(ml_dtypes.bfloat16)
    tree = {"layers": {"wq": {"a": rng.standard_normal((2, 5, 3), dtype=np.float32), "b": b,
                              "scale": np.asarray(4.0, np.float32)}}}
    out = lora_from_jax(tree, device=CPU)
    entry = out["layers"]["wq"]
    assert entry["scale"].shape == () and entry["scale"].dtype == torch.float32
    assert entry["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(entry["b"].view(torch.int16).numpy().view(np.uint16), b.view(np.uint16))
    np.testing.assert_array_equal(entry["a"].numpy(), tree["layers"]["wq"]["a"])
    opt = (np.asarray(5, np.int32), tree, {"layers": {"wq": {"a": np.ones((2, 5, 3), np.float32)}}})
    count, m, v = adam_from_jax(opt, device=CPU)
    assert count.dtype == torch.int32 and count.shape == () and int(count) == 5
    assert torch.equal(m["layers"]["wq"]["scale"], torch.tensor(4.0))
    assert isinstance(adam_from_jax(opt, device=CPU), tuple)
