"""Port's int8 KV cache and rolling (ring-buffer) cache vs the JAX reference
(CPU, f32, llama_tiny), after ``tests/test_models.py``'s cache tests.

Params are drawn by the reference's ``init_llama`` and carried across with
``convert``; prompts come from numpy with a fixed seed.  ``_quantize_kv``'s
codes and scales are held byte for byte.  Decode logits are held against the
port's own linear decode (rolling) or full forward at the reference's
tolerances (2e-4, and 0.15 with 90% greedy agreement for the int8 cache),
and against the reference's decode on the same tokens at CROSS_TOL: both
sides compute in f32 and differ in summation order only, which an int8 code
may turn into one step of its grid.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from rayfed_tpu.models import llama as jax_llama
from rayfed_tpu_torch.models import llama
from rayfed_tpu_torch.models.convert import llama_params_from_jax

CPU = torch.device("cpu")
DEC_TOL = dict(rtol=2e-4, atol=2e-4)
CROSS_TOL = {False: dict(rtol=1e-4, atol=1e-4), True: dict(rtol=1e-3, atol=1e-3)}


def _pair(**kw):
    jcfg = jax_llama.llama_tiny(**kw)
    jparams = jax_llama.init_llama(jax.random.PRNGKey(0), jcfg)
    params = llama_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device=CPU)
    return jcfg, jparams, llama.llama_tiny(**kw), params


def _ids(b, t, seed=1):
    return np.random.default_rng(seed).integers(0, 256, size=(b, t)).astype(np.int32)


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bytes_equal_the_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32)
    x[0, 0, 1] = 0.0  # a zero vector quantizes to zeros under the scale floor
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
        tx = torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        tx = torch.from_numpy(x)
    # Jitted, as the reference's prefill and decode step run it: XLA turns
    # the scale's division by 127.0 into a product with f32(1/127).
    rq, rs = jax.jit(jax_llama._quantize_kv)(jnp.asarray(x))
    q, s = llama._quantize_kv(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and tuple(s.shape) == (3, 5, 2, 1)
    assert _bytes(q) == _bytes(rq) and _bytes(s) == _bytes(rs)
    assert not q[0, 0, 1].any()


def test_kv_quant_decode_close_compact_and_equal_to_the_reference():
    jcfg0, jparams, cfg0, params = _pair()
    jcfg, cfg = jax_llama.llama_tiny(kv_quant=True), llama.llama_tiny(kv_quant=True)
    ids = _ids(2, 12)
    ref = llama.apply_llama(params, torch.from_numpy(ids).long(), cfg0).numpy()
    cache = llama.init_kv_cache(cfg, 2, 12, device=CPU)
    jcache = jax_llama.init_kv_cache(jcfg, 2, 12)
    step, jstep = llama.make_decode_step(cfg), jax_llama.make_decode_step(jcfg)
    outs = []
    for t in range(12):
        cache, logits = step(params, cache, torch.from_numpy(ids[:, t]).long(), t)
        jcache, jlogits = jstep(jparams, jcache, jnp.asarray(ids[:, t]), t)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **CROSS_TOL[True])
        outs.append(logits.numpy())
    dec = np.stack(outs, axis=1)
    assert np.max(np.abs(dec - ref)) < 0.15
    assert (dec.argmax(-1) == ref.argmax(-1)).mean() >= 0.9
    # int8 + per-(pos, head) f32 scales over Dh=16: 1.25 bytes per element
    # against 4 in the f32 cache.
    bytes_q = sum(v.numel() * v.element_size() for v in cache.values())
    bytes_f = sum(v.numel() * v.element_size() for v in llama.init_kv_cache(cfg0, 2, 12, device=CPU).values())
    assert bytes_q / bytes_f < 0.35
    assert bytes_q == sum(v.nbytes for v in jcache.values())


def test_kv_quant_prefill_matches_sequential_and_the_reference():
    jcfg, jparams, cfg, params = _pair(kv_quant=True)
    ids = _ids(2, 8)
    tids = torch.from_numpy(ids).long()
    cache_p, logits_p = llama.prefill(params, cfg, tids, 12)
    jcache_p, jlogits_p = jax_llama.prefill(jparams, jcfg, jnp.asarray(ids), 12)
    np.testing.assert_allclose(logits_p.numpy(), np.asarray(jlogits_p), **CROSS_TOL[True])
    cache_s = llama.init_kv_cache(cfg, 2, 12, device=CPU)
    step = llama.make_decode_step(cfg)
    for t in range(8):
        cache_s, _ = step(params, cache_s, tids[:, t], t)
    for plane, scale in (("k", "k_scale"), ("v", "v_scale")):
        deq_p = cache_p[plane].float() * cache_p[scale]
        deq_s = cache_s[plane].float() * cache_s[scale]
        deq_j = np.asarray(jcache_p[plane], np.float32) * np.asarray(jcache_p[scale])
        # Bounded relative to each row's absmax (the int8 budget), as the
        # reference's own test does.
        row = np.maximum(np.abs(deq_s.numpy()).max(axis=-1, keepdims=True), 1e-9)
        assert np.max(np.abs(deq_p.numpy() - deq_s.numpy()) / row) < 0.05
        assert np.max(np.abs(deq_p.numpy() - deq_j) / row) < 0.05
        assert not cache_p[plane][:, :, 8:].any() and not cache_p[scale][:, :, 8:].any()


def test_kv_quant_generate_matches_exact_and_the_reference():
    jcfg0, jparams, cfg0, params = _pair()
    jcfg, cfg = jax_llama.llama_tiny(kv_quant=True), llama.llama_tiny(kv_quant=True)
    ids = _ids(2, 8)
    tids = torch.from_numpy(ids).long()
    exact = llama.greedy_generate(params, cfg0, tids, 6)
    quant = llama.greedy_generate(params, cfg, tids, 6)
    ref = jax_llama.greedy_generate(jparams, jcfg, jnp.asarray(ids), 6)
    assert quant.shape == exact.shape == (2, 14)
    assert torch.equal(quant[:, :10], exact[:, :10])
    np.testing.assert_array_equal(quant.numpy(), np.asarray(ref))


def _run_rolling(kv_quant, window, t0, n_new, batch):
    """Rolling vs linear decode in the port, and the port's rolling decode
    vs the reference's, every step on the same tokens (the reference's
    linear greedy choices)."""
    jcfg, jparams, cfg, params = _pair(sliding_window=window, kv_quant=kv_quant)
    ids = _ids(batch, t0)
    max_len = t0 + n_new
    cache_lin, logits_lin = llama.prefill(params, cfg, torch.from_numpy(ids).long(), max_len)
    jcache_lin, jlogits = jax_llama.prefill(jparams, jcfg, jnp.asarray(ids), max_len)
    cache_roll = llama.roll_kv_cache(cache_lin, cfg, t0)
    jcache_roll = jax_llama.roll_kv_cache(jcache_lin, jcfg, t0)
    assert cache_roll["k"].shape[2] == window  # O(W) memory
    for name in cache_roll:
        assert tuple(cache_roll[name].shape) == jcache_roll[name].shape
    step_lin, step_roll = llama.make_decode_step(cfg), llama.make_decode_step(cfg, rolling=True)
    jstep_roll = jax_llama.make_decode_step(jcfg, rolling=True)
    tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
    for i in range(n_new):
        t = torch.from_numpy(tok).long()
        cache_lin, l_lin = step_lin(params, cache_lin, t, t0 + i)
        cache_roll, l_roll = step_roll(params, cache_roll, t, t0 + i)
        jcache_roll, jl_roll = jstep_roll(jparams, jcache_roll, jnp.asarray(tok), t0 + i)
        np.testing.assert_allclose(l_roll.numpy(), l_lin.numpy(), err_msg=f"step {i}", **DEC_TOL)
        np.testing.assert_allclose(l_roll.numpy(), np.asarray(jl_roll), err_msg=f"step {i}",
                                   **CROSS_TOL[kv_quant])
        tok = np.asarray(jl_roll).argmax(-1).astype(np.int32)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_rolling_cache_matches_linear_and_the_reference(kv_quant):
    _run_rolling(kv_quant, window=4, t0=6, n_new=10, batch=2)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_rolling_cache_deep_wraparound(kv_quant):
    """pos ≫ window: 100 tokens over a 16-slot ring (6+ overwrite cycles)."""
    _run_rolling(kv_quant, window=16, t0=7, n_new=100, batch=2)


def _deep_trajectory(kv_quant, window=16, t0=7, n_new=100, batch=2):
    """test_rolling_cache_deep_wraparound's trajectory, step by step: yields
    (step, pos, port linear cache, its logits, port rolling cache, its
    logits, reference linear cache) after each decode step on the same
    tokens (the reference's rolling greedy choices)."""
    jcfg, jparams, cfg, params = _pair(sliding_window=window, kv_quant=kv_quant)
    ids = _ids(batch, t0)
    max_len = t0 + n_new
    cache_lin, _ = llama.prefill(params, cfg, torch.from_numpy(ids).long(), max_len)
    jcache_lin, jlogits = jax_llama.prefill(jparams, jcfg, jnp.asarray(ids), max_len)
    cache_roll = llama.roll_kv_cache(cache_lin, cfg, t0)
    jcache_roll = jax_llama.roll_kv_cache(jcache_lin, jcfg, t0)
    step_lin, step_roll = llama.make_decode_step(cfg), llama.make_decode_step(cfg, rolling=True)
    jstep_lin, jstep_roll = jax_llama.make_decode_step(jcfg), jax_llama.make_decode_step(jcfg, rolling=True)
    tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
    for i in range(n_new):
        t = torch.from_numpy(tok).long()
        cache_lin, l_lin = step_lin(params, cache_lin, t, t0 + i)
        cache_roll, l_roll = step_roll(params, cache_roll, t, t0 + i)
        jcache_lin, _ = jstep_lin(jparams, jcache_lin, jnp.asarray(tok), t0 + i)
        jcache_roll, jl_roll = jstep_roll(jparams, jcache_roll, jnp.asarray(tok), t0 + i)
        yield i, t0 + i, cache_lin, l_lin, cache_roll, l_roll, jcache_lin
        tok = np.asarray(jl_roll).argmax(-1).astype(np.int32)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_linear_and_rolling_steps_write_the_same_bytes(kv_quant):
    """The linear step reads its window's band in ring order, so it and the
    rolling step reduce over the same slots in the same order: the slot each
    writes and the logits are the same bytes at every step."""
    window = 16
    for i, pos, lin, l_lin, roll, l_roll, _ in _deep_trajectory(kv_quant, window=window):
        for name in lin:
            assert _bytes(lin[name][:, :, pos]) == _bytes(roll[name][:, :, pos % window]), (i, name)
        assert _bytes(l_lin) == _bytes(l_roll), i


def test_linear_int8_codes_equal_the_reference():
    """The port's linear int8 decode writes the reference's int8 k/v codes at
    every step of test_rolling_cache_deep_wraparound's trajectory (the f32
    scales may differ in the last bit: both sides' RMSNorm rounds otherwise
    than XLA's, from its reduction order and its rsqrt)."""
    for i, pos, lin, _, _, _, jlin in _deep_trajectory(True):
        for name in ("k", "v"):
            got, want = lin[name][:, :, pos].numpy(), np.asarray(jlin[name])[:, :, pos]
            diff = np.argwhere(got != want)
            assert not diff.size, (
                f"step {i} (pos {pos}): {len(diff)} {name} codes differ, first at [layer, batch, head, dim] = "
                f"{diff[0].tolist()}: port {got[tuple(diff[0])]}, reference {want[tuple(diff[0])]}")


@pytest.mark.parametrize("kv_quant", [False, True])
def test_rolling_cache_short_prompt(kv_quant):
    """t0 < W: unwritten ring slots must be masked, not attended."""
    _run_rolling(kv_quant, window=8, t0=3, n_new=5, batch=1)


def test_roll_kv_cache_equals_the_reference_gather():
    jcfg, jparams, cfg, params = _pair(sliding_window=4, kv_quant=True)
    ids = _ids(2, 6)
    cache, _ = llama.prefill(params, cfg, torch.from_numpy(ids).long(), 9)
    for t0 in (2, 4, 6):
        got = llama.roll_kv_cache(cache, cfg, t0)
        ref = jax_llama.roll_kv_cache({k: jnp.asarray(v.numpy()) for k, v in cache.items()}, jcfg, t0)
        for name in cache:
            assert _bytes(got[name]) == _bytes(ref[name]), (t0, name)


def test_rolling_requires_a_window_and_a_ring_cache():
    cfg = llama.llama_tiny()
    with pytest.raises(ValueError, match="sliding_window"):
        llama.make_decode_step(cfg, rolling=True)
    with pytest.raises(ValueError, match="sliding_window"):
        llama.init_rolling_kv_cache(cfg, 1, device=CPU)
    with pytest.raises(ValueError, match="sliding_window"):
        llama.roll_kv_cache(llama.init_kv_cache(cfg, 1, 8, device=CPU), cfg, 4)
    _, _, wcfg, params = _pair(sliding_window=4)
    ring = llama.init_rolling_kv_cache(wcfg, 1, device=CPU)
    assert ring["k"].shape == (2, 1, 4, 2, 16)
    step = llama.make_decode_step(wcfg, rolling=True)
    with pytest.raises(ValueError, match="4-slot ring"):
        step(params, llama.init_kv_cache(wcfg, 1, 8, device=CPU), torch.zeros(1, dtype=torch.long), 0)
    # The ring takes positions past its size; a linear cache does not.
    step(params, ring, torch.zeros(1, dtype=torch.long), 11)
    with pytest.raises(ValueError, match="outside"):
        llama.make_decode_step(wcfg)(params, llama.init_kv_cache(wcfg, 1, 8, device=CPU),
                                     torch.zeros(1, dtype=torch.long), 8)
