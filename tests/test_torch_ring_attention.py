"""Ring, flash-ring, zigzag and Ulysses attention of the port against the
JAX package's (``tests/test_ops_attention.py``'s cases, and
``test_llama_ring_sp_matches_dense``'s).

The same numpy inputs go through the JAX builders on the 8-device CPU mesh
(the flash kernels in interpret mode, as the reference's tests run them)
and through the port's builders on a world of 4 gloo ranks on the CPU,
spawned once for the module (each case is a test of its own that reads
its stored result; every rank must return the same values).  Where the
reference's test used an 8-way axis, the port's world has 4 ranks.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayfed_tpu.models import llama as jax_llama
from rayfed_tpu.ops import attention as jax_attention
from rayfed_tpu.ops import make_ring_attention as jax_make_ring
from rayfed_tpu.ops import make_ulysses_attention as jax_make_ulysses
from rayfed_tpu.parallel import create_mesh as jax_create_mesh
from rayfed_tpu_torch.ops import attention as port_attention
from rayfed_tpu_torch.parallel.launch import run_world
from rayfed_tpu_torch.tools.parallel_check import attention_cases

RANKS = 4
# The packages re-export the functions under the modules' names.
jax_ring_mod = importlib.import_module("rayfed_tpu.ops.ring_attention")
port_ring_mod = importlib.import_module("rayfed_tpu_torch.ops.ring_attention")
F32_FWD, GRAD, BF16 = 2e-5, 5e-4, 3e-2  # the reference tests' tolerances


def _qkv(seed, b=2, t=32, h=4, d=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3)]


def _llama_inputs():
    cfg = jax_llama.llama_tiny()
    params = jax.tree_util.tree_map(np.asarray, jax_llama.init_llama(jax.random.PRNGKey(0), cfg))
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 64)).astype(np.int64)
    return params, ids


def _ring(causal, **kw):
    return {"op": "ring", "mesh": {"sp": RANKS}, "kw": {"causal": causal, **kw}}


def _uly(causal, **kw):
    return {"op": "ulysses", "mesh": {"sp": RANKS}, "kw": {"causal": causal, **kw}}


_LLAMA = _llama_inputs()
CASES = {
    "ring_f": {**_ring(False), "qkv": _qkv(0)},
    "ring_c": {**_ring(True), "qkv": _qkv(0)},
    "uly_f": {**_uly(False), "qkv": _qkv(1)},
    "uly_c": {**_uly(True), "qkv": _qkv(1)},
    "uly_flash_c": {**_uly(True, attn_fn="flash"), "qkv": _qkv(1, d=16), "grad": True},
    "ring_bf16": {**_ring(True), "qkv": _qkv(2, t=64), "dtype": "bfloat16"},
    "ring_grad": {**_ring(True), "qkv": _qkv(3, t=16), "grad": True},
    "flash_f": {**_ring(False, use_flash=True), "qkv": _qkv(5, t=64, d=16)},
    "flash_c": {**_ring(True, use_flash=True), "qkv": _qkv(5, t=64, d=16)},
    "flash_grad": {**_ring(True, use_flash=True), "qkv": _qkv(6, t=32, d=16), "grad": True},
    "flash_grad_f": {**_ring(False, use_flash=True), "qkv": _qkv(6, t=32, d=16), "grad": True},
    "flash_bf16": {**_ring(True, use_flash=True), "qkv": _qkv(7, t=64, d=16), "dtype": "bfloat16"},
    "zigzag": {**_ring(True, use_flash=True, layout="zigzag"), "qkv": _qkv(8, t=64, d=16)},
    "zigzag_grad": {**_ring(True, use_flash=True, layout="zigzag"), "qkv": _qkv(9, t=32, d=16), "grad": True},
    "zigzag_noncausal": {**_ring(False, use_flash=True, layout="zigzag"), "qkv": _qkv(10, t=32, d=16)},
    "zigzag_noflash": {**_ring(True, layout="zigzag"), "qkv": _qkv(10, t=32, d=16)},
    "zigzag_indivisible": {**_ring(True, use_flash=True, layout="zigzag"), "qkv": _qkv(10, t=36, d=16)},
    "ring_window": {**_ring(True), "qkv": _qkv(11, t=32, d=16), "call_kw": {"causal": True, "window": 8}},
    "ring_window_none": {**_ring(True), "qkv": _qkv(11, t=32, d=16), "call_kw": {"causal": True, "window": None}},
    "uly_window": {**_uly(True), "qkv": _qkv(11, t=32, d=16), "call_kw": {"causal": True, "window": 8}},
    "uly_window_none": {**_uly(True), "qkv": _qkv(11, t=32, d=16), "call_kw": {"causal": True, "window": None}},
    "uly_heads": {**_uly(False), "qkv": _qkv(4, h=6)},
    "llama": {"op": "llama", "mesh": {"sp": RANKS}, "params": _LLAMA[0], "ids": _LLAMA[1],
              "kw": {"causal": True, "use_flash": True}, "bad_kw": {"causal": False}},
}


@pytest.fixture(scope="module")
def world():
    names = list(CASES)
    per_rank = run_world(attention_cases, RANKS, ([CASES[n] for n in names],), device="cpu", timeout_s=300)
    return {n: [rank[i] for rank in per_rank] for i, n in enumerate(names)}


def _jax_mesh():
    return jax_create_mesh({"sp": RANKS}, devices=jax.devices()[:RANKS])


def _jax_builder(case):
    kw = dict(case["kw"])
    if case["op"] == "ring":
        return jax_make_ring(_jax_mesh(), "sp", **kw)
    if kw.pop("attn_fn", None) == "flash":
        from rayfed_tpu.ops.flash_attention import flash_attention

        kw["attn_fn"] = flash_attention
    return jax_make_ulysses(_jax_mesh(), "sp", **kw)


def _jax_result(case):
    dtype = jnp.bfloat16 if case.get("dtype") == "bfloat16" else jnp.float32
    q, k, v = (jnp.asarray(a, dtype) for a in case["qkv"])
    fn = _jax_builder(case)
    out = jax.jit(fn)(q, k, v)
    grads = None
    if case.get("grad"):
        grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v).astype(jnp.float32) ** 2),
                                 argnums=(0, 1, 2)))(q, k, v)
    return out, grads


def _check(world, name, tol, gtol=None):
    case = CASES[name]
    out, grads = _jax_result(case)
    want = np.asarray(out, np.float32)
    for rank, res in enumerate(world[name]):
        assert "error" not in res, res
        assert res["dtype"] == ("bfloat16" if case.get("dtype") == "bfloat16" else "float32")
        np.testing.assert_allclose(res["out"], want, atol=tol, rtol=tol, err_msg=f"rank {rank}")
        if grads is not None:
            for i, (g_port, g_ref) in enumerate(zip(res["grads"], grads)):
                np.testing.assert_allclose(g_port, np.asarray(g_ref), atol=gtol, rtol=gtol,
                                           err_msg=f"rank {rank} grad {i}")


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax(world, causal):
    _check(world, "ring_c" if causal else "ring_f", 1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(world, causal):
    _check(world, "uly_c" if causal else "uly_f", 1e-5)


def test_ulysses_with_flash_inside_matches_jax(world):
    _check(world, "uly_flash_c", F32_FWD, GRAD)


def test_ring_bf16(world):
    _check(world, "ring_bf16", BF16)


def test_ring_gradients_match(world):
    _check(world, "ring_grad", 1e-5, 1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_matches_jax(world, causal):
    _check(world, "flash_c" if causal else "flash_f", F32_FWD)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_gradients_match(world, causal):
    _check(world, "flash_grad" if causal else "flash_grad_f", F32_FWD, GRAD)


def test_ring_flash_bf16(world):
    _check(world, "flash_bf16", BF16)


def test_zigzag_ring_matches_jax(world):
    _check(world, "zigzag", F32_FWD)


def test_zigzag_ring_gradients_match(world):
    _check(world, "zigzag_grad", F32_FWD, GRAD)


def test_zigzag_requires_causal_flash(world):
    for name in ("zigzag_noncausal", "zigzag_noflash"):
        for res in world[name]:
            assert "zigzag" in res["error"]
    with pytest.raises(ValueError, match="divisible"):
        jax.jit(_jax_builder(CASES["zigzag_indivisible"]))(*(jnp.asarray(a) for a in CASES["zigzag_indivisible"]["qkv"]))
    for res in world["zigzag_indivisible"]:
        assert "divisible" in res["error"]


@pytest.mark.parametrize("name", ["ring", "ulysses"])
def test_wrapped_attention_rejects_window(world, name):
    short = "ring" if name == "ring" else "uly"
    for res in world[f"{short}_window"]:
        assert name in res["error"] and "sliding-window" in res["error"], res
    # window=None is a no-op, matching the dense signature.
    _check(world, f"{short}_window_none", 1e-5)


def test_ulysses_requires_divisible_heads(world):
    for res in world["uly_heads"]:
        assert "divisible" in res["error"]


def test_masked_rows_are_zero():
    ones = np.ones((1, 4, 1, 4), np.float32)
    out = port_attention.dot_product_attention(
        *(torch.from_numpy(ones) for _ in range(3)), causal=True, q_offset=0, kv_offset=100
    )
    ref = jax_attention.dot_product_attention(*(jnp.asarray(ones) for _ in range(3)), causal=True,
                                              q_offset=0, kv_offset=100)
    assert not torch.isnan(out).any()
    np.testing.assert_array_equal(out.numpy(), np.zeros_like(ones))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_llama_ring_sp_matches_dense(world):
    params, ids = _LLAMA
    cfg = jax_llama.llama_tiny()
    dense = np.asarray(jax_llama.apply_llama(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(ids), cfg))
    for res in world["llama"]:
        np.testing.assert_allclose(res["out"], dense, atol=2e-4, rtol=2e-4)
        # Conflicting build-time/call-time settings are rejected, not ignored.
        assert res["bad_error"] is not None and "conflicts" in res["bad_error"]


def test_every_rank_returns_the_same_output(world):
    for name, results in world.items():
        if "out" in results[0]:
            for res in results[1:]:
                np.testing.assert_array_equal(res["out"], results[0]["out"], err_msg=name)


def test_merge_partial_matches_jax():
    rng = np.random.default_rng(12)
    o_a, o_b = (rng.standard_normal((3, 8, 16)).astype(np.float32) for _ in range(2))
    lse_a, lse_b = (rng.standard_normal((3, 8)).astype(np.float32) for _ in range(2))
    lse_a[0], lse_b[1] = port_attention.NEG_INF, port_attention.NEG_INF  # absent partials
    lse_a[2, :3] = lse_b[2, :3] = port_attention.NEG_INF  # rows no partial sees
    o_p, l_p = port_ring_mod._merge_partial(*(torch.from_numpy(a) for a in (o_a, lse_a, o_b, lse_b)))
    o_j, l_j = jax_ring_mod._merge_partial(*(jnp.asarray(a) for a in (o_a, lse_a, o_b, lse_b)))
    np.testing.assert_allclose(o_p.numpy(), np.asarray(o_j), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(l_p.numpy(), np.asarray(l_j), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_accumulate_matches_jax(causal):
    q, k, v = _qkv(13, b=1, t=8, h=2, d=8)
    q_t, k_t, v_t = (torch.from_numpy(a) for a in (q, k, v))
    q_j, k_j, v_j = (jnp.asarray(a) for a in (q, k, v))
    state_p = port_attention.init_blockwise_state(q_t)
    state_j = jax_attention.init_blockwise_state(q_j)
    for kv_off in (0, 8, 16):  # a visible, a diagonal-free and a future block
        state_p = port_attention.blockwise_accumulate(q_t, k_t, v_t, *state_p, scale=0.3, q_offset=8,
                                                      kv_offset=kv_off, causal=causal)
        state_j = jax_attention.blockwise_accumulate(q_j, k_j, v_j, *state_j, scale=0.3, q_offset=8,
                                                     kv_offset=kv_off, causal=causal)
    for a, b in zip(state_p, state_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    out_p = port_attention.blockwise_finalize(state_p[0], state_p[2], torch.float32)
    out_j = jax_attention.blockwise_finalize(state_j[0], state_j[2], jnp.float32)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j), atol=1e-5, rtol=1e-5)


def test_as_attn_fn_rejects_conflicts():
    calls = []
    fn = port_attention.as_attn_fn(lambda q, k, v: calls.append(1) or q, True, None, "ring")
    q = torch.zeros(1, 4, 1, 16)
    with pytest.raises(ValueError, match="dense mask"):
        fn(q, q, q, mask=torch.ones(4, 4, dtype=torch.bool))
    with pytest.raises(ValueError, match="conflicts"):
        fn(q, q, q, causal=False)
    with pytest.raises(ValueError, match="conflicts"):
        fn(q, q, q, sm_scale=0.5)
    fn(q, q, q, causal=True, sm_scale=float(np.float32(16 ** -0.5)))  # agreement, not conflict
    assert calls == [1]
