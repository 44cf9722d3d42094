"""Port's flash-attention backward vs the JAX reference (CPU).

On the CPU the port's ``_flash_backward`` runs its plain version; the JAX
side runs the Pallas backward kernels in interpret mode, as
tests/test_flash_attention.py does.  Inputs come from numpy with a fixed
seed.  f32 throughout, so the only differences are summation order:
atol = rtol = 1e-5 on the raw backward, 1e-4 through autograd (the
gradients there are sums over a whole head and reach ~10).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayfed_tpu_torch.ops.attention import dot_product_attention
from rayfed_tpu_torch.ops.flash_attention import (
    _flash_backward,
    _flash_backward_reference,
    _flash_forward,
    _lse_delta,
    flash_attention,
)

jax_flash = importlib.import_module("rayfed_tpu.ops.flash_attention")

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)

# The forward test's cases: (t_q, t_k, block, causal, q_offset, kv_offset, window)
CASES = {
    "dense": (32, 32, 8, False, 0, 0, None),
    "causal": (32, 32, 8, True, 0, 0, None),
    "window": (32, 32, 8, True, 0, 0, 5),
    "q_shard_later": (16, 32, 8, True, 16, 0, None),
    "fully_masked_rows": (32, 32, 8, True, 0, 12, None),
    "offsets_window": (24, 24, 8, True, 8, 4, 7),
    "ragged": (20, 44, 4, True, 24, 0, None),
    "ragged_dense": (20, 44, 4, False, 0, 0, None),
}


def _inputs(seed, bh, t_q, t_k, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, t_q, d), dtype=np.float32)
    k = rng.standard_normal((bh, t_k, d), dtype=np.float32)
    v = rng.standard_normal((bh, t_k, d), dtype=np.float32)
    do = rng.standard_normal((bh, t_q, d), dtype=np.float32)
    return q, k, v, do


def _jax_forward_backward(q, k, v, do, *, block, **kw):
    """The reference's (o, lse) and (dq, dk, dv) through its Pallas kernels."""
    q, k, v, do = (jnp.asarray(x) for x in (q, k, v, do))
    o, lse = jax_flash._flash_forward(
        q, k, v, block_q=block, block_k=block, interpret=True, **kw
    )
    grads = jax_flash._flash_backward_pallas(
        q, k, v, o, lse, do, block_q=block, block_k=block, interpret=True, **kw
    )
    return o, lse, grads


@pytest.mark.parametrize("case", list(CASES))
def test_flash_backward_matches_jax_interpret(case):
    t_q, t_k, block, causal, q_off, kv_off, window = CASES[case]
    q, k, v, do = _inputs(len(case), 3, t_q, t_k, 16)
    kw = dict(scale=16**-0.5, causal=causal, q_offset=q_off, kv_offset=kv_off,
              window=window)
    o_ref, lse_ref, grads_ref = _jax_forward_backward(q, k, v, do, block=block, **kw)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = _flash_forward(tq, tk, tv, **kw)
    grads = _flash_backward(tq, tk, tv, o, lse, tdo, **kw)
    for name, g, ref, shape in zip("qkv", grads, grads_ref, [q.shape, k.shape, v.shape]):
        assert g.shape == shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), err_msg=f"d{name}", **TOL)


def test_lse_delta_reuse_and_f32_out_match_jax():
    q, k, v, do = _inputs(3, 2, 24, 24, 16)
    kw = dict(scale=0.25, causal=True, q_offset=0, kv_offset=4, window=None)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    jo, jlse = jax_flash._flash_forward(jq, jk, jv, block_q=8, block_k=8, interpret=True, **kw)
    lanes = jax_flash._lse_delta_lanes(jo, jlse, jdo)
    ref = jax_flash._flash_backward_pallas(
        jq, jk, jv, jo, jlse, jdo, block_q=8, block_k=8, interpret=True,
        lse_delta_b=lanes, out_dtype=jnp.float32, **kw,
    )
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = _flash_forward(tq, tk, tv, **kw)
    lse_delta = _lse_delta(o, lse, tdo)
    np.testing.assert_allclose(lse_delta[0].numpy(), np.asarray(lanes[0][..., 0]), **TOL)
    np.testing.assert_allclose(lse_delta[1].numpy(), np.asarray(lanes[1][..., 0]), **TOL)
    # lse_delta replaces (o, lse): garbage there must not matter.
    grads = _flash_backward(
        tq, tk, tv, torch.full_like(o, float("nan")), torch.full_like(lse, float("nan")),
        tdo, lse_delta=lse_delta, out_dtype=torch.float32, **kw,
    )
    for g, r in zip(grads, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_bf16_inputs_round_like_the_kernels_and_out_dtype():
    q, k, v, do = (torch.from_numpy(x).bfloat16() for x in _inputs(4, 2, 16, 16, 16))
    kw = dict(scale=0.25, causal=True)
    o, lse = _flash_forward(q, k, v, **kw)
    grads = _flash_backward(q, k, v, o, lse, do, **kw)
    grads32 = _flash_backward(q, k, v, o, lse, do, out_dtype=torch.float32, **kw)
    for g, g32 in zip(grads, grads32):
        assert g.dtype == torch.bfloat16 and g32.dtype == torch.float32
        assert torch.equal(g, g32.bfloat16())
    # The plain version is what the CPU path runs.
    ref = _flash_backward_reference(q, k, v, o, lse, do, **kw)
    for g, r in zip(grads, ref):
        assert torch.equal(g, r)


def _bthd(seed, shape=(2, 24, 4, 16)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(4)]


@pytest.mark.parametrize(
    "kw",
    [
        dict(causal=True),
        dict(causal=True, window=6),
        dict(causal=True, q_offset=8, kv_offset=0),
        dict(causal=True, q_offset=0, kv_offset=8),
    ],
    ids=["causal", "window", "q_offset", "kv_offset_masked_rows"],
)
def test_flash_attention_grads_match_jax_grad(kw):
    q, k, v, w = _bthd(len(kw) + 7)

    def jax_loss(q, k, v):
        out = jax_flash.flash_attention(q, k, v, block_q=8, block_k=8, **kw)
        return jnp.sum(out * w)

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, **kw)
    (out * torch.from_numpy(w)).sum().backward()
    for t, r in zip((tq, tk, tv), ref):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), **GRAD_TOL)


def test_fully_masked_rows_and_unseen_keys_get_zero_gradients():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(8, 2, 16, 24, 16))
    # kv_offset=10: queries 0..9 see no key (query 10 sees one, so its dq
    # is 0 too: a softmax over one key is constant); keys past position 15
    # (index 6 onwards) are seen by no query.
    kw = dict(scale=0.25, causal=True, kv_offset=10)
    o, lse = _flash_forward(q, k, v, **kw)
    dq, dk, dv = _flash_backward(q, k, v, o, lse, do, **kw)
    assert torch.all(dq[:, :10] == 0) and torch.all(dq[:, 11:].abs().sum(-1) > 0)
    assert torch.all(dk[:, 6:] == 0) and torch.all(dv[:, 6:] == 0)
    assert torch.all(dv[:, :6].abs().sum(-1) > 0)
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))


def test_flash_grads_match_port_dense_grads():
    q, k, v, w = (torch.from_numpy(x) for x in _bthd(9, (1, 37, 2, 8)))
    for kw in (dict(causal=True), dict(causal=True, window=9), dict(causal=False)):
        grads = []
        for fn in (flash_attention, dot_product_attention):
            qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
            (fn(*qkv, **kw) * w).sum().backward()
            grads.append([x.grad for x in qkv])
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, **GRAD_TOL)


def test_cpu_backward_does_not_count_kernel_launches():
    before = (flash_attention.bwd_dq_launches, flash_attention.bwd_dkv_launches)
    q = torch.randn(1, 8, 2, 8, requires_grad=True)
    flash_attention(q, q, q, causal=True).sum().backward()
    assert (flash_attention.bwd_dq_launches, flash_attention.bwd_dkv_launches) == before


def test_backward_non_cpu_non_cuda_tensor_raises():
    q = torch.empty(2, 8, 64, device="meta")
    lse = torch.empty(2, 8, device="meta")
    with pytest.raises(RuntimeError, match="cpu or cuda"):
        _flash_backward(q, q, q, q, lse, q, scale=1.0, causal=True)
