"""Port's flash attention and dense attention vs the JAX reference (CPU).

On the CPU the port's ``_flash_forward`` runs its plain version; the JAX
side runs the Pallas kernel in interpret mode, as tests/test_flash_attention.py
does.  Inputs come from numpy with a fixed seed.  f32 throughout, so the
only differences are summation order: atol = rtol = 1e-5.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayfed_tpu.ops import attention as jax_attention
from rayfed_tpu_torch.ops import attention
from rayfed_tpu_torch.ops.flash_attention import (
    NEG_INF,
    _bht_to_bthd,
    _bthd_to_bht,
    _fit_block,
    _flash_forward,
    flash_attention,
)

# The packages' ops/__init__ re-export the function under the module's name.
jax_flash = importlib.import_module("rayfed_tpu.ops.flash_attention")

TOL = dict(atol=1e-5, rtol=1e-5)


def _bht(seed, bh, t_q, t_k, d):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((bh, t_q, d), dtype=np.float32),
        rng.standard_normal((bh, t_k, d), dtype=np.float32),
        rng.standard_normal((bh, t_k, d), dtype=np.float32),
    )


# (t_q, t_k, block, causal, q_offset, kv_offset, window)
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


@pytest.mark.parametrize("case", list(CASES))
def test_flash_forward_matches_jax_interpret(case):
    t_q, t_k, block, causal, q_off, kv_off, window = CASES[case]
    q, k, v = _bht(len(case), 3, t_q, t_k, 16)
    scale = 16**-0.5
    o_ref, lse_ref = jax_flash._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
        causal=causal, block_q=block, block_k=block, q_offset=q_off,
        kv_offset=kv_off, interpret=True, window=window,
    )
    o, lse = _flash_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=scale, causal=causal, q_offset=q_off, kv_offset=kv_off,
        window=window,
    )
    assert o.shape == (3, t_q, 16) and o.dtype == torch.float32
    assert lse.shape == (3, t_q) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), **TOL)


def test_fully_masked_rows_give_zero_and_neg_inf_lse():
    q, k, v = _bht(7, 2, 16, 16, 16)
    o, lse = _flash_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=0.25, causal=True, kv_offset=10,
    )
    assert torch.all(o[:, :10] == 0)
    assert torch.all(lse[:, :10] <= NEG_INF / 2)
    assert torch.all(torch.isfinite(lse[:, 10:])) and torch.all(lse[:, 10:] > NEG_INF / 2)


def test_out_dtype_override_and_bf16_rounding():
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _bht(3, 2, 16, 16, 16))
    o, _ = _flash_forward(q, k, v, scale=0.25, causal=True)
    o32, lse = _flash_forward(q, k, v, scale=0.25, causal=True, out_dtype=torch.float32)
    assert o.dtype == torch.bfloat16 and o32.dtype == torch.float32
    assert lse.dtype == torch.float32
    assert torch.equal(o, o32.bfloat16())


@pytest.mark.parametrize(
    "kw", [dict(causal=False), dict(causal=True), dict(causal=True, window=6)]
)
def test_flash_attention_bthd_matches_jax(kw):
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((2, 24, 4, 16), dtype=np.float32) for _ in range(3))
    ref = jax_flash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=8, block_k=8, **kw
    )
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    assert out.shape == (2, 24, 4, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize(
    "kw",
    [
        dict(causal=False),
        dict(causal=True),
        dict(causal=True, window=4),
        dict(causal=True, q_offset=16, kv_offset=0),
        dict(causal=True, q_offset=0, kv_offset=8),
        dict(causal=False, sm_scale=0.3),
        dict(causal=False, mask=True),
    ],
)
def test_dot_product_attention_matches_jax(kw):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 16, 3, 8), dtype=np.float32)
    k, v = (rng.standard_normal((2, 24, 3, 8), dtype=np.float32) for _ in range(2))
    kw = dict(kw)
    if kw.pop("mask", False):
        mask = rng.random((2, 3, 16, 24)) > 0.3
        mask[0, 0, 0] = False  # one fully masked row
        kw["mask"] = mask
    ref = jax_attention.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        **{k_: (jnp.asarray(x) if k_ == "mask" else x) for k_, x in kw.items()},
    )
    out = attention.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        **{k_: (torch.from_numpy(x) if k_ == "mask" else x) for k_, x in kw.items()},
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_flash_matches_port_dense_on_any_length():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 37, 2, 8), dtype=np.float32)) for _ in range(3))
    for kw in (dict(causal=True), dict(causal=True, window=9), dict(causal=False)):
        torch.testing.assert_close(
            flash_attention(q, k, v, **kw),
            attention.dot_product_attention(q, k, v, **kw),
            **TOL,
        )


@pytest.mark.parametrize(
    "kw, err",
    [
        (dict(mask=torch.ones(1, dtype=torch.bool)), ValueError),
        (dict(window=4), ValueError),
        (dict(causal=True, window=0), ValueError),
    ],
)
def test_flash_attention_validation(kw, err):
    q = torch.zeros(1, 8, 1, 8)
    with pytest.raises(err):
        flash_attention(q, q, q, **kw)


def test_dot_product_attention_validation():
    q = torch.zeros(1, 8, 1, 8)
    with pytest.raises(ValueError):
        attention.dot_product_attention(q, q, q, window=2)
    with pytest.raises(ValueError):
        attention.dot_product_attention(q, q, q, causal=True, window=0)


def test_non_cpu_non_cuda_tensor_raises():
    q = torch.empty(2, 8, 64, device="meta")
    with pytest.raises(RuntimeError, match="cpu or cuda"):
        _flash_forward(q, q, q, scale=1.0, causal=True)


def test_cpu_path_does_not_count_kernel_launches():
    before = flash_attention.fwd_launches
    q = torch.zeros(1, 8, 2, 8)
    flash_attention(q, q, q, causal=True)
    assert flash_attention.fwd_launches == before


def test_layout_helpers_and_fit_block_match_reference():
    x = np.arange(2 * 5 * 3 * 4, dtype=np.float32).reshape(2, 5, 3, 4)
    bht = _bthd_to_bht(torch.from_numpy(x))
    np.testing.assert_array_equal(bht.numpy(), np.asarray(jax_flash._bthd_to_bht(jnp.asarray(x))))
    np.testing.assert_array_equal(_bht_to_bthd(bht, 2, 3).numpy(), x)
    for t, want in [(2048, 1024), (1280, 1024), (37, 16), (24, 1024), (7, 4)]:
        assert _fit_block(t, want) == jax_flash._fit_block(t, want)
