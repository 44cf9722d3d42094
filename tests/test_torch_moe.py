"""The port's MoE layer against the JAX package's (``tests/test_moe.py``'s
cases), with the reference's weights carried across
(``models/convert.py`` ``moe_params_from_jax``) and the same numpy inputs.

Expert parallelism runs on a world of 4 gloo ranks on the CPU, spawned once
for the module: each rank holds 2 of the 8 experts (``Shard(0)`` by
``PARTITION_RULES``) and the layer's output and gradients must equal the
one-rank layer's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rayfed_tpu.models import moe as jax_moe
from rayfed_tpu_torch.models import moe
from rayfed_tpu_torch.models.convert import moe_params_from_jax
from rayfed_tpu_torch.parallel.launch import run_world
from rayfed_tpu_torch.tools.parallel_check import moe_cases

RANKS = 4
FWD, GRAD = 1e-5, 1e-4  # the reference tests' tolerances


def _setup(seed=0, x_shape=(2, 8, 16), **cfg_kw):
    cfg_kw = {"num_experts": 4, "top_k": 2, "d_model": 16, "d_ff": 32, **cfg_kw}
    jparams = jax.tree_util.tree_map(np.asarray, jax_moe.init_moe(jax.random.PRNGKey(seed), jax_moe.MoeConfig(**cfg_kw)))
    x = np.random.default_rng(seed + 1).standard_normal(x_shape).astype(np.float32)
    return cfg_kw, jparams, x


def _jax(cfg_kw, jparams, x, dispatch="scatter"):
    cfg = jax_moe.MoeConfig(**cfg_kw)
    params = jax.tree_util.tree_map(jnp.asarray, jparams)

    def loss(p, xx):
        y, a = jax_moe.apply_moe(p, xx, cfg, return_aux=True, dispatch=dispatch)
        return jnp.sum(y**2) + a["aux_loss"], (y, a)

    (_, (y, aux)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    grads = {k: np.asarray(v) for k, v in gp.items()} | {"x": np.asarray(gx)}
    return np.asarray(y), {k: float(v) for k, v in aux.items()}, grads


def _port(cfg_kw, jparams, x, dispatch="scatter"):
    cfg = moe.MoeConfig(**cfg_kw)
    params = {k: v.requires_grad_(True) for k, v in moe_params_from_jax(jparams, "cpu").items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.apply_moe(params, xt, cfg, return_aux=True, dispatch=dispatch)
    names = sorted(params)
    grads = torch.autograd.grad((y**2).sum() + aux["aux_loss"], [params[n] for n in names] + [xt])
    return (y.detach().numpy(), {k: float(v.detach()) for k, v in aux.items()},
            {n: g.numpy() for n, g in zip(names + ["x"], grads)})


def _close_grads(a, b, tol):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=tol, rtol=tol, err_msg=k)


EP_CASES = {
    dispatch: {"mesh": {"ep": RANKS}, "cfg": _setup(3, num_experts=8)[0], "params": _setup(3, num_experts=8)[1],
               "x": _setup(3, num_experts=8)[2], "dispatch": dispatch}
    for dispatch in ("scatter", "einsum")
}


@pytest.fixture(scope="module")
def world():
    names = list(EP_CASES)
    per_rank = run_world(moe_cases, RANKS, ([EP_CASES[n] for n in names],), device="cpu", timeout_s=240)
    return {n: [rank[i] for rank in per_rank] for i, n in enumerate(names)}


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
def test_moe_forward_aux_and_grads_match_jax(dispatch):
    case = _setup(0)
    y_p, aux_p, g_p = _port(*case, dispatch=dispatch)
    y_j, aux_j, g_j = _jax(*case, dispatch=dispatch)
    assert y_p.shape == case[2].shape
    np.testing.assert_allclose(y_p, y_j, atol=FWD, rtol=FWD)
    assert aux_p["aux_loss"] == pytest.approx(aux_j["aux_loss"], rel=FWD) and aux_p["aux_loss"] > 0
    assert aux_p["dropped_fraction"] == aux_j["dropped_fraction"]
    _close_grads(g_p, g_j, GRAD)
    assert np.abs(g_p["gate"]).sum() > 0  # the routing is trained


def test_moe_top1_equals_dense_expert_when_single_expert():
    cfg_kw, jparams, x = _setup(0, x_shape=(1, 4, 8), num_experts=1, top_k=1, capacity_factor=2.0,
                                d_model=8, d_ff=16)
    params = moe_params_from_jax(jparams, "cpu")
    out = moe.apply_moe(params, torch.from_numpy(x), moe.MoeConfig(**cfg_kw))
    dense = F.gelu(torch.from_numpy(x) @ params["w_in"][0], approximate="tanh") @ params["w_out"][0]
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=FWD, rtol=FWD)
    np.testing.assert_allclose(out.numpy(), _jax(cfg_kw, jparams, x)[0], atol=FWD, rtol=FWD)


def test_moe_capacity_drops_overflow():
    case = _setup(0, x_shape=(1, 16, 8), num_experts=2, top_k=1, capacity_factor=0.25, d_model=8, d_ff=16)
    y_p, aux_p, _ = _port(*case)
    y_j, aux_j, _ = _jax(*case)
    assert aux_p["dropped_fraction"] > 0
    assert aux_p["dropped_fraction"] == aux_j["dropped_fraction"]
    assert np.all(np.isfinite(y_p))
    np.testing.assert_allclose(y_p, y_j, atol=FWD, rtol=FWD)


@pytest.mark.parametrize("cf", [1.25, 0.25])  # ample capacity and forced overflow
def test_moe_scatter_matches_einsum_dispatch(cf):
    case = _setup(0, x_shape=(2, 16, 16), capacity_factor=cf)
    y_s, _, g_s = _port(*case, dispatch="scatter")
    y_e, _, g_e = _port(*case, dispatch="einsum")
    np.testing.assert_allclose(y_s, y_e, atol=FWD, rtol=FWD)
    _close_grads(g_s, g_e, GRAD)


def test_moe_einsum_guard_at_scale():
    cfg = moe.MoeConfig(num_experts=64, top_k=2, d_model=8, d_ff=16)
    params = moe.init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="scatter"):
        moe.apply_moe(params, torch.zeros(8, 8192, 8), cfg, dispatch="einsum")


def test_moe_init_shapes_and_scales():
    kw = dict(num_experts=16, d_model=256, d_ff=128)
    params = moe.init_moe(moe.MoeConfig(**kw), torch.Generator().manual_seed(0), "cpu")
    ref = jax_moe.init_moe(jax.random.PRNGKey(0), jax_moe.MoeConfig(**kw))
    scales = {"gate": 256**-0.5, "w_in": 256**-0.5, "w_out": 128**-0.5}
    for name, scale in scales.items():
        assert tuple(params[name].shape) == ref[name].shape
        assert params[name].dtype == torch.float32
        assert float(params[name].std()) == pytest.approx(scale, rel=0.03)
        assert float(jnp.std(ref[name])) == pytest.approx(scale, rel=0.03)


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
def test_moe_expert_parallel_equals_one_rank(world, dispatch):
    case = EP_CASES[dispatch]
    y1, aux1, g1 = _port(case["cfg"], case["params"], case["x"], dispatch=dispatch)
    y_j = _jax(case["cfg"], case["params"], case["x"], dispatch=dispatch)[0]
    np.testing.assert_allclose(y1, y_j, atol=FWD, rtol=FWD)
    for res in world[dispatch]:
        assert res["local_experts"] == (8 // RANKS, 16, 32)
        np.testing.assert_allclose(res["out"], y1, atol=FWD, rtol=FWD)
        assert res["aux_loss"] == pytest.approx(aux1["aux_loss"], rel=FWD)
        assert res["dropped_fraction"] == aux1["dropped_fraction"]
        _close_grads(res["grads"], g1, GRAD)
