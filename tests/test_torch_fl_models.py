"""The port's FL baseline models (CPU) against the JAX package's.

The reference's params (converted with ``params_from_jax``) and the same
numpy-seeded inputs go through both packages' forward passes and one train
step.  Tolerances: logistic and MLP 1e-6 absolute plus 1e-6 relative (f32
products summed in other orders); ResNet 1e-5 absolute on logits, losses
and updated params and BN state (other conv algorithms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayfed_tpu.models import logistic as jl
from rayfed_tpu.models import resnet as jr
from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.fl import compression as tc
from rayfed_tpu_torch.models import logistic as tl
from rayfed_tpu_torch.models import resnet as tr
from rayfed_tpu_torch.models.convert import params_from_jax

CPU = torch.device("cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(jtree, ttree, atol, rtol=0.0):
    jleaves = jax.tree_util.tree_leaves(jtree)
    tleaves = tree_util.tree_leaves(ttree)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=rtol, atol=atol)


def _data(seed, n=32, d=12, classes=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x, rng.integers(0, classes, n).astype(np.int32)


def test_logistic_forward_and_step_match():
    x, y = _data(0)
    jp = {"w": jax.random.normal(jax.random.PRNGKey(1), (12, 4)) * 0.1, "b": jnp.ones(4) * 0.01}
    tp = params_from_jax(_np(jp), CPU)
    _close(jl.apply_logistic(jp, jnp.asarray(x)), {"o": tl.apply_logistic(tp, torch.from_numpy(x))}, 1e-6, 1e-6)
    jnew, jloss = jl.make_train_step(jl.apply_logistic, lr=0.3)(jp, jnp.asarray(x), jnp.asarray(y))
    tnew, tloss = tl.make_train_step(tl.apply_logistic, lr=0.3)(tp, torch.from_numpy(x), torch.from_numpy(y))
    assert abs(float(jloss) - float(tloss)) < 1e-6
    _close(jnew, tnew, 1e-6, 1e-6)
    assert tp["w"].equal(params_from_jax(_np(jp), CPU)["w"])  # inputs left intact
    module = tl.Logistic(12, 4, device=CPU)
    module.load_params(tp)
    assert torch.equal(module(torch.from_numpy(x)), tl.apply_logistic(tp, torch.from_numpy(x)))
    assert tl.init_logistic(12, 4, device=CPU)["w"].abs().sum() == 0
    np.testing.assert_allclose(
        float(tl.accuracy(tl.apply_logistic(tp, torch.from_numpy(x)), torch.from_numpy(y))),
        float(jl.accuracy(jl.apply_logistic(jp, jnp.asarray(x)), jnp.asarray(y))), atol=0)


def test_mlp_forward_and_step_match():
    x, y = _data(1)
    jp = jl.init_mlp(jax.random.PRNGKey(2), 12, (16, 8), 4)
    tp = params_from_jax(_np(jp), CPU)
    jout = jl.apply_mlp(jp, jnp.asarray(x))
    _close(jout, {"o": tl.apply_mlp(tp, torch.from_numpy(x))}, 1e-6, 1e-6)
    jnew, jloss = jl.make_train_step(jl.apply_mlp, lr=0.1)(jp, jnp.asarray(x), jnp.asarray(y))
    tnew, tloss = tl.make_train_step(tl.apply_mlp, lr=0.1)(tp, torch.from_numpy(x), torch.from_numpy(y))
    assert abs(float(jloss) - float(tloss)) < 1e-6
    _close(jnew, tnew, 1e-6, 1e-6)
    assert torch.equal(tl.MLP(tp)(torch.from_numpy(x)), tl.apply_mlp(tp, torch.from_numpy(x)))
    fresh = tl.init_mlp(torch.Generator().manual_seed(0), 12, (16,), 4, device=CPU)
    assert fresh["layer0"]["kernel"].shape == (12, 16) and fresh["layer1"]["bias"].abs().sum() == 0


def _resnet_case(small_inputs, seed=0):
    jcfg = jr.ResNetConfig(stage_sizes=(1, 1), num_classes=5, width=8, small_inputs=small_inputs)
    tcfg = tr.ResNetConfig(stage_sizes=(1, 1), num_classes=5, width=8, small_inputs=small_inputs)
    jp, js = jr.init_resnet(jax.random.PRNGKey(seed), jcfg)
    jp["head"]["kernel"] = jax.random.normal(jax.random.PRNGKey(seed + 1), jp["head"]["kernel"].shape) * 0.1
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 15, 15, 3)).astype(np.float32)
    y = rng.integers(0, 5, 4).astype(np.int32)
    return jcfg, tcfg, jp, js, x, y


@pytest.mark.parametrize("small_inputs", [True, False], ids=["cifar-stem", "imagenet-stem"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet_forward_matches(small_inputs, train):
    jcfg, tcfg, jp, js, x, _ = _resnet_case(small_inputs)
    tp, ts = params_from_jax(_np(jp), CPU), params_from_jax(_np(js), CPU)
    jlog, jstate = jr.apply_resnet(jp, js, jnp.asarray(x), jcfg, train=train)
    tlog, tstate = tr.apply_resnet(tp, ts, torch.from_numpy(x), tcfg, train=train)
    _close({"o": jlog}, {"o": tlog}, 1e-5)
    _close(jstate, tstate, 1e-5)
    module = tr.ResNet(tcfg, tp, ts)
    assert torch.equal(module(torch.from_numpy(x)), tr.apply_resnet(tp, ts, torch.from_numpy(x), tcfg)[0])
    assert len(list(module.parameters())) == len(tree_util.tree_leaves(tp))


@pytest.mark.parametrize("small_inputs", [True, False], ids=["cifar-stem", "imagenet-stem"])
def test_resnet_train_step_matches(small_inputs):
    jcfg, tcfg, jp, js, x, y = _resnet_case(small_inputs, seed=3)
    tp, ts = params_from_jax(_np(jp), CPU), params_from_jax(_np(js), CPU)
    jout = jr.make_train_step(jcfg, lr=0.1)(jp, js, jr.init_opt_state(jp), jnp.asarray(x), jnp.asarray(y))
    tout = tr.make_train_step(tcfg, lr=0.1)(tp, ts, tr.init_opt_state(tp), torch.from_numpy(x), torch.from_numpy(y))
    assert abs(float(jout[3]) - float(tout[3])) < 1e-5
    for j, t in zip(jout[:3], tout[:3]):
        _close(j, t, 1e-5)


def test_resnet_fed_step_packed_matches_per_leaf_and_reference():
    jcfg, tcfg, jp, js, x, y = _resnet_case(True, seed=5)
    tp, ts = params_from_jax(_np(jp), CPU), params_from_jax(_np(js), CPU)
    step = tr.make_fed_train_step(tcfg, lr=0.1)
    packed, ploss = step(tc.pack_tree((tp, ts)), torch.from_numpy(x), torch.from_numpy(y))
    per_leaf, lloss = step(tc.cast_floats((tp, ts), torch.bfloat16), torch.from_numpy(x), torch.from_numpy(y))
    assert isinstance(packed, tc.PackedTree) and torch.equal(ploss, lloss)
    for a, b in zip(tree_util.tree_leaves(tc.unpack_tree(packed)), tree_util.tree_leaves(per_leaf)):
        assert torch.equal(a, b)
    from rayfed_tpu.fl import compression as jc

    jpacked, jloss = jr.make_fed_train_step(jcfg, lr=0.1)(jc.pack_tree((jp, js)), jnp.asarray(x), jnp.asarray(y))
    assert abs(float(jloss) - float(ploss)) < 1e-5
    diff = np.abs(np.asarray(jpacked.buf, np.float32) - packed.buf.float().numpy())
    # bf16 outputs: one bf16 step (2^-8 relative) where the f32 results straddle a rounding edge.
    assert np.all(diff <= np.abs(np.asarray(jpacked.buf, np.float32)) * 2**-7 + 1e-6)
