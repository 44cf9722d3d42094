"""The port's meshes, partition rules and sharding strategies against the
JAX package's (``tests/test_parallel_mesh.py``'s cases).

The JAX side runs on the 8-device CPU mesh of ``conftest.py``; the port's on
a world of 4 gloo ranks on the CPU, spawned once for the module (each case a
test of its own reading the stored result of every rank).  Where the
reference's case used 8 devices, the port's uses the world's 4.  The
models' ``PARTITION_RULES`` are compared leaf for leaf: the port's specs
are the reference's ``PartitionSpec``s as plain tuples.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from rayfed_tpu.models import bert as jax_bert
from rayfed_tpu.models import llama as jax_llama
from rayfed_tpu.models import moe as jax_moe
from rayfed_tpu.models import resnet as jax_resnet
from rayfed_tpu.parallel import create_mesh as jax_create_mesh
from rayfed_tpu.parallel.sharding import shard_params_by_rules as jax_rules
from rayfed_tpu_torch.parallel import mesh as port_mesh
from rayfed_tpu_torch.parallel.launch import run_world
from rayfed_tpu_torch.tools.parallel_check import mesh_checks

RANKS = 4
BERT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            max_position=16)
RULE_SETS = {
    "llama_fsdp_tp": ("llama", {}, {"fsdp": 2, "tp": 2}),
    "llama_dp_tp": ("llama", {}, {"dp": 2, "tp": 2}),  # no fsdp axis: pruned
    "resnet": ("resnet", {"width": 8}, {"fsdp": 2, "tp": 2}),
    "bert": ("bert", BERT, {"fsdp": 2, "tp": 2}),
    "moe": ("moe", {"num_experts": 4, "d_model": 8, "d_ff": 16}, {"ep": 2, "tp": 2}),
}
_JAX_MODELS = {
    "llama": (lambda kw: jax_llama.init_llama(jax.random.PRNGKey(0), jax_llama.llama_tiny(**kw)),
              jax_llama.PARTITION_RULES),
    "resnet": (lambda kw: jax_resnet.init_resnet(jax.random.PRNGKey(0), jax_resnet.resnet18(**kw))[0],
               jax_resnet.PARTITION_RULES),
    "bert": (lambda kw: jax_bert.init_bert(jax.random.PRNGKey(0), jax_bert.BertConfig(**kw)),
             jax_bert.PARTITION_RULES),
    "moe": (lambda kw: jax_moe.init_moe(jax.random.PRNGKey(0), jax_moe.MoeConfig(**kw)),
            jax_moe.PARTITION_RULES),
}


@pytest.fixture(scope="module")
def world():
    return run_world(mesh_checks, RANKS, (RULE_SETS,), device="cpu", timeout_s=240)


def _jax_specs(mesh, params, rules):
    flat, _ = jax.tree_util.tree_flatten_with_path(jax_rules(mesh, params, rules))
    return {jax.tree_util.keystr(path, simple=True, separator="/"): tuple(s.spec) for path, s in flat}


def test_create_mesh_shapes(world):
    for res in world:
        assert res["dp_tp"] == {"dp": 2, "tp": 2}
        assert res["dp_infer"] == {"dp": 2, "tp": 2}
        assert res["default"] == {"dp": RANKS}


def test_create_mesh_errors_match_the_reference(world):
    devs = jax.devices()[:RANKS]
    for key, shape in (("err_size", {"dp": 3}), ("err_two", {"dp": -1, "tp": -1}),
                       ("err_infer", {"dp": 3, "tp": -1})):
        with pytest.raises(ValueError) as ref:
            jax_create_mesh(shape, devices=devs)
        for res in world:
            assert res[key] == str(ref.value)


def test_create_mesh_needs_a_world():
    with pytest.raises(RuntimeError, match="init_world"):
        port_mesh.create_mesh({"dp": 1}, device="cpu")


def test_shard_params_by_rules(world):
    for res in world:
        assert res["rules"] == {"dense/kernel": (None, "tp"), "dense/bias": (), "emb/embedding": ("tp", None)}


def test_rules_prune_missing_axes(world):
    mesh = jax_create_mesh({"dp": 8})
    want = jax_rules(mesh, {"k": jnp.ones((4, 4))}, rules=[(r"k", P(None, "tp"))])["k"].spec
    for res in world:
        assert res["pruned"] == {"k": tuple(want)} == {"k": (None, None)}


def test_data_parallel_strategy(world):
    for res in world:
        assert res["batch_spec"] == (("dp",), None)
        assert res["batch_local_rows"] == 16 // RANKS
        assert np.isfinite(res["dp_out"])
        assert res["dp_out"] == pytest.approx(5.0)  # mean(x @ ones + 1) over ones


def test_tp_matmul_produces_correct_result(world):
    want = np.ones((8, 4)) @ np.arange(32.0).reshape(4, 8)
    for res in world:
        assert res["tp_local_w"] == (4, 4)  # 8 columns over tp=2
        np.testing.assert_allclose(res["tp_out"], want)


@pytest.mark.parametrize("name", sorted(RULE_SETS))
def test_partition_rules_match_the_reference_leaf_by_leaf(world, name):
    model, kw, mesh_shape = RULE_SETS[name]
    init, rules = _JAX_MODELS[model]
    mesh = jax_create_mesh(dict(mesh_shape), devices=jax.devices()[:RANKS])
    want = _jax_specs(mesh, init(kw), rules)
    for res in world:
        assert res[name] == want
    assert any(spec for spec in want.values())  # some leaf is sharded
