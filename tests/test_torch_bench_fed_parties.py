"""``bench_torch.py --fed-only`` on the CPU, part 2: the legs of party
processes and ranks (pp_bench, overlap, lora_2party, resnet_fedavg,
resnet_dp and the headline fedavg_mnist), each in its own spawned processes
at small sizes, two legs at a time (``run_fed(lanes=2)``, as
``chip_smoke.py`` runs them), held to ``bench.py``'s federated section's
keys; the LoRA adapters a push carries are held to the JAX package's own
adapters.  See ``tests/torch_bench_fed.py``."""

import pytest

import bench_torch
from tests.torch_bench_fed import PRED_KEYS, check_leg_keys, port_run

LEGS = ("pp_bench", "overlap", "lora_2party", "resnet_fedavg", "resnet_dp", "fedavg_mnist")


@pytest.mark.parametrize("leg", LEGS)
def test_leg_sets_every_reference_key(leg):
    record, stats = port_run(LEGS, 2)
    check_leg_keys(record, leg)
    assert stats[leg]["s"] > 0 and stats[leg]["peak_bytes"] is None  # no card here
    assert not any(stats[leg]["launches"].values())  # a CPU run launches no kernel


def test_lanes_merge_the_legs_in_order():
    """Two legs at a time: every leg ran once, and the record lists their
    keys in bench.py's order whatever order they ended in; the DP ratio,
    which needs two legs' keys, is computed after both."""
    record, stats = port_run(LEGS, 2)
    assert sorted(stats) == sorted(LEGS)
    keys = list(record)
    firsts = [keys.index(bench_torch.FED_KEYS[leg][0]) for leg in LEGS if leg != "fedavg_mnist"]
    assert firsts == sorted(firsts)
    assert record["resnet_fedavg_vs_dp_ratio"] == round(
        record["resnet_4party_rounds_per_sec"] / record["resnet_dp_control_rounds_per_sec"], 3) or \
        abs(record["resnet_fedavg_vs_dp_ratio"] * record["resnet_dp_control_rounds_per_sec"]
            - record["resnet_4party_rounds_per_sec"]) < 2e-3 * record["resnet_4party_rounds_per_sec"] + 2e-3


def test_headline_is_fedavg_mnist():
    record, _ = port_run(LEGS, 2)
    assert record["metric"] == bench_torch.HEADLINE and record["unit"] == "rounds/s"
    assert record["value"] > 0 and record["vs_baseline"] == 1.0


def test_the_4slice_prediction_below_0_9():
    """Under a fedavg/dp ratio of 0.9 the record carries the 4-slice model's
    inputs and prediction, as bench.py's."""
    record, _ = port_run(LEGS, 2)
    if record["resnet_fedavg_vs_dp_ratio"] < 0.9:
        for key in PRED_KEYS:
            assert key in record, key
    else:
        assert not any(key in record for key in PRED_KEYS)


def test_lora_adapters_are_the_reference_adapters():
    """``lora_adapter_MB_per_push`` at the reference's Llama: the JAX
    package's ``init_lora`` tree, computed from ``rayfed_tpu`` directly."""
    import jax
    import jax.numpy as jnp

    from rayfed_tpu.models import llama as jl
    from rayfed_tpu.models import lora as jlora

    cfg = jl.LlamaConfig(**{**bench_torch.LORA_CONFIG, "dtype": jnp.float32})
    base = jax.eval_shape(lambda: jl.init_llama(jax.random.PRNGKey(42), cfg))
    adapters = jax.eval_shape(lambda b: jlora.init_lora(jax.random.PRNGKey(7), b,
                                                        jlora.LoraConfig(rank=8, targets=(r"w[qv]$", r"lm_head$"))),
                              base)
    mb = sum(leaf.size * leaf.dtype.itemsize for leaf in jax.tree_util.tree_leaves(adapters)) / 1e6
    record, _ = port_run(LEGS, 2)
    assert record["lora_adapter_MB_per_push"] == round(mb, 3)


def test_pipeline_and_dp_time_the_same_model():
    record, _ = port_run(LEGS, 2)
    assert record["pp_step_ms"] > 0 and record["pp_interleaved_step_ms"] > 0 and record["dp_step_ms"] > 0
    # The ratios of the unrounded times; the ms keys are rounded to 0.01.
    for ratio, ms in (("pp_vs_dp_step_ratio", "pp_step_ms"), ("pp_interleaved_vs_dp_step_ratio", "pp_interleaved_step_ms")):
        assert abs(record[ratio] - record["dp_step_ms"] / record[ms]) <= 1e-2 * record[ratio] + 1e-3, ratio
