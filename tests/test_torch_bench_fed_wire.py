"""``bench_torch.py --fed-only`` on the CPU, part 1: the legs of the wire
(split_fl, push_bench, send_path, stream_agg, ring_agg), each in its own
spawned processes at small sizes, held to ``bench.py``'s federated
section's keys; the ResNet-18 bundles of the full-size legs are held to the
JAX package's own bundle.  See ``tests/torch_bench_fed.py``."""

import pytest

import bench_torch
from tests.torch_bench_fed import ENV_KEYS, check_leg_keys, port_run

LEGS = ("split_fl", "push_bench", "send_path", "stream_agg", "ring_agg")


@pytest.mark.parametrize("leg", LEGS)
def test_leg_sets_every_reference_key(leg):
    record, stats = port_run(LEGS)
    check_leg_keys(record, leg)
    assert stats[leg]["s"] > 0 and stats[leg]["peak_bytes"] is None  # no card here
    assert not any(stats[leg]["launches"].values())  # a CPU run launches no kernel


def test_the_bench_checks_the_reference_keys():
    """``bench_torch.FED_KEYS`` (what ``chip_smoke.py`` holds the card's run
    to) lists the reference's keys written here."""
    from tests.torch_bench_fed import ENV_KEYS, KEYS, PRED_KEYS

    assert {leg: set(keys) for leg, keys in bench_torch.FED_KEYS.items()} == \
        {leg: set(keys) for leg, keys in KEYS.items()}
    assert set(bench_torch.FED_PRED_KEYS) == set(PRED_KEYS) and set(bench_torch.ENV_KEYS) == set(ENV_KEYS)
    assert bench_torch.FED_LEG_NAMES == tuple(KEYS)


def test_record_names_the_host_and_no_baseline():
    record, _ = port_run(LEGS)
    for key in ENV_KEYS:
        assert key in record, key
    assert record["env_device_kind"] == "cpu" and record["vs_baseline"] == 1.0


def test_resnet18_bundle_is_the_reference_bundle():
    """The full-size legs' bundle MB: the JAX package's packed bf16
    ResNet-18, computed from ``rayfed_tpu`` directly."""
    import jax

    from rayfed_tpu.fl import compression as jc
    from rayfed_tpu.models import resnet as jr

    bundle = jc.compress(jr.init_resnet(jax.random.PRNGKey(0), jr.resnet18(num_classes=10)), packed=True)
    mb = sum(leaf.nbytes for leaf in jax.tree_util.tree_leaves(bundle)) / 1e6
    record, _ = port_run(LEGS)
    assert record["stream_agg_bundle_mb"] == round(mb, 1)
    assert record["ring_bundle_mb"] == round(mb, 1)


def test_push_moves_the_bytes_it_counts():
    """Rates are bytes over walls: positive; the split ceiling, computed
    once both legs have run, and the measured rate's share of it agree."""
    record, _ = port_run(LEGS)
    for key in ("push_GBps", "push_reshard_GBps", "multirail_GBps", "singlerail_GBps", "split_fl_GBps",
                "split_fl_ceiling_steps_per_sec"):
        assert record[key] > 0, key
    share = record["split_fl_steps_per_sec"] / record["split_fl_ceiling_steps_per_sec"]
    assert abs(share - record["split_fl_vs_ceiling"]) <= 1e-2 * share + 2e-3


def test_children_refuse_jax():
    """The check every child makes before it reports: this test process has
    JAX loaded, so it fails here."""
    import jax  # noqa: F401

    with pytest.raises(AssertionError, match="loaded"):
        bench_torch._assert_no_jax()


def test_fed_only_with_compute_only_is_refused():
    with pytest.raises(SystemExit):
        bench_torch.main(["--fed-only", "--compute-only"])


def test_the_card_is_asked_for_before_any_leg(monkeypatch):
    """No card: ``run_fed`` raises before it starts a child."""
    monkeypatch.setattr(bench_torch.torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench_torch, "_multi_party", lambda *a, **k: pytest.fail("a child was started"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.run_fed("cuda")
