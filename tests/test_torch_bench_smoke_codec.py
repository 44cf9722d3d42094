"""``bench_torch.py --smoke`` on the CPU, part 2: the codec legs
(compressed_agg, secagg, server_opt), held to their gates and, where sizes
and numpy draws fix a value, to the JAX package's own leg.  See
``tests/torch_bench_smoke.py``."""

import pytest

from tests.torch_bench_smoke import check_gate, gate_params, port_leg, reference_leg

LEGS = ("compressed_agg", "secagg", "server_opt")


@pytest.mark.parametrize("gate", gate_params(LEGS))
def test_gate(gate):
    check_gate(gate, port_leg(gate.leg))


def test_fedac_rounds_to_target_equal_the_reference():
    port, ref = port_leg("server_opt"), reference_leg("server_opt")
    # The same quadratic (numpy draws of default_rng(11)), the same step and
    # resync arithmetic: FedAC and plain FedAvg need the same rounds.
    assert (port["fedac_rounds_to_target"], port["fedavg_rounds_to_target"]) == (
        ref["fedac_rounds_to_target"], ref["fedavg_rounds_to_target"])
    assert port["fedac_rounds_to_target_frac"] == ref["fedac_rounds_to_target_frac"]


def test_compressed_loss_ratio_equals_the_reference():
    port, ref = port_leg("compressed_agg"), reference_leg("compressed_agg")
    assert abs(port["compressed_loss_ratio"] - ref["compressed_loss_ratio"]) <= 1e-6


def test_compressed_bytes_on_wire_equal_the_reference():
    port, ref = port_leg("compressed_agg"), reference_leg("compressed_agg")
    assert port["compressed_bytes_on_wire_frac"] == ref["compressed_bytes_on_wire_frac"]


def test_secagg_keys_every_peer():
    extra = port_leg("secagg")
    assert extra["secagg_peers_keyed"] == 3
    assert extra["secagg_round_ms"] > 0 and extra["secagg_plain_round_ms"] > 0


def test_server_opt_logistic_rounds_reported():
    extra = port_leg("server_opt")
    assert 0 < extra["fedac_logistic_rounds_frac"] <= 1
