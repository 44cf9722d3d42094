"""``bench_torch.py --smoke`` on the CPU, part 3: the legs of party
processes and fleets (ring_agg, overlap, chaos, async_rounds), held to their
gates; the ring's coordinator share of the ingress is held to the JAX
package's own leg.  These legs are party processes by design, as
``bench.py --smoke`` runs them.  See ``tests/torch_bench_smoke.py``."""

import pytest

from tests.torch_bench_smoke import check_gate, gate_params, port_leg, reference_leg

LEGS = ("ring_agg", "overlap", "chaos", "async_rounds")


@pytest.mark.parametrize("gate", gate_params(LEGS))
def test_gate(gate):
    check_gate(gate, port_leg(gate.leg))


def test_coord_bytes_in_frac_equals_the_reference():
    port, ref = port_leg("ring_agg"), reference_leg("ring_agg")
    assert port["coord_bytes_in_frac"] == ref["coord_bytes_in_frac"]
    assert port["ring_quant_bytes_frac"] == ref["ring_quant_bytes_frac"]


def test_chaos_drops_the_crashed_parties():
    extra = port_leg("chaos")
    assert sorted(extra["chaos_crashed_parties"]) == ["alice", "dave"]
    # The lease moved to alice's deterministic successor.
    assert extra["chaos_final_coordinator"] == "bob"


def test_overlap_reports_both_walls():
    extra = port_leg("overlap")
    assert extra["overlap_round_ms"] > 0 and extra["sync_round_ms"] > 0
    assert extra["overlap_local_ms_per_round"] > 0


def test_async_reaches_the_target_both_ways():
    extra = port_leg("async_rounds")
    assert extra["async_time_to_target_s"] is not None and extra["sync_time_to_target_s"] is not None
    assert extra["async_versions"] >= 1
