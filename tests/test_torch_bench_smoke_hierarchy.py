"""``bench_torch.py --smoke`` on the CPU, part 4: the hierarchy leg at
N = 4, 16, 64 and the multi-level N = 256 with its straggling-region chaos
round, held to its gates and its per-party bytes to the JAX package's own
leg (run beside the port's, both in their own processes).  See
``tests/torch_bench_smoke.py``."""

import functools
import threading

import pytest

from tests.torch_bench_smoke import check_gate, gate_params, port_leg, reference_leg


@functools.lru_cache(maxsize=None)
def _legs():
    """The port's leg and the reference's, run at once."""
    ref = {}
    t = threading.Thread(target=lambda: ref.update(reference_leg("hierarchy")), daemon=True)
    t.start()
    port = port_leg("hierarchy")
    t.join(900)
    return port, ref


@pytest.mark.parametrize("gate", gate_params(("hierarchy",)))
def test_gate(gate):
    check_gate(gate, _legs()[0])


@pytest.mark.parametrize("n", (4, 16, 64))
def test_party_bytes_equal_the_reference(n):
    port, ref = _legs()
    assert port[f"hier_party_bytes_frac_{n}"] == ref[f"hier_party_bytes_frac_{n}"]


def test_multilevel_leg_ran():
    port, _ = _legs()
    assert "hier_n256_skipped" not in port, port.get("hier_n256_skipped")
    assert port["hier_link_backend"] == "shm"
    assert set(port["hier_level_ingress_256"]) == {"l0", "l1", "l2", "l3"}


def test_free_ports_for_256_parties_below_a_wide_ephemeral_range(monkeypatch):
    """The N=256 leg's listeners on a host whose ephemeral range starts at
    16000 (the card's machine): 256 distinct ports outside it, not an error."""
    from rayfed_tpu_torch.utils import ports

    monkeypatch.setattr(ports, "_ephemeral_range", lambda: (16000, 65535))
    got = ports.free_loopback_ports(256)
    assert len(set(got)) == 256 and all(10000 <= p < 16000 for p in got)
