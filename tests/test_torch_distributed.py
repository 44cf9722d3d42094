"""The port's multi-process party bridge (``rayfed_tpu_torch/distributed.py``)
against ``tests/test_distributed_hardening.py``'s cases, in-process.

As there, a duck-typed fake process group stands in for the party's store
and world (no subprocess): the party leader dies mid-round and a member's
parked bridge recv raises a RemoteError naming the leader within the death
deadline; a republish that exceeds the bridge's cap raises on the member
instead of hanging.  Then :class:`PartyProcessGroup`'s control plane on an
in-process ``TCPStore``: the key-value round trip, the deadline of a
blocking get, and the named failure of a barrier that a process never
reaches.  Tolerance: exact values.
"""

import datetime
import time

import numpy as np
import pytest
import torch.distributed as dist

from rayfed_tpu_torch.config import ClusterConfig, JobConfig, PartyConfig, RetryPolicy
from rayfed_tpu_torch.distributed import MultiHostTransport, PartyProcessGroup, _local_host_ip
from rayfed_tpu_torch.exceptions import RemoteError
from rayfed_tpu_torch.transport.manager import TransportManager
from tests.multiproc import get_free_ports

CPU = "cpu"


class _FakeGroup:
    """Duck-typed PartyProcessGroup: an in-memory KV, no store or world."""

    def __init__(self, num_processes, process_id, kv=None):
        self.num_processes = num_processes
        self.process_id = process_id
        self._kv = kv if kv is not None else {}

    @property
    def is_leader(self):
        return self.process_id == 0

    def publish_bridge_address(self, address):
        self._kv[self.process_id] = address

    def fetch_bridge_address(self, pid, timeout_s):
        deadline = time.monotonic() + timeout_s
        while pid not in self._kv:
            if time.monotonic() > deadline:
                raise TimeoutError(f"no bridge address for p{pid}")
            time.sleep(0.05)
        return self._kv[pid]

    def barrier(self, name, timeout_s=120.0):
        pass

    def cleanup(self):
        pass

    def shutdown(self):
        pass


def _mk_manager(party, ports, **job_kw):
    cc = ClusterConfig(
        parties={
            p: PartyConfig.from_dict({"address": f"127.0.0.1:{port}"})
            for p, port in ports.items()
        },
        current_party=party,
    )
    job = dict(
        device_put_received=False,
        cross_silo_timeout_s=3,
        retry_policy=RetryPolicy(max_attempts=2, initial_backoff_s=0.2,
                                 max_backoff_s=0.4, jitter=False),
    )
    job.update(job_kw)
    return TransportManager(cc, JobConfig(**job), device=CPU)


def test_leader_death_poisons_member_recvs_within_deadline():
    (leader_port,) = get_free_ports(1)
    leader_mgr = _mk_manager("alice", {"alice": leader_port})
    leader_mgr.start()
    member = MultiHostTransport(
        None,
        _FakeGroup(num_processes=2, process_id=1),
        device_put_received=False,
        timeout_s=60.0,
        job_config=JobConfig(
            peer_health_interval_s=0.3,
            peer_death_pings=2,
            cross_silo_timeout_s=3,
            device_put_received=False,
        ),
        leader_address=f"127.0.0.1:{leader_port}",
        device=CPU,
    )
    try:
        # Park a recv on the bridge (what a non-leader does for every
        # cross-party value) and let the watchdog see the leader alive.
        ref = member.recv("bob", "u1", "d1")
        time.sleep(1.2)
        assert not ref.done()
        leader_mgr.stop()  # the leader process dies mid-round
        t0 = time.monotonic()
        with pytest.raises(RemoteError, match="leader"):
            ref.resolve(timeout=30)
        assert time.monotonic() - t0 < 15
        # New waiters keep failing while the leader stays dead.
        with pytest.raises(RemoteError, match="leader"):
            member.recv("bob", "u2", "d1").resolve(timeout=30)
    finally:
        member.stop()


def test_republish_failure_raises_on_member_instead_of_hanging():
    leader_port, bob_port = get_free_ports(2)
    ports = {"alice": leader_port, "bob": bob_port}
    kv = {}
    # The "non-leader process": a bridge listener whose message cap is
    # too small for the republished payload (the classic torn-config
    # failure) — but big enough for the poison frame.
    bridge_cc = ClusterConfig(
        parties={"bridge-p1": PartyConfig.from_dict({"address": "0.0.0.0:0"})},
        current_party="bridge-p1",
    )
    bridge_mgr = TransportManager(
        bridge_cc,
        JobConfig(device_put_received=False, cross_silo_messages_max_size=16 * 1024),
        device=CPU,
    )
    bridge_mgr.start()
    kv[1] = f"127.0.0.1:{bridge_mgr._server.bound_port}"

    inner = _mk_manager("alice", ports)  # NOT started: the leader wrapper
    leader = MultiHostTransport(
        inner,
        _FakeGroup(num_processes=2, process_id=0, kv=kv),
        device_put_received=False,
        timeout_s=60.0,
        job_config=inner._job,
        device=CPU,
    )
    failures = []
    leader.failure_handler = lambda ref, exc: failures.append(exc)
    bob = _mk_manager("bob", ports)
    bob.start()
    try:
        # Wait for the leader's bridge clients to resolve.
        assert leader._bridge_ready.wait(timeout=15)
        payload = np.arange(32 * 1024, dtype=np.float64)  # 256 KB > cap
        assert bob.send("alice", payload, "u9", "d9").resolve(timeout=30)
        # Leader received it; the republish to the bridge is fatally
        # oversize — the member's recv must RAISE, not hang.
        with pytest.raises(RemoteError, match="republish"):
            bridge_mgr.recv("bob", "u9", "d9").resolve(timeout=30)
        deadline = time.monotonic() + 10
        while not failures and time.monotonic() < deadline:
            time.sleep(0.05)
        assert failures  # the cleanup watchdog heard about it too
    finally:
        bob.stop()
        leader.stop()
        bridge_mgr.stop()


def test_member_bridge_republishes_the_leader_payload():
    """The bridge path itself: bob's push reaches the leader and, through the
    leader's republish, the member's bridge mailbox byte for byte; a member's
    send resolves True at once (the leader's program does the real push)."""
    leader_port, bob_port = get_free_ports(2)
    ports = {"alice": leader_port, "bob": bob_port}
    kv = {}
    job = JobConfig(device_put_received=False, cross_silo_timeout_s=3)
    member = MultiHostTransport(None, _FakeGroup(2, 1, kv), device_put_received=False,
                                timeout_s=60.0, job_config=job, device=CPU)
    inner = _mk_manager("alice", ports)
    leader = MultiHostTransport(inner, _FakeGroup(2, 0, kv), device_put_received=False,
                                timeout_s=60.0, job_config=inner._job, device=CPU)
    bob = _mk_manager("bob", ports)
    bob.start()
    try:
        assert leader._bridge_ready.wait(timeout=15)
        payload = np.random.default_rng(0).standard_normal(1 << 16).astype(np.float32)
        assert bob.send("alice", payload, "u1", "d1").resolve(timeout=30)
        assert leader.recv("bob", "u1", "d1").resolve(timeout=30).tobytes() == payload.tobytes()
        assert member.recv("bob", "u1", "d1").resolve(timeout=30).tobytes() == payload.tobytes()
        assert member.send("bob", payload, "u2", "d2").resolve(timeout=1) is True
        assert member.get_stats()["party_process_id"] == 1
        with pytest.raises(NotImplementedError, match="non-leader"):
            member.recv_stream("bob", "u3", "d3", sink=None)
    finally:
        bob.stop()
        leader.stop()
        member.stop()


def _store_group(num_processes=2, process_id=0):
    """A PartyProcessGroup's control plane on an in-process TCPStore (the
    party's world is not joined: no subprocess)."""
    (port,) = get_free_ports(1)
    store = dist.TCPStore("127.0.0.1", port, num_processes, is_master=True,
                          timeout=datetime.timedelta(seconds=30), wait_for_workers=False)
    group = PartyProcessGroup.__new__(PartyProcessGroup)
    group._attach(store, f"127.0.0.1:{port}", num_processes, process_id)
    return group


def test_party_store_key_value_round_trip():
    group = _store_group()
    assert group.is_leader and group.host == "127.0.0.1"
    group.key_value_set("verdict/0", "ok")
    assert group.blocking_key_value_get("verdict/0", 5.0) == "ok"
    group.publish_bridge_address("127.0.0.1:4242")  # as process 0 would not, but the key is its
    assert group.fetch_bridge_address(0, 5.0) == "127.0.0.1:4242"
    group.cleanup()  # the leader drops members' bridge keys; its own stays
    assert group.fetch_bridge_address(0, 5.0) == "127.0.0.1:4242"
    assert _local_host_ip(group.host) == "127.0.0.1"


def test_party_store_get_times_out():
    group = _store_group()
    t0 = time.monotonic()
    with pytest.raises(Exception):
        group.blocking_key_value_get("never-set", 0.5)
    assert time.monotonic() - t0 < 10


def test_barrier_failure_is_named():
    """PartyProcessGroup.barrier wraps the store's timeout with the barrier
    name and process: process 1 of 2 waits for a process 0 that never comes."""
    group = _store_group(process_id=1)
    with pytest.raises(RuntimeError, match="barrier 'round-3' failed on process 1/2"):
        group.barrier("round-3", timeout_s=0.2)
    # A barrier that every process reaches passes.
    solo = _store_group(num_processes=1)
    solo.barrier("round-3", timeout_s=5.0)
