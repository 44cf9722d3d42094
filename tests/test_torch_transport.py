"""The port's transport (CPU): ports of tests/test_transport.py's
in-process cases, a JAX-package manager and a port manager exchanging in
one process over tcp and uds, and two port managers over shm.

Values must arrive unchanged (tolerance: byte identity).  The shm backend
hands buffers through a registry private to each package's
``transport/local.py``, so shm joins two managers of one package only.
"""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

from rayfed_tpu.config import (
    ClusterConfig as JClusterConfig,
    JobConfig as JJobConfig,
    PartyConfig as JPartyConfig,
)
from rayfed_tpu.transport.manager import TransportManager as JTransportManager
from rayfed_tpu_torch.config import (
    ClusterConfig,
    JobConfig,
    PartyConfig,
    RetryPolicy,
)
from rayfed_tpu_torch.transport.manager import TransportManager
from tests.multiproc import get_free_ports

CPU = torch.device("cpu")


def _self_cluster(party="alice", metadata=None, transport_options=None):
    (port,) = get_free_ports(1)
    return ClusterConfig(
        parties={
            party: PartyConfig(
                address=f"127.0.0.1:{port}",
                metadata=metadata or {},
                transport_options=transport_options or {},
            )
        },
        current_party=party,
    )


@pytest.fixture()
def manager():
    cluster = _self_cluster()
    mgr = TransportManager(cluster, JobConfig(device_put_received=False))
    mgr.start()
    yield mgr
    mgr.stop()


def test_n_to_1_transport(manager):
    """10 concurrent send/recv pairs through the real proxies."""
    n = 10
    recv_refs = [manager.recv("alice", f"up-{i}", f"down-{i}") for i in range(n)]
    send_refs = [
        manager.send("alice", {"i": i, "arr": np.full(4, i), "t": torch.full((4,), i)},
                     f"up-{i}", f"down-{i}")
        for i in range(n)
    ]
    assert all(r.resolve(timeout=30) for r in send_refs)
    for i, ref in enumerate(recv_refs):
        value = ref.resolve(timeout=30)
        assert value["i"] == i
        np.testing.assert_array_equal(value["arr"], np.full(4, i))
        assert torch.equal(value["t"], torch.full((4,), i))
    stats = manager.get_stats()
    assert stats["send_op_count"] == n
    assert stats["receive_op_count"] == n


def test_data_before_recv(manager):
    send_ref = manager.send("alice", "early", "5#0", "7")
    assert send_ref.resolve(timeout=30) is True
    assert manager.recv("alice", "5#0", "7").resolve(timeout=30) == "early"


def test_recv_before_data(manager):
    recv_ref = manager.recv("alice", "9#0", "11")
    done = threading.Event()
    recv_ref.add_done_callback(lambda _: done.set())
    assert not done.wait(timeout=0.2)
    manager.send("alice", [1, 2, 3], "9#0", "11")
    assert recv_ref.resolve(timeout=30) == [1, 2, 3]


def test_metadata_propagation():
    cluster = _self_cluster(metadata={"token": "alice-token"})
    job = JobConfig(metadata={"job": "j1"}, device_put_received=False)
    mgr = TransportManager(cluster, job)
    seen = {}
    mgr._server._on_message = lambda m: seen.update(m.metadata)
    mgr.start()
    try:
        assert mgr.send("alice", b"d", "m1", "m2").resolve(timeout=30)
        mgr.recv("alice", "m1", "m2").resolve(timeout=30)
        assert seen == {"job": "j1", "token": "alice-token"}
    finally:
        mgr.stop()


def test_per_party_metadata_overrides_global():
    cluster = _self_cluster(metadata={"token": "party-specific"})
    job = JobConfig(metadata={"token": "global"}, device_put_received=False)
    mgr = TransportManager(cluster, job)
    assert mgr.merged_metadata("alice") == {"token": "party-specific"}


def test_message_size_cap():
    cluster = _self_cluster()
    job = JobConfig(cross_silo_messages_max_size=1024, device_put_received=False)
    mgr = TransportManager(cluster, job)
    mgr.start()
    try:
        big = torch.zeros(100_000)
        assert mgr.send("alice", big, "big", "big").resolve(timeout=30) is False
    finally:
        mgr.stop()


def test_send_to_absent_party_fails_fast():
    (port,) = get_free_ports(1)
    cluster = ClusterConfig(
        parties={
            "alice": PartyConfig(address="127.0.0.1:1"),  # nobody listening
            "bob": PartyConfig(address=f"127.0.0.1:{port}"),
        },
        current_party="bob",
    )
    job = JobConfig(
        retry_policy=RetryPolicy(max_attempts=2, initial_backoff_s=0.05, max_backoff_s=0.1),
        device_put_received=False,
    )
    mgr = TransportManager(cluster, job)
    mgr.start()
    try:
        assert mgr.send("alice", "x", "1#0", "2").resolve(timeout=30) is False
    finally:
        mgr.stop()


def test_ping(manager):
    assert manager.ping("alice", timeout_s=2.0) is True


def test_ping_absent():
    cluster = ClusterConfig(
        parties={
            "bob": PartyConfig(address="127.0.0.1:1"),
            "alice": _self_cluster().parties["alice"],
        },
        current_party="alice",
    )
    mgr = TransportManager(cluster, JobConfig(device_put_received=False))
    mgr.start()
    try:
        assert mgr.ping("bob", timeout_s=0.5) is False
    finally:
        mgr.stop()


def test_transport_options_per_party():
    cluster = _self_cluster(transport_options={"grpc.max_send_message_length": 2048})
    mgr = TransportManager(cluster, JobConfig(device_put_received=False))
    assert mgr._merged_options("alice")["max_message_size"] == 2048


def test_duplicate_delivery_dropped(manager):
    manager.send("alice", "original", "dup#0", "1")
    assert manager.recv("alice", "dup#0", "1").resolve(timeout=30) == "original"
    manager.send("alice", "retry-copy", "dup#0", "1").resolve(timeout=30)
    deadline = time.time() + 10
    while time.time() < deadline and manager._mailbox.stats["dropped_duplicates"] < 1:
        time.sleep(0.05)
    assert manager._mailbox.stats["dropped_duplicates"] >= 1
    assert manager._mailbox.pending_count() == 0


def test_recv_timeout_surfaces():
    mgr = TransportManager(
        _self_cluster(), JobConfig(device_put_received=False, recv_backstop_s=0.2)
    )
    mgr.start()
    try:
        ref = mgr.recv("alice", "never#0", "1")
        with pytest.raises(TimeoutError):
            ref.resolve(timeout=30)
        assert mgr._mailbox.pending_count() == 0
    finally:
        mgr.stop()


def test_mailbox_ttl_gc():
    mgr = TransportManager(
        _self_cluster(), JobConfig(device_put_received=False, mailbox_ttl_s=0.05)
    )
    mgr.start()
    try:
        mgr.send("alice", torch.zeros(1024), "orphan#0", "1").resolve(timeout=30)
        deadline = time.time() + 10
        while time.time() < deadline and mgr._mailbox.pending_count():
            asyncio.run_coroutine_threadsafe(asyncio.sleep(0), mgr._loop).result()
            mgr._loop.call_soon_threadsafe(mgr._mailbox.gc)
            time.sleep(0.1)
        assert mgr._mailbox.pending_count() == 0
        assert mgr._mailbox.stats["expired"] >= 1
    finally:
        mgr.stop()


def test_streamed_tensor_transfer_end_to_end():
    """A 32 MB tensor travels as a streamed frame (lazy host fetch + CRC
    trailer) and lands on the receiving party's device."""
    mgr = TransportManager(_self_cluster(), JobConfig(device_put_received=True), device=CPU)
    mgr.start()
    try:
        x = torch.arange(8 * 1024 * 1024, dtype=torch.float32).reshape(4096, 2048)
        recv_ref = mgr.recv("alice", "shard#0", "1")
        assert mgr.send("alice", {"w": x, "tag": "big"}, "shard#0", "1").resolve(timeout=60)
        out = recv_ref.resolve(timeout=60)
        assert out["tag"] == "big"
        assert isinstance(out["w"], torch.Tensor) and out["w"].device == CPU
        assert torch.equal(out["w"], x)
        from rayfed_tpu_torch import native

        if native.is_available():
            assert mgr._server.stats.get("receive_crc_errors", 0) == 0
    finally:
        mgr.stop()


def test_mailbox_fail_party_semantics():
    from rayfed_tpu_torch.exceptions import RemoteError

    mgr = TransportManager(
        _self_cluster(), JobConfig(device_put_received=False, peer_failfast=False)
    )
    mgr.start()
    try:
        mailbox = mgr._mailbox
        err = RemoteError("bob", "ConnectionError", "gone").to_wire()

        def on_loop(fn, *args):
            async def _call():
                return fn(*args)

            return asyncio.run_coroutine_threadsafe(_call(), mgr._loop).result(10)

        ref_bob = mgr.recv("bob", "u1", "d1")
        ref_carol = mgr.recv("carol", "u2", "d2")
        deadline = time.time() + 5
        while time.time() < deadline:
            if on_loop(mailbox.parties_with_waiters) == {"bob", "carol"}:
                break
            time.sleep(0.02)
        assert on_loop(mailbox.parties_with_waiters) == {"bob", "carol"}
        on_loop(mailbox.fail_party, "bob", err)
        with pytest.raises(RemoteError, match="bob"):
            ref_bob.resolve(timeout=10)
        assert on_loop(mailbox.parties_with_waiters) == {"carol"}
        assert mgr.get_stats()["dead_parties"] == ["bob"]
        with pytest.raises(RemoteError, match="bob"):
            mgr.recv("bob", "u3", "d3").resolve(timeout=10)
        on_loop(mailbox.clear_party_failure, "bob")
        ref_bob2 = mgr.recv("bob", "u4", "d4")
        assert mgr.send("alice", torch.full((4,), 7.0), "u4", "d4").resolve(timeout=30)
        assert torch.equal(ref_bob2.resolve(timeout=30), torch.full((4,), 7.0))
        assert mgr.send("alice", np.ones(8), "u2", "d2").resolve(timeout=30)
        assert ref_carol.resolve(timeout=30).shape == (8,)
    finally:
        mgr.stop()


def test_ping_ctl_connection(manager):
    client = manager._get_client("alice")
    run = lambda coro: asyncio.run_coroutine_threadsafe(coro, manager._loop).result(10)  # noqa: E731
    assert run(client.ping(timeout_s=2.0, ctl=True)) is True
    ctl_before = client._ctl_conn
    assert ctl_before is not None
    assert run(client.ping(timeout_s=2.0)) is True and client._ctl_conn is ctl_before
    run(client.close())
    assert run(client.ping(timeout_s=1.0, ctl=True)) is False and client._ctl_conn is None


# -- across the two packages, and the local links ----------------------------


def _cluster_dicts(ports):
    return {p: {"address": f"127.0.0.1:{port}"} for p, port in ports.items()}


def _port_manager(party, ports, **job):
    cc = ClusterConfig(
        parties={p: PartyConfig.from_dict(c) for p, c in _cluster_dicts(ports).items()},
        current_party=party,
    )
    return TransportManager(cc, JobConfig(**job), device=CPU)


def _jax_manager(party, ports, **job):
    cc = JClusterConfig(
        parties={p: JPartyConfig.from_dict(c) for p, c in _cluster_dicts(ports).items()},
        current_party=party,
    )
    return JTransportManager(cc, JJobConfig(**job))


def _payloads(seed):
    rng = np.random.default_rng(seed)
    small = rng.standard_normal((3, 5)).astype(np.float32)
    big = rng.standard_normal((2048, 1024)).astype(np.float32)  # 8 MiB: streamed
    return small, big


@pytest.mark.parametrize("mode,backend", [("off", "tcp"), ("uds", "uds")])
def test_jax_and_port_managers_exchange(mode, backend):
    """A JAX-package party and a port party push to each other in one
    process: the port's tensors arrive as jax.Arrays and the reference's
    jax.Arrays as tensors, byte for byte."""
    import jax
    import jax.numpy as jnp

    pa, pb = get_free_ports(2)
    ports = {"alice": pa, "bob": pb}
    job = dict(device_put_received=True, local_link=mode, cross_silo_timeout_s=10)
    alice = _jax_manager("alice", ports, **job)
    bob = _port_manager("bob", ports, **job)
    alice.start()
    bob.start()
    try:
        small, big = _payloads(0)
        sent = {"s": torch.from_numpy(small), "b": torch.from_numpy(big), "n": np.arange(3), "i": 7}
        assert bob.send("alice", sent, "t1", "0").resolve(timeout=60)
        got = alice.recv("bob", "t1", "0").resolve(timeout=60)
        assert isinstance(got["b"], jax.Array) and isinstance(got["s"], jax.Array)
        assert np.asarray(got["b"]).tobytes() == big.tobytes()
        assert np.asarray(got["s"]).tobytes() == small.tobytes()
        assert got["i"] == 7 and np.array_equal(got["n"], np.arange(3))

        small2, big2 = _payloads(1)
        back = {"s": jnp.asarray(small2), "b": jnp.asarray(big2).astype(jnp.bfloat16)}
        assert alice.send("bob", back, "t2", "0").resolve(timeout=60)
        got2 = bob.recv("alice", "t2", "0").resolve(timeout=60)
        assert isinstance(got2["b"], torch.Tensor) and got2["b"].dtype == torch.bfloat16
        assert got2["s"].numpy().tobytes() == small2.tobytes()
        assert got2["b"].view(torch.int16).numpy().tobytes() == np.asarray(back["b"]).tobytes()
        for mgr, peer in ((bob, "alice"), (alice, "bob")):
            info = mgr.effective_transport_options(peer)["local_link"]
            assert info["decided"] and info["backend"] == backend, info
    finally:
        alice.stop()
        bob.stop()


@pytest.mark.parametrize("mode", ["shm", "auto"])
def test_port_managers_exchange_over_shm(mode):
    pa, pb = get_free_ports(2)
    ports = {"alice": pa, "bob": pb}
    alice = _port_manager("alice", ports, device_put_received=True, local_link=mode)
    bob = _port_manager("bob", ports, device_put_received=True, local_link=mode)
    alice.start()
    bob.start()
    try:
        small, big = _payloads(2)
        sent = {"s": torch.from_numpy(small), "b": torch.from_numpy(big).to(torch.bfloat16)}
        assert alice.send("bob", sent, "s1", "0").resolve(timeout=60)
        got = bob.recv("alice", "s1", "0").resolve(timeout=60)
        assert torch.equal(got["s"], sent["s"]) and torch.equal(got["b"], sent["b"])
        assert bob.send("alice", got, "s2", "0").resolve(timeout=60)
        back = alice.recv("bob", "s2", "0").resolve(timeout=60)
        assert torch.equal(back["b"], sent["b"])
        info = alice.effective_transport_options("bob")["local_link"]
        assert info["decided"] and info["backend"] == "shm", info
    finally:
        alice.stop()
        bob.stop()
