"""The port's chunked/pipelined send path, held against the reference's
tests/test_transport_pipeline.py.

Covers: chunk-ordering integrity of large streamed payloads (the CRC of
chunk k+1 overlaps the write of chunk k — bytes must still land in
order), fan-out send_many sharing one encode, in-flight receive bytes
counting as health-monitor liveness, the ctl-connection close() race,
and client-sampling determinism.  The reference's slow 1.2 GB transfer
is left to the card (``chip_smoke.py`` moves a 1.07 GB tensor).
"""

import asyncio
import threading
import time

import numpy as np
import pytest

from rayfed_tpu_torch.config import ClusterConfig, JobConfig, PartyConfig
from rayfed_tpu_torch.transport.manager import TransportManager
from tests.multiproc import get_free_ports


def _self_cluster(party="alice"):
    (port,) = get_free_ports(1)
    return ClusterConfig(
        parties={party: PartyConfig(address=f"127.0.0.1:{port}")},
        current_party=party,
    )


def _mk_manager(party="alice", **job_kw):
    job_kw.setdefault("device_put_received", False)
    mgr = TransportManager(_self_cluster(party), JobConfig(**job_kw))
    mgr.start()
    return mgr


def test_chunked_send_preserves_byte_order():
    """A payload spanning many write chunks arrives byte-exact: the
    pipelined CRC/write stages must not reorder or corrupt chunks."""
    mgr = _mk_manager()
    try:
        # > 4 write chunks, not chunk-aligned, with position-dependent
        # content so any reordering breaks equality.
        arr = np.arange(5 * 1024 * 1024 + 12345, dtype=np.uint8)
        tree = {"a": arr, "b": np.arange(1000, dtype=np.float64)}
        recv_ref = mgr.recv("alice", "chunk", "0")
        assert mgr.send("alice", tree, "chunk", "0").resolve(timeout=60)
        out = recv_ref.resolve(timeout=60)
        np.testing.assert_array_equal(out["a"], arr)
        np.testing.assert_array_equal(out["b"], tree["b"])
    finally:
        mgr.stop()


def test_send_overlap_stats_recorded():
    mgr = _mk_manager()
    try:
        big = np.ones(12 * 1024 * 1024, dtype=np.uint8)
        recv_ref = mgr.recv("alice", "st", "0")
        assert mgr.send("alice", big, "st", "0").resolve(timeout=60)
        recv_ref.resolve(timeout=60)
        stats = mgr.get_stats()
        assert stats["send_frames"] >= 1
        assert stats["send_payload_bytes"] >= big.nbytes
        assert stats["send_frame_wall_s"] > 0
        assert stats["send_write_s"] > 0
        assert stats["send_overlap_saved_s"] >= 0.0
    finally:
        mgr.stop()


def test_send_many_fans_out_one_encode():
    """send_many to [self] behaves like send; N dest refs all resolve."""
    mgr = _mk_manager()
    try:
        recv_ref = mgr.recv("alice", "fan", "0")
        refs = mgr.send_many(["alice"], {"x": np.arange(32)}, "fan", "0")
        assert set(refs) == {"alice"}
        assert refs["alice"].resolve(timeout=30) is True
        out = recv_ref.resolve(timeout=30)
        np.testing.assert_array_equal(out["x"], np.arange(32))
        assert mgr.get_stats()["send_op_count"] == 1
    finally:
        mgr.stop()


def test_shared_lazy_buffer_produces_once():
    from rayfed_tpu_torch.transport import wire

    calls = []

    def produce():
        calls.append(1)
        return memoryview(b"abcd")

    shared = wire.SharedLazyBuffer(wire.LazyBuffer(produce, 4))
    assert bytes(shared.produce()) == b"abcd"
    assert bytes(shared.produce()) == b"abcd"
    assert len(calls) == 1


def test_rx_progress_tracks_inflight_bytes():
    """The server counts payload bytes per source party, so the health
    monitor can credit an in-progress bulk transfer as liveness."""
    mgr = _mk_manager()
    try:
        big = np.ones(6 * 1024 * 1024, dtype=np.uint8)
        recv_ref = mgr.recv("alice", "rx", "0")
        assert mgr.send("alice", big, "rx", "0").resolve(timeout=60)
        recv_ref.resolve(timeout=60)
        progress = mgr._server.receive_progress()
        assert progress.get("alice", 0) >= big.nbytes
    finally:
        mgr.stop()


def test_health_monitor_spares_party_with_arriving_bytes():
    """Pings all fail, but rx-progress keeps advancing → the party must
    NOT be declared dead; when progress stops, fail-fast proceeds."""
    mgr = _mk_manager(
        peer_failfast=True,
        peer_health_interval_s=0.05,
        peer_death_pings=2,
    )
    try:
        # The peer ("bob") is never reachable by ping.
        class _DeadClient:
            async def ping(self, timeout_s=1.0, ctl=False):
                return False

        mgr._get_client = lambda party: _DeadClient()

        from rayfed_tpu_torch.transport.rendezvous import Message

        # Seed reachability evidence (a past delivery) + a parked waiter.
        def _seed():
            mgr._mailbox.put(
                Message("bob", "seed", "0", b"x", {})
            )

        mgr._loop.call_soon_threadsafe(_seed)
        recv_ref = mgr.recv("bob", "want", "0")
        deadline = time.monotonic() + 2.0

        # Feed rx progress continuously: an in-flight transfer.
        stop = threading.Event()

        def _feed():
            while not stop.is_set() and time.monotonic() < deadline:
                mgr._server.note_rx_progress("bob", 1024)
                time.sleep(0.02)

        feeder = threading.Thread(target=_feed)
        feeder.start()
        time.sleep(1.0)  # many ping cycles elapse with progress flowing
        assert "bob" not in mgr._mailbox.dead_parties_snapshot()
        assert not recv_ref.done()
        stop.set()
        feeder.join()
        # Progress stalled → consecutive ping failures now count.
        for _ in range(100):
            if recv_ref.done():
                break
            time.sleep(0.05)
        assert recv_ref.done()
        from rayfed_tpu_torch.exceptions import RemoteError

        with pytest.raises(RemoteError):
            recv_ref.resolve()
    finally:
        mgr.stop()


def test_close_racing_ctl_ping_leaks_nothing():
    """close() must synchronize with _acquire_ctl_conn: a ping mid-open
    must not resurrect a connection that close() never tears down."""
    from rayfed_tpu_torch.config import RetryPolicy
    from rayfed_tpu_torch.transport.client import TransportClient
    from rayfed_tpu_torch.transport.rendezvous import Mailbox
    from rayfed_tpu_torch.transport.server import TransportServer

    async def _run():
        mailbox = Mailbox()
        server = TransportServer(
            party="alice",
            listen_addr="127.0.0.1:0",
            mailbox=mailbox,
            max_message_size=1 << 20,
        )
        await server.start()
        client = TransportClient(
            "alice", "alice", f"127.0.0.1:{server.bound_port}",
            RetryPolicy(), timeout_s=5.0, max_message_size=1 << 20,
            checksum=False,
        )
        gate = asyncio.Event()
        real_open = client._open_conn
        opened = []

        async def _slow_open():
            await gate.wait()  # hold _ctl_lock across close()'s attempt
            conn = await real_open()
            opened.append(conn)
            return conn

        client._open_conn = _slow_open
        ping_task = asyncio.ensure_future(client.ping(ctl=True))
        await asyncio.sleep(0.05)  # ping is inside _ctl_lock, awaiting gate
        close_task = asyncio.ensure_future(client.close())
        await asyncio.sleep(0.05)
        gate.set()  # let the ping finish opening its connection
        await asyncio.wait_for(close_task, timeout=5)
        await asyncio.wait_for(ping_task, timeout=5)
        # Whatever the ping opened must have been torn down by close.
        assert client._ctl_conn is None
        for conn in opened:
            assert conn.closed
        await server.stop()

    asyncio.new_event_loop().run_until_complete(_run())


def test_sample_parties_independent_of_dict_order():
    from rayfed_tpu_torch.fl.trainer import sample_parties

    parties_a = ["alice", "bob", "carol", "dave", "erin"]
    parties_b = list(reversed(parties_a))
    for r in range(20):
        assert sample_parties(parties_a, 2, 7, r) == sample_parties(
            parties_b, 2, 7, r
        )

