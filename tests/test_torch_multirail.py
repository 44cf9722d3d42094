"""The port's multi-rail striped send path and wire v4 handshake, held against
the reference's tests/test_multirail.py.

Covers: stripe reassembly under shuffled cross-rail arrival (and the
contiguous-verified-prefix sink feed), rail death mid-payload (clean
unit-of-payload failure + retry), delta-stream × multi-rail composition,
the connection HELLO version negotiation, the runtime-mutable message
cap, loud reporting of ignored transport options, send-arena reuse, and
byte-identity of streamed aggregation with striping forced on.

All tests are in-process (real loopback sockets, toy payloads).
"""

import asyncio
import logging
import zlib

import numpy as np
import pytest
import torch

from rayfed_tpu_torch.config import ClusterConfig, JobConfig, PartyConfig
from rayfed_tpu_torch.fl import compression as fl_comp
from rayfed_tpu_torch.fl import fedavg
from rayfed_tpu_torch.fl.streaming import StreamingAggregator
from rayfed_tpu_torch.transport import wire
from rayfed_tpu_torch.transport.client import (
    ProtocolMismatchError,
    TransportClient,
)
from rayfed_tpu_torch.transport.manager import TransportManager
from rayfed_tpu_torch.transport.rendezvous import Mailbox
from rayfed_tpu_torch.transport.server import TransportServer, _apply_stripe_frame
from tests.multiproc import get_free_ports


def _mk_manager(party, cluster_ports, options=None, max_size=None):
    cc = ClusterConfig(
        parties={
            p: PartyConfig.from_dict(
                dict(
                    {"address": f"127.0.0.1:{port}"},
                    **({"transport_options": options} if options else {}),
                )
            )
            for p, port in cluster_ports.items()
        },
        current_party=party,
    )
    job = dict(
        device_put_received=False,
        zero_copy_host_arrays=True,
        cross_silo_timeout_s=20,
    )
    if max_size is not None:
        job["cross_silo_messages_max_size"] = max_size
    return TransportManager(cc, JobConfig(**job))


@pytest.fixture()
def manager_pair():
    pa, pb = get_free_ports(2)
    ports = {"alice": pa, "bob": pb}
    # stripe_rails forced: the host-adaptive default disables striping
    # on few-core CI boxes, and these tests exist to exercise it.
    opts = {"stripe_rails": 2}
    a = _mk_manager("alice", ports, options=opts)
    b = _mk_manager("bob", ports, options=opts)
    a.start()
    b.start()
    yield a, b, ports
    a.stop()
    b.stop()


def _striped_payload(seed=0, chunks=3, extra=1024):
    """A payload big enough to stripe (> STRIPE_MIN_BYTES, chunk-misaligned)."""
    n = (chunks * wire.DELTA_CHUNK_BYTES + extra) // 8
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n)  # float64


# ---------------------------------------------------------------------------
# Stripe reassembly unit tests (no sockets)
# ---------------------------------------------------------------------------


def _mk_server():
    return TransportServer(
        "bob", "127.0.0.1:0", Mailbox(), max_message_size=1 << 30
    )


def _stripe_frames(data: bytes, sid=1, stream=None, base_fp=None,
                   indices=None, csz=None, up="u1"):
    """Per-chunk stripe frames for ``data`` as (header, payload) pairs."""
    csz = csz or wire.DELTA_CHUNK_BYTES
    total = len(data)
    nch = max(1, -(-total // csz))
    indices = list(range(nch)) if indices is None else indices
    frames = []
    for i in indices:
        chunk = data[i * csz : (i + 1) * csz]
        header = {
            "src": "alice",
            "up": up,
            "down": "0",
            "ccsz": csz,
            "ccrc": [zlib.crc32(chunk)],
            "dlt": wire.make_delta_manifest(
                total, wire.encode_chunk_bitmap([i], nch), base_fp
            ),
            "stp": wire.make_stripe_marker(sid, len(indices)),
        }
        if stream is not None:
            header["stm"] = stream
        frames.append((header, chunk))
    return frames


class _RecordingSink:
    """Chunk sink capturing every prefix feed (must only ever grow)."""

    def __init__(self):
        self.feeds = []

    def on_bytes(self, view, total):
        self.feeds.append((bytes(view[:total]), total))


def test_stripe_reassembly_shuffled_arrival():
    """Frames landing in adversarial cross-rail order reassemble to the
    exact payload, and a registered sink only ever sees the contiguous
    VERIFIED prefix (monotonically growing, bytes identical)."""
    server = _mk_server()
    data = np.random.default_rng(1).bytes(
        2 * wire.DELTA_CHUNK_BYTES + 12345
    )
    sink = _RecordingSink()
    server.register_chunk_sink(("u1", "0"), sink)
    frames = _stripe_frames(data, sid=1)
    order = [2, 0, 1]
    final = None
    for pos in order:
        header, chunk = frames[pos]
        out, _read_s = _apply_stripe_frame(server, header, chunk, 0.0)
        if out is not None:
            final = out
    assert final is not None and bytes(final) == data
    # Assembly retired on completion.
    assert not server._stripes
    # Prefix feeds: chunk 2 alone feeds nothing (prefix 0), chunk 0
    # feeds exactly chunk 0's bytes; every feed is a prefix of data.
    assert sink.feeds, "contiguous prefix was never fed"
    last = 0
    for fed, total in sink.feeds:
        assert total >= last
        assert fed == data[:total]
        last = total


def test_stripe_stale_sid_rejected_and_fresh_sid_replaces():
    server = _mk_server()
    data = np.random.default_rng(2).bytes(2 * wire.DELTA_CHUNK_BYTES)
    old = _stripe_frames(data, sid=5)
    # Partial old attempt.
    assert _apply_stripe_frame(server, *old[0], 0.0)[0] is None
    # A retry re-ships under a fresh sid: replaces the partial assembly.
    new = _stripe_frames(data, sid=6)
    assert _apply_stripe_frame(server, *new[1], 0.0)[0] is None
    # Stale frame of the failed attempt is rejected.
    with pytest.raises(ValueError, match="stale"):
        _apply_stripe_frame(server, *old[1], 0.0)
    out, _ = _apply_stripe_frame(server, *new[0], 0.0)
    assert out is not None and bytes(out) == data


def test_stripe_crc_mismatch_kills_assembly():
    """A corrupt chunk fails the frame AND drops the whole assembly —
    the sender re-ships the payload as a unit under a fresh sid."""
    server = _mk_server()
    data = np.random.default_rng(3).bytes(2 * wire.DELTA_CHUNK_BYTES)
    frames = _stripe_frames(data, sid=1)
    assert _apply_stripe_frame(server, *frames[0], 0.0)[0] is None
    header, chunk = frames[1]
    with pytest.raises(ValueError, match="CRC"):
        _apply_stripe_frame(server, header, b"\x00" * len(chunk), 0.0)
    assert not server._stripes
    # The full retry under a fresh sid succeeds from scratch.
    retry = _stripe_frames(data, sid=2)
    final = None
    for header, chunk in retry:
        out, _ = _apply_stripe_frame(server, header, chunk, 0.0)
        final = out or final
    assert final is not None and bytes(final) == data


def test_delta_stripe_frames_rebuild_on_cached_base():
    """Delta stripe frames (bfp-carrying) overlay changed chunks on the
    receiver's cached base; a desynced base raises the delta_base signal
    (→ sender re-seeds full)."""
    from rayfed_tpu_torch.transport.server import _DeltaBaseMissing

    server = _mk_server()
    base = bytearray(np.random.default_rng(4).bytes(
        3 * wire.DELTA_CHUNK_BYTES
    ))
    ccrc = wire.chunk_crcs(base)
    fp = wire.crc_fingerprint(ccrc)
    server._store_delta_base("alice", "s", base, ccrc, fp)

    new = bytearray(base)
    csz = wire.DELTA_CHUNK_BYTES
    new[csz + 5 : csz + 9] = b"XYZW"  # chunk 1
    new[2 * csz + 1] ^= 0xFF  # chunk 2
    frames = _stripe_frames(
        bytes(new), sid=1, stream="s", base_fp=fp, indices=[2, 1]
    )
    assert _apply_stripe_frame(server, *frames[0], 0.0)[0] is None
    out, _ = _apply_stripe_frame(server, *frames[1], 0.0)
    assert out is not None and bytes(out) == bytes(new)
    # The rebuilt payload became the new cached base.
    assert bytes(server._get_delta_base("alice", "s")["data"]) == bytes(new)

    # Desynced fingerprint → _DeltaBaseMissing, assembly not created.
    bad = _stripe_frames(
        bytes(new), sid=2, stream="s", base_fp=fp ^ 1, indices=[1]
    )
    with pytest.raises(_DeltaBaseMissing):
        _apply_stripe_frame(server, *bad[0], 0.0)


def test_evicted_assembly_rejects_continuation_frames():
    """An in-progress assembly evicted under LRU pressure must ERROR its
    remaining frames (sender retries under a fresh sid) — silently
    recreating it would restart the frame counter and the group could
    never complete (every rail ACKing SEG forever)."""
    from rayfed_tpu_torch.transport.server import _MAX_STRIPE_ASM

    server = _mk_server()
    data = np.random.default_rng(5).bytes(2 * wire.DELTA_CHUNK_BYTES)
    group_a = _stripe_frames(data, sid=1, up="evict-a")
    assert _apply_stripe_frame(server, *group_a[0], 0.0)[0] is None
    # Flood enough other assemblies to evict group A.
    for j in range(_MAX_STRIPE_ASM + 1):
        frames = _stripe_frames(data, sid=1, up=f"evict-fill{j}")
        _apply_stripe_frame(server, *frames[0], 0.0)
    with pytest.raises(ValueError, match="dropped under memory pressure"):
        _apply_stripe_frame(server, *group_a[1], 0.0)
    # A full retry under a fresh sid assembles from scratch.
    retry = _stripe_frames(data, sid=2, up="evict-a")
    final = None
    for header, chunk in retry:
        out, _ = _apply_stripe_frame(server, header, chunk, 0.0)
        final = out or final
    assert final is not None and bytes(final) == data


def test_all_seg_stripe_group_is_not_a_delivery():
    """A stripe group whose every frame ACKed "SEG" (receiver lost the
    assembly mid-group) must surface as a retryable failure, never as
    success — a sender that believed it hangs the consumer forever."""
    from rayfed_tpu_torch.config import RetryPolicy

    client = TransportClient(
        "alice", "bob", "127.0.0.1:1", RetryPolicy(), timeout_s=5,
        max_message_size=1 << 30, stripe_rails=2,
    )

    async def run():
        loop = asyncio.get_running_loop()

        async def fake_roundtrip(msg_type, header, bufs, **kw):
            return {"result": "SEG"}

        client._roundtrip = fake_roundtrip

        async def fake_rails(k):
            return [object()]

        client._acquire_rails = fake_rails
        ready = client._ready_chunks(
            loop, memoryview(b"x" * 8), [0, 0], [0, 1], 4, 8
        )
        with pytest.raises(Exception, match="without a delivery ACK"):
            await client._send_striped_frames({}, 8, 4, 2, ready)

    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(run())
    finally:
        loop.close()


# ---------------------------------------------------------------------------
# End-to-end over real sockets
# ---------------------------------------------------------------------------


def test_striped_send_roundtrip_and_stats(manager_pair):
    """A stripe-sized plain send fans chunks over the rails and decodes
    byte-identically; the send-path breakdown stats populate."""
    a, b, _ = manager_pair
    x = _striped_payload(seed=11)
    assert a.send("bob", x, "mr1", "0").resolve(timeout=60)
    got = b.recv("alice", "mr1", "0").resolve(timeout=60)
    np.testing.assert_array_equal(got, x)
    st = a.get_stats()
    assert st["send_striped_payloads"] >= 1
    assert st["send_stripe_frames"] >= 4  # 4 chunks
    bk = st["send_path_breakdown_ms"]
    assert set(bk) == {
        "encode_ms", "d2h_ms", "crc_ms", "loop_wait_ms", "socket_ms"
    }
    assert bk["socket_ms"] > 0
    bs = b.get_stats()
    assert bs["receive_striped_payloads"] >= 1


def test_rail_death_mid_payload_clean_retry(manager_pair, monkeypatch):
    """One rail failing mid-payload: surviving rails drain, the payload
    fails as a unit and the automatic retry re-ships it fully — the
    receiver decodes the exact bytes, nothing torn."""
    a, b, _ = manager_pair
    x = _striped_payload(seed=12)

    real = TransportClient._roundtrip
    state = {"killed": False}

    async def sabotage(self, msg_type, header, payload_bufs, **kw):
        # Kill exactly one mid-group stripe frame's connection, once.
        if (
            msg_type == wire.MSG_DATA
            and header.get("stp") is not None
            and header["stp"]["sid"] == 1
            and not state["killed"]
            and wire.decode_chunk_bitmap(
                header["dlt"]["map"],
                -(-header["dlt"]["total"] // header["ccsz"]),
            )[0] == 2
        ):
            state["killed"] = True
            conn = kw.get("conn") or await self._acquire_conn()
            self._teardown(conn, ConnectionResetError("rail died"))
            raise ConnectionResetError("rail died (injected)")
        return await real(self, msg_type, header, payload_bufs, **kw)

    monkeypatch.setattr(TransportClient, "_roundtrip", sabotage)
    assert a.send("bob", x, "rd1", "0").resolve(timeout=120)
    got = b.recv("alice", "rd1", "0").resolve(timeout=60)
    np.testing.assert_array_equal(got, x)
    assert state["killed"], "fault was never injected"
    # Retry shipped the payload again: more stripe frames than chunks.
    st = a.get_stats()
    assert st["send_stripe_frames"] > 4


def test_delta_stream_multirail_composition(manager_pair):
    """Round 1 ships full (pipelined stripes), round 2 ships only the
    changed chunks; every round decodes byte-identically and the delta
    cache still saves wire bytes with striping in play."""
    a, b, _ = manager_pair
    x1 = _striped_payload(seed=13)
    assert a.send("bob", x1, "dm1", "0", stream="dm").resolve(timeout=60)
    np.testing.assert_array_equal(
        b.recv("alice", "dm1", "0").resolve(timeout=60), x1
    )
    # Change exactly one interior chunk.
    x2 = x1.copy()
    lo = wire.DELTA_CHUNK_BYTES // 8 + 3
    x2[lo : lo + 50] *= -1.0
    assert a.send("bob", x2, "dm2", "0", stream="dm").resolve(timeout=60)
    np.testing.assert_array_equal(
        b.recv("alice", "dm2", "0").resolve(timeout=60), x2
    )
    st = a.get_stats()
    assert st["delta_full_frames"] >= 1
    assert st["delta_stream_frames"] >= 1
    assert st["delta_wire_bytes"] < st["delta_logical_bytes"]
    # Identical resend ships nothing.
    before = a.get_stats()["delta_wire_bytes"]
    assert a.send("bob", x2, "dm3", "0", stream="dm").resolve(timeout=60)
    np.testing.assert_array_equal(
        b.recv("alice", "dm3", "0").resolve(timeout=60), x2
    )
    assert a.get_stats()["delta_wire_bytes"] == before


def test_send_arena_reused_across_rounds(manager_pair):
    """The per-(dest, stream) arenas are allocated once and ping-pong
    across rounds — no per-round payload-sized allocation."""
    a, b, _ = manager_pair
    x = _striped_payload(seed=14, chunks=2)
    for r in range(4):
        y = x + r
        assert a.send("bob", y, f"ar{r}", "0", stream="ar").resolve(
            timeout=60
        )
        np.testing.assert_array_equal(
            b.recv("alice", f"ar{r}", "0").resolve(timeout=60), y
        )
    client = a._clients["bob"]
    state = client._delta_streams["ar"]
    arenas = [id(ar.mm) for ar in state.arenas if ar is not None]
    assert len(arenas) == 2  # both slots allocated, then reused
    # Another round must not allocate a third arena.
    assert a.send("bob", x + 9, "ar9", "0", stream="ar").resolve(timeout=60)
    b.recv("alice", "ar9", "0").resolve(timeout=60)
    assert [
        id(ar.mm) for ar in state.arenas if ar is not None
    ] == arenas


def _raw(buf):
    if isinstance(buf, np.ndarray):
        return buf.tobytes()
    return buf.reshape(-1).view(torch.uint8).numpy().tobytes()


def test_streaming_aggregation_bitexact_with_striping(manager_pair):
    """Streamed aggregation over striped delta streams reduces to the
    exact bytes of the one-shot fused path — arenas + multi-rail change
    the byte-moving machinery, never the bytes."""
    a, b, _ = manager_pair
    rng = np.random.default_rng(15)
    n = (2 * wire.DELTA_CHUNK_BYTES + 4096) // 2  # bf16-sized elements
    trees = [
        {"w": np.asarray(rng.standard_normal(n), dtype=np.float32)}
        for _ in range(2)
    ]
    packed = [fl_comp.pack_tree(t) for t in trees]
    reference = fedavg.packed_weighted_sum(packed)

    agg = StreamingAggregator(2, device="cpu")
    b.recv_stream("alice", "sa-up", "sa-dn", agg.sink(0))
    agg.add_local(1, packed[1])
    assert a.send(
        "bob", packed[0], "sa-up", "sa-dn", stream="sa"
    ).resolve(timeout=120)
    out = agg.result(timeout=120)
    assert _raw(out.buf) == _raw(reference.buf)
    # The contribution actually rode the striped path.
    assert a.get_stats()["send_striped_payloads"] >= 1


def test_send_many_striped_fanout(manager_pair):
    """Broadcast fan-out composes with striping: every destination gets
    the identical bytes."""
    a, b, _ = manager_pair
    x = _striped_payload(seed=16, chunks=2)
    refs = a.send_many(["bob"], x, "fo1", "0", stream="fo")
    assert refs["bob"].resolve(timeout=60)
    np.testing.assert_array_equal(
        b.recv("alice", "fo1", "0").resolve(timeout=60), x
    )


def test_oversized_striped_send_fails_fast_no_retry_storm():
    """A striped payload whose TOTAL exceeds the receiver's cap (each
    frame individually under it) is rejected fatally on the first frame
    — the sender must not re-ship gigabytes through the whole retry
    ladder (parity with the single-frame oversize path).  A cap below
    the chunk size trips the frame-level prefix check instead, which
    closes the connection (same end state, one round trip earlier)."""
    import time as _time

    pa, pb = get_free_ports(2)
    ports = {"alice": pa, "bob": pb}
    opts = {"stripe_rails": 2}
    a = _mk_manager("alice", ports, options=opts)  # default (big) cap
    # Receiver cap between one chunk (4 MB) and the payload total.
    b = _mk_manager("bob", ports, options=opts, max_size=6_000_000)
    a.start()
    b.start()
    try:
        x = _striped_payload(seed=17, chunks=2)  # ~8.4 MB total
        t0 = _time.monotonic()
        ok = a.send("bob", x, "ov1", "0").resolve(timeout=60)
        elapsed = _time.monotonic() - t0
        assert ok is False
        # Fatal abort, not the ~minute-long default retry ladder.
        assert elapsed < 20, f"oversize send retried for {elapsed:.0f}s"
    finally:
        a.stop()
        b.stop()


# ---------------------------------------------------------------------------
# Version negotiation (wire v4 HELLO)
# ---------------------------------------------------------------------------


def test_protocol_version_mismatch_names_both_versions(manager_pair):
    a, b, ports = manager_pair
    client = TransportClient(
        "alice", "bob", f"127.0.0.1:{ports['bob']}",
        a._job.retry_policy, timeout_s=10,
        max_message_size=1 << 30,
    )
    client._proto_version = 99  # future build

    async def attempt():
        try:
            await client.send_data([b"x"], "vm1", "0")
        finally:
            await client.close()

    loop = asyncio.new_event_loop()
    try:
        with pytest.raises(ProtocolMismatchError) as ei:
            loop.run_until_complete(attempt())
    finally:
        loop.close()
    msg = str(ei.value)
    assert "v99" in msg and f"v{wire.WIRE_FORMAT_VERSION}" in msg
    assert "alice" in msg and "bob" in msg


def test_matching_version_handshake_is_transparent(manager_pair):
    """Same-version pairs handshake invisibly (every other e2e test in
    this file rides it); this pins that a plain send still works and the
    server saw no protocol rejects."""
    a, b, _ = manager_pair
    assert a.send("bob", np.arange(8), "hs1", "0").resolve(timeout=30)
    np.testing.assert_array_equal(
        b.recv("alice", "hs1", "0").resolve(timeout=30), np.arange(8)
    )


# ---------------------------------------------------------------------------
# Runtime-mutable message cap + transport-option hygiene
# ---------------------------------------------------------------------------


def test_set_max_message_size_live_mutation(manager_pair):
    a, b, _ = manager_pair
    big = np.arange(1_000_000, dtype=np.float64)  # 8 MB
    # Shrink below the payload: send must reject client-side.
    a.set_max_message_size(1_000_000)
    ref = a.send("bob", big, "cap1", "0")
    assert ref.resolve(timeout=30) is False  # send failed (oversize)
    # Raise it back: the same payload now flows.
    a.set_max_message_size(1 << 30)
    assert a.send("bob", big, "cap2", "0").resolve(timeout=60)
    np.testing.assert_array_equal(
        b.recv("alice", "cap2", "0").resolve(timeout=60), big
    )
    with pytest.raises(ValueError, match="positive"):
        a.set_max_message_size(0)


def test_set_max_message_size_rejects_mid_flight(manager_pair, monkeypatch):
    """A cap change while a send is on the wire must reject cleanly,
    not torn-apply."""
    a, b, _ = manager_pair
    # Materialize the client, then fake an in-flight send.
    assert a.send("bob", np.arange(4), "mf0", "0").resolve(timeout=30)
    b.recv("alice", "mf0", "0").resolve(timeout=30)
    monkeypatch.setattr(
        TransportClient, "has_inflight_sends", lambda self: True
    )
    with pytest.raises(RuntimeError, match="in flight.*bob"):
        a.set_max_message_size(123456)


def test_ignored_transport_options_warned_and_reported(caplog):
    """Unknown per-party transport options are never silently dropped:
    one loud warning lists them, and the effective-options accessor
    reports both the merge that applies and the ignored keys."""
    pa, pb = get_free_ports(2)
    ports = {"alice": pa, "bob": pb}
    a = _mk_manager(
        "alice", ports,
        options={
            "grpc.max_send_message_length": 7_000_000,
            "grpc.default_authority": "x.example",  # inapplicable
            "tiemout_s": 3,  # operator typo — must be surfaced
        },
    )
    with caplog.at_level(logging.WARNING, logger="rayfed_tpu_torch.transport.manager"):
        eff = a.effective_transport_options("bob")
        eff2 = a.effective_transport_options("bob")
    assert eff["party"] == "bob"
    assert eff["options"]["max_message_size"] == 7_000_000  # compat alias
    assert sorted(eff["ignored_keys"]) == [
        "grpc.default_authority", "tiemout_s"
    ]
    assert eff2["ignored_keys"] == eff["ignored_keys"]
    warnings = [
        r for r in caplog.records if "IGNORED" in r.getMessage()
    ]
    assert len(warnings) == 1  # one-time, not per merge
    assert "tiemout_s" in warnings[0].getMessage()


def test_effective_options_reflect_live_client(manager_pair):
    """Post-init mutations show through the accessor once a live client
    exists."""
    a, b, _ = manager_pair
    assert a.send("bob", np.arange(4), "eo1", "0").resolve(timeout=30)
    b.recv("alice", "eo1", "0").resolve(timeout=30)
    a.set_max_message_size(5_555_555)
    eff = a.effective_transport_options("bob")
    assert eff["options"]["max_message_size"] == 5_555_555
    assert eff["options"]["connections_per_peer"] >= 1


def test_fed_api_set_max_message_length_requires_init():
    import rayfed_tpu_torch as fed

    with pytest.raises(RuntimeError):
        fed.set_max_message_length(1 << 20)
