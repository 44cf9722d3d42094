"""The port's content-addressed object plane (transport/objectstore.py)
held against the reference's tests/test_objectstore.py.

Covers: fingerprint determinism across controllers (the handle contract),
the bounded LRU's byte-budget eviction + pin/unpin, concurrent-fetch
single-transfer dedup, corrupt-blob verify-on-arrival with loud re-fetch
from a different holder, dead-holder fast-fail, the ``fed.get``
handle-offer broadcast of a packed tree (warm receivers transfer ~zero
payload bytes) and welcome-by-handle byte-identity vs the eager push.
The reference's server-opt welcome cases (ROADMAP.md Queue A items 7-8)
and checkpoint cases (item 9) come with those items.

All tests are in-process (real loopback sockets, toy payloads) — no party
subprocesses.
"""

import logging
import os
import threading
import time

import numpy as np
import pytest
import torch

from rayfed_tpu_torch import objects
from rayfed_tpu_torch.config import ClusterConfig, JobConfig, PartyConfig
from rayfed_tpu_torch.fl import compression as fl_comp
from rayfed_tpu_torch.objects import ObjectPlaneError
from rayfed_tpu_torch.transport import wire
from rayfed_tpu_torch.transport.manager import TransportManager
from rayfed_tpu_torch.transport.objectstore import BlobStore, ObjectPlane
from tests.multiproc import get_free_ports


def _mk_manager(party, cluster_ports, **job_kw):
    cc = ClusterConfig(
        parties={
            p: PartyConfig.from_dict({"address": f"127.0.0.1:{port}"})
            for p, port in cluster_ports.items()
        },
        current_party=party,
    )
    job = dict(
        device_put_received=False,
        cross_silo_timeout_s=20,
    )
    job.update(job_kw)
    return TransportManager(cc, JobConfig(**job))


@pytest.fixture()
def manager_trio():
    ports = dict(zip(("alice", "bob", "carol"), get_free_ports(3)))
    mgrs = {p: _mk_manager(p, ports) for p in ports}
    for m in mgrs.values():
        m.start()
    yield mgrs
    for m in mgrs.values():
        m.stop()


def _tree(seed=0, n=1 << 13):
    rng = np.random.default_rng(seed)
    return fl_comp.pack_tree(
        {"w": torch.from_numpy(rng.standard_normal(n).astype(np.float32))}
    )


def _raw(buf):
    if isinstance(buf, torch.Tensor):
        return buf.reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(buf).tobytes()


# ---------------------------------------------------------------------------
# Fingerprints + handle schema
# ---------------------------------------------------------------------------


def test_fingerprint_determinism_across_controllers(manager_trio):
    """Two controllers publishing value-identical trees derive the SAME
    fingerprint (handle equality must mean content equality), and
    different content gets a different one."""
    tree = _tree(1)
    fp_a, n_a = manager_trio["alice"].objects.publish(tree)
    fp_b, n_b = manager_trio["bob"].objects.publish(tree)
    assert (fp_a, n_a) == (fp_b, n_b)
    fp_c, _ = manager_trio["carol"].objects.publish(_tree(2))
    assert fp_c != fp_a


def test_blob_fingerprint_shares_delta_cache_machinery():
    """The handle fingerprint's first field IS the delta-cache base
    fingerprint word (crc_fingerprint over the same chunk CRCs) — one
    producer, directly cross-checkable against delta-cache state."""
    data = os.urandom(3 * 4096)
    fp = wire.blob_fingerprint(data)
    base = wire.crc_fingerprint(wire.chunk_crcs(memoryview(data)))
    parts = fp.split(".")
    assert parts[0] == "b1"
    assert parts[1] == f"{base:08x}"
    assert int(parts[2], 16) == len(data)


def test_handle_schema_roundtrip_and_validation():
    h = objects.make_blob_handle("b1.xx", 10, ["alice"])
    assert objects.is_blob_handle(h)
    assert objects.check_blob_handle(h)["fp"] == "b1.xx"
    assert not objects.is_blob_handle({"fp": "b1.xx"})
    with pytest.raises(ValueError, match="at least one holder"):
        objects.make_blob_handle("b1.xx", 10, [])
    with pytest.raises(ObjectPlaneError, match="no holders"):
        objects.check_blob_handle(
            {objects.BLOB_HANDLE_MARK: 1, "fp": "x", "n": 1, "holders": []}
        )
    with pytest.raises(ObjectPlaneError, match="understands up to"):
        objects.check_blob_handle(
            {objects.BLOB_HANDLE_MARK: 99, "fp": "x", "n": 1,
             "holders": ["a"]}
        )
    with pytest.raises(ObjectPlaneError, match="not a blob handle"):
        objects.check_blob_handle([1, 2])


def test_resolve_without_plane_is_loud():
    class _NoPlane:
        objects = None

    h = objects.make_blob_handle("b1.xx", 10, ["alice"])
    with pytest.raises(ObjectPlaneError, match="no object plane"):
        objects.maybe_resolve_handle(_NoPlane(), h)
    # Non-handles pass through untouched.
    assert objects.maybe_resolve_handle(_NoPlane(), {"a": 1}) == {"a": 1}


# ---------------------------------------------------------------------------
# BlobStore: LRU eviction + pinning
# ---------------------------------------------------------------------------


def test_lru_eviction_and_pinning():
    store = BlobStore(budget_bytes=1000)
    store.put("a", b"x" * 400)
    store.put("b", b"y" * 400)
    store.put("p", b"z" * 300, pin=True)  # over budget: evicts LRU "a"
    assert store.get("a") is None
    assert store.get("b") is not None and store.get("p") is not None
    assert store.stats["blob_store_evictions"] == 1
    # Another put: the next LRU unpinned entry ("b") goes; the pinned
    # entry and the just-added entry both stay.
    store.put("c", b"w" * 400)
    assert store.get("b") is None
    assert store.get("p") is not None and store.get("c") is not None
    # A put larger than the remaining room keeps the pinned entry AND
    # the new entry (the working set may exceed the budget; unpinned
    # LRU entries are what pay).
    store.put("d", b"v" * 900)
    assert store.get("c") is None
    assert store.get("p") is not None and store.get("d") is not None
    assert store.total_bytes() == 1200
    # Unpinning under pressure evicts the ex-pinned entry promptly.
    store.unpin("p")
    assert store.get("p") is None
    assert store.total_bytes() == 900
    assert store.pinned_bytes() == 0
    # Re-putting identical content refreshes, never duplicates.
    store.put("d", b"v" * 900)
    assert store.total_bytes() == 900
    with pytest.raises(KeyError):
        store.pin("missing")


# ---------------------------------------------------------------------------
# Pull protocol: dedup, failover, corruption
# ---------------------------------------------------------------------------


def test_pull_roundtrip_and_content_cache(manager_trio):
    mgrs = manager_trio
    tree = _tree(3)
    fp, n = mgrs["alice"].objects.publish(tree)
    handle = mgrs["alice"].objects.handle_for(fp, n)
    got = mgrs["bob"].objects.fetch(handle, timeout_s=30)
    assert _raw(got.buf) == _raw(tree.buf)
    # Raw stored bytes are byte-identical on both ends (content cache).
    assert (
        mgrs["bob"].objects.fetch_local_bytes(fp)
        == mgrs["alice"].objects.fetch_local_bytes(fp)
    )
    # Second fetch: pure cache hit, no second transfer.
    mgrs["bob"].objects.fetch(handle, timeout_s=30)
    assert mgrs["alice"].objects.stats["blob_serves"] == 1
    assert mgrs["bob"].objects.stats["blob_cache_hits"] == 1


def test_concurrent_fetch_single_transfer(manager_trio):
    """N concurrent local waiters on one fingerprint trigger ONE wire
    transfer (in-flight dedup), and all decode the same bytes."""
    mgrs = manager_trio
    tree = _tree(4, n=1 << 15)
    fp, n = mgrs["alice"].objects.publish(tree)
    handle = mgrs["alice"].objects.handle_for(fp, n)
    results, errors = [], []

    # A gate on alice's serve of this fingerprint: the transfer proceeds
    # only once the five other fetches ride it, so a thread that starts
    # late (a loaded host) cannot find the bytes already cached.
    plane, serve = mgrs["alice"].objects, mgrs["alice"].objects._serve

    def _gated_serve(requester, req):
        if req.get("fp") == fp:
            deadline = time.monotonic() + 30
            while (mgrs["bob"].objects.stats["blob_dedup_waits"] < 5
                   and time.monotonic() < deadline):
                time.sleep(0.005)
        serve(requester, req)

    plane._serve = _gated_serve

    def _fetch():
        try:
            results.append(mgrs["bob"].objects.fetch(handle, timeout_s=30))
        except Exception as exc:  # pragma: no cover - fail loudly below
            errors.append(exc)

    threads = [threading.Thread(target=_fetch) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(results) == 6
    for got in results:
        assert _raw(got.buf) == _raw(tree.buf)
    assert mgrs["alice"].objects.stats["blob_serves"] == 1
    assert mgrs["bob"].objects.stats["blob_fetches"] == 1
    assert mgrs["bob"].objects.stats["blob_dedup_waits"] == 5


def test_miss_reply_fails_over_to_next_holder(manager_trio):
    """A holder that does not hold the bytes replies an immediate miss
    notice; the pull fails over to the next named holder instead of
    waiting out the recv backstop."""
    mgrs = manager_trio
    tree = _tree(5)
    fp, n = mgrs["alice"].objects.publish(tree)
    handle = objects.make_blob_handle(fp, n, ["bob", "alice"])
    got = mgrs["carol"].objects.fetch(handle, timeout_s=30)
    assert _raw(got.buf) == _raw(tree.buf)
    assert mgrs["bob"].objects.stats["blob_serve_misses"] == 1
    assert mgrs["alice"].objects.stats["blob_serves"] == 1


def test_corrupt_blob_refetches_from_different_holder(
    manager_trio, caplog
):
    """Verify-on-arrival: a holder serving corrupted bytes is detected
    (recomputed fingerprint mismatch), reported LOUDLY, and the pull
    re-fetches from a different holder."""
    mgrs = manager_trio
    tree = _tree(6)
    fp, n = mgrs["alice"].objects.publish(tree)
    good = mgrs["alice"].objects.fetch_local_bytes(fp)
    # bob holds CORRUPT bytes under the same fingerprint (simulates
    # silent store rot — exactly what verify-on-arrival exists for).
    bad = bytearray(good)
    bad[len(bad) // 2] ^= 0xFF
    mgrs["bob"].objects.store._entries.clear()
    mgrs["bob"].objects.store._bytes = 0
    from rayfed_tpu_torch.transport.objectstore import _Entry

    mgrs["bob"].objects.store._entries[fp] = _Entry(bytes(bad), False)
    handle = objects.make_blob_handle(fp, n, ["bob", "alice"])
    with caplog.at_level(logging.WARNING):
        got = mgrs["carol"].objects.fetch(handle, timeout_s=30)
    assert _raw(got.buf) == _raw(tree.buf)
    assert mgrs["carol"].objects.stats["blob_corrupt_refetches"] == 1
    assert any(
        "FAILED content verification" in r.message for r in caplog.records
    )
    # The verified bytes (not the corrupt ones) were cached.
    assert mgrs["carol"].objects.fetch_local_bytes(fp) == good


def test_dead_holder_fast_failover(manager_trio):
    """The Mailbox.get dead-party fast-fail covers blob pulls — a pull
    aimed at a monitor-declared-dead holder fails over to the next named
    holder immediately (as chunk-sink registrations do), not at the recv
    backstop."""
    import time

    mgrs = manager_trio
    tree = _tree(7)
    fp, n = mgrs["alice"].objects.publish(tree)
    # Declare bob dead on carol (what the health monitor does).
    from rayfed_tpu_torch.exceptions import RemoteError

    err = RemoteError("bob", "ConnectionError", "declared dead").to_wire()
    loop = mgrs["carol"]._loop
    done = threading.Event()
    loop.call_soon_threadsafe(
        lambda: (mgrs["carol"]._mailbox.fail_party("bob", err),
                 done.set())
    )
    assert done.wait(5)
    handle = objects.make_blob_handle(fp, n, ["bob", "alice"])
    t0 = time.monotonic()
    got = mgrs["carol"].objects.fetch(handle, timeout_s=120)
    elapsed = time.monotonic() - t0
    assert _raw(got.buf) == _raw(tree.buf)
    # The dead-holder leg must fail fast (well under the 120s window).
    assert elapsed < 30, elapsed
    assert mgrs["carol"].objects.stats["blob_dead_holder_failovers"] == 1


def test_no_live_holder_raises_loudly(manager_trio):
    mgrs = manager_trio
    handle = objects.make_blob_handle("b1.0.0.deadbeef", 4, ["bob"])
    with pytest.raises(ObjectPlaneError, match="every named holder"):
        mgrs["carol"].objects.fetch(handle, timeout_s=30)


# ---------------------------------------------------------------------------
# fed.get handle-offer broadcast
# ---------------------------------------------------------------------------


def test_broadcast_offer_warm_receiver_skips_payload():
    """The fed.get broadcast path (send_many(blob_offer=True)): a large
    immutable PackedTree ships as a fingerprint handle; a WARM receiver
    (content-cache hit) transfers ~zero payload bytes; byte-identity
    with the eager push holds throughout."""
    ports = dict(zip(("alice", "bob"), get_free_ports(2)))
    mgrs = {
        p: _mk_manager(p, ports, blob_broadcast_min_bytes=1024)
        for p in ports
    }
    for m in mgrs.values():
        m.start()
    try:
        tree = _tree(8, n=1 << 14)
        # Cold: handle + pull.  The decoded value equals the eager path.
        ref = mgrs["alice"].send_many(
            ["bob"], tree, "u1", "d1", blob_offer=True
        )["bob"]
        got = mgrs["bob"].recv("alice", "u1", "d1").resolve(timeout=30)
        assert ref.resolve(timeout=30)
        assert objects.is_blob_handle(got)
        val = objects.maybe_resolve_handle(mgrs["bob"], got)
        assert _raw(val.buf) == _raw(tree.buf)
        assert mgrs["alice"].objects.stats["blob_offers"] == 1
        # Warm: same content again — the receiver resolves from cache,
        # zero pull, and the wire moved only the tiny handle frame.
        sent0 = mgrs["alice"].get_stats()["send_bytes"]
        ref2 = mgrs["alice"].send_many(
            ["bob"], tree, "u2", "d2", blob_offer=True
        )["bob"]
        got2 = mgrs["bob"].recv("alice", "u2", "d2").resolve(timeout=30)
        assert ref2.resolve(timeout=30)
        val2 = objects.maybe_resolve_handle(mgrs["bob"], got2)
        assert _raw(val2.buf) == _raw(tree.buf)
        warm_bytes = mgrs["alice"].get_stats()["send_bytes"] - sent0
        assert warm_bytes < 0.1 * int(tree.buf.nbytes), warm_bytes
        assert mgrs["alice"].objects.stats["blob_serves"] == 1
        # Below the floor / non-PackedTree: no offer, eager push.
        assert mgrs["alice"].objects.maybe_offer({"x": 1}, 1024) is None
        assert (
            mgrs["alice"].objects.maybe_offer(_tree(9, n=8), 1024) is None
        )
        # Offers disabled: no handle regardless of size.
        assert mgrs["alice"].objects.maybe_offer(tree, None) is None
    finally:
        for m in mgrs.values():
            m.stop()


# ---------------------------------------------------------------------------
# Welcome-by-handle + server-opt state (join_ticket x server_opt row)
# ---------------------------------------------------------------------------


def test_welcome_by_handle_rejoin_byte_identity(manager_trio):
    """A welcome that names the model by fingerprint resolves to BYTE-
    identical state vs the eager-push welcome (receiver-decoded wire
    bytes on both paths)."""
    mgrs = manager_trio
    model = _tree(10, n=1 << 14)
    # Eager path: coordinator pushes the params inline.
    mgrs["alice"].send("bob", {"params": model}, "w.eager", "roster")
    eager = mgrs["bob"].recv("alice", "w.eager", "roster").resolve(
        timeout=30
    )["params"]
    # Handle path: coordinator publishes + sends the handle; the joiner
    # pulls (cold) and decodes.  Residency-canonicalized, exactly like
    # the quorum loop's publish sites.
    fp, n = mgrs["alice"].objects.publish(objects.canonical_host(model))
    welcome = {
        "round": 3, "epoch": 2, "members": ["alice", "bob"],
        "coordinator": "alice",
        "model": mgrs["alice"].objects.handle_for(fp, n, ["bob"]),
    }
    mgrs["alice"].send("carol", welcome, "w.handle", "roster")
    got = mgrs["carol"].recv("alice", "w.handle", "roster").resolve(
        timeout=30
    )
    resolved = objects.maybe_resolve_handle(mgrs["carol"], got["model"])
    assert _raw(resolved.buf) == _raw(eager.buf)
    assert resolved.spec.entries == eager.spec.entries
    # Warm rejoin: a party already holding the content (bob got the
    # eager push's VALUE — its canonical publish derives the SAME
    # fingerprint the coordinator's handle names, despite the two
    # controllers holding different residencies) resolves with zero
    # transfer.
    mgrs["bob"].objects.publish(objects.canonical_host(eager))
    serves0 = mgrs["alice"].objects.stats["blob_serves"]
    resolved_warm = mgrs["bob"].objects.fetch(got["model"], timeout_s=30)
    assert _raw(resolved_warm.buf) == _raw(eager.buf)
    assert mgrs["alice"].objects.stats["blob_serves"] == serves0


def test_stats_snapshot_surfaces_plane_counters(manager_trio):
    stats = manager_trio["alice"].get_stats()["object_plane"]
    for key in ("blob_cache_hits", "blob_serves", "blob_cache_bytes",
                "blob_store_evictions", "blob_pinned_bytes"):
        assert key in stats
