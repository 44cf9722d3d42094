"""The port's chaos harness (chaos.py) and its transport hook points, held
against the reference's tests/test_chaos.py: schedule semantics, plus the
robustness satellites that ride the same machinery — known-dead send
fast-fail, per-party health knobs, roster-epoch frame rejection, and the
membership-request inbox.  All in-process (real loopback sockets, toy
payloads).
"""

import asyncio
import time

import numpy as np
import pytest

from rayfed_tpu_torch import chaos
from rayfed_tpu_torch.config import ClusterConfig, JobConfig, PartyConfig, RetryPolicy
from rayfed_tpu_torch.transport.manager import TransportManager
from tests.multiproc import get_free_ports


@pytest.fixture(autouse=True)
def _no_leaked_schedule():
    yield
    chaos.uninstall()


# ---------------------------------------------------------------------------
# Schedule semantics (no sockets)
# ---------------------------------------------------------------------------


def test_schedule_validation():
    with pytest.raises(ValueError, match="unknown chaos hook"):
        chaos.ChaosSchedule({"rules": [{"hook": "nope", "op": "drop_frame"}]})
    with pytest.raises(ValueError, match="unknown chaos op"):
        chaos.ChaosSchedule({"rules": [{"hook": "send", "op": "nope"}]})
    # A partition must name exactly two distinct parties.
    for bad in (None, ["alice"], ["alice", "alice"], "alice"):
        with pytest.raises(ValueError, match="partition op needs"):
            chaos.ChaosSchedule({"rules": [
                {"hook": "wire", "op": "partition", "value": bad},
            ]})


def test_partition_rule_semantics():
    """A partition is a STANDING bidirectional cut: it matches both
    directions of the named pair (client dest / server src), persists
    (default count unbounded), and never touches other links."""
    chaos.install({"rules": [
        {"hook": "wire", "op": "partition", "value": ["alice", "bob"]},
    ]})
    for _ in range(3):  # persists, both directions
        with pytest.raises(chaos.ChaosFault, match="partitioned"):
            chaos.fire("wire", party="alice", dest="bob", type=3)
        with pytest.raises(chaos.ChaosFault, match="partitioned"):
            chaos.fire("wire", party="bob", src="alice", type=1)
    # Unrelated links are untouched — including each endpoint's links
    # to third parties (an asymmetric-connectivity cut, not a death).
    chaos.fire("wire", party="alice", dest="carol", type=3)
    chaos.fire("wire", party="carol", src="bob", type=3)
    chaos.fire("wire", party="carol", dest="dave", type=3)


def test_announce_hook_targets_the_decided_round():
    """The announce hook fires per (party, round) context — the harness
    can kill the coordinator between a specific round's cutoff and its
    broadcast."""
    chaos.install({"rules": [
        {"hook": "announce", "party": "alice", "match": {"round": 2},
         "op": "crash_party"},
    ]})
    chaos.fire("announce", party="alice", round=1, epoch=0)
    chaos.fire("announce", party="bob", round=2, epoch=0)
    with pytest.raises(chaos.ChaosPartyCrash):
        chaos.fire("announce", party="alice", round=2, epoch=0)


def test_rule_matching_party_after_count():
    sched = chaos.install({
        "rules": [
            {"hook": "send", "party": "alice", "match": {"dest": "bob"},
             "after": 1, "count": 2, "op": "drop_frame"},
        ],
    })
    assert chaos.installed() is sched
    # Wrong party / wrong dest: never fires.
    chaos.fire("send", party="bob", dest="bob")
    chaos.fire("send", party="alice", dest="carol")
    # First matching event is skipped (after=1)...
    chaos.fire("send", party="alice", dest="bob")
    # ...then it fires exactly twice.
    for _ in range(2):
        with pytest.raises(chaos.ChaosFault):
            chaos.fire("send", party="alice", dest="bob")
    chaos.fire("send", party="alice", dest="bob")  # count exhausted


def test_stream_glob_and_corrupt_crc_header():
    chaos.install({
        "rules": [
            {"hook": "frame", "match": {"stream": "fedavg/up/*"},
             "op": "drop_frame"},
            {"hook": "frame", "op": "corrupt_crc", "count": None},
        ],
    })
    with pytest.raises(chaos.ChaosFault):
        chaos.fire("frame", stream="fedavg/up/bob")
    header = {"ccrc": [5, 6]}
    chaos.fire("frame", header=header)
    assert header["ccrc"] == [4, 6]
    header = {"crc": 10}
    chaos.fire("frame", header=header)
    assert header["crc"] == 11
    header = {}
    chaos.fire("frame", header=header)
    assert header["crc"] == 1


def test_seeded_delay_is_deterministic():
    spec = {"seed": 42, "rules": [
        {"hook": "round", "op": "delay_ms", "value": [10, 50],
         "count": None},
    ]}
    a = chaos.ChaosSchedule(spec)
    b = chaos.ChaosSchedule(spec)
    da = [a.rules[0].delay_s() for _ in range(5)]
    db = [b.rules[0].delay_s() for _ in range(5)]
    assert da == db
    assert all(0.010 <= d <= 0.050 for d in da)


def test_local_slowdown_validation():
    for bad in (None, 0.5, [0.5, 2.0], [4.0, 2.0], [2.0]):
        with pytest.raises(ValueError, match="local_slowdown op needs"):
            chaos.ChaosSchedule({"rules": [
                {"hook": "local_step", "op": "local_slowdown",
                 "value": bad},
            ]})


def test_local_slowdown_stretches_measured_baseline():
    """The multiplier op sleeps ``baseline_s * (m - 1)`` — it scales
    with the REAL compute the hook site measured, unlike delay_ms's
    absolute stall — and is a standing condition (a slow device stays
    slow: count defaults to unbounded)."""
    chaos.install({"seed": 9, "rules": [
        {"hook": "local_step", "party": "b", "op": "local_slowdown",
         "value": 3.0},
    ]})
    for _ in range(3):  # persists across fires
        t0 = time.perf_counter()
        chaos.fire("local_step", party="b", version=0, cycle=0,
                   baseline_s=0.02)
        assert time.perf_counter() - t0 >= 0.02 * (3.0 - 1.0) * 0.9
    # Other parties' steps are untouched.
    t0 = time.perf_counter()
    chaos.fire("local_step", party="a", version=0, cycle=0,
               baseline_s=0.02)
    assert time.perf_counter() - t0 < 0.02
    # No reported baseline -> no stall (absolute stalls are delay_ms).
    t0 = time.perf_counter()
    chaos.fire("local_step", party="b", version=1, cycle=1)
    assert time.perf_counter() - t0 < 0.02


def test_local_slowdown_range_draw_is_seeded():
    """A [lo, hi] multiplier draws from the rule's seeded rng — the
    2-10x straggler spread replays identically run to run."""
    spec = {"seed": 7, "rules": [
        {"hook": "local_step", "op": "local_slowdown",
         "value": [2.0, 10.0]},
    ]}
    a = chaos.ChaosSchedule(spec)
    b = chaos.ChaosSchedule(spec)
    da = [a.rules[0].slowdown() for _ in range(6)]
    db = [b.rules[0].slowdown() for _ in range(6)]
    assert da == db
    assert all(2.0 <= m <= 10.0 for m in da)
    assert len(set(da)) > 1  # a spread, not a constant


def test_env_install(monkeypatch):
    monkeypatch.setenv(
        chaos.ENV_VAR,
        '{"seed": 3, "rules": [{"hook": "round", "op": "crash_party"}]}',
    )
    sched = chaos.maybe_install_from_env()
    assert sched is not None and sched.seed == 3
    # Idempotent: a second call returns the installed schedule.
    assert chaos.maybe_install_from_env() is sched
    with pytest.raises(chaos.ChaosPartyCrash):
        chaos.fire("round", party="x", round=0)


# ---------------------------------------------------------------------------
# Transport hook points (in-process manager pair)
# ---------------------------------------------------------------------------


TIGHT_RETRY = RetryPolicy(
    max_attempts=3, initial_backoff_s=0.2, max_backoff_s=0.4, jitter=False
)


def _mk_manager(party, cluster_ports, options=None, **job_kw):
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
        cross_silo_timeout_s=3,
        retry_policy=TIGHT_RETRY,
    )
    job.update(job_kw)
    return TransportManager(cc, JobConfig(**job))


@pytest.fixture()
def manager_pair():
    pa, pb = get_free_ports(2)
    ports = {"alice": pa, "bob": pb}
    a = _mk_manager("alice", ports)
    b = _mk_manager("bob", ports)
    a.start()
    b.start()
    yield a, b
    a.stop()
    b.stop()


def test_chaos_frame_drop_is_retried(manager_pair):
    a, b = manager_pair
    chaos.install({
        "rules": [
            {"hook": "frame", "party": "alice", "match": {"dest": "bob"},
             "count": 1, "op": "drop_frame"},
        ],
    })
    payload = np.arange(64, dtype=np.float32)
    assert a.send("bob", payload, "d1", "0").resolve(timeout=30)
    got = b.recv("alice", "d1", "0").resolve(timeout=30)
    np.testing.assert_array_equal(np.asarray(got), payload)


def test_chaos_corrupt_crc_exercises_verify_and_retry(manager_pair):
    a, b = manager_pair
    chaos.install({
        "rules": [
            {"hook": "frame", "party": "alice", "count": 1,
             "op": "corrupt_crc"},
        ],
    })
    payload = np.arange(256, dtype=np.float64)
    # Stream send: per-chunk CRCs are always verified receiver-side
    # (zlib), native codec or not.
    assert a.send("bob", payload, "c1", "0", stream="s").resolve(timeout=30)
    got = b.recv("alice", "c1", "0").resolve(timeout=30)
    np.testing.assert_array_equal(np.asarray(got), payload)
    assert b.get_stats().get("receive_crc_errors", 0) == 1


def test_chaos_server_drop_fails_send_loudly(manager_pair):
    a, b = manager_pair
    chaos.install({
        "rules": [
            {"hook": "server_frame", "party": "bob", "count": 1,
             "op": "drop_frame"},
        ],
    })
    # The receiver discards the frame without an ACK: the sender's
    # deadline fires (deadlines are not retried, by policy parity) and
    # the send resolves False instead of hanging.
    t0 = time.monotonic()
    assert not a.send("bob", b"x" * 64, "sd1", "0").resolve(timeout=30)
    assert time.monotonic() - t0 < 15
    # The rule is spent: the next send goes through.
    assert a.send("bob", b"y" * 64, "sd2", "0").resolve(timeout=30)
    assert bytes(b.recv("alice", "sd2", "0").resolve(timeout=30)) == b"y" * 64


def test_chaos_connect_kill_rail_is_retried(manager_pair):
    a, b = manager_pair
    chaos.install({
        "rules": [
            {"hook": "connect", "party": "alice", "count": 1,
             "op": "kill_rail"},
        ],
    })
    assert a.send("bob", b"z" * 32, "k1", "0").resolve(timeout=30)
    assert bytes(b.recv("alice", "k1", "0").resolve(timeout=30)) == b"z" * 32


def test_partition_blocks_link_and_heals(manager_pair):
    a, b = manager_pair
    # Sanity: the link works before the cut.
    assert a.send("bob", b"pre" * 8, "p0", "0").resolve(timeout=30)
    assert bytes(b.recv("alice", "p0", "0").resolve(timeout=30)) == b"pre" * 8
    chaos.install({"rules": [
        {"hook": "wire", "op": "partition", "value": ["alice", "bob"]},
    ]})
    # Client side: every frame (pings included) dies before the socket —
    # to alice, bob reads exactly like a dead peer.
    assert not a.ping("bob", timeout_s=1.0)
    t0 = time.monotonic()
    assert not a.send("bob", b"cut" * 8, "p1", "0").resolve(timeout=30)
    assert time.monotonic() - t0 < 15  # the tight ladder, not a hang
    # Healing the partition restores the link (same sockets/process).
    chaos.uninstall()
    assert a.ping("bob", timeout_s=2.0)
    assert a.send("bob", b"ok!" * 8, "p2", "0").resolve(timeout=30)
    assert bytes(b.recv("alice", "p2", "0").resolve(timeout=30)) == b"ok!" * 8


def test_partition_server_side_silent_drop(manager_pair):
    """One-sided arming (party filter): alice's frames cross the wire
    and are discarded by bob's server without ANY reply — the sender's
    ACK deadline fires (deadlines are not retried), and bob's parked
    consumers never see the bytes.  This is the receive half a real
    partition exercises in bob's process."""
    a, b = manager_pair
    chaos.install({"rules": [
        {"hook": "wire", "op": "partition", "value": ["alice", "bob"],
         "party": "bob"},
    ]})
    t0 = time.monotonic()
    assert not a.send("bob", b"drp" * 8, "sd1", "0").resolve(timeout=30)
    assert time.monotonic() - t0 < 15
    assert not a.ping("bob", timeout_s=1.0)  # PONG suppressed too
    chaos.uninstall()
    assert a.send("bob", b"yes" * 8, "sd2", "0").resolve(timeout=30)
    assert bytes(b.recv("alice", "sd2", "0").resolve(timeout=30)) == b"yes" * 8


def test_partition_drives_death_declaration():
    """The failover trigger chain: a partition starves the health
    monitor's pings, so the partitioned peer is declared dead and the
    parked recvs fail — exactly the signal the quorum driver's
    coordinator failover arms on, with both processes alive."""
    pa, pb = get_free_ports(2)
    ports = {"alice": pa, "bob": pb}
    a = _mk_manager(
        "alice", ports, peer_health_interval_s=0.3, peer_death_pings=2
    )
    b = _mk_manager("bob", ports)
    a.start()
    b.start()
    try:
        # bob proves reachable first (fail-fast only covers LOSS).
        assert b.send("alice", b"hi", "h0", "0").resolve(timeout=10)
        assert a.recv("bob", "h0", "0").resolve(timeout=10) is not None
        chaos.install({"rules": [
            {"hook": "wire", "op": "partition",
             "value": ["alice", "bob"]},
        ]})
        from rayfed_tpu_torch.exceptions import RemoteError

        t0 = time.monotonic()
        ref = a.recv("bob", "never", "0")
        with pytest.raises(RemoteError, match="unreachable"):
            ref.resolve(timeout=30)
        assert time.monotonic() - t0 < 15
        assert "bob" in a.get_stats()["dead_parties"]
    finally:
        chaos.uninstall()
        a.stop()
        b.stop()


# ---------------------------------------------------------------------------
# Known-dead fast-fail (satellite): the retry ladder is skipped
# ---------------------------------------------------------------------------


def test_dead_destination_skips_backoff_ladder():
    pa, pb = get_free_ports(2)
    ports = {"alice": pa, "bob": pb}
    # DEFAULT ladder (5 attempts, 5s/30s backoffs = ~65s of sleeps):
    # the fast-fail must beat it by consulting the dead set.
    a = _mk_manager("alice", ports, retry_policy=RetryPolicy(jitter=False))
    a.start()
    try:
        from rayfed_tpu_torch.exceptions import RemoteError

        err = RemoteError("bob", "ConnectionError", "declared dead").to_wire()
        done = asyncio.run_coroutine_threadsafe(
            asyncio.sleep(0), a._loop
        )
        done.result(timeout=5)
        a._loop.call_soon_threadsafe(a._mailbox.fail_party, "bob", err)
        time.sleep(0.2)
        t0 = time.monotonic()
        ok = a.send("bob", b"x" * 16, "u", "0").resolve(timeout=60)
        elapsed = time.monotonic() - t0
        assert not ok
        # One connection attempt (refused, nobody listening) and out —
        # nowhere near the 65s ladder.
        assert elapsed < 10, elapsed
    finally:
        a.stop()


# ---------------------------------------------------------------------------
# Health knobs as validated transport options (satellite)
# ---------------------------------------------------------------------------


def test_health_knobs_surfaced_and_validated():
    pa, pb = get_free_ports(2)
    ports = {"alice": pa, "bob": pb}
    a = _mk_manager(
        "alice", ports,
        options={"heartbeat_interval_s": 0.25, "death_deadline_s": 1.0},
    )
    eff = a.effective_transport_options("bob")
    assert eff["options"]["heartbeat_interval_s"] == 0.25
    assert eff["options"]["death_deadline_s"] == 1.0
    assert "heartbeat_interval_s" not in eff["ignored_keys"]

    bad = _mk_manager(
        "alice", ports,
        options={"heartbeat_interval_s": 2.0, "death_deadline_s": 0.5},
    )
    with pytest.raises(ValueError, match="death_deadline_s"):
        bad.effective_transport_options("bob")
    with pytest.raises(ValueError, match="heartbeat_interval_s"):
        _mk_manager(
            "alice", ports, options={"heartbeat_interval_s": -1}
        ).effective_transport_options("bob")


def test_health_knobs_drive_death_deadline():
    pa, pb = get_free_ports(2)
    ports = {"alice": pa, "bob": pb}
    # Aggressive per-party knobs on alice's view of bob.
    a = _mk_manager(
        "alice", ports,
        options={"heartbeat_interval_s": 0.2, "death_deadline_s": 0.4},
        peer_health_interval_s=0.5, peer_death_pings=3,
    )
    b = _mk_manager("bob", ports)
    a.start()
    b.start()
    try:
        # bob proves reachable (delivers a value), then dies.
        assert b.send("alice", b"hello", "h", "0").resolve(timeout=10)
        assert a.recv("bob", "h", "0").resolve(timeout=10) is not None
        b.stop()
        from rayfed_tpu_torch.exceptions import RemoteError

        t0 = time.monotonic()
        ref = a.recv("bob", "never", "0")
        with pytest.raises(RemoteError, match="unreachable"):
            ref.resolve(timeout=30)
        # Declared within a few ticks of the 0.4s deadline (first loop
        # cycle still runs at the job interval before the tick adapts).
        assert time.monotonic() - t0 < 10
    finally:
        a.stop()


# ---------------------------------------------------------------------------
# Roster epochs on the wire + membership inbox
# ---------------------------------------------------------------------------


def test_cross_epoch_frame_rejected_loudly(manager_pair):
    a, b = manager_pair
    b.roster.advance(["alice", "bob"])  # bob is at epoch 1
    # alice still stamps epoch 0: rejected fatally (no retry ladder).
    t0 = time.monotonic()
    assert not a.send("bob", b"stale" * 8, "e1", "0", epoch_tag=0).resolve(
        timeout=30
    )
    assert time.monotonic() - t0 < 5
    assert b.get_stats().get("receive_epoch_rejects", 0) == 1
    # Matching epoch passes; a NEWER epoch passes too (the advanced
    # coordinator's broadcast must reach lagging stragglers — it is the
    # frame that carries the roster transition); untagged frames are
    # never checked.
    assert a.send("bob", b"fresh" * 8, "e2", "0", epoch_tag=1).resolve(
        timeout=30
    )
    assert a.send("bob", b"newer" * 8, "e4", "0", epoch_tag=2).resolve(
        timeout=30
    )
    assert a.send("bob", b"plain" * 8, "e3", "0").resolve(timeout=30)
    assert bytes(b.recv("alice", "e2", "0").resolve(timeout=30)) == b"fresh" * 8
    assert bytes(b.recv("alice", "e4", "0").resolve(timeout=30)) == b"newer" * 8


def test_membership_request_inbox(manager_pair):
    a, b = manager_pair
    req = {"op": "join", "party": "alice", "nonce": "abc123"}
    assert a.send(
        "bob", req, "roster.req.alice.abc123", "roster"
    ).resolve(timeout=30)
    deadline = time.monotonic() + 10
    got = []
    while not got and time.monotonic() < deadline:
        got = b.drain_membership_requests()
        time.sleep(0.05)
    assert got == [req]
    assert b.drain_membership_requests() == []  # drained
    # Requests never park in the mailbox (no leaked entries).
    assert b.get_stats()["pending_recvs"] == 0
