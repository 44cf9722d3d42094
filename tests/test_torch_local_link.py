"""The port's local-link fast path (transport/local.py) held against the
reference's tests/test_local_link.py: per-link backend selection, the loud
UDS-failure fallback, chaos parity on upgraded links, and 4-party
mixed-backend byte-identity of the fold.  The reference folds quantized
codes there (ROADMAP.md Queue A item 6); here the float packed fold, held
to ``packed_weighted_sum``'s bytes.

All in-process per the tier-1 budget note: real loopback TCP, a real
AF_UNIX listener, and the same-interpreter shm handoff — the three
backends a colocated deployment actually mixes.
"""

import logging
import os

import numpy as np
import pytest

import torch

from rayfed_tpu_torch import chaos
from rayfed_tpu_torch.config import ClusterConfig, JobConfig, PartyConfig, RetryPolicy
from rayfed_tpu_torch.fl import compression as fl_comp
from rayfed_tpu_torch.fl import fedavg
from rayfed_tpu_torch.fl.streaming import StreamingAggregator
from rayfed_tpu_torch.transport.manager import TransportManager

from .multiproc import get_free_ports


@pytest.fixture(autouse=True)
def _no_leaked_schedule():
    yield
    chaos.uninstall()


TIGHT_RETRY = RetryPolicy(
    max_attempts=3, initial_backoff_s=0.2, max_backoff_s=0.4, jitter=False
)


def _mk(party, cluster_ports, dest_options=None, **job_kw):
    """One manager; ``dest_options`` maps a DEST party to that party's
    ``transport_options`` in THIS manager's view of the cluster — the
    per-link override path (a mixed-backend mesh is built by giving
    each sender a different override for the same coordinator)."""
    dest_options = dest_options or {}
    cc = ClusterConfig(
        parties={
            p: PartyConfig.from_dict(
                dict(
                    {"address": f"127.0.0.1:{port}"},
                    **(
                        {"transport_options": dest_options[p]}
                        if p in dest_options
                        else {}
                    ),
                )
            )
            for p, port in cluster_ports.items()
        },
        current_party=party,
    )
    job = dict(
        device_put_received=False,
        zero_copy_host_arrays=True,
        cross_silo_timeout_s=5,
        retry_policy=TIGHT_RETRY,
    )
    job.update(job_kw)
    return TransportManager(cc, JobConfig(**job), device=torch.device("cpu"))


def _link(mgr, dest):
    return mgr.effective_transport_options(dest)["local_link"]


def _pair(mode):
    pa, pb = get_free_ports(2)
    ports = {"alice": pa, "bob": pb}
    a = _mk("alice", ports, local_link=mode)
    b = _mk("bob", ports, local_link=mode)
    a.start()
    b.start()
    return a, b


# ---------------------------------------------------------------------------
# Backend selection matrix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "mode,backend",
    [
        ("auto", "shm"),  # same interpreter: registry handoff, no socket
        ("shm", "shm"),
        ("uds", "uds"),  # forced: HELLO advertises the path, AF_UNIX redial
        ("off", "tcp"),
    ],
)
def test_backend_selection_matrix(mode, backend):
    a, b = _pair(mode)
    try:
        x = np.arange(1 << 20, dtype=np.float32)  # big enough to bill >0ms
        assert a.send("bob", x, "m0", "0").resolve(timeout=30)
        got = b.recv("alice", "m0", "0").resolve(timeout=30)
        np.testing.assert_array_equal(np.asarray(got), x)
        info = _link(a, "bob")
        assert info["decided"] and info["backend"] == backend, info
        # The send was billed to the decided backend's stat row (the
        # per-backend split is how a local-link regression stays
        # attributable from metrics alone).
        row = a.get_stats()["send_path_breakdown_by_backend_ms"][backend]
        assert sum(row.values()) > 0, row
        others = {
            k: v
            for k, v in a.get_stats()[
                "send_path_breakdown_by_backend_ms"
            ].items()
            if k != backend
        }
        assert all(sum(r.values()) == 0 for r in others.values()), others
    finally:
        a.stop()
        b.stop()


def test_off_mode_is_a_decision_not_a_fallback():
    a, b = _pair("off")
    try:
        assert a.send(
            "bob", np.zeros(16, dtype=np.float32), "m1", "0"
        ).resolve(timeout=30)
        assert b.recv("alice", "m1", "0").resolve(timeout=30) is not None
        info = _link(a, "bob")
        assert info["backend"] == "tcp"
        # An explicit local_link="off" records NO fallback reason —
        # that field is reserved for degradations the operator didn't
        # ask for (the loud-fallback tests below assert it's set).
        assert info["fallback"] is None, info
    finally:
        a.stop()
        b.stop()


# ---------------------------------------------------------------------------
# UDS failure: loud TCP fallback, delivery still happens
# ---------------------------------------------------------------------------


def test_uds_listener_loss_falls_back_to_tcp_loudly(caplog):
    a, b = _pair("uds")
    try:
        # Yank bob's AF_UNIX socket out from under the advertisement
        # BEFORE alice's first contact: the HELLO still advertises the
        # path, so the redial hits ENOENT — the peer-restarted shape.
        path = b._server._uds_path
        assert path is not None and os.path.exists(path)
        os.unlink(path)
        x = np.arange(1 << 14, dtype=np.float32)
        with caplog.at_level(logging.WARNING):
            assert a.send("bob", x, "f0", "0").resolve(timeout=60)
        got = b.recv("alice", "f0", "0").resolve(timeout=30)
        np.testing.assert_array_equal(np.asarray(got), x)
        info = _link(a, "bob")
        # Pinned to TCP for good, with the failure recorded…
        assert info["backend"] == "tcp"
        assert "AF_UNIX" in (info["fallback"] or ""), info
        # …and LOUDLY: a forced-uds operator asked not to degrade.
        assert any(
            "using TCP" in r.getMessage() and "AF_UNIX" in r.getMessage()
            for r in caplog.records
        ), [r.getMessage() for r in caplog.records]
        # The link stays pinned: later sends work without re-probing.
        assert a.send("bob", x, "f1", "0").resolve(timeout=30)
        assert b.recv("alice", "f1", "0").resolve(timeout=30) is not None
    finally:
        a.stop()
        b.stop()


# ---------------------------------------------------------------------------
# Chaos parity: injected faults bite upgraded links like wire links
# ---------------------------------------------------------------------------


def test_chaos_partition_cuts_the_shm_link_and_heals():
    a, b = _pair("auto")
    try:
        x = np.arange(1024, dtype=np.float32)
        assert a.send("bob", x, "p0", "0").resolve(timeout=30)
        assert b.recv("alice", "p0", "0").resolve(timeout=30) is not None
        assert _link(a, "bob")["backend"] == "shm"
        # Unarmed: liveness is a registry verdict (no roundtrip).
        assert a.ping("bob", timeout_s=1.0)
        chaos.install({"rules": [
            {"hook": "wire", "op": "partition", "value": ["alice", "bob"]},
        ]})
        # Armed: the ping rides the handoff, so the partition starves
        # the PONG exactly like on a wire…
        assert not a.ping("bob", timeout_s=0.5)
        # …and the send exhausts its retries and resolves False.
        assert not a.send("bob", x, "p1", "0").resolve(timeout=30)
        chaos.uninstall()
        assert a.send("bob", x, "p2", "0").resolve(timeout=30)
        got = b.recv("alice", "p2", "0").resolve(timeout=30)
        np.testing.assert_array_equal(np.asarray(got), x)
    finally:
        a.stop()
        b.stop()


def test_chaos_frame_drop_on_shm_link_is_retried():
    a, b = _pair("auto")
    try:
        warm = np.zeros(16, dtype=np.float32)
        assert a.send("bob", warm, "w0", "0").resolve(timeout=30)
        assert b.recv("alice", "w0", "0").resolve(timeout=30) is not None
        assert _link(a, "bob")["backend"] == "shm"
        chaos.install({"rules": [
            {"hook": "frame", "party": "alice", "match": {"dest": "bob"},
             "count": 1, "op": "drop_frame"},
        ]})
        x = np.arange(4096, dtype=np.float32)
        assert a.send("bob", x, "d0", "0").resolve(timeout=30)
        got = b.recv("alice", "d0", "0").resolve(timeout=30)
        np.testing.assert_array_equal(np.asarray(got), x)
    finally:
        a.stop()
        b.stop()


def test_chaos_corrupt_crc_on_shm_link_exercises_verify_and_retry():
    """CRC is ELIDED on trusted local links — but a chaos-planted
    DECLARED checksum must still hit the receiver's mismatch path and
    the sender's retry arm (the elision is about not paying for honest
    bytes, never about skipping verification of a declared claim)."""
    a, b = _pair("auto")
    try:
        warm = np.zeros(16, dtype=np.float32)
        assert a.send("bob", warm, "w1", "0").resolve(timeout=30)
        assert b.recv("alice", "w1", "0").resolve(timeout=30) is not None
        assert _link(a, "bob")["backend"] == "shm"
        chaos.install({"rules": [
            {"hook": "frame", "party": "alice", "count": 1,
             "op": "corrupt_crc"},
        ]})
        x = np.arange(4096, dtype=np.float64)
        assert a.send("bob", x, "c0", "0").resolve(timeout=30)
        got = b.recv("alice", "c0", "0").resolve(timeout=30)
        np.testing.assert_array_equal(np.asarray(got), x)
        assert b.get_stats().get("receive_crc_errors", 0) >= 1
    finally:
        a.stop()
        b.stop()


# ---------------------------------------------------------------------------
# Mixed-backend byte-identity: shm + uds + tcp into one fold
# ---------------------------------------------------------------------------


def _packed_setup(n, size=1 << 14, seed=11):
    rng = np.random.default_rng(seed)
    return [
        fl_comp.pack_tree({"w": torch.from_numpy(rng.normal(size=(size,)).astype(np.float32))})
        for _ in range(n)
    ]


def test_mixed_backend_fold_byte_identity():
    """One coordinator folding three packed contributions that each ride a
    DIFFERENT backend (shm, uds, tcp) must produce bytes identical to a
    tcp-only round and to the one-shot packed_weighted_sum — the backend
    is a transport detail, never a numerics one."""
    parties = ["alice", "bob", "carol", "dave"]
    senders = parties[1:]
    packeds = _packed_setup(len(senders))
    want = fedavg.packed_weighted_sum(packeds)

    def run_round(link_modes):
        ports = dict(zip(parties, get_free_ports(len(parties))))
        mgrs = {"alice": _mk("alice", ports)}
        for p in senders:
            mgrs[p] = _mk(
                p, ports,
                dest_options={"alice": {"local_link": link_modes[p]}},
            )
        for m in mgrs.values():
            m.start()
        try:
            agg = StreamingAggregator(len(senders), chunk_elems=1 << 12, device="cpu")
            a = mgrs["alice"]
            for i, p in enumerate(senders):
                a.recv_stream(p, f"q-{p}", "0", agg.sink(i))
            refs = [
                mgrs[p].send("alice", pt, f"q-{p}", "0", stream="mix")
                for p, pt in zip(senders, packeds)
            ]
            out = agg.result(timeout=60)
            assert all(r.resolve(timeout=60) for r in refs)
            backends = {p: _link(mgrs[p], "alice")["backend"]
                        for p in senders}
            return out.buf.view(torch.int16).numpy().tobytes(), backends
        finally:
            for m in mgrs.values():
                m.stop()

    mixed, backends = run_round(
        {"bob": "shm", "carol": "uds", "dave": "off"}
    )
    # The mesh really was mixed — one link per backend.
    assert backends == {"bob": "shm", "carol": "uds", "dave": "tcp"}, backends
    tcp_only, tcp_backends = run_round({p: "off" for p in senders})
    assert set(tcp_backends.values()) == {"tcp"}, tcp_backends
    assert mixed == tcp_only == want.buf.view(torch.int16).numpy().tobytes()
