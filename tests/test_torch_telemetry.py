"""The port's federated flight recorder (telemetry.py), held against the
reference's tests/test_telemetry.py.

Unit: the bounded ring + emission helpers, the trace-collection
schemas (single producers, fingerprinted by tool/check_wire_format.py),
clock-offset estimation, the merge, the Perfetto export, and the
critical-path report (tool/trace_report.py).

Integration (in-process managers, real loopback sockets): the
TRACE_GET/TRACE_PUT collection round trip, the per-manager TransferLog,
and the ``metrics_snapshot`` schema-stability contract (in one process
here; the reference spawns two parties).  The reference's multi-host
delegation case comes with the multi-host party (ROADMAP.md Queue A
item 10).
"""

import json
import time

import pytest

from rayfed_tpu_torch import telemetry
from rayfed_tpu_torch.config import ClusterConfig, JobConfig, PartyConfig
from rayfed_tpu_torch.transport.manager import TransportManager
from tests.multiproc import get_free_ports


@pytest.fixture(autouse=True)
def _fresh_recorder():
    telemetry.uninstall()
    yield
    telemetry.uninstall()


# ---------------------------------------------------------------------------
# Recorder ring
# ---------------------------------------------------------------------------


def test_disarmed_emission_is_a_noop():
    assert telemetry.active() is None
    telemetry.emit("wire.send", round=1)  # must not raise, must not arm
    telemetry.event("quorum.cutoff")
    with telemetry.span("agg.finalize"):
        pass
    assert telemetry.installed() is None


def test_ring_bounds_and_drop_accounting():
    rec = telemetry.install(party="alice", capacity=4)
    for i in range(10):
        rec.emit("wire.send", round=i)
    recs = rec.records()
    assert len(recs) == 4
    assert [r.round for r in recs] == [6, 7, 8, 9]  # oldest evicted
    stats = rec.stats()
    assert stats["trace_total_recorded"] == 10
    assert stats["trace_dropped"] == 6
    assert stats["trace_capacity"] == 4


def test_round_filter_keeps_untagged_records():
    rec = telemetry.install(party="alice")
    rec.emit("wire.send", round=1)
    rec.emit("chaos.partition")  # no round tag: cross-cutting context
    rec.emit("wire.send", round=5)
    win = rec.records(rounds=(4, 9))
    assert [r.phase for r in win] == ["chaos.partition", "wire.send"]
    assert rec.records(rounds=1)[0].round == 1


def test_emit_never_raises_on_malformed_fields():
    rec = telemetry.install(party="alice")
    rec.emit("wire.send", round="not-an-int")
    (bad,) = rec.records()
    assert bad.outcome == "bad-record"
    assert "error" in bad.detail


def test_span_helper_times_and_stamps_errors():
    rec = telemetry.install(party="alice")
    with telemetry.span("agg.finalize", round=2):
        time.sleep(0.01)
    with pytest.raises(ValueError):
        with telemetry.span("agg.fold", round=2):
            raise ValueError("boom")
    ok, err = rec.records()
    assert ok.phase == "agg.finalize" and ok.dur_s >= 0.01
    assert ok.outcome == "ok" and ok.round == 2
    assert err.phase == "agg.fold" and err.outcome == "error"


def test_env_arming_adopts_party(monkeypatch):
    monkeypatch.setenv(telemetry.ENV_VAR, "1")
    rec = telemetry.maybe_install_from_env()
    assert rec is not None and rec.party is None
    # fed.init arms again, now knowing who this party is.
    rec2 = telemetry.maybe_install_from_env(party="alice")
    assert rec2 is rec and rec.party == "alice"
    monkeypatch.setenv(telemetry.ENV_VAR, "0")
    telemetry.uninstall()
    assert telemetry.maybe_install_from_env() is None


# ---------------------------------------------------------------------------
# Wire schemas (single producers — fingerprinted by check_wire_format)
# ---------------------------------------------------------------------------


def test_trace_request_reply_schemas_roundtrip():
    req = telemetry.make_trace_request("trace.put.a.n1", rounds=(2, 5))
    parsed = telemetry.check_trace_request(json.loads(json.dumps(req)))
    assert parsed["rk"] == "trace.put.a.n1"
    assert parsed["rnd"] == [2, 5]
    assert parsed["v"] == telemetry.TELEMETRY_VERSION
    rep = telemetry.make_trace_reply_meta("bob", 3, armed=True)
    parsed = telemetry.check_trace_reply_meta(json.loads(json.dumps(rep)))
    assert parsed["party"] == "bob" and parsed["n"] == 3 and parsed["armed"]
    with pytest.raises(telemetry.TelemetryError):
        telemetry.check_trace_request({"no": "reply key"})
    with pytest.raises(telemetry.TelemetryError):
        telemetry.check_trace_request({"rk": "k", "rnd": [1]})
    with pytest.raises(telemetry.TelemetryError):
        telemetry.check_trace_reply_meta({"n": 1})


def test_record_encoding_roundtrip_and_field_order_guard():
    rec = telemetry.install(party="alice")
    rec.emit(
        "wire.send", round=3, epoch=1, peer="bob", stream="fedavg",
        nbytes=1024, dur_s=0.5, detail={"x": (1, 2)},
    )
    payload = telemetry.encode_records(rec.records())
    (back,) = telemetry.decode_records(payload)
    assert back.phase == "wire.send" and back.peer == "bob"
    assert back.nbytes == 1024 and back.round == 3
    assert back.detail == {"x": [1, 2]}  # JSON-safe coercion
    doc = json.loads(payload)
    assert doc["fields"] == list(telemetry.SPAN_FIELDS)
    doc["fields"] = doc["fields"][::-1]
    with pytest.raises(telemetry.TelemetryError, match="field order"):
        telemetry.decode_records(json.dumps(doc).encode())
    doc = json.loads(payload)
    doc["v"] = telemetry.TELEMETRY_VERSION + 1
    with pytest.raises(telemetry.TelemetryError, match="protocol"):
        telemetry.decode_records(json.dumps(doc).encode())
    with pytest.raises(telemetry.TelemetryError, match="fields"):
        telemetry.record_from_list([1, 2, 3])


# ---------------------------------------------------------------------------
# Clock alignment, merge, Perfetto export, report
# ---------------------------------------------------------------------------


def test_clock_offset_estimate_and_bound():
    # Peer clock 10s ahead, symmetric 2ms RTT: recover the offset with
    # the documented RTT/2 bound.
    t_send, rtt, skew = 1000.0, 0.002, 10.0
    t_peer = t_send + rtt / 2 + skew
    off = telemetry.estimate_clock_offset(t_send, t_send + rtt, t_peer)
    assert off["offset_s"] == pytest.approx(skew, abs=1e-9)
    assert off["rtt_s"] == pytest.approx(rtt)
    assert off["bound_s"] == pytest.approx(rtt / 2)


def _rec(party, phase, t, dur=0.0, rnd=None, **kw):
    return telemetry.SpanRecord(
        party=party, round=rnd, epoch=None, phase=phase,
        peer=kw.get("peer"), stream=None, nbytes=kw.get("nbytes", 0),
        t_start=t, dur_s=dur, outcome=kw.get("outcome", "ok"),
        detail=kw.get("detail"),
    )


def test_merge_applies_offsets_and_fills_party():
    merged = telemetry.merge_records(
        {
            "alice": [_rec("alice", "wire.send", 100.0, 0.1, rnd=0)],
            # bob's clock runs 50s ahead; his record happened FIRST on
            # the collector's timeline once the offset is applied.
            "bob": [_rec(None, "wire.deliver", 149.9, 0.1, rnd=0)],
        },
        {"bob": {"offset_s": 50.0, "rtt_s": 0.001, "bound_s": 0.0005}},
    )
    assert [d["party"] for d in merged] == ["bob", "alice"]
    assert merged[0]["t_start"] == pytest.approx(99.9)


def test_perfetto_export_shape():
    merged = telemetry.merge_records({
        "alice": [
            _rec("alice", "wire.send", 100.0, 0.25, rnd=1, peer="bob",
                 nbytes=2048),
            _rec("alice", "quorum.failover", 100.3, 0.0, rnd=1,
                 detail={"to": "bob"}),
        ],
        "bob": [_rec("bob", "agg.finalize", 100.1, 0.05, rnd=1)],
    })
    doc = telemetry.to_trace_events(
        merged, {"bob": {"offset_s": 0.0, "rtt_s": 0.0, "bound_s": 0.0}}
    )
    events = doc["traceEvents"]
    json.dumps(doc)  # valid JSON end to end
    names = {e["args"]["name"] for e in events if e["name"] == "process_name"}
    assert names == {"alice", "bob"}
    spans = [e for e in events if e["ph"] == "X"]
    instants = [e for e in events if e["ph"] == "i"]
    assert {e["name"] for e in spans} == {"wire.send", "agg.finalize"}
    assert [e["name"] for e in instants] == ["quorum.failover"]
    # Timestamps are µs relative to the earliest record.
    send = next(e for e in spans if e["name"] == "wire.send")
    assert send["ts"] == 0.0 and send["dur"] == pytest.approx(0.25e6)
    assert send["args"]["nbytes"] == 2048
    # Distinct phase families land on distinct named threads.
    tids = {e["args"]["name"] for e in events if e["name"] == "thread_name"}
    assert {"wire", "quorum", "agg"} <= tids


def test_trace_report_critical_path_and_straggler():
    from tool.trace_report import format_report, round_report

    records = [dict(zip(telemetry.SPAN_FIELDS, telemetry.record_to_list(r)))
               for r in [
        _rec("alice", "driver.round", 100.0, 1.0, rnd=0, peer="alice",
             detail={"local_s": 0.3}),
        _rec("bob", "driver.round", 100.0, 0.98, rnd=0, peer="alice",
             detail={"local_s": 0.7}),
        _rec("bob", "wire.send", 100.7, 0.2, rnd=0, peer="alice"),
        _rec("alice", "agg.finalize", 100.92, 0.08, rnd=0),
        _rec("alice", "chaos.delay_ms", 100.5, 0.0, outcome="injected"),
    ]]
    rep = round_report(records, tolerance=0.25)
    info = rep[0]
    assert info["wall_s"] == pytest.approx(1.0)
    assert info["driver_wall_s"] == pytest.approx(1.0)
    assert info["wall_agrees"]
    # bob's local compute bounded the wall; he is also the straggler.
    assert info["bounded_by"]["party"] == "bob"
    assert info["bounded_by"]["phase"] == "driver.local"
    assert info["straggler"] == "bob"
    # The chain covers the full wall, chronologically.
    assert sum(s["dur_s"] for s in info["chain"]) == pytest.approx(1.0)
    # The untagged chaos injection inside the window rides along.
    assert [e["phase"] for e in info["events"]] == ["chaos.delay_ms"]
    text = format_report(records)
    assert "bounded by bob" in text and "chaos.delay_ms" in text


def test_trace_report_flags_wall_disagreement():
    from tool.trace_report import round_report

    records = [dict(zip(telemetry.SPAN_FIELDS, telemetry.record_to_list(r)))
               for r in [
        _rec("alice", "driver.round", 100.0, 0.2, rnd=0),
        _rec("bob", "wire.send", 100.0, 1.0, rnd=0),
    ]]
    assert not round_report(records, tolerance=0.25)[0]["wall_agrees"]


# ---------------------------------------------------------------------------
# In-process managers: collection round trip + per-manager TransferLog
# ---------------------------------------------------------------------------


def _pair_cluster(parties=("alice", "bob")):
    ports = get_free_ports(len(parties))
    return {
        p: ClusterConfig(
            parties={
                q: PartyConfig(address=f"127.0.0.1:{port}")
                for q, port in zip(parties, ports)
            },
            current_party=p,
        )
        for p in parties
    }


@pytest.fixture()
def manager_pair():
    mgrs = {
        p: TransportManager(cc, JobConfig(device_put_received=False))
        for p, cc in _pair_cluster().items()
    }
    for m in mgrs.values():
        m.start()
    yield mgrs
    for m in mgrs.values():
        m.stop()


def test_collect_trace_round_trip(manager_pair):
    import numpy as np

    mgrs = manager_pair
    telemetry.install()  # party=None: every seam stamps its own party
    ref = mgrs["alice"].send(
        "bob", np.arange(64, dtype=np.float32), "t1", "0",
        stream="unit", round_tag=7,
    )
    assert mgrs["bob"].recv("alice", "t1", "0").resolve(timeout=30) is not None
    assert ref.resolve(timeout=30)

    records, offset, rep = mgrs["alice"].collect_trace("bob", timeout_s=30)
    assert rep["party"] == "bob" and rep["armed"]
    assert rep["n"] == len(records) > 0
    # Only bob's own view crosses the wire; alice's spans stay home.
    assert all(r.party == "bob" for r in records)
    phases = {r.phase for r in records}
    assert "wire.deliver" in phases, phases
    assert any(r.round == 7 for r in records)
    # Loopback round trip: offset ~0 within the documented RTT/2 bound.
    assert offset["rtt_s"] < 5.0
    assert abs(offset["offset_s"]) <= offset["bound_s"] + 0.5
    # Round-bounded window: a round-99 filter keeps only untagged
    # context records.
    windowed, _, _ = mgrs["alice"].collect_trace(
        "bob", rounds=(99, 99), timeout_s=30
    )
    assert all(r.round is None for r in windowed)


def test_collect_trace_from_disarmed_peer_is_loud_not_hung(manager_pair):
    mgrs = manager_pair
    assert telemetry.installed() is None
    records, _offset, rep = mgrs["alice"].collect_trace("bob", timeout_s=30)
    assert records == [] and not rep["armed"]


def test_transfer_log_is_per_manager(manager_pair):
    import numpy as np

    from rayfed_tpu_torch import metrics

    mgrs = manager_pair
    global_before = len(metrics._global_transfer_log.records())
    ref = mgrs["alice"].send(
        "bob", np.arange(32, dtype=np.float32), "tl1", "0"
    )
    assert mgrs["bob"].recv("alice", "tl1", "0").resolve(timeout=30) is not None
    assert ref.resolve(timeout=30)
    deadline = time.time() + 30
    while (
        not mgrs["alice"].transfer_log.records() and time.time() < deadline
    ):
        time.sleep(0.02)
    sends = mgrs["alice"].transfer_log.records()
    recvs = mgrs["bob"].transfer_log.records()
    # Each party's ring holds ITS view only — nothing leaked into the
    # module-global runtime-less fallback, and nothing conflated.
    assert [r.direction for r in sends] == ["send"]
    assert sends[0].peer == "bob" and sends[0].nbytes > 0
    assert [r.direction for r in recvs] == ["recv"]
    assert recvs[0].peer == "alice"
    assert len(metrics._global_transfer_log.records()) == global_before
    # Runtime-less processes still get the documented fallback.
    assert metrics.get_transfer_log() is metrics._global_transfer_log


# ---------------------------------------------------------------------------
# metrics_snapshot schema stability (the wire-drift discipline, applied
# to the stats surface)
# ---------------------------------------------------------------------------


def test_metrics_snapshot_empty_before_init():
    from rayfed_tpu_torch.metrics import metrics_snapshot

    assert metrics_snapshot() == {}


def test_metrics_snapshot_schema():
    """In one process (the reference spawns two parties): every documented
    section and key exists with the documented type."""
    import numpy as np
    import torch

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch.metrics import METRICS_SCHEMA
    from tests.multiproc import make_cluster

    fed.init(address="local", cluster=make_cluster(["alice"]), party="alice",
             device=torch.device("cpu"))
    try:
        @fed.remote
        def produce():
            return np.arange(100, dtype=np.float32)

        fed.get(produce.party("alice").remote())
        snap = fed.metrics_snapshot()
        assert set(METRICS_SCHEMA) <= set(snap), sorted(snap)
        for section, keys in METRICS_SCHEMA.items():
            for key, typ in keys.items():
                assert key in snap[section], (section, key, sorted(snap[section]))
                assert isinstance(snap[section][key], typ), (
                    section, key, type(snap[section][key]),
                )
        assert snap["telemetry"]["trace_armed"] is False  # disarmed run
    finally:
        fed.shutdown()


# ---------------------------------------------------------------------------
# Review-hardening regressions: party attribution, disjoint
# parties/missing, multi-host leader delegation
# ---------------------------------------------------------------------------


def test_streaming_aggregator_spans_carry_party():
    """In-process multi-party runs share ONE process-global recorder;
    the aggregation spans must stamp their acting party or every
    manager's trace window would serve (and the merge would duplicate)
    them."""
    import torch

    from rayfed_tpu_torch.fl import compression as fl_comp
    from rayfed_tpu_torch.fl.streaming import StreamingAggregator

    rec = telemetry.install()  # party=None: the stamp must come from the seam
    agg = StreamingAggregator(1, party="alice", device="cpu")
    agg.add_local(0, fl_comp.pack_tree({"w": torch.ones(8)}))
    agg.result(timeout=30)
    finalize = [r for r in rec.records() if r.phase == "agg.finalize"]
    assert finalize and all(r.party == "alice" for r in finalize)


def test_trace_collect_disarmed_peer_lands_in_missing_only(
    manager_pair, monkeypatch,
):
    """api.trace_collect: 'parties' (collected) and 'missing' (failed /
    disarmed) are disjoint — a disarmed peer must not count as
    collected."""
    from types import SimpleNamespace

    from rayfed_tpu_torch import api

    mgrs = manager_pair
    assert telemetry.installed() is None  # both ends disarmed
    fake_rt = SimpleNamespace(
        party="alice",
        transport=mgrs["alice"],
        cluster_config=SimpleNamespace(parties=["alice", "bob"]),
    )
    monkeypatch.setattr(api, "get_runtime", lambda: fake_rt)
    out = api.trace_collect(timeout=30)
    assert out["missing"] == {"bob": "recorder not armed"}
    assert out["parties"] == ["alice"]
    assert set(out["parties"]).isdisjoint(out["missing"])
    assert "bob" not in out["clock_offsets"]


def test_recorder_resize_preserves_newest_records():
    """fed.init(trace_capacity=) against an already-armed (env-armed)
    recorder must honor the explicit request — resize in place, newest
    records kept, instead of silently keeping the old bound."""
    rec = telemetry.install(party="alice", capacity=4)
    for i in range(6):
        rec.emit("wire.send", round=i)
    rec.resize(2)
    assert rec.capacity == 2
    assert [r.round for r in rec.records()] == [4, 5]  # newest kept
    rec.resize(8)
    assert rec.capacity == 8
    rec.emit("wire.send", round=99)
    assert [r.round for r in rec.records()] == [4, 5, 99]
    with pytest.raises(ValueError):
        rec.resize(0)
    # Drop accounting stays consistent across resizes.
    assert rec.stats()["trace_total_recorded"] == 7


def test_malformed_trace_request_gets_fast_error_reply(
    manager_pair, monkeypatch,
):
    """A request the server cannot parse must produce an err-marked
    reply (the object-plane holder-miss shape) so the collector fails
    FAST with the real reason instead of waiting out its full per-peer
    timeout."""
    mgrs = manager_pair

    def bad_request(reply_key, rounds=None, t_send=None):
        return {"v": telemetry.TELEMETRY_VERSION, "rk": str(reply_key),
                "rnd": "bogus", "ts": float(t_send or 0.0)}

    from rayfed_tpu_torch.transport import manager as manager_mod

    monkeypatch.setattr(
        manager_mod.telemetry, "make_trace_request", bad_request
    )
    t0 = time.perf_counter()
    with pytest.raises(telemetry.TelemetryError, match="malformed"):
        mgrs["alice"].collect_trace("bob", timeout_s=30)
    # Fast-fail: one round trip, nowhere near the 30s park.
    assert time.perf_counter() - t0 < 10.0
