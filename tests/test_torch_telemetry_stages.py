"""The flight recorder's stage spans in the port: where a party's time goes
inside the local step, the send and the fold.

- ``exec.args`` / ``exec.call`` / ``exec.device`` around every actor method
  and task body (``executor.py``);
- ``wire.frame`` split into ``wire.device_wait``, ``wire.d2h``,
  ``wire.crc``, ``wire.socket`` and ``wire.loop_wait`` (``transport/``);
- ``agg.stage`` / ``agg.launch`` / ``agg.wait`` at the aggregator's thread
  (``fl/streaming.py``) and ``codec.*`` (``fl/compression.py``);
- the ``clock.anchor`` that ties an operator's profiler capture to the
  recorder's clock (``metrics.start_profile``).

Disarmed, none of these sites makes a record, a CUDA event, a stage
collector or a watcher thread.  The card's part (``exec.device`` and
``wire.device_wait`` around a long kernel) is the ``gpu``-marked test at
the end; it skips without a card.
"""

import glob
import json
import threading
import time

import numpy as np
import pytest
import torch

from rayfed_tpu_torch import telemetry
from rayfed_tpu_torch.config import ClusterConfig, JobConfig, PartyConfig
from rayfed_tpu_torch.executor import ActorInstance, TaskExecutor
from rayfed_tpu_torch.fl import compression
from rayfed_tpu_torch.fl.streaming import StreamingAggregator
from rayfed_tpu_torch.transport import wire
from rayfed_tpu_torch.transport.manager import TransportManager
from tests.multiproc import get_free_ports

STAGES = ("wire.device_wait", "wire.d2h", "wire.crc", "wire.socket", "wire.loop_wait")
LAZY_ELEMS = 2_500_000  # 10 MB of float32: a lazy buffer, past the stripe size
# A 50 s traced window holds about 90 ResNet rounds after its warm-up, and
# the ring must still hold the first of them at the default capacity.
RECORDS_PER_ROUND = telemetry.DEFAULT_TRACE_CAPACITY // 100


@pytest.fixture(autouse=True)
def _fresh_recorder():
    telemetry.uninstall()
    yield
    telemetry.uninstall()


def _managers(parties):
    ports = get_free_ports(len(parties))
    mgrs = {}
    for p in parties:
        cc = ClusterConfig(
            parties={q: PartyConfig(address=f"127.0.0.1:{port}") for q, port in zip(parties, ports)},
            current_party=p,
        )
        mgrs[p] = TransportManager(cc, JobConfig(device_put_received=False))
    for m in mgrs.values():
        m.start()
    return mgrs


@pytest.fixture()
def managers():
    mgrs = _managers(("alice", "bob", "carol"))
    yield mgrs
    for m in mgrs.values():
        m.stop()


def _exchange(mgrs, r, value, stream=True):
    """bob pushes ``value`` to alice, alice fans it out to bob and carol."""
    up = mgrs["bob"].send("alice", value, f"u{r}", "0", stream="s/up/bob" if stream else None, round_tag=r)
    mgrs["alice"].recv("bob", f"u{r}", "0").resolve(timeout=60)
    assert up.resolve(timeout=60)
    down = mgrs["alice"].send_many(["bob", "carol"], value, f"d{r}", "0", stream="s/down" if stream else None,
                                   round_tag=r)
    for p in ("bob", "carol"):
        mgrs[p].recv("alice", f"d{r}", "0").resolve(timeout=60)
    assert all(ref.resolve(timeout=60) for ref in down.values())


def _settle(rec, phase, n, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline and sum(r.phase == phase for r in rec.records()) < n:
        time.sleep(0.01)


def _end(r):
    return r.t_start + r.dur_s


def _covered(frame, stages):
    """The share of ``frame`` that the union of ``stages`` covers."""
    t, cov = frame.t_start, 0.0
    for r in sorted(stages, key=lambda r: r.t_start):
        a, b = max(r.t_start, t), min(_end(r), _end(frame))
        if b > a:
            cov += b - a
            t = b
    return cov / frame.dur_s if frame.dur_s > 0 else 1.0


# ---------------------------------------------------------------------------
# Executor: exec.args / exec.call
# ---------------------------------------------------------------------------


class Trainer:
    def train(self, x):
        time.sleep(0.01)
        return x + 1


class TreeTrainer:
    def train(self, tree):
        return {k: v + 1 for k, v in tree.items()}


def test_actor_call_and_task_spans_carry_party_and_fn():
    rec = telemetry.install()  # party=None: the stamp must come from the executor
    actor = ActorInstance(Trainer, (), {}, name="t", party="bob")
    ex = TaskExecutor(max_workers=2, party="carol")
    try:
        assert actor.call_method("train", (np.ones(4),), {}).resolve(timeout=30)[0] == 2.0

        def produce(v):
            return v * 2

        assert ex.submit(produce, (3,), {}).resolve(timeout=30) == 6
    finally:
        actor.kill()
        ex.shutdown()
    by = {(r.phase, r.detail["fn"]): r for r in rec.records() if r.phase.startswith("exec.")}
    call = by[("exec.call", "Trainer.train")]
    args = by[("exec.args", "Trainer.train")]
    assert call.party == args.party == "bob"
    assert call.dur_s >= 0.01 and call.detail["queued_ms"] >= 0.0
    assert _end(args) <= call.t_start + 1e-6
    task = by[("exec.call", "produce")]
    assert task.party == "carol" and ("exec.args", "produce") in by
    # On the CPU there is no card to wait for.
    assert not [r for r in rec.records() if r.phase == "exec.device"]


def test_failed_call_is_an_error_span():
    rec = telemetry.install(party="alice")
    ex = TaskExecutor(max_workers=1, party="alice")
    try:
        def boom():
            raise ValueError("boom")

        with pytest.raises(ValueError):
            ex.submit(boom, (), {}).resolve(timeout=30)
    finally:
        ex.shutdown()
    (call,) = [r for r in rec.records() if r.phase == "exec.call"]
    assert call.outcome == "error" and call.detail["fn"] == "boom"


# ---------------------------------------------------------------------------
# Transport: wire.frame and its stages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stream", [True, False])
def test_send_stages_lie_within_their_frame(managers, stream):
    rec = telemetry.install()
    big = torch.arange(LAZY_ELEMS, dtype=torch.float32)
    for r in range(2):
        _exchange(managers, r, big, stream=stream)
        _exchange(managers, 100 + r, np.arange(16), stream=False)  # a small frame
    _settle(rec, "wire.send", 12)
    recs = rec.records()
    frames = [r for r in recs if r.phase == "wire.frame"]
    stages = [r for r in recs if r.phase in STAGES]
    assert {"wire.d2h", "wire.socket", "wire.loop_wait"} <= {r.phase for r in stages}
    assert {f.party for f in frames} == {"alice", "bob"}
    for f in frames:
        assert f.detail is None  # the stages carry what d2h_ms/crc_ms/socket_ms did
        mine = [s for s in stages if (s.party, s.peer, s.stream) == (f.party, f.peer, f.stream)
                and f.t_start - 1e-6 <= s.t_start and _end(s) <= _end(f) + 1e-6]
        assert _covered(f, mine) >= 0.9, (f, mine)
    for s in stages:
        assert any((f.party, f.peer) == (s.party, s.peer) and f.t_start - 1e-6 <= s.t_start
                   and _end(s) <= _end(f) + 1e-6 for f in frames), s
    # Every push toward a peer has its frame within its send.
    for send in [r for r in recs if r.phase == "wire.send"]:
        assert any((f.party, f.peer) == (send.party, send.peer) and send.t_start - 1e-3 <= f.t_start
                   and _end(f) <= _end(send) + 1e-3 for f in frames), send


def test_fan_out_snapshot_is_a_frame_of_no_one_peer(managers):
    rec = telemetry.install()
    _exchange(managers, 0, torch.ones(LAZY_ELEMS))
    _settle(rec, "wire.send", 3)
    shared = [r for r in rec.records() if r.phase == "wire.frame" and r.party == "alice" and r.peer is None]
    assert len(shared) == 1 and shared[0].stream == "s/down"
    inside = [r for r in rec.records() if r.phase in ("wire.d2h", "wire.crc") and r.peer is None]
    assert {r.phase for r in inside} == {"wire.d2h", "wire.crc"}
    assert all(shared[0].t_start - 1e-6 <= r.t_start and _end(r) <= _end(shared[0]) + 1e-6 for r in inside)


def test_cached_shared_buffer_waits_on_no_card_work(monkeypatch):
    """A fan-out's shared buffer is copied once: only the reader whose fetch
    copies waits on the card (``wire.device_wait``) and records the copy;
    the readers after it take the cached view and record no event or stage,
    so nothing the party enqueued since is taken for the payload's wait."""
    events = []

    class FakeEvent:
        def __init__(self, blocking=False):
            events.append(blocking)

        def record(self, stream):
            pass

        def synchronize(self):
            pass

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "default_stream", lambda device=None: None)
    rec = telemetry.install(party="alice")
    host = np.arange(1024, dtype=np.float32)
    inner = wire.LazyBuffer(lambda: memoryview(host).cast("B"), host.nbytes, torch.device("cuda", 0))
    (shared,) = wire.share_buffers([inner])
    for peer in ("bob", "carol"):
        stages = telemetry.frame_spans(party="alice", peer=peer)
        mv, _dt = wire.fetch(shared, stages)
        assert mv.nbytes == host.nbytes
        stages.close(host.nbytes)
    assert events == [True]
    copied = {(r.peer, r.phase) for r in rec.records() if r.phase in ("wire.device_wait", "wire.d2h")}
    assert copied == {("bob", "wire.device_wait"), ("bob", "wire.d2h")}


# ---------------------------------------------------------------------------
# Fold and codec
# ---------------------------------------------------------------------------


def _stream_round(mgrs, r, contribs, agg_party="alice", pause=0.0):
    """One streaming round; ``pause``: seconds the aggregator waits for
    bytes before the peers push."""
    peers = [p for p in mgrs if p != agg_party]
    agg = StreamingAggregator(len(mgrs), party=agg_party, device="cpu")
    for i, p in enumerate(peers):
        mgrs[agg_party].recv_stream(p, f"t{r}-{p}", "0", agg.sink(i + 1))
    time.sleep(pause)
    refs = [mgrs[p].send(agg_party, contribs[p], f"t{r}-{p}", "0", stream=f"tele/up/{p}", round_tag=r)
            for p in peers]
    agg.add_local(0, contribs[agg_party])
    result = agg.result(timeout=120)
    bcast = mgrs[agg_party].send_many(peers, result, f"tb{r}", "0", stream="tele/down", round_tag=r)
    for p in peers:
        mgrs[p].recv(agg_party, f"tb{r}", "0").resolve(timeout=120)
    assert all(ref.resolve(timeout=120) for ref in refs + list(bcast.values()))
    return result


def test_streaming_fold_spans(managers):
    rec = telemetry.install()
    contribs = {p: compression.compress({"w": torch.full((LAZY_ELEMS,), float(i))}, packed=True)
                for i, p in enumerate(managers)}
    result = _stream_round(managers, 0, contribs, pause=0.2)
    assert torch.allclose(result.unpack(torch.float32)["w"][:4], torch.ones(4))
    recs = rec.records()
    phases = {(r.party, r.phase) for r in recs}
    for phase in ("agg.stage", "agg.launch", "agg.wait", "agg.fold", "agg.finalize"):
        assert ("alice", phase) in phases, phase
    (fold,) = [r for r in recs if r.phase == "agg.fold"]
    assert "busy_ms" not in fold.detail
    stage = [r for r in recs if r.phase == "agg.stage"]
    assert sum(r.nbytes for r in stage) == 2 * LAZY_ELEMS * 2  # the two peers' bf16 bytes
    assert all(r.party == "alice" for r in recs if r.phase.startswith("agg."))


def test_codec_spans_carry_nbytes():
    rec = telemetry.install(party="alice")
    tree = {"a": torch.ones(10), "b": torch.zeros(6)}
    packed = compression.compress(tree, packed=True)
    back = compression.decompress(packed)
    cast = compression.compress(tree)
    compression.decompress(cast)
    assert torch.equal(back["a"], tree["a"])
    spans = [(r.phase, r.nbytes, r.party) for r in rec.records()]
    assert spans == [("codec.compress", 32, "alice"), ("codec.decompress", 32, "alice"),
                     ("codec.compress", 32, "alice"), ("codec.decompress", 32, "alice")]


# ---------------------------------------------------------------------------
# Disarmed: nothing is made
# ---------------------------------------------------------------------------


def test_disarmed_sites_make_no_record_event_collector_or_thread(managers, monkeypatch):
    made = []
    real_event, real_stages, real_watch = torch.cuda.Event, telemetry.FrameSpans.__init__, \
        telemetry.FlightRecorder.watch

    def count(kind, real):
        def wrapped(*a, **k):
            made.append(kind)
            return real(*a, **k)
        return wrapped

    monkeypatch.setattr(torch.cuda, "Event", count("event", real_event))
    monkeypatch.setattr(telemetry.FrameSpans, "__init__", count("stages", real_stages))
    monkeypatch.setattr(telemetry.FlightRecorder, "watch", count("watch", real_watch))
    monkeypatch.setattr(telemetry.FlightRecorder, "emit", count("emit", telemetry.FlightRecorder.emit))
    assert telemetry.active() is None
    contribs = {p: compression.compress({"w": torch.full((LAZY_ELEMS,), 1.0)}, packed=True) for p in managers}
    _stream_round(managers, 0, contribs)
    _exchange(managers, 1, torch.ones(LAZY_ELEMS), stream=False)
    actor = ActorInstance(Trainer, (), {}, name="t", party="bob")
    try:
        actor.call_method("train", (np.ones(2),), {}).resolve(timeout=30)
    finally:
        actor.kill()
    compression.decompress(contribs["alice"])
    assert made == []
    assert telemetry.installed() is None
    assert not [t for t in threading.enumerate() if t.name == "rayfed-trace-watch"]


# ---------------------------------------------------------------------------
# Record budget
# ---------------------------------------------------------------------------


def test_records_per_round_stay_under_the_ring_budget():
    """A 4-party streaming round at the coordinator and at a peer, with the
    local step as an actor call and its codec: every party's records a
    round stay under the share of the default ring that a 50 s traced
    window of about 90 rounds leaves each round."""
    parties = ("alice", "bob", "carol", "dave")
    mgrs = _managers(parties)
    rec = telemetry.install()
    actors = {p: ActorInstance(TreeTrainer, (), {}, name=p, party=p) for p in parties}
    rounds = 4
    try:
        model = compression.compress({"w": torch.zeros(LAZY_ELEMS)}, packed=True)
        _stream_round(mgrs, -1, {p: model for p in parties})  # warm-up: the delta caches
        n0 = {p: sum(r.party == p for r in rec.records()) for p in parties}
        for r in range(rounds):
            contribs = {}
            for p in parties:
                local = compression.decompress(model)
                local = actors[p].call_method("train", (local,), {}).resolve(timeout=30)
                contribs[p] = compression.compress(local, packed=True)
            model = _stream_round(mgrs, r, contribs)
        _settle(rec, "wire.send", 0)
        time.sleep(0.2)
    finally:
        for a in actors.values():
            a.kill()
        for m in mgrs.values():
            m.stop()
    recs = rec.records()
    assert rec.stats()["trace_dropped"] == 0
    for p in parties:
        per_round = (sum(r.party == p for r in recs) - n0[p]) / rounds
        assert 0 < per_round <= RECORDS_PER_ROUND, (p, per_round)


# ---------------------------------------------------------------------------
# The profiler capture's clock anchor
# ---------------------------------------------------------------------------


def test_profile_anchor_maps_profiler_spans_onto_the_recorder_clock(tmp_path):
    from torch.profiler import record_function

    from rayfed_tpu_torch import metrics

    rec = telemetry.install(party="alice")
    metrics.start_profile(str(tmp_path))
    try:
        torch.ones(64).sum()
        with record_function("probe"):
            t_probe = time.time()
    finally:
        metrics.stop_profile()
    (anchor,) = [r for r in rec.records() if r.phase == "clock.anchor"]
    assert anchor.detail["label"] == metrics.PROFILE_ANCHOR
    (path,) = glob.glob(str(tmp_path / "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    (mark,) = [e for e in events if e.get("name") == metrics.PROFILE_ANCHOR and e.get("ph") == "X"]
    (probe,) = [e for e in events if e.get("name") == "probe" and e.get("ph") == "X"]
    offset_us = anchor.detail["t_ns"] / 1e3 - mark["ts"]
    assert abs((probe["ts"] + offset_us) / 1e6 - t_probe) < 1e-3


def test_profile_anchor_disarmed_leaves_no_marker(tmp_path):
    from rayfed_tpu_torch import metrics

    assert telemetry.clock_anchor("x") is None
    metrics.start_profile(str(tmp_path))
    metrics.stop_profile()
    (path,) = glob.glob(str(tmp_path / "*.json"))
    with open(path) as f:
        assert not [e for e in json.load(f)["traceEvents"] if e.get("name") == metrics.PROFILE_ANCHOR]


# ---------------------------------------------------------------------------
# On the card: exec.device and wire.device_wait cover a long kernel
# ---------------------------------------------------------------------------

SPIN_CYCLES = 1_000_000_000  # ~0.5 s of one SM spinning


@pytest.mark.gpu
def test_device_spans_cover_a_long_kernel(managers):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cuda = torch.device("cuda", torch.cuda.current_device())
    # Warm the link first: its first send opens the connections and loads
    # the native writer, which takes longer than the spin.
    _exchange(managers, 0, torch.ones(LAZY_ELEMS, device=cuda), stream=False)
    torch.cuda.synchronize()
    rec = telemetry.install()
    ex = TaskExecutor(max_workers=1, party="bob")
    try:
        def step():
            x = torch.zeros(LAZY_ELEMS, device=cuda)
            torch.cuda._sleep(SPIN_CYCLES)
            x.fill_(3.0)
            return x

        ref = ex.submit(step, (), {})
        t_issued = time.time()
        x = ref.resolve(timeout=60)
        assert not torch.cuda.default_stream(cuda).query(), "the spin ended first; raise SPIN_CYCLES"
        out = managers["bob"].send("alice", ref, "k", "0")
        got = managers["alice"].recv("bob", "k", "0").resolve(timeout=60)
        assert out.resolve(timeout=60)
        t_done = time.time()
        assert bool((torch.as_tensor(got) == 3.0).all()) and x.is_cuda
    finally:
        ex.shutdown()
    _settle(rec, "exec.device", 1)
    (call,) = [r for r in rec.records() if r.phase == "exec.call"]
    (device,) = [r for r in rec.records() if r.phase == "exec.device"]
    assert device.detail["fn"] == "step" and device.party == "bob"
    assert abs(device.t_start - _end(call)) < 1e-3
    assert device.dur_s >= 0.1 and _end(device) <= t_done
    (wait,) = [r for r in rec.records() if r.phase == "wire.device_wait"]
    assert wait.party == "bob" and wait.peer == "alice"
    # The copy to the host waited for the spin: the wait ends with the card's work.
    seen = (t_issued, call, device, wait)
    assert wait.dur_s >= 0.05 and abs(_end(wait) - _end(device)) < 0.05, seen
    assert t_issued < _end(wait), seen
