"""Federated flight recorder — cross-party round tracing.

Diagnosing *why* a round was slow (or which party bounded the wall)
used to mean reading N party logs and mentally joining them by round
number.  This module is the join: a bounded, thread-safe ring of
structured **span records** fed by the named seams that already exist —
transport send phases, server delivery, mailbox waits, aggregation
fold/finalize, quorum cutoffs/failovers, ring/hierarchy phase
boundaries, overlap's hidden-comms window, object-plane pulls,
checkpoint save/restore — plus the chaos harness, so an injected
partition appears on the SAME timeline as the failover it caused.

Record shape (:data:`SPAN_FIELDS`)::

    (party, round, epoch, phase, peer, stream, nbytes,
     t_start, dur_s, outcome, detail)

``t_start`` is wall-clock epoch seconds (``time.time()``) so records
from different parties can be merged onto one timeline; ``dur_s`` is a
monotonic-clock duration.  ``phase`` is a dotted name whose first
segment is the subsystem (``wire.send``, ``agg.finalize``,
``quorum.failover``, ``chaos.partition`` ...); ``outcome`` is ``"ok"``
unless the instrumented operation failed/was cut off; ``detail`` is a
small JSON-safe dict (stage breakdowns, member sets, fault ops).

Cost discipline (the chaos-hook contract): with no recorder installed
every emission helper is ONE module-global read.  Armed, an emission is
a deque append under a lock held for exactly that append — never a
sleep, never I/O — so a span write from the transport's receive event
loop cannot stall frames (the ``chaos.fire_nonblocking`` discipline).

Arming:

- ``RAYFED_TRACE=1`` in the environment (picked up by ``fed.init`` via
  :func:`maybe_install_from_env`, like ``RAYFED_CHAOS``), or
- ``JobConfig.trace = True``, or
- :func:`install` directly from tests/benches.

Cross-party collection: :func:`rayfed_tpu_torch.api.trace_collect` pulls each
peer's ring window over the existing transport (an observer-consumed
request frame + a nonce-keyed DATA reply — the BLOB_GET shape), aligns
clocks with the NTP-style offset estimated from the request/reply round
trip (error bound ≤ RTT/2, see :func:`estimate_clock_offset`), and
merges everything into one timeline.  Renderers: :func:`to_trace_events`
(Chrome/Perfetto ``trace_event`` JSON) and ``tool/trace_report.py``
(text critical-path round reports).  See
``docs/source/observability.rst``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import queue
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# Version of the trace-collection protocol semantics: the request /
# reply-metadata schemas, the record field order, and the clock-offset
# estimation contract.  Like OBJECT_PLANE_VERSION this is a
# payload-level knob: bumping it re-pins ``tool/wire_format.lock``
# WITHOUT a WIRE_FORMAT_VERSION bump — the frame layout is untouched.
TELEMETRY_VERSION = 1

# Field order of one span record — the single cross-party contract for
# both the in-memory ring and the wire encoding (records travel as
# field LISTS in this order, not dicts, to keep reply payloads small).
SPAN_FIELDS = (
    "party", "round", "epoch", "phase", "peer", "stream", "nbytes",
    "t_start", "dur_s", "outcome", "detail",
)

SpanRecord = collections.namedtuple("SpanRecord", SPAN_FIELDS)

DEFAULT_TRACE_CAPACITY = 16384

ENV_VAR = "RAYFED_TRACE"


class FlightRecorder:
    """Bounded thread-safe ring of :class:`SpanRecord` (one per process,
    like the chaos schedule; every record carries its acting ``party``
    so in-process multi-party simulations attribute correctly)."""

    def __init__(
        self, party: Optional[str] = None,
        capacity: int = DEFAULT_TRACE_CAPACITY,
    ) -> None:
        self.party = party
        self.capacity = int(capacity)
        self._dq: collections.deque = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._total = 0  # monotonic append count (ring may evict)
        self.t_armed = time.time()
        # The device watcher (see watch): started by its first use.
        self._watch_q: Optional[queue.SimpleQueue] = None

    def emit(
        self,
        phase: str,
        *,
        t_start: Optional[float] = None,
        dur_s: float = 0.0,
        round: Optional[int] = None,
        epoch: Optional[int] = None,
        peer: Optional[str] = None,
        stream: Optional[str] = None,
        nbytes: int = 0,
        outcome: str = "ok",
        detail: Optional[Dict[str, Any]] = None,
        party: Optional[str] = None,
    ) -> None:
        """Append one record.  Lock held for the append only — callable
        from any thread including the transport event loop.  Never
        raises: a diagnostic must not be able to fail a round, so a
        malformed field degrades to a ``bad-record`` marker instead."""
        try:
            rec = SpanRecord(
                party=party if party is not None else self.party,
                round=None if round is None else int(round),
                epoch=None if epoch is None else int(epoch),
                phase=str(phase),
                peer=peer,
                stream=stream,
                nbytes=int(nbytes),
                t_start=(
                    float(t_start) if t_start is not None else time.time()
                ),
                dur_s=float(dur_s),
                outcome=str(outcome),
                detail=detail,
            )
        except Exception as exc:
            rec = SpanRecord(
                party=self.party, round=None, epoch=None, phase=str(phase),
                peer=None, stream=None, nbytes=0, t_start=time.time(),
                dur_s=0.0, outcome="bad-record",
                detail={"error": repr(exc)},
            )
        with self._lock:
            self._dq.append(rec)
            self._total += 1

    def watch(self, events: Sequence[Any], phase: str, t_start: float, **kw: Any) -> None:
        """Emit ``phase`` from ``t_start`` to the instant the card has run
        past every one of ``events`` (CUDA events recorded by the caller).

        One watcher thread per recorder, started here on first use, waits
        on the events in the order they were handed in and stamps the end
        when it wakes; the caller's thread never synchronises.  Events
        made with ``blocking=True`` let the watcher sleep instead of spin."""
        with self._lock:
            if self._watch_q is None:
                self._watch_q = queue.SimpleQueue()
                threading.Thread(
                    target=self._watch_loop, args=(self._watch_q,),
                    name="rayfed-trace-watch", daemon=True,
                ).start()
            q = self._watch_q
        q.put((events, phase, t_start, kw))

    def _watch_loop(self, q: queue.SimpleQueue) -> None:
        while True:
            item = q.get()
            if item is None:
                return
            events, phase, t_start, kw = item
            outcome = "ok"
            try:
                for ev in events:
                    ev.synchronize()
            except Exception:  # a failed device: the span still closes
                outcome = "error"
            self.emit(phase, t_start=t_start, dur_s=max(0.0, time.time() - t_start),
                      outcome=outcome, **kw)

    def close(self) -> None:
        """Stop the device watcher once it has emitted what it holds."""
        with self._lock:
            q, self._watch_q = self._watch_q, None
        if q is not None:
            q.put(None)

    def records(
        self, rounds: Any = None, party: Optional[str] = None,
    ) -> List[SpanRecord]:
        """Snapshot of the ring (oldest first).  ``rounds`` filters by
        round tag: an int keeps that round, a ``(lo, hi)`` pair keeps
        the inclusive range — records carrying NO round tag (mailbox
        waits, chaos wire faults, health events) are always kept, since
        a window without its untagged context would hide exactly the
        cross-cutting records the merge exists for."""
        with self._lock:
            recs = list(self._dq)
        if party is not None:
            recs = [r for r in recs if r.party == party]
        if rounds is None:
            return recs
        if isinstance(rounds, int):
            lo = hi = int(rounds)
        else:
            lo, hi = int(rounds[0]), int(rounds[1])
        return [
            r for r in recs if r.round is None or lo <= r.round <= hi
        ]

    def resize(self, capacity: int) -> None:
        """Rebound the ring, KEEPING the newest records that fit —
        ``fed.init(trace_capacity=)`` against an already-armed (e.g.
        env-armed) recorder must honor the explicit request instead of
        silently keeping the old bound."""
        capacity = int(capacity)
        if capacity < 1:
            raise ValueError(f"trace capacity must be >= 1, got {capacity}")
        with self._lock:
            if capacity == self.capacity:
                return
            self._dq = collections.deque(self._dq, maxlen=capacity)
            self.capacity = capacity

    @property
    def total_recorded(self) -> int:
        with self._lock:
            return self._total

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            n, total = len(self._dq), self._total
        return {
            "trace_armed": True,
            "trace_records": n,
            "trace_total_recorded": total,
            "trace_dropped": max(0, total - n),
            "trace_capacity": self.capacity,
        }


# ---------------------------------------------------------------------------
# Process-global arming (the chaos.install pattern)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FlightRecorder] = None


def install(
    party: Optional[str] = None,
    capacity: int = DEFAULT_TRACE_CAPACITY,
) -> FlightRecorder:
    """Arm the flight recorder process-wide; returns it.  Re-installing
    replaces the ring (tests that want a fresh window)."""
    global _ACTIVE
    old, _ACTIVE = _ACTIVE, FlightRecorder(party=party, capacity=capacity)
    if old is not None:
        old.close()
    return _ACTIVE


def uninstall() -> None:
    global _ACTIVE
    old, _ACTIVE = _ACTIVE, None
    if old is not None:
        old.close()


def installed() -> Optional[FlightRecorder]:
    return _ACTIVE


def active() -> Optional[FlightRecorder]:
    """The armed recorder or ``None`` — ONE global read.  Hot call
    sites hold the return value and skip all argument construction when
    disarmed."""
    return _ACTIVE


def armed() -> bool:
    return _ACTIVE is not None


def maybe_install_from_env(party: Optional[str] = None):
    """Arm from ``RAYFED_TRACE=1`` if set (``fed.init`` calls this, so
    subprocess harnesses arm via env like chaos).  Idempotent: an
    already-armed recorder is kept, but a recorder armed WITHOUT a
    party adopts ``party`` — env-armed rings exist before fed.init
    knows who this party is."""
    import os

    if _ACTIVE is not None:
        if party is not None and _ACTIVE.party is None:
            _ACTIVE.party = party
        return _ACTIVE
    raw = os.environ.get(ENV_VAR, "")
    if raw not in ("1", "true", "on", "yes"):
        return None
    cap = int(os.environ.get("RAYFED_TRACE_CAPACITY", DEFAULT_TRACE_CAPACITY))
    return install(party=party, capacity=cap)


def emit(phase: str, **kw: Any) -> None:
    """Module-level emission — a no-op (one global read) when disarmed."""
    rec = _ACTIVE
    if rec is None:
        return
    rec.emit(phase, **kw)


def event(phase: str, **kw: Any) -> None:
    """A zero-duration record stamped now (cutoffs, failovers, chaos)."""
    rec = _ACTIVE
    if rec is None:
        return
    rec.emit(phase, t_start=time.time(), dur_s=0.0, **kw)


def phase_spanner(prefix: str, **static_kw: Any):
    """The topology drivers' phase-boundary span helper: returns
    ``mark(name, t0, **kw) -> now_p`` emitting ``<prefix>.<name>``
    anchored by back-dating ``time.time()`` with the ``perf_counter``
    delta since ``t0`` (ONE anchoring rule for ring/hierarchy/future
    topologies, not N hand-rolled copies).  The armed check happens
    ONCE here — disarmed, the returned mark is a bare perf_counter
    read with zero argument construction."""
    rec = _ACTIVE
    if rec is None:
        return lambda name, t0, **kw: time.perf_counter()

    def mark(name: str, t0: float, **kw: Any) -> float:
        now_p = time.perf_counter()
        rec.emit(
            f"{prefix}.{name}",
            t_start=time.time() - (now_p - t0),
            dur_s=now_p - t0, **static_kw, **kw,
        )
        return now_p

    return mark


@contextlib.contextmanager
def span(phase: str, **kw: Any):
    """Time a block as one span.  Disarmed cost: one global read and a
    generator frame — use only at non-hot sites (per round / per pull /
    per checkpoint, not per frame)."""
    rec = _ACTIVE
    if rec is None:
        yield
        return
    t_wall = time.time()
    t0 = time.perf_counter()
    try:
        yield
    except BaseException:
        rec.emit(
            phase, t_start=t_wall, dur_s=time.perf_counter() - t0,
            outcome="error", **kw,
        )
        raise
    rec.emit(phase, t_start=t_wall, dur_s=time.perf_counter() - t0, **kw)


# Intervals of one stage closer than this merge into one record (the
# record budget: a payload's chunks run back to back).
STAGE_MERGE_S = 1e-4
# A stretch without a stage shorter than this is one thread's bookkeeping
# between two of its stages, not a wait: it is not recorded.
STAGE_GAP_MIN_S = 1e-5


class FrameSpans:
    """One payload frame's ``wire.frame`` span and its stage spans, gathered
    from every thread that runs a stage and emitted when the frame closes.

    The threads that wait on the card, copy to the host, checksum and write
    add their intervals with :meth:`add`, stamped with ``time.time()`` where
    each ran, and :meth:`close` emits ``wire.frame`` from its opening to the
    end of its last stage, each stage's intervals (those of a stage that lie
    within :data:`STAGE_MERGE_S` of each other as one record), and the
    stretches in which no stage ran (longer than :data:`STAGE_GAP_MIN_S`)
    as ``wire.loop_wait``.  Made by :func:`frame_spans` only when the
    recorder is armed."""

    __slots__ = ("rec", "tags", "t0", "iv")

    def __init__(self, rec: FlightRecorder, **tags: Any) -> None:
        self.rec, self.tags = rec, tags
        self.t0 = time.time()
        self.iv: List[Tuple[str, float, float]] = []  # list.append: thread-safe

    def add(self, phase: str, t0: float, t1: Optional[float] = None) -> None:
        self.iv.append((phase, t0, time.time() if t1 is None else t1))

    def close(self, nbytes: int = 0, outcome: str = "ok") -> None:
        ivs = sorted(self.iv, key=lambda x: x[1])
        end = max((b for _p, _a, b in ivs), default=time.time())
        emit = self.rec.emit
        emit("wire.frame", t_start=self.t0, dur_s=max(0.0, end - self.t0),
             nbytes=nbytes, outcome=outcome, **self.tags)
        runs: Dict[str, List[List[float]]] = {}
        t = self.t0
        for phase, a, b in ivs:
            if a - t > STAGE_GAP_MIN_S:
                _merge(runs.setdefault("wire.loop_wait", []), t, a)
            t = max(t, b)
            _merge(runs.setdefault(phase, []), a, b)
        for phase, spans in runs.items():
            for a, b in spans:
                emit(phase, t_start=a, dur_s=max(0.0, b - a), **self.tags)


def frame_spans(**tags: Any) -> Optional[FrameSpans]:
    """A frame's :class:`FrameSpans` with ``tags`` (party, peer, stream) on
    every record, or None with the recorder disarmed (one global read)."""
    rec = _ACTIVE
    return None if rec is None else FrameSpans(rec, **tags)


def _merge(out: List[List[float]], a: float, b: float) -> None:
    if out and a - out[-1][1] <= STAGE_MERGE_S:
        out[-1][1] = max(out[-1][1], b)
    else:
        out.append([a, b])


def clock_anchor(label: str) -> Optional[int]:
    """Tie a ``torch.profiler`` capture to the recorder's clock: a
    ``record_function(label)`` marker around a ``time.time_ns()`` reading,
    kept in the ring as a ``clock.anchor`` event whose ``detail`` holds the
    label and the reading.  A trace event named ``label`` then maps onto the
    recorder's timeline by ``t_ns / 1e3 - ts`` microseconds.  Disarmed: one
    global read, no marker; returns the reading or None."""
    rec = _ACTIVE
    if rec is None:
        return None
    from torch.profiler import record_function

    with record_function(f"{label}.warm"):  # a capture's first marker is slow to open
        pass
    with record_function(label):
        wall_ns = time.time_ns()
    rec.emit("clock.anchor", t_start=wall_ns / 1e9, detail={"label": label, "t_ns": wall_ns})
    return wall_ns


# ---------------------------------------------------------------------------
# Trace-collection schemas — single producers, fingerprinted by
# tool/check_wire_format.py (cross-party contracts riding ordinary
# frame metadata / payloads; no frame-layout change)
# ---------------------------------------------------------------------------


class TelemetryError(RuntimeError):
    """A trace collection could not complete or a schema was malformed."""


def make_trace_request(
    reply_key: str, rounds: Any = None, t_send: Optional[float] = None,
) -> Dict[str, Any]:
    """The ``wire.TRACE_GET_KEY`` frame-metadata value: asks a peer for
    its ring window, naming the reply rendezvous key the requester is
    already parked on (the BLOB_GET shape).  ``rounds``: None (whole
    ring), an int, or an inclusive ``[lo, hi]`` pair."""
    rnd: Optional[List[int]] = None
    if rounds is not None:
        if isinstance(rounds, int):
            rnd = [int(rounds), int(rounds)]
        else:
            rnd = [int(rounds[0]), int(rounds[1])]
    return {
        "v": int(TELEMETRY_VERSION),
        "rk": str(reply_key),
        "rnd": rnd,
        "ts": float(t_send if t_send is not None else time.time()),
    }


def check_trace_request(req: Any) -> Dict[str, Any]:
    if not isinstance(req, dict) or not isinstance(req.get("rk"), str):
        raise TelemetryError(f"malformed trace request: {req!r}")
    rnd = req.get("rnd")
    if rnd is not None and (
        not isinstance(rnd, (list, tuple)) or len(rnd) != 2
    ):
        raise TelemetryError(f"malformed trace request rounds: {req!r}")
    return {
        "v": int(req.get("v", 1)),
        "rk": req["rk"],
        "rnd": None if rnd is None else [int(rnd[0]), int(rnd[1])],
        "ts": float(req.get("ts", 0.0)),
    }


def make_trace_reply_meta(
    party: str, count: int, t_wall: Optional[float] = None,
    armed: bool = True, err: Optional[str] = None,
) -> Dict[str, Any]:
    """The ``wire.TRACE_PUT_KEY`` frame-metadata value: stamps a reply
    with the serving party, its record count, its wall clock at serve
    time (``tw`` — the clock-offset estimate's peer sample), and
    whether its recorder was armed at all (a disarmed peer replies an
    EMPTY window, loudly distinguishable from a quiet armed one).
    ``err`` names a serve-side failure (malformed request, encode
    error): the server replies it instead of staying silent, so the
    collector fails FAST with the real reason instead of waiting out
    its per-peer timeout (the object plane's holder-miss notice
    shape)."""
    return {
        "v": int(TELEMETRY_VERSION),
        "party": str(party),
        "n": int(count),
        "tw": float(t_wall if t_wall is not None else time.time()),
        "armed": bool(armed),
        "err": None if err is None else str(err),
    }


def check_trace_reply_meta(rep: Any) -> Dict[str, Any]:
    if not isinstance(rep, dict) or not isinstance(rep.get("party"), str):
        raise TelemetryError(f"malformed trace reply metadata: {rep!r}")
    err = rep.get("err")
    return {
        "v": int(rep.get("v", 1)),
        "party": rep["party"],
        "n": int(rep.get("n", 0)),
        "tw": float(rep.get("tw", 0.0)),
        "armed": bool(rep.get("armed", False)),
        "err": None if err is None else str(err),
    }


def _json_safe(value: Any) -> Any:
    """Coerce a detail payload to JSON-safe primitives (the wire
    encoding refuses nothing — a diagnostic must never fail a round)."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, dict):
        return {str(k): _json_safe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple, set, frozenset)):
        return [_json_safe(v) for v in value]
    return repr(value)


def record_to_list(rec: SpanRecord) -> list:
    """One record as a field LIST in :data:`SPAN_FIELDS` order — the
    wire/report interchange form."""
    return [
        rec.party, rec.round, rec.epoch, rec.phase, rec.peer, rec.stream,
        rec.nbytes, rec.t_start, rec.dur_s, rec.outcome,
        _json_safe(rec.detail),
    ]


def record_from_list(row: Sequence[Any]) -> SpanRecord:
    if len(row) != len(SPAN_FIELDS):
        raise TelemetryError(
            f"trace record carries {len(row)} fields, expected "
            f"{len(SPAN_FIELDS)} ({SPAN_FIELDS})"
        )
    return SpanRecord(*row)


def encode_records(records: Iterable[SpanRecord]) -> bytes:
    """The trace reply's payload bytes: compact JSON of field lists."""
    doc = {
        "v": int(TELEMETRY_VERSION),
        "fields": list(SPAN_FIELDS),
        "records": [record_to_list(r) for r in records],
    }
    return json.dumps(doc, separators=(",", ":")).encode()


def decode_records(data: Any) -> List[SpanRecord]:
    doc = json.loads(bytes(data))
    if int(doc.get("v", 1)) > TELEMETRY_VERSION:
        raise TelemetryError(
            f"trace payload uses telemetry protocol v{doc.get('v')}; "
            f"this party understands up to v{TELEMETRY_VERSION}"
        )
    if doc.get("fields") != list(SPAN_FIELDS):
        raise TelemetryError(
            f"trace payload field order {doc.get('fields')} != "
            f"{list(SPAN_FIELDS)}"
        )
    return [record_from_list(row) for row in doc.get("records", [])]


# ---------------------------------------------------------------------------
# Clock alignment + merge
# ---------------------------------------------------------------------------


def estimate_clock_offset(
    t_send: float, t_recv: float, t_peer: float,
) -> Dict[str, float]:
    """NTP-style one-exchange offset estimate from the trace-collection
    round trip itself (a control-frame exchange, the same machinery the
    health monitor's pings ride).

    ``offset_s`` is the peer's clock minus ours, assuming the peer
    stamped ``t_peer`` halfway through the round trip; mapping a peer
    timestamp onto our timeline is ``t_local = t_peer_stamp −
    offset_s``.  The documented error bound is ``rtt/2`` (the reply
    could have spent the whole round trip on either leg) — with
    loopback/datacenter RTTs of 0.1–2 ms, far finer than the
    millisecond-scale spans the report reasons about.
    """
    rtt = max(0.0, float(t_recv) - float(t_send))
    offset = float(t_peer) - (float(t_send) + float(t_recv)) / 2.0
    return {"offset_s": offset, "rtt_s": rtt, "bound_s": rtt / 2.0}


def merge_records(
    party_records: Dict[str, List[SpanRecord]],
    clock_offsets: Optional[Dict[str, Dict[str, float]]] = None,
) -> List[Dict[str, Any]]:
    """One timeline: every record as a dict with ``t_start`` mapped
    onto the COLLECTOR's clock (peer timestamps shifted by the
    estimated offset) and ``party`` filled from the map key when the
    record itself carries none, sorted by adjusted start time."""
    offsets = clock_offsets or {}
    merged: List[Dict[str, Any]] = []
    for party, recs in party_records.items():
        off = float(offsets.get(party, {}).get("offset_s", 0.0))
        for rec in recs:
            d = dict(zip(SPAN_FIELDS, record_to_list(rec)))
            if d["party"] is None:
                d["party"] = party
            d["t_start"] = float(d["t_start"]) - off
            merged.append(d)
    merged.sort(key=lambda d: d["t_start"])
    return merged


# ---------------------------------------------------------------------------
# Perfetto / Chrome trace_event export
# ---------------------------------------------------------------------------


def to_trace_events(
    merged: Sequence[Dict[str, Any]],
    clock_offsets: Optional[Dict[str, Dict[str, float]]] = None,
) -> Dict[str, Any]:
    """Chrome/Perfetto ``trace_event`` JSON for a merged timeline
    (:func:`merge_records` output, or any sequence of record dicts).

    One *process* per party (named via ``process_name`` metadata
    events), one *thread* per phase family (the dotted prefix:
    ``wire``, ``agg``, ``quorum`` ...).  Spans with a duration are
    complete ("X") events; zero-duration records are instants ("i").
    Timestamps are microseconds relative to the earliest record, so
    the timeline opens at t=0 in the Perfetto UI.
    """
    events: List[Dict[str, Any]] = []
    parties = sorted({str(d.get("party")) for d in merged})
    pid_of = {p: i + 1 for i, p in enumerate(parties)}
    tids: Dict[Tuple[str, str], int] = {}
    t0 = min((float(d["t_start"]) for d in merged), default=0.0)
    for p in parties:
        events.append({
            "name": "process_name", "ph": "M", "pid": pid_of[p], "tid": 0,
            "args": {"name": p},
        })
        off = (clock_offsets or {}).get(p)
        if off:
            events.append({
                "name": "clock_sync_bound", "ph": "M", "pid": pid_of[p],
                "tid": 0, "args": {k: round(v, 6) for k, v in off.items()},
            })
    for d in merged:
        p = str(d.get("party"))
        cat = str(d.get("phase", "")).split(".", 1)[0] or "misc"
        key = (p, cat)
        if key not in tids:
            tids[key] = len([k for k in tids if k[0] == p]) + 1
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid_of[p],
                "tid": tids[key], "args": {"name": cat},
            })
        args = {
            k: d.get(k)
            for k in ("round", "epoch", "peer", "stream", "outcome")
            if d.get(k) is not None
        }
        if d.get("nbytes"):
            args["nbytes"] = d["nbytes"]
        if d.get("detail") is not None:
            args["detail"] = _json_safe(d["detail"])
        ev: Dict[str, Any] = {
            "name": str(d.get("phase")),
            "cat": cat,
            "pid": pid_of[p],
            "tid": tids[key],
            "ts": round((float(d["t_start"]) - t0) * 1e6, 3),
            "args": args,
        }
        dur = float(d.get("dur_s") or 0.0)
        if dur > 0.0:
            ev["ph"] = "X"
            ev["dur"] = round(dur * 1e6, 3)
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}
