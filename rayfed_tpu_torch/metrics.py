"""Metrics, per-transfer instrumentation, and profiler hooks.

The reference keeps only two op counters on its proxy actors
(``_stats["send_op_count"]`` / ``_stats["receive_op_count"]``,
``barriers.py:200,296``) exposed via ``_get_stats``.  Here observability
is a real subsystem, in three layers:

- **counters** — :func:`get_stats` (aggregate runtime stats: op counts,
  bytes, seconds, effective GB/s, pending recvs, crc errors, the
  send-path stage breakdown, plus the ``secagg`` / ``object_plane`` /
  ``telemetry`` sections) and :func:`metrics_snapshot`, which gathers
  every subsystem's counters under ONE documented schema
  (:data:`METRICS_SCHEMA` — schema drift fails CI the way wire drift
  does, see ``tests/test_telemetry.py``);
- **per-transfer records** — :class:`TransferLog`, a bounded ring of
  (peer, seq ids, bytes, seconds) per transfer.  One log lives on each
  ``TransportManager`` (``transport.transfer_log``) so in-process
  multi-party tests/benches don't conflate parties;
  :func:`get_transfer_log` resolves the current runtime's log and
  keeps the module-global ring only as a documented runtime-less
  fallback;
- **span traces** — the federated flight recorder
  (:mod:`rayfed_tpu_torch.telemetry`): structured cross-party span/event
  records, merged timelines (Perfetto export), and critical-path round
  reports (``tool/trace_report.py``).  :func:`trace_span` /
  :func:`start_profile` / :func:`stop_profile` remain the thin
  ``torch.profiler`` hooks for on-device (CUDA) timelines — the flight
  recorder covers the cross-party protocol layer those never see.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Any, Dict, Optional

import torch

from rayfed_tpu_torch import telemetry
from rayfed_tpu_torch.runtime import get_runtime_or_none

# The name of start_profile's clock marker in the trace it captures.
PROFILE_ANCHOR = "rayfed.clock_anchor"

TransferRecord = collections.namedtuple(
    "TransferRecord", ["direction", "peer", "up_id", "down_id", "nbytes", "seconds"]
)


class TransferLog:
    """Bounded ring of per-transfer records (thread-safe)."""

    def __init__(self, capacity: int = 1024) -> None:
        self._records: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._total = 0  # monotonic count of all records ever appended

    def record(self, direction, peer, up_id, down_id, nbytes, seconds) -> None:
        with self._lock:
            self._records.append(
                TransferRecord(direction, peer, str(up_id), str(down_id),
                               int(nbytes), float(seconds))
            )
            self._total += 1

    def records(self):
        with self._lock:
            return list(self._records)

    @property
    def total_recorded(self) -> int:
        """Monotonic append count — unlike ``len(records())``, never
        capped by the ring, so windows can be delimited correctly."""
        with self._lock:
            return self._total

    def records_since(self, total_before: int):
        """(records appended after the ``total_recorded`` snapshot,
        complete_flag).  ``complete_flag`` is False when the ring evicted
        part of the window — callers must not present a partial window
        as a full decomposition."""
        with self._lock:
            delta = self._total - total_before
            recs = list(self._records)
        if delta <= 0:
            return [], True
        if delta > len(recs):
            return recs, False
        return recs[-delta:], True

    def throughput_gbps(self, direction: Optional[str] = None) -> float:
        recs = [
            r for r in self.records()
            if (direction is None or r.direction == direction) and r.seconds > 0
        ]
        if not recs:
            return 0.0
        return sum(r.nbytes for r in recs) / sum(r.seconds for r in recs) / 1e9


# Runtime-less fallback ONLY: every TransportManager owns its own
# TransferLog (``transport.transfer_log``), so in-process multi-party
# tests/benches record each party's transfers into its own ring.  This
# module-global ring is what :func:`get_transfer_log` returns when no
# runtime (or no transport) exists in the process — e.g. unit tests of
# the log itself.
_global_transfer_log = TransferLog()


def get_transfer_log() -> TransferLog:
    """The CURRENT runtime's per-manager transfer log, falling back to
    the documented module-global ring when no runtime/transport exists.

    In-process simulations holding several managers should read each
    manager's ``transfer_log`` attribute directly — this accessor is
    the one-party (one runtime per process) convenience."""
    runtime = get_runtime_or_none()
    transport = getattr(runtime, "transport", None)
    log = getattr(transport, "transfer_log", None)
    if log is not None:
        return log
    return _global_transfer_log


def get_stats() -> Dict[str, Any]:
    """Aggregate stats for the current party's runtime.

    Superset of the reference's proxy ``_get_stats``: send/receive op
    counts plus bytes, wall seconds, and effective send GB/s.
    """
    runtime = get_runtime_or_none()
    if runtime is None or getattr(runtime, "transport", None) is None:
        return {}
    stats = dict(runtime.transport.get_stats())
    secs = stats.get("send_seconds", 0.0)
    stats["send_gbps"] = (stats.get("send_bytes", 0) / secs / 1e9) if secs else 0.0
    return stats


# The documented shape of :func:`metrics_snapshot`: section → {key →
# type}.  A key listed here MUST exist in the section with that type —
# ``tests/test_telemetry.py::test_metrics_snapshot_schema`` asserts it,
# so renaming/retyping a counter fails CI the way wire-format drift
# does.  Sections may carry ADDITIONAL keys freely; only removals and
# retypes of the documented surface break the contract.
METRICS_SCHEMA: Dict[str, Dict[str, type]] = {
    "transport": {
        "send_op_count": int,
        "send_bytes": int,
        "send_seconds": float,
        "send_gbps": float,
        "pending_recvs": int,
        "send_path_breakdown_ms": dict,
        "delta_bytes_saved_frac": float,
        "send_dest_seconds": dict,
        "dead_parties": list,
    },
    "secagg": {
        "kex": str,
        "prg": str,
        "peers": dict,
    },
    "object_plane": {
        "blob_cache_hits": int,
        "blob_cache_misses": int,
        "blob_fetches": int,
        "blob_fetch_bytes": int,
        "blob_serves": int,
        "blob_cache_bytes": int,
        "blob_pinned_bytes": int,
    },
    "quorum": {
        "coordinator_failovers": int,
        "graceful_handovers": int,
    },
    "async": {
        # fl.async_rounds: buffered asynchronous rounds.  The histogram
        # maps decay shift (min(staleness, cap)) -> folds;
        # decay_shift_total is the summed shifts (how much weight the
        # fleet's staleness cost, in halvings).
        "versions_emitted": int,
        "folds": int,
        "buffer_occupancy": int,
        "staleness_hist": dict,
        "decay_shift_total": int,
        "dropped_decayed_out": int,
        "recoded_stale": int,
    },
    "telemetry": {
        "trace_armed": bool,
    },
}


def metrics_snapshot() -> Dict[str, Any]:
    """Every subsystem's counters under ONE documented schema
    (:data:`METRICS_SCHEMA`): ``transport`` (the :func:`get_stats`
    surface), ``secagg`` / ``object_plane`` / ``telemetry`` (hoisted
    from their get_stats sections), ``quorum``
    (``fl.quorum.QUORUM_STATS``) and ``async``
    (``fl.async_rounds.ASYNC_STATS``) — the last two live per process, not
    on the transport.  Returns ``{}`` before ``fed.init`` — a snapshot of
    nothing is not an error."""
    stats = get_stats()
    if not stats:
        return {}
    from rayfed_tpu_torch.fl.async_rounds import ASYNC_STATS
    from rayfed_tpu_torch.fl.quorum import QUORUM_STATS

    out: Dict[str, Any] = {
        "transport": {
            k: v for k, v in stats.items()
            if k not in ("secagg", "object_plane", "telemetry")
        },
        "secagg": dict(stats.get("secagg") or {}),
        "object_plane": dict(stats.get("object_plane") or {}),
        "telemetry": dict(stats.get("telemetry") or {}),
        "quorum": dict(QUORUM_STATS),
        # A copy of the histogram: the snapshot must not alias the live
        # counter dict the async driver keeps mutating.
        "async": {
            **ASYNC_STATS,
            "staleness_hist": dict(ASYNC_STATS["staleness_hist"]),
        },
    }
    return out


@contextlib.contextmanager
def trace_span(name: str, **kwargs):
    """Annotate a block on the torch profiler timeline (no-op cost when no
    trace is being captured).  ``kwargs`` are folded into the label, since
    ``record_function`` takes no metadata of its own."""
    label = name
    if kwargs:
        label += "(" + ",".join(f"{k}={v}" for k, v in sorted(kwargs.items())) + ")"
    with torch.profiler.record_function(label):
        yield


_profiler_lock = threading.Lock()
_profiler: Optional[Any] = None


def start_profile(log_dir: str) -> None:
    """Begin a torch profiler capture of the host and, where present, the
    CUDA card; :func:`stop_profile` writes it to ``log_dir`` as a
    TensorBoard/Perfetto-viewable trace.

    With the flight recorder armed the capture opens with a
    ``record_function`` marker at a recorded ``time.time_ns()``, kept in the
    ring as a ``clock.anchor`` event (:func:`telemetry.clock_anchor`), so
    the trace can be placed on the recorder's timeline."""
    global _profiler
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with _profiler_lock:
        if _profiler is not None:
            raise RuntimeError("a profiler capture is already running")
        prof = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
        )
        prof.start()
        _profiler = prof
        telemetry.clock_anchor(PROFILE_ANCHOR)


def stop_profile() -> None:
    global _profiler
    with _profiler_lock:
        prof, _profiler = _profiler, None
    if prof is None:
        raise RuntimeError("no profiler capture is running")
    prof.stop()


@contextlib.contextmanager
def timed(out: Dict[str, float], key: str):
    """Accumulate wall time of a block into ``out[key]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        out[key] = out.get(key, 0.0) + (time.perf_counter() - t0)
