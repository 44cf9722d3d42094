"""Deterministic chaos injection for the transport and round drivers.

Every fault story this framework claims to survive — stragglers past the
round deadline, a party crashing mid-round, a dropped or corrupted frame,
a dead rail, a leader dying under a multi-host party — must be
*exercisable on demand* or the claim rots.  This module is the single
switchboard: a **seeded fault schedule** installed per process (or per
in-process simulated party) fires at **named hook points** threaded
through the transport client/server/manager and the federated round
driver.  With no schedule installed every hook is one ``is None`` check —
production pays nothing.

Activation:

- ``RAYFED_CHAOS`` environment variable holding the JSON schedule —
  picked up by :func:`maybe_install_from_env` (called from ``fed.init``);
- or :func:`install` directly from tests/benches (supports multiple
  in-process simulated parties because every rule carries a ``party``
  filter and every hook site reports the acting party).

Schedule format::

    {
      "seed": 0,
      "rules": [
        {"hook": "round", "party": "carol", "match": {"round": 1},
         "op": "delay_ms", "value": 4000},
        {"hook": "round", "party": "dave", "match": {"round": 1},
         "op": "crash_party"},
        {"hook": "frame", "party": "alice", "match": {"dest": "bob"},
         "count": 1, "op": "corrupt_crc"}
      ]
    }

Rule fields:

- ``hook``: one of the :data:`HOOKS` catalog below.
- ``party``: only fire in the party named (omit = any).  In-process
  multi-party simulations pass the acting party at every hook site, so
  one process-global schedule drives all simulated parties.
- ``match``: exact-match filters against the hook's context fields
  (``round``, ``dest``, ``src``, ``up`` ...); ``stream`` matches by
  ``fnmatch`` glob.  Omitted fields match anything.
- ``after``: skip the first N matching events (default 0).
- ``count``: fire at most N times (default 1; ``null`` = unbounded).
- ``op`` + ``value``: the fault (see below).

Ops:

- ``delay_ms`` — sleep ``value`` ms (or draw uniformly from a two-element
  ``[lo, hi]`` with the schedule's seeded rng: deterministic per rule).
  At async hook sites the sleep is awaited, so only the injected path
  stalls, not the whole event loop.
- ``drop_frame`` — raise :class:`ChaosFault` (a ``ConnectionError``
  subclass, so client retry arms treat it exactly like a lost wire).
- ``corrupt_crc`` — flip the low bit of the frame's declared checksum
  (``ctx["header"]``: ``crc``/``ccrc``) so the receiver's verification
  fails and the sender's retry path runs.  The payload bytes are never
  touched — injected corruption must not poison a reused send arena.
- ``kill_rail`` — raise ``ConnectionResetError`` (connection-open and
  per-frame sites: one rail dies, the payload-as-a-unit retry runs).
- ``crash_party`` — raise :class:`ChaosPartyCrash`.  Only meaningful at
  driver-level hooks (``round``, ``announce``): the test/bench harness
  turns it into a hard process exit (or, in-process, an abrupt
  transport stop) so peers see sockets die, not a graceful goodbye.
- ``local_slowdown`` — a per-party COMPUTE-delay **multiplier** at the
  ``local_step`` hook: the hook site reports how long the party's local
  step actually took (``baseline_s``), and the rule stretches it to
  ``value`` times that (sleeping ``baseline_s * (value - 1)``).
  ``value`` is the multiplier (or a two-element ``[lo, hi]`` drawn
  uniformly from the rule's seeded rng — deterministic per rule, so a
  "2-10x straggler spread" schedule replays identically).  Unlike
  ``delay_ms`` (an absolute stall), a multiplier scales with the real
  compute, which is what heterogeneous-device fleets look like — the
  async round gate and the quorum/hierarchy straggler tests share one
  schedule format.  Persists by default (``count`` unbounded): a slow
  device stays slow.
- ``partition`` — bidirectional frame drop between the two parties
  named by ``value: [a, b]``.  Fires at the ``wire`` hook (every
  client-side frame incl. health pings and handshakes, and every
  server-side received frame), so to BOTH endpoints the partner looks
  exactly dead — pings time out, sends fail, arriving frames are
  discarded without a reply — while both processes stay alive.  Unlike
  the other ops a partition persists (``count`` defaults to
  unbounded); scope it with ``after``/``count`` to heal it.

Hook catalog (:data:`HOOKS`) — ``hook name: (site, context fields)``:

- ``connect`` — ``TransportClient._open_conn`` before dialing
  (``dest``): ``delay_ms``, ``kill_rail``.
- ``send`` — ``TransportClient.send_data`` entry (``dest``, ``stream``,
  ``up``, ``down``): ``delay_ms``, ``drop_frame``.
- ``frame`` — ``TransportClient._roundtrip`` before a DATA frame's bytes
  hit the socket (``dest``, ``header`` mutable): ``delay_ms``,
  ``drop_frame``, ``corrupt_crc``, ``kill_rail``.
- ``wire`` — EVERY client-side frame (``TransportClient._roundtrip``
  entry: data, pings, handshakes; ``dest``, ``type``) and every
  server-side received frame (``src``, ``type``): ``partition``,
  ``drop_frame``, ``delay_ms`` (client side only — the receive side is
  a sync event-loop callback, so a matched delay there is logged and
  SKIPPED rather than stalling every peer's frames).  The
  asymmetric-connectivity hook — a rule here starves the health
  monitor's pings too, which ``frame`` (data frames only) cannot.
- ``server_frame`` — ``TransportServer`` dispatch of a received DATA
  frame (``src``, ``up``, ``down``): ``drop_frame`` (frame discarded
  without an ACK — the sender times out and retries).
- ``round`` — the federated round driver at each round boundary
  (``round``): ``delay_ms`` (a straggler), ``crash_party``.
- ``announce`` — the quorum coordinator between the round cutoff and
  its result/announce broadcast (``round``, ``epoch``): ``delay_ms``,
  ``crash_party``.  The nastiest failover window: the round is decided
  but nobody has heard — killing the coordinator HERE forces the
  successor to re-establish the round from re-pushed contributions.
- ``republish`` — the multi-host leader's bridge republish
  (``pid``, ``up``, ``down``): ``drop_frame``, ``delay_ms``.
- ``local_step`` — a party's local-compute step boundary (the async
  round loop's virtual parties, reusable by any driver that measures
  its own compute): context carries ``round`` (or ``version``) and
  ``baseline_s`` — the measured duration of the step just taken.
  ``local_slowdown`` (multiplier), ``delay_ms``, ``crash_party``.
"""

from __future__ import annotations

import fnmatch
import json
import logging
import random
import threading
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

ENV_VAR = "RAYFED_CHAOS"

HOOKS = (
    "connect", "send", "frame", "wire", "server_frame", "round",
    "announce", "republish",
    # Secure aggregation (fl.secagg): fires on the quorum coordinator
    # between the cutoff pinning the member set and the mask-recovery
    # announcement — killing it there leaves the survivors parked on
    # the recovery round trip with no poison coming, the nastiest
    # secure-round window (only failover can finish the round, and the
    # successor must re-run recovery on its own stream).
    "secagg_recovery",
    # A party's local-compute step boundary (async virtual parties and
    # any driver that measures its own compute) — the hook that makes
    # deterministic heterogeneous-speed fleets (2-10x straggler spread)
    # first-class via the local_slowdown multiplier op.
    "local_step",
)

_OPS = (
    "delay_ms", "drop_frame", "corrupt_crc", "kill_rail", "crash_party",
    "partition", "local_slowdown",
)


class ChaosFault(ConnectionError):
    """An injected transport fault (retryable, like a lost wire)."""


class ChaosPartyCrash(BaseException):
    """An injected party crash.

    Subclasses ``BaseException`` so no retry ladder or broad
    ``except Exception`` swallows it — a crash must unwind the whole
    driver, the way a real SIGKILL would.  Raised only from driver-level
    hooks (``round``); the harness decides how hard to die
    (``os._exit`` in subprocess harnesses, an abrupt transport stop
    in-process).
    """


class _Rule:
    __slots__ = (
        "hook", "party", "match", "after", "count", "op", "value",
        "fired", "seen", "rng",
    )

    def __init__(self, spec: Dict[str, Any], index: int, seed: int) -> None:
        self.hook = spec["hook"]
        if self.hook not in HOOKS:
            raise ValueError(
                f"unknown chaos hook {self.hook!r}; known: {HOOKS}"
            )
        self.op = spec["op"]
        if self.op not in _OPS:
            raise ValueError(
                f"unknown chaos op {self.op!r}; known: {_OPS}"
            )
        self.party = spec.get("party")
        self.match = dict(spec.get("match") or {})
        self.after = int(spec.get("after", 0))
        # A partition is a standing condition, not an event — it stays
        # up until explicitly bounded (count) or uninstalled.  So is a
        # local_slowdown: a slow device stays slow.
        count = spec.get(
            "count",
            None if self.op in ("partition", "local_slowdown") else 1,
        )
        self.count = None if count is None else int(count)
        self.value = spec.get("value")
        if self.op == "partition":
            if (
                not isinstance(self.value, (list, tuple))
                or len(self.value) != 2
                or len(set(map(str, self.value))) != 2
            ):
                raise ValueError(
                    "partition op needs value=[party_a, party_b] naming "
                    f"two distinct parties, got {self.value!r}"
                )
            self.value = [str(p) for p in self.value]
        if self.op == "local_slowdown":
            v = self.value
            ok = (
                isinstance(v, (int, float)) and float(v) >= 1.0
            ) or (
                isinstance(v, (list, tuple)) and len(v) == 2
                and all(isinstance(x, (int, float)) for x in v)
                and 1.0 <= float(v[0]) <= float(v[1])
            )
            if not ok:
                raise ValueError(
                    "local_slowdown op needs value=<multiplier >= 1> or "
                    f"value=[lo, hi] with 1 <= lo <= hi, got {v!r}"
                )
        self.seen = 0
        self.fired = 0
        # Rule-local deterministic rng (e.g. delay drawn from [lo, hi]):
        # independent of firing order across rules.
        self.rng = random.Random((int(seed) << 8) ^ index)

    def matches(self, party: Optional[str], ctx: Dict[str, Any]) -> bool:
        if self.party is not None and party != self.party:
            return False
        if self.op == "partition":
            # Bidirectional: the event is on the cut link iff the acting
            # party and its wire partner (dest on the client side, src on
            # the server side) are exactly the named pair.
            partner = ctx.get("dest", ctx.get("src"))
            if partner is None or {party, partner} != set(self.value):
                return False
        for key, want in self.match.items():
            got = ctx.get(key)
            if key == "stream":
                if not isinstance(got, str) or not fnmatch.fnmatch(
                    got, str(want)
                ):
                    return False
            elif got != want:
                return False
        return True

    def delay_s(self) -> float:
        v = self.value
        if isinstance(v, (list, tuple)) and len(v) == 2:
            v = self.rng.uniform(float(v[0]), float(v[1]))
        return float(v or 0) / 1e3

    def slowdown(self) -> float:
        """The compute-delay multiplier (seeded draw for [lo, hi])."""
        v = self.value
        if isinstance(v, (list, tuple)) and len(v) == 2:
            v = self.rng.uniform(float(v[0]), float(v[1]))
        return max(1.0, float(v))


class ChaosSchedule:
    """A parsed, counter-tracking fault schedule (thread-safe)."""

    def __init__(self, spec: Dict[str, Any]) -> None:
        seed = int(spec.get("seed", 0))
        self.seed = seed
        self.rules: List[_Rule] = [
            _Rule(r, i, seed) for i, r in enumerate(spec.get("rules", []))
        ]
        self._lock = threading.Lock()

    def pick(self, hook: str, party: Optional[str], ctx: Dict[str, Any]):
        """The first armed rule matching this event, advancing counters."""
        with self._lock:
            for rule in self.rules:
                if rule.hook != hook or not rule.matches(party, ctx):
                    continue
                rule.seen += 1
                if rule.seen <= rule.after:
                    continue
                if rule.count is not None and rule.fired >= rule.count:
                    continue
                rule.fired += 1
                return rule
        return None


_ACTIVE: Optional[ChaosSchedule] = None


def install(spec: Any) -> ChaosSchedule:
    """Install a schedule process-wide (dict or JSON string)."""
    global _ACTIVE
    if isinstance(spec, str):
        spec = json.loads(spec)
    sched = spec if isinstance(spec, ChaosSchedule) else ChaosSchedule(spec)
    _ACTIVE = sched
    logger.warning(
        "CHAOS schedule installed (%d rules, seed %d) — fault injection "
        "is ACTIVE in this process", len(sched.rules), sched.seed,
    )
    return sched


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def installed() -> Optional[ChaosSchedule]:
    return _ACTIVE


def maybe_install_from_env() -> Optional[ChaosSchedule]:
    """Install from ``RAYFED_CHAOS`` if set (idempotent; ``fed.init``
    calls this so subprocess harnesses configure chaos via env)."""
    import os

    if _ACTIVE is not None:
        return _ACTIVE
    raw = os.environ.get(ENV_VAR)
    if not raw:
        return None
    return install(raw)


def _apply(rule: _Rule, hook: str, party: Optional[str],
           ctx: Dict[str, Any]) -> Optional[float]:
    """Apply a rule's non-sleep effect; returns seconds to sleep (the
    caller sleeps — sync sites block the thread, async sites await)."""
    label = f"chaos[{hook}:{rule.op}]"
    # Flight recorder: every FIRED fault lands on the same timeline as
    # the failover/cutoff it causes (rayfed_tpu_torch/telemetry.py) — an
    # injected partition appears NEXT to the death declaration it
    # triggered.  Cost: this runs only when a rule actually fires, and
    # the emit is a nonblocking ring append (standing partitions fire
    # per frame; their event is ring-bounded like any other record).
    from rayfed_tpu_torch import telemetry as _telemetry

    _rec = _telemetry.active()
    if _rec is not None:
        _rec.emit(
            f"chaos.{rule.op}", party=party,
            t_start=time.time(),
            round=ctx.get("round"), epoch=ctx.get("epoch"),
            peer=ctx.get("dest", ctx.get("src")),
            stream=ctx.get("stream"),
            outcome="injected",
            detail={"hook": hook, **_ctx_brief(ctx)},
        )
    if rule.op == "delay_ms":
        delay = rule.delay_s()
        logger.warning("%s party=%s delaying %.0f ms (ctx=%s)",
                       label, party, delay * 1e3, _ctx_brief(ctx))
        return delay
    if rule.op == "local_slowdown":
        # Multiplier semantics: the hook site reports how long the local
        # step ACTUALLY took (baseline_s); stretching it to m x means
        # sleeping the remaining (m - 1) share.  A site that passes no
        # baseline gets no stall (logged) — absolute stalls are what
        # delay_ms is for.
        mult = rule.slowdown()
        base = float(ctx.get("baseline_s") or 0.0)
        stall = max(0.0, base * (mult - 1.0))
        if rule.fired <= 3 or base <= 0.0:
            logger.warning(
                "%s party=%s x%.2f over baseline %.3fs -> stalling "
                "%.3fs (ctx=%s)", label, party, mult, base, stall,
                _ctx_brief(ctx),
            )
        return stall
    if rule.op == "partition":
        # A standing partition fires on every frame — log its onset, not
        # a warning per dropped ping.
        if rule.fired == 1:
            logger.warning("%s party=%s up (ctx=%s)", label, party,
                           _ctx_brief(ctx))
        raise ChaosFault(
            f"{label}: link between {rule.value[0]!r} and "
            f"{rule.value[1]!r} is partitioned"
        )
    logger.warning("%s party=%s firing (ctx=%s)", label, party,
                   _ctx_brief(ctx))
    if rule.op == "drop_frame":
        raise ChaosFault(f"{label}: injected frame drop")
    if rule.op == "kill_rail":
        raise ConnectionResetError(f"{label}: injected rail death")
    if rule.op == "crash_party":
        raise ChaosPartyCrash(f"{label}: injected crash of {party!r}")
    if rule.op == "corrupt_crc":
        header = ctx.get("header")
        if isinstance(header, dict):
            if isinstance(header.get("ccrc"), list) and header["ccrc"]:
                header["ccrc"] = [header["ccrc"][0] ^ 1] + header["ccrc"][1:]
            elif "crc" in header:
                header["crc"] = int(header["crc"]) ^ 1
            else:
                # No checksum on this frame — declare a wrong one so the
                # receiver still exercises its mismatch path.
                header["crc"] = 1
    return None


def _ctx_brief(ctx: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in ctx.items() if k != "header"}


def fire(hook: str, party: Optional[str] = None, **ctx: Any) -> None:
    """Synchronous hook point.  No-op (one attribute read) without an
    installed schedule.  May sleep the calling thread, mutate
    ``ctx["header"]``, or raise the injected fault."""
    sched = _ACTIVE
    if sched is None:
        return
    rule = sched.pick(hook, party, ctx)
    if rule is None:
        return
    delay = _apply(rule, hook, party, ctx)
    if delay:
        # fedlint: disable=FED001 — sleeping is this hook's PURPOSE (injected stall on the calling worker thread); every event-loop call site uses fire_async (awaited) or fire_nonblocking (delay skipped), the split FED001 itself polices
        time.sleep(delay)


def fire_nonblocking(hook: str, party: Optional[str] = None,
                     **ctx: Any) -> None:
    """:func:`fire` for SYNCHRONOUS event-loop callbacks that must never
    sleep (the server's frame dispatch): drop/partition faults raise as
    usual, but a matched ``delay_ms`` is counted, logged and SKIPPED —
    sleeping there would stall every peer sharing the loop, injecting
    cascading faults the schedule never specified."""
    sched = _ACTIVE
    if sched is None:
        return
    rule = sched.pick(hook, party, ctx)
    if rule is None:
        return
    delay = _apply(rule, hook, party, ctx)
    if delay:
        logger.warning(
            "chaos[%s:delay_ms] party=%s matched a non-blocking hook "
            "site — the delay is SKIPPED (this site runs on the "
            "receiver's event loop; inject delays on the sender side "
            "instead)", hook, party,
        )


async def fire_async(hook: str, party: Optional[str] = None,
                     **ctx: Any) -> None:
    """Awaitable twin of :func:`fire` for event-loop hook sites — an
    injected delay parks only this coroutine, never the loop."""
    sched = _ACTIVE
    if sched is None:
        return
    rule = sched.pick(hook, party, ctx)
    if rule is None:
        return
    delay = _apply(rule, hook, party, ctx)
    if delay:
        import asyncio

        await asyncio.sleep(delay)
