"""Either-side-first rendezvous mailbox.

Reproduces the reference's event-dict race discipline
(``barriers.py:61-90`` sender side vs ``:324-345`` receiver side): data may
arrive before anyone asked for it, or a receiver may park before the data
exists — whichever side arrives first creates the entry.  The reference
mixes ``threading.Lock`` with asyncio inside a Ray actor (flagged as a
wart at ``barriers.py:303``); here everything runs on a single asyncio
loop, so no locks are needed at all.

Hardening beyond the reference:

- **Duplicate-delivery dedup**: a retry after a lost ACK re-delivers the
  same (up, down) key; consumed keys are remembered (bounded LRU) and
  re-deliveries are dropped instead of leaking a never-consumed entry.
- **TTL garbage collection**: undelivered payloads nobody ever recvs are
  expired after ``ttl_s`` (default: off until the manager wires it to the
  job's timeout), bounding mailbox memory.
- **Recv deadline**: ``get(..., timeout_s=...)`` raises ``TimeoutError``
  instead of parking forever, so a dead peer surfaces as an error on
  ``fed.get`` rather than a hang.
- **Peer-death fail-fast**: :meth:`Mailbox.fail_party` poisons every
  parked waiter expecting a party (and, until
  :meth:`Mailbox.clear_party_failure`, any new waiter on it) with an
  error message, so the transport's health monitor can turn "connection
  lost / peer unreachable" into a prompt ``RemoteError`` on ``fed.get``
  instead of a park until the recv backstop.  The reference is blind
  here (``barriers.py:244-248`` swallows send failures into False and
  its consumer never learns).
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

Key = Tuple[str, str]  # (upstream_seq_id, downstream_seq_id)

# How many consumed keys to remember for duplicate-delivery detection.
_CONSUMED_CACHE = 8192


@dataclasses.dataclass
class Message:
    src_party: str
    upstream_seq_id: str
    downstream_seq_id: str
    payload: bytes
    metadata: Dict[str, str]
    # Wall time the receiver spent reading the payload off the socket —
    # the honest denominator for receiver-side GB/s.
    read_seconds: float = 0.0
    # Poison marker: the producer's task/encode failed; dict with
    # party/type/msg (see exceptions.RemoteError.to_wire).  The recv path
    # raises instead of decoding.
    error: Optional[Dict[str, str]] = None


class _Entry:
    __slots__ = ("event", "message", "created_at", "expected_src")

    def __init__(self) -> None:
        self.event = asyncio.Event()
        self.message: Optional[Message] = None
        self.created_at = time.monotonic()
        # The party a parked waiter expects data from (None until a recv
        # declares it) — lets fail_party target exactly the waiters a
        # dead peer owes.
        self.expected_src: Optional[str] = None


class Mailbox:
    """Keyed (upstream_seq_id, downstream_seq_id) → one message slot.

    All methods must be called from the owning asyncio loop.
    """

    def __init__(self, ttl_s: Optional[float] = None) -> None:
        self._entries: Dict[Key, _Entry] = {}
        self._consumed: "collections.OrderedDict[Key, None]" = (
            collections.OrderedDict()
        )
        self._ttl_s = ttl_s
        # party -> wire-form error dict; recvs expecting these parties
        # fail immediately until clear_party_failure.
        self._dead_parties: Dict[str, Dict[str, str]] = {}
        # Every party that ever delivered data here — evidence of
        # reachability for the health monitor's loss-not-absence gate —
        # and the monotonic time of each party's latest delivery (a
        # fresh delivery IS liveness; the monitor must not count ping
        # failures against a party whose data is actively arriving).
        self._seen_parties: set = set()
        self._last_put: Dict[str, float] = {}
        # Immutable snapshot of the dead set for CROSS-THREAD readers
        # (get_stats polls from user threads; every other Mailbox method
        # is loop-thread-only).  Replaced wholesale on each mutation, so
        # a reader never iterates a dict the loop is resizing.
        self._dead_snapshot: frozenset = frozenset()
        self.stats: Dict[str, int] = {
            "dropped_duplicates": 0,
            "expired": 0,
            "peer_failed_recvs": 0,
        }

    def put(self, message: Message) -> None:
        if message.error is None:
            self._seen_parties.add(message.src_party)
            self._last_put[message.src_party] = time.monotonic()
        key = (message.upstream_seq_id, message.downstream_seq_id)
        if key in self._consumed:
            # Re-delivery of an already-consumed rendezvous (sender retry
            # after a lost ACK) — dropping it prevents an entry that no
            # recv will ever pop.
            self.stats["dropped_duplicates"] += 1
            return
        entry = self._entries.get(key)
        if entry is None:
            entry = _Entry()
            self._entries[key] = entry
        entry.message = message
        entry.event.set()

    def _mark_consumed(self, key: Key) -> None:
        self._consumed[key] = None
        self._consumed.move_to_end(key)
        while len(self._consumed) > _CONSUMED_CACHE:
            self._consumed.popitem(last=False)

    def try_take(self, key: Key) -> Optional[Message]:
        """Pop the message for ``key`` if it already arrived, else None.

        Non-blocking twin of :meth:`get` for the streaming-receive path:
        a push that landed before the sink was registered is taken from
        the mailbox instead (and the key marked consumed as usual)."""
        entry = self._entries.get(key)
        if entry is None or entry.message is None:
            return None
        self._entries.pop(key, None)
        self._mark_consumed(key)
        return entry.message

    def mark_delivered(self, src_party: str, key: Key) -> None:
        """Record an out-of-band (sink-consumed) delivery of ``key``.

        The payload never entered the mailbox, but the rendezvous must
        still be remembered as consumed (sender retries after a lost ACK
        are dups) and the delivery still counts as the party's liveness
        for the health monitor."""
        if src_party:
            self._seen_parties.add(src_party)
            self._last_put[src_party] = time.monotonic()
        self._mark_consumed(key)
        # A parked waiter entry for the same key (conflicting consumers)
        # is left untouched: recv and recv_stream on one key is a caller
        # bug, and failing the waiter here would mask it.

    async def get(
        self,
        upstream_seq_id: str,
        downstream_seq_id: str,
        timeout_s: Optional[float] = None,
        src_party: Optional[str] = None,
    ) -> Message:
        key = (str(upstream_seq_id), str(downstream_seq_id))
        entry = self._entries.get(key)
        if entry is None:
            entry = _Entry()
            self._entries[key] = entry
        if src_party is not None:
            entry.expected_src = src_party
        # A party already declared dead fails this recv immediately —
        # unless its data actually raced in first (prefer real data).
        if (
            entry.message is None
            and src_party is not None
            and src_party in self._dead_parties
        ):
            self.stats["peer_failed_recvs"] += 1
            self._entries.pop(key, None)
            self._mark_consumed(key)
            return Message(
                src_party, key[0], key[1], b"", {},
                error=dict(self._dead_parties[src_party]),
            )
        try:
            if timeout_s is None:
                await entry.event.wait()
            else:
                await asyncio.wait_for(entry.event.wait(), timeout=timeout_s)
        except asyncio.TimeoutError:
            # Only the parked-waiter entry is discarded; a message that
            # raced in concurrently has set the event and is returned.
            if entry.message is None:
                self._entries.pop(key, None)
                from rayfed_tpu_torch.exceptions import PartyWaitTimeout

                raise PartyWaitTimeout(
                    f"recv of ({key[0]}, {key[1]}) timed out after "
                    f"{timeout_s}s",
                    missing_parties=(
                        [entry.expected_src] if entry.expected_src else []
                    ),
                ) from None
        # Pop: a rendezvous key is consumed exactly once (ref barriers.py:338-340).
        self._entries.pop(key, None)
        self._mark_consumed(key)
        assert entry.message is not None
        return entry.message

    def fail_party(
        self, party: str, error: Dict[str, str], poison_new: bool = True
    ) -> int:
        """Fail every parked waiter expecting ``party`` with ``error``
        (wire-form dict, see ``RemoteError.to_wire``); with
        ``poison_new`` (default), new recvs on it fail immediately until
        :meth:`clear_party_failure`.  Returns the number of waiters
        failed.  Loop-thread only, like every Mailbox method."""
        failed = 0
        for key, entry in list(self._entries.items()):
            if entry.message is None and entry.expected_src == party:
                entry.message = Message(
                    party, key[0], key[1], b"", {}, error=dict(error)
                )
                entry.event.set()
                failed += 1
        self.stats["peer_failed_recvs"] += failed
        if poison_new:
            self._dead_parties[party] = dict(error)
            self._dead_snapshot = frozenset(self._dead_parties)
        return failed

    def clear_party_failure(self, party: str) -> None:
        """The party is reachable again: stop failing new recvs on it."""
        self._dead_parties.pop(party, None)
        self._dead_snapshot = frozenset(self._dead_parties)

    def dead_parties(self):
        return set(self._dead_parties)

    def party_failure(self, party: str) -> Optional[Dict[str, str]]:
        """The stored wire-form error of a declared-dead ``party``
        (``None`` while it is considered alive).  Loop-thread only."""
        err = self._dead_parties.get(party)
        return dict(err) if err is not None else None

    def dead_parties_snapshot(self) -> frozenset:
        """Cross-thread-safe view of the dead set (see _dead_snapshot)."""
        return self._dead_snapshot

    def seen_parties(self):
        """Parties that have delivered data to this mailbox."""
        return set(self._seen_parties)

    def seconds_since_delivery(self, party: str) -> float:
        """Monotonic seconds since ``party`` last delivered data
        (``inf`` if never)."""
        t = self._last_put.get(party)
        return float("inf") if t is None else time.monotonic() - t

    def parties_with_waiters(self):
        """Parties that parked waiters currently expect data from."""
        return {
            e.expected_src
            for e in self._entries.values()
            if e.message is None and e.expected_src is not None
        }

    def gc(self, now: Optional[float] = None) -> int:
        """Expire undelivered messages older than the TTL; returns count."""
        if self._ttl_s is None:
            return 0
        now = time.monotonic() if now is None else now
        # An entry is GC-eligible only when data arrived but nobody
        # consumed it: a parked waiter's entry has message None (its own
        # timeout governs), and data+waiter resolves immediately anyway.
        expired = [
            key
            for key, entry in self._entries.items()
            if entry.message is not None and now - entry.created_at > self._ttl_s
        ]
        for key in expired:
            self._entries.pop(key, None)
        self.stats["expired"] += len(expired)
        return len(expired)

    def pending_count(self) -> int:
        return len(self._entries)

    def pending_bytes(self) -> int:
        return sum(
            len(e.message.payload)
            for e in self._entries.values()
            if e.message is not None
        )
