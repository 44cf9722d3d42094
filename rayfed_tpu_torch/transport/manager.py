"""TransportManager — send/recv proxies on one asyncio loop thread.

The reference hosts its transport in two named Ray actors
(``SendProxyActor`` / ``RecverProxyActor-{party}``, ``barriers.py:184-351``)
with ``max_concurrency=1000`` so many ``get_data`` calls can park.  Our
party controller is a single process, so both proxies live on one asyncio
event loop running in a dedicated thread: thousands of pending recvs are
just parked coroutines, and sends are pipelined frames — no actor
round-trips, no object-store copies.

Payload encode/decode runs on a small codec thread pool so the loop never
blocks on serialization, and received device-array leaves are put back on
local devices off-loop as well.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from rayfed_tpu_torch import telemetry
from rayfed_tpu_torch.config import ClusterConfig, JobConfig, RetryPolicy
from rayfed_tpu_torch.executor import LocalRef
from rayfed_tpu_torch.transport import local
from rayfed_tpu_torch.transport import secagg as secagg_keys
from rayfed_tpu_torch.transport import tls as tls_utils
from rayfed_tpu_torch.transport import wire
from rayfed_tpu_torch.transport.client import SendError, TransportClient
from rayfed_tpu_torch.transport.rendezvous import Mailbox, Message
from rayfed_tpu_torch.transport.server import TransportServer
from rayfed_tpu_torch.utils.platform import fence_for_handoff

logger = logging.getLogger(__name__)


# Transport options the client actually consumes; everything else in a
# party's transport_options/grpc_options is loudly reported as ignored
# (the reference silently dropped unknown gRPC channel args — an
# operator typo like "tiemout_s" then just... did nothing).
_KNOWN_TRANSPORT_OPTIONS = frozenset(
    {"timeout_s", "max_message_size", "checksum", "connections_per_peer",
     "stripe_rails", "heartbeat_interval_s", "death_deadline_s",
     "local_link"}
)
# Reference-style gRPC channel-arg keys accepted for drop-in compat.
_COMPAT_TRANSPORT_OPTIONS = {
    "grpc.max_send_message_length": "max_message_size",
}
# Recognized-but-inapplicable: there is no gRPC authority to override
# on a raw socket transport.  Reported with the ignored keys.
_INAPPLICABLE_TRANSPORT_OPTIONS = frozenset({"grpc.default_authority"})


def _validate_health_knobs(heartbeat_s: float, deadline_s: float) -> None:
    """Shared validation of the per-party health-monitor options
    (``heartbeat_interval_s`` / ``death_deadline_s``) — surfaced through
    ``effective_transport_options`` instead of living as module
    constants, and validated wherever they enter."""
    if not (heartbeat_s > 0):
        raise ValueError(
            f"heartbeat_interval_s must be > 0, got {heartbeat_s}"
        )
    if deadline_s < heartbeat_s:
        raise ValueError(
            f"death_deadline_s ({deadline_s}) must be >= "
            f"heartbeat_interval_s ({heartbeat_s}) — a deadline shorter "
            f"than one heartbeat would declare every party dead on its "
            f"first missed ping"
        )


class RosterState:
    """Epoch-numbered live-membership view (elastic party membership).

    The cluster config stays the static universe of parties that COULD
    participate; the roster is the subset that currently DOES, stamped
    with a monotonically increasing **epoch**.  Epochs advance only at
    round boundaries, announced by the quorum round's coordinator in its
    result broadcast (``fl.quorum``) — every controller applies the same
    announcement, so the roster is identical everywhere without a
    consensus protocol.  ``fed.join()`` / ``fed.leave()`` / monitor-
    declared death all funnel through those announcements; no fed
    runtime restarts on churn.

    Frames of quorum rounds are stamped with the sender's epoch
    (``wire.EPOCH_TAG_KEY``) and the receiving server rejects
    cross-epoch frames loudly — see ``TransportServer.epoch_provider``.

    Thread-safe: read from the transport loop (epoch checks), driver
    threads, and the health monitor.
    """

    def __init__(self, members: Sequence[str]) -> None:
        self._lock = threading.Lock()
        self._epoch = 0
        self._members = tuple(sorted(members))
        self._leave_requested = False

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    @property
    def members(self) -> tuple:
        with self._lock:
            return self._members

    def snapshot(self) -> tuple:
        """``(epoch, members)`` read atomically."""
        with self._lock:
            return self._epoch, self._members

    def is_member(self, party: str) -> bool:
        with self._lock:
            return party in self._members

    def apply(self, epoch: int, members: Sequence[str]) -> bool:
        """Apply an announced roster; returns True if it advanced.

        Stale announcements (epoch older than current) are ignored with
        a warning — a late broadcast replay must not roll membership
        back.  An equal-epoch announcement with DIFFERENT members is a
        protocol bug and raises.
        """
        epoch = int(epoch)
        members = tuple(sorted(members))
        with self._lock:
            if epoch < self._epoch:
                logger.warning(
                    "ignoring stale roster announcement (epoch %d < "
                    "current %d)", epoch, self._epoch,
                )
                return False
            if epoch == self._epoch:
                if members != self._members:
                    raise ValueError(
                        f"conflicting rosters for epoch {epoch}: "
                        f"{members} vs {self._members}"
                    )
                return False
            logger.info(
                "roster epoch %d -> %d: members %s -> %s",
                self._epoch, epoch, self._members, members,
            )
            self._epoch = epoch
            self._members = members
            return True

    def advance(self, members: Sequence[str]) -> int:
        """Coordinator-side: bump the epoch with a new member set and
        return the new epoch (the announcement payload)."""
        with self._lock:
            self._epoch += 1
            self._members = tuple(sorted(members))
            logger.info(
                "roster advanced to epoch %d: %s",
                self._epoch, self._members,
            )
            return self._epoch

    # -- graceful departure (fed.leave) -----------------------------------

    def request_leave(self) -> None:
        """Mark this party as wanting out; the quorum round driver picks
        the flag up at the next round boundary (``fed.leave``)."""
        with self._lock:
            self._leave_requested = True

    def consume_leave_request(self) -> bool:
        with self._lock:
            requested, self._leave_requested = self._leave_requested, False
            return requested


# Rendezvous-key prefix of roster membership REQUESTS (join / leave):
# routed around the mailbox via a server observer into the manager's
# membership inbox, which the quorum coordinator drains at round
# boundaries.  Join WELCOMES ride ordinary rendezvous keys (the joiner
# parks a recv on them).
ROSTER_REQ_PREFIX = "roster.req."


def roster_successor(
    members: Sequence[str], coordinator: str, dead: Sequence[str] = (),
) -> Optional[str]:
    """Deterministic coordinator succession: the next alive party after
    ``coordinator`` on the sorted roster ring.

    Every controller derives the successor LOCALLY from the same inputs
    — the epoch-numbered roster members and the (departing or declared-
    dead) coordinator — so a coordinator crash or graceful ``fed.leave``
    needs no election protocol: walk the sorted ring starting just past
    the coordinator's position (wrapping), return the first candidate
    that is a member and not in ``dead``.  ``None`` when nobody else is
    alive.  The walk starts from the coordinator's canonical position
    whether or not it is still a member, so iterated successions (A
    dies, then B dies) land on the same party as a one-shot derivation
    from the pinned coordinator over the surviving roster.
    """
    ring = sorted(set(members) | {coordinator})
    i = ring.index(coordinator)
    skip = set(dead) | {coordinator}
    candidates = set(members)
    for p in ring[i + 1:] + ring[:i]:
        if p in candidates and p not in skip:
            return p
    return None


def partition_regions(
    members: Sequence[str], region_size: int
) -> List[List[str]]:
    """Deterministic two-level partition of the roster into regions.

    Contiguous slices of the **sorted** member list, ``region_size``
    parties each (last region short) — the same canonical order every
    other cross-controller decision uses (sampling, stripe ownership,
    ring neighbors), so every controller derives the identical
    partition from the identical roster epoch with zero negotiation.
    The hierarchy topology (:mod:`rayfed_tpu_torch.fl.hierarchy`) builds on
    this: region ``g`` runs its own chunk-striped ring, region
    coordinators carry integer partial sums up to the root.
    """
    if int(region_size) < 1:
        raise ValueError(
            f"region_size must be >= 1, got {region_size}"
        )
    ps = sorted(members)
    if not ps:
        raise ValueError("cannot partition an empty roster")
    s = int(region_size)
    return [ps[i : i + s] for i in range(0, len(ps), s)]


def branch_groups(
    node_ids: Sequence[int], branch: int
) -> List[Tuple[int, List[int]]]:
    """Deterministic constant-degree grouping of one tree level.

    Groups node ids by ``id // branch`` over the FULL id range of the
    level — NOT by packing the surviving ids densely — so a node's
    parent is a pure function of its own id and never moves when a
    sibling's subtree dies.  Every controller derives the identical
    grouping from the identical roster epoch, the same zero-negotiation
    contract as :func:`partition_regions`; the multi-level hierarchy
    (:mod:`rayfed_tpu_torch.fl.hierarchy`) applies this rule recursively
    until a single top node remains.  Returns ``(parent_id, children)``
    pairs sorted by parent id, children in ascending id order.
    """
    if int(branch) < 2:
        raise ValueError(f"branch must be >= 2, got {branch}")
    b = int(branch)
    grouped: Dict[int, List[int]] = {}
    for cid in sorted(node_ids):
        grouped.setdefault(cid // b, []).append(cid)
    return sorted(grouped.items())


def ring_neighbors(parties: Sequence[str], party: str) -> tuple:
    """``(predecessor, successor)`` of ``party`` on the sorted ring.

    The ring order is the SORTED party list — the same canonical order
    every other cross-controller decision uses (sampling, stripe
    ownership), so all parties derive identical neighbors without
    coordination.  At N=2 the single peer is both neighbors; at N=1 the
    party is its own.
    """
    ring = sorted(parties)
    try:
        i = ring.index(party)
    except ValueError:
        raise ValueError(f"{party!r} is not in the ring {ring}") from None
    return ring[i - 1], ring[(i + 1) % len(ring)]


class TransportManager:
    def __init__(
        self,
        cluster_config: ClusterConfig,
        job_config: JobConfig,
        device: Any = None,
    ) -> None:
        self._cluster = cluster_config
        self._job = job_config
        self._party = cluster_config.current_party
        # The party's torch.device (fed.init resolves it): received
        # tensor leaves are decoded onto it when device_put_received is
        # set.  None means the current CUDA card, resolved at decode.
        self.device = device

        self._loop = asyncio.new_event_loop()
        self._loop_thread: Optional[threading.Thread] = None
        self._started = threading.Event()

        self._mailbox = Mailbox(ttl_s=job_config.mailbox_ttl_s)
        self._gc_task: Optional[asyncio.TimerHandle] = None
        self._health_task: Optional[asyncio.Task] = None
        # Parties whose server acked one of our sends — reachability
        # evidence for the health monitor (set.add is atomic; read on
        # the loop thread, written from send callbacks).
        self._peers_acked: set = set()
        my_cfg = cluster_config.party_config(self._party)
        listen_addr = my_cfg.listen_addr or my_cfg.address
        self._server = TransportServer(
            party=self._party,
            listen_addr=listen_addr,
            mailbox=self._mailbox,
            max_message_size=job_config.cross_silo_messages_max_size,
            ssl_context=tls_utils.server_ssl_context(cluster_config.tls_config),
        )
        self._clients: Dict[str, TransportClient] = {}
        self._clients_lock = threading.Lock()
        self._codec_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=4, thread_name_prefix=f"rayfed-codec-{self._party}"
        )
        self.stats: Dict[str, Any] = {
            "send_op_count": 0,
            "send_bytes": 0,
            "send_seconds": 0.0,
            # Payload→wire-buffers encode time on the codec pool (the
            # "encode" stage of the send-path breakdown; the arena copy
            # is billed client-side as send_copy_s).
            "send_encode_s": 0.0,
        }
        # Per-destination send wall time (encode handoff → ACK), summed
        # over sends: surfaces which peer a fan-out actually waits on.
        # Read-modify-write from codec AND loop threads — guarded by a
        # lock so overlapping completions to one destination can't lose
        # an increment.
        self._dest_lock = threading.Lock()
        self._dest_seconds: Dict[str, float] = {}
        self._dest_ops: Dict[str, int] = {}
        # Per-destination transport-option keys that were ignored (S3:
        # never silently dropped) + one-time warning bookkeeping.
        self._ignored_options: Dict[str, list] = {}
        self._warned_ignored: set = set()
        # recv_stream bookkeeping: rendezvous key -> src party, so the
        # health monitor can fail chunk-sink waits (which never park in
        # the mailbox) when their source party dies.  Loop thread only.
        self._stream_srcs: Dict[tuple, str] = {}
        # Elastic membership: the live roster (epoch + members) plus the
        # membership-request inbox (join/leave control messages from
        # peers, consumed by a server observer; the quorum coordinator
        # drains it at round boundaries).  deque append/popleft are
        # atomic, so the loop thread appends and driver threads drain
        # without a lock.
        import collections as _collections

        self.roster = RosterState(cluster_config.parties)
        self._membership_inbox: "_collections.deque" = _collections.deque()
        self._server.epoch_provider = lambda: self.roster.epoch
        self._server._observers.append(self._observe_membership)
        # Secure-aggregation key agreement (transport/secagg.py): one
        # ephemeral keypair per manager (per fed.init session), NOT
        # module-global — several in-process parties each hold their
        # own.  Published in every HELLO this party sends or answers;
        # fl/secagg.py derives pairwise mask seeds from it.
        self.secagg_keys = secagg_keys.KeyAgreement(self._party)
        self._server.secagg = self.secagg_keys
        # Content-addressed pull-on-demand object plane (transport/
        # objectstore.py): fingerprint handles for large immutable
        # objects, BLOB_GET/BLOB_PUT pulls on the existing frame
        # machinery, bounded content cache.  The observer consumes
        # BLOB_GET request frames like the membership observer consumes
        # roster requests.
        from rayfed_tpu_torch.transport.objectstore import ObjectPlane

        self.objects = ObjectPlane(
            self, budget_bytes=job_config.blob_cache_budget_bytes
        )
        self._server._observers.append(self.objects._observe_request)
        # Per-manager transfer log (rayfed_tpu_torch/metrics.py): in-process
        # multi-party tests/benches used to conflate every party's
        # transfers into the module-global ring (the KeyAgreement
        # per-manager lesson from the secagg work) — each manager now
        # owns its ring; the module global remains a documented
        # runtime-less fallback.
        from rayfed_tpu_torch import metrics as _metrics

        self.transfer_log = _metrics.TransferLog()
        # Flight-recorder trace collection (rayfed_tpu_torch/telemetry.py):
        # peers pull this party's span-ring window via a TRACE_GET
        # request frame consumed by a server observer — the BLOB_GET
        # shape — answered with a JSON record window on the requester's
        # nonce reply key.  Serving works even with the recorder
        # disarmed (an empty window, marked armed=False), so a mixed
        # fleet degrades loudly rather than hanging the collector.
        self._server._observers.append(self._observe_trace_request)
        # Party mesh for received shards (set by fed.init to return the
        # runtime's DeviceMesh): shard-encoded leaves whose sender
        # sharding fits it decode as DTensors, each process building its
        # own shard (wire.decode_payload(mesh=)).
        self.mesh_provider = None

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        def _run_loop():
            asyncio.set_event_loop(self._loop)
            self._started.set()
            self._loop.run_forever()

        # Warm the native codec build up front so the first transfer never
        # pays (or serializes behind) a g++ compile inside _get_client.
        from rayfed_tpu_torch import native

        native.is_available()

        self._loop_thread = threading.Thread(
            target=_run_loop, name=f"rayfed-transport-{self._party}", daemon=True
        )
        self._loop_thread.start()
        self._started.wait()
        # Synchronous barrier: listener must be up before init returns
        # (parity with ray.get(actor.is_ready.remote()), barriers.py:379).
        fut = asyncio.run_coroutine_threadsafe(self._server.start(), self._loop)
        fut.result(timeout=30)

        def _periodic_gc():
            self._mailbox.gc()
            self._gc_task = self._loop.call_later(30.0, _periodic_gc)

        self._gc_task = self._loop.call_soon_threadsafe(
            lambda: self._loop.call_later(30.0, _periodic_gc)
        )
        if self._job.peer_failfast:
            self._loop.call_soon_threadsafe(
                lambda: setattr(
                    self, "_health_task",
                    self._loop.create_task(self._health_monitor()),
                )
            )

    async def _health_monitor(self) -> None:
        """Peer-death fail-fast: ping parties that parked recvs are
        waiting on; after ``peer_death_pings`` consecutive failures, fail
        those recvs with a ``RemoteError`` naming the party instead of
        letting them park until the recv backstop (improves on reference
        ``barriers.py:244-248``, which leaves the consumer blind).  A
        declared-dead party keeps being pinged and is un-poisoned the
        moment it answers again.

        A ping only fails when the peer's transport cannot answer a
        1-RTT control frame within the interval — its event loop serves
        pings independently of task compute, so a slow-but-healthy party
        does not trip this (the generous recv backstop stays the only
        limit on compute time).
        """
        from rayfed_tpu_torch.exceptions import RemoteError

        base_interval = self._job.peer_health_interval_s
        default_pings = max(1, int(self._job.peer_death_pings))
        tick = base_interval
        fails: Dict[str, int] = {}
        # Fail-fast covers connection LOSS, not never-connected: a party
        # only becomes eligible after evidence of reachability — a
        # successful health ping, a delivered message (mailbox), or an
        # acked send (self._peers_acked).  Cross-silo parties routinely
        # start minutes apart, and a not-up-yet peer must park recvs
        # (bounded by the backstop), not get declared dead.
        ever_reachable: set = set()
        # Previous cycle's per-party received-byte counters (including
        # bytes of payloads still mid-read): a counter that moved since
        # the last cycle is proof of life even when control pings queue
        # behind the bulk transfer and time out — a multi-GB push must
        # not get its sender declared dead mid-transfer (the parked
        # recvs would be failed AND their keys marked consumed, so the
        # transfer's eventual completion would be dropped as a dup).
        rx_prev: Dict[str, int] = {}

        async def probe(party: str, hb_s: float) -> bool:
            # The ping deadline follows the PARTY'S OWN heartbeat, not
            # the shared tick: one party configuring an aggressive
            # heartbeat shrinks the probe cadence for everyone, but it
            # must not shrink everyone's ping timeout — a healthy
            # slow-RTT peer would read as dead.
            try:
                return await asyncio.wait_for(
                    self._get_client(party).ping(
                        timeout_s=min(1.0, hb_s), ctl=True
                    ),
                    timeout=max(tick, min(1.0, hb_s)),
                )
            except Exception:
                return False

        while True:
            await asyncio.sleep(tick)
            parties = sorted(
                self._mailbox.parties_with_waiters()
                | self._mailbox.dead_parties()
                # Chunk-sink waits (streaming/ring aggregation) never
                # park in the mailbox — monitor their source parties
                # too, or a peer dying mid reduce-scatter would leave
                # the aggregator blind until the recv backstop.
                | self._stream_sink_parties()
            )
            # Per-party health knobs (heartbeat_interval_s /
            # death_deadline_s transport options): the loop ticks at the
            # FASTEST configured heartbeat among the monitored parties,
            # and each party's death threshold is its own deadline
            # expressed in ticks — defaults reproduce the job-level
            # peer_health_interval_s × peer_death_pings behavior bit for
            # bit.  The tick adapts one cycle late, which is fine: the
            # deadline is what operators reason about.
            knobs: Dict[str, tuple] = {}
            for p in parties:
                try:
                    knobs[p] = self._party_health_knobs(p)
                except Exception:
                    knobs[p] = (
                        base_interval, base_interval * default_pings
                    )
            tick = min(
                [base_interval] + [hb for hb, _ in knobs.values()]
            )
            # Consecutive means consecutive: a party that left the
            # monitored set (its recvs resolved) starts from zero next
            # time it parks — stale counts from old blips must not
            # combine with a fresh transient into a false death.
            fails = {p: c for p, c in fails.items() if p in parties}
            ever_reachable |= self._mailbox.seen_parties()
            ever_reachable |= self._peers_acked
            # Concurrent probes: one unreachable party must not delay
            # (and thereby slow detection for) the others.
            results = await asyncio.gather(
                *(probe(p, knobs[p][0]) for p in parties)
            )
            rx_now = self._server.receive_progress()
            for party, ok in zip(parties, results):
                # Fresh arriving bytes are liveness regardless of the
                # ping: a party mid-bulk-transfer can be slow to answer
                # control frames, but its data actively landing (even
                # partially, mid-payload) proves it isn't dead.
                if not ok and rx_now.get(party, 0) != rx_prev.get(party, 0):
                    ok = True
                if not ok and self._mailbox.seconds_since_delivery(
                    party
                ) <= tick:
                    ok = True
                if ok:
                    ever_reachable.add(party)
                    fails.pop(party, None)
                    if party in self._mailbox.dead_parties():
                        logger.info(
                            "[%s] party %s reachable again; clearing "
                            "fail-fast poison", self._party, party,
                        )
                        self._mailbox.clear_party_failure(party)
                elif (
                    party in ever_reachable
                    and party not in self._mailbox.dead_parties()
                ):
                    fails[party] = fails.get(party, 0) + 1
                    deadline_s = knobs[party][1]
                    threshold = max(1, int(round(deadline_s / tick)))
                    if fails[party] >= threshold:
                        logger.warning(
                            "[%s] party %s unreachable (%d consecutive "
                            "pings, death deadline %.1fs); failing its "
                            "pending recvs",
                            self._party, party, fails[party], deadline_s,
                        )
                        err = RemoteError(
                            party,
                            "ConnectionError",
                            f"party {party!r} is unreachable "
                            f"({fails[party]} consecutive health pings "
                            f"failed over ~{fails[party] * tick:.0f}s, "
                            f"death deadline {deadline_s:.1f}s); "
                            f"its pending sends will never arrive",
                        ).to_wire()
                        self._mailbox.fail_party(party, err)
                        self._fail_party_sinks(party, err)
            rx_prev = rx_now

    def _stream_sink_parties(self) -> set:
        """Source parties of still-registered chunk sinks (loop thread).

        Also purges bookkeeping for sinks that were consumed or
        cancelled since the last cycle, so the map cannot grow beyond
        the in-flight registrations.
        """
        live = {
            key: src
            for key, src in self._stream_srcs.items()
            if self._server.peek_chunk_sink(key) is not None
        }
        self._stream_srcs = live
        return set(live.values())

    def _fail_party_sinks(self, party: str, err: Dict[str, str]) -> None:
        """Deliver a dead party's failure to its pending chunk sinks —
        the stream analogue of ``Mailbox.fail_party`` (loop thread)."""
        for key, src in list(self._stream_srcs.items()):
            if src != party:
                continue
            self._stream_srcs.pop(key, None)
            sink = self._server.take_chunk_sink(key)
            if sink is None:
                continue
            try:
                sink.on_error(err)
            except Exception:  # pragma: no cover - sink bug
                logger.exception(
                    "[%s] chunk sink failure delivery raised", self._party
                )

    def stop(self) -> None:
        async def _shutdown():
            for client in self._clients.values():
                await client.close()
            await self._server.stop()
            # Cancel parked recvs so shutdown doesn't leak pending tasks.
            current = asyncio.current_task()
            for task in asyncio.all_tasks():
                if task is not current:
                    task.cancel()

        if self._loop_thread is None:
            return
        try:
            asyncio.run_coroutine_threadsafe(_shutdown(), self._loop).result(timeout=10)
        except Exception:  # pragma: no cover
            logger.exception("[%s] transport shutdown error", self._party)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._loop_thread.join(timeout=10)
        self._loop.close()
        self._loop_thread = None
        self._codec_pool.shutdown(wait=False)
        self.objects.close()

    # -- client construction --------------------------------------------------

    def _merged_options(self, dest_party: str) -> Dict[str, Any]:
        """Per-destination options, per-party overriding global (ref :250-268).

        Unknown keys are NOT silently dropped: they are recorded per
        destination (see :meth:`effective_transport_options`) and a
        loud one-time warning lists every ignored key — an operator
        typo must be diagnosable, not a silent no-op.
        """
        from rayfed_tpu_torch import native

        opts: Dict[str, Any] = {
            "timeout_s": self._job.cross_silo_timeout_s,
            "max_message_size": self._job.cross_silo_messages_max_size,
            # Default on only when the fast C++ path built; the pure-
            # Python CRC is ~MB/s and would stall large pushes.  Explicit
            # per-party {"checksum": True} still forces it.
            "checksum": native.is_available(),
            # Connections per destination: concurrent pushes to one party
            # ride different sockets (no head-of-line blocking), and a
            # single striped payload fans its chunks across all of them.
            "connections_per_peer": 2,
            # Health-monitor knobs (peer-death fail-fast), surfaced as
            # validated per-party options instead of module constants:
            # probe cadence and how long a party may stay unreachable
            # before its pending recvs are failed.
            "heartbeat_interval_s": self._job.peer_health_interval_s,
            "death_deadline_s": (
                self._job.peer_health_interval_s
                * max(1, int(self._job.peer_death_pings))
            ),
            # Per-link transport backend (transport/local.py): "auto"
            # upgrades a link to the peer's AF_UNIX listener (same
            # host) or the in-process shared-memory handoff (same
            # process); "off" (the default) pins TCP — existing
            # topologies keep their exact wire behavior unless opted
            # in per-job or per-party.
            "local_link": getattr(self._job, "local_link", "off"),
        }
        party_opts = dict(self._cluster.party_config(dest_party).transport_options)
        # Accept reference-style gRPC channel-arg keys for drop-in compat.
        for compat_key, real_key in _COMPAT_TRANSPORT_OPTIONS.items():
            if compat_key in party_opts:
                opts[real_key] = party_opts.pop(compat_key)
        unknown = []
        inapplicable = []
        for key in list(party_opts):
            if key in _KNOWN_TRANSPORT_OPTIONS:
                opts[key] = party_opts.pop(key)
            else:
                party_opts.pop(key)
                if key in _INAPPLICABLE_TRANSPORT_OPTIONS:
                    inapplicable.append(key)
                else:
                    unknown.append(key)
        unknown.sort()
        inapplicable.sort()
        # Everything not applied is reported through the accessor;
        # recognized-but-inapplicable keys (a reference config's
        # grpc.default_authority) are named separately in the warning
        # so they don't read as operator typos.
        self._ignored_options[dest_party] = unknown + inapplicable
        if (unknown or inapplicable) and dest_party not in self._warned_ignored:
            self._warned_ignored.add(dest_party)
            logger.warning(
                "[%s] transport options for %s contain keys this "
                "transport does not use — IGNORED: %s%s (known keys: "
                "%s; compat aliases: %s)",
                self._party, dest_party, unknown or "[]",
                f"; recognized but inapplicable on a raw-socket "
                f"transport: {inapplicable}" if inapplicable else "",
                sorted(_KNOWN_TRANSPORT_OPTIONS),
                sorted(_COMPAT_TRANSPORT_OPTIONS),
            )
        opts["heartbeat_interval_s"] = float(opts["heartbeat_interval_s"])
        opts["death_deadline_s"] = float(opts["death_deadline_s"])
        _validate_health_knobs(
            opts["heartbeat_interval_s"], opts["death_deadline_s"]
        )
        return opts

    def _party_health_knobs(self, dest_party: str) -> tuple:
        """``(heartbeat_interval_s, death_deadline_s)`` for one party —
        the per-party transport options with job-config defaults,
        validated.  Light-weight twin of :meth:`_merged_options` for the
        health monitor's per-cycle reads (no ignored-key bookkeeping)."""
        opts = self._cluster.party_config(dest_party).transport_options
        hb = float(
            opts.get("heartbeat_interval_s",
                     self._job.peer_health_interval_s)
        )
        dd = float(
            opts.get(
                "death_deadline_s",
                hb * max(1, int(self._job.peer_death_pings)),
            )
        )
        _validate_health_knobs(hb, dd)
        return hb, dd

    def effective_transport_options(self, dest_party: str) -> Dict[str, Any]:
        """The merged options a client to ``dest_party`` actually runs
        with, plus every per-party key that was ignored — the operator
        debugging accessor for "which knob actually applied".

        Reflects a live client when one exists (post-init mutations
        like :meth:`set_max_message_size` show through); otherwise the
        merge that WOULD apply on first contact.
        """
        opts = self._merged_options(dest_party)
        with self._clients_lock:
            client = self._clients.get(dest_party)
        link_info = None
        if client is not None:
            opts["timeout_s"] = client._timeout_s
            opts["max_message_size"] = client._max_message_size
            opts["checksum"] = client.checksum_enabled
            opts["connections_per_peer"] = client._pool_size
            opts["stripe_rails"] = client._stripe_rails()
            opts["local_link"] = client._local_mode
            # The LIVE backend decision too (mode is the ask, backend
            # the outcome): {mode, backend, decided, fallback} — the
            # "did my link actually upgrade, and if not why" accessor.
            link_info = client.local_link_info()
        return {
            "party": dest_party,
            "options": opts,
            "ignored_keys": list(self._ignored_options.get(dest_party, [])),
            "metadata": self.merged_metadata(dest_party),
            "local_link": link_info,
        }

    def set_max_message_size(self, max_bytes: int) -> None:
        """Mutate the cross-silo message-size cap post-init.

        Applies atomically to the server and every live client on the
        transport loop; future clients inherit it through the job
        config.  Rejects with a clear error while any send is
        mid-flight — a torn apply (some frames under the old cap, the
        ACK under the new) is exactly the confusion this guards
        against.  Per-party explicit overrides are replaced too: an
        explicit runtime mutation wins over static config.
        """
        max_bytes = int(max_bytes)
        if max_bytes <= 0:
            raise ValueError(
                f"max message length must be positive, got {max_bytes}"
            )

        async def _apply():
            # fedlint: disable=FED001 — bounded hold: sync holders of _clients_lock only do dict ops / lazy client construction (no I/O, connections open on the loop), so this dict snapshot cannot park the loop meaningfully
            with self._clients_lock:
                clients = dict(self._clients)
            busy = sorted(
                p for p, c in clients.items() if c.has_inflight_sends()
            )
            if busy:
                raise RuntimeError(
                    f"cannot change max message length while sends are "
                    f"in flight to {busy}; wait for them to drain "
                    f"(e.g. fed.shutdown's wait_sending, or resolve "
                    f"the pending send refs) and retry"
                )
            for c in clients.values():
                c._max_message_size = max_bytes
            self._server._max_message_size = max_bytes

        asyncio.run_coroutine_threadsafe(_apply(), self._loop).result(
            timeout=30
        )
        # Future clients (and _merged_options defaults) follow the job
        # config — runtime.job_config is this same object.
        self._job.cross_silo_messages_max_size = max_bytes

    def merged_metadata(self, dest_party: str) -> Dict[str, str]:
        meta = dict(self._job.metadata)
        meta.update(self._cluster.party_config(dest_party).metadata)
        return meta

    def _get_client(self, dest_party: str) -> TransportClient:
        # Called from codec-pool threads and ping callers concurrently.
        with self._clients_lock:
            client = self._clients.get(dest_party)
            if client is None:
                opts = self._merged_options(dest_party)
                client = TransportClient(
                    src_party=self._party,
                    dest_party=dest_party,
                    address=self._cluster.party_config(dest_party).address,
                    retry_policy=self._job.retry_policy,
                    timeout_s=float(opts["timeout_s"]),
                    max_message_size=int(opts["max_message_size"]),
                    metadata=self.merged_metadata(dest_party),
                    ssl_context=tls_utils.client_ssl_context(self._cluster.tls_config),
                    checksum=bool(opts.get("checksum", True)),
                    pool_size=int(opts.get("connections_per_peer", 2)),
                    loop=self._loop,
                    # Rails a striped payload fans over; None = host-
                    # adaptive (striping off on few-core hosts).
                    stripe_rails=opts.get("stripe_rails"),
                    # Known-dead fast-fail: the retry ladder consults
                    # the health monitor's dead set (thread-safe
                    # snapshot) and skips the backoff ladder against a
                    # destination already declared dead — one attempt,
                    # no 65s of retries against a corpse.
                    dead_check=(
                        lambda p=dest_party:
                        p in self._mailbox.dead_parties_snapshot()
                    ),
                    secagg=self.secagg_keys,
                    local_link=str(opts.get("local_link", "off")),
                    # An explicit per-party/job checksum survives local-
                    # link CRC elision: the operator pinned it.
                    checksum_pinned=(
                        "checksum"
                        in self._cluster.party_config(
                            dest_party
                        ).transport_options
                    ),
                )
                self._clients[dest_party] = client
            return client

    # -- send path (SendProxy role) ------------------------------------------

    def _send_poison(
        self, dest_party: str, upstream_seq_id: Any, downstream_seq_id: Any,
        exc: BaseException,
    ) -> LocalRef:
        """Poison the promised rendezvous key on the consumer side.

        Improves on reference ``barriers.py:244-248`` (send failure →
        ``False`` + log; the peer's recv parks until its backstop): the
        consumer's ``fed.get`` raises :class:`RemoteError` within the
        round-trip time, carrying the producer's exception.

        Returns a LocalRef resolving when the poison delivery finished
        (True/False) — callers chain the user-visible send result on it so
        ``wait_sending``/``shutdown`` can't cancel an in-flight poison.
        """
        from rayfed_tpu_torch.exceptions import RemoteError

        done = LocalRef()
        err = RemoteError.from_exception(self._party, exc).to_wire()
        try:
            client = self._get_client(dest_party)
            cf = asyncio.run_coroutine_threadsafe(
                client.send_data(
                    [], str(upstream_seq_id), str(downstream_seq_id), error=err
                ),
                self._loop,
            )

            def _poison_done(f):
                # exception() on a cancelled future (shutdown cancelling
                # loop tasks) RAISES instead of returning — guard it, or
                # `done` never resolves and wait_sending hangs forever.
                e = (
                    f.exception()
                    if not f.cancelled()
                    else asyncio.CancelledError("transport stopped")
                )
                if e is not None:
                    logger.warning(
                        "[%s] failed to poison (%s, %s) at %s: %r",
                        self._party, upstream_seq_id, downstream_seq_id,
                        dest_party, e,
                    )
                done.set_result(e is None)

            cf.add_done_callback(_poison_done)
        except Exception as e:  # pragma: no cover - client construction
            logger.warning(
                "[%s] cannot poison (%s, %s) at %s: %r",
                self._party, upstream_seq_id, downstream_seq_id, dest_party, e,
            )
            done.set_result(False)
        return done

    def send(
        self,
        dest_party: str,
        data: Any,
        upstream_seq_id: Any,
        downstream_seq_id: Any,
        stream: Optional[str] = None,
        round_tag: Optional[int] = None,
        epoch_tag: Optional[int] = None,
        quant_meta: Optional[Dict[str, Any]] = None,
        blob_offer: bool = False,
        version_tag: Optional[int] = None,
    ) -> LocalRef:
        """Owner-initiated push.  Returns a LocalRef resolving to True/False.

        Failures are swallowed into ``False`` + a log line (parity:
        ``barriers.py:244-248``); the cleanup watchdog turns persistent
        failures into process exit when configured.  Beyond parity, a
        failed producer task or encode also poisons the promised key on
        the consumer (see :meth:`_send_poison`).

        ``stream``: a stable stream name routes the push through the
        per-peer delta cache (only changed chunks cross the wire — see
        :meth:`TransportClient._send_stream`).

        ``round_tag``: federated round index stamped into the frame's
        metadata (``wire.ROUND_TAG_KEY``) — with pipelined rounds one
        round's frames are still in flight while the next computes, and
        the tag is what keeps receiver logs and the overlap runner's
        same-round fallback attributable to the round that owns them.

        ``epoch_tag``: roster epoch stamped into the frame metadata
        (``wire.EPOCH_TAG_KEY``) — a receiver whose roster has advanced
        rejects the frame loudly instead of parking stale bytes (see
        :class:`RosterState`).

        ``quant_meta``: compact shared-quantization-grid descriptor
        stamped into the frame metadata (``wire.QUANT_GRID_KEY``,
        JSON-encoded) when the payload is integer codes on the round's
        shared grid — see :mod:`rayfed_tpu_torch.fl.quantize`.

        ``blob_offer``: let the object plane replace a large immutable
        payload with its fingerprint handle (pull-on-demand; see
        :meth:`send_many`).

        ``version_tag``: buffered-async MODEL VERSION stamped into the
        frame metadata (``wire.ASYNC_VERSION_KEY``) — broadcasts carry
        the version they publish, contributions the version they
        trained from, and the coordinator derives staleness from the
        pair (see :mod:`rayfed_tpu_torch.fl.async_rounds`).
        """
        return self.send_many(
            [dest_party], data, upstream_seq_id, downstream_seq_id,
            stream=stream, round_tag=round_tag, epoch_tag=epoch_tag,
            quant_meta=quant_meta, blob_offer=blob_offer,
            version_tag=version_tag,
        )[dest_party]

    def send_many(
        self,
        dest_parties: Sequence[str],
        data: Any,
        upstream_seq_id: Any,
        downstream_seq_id: Any,
        stream: Optional[str] = None,
        round_tag: Optional[int] = None,
        epoch_tag: Optional[int] = None,
        quant_meta: Optional[Dict[str, Any]] = None,
        blob_offer: bool = False,
        version_tag: Optional[int] = None,
    ) -> Dict[str, LocalRef]:
        """Fan one value out to N parties — encode once, send concurrently.

        The broadcast-on-get path used to encode (and device→host fetch,
        and checksum) the same value once PER destination; here the
        payload buffers are built once, lazy shards are wrapped so the
        device fetch runs once (:func:`wire.share_buffers`), and the N
        ``send_data`` coroutines run concurrently on the loop — each
        connection's writev in its own executor thread, so fan-out wall
        time approaches max(per-dest wire time) instead of the sum.

        Returns ``{party: LocalRef→bool}`` (one result per destination,
        same swallow-to-False semantics as :meth:`send`).

        ``blob_offer=True`` (the ``fed.get`` broadcast path): when the
        resolved value is a large immutable object (a plain PackedTree
        at or above ``JobConfig.blob_broadcast_min_bytes``), the object
        plane publishes its wire bytes content-addressed and the frame
        carries the small fingerprint HANDLE instead of the payload
        (stamped ``wire.BLOB_HANDLE_KEY``); receivers resolve the
        handle lazily — a content-cache hit transfers zero payload
        bytes, a miss pulls from this party via BLOB_GET.  See
        :mod:`rayfed_tpu_torch.transport.objectstore`.
        """
        dests = list(dest_parties)
        out_refs: Dict[str, LocalRef] = {p: LocalRef() for p in dests}
        self.stats["send_op_count"] += len(dests)
        send_meta: Optional[Dict[str, str]] = {}
        if round_tag is not None:
            send_meta[wire.ROUND_TAG_KEY] = str(round_tag)
        if epoch_tag is not None:
            send_meta[wire.EPOCH_TAG_KEY] = str(epoch_tag)
        if version_tag is not None:
            send_meta[wire.ASYNC_VERSION_KEY] = str(version_tag)
        if quant_meta is not None:
            import json as _json

            send_meta[wire.QUANT_GRID_KEY] = _json.dumps(
                quant_meta, separators=(",", ":"), sort_keys=True
            )
        send_meta = send_meta or None

        def _poison_all(exc: BaseException) -> None:
            for p in dests:
                poison_ref = self._send_poison(
                    p, upstream_seq_id, downstream_seq_id, exc
                )
                # False only after the poison delivery settles —
                # otherwise shutdown's task-cancel races the in-flight
                # poison send.
                poison_ref.add_done_callback(
                    lambda _ref, p=p: out_refs[p].set_result(False)
                )

        def _encode_and_send(value: Any) -> None:
            final_meta = send_meta
            try:
                if blob_offer:
                    handle = self.objects.maybe_offer(
                        value, self._job.blob_broadcast_min_bytes
                    )
                    if handle is not None:
                        # Fingerprint first: the frame ships the small
                        # handle; the payload moves only for receivers
                        # that miss the content cache (pull-on-demand).
                        value = handle
                        final_meta = dict(send_meta or {})
                        final_meta[wire.BLOB_HANDLE_KEY] = handle["fp"]
                t_enc0 = time.perf_counter()
                bufs = wire.encode_payload(value, lazy_shards=True)
                if len(dests) > 1:
                    bufs = wire.share_buffers(bufs)
                nbytes = wire.payload_nbytes(bufs)
                streaming = any(
                    isinstance(b, wire.LazyBuffer) for b in bufs
                ) or nbytes >= wire.SHARD_STREAM_THRESHOLD
                snapshot = None
                if stream is not None and len(dests) > 1:
                    # ONE contiguous snapshot + chunk-CRC pass (codec
                    # thread), shared by every destination's delta
                    # cache — the fan-out contract of this method.
                    # Single-destination stream sends skip it: the
                    # client snapshots into its reusable per-(dest,
                    # stream) send arena instead (zero per-round
                    # allocation, pipelined with the stripe frames).
                    stages = telemetry.frame_spans(
                        party=self._party, peer=None, stream=stream
                    )
                    snapshot = TransportClient.snapshot_stream_payload(
                        bufs, stages
                    )
                    if stages is not None:
                        # The fan-out's shared frame work: no one peer's.
                        stages.close(nbytes)
                self.stats["send_encode_s"] += time.perf_counter() - t_enc0
                crc = None
                if stream is None and not streaming and self._get_client(
                    dests[0]
                ).checksum_enabled:
                    # Small payloads: checksum once on the codec thread,
                    # shared by every destination.  Streamed payloads
                    # chain their CRC per chunk overlapped with the
                    # socket write (TransportClient._write_frame).
                    from rayfed_tpu_torch import native

                    crc = native.crc32c_multi(bufs)
            except Exception as e:
                logger.warning("[%s] failed to encode payload for %s: %r",
                               self._party, dests, e)
                _poison_all(e)
                return

            def _dispatch_one(p: str) -> None:
                """One destination's write: client construction +
                coroutine scheduling, off the shared encode thread.

                These used to be issued sequentially after the shared
                encode/CRC pass — a slow client construction (TLS
                context, native warmup) or a long dispatch queue for
                destination k delayed the FIRST byte to destinations
                k+1..N.  Each destination now dispatches on its own
                executor slot, and its wall time (dispatch → ACK) is
                accounted per destination in ``get_stats()``.
                """
                t0 = time.perf_counter()
                try:
                    client = self._get_client(p)
                    # Coalesced wake: an N-way fan-out arms the loop
                    # once, not once per destination (local.py batcher).
                    cf = local.post_coroutine(
                        self._loop,
                        client.send_data(bufs, str(upstream_seq_id),
                                         str(downstream_seq_id), crc=crc,
                                         metadata=final_meta,
                                         stream=stream,
                                         stream_snapshot=snapshot),
                    )
                except Exception as e:  # pragma: no cover - construction
                    logger.warning(
                        "[%s] cannot send to %s (up=%s down=%s): %r",
                        self._party, p, upstream_seq_id, downstream_seq_id,
                        e,
                    )
                    out_refs[p].set_result(False)
                    return

                def _done(f):
                    dt = time.perf_counter() - t0
                    with self._dest_lock:
                        self._dest_seconds[p] = (
                            self._dest_seconds.get(p, 0.0) + dt
                        )
                        self._dest_ops[p] = self._dest_ops.get(p, 0) + 1
                    _tr = telemetry.active()
                    try:
                        f.result()
                        self._peers_acked.add(p)
                        self.stats["send_bytes"] += nbytes
                        self.stats["send_seconds"] += dt
                        self.transfer_log.record(
                            "send", p, upstream_seq_id,
                            downstream_seq_id, nbytes, dt,
                        )
                        if _tr is not None:
                            _tr.emit(
                                "wire.send", party=self._party, peer=p,
                                stream=stream, nbytes=nbytes,
                                t_start=time.time() - dt, dur_s=dt,
                                round=round_tag, epoch=epoch_tag,
                            )
                        out_refs[p].set_result(True)
                    except Exception as e:
                        logger.warning(
                            "[%s] failed to send to %s (up=%s down=%s%s): %r",
                            self._party, p, upstream_seq_id,
                            downstream_seq_id,
                            "" if round_tag is None
                            else f" round={round_tag}", e,
                        )
                        if _tr is not None:
                            _tr.emit(
                                "wire.send", party=self._party, peer=p,
                                stream=stream, nbytes=nbytes,
                                t_start=time.time() - dt, dur_s=dt,
                                round=round_tag, epoch=epoch_tag,
                                outcome="error",
                                detail={"error": repr(e)},
                            )
                        out_refs[p].set_result(False)

                cf.add_done_callback(_done)

            if len(dests) == 1:
                _dispatch_one(dests[0])  # no second hop for the 1:1 path
            else:
                for p in dests:
                    self._codec_pool.submit(_dispatch_one, p)

        if isinstance(data, LocalRef):
            def _on_data(ref: LocalRef) -> None:
                exc = ref.exception()
                if exc is not None:
                    logger.warning(
                        "[%s] upstream task failed; cannot send to %s: %r",
                        self._party, dests, exc,
                    )
                    _poison_all(exc)
                    return
                self._codec_pool.submit(_encode_and_send, ref.resolve())

            data.add_done_callback(_on_data)
        else:
            # A value produced on this thread: order its CUDA work before
            # the codec thread's copies (a task's result was fenced on
            # its worker thread by the executor).
            fence_for_handoff(data)
            self._codec_pool.submit(_encode_and_send, data)
        return out_refs

    # -- recv path (RecvProxy role) ------------------------------------------

    def recv(
        self,
        src_party: str,
        upstream_seq_id: Any,
        downstream_seq_id: Any,
    ) -> LocalRef:
        """Park until the owner's push lands; resolves to the decoded value."""
        allowed = self._cluster.serializing_allowed_list
        device_put = self._job.device_put_received

        t_req = time.time()
        # post_coroutine, not run_coroutine_threadsafe: a round's worth
        # of parked recvs (N-1 in a hierarchy region) arms the loop once.
        cf = local.post_coroutine(
            self._loop,
            self._mailbox.get(
                str(upstream_seq_id),
                str(downstream_seq_id),
                # Backstop deadline: an abandoned recv surfaces as an
                # error instead of a parked coroutine leaking forever.
                timeout_s=self._job.recv_backstop_s,
                # Lets the health monitor fail exactly this waiter when
                # src_party dies (peer-death fail-fast).
                src_party=src_party,
            ),
        )
        # Delivery timestamp for the mailbox.wait span: _decode runs on
        # the codec pool AFTER a queue hop, so stamping inside it would
        # bill decode-pool backlog as "the peer had not pushed yet" —
        # exactly the misattribution the recorder exists to prevent.
        t_delivered: list = []
        if telemetry.active() is not None:
            cf.add_done_callback(lambda _f: t_delivered.append(time.time()))

        def _decode(message: Message) -> Any:
            _tr = telemetry.active()
            if _tr is not None:
                # The mailbox park (request → delivery) and the socket-
                # read wall are the receiver's two waits: the first is
                # "the peer had not pushed yet", the second "the bytes
                # were in flight".  Round/epoch attribution rides the
                # frame's own metadata tags.
                meta = message.metadata or {}
                rnd = meta.get(wire.ROUND_TAG_KEY)
                ep = meta.get(wire.EPOCH_TAG_KEY)
                # Buffered-async frames carry a model version instead
                # of a round tag — surface it as the round so the
                # flight recorder's per-round pages become per-version
                # pages with no schema change.
                if rnd is None:
                    rnd = meta.get(wire.ASYNC_VERSION_KEY)
                kw = dict(
                    party=self._party, peer=message.src_party,
                    stream=str(upstream_seq_id),
                    round=int(rnd) if rnd is not None else None,
                    epoch=int(ep) if ep is not None else None,
                    outcome="error" if message.error is not None else "ok",
                )
                now = t_delivered[0] if t_delivered else time.time()
                _tr.emit(
                    "mailbox.wait", t_start=t_req,
                    dur_s=max(0.0, now - t_req), **kw,
                )
                if message.error is None:
                    _tr.emit(
                        "wire.read",
                        t_start=now - float(message.read_seconds or 0.0),
                        dur_s=float(message.read_seconds or 0.0),
                        nbytes=len(message.payload), **kw,
                    )
            if message.error is not None:
                from rayfed_tpu_torch.exceptions import RemoteError

                raise RemoteError.from_wire(message.error)
            mesh = self.mesh_provider() if self.mesh_provider else None
            value = wire.decode_payload(
                message.payload,
                allowed=allowed,
                device_put=device_put,
                device=self.device,
                mesh=mesh,
                zero_copy=self._job.zero_copy_host_arrays,
            )
            # Denominator = socket-read wall time (honest wire GB/s
            # at the receiver); decode runs here but is not billed.
            self.transfer_log.record(
                "recv", message.src_party, upstream_seq_id,
                downstream_seq_id, len(message.payload),
                message.read_seconds,
            )
            return value

        # Decode on the codec pool, never the event loop; a packed tree
        # (fl.compression.PackedTree) comes back as ONE zero-copy buffer
        # view + skeleton here — no per-leaf intermediate copies.
        return LocalRef(cf).then(_decode, executor=self._codec_pool)

    def recv_stream(
        self,
        src_party: str,
        upstream_seq_id: Any,
        downstream_seq_id: Any,
        sink: Any,
    ) -> None:
        """Chunk-granular receive: attach ``sink`` to one rendezvous.

        Instead of parking a recv and decoding the complete payload, the
        sink sees payload bytes AS THEY LAND on the wire
        (``on_bytes(view, total)`` from transport threads, then
        ``on_complete(payload)`` / ``on_error(err)``) — the hook the
        streaming aggregator builds on.  A push that raced in before
        registration is taken from the mailbox and delivered whole.  Do
        not also call :meth:`recv` on the same key.

        ``src_party`` enrolls the key with the health monitor: if the
        source dies mid-stream, the sink's ``on_error`` fires with the
        peer-death error instead of waiting out the recv backstop (the
        chunk-sink analogue of the mailbox's fail-fast).
        """
        self.recv_stream_many(
            [(src_party, upstream_seq_id, downstream_seq_id, sink)]
        )

    def recv_stream_many(self, entries: Sequence[tuple]) -> None:
        """Register many ``(src_party, up, down, sink)`` chunk sinks in
        ONE loop hop — the stripe demux of a ring round: a stripe
        owner's N-1 contribution sinks attach in a single scheduling
        round trip, so no early-arriving stripe pays an extra
        cross-thread latency per source.  Semantics per entry are
        exactly :meth:`recv_stream`."""
        prepared = [
            (str(src), (str(up), str(down)), sink)
            for src, up, down, sink in entries
        ]

        def _on_loop() -> None:
            for src, key, sink in prepared:
                msg = self._mailbox.try_take(key)
                if msg is not None:
                    try:
                        if msg.error is not None:
                            sink.on_error(msg.error)
                        else:
                            sink.on_complete(msg.payload)
                    except Exception:  # pragma: no cover - sink bug
                        logger.exception(
                            "[%s] stream sink failed on mailbox replay",
                            self._party,
                        )
                    continue
                err = self._mailbox.party_failure(src)
                if err is not None:
                    # The source was ALREADY declared dead (e.g. a ring
                    # fallback re-receiving from the peer that killed the
                    # ring round): fail the sink now, exactly like
                    # Mailbox.get fails a fresh recv on a dead party —
                    # the monitor only fires on the alive→dead
                    # transition, so a sink registered after it would
                    # otherwise park until the recv backstop.  Raced-in
                    # real data (above) is still preferred, like get's.
                    self._mailbox.stats["peer_failed_recvs"] += 1
                    try:
                        sink.on_error(err)
                    except Exception:  # pragma: no cover - sink bug
                        logger.exception(
                            "[%s] stream sink failed on dead-party "
                            "fast-fail", self._party,
                        )
                    continue
                self._server.register_chunk_sink(key, sink)
                self._stream_srcs[key] = src

        self._loop.call_soon_threadsafe(_on_loop)

    def cancel_stream(
        self, upstream_seq_id: Any, downstream_seq_id: Any
    ) -> None:
        """Detach a sink registered by :meth:`recv_stream` (timeout paths)."""
        key = (str(upstream_seq_id), str(downstream_seq_id))

        def _on_loop() -> None:
            self._server.unregister_chunk_sink(key)
            self._stream_srcs.pop(key, None)

        self._loop.call_soon_threadsafe(_on_loop)

    # -- elastic membership (roster control plane) ----------------------------

    def _observe_membership(self, message) -> bool:
        """Server observer (loop thread): membership requests — keys
        prefixed :data:`ROSTER_REQ_PREFIX` — go to the inbox, not the
        mailbox (the coordinator polls the inbox at round boundaries;
        a mailbox rendezvous would need the recv side to know the
        sender's nonce in advance)."""
        if not str(message.upstream_seq_id).startswith(ROSTER_REQ_PREFIX):
            return False
        if message.error is not None:
            return True  # a poisoned control key carries nothing to act on
        self._membership_inbox.append(message)
        return True

    def drain_membership_requests(self) -> list:
        """Decoded membership requests received since the last drain —
        each a dict like ``{"op": "join"|"leave", "party": ..., "nonce":
        ...}``.  Any thread; arrival order preserved."""
        out = []
        while True:
            try:
                msg = self._membership_inbox.popleft()
            except IndexError:
                break
            try:
                req = wire.decode_payload(
                    msg.payload,
                    allowed=self._cluster.serializing_allowed_list,
                    device_put=False,
                )
                if isinstance(req, dict):
                    out.append(req)
                else:
                    logger.warning(
                        "[%s] malformed membership request from %s: %r",
                        self._party, msg.src_party, type(req).__name__,
                    )
            except Exception:
                logger.exception(
                    "[%s] failed to decode membership request from %s",
                    self._party, msg.src_party,
                )
        return out

    def ring_neighbors(
        self, parties: Optional[Sequence[str]] = None,
        party: Optional[str] = None,
    ) -> tuple:
        """``(predecessor, successor)`` of ``party`` (default: this
        party) on the sorted ring of ``parties`` (default: the whole
        cluster) — see module-level :func:`ring_neighbors`."""
        return ring_neighbors(
            parties if parties is not None else list(self._cluster.parties),
            party or self._party,
        )

    # -- readiness ------------------------------------------------------------

    def ping(self, dest_party: str, timeout_s: float = 1.0) -> bool:
        cf = asyncio.run_coroutine_threadsafe(
            self._get_client(dest_party).ping(timeout_s), self._loop
        )
        try:
            return cf.result(timeout=timeout_s + 5)
        except Exception:
            return False

    def ensure_secagg_peer_keys(
        self, parties: Sequence[str], timeout_s: float = 30.0
    ) -> None:
        """Establish the pairwise secure-aggregation key state with
        every listed peer before the first masked round.

        Key agreement rides the connection HELLO (``wire.
        SECAGG_PUB_KEY``), so one successful ping per missing pair is
        enough: our HELLO hands the peer our key, its reply hands us
        its.  Peers whose keys are already recorded cost nothing.
        Raises :class:`~rayfed_tpu_torch.transport.secagg.SecAggError` naming
        every peer still missing at the deadline — masks derived
        without the pair state could never cancel.
        """
        deadline = time.monotonic() + float(timeout_s)
        missing = [
            p for p in parties
            if p != self._party and not self.secagg_keys.has_peer(p)
        ]
        while missing:
            for p in list(missing):
                if self.ping(p, timeout_s=2.0) and (
                    self.secagg_keys.has_peer(p)
                ):
                    missing.remove(p)
            if not missing:
                return
            if time.monotonic() >= deadline:
                raise secagg_keys.SecAggError(
                    f"[{self._party}] no secure-aggregation key from "
                    f"{sorted(missing)} after {timeout_s:.0f}s — the "
                    f"peers are unreachable or run a build without the "
                    f"secagg HELLO advertisement"
                )
            time.sleep(0.2)

    # -- flight-recorder trace collection -------------------------------------

    _TRACE_REQ_PREFIX = "trace.req."
    _TRACE_REPLY_PREFIX = "trace.put."
    _TRACE_DOWN = "trace"

    def _observe_trace_request(self, message) -> bool:
        """Server observer (transport loop thread): TRACE_GET request
        frames — identified by their ``wire.TRACE_GET_KEY`` metadata —
        are consumed here (ACKed, never enter the mailbox) and served
        off-loop from the flight-recorder ring."""
        import json as _json

        raw = (message.metadata or {}).get(wire.TRACE_GET_KEY)
        if raw is None:
            return False
        if message.error is not None:
            return True  # a poisoned request carries nothing to serve
        try:
            req = telemetry.check_trace_request(_json.loads(raw))
        except Exception as exc:
            logger.warning(
                "[%s] malformed TRACE_GET request from %s: %r",
                self._party, message.src_party, raw,
            )
            # Best-effort error reply: a silent consume would leave the
            # collector parked for its FULL per-peer timeout (a
            # version-skewed peer is exactly when you want the reason
            # fast).  Only possible when the reply key survived the
            # parse failure.
            rk = None
            try:
                maybe = _json.loads(raw)
                if isinstance(maybe, dict) and isinstance(
                    maybe.get("rk"), str
                ):
                    rk = maybe["rk"]
            except Exception:
                pass
            if rk is not None:
                self._codec_pool.submit(
                    self._serve_trace_error, message.src_party, rk,
                    f"malformed trace request: {exc!r}",
                )
            return True
        self._codec_pool.submit(self._serve_trace, message.src_party, req)
        return True

    def _serve_trace_error(
        self, requester: str, reply_key: str, err: str,
    ) -> None:
        """Codec-pool thread: push an err-marked empty reply so the
        collector fails fast instead of waiting out its timeout."""
        rep = telemetry.make_trace_reply_meta(
            self._party, 0, armed=telemetry.installed() is not None,
            err=err,
        )
        self._push_trace_reply(
            requester, reply_key, telemetry.encode_records([]), rep,
        )

    def _serve_trace(self, requester: str, req: Dict[str, Any]) -> None:
        """Codec-pool thread: push this party's ring window (or an
        empty, armed=False-marked window when the recorder is disarmed)
        to the requester's reply key."""
        try:
            rec = telemetry.installed()
            rounds = req["rnd"]
            if rec is not None:
                window = [
                    r for r in rec.records(
                        rounds=None if rounds is None else tuple(rounds)
                    )
                    if r.party is None or r.party == self._party
                ]
            else:
                window = []
            payload = telemetry.encode_records(window)
            rep = telemetry.make_trace_reply_meta(
                self._party, len(window), armed=rec is not None
            )
        except Exception as exc:
            logger.exception(
                "[%s] trace window for %s could not be built",
                self._party, requester,
            )
            self._serve_trace_error(
                requester, req["rk"], f"trace serve failed: {exc!r}"
            )
            return
        self._push_trace_reply(requester, req["rk"], payload, rep)

    def _push_trace_reply(
        self, requester: str, reply_key: str, payload: bytes,
        rep: Dict[str, Any],
    ) -> None:
        import json as _json

        metadata = {
            wire.TRACE_PUT_KEY: _json.dumps(
                rep, separators=(",", ":"), sort_keys=True
            )
        }
        try:
            client = self._get_client(requester)
            cf = asyncio.run_coroutine_threadsafe(
                client.send_data(
                    [payload], reply_key, self._TRACE_DOWN,
                    metadata=metadata,
                ),
                self._loop,
            )
        except Exception:
            logger.exception(
                "[%s] trace serve to %s could not be dispatched",
                self._party, requester,
            )
            return

        def _done(f) -> None:
            exc = (
                f.exception() if not f.cancelled()
                else asyncio.CancelledError("transport stopped")
            )
            if exc is not None:
                # Best-effort: the collector's per-peer timeout governs.
                logger.warning(
                    "[%s] trace serve to %s failed: %r",
                    self._party, requester, exc,
                )

        cf.add_done_callback(_done)

    def discard_empty_park(self, upstream: Any, downstream: Any) -> None:
        """Loop-side cleanup for a CANCELLED rendezvous park (trace
        pulls, object-plane pulls): a cancelled ``Mailbox.get`` would
        otherwise leave an empty entry whose ``expected_src`` keeps the
        health monitor pinging the peer forever.  Raced-in real data
        (message present) is left for the TTL gc.  ONE copy of the
        entry-semantics poke — the two pull protocols must not diverge
        on it."""
        key = (str(upstream), str(downstream))

        def _discard() -> None:
            entry = self._mailbox._entries.get(key)
            if entry is not None and entry.message is None:
                self._mailbox._entries.pop(key, None)

        self._loop.call_soon_threadsafe(_discard)

    def collect_trace(
        self, peer: str, rounds: Any = None,
        timeout_s: Optional[float] = None,
    ) -> tuple:
        """One TRACE_GET round trip against one peer: returns
        ``(records, clock_offset, reply_meta)``.

        The reply wait parks in the mailbox WITH the peer named
        (``src_party``), so a monitor-declared-dead peer fails the
        collection leg immediately instead of waiting out the timeout.
        The round trip doubles as the clock-offset sample: the request
        stamps our wall clock at send, the reply stamps the peer's at
        serve, and :func:`telemetry.estimate_clock_offset` bounds the
        error at RTT/2.
        """
        import json as _json
        import uuid as _uuid

        timeout = (
            float(timeout_s) if timeout_s is not None
            else float(self._job.cross_silo_timeout_s)
        )
        nonce = _uuid.uuid4().hex
        reply_up = f"{self._TRACE_REPLY_PREFIX}{self._party}.{nonce}"
        recv_cf = asyncio.run_coroutine_threadsafe(
            self._mailbox.get(
                reply_up, self._TRACE_DOWN, timeout_s=timeout,
                src_party=peer,
            ),
            self._loop,
        )
        t_send = time.time()
        req = telemetry.make_trace_request(
            reply_up, rounds=rounds, t_send=t_send
        )
        metadata = {
            wire.TRACE_GET_KEY: _json.dumps(
                req, separators=(",", ":"), sort_keys=True
            )
        }
        try:
            client = self._get_client(peer)
            send_cf = asyncio.run_coroutine_threadsafe(
                client.send_data(
                    [], f"{self._TRACE_REQ_PREFIX}{self._party}.{nonce}",
                    self._TRACE_DOWN, metadata=metadata,
                ),
                self._loop,
            )
            send_cf.result(timeout=timeout)
        except Exception as exc:
            recv_cf.cancel()
            self.discard_empty_park(reply_up, self._TRACE_DOWN)
            raise telemetry.TelemetryError(
                f"trace request to {peer!r} could not be delivered: "
                f"{exc!r}"
            ) from exc
        try:
            msg = recv_cf.result(timeout=timeout + 5)
        except Exception as exc:
            raise telemetry.TelemetryError(
                f"no trace reply from {peer!r} within {timeout}s: {exc!r}"
            ) from exc
        t_recv = time.time()
        if msg.error is not None:
            raise telemetry.TelemetryError(
                f"trace collection from {peer!r} failed: "
                f"{msg.error.get('msg', msg.error)}"
            )
        raw_rep = (msg.metadata or {}).get(wire.TRACE_PUT_KEY)
        if raw_rep is None:
            raise telemetry.TelemetryError(
                f"trace reply from {peer!r} carries no "
                f"{wire.TRACE_PUT_KEY!r} metadata"
            )
        rep = telemetry.check_trace_reply_meta(_json.loads(raw_rep))
        if rep["err"]:
            raise telemetry.TelemetryError(
                f"{peer!r} could not serve its trace window: {rep['err']}"
            )
        records = telemetry.decode_records(msg.payload)
        offset = telemetry.estimate_clock_offset(t_send, t_recv, rep["tw"])
        return records, offset, rep

    def get_stats(self) -> Dict[str, Any]:
        stats = dict(self.stats)
        stats.update(self._server.stats)
        stats.update(self._mailbox.stats)  # dups, expiries, peer fails
        stats["pending_recvs"] = self._mailbox.pending_count()
        # Send-pipeline decomposition summed over per-peer clients:
        # prepare (device→host fetch + checksum) + write > frame wall
        # means the chunk pipeline overlapped them; the saved seconds
        # are the overlap win vs a serialized encode→checksum→write.
        with self._clients_lock:
            clients = list(self._clients.values())
        for key in (
            "send_frames", "send_payload_bytes", "send_prepare_s",
            "send_write_s", "send_frame_wall_s",
            "delta_stream_frames", "delta_full_frames",
            "delta_logical_bytes", "delta_wire_bytes",
            "send_d2h_s", "send_copy_s", "send_crc_s",
            "send_loop_wait_s", "send_socket_s",
            "send_striped_payloads", "send_stripe_frames",
        ):
            stats[key] = sum(c.stats[key] for c in clients)
        # Send-path stage breakdown (ISSUE 5's can't-silently-reopen
        # telemetry): where every second between "payload ready" and
        # "bytes on the wire" went.  encode = pytree→wire buffers
        # (codec pool) + arena/gather copies; d2h = device→host
        # fetches; crc = all checksum passes; loop_wait = produced
        # chunks waiting for a rail/loop slot; socket = writev/drain.
        stats["send_path_breakdown_ms"] = {
            "encode_ms": round(
                (stats["send_encode_s"] + stats["send_copy_s"]) * 1e3, 2
            ),
            "d2h_ms": round(stats["send_d2h_s"] * 1e3, 2),
            "crc_ms": round(stats["send_crc_s"] * 1e3, 2),
            "loop_wait_ms": round(stats["send_loop_wait_s"] * 1e3, 2),
            "socket_ms": round(stats["send_socket_s"] * 1e3, 2),
        }
        # Same stages split per transport backend (local-link fast
        # path): the tcp/uds/shm rows sum to the totals above minus the
        # codec-pool encode (which runs before the backend is chosen),
        # so a local-link regression is attributable from metrics
        # alone.  For shm, socket_ms is the handoff→ACK wait.
        stats["send_path_breakdown_by_backend_ms"] = {
            b: {
                "encode_ms": round(
                    sum(c.stats[f"send_copy_s_{b}"] for c in clients) * 1e3,
                    2,
                ),
                "d2h_ms": round(
                    sum(c.stats[f"send_d2h_s_{b}"] for c in clients) * 1e3, 2
                ),
                "crc_ms": round(
                    sum(c.stats[f"send_crc_s_{b}"] for c in clients) * 1e3, 2
                ),
                "loop_wait_ms": round(
                    sum(c.stats[f"send_loop_wait_s_{b}"] for c in clients)
                    * 1e3,
                    2,
                ),
                "socket_ms": round(
                    sum(c.stats[f"send_socket_s_{b}"] for c in clients)
                    * 1e3,
                    2,
                ),
            }
            for b in ("tcp", "uds", "shm")
        }
        # Fraction of stream-send logical bytes the delta cache kept off
        # the wire (0.0 when no stream sends happened).
        logical = stats["delta_logical_bytes"]
        stats["delta_bytes_saved_frac"] = (
            (logical - stats["delta_wire_bytes"]) / logical
            if logical > 0
            else 0.0
        )
        stats["send_overlap_saved_s"] = max(
            0.0,
            stats["send_prepare_s"] + stats["send_write_s"]
            - stats["send_frame_wall_s"],
        )
        # Per-destination send wall (dispatch → ACK), cumulative: the
        # fan-out / ring hop diagnostic — which peer does this party
        # actually wait on.  Snapshots, not the live dicts (mutated
        # from send callbacks).
        with self._dest_lock:
            stats["send_dest_seconds"] = dict(self._dest_seconds)
            stats["send_dest_ops"] = dict(self._dest_ops)
        # Snapshot, not the live dict: get_stats runs on user threads
        # while the loop-thread health monitor mutates the dead set.
        stats["dead_parties"] = sorted(self._mailbox.dead_parties_snapshot())
        # Secure-aggregation key-agreement state: this party's suite and
        # which peers have completed the HELLO key exchange (the
        # operator's "why can't these two mask" diagnostic).
        stats["secagg"] = self.secagg_keys.describe()
        # Content-addressed object plane: cache hit/miss, pull/serve and
        # eviction counters (the "did the handle actually save bytes"
        # diagnostic — also what the rejoin bench gates read).
        stats["object_plane"] = self.objects.stats_snapshot()
        # Flight recorder: ring occupancy/drop counters when armed (the
        # "is my trace window still complete" diagnostic), a loud
        # armed=False marker otherwise.
        rec = telemetry.installed()
        stats["telemetry"] = (
            rec.stats() if rec is not None else {"trace_armed": False}
        )
        return stats
