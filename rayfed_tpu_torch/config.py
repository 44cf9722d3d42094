"""Cluster / job configuration.

The reference round-trips two cloudpickled dicts through Ray's internal KV
(``fed/api.py:179-195`` → ``fed/config.py:54-79``) because its proxies live
in separate Ray worker processes.  Our process model is one controller per
party, so config is a plain in-process struct attached to the Runtime; the
*shape* of the config (cluster addresses, per-party overrides, TLS, retry
policy, serialization allowlist, message caps, timeouts) is preserved.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


DEFAULT_MAX_MESSAGE_SIZE = 500 * 1024 * 1024  # parity: grpc_options.py:27-28
DEFAULT_CROSS_SILO_TIMEOUT_S = 60  # parity: api.py:49


@dataclasses.dataclass
class RetryPolicy:
    """Client retry policy for cross-silo sends.

    Defaults mirror the reference's gRPC service config
    (``fed/_private/grpc_options.py:17-23``): 5 attempts, 5s initial
    backoff, 30s max, ×2 multiplier, retry on transport unavailability.

    ``jitter`` (default on) decorrelates the delays: N parties that all
    hit the same dead peer otherwise retry in lockstep — every backoff
    wave lands the reconnect storm at the same instant the peer comes
    back.  Uses the "decorrelated jitter" recurrence
    ``sleep = min(cap, U(base, 3·prev))`` rather than plain
    ``exp × U(0,1)``: successive delays still grow toward the cap, but
    two clients' sequences diverge after the first draw.
    """

    max_attempts: int = 5
    initial_backoff_s: float = 5.0
    max_backoff_s: float = 30.0
    backoff_multiplier: float = 2.0
    jitter: bool = True

    def next_backoff(
        self, prev: Optional[float], rng: Optional[Any] = None
    ) -> float:
        """Delay before the next attempt given the previous delay
        (``None`` for the first retry).  With ``jitter=False`` this is
        the exact legacy exponential sequence."""
        if not self.jitter:
            if prev is None:
                return self.initial_backoff_s
            return min(
                prev * self.backoff_multiplier, self.max_backoff_s
            )
        import random

        rng = rng if rng is not None else random
        lo = self.initial_backoff_s
        hi = max(lo, 3.0 * (prev if prev is not None else lo))
        return min(self.max_backoff_s, rng.uniform(lo, hi))

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "RetryPolicy":
        if not d:
            return cls()

        def _dur(v, default):
            # Accept gRPC-style "5s" strings for drop-in compat.
            if v is None:
                return default
            if isinstance(v, str) and v.endswith("s"):
                return float(v[:-1])
            return float(v)

        return cls(
            max_attempts=int(d.get("maxAttempts", d.get("max_attempts", 5))),
            initial_backoff_s=_dur(
                d.get("initialBackoff", d.get("initial_backoff_s")), 5.0
            ),
            max_backoff_s=_dur(d.get("maxBackoff", d.get("max_backoff_s")), 30.0),
            backoff_multiplier=float(
                d.get("backoffMultiplier", d.get("backoff_multiplier", 2.0))
            ),
            jitter=bool(d.get("retryJitter", d.get("jitter", True))),
        )


@dataclasses.dataclass
class PartyConfig:
    """Per-party entry in the cluster map (reference ``api.py:61-96``)."""

    address: str
    listen_addr: Optional[str] = None  # bind addr if different from advertised
    metadata: Dict[str, str] = dataclasses.field(default_factory=dict)
    transport_options: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PartyConfig":
        return cls(
            address=d["address"],
            listen_addr=d.get("listen_addr"),
            metadata=dict(d.get("metadata") or d.get("grpc_metadata") or {}),
            transport_options=dict(
                d.get("transport_options") or d.get("grpc_options") or {}
            ),
        )


@dataclasses.dataclass
class ClusterConfig:
    """Resolved cluster topology + security config for one job."""

    parties: Dict[str, PartyConfig]
    current_party: str
    tls_config: Optional[Dict[str, str]] = None
    serializing_allowed_list: Optional[Dict[str, Any]] = None

    @property
    def cluster_addresses(self) -> Dict[str, str]:
        return {p: c.address for p, c in self.parties.items()}

    def other_parties(self) -> List[str]:
        return [p for p in self.parties if p != self.current_party]

    def party_config(self, party: str) -> PartyConfig:
        return self.parties[party]


@dataclasses.dataclass
class JobConfig:
    """Job-wide knobs (reference ``fed/config.py:17-51``)."""

    cross_silo_timeout_s: float = DEFAULT_CROSS_SILO_TIMEOUT_S
    cross_silo_messages_max_size: int = DEFAULT_MAX_MESSAGE_SIZE
    retry_policy: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    metadata: Dict[str, str] = dataclasses.field(default_factory=dict)
    exit_on_failure_sending: bool = False
    wait_for_ready: bool = False
    # Put received tensor payloads on the party's device eagerly.
    device_put_received: bool = True
    # With device_put_received=False, decode shard-streamed leaves as
    # READONLY views aliasing the wire buffer when their layout allows
    # (no assembly copy).  Opt-in: consumers that mutate received host
    # arrays in place need the default writable copies.
    zero_copy_host_arrays: bool = False
    # Per-link transport backend (transport/local.py): "auto" upgrades
    # a link to the peer's AF_UNIX listener (same host, proven via the
    # HELLO colocation advertisement) or the in-process shared-memory
    # handoff (same interpreter); "uds"/"shm" force one backend (loud
    # TCP fallback when it can't hold); "off" pins TCP.  Default off:
    # existing topologies keep their exact wire behavior unless opted
    # in here or per-party via transport_options={"local_link": ...}.
    local_link: str = "off"
    # Backstop deadline for a parked recv and TTL for unclaimed pushes.
    # Deliberately generous (peer *compute* time between rounds is
    # unbounded by the per-RPC timeout above); bounds leaked state from
    # desynced/dead peers without gating slow-but-healthy ones.
    recv_backstop_s: float = 3600.0
    mailbox_ttl_s: float = 3600.0
    # Peer-death fail-fast: while recvs are parked on a party, ping it
    # every peer_health_interval_s; after peer_death_pings consecutive
    # failures the pending recvs raise RemoteError naming the party
    # instead of parking until the backstop.  Pings probe the peer's
    # transport loop, not its task queue — slow compute can't trip this,
    # and a party only becomes eligible after it was reachable once
    # (startup skew parks, it doesn't kill).
    peer_failfast: bool = True
    peer_health_interval_s: float = 2.0
    peer_death_pings: int = 3
    # Content-addressed pull-on-demand object plane (transport/
    # objectstore.py).  blob_cache_budget_bytes bounds the per-party
    # content cache (pinned live-round state may exceed it; unpinned
    # entries evict LRU-first).  blob_broadcast_min_bytes: a fed.get
    # broadcast of a plain PackedTree at/above this size sends a
    # fingerprint HANDLE instead of the payload — receivers with a
    # content-cache hit transfer zero payload bytes, misses pull via
    # BLOB_GET.  None disables handle offers (required when any
    # RECEIVING party is a multi-host group: non-leader bridge
    # processes cannot pull).
    blob_cache_budget_bytes: int = 256 * 1024 * 1024
    blob_broadcast_min_bytes: Optional[int] = 8 * 1024 * 1024
    # Quorum rounds: publish each round's broadcast model into the
    # content cache on EVERY controller (one host copy + chunk-CRC +
    # sha256 per round) — what makes every member a named welcome
    # holder and a graceful leaver's rejoin warm.  Turn off for very
    # large models where that per-round cost outweighs rejoin savings:
    # welcomes still work (the coordinator publishes at welcome time;
    # member holders just reply miss → failover).
    blob_publish_round_models: bool = True
    # Federated flight recorder (rayfed_tpu_torch/telemetry.py): arm the
    # bounded span ring for this party at fed.init (the RAYFED_TRACE=1
    # env var arms it too, like RAYFED_CHAOS).  Disarmed, every
    # emission site costs one module-global read; armed, a span write
    # is a ring append — never a sleep, never I/O — so tracing adds
    # ~zero to the round wall (bench-gated: trace_overhead_frac
    # <= 0.03).  trace_capacity bounds the ring (records, not bytes).
    trace: bool = False
    trace_capacity: int = 16384
