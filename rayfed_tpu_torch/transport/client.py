"""Transport client — pooled, multiplexed, retrying connections per peer.

Plays the role of the reference's ``send_data_grpc`` channel
(``barriers.py:121-181``) plus its gRPC service-config retry policy
(``grpc_options.py:17-23``): attempts with exponential backoff on
transport unavailability, a per-RPC deadline, per-party metadata headers,
and a message-size cap.

Data plane: a small pool of connections per destination (concurrent
pushes to the same party ride different sockets instead of queuing behind
one write lock — no per-peer head-of-line blocking), and payload bytes
go to the kernel through the native vectored-write path
(``native.writev_full``: C++ writev with the GIL released) off the event
loop — no copy into asyncio's transport buffer.  TLS connections fall
back to the asyncio writer (the SSL layer owns the socket).  ACKs are
matched by request id on each connection's reader task.
"""

from __future__ import annotations

import asyncio
import collections
import itertools
import json
import logging
import ssl
import struct
import time
from typing import Any, Dict, List, Optional

from rayfed_tpu_torch import chaos
from rayfed_tpu_torch import telemetry
from rayfed_tpu_torch.config import RetryPolicy
from rayfed_tpu_torch.transport import local
from rayfed_tpu_torch.transport import wire

logger = logging.getLogger(__name__)

# Streamed payload bytes are cut into chunks of this size on the write
# path: the CRC of chunk k+1 (and the device→host fetch of the next
# lazy shard) runs in an executor thread while chunk k's writev blocks
# in another — the socket never waits on checksum/encode work and vice
# versa.  4 MB rides well above syscall overhead while keeping ~2 chunks
# of lookahead memory.
WRITE_CHUNK_BYTES = 4 * 1024 * 1024

# Delta-stream states retained per client: each holds a full payload
# snapshot, so a caller cycling stream names (against the keep-it-
# constant guidance) must evict instead of growing without bound.
# Mirrors the server's _MAX_DELTA_BASES.
_MAX_DELTA_STREAMS = 32

# Rails a striped payload fans out over — bounded so a generous
# connections_per_peer doesn't shred one payload into dozens of tiny
# interleaved flows (past ~4 rails a single sender saturates either the
# NIC or the CRC/copy stage anyway).
MAX_STRIPE_RAILS = 4

# Shared-memory sends at/under this size materialize INLINE on the
# event loop: the copy is a few µs, while an executor round trip costs
# two thread wakeups + GIL handoffs — pure overhead at stripe scale.
# Above it, the gather (and any device→host produce) moves off-loop so
# a large handoff can't stall unrelated traffic sharing the loop.
_INLINE_MATERIALIZE_BYTES = 256 * 1024


def _default_stripe_rails() -> int:
    """Host-adaptive rail count: striping pays only when spare cores
    run the per-rail CRC/copy stages concurrently with the socket
    writes.  On a 1-2 core host every rail shares one core AND the
    receiver pays an extra reassembly memcpy per byte — measured 2×
    SLOWER than the single-frame path there — so few-core hosts keep
    one rail (striping off) and the wire-v3 single-frame pipeline.
    The ``stripe_rails`` transport option overrides this (tests and
    the multirail bench force it)."""
    import os

    return max(1, min(MAX_STRIPE_RAILS, (os.cpu_count() or 2) // 2))


class SendError(ConnectionError):
    pass


class FatalSendError(SendError):
    """A send rejected by the peer for a non-transient reason — not retried."""


class ProtocolMismatchError(FatalSendError):
    """The peer speaks a different wire-protocol version.

    Raised from the connection HELLO handshake (wire v4) — naming both
    versions — instead of letting a mixed-version pair fail later with
    a confusing manifest-decode error mid-payload."""


class DeltaBaseError(SendError):
    """The receiver's delta base is missing/desynced (e.g. it restarted).

    Not a transport failure: the stream send path catches it and
    immediately re-sends the full payload, re-seeding both caches."""


class _SendArena:
    """Reusable page-aligned send buffer (anonymous mmap).

    mmap gives page alignment and lazily-faulted memory — the closest
    portable stand-in for a pinned DMA arena — and reuse across rounds
    keeps the pages hot instead of paying a fresh multi-MB allocation
    (plus its page-fault storm) per round, which is exactly the
    alloc+concat+copy the old snapshot path did."""

    __slots__ = ("mm", "size")

    def __init__(self, size: int) -> None:
        import mmap

        self.size = max(1, int(size))
        self.mm = mmap.mmap(-1, self.size)

    def view(self, size: int) -> memoryview:
        return memoryview(self.mm)[:size]


class _DeltaStream:
    """Last-ACKED payload snapshot for one (dest, stream) delta cache."""

    __slots__ = ("data", "ccrc", "fp", "lock", "arenas")

    def __init__(self) -> None:
        self.data: Optional[bytes] = None  # full payload the peer holds
        self.ccrc: Optional[List[int]] = None
        self.fp: int = 0
        # Serializes stream sends end-to-end (through the ACK): a delta
        # only makes sense against the receiver's CURRENT base, and two
        # in-flight sends on different pooled connections could arrive
        # reordered.
        self.lock = asyncio.Lock()
        # Two ping-pong send arenas: the next snapshot is written into
        # whichever slot the current base (self.data) does NOT alias, so
        # the base bytes stay stable for delta diffing and for the
        # receiver's retry semantics.  A failed send leaves the base
        # slot untouched and the next attempt reuses the other slot.
        self.arenas: List[Optional[_SendArena]] = [None, None]

    def writable_arena(self, size: int) -> memoryview:
        """A view over the arena slot not backing the current base."""
        base_obj = self.data.obj if isinstance(self.data, memoryview) else None
        for i, arena in enumerate(self.arenas):
            if arena is not None and arena.mm is base_obj:
                continue
            if arena is None or arena.size < size or arena.size > 2 * max(size, 1):
                arena = _SendArena(size)
                self.arenas[i] = arena
            return arena.view(size)
        # Unreachable (the base aliases at most one slot) — keep a safe
        # fallback rather than an assert on a hot path.
        arena = _SendArena(size)
        self.arenas[0] = arena
        return arena.view(size)


def _iter_chunk_views(payload_bufs: List, csz: int, timings: Dict[str, float], stages=None):
    """Yield ``(nbytes, [views])`` covering the payload in ``csz`` chunks.

    Buffers materialize lazily in walk order — a LazyBuffer's
    device→host fetch happens when the walk first reaches it, i.e.
    while earlier chunks are already on a socket — and a chunk spanning
    buffer boundaries yields multiple views (vectored write, no copy).
    ``timings["d2h"]`` accumulates the fetch seconds; ``stages`` (armed
    only) gets the fetches' stage spans (:func:`wire.fetch`).
    """
    cur: List = []
    cur_n = 0
    for buf in payload_bufs:
        mv, dt = wire.fetch(buf, stages)
        timings["d2h"] += dt
        off = 0
        while off < mv.nbytes:
            take = min(csz - cur_n, mv.nbytes - off)
            cur.append(mv[off : off + take])
            cur_n += take
            off += take
            if cur_n == csz:
                yield cur_n, cur
                cur, cur_n = [], 0
    if cur_n:
        yield cur_n, cur


def _resolve_ready(fut, item) -> None:
    if not fut.done():
        fut.set_result(item)


def _fail_ready(fut, exc) -> None:
    if not fut.done():
        fut.set_exception(exc)


class _Conn:
    """One pooled connection: socket, reader task, in-flight futures."""

    __slots__ = (
        "reader", "writer", "reader_task", "pending", "write_lock", "fd", "dead"
    )

    def __init__(self, reader, writer, fd: Optional[int]) -> None:
        self.reader = reader
        self.writer = writer
        self.fd = fd  # raw-writev path; None on TLS (SSL owns the socket)
        self.reader_task: Optional[asyncio.Task] = None
        self.pending: Dict[int, asyncio.Future] = {}
        self.write_lock = asyncio.Lock()
        self.dead = False  # teardown requested; close deferred past writes

    @property
    def busy(self) -> int:
        return len(self.pending) + (1 if self.write_lock.locked() else 0)

    @property
    def closed(self) -> bool:
        return self.dead or self.writer is None or self.writer.is_closing()


class TransportClient:
    def __init__(
        self,
        src_party: str,
        dest_party: str,
        address: str,
        retry_policy: RetryPolicy,
        timeout_s: float,
        max_message_size: int,
        metadata: Optional[Dict[str, str]] = None,
        ssl_context: Optional[ssl.SSLContext] = None,
        server_hostname: Optional[str] = None,
        checksum: Optional[bool] = None,
        pool_size: int = 2,
        loop: Optional[asyncio.AbstractEventLoop] = None,
        stripe_rails: Optional[int] = None,
        dead_check: Optional[Any] = None,
        secagg: Optional[Any] = None,
        local_link: str = "off",
        checksum_pinned: bool = False,
    ) -> None:
        if checksum is None:
            # Match the manager's policy: checksum only when the fast C++
            # CRC path is built.  A directly-constructed client otherwise
            # pays a ~MB/s pure-Python CRC on the event loop for a digest
            # that a native-less receiver skips verifying anyway.
            from rayfed_tpu_torch import native

            checksum = native.is_available()
        self._checksum = checksum
        # Local-link fast path (transport/local.py).  The backend is a
        # PER-LINK decision made once, on the first contact with the
        # destination: same process → shared-memory handoff; same host
        # (HELLO colocation proof) → the peer's AF_UNIX twin listener;
        # otherwise (or on any local-path failure) TCP, loudly.  CRC is
        # elided on adopted local links — the bytes never cross a wire —
        # unless the operator pinned `checksum` explicitly.  A TLS link
        # never upgrades: the operator asked for encryption, and an
        # AF_UNIX socket silently dropping it is not a fast path.
        local_link = str(local_link or "off").lower()
        if local_link not in local.LINK_MODES:
            logger.warning(
                "[%s] unknown local_link mode %r for %s; using 'off'",
                src_party, local_link, dest_party,
            )
            local_link = "off"
        if local_link != "off" and ssl_context is not None:
            logger.warning(
                "[%s] local_link=%r to %s disabled: the link is TLS and "
                "must not downgrade to a plaintext local socket",
                src_party, local_link, dest_party,
            )
            local_link = "off"
        self._local_mode = local_link
        self._local_decided = local_link == "off"
        self._link_backend = "tcp"  # tcp | uds | shm (live backend)
        self._local_endpoint: Optional[local.LocalEndpoint] = None
        self._uds_path: Optional[str] = None
        self._local_fallback: Optional[str] = None  # decision/fallback reason
        self._checksum_cfg = checksum  # restore on TCP fallback
        self._checksum_pinned = bool(checksum_pinned)
        self._src_party = src_party
        self._dest_party = dest_party
        host, _, port = address.rpartition(":")
        self._host = host
        self._port = int(port)
        self._retry_policy = retry_policy
        # Known-dead fast-fail: () -> bool, True while the destination
        # is declared dead by the health monitor (the manager wires the
        # mailbox's dead-party snapshot in).  A send still makes ONE
        # attempt — the snapshot lags recovery by up to a ping cycle —
        # but the backoff ladder is skipped: retrying a corpse burns the
        # full ladder (measured 65 s on poison pushes) for nothing, and
        # the monitor's pings, not sends, are what detect revival.
        self._dead_check = dead_check
        self._timeout_s = timeout_s
        self._max_message_size = max_message_size
        self._metadata = dict(metadata or {})
        self._ssl_context = ssl_context
        self._server_hostname = server_hostname
        # Event loop the coroutines run on, when known (the manager
        # passes its loop thread's).  Only send_data_async needs it —
        # the coroutine API is loop-agnostic as ever.
        self._loop = loop
        self._rid = itertools.count(1)
        # Stripe-payload generation ids (wire v4): monotonically
        # increasing, so the receiver can tell a retry's fresh stripe
        # group from a stale frame of the failed attempt.
        self._sid = itertools.count(1)
        # Version advertised in the connection HELLO handshake —
        # overridable so tests can exercise the mismatch path.
        self._proto_version = wire.WIRE_FORMAT_VERSION
        # Secure-aggregation key agreement (transport/secagg.py): when
        # set, every HELLO this client opens publishes the local key
        # advertisement and records the server's from the reply — one
        # connection establishes the pair's mask-seed state both ways.
        self._secagg = secagg
        self._conns: List[_Conn] = []
        self._conn_lock = asyncio.Lock()
        self._pool_size = max(1, int(pool_size))
        # Rails a striped payload fans over: explicit option, else the
        # host-adaptive default (1 on few-core hosts = striping off).
        self._stripe_rails_opt = (
            None if stripe_rails is None else max(1, int(stripe_rails))
        )
        # Dedicated control connection for health pings: a data
        # connection's write lock is held for a whole frame, so a ping
        # queued on the pool behind a multi-GB push would time out and
        # the health monitor would declare a busy-but-healthy peer
        # dead.  Opened lazily on the first ctl ping only — one-shot
        # readiness pings ride (and warm) the data pool instead.
        self._ctl_conn: Optional[_Conn] = None
        self._ctl_lock = asyncio.Lock()
        self._closed = False
        # Whole-operation in-flight send count (loop thread only):
        # incremented for the FULL span of every send_data call —
        # including producer fetches before the first frame, retry
        # backoffs, and connection opens, none of which show up in
        # per-connection pending/lock state.  The message-cap mutation
        # guard reads it so a cap change can't slip into one of those
        # windows and torn-apply to a payload legal when initiated.
        self._inflight_sends = 0
        # Per-(dest, stream) delta caches — the last payload the peer
        # ACKed on each stream, diffed against the next send so only
        # changed DELTA_CHUNK_BYTES ranges (+ a bitmap manifest) ship.
        # Bounded LRU (one full payload snapshot per entry); accessed on
        # the loop thread only.
        self._delta_streams: "collections.OrderedDict[str, _DeltaStream]" = (
            collections.OrderedDict()
        )
        # Send-pipeline accounting (loop-thread only): wall time of
        # payload frames vs the executor time spent preparing bytes
        # (device→host fetch + checksum) and writing them.  prepare +
        # write > wall means the chunk pipeline overlapped them.
        self.stats: Dict[str, Any] = {
            "send_frames": 0,
            "send_payload_bytes": 0,
            "send_prepare_s": 0.0,
            "send_write_s": 0.0,
            "send_frame_wall_s": 0.0,
            # Delta-cache accounting: logical payload bytes represented
            # by stream sends vs bytes actually shipped (changed chunks
            # + full re-seeds).  1 - wire/logical = the saved fraction.
            "delta_stream_frames": 0,
            "delta_full_frames": 0,
            "delta_logical_bytes": 0,
            "delta_wire_bytes": 0,
            # Send-path stage breakdown (the gap-can't-silently-reopen
            # telemetry): device→host fetch, arena/gather copy, CRC,
            # ready→write loop handoff wait, and raw socket time.
            "send_d2h_s": 0.0,
            "send_copy_s": 0.0,
            "send_crc_s": 0.0,
            "send_loop_wait_s": 0.0,
            "send_socket_s": 0.0,
            # Multi-rail striping accounting.
            "send_striped_payloads": 0,
            "send_stripe_frames": 0,
        }
        # Per-backend split of the stage breakdown (tcp/uds/shm): the
        # suffixed counters sum to the unsuffixed ones above, so a
        # local-link regression is attributable from metrics alone.
        # For shm, "socket" is the handoff→ACK wait (there is no
        # socket; the receiver's dispatch latency plays its role).
        for _b in ("tcp", "uds", "shm"):
            for _k in ("d2h", "copy", "crc", "loop_wait", "socket"):
                self.stats[f"send_{_k}_s_{_b}"] = 0.0

    def _bill_backend(
        self, backend: Optional[str] = None, d2h: float = 0.0,
        copy: float = 0.0, crc: float = 0.0, loop_wait: float = 0.0,
        socket: float = 0.0,
    ) -> None:
        """Accumulate stage seconds under the live backend's counters
        (the unsuffixed totals are billed by the callers as before)."""
        b = backend or self._link_backend
        st = self.stats
        if d2h:
            st[f"send_d2h_s_{b}"] += d2h
        if copy:
            st[f"send_copy_s_{b}"] += copy
        if crc:
            st[f"send_crc_s_{b}"] += crc
        if loop_wait:
            st[f"send_loop_wait_s_{b}"] += loop_wait
        if socket:
            st[f"send_socket_s_{b}"] += socket

    def local_link_info(self) -> Dict[str, Any]:
        """The link's backend decision, for effective_transport_options:
        configured mode, the live backend, whether the decision is made
        (first contact decides), and the fallback/decision reason."""
        return {
            "mode": self._local_mode,
            "backend": self._link_backend,
            "decided": self._local_decided,
            "fallback": self._local_fallback,
        }

    # -- local-link backend decision ------------------------------------------

    def _adopt_local(self, backend: str) -> None:
        self._local_decided = True
        self._link_backend = backend
        if not self._checksum_pinned:
            # CRC elision on trusted local links: the bytes never leave
            # the machine, so the whole-payload CRC32C guards nothing a
            # kernel memcpy doesn't already.  (Per-chunk stream CRCs
            # survive on uds — they double as the delta cache's base
            # fingerprints; shm bypasses the delta machinery entirely.)
            self._checksum = False
        logger.debug(
            "[%s] link to %s upgraded to %s",
            self._src_party, self._dest_party, backend,
        )

    def _adopt_shm(self, endpoint: local.LocalEndpoint) -> None:
        self._local_endpoint = endpoint
        self._adopt_local("shm")

    def _pin_tcp(self, reason: str, loud: bool = False) -> None:
        """Decide (or fall back to) TCP for this link.  ``loud`` marks a
        degradation the operator asked not to have (forced uds/shm that
        can't hold, a mid-session AF_UNIX failure) vs auto-detection
        correctly concluding the peer is remote."""
        self._local_decided = True
        self._link_backend = "tcp"
        self._local_endpoint = None
        self._uds_path = None
        self._local_fallback = reason
        self._checksum = self._checksum_cfg
        (logger.warning if loud else logger.debug)(
            "[%s] local link to %s: using TCP — %s",
            self._src_party, self._dest_party, reason,
        )

    def _consider_upgrade(self, reply: Dict[str, Any]) -> Optional[str]:
        """Decide the link backend from a HELLO reply's advertisement.

        Returns "uds" when the caller must redial over the advertised
        AF_UNIX path; "shm"/None mean the connection at hand stays
        usable (shm routes DATA through the in-process handoff but keeps
        the TCP connection as a valid control path)."""
        self._local_decided = True
        mode = self._local_mode
        if mode in ("auto", "shm"):
            ep = local.lookup_token(reply.get(wire.LOCAL_TOKEN_KEY))
            if ep is not None:
                self._adopt_shm(ep)
                return "shm"
            if mode == "shm":
                self._pin_tcp(
                    "local_link=shm but the destination server does not "
                    "live in this process", loud=True,
                )
                return None
        host_id = reply.get(wire.LOCAL_HOST_KEY)
        uds_path = reply.get(wire.LOCAL_UDS_KEY)
        colocated = (
            host_id is not None and host_id == local.host_identity()
        )
        if mode == "uds" or (mode == "auto" and colocated):
            if uds_path:
                if not colocated:
                    # Forced uds without the boot-scoped host proof:
                    # honor the operator (containers can hide
                    # machine-id while sharing a mount), but say so.
                    logger.warning(
                        "[%s] local_link=uds to %s: no colocation proof "
                        "(host identity mismatch); trusting the "
                        "advertised path %s",
                        self._src_party, self._dest_party, uds_path,
                    )
                self._uds_path = uds_path
                self._adopt_local("uds")
                return "uds"
            self._pin_tcp(
                "peer advertises no AF_UNIX listener",
                loud=(mode == "uds"),
            )
            return None
        self._pin_tcp(
            "peer is not colocated" if not colocated
            else f"local_link={mode!r} declines this backend",
        )
        return None

    async def _ensure_local_backend(self) -> None:
        """Make the link's backend decision before the first operation.

        Same-process destinations are found in the local registry with
        NO socket at all (at N=64 virtual parties, probe connections
        alone were a ~2k-socket storm per round); otherwise one pooled
        TCP connection's HELLO reply carries the advertisement and
        :meth:`_open_conn` applies the upgrade."""
        if self._local_decided:
            return
        if self._local_mode in ("auto", "shm"):
            ep = local.lookup_addr(self._host, self._port)
            if ep is not None:
                self._adopt_shm(ep)
                return
        try:
            await self._acquire_conn()
        except asyncio.CancelledError:
            raise
        except Exception:
            # The probe failed before any HELLO decided anything: leave
            # the decision open — the operation's own connect path
            # surfaces (and retries) the real error.
            pass

    # -- connection management ------------------------------------------------

    async def _open_conn(self) -> _Conn:
        if chaos.installed() is not None:
            await chaos.fire_async(
                "connect", party=self._src_party, dest=self._dest_party
            )
        use_uds = self._link_backend == "uds" and self._uds_path is not None
        if use_uds:
            try:
                reader, writer = await asyncio.open_unix_connection(
                    self._uds_path, limit=2**20
                )
            except (OSError, NotImplementedError) as e:
                # Loud mid-session fallback: the peer restarted (socket
                # unlinked) or the path went away.  TCP (and the
                # configured checksum policy) is restored for good.
                self._pin_tcp(
                    f"AF_UNIX connect to {self._uds_path} failed: {e}",
                    loud=True,
                )
                use_uds = False
        if not use_uds:
            reader, writer = await asyncio.open_connection(
                self._host,
                self._port,
                ssl=self._ssl_context,
                server_hostname=(
                    self._server_hostname if self._ssl_context else None
                ),
                limit=2**20,
            )
        fd: Optional[int] = None
        if self._ssl_context is None:
            from rayfed_tpu_torch import native

            if native.is_available():
                sock = writer.get_extra_info("socket")
                if sock is not None:
                    fd = sock.fileno()
        conn = _Conn(reader, writer, fd)
        conn.reader_task = asyncio.ensure_future(self._read_responses(conn))
        # Version handshake (wire v4): one HELLO round trip before the
        # connection carries data.  A mixed-version pair fails HERE with
        # ProtocolMismatchError naming both versions, instead of a
        # confusing manifest-decode error mid-payload.
        try:
            hello = {"src": self._src_party, "ver": self._proto_version}
            if self._secagg is not None:
                hello[wire.SECAGG_PUB_KEY] = self._secagg.hello_value()
            reply = await self._roundtrip(
                wire.MSG_HELLO,
                hello,
                [],
                timeout_s=min(self._timeout_s, 15.0),
                conn=conn,
            )
            if self._secagg is not None:
                peer_adv = reply.get(wire.SECAGG_PUB_KEY)
                if peer_adv:
                    self._secagg.record_peer(self._dest_party, peer_adv)
        except BaseException:
            if conn.reader_task is not None:
                conn.reader_task.cancel()
                conn.reader_task = None
            self._teardown(conn, SendError("handshake failed"))
            raise
        if not self._local_decided:
            # First contact decides the link backend from the HELLO
            # advertisement (transport/local.py).  A uds verdict retires
            # this TCP probe and redials over the advertised path —
            # depth-1 recursion, the decision is made now.
            if self._consider_upgrade(reply) == "uds":
                if conn.reader_task is not None:
                    conn.reader_task.cancel()
                    conn.reader_task = None
                self._teardown(
                    conn, SendError("link upgraded to AF_UNIX")
                )
                return await self._open_conn()
        return conn

    async def _acquire_rails(self, k: int) -> List[_Conn]:
        """``k`` distinct live connections for a striped send (grow the
        pool as needed; least-busy first)."""
        async with self._conn_lock:
            self._conns = [c for c in self._conns if not c.closed]
            while len(self._conns) < k:
                self._conns.append(await self._open_conn())
            return sorted(self._conns, key=lambda c: c.busy)[:k]

    def _stripe_rails(self) -> int:
        rails = (
            self._stripe_rails_opt
            if self._stripe_rails_opt is not None
            else _default_stripe_rails()
        )
        return max(1, min(self._pool_size, MAX_STRIPE_RAILS, rails))

    async def _acquire_conn(self) -> _Conn:
        """Pick the least-busy live connection; grow the pool under load."""
        self._conns = [c for c in self._conns if not c.closed]
        if self._conns:
            conn = min(self._conns, key=lambda c: c.busy)
            if conn.busy == 0 or len(self._conns) >= self._pool_size:
                return conn
        async with self._conn_lock:
            self._conns = [c for c in self._conns if not c.closed]
            idle = [c for c in self._conns if c.busy == 0]
            if idle:
                return idle[0]
            if len(self._conns) < self._pool_size or not self._conns:
                conn = await self._open_conn()
                self._conns.append(conn)
                return conn
            return min(self._conns, key=lambda c: c.busy)

    async def _acquire_ctl_conn(self) -> _Conn:
        async with self._ctl_lock:
            if self._closed:
                # A ping racing close() must not resurrect a connection
                # (and its reader task) that close() will never see.
                raise SendError(f"client to {self._dest_party} closed")
            if self._ctl_conn is None or self._ctl_conn.closed:
                self._ctl_conn = await self._open_conn()
            return self._ctl_conn

    async def _read_responses(self, conn: _Conn) -> None:
        # Local snapshot: _teardown/_really_close null conn.reader, and
        # a cancel() issued between this task's awaits is only DELIVERED
        # at the next await — the attribute read before it must not race
        # the close into an AttributeError (the stream object itself
        # just raises IncompleteReadError once its transport closed).
        reader = conn.reader
        try:
            while True:
                prefix = await reader.readexactly(wire.HEADER_SIZE)
                msg_type, _flags, hlen, plen = wire.unpack_frame_prefix(prefix)
                header = json.loads(await reader.readexactly(hlen)) if hlen else {}
                if plen:
                    await reader.readexactly(plen)
                rid = header.get("rid")
                fut = conn.pending.pop(rid, None)
                if fut is None or fut.done():
                    continue
                if msg_type == wire.MSG_ERR:
                    if header.get("code") == "protocol":
                        exc_cls = ProtocolMismatchError
                    elif header.get("fatal"):
                        exc_cls = FatalSendError
                    elif header.get("code") == "delta_base":
                        exc_cls = DeltaBaseError
                    else:
                        exc_cls = SendError
                    fut.set_exception(exc_cls(header.get("error", "remote error")))
                else:
                    fut.set_result(header)
        except (asyncio.IncompleteReadError, ConnectionResetError, OSError) as e:
            self._teardown(conn, SendError(f"connection to {self._dest_party} lost: {e}"))
        except asyncio.CancelledError:
            self._teardown(conn, SendError("client shutting down"))
            raise

    def _teardown(self, conn: _Conn, exc: Exception) -> None:
        """Retire one connection and fail its in-flight requests.

        The actual socket close is deferred while a write holds the lock:
        closing mid-``writev`` would free the fd under an executor thread,
        and a recycled fd number could splice this payload into an
        unrelated connection.  The write path closes on exit when it sees
        ``dead``.
        """
        conn.dead = True
        pending, conn.pending = conn.pending, {}
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(exc)
        if conn in self._conns:
            self._conns.remove(conn)
        if not conn.write_lock.locked():
            self._really_close(conn)

    def _really_close(self, conn: _Conn) -> None:
        if conn.writer is not None:
            try:
                conn.writer.close()
            except Exception:
                pass
        conn.writer = None
        conn.reader = None
        conn.fd = None

    async def close(self) -> None:
        # Under _ctl_lock: a concurrent ping past the _closed check in
        # _acquire_ctl_conn may be mid-_open_conn — waiting for the lock
        # here means either we see its fresh connection (and drain it
        # below) or it sees _closed and never opens one.  Setting _closed
        # without the lock leaked exactly that socket + reader task.
        async with self._ctl_lock:
            self._closed = True
            if self._ctl_conn is not None:
                self._conns.append(self._ctl_conn)  # close with the rest
                self._ctl_conn = None
        for conn in list(self._conns):
            if conn.reader_task is not None:
                conn.reader_task.cancel()
                try:
                    await conn.reader_task
                except (asyncio.CancelledError, Exception):
                    pass
                conn.reader_task = None
            self._teardown(conn, SendError("client closed"))
        self._conns = []

    # -- RPCs -----------------------------------------------------------------

    async def _roundtrip(
        self, msg_type: int, header: Dict[str, Any], payload_bufs: List,
        crc_trailer: bool = False, timeout_s: Optional[float] = None,
        conn: Optional[_Conn] = None, stages=None,
    ) -> Dict[str, Any]:
        """Write one frame and wait for its reply.  ``stages``: the
        payload's ``wire.frame`` stage spans when a caller gathers them
        (armed only); otherwise the write opens its own."""
        if chaos.installed() is not None:
            # Chaos "wire" hook: fires on EVERY outbound frame — data,
            # health pings, handshakes — so a partition rule makes the
            # destination look exactly dead to this endpoint (the "frame"
            # hook below covers data frames only).  Raised faults are
            # ConnectionErrors: pings report False, sends hit the retry
            # arms, before any connection state is touched.
            await chaos.fire_async(
                "wire", party=self._src_party, dest=self._dest_party,
                type=msg_type,
            )
        if conn is None:
            conn = await self._acquire_conn()
        rid = next(self._rid)
        header = dict(header, rid=rid)
        if msg_type == wire.MSG_DATA and chaos.installed() is not None:
            # Chaos "frame" hook: may delay this frame, drop it (raises
            # a retryable ChaosFault), kill the rail, or corrupt the
            # DECLARED checksum in the (mutable) header so the
            # receiver's verification + the sender's retry path run.
            await chaos.fire_async(
                "frame", party=self._src_party, dest=self._dest_party,
                header=header,
            )
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        conn.pending[rid] = fut
        payload_len = wire.payload_nbytes(payload_bufs)
        flags = wire.FLAG_CRC_TRAILER if crc_trailer else 0
        try:
            async with conn.write_lock:
                try:
                    if conn.closed:
                        raise SendError(
                            f"connection to {self._dest_party} closed"
                        )
                    frame_bufs = wire.pack_frame(
                        msg_type, header, payload_len=payload_len, flags=flags
                    )
                    await self._write_frame(
                        loop, conn, frame_bufs, payload_bufs, crc_trailer,
                        stages,
                    )
                except (SendError, ConnectionError, OSError,
                        asyncio.IncompleteReadError):
                    raise  # classified by the outer arms
                except BaseException as e:
                    # Any other failure mid-write (a device→host fetch
                    # raising inside LazyBuffer.produce, cancellation)
                    # leaves the stream desynced: the frame prefix
                    # already declared payload_len, so the NEXT frame's
                    # bytes would be consumed as this one's payload.
                    # The connection is unrecoverable — tear it down.
                    # (Scoped to the write: cancellation while awaiting
                    # the ACK below leaves a healthy stream.)
                    self._teardown(
                        conn,
                        SendError(
                            f"payload write to {self._dest_party} failed: {e}"
                        ),
                    )
                    raise
                finally:
                    if conn.dead:
                        self._really_close(conn)
            return await asyncio.wait_for(
                fut, timeout=self._timeout_s if timeout_s is None else timeout_s
            )
        except asyncio.TimeoutError:
            # Deadline on the ACK.  Must precede the connection-failure
            # arm: since 3.10 TimeoutError IS an OSError subclass, and a
            # deadline must not tear down a healthy pooled connection
            # (or get retried — the policy says deadlines aren't).
            raise
        except SendError:
            # App-level MSG_ERR reply for THIS request (e.g. checksum
            # mismatch, oversize).  The connection itself is healthy —
            # don't tear it down or fail the other pipelined sends.
            # (SendError subclasses ConnectionError, so this arm must
            # precede the connection-failure arm.)
            raise
        except (ConnectionError, OSError, asyncio.IncompleteReadError) as e:
            self._teardown(conn, SendError(str(e)))
            raise SendError(str(e)) from e
        finally:
            conn.pending.pop(rid, None)
            # A write failure raises out of this coroutine after
            # _teardown already set an exception on our own ACK future;
            # mark it retrieved so GC doesn't log "Future exception was
            # never retrieved" (the caller sees the write error instead).
            if fut.done() and not fut.cancelled():
                fut.exception()

    async def _write_frame(
        self, loop, conn: _Conn, frame_bufs: List, payload_bufs: List,
        crc_trailer: bool, stages=None,
    ) -> None:
        """Write one frame (prefix+header+payload[+crc trailer]).

        Native path (non-TLS, C++ built): bytes go straight to the kernel
        via ``writev`` in an executor thread — the event loop never
        copies or blocks.  The payload is cut into
        :data:`WRITE_CHUNK_BYTES` chunks and fully pipelined: the
        device→host fetch of lazy shard k+1 AND the checksum of chunk
        k+1 run in executor threads while chunk k's writev blocks in
        another, so a large payload's encode/compress cost hides under
        the wire instead of serializing in front of it.  Fallback:
        asyncio writer (same pipeline, SSL owns the socket).

        With the flight recorder armed a payload frame is a ``wire.frame``
        span with its stages (:class:`telemetry.FrameSpans`): the fetch
        (``wire.device_wait``, ``wire.d2h``), each chunk's ``wire.crc`` and
        ``wire.socket`` where they ran, and ``wire.loop_wait`` between.
        ``stages``: the caller's, when the frame is one of a payload's.
        """
        if crc_trailer:
            from rayfed_tpu_torch import native

        own = None
        if stages is None and payload_bufs:
            stages = own = self._frame_stages()

        use_fd = conn.fd is not None
        if use_fd:
            from rayfed_tpu_torch import native as _native

            timeout_ms = max(1000, int(self._timeout_s * 1000))
            fd = conn.fd  # capture: teardown may null it under our feet

            def _writev(bufs):
                # The write itself, in the executor thread that runs it.
                t0 = time.time() if stages is not None else 0.0
                try:
                    _native.writev_full(fd, bufs, timeout_ms=timeout_ms)
                    if stages is not None:
                        stages.add("wire.socket", t0)
                except TimeoutError as e:
                    # A stalled fd mid-frame desyncs the stream; surface
                    # as a connection failure (teardown), NOT a deadline
                    # (OSError(ETIMEDOUT) auto-subclasses TimeoutError,
                    # which the roundtrip treats as a healthy-conn ACK
                    # deadline).
                    raise ConnectionResetError(
                        f"write to {self._dest_party} stalled: {e}"
                    ) from e

        write_s = 0.0

        async def _write(bufs: List) -> None:
            nonlocal write_s
            t0 = time.time()
            if use_fd:
                await loop.run_in_executor(None, _writev, bufs)
            else:
                for buf in bufs:
                    conn.writer.write(buf)
                await conn.writer.drain()
            t1 = time.time()
            write_s += t1 - t0
            if stages is not None and not use_fd:
                stages.add("wire.socket", t0, t1)

        if not payload_bufs:
            await _write(frame_bufs)
            return

        def _crc(view, seed):
            t0 = time.time()
            # Chained seed: the trailer equals crc32c(concat(payload)).
            crc = native.crc32c(view, seed)
            t1 = time.time()
            if stages is not None:
                stages.add("wire.crc", t0, t1)
            return crc, t1 - t0

        t_frame0 = time.perf_counter()
        prepare_s = 0.0
        d2h_s = 0.0
        crc_s = 0.0
        payload_nbytes = 0
        crc = 0
        head: List = list(frame_bufs)  # rides along with the first chunk
        # Executor hops: each payload buffer's fetch as a byte view.
        prefetch = loop.run_in_executor(None, wire.fetch, payload_bufs[0], stages)
        for i in range(len(payload_bufs)):
            mv, dt = await prefetch
            prepare_s += dt
            d2h_s += dt
            payload_nbytes += mv.nbytes
            if i + 1 < len(payload_bufs):
                prefetch = loop.run_in_executor(
                    None, wire.fetch, payload_bufs[i + 1], stages
                )
            nchunks = max(1, -(-mv.nbytes // WRITE_CHUNK_BYTES))
            views = [
                mv[j * WRITE_CHUNK_BYTES : (j + 1) * WRITE_CHUNK_BYTES]
                for j in range(nchunks)
            ]
            crc_fut = (
                loop.run_in_executor(None, _crc, views[0], crc)
                if crc_trailer
                else None
            )
            last_buf = i == len(payload_bufs) - 1
            for j, view in enumerate(views):
                if crc_trailer:
                    crc, dt = await crc_fut
                    prepare_s += dt
                    crc_s += dt
                    if j + 1 < len(views):
                        crc_fut = loop.run_in_executor(
                            None, _crc, views[j + 1], crc
                        )
                chunk = head + [view]
                head = []
                if last_buf and j == len(views) - 1 and crc_trailer:
                    chunk.append(struct.pack(">I", crc))
                await _write(chunk)
        self.stats["send_frames"] += 1
        self.stats["send_payload_bytes"] += payload_nbytes
        self.stats["send_prepare_s"] += prepare_s
        self.stats["send_write_s"] += write_s
        self.stats["send_d2h_s"] += d2h_s
        self.stats["send_crc_s"] += crc_s
        self.stats["send_socket_s"] += write_s
        self._bill_backend(d2h=d2h_s, crc=crc_s, socket=write_s)
        self.stats["send_frame_wall_s"] += time.perf_counter() - t_frame0
        if own is not None:
            # Ring appends only: this coroutine runs on the transport loop.
            own.close(payload_nbytes)

    def _dest_known_dead(self) -> bool:
        """True while the health monitor has the destination declared
        dead — the retry ladders consult this and stop immediately
        instead of sleeping out the backoff sequence."""
        if self._dead_check is None:
            return False
        try:
            return bool(self._dead_check())
        except Exception:  # pragma: no cover - monitor accessor bug
            return False

    def _dead_fast_fail(self, last_exc: Optional[Exception]) -> None:
        raise SendError(
            f"destination {self._dest_party!r} is declared dead by the "
            f"health monitor; skipping the retry backoff ladder "
            f"(last attempt: {last_exc})"
        ) from last_exc

    def _frame_stages(self, stream: Optional[str] = None):
        """A payload's ``wire.frame`` with its stage spans toward this
        client's peer, or None with the flight recorder disarmed."""
        return telemetry.frame_spans(
            party=self._src_party, peer=self._dest_party, stream=stream
        )

    @property
    def checksum_enabled(self) -> bool:
        return self._checksum

    def has_inflight_sends(self) -> bool:
        """True while any :meth:`send_data` call is in progress — from
        entry (producer fetches, connection opens, retry backoffs)
        through the final ACK — or any pooled connection has an
        un-ACKed frame / held write lock (direct ``_roundtrip``
        callers): the runtime message-size mutation guard (a cap change
        must reject cleanly rather than torn-apply to a payload on the
        wire)."""
        if self._inflight_sends > 0:
            return True
        for conn in self._conns:
            if conn.pending or conn.write_lock.locked():
                return True
        return any(st.lock.locked() for st in self._delta_streams.values())

    # -- multi-rail striped sends (wire v4) -----------------------------------

    def _produce_plain_chunks(
        self, loop, payload_bufs, csz, ready, abort=None, stages=None
    ) -> None:
        """Executor job: cut the payload into ``csz`` chunks as
        zero-copy views (lazy buffers fetched in walk order) + per-chunk
        CRC, resolving ``ready[i]`` as chunk ``i`` becomes shippable —
        chunk k is written to a rail while chunk k+1 is still being
        fetched from device and CRC'd here.  ``abort`` (threading.Event)
        stops production between chunks: a failed attempt must not make
        its retry wait out the full d2h+CRC pass of a dead payload.
        ``stages`` (armed only) gets the fetches and checksums."""
        import zlib

        timings = {"d2h": 0.0}
        idx = 0
        d2h_prev = 0.0
        try:
            for _nbytes, views in _iter_chunk_views(payload_bufs, csz, timings, stages):
                if abort is not None and abort.is_set():
                    raise SendError("send aborted; chunk production stopped")
                t0 = time.time()
                crc = 0
                for v in views:
                    crc = zlib.crc32(v, crc)
                t1 = time.time()
                crc_s = t1 - t0
                if stages is not None:
                    stages.add("wire.crc", t0, t1)
                d2h_s = timings["d2h"] - d2h_prev
                d2h_prev = timings["d2h"]
                item = (
                    idx, crc, list(views), time.perf_counter(),
                    d2h_s, 0.0, crc_s,
                )
                loop.call_soon_threadsafe(_resolve_ready, ready[idx], item)
                idx += 1
        # fedlint: disable=FED004 — transferred, not swallowed: the failure fails every pending rail future; this runs on the codec pool, not the driver
        except BaseException as e:  # fail the rails, not the executor
            for fut in ready[idx:]:
                loop.call_soon_threadsafe(_fail_ready, fut, e)

    def _produce_arena_chunks(
        self, loop, payload_bufs, arena_mv, csz,
        base_mv=None, base_ccrc=None, ready=None, abort=None, stages=None,
    ):
        """Executor job: ONE pass copying the payload into the send
        arena chunk-by-chunk, CRC'ing each chunk as it lands and — when
        a delta base is supplied — computing its changed flag in the
        same pass (the diff aliases both arenas; no re-copy).  With
        ``ready``, ``ready[i]`` resolves as chunk ``i`` lands, so the
        fresh-payload striped path ships chunk k while chunk k+1 is
        still being fetched/copied/CRC'd.

        Returns ``(ccrcs, changed, (d2h_s, copy_s, crc_s))`` —
        ``changed`` is None without a base; the totals are billed by
        the caller on the loop thread (the pipelined path bills per
        chunk through the ready items instead).  ``stages`` (armed only)
        gets the fetches, each chunk's copy into the arena (``wire.d2h``:
        the rest of the way to the send buffer) and its checksum.
        """
        import zlib

        import numpy as np

        ccrcs: List[int] = []
        changed: Optional[List[int]] = [] if base_mv is not None else None
        timings = {"d2h": 0.0}
        d2h_prev = copy_total = crc_total = 0.0
        idx = 0
        chunk_start = 0
        try:
            for nbytes, views in _iter_chunk_views(payload_bufs, csz, timings, stages):
                if abort is not None and abort.is_set():
                    raise SendError("send aborted; chunk production stopped")
                t0 = time.time()
                off = chunk_start
                for v in views:
                    arena_mv[off : off + v.nbytes] = v
                    off += v.nbytes
                chunk_view = arena_mv[chunk_start : chunk_start + nbytes]
                t1 = time.time()
                crc = zlib.crc32(chunk_view)
                t2 = time.time()
                copy_s, crc_s = t1 - t0, t2 - t1
                if stages is not None:
                    stages.add("wire.d2h", t0, t1)
                    stages.add("wire.crc", t1, t2)
                ccrcs.append(crc)
                if changed is not None:
                    base_chunk = base_mv[chunk_start : chunk_start + nbytes]
                    if crc != base_ccrc[idx] or not np.array_equal(
                        np.frombuffer(chunk_view, np.uint8),
                        np.frombuffer(base_chunk, np.uint8),
                    ):
                        changed.append(idx)
                d2h_s = timings["d2h"] - d2h_prev
                d2h_prev = timings["d2h"]
                copy_total += copy_s
                crc_total += crc_s
                if ready is not None:
                    item = (
                        idx, crc, [chunk_view], time.perf_counter(),
                        d2h_s, copy_s, crc_s,
                    )
                    loop.call_soon_threadsafe(_resolve_ready, ready[idx], item)
                idx += 1
                chunk_start += nbytes
        except BaseException as e:
            if ready is not None:
                for fut in ready[idx:]:
                    loop.call_soon_threadsafe(_fail_ready, fut, e)
            raise
        if not ccrcs:  # empty payload: mirror wire.chunk_crcs
            ccrcs = [zlib.crc32(b"")]
        return ccrcs, changed, (timings["d2h"], copy_total, crc_total)

    @staticmethod
    def _ready_chunks(loop, full, ccrcs, indices, csz, total):
        """Pre-resolved ready futures over an already-snapshotted
        payload (delta ship / retry of a produced arena)."""
        now = time.perf_counter()
        ready = []
        for i in indices:
            size = min(csz, total - i * csz)
            fut = loop.create_future()
            fut.set_result(
                (i, ccrcs[i], [full[i * csz : i * csz + size]], now,
                 0.0, 0.0, 0.0)
            )
            ready.append(fut)
        return ready

    async def _send_striped_frames(
        self, base_header, total, csz, nch, ready, base_fp=None, stages=None,
    ) -> Dict[str, Any]:
        """Ship one payload as per-chunk stripe frames fanned
        round-robin across the rails (wire v4).

        Each ready item carries its logical chunk index; ``base_fp``
        non-None marks the frames as a delta against the receiver's
        cached base.  On any frame failure every other rail drains
        before the error surfaces — the payload fails (and retries) as
        a unit.  Returns the completing frame's ACK header.  ``stages``:
        the payload's ``wire.frame`` spans (armed only), which every stripe
        frame's write joins.
        """
        nf = len(ready)
        sid = next(self._sid)
        rails = await self._acquire_rails(min(self._stripe_rails(), nf))

        async def _one(pos: int, conn: _Conn):
            idx, crc, views, t_ready, d2h_s, copy_s, crc_s = await ready[pos]
            st = self.stats
            st["send_d2h_s"] += d2h_s
            st["send_copy_s"] += copy_s
            st["send_crc_s"] += crc_s
            st["send_prepare_s"] += d2h_s + copy_s + crc_s
            loop_wait_s = max(0.0, time.perf_counter() - t_ready)
            st["send_loop_wait_s"] += loop_wait_s
            self._bill_backend(
                d2h=d2h_s, copy=copy_s, crc=crc_s, loop_wait=loop_wait_s
            )
            hdr = dict(base_header)
            hdr["ccrc"] = [crc]
            hdr["dlt"] = wire.make_delta_manifest(
                total, wire.encode_chunk_bitmap([idx], nch), base_fp
            )
            hdr["stp"] = wire.make_stripe_marker(sid, nf)
            ack = await self._roundtrip(
                wire.MSG_DATA, hdr, views, conn=conn, stages=stages
            )
            st["send_stripe_frames"] += 1
            return ack

        results = await asyncio.gather(
            *(_one(pos, rails[pos % len(rails)]) for pos in range(nf)),
            return_exceptions=True,
        )
        errs = [r for r in results if isinstance(r, BaseException)]
        if errs:
            for kind in (FatalSendError, DeltaBaseError):
                for e in errs:
                    if isinstance(e, kind):
                        raise e
            for e in errs:
                if isinstance(e, asyncio.TimeoutError):
                    raise e
            e0 = errs[0]
            if isinstance(e0, (SendError, OSError, ConnectionError,
                               asyncio.CancelledError)):
                raise e0
            raise SendError(
                f"striped payload to {self._dest_party} failed: {e0!r}"
            ) from e0
        for ack in results:
            if ack.get("result") == "OK":
                self.stats["send_striped_payloads"] += 1
                return ack
        # Every frame ACKed "SEG" but none completed the assembly: the
        # receiver lost it mid-group (evicted under memory pressure /
        # idle-dropped).  This is NOT a delivery — treating it as one
        # would hang the consumer's rendezvous and (on stream sends)
        # corrupt the delta-base contract.  Surface as retryable: the
        # retry re-ships the whole payload under a fresh sid.
        raise SendError(
            f"striped payload to {self._dest_party} completed without a "
            f"delivery ACK (receiver dropped the assembly mid-group); "
            f"retrying"
        )

    async def _send_plain_striped(
        self, header, payload_bufs, payload_len
    ) -> str:
        """Non-stream large payload as multi-rail stripe frames.

        Chunks are cut as zero-copy views over the (lazily produced)
        payload buffers — no arena copy, since nothing diffs against
        these bytes later — and ship as soon as produced: the single
        payload that used to ride one socket behind a full-payload
        encode/CRC barrier now saturates the whole connection pool.
        """
        loop = asyncio.get_running_loop()
        csz = wire.DELTA_CHUNK_BYTES
        nch = max(1, -(-payload_len // csz))
        base_header = dict(header)
        base_header["ccsz"] = csz
        policy = self._retry_policy
        backoff: Optional[float] = None
        last_exc: Optional[Exception] = None
        for attempt in range(max(1, policy.max_attempts)):
            if attempt:
                if self._dest_known_dead():
                    self._dead_fast_fail(last_exc)
                backoff = policy.next_backoff(backoff)
                logger.debug(
                    "[%s] retrying striped send to %s in %.2fs "
                    "(attempt %d/%d)",
                    self._src_party, self._dest_party, backoff,
                    attempt + 1, policy.max_attempts,
                )
                await asyncio.sleep(backoff)
            import threading as _threading

            ready = [loop.create_future() for _ in range(nch)]
            abort = _threading.Event()
            stages = self._frame_stages()
            producer = loop.run_in_executor(
                None, self._produce_plain_chunks, loop, payload_bufs, csz,
                ready, abort, stages,
            )
            ok = False
            try:
                ack = await self._send_striped_frames(
                    base_header, payload_len, csz, nch, ready, stages=stages
                )
                ok = True
                return ack.get("result", "OK")
            except FatalSendError:
                raise
            except asyncio.TimeoutError as e:
                raise SendError(
                    f"send to {self._dest_party} timed out after "
                    f"{self._timeout_s}s"
                ) from e
            except (SendError, OSError, ConnectionError) as e:
                last_exc = e
                logger.debug(
                    "[%s] striped send to %s attempt %d/%d failed: %s",
                    self._src_party, self._dest_party, attempt + 1,
                    policy.max_attempts, e,
                )
            finally:
                # Stop production at the next chunk boundary: a failed
                # attempt must not make its retry wait out the rest of
                # a dead payload's fetch+CRC pass.  (After success the
                # producer has already finished — the final frame could
                # not ship without the last chunk.)
                abort.set()
                await producer  # never raises: failures land on `ready`
                for fut in ready:
                    if fut.done() and not fut.cancelled():
                        fut.exception()  # mark retrieved
                    elif not fut.done():
                        fut.cancel()
                if stages is not None:
                    stages.close(payload_len, "ok" if ok else "error")
        raise SendError(
            f"striped send to {self._dest_party} failed after "
            f"{policy.max_attempts} attempts: {last_exc}"
        )

    async def send_data(
        self,
        payload_bufs: List,
        upstream_seq_id: str,
        downstream_seq_id: str,
        metadata: Optional[Dict[str, str]] = None,
        crc: Optional[int] = None,
        error: Optional[Dict[str, str]] = None,
        stream: Optional[str] = None,
        stream_snapshot: Optional[tuple] = None,
    ) -> str:
        """See :meth:`_send_data_impl` — this wrapper only maintains the
        whole-operation in-flight count :meth:`has_inflight_sends`
        reads (the message-cap mutation guard) and the chaos "send"
        hook (whole-payload delay/drop injection)."""
        if chaos.installed() is not None:
            await chaos.fire_async(
                "send", party=self._src_party, dest=self._dest_party,
                stream=stream, up=str(upstream_seq_id),
                down=str(downstream_seq_id),
            )
        self._inflight_sends += 1
        try:
            if not self._local_decided:
                await self._ensure_local_backend()
            if self._link_backend == "shm" and self._local_endpoint is not None:
                return await self._send_shm(
                    payload_bufs, upstream_seq_id, downstream_seq_id,
                    metadata=metadata, crc=crc, error=error,
                    stream_snapshot=stream_snapshot,
                )
            return await self._send_data_impl(
                payload_bufs, upstream_seq_id, downstream_seq_id,
                metadata=metadata, crc=crc, error=error, stream=stream,
                stream_snapshot=stream_snapshot,
            )
        finally:
            self._inflight_sends -= 1

    async def _shm_roundtrip(
        self, msg_type: int, header: Dict[str, Any], payload,
        timeout_s: Optional[float] = None,
    ) -> Dict[str, Any]:
        """One in-process frame handoff, with the socket path's chaos
        semantics: the "wire" hook fires on every frame, "frame" on DATA
        (its mutable header is how corrupt_crc plants a wrong declared
        checksum the receiver's mismatch path then catches)."""
        if chaos.installed() is not None:
            await chaos.fire_async(
                "wire", party=self._src_party, dest=self._dest_party,
                type=msg_type,
            )
        header = dict(header, rid=next(self._rid))
        if msg_type == wire.MSG_DATA and chaos.installed() is not None:
            await chaos.fire_async(
                "frame", party=self._src_party, dest=self._dest_party,
                header=header,
            )
        return await local.deliver(
            self._local_endpoint, msg_type, header, payload,
            self._timeout_s if timeout_s is None else timeout_s,
        )

    async def _send_shm(
        self,
        payload_bufs: List,
        upstream_seq_id: str,
        downstream_seq_id: str,
        metadata: Optional[Dict[str, str]] = None,
        crc: Optional[int] = None,
        error: Optional[Dict[str, str]] = None,
        stream_snapshot: Optional[tuple] = None,
    ) -> str:
        """Same-process delivery: one gather copy, zero socket writes.

        The payload is materialized into ONE freshly-allocated buffer
        (or a fan-out's shared snapshot is passed as-is — also fresh
        per send) and handed to the destination server BY REFERENCE;
        per-chunk CRC and the delta cache are bypassed — diff passes
        and checksums that save wire bytes are pure loss when there is
        no wire, so stream sends ship full payloads here and the
        ``delta_*`` counters intentionally stay still.  Delivery
        semantics match the socket path: retry ladder, ACK deadline
        (non-retried), epoch rejects, chunk sinks, telemetry.
        """
        total = wire.payload_nbytes(payload_bufs)
        if total > self._max_message_size:
            raise SendError(
                f"message of {total} bytes exceeds configured max "
                f"{self._max_message_size}"
            )
        merged_meta = dict(self._metadata)
        if metadata:
            merged_meta.update(metadata)
        base_header: Dict[str, Any] = {
            "src": self._src_party,
            "up": str(upstream_seq_id),
            "down": str(downstream_seq_id),
            "meta": merged_meta,
        }
        if error is not None:
            base_header["err"] = error
        if crc is not None and self._checksum:
            # Pinned-checksum links keep the precomputed digest (the
            # receiver verifies it); elided links drop it.
            base_header["crc"] = crc
        loop = asyncio.get_running_loop()
        t_frame0 = time.perf_counter()
        stages = self._frame_stages()
        if stream_snapshot is not None:
            payload: Any = stream_snapshot[0]
            d2h_s = copy_s = 0.0  # billed to the fan-out's codec pass
        elif 0 < total <= _INLINE_MATERIALIZE_BYTES:
            # Small payload: the executor round trip (two thread hops +
            # a GIL handoff each) costs more than the copy itself — at
            # N=64 virtual parties the hierarchy round hands off ~2k
            # stripe-sized frames, all under this bound.
            payload, d2h_s, copy_s = local.materialize(payload_bufs, stages)
        elif total:
            payload, d2h_s, copy_s = await loop.run_in_executor(
                None, local.materialize, payload_bufs, stages
            )
        else:
            payload, d2h_s, copy_s = bytearray(0), 0.0, 0.0
        policy = self._retry_policy
        backoff: Optional[float] = None
        last_exc: Optional[Exception] = None
        for attempt in range(max(1, policy.max_attempts)):
            if attempt:
                if self._dest_known_dead():
                    self._dead_fast_fail(last_exc)
                backoff = policy.next_backoff(backoff)
                logger.debug(
                    "[%s] retrying shm send to %s in %.2fs (attempt %d/%d)",
                    self._src_party, self._dest_party, backoff,
                    attempt + 1, policy.max_attempts,
                )
                await asyncio.sleep(backoff)
            t_hand = time.time()
            try:
                ack = await self._shm_roundtrip(
                    wire.MSG_DATA, base_header, payload
                )
            except FatalSendError:
                raise
            except asyncio.TimeoutError as e:
                raise SendError(
                    f"send to {self._dest_party} timed out after "
                    f"{self._timeout_s}s"
                ) from e
            except (SendError, OSError, ConnectionError) as e:
                last_exc = e
                logger.debug(
                    "[%s] shm send to %s attempt %d/%d failed: %s",
                    self._src_party, self._dest_party, attempt + 1,
                    policy.max_attempts, e,
                )
                continue
            t_ack = time.time()
            handoff_s = t_ack - t_hand
            st = self.stats
            st["send_frames"] += 1
            st["send_payload_bytes"] += total
            st["send_prepare_s"] += d2h_s + copy_s
            st["send_d2h_s"] += d2h_s
            st["send_copy_s"] += copy_s
            st["send_socket_s"] += handoff_s
            self._bill_backend(
                backend="shm", d2h=d2h_s, copy=copy_s, socket=handoff_s
            )
            st["send_frame_wall_s"] += time.perf_counter() - t_frame0
            if stages is not None:
                # The hand-off to the receiver, up to its ACK, is the
                # shared-memory link's socket.
                stages.add("wire.socket", t_hand, t_ack)
                stages.close(total)
            return ack.get("result", "OK")
        raise SendError(
            f"send to {self._dest_party} failed after "
            f"{policy.max_attempts} attempts: {last_exc}"
        )

    async def _send_data_impl(
        self,
        payload_bufs: List,
        upstream_seq_id: str,
        downstream_seq_id: str,
        metadata: Optional[Dict[str, str]] = None,
        crc: Optional[int] = None,
        error: Optional[Dict[str, str]] = None,
        stream: Optional[str] = None,
        stream_snapshot: Optional[tuple] = None,
    ) -> str:
        """Push one DATA message with retry policy; returns the ACK result.

        ``error``: poison the rendezvous key instead of delivering data —
        the consumer's recv raises :class:`~rayfed_tpu_torch.exceptions.RemoteError`
        (improves on reference ``barriers.py:244-248`` which leaves the
        consumer parked with no diagnosis).

        ``stream``: name a logical stream (stable across rounds, e.g.
        ``"fedavg/alice"``) to enable the per-peer delta cache: the
        payload is diffed against the last payload the peer ACKed on the
        stream and only changed :data:`wire.DELTA_CHUNK_BYTES` ranges
        ship (plus a bitmap manifest + per-chunk CRCs — wire format v3).
        ``stream_snapshot``: a precomputed
        :meth:`snapshot_stream_payload` result, shared across a fan-out
        so the payload is materialized and hashed once, not once per
        destination.
        """
        if stream is not None and error is None:
            return await self._send_stream(
                stream, payload_bufs, upstream_seq_id, downstream_seq_id,
                metadata, snapshot=stream_snapshot,
            )
        payload_len = wire.payload_nbytes(payload_bufs)
        if payload_len > self._max_message_size:
            raise SendError(
                f"message of {payload_len} bytes exceeds configured max "
                f"{self._max_message_size}"
            )
        merged_meta = dict(self._metadata)
        if metadata:
            merged_meta.update(metadata)
        header = {
            "src": self._src_party,
            "up": str(upstream_seq_id),
            "down": str(downstream_seq_id),
            "meta": merged_meta,
        }
        if error is not None:
            header["err"] = error
        if (
            error is None
            and payload_len >= wire.STRIPE_MIN_BYTES
            and self._stripe_rails() >= 2
        ):
            # Multi-rail striping (wire v4): the payload's chunks fan
            # out round-robin across the connection pool as per-chunk
            # frames — one large payload no longer rides one socket,
            # and the fetch/CRC of chunk k+1 overlaps the write of
            # chunk k with no full-payload serialization barrier.
            return await self._send_plain_striped(
                header, payload_bufs, payload_len
            )
        has_lazy = any(isinstance(b, wire.LazyBuffer) for b in payload_bufs)
        streamed = has_lazy or payload_len >= wire.SHARD_STREAM_THRESHOLD
        crc_trailer = False
        if crc is None and self._checksum and streamed:
            # Streamed payload (lazy shards, or big enough to chunk):
            # the checksum chains incrementally during the write —
            # overlapped with the socket, per chunk — and rides a
            # trailer, not the header.
            crc_trailer = True
        elif crc is None and self._checksum:
            # Prefer passing ``crc`` precomputed off-loop (the manager's
            # codec pool does) — this inline path serves direct callers.
            from rayfed_tpu_torch import native

            crc = native.crc32c_multi(payload_bufs)
        if crc is not None:
            header["crc"] = crc
        policy = self._retry_policy
        backoff: Optional[float] = None
        last_exc: Optional[Exception] = None
        for attempt in range(max(1, policy.max_attempts)):
            if attempt:
                if self._dest_known_dead():
                    self._dead_fast_fail(last_exc)
                # Decorrelated jitter (policy.jitter, default on): N
                # parties retrying the same dead peer must not wake in
                # lockstep.  The chosen delay is logged so a retry storm
                # is diagnosable from one party's logs.
                backoff = policy.next_backoff(backoff)
                logger.debug(
                    "[%s] retrying send to %s in %.2fs (attempt %d/%d)",
                    self._src_party, self._dest_party, backoff,
                    attempt + 1, policy.max_attempts,
                )
                await asyncio.sleep(backoff)
            try:
                ack = await self._roundtrip(
                    wire.MSG_DATA, header, payload_bufs, crc_trailer=crc_trailer
                )
                return ack.get("result", "OK")
            except FatalSendError:
                raise
            except asyncio.TimeoutError as e:
                # Deadline exceeded is not retried (parity: only UNAVAILABLE
                # is a retryable status in the reference policy).  Must
                # precede the retry arm: TimeoutError subclasses OSError
                # since 3.10.
                raise SendError(
                    f"send to {self._dest_party} timed out after "
                    f"{self._timeout_s}s"
                ) from e
            except (SendError, OSError, ConnectionError) as e:
                last_exc = e
                logger.debug(
                    "[%s] send to %s attempt %d/%d failed: %s",
                    self._src_party, self._dest_party, attempt + 1,
                    policy.max_attempts, e,
                )
        raise SendError(
            f"send to {self._dest_party} failed after "
            f"{policy.max_attempts} attempts: {last_exc}"
        )

    def send_data_async(
        self,
        payload_bufs: List,
        upstream_seq_id: str,
        downstream_seq_id: str,
        **kwargs,
    ):
        """Thread-safe, non-blocking :meth:`send_data`: returns a
        completion future instead of awaiting the ACK.

        The returned :class:`~rayfed_tpu_torch.executor.LocalRef` resolves to
        the ACK result string once the peer acknowledged the FINAL frame
        of the send (for delta streams that includes any transparent
        full-payload re-seed after a ``delta_base`` desync), and errs
        with the send's failure — peer death after retries, a re-seed
        that itself failed, an oversize payload.  Callable from any
        thread; the client must have been constructed with its event
        loop bound (``loop=``; :class:`TransportManager` always does).
        Accepts every :meth:`send_data` keyword (``metadata``, ``crc``,
        ``stream``, ``stream_snapshot``, ``error``).
        """
        from rayfed_tpu_torch.executor import LocalRef

        if self._loop is None:
            raise RuntimeError(
                "send_data_async needs the client's event loop bound at "
                "construction (loop=...); direct awaiters use send_data"
            )
        cf = asyncio.run_coroutine_threadsafe(
            self.send_data(
                payload_bufs, upstream_seq_id, downstream_seq_id, **kwargs
            ),
            self._loop,
        )
        out = LocalRef()

        def _done(f):
            if f.cancelled():
                out.set_exception(SendError("client send cancelled"))
            elif f.exception() is not None:
                out.set_exception(f.exception())
            else:
                out.set_result(f.result())

        cf.add_done_callback(_done)
        return out

    @staticmethod
    def snapshot_stream_payload(payload_bufs: List, stages=None):
        """Materialize the payload contiguously + its chunk CRCs.

        Delta diffing needs a stable byte snapshot of the whole payload
        (lazy shards are forced here), so stream sends trade the
        overlapped per-shard fetch for the ability to skip unchanged
        chunks entirely — the right trade when most chunks repeat.
        Static so a fan-out (``TransportManager.send_many``) computes it
        ONCE and shares it with every destination's client; run it on a
        codec/executor thread, not the event loop.  ``stages`` (armed
        only) gets the fetches, the gather (``wire.d2h``) and the chunk
        checksums."""
        from rayfed_tpu_torch import native

        views = [wire.fetch(buf, stages)[0] for buf in payload_bufs]
        if stages is None:
            full = native.gather_copy(views)
            return full, wire.chunk_crcs(full)
        t0 = time.time()
        full = native.gather_copy(views)
        t1 = time.time()
        ccrcs = wire.chunk_crcs(full)
        stages.add("wire.d2h", t0, t1)
        stages.add("wire.crc", t1)
        return full, ccrcs

    @staticmethod
    def _diff_chunks(full, base, ccrcs, base_ccrcs) -> List[int]:
        """Indices of DELTA_CHUNK_BYTES chunks that differ from the base.

        CRC inequality proves difference; CRC equality is confirmed with
        a vectorized byte compare (a colliding chunk must not be
        silently dropped from the delta)."""
        import numpy as np

        csz = wire.DELTA_CHUNK_BYTES
        a = np.frombuffer(full, dtype=np.uint8)
        b = np.frombuffer(base, dtype=np.uint8)
        changed = []
        for i, (c_new, c_old) in enumerate(zip(ccrcs, base_ccrcs)):
            off = i * csz
            if c_new != c_old or not np.array_equal(
                a[off : off + csz], b[off : off + csz]
            ):
                changed.append(i)
        return changed

    async def _send_stream(
        self, stream: str, payload_bufs: List, upstream_seq_id: str,
        downstream_seq_id: str, metadata: Optional[Dict[str, str]],
        snapshot: Optional[tuple] = None,
    ) -> str:
        """Stream send with the per-peer delta cache (wire v3/v4).

        The payload is snapshotted into the stream's reusable
        page-aligned send arena (ping-pong slots: the last-ACKed base
        stays byte-stable in the other slot and the delta diff aliases
        both — no per-round alloc+concat+copy), per-chunk CRC'd and
        diffed against the base in the SAME pass, then shipped one of
        three ways:

        - unchanged / small delta → the single-frame wire-v3 delta path;
        - large delta (≥ 2 rails) → the changed chunks striped across
          the rails;
        - fresh/full payload ≥ :data:`wire.STRIPE_MIN_BYTES` with ≥ 2
          rails → pipelined stripe frames: chunk k is on a socket while
          chunk k+1 is still being fetched and CRC'd (no full-payload
          serialization barrier).

        A ``delta_base`` reply (receiver restarted / base desynced)
        falls back to a full payload, re-seeding both caches."""
        state = self._delta_streams.setdefault(stream, _DeltaStream())
        self._delta_streams.move_to_end(stream)
        if len(self._delta_streams) > _MAX_DELTA_STREAMS:
            # Oldest UNLOCKED stream loses its base (it re-seeds with a
            # full payload on next use).  A locked state has a send in
            # flight — evicting it would let a second _DeltaStream for
            # the same name race the serialization its lock promises.
            for key in list(self._delta_streams):
                if len(self._delta_streams) <= _MAX_DELTA_STREAMS:
                    break
                if key != stream and not self._delta_streams[key].lock.locked():
                    del self._delta_streams[key]
        loop = asyncio.get_running_loop()
        async with state.lock:
            csz = wire.DELTA_CHUNK_BYTES
            total = wire.payload_nbytes(payload_bufs)
            if total > self._max_message_size:
                raise SendError(
                    f"message of {total} bytes exceeds configured max "
                    f"{self._max_message_size}"
                )
            nch = max(1, -(-total // csz))
            merged_meta = dict(self._metadata)
            if metadata:
                merged_meta.update(metadata)
            base_header = {
                "src": self._src_party,
                "up": str(upstream_seq_id),
                "down": str(downstream_seq_id),
                "meta": merged_meta,
                "stm": stream,
                "ccsz": csz,
            }
            has_base = (
                state.data is not None
                and state.ccrc is not None
                and len(state.data) == total
            )
            # Stripe only with >= 2 rails: on one rail the per-chunk
            # frames still pay per-frame ACKs and the receiver's
            # reassembly memcpy with nothing pipelining against them —
            # the v3 single-frame path (below) already overlaps CRC
            # with the socket and delivers zero-copy, and it now snaps
            # into the reusable arena too.
            stripeable = (
                total >= wire.STRIPE_MIN_BYTES
                and nch >= 2
                and self._stripe_rails() >= 2
            )
            full: Optional[memoryview] = None
            ccrcs: Optional[List[int]] = None
            changed: Optional[List[int]] = None
            pipelined = False
            # The payload's frame work toward this peer, from its first
            # byte's production to its last write (armed only).
            stages = self._frame_stages(stream)
            if snapshot is not None:
                # Fan-out path: ONE shared snapshot + CRC pass serves
                # every destination (codec thread); only the diff
                # against THIS destination's base runs here.
                full_raw, ccrcs = snapshot
                full = memoryview(full_raw)
                if full.format != "B":
                    full = full.cast("B")
                if has_base:
                    changed = await loop.run_in_executor(
                        None, self._diff_chunks, full, state.data, ccrcs,
                        state.ccrc,
                    )
            elif has_base or not stripeable:
                # Arena snapshot: copy + CRC + diff in ONE executor
                # pass over the reused mmap arena.
                arena_mv = state.writable_arena(total)
                ccrcs, changed, totals = await loop.run_in_executor(
                    None, self._produce_arena_chunks, loop, payload_bufs,
                    arena_mv, csz,
                    state.data if has_base else None,
                    state.ccrc if has_base else None,
                    None, None, stages,
                )
                full = arena_mv
                st = self.stats
                st["send_d2h_s"] += totals[0]
                st["send_copy_s"] += totals[1]
                st["send_crc_s"] += totals[2]
                st["send_prepare_s"] += sum(totals)
                self._bill_backend(
                    d2h=totals[0], copy=totals[1], crc=totals[2]
                )
            else:
                # Fresh stripe-sized payload: production is pipelined
                # with the stripe frames inside the attempt loop.
                full = state.writable_arena(total)
                pipelined = True

            # A delta frame only wins when at least one chunk is skipped.
            force_full = changed is None or len(changed) >= nch
            policy = self._retry_policy
            backoff: Optional[float] = None
            last_exc: Optional[Exception] = None
            attempt = 0
            import threading as _threading

            while attempt < max(1, policy.max_attempts):
                producer = None
                abort = _threading.Event()
                ready: Optional[List[asyncio.Future]] = None
                try:
                    if force_full and stripeable:
                        if pipelined and ccrcs is None:
                            ready = [
                                loop.create_future() for _ in range(nch)
                            ]
                            producer = loop.run_in_executor(
                                None, self._produce_arena_chunks, loop,
                                payload_bufs, full, csz, None, None, ready,
                                abort, stages,
                            )
                        else:
                            ready = self._ready_chunks(
                                loop, full, ccrcs, list(range(nch)), csz,
                                total,
                            )
                        ack = await self._send_striped_frames(
                            base_header, total, csz, nch, ready,
                            stages=stages,
                        )
                    elif (
                        not force_full
                        and len(changed) >= 2
                        and len(changed) * csz >= wire.STRIPE_MIN_BYTES
                        and self._stripe_rails() >= 2
                    ):
                        # Big delta: changed chunks fan out over the
                        # rails too (same reassembly machinery, with
                        # the base fingerprint carried per frame).
                        ready = self._ready_chunks(
                            loop, full, ccrcs, changed, csz, total
                        )
                        ack = await self._send_striped_frames(
                            base_header, total, csz, nch, ready,
                            base_fp=state.fp, stages=stages,
                        )
                    else:
                        header = dict(base_header)
                        if not force_full:
                            header["ccrc"] = [ccrcs[i] for i in changed]
                            header["dlt"] = wire.make_delta_manifest(
                                total,
                                wire.encode_chunk_bitmap(changed, nch),
                                state.fp,
                            )
                            bufs = [
                                full[i * csz : (i + 1) * csz]
                                for i in changed
                            ]
                        else:
                            header["ccrc"] = ccrcs
                            bufs = [full] if total else []
                        ack = await self._roundtrip(
                            wire.MSG_DATA, header, bufs, stages=stages
                        )
                except DeltaBaseError:
                    if force_full:  # full sends can't need a base
                        raise
                    logger.debug(
                        "[%s] stream %r delta base desynced at %s; "
                        "re-seeding with a full payload",
                        self._src_party, stream, self._dest_party,
                    )
                    force_full = True  # immediate, not a failed attempt
                    continue
                except FatalSendError:
                    raise
                except asyncio.TimeoutError as e:
                    raise SendError(
                        f"send to {self._dest_party} timed out after "
                        f"{self._timeout_s}s"
                    ) from e
                except (SendError, OSError, ConnectionError) as e:
                    # Outcome unknown (e.g. applied but ACK lost): the
                    # cache keeps the last-ACKED base — if the peer in
                    # fact advanced, the next delta's bfp mismatches and
                    # the delta_base fallback re-seeds.  Retry per
                    # policy.
                    last_exc = e
                    attempt += 1
                    logger.debug(
                        "[%s] stream send to %s attempt %d/%d failed: %s",
                        self._src_party, self._dest_party, attempt,
                        policy.max_attempts, e,
                    )
                    if stages is not None:
                        stages.close(total, "error")
                        stages = self._frame_stages(stream)
                    if attempt >= max(1, policy.max_attempts):
                        break
                    if self._dest_known_dead():
                        self._dead_fast_fail(last_exc)
                    backoff = policy.next_backoff(backoff)
                    logger.debug(
                        "[%s] retrying stream send to %s in %.2fs",
                        self._src_party, self._dest_party, backoff,
                    )
                    await asyncio.sleep(backoff)
                    continue
                finally:
                    if producer is not None:
                        # Stop production at the next chunk boundary on
                        # failure; after success the producer already
                        # finished (the final frame needed its chunk).
                        abort.set()
                        try:
                            ccrcs, _chg, _totals = await producer
                        except Exception:
                            ccrcs = None  # re-produce on the retry
                        if ready is not None:
                            for fut in ready:
                                if fut.done() and not fut.cancelled():
                                    fut.exception()  # mark retrieved
                                elif not fut.done():
                                    fut.cancel()
                # ACKed: the peer now holds `full` — it IS the new base.
                if stages is not None:
                    stages.close(total)
                wire_bytes = (
                    total if force_full
                    else sum(min(csz, total - i * csz) for i in changed)
                )
                state.data = full
                state.ccrc = ccrcs
                state.fp = wire.crc_fingerprint(ccrcs)
                self.stats["delta_logical_bytes"] += total
                self.stats["delta_wire_bytes"] += wire_bytes
                if force_full:
                    self.stats["delta_full_frames"] += 1
                else:
                    self.stats["delta_stream_frames"] += 1
                _tr = telemetry.active()
                if _tr is not None:
                    # Delta-cache verdict for THIS stream send: how many
                    # of the payload's chunks the diff kept off the wire
                    # (a "full" outcome is a cold stream or a re-seed
                    # after a base desync).  Ring append only — loop
                    # coroutine.
                    _tr.emit(
                        "wire.delta", party=self._src_party,
                        peer=self._dest_party, stream=stream,
                        nbytes=wire_bytes,
                        outcome="full" if force_full else "delta",
                        detail={
                            "logical_bytes": total,
                            "changed_chunks": (
                                None if force_full else len(changed)
                            ),
                        },
                    )
                return ack.get("result", "OK")
            raise SendError(
                f"stream send to {self._dest_party} failed after "
                f"{policy.max_attempts} attempts: {last_exc}"
            )

    async def ping(self, timeout_s: float = 1.0, ctl: bool = False) -> bool:
        """Readiness probe with a per-request deadline (no shared-state
        mutation — concurrent sends keep their own timeout).

        ``ctl=True`` (the health monitor): ride the dedicated control
        connection so the probe cannot queue behind a bulk payload write
        on the data pool — which would read as "dead" exactly when the
        peer is busiest.  Default (one-shot readiness pings): use the
        data pool, warming a connection the first real send then reuses,
        and leaving no extra long-lived socket behind when no monitor
        runs."""
        try:
            if not self._local_decided:
                await self._ensure_local_backend()
            if self._link_backend == "shm" and self._local_endpoint is not None:
                if chaos.installed() is None:
                    # In-process peer: liveness is a registry verdict,
                    # not a roundtrip — N virtual parties' health
                    # monitors each ping every monitored peer per tick,
                    # an O(N²) control storm that was ~a third of the
                    # N=64 hierarchy round wall; and a ping DEADLINE
                    # under GIL starvation reads busy as dead exactly
                    # when the process is loaded.
                    return local.endpoint_alive(self._local_endpoint)
                # Chaos armed: ride the handoff so an injected
                # partition starves the PONG exactly like on a wire.
                await self._shm_roundtrip(
                    wire.MSG_PING, {"src": self._src_party}, b"",
                    timeout_s=timeout_s,
                )
                return True
            conn = await self._acquire_ctl_conn() if ctl else None
            await self._roundtrip(
                wire.MSG_PING, {"src": self._src_party}, [],
                timeout_s=timeout_s, conn=conn,
            )
            return True
        except Exception:
            return False
