"""Asyncio transport server — the receive side of the push transport.

Plays the role of the reference's ``RecverProxyActor`` gRPC server
(``barriers.py:93-118, 280-351``) without an actor framework: one
listener per party, frames demuxed into the rendezvous :class:`Mailbox`.

Implementation is an ``asyncio.BufferedProtocol`` frame parser rather
than the (simpler) StreamReader: payload bytes land **directly** in a
preallocated per-frame ``bytearray`` via ``get_buffer``/``buffer_updated``
— no 64 KiB chunk joins, no intermediate copies.  On localhost this is
~3.5× the StreamReader read path; the decode side then reads arrays
zero-copy out of the same buffer (``np.frombuffer`` → ``device_put``).
TLS (including mutual auth) is plain ``ssl`` on the listener (asyncio's
sslproto supports buffered protocols on 3.11+).

Per-connection frame order is preserved: checksum verification of large
payloads runs off-loop while the socket is paused, so other connections
keep flowing.
"""

from __future__ import annotations

import asyncio
import collections
import json
import logging
import ssl
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from rayfed_tpu_torch import chaos
from rayfed_tpu_torch import telemetry
from rayfed_tpu_torch.transport import local
from rayfed_tpu_torch.transport import wire
from rayfed_tpu_torch.transport.rendezvous import Mailbox, Message

logger = logging.getLogger(__name__)

_PREFIX_SIZE = wire.HEADER_SIZE
# Payloads at or above this size get their checksum verified off-loop.
_OFFLOAD_CRC_BYTES = 4 * 1024 * 1024
# Payloads at or above this size are read off-loop: the protocol pauses
# and a blocking recv_into loop in an executor thread drains the socket
# straight into the preallocated payload buffer — no per-chunk event-loop
# callbacks for the bulk bytes (mirrors the client's writev send path).
_RAW_READ_BYTES = 4 * 1024 * 1024
# Headers are small JSON (ids + metadata); a corrupt or hostile peer must
# not be able to force a multi-GB allocation via the 32-bit hlen field.
_MAX_HEADER_BYTES = 1 * 1024 * 1024
# Delta bases retained per server: one full payload per (src, stream) —
# bounded LRU so a peer cycling stream names can't grow memory unbounded.
_MAX_DELTA_BASES = 32
# In-progress multi-rail stripe reassemblies retained (wire v4): one
# payload-sized buffer each, keyed by rendezvous — bounded LRU plus an
# idle-drop so an abandoned sender can't pin payload buffers forever.
_MAX_STRIPE_ASM = 8
_STRIPE_IDLE_DROP_S = 600.0


class _DeltaBaseMissing(Exception):
    """The delta's base payload isn't cached here (restart/desync)."""


class _StripeFatal(Exception):
    """A striped payload rejected for a non-transient reason (e.g. it
    exceeds this server's message-size cap): replied ``fatal`` so the
    sender aborts instead of fruitlessly re-shipping gigabytes — parity
    with the single-frame path's ``_fatal_oversize``."""


class _StripeReject(ValueError):
    """A stripe frame rejected for protocol-STATE reasons — stale sid,
    evicted assembly, geometry disagreement — not data corruption.
    Counted as ``receive_stripe_rejects`` so an eviction burst doesn't
    read as phantom CRC errors in the stats."""


class _StripeAsm:
    """One in-progress multi-rail payload reassembly (wire v4).

    Frames of the same payload land concurrently on different rail
    connections; chunk placement is serialized by the per-assembly
    lock, the map itself by the server's stripe lock.  ``prefix``
    tracks the contiguous VERIFIED chunk prefix — the only bytes a
    chunk sink ever sees, which is what lets a streaming aggregator
    keep folding under shuffled cross-rail arrival.
    """

    __slots__ = (
        "sid", "total", "csz", "nch", "nf", "buf", "ccrc", "have",
        "frames", "is_delta", "prefix", "shipped", "read_s", "lock",
        "touched",
    )

    def __init__(self, sid, total, csz, nch, nf, buf, ccrc, is_delta):
        self.sid = sid
        self.total = total
        self.csz = csz
        self.nch = nch
        self.nf = nf
        self.buf = buf
        self.ccrc = ccrc
        self.have: set = set()
        self.frames = 0
        self.is_delta = is_delta
        self.prefix = 0   # contiguous verified chunks from index 0
        self.shipped = 0  # wire bytes received for this assembly
        self.read_s = 0.0
        self.lock = threading.Lock()
        self.touched = time.monotonic()


class _FrameProtocol(asyncio.BufferedProtocol):
    """One connection's incremental frame parser (prefix → header → payload)."""

    def __init__(self, server: "TransportServer") -> None:
        self._server = server
        self._transport: Optional[asyncio.Transport] = None
        # Parse state
        self._small = bytearray(_PREFIX_SIZE)
        self._small_view = memoryview(self._small)
        self._need = _PREFIX_SIZE
        self._got = 0
        self._state = "prefix"  # prefix | header | payload | trailer
        self._msg_type = 0
        self._flags = 0
        self._hlen = 0
        self._plen = 0
        self._header: Dict[str, Any] = {}
        self._payload: Optional[bytearray] = None
        self._payload_view: Optional[memoryview] = None
        self._payload_t0 = 0.0
        self._trailer_crc: Optional[int] = None
        self._peer = None
        self._closed = False
        # Chunk-granular receive hook: when a sink is registered for this
        # frame's (up, down) key, arriving payload bytes are surfaced to
        # it incrementally (streaming aggregation consumes them while
        # later chunks are still on the wire).  Delta frames skip the
        # incremental feed — their payload is compacted changed chunks,
        # only meaningful after reconstruction.
        self._cur_sink = None

    # -- protocol callbacks ---------------------------------------------------

    def connection_made(self, transport) -> None:
        self._transport = transport
        self._peer = transport.get_extra_info("peername")
        self._server._protocols.add(self)

    def connection_lost(self, exc) -> None:
        self._closed = True
        self._server._protocols.discard(self)
        # A sink that was being fed an in-flight payload must hear that
        # the frame died (the sender will retry on a fresh connection
        # with a fresh buffer) — otherwise it would keep folding from a
        # half-filled stale buffer.
        if self._cur_sink is not None and self._state == "payload":
            try:
                self._cur_sink.on_frame_abort(corrupt=False)
            except Exception:  # pragma: no cover - sink bug
                logger.exception(
                    "[%s] chunk sink abort failed", self._server._party
                )
            self._cur_sink = None

    def get_buffer(self, sizehint: int) -> memoryview:
        if self._state == "payload":
            if self._payload_t0 == 0.0:
                self._payload_t0 = time.perf_counter()
            return self._payload_view[self._got :]
        return self._small_view[self._got : self._need]

    def buffer_updated(self, nbytes: int) -> None:
        if self._state == "payload" and nbytes:
            # Mid-payload liveness: the health monitor counts bytes
            # actively arriving from a party as proof of life, so a
            # multi-GB push can't get its sender declared dead just
            # because control pings queue behind the bulk transfer.
            self._server.note_rx_progress(self._header.get("src"), nbytes)
            if self._cur_sink is not None:
                try:
                    self._cur_sink.on_bytes(
                        self._payload_view, self._got + nbytes
                    )
                except Exception:
                    logger.exception(
                        "[%s] chunk sink failed (peer=%s)",
                        self._server._party, self._peer,
                    )
                    self._cur_sink = None
        self._got += nbytes
        if self._got < self._need:
            return
        try:
            if self._state == "prefix":
                self._on_prefix()
            elif self._state == "header":
                self._on_header()
            elif self._state == "trailer":
                self._on_trailer()
            else:
                self._on_payload()
        except Exception:
            logger.exception(
                "[%s] frame parse error (peer=%s)", self._server._party, self._peer
            )
            self._abort()

    # -- state transitions ----------------------------------------------------

    def _expect(self, state: str, need: int) -> None:
        self._state = state
        self._need = need
        self._got = 0
        if state != "payload" and need > len(self._small):
            self._small = bytearray(need)
            self._small_view = memoryview(self._small)

    def _on_prefix(self) -> None:
        msg_type, flags, hlen, plen = wire.unpack_frame_prefix(
            bytes(self._small_view[:_PREFIX_SIZE])
        )
        self._msg_type = msg_type
        self._flags = flags
        self._hlen = hlen
        self._plen = plen
        if hlen > _MAX_HEADER_BYTES:
            # Can't even read a header this size to echo a request id —
            # drop the connection before allocating anything.
            logger.warning(
                "[%s] header of %d bytes exceeds cap %d (peer=%s); closing",
                self._server._party, hlen, _MAX_HEADER_BYTES, self._peer,
            )
            self._abort()
            return
        if plen > self._server._max_message_size:
            # Fatal (non-retryable).  Read the header (to echo rid), reply,
            # then close — never allocate the oversized payload.
            self._expect("header", hlen) if hlen else self._fatal_oversize({})
            self._oversize = True
            return
        self._oversize = False
        if hlen:
            self._expect("header", hlen)
        else:
            self._header = {}
            self._begin_payload()

    def _on_header(self) -> None:
        self._header = json.loads(bytes(self._small_view[: self._hlen]))
        if getattr(self, "_oversize", False):
            self._fatal_oversize(self._header)
            return
        self._begin_payload()

    def _begin_payload(self) -> None:
        self._cur_sink = None
        if self._msg_type == wire.MSG_DATA and self._header.get("dlt") is None:
            self._cur_sink = self._server.peek_chunk_sink(
                (str(self._header.get("up")), str(self._header.get("down")))
            )
        if self._plen == 0:
            self._payload = bytearray(0)
            if self._flags & wire.FLAG_CRC_TRAILER:
                self._expect("trailer", 4)
            else:
                self._dispatch_frame()
            return
        self._payload = bytearray(self._plen)
        self._payload_view = memoryview(self._payload)
        self._payload_t0 = 0.0
        if self._plen >= _RAW_READ_BYTES:
            sock = (
                None
                if self._server._ssl_context is not None
                else self._transport.get_extra_info("socket")
            )
            if sock is not None:
                # Off-loop bulk read.  Safe w.r.t. buffering: get_buffer
                # windows are exact, so at this point the transport holds
                # no payload bytes — they're all still in the kernel.
                # State is "payload" for the whole drain (no protocol
                # callbacks fire while paused) so connection_lost's
                # mid-payload sink-abort applies to raw-read frames too.
                self._state = "payload"
                self._transport.pause_reading()
                self._payload_t0 = time.perf_counter()
                loop = asyncio.get_running_loop()
                fut = loop.run_in_executor(None, self._raw_read, sock.fileno())
                fut.add_done_callback(
                    lambda f: loop.call_soon_threadsafe(self._raw_read_done, f)
                )
                return
        self._expect("payload", self._plen)

    def _raw_read(self, fd: int) -> None:
        """Drain the payload into the preallocated buffer via os.readv on
        the raw fd (executor thread; the socket stays non-blocking —
        EAGAIN polls for readability).

        ``select.poll`` (not select) — no FD_SETSIZE limit — and an IDLE
        deadline (reset on every successful read) so a peer that
        declares a payload then stalls cannot pin a shared executor
        thread forever, while a slow-but-flowing large transfer is never
        cut off.
        """
        import os
        import select

        idle_limit = 120.0
        deadline = time.monotonic() + idle_limit
        poller = select.poll()
        poller.register(fd, select.POLLIN)
        view = self._payload_view
        src = self._header.get("src")
        got = 0
        while got < len(view):
            try:
                r = os.readv(fd, [view[got:]])
                if r == 0:
                    raise ConnectionError("peer closed mid-payload")
                got += r
                # Same liveness signal as the protocol path (note_rx_
                # progress tolerates this executor-thread caller).
                self._server.note_rx_progress(src, r)
                if self._cur_sink is not None:
                    try:  # sinks are thread-safe (see fl.streaming)
                        self._cur_sink.on_bytes(view, got)
                    except Exception:
                        logger.exception(
                            "[%s] chunk sink failed (raw read)",
                            self._server._party,
                        )
                        self._cur_sink = None
                deadline = time.monotonic() + idle_limit
            except (BlockingIOError, InterruptedError):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ConnectionError(
                        f"peer stalled mid-payload ({got}/{len(view)} bytes)"
                    )
                poller.poll(min(remaining, 10.0) * 1000)

    def _raw_read_done(self, fut) -> None:
        try:
            fut.result()
        except Exception as e:
            if not self._closed:
                logger.warning(
                    "[%s] payload read failed (peer=%s): %s",
                    self._server._party, self._peer, e,
                )
                self._abort()
            return
        if self._closed:
            return
        self._transport.resume_reading()
        self._got = self._need = self._plen  # state as if read via protocol
        self._state = "payload"
        if self._flags & wire.FLAG_CRC_TRAILER:
            self._expect("trailer", 4)
        else:
            self._dispatch_frame()

    def _on_payload(self) -> None:
        if self._flags & wire.FLAG_CRC_TRAILER:
            self._expect("trailer", 4)
            return
        self._dispatch_frame()

    def _on_trailer(self) -> None:
        import struct

        (self._trailer_crc,) = struct.unpack(">I", bytes(self._small_view[:4]))
        self._dispatch_frame()

    def _reset(self) -> None:
        self._payload = None
        self._payload_view = None
        self._cur_sink = None
        self._expect("prefix", _PREFIX_SIZE)

    # -- frame handling -------------------------------------------------------

    def _reply(self, msg_type: int, header: Dict[str, Any]) -> None:
        if self._transport is None or self._closed:
            return
        for buf in wire.pack_frame(msg_type, header):
            self._transport.write(buf)

    def _abort(self) -> None:
        if self._transport is not None:
            self._transport.close()
        self._closed = True

    def _fatal_oversize(self, header: Dict[str, Any]) -> None:
        self._reply(
            wire.MSG_ERR,
            {
                "rid": header.get("rid"),
                "fatal": True,
                "error": f"message of {self._plen} bytes exceeds max "
                f"{self._server._max_message_size}",
            },
        )
        # Close: the oversized payload is still in flight on the socket and
        # we refuse to buffer it.
        if self._transport is not None:
            # Give the reply a chance to flush before close.
            asyncio.get_running_loop().call_soon(self._abort)
        self._state = "drop"
        self._need = 1 << 62  # swallow whatever arrives until close

    def _dispatch_frame(self) -> None:
        server = self._server
        msg_type = self._msg_type
        header = self._header
        payload = self._payload if self._payload is not None else bytearray(0)
        read_seconds = (
            (time.perf_counter() - self._payload_t0) if self._payload_t0 else 0.0
        )
        trailer_crc = self._trailer_crc
        self._trailer_crc = None
        if trailer_crc is not None and "crc" not in header:
            header = dict(header, crc=trailer_crc)
        self._reset()

        if chaos.installed() is not None:
            # Chaos "wire" hook, receive side: covers EVERY frame type
            # (handshakes and pings included), so a partition rule also
            # starves the partner's health probes — to the sender this
            # party reads as dead while both processes stay alive.
            # Non-blocking variant: this is a sync protocol callback on
            # the shared event loop, so a delay rule must never sleep
            # here (it would stall every peer's frames, not one link's).
            try:
                chaos.fire_nonblocking(
                    "wire", party=server._party, src=header.get("src"),
                    type=msg_type,
                )
            except chaos.ChaosFault:
                # Discard without any reply: no ACK, no PONG — the
                # sender's deadline machinery is the point.  A sink that
                # already saw payload bytes hears a clean abort.
                if msg_type == wire.MSG_DATA:
                    self._notify_sink_abort(header, corrupt=False)
                return

        if msg_type == wire.MSG_HELLO:
            # Connection handshake (wire v4): a mixed-version pair must
            # fail HERE with a message naming both versions, not later
            # with a confusing manifest-decode error mid-payload.
            peer_ver = int(header.get("ver", 1))
            if peer_ver != wire.WIRE_FORMAT_VERSION:
                logger.warning(
                    "[%s] rejecting connection from %s: peer speaks wire "
                    "protocol v%s, this party speaks v%s",
                    server._party, header.get("src", self._peer),
                    peer_ver, wire.WIRE_FORMAT_VERSION,
                )
                self._reply(
                    wire.MSG_ERR,
                    {
                        "rid": header.get("rid"),
                        "fatal": True,
                        "code": "protocol",
                        "error": (
                            f"wire protocol version mismatch: peer "
                            f"{header.get('src', '?')!r} speaks "
                            f"v{peer_ver}, party {server._party!r} "
                            f"speaks v{wire.WIRE_FORMAT_VERSION} — "
                            f"upgrade the older party"
                        ),
                    },
                )
                # Flush the reply, then drop the connection.
                asyncio.get_running_loop().call_soon(self._abort)
                return
            reply = {
                "rid": header.get("rid"),
                "ver": wire.WIRE_FORMAT_VERSION,
                "src": server._party,
            }
            # Secure-aggregation key agreement rides the handshake
            # (transport/secagg.py): record the client's advertised key
            # and answer with our own, so one connection establishes
            # the pair's mask-seed state in both directions.
            sa = server.secagg
            if sa is not None:
                peer_adv = header.get(wire.SECAGG_PUB_KEY)
                src = header.get("src")
                if peer_adv and src:
                    sa.record_peer(str(src), peer_adv)
                reply[wire.SECAGG_PUB_KEY] = sa.hello_value()
            # Local-link colocation advertisement (transport/local.py):
            # always volunteered — three small strings per handshake.
            # The CLIENT decides whether to upgrade; a TLS listener
            # stays out of it (a link the operator encrypts must not
            # silently downgrade to an unencrypted AF_UNIX socket).
            if server._ssl_context is None:
                reply[wire.LOCAL_HOST_KEY] = local.host_identity()
                if server._local_sid is not None:
                    reply[wire.LOCAL_TOKEN_KEY] = local.endpoint_token(
                        server._local_sid
                    )
                if server._uds_path is not None:
                    reply[wire.LOCAL_UDS_KEY] = server._uds_path
            self._reply(wire.MSG_HELLO, reply)
            return
        if msg_type == wire.MSG_PING:
            self._reply(wire.MSG_PONG, {"rid": header.get("rid")})
            return
        if msg_type != wire.MSG_DATA:
            logger.warning(
                "[%s] unexpected frame type %s from %s",
                server._party, msg_type, self._peer,
            )
            self._abort()
            return

        if chaos.installed() is not None:
            try:
                # Same non-blocking discipline as the "wire" hook above:
                # this dispatch runs on the shared event loop.
                chaos.fire_nonblocking(
                    "server_frame", party=server._party,
                    src=header.get("src"), up=str(header.get("up")),
                    down=str(header.get("down")),
                )
            except chaos.ChaosFault:
                # Injected receive-side drop: discard the frame WITHOUT
                # an ACK — the sender's deadline/retry machinery is what
                # this fault exists to exercise.  A sink that saw the
                # payload's bytes hears a clean abort, like a died
                # connection.
                self._notify_sink_abort(header, corrupt=False)
                return

        if header.get("ccrc") is not None:
            # Stream frame (wire v3): per-chunk CRCs verified as the
            # integrity check — the whole-payload _crc_of re-check is
            # skipped (it would double-hash multi-GB payloads on the hot
            # receive path).  Delta frames also reconstruct against the
            # cached base here.
            self._handle_stream_data(header, payload, read_seconds)
            return

        expected_crc = header.get("crc")
        if expected_crc is not None:
            from rayfed_tpu_torch import native

            if not native.is_available():
                # Advisory checksum: without the fast C++ path, verifying
                # at python speed would stall the pipeline — trust TCP.
                if not server._warned_no_native_crc:
                    server._warned_no_native_crc = True
                    logger.warning(
                        "[%s] peer sends checksums but native codec is "
                        "unavailable; skipping verification", server._party,
                    )
                expected_crc = None

        if expected_crc is not None and len(payload) >= _OFFLOAD_CRC_BYTES:
            # Big frame: verify off-loop; pause reading so per-connection
            # order holds without buffering unbounded frames.
            transport = self._transport
            if transport is not None:
                transport.pause_reading()
            loop = asyncio.get_running_loop()
            fut = loop.run_in_executor(None, _crc_of, payload)

            def _done(f):
                try:
                    actual = f.result()
                except Exception as e:  # pragma: no cover
                    logger.exception("[%s] crc executor error: %s", server._party, e)
                    self._abort()
                    return
                finally:
                    if transport is not None and not self._closed:
                        transport.resume_reading()
                self._finish_data(header, payload, read_seconds, expected_crc, actual)

            fut.add_done_callback(
                lambda f: loop.call_soon_threadsafe(_done, f)
            )
            return

        actual = None
        if expected_crc is not None:
            actual = _crc_of(payload)
        self._finish_data(header, payload, read_seconds, expected_crc, actual)

    def _handle_stream_data(self, header, payload, read_seconds) -> None:
        """Verify per-chunk CRCs and (for deltas) rebuild the full payload.

        Both are byte-bound work (CRC pass + a full-payload memcpy for
        deltas), so large frames run them off-loop with reading paused —
        same discipline as the whole-payload CRC offload."""
        server = self._server
        if header.get("stp") is not None:
            # Multi-rail stripe frame (wire v4): verify + place this
            # frame's chunks into the payload's reassembly buffer.
            # Other rails' frames keep flowing on their own
            # connections while this one verifies off-loop.  Keyed on
            # the LOGICAL total, not this frame's size: the group's
            # first frame allocates the whole assembly buffer (and for
            # deltas copies the cached base), and a short tail chunk
            # arriving first must not run that multi-GB byte work on
            # the event loop (same rule as the wire-v3 branch below).
            transport = self._transport
            _dlt = header.get("dlt") or {}
            big = max(
                len(payload), int(_dlt.get("total") or 0)
            ) >= _OFFLOAD_CRC_BYTES
            if big and transport is not None:
                transport.pause_reading()
            loop = asyncio.get_running_loop()
            if big:
                fut = loop.run_in_executor(
                    None, _apply_stripe_frame, server, header, payload,
                    read_seconds,
                )

                def _done(f):
                    try:
                        final, read_total = f.result()
                        exc = None
                    except Exception as e:
                        final, read_total, exc = None, read_seconds, e
                    finally:
                        if transport is not None and not self._closed:
                            transport.resume_reading()
                    self._stripe_result(header, read_total, final, exc)

                fut.add_done_callback(
                    lambda f: loop.call_soon_threadsafe(_done, f)
                )
                return
            try:
                final, read_total = _apply_stripe_frame(
                    server, header, payload, read_seconds
                )
                exc = None
            except Exception as e:
                final, read_total, exc = None, read_seconds, e
            self._stripe_result(header, read_total, final, exc)
            return
        dlt = header.get("dlt")
        total = int(dlt["total"]) if dlt else len(payload)
        if total >= _OFFLOAD_CRC_BYTES:
            transport = self._transport
            if transport is not None:
                transport.pause_reading()
            loop = asyncio.get_running_loop()
            fut = loop.run_in_executor(
                None, _verify_and_apply_stream, server, header, payload
            )

            def _done(f):
                try:
                    final = f.result()
                    exc = None
                except Exception as e:
                    final, exc = None, e
                finally:
                    if transport is not None and not self._closed:
                        transport.resume_reading()
                self._stream_result(header, read_seconds, final, exc)

            fut.add_done_callback(
                lambda f: loop.call_soon_threadsafe(_done, f)
            )
            return
        try:
            final = _verify_and_apply_stream(server, header, payload)
            exc = None
        except Exception as e:
            final, exc = None, e
        self._stream_result(header, read_seconds, final, exc)

    def _notify_sink_abort(self, header, corrupt: bool) -> None:
        """A frame that fed a chunk sink failed verification (or died):
        the sink must know, so already-folded bytes don't silently
        survive into the aggregate when the sender retries."""
        sink = self._server.peek_chunk_sink(
            (str(header.get("up")), str(header.get("down")))
        )
        if sink is not None:
            try:
                sink.on_frame_abort(corrupt=corrupt)
            except Exception:  # pragma: no cover - sink bug
                logger.exception(
                    "[%s] chunk sink abort failed", self._server._party
                )

    def _stripe_result(self, header, read_seconds, final, exc) -> None:
        """Reply for one stripe frame: SEG while the payload assembles,
        the ordinary delivery path on completion, errors as MSG_ERR."""
        server = self._server
        if exc is not None:
            if isinstance(exc, _DeltaBaseMissing):
                server.stats["receive_delta_base_misses"] = (
                    server.stats.get("receive_delta_base_misses", 0) + 1
                )
                self._reply(
                    wire.MSG_ERR,
                    {
                        "rid": header.get("rid"),
                        "code": "delta_base",
                        "error": str(exc),
                    },
                )
                return
            if isinstance(exc, _StripeFatal):
                # Non-transient (oversize): abort the send instead of
                # letting the retry policy re-ship the whole payload.
                self._notify_sink_abort(header, corrupt=False)
                self._reply(
                    wire.MSG_ERR,
                    {
                        "rid": header.get("rid"),
                        "fatal": True,
                        "error": str(exc),
                    },
                )
                return
            if isinstance(exc, _StripeReject):
                # Protocol-state reject (stale sid / evicted assembly /
                # geometry): NOT corruption — its own counter, so an
                # eviction burst can't read as phantom CRC errors.
                server.stats["receive_stripe_rejects"] = (
                    server.stats.get("receive_stripe_rejects", 0) + 1
                )
                self._notify_sink_abort(header, corrupt=False)
                self._reply(
                    wire.MSG_ERR,
                    {
                        "rid": header.get("rid"),
                        "error": f"stripe frame rejected: {exc}",
                    },
                )
                return
            server.stats["receive_crc_errors"] = (
                server.stats.get("receive_crc_errors", 0) + 1
            )
            # Clean abort, never corrupt: a sink only ever saw VERIFIED
            # prefix bytes (identical on the sender's full retry), so
            # its folded blocks stay a valid prefix — reset-and-retry,
            # not the unrecoverable donated-accumulator failure.
            self._notify_sink_abort(header, corrupt=False)
            self._reply(
                wire.MSG_ERR,
                {
                    "rid": header.get("rid"),
                    "error": f"stripe frame verification failed: {exc}",
                },
            )
            return
        if final is None:
            self._reply(
                wire.MSG_ACK, {"rid": header.get("rid"), "result": "SEG"}
            )
            return
        self._finish_data(header, final, read_seconds, None, None)

    def _stream_result(self, header, read_seconds, final, exc) -> None:
        server = self._server
        if exc is not None:
            if isinstance(exc, _DeltaBaseMissing):
                server.stats["receive_delta_base_misses"] = (
                    server.stats.get("receive_delta_base_misses", 0) + 1
                )
                self._reply(
                    wire.MSG_ERR,
                    {
                        "rid": header.get("rid"),
                        "code": "delta_base",
                        "error": str(exc),
                    },
                )
                return
            server.stats["receive_crc_errors"] = (
                server.stats.get("receive_crc_errors", 0) + 1
            )
            self._notify_sink_abort(header, corrupt=True)
            self._reply(
                wire.MSG_ERR,
                {
                    "rid": header.get("rid"),
                    "error": f"stream payload verification failed: {exc}",
                },
            )
            return
        self._finish_data(header, final, read_seconds, None, None)

    def _finish_data(
        self, header, payload, read_seconds, expected_crc, actual
    ) -> None:
        server = self._server
        if expected_crc is not None and actual != expected_crc:
            server.stats["receive_crc_errors"] = (
                server.stats.get("receive_crc_errors", 0) + 1
            )
            self._notify_sink_abort(header, corrupt=True)
            self._reply(
                wire.MSG_ERR,
                {
                    "rid": header.get("rid"),
                    "error": f"payload checksum mismatch "
                    f"({actual:#x} != {expected_crc:#x})",
                },
            )
            return
        ep = (header.get("meta") or {}).get(wire.EPOCH_TAG_KEY)
        if ep is not None and server.epoch_provider is not None:
            cur = server.epoch_provider()
            if cur is not None and int(ep) < int(cur):
                # STALE-epoch frame (elastic membership): the sender's
                # roster lags this party's — reject LOUDLY and fatally
                # (a retry can't fix a stale epoch; the late
                # contribution folds into the next round via the
                # sender's own DGA correction instead).  Frames from a
                # NEWER epoch are accepted: a straggler a full round
                # behind still has the old epoch when the advanced
                # coordinator's broadcast lands, and that broadcast is
                # the very frame carrying the roster transition it
                # needs — gating it would strand every straggler.
                server.stats["receive_epoch_rejects"] = (
                    server.stats.get("receive_epoch_rejects", 0) + 1
                )
                logger.warning(
                    "[%s] rejecting frame (%s, %s) from %s: roster epoch "
                    "%s, this party is at epoch %s",
                    server._party, header.get("up"), header.get("down"),
                    header.get("src"), ep, cur,
                )
                self._notify_sink_abort(header, corrupt=False)
                self._reply(
                    wire.MSG_ERR,
                    {
                        "rid": header.get("rid"),
                        "fatal": True,
                        "code": "epoch",
                        "error": (
                            f"stale roster epoch: frame carries epoch "
                            f"{ep}, party {server._party!r} is at epoch "
                            f"{cur} — the membership advanced; fold the "
                            f"late contribution into the next round"
                        ),
                    },
                )
                return
        message = Message(
            src_party=header.get("src", "?"),
            upstream_seq_id=str(header.get("up")),
            downstream_seq_id=str(header.get("down")),
            payload=payload,
            metadata=header.get("meta", {}),
            read_seconds=read_seconds,
            error=header.get("err"),
        )
        server.stats["receive_op_count"] += 1
        server.stats["receive_bytes"] += len(payload)
        _tr = telemetry.active()
        if _tr is not None:
            # Server-side delivery record: a verified payload is about
            # to reach its consumer (observer, chunk sink, or mailbox).
            # This is a sync event-loop callback — the emit is a ring
            # append, never a sleep (the fire_nonblocking discipline).
            meta = header.get("meta") or {}
            rnd = meta.get(wire.ROUND_TAG_KEY)
            _tr.emit(
                "wire.deliver", party=server._party,
                peer=message.src_party,
                stream=message.upstream_seq_id,
                nbytes=len(payload),
                t_start=time.time() - float(read_seconds or 0.0),
                dur_s=float(read_seconds or 0.0),
                round=int(rnd) if rnd is not None else None,
                epoch=int(ep) if ep is not None else None,
                outcome="error" if message.error is not None else "ok",
            )
        key = (message.upstream_seq_id, message.downstream_seq_id)
        for obs in list(server._observers):
            try:
                if obs(message):
                    # Consumed by a control-plane observer (e.g. a
                    # roster membership request): never enters the
                    # mailbox, but the rendezvous is still remembered
                    # (sender retries dedupe) and the delivery counts
                    # as liveness.
                    server._mailbox.mark_delivered(message.src_party, key)
                    self._reply(
                        wire.MSG_ACK,
                        {"rid": header.get("rid"), "result": "OK"},
                    )
                    return
            except Exception:  # pragma: no cover - observer bug
                logger.exception(
                    "[%s] message observer failed", server._party
                )
        sink = server.take_chunk_sink(key)
        if sink is not None:
            # Sink-consumed delivery: the payload never parks in the
            # mailbox (the streaming aggregator already folded it in, or
            # takes it whole here) — but the rendezvous is still marked
            # consumed so a sender retry after a lost ACK is deduped,
            # and the delivery still counts as peer liveness.
            server._mailbox.mark_delivered(message.src_party, key)
            try:
                if message.error is not None:
                    sink.on_error(message.error)
                else:
                    sink.on_complete(message.payload)
            except Exception:
                logger.exception(
                    "[%s] chunk sink completion failed", server._party
                )
            self._reply(
                wire.MSG_ACK, {"rid": header.get("rid"), "result": "OK"}
            )
            return
        if server._on_message is not None:
            server._on_message(message)
        server._mailbox.put(message)
        self._reply(wire.MSG_ACK, {"rid": header.get("rid"), "result": "OK"})


def _crc_of(payload) -> int:
    from rayfed_tpu_torch import native

    return native.crc32c(payload)


def _verify_and_apply_stream(server: "TransportServer", header, payload):
    """Verify a stream frame's per-chunk CRCs; rebuild deltas on the base.

    Executor-thread safe (pure byte work + the server's delta-base lock).
    Returns the FULL logical payload: the frame's own payload for full
    sends, or a fresh buffer with the changed chunks overlaid on the
    cached base for delta frames.  The result is stored as the stream's
    new base — never mutated in place afterwards, so zero-copy decode
    views of a delivered payload stay valid.
    """
    import zlib

    csz = int(header.get("ccsz") or wire.DELTA_CHUNK_BYTES)
    ccrc = header["ccrc"]
    dlt = header.get("dlt")
    src = header.get("src", "?")
    stm = header.get("stm", "?")
    mv = memoryview(payload)

    if dlt is None:
        nch = max(1, -(-len(mv) // csz))
        if len(ccrc) != nch:
            raise ValueError(
                f"{len(ccrc)} chunk CRCs for {nch} payload chunks"
            )
        for i, expect in enumerate(ccrc):
            if zlib.crc32(mv[i * csz : (i + 1) * csz]) != expect:
                raise ValueError(f"chunk {i} CRC mismatch")
        server._store_delta_base(
            src, stm, payload, list(ccrc), wire.crc_fingerprint(ccrc)
        )
        return payload

    total = int(dlt["total"])
    nch = max(1, -(-total // csz))
    indices = wire.decode_chunk_bitmap(dlt["map"], nch)
    if len(indices) != len(ccrc):
        raise ValueError(
            f"delta bitmap selects {len(indices)} chunks but "
            f"{len(ccrc)} CRCs were sent"
        )
    base = server._get_delta_base(src, stm)
    if base is None:
        raise _DeltaBaseMissing(
            f"no cached base for stream {stm!r} from {src!r}"
        )
    if len(base["data"]) != total or base["fp"] != int(dlt["bfp"]):
        raise _DeltaBaseMissing(
            f"cached base for stream {stm!r} from {src!r} desynced "
            f"(restart or lost update)"
        )
    if not indices:
        # Byte-identical resend (the cache's best case): the stored base
        # IS the payload — no O(model) copy, no re-store (bases are
        # never mutated in place, so sharing it with the consumer is
        # safe).
        if len(mv):
            raise ValueError("empty delta bitmap with a non-empty payload")
        server.stats["receive_delta_frames"] = (
            server.stats.get("receive_delta_frames", 0) + 1
        )
        server.stats["receive_delta_bytes_saved"] = (
            server.stats.get("receive_delta_bytes_saved", 0) + total
        )
        return base["data"]
    new = bytearray(base["data"])
    new_ccrc = list(base["ccrc"])
    off = 0
    for i, expect in zip(indices, ccrc):
        size = min(csz, total - i * csz)
        chunk = mv[off : off + size]
        if len(chunk) != size:
            raise ValueError("delta payload shorter than its bitmap")
        if zlib.crc32(chunk) != expect:
            raise ValueError(f"delta chunk {i} CRC mismatch")
        new[i * csz : i * csz + size] = chunk
        new_ccrc[i] = expect
        off += size
    if off != len(mv):
        raise ValueError(
            f"delta payload has {len(mv) - off} trailing bytes"
        )
    server._store_delta_base(
        src, stm, new, new_ccrc, wire.crc_fingerprint(new_ccrc)
    )
    server.stats["receive_delta_frames"] = (
        server.stats.get("receive_delta_frames", 0) + 1
    )
    server.stats["receive_delta_bytes_saved"] = (
        server.stats.get("receive_delta_bytes_saved", 0) + total - len(mv)
    )
    return new


def _apply_stripe_frame(
    server: "TransportServer", header, payload, read_seconds
):
    """Verify and place one stripe frame's chunks (wire v4).

    Returns ``(full_payload, read_s_total)`` when the frame completes
    its payload's reassembly, ``(None, read_seconds)`` while partial.
    Executor-thread safe: frames of one payload arrive concurrently on
    different rail connections — the assembly map is guarded by the
    server's stripe lock, chunk placement by the per-assembly lock.

    A frame whose ``sid`` is newer than the pending assembly's replaces
    it (the sender's retry re-ships the whole payload under a fresh
    sid); an older ``sid`` is a stale frame of a failed attempt and is
    rejected.  Fresh payloads additionally feed any registered chunk
    sink their growing contiguous VERIFIED prefix, so streaming
    aggregation keeps overlapping the wire under shuffled arrival.
    """
    import zlib

    stp = header["stp"]
    dlt = header["dlt"]
    src = header.get("src", "?")
    stm = header.get("stm")
    sid = int(stp["sid"])
    nf = int(stp["nf"])
    total = int(dlt["total"])
    csz = int(header.get("ccsz") or wire.DELTA_CHUNK_BYTES)
    nch = max(1, -(-total // csz))
    key = (src, str(header.get("up")), str(header.get("down")))
    is_delta = "bfp" in dlt

    with server._stripe_lock:
        now = time.monotonic()
        for k in list(server._stripes):  # drop abandoned assemblies
            if now - server._stripes[k].touched > _STRIPE_IDLE_DROP_S:
                server._note_stripe_evicted(k, server._stripes[k].sid)
                del server._stripes[k]
        asm = server._stripes.get(key)
        if asm is not None and sid < asm.sid:
            raise _StripeReject(
                f"stale stripe frame (sid {sid} < current {asm.sid})"
            )
        if asm is None and (key, sid) in server._stripe_evicted:
            # A continuation frame of a group whose assembly was
            # evicted: recreating it would restart the frame counter
            # and the group could never complete (every rail would ACK
            # SEG forever).  Fail the frame so the sender drains its
            # rails and re-ships the payload under a fresh sid.
            raise _StripeReject(
                f"stripe assembly (sid {sid}) was dropped under memory "
                f"pressure before this frame arrived; re-send the payload"
            )
        if asm is None or sid > asm.sid:
            if total > server._max_message_size:
                raise _StripeFatal(
                    f"striped message of {total} bytes exceeds max "
                    f"{server._max_message_size}"
                )
            if is_delta:
                if stm is None:
                    raise ValueError("delta stripe frame without a stream")
                base = server._get_delta_base(src, stm)
                if base is None:
                    raise _DeltaBaseMissing(
                        f"no cached base for stream {stm!r} from {src!r}"
                    )
                if len(base["data"]) != total or base["fp"] != int(dlt["bfp"]):
                    raise _DeltaBaseMissing(
                        f"cached base for stream {stm!r} from {src!r} "
                        f"desynced (restart or lost update)"
                    )
                buf = bytearray(base["data"])
                ccrc = list(base["ccrc"])
            else:
                buf = bytearray(total)
                ccrc = [0] * nch
            asm = _StripeAsm(sid, total, csz, nch, nf, buf, ccrc, is_delta)
            server._stripes[key] = asm
            server._stripes.move_to_end(key)
            while len(server._stripes) > _MAX_STRIPE_ASM:
                old_key, old_asm = server._stripes.popitem(last=False)
                # The evicted group can never complete now — remember
                # it so its remaining frames error (sender retries)
                # instead of silently recreating a counter that never
                # reaches nf.
                server._note_stripe_evicted(old_key, old_asm.sid)
        else:
            server._stripes.move_to_end(key)
        asm.touched = now

    try:
        if (
            asm.total != total or asm.csz != csz or asm.nf != nf
            or asm.is_delta != is_delta
        ):
            raise _StripeReject("stripe frames disagree on payload geometry")
        indices = wire.decode_chunk_bitmap(dlt["map"], nch)
        ccrc_hdr = header["ccrc"]
        if len(indices) != len(ccrc_hdr):
            raise ValueError(
                f"stripe bitmap selects {len(indices)} chunks but "
                f"{len(ccrc_hdr)} CRCs were sent"
            )
        mv = memoryview(payload)
        with asm.lock:
            off = 0
            for i, expect in zip(indices, ccrc_hdr):
                size = min(csz, total - i * csz)
                chunk = mv[off : off + size]
                if len(chunk) != size:
                    raise ValueError("stripe payload shorter than its bitmap")
                if zlib.crc32(chunk) != expect:
                    raise ValueError(f"stripe chunk {i} CRC mismatch")
                asm.buf[i * csz : i * csz + size] = chunk
                asm.ccrc[i] = expect
                asm.have.add(i)
                off += size
            if off != len(mv):
                raise ValueError(
                    f"stripe payload has {len(mv) - off} trailing bytes"
                )
            asm.frames += 1
            asm.shipped += len(mv)
            asm.read_s += read_seconds
            complete = asm.frames >= asm.nf
            if complete and not asm.is_delta and len(asm.have) != nch:
                raise ValueError(
                    f"stripe group complete with {len(asm.have)}/{nch} chunks"
                )
            feed_to = 0
            if not asm.is_delta:
                while asm.prefix in asm.have:
                    asm.prefix += 1
                feed_to = min(asm.prefix * csz, total)
    except Exception:
        # A bad frame kills the whole assembly: the sender fails the
        # payload as a unit and re-ships it under a fresh sid.  Mark it
        # evicted so sibling frames still in flight on other rails fail
        # fast instead of recreating a counter that can't complete.
        with server._stripe_lock:
            if server._stripes.get(key) is asm:
                server._note_stripe_evicted(key, asm.sid)
                del server._stripes[key]
        raise

    if not complete:
        if feed_to:
            sink = server.peek_chunk_sink(
                (str(header.get("up")), str(header.get("down")))
            )
            if sink is not None:
                try:  # sinks are thread-safe (see fl.streaming)
                    sink.on_bytes(memoryview(asm.buf), feed_to)
                except Exception:
                    logger.exception(
                        "[%s] chunk sink failed (stripe feed)",
                        server._party,
                    )
        return None, read_seconds

    with server._stripe_lock:
        if server._stripes.get(key) is asm:
            del server._stripes[key]
    if stm is not None:
        server._store_delta_base(
            src, stm, asm.buf, asm.ccrc, wire.crc_fingerprint(asm.ccrc)
        )
    server.stats["receive_stripe_frames"] = (
        server.stats.get("receive_stripe_frames", 0) + asm.frames
    )
    server.stats["receive_striped_payloads"] = (
        server.stats.get("receive_striped_payloads", 0) + 1
    )
    if asm.is_delta:
        server.stats["receive_delta_frames"] = (
            server.stats.get("receive_delta_frames", 0) + 1
        )
        server.stats["receive_delta_bytes_saved"] = (
            server.stats.get("receive_delta_bytes_saved", 0)
            + total - asm.shipped
        )
    _tr = telemetry.active()
    if _tr is not None:
        # Multi-rail reassembly completed: one record per striped
        # payload with how many cross-rail frames built it and how many
        # bytes actually crossed the wire (delta stripes overlay a
        # cached base).  Ring append only — may run on the loop.
        _tr.emit(
            "wire.reassemble", party=server._party, peer=src,
            stream=stm, nbytes=total,
            t_start=time.time() - asm.read_s, dur_s=asm.read_s,
            detail={
                "frames": asm.frames, "shipped_bytes": asm.shipped,
                "delta": bool(asm.is_delta),
            },
        )
    return asm.buf, asm.read_s


class TransportServer:
    def __init__(
        self,
        party: str,
        listen_addr: str,
        mailbox: Mailbox,
        max_message_size: int,
        ssl_context: Optional[ssl.SSLContext] = None,
        on_message: Optional[Callable[[Message], None]] = None,
    ) -> None:
        self._party = party
        host, _, port = listen_addr.rpartition(":")
        self._host = host or "0.0.0.0"
        self._port = int(port)
        self._mailbox = mailbox
        self._max_message_size = max_message_size
        self._ssl_context = ssl_context
        self._server: Optional[asyncio.AbstractServer] = None
        self._on_message = on_message
        # Consuming observers (loop thread): each is called with every
        # delivered DATA message BEFORE the mailbox; returning True
        # consumes it (no mailbox entry, still ACKed + liveness-
        # credited).  The control-plane demux the roster membership
        # inbox rides on — unlike _on_message (the multi-host leader's
        # republish tap), observers may be stacked.
        self._observers: list = []
        # Elastic membership: () -> Optional[int], the receiver's
        # current roster epoch.  Frames stamped with a different epoch
        # (wire.EPOCH_TAG_KEY) are rejected loudly.  Set by the manager.
        self.epoch_provider: Optional[Callable[[], Optional[int]]] = None
        # Secure-aggregation key agreement (transport/secagg.py): when
        # set by the manager, inbound HELLOs have their key
        # advertisement recorded and the HELLO reply carries ours.
        self.secagg: Optional[Any] = None
        self._warned_no_native_crc = False
        self.stats: Dict[str, Any] = {"receive_op_count": 0, "receive_bytes": 0}
        # Per-party monotonically growing byte counters INCLUDING bytes
        # of payloads still in flight (the completed-put counters above
        # only move at frame boundaries).  Written from the loop thread
        # and the raw-read executor threads: plain dict ops are atomic
        # under the GIL, and a (rare) lost += only delays the health
        # monitor's liveness credit by one ping cycle.
        self._rx_progress: Dict[str, int] = {}
        # Delta bases: (src, stream) → last full payload + its chunk
        # CRCs + fingerprint.  Touched from the loop thread and the
        # stream-verify executor jobs, hence the lock; bounded LRU.
        self._delta_lock = threading.Lock()
        self._delta_bases: "collections.OrderedDict[Tuple[str, str], Dict]" = (
            collections.OrderedDict()
        )
        # Multi-rail stripe reassemblies (wire v4): rendezvous key →
        # in-progress _StripeAsm.  Touched from several executor
        # threads concurrently (one per rail connection) — the map is
        # guarded here, chunk placement by each assembly's own lock.
        self._stripe_lock = threading.Lock()
        self._stripes: "collections.OrderedDict[Tuple[str, str, str], _StripeAsm]" = (
            collections.OrderedDict()
        )
        # (key, sid) pairs whose in-progress assembly was evicted (LRU
        # pressure / idle drop): their continuation frames must error —
        # recreating the assembly would restart the frame counter and
        # the group could never complete.  Bounded ring; guarded by
        # _stripe_lock.
        self._stripe_evicted: "collections.OrderedDict[Tuple, None]" = (
            collections.OrderedDict()
        )
        # Chunk sinks: (up, down) → streaming consumer (loop thread
        # only; registered by TransportManager.recv_stream).
        self._chunk_sinks: Dict[Tuple[str, str], Any] = {}
        # Live connections (loop thread only): stop() aborts them so
        # peers see EOF promptly instead of half-open sockets.
        self._protocols: set = set()
        # Local-link fast path (transport/local.py): the AF_UNIX twin
        # listener (same frames, same dispatch — just not the loopback
        # TCP stack) and this server's in-process registry id, both
        # advertised in HELLO replies so colocated clients can upgrade.
        self._uds_path: Optional[str] = None
        self._uds_server: Optional[asyncio.AbstractServer] = None
        self._local_sid: Optional[str] = None

    def _note_stripe_evicted(self, key, sid: int) -> None:
        """Record an evicted in-progress stripe group (caller holds
        ``_stripe_lock``)."""
        self._stripe_evicted[(key, sid)] = None
        while len(self._stripe_evicted) > 4 * _MAX_STRIPE_ASM:
            self._stripe_evicted.popitem(last=False)

    def note_rx_progress(self, party: Optional[str], nbytes: int) -> None:
        if party:
            self._rx_progress[party] = self._rx_progress.get(party, 0) + nbytes

    def receive_progress(self) -> Dict[str, int]:
        """Snapshot of per-party received bytes (incl. in-flight payloads)."""
        return dict(self._rx_progress)

    # -- delta base cache (wire v3 streams) -----------------------------------

    def _get_delta_base(self, src: str, stream: str) -> Optional[Dict]:
        with self._delta_lock:
            entry = self._delta_bases.get((src, stream))
            if entry is not None:
                self._delta_bases.move_to_end((src, stream))
            return entry

    def _store_delta_base(
        self, src: str, stream: str, data, ccrc, fp: int
    ) -> None:
        with self._delta_lock:
            self._delta_bases[(src, stream)] = {
                "data": data, "ccrc": ccrc, "fp": fp,
            }
            self._delta_bases.move_to_end((src, stream))
            while len(self._delta_bases) > _MAX_DELTA_BASES:
                self._delta_bases.popitem(last=False)

    # -- chunk sinks (streaming aggregation) ----------------------------------

    def register_chunk_sink(self, key: Tuple[str, str], sink: Any) -> None:
        """Attach a streaming consumer to one (up, down) rendezvous.

        The sink sees ``on_bytes(view, total)`` as payload bytes land
        (loop thread or raw-read executor thread — must be thread-safe),
        then exactly one of ``on_complete(payload)`` / ``on_error(err)``
        on the loop thread; the frame bypasses the mailbox.  A frame
        that dies before delivery — connection lost mid-payload, or
        verification failure — instead emits ``on_frame_abort(corrupt=
        bool)`` and the sink stays registered for the sender's retry.
        Loop-thread only (TransportManager schedules it)."""
        self._chunk_sinks[key] = sink

    def unregister_chunk_sink(self, key: Tuple[str, str]) -> None:
        self._chunk_sinks.pop(key, None)

    def peek_chunk_sink(self, key: Tuple[str, str]):
        return self._chunk_sinks.get(key)

    def take_chunk_sink(self, key: Tuple[str, str]):
        return self._chunk_sinks.pop(key, None)

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._server = await loop.create_server(
            lambda: _FrameProtocol(self),
            host=self._host,
            port=self._port,
            ssl=self._ssl_context,
        )
        if self._port == 0:  # OS-assigned (bridge listeners)
            self._port = self._server.sockets[0].getsockname()[1]
        if self._ssl_context is None:
            # AF_UNIX twin listener (local-link fast path): same
            # protocol, advertised in HELLO replies.  Best-effort — a
            # host without a writable tmpdir just never advertises one,
            # and clients keep TCP.  TLS listeners opt out entirely (an
            # encrypted link must not downgrade to a plain socket).
            path = local.make_uds_path()
            try:
                self._uds_server = await loop.create_unix_server(
                    lambda: _FrameProtocol(self), path
                )
                self._uds_path = path
            except (OSError, NotImplementedError) as e:
                logger.debug(
                    "[%s] no AF_UNIX twin listener: %s", self._party, e
                )
            # In-process registry: colocated clients in THIS interpreter
            # discover the server object itself (shared-memory handoff)
            # without a probe connection.
            self._local_sid = local.register_server(
                self, loop, self._host, self._port
            )
        logger.debug("[%s] transport server listening on %s:%s",
                     self._party, self._host, self._port)

    @property
    def bound_port(self) -> int:
        return self._port

    async def stop(self) -> None:
        local.unregister_server(self._local_sid)
        self._local_sid = None
        if self._uds_server is not None:
            self._uds_server.close()
            await self._uds_server.wait_closed()
            self._uds_server = None
        if self._uds_path is not None:
            try:
                import os

                os.unlink(self._uds_path)
            except OSError:
                pass
            self._uds_path = None
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        # Server.close() only stops the LISTENER; established
        # connections would linger half-open (a peer's in-flight send
        # then waits out its full ACK deadline instead of seeing EOF
        # and reconnecting).  Abort them explicitly.
        for proto in list(self._protocols):
            proto._abort()
        self._protocols.clear()
