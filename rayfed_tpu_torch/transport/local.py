"""Local-link fast path: colocation detection + same-process delivery.

The transport backend is a per-link decision (``local_link:
auto|uds|shm|off`` in transport options).  This module holds the three
pieces every backend upgrade needs:

- **Colocation proof.**  :func:`host_identity` is a boot-scoped host
  fingerprint (machine-id + boot-id hash) every server volunteers in its
  HELLO reply under :data:`wire.LOCAL_HOST_KEY`; two endpoints that
  present the same value share a kernel, so an AF_UNIX socket (path
  advertised under :data:`wire.LOCAL_UDS_KEY`) reaches the peer without
  the loopback-TCP stack.  :func:`process_token` goes one step further —
  a per-process random token under :data:`wire.LOCAL_TOKEN_KEY` proves
  the peer lives in THIS interpreter, unlocking the shared-memory
  handoff below.

- **In-process server registry.**  Virtual parties (benches, tests, the
  hierarchy ladder) run every :class:`TransportServer` in one process;
  :func:`register_server` / :func:`lookup_addr` let a client discover
  the destination server object without ever opening a probe socket —
  at N=64 that alone removes ~2k loopback connections per round.

- **Shared-memory handoff.**  :func:`deliver` hands a payload buffer to
  the destination server BY REFERENCE: the buffer is scheduled onto the
  server's event loop and pushed through ``_FrameProtocol``'s normal
  dispatch chain, so chunk sinks, epoch rejects, chaos ``wire``/
  ``server_frame`` hooks, receive stats, telemetry ``wire.deliver``
  spans, observers and the mailbox all behave exactly as on a socket.
  Per-chunk CRC is elided on this path — the bytes never leave the
  machine, and the handoff buffer is freshly allocated per send (the
  PR 5 ping-pong arenas stay OUT of this path: their slot reuse at
  round+2 would dangle under a zero-copy receiver holding the previous
  round's views).

Import discipline: ``server.py`` and ``client.py`` both import this
module at top level, so this module imports them only lazily inside
functions.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import os
import secrets
import tempfile
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from rayfed_tpu_torch.transport import wire

logger = logging.getLogger(__name__)

#: Valid values of the ``local_link`` transport option.
LINK_MODES = ("auto", "uds", "shm", "off")


# -- colocation identity ------------------------------------------------------

_HOST_ID: Optional[str] = None
# One random token per interpreter: presenting it back proves the HELLO
# reply was produced by THIS process (a pid alone recycles; a copied
# config file can't fake 128 random bits).
_PROCESS_TOKEN = f"{os.getpid():x}-{secrets.token_hex(16)}"


def host_identity() -> str:
    """Boot-scoped host fingerprint two colocated processes agree on.

    machine-id + boot-id hashed together: stable across processes on one
    running kernel, different across hosts AND across reboots of the
    same host (a stale advertisement can never alias a different boot's
    socket paths).  Hostname fallback for systems exposing neither.
    """
    global _HOST_ID
    if _HOST_ID is None:
        parts = []
        for path in ("/etc/machine-id", "/proc/sys/kernel/random/boot_id"):
            try:
                with open(path) as f:
                    parts.append(f.read().strip())
            except OSError:
                pass
        if not parts:
            import socket as _socket

            parts = [_socket.gethostname()]
        _HOST_ID = hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]
    return _HOST_ID


def process_token() -> str:
    return _PROCESS_TOKEN


def make_uds_path() -> str:
    """A fresh AF_UNIX path for one server's twin listener.

    Kept short on purpose: ``sun_path`` caps at ~104 bytes and a deep
    ``$TMPDIR`` must not silently truncate into a collision."""
    name = f"rfw-{os.getpid()}-{secrets.token_hex(4)}.sock"
    return os.path.join(tempfile.gettempdir(), name)


# -- in-process server registry ----------------------------------------------


class LocalEndpoint:
    """One registered in-process server: the object + its event loop."""

    __slots__ = ("server", "loop", "sid")

    def __init__(self, server: Any, loop: asyncio.AbstractEventLoop, sid: str):
        self.server = server
        self.loop = loop
        self.sid = sid


_REG_LOCK = threading.Lock()
_BY_ADDR: Dict[Tuple[str, int], LocalEndpoint] = {}
_BY_SID: Dict[str, LocalEndpoint] = {}
_SID_SEQ = 0

_LOOPBACK = frozenset({"", "0.0.0.0", "localhost", "127.0.0.1", "::", "::1"})


def _norm_host(host: str) -> str:
    return "127.0.0.1" if host in _LOOPBACK else host


def register_server(server: Any, loop: asyncio.AbstractEventLoop,
                    host: str, port: int) -> str:
    """Record a started server; returns its registry id (``sid``)."""
    global _SID_SEQ
    with _REG_LOCK:
        _SID_SEQ += 1
        sid = str(_SID_SEQ)
        ep = LocalEndpoint(server, loop, sid)
        _BY_ADDR[(_norm_host(host), int(port))] = ep
        _BY_SID[sid] = ep
        return sid


def unregister_server(sid: Optional[str]) -> None:
    if sid is None:
        return
    with _REG_LOCK:
        ep = _BY_SID.pop(sid, None)
        if ep is not None:
            for key, val in list(_BY_ADDR.items()):
                if val is ep:
                    del _BY_ADDR[key]


def lookup_addr(host: str, port: int) -> Optional[LocalEndpoint]:
    """The in-process server listening on ``host:port``, if any."""
    with _REG_LOCK:
        return _BY_ADDR.get((_norm_host(host), int(port)))


def endpoint_alive(ep: LocalEndpoint) -> bool:
    """Synchronous liveness verdict for an in-process peer: still
    registered (its manager hasn't stopped) and its loop still runs.

    This is what makes health monitoring O(1) on shm links: an
    in-process peer cannot die independently of this registry — no
    ping roundtrip needed, and GIL starvation under N virtual parties
    can never read as death (the false positive a wire ping deadline
    risks exactly when the process is busiest)."""
    with _REG_LOCK:
        live = _BY_SID.get(ep.sid) is ep
    return live and not ep.loop.is_closed()


def endpoint_token(sid: str) -> str:
    """The HELLO ``lt`` value naming one in-process server."""
    return f"{_PROCESS_TOKEN}:{sid}"


def lookup_token(token: Optional[str]) -> Optional[LocalEndpoint]:
    """Resolve a HELLO ``lt`` advertisement — None unless it names a
    live server in THIS process (the random-token prefix is the proof)."""
    if not token:
        return None
    ptok, _, sid = token.partition(":")
    if ptok != _PROCESS_TOKEN:
        return None
    with _REG_LOCK:
        return _BY_SID.get(sid)


# -- coalesced cross-loop scheduling ------------------------------------------


class _LoopBatcher:
    """Coalesce cross-thread callbacks onto one event loop.

    ``loop.call_soon_threadsafe`` writes the self-pipe wake byte on
    EVERY call; in an N=64 all-to-all burst that is ~3 wake syscalls
    per message and the flight recorder showed the wake path
    (``_write_to_self``) as the single largest non-idle cost of the
    hierarchy round.  The batcher arms the loop ONCE: callbacks posted
    while the drain is still pending ride the same wake for free, from
    any producer thread.  FIFO order is preserved (single queue, one
    drainer), so delivery/reply ordering is exactly the unbatched
    behaviour.

    A callback posted after the target loop died is dropped and the
    post raises ``RuntimeError`` only when it is the arming call — the
    same contract as ``call_soon_threadsafe`` itself, and the deliver
    path maps both outcomes to the socket analogue (refused connection
    at arm time, reply-deadline timeout for queued-but-undrained).
    """

    __slots__ = ("loop", "_lock", "_queue", "_armed")

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self.loop = loop
        self._lock = threading.Lock()
        self._queue: deque = deque()
        self._armed = False

    def post(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._queue.append(fn)
            if self._armed:
                return
            self._armed = True
        try:
            self.loop.call_soon_threadsafe(self._drain)
        except RuntimeError:
            with self._lock:
                self._armed = False
            raise

    def _drain(self) -> None:
        while True:
            with self._lock:
                if not self._queue:
                    self._armed = False
                    return
                fns = list(self._queue)
                self._queue.clear()
            for fn in fns:
                try:
                    fn()
                except Exception:  # pragma: no cover - callback bug
                    logger.exception("batched loop callback failed")


_BATCHERS: "weakref.WeakKeyDictionary[asyncio.AbstractEventLoop, _LoopBatcher]" = (
    weakref.WeakKeyDictionary()
)
_BATCHERS_LOCK = threading.Lock()


def loop_batcher(loop: asyncio.AbstractEventLoop) -> _LoopBatcher:
    """The (one) coalescing scheduler for ``loop``."""
    with _BATCHERS_LOCK:
        b = _BATCHERS.get(loop)
        if b is None:
            b = _LoopBatcher(loop)
            _BATCHERS[loop] = b
        return b


def post_coroutine(loop: asyncio.AbstractEventLoop, coro) -> "Future":
    """``asyncio.run_coroutine_threadsafe`` with a coalesced wake.

    Identical contract for the caller — a ``concurrent.futures.Future``
    resolving with the coroutine's result — but the loop is armed
    through :func:`loop_batcher`, so a burst of dispatches (the N-1
    sends of a hierarchy fan-out) costs one self-pipe wake instead of
    one per coroutine.  Cancelling the returned future does NOT cancel
    the task (no caller does; ``run_coroutine_threadsafe``'s two-way
    chain is the one piece not reproduced here).  Raises
    ``RuntimeError`` like ``call_soon_threadsafe`` if the loop is gone
    at arm time.
    """
    from concurrent.futures import Future

    cf: Future = Future()

    def _start() -> None:
        try:
            # fedlint: disable=FED002 — _start executes ON the loop thread: it only ever runs inside _LoopBatcher._drain, which the batcher schedules via call_soon_threadsafe
            task = loop.create_task(coro)
        except Exception as e:
            cf.set_exception(e)
            return

        def _chain(t: "asyncio.Task") -> None:
            if t.cancelled():
                cf.cancel()
                return
            exc = t.exception()
            if exc is not None:
                cf.set_exception(exc)
            else:
                cf.set_result(t.result())

        task.add_done_callback(_chain)

    loop_batcher(loop).post(_start)
    return cf


# -- shared-memory delivery ---------------------------------------------------

_DELIVERY_CLS = None


def _delivery_protocol_cls():
    """The one-shot delivery protocol (lazy: avoids a server import cycle).

    A ``_FrameProtocol`` with no transport: parse state is injected
    directly and ``_dispatch_frame`` runs unmodified, so every receive
    semantic — chaos hooks, CRC verify (including a chaos-corrupted
    declared CRC), epoch rejects, observers, chunk sinks, stats,
    telemetry — is the socket path's own code.  Replies are forwarded
    to the sender's loop instead of written to a transport.
    """
    global _DELIVERY_CLS
    if _DELIVERY_CLS is None:
        from rayfed_tpu_torch.transport.server import _FrameProtocol

        class _ShmDelivery(_FrameProtocol):
            def __init__(self, server, on_reply):
                super().__init__(server)
                self._on_reply = on_reply

            def _reply(self, msg_type, header):
                self._on_reply(msg_type, header)

            def _abort(self):
                self._closed = True

        _DELIVERY_CLS = _ShmDelivery
    return _DELIVERY_CLS


def _map_remote_error(header: Dict[str, Any]) -> Exception:
    # Same classification as TransportClient._read_responses.
    from rayfed_tpu_torch.transport.client import (
        DeltaBaseError, FatalSendError, ProtocolMismatchError, SendError,
    )

    if header.get("code") == "protocol":
        exc_cls: type = ProtocolMismatchError
    elif header.get("fatal"):
        exc_cls = FatalSendError
    elif header.get("code") == "delta_base":
        exc_cls = DeltaBaseError
    else:
        exc_cls = SendError
    return exc_cls(header.get("error", "remote error"))


async def deliver(
    endpoint: LocalEndpoint,
    msg_type: int,
    header: Dict[str, Any],
    payload,
    timeout_s: float,
) -> Dict[str, Any]:
    """Hand one frame to an in-process server and await its reply.

    Runs on the SENDER's event loop; the frame is marshaled onto the
    destination server's loop (they differ — every virtual party runs
    its own) and pushed through the normal dispatch chain.  The reply
    resolves a future back on the sender's loop.  Raises the same
    exception classes a socket roundtrip would: ``asyncio.TimeoutError``
    on a reply deadline (e.g. the receiver discarded the frame under a
    chaos fault — no ACK is the point), mapped ``SendError`` subclasses
    for MSG_ERR replies.
    """
    loop = asyncio.get_running_loop()
    fut: asyncio.Future = loop.create_future()
    reply_batcher = loop_batcher(loop)

    def _on_reply(reply_type: int, reply_header: Dict[str, Any]) -> None:
        def _resolve() -> None:
            if fut.done():
                return
            if reply_type == wire.MSG_ERR:
                fut.set_exception(_map_remote_error(reply_header))
            else:
                fut.set_result(reply_header)

        try:
            reply_batcher.post(_resolve)
        except RuntimeError:  # sender loop gone mid-shutdown: nobody waits
            pass

    proto = _delivery_protocol_cls()(endpoint.server, _on_reply)
    t_handoff = time.perf_counter()

    def _run() -> None:
        server = endpoint.server
        try:
            if (
                msg_type == wire.MSG_DATA
                and len(payload) > server._max_message_size
            ):
                # Mirror _fatal_oversize (the prefix-stage reject a
                # socket receiver would have issued).
                _on_reply(wire.MSG_ERR, {
                    "rid": header.get("rid"),
                    "fatal": True,
                    "error": f"message of {len(payload)} bytes exceeds "
                             f"max {server._max_message_size}",
                })
                return
            # Same liveness credit a socket read would earn: a party
            # actively handing us payload bytes is alive.
            server.note_rx_progress(header.get("src"), len(payload))
            # Inject parse state as if the frame was just read, then
            # dispatch through the unmodified receive chain.
            proto._msg_type = msg_type
            proto._flags = 0
            proto._header = header
            proto._plen = len(payload)
            proto._payload = payload
            proto._payload_view = None
            proto._payload_t0 = t_handoff
            proto._dispatch_frame()
        except Exception as e:  # pragma: no cover - dispatch bug
            logger.exception(
                "[%s] local delivery dispatch failed", server._party
            )
            _on_reply(wire.MSG_ERR, {
                "rid": header.get("rid"),
                "error": f"local delivery failed: {e}",
            })

    try:
        loop_batcher(endpoint.loop).post(_run)
    except RuntimeError as e:
        # The destination's event loop is gone (its manager shut down):
        # the socket-path analogue is a refused connection.
        from rayfed_tpu_torch.transport.client import SendError

        raise SendError(
            f"local delivery failed: destination loop closed ({e})"
        ) from e
    return await asyncio.wait_for(fut, timeout=timeout_s)


def materialize(payload_bufs: List, stages=None) -> Tuple[Any, float, float]:
    """Executor job: fetch + gather the payload into ONE fresh buffer.

    The result is handed to the receiver by reference, so it must be
    freshly allocated here (never a reused arena slot) — this gather is
    the single copy a shared-memory send pays.  Returns
    ``(buffer, d2h_seconds, copy_seconds)``; ``stages`` (the flight
    recorder's, armed only) gets the fetches and the gather (``wire.d2h``).
    """
    fetched = [wire.fetch(buf, stages) for buf in payload_bufs]
    views = [mv for mv, _dt in fetched]
    t0 = time.time()
    if len(views) == 1:
        payload: Any = bytearray(views[0])
    else:
        from rayfed_tpu_torch import native

        payload = native.gather_copy(views)
    t1 = time.time()
    if stages is not None:
        stages.add("wire.d2h", t0, t1)
    return payload, sum(dt for _mv, dt in fetched), t1 - t0
