"""Content-addressed pull-on-demand blob plane — one per TransportManager.

The repo's transport was purely push-based: the data owner initiates
every transfer, so every large immutable object (base weights, join
welcomes, checkpoint restores) was eagerly shipped even when the
receiver already held the bytes.  The :class:`ObjectPlane` grows the
rendezvous mailbox into a content-addressed blob layer and introduces
the repo's FIRST pull direction:

- **fingerprint handles** — the owner serializes once, fingerprints the
  wire bytes (``wire.blob_fingerprint``, built on the delta-cache's
  chunk-CRC machinery) and passes a small handle instead of the payload
  (:mod:`rayfed_tpu_torch.objects` owns the schemas);
- **BLOB_GET / BLOB_PUT** — a request/reply pair riding the EXISTING
  frame machinery: the request is a tiny payload-less frame stamped
  with ``wire.BLOB_GET_KEY`` metadata (consumed by a server observer,
  like roster membership requests); the reply is an ordinary DATA push
  of the stored wire bytes onto the reply rendezvous key the requester
  is already parked on — so per-chunk CRCs, multi-rail striping and
  stripe reassembly all apply unchanged, with **no new socket**;
- **bounded content-addressed LRU** — byte-budget eviction with
  pin/unpin for live round state, concurrent-fetch dedup (N waiters on
  one fingerprint trigger ONE transfer), and verify-on-arrival: a
  corrupt blob is dropped LOUDLY and re-fetched from a different
  holder;
- **dead-holder failover** — the pull parks in the mailbox with the
  holder named (``Mailbox.get``'s ``src_party``), so a pull aimed at a
  monitor-declared-dead holder fails IMMEDIATELY (the mirror of the
  PR 3 chunk-sink registration fix) and fails over to the next named
  holder instead of waiting out the recv backstop; a holder that does
  not hold the bytes replies a payload-less miss notice with the same
  effect.

What stays push-based: per-round contributions and aggregates (fresh
content every round — nothing to deduplicate), control traffic, and
anything below the handle-offer size floor.  See
``docs/source/object_plane.rst``.
"""

from __future__ import annotations

import asyncio
import collections
import json
import logging
import threading
import time
import uuid
from typing import Any, Dict, Optional, Sequence

from rayfed_tpu_torch import objects, telemetry
from rayfed_tpu_torch.objects import ObjectPlaneError
from rayfed_tpu_torch.transport import wire

logger = logging.getLogger(__name__)

# Rendezvous-key prefixes of the pull protocol.  Requests are consumed
# by a server observer (never enter the mailbox); replies land on a
# per-pull nonce key the requester parks on — derived, not drawn from
# the global seq counter, so pulls compose with rejoin (nothing to
# reconstruct) and two concurrent pulls can never collide.
BLOB_REQ_PREFIX = "blob.req."
BLOB_REPLY_PREFIX = "blob.put."
_BLOB_DOWN = "blob"

# Default byte budget of the content-addressed cache.  Pinned entries
# (live round state: the current model, a just-offered broadcast) are
# never evicted and may exceed the budget; unpinned entries are evicted
# LRU-first the moment the total crosses it.
DEFAULT_BLOB_CACHE_BUDGET = 256 << 20


class _HolderFailure(Exception):
    """One holder could not produce the blob; the pull fails over."""

    def __init__(self, kind: str, detail: str) -> None:
        super().__init__(detail)
        self.kind = kind  # "dead" | "miss" | "corrupt" | "timeout" | "send"


class _Entry:
    __slots__ = ("data", "pinned")

    def __init__(self, data: bytes, pinned: bool) -> None:
        self.data = data
        self.pinned = pinned


class BlobStore:
    """Bounded content-addressed LRU: fingerprint → immutable bytes.

    Thread-safe (hit from user threads, the codec pool, and the
    transport loop's observer).  ``pin``/``unpin`` protect live round
    state from byte-budget eviction; pinned bytes do not count against
    the budget the way candidates do — they simply never leave.
    """

    def __init__(self, budget_bytes: int = DEFAULT_BLOB_CACHE_BUDGET) -> None:
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[str, _Entry]" = (
            collections.OrderedDict()
        )
        self._bytes = 0
        self.budget_bytes = int(budget_bytes)
        self.stats: Dict[str, int] = {
            "blob_store_puts": 0,
            "blob_store_evictions": 0,
            "blob_store_evicted_bytes": 0,
        }

    def put(self, fp: str, data: bytes, pin: bool = False) -> None:
        data = bytes(data)
        with self._lock:
            entry = self._entries.get(fp)
            if entry is not None:
                # Same content (content-addressed): refresh recency and
                # possibly strengthen the pin; never duplicate bytes.
                self._entries.move_to_end(fp)
                entry.pinned = entry.pinned or pin
                return
            self._entries[fp] = _Entry(data, pin)
            self._bytes += len(data)
            self.stats["blob_store_puts"] += 1
            self._evict_locked()

    def _evict_locked(self) -> None:
        if self._bytes <= self.budget_bytes:
            return
        # Never evict the most recently touched entry: the blob just
        # stored/served IS the working set, even when pinned entries
        # alone exceed the budget.
        for fp in list(self._entries)[:-1]:
            if self._bytes <= self.budget_bytes:
                break
            entry = self._entries[fp]
            if entry.pinned:
                continue
            del self._entries[fp]
            self._bytes -= len(entry.data)
            self.stats["blob_store_evictions"] += 1
            self.stats["blob_store_evicted_bytes"] += len(entry.data)

    def get(self, fp: str) -> Optional[bytes]:
        with self._lock:
            entry = self._entries.get(fp)
            if entry is None:
                return None
            self._entries.move_to_end(fp)
            return entry.data

    def contains(self, fp: str) -> bool:
        with self._lock:
            return fp in self._entries

    def pin(self, fp: str) -> None:
        with self._lock:
            entry = self._entries.get(fp)
            if entry is None:
                raise KeyError(f"cannot pin unknown blob {fp}")
            entry.pinned = True

    def unpin(self, fp: str) -> None:
        """Release a pin; the entry stays cached but becomes evictable
        (and is evicted right away when the store is over budget)."""
        with self._lock:
            entry = self._entries.get(fp)
            if entry is None:
                return
            entry.pinned = False
            self._evict_locked()

    def total_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def pinned_bytes(self) -> int:
        with self._lock:
            return sum(
                len(e.data) for e in self._entries.values() if e.pinned
            )

    def fingerprints(self) -> list:
        with self._lock:
            return list(self._entries)


class ObjectPlane:
    """The per-TransportManager pull-on-demand plane (module docstring).

    Construction wires a server observer that consumes BLOB_GET request
    frames (loop thread) and serves them off-loop from the store; pulls
    run on the caller's thread, parking in the mailbox exactly like an
    ordinary recv — dead-party fast-fail included.
    """

    def __init__(
        self, manager, budget_bytes: int = DEFAULT_BLOB_CACHE_BUDGET
    ) -> None:
        self._manager = manager
        self.store = BlobStore(budget_bytes)
        self._lock = threading.Lock()
        self._fetch_pool = None  # lazy; see fetch_executor
        # fingerprint → Future shared by every concurrent local fetch of
        # the same content: N waiters, ONE transfer.
        self._inflight: Dict[str, Any] = {}
        # named pin slots (e.g. the quorum loop's current round model):
        # publishing a new generation into a slot unpins the previous.
        self._slots: Dict[str, str] = {}
        self.stats: Dict[str, int] = {
            "blob_cache_hits": 0,
            "blob_cache_misses": 0,
            "blob_fetches": 0,
            "blob_fetch_bytes": 0,
            "blob_dedup_waits": 0,
            "blob_corrupt_refetches": 0,
            "blob_dead_holder_failovers": 0,
            "blob_serves": 0,
            "blob_serve_bytes": 0,
            "blob_serve_misses": 0,
            "blob_offers": 0,
        }

    @property
    def party(self) -> str:
        return self._manager._party

    @property
    def fetch_executor(self):
        """A small dedicated pool for blocking handle resolution.

        A pull parks for up to a holder round trip — running it on the
        manager's shared codec pool would starve encode/decode and,
        worse, the BLOB_GET *serves* of symmetric pulls (two parties
        each pulling from the other could wedge until timeout).  The
        ``fed.get`` receive chain resolves handles HERE instead; the
        codec pool stays free for quick work."""
        import concurrent.futures as _futures

        with self._lock:
            if self._fetch_pool is None:
                self._fetch_pool = _futures.ThreadPoolExecutor(
                    max_workers=4,
                    thread_name_prefix=f"rayfed-blob-{self.party}",
                )
            return self._fetch_pool

    # -- publish (owner side) ---------------------------------------------

    def publish(
        self, value: Any = None, *, data: Optional[bytes] = None,
        pin: bool = False,
    ) -> tuple:
        """Store one object's wire bytes content-addressed; returns
        ``(fingerprint, nbytes)``.  Pass ``data=`` when the serialized
        bytes already exist (e.g. a just-received payload)."""
        if data is None:
            fp, data = objects.fingerprint_value(value)
        else:
            data = bytes(data)
            fp = wire.blob_fingerprint(data)
        self.store.put(fp, data, pin=pin)
        return fp, len(data)

    def publish_slot(self, slot: str, value: Any = None, *,
                     data: Optional[bytes] = None) -> tuple:
        """Publish pinned into a named slot, unpinning the slot's
        previous generation — how the quorum loop keeps exactly the
        CURRENT round model protected from eviction.  Slot bookkeeping
        is under the plane lock: two racing publishes into one slot
        must leave exactly ONE pinned winner (an orphaned pin would be
        a permanent cache leak)."""
        fp, n = self.publish(value, data=data, pin=True)
        with self._lock:
            prev = self._slots.get(slot)
            self._slots[slot] = fp
        if prev is not None and prev != fp:
            self.store.unpin(prev)
        return fp, n

    def handle_for(
        self, fp: str, nbytes: int, extra_holders: Sequence[str] = ()
    ) -> Dict[str, Any]:
        """A handle naming this party (the publisher) as first holder."""
        holders = [self.party] + [
            h for h in extra_holders if h != self.party
        ]
        return objects.make_blob_handle(fp, nbytes, holders)

    def maybe_offer(self, value: Any, min_bytes: Optional[int]):
        """The ``fed.get`` broadcast hook: when ``value`` is a large
        immutable object (a plain :class:`~rayfed_tpu_torch.fl.compression.
        PackedTree` at or above the size floor), publish it and return
        the handle to send IN PLACE of the payload; otherwise ``None``
        (the eager push proceeds unchanged).  Only exact PackedTrees
        are offered: quantized/masked subclasses carry round-scoped
        grid/mask state that is not content-stable across receivers.
        """
        if min_bytes is None or min_bytes <= 0:
            return None
        from rayfed_tpu_torch.fl.compression import PackedTree

        if type(value) is not PackedTree:
            return None
        try:
            nb = int(getattr(value.buf, "nbytes", 0))
        except Exception:  # pragma: no cover - exotic buf
            return None
        if nb < int(min_bytes):
            return None
        # Slot-pinned: the LATEST offer stays eviction-proof while
        # receivers pull; earlier offers become ordinary LRU citizens
        # (still served on a hit, evicted only under byte pressure).
        fp, n = self.publish_slot("offer", value)
        self.stats["blob_offers"] += 1
        return self.handle_for(fp, n)

    # -- fetch (puller side) ----------------------------------------------

    def fetch_local_bytes(self, fp: str) -> Optional[bytes]:
        """The stored wire bytes for ``fp`` — local cache only, no pull
        (checkpoint restore resolves by fingerprint BEFORE touching
        disk through exactly this)."""
        return self.store.get(fp)

    def fetch(
        self, handle: Dict[str, Any], timeout_s: Optional[float] = None,
        decode: bool = True,
    ) -> Any:
        """Resolve a handle: content-cache hit → zero wire bytes; miss
        → ONE pull shared by every concurrent local waiter, tried
        against the named holders in order with dead/miss/corrupt
        failover.  ``decode=False`` returns the raw wire bytes."""
        handle = objects.check_blob_handle(handle)
        fp = handle["fp"]
        data = self.store.get(fp)
        if data is not None:
            with self._lock:  # concurrent fetches count every resolve
                self.stats["blob_cache_hits"] += 1
            # Flight recorder: one record per resolve with its pull
            # temperature (warm hit / dedup ride / cold wire pull) —
            # the "did the handle actually save bytes" question, per
            # pull instead of summed in stats_snapshot.  Guarded: warm
            # hits are the hot resolve path, so disarmed cost stays
            # one global read (no argument construction).
            if telemetry.active() is not None:
                telemetry.event(
                    "blob.fetch", party=self.party, nbytes=len(data),
                    outcome="warm", detail={"fp": fp},
                )
            return self._decode(data) if decode else data
        import concurrent.futures as _futures

        backstop = (
            float(timeout_s) if timeout_s is not None
            else float(self._manager._job.recv_backstop_s)
        )
        with self._lock:
            # The counters move under the lock: concurrent waiters'
            # unlocked ``+=`` could lose increments.
            self.stats["blob_cache_misses"] += 1
            fut = self._inflight.get(fp)
            owner = fut is None
            if owner:
                fut = _futures.Future()
                self._inflight[fp] = fut
            else:
                self.stats["blob_dedup_waits"] += 1
        if not owner:
            # Concurrent-fetch dedup: ride the in-flight transfer.  The
            # owner may legitimately spend up to one backstop PER named
            # holder (failover), so the waiter bound scales with the
            # holder count — and a waiter timeout surfaces as the
            # plane's own loud error type, never a bare futures
            # TimeoutError.
            t0_wall, t0 = time.time(), time.perf_counter()
            try:
                data = fut.result(
                    timeout=backstop * max(1, len(handle["holders"])) + 5
                )
            except _futures.TimeoutError:
                raise ObjectPlaneError(
                    f"blob {fp}: the in-flight pull this fetch was "
                    f"riding did not finish within the holder-failover "
                    f"window"
                ) from None
            telemetry.emit(
                "blob.fetch", party=self.party, nbytes=len(data),
                t_start=t0_wall, dur_s=time.perf_counter() - t0,
                outcome="dedup", detail={"fp": fp},
            )
            return self._decode(data) if decode else data
        t0_wall, t0 = time.time(), time.perf_counter()
        try:
            data = self.store.get(fp)  # raced-in between miss and lock
            if data is None:
                data = self._pull(handle, backstop)
                self.store.put(fp, data)
                telemetry.emit(
                    "blob.fetch", party=self.party, nbytes=len(data),
                    t_start=t0_wall, dur_s=time.perf_counter() - t0,
                    outcome="cold", detail={"fp": fp},
                )
            else:
                # A concurrent owner completed between the miss and the
                # inflight lock: a resolve is a resolve — every path
                # leaves a blob.fetch record or temperature counts stop
                # reconciling with stats_snapshot under concurrency.
                telemetry.event(
                    "blob.fetch", party=self.party, nbytes=len(data),
                    outcome="warm", detail={"fp": fp, "raced": True},
                )
            fut.set_result(data)
        except BaseException as exc:
            fut.set_exception(exc)
            raise
        finally:
            with self._lock:
                self._inflight.pop(fp, None)
        return self._decode(data) if decode else data

    def _decode(self, data: bytes) -> Any:
        """Decode exactly like the ordinary recv path, so a handle-
        resolved object is indistinguishable from an eager push."""
        mgr = self._manager
        mesh = mgr.mesh_provider() if mgr.mesh_provider else None
        return objects.deserialize_blob(
            data,
            allowed=mgr._cluster.serializing_allowed_list,
            device_put=mgr._job.device_put_received,
            device=mgr.device,
            mesh=mesh,
            zero_copy=mgr._job.zero_copy_host_arrays,
        )

    def _pull(self, handle: Dict[str, Any], timeout_s: float) -> bytes:
        fp = handle["fp"]
        holders = objects.holders_for(handle, exclude=(self.party,))
        if not holders:
            raise ObjectPlaneError(
                f"blob {fp} is not cached locally and the handle names "
                f"no other holder ({handle['holders']})"
            )
        outcomes = []
        for holder in holders:
            try:
                data = self._pull_once(fp, holder, timeout_s)
            except _HolderFailure as exc:
                outcomes.append(f"{holder}: {exc.kind} ({exc})")
                telemetry.event(
                    "blob.failover", party=self.party, peer=holder,
                    outcome=exc.kind, detail={"fp": fp},
                )
                if exc.kind == "corrupt":
                    self.stats["blob_corrupt_refetches"] += 1
                    logger.warning(
                        "[%s] blob %s from holder %s FAILED content "
                        "verification on arrival (%s); re-fetching from "
                        "a different holder",
                        self.party, fp, holder, exc,
                    )
                elif exc.kind == "dead":
                    self.stats["blob_dead_holder_failovers"] += 1
                    logger.warning(
                        "[%s] blob pull of %s: holder %s is declared "
                        "dead; failing over to the next named holder",
                        self.party, fp, holder,
                    )
                else:
                    logger.warning(
                        "[%s] blob pull of %s from %s failed (%s: %s); "
                        "trying the next holder",
                        self.party, fp, holder, exc.kind, exc,
                    )
                continue
            self.stats["blob_fetches"] += 1
            self.stats["blob_fetch_bytes"] += len(data)
            return data
        raise ObjectPlaneError(
            f"blob pull of {fp} failed at every named holder: "
            f"{'; '.join(outcomes)}"
        )

    def _pull_once(self, fp: str, holder: str, timeout_s: float) -> bytes:
        """One BLOB_GET round trip against one holder.

        The reply wait is an ordinary mailbox park WITH the holder
        named (``src_party``): a holder already declared dead fails the
        park immediately, and one that dies mid-pull is failed by the
        health monitor within its death deadline — never the backstop.
        """
        mgr = self._manager
        nonce = uuid.uuid4().hex
        reply_up = f"{BLOB_REPLY_PREFIX}{fp}.{self.party}.{nonce}"
        recv_cf = asyncio.run_coroutine_threadsafe(
            mgr._mailbox.get(
                reply_up, _BLOB_DOWN, timeout_s=timeout_s,
                src_party=holder,
            ),
            mgr._loop,
        )
        req = objects.make_blob_request(fp, reply_up)
        metadata = {
            wire.BLOB_GET_KEY: json.dumps(
                req, separators=(",", ":"), sort_keys=True
            )
        }
        try:
            client = mgr._get_client(holder)
            send_cf = asyncio.run_coroutine_threadsafe(
                client.send_data(
                    [], f"{BLOB_REQ_PREFIX}{self.party}.{nonce}",
                    _BLOB_DOWN, metadata=metadata,
                ),
                mgr._loop,
            )
            send_cf.result(timeout=timeout_s)
        except Exception as exc:
            recv_cf.cancel()
            mgr.discard_empty_park(reply_up, _BLOB_DOWN)
            raise _HolderFailure(
                "send", f"BLOB_GET request could not be delivered: {exc!r}"
            ) from exc
        from rayfed_tpu_torch.exceptions import PartyWaitTimeout

        try:
            msg = recv_cf.result(timeout=timeout_s + 5)
        except PartyWaitTimeout as exc:
            raise _HolderFailure(
                "timeout", f"no reply within {timeout_s}s"
            ) from exc
        except Exception as exc:
            raise _HolderFailure("timeout", repr(exc)) from exc
        if msg.error is not None:
            # Dead-holder fast-fail (Mailbox.get's src_party poison) or
            # a mid-pull death delivered by the health monitor.
            raise _HolderFailure(
                "dead", msg.error.get("msg", str(msg.error))
            )
        raw_rep = (msg.metadata or {}).get(wire.BLOB_PUT_KEY)
        rep: Dict[str, Any] = {}
        if raw_rep is not None:
            try:
                rep = objects.check_blob_reply_meta(json.loads(raw_rep))
            except Exception as exc:
                raise _HolderFailure(
                    "corrupt", f"malformed BLOB_PUT metadata: {exc!r}"
                ) from exc
        if rep.get("miss"):
            raise _HolderFailure(
                "miss", "holder does not hold these bytes"
            )
        data = bytes(msg.payload)
        got = wire.blob_fingerprint(data)
        if got != fp:
            raise _HolderFailure(
                "corrupt",
                f"arrived bytes fingerprint {got} != requested {fp}",
            )
        return data

    # -- serve (holder side) ----------------------------------------------

    def _observe_request(self, message) -> bool:
        """Server observer (transport loop thread): BLOB_GET request
        frames — identified by their ``wire.BLOB_GET_KEY`` metadata —
        are consumed here (ACKed, never enter the mailbox) and served
        off-loop from the store."""
        raw = (message.metadata or {}).get(wire.BLOB_GET_KEY)
        if raw is None:
            return False
        if message.error is not None:
            return True  # a poisoned request carries nothing to serve
        try:
            req = objects.check_blob_request(json.loads(raw))
        except Exception:
            logger.warning(
                "[%s] malformed BLOB_GET request from %s: %r",
                self.party, message.src_party, raw,
            )
            return True
        self._manager._codec_pool.submit(
            self._serve, message.src_party, req
        )
        return True

    def _serve(self, requester: str, req: Dict[str, Any]) -> None:
        """Codec-pool thread: push the stored bytes (or a miss notice)
        to the requester's reply key.  Ordinary DATA framing — striping
        / per-chunk CRC / reassembly apply to large blobs unchanged."""
        mgr = self._manager
        fp = req["fp"]
        data = self.store.get(fp)
        crc = None
        if data is None:
            self.stats["blob_serve_misses"] += 1
            bufs: list = []
            rep = objects.make_blob_reply_meta(fp, miss=True)
        else:
            self.stats["blob_serves"] += 1
            self.stats["blob_serve_bytes"] += len(data)
            bufs = [data]
            rep = objects.make_blob_reply_meta(fp, len(data))
        metadata = {
            wire.BLOB_PUT_KEY: json.dumps(
                rep, separators=(",", ":"), sort_keys=True
            )
        }
        try:
            client = mgr._get_client(requester)
            if (
                data is not None
                and client.checksum_enabled
                and len(data) < wire.SHARD_STREAM_THRESHOLD
            ):
                # Small replies: checksum here (off-loop); streamed /
                # striped replies chain their CRC per chunk as usual.
                from rayfed_tpu_torch import native

                crc = native.crc32c_multi(bufs)
            cf = asyncio.run_coroutine_threadsafe(
                client.send_data(
                    bufs, req["rk"], _BLOB_DOWN, metadata=metadata,
                    crc=crc,
                ),
                mgr._loop,
            )
        except Exception:
            logger.exception(
                "[%s] blob serve of %s to %s could not be dispatched",
                self.party, fp, requester,
            )
            return

        def _done(f) -> None:
            exc = (
                f.exception() if not f.cancelled()
                else asyncio.CancelledError("transport stopped")
            )
            if exc is not None:
                # Best-effort: the requester's per-holder timeout (or
                # its own death) governs; it retries another holder.
                logger.warning(
                    "[%s] blob serve of %s to %s failed: %r",
                    self.party, fp, requester, exc,
                )

        cf.add_done_callback(_done)

    def close(self) -> None:
        """Shut the fetch pool down (manager.stop)."""
        with self._lock:
            pool, self._fetch_pool = self._fetch_pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    # -- introspection -----------------------------------------------------

    def stats_snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self.stats)
        out.update(self.store.stats)
        out["blob_cache_bytes"] = self.store.total_bytes()
        out["blob_pinned_bytes"] = self.store.pinned_bytes()
        out["blob_cache_entries"] = len(self.store.fingerprints())
        return out
