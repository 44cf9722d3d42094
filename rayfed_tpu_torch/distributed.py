"""Multi-process parties: one party spanning several processes.

The port of ``rayfed_tpu/distributed.py``.  The reference's party is one
Ray cluster (any number of machines behind one GCS); the JAX package's is
a ``jax.distributed`` process group.  Here a party of several processes is
a ``torch.distributed`` world: :class:`PartyProcessGroup` starts a
:class:`~torch.distributed.TCPStore` at the party's ``coordinator_address``
(process 0 is its master) and joins the party's world over the same store
(:func:`~rayfed_tpu_torch.parallel.collectives.init_world`), one card a
process, so that a party mesh (``DeviceMesh``) spans every process of the
party.

Cross-party traffic stays on the push transport, but only **process 0 of
each party (the leader)** runs it — one listener, one egress per party.
Values a non-leader process needs (recv'd pushes, broadcast-on-get
results) reach it through the **party process bridge**: every non-leader
runs its own :class:`TransportServer` instance and the leader re-pushes
each received DATA frame's raw payload to it over the same wire stack
(zero-copy frames, CRC, native writev) — bulk tensors never ride the
store.  The store carries only control metadata: the non-leaders' bridge
addresses, barriers and the verdicts of collective settings.

The bridge is keyed by the same deterministic ``(upstream, downstream)``
rendezvous ids as the wire, and each process's mailbox is key-addressed
and unordered — recv futures may resolve in any order on any thread with
no collective-ordering hazard (an ordered collective broadcast would
require every process to resolve recvs in lockstep program order).
"""

from __future__ import annotations

import asyncio
import datetime
import ipaddress
import itertools
import logging
import os
import socket as _socket
import threading
from typing import Any, Dict, Optional

import torch.distributed as dist

from rayfed_tpu_torch.executor import LocalRef

logger = logging.getLogger(__name__)

_BRIDGE_PREFIX = "rayfed_bridge"
_WORLD_PREFIX = "rayfed_world"  # the party world's rendezvous keys in the store


def _local_host_ip(coordinator_host: Optional[str] = None) -> str:
    """Address other party processes can reach this host at.

    ``RAYFED_BRIDGE_HOST`` overrides; a party whose coordinator is on the
    loopback lives on one host and uses it; otherwise the interface of
    the default route (a UDP socket's local address: no packet is sent).
    """
    override = os.environ.get("RAYFED_BRIDGE_HOST")
    if override:
        return override
    try:
        if coordinator_host is not None and ipaddress.ip_address(coordinator_host).is_loopback:
            return "127.0.0.1"
    except ValueError:
        if coordinator_host == "localhost":
            return "127.0.0.1"
    try:
        s = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
        try:
            s.connect(("10.255.255.255", 1))  # no packets sent; routes only
            return s.getsockname()[0]
        finally:
            s.close()
    except Exception:
        return "127.0.0.1"


def _split_address(address: str):
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator_address must be 'host:port', got {address!r}")
    return host, int(port)


class PartyProcessGroup:
    """This party's process group (leader = process 0).

    Starts the party's :class:`~torch.distributed.TCPStore` at
    ``coordinator_address`` (process 0 is its master) and joins the party's
    ``torch.distributed`` world over it: process ``p`` is rank ``p``, on
    ``cuda:(p % device_count)`` unless ``device`` says otherwise (``"cpu"``
    for a gloo world on the CPU).  :attr:`device` is the process's device.
    The store carries the control metadata (bridge addresses, barriers);
    every wait on it has a deadline.
    """

    def __init__(
        self,
        coordinator_address: str,
        num_processes: int,
        process_id: int,
        *,
        device: Optional[Any] = None,
        timeout_s: float = 300.0,
    ) -> None:
        from rayfed_tpu_torch.parallel.collectives import init_world

        host, port = _split_address(coordinator_address)
        store = dist.TCPStore(
            host, port, int(num_processes), is_master=int(process_id) == 0,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        self._attach(store, coordinator_address, num_processes, process_id)
        self.device = init_world(
            self.process_id, self.num_processes,
            store=dist.PrefixStore(_WORLD_PREFIX, store), device=device, timeout_s=timeout_s,
        )

    def _attach(self, store, coordinator_address: str, num_processes: int, process_id: int) -> None:
        self._store = store
        self.coordinator_address = coordinator_address
        self.num_processes = int(num_processes)
        self.process_id = int(process_id)
        self.device = None

    @property
    def is_leader(self) -> bool:
        return self.process_id == 0

    @property
    def host(self) -> str:
        return _split_address(self.coordinator_address)[0]

    # -- control metadata ------------------------------------------------------

    def publish_bridge_address(self, address: str) -> None:
        """Non-leader: advertise this process's bridge listener."""
        self.key_value_set(f"{_BRIDGE_PREFIX}_addr/{self.process_id}", address)

    def fetch_bridge_address(self, pid: int, timeout_s: float) -> str:
        """Leader: resolve a non-leader's bridge listener address."""
        return self.blocking_key_value_get(f"{_BRIDGE_PREFIX}_addr/{pid}", timeout_s)

    def key_value_set(self, key: str, value: str) -> None:
        """Generic control-metadata publish (leader verdicts etc.)."""
        self._store.set(key, value)

    def blocking_key_value_get(self, key: str, timeout_s: float) -> str:
        """Generic control-metadata fetch with a deadline (raises when the
        key does not appear within ``timeout_s``)."""
        self._store.wait([key], datetime.timedelta(seconds=timeout_s))
        return self._store.get(key).decode()

    def barrier(self, name: str, timeout_s: float = 120.0) -> None:
        """Party-wide barrier with a DEADLINE and a named failure: the
        raw store error says only that a key timed out — wrap it so the
        operator learns which barrier, which process, and how long it
        waited (the missing processes are whichever never arrived)."""
        try:
            self._store.set(f"rayfed_barrier/{name}/{self.process_id}", "1")
            self._store.wait(
                [f"rayfed_barrier/{name}/{p}" for p in range(self.num_processes)],
                datetime.timedelta(seconds=timeout_s),
            )
        except Exception as e:
            raise RuntimeError(
                f"party process barrier {name!r} failed on process "
                f"{self.process_id}/{self.num_processes} after waiting "
                f"{timeout_s:.0f}s — at least one party process never "
                f"arrived (or already failed): {e}"
            ) from e

    def cleanup(self) -> None:
        """Best-effort removal of bridge keys (leader, at shutdown) so a
        re-init against the same store can't resolve a stale address from
        the previous incarnation."""
        if not self.is_leader:
            return
        for pid in range(1, self.num_processes):
            try:
                self._store.delete_key(f"{_BRIDGE_PREFIX}_addr/{pid}")
            except Exception:  # pragma: no cover - a store already gone
                logger.debug("bridge key cleanup failed", exc_info=True)

    def shutdown(self) -> None:
        """Leave the party's world and drop the store."""
        try:
            if dist.is_initialized():
                dist.destroy_process_group()
        except Exception:  # pragma: no cover
            logger.debug("destroy_process_group failed", exc_info=True)
        self._store = None


class MultiHostTransport:
    """Send/recv proxy for a party spanning several processes.

    - Leader: wraps the party's real :class:`TransportManager`; every
      received DATA frame's raw payload is additionally re-pushed to
      each non-leader's bridge server over the wire stack.
    - Non-leader: runs a bridge :class:`TransportManager` (listener on
      an OS-assigned port, advertised through the party's store).  Sends
      resolve ``True`` immediately (the leader performs the real push;
      the same deterministic program runs there); recvs park on the
      local bridge mailbox and decode with the full device_put /
      mesh-re-shard path — each process places its own shards.
    """

    def __init__(
        self,
        inner,  # TransportManager (NOT yet started) | None
        group: PartyProcessGroup,
        *,
        allowed: Optional[Dict] = None,
        device_put_received: bool = True,
        timeout_s: float = 60.0,
        mesh_provider=None,
        job_config=None,
        tls_config: Optional[Dict] = None,
        leader_address: Optional[str] = None,
        device: Any = None,
    ) -> None:
        self._inner = inner
        # The process's device (the party's TransportManager's ``device``):
        # the bridge decodes received tensors onto it.
        self.device = device
        self._group = group
        self._allowed = allowed
        self._device_put = device_put_received
        self._timeout_s = timeout_s
        self._job = job_config
        self._tls_config = tls_config
        # The party's advertised cross-party address — which is the
        # LEADER's listener.  Non-leaders run a watchdog against it so
        # leader death mid-round poisons their parked bridge recvs
        # within the death deadline instead of the recv backstop.
        self._leader_address = leader_address
        self._watchdog_task = None
        self._nl_roster = None  # lazy non-leader roster stub
        self._bridge_mgr = None  # non-leader listener
        self._bridge_clients: Dict[int, Any] = {}  # leader: pid -> client
        self._bridge_ready = threading.Event()
        # Loop-side twin of _bridge_ready: republish coroutines await this
        # instead of parking shared executor threads in a blocking wait
        # (a burst of early frames would otherwise occupy the same
        # executor the server raw-read and writev paths use).  Created
        # lazily ON the inner loop (single-threaded there, so no race).
        self._bridge_ready_async: Optional[asyncio.Event] = None
        # Set by api.init: called with a failed-send LocalRef so the
        # cleanup watchdog sees a fatal republish (exit-on-failure
        # semantics apply to the intra-party bridge too).
        self.failure_handler = None
        # Collective-call sequence for runtime cap mutation: every
        # process of the SPMD program calls set_max_message_size the
        # same number of times in the same order, so a local counter
        # names matching barrier/verdict keys on all of them.
        self._msgcap_seq = itertools.count()

        if group.num_processes <= 1:
            self._bridge_ready.set()
            if inner is not None:
                inner.start()
        elif group.is_leader:
            self._start_leader_bridge()
        else:
            self._start_member_bridge(mesh_provider)
            self._start_leader_watchdog()

    # -- bridge wiring ---------------------------------------------------------

    def _bridge_job_config(self):
        """Bridge-side job knobs: inherit the party's limits (a leader
        republish larger than the bridge server's cap would be fatally
        rejected and silently desync the SPMD program)."""
        import dataclasses

        from rayfed_tpu_torch.config import JobConfig

        base = self._job if self._job is not None else JobConfig()
        return dataclasses.replace(
            base,
            device_put_received=self._device_put,
            recv_backstop_s=self._timeout_s,
        )

    def _start_member_bridge(self, mesh_provider) -> None:
        from rayfed_tpu_torch.config import ClusterConfig, PartyConfig
        from rayfed_tpu_torch.transport.manager import TransportManager

        me = f"bridge-p{self._group.process_id}"
        cc = ClusterConfig(
            parties={
                me: PartyConfig.from_dict({"address": "0.0.0.0:0"})
            },
            current_party=me,
            serializing_allowed_list=self._allowed,
            # Same TLS posture as the cross-party wire: the bridge
            # crosses the inter-host network too.
            tls_config=self._tls_config,
        )
        self._bridge_mgr = TransportManager(cc, self._bridge_job_config(), device=self.device)
        self._bridge_mgr.mesh_provider = mesh_provider
        self._bridge_mgr.start()
        port = self._bridge_mgr._server.bound_port
        host = _local_host_ip(getattr(self._group, "host", None))
        self._group.publish_bridge_address(f"{host}:{port}")
        self._bridge_ready.set()

    def _start_leader_watchdog(self) -> None:
        """Non-leader: monitor the LEADER's cross-party listener.

        The leader is every non-leader's single source of cross-party
        values; when it dies mid-round the bridge mailbox's parked
        recvs used to wait out the full recv backstop.  The watchdog
        pings the leader's transport (the party's advertised address)
        on the bridge manager's loop and, after ``peer_death_pings``
        consecutive failures, fails every parked bridge waiter —
        leader death now surfaces on the member within the death
        deadline, as a :class:`~rayfed_tpu_torch.exceptions.RemoteError`
        naming the leader.  Like the main health monitor, a leader
        that was never reachable only parks recvs (startup skew), and
        monitoring continues so waiters that park AFTER the death are
        failed on the next cycle too.
        """
        if self._leader_address is None or self._bridge_mgr is None:
            return
        from rayfed_tpu_torch.config import JobConfig, RetryPolicy
        from rayfed_tpu_torch.transport import tls as tls_utils
        from rayfed_tpu_torch.transport.client import TransportClient

        mgr = self._bridge_mgr
        job = self._job if self._job is not None else JobConfig()
        if not job.peer_failfast:
            return
        interval = job.peer_health_interval_s
        threshold = max(1, int(job.peer_death_pings))
        client = TransportClient(
            src_party=mgr._party,
            dest_party="party-leader",
            address=self._leader_address,
            retry_policy=RetryPolicy(max_attempts=1),
            timeout_s=job.cross_silo_timeout_s,
            max_message_size=job.cross_silo_messages_max_size,
            ssl_context=tls_utils.client_ssl_context(self._tls_config),
            loop=mgr._loop,
        )

        async def _watch():
            from rayfed_tpu_torch.exceptions import RemoteError

            fails = 0
            ever_reachable = False
            while True:
                await asyncio.sleep(interval)
                try:
                    ok = await asyncio.wait_for(
                        client.ping(
                            timeout_s=min(1.0, interval), ctl=True
                        ),
                        timeout=interval,
                    )
                except Exception:
                    ok = False
                if ok:
                    ever_reachable = True
                    fails = 0
                    continue
                if not ever_reachable:
                    continue
                fails += 1
                if fails < threshold:
                    continue
                mailbox = mgr._mailbox
                waiting = sorted(mailbox.parties_with_waiters())
                if not waiting:
                    continue
                logger.warning(
                    "party leader at %s unreachable (%d consecutive "
                    "pings); failing %d parked bridge recvs",
                    self._leader_address, fails, len(waiting),
                )
                err = RemoteError(
                    "party-leader",
                    "ConnectionError",
                    f"this party's leader process "
                    f"({self._leader_address}) is unreachable "
                    f"({fails} consecutive pings over "
                    f"~{fails * interval:.0f}s) — the bridge cannot "
                    f"deliver cross-party values; the SPMD program "
                    f"cannot proceed",
                ).to_wire()
                for party in waiting:
                    # poison_new=False: the loop keeps running, so
                    # waiters that park after this cycle are failed on
                    # the next one — and a recovered leader resumes
                    # cleanly with nothing to un-poison.
                    mailbox.fail_party(party, err, poison_new=False)

        def _arm():
            self._watchdog_task = mgr._loop.create_task(_watch())

        mgr._loop.call_soon_threadsafe(_arm)

    def _start_leader_bridge(self) -> None:
        """Install the republish hook, start the wire, and resolve
        non-leader addresses in the background.

        Hook-before-start: a peer's push can land the instant the
        listener accepts, and a frame received with no hook installed
        would never reach the non-leaders (silent SPMD desync at
        startup).  Republishes block until resolution completes.
        """
        from rayfed_tpu_torch.config import RetryPolicy
        from rayfed_tpu_torch.transport import tls as tls_utils
        from rayfed_tpu_torch.transport.client import TransportClient

        inner = self._inner
        inner._server._on_message = self._on_leader_message
        inner.start()

        def _connect():
            # Retry each address forever: a party process that never
            # comes up means the job is stuck regardless, and "skip the
            # missing process" would be a silent desync.  Loud beats
            # degraded.
            for pid in range(1, self._group.num_processes):
                while True:
                    try:
                        addr = self._group.fetch_bridge_address(pid, 60.0)
                        break
                    except Exception as e:
                        logger.warning(
                            "bridge address for p%d not resolved yet (%s); "
                            "retrying", pid, e,
                        )
                self._bridge_clients[pid] = TransportClient(
                    src_party=inner._party,
                    dest_party=f"bridge-p{pid}",
                    address=addr,
                    retry_policy=RetryPolicy(),
                    timeout_s=inner._job.cross_silo_timeout_s,
                    max_message_size=inner._job.cross_silo_messages_max_size,
                    ssl_context=tls_utils.client_ssl_context(self._tls_config),
                )
            self._bridge_ready.set()
            inner._loop.call_soon_threadsafe(self._set_ready_on_loop)

        threading.Thread(
            target=_connect, name="rayfed-bridge-connect", daemon=True
        ).start()

    def _set_ready_on_loop(self) -> None:
        # Runs on the inner loop; creates the event if no republish
        # raced ahead of us.
        if self._bridge_ready_async is None:
            self._bridge_ready_async = asyncio.Event()
        self._bridge_ready_async.set()

    def _on_leader_message(self, message) -> None:
        # Runs on the inner loop thread; must not block.
        # fedlint: disable=FED002 — provably on-loop: installed as the server's _on_message callback, invoked only from its frame dispatch on the loop thread
        asyncio.ensure_future(self._republish(message))

    async def _republish(self, message) -> None:
        loop = asyncio.get_running_loop()
        if not self._bridge_ready.is_set():
            if self._bridge_ready_async is None:
                self._bridge_ready_async = asyncio.Event()
            while True:
                try:
                    await asyncio.wait_for(
                        self._bridge_ready_async.wait(), timeout=60
                    )
                    break
                except asyncio.TimeoutError:
                    logger.error(
                        "bridge clients still unresolved; republish of "
                        "(%s, %s) waiting",
                        message.upstream_seq_id, message.downstream_seq_id,
                    )
        crc = None
        clients = list(self._bridge_clients.items())
        if (
            clients
            and clients[0][1].checksum_enabled
            and message.error is None
        ):
            # One off-loop checksum, reused for every non-leader (the
            # inline per-send path would recompute it N-1 times ON the
            # event loop).
            from rayfed_tpu_torch import native

            crc = await loop.run_in_executor(
                None, native.crc32c, message.payload
            )
        for pid, client in clients:
            try:
                await client.send_data(
                    [message.payload] if message.error is None else [],
                    message.upstream_seq_id,
                    message.downstream_seq_id,
                    crc=crc,
                    error=message.error,
                )
            except Exception as e:
                # A failed republish means the non-leader can never see
                # this value: the SPMD program WILL desync.  Loud path
                # (module docstring contract): escalate to the cleanup
                # watchdog (exit-on-failure semantics) instead of letting
                # the non-leader's recv park until its backstop.
                logger.exception(
                    "bridge republish to p%d failed (up=%s down=%s)",
                    pid, message.upstream_seq_id, message.downstream_seq_id,
                )
                # Poison the key ON the member: when the bridge itself
                # is reachable but this payload can't cross it (e.g. it
                # exceeds the bridge's message cap), the member's recv
                # must RAISE a RemoteError naming the failure instead
                # of hanging until its backstop.  A fully unreachable
                # bridge fails this too — then the member-side leader
                # watchdog is the backstop.
                try:
                    from rayfed_tpu_torch.exceptions import RemoteError

                    await client.send_data(
                        [],
                        message.upstream_seq_id,
                        message.downstream_seq_id,
                        error=RemoteError(
                            "party-leader",
                            "BridgeRepublishError",
                            f"leader failed to republish "
                            f"({message.upstream_seq_id}, "
                            f"{message.downstream_seq_id}) to party "
                            f"process {pid}: {e}",
                        ).to_wire(),
                    )
                except Exception:
                    logger.exception(
                        "bridge republish poison to p%d also failed", pid
                    )
                if self.failure_handler is not None:
                    try:
                        self.failure_handler(LocalRef.from_value(False), e)
                    except Exception:  # pragma: no cover
                        logger.exception("republish failure handler raised")

    # -- proxy interface ------------------------------------------------------

    def send(self, dest_party, data, upstream_seq_id, downstream_seq_id,
             stream=None, round_tag=None, epoch_tag=None,
             quant_meta=None, blob_offer=False):
        # blob_offer is deliberately dropped: a multi-host party never
        # offers fingerprint handles — the RECEIVER may itself be a
        # multi-host group whose non-leader bridge processes cannot
        # pull, so its broadcasts stay eager pushes.
        del blob_offer
        if self._inner is not None:
            return self._inner.send(
                dest_party=dest_party,
                data=data,
                upstream_seq_id=upstream_seq_id,
                downstream_seq_id=downstream_seq_id,
                stream=stream,
                round_tag=round_tag,
                epoch_tag=epoch_tag,
                quant_meta=quant_meta,
            )
        # Non-leader: the leader's identical program does the real push.
        return LocalRef.from_value(True)

    def send_many(self, dest_parties, data, upstream_seq_id,
                  downstream_seq_id, stream=None, round_tag=None,
                  epoch_tag=None, quant_meta=None, blob_offer=False):
        """Fan-out broadcast (one shared encode) — leader only; see
        :meth:`TransportManager.send_many`.  ``blob_offer`` is dropped
        (see :meth:`send`): multi-host parties broadcast eagerly."""
        del blob_offer
        if self._inner is not None:
            return self._inner.send_many(
                dest_parties=dest_parties,
                data=data,
                upstream_seq_id=upstream_seq_id,
                downstream_seq_id=downstream_seq_id,
                stream=stream,
                round_tag=round_tag,
                epoch_tag=epoch_tag,
                quant_meta=quant_meta,
            )
        return {p: LocalRef.from_value(True) for p in dest_parties}

    def recv(self, src_party, upstream_seq_id, downstream_seq_id):
        if self._inner is not None:
            return self._inner.recv(
                src_party=src_party,
                upstream_seq_id=upstream_seq_id,
                downstream_seq_id=downstream_seq_id,
            )
        return self._bridge_mgr.recv(
            src_party=src_party,
            upstream_seq_id=upstream_seq_id,
            downstream_seq_id=downstream_seq_id,
        )

    def recv_stream(self, src_party, upstream_seq_id, downstream_seq_id,
                    sink):
        """Chunk-granular receive — leader only: the cross-party wire
        (and thus the chunk hook) exists on the leader process.  A
        non-leader coordinator process cannot stream-aggregate; use the
        one-shot ``fl.aggregate`` for multi-host parties until the
        bridge republish grows a chunk hook."""
        if self._inner is None:
            raise NotImplementedError(
                "streaming aggregation is not supported on non-leader "
                "processes of a multi-host party — aggregate with "
                "fl.aggregate there instead"
            )
        return self._inner.recv_stream(
            src_party, upstream_seq_id, downstream_seq_id, sink
        )

    def recv_stream_many(self, entries):
        """Batch chunk-sink registration — leader only, like
        :meth:`recv_stream` (same non-leader caveat)."""
        if self._inner is None:
            raise NotImplementedError(
                "streaming aggregation is not supported on non-leader "
                "processes of a multi-host party — aggregate with "
                "fl.aggregate there instead"
            )
        return self._inner.recv_stream_many(entries)

    def cancel_stream(self, upstream_seq_id, downstream_seq_id):
        if self._inner is not None:
            self._inner.cancel_stream(upstream_seq_id, downstream_seq_id)

    def _send_poison(self, dest_party, upstream_seq_id, downstream_seq_id,
                     exc):
        """Poison a promised rendezvous key on the consumer (see
        :meth:`TransportManager._send_poison`).  Leaders delegate to the
        real wire — without this, a multi-host leader's aggregation
        aborts (ring poison cascade, streaming result poison) would
        silently no-op and leave every peer parked until its backstop.
        Non-leaders resolve ``True`` like :meth:`send`: the leader's
        identical program delivers the real poison."""
        if self._inner is not None:
            return self._inner._send_poison(
                dest_party, upstream_seq_id, downstream_seq_id, exc
            )
        return LocalRef.from_value(True)

    def ping(self, dest_party: str, timeout_s: float = 1.0) -> bool:
        if self._inner is not None:
            return self._inner.ping(dest_party, timeout_s)
        return True  # non-leaders have no cross-party wire to check

    @property
    def roster(self):
        """The party's roster-epoch object (elastic membership) — the
        leader's real one; non-leaders get a local stub (quorum rounds
        are leader-driven, like streaming aggregation)."""
        if self._inner is not None:
            return self._inner.roster
        if self._nl_roster is None:
            from rayfed_tpu_torch.transport.manager import RosterState

            self._nl_roster = RosterState([])
        return self._nl_roster

    def drain_membership_requests(self) -> list:
        if self._inner is not None:
            return self._inner.drain_membership_requests()
        return []

    @property
    def secagg_keys(self):
        """Secure-aggregation key agreement (transport/secagg.py) —
        leader-only, like every other cross-party plane: the leader's
        HELLO handshakes carry the party's key.  None on non-leaders;
        the fl.secagg entry points fail loudly on it (masked rounds are
        leader-driven, like streaming aggregation)."""
        if self._inner is not None:
            return self._inner.secagg_keys
        return None

    def ensure_secagg_peer_keys(self, parties, timeout_s: float = 30.0):
        if self._inner is None:
            raise NotImplementedError(
                "secure aggregation is leader-driven: non-leader "
                "processes of a multi-host party have no cross-party "
                "wire to agree keys over"
            )
        return self._inner.ensure_secagg_peer_keys(parties, timeout_s)

    @property
    def objects(self):
        """Content-addressed object plane (transport/objectstore.py) —
        leader-only like every cross-party plane: the leader's manager
        serves and pulls blobs.  None on non-leaders; handle resolution
        on one fails loudly (``objects.maybe_resolve_handle``) instead
        of handing user code a raw handle dict."""
        if self._inner is not None:
            return self._inner.objects
        return None

    @property
    def transfer_log(self):
        """Per-manager transfer records (rayfed_tpu/metrics.py) — the
        leader's wire view.  Non-leaders expose their bridge manager's
        log (its recv re-pushes ARE that process's transfers)."""
        if self._inner is not None:
            return self._inner.transfer_log
        bridge = getattr(self, "_bridge_mgr", None)
        return getattr(bridge, "transfer_log", None)

    def collect_trace(
        self, peer: str, rounds=None, timeout_s=None,
    ) -> tuple:
        """Cross-party trace pull (``fed.trace_collect``) — leader-only
        like every cross-party plane: the leader's manager holds the
        wire clients the TRACE_GET round trip rides.  Non-leaders have
        no cross-party transport and fail loudly (collect on the
        leader; the SERVING side works on every process that runs a
        manager, so multi-host parties can always be collected FROM)."""
        if self._inner is None:
            from rayfed_tpu_torch import telemetry

            raise telemetry.TelemetryError(
                "non-leader process of a multi-host party has no "
                "cross-party wire transport to collect traces over — "
                "run fed.trace_collect on the party leader"
            )
        return self._inner.collect_trace(
            peer, rounds=rounds, timeout_s=timeout_s
        )

    def set_max_message_size(self, max_bytes: int) -> None:
        """Runtime message-size cap mutation, party-wide and atomic.

        A multi-host party must move the cap on EVERY process at once:
        the leader's wire server/clients AND each sibling's bridge
        server — a leader that accepted a newly-allowed large payload
        while one bridge server kept the init-time cap would have its
        republish fatally rejected there, silently desyncing the SPMD
        program.  This is therefore a **collective**: every process of
        the party calls ``fed.set_max_message_length`` at the same
        program point (like any other SPMD collective).

        Protocol: enter-barrier (no process still has a pre-call send
        in flight once all have arrived) → the leader applies to its
        real manager (which itself rejects on in-flight cross-party
        sends) and its bridge republish clients, then publishes an
        ``ok``/``err:...`` verdict on the party's store → non-leaders
        fetch the verdict and apply to their bridge manager only on
        ``ok`` → exit-barrier.  On an ``err`` verdict every process
        raises the same ``RuntimeError``, so a rejected mutation leaves
        the whole party on the old cap — never torn across processes.
        """
        max_bytes = int(max_bytes)
        if max_bytes <= 0:
            raise ValueError(
                f"max message length must be positive, got {max_bytes}"
            )
        if self._group.num_processes <= 1:
            if self._inner is not None:
                self._inner.set_max_message_size(max_bytes)
            return

        seq = next(self._msgcap_seq)
        verdict_key = f"{_BRIDGE_PREFIX}_msgcap/{seq}"
        self._group.barrier(f"rfw_msgcap_enter_{seq}")
        if self._group.is_leader:
            verdict = "ok"
            try:
                self._leader_apply_cap(max_bytes)
            except Exception as e:
                verdict = f"err:{e}"
            self._group.key_value_set(verdict_key, verdict)
        else:
            verdict = self._group.blocking_key_value_get(verdict_key, 120.0)
            if verdict == "ok" and self._bridge_mgr is not None:
                # Bridge managers never originate sends, so the inner
                # inflight guard is vacuous here — this is a plain
                # server/job-config cap update on the bridge listener.
                self._bridge_mgr.set_max_message_size(max_bytes)
        self._group.barrier(f"rfw_msgcap_exit_{seq}")
        if verdict != "ok":
            raise RuntimeError(
                f"set_max_message_length rejected for multi-host party "
                f"(no process applied it): {verdict[4:]}"
            )

    def _leader_apply_cap(self, max_bytes: int) -> None:
        """Leader side of the cap collective: real manager + bridge
        republish clients.  The bridge inflight check runs FIRST so a
        busy bridge rejects before the inner manager mutates — inside
        the enter-barrier no process is issuing new sends, so the
        check-then-apply window cannot readmit traffic."""

        async def _check_bridge():
            busy = sorted(
                pid
                for pid, c in self._bridge_clients.items()
                if c.has_inflight_sends()
            )
            if busy:
                raise RuntimeError(
                    f"cannot change max message length while bridge "
                    f"republishes are in flight to party processes "
                    f"{busy}; retry after the round completes"
                )

        async def _apply_bridge():
            for c in self._bridge_clients.values():
                c._max_message_size = max_bytes

        loop = self._inner._loop
        if self._bridge_clients:
            asyncio.run_coroutine_threadsafe(
                _check_bridge(), loop
            ).result(timeout=30)
        self._inner.set_max_message_size(max_bytes)
        if self._bridge_clients:
            asyncio.run_coroutine_threadsafe(
                _apply_bridge(), loop
            ).result(timeout=30)

    def effective_transport_options(self, dest_party: str) -> Dict[str, Any]:
        if self._inner is not None:
            return self._inner.effective_transport_options(dest_party)
        return {
            "party": dest_party,
            "options": {},
            "ignored_keys": [],
            "metadata": {},
            "note": "non-leader process: no cross-party wire",
        }

    def get_stats(self) -> Dict[str, Any]:
        mgr = self._inner if self._inner is not None else self._bridge_mgr
        stats = mgr.get_stats() if mgr is not None else {}
        stats["party_process_id"] = self._group.process_id
        stats["party_num_processes"] = self._group.num_processes
        return stats

    def stop(self) -> None:
        if self._inner is not None:
            self._inner.stop()  # also cancels bridge-client tasks (same loop)
        if self._bridge_mgr is not None:
            self._bridge_mgr.stop()
        self._group.cleanup()
        self._group.shutdown()
