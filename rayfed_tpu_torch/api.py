"""Public API: ``init`` / ``shutdown`` / ``remote`` / ``get`` / ``kill``.

Capability parity with reference ``fed/api.py``, redesigned for a
single-controller-per-party runtime: ``init`` stands up the party's
Runtime (executor + transport proxies + cleanup watchdog) instead of a Ray
cluster; config lives on the Runtime rather than a GCS KV; ``@remote``
tasks run torch callables on the party's CUDA card.

The JAX package's mesh and multi-host options are ``init``'s too: a party
mesh (``mesh``/``mesh_shape``, a ``DeviceMesh`` of
:mod:`rayfed_tpu_torch.parallel`) spans the party's processes, which
``coordinator_address``/``num_party_processes``/``party_process_id`` join
(:mod:`rayfed_tpu_torch.distributed`).  Elastic membership
(``join``/``leave``) rides the quorum rounds of
:mod:`rayfed_tpu_torch.fl.quorum`.
"""

from __future__ import annotations

import functools
import inspect
import logging
import time
from typing import Any, Dict, List, Optional, Union

from rayfed_tpu_torch import utils as fed_utils
from rayfed_tpu_torch.actor import FedActorHandle
from rayfed_tpu_torch.call_holder import FedCallHolder
from rayfed_tpu_torch.cleanup import CleanupManager
from rayfed_tpu_torch.config import (
    DEFAULT_MAX_MESSAGE_SIZE,
    ClusterConfig,
    JobConfig,
    PartyConfig,
    RetryPolicy,
)
from rayfed_tpu_torch.executor import LocalRef, is_local_refs
from rayfed_tpu_torch.fed_object import FedObject
from rayfed_tpu_torch.runtime import (
    Runtime,
    get_runtime,
    get_runtime_or_none,
    set_current_runtime,
)
from rayfed_tpu_torch.transport.manager import TransportManager
from rayfed_tpu_torch.utils.logging_utils import set_thread_party, setup_logger
from rayfed_tpu_torch.utils.platform import resolve_device

logger = logging.getLogger(__name__)


def init(
    address: Optional[str] = None,
    cluster: Optional[Dict] = None,
    party: Optional[str] = None,
    tls_config: Optional[Dict] = None,
    logging_level: str = "info",
    cross_silo_retry_policy: Optional[Dict] = None,
    cross_silo_grpc_retry_policy: Optional[Dict] = None,  # reference-compat alias
    cross_silo_send_max_retries: Optional[int] = None,
    cross_silo_serializing_allowed_list: Optional[Dict] = None,
    exit_on_failure_cross_silo_sending: bool = False,
    cross_silo_messages_max_size_in_bytes: Optional[int] = None,
    cross_silo_timeout_in_seconds: float = 60,
    recv_backstop_in_seconds: Optional[float] = None,
    mailbox_ttl_in_seconds: Optional[float] = None,
    peer_failfast: bool = True,
    peer_health_interval_in_seconds: Optional[float] = None,
    peer_death_pings: Optional[int] = None,
    enable_waiting_for_other_parties_ready: bool = False,
    global_metadata: Optional[Dict] = None,
    grpc_metadata: Optional[Dict] = None,  # reference-compat alias
    mesh: Optional[Any] = None,
    mesh_shape: Optional[Dict[str, int]] = None,
    max_workers: int = 16,
    device_put_received: bool = True,
    process_default: bool = True,
    coordinator_address: Optional[str] = None,
    num_party_processes: Optional[int] = None,
    party_process_id: Optional[int] = None,
    trace: Optional[bool] = None,
    trace_capacity: Optional[int] = None,
    device: Optional[Any] = None,
    **kwargs,
) -> Runtime:
    """Initialize this party's controller.

    Reference-parity arguments follow ``fed/api.py:38-228``; the cluster
    dict has the same shape (``address``, optional ``listen_addr``,
    per-party ``metadata``/``grpc_metadata`` and
    ``transport_options``/``grpc_options``).  ``address`` exists for
    drop-in compat and accepts 'local'/None — there is no external cluster
    to join: the controller process *is* the party runtime.

    Arguments of this package:

    - ``device``: the party's ``torch.device`` (or its name).  ``None``
      picks the current CUDA card and raises where there is none; pass
      ``"cpu"`` to run the party on the CPU.  Received tensors are
      decoded onto it;
    - ``mesh`` / ``mesh_shape``: the party's ``DeviceMesh``
      (``runtime.mesh``; received tensors whose sender sharding fits it
      decode onto it as DTensors), or its shape, laid over the party's
      world of processes, one card a process: the shape's size must be
      the number of party processes (1 for a one-process party, whose
      one-rank world is started here if there is none);
    - ``device_put_received``: place received tensor payloads onto
      ``device`` eagerly;
    - ``peer_failfast`` (+ ``peer_health_interval_in_seconds``,
      ``peer_death_pings``): while recvs are parked on a party, ping its
      transport; after N consecutive failures the parked ``fed.get``
      raises :class:`~rayfed_tpu_torch.exceptions.RemoteError` naming the dead
      party instead of waiting out the recv backstop;
    - ``process_default``: also register this runtime as the process-wide
      default (disable when simulating multiple parties in one process);
    - ``coordinator_address`` + ``num_party_processes`` +
      ``party_process_id``: a party spanning several processes
      (:mod:`rayfed_tpu_torch.distributed`): every process runs the same
      program; process 0 (the leader) runs the cross-party transport and
      the others receive through its bridge.  ``coordinator_address`` is
      the party's ``host:port`` for its store (process 0 listens there);
      process ``p`` runs on ``cuda:(p % device_count)`` unless ``device``
      says otherwise.
    """
    assert cluster, "Cluster should be provided."
    assert party, "Party should be provided."
    assert party in cluster, f"Party {party} is not in cluster {cluster}."
    if coordinator_address is None:
        device = resolve_device(device)
    elif num_party_processes is None or party_process_id is None:
        raise ValueError(
            "coordinator_address requires num_party_processes and "
            "party_process_id"
        )

    # Deterministic fault injection (tests/benches): a JSON schedule in
    # $RAYFED_CHAOS arms the transport/driver chaos hooks for this
    # process.  A no-op unless the variable is set.
    from rayfed_tpu_torch import chaos as _chaos

    _chaos.maybe_install_from_env()

    # Flight recorder (rayfed_tpu_torch/telemetry.py): RAYFED_TRACE=1 arms the
    # span ring like RAYFED_CHAOS arms faults; an env-armed (or
    # pre-armed) recorder without a party adopts this one.  The
    # JobConfig knob arms it below, once job_config exists.
    from rayfed_tpu_torch import telemetry as _telemetry

    _telemetry.maybe_install_from_env(party=party)

    fed_utils.validate_address(address)
    fed_utils.validate_cluster_info(cluster)

    tls_config = tls_config or None
    if tls_config:
        from rayfed_tpu_torch.transport.tls import validate_tls_config

        validate_tls_config(tls_config)

    retry_dict = cross_silo_retry_policy or cross_silo_grpc_retry_policy
    retry_policy = RetryPolicy.from_dict(retry_dict)
    if cross_silo_send_max_retries is not None:
        retry_policy.max_attempts = int(cross_silo_send_max_retries)

    cluster_config = ClusterConfig(
        parties={p: PartyConfig.from_dict(cfg) for p, cfg in cluster.items()},
        current_party=party,
        tls_config=tls_config,
        serializing_allowed_list=cross_silo_serializing_allowed_list,
    )
    job_config = JobConfig(
        cross_silo_timeout_s=float(cross_silo_timeout_in_seconds),
        cross_silo_messages_max_size=(
            int(cross_silo_messages_max_size_in_bytes)
            if cross_silo_messages_max_size_in_bytes is not None
            else DEFAULT_MAX_MESSAGE_SIZE
        ),
        retry_policy=retry_policy,
        metadata=dict(global_metadata or grpc_metadata or {}),
        exit_on_failure_sending=exit_on_failure_cross_silo_sending,
        wait_for_ready=enable_waiting_for_other_parties_ready,
        device_put_received=device_put_received,
    )
    if recv_backstop_in_seconds is not None:
        job_config.recv_backstop_s = float(recv_backstop_in_seconds)
    if mailbox_ttl_in_seconds is not None:
        job_config.mailbox_ttl_s = float(mailbox_ttl_in_seconds)
    job_config.peer_failfast = bool(peer_failfast)
    if peer_health_interval_in_seconds is not None:
        job_config.peer_health_interval_s = float(peer_health_interval_in_seconds)
    if peer_death_pings is not None:
        job_config.peer_death_pings = int(peer_death_pings)
    if trace is not None:
        job_config.trace = bool(trace)
    if trace_capacity is not None:
        job_config.trace_capacity = int(trace_capacity)
    if job_config.trace and _telemetry.installed() is None:
        _telemetry.install(party=party, capacity=job_config.trace_capacity)
    elif trace_capacity is not None and _telemetry.installed() is not None:
        # An env-armed (or test-installed) recorder already exists; an
        # EXPLICIT capacity request must still take effect — resize in
        # place (newest records kept) instead of silently ignoring it.
        _telemetry.installed().resize(int(trace_capacity))

    party_group = None
    if coordinator_address is not None:
        from rayfed_tpu_torch.distributed import PartyProcessGroup

        # Before any CUDA work in this process: it takes its own card and
        # joins the party's world, which the party mesh spans.
        party_group = PartyProcessGroup(
            coordinator_address, num_party_processes, party_process_id, device=device
        )
        device = party_group.device

    owned_world = False
    if mesh is None and mesh_shape is not None:
        import torch.distributed as dist

        from rayfed_tpu_torch.parallel.mesh import create_mesh

        if party_group is None and not dist.is_initialized():
            # A one-process party's world: one rank, no port.
            dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
            owned_world = True
        try:
            mesh = create_mesh(mesh_shape, device=device.type)
        except BaseException:
            if owned_world:
                dist.destroy_process_group()
            if party_group is not None:
                party_group.shutdown()
            raise

    runtime = Runtime(
        cluster_config=cluster_config,
        job_config=job_config,
        max_workers=max_workers,
        mesh=mesh,
    )
    runtime.owned_world = owned_world
    set_current_runtime(runtime, process_default=process_default)
    set_thread_party(party)

    setup_logger(logging_level=logging_level, party=party)

    runtime.cleanup_manager = CleanupManager(
        exit_on_failure_sending=exit_on_failure_cross_silo_sending
    )
    runtime.cleanup_manager.start()

    if party_group is not None:
        from rayfed_tpu_torch.distributed import MultiHostTransport

        inner = None
        if party_group.is_leader:
            inner = TransportManager(cluster_config, job_config, device=device)
            inner.mesh_provider = lambda: runtime.mesh
            # NOT started here: MultiHostTransport must install its
            # republish hook before the listener accepts the first frame.
        transport = MultiHostTransport(
            inner,
            party_group,
            allowed=cluster_config.serializing_allowed_list,
            device_put_received=device_put_received,
            # Same backstop as the leader's wire recv — the party's
            # processes must time out together or not at all (a lone
            # non-leader failure desyncs the SPMD program).
            timeout_s=job_config.recv_backstop_s,
            mesh_provider=lambda: runtime.mesh,
            job_config=job_config,
            tls_config=tls_config,
            # The party's advertised address IS the leader's listener:
            # non-leaders watchdog it so leader death poisons their
            # parked bridge recvs within the death deadline.
            leader_address=cluster_config.party_config(party).address,
            device=device,
        )
        # A fatal bridge republish is a send failure for watchdog
        # purposes: exit-on-failure applies to the intra-party bridge too.
        transport.failure_handler = (
            lambda ref, exc: runtime.cleanup_manager.push_to_sending(ref)
        )
    else:
        transport = TransportManager(cluster_config, job_config, device=device)
        transport.mesh_provider = lambda: runtime.mesh
        transport.start()
    runtime.send_proxy = transport
    runtime.recv_proxy = transport
    runtime.transport = transport

    # Pre-warm the fl package ON THIS THREAD, before any cross-thread
    # traffic exists: the decode paths import fl submodules from worker
    # threads (a packed skeleton names fl.compression), and two FIRST
    # imports racing across threads can observe a partially initialized
    # package.  One eager import here makes every later lookup a
    # sys.modules hit.
    import rayfed_tpu_torch.fl  # noqa: F401

    if enable_waiting_for_other_parties_ready:
        ping_others(cluster=cluster, self_party=party, max_retries=3600)
    logger.info("Started rayfed_tpu_torch runtime for party %s.", party)
    return runtime


def ping_others(cluster: Dict[str, Dict], self_party: str, max_retries: int = 3600):
    """Ping other parties until all are ready (ref ``barriers.py:441-466``)."""
    runtime = get_runtime()
    transport: TransportManager = runtime.transport
    others = [p for p in cluster if p != self_party]
    tried = 0
    while tried < max_retries and others:
        logger.info(
            "Try ping %s at attempt %d, up to %d attempts.", others, tried, max_retries
        )
        tried += 1
        others = [o for o in others if not transport.ping(o, timeout_s=1.0)]
        if others:
            # fedlint: disable=FED001 — sync init-time retry loop on the caller's thread, before any round traffic; the transport event loop runs in its own thread and is never blocked by this wait
            time.sleep(2)
    if others:
        raise RuntimeError(
            f"Failed to wait for parties: {others} to start, abort `fed.init`."
        )
    return True


def set_max_message_length(max_bytes: int) -> None:
    """Mutate the cross-silo message-size cap AFTER ``init`` (parity
    with adjusting the reference's ``grpc.max_send_message_length`` /
    ``max_receive_message_length`` channel options, but live).

    Applies atomically to this party's transport server and every live
    per-peer client, and to clients created later.  Raises
    ``RuntimeError`` while any cross-party send is mid-flight — the cap
    change must reject cleanly rather than torn-apply to a payload
    already on the wire (drain with ``fed.get`` on the pending sends,
    or retry after the round completes).  Each party controls its own
    caps; lower both sides when actually shrinking a limit.

    On a multi-host party this is a **collective**: every process of
    the party must call it at the same program point (like any SPMD
    collective).  The processes rendezvous on a coordination-service
    barrier, the leader applies the cap to the cross-party wire and its
    bridge republish clients and publishes an ok/err verdict, and the
    siblings apply it to their bridge servers only on ok — a rejected
    mutation (e.g. in-flight sends) raises the same ``RuntimeError`` on
    every process and leaves the whole party on the old cap.
    """
    runtime = get_runtime()
    transport = getattr(runtime, "transport", None)
    if transport is None:
        raise RuntimeError("transport not started; call fed.init() first")
    # The manager also updates runtime.job_config (the same object), so
    # future clients inherit the new cap — one writer, no duplicate here.
    transport.set_max_message_size(int(max_bytes))


def trace_collect(
    rounds: Optional[Any] = None,
    parties: Optional[List[str]] = None,
    timeout: Optional[float] = None,
) -> Dict[str, Any]:
    """Pull every peer's flight-recorder ring window and merge with the
    local one into ONE cross-party timeline (``rayfed_tpu_torch.telemetry``).

    ``rounds``: None (whole rings), an int, or an inclusive ``(lo, hi)``
    range of round tags; records carrying no round tag (mailbox waits,
    chaos wire faults) are always included.  ``parties``: restrict the
    peer set (default: every other cluster party).  Peers whose pull
    fails (dead, unreachable, pre-telemetry build) or whose recorder is
    disarmed land in ``missing`` with the reason — a partial timeline
    is returned, never an exception for a single dead peer; ``parties``
    and ``missing`` are disjoint.  Peers are pulled concurrently, so the
    collection wall is ~one ``timeout`` even with several peers down.

    Peer clocks are aligned onto THIS party's timeline with the
    NTP-style offset estimated from each collection round trip (error
    bound RTT/2, reported per peer in ``clock_offsets`` —
    :func:`rayfed_tpu_torch.telemetry.estimate_clock_offset`).

    Returns ``{"collector", "records", "clock_offsets", "parties",
    "missing"}`` where ``records`` is the merged, time-sorted list of
    record dicts — feed it to
    :func:`rayfed_tpu_torch.telemetry.to_trace_events` for a Chrome/Perfetto
    ``trace_event`` JSON export, or to ``tool/trace_report.py`` for a
    critical-path round report.  Works with the recorder disarmed
    locally (you still get the peers' windows); multi-host non-leader
    processes have no wire transport and raise loudly.
    """
    from rayfed_tpu_torch import telemetry

    runtime = get_runtime()
    transport = runtime.transport
    me = runtime.party
    if not hasattr(transport, "collect_trace"):
        raise telemetry.TelemetryError(
            "this process has no cross-party wire transport to collect "
            "traces over (multi-host non-leader bridges cannot pull — "
            "run fed.trace_collect on the party leader)"
        )
    rec = telemetry.installed()
    local = rec.records(rounds=rounds) if rec is not None else []
    local = [r for r in local if r.party is None or r.party == me]
    peers = [
        p for p in (
            parties if parties is not None
            else list(runtime.cluster_config.parties)
        )
        if p != me
    ]
    party_records: Dict[str, list] = {me: local}
    offsets: Dict[str, Dict[str, float]] = {
        me: {"offset_s": 0.0, "rtt_s": 0.0, "bound_s": 0.0}
    }
    missing: Dict[str, str] = {}
    # Pull peers CONCURRENTLY: each pull is an independent request/
    # reply round trip, and a dead/unreachable peer costs its full
    # per-peer timeout — serialized, N dead peers would stack N
    # timeouts into the collection wall (exactly the post-chaos
    # situation this API exists to diagnose).  Concurrent, the wall is
    # ~one timeout regardless of how many peers are down.
    from concurrent.futures import ThreadPoolExecutor

    def _pull(p: str):
        return transport.collect_trace(p, rounds=rounds, timeout_s=timeout)

    if peers:
        with ThreadPoolExecutor(
            max_workers=min(len(peers), 8),
            thread_name_prefix="rayfed-trace-collect",
        ) as pool:
            futures = {p: pool.submit(_pull, p) for p in peers}
            for p in peers:
                try:
                    records, offset, rep = futures[p].result()
                except Exception as exc:
                    logger.warning(
                        "[%s] trace collection from %s failed: %r",
                        me, p, exc,
                    )
                    missing[p] = repr(exc)
                    continue
                if not rep["armed"] and not records:
                    # "parties" and "missing" are disjoint by contract:
                    # a disarmed peer contributed nothing, so it belongs
                    # in missing ONLY (consumers count parties as
                    # collected).
                    missing[p] = "recorder not armed"
                    continue
                party_records[p] = records
                offsets[p] = offset
    merged = telemetry.merge_records(party_records, offsets)
    return {
        "collector": me,
        "records": merged,
        "clock_offsets": offsets,
        "parties": sorted(party_records),
        "missing": missing,
    }


def metrics_snapshot() -> Dict[str, Any]:
    """Every subsystem's counters under one documented schema
    (``rayfed_tpu_torch.metrics.METRICS_SCHEMA``): ``transport``, ``secagg``,
    ``object_plane``, ``telemetry``, ``quorum``.  See
    :func:`rayfed_tpu_torch.metrics.metrics_snapshot`."""
    from rayfed_tpu_torch.metrics import metrics_snapshot as _snapshot

    return _snapshot()


def join(coordinator: Optional[str] = None,
         timeout: Optional[float] = None) -> dict:
    """(Re)join an in-progress quorum run — elastic membership's entry door.
    Sends a join request to the run's coordinator and parks until its next
    round boundary returns the **welcome ticket** (round index, session,
    roster epoch — applied to this runtime before returning — the current
    coordinator and the current global model).  Pass the ticket to
    ``fl.run_fedavg_rounds(..., quorum=k, join_ticket=ticket)`` to enter the
    loop; no other party restarts anything.  ``coordinator`` must name the
    run's current coordinator.  See :mod:`rayfed_tpu_torch.fl.quorum`."""
    from rayfed_tpu_torch.fl.quorum import join_cluster

    return join_cluster(coordinator=coordinator, timeout=timeout)


def leave() -> None:
    """Gracefully leave an in-progress quorum run at the next round
    boundary: the coordinator announces the departure (roster epoch
    advance) and this party's ``run_fedavg_rounds`` returns the last
    broadcast model once the roster drops it.  A leaving coordinator
    completes its round and hands the lease to the announced successor.
    See :mod:`rayfed_tpu_torch.fl.quorum`."""
    from rayfed_tpu_torch.fl.quorum import request_leave

    request_leave()


def shutdown() -> None:
    """Shutdown this party's runtime (ref ``api.py:231-241``)."""
    runtime = get_runtime_or_none()
    if runtime is None:
        return
    if runtime.cleanup_manager is not None:
        runtime.cleanup_manager.wait_sending()
    if getattr(runtime, "transport", None) is not None:
        runtime.transport.stop()
    runtime.shutdown_actors()
    runtime.executor.shutdown(wait=False)
    if runtime.owned_world:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    set_current_runtime(None)
    set_thread_party(None)
    logger.info("Shutdowned rayfed_tpu_torch.")


def _get_cluster():
    return get_runtime().cluster_config.cluster_addresses


def _get_party():
    return get_runtime().party


def _get_tls():
    return get_runtime().cluster_config.tls_config


class FedRemoteFunction:
    def __init__(self, func_or_class) -> None:
        self._node_party: Optional[str] = None
        self._func_body = func_or_class
        self._options: dict = {}
        self._fed_call_holder: Optional[FedCallHolder] = None

    def party(self, party: str) -> "FedRemoteFunction":
        self._node_party = party
        self._fed_call_holder = FedCallHolder(
            get_runtime(), self._node_party, self._execute_impl, self._options
        )
        return self

    def options(self, **options) -> "FedRemoteFunction":
        self._options = options
        if self._fed_call_holder:
            self._fed_call_holder.options(**options)
        return self

    def remote(self, *args, **kwargs):
        assert (
            self._node_party is not None
        ), "A fed function should be specified within a party to execute."
        return self._fed_call_holder.internal_remote(*args, **kwargs)

    def _execute_impl(self, args: tuple, kwargs: dict):
        runtime = get_runtime()
        num_returns = int(self._options.get("num_returns", 1))
        return runtime.executor.submit(
            self._func_body, args, kwargs, num_returns=num_returns
        )


class FedRemoteClass:
    def __init__(self, func_or_class) -> None:
        self._party: Optional[str] = None
        self._cls = func_or_class
        self._options: dict = {}

    def party(self, party: str) -> "FedRemoteClass":
        self._party = party
        return self

    def options(self, **options) -> "FedRemoteClass":
        self._options = options
        return self

    def remote(self, *cls_args, **cls_kwargs) -> FedActorHandle:
        runtime = get_runtime()
        fed_class_task_id = runtime.next_seq_id()
        fed_actor_handle = FedActorHandle(
            runtime,
            fed_class_task_id,
            self._cls,
            self._party,
            self._options,
        )
        fed_call_holder = FedCallHolder(
            runtime, self._party, fed_actor_handle._execute_impl, self._options
        )
        fed_call_holder.internal_remote(*cls_args, **cls_kwargs)
        return fed_actor_handle


def _is_cython_callable(obj) -> bool:
    """Cython-compiled functions (reference ``utils.py:131-144`` accepts
    them): not caught by ``inspect.isfunction``; identified by the type
    name ``cython_function_or_method`` on the object itself or — for
    Cython 3 bound methods, which expose ``__func__`` rather than
    ``func_name`` — on its underlying function."""

    def _is_cython_type(o) -> bool:
        return type(o).__name__ == "cython_function_or_method"

    return _is_cython_type(obj) or (
        hasattr(obj, "__func__") and _is_cython_type(obj.__func__)
    )


def remote(*args, **kwargs):
    """``@fed.remote`` decorator for functions and classes (ref ``api.py:332-350``)."""

    def _make_fed_remote(function_or_class, **options):
        if (
            inspect.isfunction(function_or_class)
            or inspect.isbuiltin(function_or_class)
            or _is_cython_callable(function_or_class)
        ):
            return FedRemoteFunction(function_or_class).options(**options)
        if inspect.isclass(function_or_class):
            return FedRemoteClass(function_or_class).options(**options)
        raise TypeError(
            "The @fed.remote decorator must be applied to either a function or a class."
        )

    if len(args) == 1 and len(kwargs) == 0 and callable(args[0]):
        return _make_fed_remote(args[0])
    assert len(args) == 0 and len(kwargs) > 0, "Remote args error."
    return functools.partial(_make_fed_remote, **kwargs)


def get(
    fed_objects: Union[LocalRef, FedObject, List[FedObject]],
    timeout: Optional[float] = None,
) -> Any:
    """Fetch real data of fed objects (ref ``api.py:353-421``).

    Owned objects are broadcast (pushed) to every other party not already
    holding them; unowned objects park on a recv keyed by the shared fake
    seq id allocated identically on all parties.
    """
    if is_local_refs(fed_objects):
        if isinstance(fed_objects, list):
            return [r.resolve(timeout=timeout) for r in fed_objects]
        return fed_objects.resolve(timeout=timeout)

    runtime = get_runtime()
    from rayfed_tpu_torch.proxy import recv_on_runtime, send_many_on_runtime

    # Fake fed_task_id allocated on EVERY party to keep counters aligned
    # (ref api.py:368) — the determinism contract.
    fake_fed_task_id = runtime.next_seq_id()
    cluster_parties = list(runtime.cluster_config.parties)
    current_party = runtime.party
    is_individual_id = isinstance(fed_objects, FedObject)
    if is_individual_id:
        fed_objects = [fed_objects]

    refs: List[LocalRef] = []
    for fed_object in fed_objects:
        if isinstance(fed_object, LocalRef):
            refs.append(fed_object)
            continue
        if fed_object.get_party() == current_party:
            local_ref = fed_object.get_local_ref()
            assert local_ref is not None
            refs.append(local_ref)
            # Exactly-once broadcast dedup (ref api.py:389-394), then one
            # fan-out push: the payload is encoded/checksummed once and
            # streamed to every pending peer concurrently.
            pending = [
                party_name
                for party_name in cluster_parties
                if party_name != current_party
                and fed_object._mark_if_not_sending_to_party(party_name)
            ]
            if pending:
                send_many_on_runtime(
                    runtime,
                    dest_parties=pending,
                    data=local_ref,
                    upstream_seq_id=fed_object.get_fed_task_id(),
                    downstream_seq_id=fake_fed_task_id,
                    # Large immutable objects (plain PackedTrees at or
                    # above JobConfig.blob_broadcast_min_bytes) ship as
                    # fingerprint handles: receivers with a content-
                    # cache hit transfer ZERO payload bytes, misses
                    # pull from this owner (transport/objectstore.py).
                    blob_offer=True,
                )
        else:
            cached = fed_object.get_local_ref()
            if cached is not None:
                refs.append(cached)
            else:
                from rayfed_tpu_torch.objects import maybe_resolve_handle

                plane = getattr(runtime.transport, "objects", None)
                received = recv_on_runtime(
                    runtime,
                    src_party=fed_object.get_party(),
                    upstream_seq_id=fed_object.get_fed_task_id(),
                    curr_seq_id=fake_fed_task_id,
                ).then(
                    # A broadcast that arrived as a fingerprint handle
                    # resolves through the object plane (cache hit =
                    # zero-copy, miss = BLOB_GET pull); ordinary
                    # payloads pass through untouched.  A cold pull
                    # BLOCKS for a holder round trip, so it runs on the
                    # plane's dedicated fetch pool — never the shared
                    # codec pool, which must stay free to decode and to
                    # SERVE the symmetric pulls of other parties.
                    lambda v: maybe_resolve_handle(runtime.transport, v),
                    executor=(
                        plane.fetch_executor if plane is not None else None
                    ),
                )
                fed_object._cache_local_ref(received)
                refs.append(received)

    values = [r.resolve(timeout=timeout) for r in refs]
    if is_individual_id:
        values = values[0]
    return values


def kill(actor: FedActorHandle, *, no_restart: bool = True) -> None:
    """Kill a fed actor — only effective in its owning party (ref ``api.py:424-428``)."""
    del no_restart  # no restart semantics in the in-process substrate
    runtime = get_runtime()
    if actor._node_party == runtime.party:
        actor._kill()
