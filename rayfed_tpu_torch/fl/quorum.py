"""Quorum (k-of-n) federated rounds and elastic party membership.

Every other aggregation path assumes a fixed roster where every party
answers every round: one slow or dead silo stalls or aborts the round for
everyone.  This module makes the round survive partial failure:

- **Quorum rounds** (``run_fedavg_rounds(quorum=k, round_deadline_s=d)``):
  the coordinator aggregates the first *k* of *n* contributions; once the
  deadline passes (or the stragglers provably cannot arrive) it stops
  waiting and reweights by the arrived Σw
  (:class:`~rayfed_tpu_torch.fl.streaming.StreamingAggregator`'s cutoff and
  subset refold, on the coordinator's card).  The aggregate over the member
  subset *M* equals the fold over *M* in sorted-party order, byte for byte.
- **Late fold, not drop**: a straggler whose contribution missed the cutoff
  still receives the round's broadcast; its local progress folds into its
  next starting point with :func:`~rayfed_tpu_torch.fl.overlap.dga_correct`
  (``input_{r+1} = agg_r + (u_r − input_r)``).
- **Elastic membership**: the live roster is an epoch-numbered object on
  the transport (:class:`~rayfed_tpu_torch.transport.manager.RosterState`).
  ``fed.join()`` / ``fed.leave()`` / monitor-declared death advance the
  epoch at a round boundary, announced by the coordinator in the round
  broadcast so every controller applies the same transition.  Quorum
  frames carry their sender's epoch (``wire.EPOCH_TAG_KEY``) and stale ones
  are rejected loudly.
- **Ring rounds honor the quorum**: ``mode="ring"`` runs the chunk-striped
  ring; a straggler or death aborts it and the same round re-aggregates
  over the coordinator topology with the quorum cutoff.
- **Coordinator failover**: when a controller's health monitor declares the
  coordinator dead mid-round, it derives the successor — the next alive
  party on the sorted roster ring
  (:func:`~rayfed_tpu_torch.transport.manager.roster_successor`) — and
  re-establishes the same round there under fresh rendezvous keys.  A
  coordinator ``fed.leave()`` completes its round and its announcement
  names the successor (a graceful handover).

Every rendezvous key of a quorum round derives from ``(session, stream,
round index)``, so a party that rejoins needs only the round index and the
session from its welcome to re-align.

``mode="ring"`` and ``mode="hierarchy"`` run their topology first and fall
back to the coordinator's quorum cutoff for a round it aborts.

``server_opt=`` (a packed :mod:`rayfed_tpu_torch.fl.server_opt` optimizer):
the coordinator, the hierarchy's root or, on the ring, every controller
steps the round's mean; every controller resyncs its state replica from the
broadcast, and a welcome carries the optimizer's stamp and a content handle
to the state, so a joiner enters on the run's trajectory.

``secure_agg=`` (:mod:`rayfed_tpu_torch.fl.secagg`): contributions ship as
``w·q`` plus pairwise and self masks, the coordinator folds at unit weight,
and after the cutoff it announces the member set; every member replies with
its self-mask seed and its seeds toward the dropped parties, and the
orphaned masks are subtracted before the finalize rescale.

``checkpointer=`` (:class:`rayfed_tpu_torch.checkpoint.FedCheckpointer`):
each party snapshots the params and server-opt state with the run's
session, roster epoch and members, coordinator and member log; a fully
restarted cluster resumes from the latest snapshot (a joiner enters by its
welcome instead).
"""

from __future__ import annotations

import logging
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from rayfed_tpu_torch import chaos, telemetry

logger = logging.getLogger(__name__)

# Per-process counters of the coordinator-lease transitions this controller
# observed: ``coordinator_failovers`` — crash-driven successions it
# re-established a round through; ``graceful_handovers`` — announced
# coordinator ``fed.leave()`` handovers applied.
QUORUM_STATS = {"coordinator_failovers": 0, "graceful_handovers": 0}


class QuorumRoundError(RuntimeError):
    """A quorum round failed on this controller (quorum unreachable,
    coordinator death with no live successor, broadcast lost)."""


class QuorumRoundOutcome:
    """One quorum round's result on this controller."""

    __slots__ = ("result", "members", "announce", "welcomes")

    def __init__(self, result: Any, members: List[str],
                 announce: Optional[Dict[str, Any]],
                 welcomes: List[Tuple[str, str]]):
        self.result = result  # aggregated PackedTree
        self.members = members  # parties whose contributions made the cut
        self.announce = announce  # {"epoch", "members"} roster advance or None
        self.welcomes = welcomes  # coordinator only: [(party, nonce)] joiners


def _round_key(session: str, stream: str, r: int) -> str:
    return f"q.{session}.{stream}.{r}"


def _poison_round_key(runtime, parties, up, down, exc) -> None:
    """Best-effort poison of one promised rendezvous key on every listed
    party: peers parked on it raise the coordinator's error now."""
    poison = getattr(runtime.transport, "_send_poison", None)
    if poison is None:
        return
    for p in parties:
        try:
            poison(p, up, down, exc)
        except Exception:  # pragma: no cover - best effort
            logger.exception("failed to poison quorum key for %s", p)


def quorum_aggregate(
    runtime,
    updates: Dict[str, Any],
    weights: Optional[Dict[str, float]],
    *,
    session: str,
    round_index: int,
    quorum: int,
    deadline_s: Optional[float],
    coordinator: str,
    stream: str,
    epoch: int,
    announce_fn: Optional[Callable[[List[str]], tuple]] = None,
    backstop: Optional[float] = None,
    timings: Optional[Dict[str, float]] = None,
    quant: Optional[Any] = None,
    quant_ref: Optional[Any] = None,
    quant_scope: Optional[str] = None,
    secagg: Optional[Any] = None,
    server_step: Optional[Any] = None,
) -> QuorumRoundOutcome:
    """One k-of-n streaming round over the coordinator topology.

    ``updates``: ``{party: FedObject}`` for the round's active roster
    (sorted-party order is the fold order).  Every active controller calls
    this at the same program point; the coordinator decides the member set
    (quorum cutoff, on its card) and broadcasts ``{"d": aggregate, "m":
    members, "a": roster announcement}``.  ``announce_fn(members) ->
    (announce | None, welcomes)`` runs on the coordinator after the cutoff
    (drains join/leave requests, drops dead parties, advances the roster).

    ``quant``: the round's shared grid — contributions are quantized before
    the push, the coordinator folds codes in i32 (its cutoff refold equals
    ``packed_quantized_sum`` over the subset) and the broadcast is
    re-quantized on a fresh payload-carried grid
    (:func:`~rayfed_tpu_torch.fl.quantize.quantize_downlink`).
    ``quant_scope`` keys the residual, committed only when the round's
    broadcast lands.  ``server_step`` (:mod:`rayfed_tpu_torch.fl.server_opt`):
    applied by the coordinator after the cutoff and before the broadcast,
    to the arrived subset's mean, so every controller receives the
    post-step model; mutually exclusive with ``secagg``.

    ``secagg``: the transport's key-agreement plane
    (:class:`~rayfed_tpu_torch.transport.secagg.KeyAgreement`); requires
    ``quant``.  The round runs masked: contributions ship as ``w·q`` plus
    pairwise masks and a private self-mask (Bonawitz double masking) in
    i32, the coordinator folds them at unit weight, and after the cutoff it
    announces the pinned members (``<round>.sa.c``); each member replies
    with its self-mask seed and its seeds toward the dropped parties
    (``<round>.sa.r.<party>``), and the orphaned masks are subtracted before
    the rescale.  A coordinator crash in that window reaches the round loop's
    failover arm like any coordinator death; the successor's stream scope
    re-keys every mask.
    """
    from rayfed_tpu_torch.fl import quantize as qz
    from rayfed_tpu_torch.proxy import recv_on_runtime

    me = runtime.party
    parties = sorted(updates)
    down = _round_key(session, stream, round_index)
    backstop = backstop if backstop is not None else runtime.job_config.recv_backstop_s
    t0 = time.perf_counter()
    masker = None
    if secagg is not None:
        if server_step is not None:
            raise QuorumRoundError(
                "server_step does not compose with masked (secure_agg) "
                "rounds yet — loud exclusion, see fl.server_opt"
            )
        if quant is None:
            raise QuorumRoundError(
                "secure aggregation requires the quantized domain "
                "(quant=) — masks live on the shared integer grid"
            )
        from rayfed_tpu_torch.fl import secagg as sa
        from rayfed_tpu_torch.fl.fedavg import quant_weights

        iw, _ = quant_weights(None if weights is None else [float(weights[p]) for p in parties], len(parties))
        masker = sa.RoundMasker(
            secagg, me, [p for p in parties if p != me],
            session=session, stream=stream, round_index=round_index,
            weight=iw[parties.index(me)],
            # Double masking: a quorum round can exclude a live straggler,
            # and recovering its pairwise masks would otherwise unmask its
            # late payload; the private self-mask keeps it noise.
            self_mask=True,
        )
        codec = sa.MaskedRoundCodec(quant, quant_ref, quant_scope, masker)
    else:
        codec = qz.RoundCodec(quant, quant_ref, quant_scope)
    qref = codec.ref

    # Quorum control-plane sends go directly through the transport, not
    # proxy.send_on_runtime: that registers every ref with the cleanup
    # send-watchdog, and a protocol-tolerated failure (an epoch-rejected
    # late push, a broadcast to a just-crashed party) must not end a
    # healthy process.
    if me != coordinator:
        local_ref = updates[me].get_local_ref()
        if quant is not None:
            local_ref = local_ref.then(codec.to_wire)
        runtime.send_proxy.send(
            coordinator, local_ref, f"{down}.up.{me}", down,
            # Masked codes are fresh noise every round: plain sends.
            stream=None if masker is not None else f"{stream}/up/{me}",
            round_tag=round_index, epoch_tag=epoch, quant_meta=codec.descriptor,
        )
        # The push is not a success gate: a late push may be
        # epoch-rejected — the protocol working; the local progress folds
        # into the next round via dga_correct.
        try:
            if masker is not None:
                # The coordinator's post-cutoff announcement comes before the
                # broadcast.  Every member replies with its self-mask seed
                # and its seeds toward the dropped; an excluded party falls
                # through, its self-mask seed kept private.  Inside this try:
                # a coordinator crash here reaches the failover arm.
                ctl = sa.check_recovery_message(
                    recv_on_runtime(runtime, coordinator, f"{down}.sa.c", down).resolve(timeout=backstop),
                    "request",
                )
                dropped = list(ctl["dr"])
                if me in ctl["m"]:
                    runtime.send_proxy.send(
                        coordinator,
                        sa.make_recovery_reply(me, masker.recovery_seeds(dropped), masker.self_seed_hex()),
                        f"{down}.sa.r.{me}", down,
                        round_tag=round_index, epoch_tag=epoch,
                    )
            value = recv_on_runtime(runtime, coordinator, f"{down}.down", down).resolve(timeout=backstop)
        except BaseException as exc:
            codec.rollback()
            raise QuorumRoundError(
                f"round {round_index}: result broadcast from coordinator "
                f"{coordinator!r} failed: {exc!r}"
            ) from exc
        codec.commit()
        result_val = value["d"]
        if quant is not None and isinstance(result_val, qz.QuantizedPackedTree):
            # Quantized downlink: decoded with the grid the payload carries.
            result_val = result_val.dequantize(
                torch.float32, ref=qref if result_val.gmeta.mode == "delta" else None
            )
        if timings is not None:
            timings["agg_s"] = time.perf_counter() - t0
        return QuorumRoundOutcome(result_val, list(value["m"]), value.get("a"), [])

    # -- coordinator ---------------------------------------------------------
    from rayfed_tpu_torch.fl.streaming import StreamingAggregator

    idx = {p: i for i, p in enumerate(parties)}
    w_list = None if weights is None else [float(weights[p]) for p in parties]
    others = [p for p in parties if p != me]
    agg_kwargs: Dict[str, Any] = {}
    if quant is not None:
        # The fold grid IS the quantization grid.
        agg_kwargs["chunk_elems"] = quant.chunk_elems
        agg_kwargs["quant_ref"] = qref
    elif server_step is not None:
        # The step consumes the exact f32 aggregate (quantized rounds
        # finalize in f32 already).
        agg_kwargs["out_dtype"] = "float32"
    if masker is not None:

        def _mask_recovery(member_labels):
            # On the aggregator worker, between the cutoff and the rescale.
            # The chaos hook sits first: a harness can kill the coordinator
            # in the recovery window.
            chaos.fire("secagg_recovery", party=me, round=round_index, epoch=epoch)
            dropped = sorted(set(parties) - set(member_labels))
            # To every active peer: excluded stragglers are parked on this
            # key too and fall through to the broadcast.
            runtime.send_proxy.send_many(
                others, sa.make_recovery_request(member_labels, dropped),
                f"{down}.sa.c", down, round_tag=round_index, epoch_tag=epoch,
            )
            if dropped:
                sa.SECAGG_STATS["mask_recoveries"] += 1
                logger.warning(
                    "round %d: recovering masks of dropped parties %s from %d survivors",
                    round_index, dropped, len(member_labels),
                )
            survivor_seeds = {}
            self_seeds = {}
            if me in member_labels:
                survivor_seeds[me] = masker.recovery_seeds(dropped)
                self_seeds[me] = masker.self_seed_hex()
            # Park every reply's recv first, resolve after: one round trip.
            reply_refs = {
                p: recv_on_runtime(runtime, p, f"{down}.sa.r.{p}", down)
                for p in member_labels if p != me
            }
            for p, ref in reply_refs.items():
                reply = sa.check_recovery_message(ref.resolve(timeout=backstop), "reply")
                if str(reply["p"]) != p:
                    # The sender decides the mask signs (sorted-name order):
                    # a mis-stamped reply would corrupt the correction.
                    raise sa.SecAggError(
                        f"recovery reply on {p!r}'s rendezvous claims "
                        f"to be from {reply['p']!r} — refusing to "
                        f"finalize the round"
                    )
                survivor_seeds[p] = dict(reply["sd"])
                self_seeds[p] = str(reply["b"])
            return sa.mask_correction(
                survivor_seeds, dropped, quant.total_elems, secagg.prg_scheme,
                members=member_labels, self_seeds=self_seeds,
            )

        agg_kwargs["masked"] = True
        agg_kwargs["mask_recovery"] = _mask_recovery
    agg = StreamingAggregator(
        len(parties),
        weights=w_list,
        allowed=runtime.cluster_config.serializing_allowed_list,
        quorum=min(int(quorum), len(parties)),
        labels=parties,
        party=me,
        quant=quant,
        device=runtime.transport.device,
        **agg_kwargs,
    )
    sink_entries = []
    cancel_keys = []
    for p in parties:
        if p == me:

            def _feed(ref, i=idx[p]):
                exc = ref.exception()
                if exc is not None:
                    # The coordinator's own training failed: survivable
                    # under quorum, like any other party's failure.
                    agg._on_error(i, exc)
                    return
                try:
                    value = codec.to_wire(ref.resolve())
                # fedlint: disable=FED004 — transferred, not swallowed: a quantize failure of the coordinator's OWN update is survivable under quorum exactly like its training failing
                except BaseException as e:
                    agg._on_error(i, e)
                    return
                agg.add_local(i, value)

            updates[p].get_local_ref().add_done_callback(_feed)
        else:
            sink_entries.append((p, f"{down}.up.{p}", down, agg.sink(idx[p])))
            cancel_keys.append((p, f"{down}.up.{p}", down))
    if sink_entries:
        runtime.transport.recv_stream_many(sink_entries)
    try:
        result = agg.result(timeout=backstop, deadline_s=deadline_s)
        members = [parties[i] for i in agg.quorum_members]
        if server_step is not None:
            # After the cutoff and before the broadcast: the step's
            # pseudo-gradient is the arrived subset's mean, and a failure
            # reaches the parked peers through the poison below.
            result = server_step(result)
        # Excluded stragglers' sinks must not linger: an armed sink keeps
        # the health monitor probing its source, and a late payload would
        # park unread.
        member_set = set(members)
        for p, up, dwn in cancel_keys:
            if p not in member_set:
                runtime.transport.cancel_stream(up, dwn)
        # Inside the poison-protected block: announce_fn can raise (a
        # leaving coordinator with no successor), and the peers are parked
        # on the broadcast.
        announce, welcomes = (None, [])
        if announce_fn is not None:
            announce, welcomes = announce_fn(members)
    except BaseException as exc:
        codec.rollback()
        if isinstance(exc, chaos.ChaosPartyCrash):
            # An injected crash must look like a real one: no poison (the
            # secagg_recovery hook fires on the aggregator worker, so its
            # crash surfaces here).
            raise
        _poison_round_key(runtime, others, f"{down}.down", down, exc)
        if masker is not None:
            # Masked peers may still be parked on the announcement.
            _poison_round_key(runtime, others, f"{down}.sa.c", down, exc)
        for _p, up, dwn in cancel_keys:
            runtime.transport.cancel_stream(up, dwn)
        raise QuorumRoundError(f"round {round_index}: quorum aggregation failed: {exc!r}") from exc
    codec.commit()
    # The round is decided and nobody has heard: the chaos "announce" hook
    # sits here, outside the poison-protected block, so an injected crash
    # looks like a real one.
    chaos.fire("announce", party=me, round=round_index, epoch=epoch)
    wire_result = result
    down_descriptor = None
    if quant is not None:
        # The downlink re-quantized on a fresh grid, shared with
        # streaming_aggregate.
        wire_result, result, down_descriptor = qz.quantize_downlink(result, quant, qref, quant_scope)
    payload = {"d": wire_result, "m": members, "a": announce}
    refs = runtime.send_proxy.send_many(
        others, payload, f"{down}.down", down,
        stream=f"{stream}/down", round_tag=round_index, epoch_tag=epoch,
        quant_meta=down_descriptor,
    )
    for p, ref in refs.items():
        if not ref.resolve(timeout=backstop):
            # A dead or just-crashed party: its recv fails via the health
            # monitor, and a rejoin resyncs from a welcome.
            logger.warning("round %d: result broadcast to %s failed (dead or departed party?)",
                           round_index, p)
    if timings is not None:
        timings["agg_s"] = time.perf_counter() - t0
    return QuorumRoundOutcome(result, members, announce, welcomes)


def _coordinator_announce_fn(runtime, trainers: Dict[str, Any], active: List[str],
                             coordinator: str, leaving: bool = False):
    """The coordinator's per-round roster-transition hook for
    :func:`quorum_aggregate`: drains join/leave requests, drops parties
    that are both monitor-declared dead and missed the round, and advances
    the roster epoch when the set changed.  A join request always gets a
    welcome.  ``leaving``: this coordinator called ``fed.leave()`` — it
    completes the round and the announcement names its successor (a
    handover); with no live successor it fails loudly."""
    from rayfed_tpu_torch.transport.manager import roster_successor

    transport = runtime.transport
    roster = transport.roster

    def announce_fn(members: List[str]):
        joins: Dict[str, str] = {}
        leaves = set()
        for req in transport.drain_membership_requests():
            op, p = req.get("op"), req.get("party")
            if op == "join" and p in trainers:
                joins[p] = str(req.get("nonce", ""))
            elif op == "leave" and p:
                leaves.add(p)
            else:
                logger.warning("ignoring malformed membership request: %r", req)
        if leaving:
            leaves.add(coordinator)
        dead = set(transport.get_stats().get("dead_parties", ()))
        # Drop only parties that both missed the round and are declared
        # dead: a straggler stays a member (its progress folds next round).
        dropped = (set(active) - set(members)) & dead
        established = set(active) - dropped - leaves
        new_members = established | set(joins)
        handover = None
        if coordinator not in new_members:
            # Successor candidates are the established members only: a
            # same-round joiner is not in the round loop yet.
            handover = roster_successor(established, coordinator, dead)
            if handover is None:
                raise QuorumRoundError(
                    f"coordinator {coordinator!r} is leaving the roster "
                    f"but no live established successor remains "
                    f"(members {sorted(new_members)}, dead "
                    f"{sorted(dead)}) — the run cannot continue"
                )
        announce = None
        if new_members != set(active):
            epoch = roster.advance(sorted(new_members))
            announce = {"epoch": epoch, "members": sorted(new_members)}
            if handover is not None:
                announce["handover"] = handover
        return announce, [(p, n) for p, n in sorted(joins.items())]

    return announce_fn


def run_quorum_rounds(
    trainers: Dict[str, Any],
    params: Any,
    rounds: int,
    *,
    quorum: int,
    round_deadline_s: Optional[float],
    weights: Optional[Sequence[float]] = None,
    coordinator: Optional[str] = None,
    wire_dtype: Any = None,
    mode: str = "coordinator",
    ring_chunk_elems: Optional[int] = None,
    on_round: Optional[Callable[[int, Any], None]] = None,
    timings: Optional[list] = None,
    stream: str = "fedavg",
    join_ticket: Optional[Dict[str, Any]] = None,
    round_log: Optional[list] = None,
    checkpointer: Any = None,
    checkpoint_every: int = 0,
    wire_quant: Optional[str] = None,
    secure_agg: bool = False,
    region_size: Optional[int] = None,
    region_branch: Optional[int] = None,
    region_quorum: Optional[int] = None,
    region_deadline_s: Optional[float] = None,
    server_opt: Optional[Any] = None,
) -> Any:
    """The quorum-mode round loop behind ``run_fedavg_rounds(quorum=k)``.

    Against the classic loop:

    - aggregation is the quorum-aware streaming round
      (:func:`quorum_aggregate`); ``mode="ring"`` tries the ring first and
      falls back to it when the ring aborts;
    - each party's next input is the broadcast aggregate, a straggler's
      ``dga_correct(agg, update, input)``;
    - the active set is the live roster (epoch-advanced at round
      boundaries by the coordinator's announcements); a party that finds
      itself off the roster returns its last broadcast;
    - the coordinator is a rotating lease (failover on a declared death,
      handover on its ``fed.leave()``);
    - ``weights`` align with ``sorted(trainers)`` and are subset per round
      to the active members;
    - ``join_ticket``: the welcome ``fed.join()`` returned — the joiner
      starts at its round, from its params, under its coordinator;
    - ``round_log``: receives one ``{"round", "epoch", "active", "members",
      "coordinator"}`` dict per round;
    - ``wire_quant``: the rounds run in the compressed domain from the
      second round on, the grid ranged by the previous broadcast's delta
      (the welcome carries it to joiners);
    - ``mode="hierarchy"`` (requires ``wire_quant`` and ``region_size``):
      each round with a grid runs the region tree first, with per-region
      cutoffs under ``region_quorum``/``region_deadline_s``.

    - ``server_opt``: a packed :class:`~rayfed_tpu_torch.fl.server_opt.
      PackedServerOpt`, stepped where the round finalizes and resynced on
      every controller; welcomes carry its state.

    - ``secure_agg`` (requires ``wire_quant``): every round with a grid
      runs masked (:func:`quorum_aggregate`'s ``secagg``); the first round
      runs unquantized and unmasked.

    - ``checkpointer`` (+ ``checkpoint_every``): snapshot ``(round,
      params, server-opt state)`` with the session, roster epoch and
      members, coordinator and member log; a restarted cluster resumes
      from the latest snapshot (skipped when ``join_ticket`` is given).
    """
    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch.fl import quantize as qz
    from rayfed_tpu_torch.fl.compression import PackedTree, compress, decompress
    from rayfed_tpu_torch.fl.fedavg import as_tensor
    from rayfed_tpu_torch.fl.overlap import dga_correct
    from rayfed_tpu_torch.runtime import get_runtime
    from rayfed_tpu_torch.transport.manager import roster_successor

    from rayfed_tpu_torch.fl.server_opt import (
        PackedServerOpt,
        PackedServerOptimizer,
        describe_server_opt,
    )

    if server_opt is not None:
        if not isinstance(server_opt, PackedServerOpt):
            raise QuorumRoundError(
                "quorum rounds take a fl.server_opt.PackedServerOpt "
                "(the packed-domain server optimizer, e.g. fl.server_opt"
                ".fedac(...)); legacy fedopt.ServerOptimizer optimizers "
                "run per-leaf tree arithmetic and need the exact "
                "fixed-roster classic loop"
            )
        if secure_agg:
            raise QuorumRoundError(
                "server_opt does not compose with secure_agg yet — the "
                "masked recovery window has not been exercised with a "
                "post-finalize step (loud exclusion, fl.server_opt)"
            )
    runtime = get_runtime()
    transport = runtime.transport
    # The replicated state lives on the party's card (its device).
    sopt = None if server_opt is None else PackedServerOptimizer(server_opt, device=transport.device)
    sopt_descr = describe_server_opt(server_opt)
    secagg_keys = None
    if secure_agg:
        if wire_quant is None:
            raise QuorumRoundError(
                "secure_agg requires wire_quant — masks live in the "
                "shared-grid integer domain (fl.secagg)"
            )
        secagg_keys = getattr(transport, "secagg_keys", None)
        if secagg_keys is None or not hasattr(transport, "ensure_secagg_peer_keys"):
            raise QuorumRoundError(
                "secure_agg needs the transport key-agreement plane "
                "(TransportManager.secagg_keys) — this transport has "
                "none"
            )
    roster = getattr(transport, "roster", None)
    if roster is None:
        raise QuorumRoundError(
            "this transport has no roster (quorum rounds need the "
            "single-process TransportManager)"
        )
    if mode == "hierarchy":
        if wire_quant is None:
            raise QuorumRoundError(
                "mode='hierarchy' requires wire_quant — hierarchical "
                "aggregation is compressed-domain only (fl.hierarchy)"
            )
        if region_size is None or int(region_size) < 1:
            raise QuorumRoundError(
                "mode='hierarchy' requires region_size= (the "
                "deterministic partition width)"
            )
        if secure_agg:
            raise QuorumRoundError(
                "mode='hierarchy' and secure_agg are mutually "
                "exclusive — pairwise masks only cancel over the full "
                "party set (fl.hierarchy)"
            )
        if region_branch is not None and int(region_branch) < 2:
            raise QuorumRoundError(f"region_branch must be >= 2, got {region_branch!r}")
        if region_quorum is not None and int(region_quorum) < 1:
            raise QuorumRoundError(f"region_quorum must be >= 1, got {region_quorum!r}")
        if region_deadline_s is not None and region_quorum is None:
            raise QuorumRoundError(
                "region_deadline_s needs region_quorum= (the "
                "per-region minimum arrived count the deadline gates)"
            )
    elif region_branch is not None or region_quorum is not None or region_deadline_s is not None:
        raise QuorumRoundError(
            "region_branch/region_quorum/region_deadline_s only apply "
            "to mode='hierarchy'"
        )
    me = runtime.party
    all_parties = sorted(trainers)
    cluster_parties = sorted(runtime.cluster_config.parties)
    if all_parties != cluster_parties:
        raise QuorumRoundError(
            f"quorum rounds require every cluster party to train: "
            f"trainers {all_parties} vs cluster {cluster_parties} — "
            f"observer controllers are not supported with quorum= "
            f"(use the classic aggregation paths there)"
        )
    # The pinned anchor (coord0) vs the live lease (coord): the stream name
    # derives from the pair, so controllers that agree on the lease agree
    # on every rendezvous key (see _effective_stream).
    coord0 = coordinator if coordinator is not None else min(trainers)
    coord = coord0
    w_map = None if weights is None else dict(zip(all_parties, [float(w) for w in weights]))
    wire_dt = torch.bfloat16 if wire_dtype is None else wire_dtype
    backstop = runtime.job_config.recv_backstop_s
    # One shared log even when the caller passed none: the snapshots embed
    # it (the restored run replays the same recurrence).
    log = round_log if round_log is not None else []

    restored = None
    # Where the next round's driver span opens, when a restore or a snapshot
    # opens the round: the flight recorder tags both with that round's
    # number, so the round's span covers them (else the trace's round window
    # is wider than the driver's own span by the snapshot's time).
    span_open = None
    if checkpointer is not None and join_ticket is None:
        t_open = (time.perf_counter(), time.time())
        restored = _restore_quorum_snapshot(checkpointer, params, roster, log,
                                            sopt=sopt, sopt_descr=sopt_descr)
        if restored is not None:
            span_open = t_open

    # The previous round's observed aggregate delta (broadcast values only:
    # the same on every controller), the range of the next round's grid.
    quant_prev_delta = None

    if join_ticket is not None:
        start_round = int(join_ticket["round"])
        session = str(join_ticket["session"])
        params = join_ticket["params"]
        # The welcome names the run's current coordinator.
        coord = str(join_ticket.get("coordinator", coord))
        if wire_quant is not None:
            quant_prev_delta = join_ticket.get("qd")
        _apply_ticket_server_opt(transport, join_ticket, sopt, sopt_descr)
    elif restored is not None:
        start_round, session, params = restored
        if start_round >= rounds:
            return params
        # A run that checkpointed after a failover or handover has the old
        # coordinator off the roster: every resuming controller lands on
        # the same successor by the deterministic succession rule.
        _, members_now = roster.snapshot()
        if coord not in members_now:
            coord = roster_successor(members_now, coord)
            if coord is None:
                raise QuorumRoundError(
                    f"restored roster {sorted(members_now)} has no live "
                    f"successor for coordinator {coord0!r}"
                )
            logger.info("[%s] restored roster lacks coordinator %s; re-derived successor %s",
                        me, coord0, coord)
    else:
        start_round = 0
        # One id per run, drawn identically on every non-joining controller.
        session = str(runtime.next_seq_id())

    current = params if isinstance(params, PackedTree) else compress(params, packed=True, wire_dtype=wire_dt)
    late_inputs: Dict[str, Any] = {}
    dga = fed.remote(dga_correct)
    # A fed.leave() stays pending until the announced roster drops us (the
    # request is re-sent each boundary, surviving a failover between).
    leave_pending = False

    r = start_round
    while r < rounds:
        chaos.fire("round", party=me, round=r)
        epoch, roster_members = roster.snapshot()
        if me not in roster_members:
            logger.info("[%s] off the roster at epoch %d; leaving the round loop at round %d", me, epoch, r)
            break
        if roster.consume_leave_request():
            leave_pending = True
        if leave_pending and me != coord:
            nonce = uuid.uuid4().hex
            runtime.send_proxy.send(
                coord, {"op": "leave", "party": me, "nonce": nonce},
                f"roster.req.{me}.{nonce}", "roster",
            )
        active = [p for p in all_parties if p in roster_members]
        # A party off the roster forfeits its pending late fold.
        for p in list(late_inputs):
            if p not in active:
                late_inputs.pop(p)
        if len(active) < quorum:
            raise QuorumRoundError(
                f"round {r}: live roster {active} is smaller than the "
                f"quorum ({quorum}) — the run cannot make progress"
            )
        if secure_agg:
            # One HELLO ping per missing pair (a no-op once every active
            # peer's key is recorded, so a joiner is pinged once).
            transport.ensure_secagg_peer_keys(active)
        round_grid = None
        round_ref = None
        if wire_quant is not None:
            # The round's shared reference: the broadcast as flat f32.
            round_ref = as_tensor(current.buf).reshape(-1).to(torch.float32)
            if quant_prev_delta is not None:
                round_grid = qz.make_round_grid(
                    quant_prev_delta, wire_dtype=wire_quant, mode="delta",
                    expand=qz.QUANT_DELTA_EXPAND,
                    # The grid chunking IS the ring's stripe grid.
                    chunk_elems=ring_chunk_elems if mode in ("ring", "hierarchy") else None,
                )
        # The round's shared starting buffer anchors the step (where the
        # round finalizes) and the resync (on every controller).
        step_fn = None
        x_srv = None
        if sopt is not None:
            x_srv = round_ref if round_ref is not None else as_tensor(current.buf).reshape(-1).to(torch.float32)
            sopt.ensure(x_srv)
            step_fn = sopt.step_fn(x_srv)
        rec = None
        trace_round = telemetry.armed()
        if timings is not None or trace_round:
            rec = {"local_s": 0.0, "push_s": 0.0, "agg_s": 0.0, "hidden_s": 0.0}
            t_r0 = time.perf_counter()
            t_r0_wall = time.time()
        inputs = {p: late_inputs.pop(p, current) for p in active}
        updates = {p: trainers[p].train.remote(inputs[p]) for p in active}
        if rec is not None and me in updates:
            my_ref = updates[me].get_local_ref()
            if my_ref is not None:
                my_ref.add_done_callback(
                    lambda _ref, rec=rec, t0=t_r0: rec.__setitem__("local_s", time.perf_counter() - t0)
                )
        # The aggregation attempt loop: deterministic coordinator failover.
        # The happy path runs once; when the attempt dies because the
        # coordinator is declared dead, every survivor derives the same
        # successor and re-establishes the same round there.
        failed_over: set = set()
        while True:
            announce_fn = (
                _coordinator_announce_fn(runtime, trainers, active, coordinator=coord, leaving=leave_pending)
                if me == coord else None
            )
            try:
                outcome = _aggregate_with_mode(
                    runtime, updates, w_map, session=session, round_index=r,
                    quorum=quorum, deadline_s=round_deadline_s, coordinator=coord,
                    stream=_effective_stream(stream, coord, coord0), epoch=epoch,
                    mode=mode, ring_chunk_elems=ring_chunk_elems,
                    announce_fn=announce_fn, backstop=backstop, active=active,
                    timings=rec, quant=round_grid, quant_ref=round_ref,
                    # The residual is keyed by the caller's stream: it
                    # carries across attempts and coordinators.
                    quant_scope=stream if round_grid is not None else None,
                    region_size=region_size, region_branch=region_branch,
                    region_quorum=region_quorum, region_deadline_s=region_deadline_s,
                    secagg=secagg_keys if round_grid is not None else None,
                    server_step=step_fn,
                )
                break
            except QuorumRoundError as exc:
                dead = set(runtime.transport.get_stats().get("dead_parties", ()))
                if me == coord or coord not in dead:
                    # Not a coordinator death: nothing a new lease fixes.
                    raise
                failed_over.add(coord)
                successor = roster_successor(active, coord, dead | failed_over)
                if successor is None:
                    raise QuorumRoundError(
                        f"round {r}: coordinator {coord!r} died and no "
                        f"live successor remains on the roster "
                        f"{active} (dead: {sorted(dead)})"
                    ) from exc
                QUORUM_STATS["coordinator_failovers"] += 1
                telemetry.event(
                    "quorum.failover", round=r, epoch=epoch, party=me, peer=successor,
                    outcome="failover",
                    detail={"from": coord, "to": successor, "dead": sorted(dead), "error": repr(exc)},
                )
                logger.warning(
                    "[%s] round %d: coordinator %s declared dead (%s); failing over "
                    "to successor %s and re-establishing the round", me, r, coord, exc, successor,
                )
                coord = successor
        avg, members = outcome.result, outcome.members
        # Stragglers fold their missed progress into the next round (DGA),
        # a party-local fed task: no extra wire traffic.
        for p in active:
            if p not in members:
                late_inputs[p] = dga.party(p).remote(avg, updates[p], inputs[p])
        next_coord = coord
        if outcome.announce is not None:
            if me != coord:
                roster.apply(outcome.announce["epoch"], outcome.announce["members"])
            handover = outcome.announce.get("handover")
            if handover is not None:
                # Graceful coordinator departure: the lease rotates at this
                # boundary to the announced successor.
                next_coord = str(handover)
                QUORUM_STATS["graceful_handovers"] += 1
                telemetry.event(
                    "quorum.handover", round=r, epoch=epoch, party=me, peer=next_coord,
                    detail={"from": coord, "to": next_coord},
                )
                logger.info("[%s] round %d: coordinator %s handed the lease to %s", me, r, coord, next_coord)
            if telemetry.active() is not None:
                telemetry.event(
                    "quorum.announce", round=r, party=me, peer=coord,
                    epoch=int(outcome.announce["epoch"]),
                    detail={"members": sorted(outcome.announce["members"]), "handover": handover},
                )
        log.append({
            "round": r, "epoch": epoch, "active": list(active),
            "members": list(members), "coordinator": coord,
        })
        current = avg
        plane = getattr(transport, "objects", None)
        if plane is not None and runtime.job_config.blob_publish_round_models:
            # Every controller publishes the round broadcast into its
            # content cache, so every member is a named holder in welcome
            # handles.  Residency-canonicalized: the same fingerprint from
            # the same values on every controller.
            from rayfed_tpu_torch.objects import canonical_host

            plane.publish_slot("model", canonical_host(current))
        if sopt is not None:
            # Every replica advances from the broadcast pair; a failed
            # attempt never reaches here, so a failover re-runs the same
            # step from the same state.
            sopt.resync(x_srv, avg.buf)
        if wire_quant is not None:
            quant_prev_delta = qz._host_f32(avg.buf) - qz._host_f32(round_ref)
        if rec is not None:
            rec["agg_s"] = max(0.0, rec.get("agg_s", 0.0) - rec["local_s"])
            rec["round"] = r
            rec["epoch"] = epoch
            rec["coordinator"] = coord
            if timings is not None:
                timings.append(rec)
            if trace_round:
                t0, t0_wall = span_open or (t_r0, t_r0_wall)
                telemetry.emit(
                    "driver.round", round=r, epoch=epoch, party=me, peer=coord,
                    t_start=t0_wall, dur_s=time.perf_counter() - t0,
                    detail={k: (round(v, 6) if isinstance(v, float) else v)
                            for k, v in rec.items()} | {"members": sorted(members)},
                )
        if on_round is not None:
            on_round(r, decompress(current))
        if me == coord and outcome.welcomes:
            _send_welcomes(
                runtime, outcome.welcomes, roster, current, r + 1, session, backstop,
                coordinator=next_coord, quant_delta=quant_prev_delta,
                server_opt_descr=sopt_descr,
                # The post-resync state anchors the next round everywhere.
                server_state=sopt.state if sopt is not None else None,
            )
        coord = next_coord
        span_open = None
        if checkpointer is not None and checkpoint_every and (r + 1) % checkpoint_every == 0:
            span_open = (time.perf_counter(), time.time())
            ep_now, mem_now = roster.snapshot()
            snap = {"params": decompress(current)}
            if sopt is not None:
                # The state rides the snapshot; its stamp below makes a
                # cross-config restore refuse instead of resetting momentum.
                snap["server_state"] = sopt.state
            checkpointer.save(
                r + 1, snap,
                metadata={
                    "quorum_session": session,
                    "epoch": int(ep_now),
                    "members": list(mem_now),
                    "coordinator": coord,
                    "member_log": [dict(e) for e in log],
                    "server_opt": sopt_descr,
                },
            )
        r += 1
    return decompress(current)


def _restore_quorum_snapshot(checkpointer, params, roster, log, sopt=None, sopt_descr=None):
    """Resume a quorum run from its latest snapshot: returns ``(start_round,
    session, params)`` with the roster epoch and members applied, the member
    log replayed into ``log`` and the server-opt state (when the run carries
    one) loaded into ``sopt``; or ``None`` when the checkpointer holds
    nothing yet.  The caller re-derives the coordinator from the restored
    roster.  The snapshot's ``server_opt`` stamp must match ``sopt_descr``
    (a refusal either way: ``fl.server_opt.check_snapshot_server_opt``)."""
    latest = checkpointer.latest_round()
    if latest is None:
        return None
    from rayfed_tpu_torch.fl.compression import PackedTree, decompress, pack_tree

    tmpl = decompress(params) if isinstance(params, PackedTree) else params
    # "ckpt_meta", not "meta": checkpoint metadata lives on local disk; it
    # is not frame metadata, whose literal keys fedlint FED006 polices.
    ckpt_meta = checkpointer.load_metadata(latest)
    if "quorum_session" not in ckpt_meta:
        raise QuorumRoundError(
            f"checkpoint round {latest} was not written by a quorum run (no "
            f"roster epoch / rendezvous session in its metadata) — a "
            f"classic-loop checkpoint directory cannot resume a quorum run"
        )
    if sopt_descr is not None:
        from rayfed_tpu_torch.fl.server_opt import check_snapshot_server_opt

        check_snapshot_server_opt(ckpt_meta.get("server_opt"), sopt_descr)
    target = {"params": tmpl}
    if sopt is not None:
        target["server_state"] = sopt.opt.init(pack_tree(tmpl, torch.float32).buf)
    restored_round, snap = checkpointer.restore(round_num=latest, target=target)
    if sopt is not None:
        sopt.load_state(snap["server_state"])
    roster.apply(int(ckpt_meta["epoch"]), list(ckpt_meta["members"]))
    del log[:]
    log.extend(dict(e) for e in (ckpt_meta.get("member_log") or []))
    logger.info(
        "resuming quorum run at round %d (roster epoch %s, members %s)",
        restored_round, ckpt_meta["epoch"], ckpt_meta["members"],
    )
    return int(restored_round), str(ckpt_meta["quorum_session"]), snap["params"]


def _effective_stream(stream: str, coord: str, coord0: str) -> str:
    """The round's delta-stream scope under the current coordinator lease:
    the pinned coordinator keeps the caller's name, a successor gets a
    coordinator-scoped one — every failover rendezvous key is fresh, and
    the same on every controller."""
    return stream if coord == coord0 else f"{stream}.fo.{coord}"


def _aggregate_with_mode(
    runtime, updates, w_map, *, session, round_index, quorum, deadline_s,
    coordinator, stream, epoch, mode, ring_chunk_elems, announce_fn,
    backstop, active, timings, quant=None, quant_ref=None, quant_scope=None,
    secagg=None, region_size=None, region_branch=None, region_quorum=None,
    region_deadline_s=None, server_step=None,
) -> QuorumRoundOutcome:
    """The topology first when ``mode`` is ``"ring"`` or ``"hierarchy"``: a
    straggler or dead party aborts it on every controller (poison cascade +
    commit pass), and the same round re-aggregates over the coordinator
    topology with the quorum cutoff.  The hierarchy runs from the first
    round with a grid (it is compressed-domain only), with per-region
    cutoffs under ``region_quorum=``, so a slow region folds its arrived
    members instead of aborting the tree."""
    from rayfed_tpu_torch.proxy import recv_on_runtime

    me = runtime.party
    down = _round_key(session, stream, round_index)

    def _announce_after_topology(result) -> QuorumRoundOutcome:
        """The roster transition after a ring or hierarchy round: a tiny
        announce frame rides after every such round (usually ``{"a":
        None}``)."""
        members = list(active)
        announce = None
        welcomes: list = []
        if me == coordinator:
            try:
                if announce_fn is not None:
                    announce, welcomes = announce_fn(members)
            except BaseException as exc:
                _poison_round_key(runtime, [p for p in active if p != me], f"{down}.ann", down, exc)
                raise
            chaos.fire("announce", party=me, round=round_index, epoch=epoch)
            refs = runtime.send_proxy.send_many(
                [p for p in active if p != me], {"a": announce}, f"{down}.ann", down,
                round_tag=round_index, epoch_tag=epoch,
            )
            for p, ref in refs.items():
                if not ref.resolve(timeout=backstop):
                    logger.warning("round %d: announce to %s failed", round_index, p)
        else:
            try:
                ann = recv_on_runtime(runtime, coordinator, f"{down}.ann", down).resolve(timeout=backstop)
            except BaseException as exc:
                # A coordinator dying between the ring and its announce
                # reaches the failover arm like any coordinator death.
                raise QuorumRoundError(
                    f"round {round_index}: announce from coordinator "
                    f"{coordinator!r} failed: {exc!r}"
                ) from exc
            announce = ann.get("a")
        return QuorumRoundOutcome(result, members, announce, welcomes)

    if mode == "ring" and len(active) > 1:
        from rayfed_tpu_torch.fl.ring import RING_STATS, RingRoundError, ring_aggregate

        try:
            result = ring_aggregate(
                [updates[p] for p in sorted(updates)],
                None if w_map is None else [w_map[p] for p in sorted(updates)],
                stream=f"{stream}/ring",
                # The step consumes the exact f32 assembly.
                out_dtype="float32" if server_step is not None else None,
                chunk_elems=ring_chunk_elems,
                seq_ids=(f"{down}.rs", f"{down}.ag", f"{down}.c", f"{down}.rl", f"{down}.nm"),
                round_tag=round_index,
                timeout=deadline_s if deadline_s is not None else backstop,
                expect_parties=active,
                timings=timings,
                quant=quant, quant_ref=quant_ref, quant_scope=quant_scope,
            )
            if server_step is not None:
                # No downlink: every controller holds the same assembly
                # and steps it locally.
                result = server_step(result)
            return _announce_after_topology(result)
        except RingRoundError as exc:
            logger.warning(
                "round %d: ring aborted (%s); re-aggregating the same round over "
                "the coordinator topology with quorum %d cutoff", round_index, exc, quorum,
            )
            RING_STATS["fallback_rounds"] += 1
            stream = f"{stream}.fb"
    if mode == "hierarchy" and len(active) > 1 and quant is not None:
        from rayfed_tpu_torch.fl.hierarchy import HIER_STATS, HierarchyRoundError, hierarchy_aggregate

        try:
            result = hierarchy_aggregate(
                [updates[p] for p in sorted(updates)],
                None if w_map is None else [w_map[p] for p in sorted(updates)],
                region_size=int(region_size), region_branch=region_branch,
                region_quorum=region_quorum, region_deadline_s=region_deadline_s,
                stream=f"{stream}/hier",
                quant=quant, quant_ref=quant_ref, quant_scope=quant_scope, quant_downlink=True,
                seq_ids=tuple(f"{down}.h{i}" for i in range(6)),
                round_tag=round_index, epoch=epoch,
                timeout=deadline_s if deadline_s is not None else backstop,
                timings=timings, server_step=server_step,
            )
            return _announce_after_topology(result)
        except HierarchyRoundError as exc:
            # A dead region coordinator (or root) aborts the tree on every
            # controller; the flat quorum re-run cuts the corpse off at the
            # deadline, the announcement drops it from the roster, and a
            # dead quorum coordinator reaches the failover arm.
            logger.warning(
                "round %d: hierarchy aborted (%s); re-aggregating the same round over "
                "the coordinator topology with quorum %d cutoff", round_index, exc, quorum,
            )
            HIER_STATS["fallback_rounds"] += 1
            stream = f"{stream}.fb"
    return quorum_aggregate(
        runtime, updates, w_map, session=session, round_index=round_index,
        quorum=quorum, deadline_s=deadline_s, coordinator=coordinator,
        stream=stream, epoch=epoch, announce_fn=announce_fn, backstop=backstop,
        timings=timings, quant=quant, quant_ref=quant_ref, quant_scope=quant_scope,
        secagg=secagg, server_step=server_step,
    )


def _normalize_server_opt_descr(descr) -> Dict[str, Any]:
    out: Dict[str, Any] = {"kind": str(descr.get("kind", "none"))}
    if "hyper" in descr:
        out["hyper"] = [float(h) for h in descr["hyper"]]
    return out


def _apply_ticket_server_opt(transport, join_ticket: Dict[str, Any], sopt, sopt_descr) -> None:
    """Validate a welcome's server-opt stamp against this run's and load
    the state its handle names (pulled through the object plane).  Every
    mismatch raises, naming both sides: a joiner entering on another
    trajectory would reset the optimizer for the whole run the first time
    it holds the coordinator lease."""
    t_descr = join_ticket.get("server_opt")
    mine = _normalize_server_opt_descr(sopt_descr)
    if t_descr is not None:
        theirs = _normalize_server_opt_descr(t_descr)
        if theirs != mine:
            raise QuorumRoundError(
                f"server_opt mismatch between this joiner and the run "
                f"it is entering: the welcome was stamped {theirs}, "
                f"this run_fedavg_rounds call is configured {mine} — "
                f"pass the matching server_opt"
            )
    elif sopt is not None:
        raise QuorumRoundError(
            f"this run is configured with server_opt={mine} but the "
            f"welcome carries no server_opt stamp (a coordinator from "
            f"before welcomes carried optimizer state?) — the joiner "
            f"cannot resync the trajectory; restart the run or drop "
            f"server_opt"
        )
    if sopt is None:
        return
    state_handle = join_ticket.get("server_state")
    if state_handle is None:
        raise QuorumRoundError(
            "the welcome stamps a packed server_opt but carries no "
            "server_state handle — cannot resync the optimizer "
            "trajectory"
        )
    from rayfed_tpu_torch.objects import maybe_resolve_handle

    sopt.load_state(maybe_resolve_handle(transport, state_handle))


def _send_welcomes(runtime, welcomes, roster, current, next_round, session, backstop,
                   coordinator: str, quant_delta=None, server_opt_descr=None,
                   server_state=None) -> None:
    """Coordinator: hand each joiner what it needs to enter the loop at the
    next round — round index, session, the roster epoch and members, the
    current coordinator, the global model (by content handle when the
    transport has an object plane: a warm joiner pulls ~zero bytes) and,
    for compressed-domain runs, the grid reference delta; under a packed
    server optimizer its stamp and a content handle to the replicated
    state.  Best-effort: a joiner that died again re-requests later."""
    from rayfed_tpu_torch.objects import canonical_host

    epoch, members = roster.snapshot()
    plane = getattr(runtime.transport, "objects", None)
    shared: Dict[str, Any] = {}
    if plane is not None:
        fp, n = plane.publish(canonical_host(current))
        shared["model"] = plane.handle_for(fp, n, extra_holders=members)
    else:
        shared["params"] = current
    if server_opt_descr is not None:
        shared["server_opt"] = dict(server_opt_descr)
    if server_state is not None:
        if plane is None:
            raise QuorumRoundError(
                "a server_opt run's welcome needs the object plane to "
                "carry the optimizer state; this transport has none"
            )
        sfp, sn = plane.publish(canonical_host(server_state))
        shared["server_state"] = plane.handle_for(sfp, sn)
    for party, nonce in welcomes:
        payload = {
            "round": int(next_round),
            "session": session,
            "epoch": int(epoch),
            "members": list(members),
            "coordinator": coordinator,
            **shared,
        }
        if quant_delta is not None:
            payload["qd"] = quant_delta
        ref = runtime.send_proxy.send(party, payload, f"roster.welcome.{party}.{nonce}", "roster")
        if not ref.resolve(timeout=backstop):
            logger.warning("welcome to rejoining party %s failed; it will have to re-request", party)


def join_cluster(coordinator: Optional[str] = None, timeout: Optional[float] = None) -> Dict[str, Any]:
    """(Re)join an in-progress quorum run — the ``fed.join()`` protocol.

    Sends a join request to the coordinator's membership inbox and parks
    until its next round boundary sends back the welcome: ``{"round",
    "session", "epoch", "members", "coordinator", "params"}``.  The
    welcome's roster epoch is applied to this runtime's roster before
    returning.  Pass the ticket to ``run_fedavg_rounds(join_ticket=...)``.
    ``coordinator`` must name the run's current lease holder.
    """
    from rayfed_tpu_torch.proxy import recv_on_runtime
    from rayfed_tpu_torch.runtime import get_runtime

    runtime = get_runtime()
    me = runtime.party
    coord = coordinator if coordinator is not None else min(runtime.cluster_config.parties)
    if coord == me:
        raise ValueError(
            "the coordinator cannot join its own run; pass the "
            "coordinator the run is anchored at"
        )
    nonce = uuid.uuid4().hex
    ref = runtime.send_proxy.send(
        coord, {"op": "join", "party": me, "nonce": nonce}, f"roster.req.{me}.{nonce}", "roster",
    )
    backstop = timeout if timeout is not None else runtime.job_config.recv_backstop_s
    if not ref.resolve(timeout=backstop):
        raise QuorumRoundError(f"join request to coordinator {coord!r} could not be delivered")
    welcome = recv_on_runtime(runtime, coord, f"roster.welcome.{me}.{nonce}", "roster").resolve(
        timeout=backstop
    )
    if "model" in welcome and "params" not in welcome:
        # A handle-passing welcome: resolve the model by content
        # fingerprint through the object plane.
        from rayfed_tpu_torch.objects import maybe_resolve_handle

        welcome["params"] = maybe_resolve_handle(runtime.transport, welcome["model"], timeout=backstop)
    runtime.transport.roster.apply(welcome["epoch"], welcome["members"])
    logger.info(
        "[%s] joined at round %d (roster epoch %d, members %s)",
        me, welcome["round"], welcome["epoch"], welcome["members"],
    )
    return welcome


def request_leave() -> None:
    """Graceful departure — the ``fed.leave()`` half of elastic membership.
    Sets the roster's leave flag; the quorum loop tells the coordinator at
    the next round boundary and returns once the announced roster drops
    this party.  On the coordinator it triggers a graceful handover."""
    from rayfed_tpu_torch.runtime import get_runtime

    get_runtime().transport.roster.request_leave()
