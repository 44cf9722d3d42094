"""High-level federated training driver: the round loop as one call.

:func:`run_fedavg_rounds` composes the framework's pieces — coordinator
aggregation with pipelined (lazy) rounds, the streaming on-card fold, the
legacy FedOpt server optimizers, error feedback, bf16 wire compression
and the compressed-domain round (``wire_quant``) — while preserving the
multi-controller contract: every party calls it at the same program point
with the same arguments and walks the identical seq-id sequence.

``mode="ring"`` aggregates over the chunk-striped ring
(:mod:`rayfed_tpu_torch.fl.ring`), falling back to the coordinator topology
for a round the ring aborts; ``mode="hierarchy"`` over the region tree
(:mod:`rayfed_tpu_torch.fl.hierarchy`), falling back to the flat streaming
fold for a round the tree aborts; ``overlap=True`` hands the loop to
:class:`rayfed_tpu_torch.fl.overlap.PipelinedRoundRunner` (round *k*'s
aggregation under round *k+1*'s compute); ``quorum=`` to
:func:`rayfed_tpu_torch.fl.quorum.run_quorum_rounds` (k-of-n rounds, elastic
membership, coordinator failover).  A packed ``server_opt``
(:mod:`rayfed_tpu_torch.fl.server_opt`) steps the aggregate where it
finalizes and every controller resyncs its state replica from the
broadcast.  ``secure_agg`` masks each round's quantized contributions
(:mod:`rayfed_tpu_torch.fl.secagg`): the coordinator learns only the sum.
With a ``checkpointer`` (:class:`rayfed_tpu_torch.checkpoint.FedCheckpointer`)
each party snapshots ``(round, params, server-opt state)`` every
``checkpoint_every`` rounds and a restarted run resumes from its latest
snapshot.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Optional, Sequence

import torch

import numpy as np

from rayfed_tpu_torch.fl.compression import (
    ErrorFeedback,
    compress,
    decompress,
    dtype_name,
    pack_tree,
)
from rayfed_tpu_torch.fl.fedavg import aggregate
from rayfed_tpu_torch.fl.fedopt import ServerOptimizer
from rayfed_tpu_torch.fl.quantize import QUANT_DELTA_EXPAND, _host_f32, make_round_grid

logger = logging.getLogger(__name__)


def sample_parties(
    parties: Sequence[str], sample: int, sample_seed: int, round_index: int
) -> list:
    """The per-round participation draw, shared by every controller.

    Draws from the **sorted** party list (two controllers that built their
    ``trainers`` mapping in different orders must draw the same subset),
    and returns it sorted, so the coordinator choice is order-stable.
    """
    import random as _random

    rng = _random.Random(int(sample_seed) * 1_000_003 + round_index)
    return sorted(rng.sample(sorted(parties), int(sample)))


def validate_round_config(
    trainers: dict,
    *,
    rounds: int = 1,
    server_opt: Optional[Any] = None,
    weights: Optional[Sequence[float]] = None,
    compress_wire: bool = False,
    packed_wire: bool = False,
    checkpointer: Any = None,
    checkpoint_every: int = 0,
    sample: Optional[int] = None,
    aggregator: Optional[Callable[[Sequence[Any]], Any]] = None,
    streaming_agg: bool = False,
    error_feedback: bool = False,
    wire_quant: Optional[Any] = None,
    mode: str = "coordinator",
    coordinator: Optional[str] = None,
    overlap: bool = False,
    ring_chunk_elems: Optional[int] = None,
    region_size: Optional[int] = None,
    region_branch: Optional[int] = None,
    region_quorum: Optional[int] = None,
    region_deadline_s: Optional[float] = None,
    quorum: Optional[int] = None,
    round_deadline_s: Optional[float] = None,
    join_ticket: Optional[dict] = None,
    round_log: Optional[list] = None,
    secure_agg: bool = False,
) -> dict:
    """Validate one round-loop configuration WITHOUT running it.

    The verdict is the JAX package's, option for option: each pair either
    passes or raises a ``ValueError`` naming the clash.  Returns
    ``{"wire_quant": <dtype name or None>, "checkpoint_every": <int>,
    "server_opt_kind": "none"|"fedopt"|"packed"}``.
    """
    from rayfed_tpu_torch.fl.server_opt import PackedServerOpt

    packed_opt = server_opt if isinstance(server_opt, PackedServerOpt) else None
    legacy_opt = server_opt if packed_opt is None else None
    if legacy_opt is not None and not isinstance(legacy_opt, ServerOptimizer):
        raise ValueError(
            f"server_opt must be a fl.server_opt.PackedServerOpt "
            f"(packed-domain momentum/FedAC — composes with "
            f"wire_quant/quorum/ring/hierarchy) or a legacy "
            f"fl.fedopt.ServerOptimizer, got "
            f"{type(server_opt).__name__}"
        )
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    if checkpoint_every and checkpointer is None:
        raise ValueError("checkpoint_every set without a checkpointer")
    if checkpoint_every < 0:
        raise ValueError(f"checkpoint_every must be >= 0, got {checkpoint_every}")
    if checkpointer is not None and not checkpoint_every:
        # A checkpointer with checkpoint_every=0 would resume but never
        # save: snapshot every round rather than silently never.
        checkpoint_every = 1
    if aggregator is not None and weights is not None:
        raise ValueError(
            "aggregator and weights are mutually exclusive (a custom "
            "reducer defines its own weighting)"
        )
    if sample is not None and not 1 <= int(sample) <= len(trainers):
        raise ValueError(f"sample must be in [1, {len(trainers)}], got {sample}")
    if sample is not None and weights is not None:
        raise ValueError(
            "sample and weights are mutually exclusive (a weight "
            "sequence cannot align with a changing per-round subset)"
        )
    qname = None
    if wire_quant is not None:
        qname = (
            dtype_name(wire_quant) if isinstance(wire_quant, torch.dtype)
            else np.dtype(wire_quant).name
        )
        if qname not in ("uint8", "int8"):
            raise ValueError(
                f"wire_quant must be an 8-bit integer dtype (uint8/"
                f"int8), got {qname!r}"
            )
        if not (compress_wire and packed_wire):
            raise ValueError(
                "wire_quant requires compress_wire=True and "
                "packed_wire=True (the quantized unit is the packed "
                "wire buffer)"
            )
        if not streaming_agg and mode not in ("ring", "hierarchy") and quorum is None:
            raise ValueError(
                "wire_quant requires streaming_agg=True, mode='ring', "
                "mode='hierarchy' or quorum= — the compressed-domain "
                "fold lives in the streaming/striped aggregators "
                "(fl.quantize)"
            )
        incompat_q = {
            "error_feedback": error_feedback,  # the grid codec carries its own
            "aggregator": aggregator is not None,
            "server_opt": legacy_opt is not None,  # a legacy tree optimizer
        }
        bad_q = [k for k, v in incompat_q.items() if v]
        if bad_q:
            raise ValueError(
                f"wire_quant is incompatible with {bad_q}: the "
                f"grid codec carries its own error feedback, the "
                f"other paths have not been taught the quantized round "
                f"shape, and a legacy fedopt.ServerOptimizer runs "
                f"per-leaf tree arithmetic — use the packed "
                f"fl.server_opt optimizers with wire_quant"
            )
    if secure_agg:
        if wire_quant is None:
            raise ValueError(
                "secure_agg requires wire_quant — pairwise masks live "
                "in the shared-grid integer domain (fl.secagg); pass "
                "e.g. wire_quant='uint8'"
            )
        if mode == "ring":
            raise ValueError(
                "secure_agg runs the streaming/quorum coordinator "
                "topology — mode='ring' is a loud exclusion (stripe "
                "owners would each see a maskable subset)"
            )
        if sample is not None and sample != len(trainers):
            raise ValueError(
                "secure_agg and sample are mutually exclusive: the "
                "mask peer set is the round's full active roster"
            )
    if streaming_agg and not (compress_wire and packed_wire):
        raise ValueError(
            "streaming_agg requires compress_wire=True and "
            "packed_wire=True (the streamed unit is the packed wire "
            "buffer)"
        )
    if streaming_agg and aggregator is not None:
        raise ValueError(
            "streaming_agg and aggregator are mutually exclusive (a "
            "custom reducer needs the raw per-party values)"
        )
    if error_feedback and not (compress_wire and packed_wire):
        raise ValueError(
            "error_feedback requires compress_wire=True and "
            "packed_wire=True (the residual is carried on the packed "
            "wire buffer)"
        )
    if mode not in ("coordinator", "ring", "hierarchy"):
        raise ValueError(
            f"unknown mode {mode!r}: expected 'coordinator', 'ring' or "
            f"'hierarchy'"
        )
    if mode == "hierarchy":
        if wire_quant is None:
            raise ValueError(
                "mode='hierarchy' requires wire_quant: hierarchical "
                "aggregation is compressed-domain ONLY (float partial "
                "sums would re-associate a non-associative fold and "
                "silently break hierarchical == flat byte-identity) — "
                "pass e.g. wire_quant='uint8'"
            )
        if region_size is None or int(region_size) < 1:
            raise ValueError(
                "mode='hierarchy' requires region_size= (the "
                "deterministic partition width of the sorted roster), "
                f"got {region_size!r}"
            )
        if streaming_agg:
            raise ValueError(
                "mode='hierarchy' and streaming_agg are mutually "
                "exclusive: the hierarchy replaces the flat hub "
                "topology streaming_agg folds on (its fallback path "
                "streams on its own) — drop streaming_agg"
            )
        if sample is not None and sample != len(trainers):
            raise ValueError(
                "mode='hierarchy' requires full participation: "
                "sampling churns the region partition every round, "
                "re-striping every region ring — use "
                "mode='coordinator' for sampled rounds"
            )
        if secure_agg:
            raise ValueError(
                "mode='hierarchy' and secure_agg are mutually "
                "exclusive: pairwise masks only cancel over the FULL "
                "party set, so a region's partial sum would be "
                "un-finalizable ring noise — loud exclusion, never "
                "silent garbage"
            )
        if aggregator is not None:
            raise ValueError(
                "mode='hierarchy' and aggregator are mutually "
                "exclusive (a custom reducer needs the raw per-party "
                "values at one place)"
            )
    if region_size is not None and mode != "hierarchy":
        raise ValueError(
            "region_size only applies to mode='hierarchy' (it sets "
            "the deterministic region partition width)"
        )
    if region_branch is not None:
        if mode != "hierarchy":
            raise ValueError(
                "region_branch only applies to mode='hierarchy' (it "
                "sets the interior tree degree of the derived "
                "multi-level hierarchy)"
            )
        if int(region_branch) < 2:
            raise ValueError(
                f"region_branch must be >= 2 (a 1-ary interior level "
                f"folds nothing), got {region_branch!r}"
            )
    if region_quorum is not None:
        if mode != "hierarchy":
            raise ValueError(
                "region_quorum only applies to mode='hierarchy' (it "
                "sets the per-region minimum arrived count for the "
                "deadline-gated region cutoff)"
            )
        if int(region_quorum) < 1:
            raise ValueError(
                f"region_quorum must be >= 1 (the minimum arrived "
                f"member count per region), got {region_quorum!r}"
            )
    if region_deadline_s is not None:
        if region_quorum is None:
            raise ValueError(
                "region_deadline_s needs region_quorum= (the "
                "per-region minimum arrived count the deadline gates)"
            )
        if float(region_deadline_s) <= 0:
            raise ValueError(
                f"region_deadline_s must be positive, got "
                f"{region_deadline_s!r}"
            )
    if mode == "ring":
        if not (compress_wire and packed_wire):
            raise ValueError(
                "mode='ring' requires compress_wire=True and "
                "packed_wire=True (the striped unit is the packed wire "
                "buffer)"
            )
        if aggregator is not None:
            raise ValueError(
                "mode='ring' and aggregator are mutually exclusive (a "
                "custom reducer needs the raw per-party values at one "
                "place)"
            )
        if sample is not None and sample != len(trainers):
            raise ValueError(
                "mode='ring' requires full participation: sampling "
                "churns ring membership, re-striping the chunk grid "
                "and thrashing the per-peer delta caches every round — "
                "use mode='coordinator' for sampled rounds"
            )
        if streaming_agg:
            raise ValueError(
                "mode='ring' and streaming_agg are mutually exclusive: "
                "the ring replaces the hub topology streaming_agg "
                "folds on (the ring's fallback path streams on its "
                "own) — drop streaming_agg or use mode='coordinator'"
            )
    if coordinator is not None and coordinator not in trainers:
        raise ValueError(
            f"coordinator {coordinator!r} is not a training party "
            f"({sorted(trainers)})"
        )
    if ring_chunk_elems is not None and mode not in ("ring", "hierarchy"):
        raise ValueError(
            "ring_chunk_elems only applies to mode='ring' or "
            "mode='hierarchy' (it sets the stripe/chunk grid "
            "granularity)"
        )
    if quorum is not None:
        if not 1 <= int(quorum) <= len(trainers):
            raise ValueError(f"quorum must be in [1, {len(trainers)}], got {quorum}")
        if not (compress_wire and packed_wire):
            raise ValueError(
                "quorum requires compress_wire=True and packed_wire=True "
                "(the quorum cutoff and the DGA late fold run on the "
                "packed wire buffer)"
            )
        incompat = {
            "server_opt": legacy_opt is not None,
            "aggregator": aggregator is not None,
            "sample": sample is not None and sample != len(trainers),
            "error_feedback": error_feedback,
            "overlap": overlap,
        }
        bad = [k for k, v in incompat.items() if v]
        if bad:
            raise ValueError(
                f"quorum is incompatible with {bad}: each needs the "
                "exact fixed-roster synchronous round boundary that "
                "k-of-n cutoffs and elastic membership give up (packed "
                "fl.server_opt optimizers DO compose with quorum)"
            )
    if round_deadline_s is not None:
        if quorum is None:
            raise ValueError(
                "round_deadline_s only applies with quorum= (it is the "
                "straggler cutoff of k-of-n rounds)"
            )
        if not round_deadline_s > 0:
            raise ValueError(f"round_deadline_s must be > 0, got {round_deadline_s}")
    if join_ticket is not None and quorum is None:
        raise ValueError(
            "join_ticket only applies with quorum= (elastic membership "
            "rides the quorum round protocol)"
        )
    if round_log is not None and quorum is None:
        raise ValueError(
            "round_log only applies with quorum= (the classic loop has "
            "a fixed roster — there is nothing to log)"
        )
    if overlap:
        if not (compress_wire and packed_wire):
            raise ValueError(
                "overlap=True requires compress_wire=True and "
                "packed_wire=True (the overlapped aggregation unit is "
                "the packed wire buffer, and the DGA correction runs on "
                "it)"
            )
        if mode == "hierarchy":
            raise ValueError(
                "overlap=True is incompatible with mode='hierarchy' — "
                "the pipelined engine drives the coordinator/ring "
                "collectives from its comms lane; the hierarchy's "
                "region-cutoff/regroup protocol has no lane-callable "
                "collective yet (loud exclusion, never a silent flat "
                "fallback)"
            )
        if secure_agg:
            raise ValueError(
                "overlap=True is incompatible with secure_agg — "
                "pairwise masks are keyed by a synchronous (session, "
                "stream, round) tuple over the round's full roster; "
                "the pipelined lane's in-flight round would need a "
                "mask-recovery window that has never been exercised "
                "under overlap (loud exclusion)"
            )
        incompat = {
            "server_opt": legacy_opt is not None,
            "aggregator": aggregator is not None,
            "sample": sample is not None and sample != len(trainers),
            "error_feedback": error_feedback,
            "checkpointer": checkpointer is not None,
        }
        bad = [k for k, v in incompat.items() if v]
        if bad:
            raise ValueError(
                f"overlap=True is incompatible with {bad}: each needs "
                "the exact synchronous round boundary (the overlapped "
                "aggregate lands one round late, under the next round's "
                "compute)"
            )
    if packed_opt is not None:
        _check_packed_opt(trainers, compress_wire, packed_wire, error_feedback,
                          aggregator, secure_agg, sample)
    return {
        "wire_quant": qname,
        "checkpoint_every": checkpoint_every,
        "server_opt_kind": (
            "none" if server_opt is None
            else "packed" if packed_opt is not None
            else "fedopt"
        ),
    }


def _check_packed_opt(trainers, compress_wire, packed_wire, error_feedback,
                      aggregator, secure_agg, sample) -> None:
    """The JAX package's exclusions of a packed ``server_opt``."""
    if not (compress_wire and packed_wire):
        raise ValueError(
            "a packed server_opt (fl.server_opt) requires "
            "compress_wire=True and packed_wire=True — the fused "
            "step runs over the packed wire buffer"
        )
    incompat_s = {
        # Under a server step the broadcast already is the stepped model:
        # the outgoing-wire residual would correct the wrong model.
        "error_feedback": error_feedback,
        # A custom reducer's output is not the weighted mean the step
        # assumes.
        "aggregator": aggregator is not None,
        "secure_agg": secure_agg,
        "sample": sample is not None and sample != len(trainers),
    }
    bad_s = [k for k, v in incompat_s.items() if v]
    if bad_s:
        raise ValueError(
            f"packed server_opt is incompatible with {bad_s} — "
            f"loud exclusion (see fl.server_opt's composition "
            f"notes)"
        )


def run_fedavg_rounds(
    trainers: dict,
    params: Any,
    rounds: int,
    *,
    server_opt: Optional[Any] = None,
    weights: Optional[Sequence[float]] = None,
    compress_wire: bool = False,
    packed_wire: bool = False,
    checkpointer: Any = None,
    checkpoint_every: int = 0,
    on_round: Optional[Callable[[int, Any], None]] = None,
    sample: Optional[int] = None,
    sample_seed: int = 0,
    aggregator: Optional[Callable[[Sequence[Any]], Any]] = None,
    streaming_agg: bool = False,
    error_feedback: bool = False,
    wire_dtype: Any = None,
    wire_quant: Optional[Any] = None,
    mode: str = "coordinator",
    coordinator: Optional[str] = None,
    overlap: bool = False,
    timings: Optional[list] = None,
    ring_chunk_elems: Optional[int] = None,
    region_size: Optional[int] = None,
    region_branch: Optional[int] = None,
    region_quorum: Optional[int] = None,
    region_deadline_s: Optional[float] = None,
    quorum: Optional[int] = None,
    round_deadline_s: Optional[float] = None,
    join_ticket: Optional[dict] = None,
    round_log: Optional[list] = None,
    secure_agg: bool = False,
) -> Any:
    """Run ``rounds`` FedAvg rounds over party-pinned trainer actors.

    ``trainers``: ``{party: actor}`` where ``actor.train(params)`` returns
    the party's updated tree (each party's actor runs only on its own
    silo).  Every controller passes the identical arguments.

    - ``server_opt``: a packed :class:`~rayfed_tpu_torch.fl.server_opt.
      PackedServerOpt` (server momentum or FedAC over the packed buffer,
      stepped where the aggregate finalizes; composes with ``wire_quant``,
      ``quorum``, the ring, the hierarchy and ``overlap``), or a legacy
      :class:`~rayfed_tpu_torch.fl.fedopt.ServerOptimizer` applied to the
      round aggregate (plain replacement when ``None``).
    - ``compress_wire``: halves the push bytes.  Trainer contract:
      ``train`` calls :func:`~rayfed_tpu_torch.fl.decompress` on its
      argument and returns ``compress(updated)``.
    - ``packed_wire``: with ``compress_wire``, the packed single-buffer
      wire form (:class:`~rayfed_tpu_torch.fl.PackedTree`).
    - ``on_round(i, params)``: called after each materialized round.
    - ``sample``: a deterministic pseudo-random subset of ``sample``
      parties trains each round (seeded by ``(sample_seed, round)``).
    - ``aggregator(values) -> tree``: a custom reducer in place of the
      weighted mean (exclusive with ``weights``).
    - ``streaming_agg``: aggregate each round with
      :func:`~rayfed_tpu_torch.fl.streaming.streaming_aggregate`: the
      coordinator folds each arriving chunk on its card while later chunks
      are on the wire, and contributions and broadcasts ride per-peer
      delta streams.  Requires ``compress_wire`` + ``packed_wire``;
      byte-identical to the one-shot path.
    - ``error_feedback``: carry the wire cast error of the driver's
      outgoing compressed model into the next round
      (:class:`~rayfed_tpu_torch.fl.ErrorFeedback`).
    - ``wire_dtype``: the driver's outgoing wire dtype (default bf16).
    - ``wire_quant``: aggregate **in the compressed domain** (``"uint8"``
      or ``"int8"``; :mod:`rayfed_tpu_torch.fl.quantize`).  Each round
      every controller derives the same grid from the previous round's
      aggregate delta, contributions are coded as ``update − shared
      model`` on it with the grid codec's own error feedback (so
      ``error_feedback`` is excluded), the coordinator folds the codes in
      i32 and rescales once, and the broadcast is re-quantized on a fresh
      grid.  The first round has no observed delta and runs unquantized.
      Requires ``compress_wire``, ``packed_wire`` and ``streaming_agg``;
      integral non-negative ``weights`` only.
    - ``mode="ring"``: aggregate over the chunk-striped ring
      (:func:`~rayfed_tpu_torch.fl.ring.ring_aggregate`): per-party traffic
      ~2·|model| whatever the party count; a round the ring aborts falls
      back to the coordinator topology, in lockstep, with the same bytes.
      Requires ``compress_wire`` + ``packed_wire``, full participation and
      no ``streaming_agg``.  ``ring_chunk_elems`` sets the stripe grid.
    - ``mode="hierarchy"``: aggregate over the region tree
      (:func:`~rayfed_tpu_torch.fl.hierarchy.hierarchy_aggregate`): the
      sorted roster partitions into regions of ``region_size``, each
      region runs the stripe ring, region coordinators stream integer
      partial sums up to a root, which rescales once; the result equals the
      flat compressed-domain fold byte for byte.  Requires ``wire_quant``
      and ``region_size``; the first round (no grid yet) runs the flat
      streaming fold, and a round the tree aborts re-aggregates over it, in
      lockstep.  ``region_branch``: the interior degree (the tree recurses
      past it); ``region_quorum``/``region_deadline_s``: per-region cutoffs
      (a region folds its arrived members once the deadline passes).
    - ``overlap``: double-buffer the rounds
      (:class:`~rayfed_tpu_torch.fl.overlap.PipelinedRoundRunner`): round
      *k*'s push and aggregation run on a comms lane under round *k+1*'s
      local steps, with one round of staleness fixed by the DGA correction.
      Coordinator or ring mode, ``wire_quant`` included; requires
      ``compress_wire`` + ``packed_wire``; excludes ``mode="hierarchy"``,
      ``quorum``, ``sample``, ``aggregator``, ``error_feedback`` and a
      legacy ``server_opt``.
    - ``coordinator``: the party that anchors the rounds (default the
      ``min`` party); keep it stable across a run.  Under ``quorum`` it
      names the initial lease holder only.
    - ``quorum``: k-of-n rounds (:mod:`rayfed_tpu_torch.fl.quorum`): the
      round aggregates the arrived contributions once ``round_deadline_s``
      passes with at least ``quorum`` of them, stragglers fold their
      progress into the next round, the roster is elastic (``fed.join`` /
      ``fed.leave``) and the coordinator fails over.  ``join_ticket``: the
      welcome ``fed.join()`` returned; ``round_log``: a list receiving each
      round's roster, members and coordinator.
    - ``secure_agg``: secure aggregation (:mod:`rayfed_tpu_torch.fl.secagg`):
      each party's quantized contribution ships as ``w·q`` plus pairwise
      masks derived from the transport's HELLO key agreement, so the
      coordinator learns only the sum, and the finalized bytes equal the
      unmasked round's.  Requires ``wire_quant`` (with ``streaming_agg`` or
      ``quorum``, where a dropout triggers mask recovery); excludes
      ``mode="ring"``/``"hierarchy"``, ``overlap``, ``sample`` and a packed
      ``server_opt``.  The first round (no grid yet) runs unquantized and
      unmasked.
    - ``timings``: a list receiving one ``{"local_s", "push_s", "agg_s",
      "hidden_s"}`` dict per round (seconds; materializes every round).

    Without a server optimizer the rounds **pipeline**: the averaged model
    flows into the next round as a lazy ``FedObject`` and only the final
    round materializes.  Returns the final global params (identical on
    every controller).
    """
    cfg = validate_round_config(
        trainers,
        rounds=rounds, server_opt=server_opt, weights=weights,
        compress_wire=compress_wire, packed_wire=packed_wire,
        checkpointer=checkpointer, checkpoint_every=checkpoint_every,
        sample=sample, aggregator=aggregator, streaming_agg=streaming_agg,
        error_feedback=error_feedback, wire_quant=wire_quant, mode=mode,
        coordinator=coordinator, overlap=overlap,
        ring_chunk_elems=ring_chunk_elems, region_size=region_size,
        region_branch=region_branch, region_quorum=region_quorum,
        region_deadline_s=region_deadline_s, quorum=quorum,
        round_deadline_s=round_deadline_s, join_ticket=join_ticket,
        round_log=round_log, secure_agg=secure_agg,
    )
    legacy_opt = server_opt if cfg["server_opt_kind"] == "fedopt" else None
    packed_opt = server_opt if cfg["server_opt_kind"] == "packed" else None
    # The coordinator stays the same for the whole run: every delta-stream
    # cache is keyed by its destination party.
    coord = coordinator if coordinator is not None else min(trainers)
    wire_dt = torch.bfloat16 if wire_dtype is None else wire_dtype

    if quorum is not None:
        # k-of-n rounds with elastic membership own their loop shape
        # (roster-driven active set, DGA late folds, round-index-derived
        # rendezvous keys) — see fl/quorum.py.
        from rayfed_tpu_torch.fl.quorum import run_quorum_rounds

        return run_quorum_rounds(
            trainers, params, rounds,
            quorum=int(quorum), round_deadline_s=round_deadline_s,
            weights=weights, coordinator=coord, wire_dtype=wire_dt,
            mode=mode, ring_chunk_elems=ring_chunk_elems, on_round=on_round,
            timings=timings, join_ticket=join_ticket, round_log=round_log,
            wire_quant=cfg["wire_quant"], region_size=region_size,
            region_branch=region_branch, region_quorum=region_quorum,
            region_deadline_s=region_deadline_s, server_opt=packed_opt,
            secure_agg=secure_agg, checkpointer=checkpointer,
            checkpoint_every=cfg["checkpoint_every"],
        )

    from rayfed_tpu_torch.fl.server_opt import (
        PackedServerOptimizer,
        check_snapshot_server_opt,
        describe_server_opt,
    )
    from rayfed_tpu_torch.runtime import get_runtime

    # The replicated state lives on the party's card (its device).
    sopt = (
        PackedServerOptimizer(packed_opt, device=get_runtime().transport.device)
        if packed_opt is not None else None
    )

    if overlap:
        # The pipelined engine owns its loop shape (double-buffered rounds,
        # the DGA correction, the comms lane) — see fl/overlap.py.
        from rayfed_tpu_torch.fl.overlap import PipelinedRoundRunner

        runner = PipelinedRoundRunner(
            trainers, weights=weights, mode=mode, coordinator=coord, wire_dtype=wire_dt,
            on_round=on_round, ring_chunk_elems=ring_chunk_elems, wire_quant=cfg["wire_quant"],
            server_opt=sopt,
        )
        return runner.run(params, rounds, timings=timings)

    from rayfed_tpu_torch import telemetry as _telemetry
    from rayfed_tpu_torch.fed_object import FedObject

    state = legacy_opt.init(params) if legacy_opt is not None else None
    checkpoint_every = cfg["checkpoint_every"]
    # The checkpoint stamp of this run's server-opt config: every snapshot
    # carries it, and a restore across differing configs is refused (a
    # silent momentum reset changes the trajectory without failing).
    sopt_descr = describe_server_opt(server_opt)
    start_round = 0
    # Where the next round's driver span opens, when a restore or a snapshot
    # opens the round: the flight recorder tags both with that round's
    # number, so the round's span covers them.
    span_open = None
    if checkpointer is not None and checkpointer.latest_round() is not None:
        span_open = (time.perf_counter(), time.time())
        check_snapshot_server_opt(checkpointer.load_metadata().get("server_opt"), sopt_descr)
        target = {"params": params}
        if state is not None:
            target["server_state"] = state
        if sopt is not None:
            target["server_state"] = packed_opt.init(pack_tree(params, torch.float32).buf)
        # Onto the party's card (the checkpointer's default device).
        restored_round, snap = checkpointer.restore(target=target)
        params = snap["params"]
        if state is not None:
            state = snap["server_state"]
        if sopt is not None:
            sopt.load_state(snap["server_state"])
        start_round = restored_round
        if start_round >= rounds:
            return params
    qname = cfg["wire_quant"]
    # Compressed-domain state: the previous round's aggregate delta, from
    # broadcast values only (so equal on every controller); None until one
    # round has been observed, so the first round runs unquantized.
    quant_prev_delta = None

    # Pipelined mode only when nothing needs the materialized value each
    # round.
    pipeline = (
        server_opt is None
        and on_round is None
        and not checkpoint_every
        and aggregator is None  # a reducer needs the raw values
        and not streaming_agg  # streaming materializes at the reducer
        and not error_feedback  # the residual needs the driver's tree
        and mode == "coordinator"  # the ring assembles (materializes) per round
        and timings is None  # per-round timing needs a round boundary
        and len(trainers) > 1
    )
    ef = ErrorFeedback(wire_dt) if error_feedback else None
    parties = list(trainers)

    def round_parties(r: int):
        if sample is None or sample == len(parties):
            return parties
        return sample_parties(parties, int(sample), sample_seed, r)

    current: Any = params  # tree, or FedObject in pipelined rounds
    me = None
    # Flight recorder: armed, every materialized round emits a driver
    # span carrying the round key the transport stamps on frames.
    trace_rounds = _telemetry.armed() and not pipeline
    if timings is not None or trace_rounds or secure_agg:
        me = get_runtime().party
    if secure_agg:
        _rt = get_runtime()
        _transport = _rt.transport
        sa_keys = getattr(_transport, "secagg_keys", None)
        if sa_keys is None or not hasattr(_transport, "ensure_secagg_peer_keys"):
            raise ValueError(
                "secure_agg needs the transport key-agreement plane "
                "(TransportManager.secagg_keys) — this transport has "
                "none"
            )
        # One HELLO ping per missing pair, before the first masked round.
        _transport.ensure_secagg_peer_keys(parties)
        # A fresh mask-seed scope per run, drawn identically on every
        # controller: a (session, stream, round) seed reused over other
        # data would be a two-time pad.
        sa_session = str(_rt.next_seq_id())

    for r in range(start_round, rounds):
        active = round_parties(r)
        # A driver-held tree is compressed before the push (with the
        # carried error-feedback residual, when enabled); a lazy FedObject
        # from a pipelined round is already the trainers' wire form.
        if compress_wire and not isinstance(current, FedObject):
            outgoing = (
                ef.compress(current)
                if ef is not None
                else compress(current, packed=packed_wire, wire_dtype=wire_dt)
            )
        else:
            outgoing = current
        rec = None
        if timings is not None or trace_rounds:
            rec = {"local_s": 0.0, "push_s": 0.0, "agg_s": 0.0, "hidden_s": 0.0}
            t_r0 = time.perf_counter()
            t_r0_wall = time.time()
        updates = [trainers[p].train.remote(outgoing) for p in active]
        if rec is not None and me in active:
            my_ref = updates[active.index(me)].get_local_ref()
            if my_ref is not None:
                my_ref.add_done_callback(
                    lambda _ref, rec=rec, t0=t_r0: rec.__setitem__(
                        "local_s", time.perf_counter() - t0
                    )
                )
        if pipeline:
            last = r == rounds - 1
            current = aggregate(
                updates, weights, mode="coordinator", coordinator=coord,
                materialize=last,
            )
            if last and compress_wire:
                current = decompress(current)
            continue

        # With error feedback (or a server optimizer) the aggregate comes
        # back in f32: casting the mean to the wire dtype here would
        # re-quantize it with no residual to compensate.
        agg_out_dtype = (
            "float32" if (error_feedback or server_opt is not None) else None
        )
        # Compressed-domain round: updates are coded as deltas against the
        # round's shared starting model (`current`, the same bytes on every
        # controller) on a grid ranged by the previous round's delta.
        round_grid = None
        round_ref = None
        if qname is not None:
            round_ref = pack_tree(current, torch.float32).buf
            if quant_prev_delta is not None:
                round_grid = make_round_grid(
                    quant_prev_delta, wire_dtype=qname, mode="delta",
                    # The grid chunking IS the ring's stripe chunking, or
                    # ring_aggregate's chunk-match guard would abort (and
                    # fall back) every quantized ring round.
                    chunk_elems=ring_chunk_elems if mode in ("ring", "hierarchy") else None,
                    expand=QUANT_DELTA_EXPAND,
                )
        # Packed server optimization: the round's shared starting buffer
        # anchors the step (at the finalizing node, or on every controller
        # for the ring and the one-shot path) and the resync below.
        step_fn = None
        x_srv = None
        if sopt is not None:
            x_srv = round_ref if round_ref is not None else pack_tree(current, torch.float32).buf
            sopt.ensure(x_srv)
            step_fn = sopt.step_fn(x_srv)
        # Secure aggregation: this party's round masker (pairwise seeds
        # toward every active peer, at its own fold weight); the keystream
        # expands on a background thread under the local step.  The first
        # round (no grid) runs unmasked.
        round_masker = None
        if secure_agg and round_grid is not None and me in trainers:
            from rayfed_tpu_torch.fl import secagg as _sa
            from rayfed_tpu_torch.fl.fedavg import quant_weights

            _iw, _ = quant_weights(None if weights is None else [float(w) for w in weights], len(active))
            round_masker = _sa.RoundMasker(
                sa_keys, me, [p for p in active if p != me],
                session=sa_session, stream="fedavg", round_index=r,
                weight=_iw[active.index(me)],
            )
            round_masker.prefetch(round_grid.total_elems)
        if mode == "hierarchy":
            from rayfed_tpu_torch.fl.streaming import streaming_aggregate

            if round_grid is None:
                # The first round has no grid and the hierarchy is
                # compressed-domain only: the flat streaming round, as the
                # quantized loop's own first round.
                avg = streaming_aggregate(
                    updates, weights, stream="fedavg", coordinator=coord,
                    out_dtype=agg_out_dtype, timings=rec, server_step=step_fn,
                )
            else:
                from rayfed_tpu_torch.fl.hierarchy import HIER_STATS, HierarchyRoundError, hierarchy_aggregate

                try:
                    avg = hierarchy_aggregate(
                        updates, weights, region_size=int(region_size), region_branch=region_branch,
                        region_quorum=region_quorum, region_deadline_s=region_deadline_s,
                        stream="fedavg", quant=round_grid, quant_ref=round_ref, quant_scope="fedavg",
                        # The broadcast down the tree is quantized too.
                        quant_downlink=True, round_tag=r, timings=rec, server_step=step_fn,
                    )
                except HierarchyRoundError as e:
                    # The abort reached every controller (poison cascade and
                    # commit/release), so all of them take this branch in
                    # lockstep: the same round's updates re-aggregate over
                    # the flat streaming fold, with the same grid and the
                    # same uncommitted residual.
                    logger.warning(
                        "hierarchy round %d aborted (%s); falling back to flat "
                        "streaming aggregation at %r", r, e, coord,
                    )
                    HIER_STATS["fallback_rounds"] += 1
                    # No resync happened: the same step from the same state.
                    avg = streaming_aggregate(
                        updates, weights, stream="fedavg", coordinator=coord, timings=rec,
                        quant=round_grid, quant_ref=round_ref, quant_scope="fedavg",
                        server_step=step_fn,
                    )
        elif mode == "ring":
            from rayfed_tpu_torch.fl.ring import RING_STATS, RingRoundError, ring_aggregate

            try:
                avg = ring_aggregate(
                    updates, weights, stream="fedavg", out_dtype=agg_out_dtype,
                    chunk_elems=ring_chunk_elems, timings=rec,
                    quant=round_grid, quant_ref=round_ref, quant_scope="fedavg",
                )
                if step_fn is not None:
                    # No downlink: every controller holds the same
                    # assembled aggregate and steps it locally.
                    avg = step_fn(avg)
            except RingRoundError as e:
                # The abort reached every controller (poison cascade +
                # commit ring), so all of them take this branch in
                # lockstep: the same round's updates re-aggregate over the
                # coordinator topology, with the same grid and the same
                # uncommitted residual.
                from rayfed_tpu_torch.fl.streaming import streaming_aggregate

                logger.warning(
                    "ring round %d aborted (%s); falling back to coordinator "
                    "aggregation at %r", r, e, coord,
                )
                RING_STATS["fallback_rounds"] += 1
                avg = streaming_aggregate(
                    updates, weights, stream="fedavg", coordinator=coord,
                    out_dtype=agg_out_dtype, timings=rec,
                    quant=round_grid, quant_ref=round_ref, quant_scope="fedavg",
                    server_step=step_fn,
                )
        elif streaming_agg:
            from rayfed_tpu_torch.fl.streaming import streaming_aggregate

            avg = streaming_aggregate(
                updates, weights, stream="fedavg", coordinator=coord,
                out_dtype=agg_out_dtype, timings=rec,
                quant=round_grid, quant_ref=round_ref, quant_scope="fedavg",
                quant_downlink=round_grid is not None, secagg=round_masker,
                server_step=step_fn,
            )
        else:
            t_a0 = time.perf_counter() if rec is not None else 0.0
            avg = aggregate(updates, weights, reducer=aggregator, coordinator=coord)
            if step_fn is not None:
                avg = step_fn(avg)
            if rec is not None:
                rec["agg_s"] = time.perf_counter() - t_a0
        if sopt is not None:
            # Every controller advances its replica from the broadcast
            # pair, which all of them hold byte for byte.
            sopt.resync(x_srv, avg.buf)
        if qname is not None:
            # How far the global model moved (after the server step), per
            # element: next round's grid covers that range.
            quant_prev_delta = _host_f32(avg.buf) - _host_f32(round_ref)
        if compress_wire:
            avg = decompress(avg)
        if legacy_opt is not None:
            current, state = legacy_opt.apply(current, avg, state)
        else:
            current = avg
        if on_round is not None:
            on_round(r, current)
        t_open = None
        if checkpoint_every and (r + 1) % checkpoint_every == 0:
            snap = {"params": current}
            if state is not None:
                snap["server_state"] = state
            if sopt is not None:
                snap["server_state"] = sopt.state
            t_open = (time.perf_counter(), time.time())
            checkpointer.save(r + 1, snap, metadata={"server_opt": sopt_descr})
        if rec is not None:
            # The aggregation call blocks on this party's own training
            # output before any byte can move, so its walls include the
            # local wait — subtract it to report the comms-only window.
            rec["push_s"] = max(0.0, rec["push_s"] - rec["local_s"])
            rec["agg_s"] = max(0.0, rec["agg_s"] - rec["local_s"])
            rec["round"] = r
            rec["epoch"] = None
            rec["coordinator"] = coord
            if timings is not None:
                timings.append(rec)
            if trace_rounds:
                t0, t0_wall = span_open or (t_r0, t_r0_wall)
                _telemetry.emit(
                    "driver.round", round=r, party=me, peer=coord,
                    t_start=t0_wall, dur_s=time.perf_counter() - t0,
                    detail={
                        k: (round(v, 6) if isinstance(v, float) else v)
                        for k, v in rec.items()
                    },
                )
            logger.debug(
                "round %d timings: local=%.3fs push=%.3fs agg=%.3fs hidden=%.3fs",
                r, rec["local_s"], rec["push_s"], rec["agg_s"], rec["hidden_s"],
            )
        span_open = t_open

    return current
