"""Pipelined federated rounds: hide cross-party aggregation under compute.

The synchronous round loop serializes its two expensive phases: every
party finishes its local steps, pushes its update, then idles until the
aggregate comes back, so a round takes ``compute + comms`` although the two
use disjoint resources (the card and the wire).

:class:`PipelinedRoundRunner` removes that with one round of bounded
staleness (delayed-gradient averaging): after computing its round-*k*
model, each party hands the push and aggregation of round *k* to a
**comms lane** (:class:`rayfed_tpu_torch.executor.CommsLane`) and starts
round *k+1*'s local steps from its locally updated model at once.  When the
round-*k* aggregate lands, the party folds it in with the DGA correction::

    w  ←  agg_k + (w_local − w_local_at_send)

:func:`dga_correct`: the delayed global average replaces the stale local
base while the local progress made meanwhile is kept.  A round then takes
``max(compute, comms)`` plus the correction.

Every controller runs the same main-thread program (train → correct → hand
off), so the fed seq-id streams stay aligned; the lane never allocates seq
ids: each round's aggregation ids are drawn on the main thread in program
order and passed in (``seq_ids=``).  Every frame carries its round
(``wire.ROUND_TAG_KEY``).  A ring round that aborts is re-aggregated, same
round and same contributions, over the coordinator topology before the
runner moves on (every controller sees the abort, so all take the fallback
together); a coordinator-mode failure raises on every controller.

``wire_quant`` composes through the unified staleness recurrence: round
*k*'s corrected contribution ``c_p = b_{k−1} + (u_p − c_p^prev)`` differs
from the round's shared reference ``b_{k−1}`` (the previous broadcast) by
the party's local displacement over one round, the quantity the delta grid
is ranged for; :func:`dga_correct` computes in f32 and casts once, so
coding the corrected contribution codes that displacement.  Round 0 runs
unquantized (nothing observed yet), later rounds on a grid from the
previous broadcast's delta, as the synchronous quantized loop.

A packed server optimizer composes the same way: the broadcast is
``b_k = step(x_k, m_k)`` with ``m_k`` the round's mean, and anchoring the
correction on that post-step broadcast gives ``m_k − b_{k−1} = mean_p u_p −
m_{k−1}``, so the step's pseudo-gradient is the mean local displacement one
round stale.  The runner hands the step to the collective (the coordinator
steps once; on the ring every controller steps the same assembly) and
resyncs the replicated state from each landed broadcast pair
(:mod:`rayfed_tpu_torch.fl.server_opt`).

``dga_correct`` is also the quorum loop's late fold of a straggler's missed
round (:mod:`rayfed_tpu_torch.fl.quorum`).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from rayfed_tpu_torch.fl import fedavg
from rayfed_tpu_torch.fl.compression import PackedTree, torch_dtype

logger = logging.getLogger(__name__)


def dga_correct(agg: Any, cur: Any, base: Any) -> PackedTree:
    """``agg + (cur − base)`` on PackedTrees — the DGA staleness fix.

    ``agg`` is the delayed round aggregate, ``cur`` the party's current
    local model, ``base`` the local model its contribution was trained
    from.  The three buffers convert to f32, the sum runs as the JAX
    package's program computes it (``(agg + cur) − base``, two rounded f32
    ops: there is no product to contract) and casts once to ``cur``'s wire
    dtype, on ``cur``'s device.  Non-float (passthrough) leaves get the same
    elementwise recurrence.
    """
    for name, tree in (("agg", agg), ("cur", cur), ("base", base)):
        if not isinstance(tree, PackedTree):
            raise TypeError(
                f"dga_correct consumes PackedTrees; {name} is "
                f"{type(tree).__name__} — trainers must return "
                "fl.compress(updated, packed=True)"
            )
    if cur.spec != base.spec:
        raise ValueError(
            "dga_correct: cur/base pack specs differ — the trainer "
            "changed its tree structure mid-run"
        )
    if agg.spec.entries != cur.spec.entries or agg.spec.treedef != cur.spec.treedef:
        raise ValueError(
            "dga_correct: aggregate pack spec differs from the local "
            "model's — all parties must pack the identical structure"
        )
    device = fedavg._fold_device([cur.buf, agg.buf, base.buf])

    def f32(buf):
        return fedavg.as_tensor(buf, device).to(torch.float32)

    buf = (f32(agg.buf) + f32(cur.buf) - f32(base.buf)).to(torch_dtype(cur.spec.wire_dtype))
    passthrough = tuple(
        a + (c - b) for a, c, b in zip(agg.passthrough, cur.passthrough, base.passthrough)
    )
    return PackedTree(buf, passthrough, cur.spec)




class _InFlight:
    """One round's aggregation handed to the comms lane."""

    __slots__ = ("round_index", "ref", "rec")

    def __init__(self, round_index: int, ref: Any, rec: Dict[str, float]):
        self.round_index = round_index
        self.ref = ref
        self.rec = rec


class PipelinedRoundRunner:
    """Double-buffered FedAvg rounds: round *k*'s comms under round *k+1*'s
    compute.

    ``trainers``/``weights``/``mode``/``coordinator`` as in
    :func:`rayfed_tpu_torch.fl.run_fedavg_rounds`; the trainers follow the
    packed wire contract (``train`` decompresses its argument and returns
    ``fl.compress(updated, packed=True)``).  ``mode="coordinator"``
    aggregates each round with
    :func:`~rayfed_tpu_torch.fl.streaming.streaming_aggregate`,
    ``mode="ring"`` with :func:`~rayfed_tpu_torch.fl.ring.ring_aggregate`
    (falling back to the coordinator topology for a round the ring aborts);
    both fold on the runtime's device.  ``wire_quant``: ``"uint8"`` or
    ``"int8"``, compressed-domain rounds as in the synchronous loop (module
    docstring).  ``server_opt``: a packed
    :class:`~rayfed_tpu_torch.fl.server_opt.PackedServerOptimizer` (or its
    bare spec), stepping each round's mean (module docstring).

    Every controller constructs the runner with the same arguments and
    calls :meth:`run` at the same program point.
    """

    def __init__(
        self,
        trainers: Dict[str, Any],
        *,
        weights: Optional[Sequence[float]] = None,
        mode: str = "coordinator",
        coordinator: Optional[str] = None,
        wire_dtype: Any = None,
        stream: str = "fedavg",
        on_round: Optional[Callable[[int, Any], None]] = None,
        ring_chunk_elems: Optional[int] = None,
        wire_quant: Optional[str] = None,
        server_opt: Any = None,
    ) -> None:
        if not trainers:
            raise ValueError("PipelinedRoundRunner needs trainers")
        if mode not in ("coordinator", "ring"):
            raise ValueError(f"unknown mode {mode!r}: expected 'coordinator' or 'ring'")
        if weights is not None and len(weights) != len(trainers):
            raise ValueError(f"{len(weights)} weights for {len(trainers)} trainers")
        if coordinator is not None and coordinator not in trainers:
            raise ValueError(
                f"coordinator {coordinator!r} is not a training party ({sorted(trainers)})"
            )
        if server_opt is not None and not hasattr(server_opt, "step_fn"):
            # A bare packed spec from a direct caller: wrap it as
            # run_fedavg_rounds does.
            from rayfed_tpu_torch.fl.server_opt import PackedServerOptimizer

            server_opt = PackedServerOptimizer(server_opt)
        self._sopt = server_opt
        self._trainers = trainers
        self._weights = None if weights is None else [float(w) for w in weights]
        self._mode = mode
        self._coord = coordinator if coordinator is not None else min(trainers)
        self._wire_dtype = torch.bfloat16 if wire_dtype is None else wire_dtype
        self._stream = stream
        self._on_round = on_round
        self._ring_chunk_elems = ring_chunk_elems
        self._wire_quant = None if wire_quant is None else str(wire_quant)
        # The local controller's party, set by run(); stamps the flight
        # recorder's driver.round / overlap.hidden spans.
        self._me: Optional[str] = None

    # -- lane side: one round's push + aggregate (+ fallback) ------------------

    def _aggregate_round(self, r: int, objs: List[Any], seq_ids: Sequence[int],
                         fallback_ids: Sequence[int], rec: Dict[str, float],
                         grid: Any = None, ref: Any = None,
                         step_fn: Optional[Callable[[Any], Any]] = None) -> Any:
        from rayfed_tpu_torch.fl.ring import RING_STATS, RingRoundError, ring_aggregate
        from rayfed_tpu_torch.fl.streaming import streaming_aggregate

        scope = self._stream if grid is not None else None
        # Under a server step the aggregate comes back in f32 (quantized
        # rounds finalize in f32 already).
        out_dtype = "float32" if step_fn is not None else None
        t0 = time.perf_counter()
        try:
            if self._mode != "ring":
                # No fallback on the coordinator topology: a rerun over the
                # same topology with the same contributions would fail the
                # same way, and the error reaches every controller.
                return streaming_aggregate(
                    objs, self._weights, stream=self._stream, coordinator=self._coord,
                    seq_ids=seq_ids, round_tag=r, timings=rec, out_dtype=out_dtype,
                    quant=grid, quant_ref=ref, quant_scope=scope,
                    # The broadcast is quantized too, as in the synchronous loop.
                    quant_downlink=grid is not None, server_step=step_fn,
                )
            try:
                agg = ring_aggregate(
                    objs, self._weights, stream=self._stream, chunk_elems=self._ring_chunk_elems,
                    seq_ids=seq_ids, round_tag=r, timings=rec, out_dtype=out_dtype,
                    quant=grid, quant_ref=ref, quant_scope=scope,
                )
                if step_fn is not None:
                    # No downlink: every controller steps the same assembly.
                    agg = step_fn(agg)
                return agg
            except RingRoundError as exc:
                # The abort reached every controller (poison cascade and
                # commit ring), so all take this branch together: the same
                # round's contributions re-aggregate over the coordinator
                # topology, on the same grid with the same uncommitted
                # residual (the downlink stays plain on this recovery path),
                # and the same step from the same, never resynced, state.
                logger.warning(
                    "pipelined round %d ring aggregation failed (%s); "
                    "re-aggregating the same round synchronously over "
                    "the coordinator topology at %r", r, exc, self._coord,
                )
                RING_STATS["fallback_rounds"] += 1
                return streaming_aggregate(
                    objs, self._weights, stream=self._stream, coordinator=self._coord,
                    seq_ids=fallback_ids, round_tag=r, timings=rec, out_dtype=out_dtype,
                    quant=grid, quant_ref=ref, quant_scope=scope, server_step=step_fn,
                )
        finally:
            # The raw lane window; _collect turns it into the comms wall.
            rec["_lane_t0"] = t0
            rec["_lane_t1"] = time.perf_counter()

    # -- main-thread driver ---------------------------------------------------

    def _alloc_ids(self, runtime) -> tuple:
        """The round's aggregation seq ids, in main-thread program order:
        the mode's collective's and the fallback's, drawn whatever is used
        so every controller's counter advances alike."""
        from rayfed_tpu_torch.fl.ring import RING_SEQ_IDS
        from rayfed_tpu_torch.fl.streaming import STREAM_AGG_SEQ_IDS

        n = RING_SEQ_IDS if self._mode == "ring" else STREAM_AGG_SEQ_IDS
        primary = tuple(runtime.next_seq_id() for _ in range(n))
        fallback = tuple(runtime.next_seq_id() for _ in range(STREAM_AGG_SEQ_IDS))
        return primary, fallback

    def _collect(self, inflight: _InFlight, backstop: float,
                 next_u_done: Optional[Dict[str, Any]] = None) -> Any:
        """Block until the in-flight round's aggregate lands and rewrite its
        record with the comms wall: from this party's contribution being
        ready to the aggregate landing (the collective's own walls include
        the wait for the local contribution).  ``hidden_s`` is the part of
        that window the next round's local train covered (``next_u_done``
        holds its end)."""
        agg = inflight.ref.resolve(timeout=backstop)
        rec = inflight.rec
        t_round0 = rec.pop("_t0", None)
        lane_t0 = rec.pop("_lane_t0", None)
        lane_t1 = rec.pop("_lane_t1", None)
        start = None
        if lane_t0 is not None and lane_t1 is not None:
            ready = (
                t_round0 + rec["local_s"]
                if t_round0 is not None and rec["local_s"] > 0.0
                else lane_t0
            )
            start = max(ready, lane_t0)
            # Anchor the collective's walls on the lane's end, so a fallback
            # that overwrote the record stays right.
            t_call0 = lane_t1 - rec["agg_s"] if rec["agg_s"] > 0.0 else start
            rec["push_s"] = max(0.0, t_call0 + rec["push_s"] - start)
            rec["agg_s"] = max(0.0, lane_t1 - start)
            if next_u_done is not None:
                done = next_u_done.get("t")
                end_hidden = lane_t1 if done is None else min(lane_t1, done)
                rec["hidden_s"] = min(max(0.0, end_hidden - start), rec["agg_s"])
        logger.debug(
            "round %d timings: local=%.3fs push=%.3fs agg=%.3fs hidden=%.3fs",
            inflight.round_index, rec.get("local_s", 0.0), rec.get("push_s", 0.0),
            rec.get("agg_s", 0.0), rec["hidden_s"],
        )
        from rayfed_tpu_torch import telemetry as _telemetry

        _tr = _telemetry.active()
        if _tr is not None and lane_t1 is not None:
            now_p, now_w = time.perf_counter(), time.time()
            anchor = t_round0 if t_round0 is not None else lane_t0
            _tr.emit(
                "driver.round", round=inflight.round_index, party=self._me, peer=self._coord,
                t_start=now_w - (now_p - anchor), dur_s=max(0.0, lane_t1 - anchor),
                detail={k: (round(v, 6) if isinstance(v, float) else v) for k, v in rec.items()},
            )
            if start is not None and rec["hidden_s"] > 0.0:
                _tr.emit(
                    "overlap.hidden", round=inflight.round_index, party=self._me,
                    t_start=now_w - (now_p - start), dur_s=rec["hidden_s"],
                    detail={"agg_s": round(rec["agg_s"], 6)},
                )
        return agg

    def run(self, params: Any, rounds: int, *,
            timings: Optional[List[Dict[str, float]]] = None) -> Any:
        """Run ``rounds`` pipelined rounds from ``params``; returns the final
        global params (a decompressed tree, the same on every controller).

        ``timings``: a list receiving one ``{"local_s", "push_s", "agg_s",
        "hidden_s"}`` dict per round.
        """
        if rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {rounds}")
        import rayfed_tpu_torch as fed
        from rayfed_tpu_torch.executor import CommsLane
        from rayfed_tpu_torch.fl import quantize as qz
        from rayfed_tpu_torch.fl.compression import compress, decompress, pack_tree
        from rayfed_tpu_torch.runtime import get_runtime

        runtime = get_runtime()
        me = runtime.party
        self._me = me
        backstop = runtime.job_config.recv_backstop_s
        parties = list(self._trainers)
        outgoing = compress(params, packed=True, wire_dtype=self._wire_dtype)
        # Compressed-domain and server-opt state: ``round_base`` is the f32
        # reference every controller holds for the round about to be
        # submitted (round 0: the packed init; later: the latest landed
        # broadcast), ``inflight_base`` the in-flight round's (its step and
        # its resync when it lands), and ``prev_delta`` how far the last
        # landed round moved the model (after the server step).
        sopt = self._sopt
        use_quant = self._wire_quant is not None
        round_base = (
            pack_tree(params, torch.float32).buf if use_quant or sopt is not None else None
        )
        inflight_base = None
        prev_delta = None
        lane = CommsLane(name=f"rayfed-comms-{me}", bind_runtime_fn=runtime._bind_to_current_thread)
        try:
            inputs: Dict[str, Any] = {p: outgoing for p in parties}
            prev_contribs: Optional[Dict[str, Any]] = None
            inflight: Optional[_InFlight] = None
            for r in range(rounds):
                rec: Dict[str, Any] = {
                    "local_s": 0.0, "push_s": 0.0, "agg_s": 0.0, "hidden_s": 0.0,
                    # The keys the transport stamps on every frame (no
                    # roster epoch here).
                    "round": r, "epoch": None, "coordinator": self._coord,
                }
                t_r0 = time.perf_counter()
                rec["_t0"] = t_r0  # popped by _collect
                # Round r's local steps, each party from its own model (round
                # 0: the shared init; later: its corrected model): no wire
                # traffic, no barrier.
                u = {p: self._trainers[p].train.remote(inputs[p]) for p in parties}
                u_done: Optional[Dict[str, Any]] = None
                if me in u:
                    u_ref = u[me].get_local_ref()
                    if u_ref is not None:
                        u_done = {"t": None}
                        u_ref.add_done_callback(
                            lambda _ref, d=u_done: d.__setitem__("t", time.perf_counter())
                        )
                if inflight is None:
                    contribs = u  # round 0: the raw local models
                else:
                    # Round r−1's aggregate lands (usually already done, under
                    # round r's compute); the DGA correction runs as a
                    # party-local task chained on round r's train output.
                    agg_prev = self._collect(inflight, backstop, u_done)
                    if use_quant or sopt is not None:
                        new_base = fedavg.as_tensor(agg_prev.buf).to(torch.float32)
                        if sopt is not None:
                            # Every replica advances from the landed
                            # round's broadcast pair.
                            sopt.resync(inflight_base, agg_prev.buf)
                        if use_quant:
                            prev_delta = qz._host_f32(new_base) - qz._host_f32(round_base)
                        round_base = new_base
                    if self._on_round is not None:
                        self._on_round(inflight.round_index, decompress(agg_prev))
                    contribs = {
                        p: fed.remote(dga_correct).party(p).remote(agg_prev, u[p], prev_contribs[p])
                        for p in parties
                    }
                if me in contribs:
                    local_ref = contribs[me].get_local_ref()
                    if local_ref is not None:
                        local_ref.add_done_callback(
                            lambda _ref, rec=rec, t0=t_r0: rec.__setitem__("local_s", time.perf_counter() - t0)
                        )
                # Round r's grid, from broadcast values only (the same on
                # every controller); round 0 has none and runs unquantized.
                round_grid = None
                if use_quant and prev_delta is not None:
                    round_grid = qz.make_round_grid(
                        prev_delta, wire_dtype=self._wire_quant, mode="delta",
                        # The grid chunking is the ring's stripe chunking.
                        chunk_elems=self._ring_chunk_elems if self._mode == "ring" else None,
                        expand=qz.QUANT_DELTA_EXPAND,
                    )
                step_fn = None
                if sopt is not None:
                    sopt.ensure(round_base)
                    step_fn = sopt.step_fn(round_base)
                inflight_base = round_base
                seq_ids, fallback_ids = self._alloc_ids(runtime)
                inflight = _InFlight(
                    r,
                    lane.submit(
                        self._aggregate_round, r, list(contribs.values()), seq_ids, fallback_ids,
                        rec, round_grid, round_base if use_quant else None, step_fn,
                    ),
                    rec,
                )
                if timings is not None:
                    timings.append(rec)
                # Round r+1 trains from the corrected round-r model, which is
                # the round-r contribution.
                prev_contribs = contribs
                inputs = contribs
            final = self._collect(inflight, backstop)
            if self._on_round is not None:
                self._on_round(rounds - 1, decompress(final))
            return decompress(final)
        finally:
            lane.shutdown(wait=False)
