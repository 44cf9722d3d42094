"""Chunk-striped ring aggregation: reduce-scatter + all-gather FedAvg.

The coordinator topology (:func:`~rayfed_tpu_torch.fl.streaming.
streaming_aggregate`) funnels every contribution into one party: the
coordinator moves ``2·(N-1)·|model|`` bytes per round while every other
party moves ``~|model|``.  Here the round is a **reduce-scatter followed by
an all-gather** over the sorted party ring:

1. **Stripe layout.**  The packed buffer's canonical chunk grid
   (:func:`~rayfed_tpu_torch.fl.fedavg.packed_block_grid`) is striped
   round-robin across the N ring parties
   (:func:`~rayfed_tpu_torch.fl.fedavg.packed_stripe_schedule`): block
   ``b`` belongs to stripe ``b % N``, stripe ``k`` is owned by the ring's
   ``k``-th party.  Every party derives the schedule from the same
   constants — a cross-party contract, like the wire format.
2. **Reduce-scatter.**  Every party slices its packed contribution into
   per-stripe compacted payloads and pushes each to that stripe's owner on
   a stable delta stream (``{stream}/rs``).  Each owner folds the arriving
   stripe blocks with the party-order-per-block schedule
   (:class:`~rayfed_tpu_torch.fl.streaming.StripeAggregator`: on the card
   the fold kernel ``ops/csrc/fold_fma.cu``) and finalizes with the shared
   divide.  Both are elementwise, so each reduced stripe is byte-identical
   to the same element range of the one-shot fold, whatever the arrival
   order.
3. **All-gather.**  Each owner sends its reduced stripe to its ring
   successor; every party forwards what it receives until the stripe has
   visited the whole ring (N-1 hops).  Every party assembles the N stripes
   back onto the chunk grid into the same ``PackedTree``.

Per-party traffic is ``~2·|model|`` whatever N (the hub's coordinator moves
``2·(N-1)·|model|``).

**Commit ring.**  A failure anywhere makes every party abandon the round
together: the failing party poisons every rendezvous key it was going to
produce (the transport's poison and frame-abort machinery), and a 2-pass
token ring (commit → release) runs after assembly, so a party that already
has all its bytes still learns that someone else did not.  A crash inside
the release pass itself can still strand successors until the receive
backstop: that window is two token hops.

``run_fedavg_rounds(mode="ring")`` drives this per round and falls back to
the coordinator topology for the round when the ring aborts: the same bytes,
no lost round.  The stripe payloads carry the JAX package's ``rsm``
manifest, so a torch party and a JAX party share a ring.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from rayfed_tpu_torch.fl import fedavg
from rayfed_tpu_torch.fl.compression import PackedTree, dtype_name, torch_dtype

logger = logging.getLogger(__name__)

# Version of the ring stripe manifest ("rsm" sideband leaf) — the JAX
# package's, fingerprinted with the schema by tool/check_wire_format.py.
# History: 1 = original; 2 = optional "qg" field (the shared quantization
# grid's fingerprint on compressed-domain "rs" stripes); 3 = "ag" stripes
# of a compressed-domain round carry grid CODES (dt = the grid's integer
# dtype, "qg" present).
RING_STRIPE_VERSION = 3

# Per-process round counters: the trainer's fallback path and the tests
# read them to tell a completed ring round from an aborted one.
RING_STATS: Dict[str, int] = {
    "rounds_completed": 0,
    "rounds_aborted": 0,
    "fallback_rounds": 0,
}

# Test-only fault injection: called with the phase name ("local", "rs",
# "reduce", "ag", "commit") at each step of the member flow; raising from
# it simulates a mid-round failure at that phase.
_fault_hook: Optional[Callable[[str], None]] = None


def _maybe_fault(phase: str) -> None:
    if _fault_hook is not None:
        _fault_hook(phase)


# Seq ids one ring_aggregate call consumes — callers pre-allocating ids for
# an off-main-thread call draw exactly this many, in program order.
RING_SEQ_IDS = 5


class RingRoundError(RuntimeError):
    """A ring round aborted (peer death, wire failure, poisoned hop).

    The round's contributions are still intact on their owners —
    re-aggregate them over the coordinator topology
    (``run_fedavg_rounds(mode="ring")`` does exactly that).
    """


def make_stripe_meta(
    stripe: int,
    n_stripes: int,
    nblocks: int,
    total_elems: int,
    dtype: str,
    phase: str,
    qgrid_fp: Optional[int] = None,
) -> Dict[str, Any]:
    """The ``rsm`` sideband of a stripe payload — single producer of its
    schema.  ``phase`` is ``"rs"`` (a raw stripe contribution) or ``"ag"``
    (a reduced stripe on the gather ring).  ``qgrid_fp``: the shared
    quantization grid's fingerprint on compressed-domain stripes."""
    rsm = {
        "v": RING_STRIPE_VERSION,
        "s": int(stripe),
        "n": int(n_stripes),
        "nb": int(nblocks),
        "el": int(total_elems),
        "dt": str(dtype),
        "ph": str(phase),
    }
    if qgrid_fp is not None:
        rsm["qg"] = int(qgrid_fp)
    return rsm


def _stripe_slice(buf: Any, blocks: Sequence[int], chunk_elems: int, total_elems: int) -> Any:
    """Compact the stripe's blocks out of the packed buffer (a tensor on
    any device, or an array), in ascending block order — the order the fold
    schedule assumes."""
    parts = [buf[b * chunk_elems : min((b + 1) * chunk_elems, total_elems)] for b in blocks]
    if isinstance(buf, torch.Tensor):
        if not parts:
            return buf.new_empty(0)
        return parts[0] if len(parts) == 1 else torch.cat(parts)
    if not parts:
        return np.empty(0, buf.dtype)
    if len(parts) == 1:
        return np.ascontiguousarray(parts[0])
    return np.concatenate(parts)


def _stripe_elems(blocks: Sequence[int], chunk_elems: int, nblocks: int, total_elems: int) -> int:
    n = len(blocks) * chunk_elems
    if blocks and blocks[-1] == nblocks - 1:
        n -= nblocks * chunk_elems - total_elems  # short tail block
    return n


def _stripe_grid(scales, zps, chunk_elems: int, n: int, wire_dtype: str):
    """The grid of a stripe's rows: its blocks back to back, the last one
    possibly short — the shape the codec's kernels take."""
    from rayfed_tpu_torch.fl.quantize import QuantGrid

    return QuantGrid(np.asarray(scales, np.float32), np.asarray(zps, np.float32),
                     int(chunk_elems), int(n), str(wire_dtype), "delta")


def code_gather_stripe(stripe, ref_slice, scales, zps, chunk_elems: int, wire_dtype: str) -> torch.Tensor:
    """Code a finalized f32 stripe onto the shared round grid's rows: the
    quantized ring's gather hop.  The coding is block-local (the codec's
    quantize on the stripe's rows, with a zero residual), so every
    controller decodes the same bytes and the assembled ring result equals
    the full-buffer recode of the exact aggregate.  Returns the codes on
    the stripe's device."""
    from rayfed_tpu_torch.fl.quantize import _quantize_codes

    arr = fedavg.as_tensor(stripe).reshape(-1).to(torch.float32)
    grid = _stripe_grid(scales, zps, chunk_elems, arr.numel(), wire_dtype)
    codes, _ = _quantize_codes(arr, ref_slice, None, grid)
    return codes


def decode_gather_stripe(codes, ref_slice, scales, zps, chunk_elems: int, out_dtype) -> torch.Tensor:
    """Decode a gather-hop stripe's grid codes to ``out_dtype`` — the
    receiver half of :func:`code_gather_stripe`."""
    from rayfed_tpu_torch.fl.quantize import _dequantize_codes

    arr = fedavg.as_tensor(codes).reshape(-1)
    grid = _stripe_grid(scales, zps, chunk_elems, arr.numel(), dtype_name(arr.dtype))
    return _dequantize_codes(arr, ref_slice, grid, dtype_name(out_dtype))


def _check_meta(meta_json: str, want: Dict[str, Any]) -> None:
    rsm = json.loads(meta_json)
    if rsm.get("v", 0) > RING_STRIPE_VERSION:
        raise ValueError(
            f"stripe payload uses ring manifest v{rsm.get('v')}; this "
            f"party understands up to v{RING_STRIPE_VERSION}"
        )
    for key, expect in want.items():
        if rsm.get(key) != expect:
            raise ValueError(
                f"stripe manifest mismatch: {key}={rsm.get(key)!r}, "
                f"expected {expect!r} — ring peers disagree on the "
                f"stripe schedule"
            )


def ring_aggregate(
    fed_objects: Sequence[Any],
    weights: Optional[Sequence[float]] = None,
    *,
    stream: str = "ring",
    timeout: Optional[float] = None,
    out_dtype: Any = None,
    chunk_elems: Optional[int] = None,
    seq_ids: Optional[Sequence[Any]] = None,
    round_tag: Optional[int] = None,
    timings: Optional[Dict[str, float]] = None,
    expect_parties: Optional[Sequence[str]] = None,
    quant: Optional[Any] = None,
    quant_ref: Optional[Any] = None,
    quant_scope: Optional[str] = None,
) -> Any:
    """FedAvg round over the chunk-striped ring (see the module docstring).

    Drop-in for ``streaming_aggregate`` when the contributions are
    PackedTrees, one per party: every controller calls it at the same
    program point with the same arguments.  Returns the averaged PackedTree
    on every party (its buffer on the party's device) — byte-identical to
    the streamed fold over the same contribution order.

    ``stream`` scopes the delta caches (keep it constant across rounds);
    ``out_dtype`` as in ``streaming_aggregate``; ``chunk_elems`` overrides
    the canonical grid granularity (every controller passes the same).
    Aborted rounds raise :class:`RingRoundError` on every controller
    (poison cascade + commit ring), so callers fall back in lockstep.

    ``seq_ids``: :data:`RING_SEQ_IDS` pre-allocated rendezvous ids (a call
    off the driving thread must pass them).  ``round_tag`` stamps every
    frame with the round index.  ``timings`` receives ``push_s`` (the
    reduce-scatter pushes ACKed) and ``agg_s`` (the call's wall).

    ``quant``: the round's shared :class:`~rayfed_tpu_torch.fl.quantize.
    QuantGrid` — the reduce-scatter runs in the compressed domain (stripes
    of integer codes with the grid's fingerprint in their ``rsm``, folded in
    i32, one rescale per stripe) and the gather hop is coded on the same
    grid (:func:`code_gather_stripe`; every party, the owner included,
    assembles the decoded codes).  ``quant_ref``: the round's shared
    reference for ``mode="delta"`` grids.  ``out_dtype`` defaults to f32
    then.  ``quant_scope`` keys the error-feedback residual, committed only
    when the round lands.

    ``expect_parties``: the controllers expected live this round (default:
    the cluster); quorum rounds pass the current roster.
    """
    from rayfed_tpu_torch import telemetry as _telemetry
    from rayfed_tpu_torch.fed_object import FedObject
    from rayfed_tpu_torch.fl.quantize import RoundCodec
    from rayfed_tpu_torch.fl.streaming import DEFAULT_CHUNK_ELEMS
    from rayfed_tpu_torch.proxy import recv_on_runtime, send_many_on_runtime, send_on_runtime
    from rayfed_tpu_torch.runtime import get_runtime

    runtime = get_runtime()
    objs = list(fed_objects)
    if not objs:
        raise ValueError("ring_aggregate needs at least one contribution")
    for obj in objs:
        if not isinstance(obj, FedObject):
            raise TypeError(
                "ring_aggregate consumes FedObjects (party-owned "
                f"contributions), got {type(obj).__name__}"
            )
    owners = [obj.get_party() for obj in objs]
    if len(set(owners)) != len(owners):
        raise ValueError(
            "ring_aggregate needs exactly one contribution per party "
            f"(owners: {owners}) — aggregate duplicates locally first"
        )
    if weights is not None:
        if len(weights) != len(objs):
            raise ValueError(f"{len(weights)} weights for {len(objs)} contributions")
        weights = [float(w) for w in weights]
        total_w = fedavg._check_weights(weights)
    else:
        total_w = float(len(objs))

    # The ring: contribution owners in sorted order.  Stripe k is owned by
    # ring[k]; the FOLD order stays the fed_objects order.
    ring = sorted(owners)
    n = len(ring)
    idx_of = {obj.get_party(): i for i, obj in enumerate(objs)}

    # Allocated unconditionally and identically on every controller.
    if seq_ids is None:
        rs_id, ag_id, commit_id, release_id, nm_id = (runtime.next_seq_id() for _ in range(RING_SEQ_IDS))
    else:
        rs_id, ag_id, commit_id, release_id, nm_id = seq_ids

    t_call0 = time.perf_counter()
    t_mark = t_call0
    me = runtime.party
    _phase_span = _telemetry.phase_spanner("ring", round=round_tag, party=me)
    backstop = timeout if timeout is not None else runtime.job_config.recv_backstop_s
    parties = (
        list(expect_parties) if expect_parties is not None else list(runtime.cluster_config.parties)
    )
    non_members = [p for p in parties if p not in set(ring)]

    if me not in idx_of:
        # Non-member controller: the first ring party broadcasts the result
        # before its commit and a release token after it — consuming both
        # keeps this controller's verdict in lockstep with the members'.
        try:
            result = recv_on_runtime(runtime, ring[0], nm_id, nm_id).resolve(timeout=backstop)
            recv_on_runtime(runtime, ring[0], f"{release_id}.nm", release_id).resolve(timeout=backstop)
            RING_STATS["rounds_completed"] += 1
            return result
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as exc:
            RING_STATS["rounds_aborted"] += 1
            raise RingRoundError(f"ring round broadcast from {ring[0]!r} failed: {exc!r}") from exc

    from rayfed_tpu_torch.transport.manager import ring_neighbors

    transport = runtime.transport
    device = transport.device
    m = ring.index(me)
    my_idx = idx_of[me]
    pred, succ = ring_neighbors(ring, me)
    chunk_elems = int(chunk_elems) if chunk_elems else DEFAULT_CHUNK_ELEMS

    def _broadcast_non_members(result) -> None:
        """Result to non-member controllers — checked, so a failed
        broadcast aborts the round instead of leaving them parked."""
        refs = send_many_on_runtime(
            runtime, non_members, result, nm_id, nm_id,
            stream=f"{stream}/nm", round_tag=round_tag,
        )
        for p, ref in refs.items():
            if not ref.resolve(timeout=backstop):
                raise RingRoundError(f"result broadcast to non-member {p!r} failed")

    def _release_non_members() -> None:
        """Post-commit release tokens: a failure here is the residual
        commit window (the non-member aborts at its backstop)."""
        refs = send_many_on_runtime(
            runtime, non_members, {"ok": 1}, f"{release_id}.nm", release_id, round_tag=round_tag,
        )
        for p, ref in refs.items():
            if not ref.resolve(timeout=backstop):  # pragma: no cover
                logger.warning("[%s] non-member release token to %s failed", me, p)

    # The sender-side codec discipline shared with streaming and quorum
    # (grid check, residual commit); a no-op without a grid.
    codec = RoundCodec(quant, quant_ref, quant_scope)
    qref = codec.ref

    if n == 1:
        # Degenerate single-party ring: reduce locally; still serve any
        # non-member controllers.
        try:
            value = objs[0].get_local_ref().resolve(timeout=backstop)
            if quant is not None:
                result = fedavg.packed_quantized_sum(
                    [codec.to_wire(value)], weights, out_dtype=out_dtype, ref=qref
                )
            else:
                result = fedavg.packed_weighted_sum([value], weights, out_dtype=out_dtype)
            if non_members:
                _broadcast_non_members(result)
                _release_non_members()
        except BaseException as exc:
            _poison_ring_edges(
                runtime, exc, ring=ring, m=0, my_idx=my_idx, rs_id=rs_id, ag_id=ag_id,
                commit_id=commit_id, release_id=release_id, nm_id=nm_id, non_members=non_members,
            )
            codec.rollback()
            if isinstance(exc, (KeyboardInterrupt, SystemExit)):
                raise
            RING_STATS["rounds_aborted"] += 1
            if isinstance(exc, RingRoundError):
                raise
            raise RingRoundError(f"ring round aborted: {exc!r}") from exc
        codec.commit()
        RING_STATS["rounds_completed"] += 1
        return result

    # Everything below may touch the wire: failures poison every key this
    # party was going to produce, then surface as RingRoundError.
    pending_cancels: List[tuple] = []
    agg = None
    try:
        _maybe_fault("local")
        my_packed = objs[my_idx].get_local_ref().resolve(timeout=backstop)
        if not isinstance(my_packed, PackedTree):
            raise TypeError(
                "ring_aggregate consumes PackedTree contributions, got "
                f"{type(my_packed).__name__} — produce updates with "
                "fl.compress(tree, packed=True)"
            )
        if quant is not None:
            if int(chunk_elems) != quant.chunk_elems:
                raise ValueError(
                    f"ring chunk grid ({chunk_elems} elems) must match "
                    f"the quantization grid ({quant.chunk_elems}) — "
                    f"both ARE the canonical packed_block_grid chunking"
                )
            my_packed = codec.to_wire(my_packed)
        buf = fedavg.as_tensor(my_packed.buf).reshape(-1)
        if buf.numel() == 0:
            raise ValueError(
                "ring_aggregate needs float leaves to stripe; use "
                "fl.aggregate for passthrough-only trees"
            )
        wire_name = dtype_name(buf.dtype)
        total_elems = int(buf.numel())
        nblocks = fedavg.packed_block_grid(total_elems, chunk_elems)
        stripes = fedavg.packed_stripe_schedule(nblocks, n)
        # What every party returns: f32 for a compressed-domain round.
        out_name = (
            dtype_name(out_dtype) if out_dtype is not None
            else ("float32" if quant is not None else wire_name)
        )
        q_fp = None if quant is None else quant.fingerprint()

        def elems(k: int) -> int:
            return _stripe_elems(stripes[k], chunk_elems, nblocks, total_elems)

        # -- reduce-scatter: my contribution out, my stripe folded in --
        my_stripe_elems = elems(m)
        if my_stripe_elems:
            rs_want = {"s": m, "n": n, "nb": nblocks, "el": total_elems, "dt": wire_name, "ph": "rs"}
            if q_fp is not None:
                # Integer codes mean nothing without the grid.
                rs_want["qg"] = q_fp
            agg = _make_stripe_agg(
                runtime, len(objs), weights,
                out_name if quant is not None else out_dtype,
                my_stripe_elems, chunk_elems, label=f"stripe {m}",
                meta_check=lambda v: _check_meta(v, rs_want),
                quant=quant, quant_blocks=stripes[m],
                quant_ref=None if qref is None else _stripe_slice(qref, stripes[m], chunk_elems, total_elems),
            )
            entries = []
            for i, obj in enumerate(objs):
                if i == my_idx:
                    continue
                entries.append((obj.get_party(), f"{rs_id}.rs.{i}.{m}", rs_id, agg.sink(i)))
                pending_cancels.append((f"{rs_id}.rs.{i}.{m}", rs_id))
            # One loop hop demuxes all N-1 contribution streams.
            transport.recv_stream_many(entries)

        _maybe_fault("rs")
        rs_refs = []
        for k in range(n):
            if k == m or not elems(k):
                continue
            payload: Dict[str, Any] = {
                "data": _stripe_slice(buf, stripes[k], chunk_elems, total_elems),
                "rsm": json.dumps(
                    make_stripe_meta(k, n, nblocks, total_elems, wire_name, "rs", qgrid_fp=q_fp),
                    sort_keys=True,
                ),
            }
            if k == 0 and my_packed.passthrough:
                # Non-float leaves ride to the first stripe's owner, which
                # reduces them once and ships them with its gathered stripe.
                payload["pt"] = tuple(my_packed.passthrough)
            rs_refs.append((
                ring[k], f"{rs_id}.rs.{my_idx}.{k}",
                send_on_runtime(
                    runtime, ring[k], payload, f"{rs_id}.rs.{my_idx}.{k}", rs_id,
                    stream=f"{stream}/rs", round_tag=round_tag, quant_meta=codec.descriptor,
                ),
            ))
        if my_stripe_elems:
            agg.add_local(my_idx, _stripe_slice(buf, stripes[m], chunk_elems, total_elems))
        for dest, up, ref in rs_refs:
            if not ref.resolve(timeout=backstop):
                raise RingRoundError(f"reduce-scatter push {up!r} to {dest!r} failed")
        if timings is not None:
            timings["push_s"] = time.perf_counter() - t_call0

        _maybe_fault("reduce")
        if my_stripe_elems:
            my_reduced = agg.result(timeout=backstop)
        else:
            my_reduced = torch.empty(0, dtype=torch_dtype(out_name), device=device)
        t_mark = _phase_span("reduce_scatter", t_mark, detail={"stripe": m, "parties": n})

        # Reduced passthrough: stripe 0's owner holds every party's
        # non-float leaves and reduces them as the one-shot fold does.
        reduced_pt: tuple = ()
        if m == 0 and my_packed.passthrough:
            pts: List[tuple] = [()] * len(objs)
            pts[my_idx] = tuple(my_packed.passthrough)
            for i in range(len(objs)):
                if i != my_idx:
                    pts[i] = tuple(agg.payload_value(i)["pt"])
            reduced_pt = tuple(fedavg._reduce_passthrough(pts, weights, total_w))

        # -- all-gather: reduced stripes travel the ring ---------------
        # A compressed-domain round codes the gather hop on the shared
        # round grid, and every party (owner included) assembles the
        # decoded codes.
        _maybe_fault("ag")

        def _gather_ctx(k: int):
            rows_s, rows_z = quant.rows(stripes[k])
            ref_slice = None if qref is None else _stripe_slice(qref, stripes[k], chunk_elems, total_elems)
            return rows_s, rows_z, ref_slice

        # The gather wire dtype is a round-wide contract, from the grid
        # alone (a zero-stripe party still validates its peers' stripes).
        ag_dt_name = quant.wire_dtype if quant is not None else out_name
        if quant is not None and my_stripe_elems:
            rows_s, rows_z, ref_slice = _gather_ctx(m)
            my_codes = code_gather_stripe(my_reduced, ref_slice, rows_s, rows_z, chunk_elems, quant.wire_dtype)
            my_assembled = decode_gather_stripe(my_codes, ref_slice, rows_s, rows_z, chunk_elems, out_name)
        else:
            my_codes = None
            my_assembled = my_reduced
        gathered: Dict[int, torch.Tensor] = {m: my_assembled}
        fwd_refs: List[tuple] = []
        fwd_lock = threading.Lock()

        def _ag_payload(k: int, data: Any) -> Dict[str, Any]:
            payload = {
                "data": data,
                "rsm": json.dumps(
                    make_stripe_meta(k, n, nblocks, total_elems, ag_dt_name, "ag", qgrid_fp=q_fp),
                    sort_keys=True,
                ),
            }
            if k == 0 and reduced_pt:
                payload["pt"] = reduced_pt
            return payload

        def _ag_send(k: int, hop: int, payload: Dict[str, Any]) -> None:
            ref = send_on_runtime(
                runtime, succ, payload, f"{ag_id}.ag.{k}.{hop}", ag_id,
                stream=f"{stream}/ag/{k}", round_tag=round_tag,
            )
            with fwd_lock:
                fwd_refs.append((k, hop, ref))

        if elems(m):
            _ag_send(m, 1, _ag_payload(m, my_codes if my_codes is not None else gathered[m]))

        collected: Dict[int, Any] = {}
        for k in sorted((k for k in range(n) if k != m and elems(k)), key=lambda k: (m - k) % n):
            hop = (m - k) % n  # how many hops stripe k took to reach me

            def _on_stripe(value, k=k, hop=hop):
                ag_want = {"s": k, "n": n, "nb": nblocks, "el": total_elems, "dt": ag_dt_name, "ph": "ag"}
                if q_fp is not None:
                    ag_want["qg"] = q_fp
                _check_meta(value["rsm"], ag_want)
                if hop + 1 <= n - 1:  # the successor is not stripe k's owner
                    _ag_send(k, hop + 1, value)
                return value

            # Forward on arrival: relaying stripe k overlaps stripe k+1
            # still being on the wire.
            collected[k] = recv_on_runtime(runtime, pred, f"{ag_id}.ag.{k}.{hop}", ag_id).then(_on_stripe)

        for k, ref in collected.items():
            value = ref.resolve(timeout=backstop)
            arr = fedavg.as_tensor(value["data"], device).reshape(-1)
            if quant is not None:
                rows_s, rows_z, ref_slice = _gather_ctx(k)
                arr = decode_gather_stripe(arr, ref_slice, rows_s, rows_z, chunk_elems, out_name)
            gathered[k] = arr
            if k == 0 and "pt" in value:
                reduced_pt = tuple(value["pt"])
        with fwd_lock:
            pending_fwd = list(fwd_refs)
        for k, hop, ref in pending_fwd:
            if not ref.resolve(timeout=backstop):
                raise RingRoundError(f"all-gather forward of stripe {k} (hop {hop}) to {succ!r} failed")
        t_mark = _phase_span("all_gather", t_mark)

        # -- assemble the full buffer back onto the chunk grid ---------
        full = torch.empty(total_elems, dtype=torch_dtype(out_name), device=device)
        for k in range(n):
            data = gathered.get(k)
            if data is None or not len(stripes[k]):
                continue
            if data.numel() != elems(k):
                raise RingRoundError(f"stripe {k} carries {data.numel()} elements, schedule says {elems(k)}")
            data = data.to(device)
            off = 0
            for b in stripes[k]:
                size = min(chunk_elems, total_elems - b * chunk_elems)
                full[b * chunk_elems : b * chunk_elems + size] = data[off : off + size]
                off += size
        result = fedavg._packed_result(full, reduced_pt, my_packed.spec, out_name)

        # The non-member broadcast rides BEFORE the commit ring: a failed
        # broadcast then aborts the round on every controller.
        if m == 0 and non_members:
            _broadcast_non_members(result)

        # -- commit ring: agree the round landed everywhere ------------
        _maybe_fault("commit")
        token = {"ok": 1}

        def _token_send(up: str, down) -> None:
            if not send_on_runtime(runtime, succ, token, up, down, round_tag=round_tag).resolve(timeout=backstop):
                raise RingRoundError(f"commit token {up!r} to {succ!r} failed")

        if m == 0:
            _token_send(f"{commit_id}.c.1", commit_id)
            recv_on_runtime(runtime, pred, f"{commit_id}.c.{n}", commit_id).resolve(timeout=backstop)
            _token_send(f"{release_id}.r.1", release_id)
        else:
            recv_on_runtime(runtime, pred, f"{commit_id}.c.{m}", commit_id).resolve(timeout=backstop)
            _token_send(f"{commit_id}.c.{m + 1}", commit_id)
            recv_on_runtime(runtime, pred, f"{release_id}.r.{m}", release_id).resolve(timeout=backstop)
            if m < n - 1:
                _token_send(f"{release_id}.r.{m + 1}", release_id)
    except BaseException as exc:
        codec.rollback()
        for up, down in pending_cancels:
            transport.cancel_stream(up, down)
        _poison_ring_edges(
            runtime, exc, ring=ring, m=m, my_idx=my_idx, rs_id=rs_id, ag_id=ag_id,
            commit_id=commit_id, release_id=release_id, nm_id=nm_id, non_members=non_members,
        )
        if isinstance(exc, (KeyboardInterrupt, SystemExit)):
            # The poison still unparks the peers, but an interrupt stops
            # the caller: the trainer's fallback must not swallow it.
            raise
        RING_STATS["rounds_aborted"] += 1
        _telemetry.event("ring.abort", round=round_tag, party=me, outcome="error", detail={"error": repr(exc)})
        if isinstance(exc, RingRoundError):
            raise
        raise RingRoundError(f"ring round aborted: {exc!r}") from exc

    if m == 0 and non_members:
        try:
            _release_non_members()
        except Exception:  # pragma: no cover - post-commit best effort
            logger.exception("[%s] non-member release pass failed", me)
    codec.commit()
    RING_STATS["rounds_completed"] += 1
    _phase_span("commit", t_mark)
    if timings is not None:
        timings.setdefault("push_s", 0.0)
        timings["agg_s"] = time.perf_counter() - t_call0
    return result


def _make_stripe_agg(runtime, n_sources, weights, out_dtype, expect_elems, chunk_elems, label,
                     meta_check=None, quant=None, quant_blocks=None, quant_ref=None):
    from rayfed_tpu_torch.fl.streaming import StripeAggregator

    return StripeAggregator(
        n_sources,
        weights=weights,
        allowed=runtime.cluster_config.serializing_allowed_list,
        party=runtime.party,
        # The fold grid matches the stripe compaction grid.
        chunk_elems=chunk_elems,
        out_dtype=out_dtype,
        expect_elems=expect_elems,
        label=label,
        meta_check=meta_check,
        quant=quant,
        quant_blocks=quant_blocks,
        quant_ref=quant_ref,
        device=runtime.transport.device,
    )


def _poison_ring_edges(runtime, exc, *, ring, m, my_idx, rs_id, ag_id, commit_id, release_id,
                       nm_id, non_members) -> None:
    """Best-effort poison of every rendezvous key this party produces: the
    receivers raise the originating error within a round trip and unwind
    their own outgoing edges the same way — the abort cascades around the
    ring."""
    poison = getattr(runtime.transport, "_send_poison", None)
    if poison is None:  # transport without a poison path (custom proxy)
        return
    n = len(ring)
    succ = ring[(m + 1) % n]
    edges = []
    for k in range(n):  # reduce-scatter pushes I owed stripe owners
        if k != m:
            edges.append((ring[k], f"{rs_id}.rs.{my_idx}.{k}", rs_id))
    for k in range(n):  # all-gather forwards I owed my successor
        hop = (m - k) % n + 1
        if hop <= n - 1:
            edges.append((succ, f"{ag_id}.ag.{k}.{hop}", ag_id))
    edges.append((succ, f"{commit_id}.c.{m + 1}", commit_id))
    if m < n - 1:
        edges.append((succ, f"{release_id}.r.{m + 1}", release_id))
    if m == 0:
        for p in non_members:
            edges.append((p, nm_id, nm_id))
            edges.append((p, f"{release_id}.nm", release_id))
    for dest, up, down in edges:
        if dest == runtime.party:
            continue  # n==1 degenerate ring: succ is this party itself
        try:
            poison(dest, up, down, exc)
        except Exception:  # pragma: no cover - best effort
            logger.exception(
                "[%s] failed to poison ring edge (%s, %s) at %s", runtime.party, up, down, dest,
            )
