"""Buffered asynchronous federated rounds with exact integer staleness
decay: the round barrier removed, the synchronous stack's byte-exactness
kept.

The port of the JAX package's ``fl/async_rounds.py``, with the same names
and structure.  Parties push a staleness-tagged quantized contribution
whenever they finish local work; the coordinator folds each arrival into a
running i32 code buffer on its device through the unchanged
:func:`~rayfed_tpu_torch.fl.fedavg.quantized_accum_kernel` and emits a new
model **version** every K contributions (``buffer_k``) or T seconds
(``flush_s``): FedBuff's buffered-async regime (Nguyen et al.,
arXiv:2106.06639) in the compressed domain.

Exactness
---------

A contribution coded on the version-``v`` grid arrives with staleness
``s = v_now − v`` and folds at the integer weight ``w >> min(s, cap)``
(:func:`decay_weight`).  Integer adds commute and associate, so for one
version's contribution set the buffer holds ``Σ_p w_eff_p · q_p`` whatever
the arrival order, and the one rescale
(:func:`~rayfed_tpu_torch.fl.fedavg.finalize_packed_quantized`) emits the
bytes of a sorted-order :func:`~rayfed_tpu_torch.fl.fedavg.
packed_quantized_sum` refold of the same set at weights ``w_eff``, on the
card and on the CPU alike.  A stale contribution decodes against the
version it was coded on (every broadcast ships its grid) and re-codes onto
the current grid through the shared :class:`~rayfed_tpu_torch.fl.quantize.
RoundCodec`; the grids of the last ``staleness_cap + 2`` versions are kept.
A server optimizer (:mod:`rayfed_tpu_torch.fl.server_opt`), when given,
steps each buffered mean as the synchronous loop steps a round's.

Version-tagged wire contract
----------------------------

Broadcasts and contributions stamp the model version into the frame
metadata under :data:`rayfed_tpu_torch.transport.wire.ASYNC_VERSION_KEY`
(``TransportManager.send(version_tag=...)``), the JAX package's key, so a
fleet may mix both packages.  Version 0 needs no negotiation: every
controller derives the same ``mode="abs"`` grid from the initial params
(:func:`bootstrap_grid`), and every later grid rides the broadcast.  A
party's final push retires it from the roster and bumps the epoch stamped
on later broadcasts.

:func:`run_async_fleet` runs the fleet in one process, as the JAX package's
harness does: one thread per virtual party over bare
``TransportManager``\\s on loopback.  It picks the listeners' ports with
:func:`~rayfed_tpu_torch.utils.ports.free_loopback_ports` (the JAX package
binds port 0 and closes, and an outgoing connection may take such a port
before its party binds it).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from rayfed_tpu_torch import chaos, telemetry
from rayfed_tpu_torch.fl import quantize as qz
from rayfed_tpu_torch.fl.compression import PackedTree, PackSpec, pack_tree
from rayfed_tpu_torch.fl.fedavg import as_tensor, finalize_packed_quantized, quantized_accum_kernel
from rayfed_tpu_torch.fl.quantize import (
    QuantGrid,
    QuantizedPackedTree,
    RoundCodec,
    grid_descriptor,
    make_round_grid,
)
from rayfed_tpu_torch.utils.platform import resolve_device
from rayfed_tpu_torch.utils.ports import free_loopback_ports

logger = logging.getLogger(__name__)

#: Shift cap: beyond this staleness every weight decays alike (``w >> cap``);
#: it mostly bounds the grid-retention window.
DEFAULT_STALENESS_CAP = 8

#: Contributions buffered per emitted model version (FedBuff's K).
DEFAULT_BUFFER_K = 4

# Per-process counters, the "async" section of metrics_snapshot().
ASYNC_STATS: Dict[str, Any] = {
    "versions_emitted": 0,
    "folds": 0,
    "buffer_occupancy": 0,
    "staleness_hist": {},
    "decay_shift_total": 0,
    "dropped_decayed_out": 0,
    "dropped_unretained": 0,
    "recoded_stale": 0,
}


def reset_async_stats() -> None:
    """Zero the per-process async counters."""
    ASYNC_STATS.update(
        versions_emitted=0, folds=0, buffer_occupancy=0,
        staleness_hist={}, decay_shift_total=0, dropped_decayed_out=0,
        dropped_unretained=0, recoded_stale=0,
    )


def decay_weight(weight: int, staleness: int, staleness_cap: int = DEFAULT_STALENESS_CAP) -> int:
    """The exact integer staleness decay ``w >> min(s, cap)``: the one
    producer, so that no call site decays by a float multiply."""
    w = int(weight)
    s = int(staleness)
    if w < 0 or float(weight) != w:
        raise ValueError(
            f"compressed-domain folds need non-negative integral "
            f"weights (example counts), got {weight!r}"
        )
    if s < 0:
        raise ValueError(
            f"staleness is versions-behind, never negative (got {s}) — "
            f"a contribution cannot be coded against an unemitted model"
        )
    return w >> min(s, int(staleness_cap))


def bootstrap_grid(model_buf: Any, wire_dtype: str = "uint8",
                   chunk_elems: Optional[int] = None) -> QuantGrid:
    """The version-0 grid: ``mode="abs"`` over the initial params, derived
    alike on every controller (pure numpy, as the JAX package's).  From
    version 1 on the coordinator rotates to delta grids shipped on the
    broadcast."""
    if isinstance(model_buf, PackedTree):
        model_buf = model_buf.buf
    flat = qz._host_f32(model_buf)
    if flat.size and float(flat.max() - flat.min()) == 0.0:
        # A constant init ranges every chunk to the eps floor: every
        # version-0 contribution clips to the constant and the fleet
        # stays at the init.
        raise ValueError(
            "bootstrap_grid: initial params are all-constant — the "
            "version-0 abs grid ranges over the initial value spread, "
            "so a constant init clips every contribution to itself "
            "(randomize the init, as real models do)"
        )
    return make_round_grid(flat, chunk_elems=chunk_elems, wire_dtype=wire_dtype, mode="abs")


def _f32_flat(buf: Any, device: torch.device) -> torch.Tensor:
    return as_tensor(buf, device).reshape(-1).to(torch.float32)


class AsyncBuffer:
    """The running compressed-domain fold of one model version.

    An i32 accumulator over the grid's padded block layout on ``device``
    (default the card), one :func:`~rayfed_tpu_torch.fl.fedavg.
    quantized_accum_kernel` call per arrival (the whole buffer as one chunk
    at offset 0; the padding stays zero), and :meth:`finalize`, the one
    rescale every synchronous topology ends in: the emitted bytes are those
    of a sorted-order ``packed_quantized_sum`` refold of the folded
    ``(codes, w_eff)`` set.
    """

    __slots__ = ("grid", "ref", "staleness_cap", "device", "_acc", "_padded",
                 "_template", "_count", "_total_w", "staleness_hist", "decay_shift_total")

    def __init__(self, grid: QuantGrid, ref: Optional[Any], template: PackedTree,
                 staleness_cap: int = DEFAULT_STALENESS_CAP, device: Any = None) -> None:
        self.staleness_cap = int(staleness_cap)
        self.device = resolve_device(device)
        # The finalized PackedTree's skeleton; the fold never reads it.
        self._template = template
        self._padded = 0
        self._acc: Optional[torch.Tensor] = None
        self.grid = grid
        self.ref: Optional[torch.Tensor] = None
        self.staleness_hist: Dict[int, int] = {}
        self.decay_shift_total = 0
        self._count = 0
        self._total_w = 0
        self.reset(grid, ref)

    @property
    def occupancy(self) -> int:
        """Contributions folded into the current (unemitted) version."""
        return self._count

    @property
    def total_weight(self) -> int:
        return self._total_w

    def reset(self, grid: QuantGrid, ref: Optional[Any]) -> None:
        """Start the next version's buffer on a (possibly rotated) grid.
        Rotation never changes the packed layout: only the scales, zero
        points and reference move."""
        if self._acc is not None and (
            grid.total_elems != self.grid.total_elems
            or grid.chunk_elems != self.grid.chunk_elems
        ):
            raise ValueError(
                f"grid rotation changed the packed layout "
                f"({self.grid.total_elems}/{self.grid.chunk_elems} -> "
                f"{grid.total_elems}/{grid.chunk_elems}) — the running "
                f"buffer is per-model-layout; build a new AsyncBuffer "
                f"when the model structure changes"
            )
        self.grid = grid
        if ref is not None:
            ref = _f32_flat(ref, self.device)
            if ref.numel() != grid.total_elems:
                raise ValueError(
                    f"reference has {ref.numel()} elements, grid covers "
                    f"{grid.total_elems}"
                )
        elif grid.mode == "delta":
            raise ValueError(
                "delta-mode grids fold codes of x - ref: pass the "
                "version's shared reference buffer"
            )
        self.ref = ref
        self._padded = grid.nblocks * grid.chunk_elems
        self._acc = torch.zeros(self._padded, dtype=torch.int32, device=self.device)
        self._count = 0
        self._total_w = 0
        self.staleness_hist = {}
        self.decay_shift_total = 0
        ASYNC_STATS["buffer_occupancy"] = 0

    def fold(self, qt: QuantizedPackedTree, weight: int = 1, staleness: int = 0) -> int:
        """Fold one arrival; returns the effective (decayed) weight.  A
        weight the shift decays to 0 folds nothing.  Codes taken on another
        grid raise: stale codes re-code through the shared RoundCodec first
        (:func:`run_async_coordinator` does)."""
        if not isinstance(qt, QuantizedPackedTree):
            raise TypeError(
                f"AsyncBuffer folds QuantizedPackedTree contributions, "
                f"got {type(qt).__name__}"
            )
        if qt.gmeta != self.grid.meta():
            raise ValueError(
                f"contribution was coded on a different grid "
                f"(fp={qt.gmeta.fp:#010x} vs "
                f"{self.grid.fingerprint():#010x}) — version-stale "
                f"codes re-code through the shared RoundCodec before "
                f"the fold"
            )
        shift = min(int(staleness), self.staleness_cap)
        w_eff = decay_weight(weight, staleness, self.staleness_cap)
        self.staleness_hist[shift] = self.staleness_hist.get(shift, 0) + 1
        hist = ASYNC_STATS["staleness_hist"]
        hist[shift] = hist.get(shift, 0) + 1
        if w_eff <= 0:
            ASYNC_STATS["dropped_decayed_out"] += 1
            return 0
        # The headroom guard before the accumulator is touched: a refused
        # fold leaves the buffer as it was.
        self.grid.check_weight_headroom(self._total_w + w_eff)
        codes = as_tensor(qt.buf, self.device).reshape(-1)
        if codes.numel() != self.grid.total_elems:
            raise ValueError(
                f"contribution carries {codes.numel()} codes, grid covers "
                f"{self.grid.total_elems}"
            )
        quantized_accum_kernel(self._acc, 0, codes, w_eff)
        self._count += 1
        self._total_w += w_eff
        self.decay_shift_total += shift
        ASYNC_STATS["folds"] += 1
        ASYNC_STATS["buffer_occupancy"] = self._count
        ASYNC_STATS["decay_shift_total"] += shift
        return w_eff

    def finalize(self, out_dtype: Any = np.float32) -> PackedTree:
        """The buffered version's weighted mean, one rescale on the
        buffer's device.  The buffer stays live; :meth:`reset` starts the
        next version."""
        if self._count == 0:
            raise ValueError(
                "finalize on an empty buffer — the weighted average of "
                "no contributions is undefined (emission is gated on "
                "occupancy for exactly this reason)"
            )
        buf = finalize_packed_quantized(
            self._acc, self.grid.scales, self.grid.zps,
            float(self._total_w), self.grid.total_elems,
            self.grid.chunk_elems, out_dtype, ref=self.ref,
        )
        tmpl = self._template
        spec = PackSpec(tmpl.spec.entries, tmpl.spec.treedef, np.dtype(out_dtype).name)
        return PackedTree(buf, tmpl.passthrough, spec)


def _wrap_server_opt(server_opt: Any, device: torch.device) -> Any:
    if server_opt is None or hasattr(server_opt, "step_fn"):
        return server_opt
    from rayfed_tpu_torch.fl.server_opt import PackedServerOptimizer

    return PackedServerOptimizer(server_opt, device=device)


def run_async_coordinator(
    mgr: Any,
    party: str,
    members: Sequence[str],
    params: Any,
    *,
    cycles: Any,
    buffer_k: int = DEFAULT_BUFFER_K,
    flush_s: Optional[float] = None,
    wire_quant: str = "uint8",
    chunk_elems: Optional[int] = None,
    staleness_cap: int = DEFAULT_STALENESS_CAP,
    grid_retention: Optional[int] = None,
    server_opt: Any = None,
    stream: str = "async",
    timeout_s: Optional[float] = None,
    version_log: Optional[List[Dict[str, Any]]] = None,
    record_folds: Optional[List[Dict[str, Any]]] = None,
    device: Any = None,
) -> Dict[str, Any]:
    """The buffered-async coordinator over a bare ``TransportManager``.

    Parks one receive per active member and takes arrivals from a queue;
    each folds into the running :class:`AsyncBuffer` (re-coded when its
    version's grid has rotated), and a version emits every ``buffer_k``
    contributions or, checked at arrival, ``flush_s`` seconds.  The reply
    to each push carries the current model, its grid and its version (the
    ``version_tag`` frame metadata): the reply is the version broadcast.

    ``cycles``: pushes per member (an int, or a dict by member); a member's
    final push retires it.  ``grid_retention``: how many past versions stay
    decodable (default ``staleness_cap + 2``); older arrivals are dropped
    and counted.  ``record_folds``: receives ``{version, party, qt, weight,
    w_eff, staleness}`` per fold, the refold check's input.  ``device``:
    where the buffer, the model and the step live (default the manager's,
    else the card).  Returns ``{"w", "versions", "epoch", "folds",
    "template"}`` with ``w`` the final model as a host array.
    """
    device = resolve_device(device if device is not None else getattr(mgr, "device", None))
    members = [str(m) for m in members]
    if isinstance(cycles, int):
        expected = {m: int(cycles) for m in members}
    else:
        expected = {m: int(cycles[m]) for m in members}
    total_pushes = sum(expected.values())
    retention = int(grid_retention) if grid_retention is not None else int(staleness_cap) + 2
    sopt = _wrap_server_opt(server_opt, device)

    tmpl = pack_tree(params, torch.float32)
    model = _f32_flat(tmpl.buf, device)
    # The broadcast form of the model (a host array, shared by every
    # reply of one version).
    model_host = qz._host_f32(model)
    grid0 = bootstrap_grid(model_host, wire_quant, chunk_elems)
    # version -> (grid, reference) for decoding version-stale codes.
    grids: Dict[int, Any] = {0: (grid0, None)}
    version = 0
    epoch = 0
    buf = AsyncBuffer(grid0, None, tmpl, staleness_cap=staleness_cap, device=device)
    last_emit = time.perf_counter()
    emitted_folds = 0

    arrivals: "queue.Queue" = queue.Queue()

    def _park(member: str, cycle: int) -> None:
        ref = mgr.recv(member, f"{stream}.up.{member}", str(cycle))
        ref.add_done_callback(lambda r, _m=member, _c=cycle: arrivals.put((_m, _c, r)))

    roster = {m for m in members if expected[m] > 0}
    for m in roster:
        _park(m, 0)

    def _emit_version() -> None:
        nonlocal version, model, model_host, last_emit, emitted_folds
        folds = buf.occupancy
        total_w = buf.total_weight
        hist = dict(buf.staleness_hist)
        shifts = buf.decay_shift_total
        with telemetry.span(
            "async.version", party=party, stream=stream, round=version + 1, epoch=epoch,
            detail={"folds": folds, "total_weight": total_w, "decay_shift_total": shifts},
        ):
            agg = buf.finalize(np.float32)
            if sopt is not None:
                sopt.ensure(model)
                agg = sopt.step_fn(model)(agg)
                sopt.resync(model, agg.buf)
            new_model = _f32_flat(agg.buf, device)
            delta = new_model - model
            if bool(torch.any(delta != 0)):
                new_grid = make_round_grid(
                    delta, chunk_elems=grid0.chunk_elems, wire_dtype=wire_quant,
                    mode="delta", expand=qz.QUANT_DELTA_EXPAND,
                )
                new_ref: Optional[torch.Tensor] = new_model
            else:
                # A version that did not move keeps the grid and its
                # reference: an all-zero delta range would clip everything.
                new_grid, new_ref = grids[version]
            version += 1
            grids[version] = (new_grid, new_ref)
            for old in [v for v in grids if v < version - retention]:
                del grids[old]
            model = new_model
            model_host = qz._host_f32(model)
            buf.reset(new_grid, new_ref)
        ASYNC_STATS["versions_emitted"] += 1
        emitted_folds += folds
        if version_log is not None:
            version_log.append({
                "version": version, "folds": folds, "total_weight": total_w,
                "staleness_hist": hist, "decay_shift_total": shifts,
                "model": model_host.copy(),
                # The emission's wall-clock stamp, for time-to-target curves.
                "t_wall": time.time(),
            })
        last_emit = time.perf_counter()

    processed = 0
    while processed < total_pushes:
        member, cycle, ref = arrivals.get()
        payload = ref.resolve(timeout_s)
        processed += 1
        qt = payload["qt"]
        v_from = int(payload["v"])
        weight = int(payload["weight"])
        staleness = version - v_from
        fold_detail: Dict[str, Any] = {
            "staleness": staleness, "cycle": cycle, "v_from": v_from, "weight": weight,
        }
        with telemetry.span(
            "async.fold", party=party, peer=member, stream=stream,
            round=version, epoch=epoch, detail=fold_detail,
        ):
            held = grids.get(v_from)
            if held is None:
                # Past the retention window the reference that decodes
                # the codes is gone; the decayed weight is negligible.
                ASYNC_STATS["dropped_unretained"] += 1
                logger.warning(
                    "[%s] dropping contribution from %s coded at version %d "
                    "(current %d, retention %d)", party, member, v_from, version, retention,
                )
                w_eff = 0
            else:
                if v_from != version:
                    g_old, ref_old = held
                    if qt.gmeta != g_old.meta():
                        raise ValueError(
                            f"contribution from {member} claims "
                            f"version {v_from} but its codes carry "
                            f"grid fp={qt.gmeta.fp:#010x}, version "
                            f"{v_from}'s grid is "
                            f"{g_old.fingerprint():#010x}"
                        )
                    # Decoded and re-coded on the buffer's device.
                    on_dev = QuantizedPackedTree(as_tensor(qt.buf, device), qt.scales, qt.zps,
                                                 qt.passthrough, qt.spec, qt.gmeta)
                    decoded = on_dev.dequantize(np.float32, ref=ref_old)
                    qt = RoundCodec(buf.grid, buf.ref).to_wire(decoded)
                    ASYNC_STATS["recoded_stale"] += 1
                    fold_detail["recoded"] = True
                w_eff = buf.fold(qt, weight, staleness)
                fold_detail["w_eff"] = w_eff
                if record_folds is not None:
                    record_folds.append({
                        "version": version, "party": member, "qt": qt,
                        "weight": weight, "w_eff": w_eff, "staleness": staleness,
                    })
        now = time.perf_counter()
        if buf.occupancy and (
            buf.occupancy >= int(buffer_k)
            or (flush_s is not None and now - last_emit >= flush_s)
        ):
            _emit_version()
        cur_grid, _cur_ref = grids[version]
        mgr.send(
            member,
            {
                "v": version,
                "buf": model_host,
                "scales": cur_grid.scales,
                "zps": cur_grid.zps,
                "mode": cur_grid.mode,
                "epoch": epoch,
            },
            f"{stream}.dn.{member}", str(cycle),
            stream=stream, version_tag=version, epoch_tag=epoch,
            quant_meta=grid_descriptor(cur_grid),
        )
        if bool(payload.get("fin")) or cycle + 1 >= expected[member]:
            roster.discard(member)
            epoch += 1
            telemetry.event("async.roster", party=party, peer=member, stream=stream,
                            epoch=epoch, round=version)
        else:
            _park(member, cycle + 1)

    # Arrivals after the last emission still owe the fleet a version.
    if buf.occupancy:
        _emit_version()
    return {
        "w": model_host,
        "versions": version,
        "epoch": epoch,
        "folds": emitted_folds,
        "template": tmpl,
    }


def run_async_party(
    mgr: Any,
    party: str,
    coordinator: str,
    params: Any,
    local_step_fn: Callable[[str, PackedTree, int, int], PackedTree],
    *,
    cycles: int,
    weight: int = 1,
    wire_quant: str = "uint8",
    chunk_elems: Optional[int] = None,
    stream: str = "async",
    timeout_s: Optional[float] = None,
    device: Any = None,
) -> Dict[str, Any]:
    """One virtual party's push loop (no round barrier anywhere).

    Each cycle: ``local_step_fn(party, packed_model, version, cycle) ->
    PackedTree`` (its measured duration feeds the chaos ``local_step``
    hook, where a seeded ``local_slowdown`` makes a straggler), then the
    result coded on the current version's grid through the party's
    error-feedback :class:`~rayfed_tpu_torch.fl.quantize.RoundCodec`,
    pushed version-tagged, and whatever version the reply carries adopted.
    ``device``: where the party's model lives (default the manager's, else
    the card).  Returns ``{"w", "version"}`` (``w`` a host array).
    """
    device = resolve_device(device if device is not None else getattr(mgr, "device", None))
    tmpl = pack_tree(params, torch.float32)
    model = _f32_flat(tmpl.buf, device)
    grid = bootstrap_grid(model, wire_quant, chunk_elems)
    gref: Optional[torch.Tensor] = None
    version = 0
    f32_spec = PackSpec(tmpl.spec.entries, tmpl.spec.treedef, "float32")
    packed = PackedTree(model, tmpl.passthrough, f32_spec)
    scope = f"{stream}.{party}"

    for c in range(int(cycles)):
        t_wall = time.time()
        t0 = time.perf_counter()
        contrib = local_step_fn(party, packed, version, c)
        dur = time.perf_counter() - t0
        telemetry.emit("async.local", t_start=t_wall, dur_s=dur, party=party,
                       stream=stream, round=version, detail={"cycle": c})
        # The chaos hook may sleep here (local_slowdown over the measured
        # baseline): the heterogeneous-device time the buffer absorbs.
        chaos.fire("local_step", party, version=version, cycle=c, baseline_s=dur)
        codec = RoundCodec(grid, gref, scope=scope)
        qt = codec.to_wire(contrib)
        with telemetry.span("async.cycle", party=party, stream=stream, round=version,
                            detail={"cycle": c}):
            mgr.send(
                coordinator,
                {"v": version, "cycle": c, "weight": int(weight),
                 "fin": c + 1 >= int(cycles), "qt": qt},
                f"{stream}.up.{party}", str(c),
                stream=stream, version_tag=version, quant_meta=codec.descriptor,
            )
            reply = mgr.recv(coordinator, f"{stream}.dn.{party}", str(c)).resolve(timeout_s)
        # The coordinator replies after the fold: the residual is spent.
        codec.commit()
        rv = int(reply["v"])
        if rv != version:
            version = rv
            model = _f32_flat(reply["buf"], device)
            mode = str(reply["mode"])
            grid = QuantGrid(
                qz._host_f32(reply["scales"]), qz._host_f32(reply["zps"]),
                grid.chunk_elems, grid.total_elems, wire_quant, mode,
            )
            gref = model if mode == "delta" else None
            packed = PackedTree(model, tmpl.passthrough, f32_spec)
    return {"w": qz._host_f32(model), "version": version}


def run_async_fleet(
    parties: Sequence[str],
    params: Any,
    local_step_fn: Callable[[str, PackedTree, int, int], PackedTree],
    *,
    cycles: Any = 4,
    weights: Optional[Dict[str, int]] = None,
    buffer_k: int = DEFAULT_BUFFER_K,
    flush_s: Optional[float] = None,
    wire_quant: str = "uint8",
    chunk_elems: Optional[int] = None,
    staleness_cap: int = DEFAULT_STALENESS_CAP,
    grid_retention: Optional[int] = None,
    server_opt: Any = None,
    stream: str = "async",
    timeout_s: float = 300.0,
    version_log: Optional[List[Dict[str, Any]]] = None,
    record_folds: Optional[List[Dict[str, Any]]] = None,
    device: Any = None,
) -> Dict[str, Any]:
    """The in-process virtual-party harness: N loopback ``TransportManager``\\s
    (local links upgraded), one thread per party, the first name
    coordinating.  ``device``: every party's device (default the card).
    Returns the coordinator's result with ``party_results`` by member."""
    from rayfed_tpu_torch.config import ClusterConfig, JobConfig, PartyConfig
    from rayfed_tpu_torch.transport.manager import TransportManager

    device = resolve_device(device)
    parties = [str(p) for p in parties]
    if len(parties) < 2:
        raise ValueError("an async fleet needs a coordinator + >= 1 member")
    coordinator, members = parties[0], parties[1:]
    ports = dict(zip(parties, free_loopback_ports(len(parties))))

    def _mk(p: str) -> Any:
        cc = ClusterConfig(
            parties={q: PartyConfig.from_dict({"address": f"127.0.0.1:{ports[q]}"}) for q in parties},
            current_party=p,
        )
        return TransportManager(
            cc,
            JobConfig(device_put_received=False, zero_copy_host_arrays=True, local_link="auto"),
            device=device,
        )

    mgrs = {p: _mk(p) for p in parties}
    results: Dict[str, Any] = {}
    errors: Dict[str, BaseException] = {}
    try:
        for m in mgrs.values():
            m.start()

        def _coord() -> None:
            try:
                results[coordinator] = run_async_coordinator(
                    mgrs[coordinator], coordinator, members, params,
                    cycles=cycles, buffer_k=buffer_k, flush_s=flush_s,
                    wire_quant=wire_quant, chunk_elems=chunk_elems,
                    staleness_cap=staleness_cap, grid_retention=grid_retention,
                    server_opt=server_opt, stream=stream, timeout_s=timeout_s,
                    version_log=version_log, record_folds=record_folds,
                )
            # fedlint: disable=FED004 — transferred, not swallowed: the parent re-raises from the errors dict after join
            except BaseException as e:
                errors[coordinator] = e

        def _member(p: str) -> None:
            try:
                n = cycles if isinstance(cycles, int) else cycles[p]
                results[p] = run_async_party(
                    mgrs[p], p, coordinator, params, local_step_fn,
                    cycles=n, weight=(weights or {}).get(p, 1),
                    wire_quant=wire_quant, chunk_elems=chunk_elems,
                    stream=stream, timeout_s=timeout_s,
                )
            # fedlint: disable=FED004 — transferred, not swallowed: the parent re-raises from the errors dict after join
            except BaseException as e:
                errors[p] = e

        threads = [threading.Thread(target=_coord, daemon=True)] + [
            threading.Thread(target=_member, args=(p,), daemon=True) for p in members
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout_s)
        if errors:
            raise RuntimeError(f"async fleet failed: { {p: repr(e) for p, e in errors.items()} }")
        if any(t.is_alive() for t in threads):
            raise TimeoutError(f"async fleet did not complete within {timeout_s}s")
    finally:
        for m in mgrs.values():
            try:
                m.stop()
            except Exception:  # pragma: no cover
                logger.exception("async fleet manager stop failed")
    out = dict(results[coordinator])
    out["party_results"] = {p: results[p] for p in members}
    return out
