"""Streaming on-device aggregation of PackedTree contributions.

The classic FedAvg receive path waits for every party's payload, decodes N
trees and reduces once.  Here aggregation is fused into the receive path:
the transport surfaces payload bytes **as they land**
(``TransportManager.recv_stream`` → the server's chunk sinks), and a
:class:`StreamingAggregator` copies each complete block of the packed wire
buffer to its device and folds it into an f32 accumulator there while later
chunks are still on the wire.

Each block folds as one exactly rounded fused multiply-add per element,
``acc = fma(w, f32(x), acc)`` from a zeroed accumulator — the program XLA
compiles the JAX package's ``_accum_kernel`` into on the CPU: on the card
the fold kernel ``ops/csrc/fold_fma.cu`` (``__fmaf_rn``), on the CPU its
plain version (:func:`rayfed_tpu_torch.ops.fold.fma`).  Blocks fold in
**party order per block** (party ``i``'s block ``b`` only after parties
``0..i-1`` folded theirs), so arrival order only affects scheduling: the
streamed aggregate is byte-identical to the JAX package's streamed fold.

In compressed-domain mode (``quant=``, the round's
:class:`~rayfed_tpu_torch.fl.quantize.QuantGrid`) the contributions are
integer codes: each block folds into an i32 accumulator as an in-place
``acc[off:off+n] += w·q`` (exact, so any order gives the same bytes), every
wire contribution's grid is checked against the round's before the one
rescale (:func:`~rayfed_tpu_torch.fl.fedavg.finalize_packed_quantized`).

Quorum (k-of-n) mode (``quorum=``, :mod:`rayfed_tpu_torch.fl.quorum`): once
``result(deadline_s=)``'s deadline passes, or the missing contributions
provably cannot arrive, with at least ``quorum`` complete, the worker pins
the arrived set, reweights to its Σw, zeroes the accumulator and refolds the
retained payloads: the result equals the fold over that subset, byte for
byte.  :class:`StripeAggregator` folds one stripe of the chunk grid for the
ring (:mod:`rayfed_tpu_torch.fl.ring`) through the same fold.

On the card the fold runs on a stream of the aggregator's own; the result
is fenced onto the device's default stream before it is handed on
(:func:`~rayfed_tpu_torch.utils.platform.fence_for_handoff`), so the
transport's device→host copy of the broadcast sees finished bytes.

Presummed mode (``presummed=``, :mod:`rayfed_tpu_torch.fl.hierarchy`):
the sources are region partial sums ``Σ w_p·q_p``
(:class:`~rayfed_tpu_torch.fl.hierarchy.RegionSumTree`, int16 or int32)
with the weights already folded in, so each folds at unit weight into the
same i32 accumulator; ``weights`` are then the regions' integer totals, so
the finalize divides by the whole roster's Σw, exactly as the flat fold.

Masked mode (``masked=``, :mod:`rayfed_tpu_torch.fl.secagg`): the sources
are masked i32 codes ``w_i·q_i + net pairwise mask``, each folded at unit
weight (the party folded its own weight in), so the accumulator holds
``Σ w_i·q_i`` once the pair masks cancel; the float weights stay the true
ones for the cutoff's reweight and the finalize.  ``mask_recovery``
(quorum rounds) runs on the worker with the member labels before the
finalize and returns the orphaned-mask correction, subtracted in place from
the accumulator (:func:`~rayfed_tpu_torch.fl.fedavg.masked_correction_kernel`).

``streaming_aggregate`` is the multi-controller entry point: every party
calls it at the same program point with the same arguments; contributions
flow to the coordinator on named delta streams (only changed chunks cross
the wire round over round) and the result is broadcast back.
"""

from __future__ import annotations

import json
import logging
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from rayfed_tpu_torch.fl import fedavg
from rayfed_tpu_torch.fl.compression import PackedTree, dtype_name
from rayfed_tpu_torch.fl.fedavg import DEFAULT_CHUNK_ELEMS
from rayfed_tpu_torch.ops.fold import fold_fma_
from rayfed_tpu_torch.transport import wire
from rayfed_tpu_torch.utils.platform import fence_for_handoff, resolve_device

logger = logging.getLogger(__name__)

# A sink only wakes the aggregator worker after this many new bytes
# (or on completion) — per-64KB-read notifies would thrash the lock.
_NOTIFY_BYTES = 512 * 1024

# Seq ids one streaming_aggregate call consumes.
STREAM_AGG_SEQ_IDS = 2

# Most elements one fold call takes (16 of the round's 2^21-element
# blocks): a longer run folds piece by piece, so what a call stages and
# allocates stays bounded whatever the run's length (64 MiB of bf16 wire
# bytes, one pinned block and one device buffer; the integer fold's two i32
# temporaries, 128 MiB each).
_RUN_ELEMS = 1 << 25


def _fold_block(acc: torch.Tensor, off: int, chunk: torch.Tensor, w) -> None:
    """``acc[off:off+n] = fma(w, f32(x), acc[off:off+n])``, in place, rounded
    once: the fused multiply-add XLA compiles the JAX package's
    ``_accum_kernel`` into on the CPU; on the card one launch of the fold
    kernel's step form, whether ``chunk`` is one block or a run of them.
    ``w``: a host number (:func:`~rayfed_tpu_torch.ops.fold.f32_arg`)."""
    fold_fma_(acc[off : off + chunk.numel()], w, chunk)


class _Stream:
    """Receive state of one contribution."""

    __slots__ = (
        "payload", "avail_bytes", "complete", "local_tree", "elems",
        "ready", "data_start", "data_nbytes", "dtype", "itemsize",
        "applied_blocks", "t_complete", "notified_bytes", "error", "manifest",
    )

    def __init__(self) -> None:
        self.payload: Optional[memoryview] = None
        self.avail_bytes = 0
        self.complete = False
        self.local_tree = None  # coordinator's own PackedTree
        self.elems: Optional[torch.Tensor] = None  # its flat buffer
        self.ready = None  # CUDA event the local buffer's producer recorded
        self.data_start = -1  # byte offset of the packed buffer
        self.data_nbytes = -1
        self.dtype: Optional[torch.dtype] = None
        self.itemsize = 0
        self.applied_blocks = 0
        self.t_complete = 0.0
        self.notified_bytes = 0
        self.error: Optional[BaseException] = None  # quorum mode: a failed source
        self.manifest: Optional[Dict[str, Any]] = None  # the payload's, once parsed


class _StreamSink:
    """Transport-facing adapter: thread-safe, throttled notifies."""

    __slots__ = ("_agg", "_index")

    def __init__(self, agg: "StreamingAggregator", index: int) -> None:
        self._agg = agg
        self._index = index

    def on_bytes(self, view: memoryview, total: int) -> None:
        self._agg._on_bytes(self._index, view, total)

    def on_complete(self, payload) -> None:
        self._agg._on_complete(self._index, payload)

    def on_error(self, err: Any) -> None:
        self._agg._on_error(self._index, err)

    def on_frame_abort(self, corrupt: bool = False) -> None:
        self._agg._on_frame_abort(self._index, corrupt)


class StreamingAggregator:
    """Fold N PackedTree contributions into one as their bytes arrive.

    Usage (coordinator side)::

        agg = StreamingAggregator(n_sources=len(parties), weights=w)
        for i, party in enumerate(parties):
            transport.recv_stream(party, up_id, down_id, agg.sink(i))
        agg.add_local(my_index, my_packed_tree)   # no wire hop for self
        averaged = agg.result(timeout=60)         # PackedTree, wire dtype

    The reduce holds one f32 accumulator on ``device`` (default: the CUDA
    card; ``"cpu"`` only when asked) and one block per contribution at a
    time, never a list of decoded trees.  On a CUDA device the fold runs
    there or raises: it never carries on on the host.

    ``quorum``: k-of-n mode — see the module docstring and
    :meth:`result`'s ``deadline_s``.  ``labels`` name the sources in errors
    and in ``stats["quorum_failed_sources"]``.
    """

    def __init__(
        self,
        n_sources: int,
        weights: Optional[Sequence[float]] = None,
        allowed: Optional[Dict[str, Any]] = None,
        chunk_elems: int = DEFAULT_CHUNK_ELEMS,
        out_dtype: Any = None,
        quorum: Optional[int] = None,
        labels: Optional[Sequence[str]] = None,
        quant: Optional[Any] = None,
        quant_ref: Optional[Any] = None,
        masked: bool = False,
        mask_recovery: Optional[Any] = None,
        presummed: Optional[str] = None,
        party: Optional[str] = None,
        device: Any = None,
    ) -> None:
        if n_sources < 1:
            raise ValueError("streaming aggregation needs >= 1 source")
        self._party = None if party is None else str(party)
        if quorum is not None and not 1 <= int(quorum) <= n_sources:
            raise ValueError(f"quorum must be in [1, {n_sources}], got {quorum}")
        if labels is not None and len(labels) != n_sources:
            raise ValueError(f"{len(labels)} labels for {n_sources} sources")
        if weights is not None:
            if len(weights) != n_sources:
                raise ValueError(f"{len(weights)} weights for {n_sources} sources")
            self._weights = [float(w) for w in weights]
            self._total_w = fedavg._check_weights(self._weights)
        else:
            self._weights = [1.0] * n_sources
            self._total_w = float(n_sources)
        # Original arg (None vs explicit): the passthrough reduce must
        # take the same code path as packed_weighted_sum's.
        self._weights_arg = None if weights is None else list(self._weights)
        self._allowed = allowed
        self._out_name = None if out_dtype is None else dtype_name(out_dtype)
        self._chunk_elems = int(chunk_elems)
        self._device = resolve_device(device)
        # Compressed-domain mode: the round's grid; delta-coded rounds also
        # hold the shared reference buffer (flat f32 on this device) the
        # finalize adds back.  A StripeAggregator folds a block subset of
        # the grid and gets its stripe's slice of the reference; the base
        # class checks the full buffer's element count.
        self._quant = quant
        self._quant_full = True
        self._int_weights: Optional[List[int]] = None
        self._quant_ref: Optional[torch.Tensor] = None
        if quant is not None:
            if quant.mode == "delta":
                if quant_ref is None:
                    raise ValueError(
                        "a mode='delta' grid needs quant_ref= (the "
                        "round's shared reference buffer)"
                    )
                from rayfed_tpu_torch.fl.quantize import _f32_on

                self._quant_ref = _f32_on(
                    quant_ref.buf if isinstance(quant_ref, PackedTree) else quant_ref,
                    self._device,
                )
            elif quant_ref is not None:
                raise ValueError("quant_ref only applies to mode='delta' grids")
            if self._chunk_elems != int(quant.chunk_elems):
                raise ValueError(
                    f"fold grid ({self._chunk_elems} elems/block) must "
                    f"match the quantization grid "
                    f"({quant.chunk_elems}) — both ARE the canonical "
                    f"packed_block_grid chunking"
                )
            iw, itotal = fedavg.quant_weights(weights, n_sources)
            quant.check_weight_headroom(itotal)
            self._int_weights = iw
            # Integer totals are exact in f32 up to the headroom bound.
            self._weights = [float(w) for w in iw]
            self._total_w = float(itotal)
        # Masked mode: unit-weight folds of masked codes; the float weights
        # above stay the true counts (the cutoff's reweight and the
        # finalize see the unmasked round's numbers).
        self._masked = bool(masked)
        self._mask_recovery = mask_recovery
        if self._masked and quant is None:
            raise ValueError(
                "masked aggregation requires quant= (the round's shared "
                "grid) — masks live in the integer domain"
            )
        if mask_recovery is not None and not self._masked:
            raise ValueError("mask_recovery only applies with masked=True")
        # Presummed (hierarchy) mode names the partial sums' integer wire
        # dtype (fl.hierarchy.partial_sum_dtype).
        self._presummed = None if presummed is None else str(presummed)
        if self._presummed is not None:
            if quant is None:
                raise ValueError(
                    "presummed aggregation requires quant= (the round's "
                    "shared grid) — partial sums live in its integer "
                    "domain"
                )
            if self._masked:
                raise ValueError(
                    "presummed and masked are mutually exclusive (a "
                    "region partial sum is already an unmaskable fold)"
                )
            if np.dtype(self._presummed).kind != "i":
                raise ValueError(
                    f"presummed= names the partial-sum integer wire "
                    f"dtype, got {self._presummed!r}"
                )
        self._stream = (
            torch.cuda.Stream(self._device) if self._device.type == "cuda" else None
        )
        self._n = n_sources
        self._streams = [_Stream() for _ in range(n_sources)]
        self._quorum = None if quorum is None else int(quorum)
        self._labels = (
            [str(x) for x in labels]
            if labels is not None
            else [f"source {i}" for i in range(n_sources)]
        )
        # Sorted indices of the contributions aggregated; None until a
        # quorum cutoff excludes someone.
        self._participating: Optional[List[int]] = None
        self._deadline_at: Optional[float] = None  # monotonic cutoff time
        # Set by a transport thread that needs the fold rolled back (a
        # corrupt mid-fold stream under quorum); consumed by the worker,
        # the only thread that touches the accumulator.
        self._needs_reset = False
        self._cond = threading.Condition()
        self._acc: Optional[torch.Tensor] = None
        self._total_elems = -1
        self._nblocks = -1
        self._wire_dtype: Optional[torch.dtype] = None
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self._done = False
        self._worker: Optional[threading.Thread] = None
        # Timing for the overlap metric.
        self._t_first_byte = 0.0
        self._t_all_complete = 0.0
        self._t_done = 0.0
        self._busy_s = 0.0
        self.stats: Dict[str, Any] = {}

    # -- source attachment ----------------------------------------------------

    def sink(self, index: int) -> _StreamSink:
        """The chunk sink for source ``index`` (hand to recv_stream)."""
        self._ensure_worker()
        return _StreamSink(self, index)

    def add_local(self, index: int, packed_tree: Any) -> None:
        """Feed the coordinator's own contribution (no wire hop).

        Its buffer stays where it is when it lies on the aggregator's card
        (a CUDA tensor, a CPU tensor or a numpy array are all accepted);
        the fold waits for the work the calling thread queued before it.
        """
        from rayfed_tpu_torch.fl.quantize import QuantizedPackedTree

        if not isinstance(packed_tree, PackedTree):
            self.fail(
                TypeError(
                    "streaming aggregation consumes PackedTree "
                    f"contributions, got {type(packed_tree).__name__} — "
                    "produce updates with fl.compress(tree, packed=True)"
                )
            )
            return
        if self._quant is not None:
            if not isinstance(packed_tree, QuantizedPackedTree):
                self.fail(
                    TypeError(
                        "compressed-domain aggregation consumes "
                        "QuantizedPackedTree contributions — quantize "
                        "onto the round grid first (fl.quantize)"
                    )
                )
                return
            from rayfed_tpu_torch.fl.secagg import MaskedCodeTree

            if self._masked != isinstance(packed_tree, MaskedCodeTree):
                self.fail(
                    TypeError(
                        "masked fold got an unmasked contribution"
                        if self._masked else
                        "got a MaskedCodeTree but this aggregator is "
                        "not masked — construct it with masked=True "
                        "(fl.secagg) or send plain quantized codes"
                    )
                )
                return
            from rayfed_tpu_torch.fl.hierarchy import RegionSumTree

            if (self._presummed is not None) != isinstance(packed_tree, RegionSumTree):
                self.fail(
                    TypeError(
                        "presummed fold got a per-party contribution "
                        "(expected a RegionSumTree partial sum)"
                        if self._presummed is not None else
                        "got a RegionSumTree but this aggregator is "
                        "not presummed — construct it with presummed= "
                        "(fl.hierarchy) or send per-party codes"
                    )
                )
                return
            if packed_tree.gmeta != self._quant.meta():
                self.fail(
                    ValueError(
                        f"local contribution {index} was coded on a "
                        f"different grid (fp={packed_tree.gmeta.fp:#010x}"
                        f" vs {self._quant.fingerprint():#010x})"
                    )
                )
                return
        elif isinstance(packed_tree, QuantizedPackedTree):
            self.fail(
                TypeError(
                    "got a QuantizedPackedTree but no quant= grid — "
                    "construct the aggregator with the round's "
                    "QuantGrid to fold in the compressed domain"
                )
            )
            return
        self._attach_local(index, packed_tree.buf, tree=packed_tree)

    def _attach_local(self, index: int, buf: Any, tree: Any = None) -> None:
        """Bind a contribution that needs no wire hop (a buffer on any
        device, or a host array)."""
        try:
            elems = fedavg.as_tensor(buf, self._device).reshape(-1)
            ready = None
            if self._stream is not None:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self._device))
                elems.record_stream(self._stream)
        except Exception as e:  # transferred: fail(e) poisons every waiter
            self.fail(e)
            return
        self._ensure_worker()
        now = time.perf_counter()
        with self._cond:
            s = self._streams[index]
            s.local_tree = tree
            s.elems = elems
            s.ready = ready
            s.dtype = elems.dtype
            s.itemsize = elems.element_size()
            s.data_start = 0
            s.data_nbytes = elems.numel() * s.itemsize
            s.avail_bytes = s.data_nbytes
            s.complete = True
            s.t_complete = now
            if not self._t_first_byte:
                self._t_first_byte = now
            self._cond.notify_all()

    def fail(self, exc: BaseException) -> None:
        with self._cond:
            if self._error is None:
                self._error = exc
            self._cond.notify_all()

    # -- sink callbacks (transport threads) -----------------------------------

    def _on_bytes(self, index: int, view: memoryview, total: int) -> None:
        # ``view`` is the frame's full payload buffer and ``total`` the
        # CONTIGUOUS bytes available from offset 0 (a growing verified
        # prefix on multi-rail stripe frames) — the fold only ever reads a
        # true prefix.  All state writes happen under the lock; only the
        # worker wake is throttled.
        s = self._streams[index]
        with self._cond:
            if s.complete:
                return
            if s.payload is not None and s.payload.obj is not view.obj:
                # A retry frame with a fresh buffer: drop the stale
                # binding (applied blocks stay — a retry resends the
                # identical payload, so they remain a valid prefix).
                self._reset_frame(s)
            if s.payload is None:
                s.payload = view
                if not self._t_first_byte:
                    self._t_first_byte = time.perf_counter()
                s.avail_bytes = total
            else:
                s.avail_bytes = max(s.avail_bytes, total)
            if total - s.notified_bytes >= _NOTIFY_BYTES:
                s.notified_bytes = total
                self._cond.notify_all()

    def _on_complete(self, index: int, payload) -> None:
        now = time.perf_counter()
        with self._cond:
            s = self._streams[index]
            if s.error is not None:
                # A stream that failed earlier delivered clean bytes (the
                # sender's retry or the party's revival won): it rejoins
                # the fold pool, or the ordered fold would stall at it.
                logger.info(
                    "contribution from %s recovered (clean retry after %s)",
                    self._labels[index], s.error,
                )
                s.error = None
            # Delta frames (and mailbox replays) deliver a payload object
            # the incremental view never saw — rebind.
            s.payload = memoryview(payload)
            s.avail_bytes = len(s.payload)
            s.complete = True
            s.t_complete = now
            if not self._t_first_byte:
                self._t_first_byte = now
            self._cond.notify_all()

    def _on_error(self, index: int, err: Any) -> None:
        from rayfed_tpu_torch.exceptions import RemoteError

        if isinstance(err, BaseException):
            exc: BaseException = err
        else:
            try:
                exc = RemoteError.from_wire(err)
            except Exception:
                exc = RuntimeError(f"stream {index} failed: {err!r}")
        if self._quorum is None:
            self.fail(exc)
            return
        # Quorum mode: one failed contribution is survivable — mark it and
        # let the cutoff aggregate the rest.  The give-up verdict belongs to
        # the deadline (_maybe_cutoff_locked): an error may clear.
        with self._cond:
            s = self._streams[index]
            if s.complete or s.error is not None:
                return
            s.error = exc
            logger.warning(
                "contribution from %s failed (%s); continuing toward "
                "quorum %d/%d", self._labels[index], exc, self._quorum, self._n,
            )
            self._cond.notify_all()

    @staticmethod
    def _reset_frame(s: _Stream) -> None:
        """Forget a dead frame's buffer; keep the applied-block prefix
        (a sender retry re-sends the identical payload bytes)."""
        s.payload = None
        s.avail_bytes = 0
        s.notified_bytes = 0
        s.data_start = -1
        s.data_nbytes = -1
        s.dtype = None

    def _on_frame_abort(self, index: int, corrupt: bool) -> None:
        """The in-flight frame died (connection drop) or failed
        verification.  A clean drop resets the frame state and waits for
        the sender's retry; a CORRUPT frame whose bytes were already
        folded cannot be rolled back out of the accumulator — fail the
        aggregation loudly, unless quorum mode can refold the others."""
        with self._cond:
            s = self._streams[index]
            if s.complete:
                return
            if corrupt and s.applied_blocks > 0:
                if self._quorum is not None:
                    # Excluded and refolded: the worker zeroes the
                    # accumulator and refolds the healthy contributions
                    # from their retained payloads.
                    s.error = RuntimeError(
                        f"contribution from {self._labels[index]} failed "
                        f"verification mid-fold; excluded and refolding"
                    )
                    self._reset_frame(s)
                    self._needs_reset = True
                else:
                    self._error = RuntimeError(
                        f"contribution {index} failed verification after "
                        f"{s.applied_blocks} of its blocks were already "
                        f"aggregated — the accumulator cannot be rolled back; "
                        f"re-run the round"
                    )
            else:
                self._reset_frame(s)
            self._cond.notify_all()

    def _reset_fold_locked(self) -> None:
        """Zero the accumulator and forget all applied blocks (cutoff /
        quorum rollback); the retained payloads and local buffers are the
        refold's sources — no bytes cross the wire again."""
        if self._acc is not None:
            self._acc = torch.zeros_like(self._acc)
        for s in self._streams:
            s.applied_blocks = 0

    def _maybe_cutoff_locked(self) -> None:
        """Quorum cutoff (worker loop, under the lock): once the deadline
        passes — or the missing contributions provably cannot arrive —
        with at least ``quorum`` complete, pin the arrived set, reweight to
        its Σw and refold.  All arrived never reaches here with a subset,
        so quorum=n with no faults is the all-of-n fold."""
        if self._quorum is None or self._participating is not None:
            return
        # Ready = complete and healthy: the cutoff never pins a failed
        # stream into the fold set.
        ready = [i for i, s in enumerate(self._streams) if s.complete and s.error is None]
        if len(ready) == self._n:
            return
        failed = sum(1 for s in self._streams if s.error is not None)
        deadline_hit = self._deadline_at is not None and time.monotonic() >= self._deadline_at
        if len(ready) < self._quorum:
            # Give up only at the deadline, when even the pending healthy
            # streams could not fill the quorum.
            pending = self._n - len(ready) - failed
            if deadline_hit and len(ready) + pending < self._quorum and self._error is None:
                failed_names = [self._labels[i] for i, s in enumerate(self._streams) if s.error is not None]
                exc: BaseException = RuntimeError(
                    f"quorum {self._quorum}/{self._n} unreachable: only "
                    f"{len(ready)} contributions arrived by the round "
                    f"deadline and those from {failed_names} failed"
                )
                for s in self._streams:
                    if s.error is not None:
                        exc.__cause__ = s.error
                        break
                self._error = exc
                self._cond.notify_all()
            return
        if not deadline_hit and not (failed and len(ready) + failed == self._n):
            return
        self._participating = ready  # sorted by construction
        excluded = [self._labels[i] for i in range(self._n) if i not in set(ready)]
        logger.warning(
            "quorum cutoff: aggregating %d/%d contributions (excluded: %s); "
            "reweighting to the arrived sum", len(ready), self._n, excluded,
        )
        from rayfed_tpu_torch import telemetry

        telemetry.event(
            "quorum.cutoff", party=self._party,
            detail={"members": [self._labels[i] for i in ready], "excluded": excluded},
        )
        if self._weights_arg is not None:
            self._total_w = fedavg._check_weights([self._weights[i] for i in ready])
        else:
            self._total_w = float(len(ready))
        # Partial folds may hold excluded streams' blocks: restart from zero
        # over the pinned set in party order — the subset's fold.
        self._reset_fold_locked()

    # -- result ---------------------------------------------------------------

    def result(self, timeout: Optional[float] = None, deadline_s: Optional[float] = None):
        """Block until every contribution streamed in; the aggregate as a
        :class:`~rayfed_tpu_torch.fl.compression.PackedTree` in the wire
        dtype (or ``out_dtype``), its buffer on the aggregator's device.

        ``deadline_s`` (quorum mode only): seconds from this call after
        which the wait stops for stragglers — once at least ``quorum``
        contributions are complete, the worker cuts the round over to the
        arrived set (reweighted to its Σw).  Its granularity is the
        worker's wake interval (≤ 0.5 s past the deadline)."""
        if deadline_s is not None and self._quorum is None:
            raise ValueError("deadline_s needs quorum= at construction")
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            if deadline_s is not None and self._deadline_at is None:
                self._deadline_at = time.monotonic() + float(deadline_s)
                self._cond.notify_all()  # the worker re-times its waits
            while not self._done and self._error is None:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        from rayfed_tpu_torch.exceptions import PartyWaitTimeout

                        self._error = PartyWaitTimeout(
                            f"streaming aggregation timed out after {timeout}s",
                            missing_parties=[
                                self._labels[i]
                                for i, s in enumerate(self._streams)
                                if not s.complete
                            ],
                        )
                        self._cond.notify_all()
                        break
                self._cond.wait(timeout=remaining)
            if self._error is not None:
                raise self._error
            return self._result

    @property
    def quorum_members(self) -> List[int]:
        """Sorted indices of the contributions the aggregate includes (all
        of them unless a quorum cutoff excluded stragglers).  Meaningful
        once :meth:`result` returned."""
        with self._cond:
            if self._participating is not None:
                return list(self._participating)
            return list(range(self._n))

    @property
    def agg_overlap_frac(self) -> float:
        """Fraction of aggregation busy time hidden under the wire."""
        return self.stats.get("agg_overlap_frac", 0.0)

    def _members(self) -> List[int]:
        return self._participating if self._participating is not None else list(range(self._n))

    # -- worker ---------------------------------------------------------------

    def _ensure_worker(self) -> None:
        with self._cond:
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._run, name="rayfed-stream-agg", daemon=True
                )
                self._worker.start()

    def _parse_layout(self, s: _Stream) -> bool:
        """Locate the packed buffer inside the payload (needs only the
        manifest + skeleton-length prefix, i.e. the first chunk)."""
        if s.data_start >= 0:
            return True
        if s.payload is None or s.avail_bytes < 4:
            return False
        mv = s.payload
        (mlen,) = struct.unpack(">I", bytes(mv[:4]))
        if s.avail_bytes < 4 + mlen:
            return False
        manifest = json.loads(bytes(mv[4 : 4 + mlen]))
        s.manifest = manifest  # sideband consumers (StripeAggregator)
        leaves = manifest["leaves"]
        if not leaves or leaves[0]["k"] not in ("nd", "nds"):
            raise ValueError(
                "streaming aggregation expects a PackedTree payload "
                "(leaf 0 must be the packed wire buffer) — produce "
                "updates with fl.compress(tree, packed=True)"
            )
        spec = leaves[0]
        if spec["k"] == "nd":
            nbytes = spec["n"]
        else:
            nbytes = sum(e["n"] for e in spec["shards"])
        # The dtype through the torch table: numpy has no bfloat16 of its own.
        dt = wire._torch_dtype(spec["dtype"])
        s.data_start = 4 + mlen + manifest["skel"]
        s.data_nbytes = nbytes
        s.itemsize = torch.empty(0, dtype=dt).element_size()
        s.dtype = dt
        return True

    def _init_acc(self, s: _Stream) -> None:
        if s.data_nbytes % s.itemsize:
            raise ValueError("packed buffer not a whole element count")
        self._total_elems = s.data_nbytes // s.itemsize
        if self._total_elems >= 2**31:
            # The reference's fold offsets ride int32; the same limit holds
            # here so a round means the same thing on both packages.
            raise ValueError(
                f"packed buffer has {self._total_elems} elements — "
                f"streaming aggregation supports < 2**31 elements per "
                f"buffer; split the tree into multiple packed buffers"
            )
        self._wire_dtype = s.dtype
        self._nblocks = fedavg.packed_block_grid(self._total_elems, self._chunk_elems)
        if self._quant is None:
            self._acc = torch.zeros(self._total_elems, dtype=torch.float32, device=self._device)
            return
        # Masked rounds widen the codes to i32 (the ring of the masks);
        # presummed rounds carry partial sums at their own integer width.
        from rayfed_tpu_torch.fl.secagg import MASKED_WIRE_DTYPE

        if self._masked:
            want_dt, mode_name = MASKED_WIRE_DTYPE, "masked"
        elif self._presummed is not None:
            want_dt, mode_name = self._presummed, "presummed"
        else:
            want_dt, mode_name = self._quant.wire_dtype, "plain"
        if dtype_name(s.dtype) != want_dt:
            raise ValueError(
                f"compressed-domain contribution carries "
                f"{dtype_name(s.dtype)} codes, this round folds "
                f"{want_dt} ({mode_name} mode) — "
                f"sender and receiver disagree on the round shape"
            )
        if self._quant_full and self._total_elems != self._quant.total_elems:
            raise ValueError(
                f"contribution has {self._total_elems} codes, the "
                f"round grid covers {self._quant.total_elems} — "
                f"all parties must quantize the identical packed "
                f"layout"
            )
        # Padded onto the block grid, the shape the finalize reshapes.
        self._acc = torch.zeros(
            self._nblocks * self._chunk_elems, dtype=torch.int32, device=self._device
        )

    def _avail_blocks(self, s: _Stream) -> int:
        if s.complete:
            return self._nblocks
        if s.data_start < 0 or s.dtype is None:
            return 0
        avail_elems = max(
            0, (min(s.avail_bytes, s.data_start + s.data_nbytes) - s.data_start)
            // s.itemsize
        )
        return min(self._nblocks, avail_elems // self._chunk_elems)

    def _run_elems(self, src: tuple, lo: int, hi: int) -> torch.Tensor:
        """The wire elements of blocks ``[lo, hi)`` (at most
        :data:`_RUN_ELEMS` of them) on the aggregator's device, as one
        tensor: the blocks of a run are contiguous in the source as in the
        accumulator, so they fold in one launch.

        ``src`` is an under-the-lock snapshot of the stream's ``(elems,
        payload, dtype, itemsize, data_start)``: a concurrent frame abort
        may null the live fields mid-fold, but the snapshot's bytes are a
        stable valid prefix of the payload (a retry resends identical
        bytes).  Payload bytes are read through ``uint8`` and viewed as the
        wire dtype, then copied to the device."""
        elems, payload, dt, itemsize, data_start = src
        ce = self._chunk_elems
        first = lo * ce
        count = min(hi * ce, self._total_elems) - first
        if elems is not None:
            return elems[first : first + count]
        start = data_start + first * itemsize
        region = payload[start : start + count * itemsize]
        if self._stream is not None:
            # Through a pinned block, so the copy to the card queues on the
            # fold's stream without holding this thread (the caching host
            # allocator keeps the block until the copy has run, then hands
            # it out again for a later piece of the same size).
            host = torch.empty(region.nbytes, dtype=torch.uint8, pin_memory=True)
            host.numpy()[:] = np.frombuffer(region, dtype=np.uint8)
            return host.view(dt).to(self._device, non_blocking=True)
        if region.readonly:
            return torch.from_numpy(np.frombuffer(region, dtype=np.uint8).copy()).view(dt)
        return torch.frombuffer(region, dtype=torch.uint8).view(dt)

    def _run(self) -> None:
        try:
            if self._stream is not None:
                with torch.cuda.stream(self._stream):
                    self._run_inner()
            else:
                self._run_inner()
        except Exception as e:  # transferred: fail(e) poisons every waiter
            logger.exception("streaming aggregator worker failed")
            self.fail(e)

    def _run_inner(self) -> None:
        weights = None
        while True:
            with self._cond:
                if self._error is not None:
                    return
                if self._needs_reset:
                    self._needs_reset = False
                    self._reset_fold_locked()
                self._maybe_cutoff_locked()
                # The fold set: every stream, or the pinned quorum subset
                # (excluded stragglers are ignored even if bytes arrive).
                order = self._members()
                work: List[tuple] = []
                try:
                    for i in order:
                        s = self._streams[i]
                        if s.error is not None:
                            continue
                        if s.dtype is None and not self._parse_layout(s):
                            continue
                        if self._acc is None:
                            self._init_acc(s)
                        if (
                            s.data_nbytes != self._total_elems * s.itemsize
                            or s.dtype != self._wire_dtype
                        ):
                            raise ValueError(
                                f"contribution {i} layout mismatch: "
                                f"{s.data_nbytes}B {s.dtype} vs "
                                f"{self._total_elems} elems of "
                                f"{self._wire_dtype} — all parties must "
                                f"pack the same tree structure"
                            )
                except Exception as e:
                    self._error = e
                    self._cond.notify_all()
                    return
                if self._acc is not None:
                    # Party-order-per-block schedule: stream i may fold
                    # block b only once every earlier stream of the fold
                    # set folded theirs — the result is then independent of
                    # arrival order.  A failed stream stalls its successors
                    # until the cutoff excludes it.  The chunk source is
                    # snapshotted HERE, under the lock (see _run_elems).
                    limit = self._nblocks
                    for i in order:
                        s = self._streams[i]
                        if s.error is not None:
                            break
                        target = min(self._avail_blocks(s), limit)
                        if target > s.applied_blocks:
                            work.append((
                                i, s.applied_blocks, target,
                                (s.elems, s.payload, s.dtype, s.itemsize, s.data_start),
                                s.ready,
                            ))
                        limit = s.applied_blocks
                all_complete = all(self._streams[i].complete for i in order) and (
                    self._participating is not None
                    or not any(s.error is not None for s in self._streams)
                )
                if not work:
                    if all_complete and self._acc is not None and all(
                        self._streams[i].applied_blocks == self._nblocks for i in order
                    ):
                        break  # everything folded — finalize below
                    wait_s = 0.5
                    if self._deadline_at is not None and self._participating is None:
                        wait_s = min(wait_s, max(0.05, self._deadline_at - time.monotonic()))
                    self._cond.wait(timeout=wait_s)
                    continue
                if all_complete and not self._t_all_complete:
                    self._t_all_complete = max(self._streams[i].t_complete for i in order)
            # Apply outside the lock (sinks keep landing bytes meanwhile).
            if weights is None:
                if self._masked or self._presummed is not None:
                    # A masked code carries its party's own weight (pair
                    # masks cancel only at unit fold weight), a partial sum
                    # Σ w_p·q_p: both fold at weight 1.
                    weights, fold = [1] * self._n, fedavg.quantized_accum_kernel
                elif self._int_weights is not None:
                    weights, fold = self._int_weights, fedavg.quantized_accum_kernel
                else:
                    weights, fold = list(self._weights), _fold_block
            piece = max(1, _RUN_ELEMS // self._chunk_elems)
            for i, lo, hi, src, ready in work:
                if ready is not None:
                    self._stream.wait_event(ready)
                # The run of blocks [lo, hi) folds a piece of at most
                # _RUN_ELEMS at a time: the order per element (party i after
                # parties 0..i-1) is the limit's.
                for a in range(lo, hi, piece):
                    b = min(a + piece, hi)
                    t0 = time.perf_counter()
                    fold(self._acc, a * self._chunk_elems, self._run_elems(src, a, b), weights[i])
                    self._busy_s += time.perf_counter() - t0
                    with self._cond:
                        self._streams[i].applied_blocks = b

        t0 = time.perf_counter()
        t0_wall = time.time()
        result = self._finalize()
        fin_s = time.perf_counter() - t0
        self._busy_s += fin_s
        self._t_done = time.perf_counter()
        if not self._t_all_complete:
            self._t_all_complete = self._t_done
        tail_s = max(0.0, self._t_done - self._t_all_complete)
        busy = max(self._busy_s, 1e-9)
        excluded = 0 if self._participating is None else self._n - len(self._participating)
        from rayfed_tpu_torch import telemetry as _telemetry

        _tr = _telemetry.active()
        if _tr is not None:
            # The fold window (first byte → every block folded) and the
            # single finalize, as spans.
            now_p, now_w = time.perf_counter(), time.time()
            if self._t_first_byte:
                _tr.emit(
                    "agg.fold",
                    party=self._party,
                    t_start=now_w - (now_p - self._t_first_byte),
                    dur_s=max(0.0, self._t_all_complete - self._t_first_byte),
                    detail={
                        "busy_ms": round(self._busy_s * 1e3, 3),
                        "parties": len(self._streams),
                    },
                )
            _tr.emit(
                "agg.finalize", party=self._party,
                t_start=t0_wall, dur_s=fin_s, detail={"excluded": excluded},
            )
        self.stats = {
            "agg_busy_s": self._busy_s,
            "agg_tail_s": tail_s,
            "agg_wire_s": max(0.0, self._t_all_complete - self._t_first_byte),
            "agg_overlap_frac": min(1.0, max(0.0, 1.0 - tail_s / busy)),
            "quorum_excluded": excluded,
            # Sources cut with a standing error (dead party, failed
            # verification), as against merely late ones.
            "quorum_failed_sources": [
                self._labels[i] for i, s in enumerate(self._streams) if s.error is not None
            ],
        }
        with self._cond:
            self._result = result
            self._done = True
            self._cond.notify_all()

    def _finalize(self) -> PackedTree:
        """Divide + cast once, rebuild the PackedTree around the aggregated
        buffer (spec/passthrough from one template contribution — they are
        structural, identical across parties).  On the card the result is
        fenced onto the default stream before any other thread sees it."""
        members = self._members()
        if self._quant is not None:
            # Every wire payload's grid is checked first: wrong-grid codes
            # must never rescale.
            self._verify_quant_members(members)
            if self._masked and self._mask_recovery is not None:
                # Dropout mask recovery (quorum rounds): the hook runs the
                # announce/reply round trip with the members and returns the
                # orphaned-mask correction, subtracted before the rescale
                # (this worker is the only thread that touches the
                # accumulator).  With no dropout it still announces the
                # member set and returns None.
                corr = self._mask_recovery([self._labels[i] for i in members])
                if corr is not None:
                    corr = np.asarray(corr, np.uint32).reshape(-1)
                    if corr.size != self._total_elems:
                        raise ValueError(
                            f"mask correction covers {corr.size} "
                            f"elements, round folds {self._total_elems}"
                        )
                    pad = self._nblocks * self._chunk_elems - corr.size
                    if pad:
                        corr = np.concatenate([corr, np.zeros(pad, np.uint32)])
                    fedavg.masked_correction_kernel(self._acc, corr)
            out_name = self._out_name or "float32"
            out_buf = fedavg.finalize_packed_quantized(
                self._acc, self._quant.scales, self._quant.zps, self._total_w,
                self._total_elems, self._chunk_elems, out_name, ref=self._quant_ref,
            )
        else:
            out_name = self._out_name or dtype_name(self._wire_dtype)
            out_buf = fedavg.finalize_packed_stripe(
                self._acc, self._total_w, self._total_elems, out_name
            )
        self._acc = None
        if self._stream is not None:
            fence_for_handoff(out_buf)
        template = self._template_tree()
        passthrough = template.passthrough
        if passthrough:
            # After a cutoff only the members' trees reduce, with their
            # weights.
            passthrough = fedavg._reduce_passthrough(
                [self._tree_of(self._streams[i]).passthrough for i in members],
                None if self._weights_arg is None else [self._weights[i] for i in members],
                self._total_w,
            )
        return fedavg._packed_result(out_buf, passthrough, template.spec, out_name)

    def _verify_quant_members(self, members: Sequence[int]) -> None:
        """Every member wire contribution must be a QuantizedPackedTree
        coded on exactly the round grid (local ones were checked at
        ``add_local``)."""
        from rayfed_tpu_torch.fl.hierarchy import RegionSumTree
        from rayfed_tpu_torch.fl.quantize import QuantizedPackedTree
        from rayfed_tpu_torch.fl.secagg import MaskedCodeTree

        want = self._quant.meta()
        for i in members:
            s = self._streams[i]
            if s.local_tree is not None:
                continue
            tree = self._tree_of(s)
            if not isinstance(tree, QuantizedPackedTree):
                raise TypeError(
                    f"contribution from {self._labels[i]} is not a "
                    f"QuantizedPackedTree — all parties must quantize "
                    f"onto the round's shared grid"
                )
            if self._masked != isinstance(tree, MaskedCodeTree):
                raise TypeError(
                    f"contribution from {self._labels[i]} is "
                    f"{'unmasked' if self._masked else 'masked'} but "
                    f"this round folds "
                    f"{'masked' if self._masked else 'plain'} codes — "
                    f"all parties must agree on secure_agg for the round"
                )
            if (self._presummed is not None) != isinstance(tree, RegionSumTree):
                raise TypeError(
                    f"contribution from {self._labels[i]} is "
                    f"{'a per-party code tree' if self._presummed is not None else 'a RegionSumTree partial sum'}"
                    f" but this fold is "
                    f"{'presummed' if self._presummed is not None else 'per-party'}"
                    f" — hierarchy levels must agree on the round shape"
                )
            if tree.gmeta != want:
                raise ValueError(
                    f"contribution from {self._labels[i]} was coded on "
                    f"a different grid (fp={tree.gmeta.fp:#010x} vs "
                    f"{want.fp:#010x}) — aborting before the rescale; "
                    f"re-run the round on one grid"
                )

    def _tree_of(self, s: _Stream) -> PackedTree:
        if s.local_tree is not None:
            return s.local_tree
        tree = wire.decode_payload(s.payload, allowed=self._allowed, zero_copy=True)
        if not isinstance(tree, PackedTree):
            raise TypeError(
                "streaming aggregation consumes PackedTree payloads, got "
                f"{type(tree).__name__}"
            )
        return tree

    def _template_tree(self) -> PackedTree:
        members = self._members()
        for i in members:
            if self._streams[i].local_tree is not None:
                return self._streams[i].local_tree
        return self._tree_of(self._streams[members[0]])


class StripeAggregator(StreamingAggregator):
    """Fold one *stripe* of the packed chunk grid as its bytes arrive.

    The ring (:mod:`rayfed_tpu_torch.fl.ring`) stripes the packed buffer's
    chunk grid across the sorted party ring; each stripe owner runs one of
    these over the compacted stripe payloads its peers send (leaf 0 of each
    payload is the stripe's chunks back to back, in ascending block order).
    The sinks, the frame-abort semantics and the party-order-per-block fold
    schedule are :class:`StreamingAggregator`'s, and so is the fold: one
    exactly rounded FMA per element (``fold_fma.cu`` on the card).  Both the
    fold and the finalize are elementwise, so the stripe result is
    byte-identical to the same element range of the whole-buffer fold.

    ``expect_elems``: the stripe's element count from the schedule — a
    mis-wired payload fails fast.  ``meta_check``: called with the
    payload's ``rsm`` manifest string (its last leaf) before any of its
    blocks fold.  ``quant_blocks``: a compressed-domain stripe's global
    block indices, which select its rows of the round grid for the
    finalize; ``quant_ref`` is then the stripe's slice of the reference.
    """

    def __init__(
        self,
        n_sources: int,
        weights: Optional[Sequence[float]] = None,
        allowed: Optional[Dict[str, Any]] = None,
        chunk_elems: int = DEFAULT_CHUNK_ELEMS,
        out_dtype: Any = None,
        expect_elems: Optional[int] = None,
        label: str = "stripe",
        meta_check: Optional[Any] = None,
        quant: Optional[Any] = None,
        quant_blocks: Optional[Sequence[int]] = None,
        quant_ref: Optional[Any] = None,
        party: Optional[str] = None,
        device: Any = None,
    ) -> None:
        super().__init__(
            n_sources, weights=weights, allowed=allowed,
            chunk_elems=chunk_elems, out_dtype=out_dtype, party=party,
            quant=quant, quant_ref=quant_ref, device=device,
        )
        self._expect_elems = None if expect_elems is None else int(expect_elems)
        self._label = label
        self._meta_check = meta_check
        # Stripe payloads are bare code arrays (grid agreement is the
        # ring's rsm cross-check), so the full-buffer checks are skipped.
        self._quant_full = False
        if quant is not None and quant_blocks is None:
            raise ValueError(
                f"{label}: compressed-domain stripes need quant_blocks "
                f"(the stripe's global block indices)"
            )
        self._quant_blocks = None if quant_blocks is None else [int(b) for b in quant_blocks]

    def _parse_layout(self, s: _Stream) -> bool:
        already = s.data_start >= 0
        if not super()._parse_layout(s):
            return False
        if self._meta_check is not None and not already and s.manifest is not None:
            # Wire payloads only (the owner's own stripe has no manifest);
            # once, before any of its blocks fold.
            last = s.manifest["leaves"][-1]
            if last.get("k") != "py" or not isinstance(last.get("v"), str):
                raise ValueError(f"{self._label}: stripe payload is missing its 'rsm' manifest leaf")
            self._meta_check(last["v"])
        return True

    def add_local(self, index: int, stripe: Any) -> None:
        """Feed the owner's own stripe (a 1-D wire-dtype tensor, on any
        device, or host array)."""
        n = stripe.numel() if isinstance(stripe, torch.Tensor) else int(np.asarray(stripe).size)
        if self._expect_elems is not None and n != self._expect_elems:
            self.fail(
                ValueError(
                    f"{self._label}: local stripe has {n} elements, "
                    f"schedule expects {self._expect_elems}"
                )
            )
            return
        if self._quant is not None:
            got = dtype_name(stripe.dtype if isinstance(stripe, torch.Tensor) else np.asarray(stripe).dtype)
            if got != self._quant.wire_dtype:
                self.fail(
                    ValueError(
                        f"{self._label}: local stripe is {got}, the "
                        f"round grid codes {self._quant.wire_dtype}"
                    )
                )
                return
        self._attach_local(index, stripe)

    def _init_acc(self, s: _Stream) -> None:
        super()._init_acc(s)
        if self._expect_elems is not None and self._total_elems != self._expect_elems:
            raise ValueError(
                f"{self._label}: contribution carries "
                f"{self._total_elems} elements, schedule expects "
                f"{self._expect_elems} — ring peers disagree on the "
                f"stripe layout"
            )

    def payload_value(self, index: int) -> Any:
        """The decoded payload of source ``index`` (the stripe dict with
        its sideband fields), None for the owner's own source."""
        s = self._streams[index]
        if s.payload is None:
            return None
        return wire.decode_payload(s.payload, allowed=self._allowed, zero_copy=True)

    def _finalize(self) -> torch.Tensor:
        """The bare stripe buffer in the output dtype, on the aggregator's
        device: the assembly scatters it back onto the chunk grid."""
        if self._quant is not None:
            # Stripe block i of the compacted payload IS global block
            # quant_blocks[i]: its rows of the grid make the rescale the
            # whole-buffer finalize's at those elements.
            if len(self._quant_blocks) != self._nblocks:
                raise ValueError(
                    f"{self._label}: {self._nblocks} folded blocks vs "
                    f"{len(self._quant_blocks)} scheduled quant blocks"
                )
            scales, zps = self._quant.rows(self._quant_blocks)
            out_buf = fedavg.finalize_packed_quantized(
                self._acc, scales, zps, self._total_w, self._total_elems,
                self._chunk_elems, self._out_name or "float32", ref=self._quant_ref,
            )
        else:
            out_buf = fedavg.finalize_packed_stripe(
                self._acc, self._total_w, self._total_elems,
                self._out_name or dtype_name(self._wire_dtype),
            )
        self._acc = None
        if self._stream is not None:
            fence_for_handoff(out_buf)
        return out_buf


def streaming_aggregate(
    fed_objects: Sequence[Any],
    weights: Optional[Sequence[float]] = None,
    *,
    coordinator: Optional[str] = None,
    stream: str = "sagg",
    timeout: Optional[float] = None,
    out_dtype: Any = None,
    seq_ids: Optional[Sequence[int]] = None,
    round_tag: Optional[int] = None,
    timings: Optional[Dict[str, float]] = None,
    quant: Optional[Any] = None,
    quant_ref: Optional[Any] = None,
    quant_scope: Optional[str] = None,
    quant_downlink: bool = False,
    secagg: Optional[Any] = None,
    server_step: Optional[Any] = None,
) -> Any:
    """FedAvg round over the streaming + delta-cache pipeline.

    Drop-in for ``fl.aggregate(...)`` in coordinator topology when the
    contributions are PackedTrees: every party calls it at the same
    program point with the same arguments.  Owners push their update to
    the coordinator on a per-party **delta stream**; the coordinator folds
    each arriving chunk on its device while later chunks are in flight,
    and broadcasts the aggregate (also on a delta stream).  Returns the
    averaged PackedTree on every party.

    ``stream`` names the delta-cache scope — keep it constant across
    rounds.  ``seq_ids``: :data:`STREAM_AGG_SEQ_IDS` pre-allocated
    rendezvous ids (a call off the driving thread must pass them).
    ``round_tag`` stamps every frame with the round index.  ``timings``
    receives ``push_s`` (this party's pushes ACKed; 0.0 on the
    coordinator) and ``agg_s`` (wall time of the call), and on the
    coordinator ``agg_stats`` (the aggregator's ``stats``).  ``server_step``:
    a hook the coordinator applies to the finalized aggregate before the
    broadcast.

    ``quant``: the round's shared :class:`~rayfed_tpu_torch.fl.quantize.
    QuantGrid`: aggregate **in the compressed domain**.  Each party's
    contribution is quantized onto the grid before the push (already
    quantized ones pass after a fingerprint check), frames carry the grid
    descriptor (``wire.QUANT_GRID_KEY``), the coordinator folds the codes
    in i32 and rescales once.  ``quant_ref``: the round's shared reference
    buffer for ``mode="delta"`` grids.  ``out_dtype`` defaults to f32 in
    this mode.  ``quant_scope`` keys the error-feedback residual
    (:func:`~rayfed_tpu_torch.fl.quantize.compressor`; None quantizes
    statelessly).  ``quant_downlink`` re-quantizes the broadcast onto a
    fresh grid carried in the payload; every party, the coordinator
    included, returns the same dequantized tree.

    ``secagg``: this party's :class:`~rayfed_tpu_torch.fl.secagg.RoundMasker`
    (requires ``quant``): each contribution ships as ``w·q + pairwise masks``
    in i32 (plain sends: masked codes are fresh noise every round, nothing
    for a delta stream to reuse), the coordinator folds at unit weight and
    the masks cancel exactly.  The all-of-n path fails the round on any
    loss, so no mask can be orphaned here.
    """
    from rayfed_tpu_torch.fed_object import FedObject
    from rayfed_tpu_torch.proxy import (
        recv_on_runtime,
        send_many_on_runtime,
        send_on_runtime,
    )
    from rayfed_tpu_torch.runtime import get_runtime

    from rayfed_tpu_torch.fl import quantize as qz

    runtime = get_runtime()
    objs = list(fed_objects)
    if not objs:
        raise ValueError("streaming_aggregate needs at least one object")
    if weights is not None and len(weights) != len(objs):
        raise ValueError(f"{len(weights)} weights for {len(objs)} objects")
    for obj in objs:
        if not isinstance(obj, FedObject):
            raise TypeError(
                "streaming_aggregate consumes FedObjects (party-owned "
                f"contributions), got {type(obj).__name__}"
            )
    if quant_downlink and quant is None:
        raise ValueError("quant_downlink requires quant= (the grid)")
    if secagg is not None and quant is None:
        raise ValueError(
            "secagg= requires quant= — masks live in the shared-grid "
            "integer domain (fl.secagg)"
        )
    if server_step is not None and secagg is not None:
        raise ValueError(
            "server_step does not compose with masked (secure_agg) "
            "rounds yet — the recovery window has not been exercised "
            "with a post-finalize step (loud exclusion, see "
            "fl.server_opt)"
        )
    if quant is not None and out_dtype is None:
        # Integer codes make no sense as an output dtype.
        out_dtype = torch.float32
    # The sender-side codec discipline (grid check, residual commit); a
    # no-op without a grid.
    if secagg is not None:
        from rayfed_tpu_torch.fl.secagg import MaskedRoundCodec

        codec = MaskedRoundCodec(quant, quant_ref, quant_scope, secagg)
    else:
        codec = qz.RoundCodec(quant, quant_ref, quant_scope)
    qref = codec.ref

    # Allocated identically on every controller — the determinism
    # contract that keys the rendezvous.
    if seq_ids is None:
        contrib_id = runtime.next_seq_id()
        result_id = runtime.next_seq_id()
    else:
        contrib_id, result_id = seq_ids
    t_call0 = time.perf_counter()
    me = runtime.party
    coord = coordinator or objs[0].get_party()
    backstop = timeout if timeout is not None else runtime.job_config.recv_backstop_s
    parties = list(runtime.cluster_config.parties)

    if me != coord:
        own_seq = 0  # per-owner ordinal: stable under client sampling
        push_done: List[float] = []
        for obj in objs:
            if obj.get_party() == me:
                local_ref = obj.get_local_ref()
                if quant is not None:
                    # Quantize on the thread that resolves the update; the
                    # codes are what the delta cache diffs and the wire ships.
                    local_ref = local_ref.then(codec.to_wire)
                push_ref = send_on_runtime(
                    runtime, coord, local_ref,
                    obj.get_fed_task_id(), contrib_id,
                    stream=None if secagg is not None else f"{stream}/up/{me}/{own_seq}",
                    round_tag=round_tag,
                    quant_meta=codec.descriptor,
                )
                if timings is not None:
                    push_ref.add_done_callback(
                        lambda _r: push_done.append(time.perf_counter())
                    )
                own_seq += 1
        try:
            result = recv_on_runtime(runtime, coord, result_id, result_id).resolve(
                timeout=backstop
            )
        except BaseException:
            codec.rollback()
            raise
        codec.commit()
        if quant is not None and isinstance(result, qz.QuantizedPackedTree):
            # Quantized downlink: decoded with the grid the payload carries,
            # the bytes the coordinator returns.
            result = result.dequantize(
                out_dtype, ref=qref if result.gmeta.mode == "delta" else None
            )
        if timings is not None:
            # The broadcast only lands after the coordinator folded every
            # contribution, so the ACK timestamps are complete by now.
            timings["push_s"] = max(push_done) - t_call0 if push_done else 0.0
            timings["agg_s"] = time.perf_counter() - t_call0
        return result

    agg = StreamingAggregator(
        len(objs),
        weights=weights,
        allowed=runtime.cluster_config.serializing_allowed_list,
        out_dtype=out_dtype,
        party=me,
        quant=quant,
        quant_ref=qref,
        masked=secagg is not None,
        # The fold grid IS the quantization grid.
        chunk_elems=quant.chunk_elems if quant is not None else DEFAULT_CHUNK_ELEMS,
        device=runtime.transport.device,
    )
    pending_cancels: List[tuple] = []
    sink_entries: List[tuple] = []
    for i, obj in enumerate(objs):
        if obj.get_party() == me:

            def _feed(ref, i=i):
                exc = ref.exception()
                if exc is not None:
                    agg.fail(exc)
                    return
                try:
                    value = codec.to_wire(ref.resolve())
                # fedlint: disable=FED004 — transferred, not swallowed: fail(e) poisons every result waiter; this callback runs on the resolving task-pool thread, not the driver
                except BaseException as e:
                    agg.fail(e)
                    return
                agg.add_local(i, value)

            obj.get_local_ref().add_done_callback(_feed)
        else:
            sink_entries.append(
                (obj.get_party(), obj.get_fed_task_id(), contrib_id, agg.sink(i))
            )
            pending_cancels.append((obj.get_fed_task_id(), contrib_id))
    if sink_entries:
        # One loop hop registers every contribution sink (and enrolls
        # their source parties with the health monitor's fail-fast).
        runtime.transport.recv_stream_many(sink_entries)
    others = [p for p in parties if p != me]
    try:
        result = agg.result(timeout=backstop)
        if server_step is not None:
            result = server_step(result)
    except BaseException as exc:
        codec.rollback()
        for up, down in pending_cancels:
            runtime.transport.cancel_stream(up, down)
        # The peers are parked on the result broadcast — poison that key
        # so their recv raises the coordinator's error now.
        poison = getattr(runtime.transport, "_send_poison", None)
        if poison is not None:
            for p in others:
                try:
                    poison(p, result_id, result_id, exc)
                except Exception:  # pragma: no cover - best effort
                    logger.exception("failed to poison streaming result for %s", p)
        raise
    codec.commit()
    wire_result, down_descriptor = result, None
    if quant_downlink:
        # The broadcast on a fresh grid derived from the aggregate; the
        # coordinator returns the dequantized codes, as every peer does.
        wire_result, result, down_descriptor = qz.quantize_downlink(
            result, quant, qref, quant_scope, out_dtype=out_dtype
        )
    if others:
        send_many_on_runtime(
            runtime, others, wire_result, result_id, result_id,
            stream=f"{stream}/down", round_tag=round_tag,
            quant_meta=down_descriptor,
        )
    if timings is not None:
        timings["push_s"] = 0.0  # own contribution never hits the wire
        timings["agg_s"] = time.perf_counter() - t_call0
        timings["agg_stats"] = dict(agg.stats)
    return result
