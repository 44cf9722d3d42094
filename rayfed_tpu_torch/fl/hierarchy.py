"""Recursive hierarchical aggregation: region rings and quantized
multi-level partial-sum streaming.

A hub coordinator takes O(N)·|model| of ingress and a single N-party ring
pays N−1 serial hops per stripe.  Here the sorted roster partitions
deterministically into regions
(:func:`rayfed_tpu_torch.transport.manager.partition_regions`: every
controller derives the same partition from the same roster epoch) and the
round becomes a tree over the existing pieces:

1. **Region reduce-scatter**: each region runs the ring's stripe schedule
   over its own members on the round's shared
   :class:`~rayfed_tpu_torch.fl.quantize.QuantGrid` (the hierarchy always
   runs in the compressed domain, see below), folding the integer codes
   into i32 accumulators on the owners' devices
   (:class:`~rayfed_tpu_torch.fl.streaming.StripeAggregator`).  The stripes
   are **not finalized**: each owner emits its stripe of the region's raw
   partial sum ``Σ_{p∈region} w_p·q_p``.
2. **Partial sums up the tree**: stripe owners hand their stripes to the
   region coordinator (the first live member), which assembles the
   region's partial sum (a :class:`RegionSumTree`, at the narrowest exact
   integer width, :func:`partial_sum_dtype`) and streams it up.  Interior
   coordinators fold their children's sums at unit weight in a
   ``presummed`` :class:`~rayfed_tpu_torch.fl.streaming.StreamingAggregator`,
   the same i32 fold every flat path uses; only the root finalizes.
3. **Broadcast down the tree**: the root rescales once
   (:func:`~rayfed_tpu_torch.fl.fedavg.finalize_packed_quantized`), the
   aggregate travels root → child coordinators → a relay chain inside each
   leaf region, and a commit/release pass gives every controller the same
   success/abort verdict.

**Multi-level.**  Leaf regions group ``branch`` at a time into interior
nodes (:func:`region_layout` derives the whole tree from the sorted roster,
``region_size``, ``branch`` and the dead set), recursively until one top
node remains.  :func:`partial_sum_dtype` is derived per level from the
level's largest subtree weight, so levels near the leaves ride int16 where
the root needs int32.

**Per-region quorum** (``region_quorum=``): a leaf region collects full
code trees at its coordinator behind a deadline-gated quorum fold and
emits the arrived subset's partial sum; the arrived Σw rides up in each
:class:`RegionSumTree` and the root divides by the weight that folded, so
the result equals ``packed_quantized_sum`` over the arrived members.
Interior levels stay strict: a dead region coordinator aborts the round.

**Why this equals the flat fold byte for byte.**  Integer adds are exact
and associative, so ``Σ_regions (Σ_{p∈region} w_p·q_p)`` is the flat
accumulator bit for bit, and the one finalize is shared: hierarchy == flat
streaming == ``packed_quantized_sum``, whatever the arrival order at any
level and whatever device each node folds on.  Float partial sums would
re-associate a non-associative fold, so an unquantized hierarchy is
refused.

**Failure.**  A failure poisons every rendezvous key the failing party
owed, so :class:`HierarchyRoundError` raises on every controller and
``run_fedavg_rounds(mode="hierarchy")`` re-aggregates the same round over
the flat path in lockstep (``HIER_STATS["fallback_rounds"]``).

On the card every accumulator, every partial sum a node folds or ships and
the assembly live on the party's device; the payloads carry the JAX
package's ``hrm`` manifest and :class:`RegionSumTree` travels under its
module path, so parties of the two packages share a tree.
"""

from __future__ import annotations

import json
import logging
import time
import zlib
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.fl import fedavg
from rayfed_tpu_torch.fl.compression import PackedTree, PackSpec, torch_dtype
from rayfed_tpu_torch.fl.quantize import QuantizedPackedTree
from rayfed_tpu_torch.fl.ring import _stripe_elems, _stripe_slice
from rayfed_tpu_torch.fl.streaming import StreamingAggregator, StripeAggregator
from rayfed_tpu_torch.utils.platform import fence_for_handoff, resolve_device

logger = logging.getLogger(__name__)

# Version of the region manifest ("hrm" sideband leaf), the JAX package's:
# fingerprinted with its schema by tool/check_wire_format.py.  v2: "lv"
# (tree level), "pa" (parent node id), "rp" (the leaf's interior path).
HIERARCHY_VERSION = 2

# Longest relay chain of the region-ring downlink: a region splits into
# ceil(members/8) parallel chains, so the downlink's critical path stays at
# 8 serial hops whatever the region size.
RING_RELAY_MAX_HOPS = 8

# Per-process round counters (the trainer's fallback path and tests read
# them, as fl.ring.RING_STATS).
HIER_STATS: Dict[str, int] = {
    "rounds_completed": 0,
    "rounds_aborted": 0,
    "fallback_rounds": 0,
    # Rounds where >= 1 region completed on its arrived subset.
    "region_cutoffs": 0,
}

# Test-only fault injection: called with (phase, party) at each step of the
# member flow ("local", "rs", "ps", "up", "down", "commit"); raising
# simulates a failure at that phase.  Takes the party because in-process
# virtual parties share one process.
_fault_hook: Optional[Callable[[str, str], None]] = None


def _maybe_fault(phase: str, party: str) -> None:
    if _fault_hook is not None:
        _fault_hook(phase, party)


def _relay_chains(members: Sequence[str], max_hops: int = RING_RELAY_MAX_HOPS) -> List[List[str]]:
    """Split a region's relay members into ``ceil(len/max_hops)``
    order-preserving contiguous chains, sized as evenly as possible (the
    longest chain is the downlink's critical path)."""
    if max_hops < 1:
        raise ValueError(f"max_hops must be >= 1, got {max_hops}")
    n = len(members)
    if n == 0:
        return []
    k = -(-n // max_hops)
    base, extra = divmod(n, k)
    chains: List[List[str]] = []
    start = 0
    for i in range(k):
        size = base + (1 if i < extra else 0)
        chains.append(list(members[start : start + size]))
        start += size
    return chains


# Seq ids one hierarchy_aggregate call consumes, in order: (rs, ps, up,
# down, commit, release).
HIER_SEQ_IDS = 6


class HierarchyRoundError(RuntimeError):
    """A hierarchy round aborted (peer death, wire failure, poisoned hop,
    partition disagreement).  The contributions are intact on their owners:
    re-aggregate the same round over the flat topology
    (``run_fedavg_rounds(mode="hierarchy")`` does)."""


def members_fingerprint(members: Sequence[str]) -> int:
    """CRC32 over the sorted roster: region manifests carry it, so two
    controllers that derived different partitions abort instead of folding
    mismatched stripes."""
    return zlib.crc32("\n".join(sorted(members)).encode())


def partial_sum_dtype(qabs_max: int, total_weight: int) -> str:
    """The narrowest integer wire dtype that holds ``qabs_max · W``
    exactly: int16 while it fits in 2¹⁵−1, else int32."""
    bound = int(qabs_max) * int(total_weight)
    if bound <= 2**15 - 1:
        return "int16"
    if bound <= 2**31 - 1:
        return "int32"
    raise ValueError(
        f"integer-fold overflow: qabs_max {qabs_max} x total weight "
        f"{total_weight} = {bound} exceeds the i32 accumulator bound — "
        f"rescale the example counts"
    )


class TreeNode(NamedTuple):
    """One active interior node of the derived tree."""

    children: tuple  # active child node ids at the level below
    coordinator: str  # the coordinator of the first active child


class HierarchyLayout(NamedTuple):
    """One round's tree (a pure function of the sorted members,
    ``region_size``, ``branch`` and the dead set)."""

    regions: List[List[str]]  # full partition of the roster
    live: List[List[str]]  # per-region live members (sorted)
    coordinators: Dict[int, str]  # region index -> live coordinator
    active: List[int]  # region indices with >= 1 live member
    root: str
    root_region: int
    # Interior levels 1..L (levels[i] is level i+1): active node id ->
    # TreeNode.  The last level holds one node, coordinated by the root.
    # Node ids group the FULL previous-level id range (prev_id // branch),
    # so a dead subtree drops out of its parent without re-parenting others.
    levels: tuple = ()
    branch: int = 0


def region_layout(
    members: Sequence[str], region_size: int, dead: Sequence[str] = (),
    branch: Optional[int] = None,
) -> HierarchyLayout:
    """Derive the round's tree.

    The partition comes from the roster alone (stable under a mid-round
    death); ``dead`` parties drop out of their region's ring and fold set,
    and a dead coordinator's region fails over to its
    :func:`~rayfed_tpu_torch.transport.manager.roster_successor`.  Every
    ``branch`` contiguous node ids of a level group into one interior node,
    recursively until one node remains; an interior node's coordinator is
    its first active child's, so the root is the first active region's
    coordinator.  ``branch`` defaults to ``max(2, region_size)``.
    """
    from rayfed_tpu_torch.transport.manager import branch_groups, partition_regions, roster_successor

    regions = partition_regions(members, region_size)
    if branch is None:
        branch = max(2, int(region_size))
    branch = int(branch)
    if branch < 2:
        raise ValueError(f"branch must be >= 2 (a 1-ary interior level folds nothing), got {branch}")
    dead_set = set(dead)
    live = [[p for p in r if p not in dead_set] for r in regions]
    coordinators: Dict[int, str] = {}
    active: List[int] = []
    for g, r in enumerate(regions):
        if not live[g]:
            continue
        coordinators[g] = roster_successor(r, r[0], dead_set) if r[0] in dead_set else r[0]
        active.append(g)
    if not active:
        raise HierarchyRoundError(
            f"no live party remains on the roster {sorted(members)} (dead: {sorted(dead_set)})"
        )
    # At least one interior level always exists (the top node the root
    # folds), so one branch group reproduces the two-level shape.
    levels: List[Dict[int, TreeNode]] = []
    prev_active = list(active)
    prev_coord: Dict[int, str] = dict(coordinators)
    n_full = len(regions)
    while True:
        n_full = -(-n_full // branch)
        level = {
            nid: TreeNode(tuple(children), prev_coord[children[0]])
            for nid, children in branch_groups(prev_active, branch)
        }
        levels.append(level)
        if n_full <= 1:
            break
        prev_active = sorted(level)
        prev_coord = {nid: nd.coordinator for nid, nd in level.items()}
    root_region = active[0]
    return HierarchyLayout(
        regions, live, coordinators, active, coordinators[root_region], root_region,
        tuple(levels), branch,
    )


def make_region_meta(
    phase: str, region: int, n_regions: int, stripe: int, n_stripes: int, nblocks: int,
    total_elems: int, dtype: str, qgrid_fp: int, members_fp: int,
    epoch: Optional[int] = None, level: int = 0, parent: int = 0, path: str = "",
) -> Dict[str, Any]:
    """The ``hrm`` sideband of a hierarchy payload — single producer of its
    schema.  ``phase`` is ``"rs"`` (region reduce-scatter codes) or
    ``"ps"`` (a stripe of the region's partial sum).  Receivers check every
    field against their own layout before any block folds: the roster
    fingerprint (``mf``), the epoch (``ep``), the grid (``qg``) and the
    tree shape (``lv``/``pa``/``rp``)."""
    return {
        "v": HIERARCHY_VERSION,
        "ph": str(phase),
        "rg": int(region),
        "nr": int(n_regions),
        "s": int(stripe),
        "n": int(n_stripes),
        "nb": int(nblocks),
        "el": int(total_elems),
        "dt": str(dtype),
        "qg": int(qgrid_fp),
        "mf": int(members_fp),
        "ep": -1 if epoch is None else int(epoch),
        "lv": int(level),
        "pa": int(parent),
        "rp": str(path),
    }


def check_region_meta(meta_json: str, want: Dict[str, Any]) -> None:
    """Check a received ``hrm`` manifest against the locally derived
    layout; raises naming the first mismatched field."""
    hrm = json.loads(meta_json)
    if hrm.get("v", 0) > HIERARCHY_VERSION:
        raise HierarchyRoundError(
            f"region payload uses hierarchy manifest v{hrm.get('v')}; "
            f"this party understands up to v{HIERARCHY_VERSION}"
        )
    for key, expect in want.items():
        if hrm.get(key) != expect:
            raise HierarchyRoundError(
                f"region manifest mismatch: {key}={hrm.get(key)!r}, "
                f"expected {expect!r} — hierarchy peers disagree on the "
                f"round's partition/grid/epoch"
            )


class RegionSumTree(QuantizedPackedTree):
    """Wire form of an integer partial sum ``Σ w_p·q_p`` on the round's
    grid, at the narrowest exact integer width (:func:`partial_sum_dtype`),
    with the grid riding along (the folding node checks its fingerprint).

    Not decodable on its own: a partial sum means nothing before the root's
    one rescale over the whole roster's weight, so :meth:`dequantize` and
    :meth:`unpack` raise.  Fold it in a ``presummed``
    :class:`~rayfed_tpu_torch.fl.streaming.StreamingAggregator`.

    ``arrived_w``: the subtree's Σw that actually folded, set when a
    region cutoff excluded members (None: the full subtree weight).
    """

    __slots__ = ("arrived_w",)

    def __init__(self, buf, scales, zps, passthrough, spec, gmeta, arrived_w: Optional[int] = None):
        super().__init__(buf, scales, zps, passthrough, spec, gmeta)
        self.arrived_w = None if arrived_w is None else int(arrived_w)

    def dequantize(self, out_dtype: Any = np.float32, ref: Optional[Any] = None):
        raise HierarchyRoundError(
            "a RegionSumTree is an integer PARTIAL sum — only the root "
            "fold (StreamingAggregator(presummed=...)) may rescale it, "
            "once, over the whole roster's weight"
        )

    def unpack(self, dtype: Any = None):
        raise HierarchyRoundError("a RegionSumTree cannot be unpacked — see dequantize")

    def __reduce__(self):
        return (
            RegionSumTree,
            (self.buf, self.scales, self.zps, self.passthrough, self.spec, self.gmeta, self.arrived_w),
        )

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"RegionSumTree({self.gmeta.total_elems} partial-sum elements on grid "
            f"fp={self.gmeta.fp:#010x}"
            + ("" if self.arrived_w is None else f", arrived_w={self.arrived_w}") + ")"
        )


tree_util.register_pytree_node(
    RegionSumTree,
    lambda rt: ((rt.buf, rt.scales, rt.zps, *rt.passthrough), (rt.spec, rt.gmeta, rt.arrived_w)),
    lambda aux, ch: RegionSumTree(ch[0], ch[1], ch[2], tuple(ch[3:]), aux[0], aux[1], aux[2]),
)


def _raw_sum(agg: StreamingAggregator) -> torch.Tensor:
    """The aggregator's exact i32 accumulator, trimmed of the block grid's
    pad, on its device (fenced for the threads that read it next)."""
    out = agg._acc[: agg._total_elems]
    agg._acc = None
    if agg._stream is not None:
        fence_for_handoff(out)
    return out


class _RawStripeAggregator(StripeAggregator):
    """A region stripe owner's fold that emits the raw i32 partial sum:
    the region must not rescale (a per-region divide would round twice)."""

    def _finalize(self):
        return _raw_sum(self)


class _RegionHubAggregator(StreamingAggregator):
    """A leaf region's quorum hub fold: the coordinator collects the
    members' code trees and emits the raw i32 partial sum of the arrived
    subset (the cutoff is the base class's)."""

    def _finalize(self):
        self._verify_quant_members(self._members())
        return _raw_sum(self)


class _NodeAggregator(StreamingAggregator):
    """An interior node's fold of its children's :class:`RegionSumTree`
    partial sums (unit weight, all children).  Emits the raw i32 subtree
    sum, except at the root (``finalize_root=True``), which rescales once
    over the Σw that arrived (the children's ``arrived_w``, or their roster
    weights when no cutoff happened: then exactly the flat fold's Σw)."""

    def __init__(self, *args, finalize_root: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self._finalize_root = bool(finalize_root)
        self.arrived_w: Optional[int] = None

    def _finalize(self):
        members = self._members()
        self._verify_quant_members(members)
        arrived = 0
        for i in members:
            tree = self._tree_of(self._streams[i])
            arrived += int(tree.arrived_w) if tree.arrived_w is not None else int(self._weights[i])
        self.arrived_w = arrived
        if self._finalize_root:
            # Integer totals are exact in f32 up to the grid's headroom bound.
            self._total_w = float(arrived)
            return super()._finalize()
        return _raw_sum(self)


class HierarchyRound:
    """One party's walk of a hierarchical round.

    Driven through a ``TransportManager``-shaped object (``send``,
    ``send_many``, ``recv``, ``recv_stream_many``, ``cancel_stream``), not
    the fed runtime: :func:`hierarchy_aggregate`, benches of virtual parties
    and the in-process tests all drive this class.

    ``keys``: the round's six rendezvous ids ``(rs, ps, up, down, commit,
    release)``, the same on every controller.  ``epoch`` stamps every frame
    (a receiver whose roster advanced rejects stale frames).  ``device``:
    where this party's accumulators, partial sums and assembly live (default
    the transport's device, else the card; ``"cpu"`` only when asked).
    """

    def __init__(
        self,
        transport: Any,
        *,
        party: str,
        members: Sequence[str],
        region_size: int,
        grid: Any,
        quant_ref: Optional[Any],
        keys: Sequence[Any],
        weights: Optional[Dict[str, float]] = None,
        stream: str = "hier",
        epoch: Optional[int] = None,
        round_tag: Optional[int] = None,
        backstop: Optional[float] = None,
        quant_scope: Optional[str] = None,
        allowed: Optional[Dict[str, Any]] = None,
        quant_downlink: bool = False,
        dead: Sequence[str] = (),
        timings: Optional[Dict[str, float]] = None,
        server_step: Optional[Any] = None,
        branch: Optional[int] = None,
        region_quorum: Optional[int] = None,
        region_deadline_s: Optional[float] = None,
        ring_downlink: bool = True,
        device: Any = None,
    ) -> None:
        from rayfed_tpu_torch.fl.quantize import RoundCodec

        if grid is None:
            raise HierarchyRoundError(
                "hierarchical aggregation runs in the compressed domain "
                "ONLY: float partial sums would re-associate a "
                "non-associative fold and silently break hierarchical "
                "== flat byte-identity — pass the round's shared "
                "QuantGrid (wire_quant)"
            )
        if len(keys) != HIER_SEQ_IDS:
            raise ValueError(f"hierarchy rounds consume {HIER_SEQ_IDS} rendezvous ids, got {len(keys)}")
        self._t = transport
        self._me = str(party)
        self._members = sorted(members)
        if self._me not in self._members:
            raise HierarchyRoundError(
                f"{self._me!r} is not on the round roster {self._members} — "
                f"observer controllers are not supported by hierarchy rounds"
            )
        self._dead = set(dead)
        if self._me in self._dead:
            raise HierarchyRoundError(f"{self._me!r} is in the round's agreed dead set")
        self._lay = region_layout(self._members, region_size, self._dead, branch=branch)
        self._grid = grid
        self._codec = RoundCodec(grid, quant_ref, quant_scope)
        self._qref = self._codec.ref
        self._keys = tuple(keys)
        self._stream = stream
        self._epoch = epoch
        self._round_tag = round_tag
        self._backstop = backstop
        self._allowed = allowed
        self._quant_scope = quant_scope
        self._quant_downlink = bool(quant_downlink)
        self._timings = timings
        self._server_step = server_step
        self._device = resolve_device(device if device is not None else getattr(transport, "device", None))
        contributors = [p for p in self._members if p not in self._dead]
        w_list = None if weights is None else [float(weights[p]) for p in contributors]
        iw, itotal = fedavg.quant_weights(w_list, len(contributors))
        self._iw = dict(zip(contributors, iw))
        self._w_total = itotal
        grid.check_weight_headroom(itotal)
        lay = self._lay
        # Subtree roster weights per node (arrived <= roster, so each
        # level's dtype bound holds under a cutoff), and one partial-sum
        # wire dtype per level, from the level's largest subtree weight.
        self._node_w: List[Dict[int, int]] = [
            {g: sum(self._iw[p] for p in lay.live[g]) for g in lay.active}
        ]
        for level in lay.levels:
            below = self._node_w[-1]
            self._node_w.append({nid: sum(below[c] for c in nd.children) for nid, nd in level.items()})
        self._lvl_dtype = [
            partial_sum_dtype(grid.qabs_max, max(w.values())) for w in self._node_w[:-1]
        ] or [partial_sum_dtype(grid.qabs_max, itotal)]
        self._ps_dtype = self._lvl_dtype[0]
        self._members_fp = members_fingerprint(self._members)
        # The (level, node id) pairs this party coordinates, up from its
        # leaf region: an interior node's coordinator is its first active
        # child's, so the chain is a walk straight up.
        g_mine = next((j for j in lay.active if self._me in lay.live[j]), None)
        self._g = g_mine
        self._coordinated: List[tuple] = []
        if g_mine is not None and lay.coordinators[g_mine] == self._me:
            self._coordinated.append((0, g_mine))
            nid = g_mine
            for lv, level in enumerate(lay.levels, start=1):
                nid //= lay.branch
                if level[nid].coordinator != self._me:
                    break
                self._coordinated.append((lv, nid))
        if region_quorum is not None:
            rq = int(region_quorum)
            if rq < 1:
                raise ValueError(
                    f"region_quorum must be >= 1 (the minimum arrived "
                    f"member count per region), got {region_quorum}"
                )
            region_quorum = rq
        self._region_quorum = region_quorum
        self._region_deadline_s = None if region_deadline_s is None else float(region_deadline_s)
        if self._region_deadline_s is not None and region_quorum is None:
            raise ValueError(
                "region_deadline_s needs region_quorum= (the per-region "
                "minimum arrived count the deadline gates)"
            )
        self._ring_downlink = bool(ring_downlink)
        self._pending_cancels: List[tuple] = []

    # -- helpers --------------------------------------------------------------

    def _send(self, dest: str, value: Any, up: str, *, down: Any,
              stream: Optional[str] = None, quant_meta=None):
        return self._t.send(
            dest, value, up, down, stream=stream, round_tag=self._round_tag,
            epoch_tag=self._epoch, quant_meta=quant_meta,
        )

    def _recv(self, src: str, up: str, down: Any):
        return self._t.recv(src, up, down)

    def _coord_of(self, lv: int, nid: int) -> str:
        """Coordinator of active node ``nid`` at level ``lv`` (0 = leaf
        regions)."""
        if lv == 0:
            return self._lay.coordinators[nid]
        return self._lay.levels[lv - 1][nid].coordinator

    def _node_path(self, g: int) -> str:
        """Region ``g``'s interior ancestor ids, leaf to root (the ``rp``
        field peers cross-check)."""
        nid = g
        parts: List[str] = []
        for _ in self._lay.levels:
            nid //= self._lay.branch
            parts.append(str(nid))
        return "/".join(parts)

    def _hrm_want(self, phase: str, g: int, stripe: int, n_stripes: int,
                  nblocks: int, dtype: str) -> Dict[str, Any]:
        return {
            "ph": phase, "rg": g, "nr": len(self._lay.regions),
            "s": stripe, "n": n_stripes, "nb": nblocks,
            "el": self._grid.total_elems, "dt": dtype,
            "qg": self._grid.fingerprint(), "mf": self._members_fp,
            "ep": -1 if self._epoch is None else int(self._epoch),
            "lv": 0, "pa": g // self._lay.branch,
            "rp": self._node_path(g),
        }

    def _hrm(self, phase: str, g: int, stripe: int, n_stripes: int, nblocks: int, dtype: str) -> str:
        return json.dumps(
            make_region_meta(
                phase, g, len(self._lay.regions), stripe, n_stripes, nblocks,
                self._grid.total_elems, dtype, self._grid.fingerprint(), self._members_fp,
                epoch=self._epoch, level=0, parent=g // self._lay.branch, path=self._node_path(g),
            ),
            sort_keys=True,
        )

    # -- the round ------------------------------------------------------------

    def run(self, local_value: Any) -> PackedTree:
        """Walk the round; returns the finalized aggregate (the same bytes
        on every controller) or raises :class:`HierarchyRoundError` on
        every controller."""
        t0 = time.perf_counter()
        try:
            result = self._run_inner(local_value)
        except BaseException as exc:
            self._codec.rollback()
            for up, down in self._pending_cancels:
                try:
                    self._t.cancel_stream(up, down)
                except Exception:  # pragma: no cover - best effort
                    pass
            self._poison_edges(exc)
            if isinstance(exc, (KeyboardInterrupt, SystemExit)):
                # The poison still unparks the peers, but an interrupt
                # stops the caller unwrapped.
                raise
            HIER_STATS["rounds_aborted"] += 1
            from rayfed_tpu_torch import telemetry as _telemetry

            _telemetry.event(
                "hier.abort", round=self._round_tag, epoch=self._epoch, party=self._me,
                outcome="error", detail={"error": repr(exc)},
            )
            if isinstance(exc, HierarchyRoundError):
                raise
            raise HierarchyRoundError(f"hierarchy round aborted: {exc!r}") from exc
        self._codec.commit()
        HIER_STATS["rounds_completed"] += 1
        if self._timings is not None:
            self._timings["agg_s"] = time.perf_counter() - t0
            self._timings.setdefault("push_s", 0.0)
            # The partial sums' wire dtype per level, leaves first.
            self._timings["ps_dtypes"] = list(self._lvl_dtype)
        return result

    def _run_inner(self, local_value: Any) -> PackedTree:
        from rayfed_tpu_torch import telemetry as _telemetry
        from rayfed_tpu_torch.fl import quantize as qz

        me = self._me
        lay = self._lay
        _, _, up_id, down_id, commit_id, release_id = self._keys
        backstop = self._backstop
        t_call0 = time.perf_counter()

        _maybe_fault("local", me)
        q = self._codec.to_wire(local_value)
        if q.passthrough:
            raise HierarchyRoundError(
                f"hierarchical aggregation covers the packed float "
                f"buffer only, but this update carries "
                f"{len(q.passthrough)} non-float (passthrough) leaf(s) "
                f"— their per-leaf reduce has no tree decomposition "
                f"yet; drop them from the update tree (loud exclusion, "
                f"never a silent partial aggregate)"
            )
        g = self._g
        region = lay.live[g]
        coord = lay.coordinators[g]
        is_coord = me == coord
        is_root = me == lay.root
        t_mark = t_call0
        # Flight-recorder phase boundaries, level-stamped (region_rs,
        # region_gather, up.l<k>, down.l<k>, down.relay|down.fan,
        # broadcast, commit).
        _phase_span = _telemetry.phase_spanner(
            "hier", round=self._round_tag, epoch=self._epoch, party=me,
            detail={"region": g, "coordinator": coord, "root": lay.root},
        )

        # -- 1+2. the leaf: the region's raw integer partial sum --------
        # The stripe ring folds it across the region; quorum mode collects
        # code trees at the coordinator behind a k-of-region cutoff.
        if self._region_quorum is None:
            buf = fedavg.as_tensor(q.buf).reshape(-1)
            ps_full, t_mark = self._leaf_stripe(buf, _phase_span, t_mark, t_call0)
            leaf_members = list(region)
        else:
            ps_full, leaf_members, t_mark = self._leaf_hub(q, _phase_span, t_mark, t_call0)

        # -- 3. up the tree: fold subtree sums level by level -----------
        # A coordinator climbs its chain of coordinated nodes, folding its
        # children's partial sums at unit weight, and ships the subtree sum
        # to the next coordinator; the top node's fold (the root's) is the
        # round's one rescale.
        _maybe_fault("up", me)
        result = None
        ce = self._grid.chunk_elems
        n_levels = len(lay.levels)
        if is_coord:
            sub_raw = ps_full
            sub_arrived = sum(self._iw[p] for p in leaf_members)
            child_id = g
            for lv in range(1, n_levels + 1):
                nid = child_id // lay.branch
                node = lay.levels[lv - 1][nid]
                up_dt = self._lvl_dtype[lv - 1]
                sub_tree = RegionSumTree(
                    sub_raw, self._grid.scales, self._grid.zps, (),
                    PackSpec(q.spec.entries, q.spec.treedef, up_dt),
                    self._grid.meta(), arrived_w=sub_arrived,
                )
                if node.coordinator != me:
                    ref = self._send(
                        node.coordinator, sub_tree, f"{up_id}.{lv}.{child_id}", down=up_id,
                        stream=f"{self._stream}/up/{lv}.{child_id}",
                        quant_meta=self._codec.descriptor,
                    )
                    if not ref.resolve(timeout=backstop):
                        raise HierarchyRoundError(
                            f"level-{lv - 1} partial sum of node {child_id} to {node.coordinator!r} failed"
                        )
                    t_mark = _phase_span(f"up.l{lv}", t_mark)
                    break
                children = node.children
                at_top = lv == n_levels
                node_agg = _NodeAggregator(
                    len(children),
                    weights=[float(self._node_w[lv - 1][c]) for c in children],
                    allowed=self._allowed,
                    party=me,
                    chunk_elems=ce,
                    labels=[f"level-{lv - 1} node {c}" for c in children],
                    quant=self._grid,
                    quant_ref=self._qref,
                    presummed=up_dt,
                    finalize_root=at_top,
                    device=self._device,
                )
                entries = []
                for idx, c in enumerate(children):
                    if c == child_id:
                        continue
                    entries.append((self._coord_of(lv - 1, c), f"{up_id}.{lv}.{c}", up_id, node_agg.sink(idx)))
                    self._pending_cancels.append((f"{up_id}.{lv}.{c}", up_id))
                if entries:
                    self._t.recv_stream_many(entries)
                node_agg.add_local(children.index(child_id), sub_tree)
                folded = node_agg.result(timeout=backstop)
                sub_arrived = node_agg.arrived_w
                t_mark = _phase_span(f"up.l{lv}", t_mark)
                if at_top:
                    result = folded  # the top node's coordinator is the root
                    break
                # Interior emission: exact i32 narrowed to the level's dtype.
                sub_raw = folded.to(torch_dtype(self._lvl_dtype[lv]))
                child_id = nid

        # -- 4. broadcast down the tree ---------------------------------
        _maybe_fault("down", me)
        down_descr = None
        wire_down = None
        chain: List[str] = []
        if is_root:
            if self._server_step is not None:
                # The round's one server step (fl.server_opt): the exact
                # finalized f32 in, the post-step model out, so the
                # downlink's fresh grid is ranged by the post-step delta.
                # A failure aborts through the poison cascade and the
                # driver re-runs the same step from the same state on the
                # flat path.
                result = self._server_step(result)
            wire_down = result
            if self._quant_downlink:
                wire_down, result, down_descr = qz.quantize_downlink(
                    result, self._grid, self._qref, self._quant_scope,
                )
        elif self._coordinated:
            lvh, nidh = self._coordinated[-1]
            parent = self._coord_of(lvh + 1, nidh // lay.branch)
            value = self._recv(parent, f"{down_id}.c", down_id).resolve(timeout=backstop)
            result = self._decode_down(value)
            wire_down = value
            if isinstance(value, QuantizedPackedTree):
                down_descr = qz.grid_descriptor(value.grid())
        if self._coordinated:
            # Interior fan-down, top level first, to every child
            # coordinator: constant out-degree, so the root's egress stays
            # ~branch·|model| whatever N.
            for lv, nid in reversed(self._coordinated[1:]):
                dests = [self._coord_of(lv - 1, c) for c in lay.levels[lv - 1][nid].children]
                dests = [p for p in dests if p != me]
                if dests:
                    refs = self._t.send_many(
                        dests, wire_down, f"{down_id}.c", down_id, stream=f"{self._stream}/down",
                        round_tag=self._round_tag, epoch_tag=self._epoch, quant_meta=down_descr,
                    )
                    for p, ref in refs.items():
                        if not ref.resolve(timeout=backstop):
                            raise HierarchyRoundError(f"result fan-down to level-{lv - 1} coordinator {p!r} failed")
                    t_mark = _phase_span(f"down.l{lv}", t_mark)
            # Leaf delivery.  Ring mode: the result relays member to member
            # (forward on arrival), one copy per chain from the coordinator.
            # Members a cutoff excluded get a direct best-effort copy (not
            # on a chain: a straggler would stall it).
            chain = [p for p in leaf_members if p != me]
            extras = [p for p in region if p != me and p not in leaf_members]
            if chain:
                if self._ring_downlink:
                    head_refs = [
                        (sub[0], self._send(
                            sub[0], {"chain": sub, "data": wire_down}, f"{down_id}.m", down=down_id,
                            stream=f"{self._stream}/down", quant_meta=down_descr,
                        ))
                        for sub in _relay_chains(chain)
                    ]
                    for head, ref in head_refs:
                        if not ref.resolve(timeout=backstop):
                            raise HierarchyRoundError(f"ring downlink head push to {head!r} failed")
                else:
                    refs = self._t.send_many(
                        chain, wire_down, f"{down_id}.m", down_id, stream=f"{self._stream}/down",
                        round_tag=self._round_tag, epoch_tag=self._epoch, quant_meta=down_descr,
                    )
                    for p, ref in refs.items():
                        if not ref.resolve(timeout=backstop):
                            raise HierarchyRoundError(f"result broadcast to member {p!r} failed")
            for p in extras:
                # A quorum-excluded member may be dead; a live straggler
                # still gets the model.
                if not self._send(
                    p, wire_down, f"{down_id}.m", down=down_id,
                    stream=f"{self._stream}/down", quant_meta=down_descr,
                ).resolve(timeout=backstop):
                    logger.warning("[%s] downlink to excluded member %s failed", me, p)
            t_mark = _phase_span("down.relay" if self._ring_downlink else "down.fan", t_mark)
        else:
            value = self._recv(coord, f"{down_id}.m", down_id).resolve(timeout=backstop)
            relay = None
            inner = value
            if isinstance(value, dict) and "chain" in value:
                # A region-ring envelope: forward the same envelope to my
                # successor before decoding, then confirm my hop with a
                # commit token so the coordinator's commit covers the chain.
                relay = [str(p) for p in value["chain"]]
                inner = value["data"]
            if relay is not None and me in relay:
                pos = relay.index(me)
                if pos + 1 < len(relay):
                    fwd_meta = (
                        qz.grid_descriptor(inner.grid()) if isinstance(inner, QuantizedPackedTree) else None
                    )
                    ref = self._send(
                        relay[pos + 1], value, f"{down_id}.m", down=down_id,
                        stream=f"{self._stream}/down", quant_meta=fwd_meta,
                    )
                    if not ref.resolve(timeout=backstop):
                        raise HierarchyRoundError(f"ring downlink relay to {relay[pos + 1]!r} failed")
            result = self._decode_down(inner)
            if relay is not None and me in relay:
                ref = self._send(coord, {"ok": 1}, f"{commit_id}.m.{g}.{me}", down=commit_id)
                if not ref.resolve(timeout=backstop):
                    raise HierarchyRoundError(f"relay commit token to coordinator {coord!r} failed")
            t_mark = _phase_span("broadcast", t_mark)

        # -- 5. commit/release: agree that the round landed everywhere ---
        # Every coordinator confirms its region's delivery (relay tokens in
        # ring mode, send acks otherwise) and its child coordinators'
        # commits; the root collects the top node's, and a release travels
        # back down every branch: a member returns only once released.
        _maybe_fault("commit", me)
        token = {"ok": 1}
        if self._coordinated:
            if self._ring_downlink:
                for p in chain:
                    self._recv(p, f"{commit_id}.m.{g}.{p}", commit_id).resolve(timeout=backstop)
            for lv, nid in self._coordinated[1:]:
                for c in lay.levels[lv - 1][nid].children:
                    cc = self._coord_of(lv - 1, c)
                    if cc != me:
                        self._recv(cc, f"{commit_id}.{lv - 1}.{c}", commit_id).resolve(timeout=backstop)
            if not is_root:
                lvh, nidh = self._coordinated[-1]
                parent = self._coord_of(lvh + 1, nidh // lay.branch)
                ref = self._send(parent, token, f"{commit_id}.{lvh}.{nidh}", down=commit_id)
                if not ref.resolve(timeout=backstop):
                    raise HierarchyRoundError(f"commit token of node {nidh} (level {lvh}) to {parent!r} failed")
                self._recv(parent, f"{release_id}.r", release_id).resolve(timeout=backstop)
            rel_dests: List[str] = []
            for lv, nid in self._coordinated[1:]:
                rel_dests.extend(self._coord_of(lv - 1, c) for c in lay.levels[lv - 1][nid].children)
            rel_dests.extend(p for p in region if p != me)
            rel_dests = [p for p in dict.fromkeys(rel_dests) if p != me]
            if rel_dests:
                refs = self._t.send_many(
                    rel_dests, token, f"{release_id}.r", release_id,
                    round_tag=self._round_tag, epoch_tag=self._epoch,
                )
                for p, ref in refs.items():
                    if not ref.resolve(timeout=backstop):
                        # After the commit, best effort: a stranded waiter
                        # aborts at its backstop.
                        logger.warning("[%s] release token to %s failed", me, p)
        else:
            self._recv(coord, f"{release_id}.r", release_id).resolve(timeout=backstop)
        _phase_span("commit", t_mark)
        return result

    def _leaf_stripe(self, buf: torch.Tensor, _phase_span, t_mark, t_call0):
        """The leaf in stripe-ring mode: the region's reduce-scatter, then
        the partial-sum gather at the coordinator.  Returns ``(ps_full,
        t_mark)``: the region's raw sum in the level-0 wire dtype on the
        coordinator's device (None elsewhere)."""
        me = self._me
        lay = self._lay
        rs_id, ps_id = self._keys[0], self._keys[1]
        backstop = self._backstop
        g = self._g
        region = lay.live[g]
        m = region.index(me)
        coord = lay.coordinators[g]
        ce = self._grid.chunk_elems
        total_elems = self._grid.total_elems
        nblocks = fedavg.packed_block_grid(total_elems, ce)
        s_n = len(region)
        stripes = fedavg.packed_stripe_schedule(nblocks, s_n)
        wire_name = self._grid.wire_dtype

        def elems(k: int) -> int:
            return _stripe_elems(stripes[k], ce, nblocks, total_elems)

        # -- 1. region reduce-scatter: codes to the stripe owners -------
        agg = None
        if elems(m):
            want = self._hrm_want("rs", g, m, s_n, nblocks, wire_name)
            agg = _RawStripeAggregator(
                s_n,
                weights=[float(self._iw[p]) for p in region],
                allowed=self._allowed,
                party=me,
                chunk_elems=ce,
                expect_elems=elems(m),
                label=f"region {g} stripe {m}",
                meta_check=lambda v: check_region_meta(v, want),
                quant=self._grid,
                quant_blocks=stripes[m],
                quant_ref=None if self._qref is None else _stripe_slice(self._qref, stripes[m], ce, total_elems),
                device=self._device,
            )
            entries = []
            for i, p in enumerate(region):
                if i == m:
                    continue
                entries.append((p, f"{rs_id}.{g}.{i}.{m}", rs_id, agg.sink(i)))
                self._pending_cancels.append((f"{rs_id}.{g}.{i}.{m}", rs_id))
            if entries:
                self._t.recv_stream_many(entries)

        _maybe_fault("rs", me)
        rs_refs = []
        for k, p in enumerate(region):
            if k == m or not elems(k):
                continue
            payload = {
                "data": _stripe_slice(buf, stripes[k], ce, total_elems),
                "hrm": self._hrm("rs", g, k, s_n, nblocks, wire_name),
            }
            rs_refs.append((p, f"{rs_id}.{g}.{m}.{k}", self._send(
                p, payload, f"{rs_id}.{g}.{m}.{k}", down=rs_id,
                stream=f"{self._stream}/rs", quant_meta=self._codec.descriptor,
            )))
        if agg is not None:
            agg.add_local(m, _stripe_slice(buf, stripes[m], ce, total_elems))
        for p, up, ref in rs_refs:
            if not ref.resolve(timeout=backstop):
                raise HierarchyRoundError(f"region reduce-scatter push {up!r} to {p!r} failed")
        if self._timings is not None:
            self._timings["push_s"] = time.perf_counter() - t_call0

        ps_dt = torch_dtype(self._ps_dtype)
        raw_stripe = None
        if agg is not None:
            # Bounded by qabs_max·W by construction, so the cast is exact.
            raw_stripe = agg.result(timeout=backstop).to(ps_dt)

        # -- 2. partial-sum gather at the region coordinator ------------
        t_mark = _phase_span("region_rs", t_mark)
        _maybe_fault("ps", me)
        ps_full = None
        if me != coord:
            if raw_stripe is not None:
                ref = self._send(
                    coord,
                    {"data": raw_stripe, "hrm": self._hrm("ps", g, m, s_n, nblocks, self._ps_dtype)},
                    f"{ps_id}.{g}.{m}", down=ps_id, quant_meta=self._codec.descriptor,
                )
                if not ref.resolve(timeout=backstop):
                    raise HierarchyRoundError(f"partial-sum stripe {m} of region {g} to coordinator {coord!r} failed")
        else:
            ps_full = torch.zeros(total_elems, dtype=ps_dt, device=self._device)

            def scatter(stripe: torch.Tensor, blocks) -> None:
                off = 0
                for b in blocks:
                    size = min(ce, total_elems - b * ce)
                    ps_full[b * ce : b * ce + size] = stripe[off : off + size]
                    off += size

            if raw_stripe is not None:
                scatter(raw_stripe, stripes[m])
            ps_refs = {
                k: (p, self._recv(p, f"{ps_id}.{g}.{k}", ps_id))
                for k, p in enumerate(region)
                if k != m and elems(k)
            }
            for k, (p, ref) in ps_refs.items():
                value = ref.resolve(timeout=backstop)
                check_region_meta(value["hrm"], self._hrm_want("ps", g, k, s_n, nblocks, self._ps_dtype))
                arr = fedavg.as_tensor(value["data"], self._device).reshape(-1)
                if arr.numel() != elems(k):
                    raise HierarchyRoundError(
                        f"partial-sum stripe {k} of region {g} carries "
                        f"{arr.numel()} elements, schedule says {elems(k)}"
                    )
                scatter(arr, stripes[k])
            if ps_full.device.type == "cuda":
                fence_for_handoff(ps_full)
        t_mark = _phase_span("region_gather", t_mark)
        return ps_full, t_mark

    def _leaf_hub(self, q, _phase_span, t_mark, t_call0):
        """The leaf in quorum mode: members stream their code trees to the
        coordinator, whose deadline-gated quorum fold emits the arrived
        subset's raw sum.  Returns ``(ps_full, arrived members, t_mark)``;
        the other members report the full live region."""
        from rayfed_tpu_torch import telemetry as _telemetry

        me = self._me
        lay = self._lay
        rs_id = self._keys[0]
        backstop = self._backstop
        g = self._g
        region = lay.live[g]
        m = region.index(me)
        coord = lay.coordinators[g]

        if me != coord:
            _maybe_fault("rs", me)
            ref = self._send(
                coord, q, f"{rs_id}.q.{g}.{m}", down=rs_id,
                stream=f"{self._stream}/rs", quant_meta=self._codec.descriptor,
            )
            if not ref.resolve(timeout=backstop):
                raise HierarchyRoundError(f"code-tree push of member {m} of region {g} to coordinator {coord!r} failed")
            if self._timings is not None:
                self._timings["push_s"] = time.perf_counter() - t_call0
            t_mark = _phase_span("region_rs", t_mark)
            _maybe_fault("ps", me)
            t_mark = _phase_span("region_gather", t_mark)
            return None, list(region), t_mark

        agg = _RegionHubAggregator(
            len(region),
            weights=[float(self._iw[p]) for p in region],
            allowed=self._allowed,
            party=me,
            chunk_elems=self._grid.chunk_elems,
            quorum=min(self._region_quorum, len(region)),
            labels=list(region),
            quant=self._grid,
            quant_ref=self._qref,
            device=self._device,
        )
        entries = []
        for i, p in enumerate(region):
            if i == m:
                continue
            entries.append((p, f"{rs_id}.q.{g}.{i}", rs_id, agg.sink(i)))
            self._pending_cancels.append((f"{rs_id}.q.{g}.{i}", rs_id))
        if entries:
            self._t.recv_stream_many(entries)
        _maybe_fault("rs", me)
        agg.add_local(m, q)
        if self._timings is not None:
            self._timings["push_s"] = time.perf_counter() - t_call0
        raw = agg.result(timeout=backstop, deadline_s=self._region_deadline_s)
        t_mark = _phase_span("region_rs", t_mark)
        _maybe_fault("ps", me)
        arrived = [region[i] for i in agg.quorum_members]
        if len(arrived) < len(region):
            HIER_STATS["region_cutoffs"] += 1
            _telemetry.event(
                "hier.region_cutoff", round=self._round_tag, epoch=self._epoch, party=me,
                outcome="cutoff",
                detail={"region": g, "arrived": arrived, "excluded": [p for p in region if p not in arrived]},
            )
        # Bounded by qabs_max·W of the full region (arrived <= roster), so
        # the cast is exact under any cutoff.
        ps_full = raw.to(torch_dtype(self._ps_dtype))
        t_mark = _phase_span("region_gather", t_mark)
        return ps_full, arrived, t_mark

    def _decode_down(self, value: Any) -> PackedTree:
        if isinstance(value, RegionSumTree):
            raise HierarchyRoundError(
                "broadcast carried a RegionSumTree — the downlink must be the FINALIZED aggregate"
            )
        if isinstance(value, QuantizedPackedTree):
            return value.dequantize(np.float32, ref=self._qref if value.gmeta.mode == "delta" else None)
        if not isinstance(value, PackedTree):
            raise HierarchyRoundError(
                f"broadcast carried {type(value).__name__}, expected the aggregated PackedTree"
            )
        return value

    def _poison_edges(self, exc: BaseException) -> None:
        """Best-effort poison of every rendezvous key this party produces,
        so peers parked on them raise within a round trip: the abort
        travels up the coordinated chain and back down every branch."""
        poison = getattr(self._t, "_send_poison", None)
        if poison is None or self._g is None:
            return
        lay = self._lay
        me = self._me
        rs_id, ps_id, up_id, down_id, commit_id, release_id = self._keys
        g = self._g
        region = lay.live[g]
        m = region.index(me)
        coord = lay.coordinators[g]
        edges: List[tuple] = []
        if self._region_quorum is None:
            for k, p in enumerate(region):
                if k != m:
                    edges.append((p, f"{rs_id}.{g}.{m}.{k}", rs_id))
            if me != coord:
                edges.append((coord, f"{ps_id}.{g}.{m}", ps_id))
        elif me != coord:
            # A poisoned hub stream marks this member failed, so the
            # coordinator's quorum cuts off at once.
            edges.append((coord, f"{rs_id}.q.{g}.{m}", rs_id))
        if me != coord:
            if self._ring_downlink:
                edges.append((coord, f"{commit_id}.m.{g}.{me}", commit_id))
        else:
            if self._coordinated and me != lay.root:
                lvh, nidh = self._coordinated[-1]
                parent = self._coord_of(lvh + 1, nidh // lay.branch)
                edges.append((parent, f"{up_id}.{lvh + 1}.{nidh}", up_id))
                edges.append((parent, f"{commit_id}.{lvh}.{nidh}", commit_id))
            for lv, nid in self._coordinated[1:]:
                for c in lay.levels[lv - 1][nid].children:
                    cc = self._coord_of(lv - 1, c)
                    if cc != me:
                        edges.append((cc, f"{down_id}.c", down_id))
                        edges.append((cc, f"{release_id}.r", release_id))
            for p in region:
                if p != me:
                    edges.append((p, f"{down_id}.m", down_id))
                    edges.append((p, f"{release_id}.r", release_id))
        for dest, up, down in edges:
            if dest == me:
                continue
            try:
                poison(dest, up, down, exc)
            except Exception:  # pragma: no cover - best effort
                logger.exception("[%s] failed to poison hierarchy edge (%s, %s) at %s", me, up, down, dest)


def hierarchy_aggregate(
    fed_objects: Sequence[Any],
    weights: Optional[Sequence[float]] = None,
    *,
    region_size: int,
    stream: str = "hier",
    timeout: Optional[float] = None,
    quant: Any = None,
    quant_ref: Optional[Any] = None,
    quant_scope: Optional[str] = None,
    quant_downlink: bool = False,
    seq_ids: Optional[Sequence[Any]] = None,
    round_tag: Optional[int] = None,
    epoch: Optional[int] = None,
    timings: Optional[Dict[str, float]] = None,
    dead: Sequence[str] = (),
    server_step: Optional[Any] = None,
    region_branch: Optional[int] = None,
    region_quorum: Optional[int] = None,
    region_deadline_s: Optional[float] = None,
    ring_downlink: bool = True,
) -> Any:
    """FedAvg round over the derived multi-level hierarchy (module
    docstring), on the runtime's device.

    Every controller calls it at the same program point with the same
    arguments and gets the same bytes: ``packed_quantized_sum`` over the
    contributions (or, under a region cutoff, over the arrived ones).
    ``quant`` (the round's shared grid) is required.  ``region_size``
    partitions the sorted roster; ``region_branch`` sets the interior
    degree (default ``max(2, region_size)``: two levels until the region
    count exceeds it); ``region_quorum``/``region_deadline_s`` enable the
    per-region cutoffs; ``ring_downlink`` relays the broadcast member to
    member (default) instead of a coordinator fan-out.  ``seq_ids``:
    :data:`HIER_SEQ_IDS` pre-allocated rendezvous ids.  ``epoch`` stamps
    every frame.  ``timings`` receives ``push_s``, ``agg_s`` and
    ``ps_dtypes`` (the partial sums' wire dtype per level, leaves first).
    An aborted round raises :class:`HierarchyRoundError` on
    every controller.  ``server_step`` (:mod:`rayfed_tpu_torch.fl.
    server_opt`): applied once, at the root, between its rescale and the
    downlink, so every controller receives the post-step model.
    """
    from rayfed_tpu_torch.fed_object import FedObject
    from rayfed_tpu_torch.runtime import get_runtime

    runtime = get_runtime()
    objs = list(fed_objects)
    if not objs:
        raise ValueError("hierarchy_aggregate needs at least one contribution")
    for obj in objs:
        if not isinstance(obj, FedObject):
            raise TypeError(
                "hierarchy_aggregate consumes FedObjects (party-owned "
                f"contributions), got {type(obj).__name__}"
            )
    owners = [obj.get_party() for obj in objs]
    if len(set(owners)) != len(owners):
        raise ValueError(
            "hierarchy_aggregate needs exactly one contribution per "
            f"party (owners: {owners}) — aggregate duplicates locally first"
        )
    if weights is not None and len(weights) != len(objs):
        raise ValueError(f"{len(weights)} weights for {len(objs)} contributions")
    if seq_ids is None:
        seq_ids = [runtime.next_seq_id() for _ in range(HIER_SEQ_IDS)]
    me = runtime.party
    backstop = timeout if timeout is not None else runtime.job_config.recv_backstop_s
    w_map = None if weights is None else {p: float(w) for p, w in zip(owners, weights)}
    if me not in owners:
        raise HierarchyRoundError(
            f"{me!r} contributes nothing this round — observer "
            f"controllers are not supported by hierarchy rounds (use "
            f"the flat streaming path)"
        )
    rnd = HierarchyRound(
        runtime.send_proxy,
        party=me,
        members=owners,
        region_size=region_size,
        grid=quant,
        quant_ref=quant_ref,
        keys=seq_ids,
        weights=w_map,
        stream=stream,
        epoch=epoch,
        round_tag=round_tag,
        backstop=backstop,
        quant_scope=quant_scope,
        allowed=runtime.cluster_config.serializing_allowed_list,
        quant_downlink=quant_downlink,
        dead=dead,
        timings=timings,
        server_step=server_step,
        branch=region_branch,
        region_quorum=region_quorum,
        region_deadline_s=region_deadline_s,
        ring_downlink=ring_downlink,
        device=runtime.transport.device,
    )
    local_value = objs[owners.index(me)].get_local_ref().resolve(timeout=backstop)
    return rnd.run(local_value)
