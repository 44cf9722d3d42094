"""The port's hierarchical aggregation (CPU) against the JAX package's, after
``tests/test_hierarchy.py``.

The data plane runs through bare ``TransportManager`` virtual parties
(threads in one process, real loopback sockets), as the reference's tests
do: ``HierarchyRound`` needs no fed runtime.  Contributions are made from
numpy seeds and coded on one grid; integer folds are exact, so every
result is held to byte identity with the JAX package's
``packed_quantized_sum`` over the same codes (or over the arrived subset,
after a region cutoff).  One round mixes parties of the two packages; the
pure functions (partition, layout, relay chains, dtypes, manifests) give
the JAX package's outputs on the same inputs; ``RegionSumTree`` payloads
are the JAX package's bytes and each side decodes the other's.
"""

import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayfed_tpu.config import (
    ClusterConfig as JClusterConfig,
    JobConfig as JJobConfig,
    PartyConfig as JPartyConfig,
)
from rayfed_tpu.fl import compression as jc
from rayfed_tpu.fl import fedavg as jf
from rayfed_tpu.fl import hierarchy as JH
from rayfed_tpu.fl import quantize as jqz
from rayfed_tpu.transport import wire as jwire
from rayfed_tpu.transport.manager import TransportManager as JTransportManager
from rayfed_tpu.transport.manager import branch_groups as jbranch_groups
from rayfed_tpu.transport.manager import partition_regions as jpartition_regions
from rayfed_tpu_torch.config import ClusterConfig, JobConfig, PartyConfig
from rayfed_tpu_torch.fl import compression as tc
from rayfed_tpu_torch.fl import hierarchy as H
from rayfed_tpu_torch.fl import quantize as qz
from rayfed_tpu_torch.fl.streaming import StreamingAggregator
from rayfed_tpu_torch.transport import wire
from rayfed_tpu_torch.transport.manager import TransportManager, branch_groups, partition_regions
from tests.multiproc import get_free_ports

CPU = torch.device("cpu")
CE = 1 << 9  # 512-element blocks: many blocks on toy buffers


def _raw(x):
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _payload(bufs):
    return b"".join(
        bytes(b) if isinstance(b, (bytes, bytearray)) else bytes(memoryview(b).cast("B"))
        for b in bufs
    )


def _layout_tuple(lay):
    """A layout of either package as plain data."""
    return (
        lay.regions, lay.live, lay.coordinators, lay.active, lay.root, lay.root_region,
        [{n: (tuple(nd.children), nd.coordinator) for n, nd in level.items()} for level in lay.levels],
        lay.branch,
    )


# -- deterministic partition and layout (pure functions) ---------------------------


def test_partition_regions_deterministic_and_validates():
    for members, size in ((["d", "a", "c", "b"], 2), (["a", "b", "c", "d", "e"], 2), (["a"], 4)):
        assert partition_regions(members, size) == jpartition_regions(members, size)
    assert partition_regions(["d", "a", "c", "b"], 2) == [["a", "b"], ["c", "d"]]
    with pytest.raises(ValueError, match="region_size"):
        partition_regions(["a"], 0)
    with pytest.raises(ValueError, match="empty"):
        partition_regions([], 2)


def test_partition_determinism_under_roster_churn():
    before, after = ["a", "b", "c", "d"], ["a", "b", "d"]
    assert partition_regions(before, 2) != partition_regions(after, 2)
    for members in (before, after, ["d", "a", "b", "c"]):
        assert H.members_fingerprint(members) == JH.members_fingerprint(members)
    assert H.members_fingerprint(before) != H.members_fingerprint(after)
    assert H.members_fingerprint(["d", "a", "b", "c"]) == H.members_fingerprint(before)


def test_region_layout_dead_coordinator_fails_over_via_successor():
    members = ["a", "b", "c", "d"]
    for dead in ((), ["c"], ["a"], ["c", "d"]):
        assert _layout_tuple(H.region_layout(members, 2, dead=dead)) == _layout_tuple(
            JH.region_layout(members, 2, dead=dead))
    assert H.region_layout(members, 2, dead=["c"]).coordinators == {0: "a", 1: "d"}
    lay3 = H.region_layout(members, 2, dead=["a"])
    assert lay3.coordinators == {0: "b", 1: "c"} and lay3.root == "b"
    assert H.region_layout(members, 2, dead=["c", "d"]).active == [0]
    with pytest.raises(H.HierarchyRoundError, match="no live party"):
        H.region_layout(members, 2, dead=members)


def test_branch_groups_full_id_range_contract():
    for ids, b in (([0, 1, 2, 3, 4, 5, 6, 7], 2), ([0, 1, 2, 3, 6, 7], 2), ([5], 4), ([7, 2, 0], 4)):
        assert branch_groups(ids, b) == jbranch_groups(ids, b)
    assert branch_groups([0, 1, 2, 3, 6, 7], 2) == [(0, [0, 1]), (1, [2, 3]), (3, [6, 7])]
    with pytest.raises(ValueError, match="branch"):
        branch_groups([0, 1], 1)


def test_relay_chains_bounded_and_even():
    for n in (0, 1, 7, 8, 9, 16, 17, 33, 64):
        members = [f"p{i:02d}" for i in range(n)]
        assert H._relay_chains(members) == JH._relay_chains(members), n
        assert H._relay_chains(members, 3) == JH._relay_chains(members, 3), n
    chains = H._relay_chains([f"p{i:02d}" for i in range(33)])
    assert len(chains) == 5 and max(map(len, chains)) - min(map(len, chains)) <= 1
    with pytest.raises(ValueError, match="max_hops"):
        H._relay_chains(["a"], 0)


def test_region_layout_multilevel_recursion_deterministic():
    import random

    members = [f"m{i:02d}" for i in range(16)]
    for size, branch in ((2, 2), (2, 4), (8, None), (4, 2), (3, 3), (1, 2)):
        assert _layout_tuple(H.region_layout(members, size, branch=branch)) == _layout_tuple(
            JH.region_layout(members, size, branch=branch)), (size, branch)
    lay = H.region_layout(members, 2, branch=2)
    assert len(lay.levels) == 3 and lay.levels[2][0].coordinator == lay.root == "m00"
    shuffled = list(members)
    random.Random(5).shuffle(shuffled)
    assert H.region_layout(shuffled, 2, branch=2) == lay
    with pytest.raises(ValueError, match="branch"):
        H.region_layout(members, 2, branch=1)


def test_region_layout_multilevel_death_stability_and_epoch_churn():
    members = [f"m{i:02d}" for i in range(16)]
    for dead in (["m06", "m07"], ["m00", "m01"], ["m03"], ["m00", "m04", "m05", "m15"]):
        assert _layout_tuple(H.region_layout(members, 2, dead=dead, branch=2)) == _layout_tuple(
            JH.region_layout(members, 2, dead=dead, branch=2)), dead
    lay2 = H.region_layout(members, 2, dead=["m06", "m07"], branch=2)
    assert lay2.levels[0][1].children == (2,) and lay2.levels[0][1].coordinator == "m04"
    assert H.region_layout(members, 2, dead=["m00", "m01"], branch=2).root == "m02"
    after = [p for p in members if p not in ("m06", "m07")]
    assert H.region_layout(after, 2, branch=2).regions != lay2.regions


def test_partial_sum_dtype_narrowest_exact():
    for qmax, w in ((255, 4), (255, 128), (255, 129), (255, 8_000_000), (127, 258), (255, 64), (255, 512)):
        assert H.partial_sum_dtype(qmax, w) == JH.partial_sum_dtype(qmax, w), (qmax, w)
    assert H.partial_sum_dtype(255, 128) == "int16" and H.partial_sum_dtype(255, 129) == "int32"
    with pytest.raises(ValueError, match="overflow"):
        H.partial_sum_dtype(255, 9_000_000)


def test_region_meta_schema_and_check():
    kw = dict(qgrid_fp=123, members_fp=H.members_fingerprint(["a", "b"]), epoch=4,
              level=0, parent=1, path="1/0")
    meta = H.make_region_meta("rs", 1, 3, 0, 2, 9, 4100, "uint8", **kw)
    assert meta == JH.make_region_meta("rs", 1, 3, 0, 2, 9, 4100, "uint8", **kw)
    assert H.HIERARCHY_VERSION == JH.HIERARCHY_VERSION
    want = dict(meta)
    want.pop("v")
    H.check_region_meta(json.dumps(meta), want)
    with pytest.raises(H.HierarchyRoundError, match="mf="):
        H.check_region_meta(json.dumps(meta), {**want, "mf": H.members_fingerprint(["a", "b", "c"])})
    with pytest.raises(H.HierarchyRoundError, match="ep="):
        H.check_region_meta(json.dumps(meta), {**want, "ep": 5})
    with pytest.raises(H.HierarchyRoundError, match="understands up to"):
        H.check_region_meta(json.dumps({**meta, "v": H.HIERARCHY_VERSION + 1}), want)


def test_region_manifest_holds_the_wire_format_lock(monkeypatch):
    """The hierarchy entries of ``tool/wire_format.lock``
    (``hierarchy_region_schema`` and ``hierarchy_version``): the lock's
    fingerprint, recomputed with the port's ``make_region_meta``,
    ``members_fingerprint`` and version in place of the JAX package's, is
    still the pinned one."""
    import pathlib

    from tool import check_wire_format

    monkeypatch.setattr(JH, "make_region_meta", H.make_region_meta)
    monkeypatch.setattr(JH, "members_fingerprint", H.members_fingerprint)
    monkeypatch.setattr(JH, "HIERARCHY_VERSION", H.HIERARCHY_VERSION)
    lock = json.loads((pathlib.Path(check_wire_format.__file__).parent / "wire_format.lock").read_text())
    assert check_wire_format.compute_fingerprint() == lock["fingerprint"]


# -- RegionSumTree and the presummed fold (in memory) ------------------------------


def _toy(n=4, size=4_000, seed=7):
    """The shared reference, n contributions (each package's PackedTree of
    the same values) and the round grid (each package's)."""
    rng = np.random.default_rng(seed)
    ref = rng.normal(size=(size,)).astype(np.float32)
    ups = [ref + 0.01 * rng.normal(size=(size,)).astype(np.float32) for _ in range(n)]
    prev = 0.01 * rng.normal(size=(size,)).astype(np.float32)
    tp = [tc.pack_tree({"w": torch.from_numpy(u.copy())}, torch.float32) for u in ups]
    jp = [jc.pack_tree({"w": jnp.asarray(u)}, jnp.float32) for u in ups]
    tgrid = qz.make_round_grid(prev, chunk_elems=CE, mode="delta", expand=4.0)
    jgrid = jqz.make_round_grid(prev, chunk_elems=CE, mode="delta", expand=4.0)
    return ref, tp, jp, tgrid, jgrid


def _region_sum(pkg, qts, weights, grid, spec, ps_dtype):
    acc = np.zeros(grid.total_elems, np.int64)
    for w, qt in zip(weights, qts):
        acc += int(w) * np.asarray(qt.buf).astype(np.int64)
    cls, comp = (H.RegionSumTree, tc) if pkg == "torch" else (JH.RegionSumTree, jc)
    return cls(acc.astype(np.dtype(ps_dtype)), grid.scales, grid.zps, (),
               comp.PackSpec(spec.entries, spec.treedef, ps_dtype), grid.meta())


def test_region_sum_tree_refuses_decode_and_pickles():
    ref, tp, jp, tgrid, jgrid = _toy(2)
    tq = [qz.quantize_packed(p, tgrid, ref=ref) for p in tp]
    jq = [jqz.quantize_packed(p, jgrid, ref=ref) for p in jp]
    for ps_dtype in ("int16", "int32"):
        rs = _region_sum("torch", tq, [1, 2], tgrid, tq[0].spec, ps_dtype)
        jrs = _region_sum("jax", jq, [1, 2], jgrid, jq[0].spec, ps_dtype)
        with pytest.raises(H.HierarchyRoundError, match="PARTIAL"):
            rs.dequantize()
        with pytest.raises(H.HierarchyRoundError, match="dequantize"):
            rs.unpack()
        tbytes = _payload(wire.encode_payload(rs))
        jbytes = _payload(jwire.encode_payload(jrs))
        assert tbytes == jbytes, ps_dtype
        # Each package decodes the other's payload as its own class, under
        # an empty allowlist (the class is admitted internally).
        back = wire.decode_payload(jbytes, allowed={})
        assert isinstance(back, H.RegionSumTree) and back.arrived_w is None
        assert _raw(back.buf) == _raw(rs.buf) and tuple(back.gmeta) == tuple(rs.gmeta)
        jback = jwire.decode_payload(tbytes, allowed={})
        assert isinstance(jback, JH.RegionSumTree) and _raw(jback.buf) == _raw(jrs.buf)
    cut = H.RegionSumTree(rs.buf, rs.scales, rs.zps, (), rs.spec, rs.gmeta, arrived_w=5)
    jcut = JH.RegionSumTree(jrs.buf, jrs.scales, jrs.zps, (), jrs.spec, jrs.gmeta, arrived_w=5)
    assert _payload(wire.encode_payload(cut)) == _payload(jwire.encode_payload(jcut))
    assert jwire.decode_payload(_payload(wire.encode_payload(cut)), allowed={}).arrived_w == 5


def test_presummed_aggregator_validation():
    ref, tp, jp, grid, _ = _toy(2)
    with pytest.raises(ValueError, match="requires quant"):
        StreamingAggregator(2, presummed="int16", device=CPU)
    with pytest.raises(ValueError, match="integer wire dtype"):
        StreamingAggregator(2, chunk_elems=CE, quant=grid, quant_ref=ref, presummed="float32", device=CPU)
    # Secure aggregation is a later item of the port (the reference says
    # "mutually exclusive" for masked + presummed).
    with pytest.raises(NotImplementedError, match="item 8"):
        StreamingAggregator(2, chunk_elems=CE, quant=grid, quant_ref=ref, masked=True,
                            presummed="int32", device=CPU)
    qts = [qz.quantize_packed(p, grid, ref=ref) for p in tp]
    agg = StreamingAggregator(1, weights=[3.0], chunk_elems=CE, quant=grid, quant_ref=ref,
                              presummed="int16", device=CPU)
    agg.add_local(0, qts[0])
    with pytest.raises(TypeError, match="presummed fold got"):
        agg.result(timeout=10)
    rs = _region_sum("torch", qts, [1, 1], grid, qts[0].spec, "int16")
    agg2 = StreamingAggregator(1, chunk_elems=CE, quant=grid, quant_ref=ref, device=CPU)
    agg2.add_local(0, rs)
    with pytest.raises(TypeError, match="not presummed"):
        agg2.result(timeout=10)
    # Over the wire: a per-party code tree into a presummed fold, and a
    # partial sum at the wrong width.
    agg3 = StreamingAggregator(2, weights=[1, 1], chunk_elems=CE, quant=grid, quant_ref=ref,
                               presummed="int16", device=CPU)
    agg3.add_local(0, rs)
    agg3.sink(1).on_complete(_payload(wire.encode_payload(qts[1])))
    with pytest.raises(ValueError, match="layout mismatch"):
        agg3.result(timeout=10)
    agg4 = StreamingAggregator(2, weights=[1, 1], chunk_elems=CE, quant=grid, quant_ref=ref,
                               presummed="int32", device=CPU)
    agg4.sink(0).on_complete(_payload(wire.encode_payload(rs)))
    agg4.add_local(1, _region_sum("torch", qts, [1, 1], grid, qts[0].spec, "int32"))
    with pytest.raises(ValueError, match="int16 codes, this round folds int32"):
        agg4.result(timeout=10)


@pytest.mark.parametrize("ps_dtype", ["int16", "int32"])
def test_presummed_fold_bitexact_vs_flat(ps_dtype):
    """Region sums folded at unit weight (one local, one over the wire)
    give the JAX package's ``packed_quantized_sum`` over every party, at
    either partial-sum width: the fold widens int16 and int32 chunks into
    the i32 accumulator."""
    ref, tp, jp, tgrid, jgrid = _toy(4)
    ws = [3, 1, 2, 5]
    tq = [qz.quantize_packed(p, tgrid, ref=ref) for p in tp]
    jq = [jqz.quantize_packed(p, jgrid, ref=ref) for p in jp]
    want = jf.packed_quantized_sum(jq, ws, ref=ref)
    rs0 = _region_sum("torch", tq[:2], ws[:2], tgrid, tq[0].spec, ps_dtype)
    rs1 = _region_sum("torch", tq[2:], ws[2:], tgrid, tq[0].spec, ps_dtype)
    agg = StreamingAggregator(2, weights=[float(sum(ws[:2])), float(sum(ws[2:]))], chunk_elems=CE,
                              quant=tgrid, quant_ref=ref, presummed=ps_dtype,
                              labels=["region 0", "region 1"], device=CPU)
    agg.add_local(0, rs0)
    agg.sink(1).on_complete(_payload(wire.encode_payload(rs1)))
    got = agg.result(timeout=30)
    assert _raw(got.buf) == _raw(want.buf)


# -- in-process virtual parties: the whole data plane over real sockets ------------


def _manager(pkg, party, ports, options=None):
    def entry(p, port):
        return {"address": f"127.0.0.1:{port}",
                **({"transport_options": options[p]} if options and p in options else {})}

    if pkg == "jax":
        cc = JClusterConfig(parties={p: JPartyConfig.from_dict(entry(p, port)) for p, port in ports.items()},
                            current_party=party)
        return JTransportManager(cc, JJobConfig(device_put_received=False, zero_copy_host_arrays=True,
                                                cross_silo_timeout_s=20))
    cc = ClusterConfig(parties={p: PartyConfig.from_dict(entry(p, port)) for p, port in ports.items()},
                       current_party=party)
    return TransportManager(cc, JobConfig(device_put_received=False, zero_copy_host_arrays=True,
                                          cross_silo_timeout_s=20), device=CPU)


class _Cluster:
    """N in-process virtual parties (one TransportManager each; ``jax``
    names the parties that run the JAX package)."""

    def __init__(self, parties, options=None, jax=()):
        self.parties = list(parties)
        self.jax = set(jax)
        ports = dict(zip(self.parties, get_free_ports(len(self.parties))))
        self.mgrs = {p: _manager("jax" if p in self.jax else "torch", p, ports, options)
                     for p in self.parties}
        for m in self.mgrs.values():
            m.start()

    def stop(self):
        # In parallel: a manager's shutdown can wait out its peers' links.
        def stop_one(m):
            try:
                m.stop()
            except Exception:
                pass

        threads = [threading.Thread(target=stop_one, args=(m,), daemon=True) for m in self.mgrs.values()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)

    def run_round(self, contribs, grids, ref, *, region_size, keys, weights=None, dead=(),
                  stagger=None, epoch=None, quant_downlink=False, skip=(), **hier_kw):
        """One HierarchyRound on every (non-skipped) party thread, each
        party on its own package (``contribs``/``grids``: ``{"torch": ...,
        "jax": ...}``).  Returns ({party: result}, {party: exception})."""
        results, errors = {}, {}

        def run_party(p, i):
            pkg = "jax" if p in self.jax else "torch"
            try:
                kw = dict(hier_kw)
                if pkg == "torch":
                    kw["device"] = CPU
                rnd = (JH if pkg == "jax" else H).HierarchyRound(
                    self.mgrs[p], party=p, members=self.parties, region_size=region_size,
                    grid=grids[pkg], quant_ref=ref, keys=keys, weights=weights, stream="ht",
                    backstop=60, dead=dead, epoch=epoch, quant_downlink=quant_downlink, **kw,
                )
                if stagger:
                    time.sleep(stagger[i % len(stagger)])
                results[p] = rnd.run(contribs[pkg][p])
            except BaseException as e:
                errors[p] = e

        threads = [threading.Thread(target=run_party, args=(p, i), daemon=True)
                   for i, p in enumerate(self.parties) if p not in set(dead) | set(skip)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads), "a party thread hung"
        return results, errors


PARTIES4 = ["p00", "p01", "p02", "p03"]


@pytest.fixture()
def cluster4():
    c = _Cluster(PARTIES4)
    yield c
    c.stop()


def _round_inputs(parties, n, ref_fn, grid_seed, seed0):
    """Each package's contributions (the same values) and grids (from the
    same previous delta), as the reference's tests make them."""
    ref = ref_fn(n)
    ups = {}
    for i, p in enumerate(parties):
        rng = np.random.default_rng(seed0 + i)
        ups[p] = ref + 0.01 * rng.normal(size=ref.shape).astype(np.float32)
    prev = (0.01 * np.random.default_rng(grid_seed).standard_normal(ref.size)).astype(np.float32)
    contribs = {
        "torch": {p: tc.pack_tree({"w": torch.from_numpy(u.copy())}, torch.float32) for p, u in ups.items()},
        "jax": {p: jc.pack_tree({"w": jnp.asarray(u)}, jnp.float32) for p, u in ups.items()},
    }
    grids = {"torch": qz.make_round_grid(prev, mode="delta", expand=4.0, chunk_elems=CE),
             "jax": jqz.make_round_grid(prev, mode="delta", expand=4.0, chunk_elems=CE)}
    return ref, contribs, grids


def _want(contribs, grids, ref, members, weights=None):
    """The JAX package's one-shot compressed-domain reduce over ``members``."""
    jq = [jqz.quantize_packed(contribs["jax"][p], grids["jax"], ref=ref) for p in members]
    return jf.packed_quantized_sum(jq, None if weights is None else [weights[p] for p in members], ref=ref)


def test_hierarchy_n4_bitexact_vs_flat_under_shuffled_arrival(cluster4):
    """hierarchy(N=4, two regions) equals the port's flat streaming fold and
    the JAX package's ``packed_quantized_sum`` byte for byte, under shuffled
    arrival at every level."""
    ref, contribs, grids = _round_inputs(PARTIES4, 4_100, lambda n: np.linspace(-0.5, 0.5, n).astype(np.float32),
                                         0, 100)
    weights = {p: float(w) for p, w in zip(PARTIES4, [2, 1, 3, 1])}
    want = _want(contribs, grids, ref, PARTIES4, weights)
    tq = [qz.quantize_packed(contribs["torch"][p], grids["torch"], ref=ref) for p in PARTIES4]
    flat = StreamingAggregator(4, weights=[weights[p] for p in PARTIES4], chunk_elems=CE,
                               quant=grids["torch"], quant_ref=ref, device=CPU)
    for i in (2, 0, 3):
        flat.sink(i).on_complete(_payload(wire.encode_payload(tq[i])))
    flat.add_local(1, tq[1])
    assert _raw(flat.result(timeout=30).buf) == _raw(want.buf)
    for r, stagger in enumerate([(0.0, 0.02, 0.01), (0.03, 0.0, 0.0)]):
        results, errors = cluster4.run_round(contribs, grids, ref, region_size=2,
                                             keys=[f"r{r}k{j}" for j in range(6)],
                                             weights=weights, stagger=stagger)
        assert not errors, errors
        for p in PARTIES4:
            assert _raw(results[p].buf) == _raw(want.buf), f"{p} round {r}"


def test_hierarchy_quant_downlink_byte_agree(cluster4):
    """With the re-quantized downlink every party returns the JAX
    package's ``quantize_downlink`` of the exact aggregate, dequantized."""
    ref, contribs, grids = _round_inputs(PARTIES4, 4_096, lambda n: np.linspace(-0.2, 0.8, n).astype(np.float32),
                                         3, 500)
    results, errors = cluster4.run_round(contribs, grids, ref, region_size=2,
                                         keys=[f"dk{j}" for j in range(6)], quant_downlink=True)
    assert not errors, errors
    exact = _want(contribs, grids, ref, PARTIES4)
    down = jqz.make_round_grid(np.asarray(exact.buf, np.float32) - ref, chunk_elems=CE,
                               wire_dtype=grids["jax"].wire_dtype, mode="delta")
    expect = jqz.quantize_packed(exact, down, ref=ref).dequantize(np.float32, ref=ref)
    for p in PARTIES4:
        assert _raw(results[p].buf) == _raw(expect.buf), p


def test_hierarchy_uneven_regions_single_member_region():
    """N=5 at region_size=2: regions of 2, 2 and 1 (the last a local fold)."""
    parties = [f"q{i:02d}" for i in range(5)]
    c = _Cluster(parties)
    try:
        ref, contribs, grids = _round_inputs(parties, 3_000, lambda n: np.zeros(n, np.float32), 9, 900)
        weights = {p: float(i + 1) for i, p in enumerate(parties)}
        results, errors = c.run_round(contribs, grids, ref, region_size=2,
                                      keys=[f"u{j}" for j in range(6)], weights=weights)
        assert not errors, errors
        want = _want(contribs, grids, ref, parties, weights)
        for p in parties:
            assert _raw(results[p].buf) == _raw(want.buf), p
    finally:
        c.stop()


def test_hierarchy_multilevel_n8_bitexact_ring_and_hub():
    """A three-level tree (N=8, region_size=2, branch=2) in both leaf modes
    (stripe ring with the relay downlink, and fan-out; the quorum hub at
    full quorum) equals ``packed_quantized_sum``; the leaves ship int16
    partial sums and the levels above int32."""
    parties = [f"t{i:02d}" for i in range(8)]
    c = _Cluster(parties)
    try:
        ref, contribs, grids = _round_inputs(parties, 3_000, lambda n: np.zeros(n, np.float32), 31, 700)
        weights = {p: float(w) for p, w in zip(parties, [3, 1, 2, 5, 1, 2, 1, 4])}
        want = _want(contribs, grids, ref, parties, weights)
        cutoffs0 = H.HIER_STATS["region_cutoffs"]
        for tag, kw in [("ring", dict(branch=2)), ("hub", dict(branch=2, region_quorum=2)),
                        ("fan", dict(branch=2, ring_downlink=False))]:
            results, errors = c.run_round(contribs, grids, ref, region_size=2,
                                          keys=[f"m{tag}{j}" for j in range(6)], weights=weights, **kw)
            assert not errors, (tag, errors)
            for p in parties:
                assert _raw(results[p].buf) == _raw(want.buf), f"{p} [{tag}]"
        assert H.HIER_STATS["region_cutoffs"] == cutoffs0
        rnd = H.HierarchyRound(object(), party="t00", members=parties, region_size=2, grid=grids["torch"],
                               quant_ref=ref, keys=["k"] * 6, weights=weights, branch=2, device=CPU)
        jrnd = JH.HierarchyRound(object(), party="t00", members=parties, region_size=2, grid=grids["jax"],
                                 quant_ref=ref, keys=["k"] * 6, weights=weights, branch=2)
        assert rnd._lvl_dtype == jrnd._lvl_dtype == ["int16", "int16"]
        assert rnd._coordinated == jrnd._coordinated == [(0, 0), (1, 0), (2, 0)]
    finally:
        c.stop()


def test_hierarchy_multilevel_partial_sum_dtypes_follow_the_levels():
    """Sixteen parties of weight 32 on a uint8 grid (region_size=4,
    branch=2): the leaves ship int16 (255·128 ≤ 32767), the interior nodes
    int32 (255·256), which the root folds — the JAX package's per-level
    choice."""
    parties = [f"v{i:02d}" for i in range(16)]
    weights = {p: 32.0 for p in parties}
    ref = np.zeros(2_000, np.float32)
    tgrid = qz.make_round_grid(np.full(2_000, 0.01, np.float32), mode="delta", chunk_elems=CE)
    jgrid = jqz.make_round_grid(np.full(2_000, 0.01, np.float32), mode="delta", chunk_elems=CE)
    rnd = H.HierarchyRound(object(), party="v00", members=parties, region_size=4, grid=tgrid, quant_ref=ref,
                           keys=["k"] * 6, weights=weights, branch=2, device=CPU)
    jrnd = JH.HierarchyRound(object(), party="v00", members=parties, region_size=4, grid=jgrid, quant_ref=ref,
                             keys=["k"] * 6, weights=weights, branch=2)
    assert rnd._lvl_dtype == jrnd._lvl_dtype == ["int16", "int32"]
    assert [len(level) for level in rnd._lay.levels] == [2, 1]


def test_hierarchy_region_quorum_cutoff_absorbs_dead_member():
    """One region member never joins: its region's deadline-gated hub fold
    contributes the arrived subset, the root divides by the arrived Σw, the
    round completes, and every live party holds ``packed_quantized_sum``
    over the arrived members."""
    parties = [f"x{i:02d}" for i in range(6)]
    silent = "x04"
    c = _Cluster(parties)
    try:
        ref, contribs, grids = _round_inputs(parties, 3_000, lambda n: np.zeros(n, np.float32), 41, 800)
        # The silent member carries the largest weight: a root dividing by
        # the roster Σw would be loudly wrong.
        weights = {p: float(w) for p, w in zip(parties, [2, 1, 3, 1, 5, 2])}
        cutoffs0, aborted0 = H.HIER_STATS["region_cutoffs"], H.HIER_STATS["rounds_aborted"]
        results, errors = c.run_round(contribs, grids, ref, region_size=3, keys=[f"rq{j}" for j in range(6)],
                                      weights=weights, skip=(silent,), region_quorum=2, region_deadline_s=1.0)
        assert not errors, errors
        assert H.HIER_STATS["region_cutoffs"] == cutoffs0 + 1
        assert H.HIER_STATS["rounds_aborted"] == aborted0
        arrived = [p for p in parties if p != silent]
        want = _want(contribs, grids, ref, arrived, weights)
        for p in arrived:
            assert _raw(results[p].buf) == _raw(want.buf), p
    finally:
        c.stop()


def test_hierarchy_region_quorum_validation():
    ref, _, _, grid, jgrid = _toy(2)
    kw = dict(party="a", members=["a", "b"], region_size=2, grid=grid, quant_ref=ref, keys=["k"] * 6, device=CPU)
    with pytest.raises(ValueError, match="region_quorum"):
        H.HierarchyRound(object(), region_quorum=0, **kw)
    with pytest.raises(ValueError, match="needs region_quorum"):
        H.HierarchyRound(object(), region_deadline_s=1.0, **kw)
    # A server step is taken, as the JAX package takes it: the root applies
    # it once before the downlink (held by bytes in test_torch_server_opt).
    step = lambda x: x  # noqa: E731
    assert H.HierarchyRound(object(), server_step=step, **kw)._server_step is step
    jkw = dict(kw, grid=jgrid, quant_ref=np.asarray(ref))
    jkw.pop("device")
    assert JH.HierarchyRound(object(), server_step=step, **jkw)._server_step is step


def test_hierarchy_refuses_passthrough_and_unquantized():
    ref, tp, _, grid, _ = _toy(2)
    base = dict(region_size=1, keys=["k"] * 6, device=CPU)
    with pytest.raises(H.HierarchyRoundError, match="compressed domain"):
        H.HierarchyRound(object(), party="a", members=["a", "b"], grid=None, quant_ref=None, **base)
    with pytest.raises(H.HierarchyRoundError, match="observer"):
        H.HierarchyRound(object(), party="z", members=["a", "b"], grid=grid, quant_ref=ref, **base)
    with pytest.raises(ValueError, match="rendezvous ids"):
        H.HierarchyRound(object(), party="a", members=["a", "b"], grid=grid, quant_ref=ref,
                         region_size=1, keys=["k"] * 3, device=CPU)
    # A contribution with non-float leaves has no tree decomposition.
    with_pt = tc.pack_tree({"w": torch.from_numpy(ref.copy()), "n": np.arange(3, dtype=np.int32)}, torch.float32)
    aborted0 = H.HIER_STATS["rounds_aborted"]
    rnd = H.HierarchyRound(object(), party="a", members=["a"], grid=grid, quant_ref=ref, **base)
    with pytest.raises(H.HierarchyRoundError, match="passthrough"):
        rnd.run(with_pt)
    assert H.HIER_STATS["rounds_aborted"] == aborted0 + 1


def test_hierarchy_stale_epoch_frames_rejected_loudly():
    """A receiver whose roster moved two epochs on rejects epoch-1 frames
    and the round aborts as HierarchyRoundError on every controller."""
    parties = ["e00", "e01"]
    c = _Cluster(parties)
    try:
        c.mgrs["e00"].roster.advance(parties)
        c.mgrs["e00"].roster.advance(parties)
        ref, contribs, grids = _round_inputs(parties, 2_000, lambda n: np.zeros(n, np.float32), 11, 50)
        results, errors = c.run_round(contribs, grids, ref, region_size=2,
                                      keys=[f"se{j}" for j in range(6)], epoch=1)
        assert set(errors) == set(parties), (results, errors)
        for p, e in errors.items():
            assert isinstance(e, H.HierarchyRoundError), (p, e)
        assert c.mgrs["e00"].get_stats().get("receive_epoch_rejects", 0) >= 1
    finally:
        c.stop()


def test_hierarchy_region_coordinator_kill_failover():
    """Hard-kill a region coordinator at the up phase: every survivor
    aborts, the layout fails the region over to ``roster_successor``, and
    the re-run over the survivors equals ``packed_quantized_sum`` over
    them."""
    victim = "p02"
    options = {victim: {"heartbeat_interval_s": 0.3, "death_deadline_s": 0.9}}
    c = _Cluster(PARTIES4, options=options)
    try:
        ref, contribs, grids = _round_inputs(PARTIES4, 3_000, lambda n: np.zeros(n, np.float32), 21, 300)
        weights = {p: float(w) for p, w in zip(PARTIES4, [2, 1, 3, 1])}
        results, errors = c.run_round(contribs, grids, ref, region_size=2,
                                      keys=[f"c0{j}" for j in range(6)], weights=weights)
        assert not errors, errors

        def kill_at_up(phase, party):
            if phase == "up" and party == victim:
                c.mgrs[victim].stop()
                raise RuntimeError("chaos: region coordinator killed")

        H._fault_hook = kill_at_up
        try:
            results, errors = c.run_round(contribs, grids, ref, region_size=2,
                                          keys=[f"c1{j}" for j in range(6)], weights=weights)
        finally:
            H._fault_hook = None
        assert set(errors) == set(PARTIES4), (results, errors)
        for p in set(PARTIES4) - {victim}:
            assert isinstance(errors[p], H.HierarchyRoundError), (p, errors[p])
        assert H.region_layout(PARTIES4, 2, dead=[victim]).coordinators[1] == "p03"
        survivors = [p for p in PARTIES4 if p != victim]
        results, errors = c.run_round(contribs, grids, ref, region_size=2, keys=[f"c2{j}" for j in range(6)],
                                      weights=weights, dead=[victim])
        assert not errors, errors
        want = _want(contribs, grids, ref, survivors, weights)
        for p in survivors:
            assert _raw(results[p].buf) == _raw(want.buf), p
    finally:
        c.stop()


def test_hierarchy_round_mixes_the_two_packages():
    """N=4 in one process: p00 and p02 (each a region coordinator, p00 the
    root) on the port, p01 and p03 on the JAX package.  Stripes, partial
    sums, the root's fold and the relayed downlink cross the packages, and
    every party holds the all-JAX round's bytes."""
    ref, contribs, grids = _round_inputs(PARTIES4, 4_100, lambda n: np.linspace(-0.3, 0.3, n).astype(np.float32),
                                         5, 600)
    weights = {p: float(w) for p, w in zip(PARTIES4, [1, 4, 2, 3])}
    all_jax = _Cluster(PARTIES4, jax=PARTIES4)
    try:
        want, errors = all_jax.run_round(contribs, grids, ref, region_size=2, keys=[f"aj{j}" for j in range(6)],
                                         weights=weights, quant_downlink=True)
        assert not errors, errors
    finally:
        all_jax.stop()
    mixed = _Cluster(PARTIES4, jax=["p01", "p03"])
    try:
        for tag, kw in (("ring", {}), ("hub", dict(region_quorum=2))):
            results, errors = mixed.run_round(contribs, grids, ref, region_size=2,
                                              keys=[f"mx{tag}{j}" for j in range(6)], weights=weights,
                                              quant_downlink=True, **kw)
            assert not errors, (tag, errors)
            for p in PARTIES4:
                assert _raw(results[p].buf) == _raw(want["p00"].buf), (tag, p)
    finally:
        mixed.stop()


# -- driver validation (no runtime needed) ------------------------------------------


def test_run_fedavg_rounds_hierarchy_validation():
    from rayfed_tpu_torch.fl import run_fedavg_rounds

    trainers = {"a": None, "b": None}
    base = dict(compress_wire=True, packed_wire=True)
    with pytest.raises(ValueError, match="requires wire_quant"):
        run_fedavg_rounds(trainers, {}, rounds=1, mode="hierarchy", region_size=1, **base)
    with pytest.raises(ValueError, match="requires region_size"):
        run_fedavg_rounds(trainers, {}, rounds=1, mode="hierarchy", wire_quant="uint8", **base)
    with pytest.raises(ValueError, match="streaming_agg are mutually"):
        run_fedavg_rounds(trainers, {}, rounds=1, mode="hierarchy", region_size=1, wire_quant="uint8",
                          streaming_agg=True, **base)
    # secure_agg is a later item of the port: it raises before the clash.
    with pytest.raises(NotImplementedError, match="item 8"):
        run_fedavg_rounds(trainers, {}, rounds=1, mode="hierarchy", region_size=1, wire_quant="uint8",
                          secure_agg=True, **base)
    with pytest.raises(ValueError, match="region_size only applies"):
        run_fedavg_rounds(trainers, {}, rounds=1, region_size=2, **base)
    with pytest.raises(ValueError, match="full participation"):
        run_fedavg_rounds(trainers, {}, rounds=1, mode="hierarchy", region_size=1, wire_quant="uint8",
                          sample=1, **base)
