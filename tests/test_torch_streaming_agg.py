"""The port's streaming aggregation (CPU) against the JAX package's.

A :class:`StreamingAggregator` on the CPU fed chunk by chunk, in shuffled
arrival orders, must give the bytes of the port's one-shot
``packed_weighted_sum`` and of the JAX package's (tolerance: byte
identity).  Also: the local contribution, a frame abort with a clean retry,
a corrupt frame, passthrough leaves, a layout mismatch, the timeout, the
masked option's verdict, and PackedTrees on delta streams between a JAX-package
manager and a port manager in one process.
"""

import random
import time

import jax
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
from rayfed_tpu.fl import streaming as jss
from rayfed_tpu.transport.manager import TransportManager as JTransportManager
from rayfed_tpu_torch.config import ClusterConfig, JobConfig, PartyConfig
from rayfed_tpu_torch.fl import compression as tc
from rayfed_tpu_torch.fl import fedavg as tf
from rayfed_tpu_torch.fl.streaming import StreamingAggregator
from rayfed_tpu_torch.transport import wire
from rayfed_tpu_torch.transport.manager import TransportManager
from tests.multiproc import get_free_ports

CPU = torch.device("cpu")


def _np_trees(n, seed=0, shapes=((400, 33), (1000,), (7, 11, 13))):
    rng = np.random.default_rng(seed)
    return [
        {f"w{j}": rng.standard_normal(s).astype(np.float32) for j, s in enumerate(shapes)}
        for _ in range(n)
    ]


def _packed(trees, wire_dtype=torch.bfloat16):
    return [tc.pack_tree({k: torch.from_numpy(v) for k, v in t.items()}, wire_dtype) for t in trees]


def _jax_packed(trees):
    return [jc.pack_tree({k: jnp.asarray(v) for k, v in t.items()}) for t in trees]


def _payload_of(packed, writable=False):
    data = b"".join(
        bytes(b) if isinstance(b, (bytes, bytearray)) else bytes(memoryview(b).cast("B"))
        for b in wire.encode_payload(packed)
    )
    return bytearray(data) if writable else data


def _raw(x):
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


def _feed(sink, payload, rng, step=None):
    mv = memoryview(payload)
    step = step or int(rng.integers(3000, 40000))
    for off in range(step, len(payload), step):
        sink.on_bytes(mv, off)
    sink.on_complete(payload)


@pytest.mark.parametrize("order_seed", [0, 1, 2])
@pytest.mark.parametrize("weights", [None, [3, 5, 7, 11]], ids=["mean", "3-5-7-11"])
@pytest.mark.parametrize("out_dtype", [None, "float32"], ids=["bf16-out", "f32-out"])
def test_streamed_equals_one_shot_equals_jax_under_shuffled_arrival(order_seed, weights, out_dtype):
    trees = _np_trees(4, seed=order_seed)
    tp = _packed(trees)
    one_shot = tf.packed_weighted_sum(tp, weights, out_dtype=out_dtype)
    jref = jf.packed_weighted_sum(
        _jax_packed(trees), weights, out_dtype=None if out_dtype is None else jnp.float32
    )
    assert _raw(one_shot.buf) == _raw(jref.buf)

    rng = np.random.default_rng(order_seed)
    agg = StreamingAggregator(4, weights=weights, out_dtype=out_dtype, chunk_elems=1 << 11, device=CPU)
    order = [1, 2, 3]
    random.Random(order_seed).shuffle(order)
    local_first = order_seed % 2 == 0
    if local_first:
        agg.add_local(0, tp[0])
    for i in order:
        _feed(agg.sink(i), _payload_of(tp[i], writable=i % 2 == 0), rng)
    if not local_first:
        agg.add_local(0, tp[0])
    out = agg.result(timeout=60)
    assert isinstance(out, tc.PackedTree) and out.spec == one_shot.spec
    assert _raw(out.buf) == _raw(one_shot.buf)
    assert set(agg.stats) >= {"agg_busy_s", "agg_tail_s", "agg_wire_s", "agg_overlap_frac"}


def _reference_streamed_fold(packed, weights, chunk_elems):
    """The JAX package's streamed fold of f32 wire buffers: its per-block
    multiply-add step (``_accum_kernel``) from a zeroed accumulator, party by
    party, then its stripe finalize.  Where ``w·x`` is inexact its fused
    multiply-adds round otherwise than the one-shot chain's, so the streamed
    bytes are the reference's streamed fold's, not ``packed_weighted_sum``'s."""
    n = packed[0].buf.numel()
    acc = jnp.zeros(n, jnp.float32)
    for p, w in zip(packed, weights):
        x = jnp.asarray(p.buf.numpy())
        for off in range(0, n, chunk_elems):
            c = min(chunk_elems, n - off)
            acc = jss._accum_kernel(c, "float32", "float32")(acc, x[off:off + c], off, jnp.float32(w))
    return np.asarray(jf.finalize_packed_stripe(acc, float(sum(weights)), n, np.float32))


def test_f32_wire_fold_leaves_its_inputs_untouched():
    """An f32 wire buffer needs no cast: the fold must still not scale the
    local contribution or a writable payload in place, and its bytes are the
    reference's streamed fold's."""
    tp = _packed(_np_trees(3, seed=3), torch.float32)
    reference = _reference_streamed_fold(tp, [3, 5, 7], 1 << 10)
    before = [_raw(p.buf) for p in tp]
    payloads = [_payload_of(p, writable=True) for p in tp]
    kept = [bytes(p) for p in payloads]
    agg = StreamingAggregator(3, weights=[3, 5, 7], chunk_elems=1 << 10, device=CPU)
    agg.add_local(0, tp[0])
    for i in (2, 1):
        _feed(agg.sink(i), payloads[i], np.random.default_rng(i))
    assert _raw(agg.result(timeout=60).buf) == reference.tobytes()
    assert [_raw(p.buf) for p in tp] == before
    assert [bytes(p) for p in payloads[1:]] == kept[1:]


def test_interleaved_partial_arrivals_fold_in_party_order():
    """Chunks of every party interleave (the last party lands first, the
    first in small steps): the result is still the one-shot bytes."""
    tp = _packed(_np_trees(3, seed=4))
    reference = tf.packed_weighted_sum(tp, [1.0, 2.5, 0.25])
    payloads = [_payload_of(p) for p in tp]
    agg = StreamingAggregator(3, weights=[1.0, 2.5, 0.25], chunk_elems=1 << 10, device=CPU)
    sinks = [agg.sink(i) for i in range(3)]
    sinks[2].on_complete(payloads[2])
    sinks[1].on_bytes(memoryview(payloads[1]), len(payloads[1]) // 3)
    sinks[1].on_complete(payloads[1])
    _feed(sinks[0], payloads[0], None, step=5001)
    assert _raw(agg.result(timeout=60).buf) == _raw(reference.buf)


@pytest.mark.parametrize("form", ["tensor", "numpy"])
def test_local_contribution_in_either_buffer_form(form):
    tp = _packed(_np_trees(2, seed=5))
    local = tp[0]
    if form == "numpy":
        local = tc.PackedTree(local.buf.view(torch.int16).numpy().view(jnp.bfloat16),
                              local.passthrough, local.spec)
    agg = StreamingAggregator(2, device=CPU)
    agg.add_local(0, local)
    agg.sink(1).on_complete(_payload_of(tp[1]))
    out = agg.result(timeout=60)
    assert _raw(out.buf) == _raw(tf.packed_weighted_sum(tp).buf)
    restored = tc.unpack_tree(out, torch.float32)
    assert restored["w0"].dtype == torch.float32 and restored["w0"].shape == (400, 33)


def test_local_contribution_must_be_packed():
    agg = StreamingAggregator(1, device=CPU)
    agg.add_local(0, {"w": torch.ones(3)})
    with pytest.raises(TypeError, match="PackedTree"):
        agg.result(timeout=10)


def test_frame_abort_and_clean_retry_stay_bit_exact():
    tp = _packed(_np_trees(2, seed=6))
    payloads = [_payload_of(p) for p in tp]
    reference = tf.packed_weighted_sum(tp)
    agg = StreamingAggregator(2, chunk_elems=1 << 10, device=CPU)
    s0 = agg.sink(0)
    stale = bytearray(payloads[0][: len(payloads[0]) // 2])
    s0.on_bytes(memoryview(stale), len(stale))
    deadline = time.monotonic() + 10
    while agg._streams[0].applied_blocks == 0 and time.monotonic() < deadline:
        time.sleep(0.02)  # let the worker fold part of the prefix
    assert agg._streams[0].applied_blocks > 0
    s0.on_frame_abort(corrupt=False)
    s0.on_bytes(memoryview(payloads[0]), len(payloads[0]))
    s0.on_complete(payloads[0])
    agg.add_local(1, tp[1])
    assert _raw(agg.result(timeout=60).buf) == _raw(reference.buf)


def test_corrupt_frame_after_partial_fold_fails_loudly():
    tp = _packed(_np_trees(2, seed=7))
    payloads = [_payload_of(p) for p in tp]
    agg = StreamingAggregator(2, chunk_elems=1 << 10, device=CPU)
    s0 = agg.sink(0)
    s0.on_bytes(memoryview(payloads[0]), len(payloads[0]))
    deadline = time.monotonic() + 10
    while agg._streams[0].applied_blocks == 0 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert agg._streams[0].applied_blocks > 0
    s0.on_frame_abort(corrupt=True)
    agg.add_local(1, tp[1])
    with pytest.raises(RuntimeError, match="rolled back"):
        agg.result(timeout=30)


@pytest.mark.parametrize("weights", [None, [3, 5]], ids=["mean", "3-5"])
def test_passthrough_leaves_reduce_like_the_one_shot_and_jax(weights):
    rng = np.random.default_rng(8)
    trees = [{"w": rng.standard_normal(4096).astype(np.float32),
              "count": np.arange(4, dtype=np.int64) * (i + 1)} for i in range(2)]
    tp = [tc.pack_tree({**t, "w": torch.from_numpy(t["w"])}) for t in trees]
    jp = [jc.pack_tree({**t, "w": jnp.asarray(t["w"])}) for t in trees]
    reference = tf.packed_weighted_sum(tp, weights)
    jref = jf.packed_weighted_sum(jp, weights)
    agg = StreamingAggregator(2, weights=weights, device=CPU)
    agg.add_local(0, tp[0])
    agg.sink(1).on_complete(_payload_of(tp[1]))
    out = agg.result(timeout=60)
    assert _raw(out.buf) == _raw(reference.buf) == _raw(jref.buf)
    for got, want, jwant in zip(out.passthrough, reference.passthrough, jref.passthrough):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        np.testing.assert_allclose(np.asarray(got), np.asarray(jwant), rtol=1e-12)


def test_layout_mismatch_fails():
    agg = StreamingAggregator(2, device=CPU)
    agg.add_local(0, tc.pack_tree({"w": torch.ones(64)}))
    agg.sink(1).on_complete(_payload_of(tc.pack_tree({"w": torch.ones(65)})))
    with pytest.raises(ValueError, match="layout mismatch"):
        agg.result(timeout=60)


def test_result_timeout_names_the_missing_source():
    agg = StreamingAggregator(2, labels=["alice", "bob"], device=CPU)
    agg.add_local(0, tc.pack_tree({"w": torch.ones(8)}))
    with pytest.raises(TimeoutError) as info:
        agg.result(timeout=0.2)
    assert info.value.missing_parties == ["bob"]


@pytest.mark.parametrize("option,item", [({"masked": True}, "item 8")])
def test_unported_options_name_their_item(option, item):
    """Item 8 is ported: ``masked=`` without a grid gets the JAX package's
    ``ValueError``."""
    with pytest.raises(ValueError) as ours:
        StreamingAggregator(2, device=CPU, **option)
    with pytest.raises(ValueError) as theirs:
        jss.StreamingAggregator(2, **option)
    assert str(ours.value) == str(theirs.value)
    assert "masked aggregation requires quant=" in str(ours.value)


@pytest.mark.parametrize("presummed", ["int16", "int32"])
def test_presummed_needs_a_grid_as_in_the_reference(presummed):
    """``presummed=`` (ported with the hierarchy) folds region partial sums
    in the compressed domain only: without ``quant=`` both packages refuse
    it with the same error."""
    with pytest.raises(ValueError) as ours:
        StreamingAggregator(2, presummed=presummed, device=CPU)
    with pytest.raises(ValueError) as theirs:
        jss.StreamingAggregator(2, presummed=presummed)
    assert str(ours.value) == str(theirs.value)


# -- managers: delta streams, recv_stream ------------------------------------------


def _cluster_dicts(ports):
    return {p: {"address": f"127.0.0.1:{port}"} for p, port in ports.items()}


def _port_manager(party, ports):
    cc = ClusterConfig(
        parties={p: PartyConfig.from_dict(c) for p, c in _cluster_dicts(ports).items()},
        current_party=party,
    )
    job = JobConfig(device_put_received=False, zero_copy_host_arrays=True, cross_silo_timeout_s=20)
    return TransportManager(cc, job, device=CPU)


def _jax_manager(party, ports):
    cc = JClusterConfig(
        parties={p: JPartyConfig.from_dict(c) for p, c in _cluster_dicts(ports).items()},
        current_party=party,
    )
    job = JJobConfig(device_put_received=False, zero_copy_host_arrays=True, cross_silo_timeout_s=20)
    return JTransportManager(cc, job)


@pytest.fixture()
def mixed_pair():
    pa, pb = get_free_ports(2)
    ports = {"alice": pa, "bob": pb}
    alice, bob = _jax_manager("alice", ports), _port_manager("bob", ports)
    alice.start()
    bob.start()
    yield alice, bob
    alice.stop()
    bob.stop()


def test_jax_and_port_managers_exchange_packed_trees_on_delta_streams(mixed_pair):
    """Round over round on one stream each way: the JAX party's PackedTree
    arrives as the port's and back, values byte for byte, and the second
    and third sends ship as deltas."""
    alice, bob = mixed_pair
    base = np.arange(wire.DELTA_CHUNK_BYTES // 2, dtype=np.float32)  # 2 bf16 chunks
    for r in range(3):
        arr = base.copy()
        arr[r * 10 : r * 10 + 5] += 1.0 + r
        jp = jc.pack_tree({"w": jnp.asarray(arr), "r": r})
        assert alice.send("bob", jp, f"pk{r}", "0", stream="pk").resolve(timeout=30)
        got = bob.recv("alice", f"pk{r}", "0").resolve(timeout=30)
        assert isinstance(got, tc.PackedTree) and got.passthrough == (r,)
        assert _raw(got.buf) == _raw(jp.buf)
        back = tc.pack_tree({"w": tc.unpack_tree(got, torch.float32)["w"] * 2, "r": r})
        assert bob.send("alice", back, f"bk{r}", "0", stream="bk").resolve(timeout=30)
        jgot = alice.recv("bob", f"bk{r}", "0").resolve(timeout=30)
        assert isinstance(jgot, jc.PackedTree) and jgot.spec == jp.spec
        assert _raw(jgot.buf) == _raw(back.buf)
    assert alice.get_stats()["delta_stream_frames"] >= 1
    assert bob.get_stats()["delta_stream_frames"] >= 1


def test_port_aggregator_folds_a_jax_party_stream(mixed_pair):
    """recv_stream hands the JAX party's packed bytes to the port's fold as
    they land; sink before the push, and mailbox replay after it."""
    alice, bob = mixed_pair
    trees = _np_trees(2, seed=9)
    jp, tp = _jax_packed(trees), _packed(trees)
    reference = jf.packed_weighted_sum(jp)
    for up in ("s-up", "s-up2"):
        agg = StreamingAggregator(2, device=CPU)
        if up == "s-up":
            bob.recv_stream("alice", up, "s-dn", agg.sink(0))
            assert alice.send("bob", jp[0], up, "s-dn").resolve(timeout=30)
        else:
            assert alice.send("bob", jp[0], up, "s-dn").resolve(timeout=30)
            deadline = time.monotonic() + 10
            while bob._mailbox.pending_count() == 0 and time.monotonic() < deadline:
                time.sleep(0.05)
            bob.recv_stream("alice", up, "s-dn", agg.sink(0))
        agg.add_local(1, tp[1])
        assert _raw(agg.result(timeout=60).buf) == _raw(reference.buf)
    assert bob._mailbox.pending_count() == 0
