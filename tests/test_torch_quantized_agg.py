"""The port's compressed-domain round (CPU) against the JAX package's, after
``tests/test_quantized_agg.py`` and the quantized cases of
``tests/test_streaming_agg.py``.

Buffers are made from numpy seeds and go through both packages.  The grid
derivation is numpy on both sides, the codes, residuals and i32
accumulators are integer arithmetic or the same float chain, and the
finalize is the same op sequence, so everything here is held to byte
identity: grids and fingerprints, codes and residuals, accumulators,
finalized and dequantized buffers, downlink codes, ``QuantizedPackedTree``
payload bytes, and the streamed fold against the one-shot fold.  The
in-process managers carry quantized payloads between a port party and a
party of either package; ``validate_round_config`` gives the JAX package's
verdict for every ``wire_quant`` pair.
"""

import itertools
import json
import random

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
from rayfed_tpu.fl import quantize as jqz
from rayfed_tpu.fl import streaming as jss
from rayfed_tpu.transport import wire as jwire
from rayfed_tpu.transport.manager import TransportManager as JTransportManager
from rayfed_tpu_torch.config import ClusterConfig, JobConfig, PartyConfig
from rayfed_tpu_torch.fl import compression as tc
from rayfed_tpu_torch.fl import fedavg as tf
from rayfed_tpu_torch.fl import quantize as qz
from rayfed_tpu_torch.fl import streaming as tss
from rayfed_tpu_torch.fl import trainer as ttrainer
from rayfed_tpu_torch.fl.streaming import StreamingAggregator
from rayfed_tpu_torch.transport import wire
from rayfed_tpu_torch.transport.manager import TransportManager
from tests.multiproc import get_free_ports

CPU = torch.device("cpu")
CE = 1 << 12  # 4096-element blocks: several blocks on toy buffers


def _raw(x):
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _payload(bufs):
    return b"".join(
        bytes(b) if isinstance(b, (bytes, bytearray)) else bytes(memoryview(b).cast("B"))
        for b in bufs
    )


def _setup(n=3, size=40_000, seed=1, extra=None):
    """The shared reference buffer, n parties' float updates a delta-scale
    away (each package's PackedTree of the same values) and the round grid
    (each package's, from the same previous delta)."""
    rng = np.random.default_rng(seed)
    ref = rng.normal(size=(size,)).astype(np.float32)
    updates = [ref + 0.01 * rng.normal(size=(size,)).astype(np.float32) for _ in range(n)]
    prev_delta = 0.01 * rng.normal(size=(size,)).astype(np.float32)

    def tree(u, pkg):
        t = {"w": jnp.asarray(u) if pkg == "jax" else torch.from_numpy(u.copy())}
        if extra is not None:
            t["n"] = extra
        return t

    jp = [jc.pack_tree(tree(u, "jax"), jnp.float32) for u in updates]
    tp = [tc.pack_tree(tree(u, "torch"), torch.float32) for u in updates]
    jgrid = jqz.make_round_grid(prev_delta, chunk_elems=CE, mode="delta", expand=4.0)
    tgrid = qz.make_round_grid(prev_delta, chunk_elems=CE, mode="delta", expand=4.0)
    return ref, jp, tp, jgrid, tgrid


def _assert_grid_equal(got, ref):
    assert _raw(got.scales) == _raw(ref.scales) and _raw(got.zps) == _raw(ref.zps)
    assert got.fingerprint() == ref.fingerprint()
    assert tuple(got.meta()) == tuple(ref.meta())
    assert qz.grid_descriptor(got) == jqz.grid_descriptor(ref)


def _assert_qtree_equal(got, ref):
    assert isinstance(got, qz.QuantizedPackedTree) and isinstance(ref, jqz.QuantizedPackedTree)
    assert _raw(got.buf) == _raw(ref.buf) and np.asarray(got.buf).dtype == np.asarray(ref.buf).dtype
    assert _raw(got.scales) == _raw(ref.scales) and _raw(got.zps) == _raw(ref.zps)
    assert tuple(got.gmeta) == tuple(ref.gmeta)
    assert got.spec.wire_dtype == ref.spec.wire_dtype and got.spec.entries == ref.spec.entries


# -- grids and descriptors ----------------------------------------------------


def _grid_bufs():
    rng = np.random.default_rng(0)
    return {
        "linspace": (np.linspace(-0.01, 0.02, 10_000, dtype=np.float32), {}),
        "tail": (rng.normal(0, 0.01, 3 * CE + 17).astype(np.float32), {}),
        "degenerate": (np.concatenate([np.zeros(CE, np.float32), np.full(CE, 0.01, np.float32),
                                       rng.normal(0, 0.01, CE).astype(np.float32)]), {}),
        "zeros": (np.zeros(CE + 5, np.float32), {}),
        "int8_abs": (rng.normal(0, 1, 2 * CE).astype(np.float32), dict(wire_dtype="int8", mode="abs")),
        "expand": (rng.normal(0, 0.01, 5000).astype(np.float32), dict(expand=4.0, floor_frac=0.2)),
        "lock": (np.linspace(-1.0, 1.0, 4096, dtype=np.float32), dict(chunk_elems=1024)),
    }


@pytest.mark.parametrize("name", sorted(_grid_bufs()))
def test_round_grid_equals_the_reference(name):
    buf, kw = _grid_bufs()[name]
    kw = dict({"chunk_elems": CE}, **kw)
    ref = jqz.make_round_grid(buf, **kw)
    _assert_grid_equal(qz.make_round_grid(buf, **kw), ref)
    _assert_grid_equal(qz.make_round_grid(torch.from_numpy(buf.copy()), **kw), ref)
    packed = tc.pack_tree({"w": torch.from_numpy(buf.copy())}, torch.float32)
    _assert_grid_equal(qz.make_round_grid(packed, **kw), ref)


def test_grid_descriptor_checks_and_guards():
    buf = np.linspace(-0.01, 0.02, 10_000, dtype=np.float32)
    g1 = qz.make_round_grid(buf, chunk_elems=CE)
    assert g1 == qz.make_round_grid(buf.copy(), chunk_elems=CE)
    buf2 = buf.copy()
    buf2[7] += 1.0  # a new block-0 max moves the fingerprint
    assert qz.make_round_grid(buf2, chunk_elems=CE).fingerprint() != g1.fingerprint()
    gd = qz.grid_descriptor(g1)
    assert gd["dt"] == "uint8" and gd["md"] == "delta" and gd["nb"] == g1.nblocks and gd["ce"] == CE
    qz.check_descriptor(gd, g1)
    qz.check_descriptor(json.dumps(gd), g1)
    jqz.check_descriptor(gd, jqz.make_round_grid(buf, chunk_elems=CE))
    with pytest.raises(ValueError, match="grid mismatch"):
        qz.check_descriptor(dict(gd, fp=gd["fp"] ^ 1), g1)
    with pytest.raises(ValueError, match="understands up to"):
        qz.check_descriptor(dict(gd, v=gd["v"] + 1), g1)
    with pytest.raises(ValueError, match="unsupported quantized wire dtype"):
        qz.make_round_grid(buf, wire_dtype="int16")
    with pytest.raises(ValueError, match="empty buffer"):
        qz.make_round_grid(np.zeros(0, np.float32))
    with pytest.raises(ValueError, match="mode"):
        qz.QuantGrid(g1.scales, g1.zps, CE, g1.total_elems, mode="rel")
    with pytest.raises(ValueError, match="canonical grid"):
        qz.QuantGrid(g1.scales[:1], g1.zps[:1], CE, g1.total_elems)
    rows = g1.rows([2, 0])
    assert _raw(rows[0]) == _raw(g1.scales[[2, 0]])
    assert g1.qabs_max == 255 and qz.make_round_grid(buf, wire_dtype="int8").qabs_max == 128


def test_grid_floor_keeps_degenerate_blocks_usable():
    buf = _grid_bufs()["degenerate"][0]
    g = qz.make_round_grid(buf, chunk_elems=CE, floor_frac=0.05)
    rms = float(np.sqrt(np.mean(buf.astype(np.float64) ** 2)))
    assert g.scales[0] >= 0.05 * rms * 2 / 255 * 0.99
    assert g.scales[1] >= 0.05 * rms * 2 / 255 * 0.99


def test_weight_and_headroom_guards_equal_the_reference():
    ref, jp, tp, jgrid, tgrid = _setup(2, size=5000)
    jq = [jqz.quantize_packed(p, jgrid, ref=ref) for p in jp]
    tq = [qz.quantize_packed(p, tgrid, ref=ref) for p in tp]
    for weights, match in (([0.5, 1.5], "integral"), ([-1, 2], "integral"),
                           ([2**31 // 255, 5], "overflow"), ([0, 0], "zero")):
        with pytest.raises(ValueError, match=match) as want:
            jf.packed_quantized_sum(jq, weights, ref=ref)
        with pytest.raises(ValueError, match=match) as got:
            tf.packed_quantized_sum(tq, weights, ref=ref)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="overflow"):
        StreamingAggregator(2, weights=[2**31 // 255, 5], chunk_elems=CE, quant=tgrid,
                            quant_ref=ref, device=CPU)
    with pytest.raises(ValueError, match="quant_ref"):
        StreamingAggregator(2, chunk_elems=CE, quant=tgrid, device=CPU)
    with pytest.raises(ValueError, match="canonical"):
        StreamingAggregator(2, chunk_elems=CE * 2, quant=tgrid, quant_ref=ref, device=CPU)
    assert tf.quant_weights(None, 3) == jf.quant_weights(None, 3) == ([1, 1, 1], 3)
    assert tf.quant_weights([3.0, 1, 2], 3) == jf.quant_weights([3.0, 1, 2], 3)


# -- the codec: codes, residuals, dequantize ------------------------------------


@pytest.mark.parametrize("mode", ["delta", "abs", "int8_delta", "bf16_update"])
def test_quantize_and_dequantize_bytes_equal_the_reference(mode):
    ref, jp, tp, jgrid, tgrid = _setup(1, extra=np.arange(3, dtype=np.int32))
    if mode == "abs":
        jgrid = jqz.make_round_grid(np.asarray(jp[0].buf), chunk_elems=CE, mode="abs")
        tgrid = qz.make_round_grid(tp[0].buf, chunk_elems=CE, mode="abs")
    elif mode == "int8_delta":
        delta = np.asarray(jp[0].buf) - ref
        jgrid = jqz.make_round_grid(delta, chunk_elems=CE, wire_dtype="int8")
        tgrid = qz.make_round_grid(delta, chunk_elems=CE, wire_dtype="int8")
    elif mode == "bf16_update":
        jp = [jc.pack_tree(jc.unpack_tree(jp[0]), jnp.bfloat16)]
        tp = [tc.pack_tree(tc.unpack_tree(tp[0]), torch.bfloat16)]
    _assert_grid_equal(tgrid, jgrid)
    kw = {} if mode == "abs" else {"ref": ref}
    want = jqz.quantize_packed(jp[0], jgrid, **kw)
    got = qz.quantize_packed(tp[0], tgrid, **kw)
    _assert_qtree_equal(got, want)
    assert isinstance(got.buf, np.ndarray) and got.nbytes == want.nbytes
    for out in (np.float32, jnp.bfloat16):
        back_j = want.dequantize(out, **kw)
        back_t = got.dequantize(torch.float32 if out is np.float32 else torch.bfloat16, **kw)
        assert _raw(back_t.buf) == _raw(back_j.buf) and back_t.spec == tc.PackSpec(
            back_t.spec.entries, back_t.spec.treedef, back_j.spec.wire_dtype)
    # A tensor reference gives the same codes as an array one.
    if mode != "abs":
        _assert_qtree_equal(qz.quantize_packed(tp[0], tgrid, ref=torch.from_numpy(ref)), want)
    # dequantize_packed and a QuantizedPackedTree's tree round trip.
    back = qz.dequantize_packed(got, ref=kw.get("ref"))
    assert _raw(back.buf) == _raw(want.dequantize(np.float32, **kw).buf)


@pytest.mark.parametrize("n, chunk", [(256, None), (4096, None), (4096 + 7, 1024)])
def test_codec_computes_only_the_buffers_elements(monkeypatch, n, chunk):
    """A buffer smaller than its grid's blocks (the async fleet's 256 and
    4096 elements on 2^21-element blocks) is coded over its own elements,
    not over a padded block, with the reference's bytes: padding cost 0.96
    async versions/s at N=64 where the reference made 4.53."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(n).astype(np.float32)
    ref = rng.standard_normal(n).astype(np.float32)
    seen = []
    fma_rows = qz.fma_rows
    monkeypatch.setattr(qz, "fma_rows",
                        lambda s, b, c, *a, **kw: (seen.append(b.numel()), fma_rows(s, b, c, *a, **kw))[1])
    jgrid = jqz.make_round_grid(x - ref, chunk_elems=chunk)
    tgrid = qz.make_round_grid(x - ref, chunk_elems=chunk)
    _assert_grid_equal(tgrid, jgrid)
    want = jqz.quantize_packed(jc.pack_tree({"w": jnp.asarray(x)}, jnp.float32), jgrid, ref=ref)
    got = qz.quantize_packed(tc.pack_tree({"w": torch.from_numpy(x)}, torch.float32), tgrid, ref=ref)
    _assert_qtree_equal(got, want)
    back_t, back_j = got.dequantize(torch.float32, ref=ref), want.dequantize(np.float32, ref=ref)
    assert _raw(back_t.buf) == _raw(back_j.buf)
    assert seen and sum(seen) == 2 * n  # the quantize residual and the dequantize, n elements each


def test_roundtrip_error_bounded_by_the_grid_step():
    ref, _, tp, _, tgrid = _setup(1)
    qt = qz.quantize_packed(tp[0], tgrid, ref=ref)
    assert qt.buf.dtype == np.uint8
    back = qt.dequantize(torch.float32, ref=ref)
    err = np.abs(back.buf.numpy() - tp[0].buf.numpy())
    step = np.repeat(tgrid.scales, CE)[: tgrid.total_elems]
    assert np.all(err <= 0.51 * step + 1e-7)


def test_delta_codes_need_the_reference():
    ref, _, tp, _, tgrid = _setup(1)
    with pytest.raises(ValueError, match="delta"):
        qz.quantize_packed(tp[0], tgrid)
    qt = qz.quantize_packed(tp[0], tgrid, ref=ref)
    with pytest.raises(ValueError, match="delta"):
        qt.dequantize(torch.float32)
    with pytest.raises(ValueError, match="delta"):
        tc.decompress(qt)  # unpack without ref must refuse
    with pytest.raises(ValueError, match="elements"):
        qz.quantize_packed(tp[0], tgrid, ref=ref[:-1])
    gabs = qz.make_round_grid(tp[0].buf, chunk_elems=CE, mode="abs")
    with pytest.raises(ValueError, match="abs"):
        qz.quantize_packed(tp[0], gabs, ref=ref)
    tree = tc.decompress(qz.quantize_packed(tp[0], gabs))
    assert set(tree) == {"w"} and tree["w"].dtype == torch.float32
    with pytest.raises(TypeError, match="already quantized"):
        qz.quantize_packed(qt, tgrid, ref=ref)
    with pytest.raises(TypeError, match="PackedTree"):
        qz.quantize_packed({"w": torch.ones(3)}, tgrid, ref=ref)
    with pytest.raises(TypeError, match="QuantizedPackedTree"):
        qz.dequantize_packed(tp[0])


def test_compressor_residuals_equal_the_reference_over_three_rounds():
    ref, jp, tp, jgrid, tgrid = _setup(3)
    jcomp, tcomp = jqz.QuantCompressor(), qz.QuantCompressor()
    for r in range(3):
        want = jcomp.quantize(jp[r], jgrid, ref=ref)
        got = tcomp.quantize(tp[r], tgrid, ref=ref)
        assert tcomp.residual is (None if r == 0 else tcomp.residual)
        _assert_qtree_equal(got, want)
        # Rollback leaves the committed state: re-quantizing gives the same codes.
        tcomp.rollback()
        _assert_qtree_equal(tcomp.quantize(tp[r], tgrid, ref=ref), want)
        jcomp.commit()
        tcomp.commit()
        assert _raw(tcomp.residual) == _raw(np.asarray(jcomp.residual))
    # The committed residual is what the grid dropped.
    back = got.dequantize(torch.float32, ref=ref)
    assert float(tcomp.residual.abs().max()) <= float(tgrid.scales.max())
    assert back.buf.shape == tcomp.residual.shape
    with pytest.raises(ValueError, match="reset"):
        tcomp.quantize(tc.pack_tree({"w": torch.ones(5)}, torch.float32),
                       qz.make_round_grid(np.ones(5, np.float32), chunk_elems=CE), ref=np.ones(5, np.float32))
    tcomp.reset()
    assert tcomp.residual is None


def test_round_codec_and_compressor_registry():
    ref, jp, tp, jgrid, tgrid = _setup(1)
    qz.reset_compressors()
    assert qz.RoundCodec(None).to_wire(tp[0]) is tp[0]
    codec = qz.RoundCodec(tgrid, tc.pack_tree({"w": torch.from_numpy(ref)}, torch.float32), scope="t/up")
    assert isinstance(codec.ref, torch.Tensor) and codec.descriptor == jqz.grid_descriptor(jgrid)
    jcodec = jqz.RoundCodec(jgrid, ref, scope="t/up")
    got, want = codec.to_wire(tp[0]), jcodec.to_wire(jp[0])
    _assert_qtree_equal(got, want)
    assert codec.to_wire(got) is got  # pre-quantized on this grid: passes
    other = qz.make_round_grid(0.02 * np.ones(tgrid.total_elems, np.float32), chunk_elems=CE)
    with pytest.raises(ValueError, match="different grid"):
        codec.to_wire(qz.quantize_packed(tp[0], other, ref=ref))
    with pytest.raises(TypeError, match="PackedTree"):
        codec.to_wire({"w": torch.ones(2)})
    assert qz.compressor("t/up").residual is None
    codec.rollback()
    assert qz.compressor("t/up").residual is None
    codec.to_wire(tp[0])
    codec.commit()
    jcodec.commit()
    assert _raw(qz.compressor("t/up").residual) == _raw(np.asarray(jqz.compressor("t/up").residual))
    qz.reset_compressors()
    jqz.reset_compressors()
    assert qz.compressor("t/up").residual is None


def test_ef_convergence_matches_f32_on_a_toy_problem():
    """The quantized FedAvg recurrence with error feedback lands at the f32
    loop's optimum (the reference's own acceptance check)."""
    rng = np.random.default_rng(3)
    target = rng.normal(size=(2048,)).astype(np.float32)
    shift = [0.3 * rng.normal(size=(2048,)).astype(np.float32) for _ in range(2)]
    lr = 0.3

    def run(quantized):
        x = np.zeros(2048, np.float32)
        comps = [qz.QuantCompressor() for _ in range(2)]
        prev_delta = None
        for _ in range(30):
            ups = [x - lr * (x - (target + s)) for s in shift]
            if quantized and prev_delta is not None:
                grid = qz.make_round_grid(prev_delta, chunk_elems=512, mode="delta", expand=4.0)
                qts = []
                for c, u in zip(comps, ups):
                    qts.append(c.quantize(tc.pack_tree({"w": torch.from_numpy(u)}, torch.float32), grid, ref=x))
                    c.commit()
                agg = tf.packed_quantized_sum(qts, ref=x).buf.numpy()
            else:
                agg = np.mean(ups, axis=0).astype(np.float32)
            prev_delta = agg - x
            x = agg
        return float(np.mean((x - target) ** 2))

    exact, quant = run(False), run(True)
    assert quant <= exact * 1.01 + 1e-6, (exact, quant)


# -- the one-shot integer reduce and its finalize ------------------------------------


@pytest.mark.parametrize("weights", [None, [3, 1, 2]])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_packed_quantized_sum_and_accumulator_equal_the_reference(weights, out):
    ref, jp, tp, jgrid, tgrid = _setup(3, extra=np.arange(4, dtype=np.int32))
    jq = [jqz.quantize_packed(p, jgrid, ref=ref) for p in jp]
    tq = [qz.quantize_packed(p, tgrid, ref=ref) for p in tp]
    jout = np.float32 if out == "float32" else jnp.bfloat16
    want = jf.packed_quantized_sum(jq, weights, out_dtype=jout, ref=ref)
    got = tf.packed_quantized_sum(tq, weights, out_dtype=getattr(torch, out), ref=ref)
    assert _raw(got.buf) == _raw(want.buf) and got.spec.wire_dtype == want.spec.wire_dtype == out
    for a, b in zip(got.passthrough, want.passthrough):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)
    # The i32 accumulator itself, padded onto the block grid.
    iw, _ = tf.quant_weights(weights, 3)
    nb = tgrid.nblocks
    jacc = jf._quant_reduce_jit(nb, CE)(tuple(q.buf for q in jq), np.asarray(iw, np.int32))
    tacc = tf._quant_reduce([q.buf for q in tq], iw, nb, CE, CPU)
    assert tacc.dtype == torch.int32 and _raw(tacc) == _raw(jacc)
    # ... and the integer reference formula, in int64.
    codes = np.stack([np.asarray(q.buf, np.int64) for q in tq])
    acc = (codes * np.asarray(iw, np.int64)[:, None]).sum(0)
    assert np.array_equal(tacc.numpy()[: tgrid.total_elems], acc)


@pytest.mark.parametrize("with_ref", [True, False])
def test_finalize_equals_the_reference(with_ref):
    rng = np.random.default_rng(8)
    total, ce = 3 * 1000 + 7, 1000
    grid = qz.make_round_grid(rng.normal(0, 0.01, total).astype(np.float32), chunk_elems=ce)
    acc = rng.integers(0, 255 * 11, size=4 * ce).astype(np.int32)
    ref = rng.normal(size=total).astype(np.float32) if with_ref else None
    for out in ("float32", "bfloat16"):
        want = jf.finalize_packed_quantized(jnp.asarray(acc), grid.scales, grid.zps, 11.0, total, ce,
                                            jnp.dtype(out) if out == "float32" else jnp.bfloat16, ref=ref)
        got = tf.finalize_packed_quantized(torch.from_numpy(acc), grid.scales, grid.zps, 11.0, total, ce,
                                           out, ref=None if ref is None else torch.from_numpy(ref))
        assert _raw(got) == _raw(want), out
    with pytest.raises(ValueError, match="reference has"):
        tf.finalize_packed_quantized(torch.from_numpy(acc), grid.scales, grid.zps, 11.0, total, ce,
                                     "float32", ref=np.zeros(5, np.float32))


def test_accum_kernel_folds_in_place():
    acc = torch.zeros(10, dtype=torch.int32)
    tf.quantized_accum_kernel(acc, 4, torch.tensor([1, 2, 255], dtype=torch.uint8), 7)
    tf.quantized_accum_kernel(acc, 5, torch.tensor([-128], dtype=torch.int8), 2)
    assert acc.tolist() == [0, 0, 0, 0, 7, -242, 1785, 0, 0, 0]


def test_mixed_grids_and_float_paths_rejected():
    ref, jp, tp, jgrid, tgrid = _setup(2)
    tq = [qz.quantize_packed(p, tgrid, ref=ref) for p in tp]
    other = qz.make_round_grid(0.02 * np.ones(tgrid.total_elems, np.float32), chunk_elems=CE)
    alien = qz.quantize_packed(tp[1], other, ref=ref)
    with pytest.raises(ValueError, match="different grid"):
        tf.packed_quantized_sum([tq[0], alien], ref=ref)
    with pytest.raises(ValueError, match="not a QuantizedPackedTree"):
        tf.packed_quantized_sum([tq[0], tp[1]], ref=ref)
    with pytest.raises(ValueError, match="packed_quantized_sum"):
        tf.packed_weighted_sum(tq)
    with pytest.raises(ValueError, match="delta"):
        tf.tree_average(tq)


def test_tree_average_folds_abs_codes_as_the_reference():
    _, jp, tp, _, _ = _setup(2)
    jgrid = jqz.make_round_grid(np.asarray(jp[0].buf), chunk_elems=CE, mode="abs")
    tgrid = qz.make_round_grid(tp[0].buf, chunk_elems=CE, mode="abs")
    want = jf.tree_average([jqz.quantize_packed(p, jgrid) for p in jp], [2, 5])
    got = tf.tree_average([qz.quantize_packed(p, tgrid) for p in tp], [2, 5])
    assert _raw(got.buf) == _raw(want.buf)


@pytest.mark.parametrize("weights", [None, [3.0, 5.0]])
def test_integer_packed_buffers_fold_as_the_reference(weights):
    """A plain PackedTree of integer wire codes folds through the float
    chain (the codes cast to f32), as the JAX package's."""
    rng = np.random.default_rng(9)
    codes = [rng.integers(0, 256, 5000).astype(np.uint8) for _ in range(2)]
    jspec = jc.pack_tree({"w": jnp.ones(5000)}).spec
    tspec = tc.pack_tree({"w": torch.ones(5000)}).spec
    jt = [jc.PackedTree(jnp.asarray(c), (), jc.PackSpec(jspec.entries, jspec.treedef, "uint8")) for c in codes]
    tt = [tc.PackedTree(torch.from_numpy(c), (), tc.PackSpec(tspec.entries, tspec.treedef, "uint8")) for c in codes]
    for out in (None, "float32"):
        want = jf.packed_weighted_sum(jt, weights, out_dtype=out)
        got = tf.packed_weighted_sum(tt, weights, out_dtype=out)
        assert _raw(got.buf) == _raw(want.buf) and got.spec.wire_dtype == want.spec.wire_dtype
    agg = StreamingAggregator(2, weights=weights, device=CPU)
    agg.add_local(0, tt[0])
    agg.sink(1).on_complete(_payload(wire.encode_payload(tt[1])))
    assert _raw(agg.result(timeout=30).buf) == _raw(jf.packed_weighted_sum(jt, weights).buf)


# -- payloads -------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [None, np.arange(3, dtype=np.int32)], ids=["codes", "passthrough"])
def test_quantized_payload_bytes_equal_the_reference(extra):
    ref, jp, tp, jgrid, tgrid = _setup(1, extra=extra)
    want = jqz.quantize_packed(jp[0], jgrid, ref=ref)
    got = qz.quantize_packed(tp[0], tgrid, ref=ref)
    jbytes = _payload(jwire.encode_payload(want))
    tbytes = _payload(wire.encode_payload(got))
    assert tbytes == jbytes
    # Each package decodes the other's payload as its own class, allowlist on.
    back = wire.decode_payload(jbytes, allowed={"numpy": "*"})
    _assert_qtree_equal(back, want)
    assert back.grid() == tgrid
    jback = jwire.decode_payload(tbytes, allowed={"numpy": "*"})
    assert isinstance(jback, jqz.QuantizedPackedTree) and jback.gmeta == want.gmeta
    assert _raw(jback.dequantize(np.float32, ref=ref).buf) == _raw(got.dequantize(torch.float32, ref=ref).buf)


def test_grid_descriptor_and_meta_key_hold_the_wire_format_lock(monkeypatch):
    """The quantized entries of ``tool/wire_format.lock``: the metadata key,
    the descriptor's schema and the grid version.  The lock's fingerprint,
    recomputed with the port's grid and descriptor in place of the JAX
    package's, is still the pinned one."""
    import pathlib

    from tool import check_wire_format

    assert wire.QUANT_GRID_KEY == jwire.QUANT_GRID_KEY == "qg"
    assert qz.QUANT_GRID_VERSION == jqz.QUANT_GRID_VERSION
    assert qz.QUANT_DELTA_EXPAND == jqz.QUANT_DELTA_EXPAND
    grid = qz.make_round_grid(np.linspace(-1.0, 1.0, 4096, dtype=np.float32), chunk_elems=1024)
    monkeypatch.setattr(jqz, "make_round_grid", lambda *a, **kw: grid)
    monkeypatch.setattr(jqz, "grid_descriptor", qz.grid_descriptor)
    lock = json.loads((pathlib.Path(check_wire_format.__file__).parent / "wire_format.lock").read_text())
    assert check_wire_format.compute_fingerprint() == lock["fingerprint"]


def test_quantize_downlink_equals_the_reference():
    ref, jp, tp, jgrid, tgrid = _setup(2)
    want_sum = jf.packed_quantized_sum([jqz.quantize_packed(p, jgrid, ref=ref) for p in jp], ref=ref)
    got_sum = tf.packed_quantized_sum([qz.quantize_packed(p, tgrid, ref=ref) for p in tp], ref=ref)
    jqz.reset_compressors()
    qz.reset_compressors()
    for scope in (None, "down-test"):
        for r in range(2):
            jw, jdec, jd = jqz.quantize_downlink(want_sum, jgrid, ref, scope)
            tw, tdec, td = qz.quantize_downlink(got_sum, tgrid, torch.from_numpy(ref), scope)
            _assert_qtree_equal(tw, jw)
            assert _raw(tdec.buf) == _raw(jdec.buf) and td == jd
    abs_sum = tf.packed_weighted_sum(tp[:1], out_dtype="float32")
    jw, jdec, jd = jqz.quantize_downlink(jf.packed_weighted_sum(jp[:1], out_dtype=np.float32), jgrid, None, None)
    tw, tdec, td = qz.quantize_downlink(abs_sum, tgrid, None, None)
    _assert_qtree_equal(tw, jw)
    assert _raw(tdec.buf) == _raw(jdec.buf) and td == jd and td["md"] == "abs"
    qz.reset_compressors()
    jqz.reset_compressors()


# -- the streamed integer fold ------------------------------------------------------


@pytest.mark.parametrize("weights", [None, [3, 1, 2]])
def test_streaming_integer_fold_bitexact_adversarial_order(weights):
    ref, jp, tp, jgrid, tgrid = _setup(3)
    jq = [jqz.quantize_packed(p, jgrid, ref=ref) for p in jp]
    tq = [qz.quantize_packed(p, tgrid, ref=ref) for p in tp]
    want = jf.packed_quantized_sum(jq, weights, ref=ref)
    assert _raw(tf.packed_quantized_sum(tq, weights, ref=ref).buf) == _raw(want.buf)
    for trial in range(3):
        agg = StreamingAggregator(3, weights=weights, chunk_elems=CE, quant=tgrid, quant_ref=ref, device=CPU)
        payloads = [_payload(wire.encode_payload(q)) for q in tq]
        if trial == 0:
            # Source 2 lands whole first, 0 trickles in odd increments, 1 whole.
            sinks = [agg.sink(i) for i in range(3)]
            sinks[2].on_complete(payloads[2])
            mv0 = memoryview(payloads[0])
            for off in range(1 << 12, len(payloads[0]), 9999):
                sinks[0].on_bytes(mv0, off)
            sinks[0].on_complete(payloads[0])
            sinks[1].on_complete(payloads[1])
        else:
            rng = random.Random(trial)
            local = rng.randrange(3)
            agg.add_local(local, tq[local])
            order = [i for i in range(3) if i != local]
            rng.shuffle(order)
            for i in order:
                mv = memoryview(payloads[i])
                for off in range(rng.randrange(1, 5000), len(payloads[i]), 7777):
                    agg.sink(i).on_bytes(mv, off)
                agg.sink(i).on_complete(payloads[i])
        got = agg.result(timeout=60)
        assert got.buf.dtype == torch.float32 and _raw(got.buf) == _raw(want.buf), trial


def test_streaming_rejects_wrong_grids_and_forms():
    ref, _, tp, _, tgrid = _setup(2)
    other = qz.make_round_grid(0.02 * np.ones(tgrid.total_elems, np.float32), chunk_elems=CE)
    agg = StreamingAggregator(2, chunk_elems=CE, quant=tgrid, quant_ref=ref, device=CPU)
    agg.add_local(0, qz.quantize_packed(tp[0], tgrid, ref=ref))
    agg.sink(1).on_complete(_payload(wire.encode_payload(qz.quantize_packed(tp[1], other, ref=ref))))
    with pytest.raises(ValueError, match="different grid"):
        agg.result(timeout=60)
    agg = StreamingAggregator(1, chunk_elems=CE, quant=tgrid, quant_ref=ref, device=CPU)
    agg.add_local(0, tp[0])  # a plain PackedTree under a grid
    with pytest.raises(TypeError, match="QuantizedPackedTree"):
        agg.result(timeout=10)
    agg = StreamingAggregator(1, chunk_elems=CE, quant=tgrid, quant_ref=ref, device=CPU)
    agg.add_local(0, qz.quantize_packed(tp[0], other, ref=ref))
    with pytest.raises(ValueError, match="different grid"):
        agg.result(timeout=10)
    agg = StreamingAggregator(1, device=CPU)  # codes without a grid
    agg.add_local(0, qz.quantize_packed(tp[0], tgrid, ref=ref))
    with pytest.raises(TypeError, match="no quant= grid"):
        agg.result(timeout=10)
    agg = StreamingAggregator(1, chunk_elems=CE, quant=tgrid, quant_ref=ref, device=CPU)
    agg.sink(0).on_complete(_payload(wire.encode_payload(tp[0])))  # f32 values, not codes
    with pytest.raises(ValueError, match="codes"):
        agg.result(timeout=10)


# -- in-process managers: quantized payloads on delta streams ------------------------


def _manager(pkg, party, ports):
    if pkg == "jax":
        cc = JClusterConfig(parties={p: JPartyConfig.from_dict({"address": f"127.0.0.1:{port}"})
                                     for p, port in ports.items()}, current_party=party)
        return JTransportManager(cc, JJobConfig(device_put_received=False, zero_copy_host_arrays=True,
                                                cross_silo_timeout_s=20))
    cc = ClusterConfig(parties={p: PartyConfig.from_dict({"address": f"127.0.0.1:{port}"})
                                for p, port in ports.items()}, current_party=party)
    return TransportManager(cc, JobConfig(device_put_received=False, zero_copy_host_arrays=True,
                                          cross_silo_timeout_s=20), device=CPU)


@pytest.fixture(params=["torch", "jax"])
def sender_pair(request):
    """(alice, bob): bob is a port manager; alice a port or a JAX one."""
    pa, pb = get_free_ports(2)
    ports = {"alice": pa, "bob": pb}
    a, b = _manager(request.param, "alice", ports), _manager("torch", "bob", ports)
    a.start()
    b.start()
    yield request.param, a, b
    a.stop()
    b.stop()


def test_quantized_round_over_delta_streams(sender_pair):
    """Two rounds of one party's codes on a delta stream into a port
    aggregator with the coordinator's own codes added locally: each round
    folds to the port's ``packed_quantized_sum`` and the JAX package's, the
    frame carries the grid descriptor, and round 2 ships as a delta."""
    pkg, alice, bob = sender_pair
    size = wire.DELTA_CHUNK_BYTES * 3  # 3 full 4 MB chunks of uint8 codes
    rng = np.random.default_rng(5)
    ref = rng.normal(size=(size,)).astype(np.float32)
    prev = 0.01 * rng.normal(size=(size,)).astype(np.float32)
    tgrid = qz.make_round_grid(prev, mode="delta", expand=4.0)
    jgrid = jqz.make_round_grid(prev, mode="delta", expand=4.0)
    mine = qz.quantize_packed(tc.pack_tree({"w": torch.from_numpy(ref * 1.0001)}, torch.float32), tgrid, ref=ref)
    for r in range(2):
        arr = ref.copy()
        lo = wire.DELTA_CHUNK_BYTES  # only the second code chunk changes round over round
        arr[lo: lo + 1000] += 1e-3 * (r + 1)
        if pkg == "jax":
            theirs = jqz.quantize_packed(jc.pack_tree({"w": jnp.asarray(arr)}, jnp.float32), jgrid, ref=ref)
            gd = jqz.grid_descriptor(jgrid)
        else:
            theirs = qz.quantize_packed(tc.pack_tree({"w": torch.from_numpy(arr)}, torch.float32), tgrid, ref=ref)
            gd = qz.grid_descriptor(tgrid)
        sent = alice.send("bob", theirs, f"q{r}", "0", stream="qdelta", quant_meta=gd)
        agg = StreamingAggregator(2, weights=[2, 3], chunk_elems=tgrid.chunk_elems, quant=tgrid,
                                  quant_ref=torch.from_numpy(ref), device=CPU)
        agg.add_local(0, mine)
        bob.recv_stream("alice", f"q{r}", "0", agg.sink(1))
        got = agg.result(timeout=60)
        assert sent.resolve(timeout=60)
        as_port = qz.QuantizedPackedTree(np.asarray(theirs.buf), np.asarray(theirs.scales),
                                         np.asarray(theirs.zps), (), mine.spec, qz.QuantMeta(*theirs.gmeta))
        want = tf.packed_quantized_sum([mine, as_port], [2, 3], ref=ref)
        jmine = jqz.QuantizedPackedTree(mine.buf, mine.scales, mine.zps, (),
                                        jc.pack_tree({"w": jnp.asarray(ref)}, jnp.float32).spec,
                                        jqz.QuantMeta(*mine.gmeta))
        jtheirs = jqz.QuantizedPackedTree(np.asarray(theirs.buf), np.asarray(theirs.scales), np.asarray(theirs.zps),
                                          (), jmine.spec, jqz.QuantMeta(*theirs.gmeta))
        jwant = jf.packed_quantized_sum([jmine, jtheirs], [2, 3], ref=ref)
        assert _raw(got.buf) == _raw(want.buf) == _raw(jwant.buf), r
    stats = alice.get_stats()
    assert stats["delta_stream_frames"] >= 1
    assert stats["delta_wire_bytes"] < stats["delta_logical_bytes"]


def test_grid_descriptor_rides_the_frame_metadata(sender_pair):
    pkg, alice, bob = sender_pair
    ref = np.linspace(-0.01, 0.01, 100_000, dtype=np.float32)
    grid = qz.make_round_grid(ref, mode="delta", expand=4.0)
    if pkg == "jax":
        jgrid = jqz.make_round_grid(ref, mode="delta", expand=4.0)
        qt = jqz.quantize_packed(jc.pack_tree({"w": jnp.asarray(ref * 1.001)}, jnp.float32), jgrid, ref=ref)
        gd = jqz.grid_descriptor(jgrid)
    else:
        qt = qz.quantize_packed(tc.pack_tree({"w": torch.from_numpy(ref * 1.001)}, torch.float32), grid, ref=ref)
        gd = qz.grid_descriptor(grid)
    assert gd == qz.grid_descriptor(grid)
    assert alice.send("bob", qt, "m1", "0", quant_meta=gd).resolve(timeout=60)
    entry = bob._mailbox._entries[("m1", "0")]
    meta = entry.message.metadata
    assert json.loads(meta[wire.QUANT_GRID_KEY]) == gd
    qz.check_descriptor(meta[wire.QUANT_GRID_KEY], grid)
    got = bob.recv("alice", "m1", "0").resolve(timeout=60)
    assert isinstance(got, qz.QuantizedPackedTree) and got.gmeta == grid.meta()


# -- validate_round_config: wire_quant pairs ---------------------------------------


TRAINERS = {"a": None, "b": None}
BASE = dict(compress_wire=True, packed_wire=True, streaming_agg=True)
QUANT_OPTIONS = [
    ("wire_quant", "uint8"), ("wire_quant", "int8"), ("wire_quant", "int16"), ("wire_quant", "float32"),
]
OTHER_OPTIONS = [
    ("rounds", 0), ("server_opt", "server_sgd()"), ("server_opt", "not-an-optimizer"),
    ("server_opt", "fedac()"),
    ("weights", [1.0, 2.0]), ("compress_wire", False), ("packed_wire", False),
    ("checkpoint_every", 2), ("sample", 1), ("sample", 5), ("aggregator", len),
    ("streaming_agg", False), ("error_feedback", True), ("mode", "bogus"), ("coordinator", "a"),
    ("ring_chunk_elems", 8), ("round_deadline_s", 1.0), ("join_ticket", {}), ("round_log", []),
]
VERDICT_CASES = [
    (q, o, base) for q, o in itertools.product(QUANT_OPTIONS, [None] + OTHER_OPTIONS)
    for base in (False, True)
]


def _verdict(fn, kwargs):
    try:
        return ("ok", fn(TRAINERS, **kwargs))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize(
    "quant,other,base", VERDICT_CASES,
    ids=lambda v: v if isinstance(v, bool) else ("-" if v is None else f"{v[0]}={getattr(v[1], '__name__', v[1])}"),
)
def test_wire_quant_verdicts_equal_the_reference(quant, other, base):
    from rayfed_tpu.fl import fedopt as jfedopt
    from rayfed_tpu.fl import trainer as jtrainer
    from rayfed_tpu_torch.fl import fedopt as tfedopt

    ref_kw = dict(BASE) if base else {}
    port_kw = dict(ref_kw)
    for name, value in [quant] + ([other] if other else []):
        if value == "server_sgd()":
            ref_kw[name], port_kw[name] = jfedopt.server_sgd(), tfedopt.server_sgd()
        elif value == "fedac()":
            # Each package's own packed optimizer spec.
            from rayfed_tpu.fl import server_opt as jso
            from rayfed_tpu_torch.fl import server_opt as tso

            ref_kw[name], port_kw[name] = jso.fedac(1.0, 3.0, 0.5), tso.fedac(1.0, 3.0, 0.5)
        else:
            ref_kw[name] = port_kw[name] = value
    assert _verdict(ttrainer.validate_round_config, port_kw) == _verdict(jtrainer.validate_round_config, ref_kw)


def test_wire_quant_takes_a_torch_dtype():
    for dt, name in ((torch.uint8, "uint8"), (torch.int8, "int8"), ("uint8", "uint8")):
        assert ttrainer.validate_round_config(TRAINERS, wire_quant=dt, **BASE)["wire_quant"] == name
    with pytest.raises(ValueError, match="8-bit"):
        ttrainer.validate_round_config(TRAINERS, wire_quant=torch.int16, **BASE)


# -- run_fedavg_rounds(wire_quant=) in one party ------------------------------------


def test_one_party_quantized_rounds_follow_the_codec():
    """Three rounds of ``run_fedavg_rounds(wire_quant="uint8")`` in one
    party: the bootstrap round runs unquantized, then each round's result
    is the codec's, step by step (the contribution coded on the grid of the
    last round's delta with the uplink residual, folded, re-coded on the
    downlink's fresh grid with its own residual), byte for byte."""
    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch.models import logistic
    from tests.multiproc import make_cluster

    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((128, 16)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, 128).astype(np.int64))
    step = logistic.make_train_step(logistic.apply_logistic, lr=0.3)

    def local(params):
        for _ in range(2):
            params, _ = step(params, x, y)
        return tc.compress(params, packed=True)

    @fed.remote
    class Trainer:
        def train(self, params):
            return local(tc.decompress(params, torch.float32))

    qz.reset_compressors()
    fed.init(address="local", cluster=make_cluster(["solo"]), party="solo", device=CPU)
    try:
        params = logistic.init_logistic(16, 3, device=CPU)
        timings = []
        final = fed.fl.run_fedavg_rounds({"solo": Trainer.party("solo").remote()}, params, rounds=3,
                                         compress_wire=True, packed_wire=True, streaming_agg=True,
                                         wire_quant="uint8", timings=timings)
    finally:
        fed.shutdown()
        qz.reset_compressors()
    assert len(timings) == 3

    up, down = qz.QuantCompressor(), qz.QuantCompressor()
    current, prev_delta = params, None
    for r in range(3):
        ref = tc.pack_tree(current, torch.float32).buf
        contrib = local(tc.decompress(tc.compress(current, packed=True), torch.float32))
        if prev_delta is None:
            avg = contrib  # one party: the mean of one contribution
        else:
            grid = qz.make_round_grid(prev_delta, wire_dtype="uint8", mode="delta",
                                      expand=qz.QUANT_DELTA_EXPAND)
            codes = up.quantize(contrib, grid, ref=ref)
            up.commit()
            folded = tf.packed_quantized_sum([codes], ref=ref)
            down_grid = qz.make_round_grid(folded.buf.numpy() - ref.numpy(), chunk_elems=grid.chunk_elems,
                                           wire_dtype="uint8", mode="delta")
            avg = down.quantize(folded, down_grid, ref=ref).dequantize(torch.float32, ref=ref)
            down.commit()
        prev_delta = avg.buf.to(torch.float32).numpy() - ref.numpy()
        current = tc.decompress(avg)
    for name in final:
        assert final[name].dtype == torch.float32 and _raw(final[name]) == _raw(current[name]), name


# -- where the reference's XLA program fuses a multiply-add ---------------------------


def _fma_probe(size=40_000):
    """Elements, out of ``size``, where a two-op f32 chain differs from the
    reference's bytes and where the port does: the quantize residual
    ``corrected − scale·(q − zp)``, the dequantize's ``ref + scale·(q −
    zp)``, the finalize, and the float packed fold ``acc + w·x`` with f32
    wire buffers (weights 3/5/7/11) and with bf16 ones at fractional
    weights (1.7/2.3/0.9/4.1), there with the first differing element and
    its (reference, port) values.  Run ``JAX_PLATFORMS=cpu python -m
    tests.test_torch_quantized_agg`` to print them."""
    ref, jp, tp, jgrid, tgrid = _setup(1, size=size)
    out = {}
    upd = np.asarray(jp[0].buf)
    s, z = jgrid.scales[:, None], jgrid.zps[:, None]
    nb, ce, n = jgrid.nblocks, jgrid.chunk_elems, jgrid.total_elems

    def blocks(x):
        return np.concatenate([x, np.zeros(nb * ce - n, np.float32)]).reshape(nb, ce)

    _, jres = jqz._quantize_kernel(ce, n, "uint8", True)(
        jnp.asarray(upd), jnp.asarray(ref), jgrid.scales, jgrid.zps, np.zeros(n, np.float32))
    corrected = upd - ref
    q = np.clip(np.round(blocks(corrected) / s + z), 0, 255)
    two_op = corrected - (s * (q - z)).reshape(-1)[:n]
    _, tres = qz._quantize_codes(tp[0].buf, ref, None, tgrid)
    out["quantize residual"] = (int(np.sum(two_op != np.asarray(jres))),
                                int(np.sum(tres.numpy() != np.asarray(jres))))
    codes = jqz.quantize_packed(jp[0], jgrid, ref=ref)
    jdeq = np.asarray(codes.dequantize(np.float32, ref=ref).buf)
    two_op = ref + (s * (blocks(np.asarray(codes.buf, np.float32)) - z)).reshape(-1)[:n]
    tdeq = qz._dequantize_codes(codes.buf, ref, tgrid, "float32").numpy()
    out["dequantize ref add"] = (int(np.sum(two_op != jdeq)), int(np.sum(tdeq != jdeq)))
    acc = np.random.default_rng(8).integers(0, 255 * 6, nb * ce).astype(np.int32)
    jfin = np.asarray(jf.finalize_packed_quantized(jnp.asarray(acc), jgrid.scales, jgrid.zps, 6.0, n, ce,
                                                   np.float32, ref=ref))
    a = acc.reshape(nb, ce).astype(np.float32)
    two_op = ref + (s * (a - z * np.float32(6.0))).reshape(-1)[:n] / np.float32(6.0)
    tfin = tf.finalize_packed_quantized(torch.from_numpy(acc), jgrid.scales, jgrid.zps, 6.0, n, ce,
                                        "float32", ref=ref).numpy()
    out["finalize"] = (int(np.sum(two_op != jfin)), int(np.sum(tfin != jfin)))
    rng = np.random.default_rng(0)
    bufs = [rng.standard_normal(size).astype(np.float32) for _ in range(4)]
    for name, wire_dt, weights in (("float fold, f32 wire", "f32", [3, 5, 7, 11]),
                                   ("float fold, bf16 wire, fractional weights", "bf16", [1.7, 2.3, 0.9, 4.1])):
        jt = [jc.pack_tree({"w": jnp.asarray(b)}, jnp.float32 if wire_dt == "f32" else jnp.bfloat16) for b in bufs]
        tt = [tc.pack_tree({"w": torch.from_numpy(b)}, torch.float32 if wire_dt == "f32" else torch.bfloat16)
              for b in bufs]
        w32 = np.asarray(weights, np.float32)
        total = np.float32(sum(weights))
        xs = [np.asarray(t.buf, np.float32) for t in jt]
        two_op = np.zeros(size, np.float32)
        for w, x in zip(w32, xs):
            two_op = two_op + w * x
        two_op = two_op / total
        # One-shot: packed_weighted_sum in both packages.
        want = np.asarray(jf.packed_weighted_sum(jt, weights, out_dtype=np.float32).buf)
        got = tf.packed_weighted_sum(tt, weights, out_dtype="float32").buf.numpy()
        out[name + ", one-shot"] = _fold_mismatch(two_op, want, got)
        # Streamed: the per-block fold steps from a zeroed accumulator, then
        # the stripe finalize, in both packages.
        step = jss._accum_kernel(CE, "float32", jt[0].spec.wire_dtype)
        jacc, tacc = jnp.zeros(nb * CE, jnp.float32), torch.zeros(nb * CE)
        for w, jp_i, tp_i in zip(w32, jt, tt):
            jbuf = jnp.concatenate([jp_i.buf, jnp.zeros(nb * CE - size, jp_i.buf.dtype)])
            for b in range(nb):
                jacc = step(jacc, jbuf[b * CE:(b + 1) * CE], b * CE, jnp.float32(w))
                tss._fold_block(tacc, b * CE, tp_i.buf[b * CE:(b + 1) * CE], tf.f32_scalar(w, CPU))
        want = np.asarray(jf.finalize_packed_stripe(jacc, float(total), size, np.float32))
        got = tf.finalize_packed_stripe(tacc, float(total), size, "float32").numpy()
        out[name + ", streamed"] = _fold_mismatch(two_op, want, got)
    return out


def _fold_mismatch(two_op, want, got):
    """(two-op chain's mismatches, port's, the port's first differing element
    and its (reference, port) values) against the reference's bytes."""
    diff = np.flatnonzero(got != want)
    at = int(diff[0]) if diff.size else None
    return (int(np.sum(two_op != want)), int(diff.size), at,
            None if at is None else (float(want[at]), float(got[at])))


def test_the_port_rounds_once_where_the_reference_fuses():
    """The quantize residual, the dequantize's reference add and the float
    fold's multiply-adds (one-shot and streamed, f32 wire and fractional
    weights) are fused multiply-adds in the reference's compiled programs (a
    two-op chain differs from their bytes) and the port's exact FMAs give
    their bytes; the finalize is not fused, and the port's two ops give its
    bytes."""
    probe = _fma_probe(size=20_000)
    for name in ("quantize residual", "dequantize ref add"):
        two_op, port = probe[name]
        assert two_op > 0 and port == 0, (name, probe[name])
    assert probe["finalize"] == (0, 0)
    folds = [name for name in probe if name.startswith("float fold")]
    assert len(folds) == 4
    for name in folds:
        two_op, port, _, _ = probe[name]
        assert two_op > 0 and port == 0, (name, probe[name])


if __name__ == "__main__":
    for name, counts in _fma_probe().items():
        print(f"{name}: {counts}")
