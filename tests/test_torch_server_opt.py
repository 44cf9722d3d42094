"""The port's packed server optimizers (``fl/server_opt.py`` and the step and
resync programs of ``fl/fedavg.py``) against the JAX package's, after
``tests/test_server_opt.py``.

Inputs are made from numpy seeds and go through both packages.  XLA:CPU
contracts the reference's step and resync into fused multiply-adds; the
port computes each as one exactly rounded FMA (``ops/fold.py``), so the
step, the resync, every downstream fold and downlink, and the replicated
state are held to byte identity, not a tolerance.  The reference's
checkpoint round trip needs ``checkpoint.py`` (ROADMAP.md Queue A item 9):
here the state goes through ``models.convert.server_state_from_jax`` and the
wire pickle instead.  Everything runs in one process.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rayfed_tpu.fl import compression as jc
from rayfed_tpu.fl import fedavg as jf
from rayfed_tpu.fl import quantize as jqz
from rayfed_tpu.fl import server_opt as jso
from rayfed_tpu.fl.streaming import StreamingAggregator as JStreamingAggregator
from rayfed_tpu_torch.fl import compression as tc
from rayfed_tpu_torch.fl import fedavg as tf
from rayfed_tpu_torch.fl import quantize as qz
from rayfed_tpu_torch.fl import server_opt as so
from rayfed_tpu_torch.fl.streaming import StreamingAggregator
from rayfed_tpu_torch.transport import wire

CPU = torch.device("cpu")
CE = 1 << 12
LENGTHS = [7, 8, 9, 64, 1000, 4099]
CONFIGS = [
    ("momentum", (0.7, 0.9)),
    ("momentum", (0.7, 0.6)),
    ("fedac", (0.8, 6.0, 0.7)),
    ("fedac", (1.0, 3.0, 0.5)),
    ("fedac", (0.9, 2.5, 0.4)),
]


def _raw(x):
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _payload(bufs):
    return b"".join(
        bytes(b) if isinstance(b, (bytes, bytearray)) else bytes(memoryview(b).cast("B"))
        for b in bufs
    )


def _specs(kind, hyper):
    return so.PackedServerOpt(kind, hyper), jso.PackedServerOpt(kind, hyper)


def _setup(n=3, size=40_000, seed=1):
    """The reference test's toy round in both packages: a shared reference,
    ``n`` f32 contributions near it and a delta grid."""
    rng = np.random.default_rng(seed)
    ref = rng.normal(size=(size,)).astype(np.float32)
    ws = [ref + 0.01 * rng.normal(size=(size,)).astype(np.float32) for _ in range(n)]
    prev_delta = 0.01 * rng.normal(size=(size,)).astype(np.float32)
    tgrid = qz.make_round_grid(prev_delta, chunk_elems=CE, mode="delta", expand=4.0)
    jgrid = jqz.make_round_grid(prev_delta, chunk_elems=CE, mode="delta", expand=4.0)
    tp = [tc.pack_tree({"w": torch.from_numpy(w)}, torch.float32) for w in ws]
    jp = [jc.pack_tree({"w": jnp.asarray(w)}, jnp.float32) for w in ws]
    return ref, tp, jp, tgrid, jgrid


# -- spec and the two programs ------------------------------------------------------


def test_spec_validation():
    with pytest.raises(ValueError, match="kind"):
        so.PackedServerOpt("adamw", (0.1,))
    with pytest.raises(ValueError, match="lr"):
        so.server_momentum(lr=0.0)
    with pytest.raises(ValueError, match="momentum"):
        so.server_momentum(momentum=1.0)
    with pytest.raises(ValueError, match="gamma"):
        so.fedac(lam=1.0, gamma=0.5)
    with pytest.raises(ValueError, match="beta"):
        so.fedac(beta=1.0)
    opt = so.fedac(1.0, 3.0, 0.5)
    assert opt.describe() == {"kind": "fedac", "hyper": [1.0, 3.0, 0.5]}
    assert opt.describe() == jso.fedac(1.0, 3.0, 0.5).describe()
    assert opt == so.fedac(1.0, 3.0, 0.5) and hash(opt) == hash(so.fedac(1.0, 3.0, 0.5))
    assert opt != so.fedac(1.0, 3.0, 0.25)
    assert so.server_momentum().describe() == jso.server_momentum().describe()
    assert so._STATE_WIDTH == jso._STATE_WIDTH and opt.n_state == 1


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind,hyper", CONFIGS, ids=lambda v: str(v))
def test_step_and_resync_bytes_equal_the_reference(kind, hyper, n):
    """The step from a random state, and the resync from its output, equal
    the JAX package's programs byte for byte at every length (the
    vectoriser decides which elements XLA fuses, so several lengths)."""
    rng = np.random.default_rng(1000 * n + len(hyper))
    x = rng.normal(size=(n,)).astype(np.float32)
    avg = (x - 0.1 * rng.normal(size=(n,))).astype(np.float32)
    st = rng.normal(size=(n,)).astype(np.float32)
    want = np.asarray(jf.server_step_kernel(kind, hyper)(jnp.asarray(x), jnp.asarray(avg), jnp.asarray(st)))
    got = tf.server_step_kernel(kind, hyper)(torch.from_numpy(x), torch.from_numpy(avg), torch.from_numpy(st))
    assert _raw(got) == _raw(want)
    want_r = jf.server_resync_kernel(kind, hyper)(jnp.asarray(x), jnp.asarray(want), jnp.asarray(st))
    got_r = tf.server_resync_kernel(kind, hyper)(torch.from_numpy(x), torch.from_numpy(want), torch.from_numpy(st))
    assert len(got_r) == len(want_r) == 1
    assert _raw(got_r[0]) == _raw(want_r[0])
    # The inputs are read, never written.
    assert _raw(torch.from_numpy(st)) == _raw(st) and _raw(torch.from_numpy(avg)) == _raw(avg)


@pytest.mark.parametrize("kind,hyper", CONFIGS[:3], ids=lambda v: str(v))
def test_step_kernel_matches_the_numpy_reference(kind, hyper):
    """``reference_step`` (both packages' own) within the reference test's
    tolerances, and the resync from the realized step reproduces the true
    state update."""
    opt, jopt = _specs(kind, hyper)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5000,)).astype(np.float32)
    avg = x - 0.01 * rng.normal(size=x.shape).astype(np.float32)
    state = opt.init(torch.from_numpy(x))
    got = tf.server_step_kernel(kind, hyper)(torch.from_numpy(x), torch.from_numpy(avg), *state.bufs).numpy()
    want, want_state = so.reference_step(opt, x, avg, [b.numpy() for b in state.bufs])
    jwant, jwant_state = jso.reference_step(jopt, x, avg, [b.numpy() for b in state.bufs])
    assert _raw(want) == _raw(jwant) and _raw(want_state[0]) == _raw(jwant_state[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    new_state = tf.server_resync_kernel(kind, hyper)(torch.from_numpy(x), torch.from_numpy(got), *state.bufs)
    np.testing.assert_allclose(new_state[0].numpy(), want_state[0], rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind,hyper", [("momentum", (1.0, 0.0)), ("fedac", (1.0, 1.0, 0.0))],
                         ids=["momentum-degenerate", "fedac-degenerate"])
def test_degenerate_configs_are_plain_fedavg_bitexact(kind, hyper):
    opt, _ = _specs(kind, hyper)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4096,)).astype(np.float32)
    avg = torch.from_numpy(x - 0.01 * rng.normal(size=x.shape).astype(np.float32))
    got = tf.server_step_kernel(kind, hyper)(torch.from_numpy(x), avg, *opt.init(torch.from_numpy(x)).bufs)
    # The aggregate itself (its storage), not a rounded rebuild of it.
    assert got.data_ptr() == avg.data_ptr() and _raw(got) == _raw(avg)


def test_unknown_kind_raises():
    for fn in (tf.server_step_kernel, tf.server_resync_kernel):
        with pytest.raises(ValueError, match="unknown server-opt kind"):
            fn("adamw", (0.1,))


def test_init_state_equals_the_reference():
    x = np.random.default_rng(4).normal(size=(999,)).astype(np.float32)
    for kind, hyper in CONFIGS:
        opt, jopt = _specs(kind, hyper)
        got, want = opt.init(torch.from_numpy(x)), jopt.init(x)
        assert (got.kind, got.hyper) == (want.kind, want.hyper)
        assert [_raw(b) for b in got.bufs] == [_raw(b) for b in want.bufs]
        assert got.bufs[0].device == CPU


def test_step_fn_guards():
    ref, tp, _, grid, _ = _setup(1)
    runner = so.PackedServerOptimizer(so.fedac(1.0, 3.0, 0.5))
    with pytest.raises(RuntimeError, match="ensure"):
        runner.step_fn(ref)
    with pytest.raises(RuntimeError, match="resync before"):
        runner.resync(ref, ref)
    runner.ensure(torch.from_numpy(ref))
    step = runner.step_fn(torch.from_numpy(ref))
    with pytest.raises(TypeError, match="FINALIZED float"):
        step(qz.quantize_packed(tp[0], grid, ref=ref))
    with pytest.raises(TypeError, match="PackedTree"):
        step({"w": np.ones(3)})
    short = tc.pack_tree({"w": torch.ones(7)}, torch.float32)
    with pytest.raises(ValueError, match="elements"):
        step(short)
    with pytest.raises(ValueError, match="broadcast has 7 elements"):
        runner.resync(torch.from_numpy(ref), torch.ones(7))
    out = step(tp[0])
    assert isinstance(out, tc.PackedTree) and out.spec.wire_dtype == "float32"
    with pytest.raises(TypeError, match="wraps a PackedServerOpt"):
        so.PackedServerOptimizer(object())


# -- replicas ---------------------------------------------------------------------


def test_controller_replicas_byte_agree_across_rounds():
    """Three port replicas and one of the JAX package, stepping the same
    broadcasts, stay byte-identical in model and state: the local step of
    ring rounds and a quorum failover rest on it."""
    rng = np.random.default_rng(3)
    opt, jopt = so.fedac(1.0, 3.0, 0.5), jso.fedac(1.0, 3.0, 0.5)
    size = 20_000
    x = rng.normal(size=(size,)).astype(np.float32)
    tmpl = tc.pack_tree({"w": torch.from_numpy(x)}, torch.float32)
    jtmpl = jc.pack_tree({"w": jnp.asarray(x)}, jnp.float32)
    ports = [so.PackedServerOptimizer(opt, device=CPU) for _ in range(3)]
    ref_ctl = jso.PackedServerOptimizer(jopt)
    cur = x.copy()
    for _ in range(4):
        avg = cur - 0.01 * rng.normal(size=(size,)).astype(np.float32)
        outs = []
        for c in ports:
            c.ensure(torch.from_numpy(cur))
            res = tc.PackedTree(torch.from_numpy(avg), tmpl.passthrough, tmpl.spec)
            outs.append(c.step_fn(torch.from_numpy(cur))(res).buf)
        ref_ctl.ensure(cur)
        jout = np.asarray(ref_ctl.step_fn(cur)(jc.PackedTree(jnp.asarray(avg), jtmpl.passthrough, jtmpl.spec)).buf)
        assert all(_raw(o) == _raw(jout) for o in outs)
        for c in ports:
            c.resync(torch.from_numpy(cur), outs[0])
        ref_ctl.resync(cur, jout)
        assert all(_raw(c.state.bufs[0]) == _raw(ref_ctl.state.bufs[0]) for c in ports)
        cur = jout


def test_mixed_package_controllers_agree_for_three_rounds():
    """A JAX controller and a torch controller step the same broadcast for
    three rounds, momentum then FedAC: their ``PackedServerState`` buffers
    stay byte-equal, and the torch state read back by the JAX package (and
    the reverse) is the same state."""
    from rayfed_tpu_torch.models.convert import server_state_from_jax, server_state_to_jax

    for kind, hyper in (("momentum", (0.7, 0.9)), ("fedac", (0.8, 6.0, 0.7))):
        opt, jopt = _specs(kind, hyper)
        rng = np.random.default_rng(17)
        x = rng.normal(size=(3001,)).astype(np.float32)
        t_ctl, j_ctl = so.PackedServerOptimizer(opt, device=CPU), jso.PackedServerOptimizer(jopt)
        tmpl = tc.pack_tree({"w": torch.from_numpy(x)}, torch.float32)
        for r in range(3):
            avg = (x - 0.02 * rng.normal(size=x.shape)).astype(np.float32)
            t_ctl.ensure(torch.from_numpy(x))
            j_ctl.ensure(x)
            new = t_ctl.step_fn(torch.from_numpy(x))(tc.PackedTree(torch.from_numpy(avg), tmpl.passthrough, tmpl.spec))
            jnew = jf.server_step_kernel(kind, hyper)(jnp.asarray(x), jnp.asarray(avg), *j_ctl.state.bufs)
            assert _raw(new.buf) == _raw(jnew), r
            # The broadcast is the port's: both resync from its bytes.
            t_ctl.resync(torch.from_numpy(x), new.buf)
            j_ctl.resync(x, new.buf.numpy())
            assert _raw(t_ctl.state.bufs[0]) == _raw(j_ctl.state.bufs[0]), r
            x = new.buf.numpy()
        back = server_state_from_jax(j_ctl.state, device=CPU)
        assert isinstance(back, so.PackedServerState)
        assert (back.kind, back.hyper) == (opt.kind, opt.hyper)
        assert _raw(back.bufs[0]) == _raw(t_ctl.state.bufs[0])
        there = server_state_to_jax(t_ctl.state)
        assert isinstance(there.bufs[0], np.ndarray) and _raw(there.bufs[0]) == _raw(j_ctl.state.bufs[0])


# -- the cutoff, the downlink and the hierarchy ------------------------------------


def _cutoff_aggs(grid, jgrid, ref, tq, jq, ws):
    """The reference test's cutoff round in both packages: source 1 never
    arrives, 0 and 2 fold."""
    agg = StreamingAggregator(3, weights=ws, chunk_elems=CE, quant=grid, quant_ref=ref, quorum=2,
                              labels=["a", "b", "c"], device=CPU)
    agg.sink(1)
    agg.add_local(0, tq[0])
    agg.sink(2).on_complete(_payload(wire.encode_payload(tq[2])))
    jagg = JStreamingAggregator(3, weights=ws, chunk_elems=CE, quant=jgrid, quant_ref=ref, quorum=2,
                                labels=["a", "b", "c"])
    jagg.sink(1)
    jagg.add_local(0, jq[0])
    from rayfed_tpu import native as jnative
    from rayfed_tpu.transport import wire as jwire

    jagg.sink(2).on_complete(jnative.gather_copy(
        [memoryview(b) if isinstance(b, (bytes, bytearray)) else b for b in jwire.encode_payload(jq[2])]))
    return agg.result(timeout=60, deadline_s=0.4), agg, jagg.result(timeout=60, deadline_s=0.4)


def test_quorum_subset_refold_feeds_step_bitexact():
    ref, tp, jp, grid, jgrid = _setup(3)
    tq = [qz.quantize_packed(p, grid, ref=ref) for p in tp]
    jq = [jqz.quantize_packed(p, jgrid, ref=ref) for p in jp]
    ws = [3, 1, 2]
    runner = so.PackedServerOptimizer(so.fedac(1.0, 3.0, 0.5), device=CPU)
    runner.ensure(ref)
    step = runner.step_fn(ref)
    jrunner = jso.PackedServerOptimizer(jso.fedac(1.0, 3.0, 0.5))
    jrunner.ensure(ref)
    result, agg, jresult = _cutoff_aggs(grid, jgrid, ref, tq, jq, ws)
    got = step(result)
    assert agg.quorum_members == [0, 2]
    # The step's pseudo-gradient is the subset's mean (Σw = 3 + 2).
    want = step(tf.packed_quantized_sum([tq[0], tq[2]], [3, 2], ref=ref))
    assert _raw(got.buf) == _raw(want.buf)
    assert _raw(got.buf) == _raw(jrunner.step_fn(ref)(jresult).buf)


@pytest.mark.parametrize("cutoff", [False, True], ids=["full", "cutoff"])
def test_quantized_downlink_after_step_parity(cutoff):
    """The post-step broadcast decoded from its serialized bytes equals the
    coordinator's own decode, both equal the JAX package's, and both
    controllers resync to one state from it."""
    ref, tp, jp, grid, jgrid = _setup(3)
    tq = [qz.quantize_packed(p, grid, ref=ref) for p in tp]
    jq = [jqz.quantize_packed(p, jgrid, ref=ref) for p in jp]
    ws = [3, 1, 2]
    opt, jopt = so.server_momentum(0.9, 0.5), jso.server_momentum(0.9, 0.5)
    runner = so.PackedServerOptimizer(opt, device=CPU)
    runner.ensure(ref)
    step = runner.step_fn(ref)
    jrunner = jso.PackedServerOptimizer(jopt)
    jrunner.ensure(ref)
    if cutoff:
        result, _, jresult = _cutoff_aggs(grid, jgrid, ref, tq, jq, ws)
    else:
        agg = StreamingAggregator(3, weights=ws, chunk_elems=CE, quant=grid, quant_ref=ref, device=CPU)
        jagg = JStreamingAggregator(3, weights=ws, chunk_elems=CE, quant=jgrid, quant_ref=ref)
        for i in range(3):
            agg.add_local(i, tq[i])
            jagg.add_local(i, jq[i])
        result, jresult = agg.result(timeout=60), jagg.result(timeout=60)
    wire_result, decoded, descr = qz.quantize_downlink(step(result), grid, ref, None)
    jwire_result, jdecoded, jdescr = jqz.quantize_downlink(jrunner.step_fn(ref)(jresult), jgrid, ref, None)
    assert descr["md"] == "delta" and descr == jdescr
    assert _raw(wire_result.buf) == _raw(jwire_result.buf)
    assert _raw(decoded.buf) == _raw(jdecoded.buf)
    assert _raw(decoded.buf) == _raw(wire_result.dequantize(np.float32, ref=ref).buf)
    got = wire.decode_payload(_payload(wire.encode_payload(wire_result)), allowed={})
    assert isinstance(got, qz.QuantizedPackedTree)
    receiver = got.dequantize(np.float32, ref=ref)
    assert _raw(receiver.buf) == _raw(decoded.buf)
    a = so.PackedServerOptimizer(opt, device=CPU)
    a.ensure(ref)
    a.resync(ref, decoded.buf)
    b = so.PackedServerOptimizer(opt, device=CPU)
    b.ensure(ref)
    b.resync(ref, receiver.buf)
    assert _raw(a.state.bufs[0]) == _raw(b.state.bufs[0])


def test_hierarchy_regrouped_fold_step_downlink_bitexact():
    """Two regions' integer partial sums folded at the root, one step and
    the downlink equal the flat fold, the same step and the downlink, and
    the JAX package's flat round, byte for byte."""
    from rayfed_tpu_torch.fl.hierarchy import RegionSumTree, partial_sum_dtype

    ref, tp, jp, grid, jgrid = _setup(4)
    ws = [2, 1, 3, 1]
    tq = [qz.quantize_packed(p, grid, ref=ref) for p in tp]
    jq = [jqz.quantize_packed(p, jgrid, ref=ref) for p in jp]
    runner = so.PackedServerOptimizer(so.fedac(1.0, 3.0, 0.5), device=CPU)
    runner.ensure(ref)
    step = runner.step_fn(ref)

    flat = StreamingAggregator(4, weights=ws, chunk_elems=CE, quant=grid, quant_ref=ref, device=CPU)
    for i, q in enumerate(tq):
        flat.add_local(i, q)
    flat_wire, flat_decoded, _ = qz.quantize_downlink(step(flat.result(timeout=60)), grid, ref, None)

    ps_dt = partial_sum_dtype(grid.qabs_max, sum(ws))
    root = StreamingAggregator(2, weights=[float(ws[0] + ws[1]), float(ws[2] + ws[3])], chunk_elems=CE,
                               quant=grid, quant_ref=ref, presummed=ps_dt, labels=["region 0", "region 1"],
                               device=CPU)
    for g, members in enumerate([(0, 1), (2, 3)]):
        acc = np.zeros(grid.total_elems, np.int64)
        for i in members:
            acc += ws[i] * np.asarray(tq[i].buf).astype(np.int64)
        spec = tc.PackSpec(tq[0].spec.entries, tq[0].spec.treedef, ps_dt)
        root.add_local(g, RegionSumTree(acc.astype(np.dtype(ps_dt)), grid.scales, grid.zps, (), spec, grid.meta()))
    hier_wire, hier_decoded, _ = qz.quantize_downlink(step(root.result(timeout=60)), grid, ref, None)
    assert _raw(flat_decoded.buf) == _raw(hier_decoded.buf)
    assert _raw(flat_wire.buf) == _raw(hier_wire.buf)

    jrunner = jso.PackedServerOptimizer(jso.fedac(1.0, 3.0, 0.5))
    jrunner.ensure(ref)
    jflat = JStreamingAggregator(4, weights=ws, chunk_elems=CE, quant=jgrid, quant_ref=ref)
    for i, q in enumerate(jq):
        jflat.add_local(i, q)
    jwire_result, jdecoded, _ = jqz.quantize_downlink(jrunner.step_fn(ref)(jflat.result(timeout=60)), jgrid, ref, None)
    assert _raw(hier_wire.buf) == _raw(jwire_result.buf) and _raw(hier_decoded.buf) == _raw(jdecoded.buf)


# -- state carried across: snapshot stamps, load_state, the wire ------------------


def test_checkpoint_state_roundtrip(tmp_path):
    """The reference's checkpoint round trip through the port's
    ``FedCheckpointer`` (the state and its ``server_opt`` stamp restore
    byte for byte); a JAX state converted by ``server_state_from_jax``, and
    a port state through the wire pickle, both decode to the same bytes and
    spec; the JAX package reads the port's state as its own class."""
    from rayfed_tpu_torch.checkpoint import FedCheckpointer
    from rayfed_tpu.transport import wire as jwire
    from rayfed_tpu_torch.models.convert import server_state_from_jax

    opt, jopt = so.fedac(1.0, 3.0, 0.5), jso.fedac(1.0, 3.0, 0.5)
    x = np.random.default_rng(7).normal(size=(512,)).astype(np.float32)
    runner = so.PackedServerOptimizer(opt, device=CPU)
    runner.ensure(torch.from_numpy(x))
    runner.resync(torch.from_numpy(x), torch.from_numpy(x - 0.01))  # a nontrivial state
    jrunner = jso.PackedServerOptimizer(jopt)
    jrunner.ensure(x)
    jrunner.resync(x, x - np.float32(0.01))
    assert _raw(runner.state.bufs[0]) == _raw(jrunner.state.bufs[0])

    ck = FedCheckpointer(str(tmp_path), "alice", device=CPU)
    ck.save(3, {"params": {"w": torch.from_numpy(x)}, "server_state": runner.state},
            metadata={"server_opt": opt.describe()})
    r, snap = ck.restore(target={"params": {"w": torch.zeros(512)}, "server_state": opt.init(torch.zeros(512))})
    assert r == 3 and ck.load_metadata(3)["server_opt"] == opt.describe()
    assert _raw(so.PackedServerOptimizer(opt, state=snap["server_state"]).state.bufs[0]) == \
        _raw(runner.state.bufs[0])

    restored = so.PackedServerOptimizer(opt, state=server_state_from_jax(jrunner.state, device=CPU))
    assert _raw(restored.state.bufs[0]) == _raw(runner.state.bufs[0])
    blob = _payload(wire.encode_payload({"server_state": runner.state}))
    back = wire.decode_payload(blob, allowed={})["server_state"]
    assert isinstance(back, so.PackedServerState) and (back.kind, back.hyper) == (opt.kind, opt.hyper)
    assert _raw(back.bufs[0]) == _raw(runner.state.bufs[0])
    jback = jwire.decode_payload(blob, allowed={})["server_state"]
    assert isinstance(jback, jso.PackedServerState) and _raw(jback.bufs[0]) == _raw(runner.state.bufs[0])
    tback = wire.decode_payload(_payload(jwire.encode_payload({"s": jrunner.state})), allowed={})["s"]
    assert isinstance(tback, so.PackedServerState) and _raw(tback.bufs[0]) == _raw(runner.state.bufs[0])


def test_snapshot_server_opt_guard_matrix():
    from rayfed_tpu_torch.fl.fedopt import server_sgd

    packed = so.fedac(1.0, 3.0, 0.5).describe()
    none = so.describe_server_opt(None)
    legacy = so.describe_server_opt(server_sgd(0.5, 0.9))
    assert (none, legacy) == (jso.describe_server_opt(None), {"kind": "fedopt"})
    for ok in (so.check_snapshot_server_opt, jso.check_snapshot_server_opt):
        ok(packed, packed)
        ok(none, none)
        ok(legacy, legacy)
        ok(None, none)
        ok(None, legacy)
        with pytest.raises(ValueError, match="no server_opt stamp"):
            ok(None, packed)
        for stored, expected in [
            (none, packed), (packed, none), (legacy, packed),
            (packed, legacy), (none, legacy), (legacy, none),
            ({"kind": "fedac", "hyper": [1.0, 3.0, 0.25]}, packed),
            ({"kind": "momentum", "hyper": [1.0, 0.9]}, packed),
        ]:
            with pytest.raises(ValueError, match="server_opt mismatch"):
                ok(stored, expected)


def test_load_state_refuses_foreign_spec():
    st = so.fedac(1.0, 3.0, 0.5).init(torch.zeros(16))
    with pytest.raises(ValueError, match="restored server-opt state"):
        so.PackedServerOptimizer(so.fedac(1.0, 2.0, 0.5), state=st)
    with pytest.raises(TypeError, match="PackedServerState"):
        so.PackedServerOptimizer(so.fedac(1.0, 3.0, 0.5), state=object())


# -- rounds to target --------------------------------------------------------------


def _rounds_to_target(opt, target_loss, max_rounds=420):
    """The reference test's quadratic recurrence through the port's step and
    resync: 2 heterogeneous parties, per-coordinate curvature, loss the mean
    squared distance to the shared optimum."""
    rng = np.random.default_rng(11)
    size = 4096
    opt_point = rng.normal(size=(size,)).astype(np.float32)
    s = 0.3 * rng.normal(size=(size,)).astype(np.float32)
    shifts = [s, -s]
    curv = np.linspace(0.02, 0.12, size).astype(np.float32)
    tmpl = tc.pack_tree({"w": torch.zeros(size)}, torch.float32)
    runner = None if opt is None else so.PackedServerOptimizer(opt, device=CPU)
    x = np.zeros(size, np.float32)
    for r in range(max_rounds):
        ups = [x - curv * (x - (opt_point + sh)) for sh in shifts]
        avg = np.mean(ups, axis=0).astype(np.float32)
        if runner is not None:
            runner.ensure(torch.from_numpy(x))
            res = tc.PackedTree(torch.from_numpy(avg), tmpl.passthrough, tmpl.spec)
            new_x = runner.step_fn(torch.from_numpy(x))(res).buf
            runner.resync(torch.from_numpy(x), new_x)
            x = new_x.numpy()
        else:
            x = avg
        if float(np.mean((x - opt_point) ** 2)) <= target_loss:
            return r + 1
    return max_rounds


def test_fedac_cuts_rounds_to_target_on_quadratic():
    base = float(np.mean(np.random.default_rng(11).normal(size=(4096,)).astype(np.float32) ** 2))
    target = 1e-3 * base
    plain = _rounds_to_target(None, target)
    accel = _rounds_to_target(so.fedac(1.0, 6.0, 0.7), target)
    assert plain < 420, plain
    assert accel / plain <= 0.8, (plain, accel)


def test_degenerate_fedac_trajectory_equals_plain_bitexact():
    rng = np.random.default_rng(13)
    size = 2048
    tmpl = tc.pack_tree({"w": torch.zeros(size)}, torch.float32)
    runner = so.PackedServerOptimizer(so.fedac(1.0, 1.0, 0.0), device=CPU)
    x_plain = rng.normal(size=(size,)).astype(np.float32)
    x_opt = x_plain.copy()
    for _ in range(5):
        avg = x_plain - 0.05 * x_plain + 0.001 * rng.normal(size=(size,)).astype(np.float32)
        x_plain = avg
        runner.ensure(torch.from_numpy(x_opt))
        new_x = runner.step_fn(torch.from_numpy(x_opt))(
            tc.PackedTree(torch.from_numpy(avg), tmpl.passthrough, tmpl.spec)).buf
        runner.resync(torch.from_numpy(x_opt), new_x)
        x_opt = new_x.numpy()
        assert _raw(x_opt) == _raw(x_plain)


# -- the round loop in one party ----------------------------------------------------


@pytest.mark.parametrize("wire_quant", [None, "uint8"])
def test_one_party_rounds_step_and_resync(wire_quant):
    """Three rounds of ``run_fedavg_rounds(server_opt=fedac(...))`` in one
    party: each round's result is the aggregate stepped from the replicated
    state (then, under ``wire_quant``, re-coded for the downlink with the
    grid ranged by the post-step delta), byte for byte with a replay of the
    same pieces."""
    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch.models import logistic
    from tests.multiproc import make_cluster

    rng = np.random.default_rng(21)
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

    opt = so.fedac(1.0, 3.0, 0.5)
    qz.reset_compressors()
    fed.init(address="local", cluster=make_cluster(["solo"]), party="solo", device=CPU)
    try:
        params = logistic.init_logistic(16, 3, device=CPU)
        final = fed.fl.run_fedavg_rounds({"solo": Trainer.party("solo").remote()}, params, rounds=3,
                                         compress_wire=True, packed_wire=True, streaming_agg=True,
                                         wire_quant=wire_quant, server_opt=opt)
    finally:
        fed.shutdown()
        qz.reset_compressors()

    replica = so.PackedServerOptimizer(opt, device=CPU)
    up, down = qz.QuantCompressor(), qz.QuantCompressor()
    current, prev_delta = params, None
    for _ in range(3):
        x_srv = tc.pack_tree(current, torch.float32).buf
        replica.ensure(x_srv)
        contrib = local(tc.decompress(tc.compress(current, packed=True), torch.float32))
        if prev_delta is None:
            folded = tf.packed_weighted_sum([contrib], out_dtype="float32")
            avg = replica.step_fn(x_srv)(folded)
        else:
            grid = qz.make_round_grid(prev_delta, wire_dtype="uint8", mode="delta", expand=qz.QUANT_DELTA_EXPAND)
            codes = up.quantize(contrib, grid, ref=x_srv)
            up.commit()
            stepped = replica.step_fn(x_srv)(tf.packed_quantized_sum([codes], ref=x_srv))
            down_grid = qz.make_round_grid(stepped.buf.numpy() - x_srv.numpy(), chunk_elems=grid.chunk_elems,
                                           wire_dtype="uint8", mode="delta")
            avg = down.quantize(stepped, down_grid, ref=x_srv).dequantize(torch.float32, ref=x_srv)
            down.commit()
        replica.resync(x_srv, avg.buf)
        if wire_quant is not None:
            prev_delta = avg.buf.numpy() - x_srv.numpy()
        current = tc.decompress(avg)
    for name in final:
        assert _raw(final[name]) == _raw(current[name]), name
