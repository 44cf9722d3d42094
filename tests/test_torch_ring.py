"""The port's chunk-striped ring (CPU) against the JAX package's.

Byte identity throughout: the stripe schedule and compaction, the ``rsm``
manifest (and ``tool/wire_format.lock``'s ring entries recomputed with the
port's producer), the quantized gather hop's codes and decode, the
``StripeAggregator``'s stripes fed the same payloads as the reference's
(bf16 wire, integral or exact weights), the stripes reassembled against
both packages' ``packed_weighted_sum`` for 2-4 parties on a flat and a
ResNet tree, and ``validate_round_config``'s ring verdicts.

One party-process run (~15 s): a 3-party ring, alice and bob on the port
and carol on the JAX package, where a direct ``ring_aggregate`` and two
``run_fedavg_rounds(mode="ring")`` rounds run; the second round aborts at
alice's reduce-scatter through ``_maybe_fault`` and every party falls back
to the coordinator topology in lockstep.  Every party's bytes equal its
package's one-shot fold of the round's contributions and each other's.
"""

import json
import multiprocessing as mp
import random
import sys
import time
import zlib

import numpy as np
import pytest
import torch

from rayfed_tpu_torch.fl import compression as tc
from rayfed_tpu_torch.fl import fedavg as tf
from rayfed_tpu_torch.fl import quantize as tqz
from rayfed_tpu_torch.fl import ring as tring
from rayfed_tpu_torch.fl import trainer as ttrainer
from rayfed_tpu_torch.fl.streaming import StripeAggregator
from rayfed_tpu_torch.transport import wire
from tests.multiproc import make_cluster

CPU = torch.device("cpu")


def _raw(x):
    if isinstance(x, torch.Tensor):
        if x.numel() == 0:
            return b""
        return x.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _payload(value):
    return b"".join(
        bytes(b) if isinstance(b, (bytes, bytearray)) else bytes(memoryview(b).cast("B"))
        for b in wire.encode_payload(value)
    )


def _np_trees(n, shapes=((400, 33), (1000,), (7, 11, 13))):
    rng = np.random.default_rng(0)
    return [{f"w{j}": rng.standard_normal(s).astype(np.float32) for j, s in enumerate(shapes)}
            for _ in range(n)]


def _packed_pair(trees):
    """Each package's bf16 PackedTree of the same float trees."""
    import jax.numpy as jnp

    from rayfed_tpu.fl import compression as jc

    jp = [jc.pack_tree({k: jnp.asarray(v) for k, v in t.items()}) for t in trees]
    tp = [tc.pack_tree({k: torch.from_numpy(v) for k, v in t.items()}) for t in trees]
    return jp, tp


# -- schedule, compaction, manifest -----------------------------------------------


@pytest.mark.parametrize("total,chunk,n", [(10 << 10, 1 << 10, 4), (2560, 1024, 3), (0, 1024, 2), (5000, 1024, 2)])
def test_stripe_schedule_and_slices_equal_the_reference(total, chunk, n):
    from rayfed_tpu.fl import fedavg as jf
    from rayfed_tpu.fl import ring as jring

    nb = tf.packed_block_grid(total, chunk)
    assert nb == jf.packed_block_grid(total, chunk)
    stripes = tf.packed_stripe_schedule(nb, n)
    assert stripes == jf.packed_stripe_schedule(nb, n)
    buf = np.arange(total, dtype=np.float32)
    for blocks in stripes:
        want = jring._stripe_slice(buf, blocks, chunk, total)
        assert tring._stripe_elems(blocks, chunk, nb, total) == jring._stripe_elems(blocks, chunk, nb, total)
        assert _raw(tring._stripe_slice(buf, blocks, chunk, total)) == _raw(want)
        assert _raw(tring._stripe_slice(torch.from_numpy(buf), blocks, chunk, total)) == _raw(want)
    with pytest.raises(ValueError):
        tf.packed_stripe_schedule(4, 0)


def test_stripe_meta_equals_the_reference_and_holds_the_lock(monkeypatch):
    """The ``rsm`` JSON equals the reference's; the lock's fingerprint,
    recomputed with the port's producer and version in place of the JAX
    package's, is still the pinned one (``ring_stripe_schema``,
    ``ring_stripe_quant_schema``, ``ring_stripe_version`` and the roster
    epoch key)."""
    import pathlib

    from rayfed_tpu.fl import ring as jring
    from rayfed_tpu.transport import wire as jwire
    from tool import check_wire_format

    for args, kw in (((2, 4, 10, 12345, "bfloat16", "rs"), {}),
                     ((1, 3, 9, 1 << 21, "uint8", "ag"), {"qgrid_fp": 987})):
        assert json.dumps(tring.make_stripe_meta(*args, **kw), sort_keys=True) == json.dumps(
            jring.make_stripe_meta(*args, **kw), sort_keys=True)
    meta = tring.make_stripe_meta(2, 4, 10, 12345, "bfloat16", "rs")
    tring._check_meta(json.dumps(meta), {"s": 2, "n": 4, "el": 12345, "dt": "bfloat16", "ph": "rs"})
    with pytest.raises(ValueError, match="disagree"):
        tring._check_meta(json.dumps(meta), {"s": 3})
    with pytest.raises(ValueError, match="understands up to"):
        tring._check_meta(json.dumps(dict(meta, v=tring.RING_STRIPE_VERSION + 1)), {})
    assert tring.RING_STRIPE_VERSION == jring.RING_STRIPE_VERSION
    assert tring.RING_SEQ_IDS == jring.RING_SEQ_IDS
    assert wire.EPOCH_TAG_KEY == jwire.EPOCH_TAG_KEY
    monkeypatch.setattr(jring, "make_stripe_meta", tring.make_stripe_meta)
    monkeypatch.setattr(jring, "RING_STRIPE_VERSION", tring.RING_STRIPE_VERSION)
    monkeypatch.setattr(jwire, "EPOCH_TAG_KEY", wire.EPOCH_TAG_KEY)
    lock = json.loads((pathlib.Path(check_wire_format.__file__).parent / "wire_format.lock").read_text())
    assert check_wire_format.compute_fingerprint() == lock["fingerprint"]


@pytest.mark.parametrize("with_ref", [False, True])
def test_gather_stripe_codes_and_decode_equal_the_reference(with_ref):
    from rayfed_tpu.fl import ring as jring

    rng = np.random.default_rng(3)
    ce, blocks = 1024, [1, 4, 7]
    n = 2 * ce + 300  # the last block short
    grid = tqz.make_round_grid(rng.normal(size=8 * ce).astype(np.float32), chunk_elems=ce, expand=4.0)
    scales, zps = grid.rows(blocks)
    stripe = (rng.normal(size=n) * 0.5).astype(np.float32)
    ref = rng.normal(size=n).astype(np.float32) if with_ref else None
    want = jring.code_gather_stripe(stripe, ref, scales, zps, ce, "uint8")
    got = tring.code_gather_stripe(torch.from_numpy(stripe), None if ref is None else torch.from_numpy(ref),
                                   scales, zps, ce, "uint8")
    assert _raw(got) == _raw(want)
    dwant = jring.decode_gather_stripe(want, ref, scales, zps, ce, np.float32)
    dgot = tring.decode_gather_stripe(got, ref, scales, zps, ce, torch.float32)
    assert _raw(dgot) == _raw(dwant)


# -- StripeAggregator --------------------------------------------------------------


def _assemble(agg_cls, bufs, weights, n_stripes, chunk, seed, **agg_kw):
    """Reduce-scatter + assemble in process with seeded arrival orders: the
    payloads are the same bytes for either package's aggregator."""
    rng = random.Random(seed)
    total = bufs[0].size
    nblocks = tf.packed_block_grid(total, chunk)
    stripes = tf.packed_stripe_schedule(nblocks, n_stripes)
    out = np.empty(total, bufs[0].dtype)
    for k, blocks in enumerate(stripes):
        se = tring._stripe_elems(blocks, chunk, nblocks, total)
        if not se:
            continue
        agg = agg_cls(len(bufs), weights=weights, chunk_elems=chunk, expect_elems=se, **agg_kw)
        local = rng.randrange(len(bufs))
        order = [i for i in range(len(bufs)) if i != local]
        rng.shuffle(order)
        for i in order:
            payload = _payload({"data": tring._stripe_slice(bufs[i], blocks, chunk, total)})
            if rng.random() < 0.5:  # partial extents before completion
                mv = memoryview(payload)
                for frac in sorted(rng.random() for _ in range(3)):
                    agg.sink(i).on_bytes(mv, int(len(payload) * frac))
            agg.sink(i).on_complete(payload)
        agg.add_local(local, tring._stripe_slice(bufs[local], blocks, chunk, total))
        got = agg.result(timeout=60)
        got = np.frombuffer(_raw(got), bufs[0].dtype) if isinstance(got, torch.Tensor) else np.asarray(got)
        off = 0
        for b in blocks:
            size = min(chunk, total - b * chunk)
            out[b * chunk : b * chunk + size] = got[off : off + size]
            off += size
    return out


def _both_assemblies(bufs, weights, n, chunk, seed):
    from rayfed_tpu.fl.streaming import StripeAggregator as JStripe

    want = _assemble(JStripe, bufs, weights, n, chunk, seed)
    got = _assemble(StripeAggregator, bufs, weights, n, chunk, seed, device=CPU)
    return got, want


@pytest.mark.parametrize("n_parties", [2, 3, 4])
@pytest.mark.parametrize("weights", [None, "uneven"])
def test_ring_stripes_equal_both_one_shot_folds(n_parties, weights):
    from rayfed_tpu.fl import fedavg as jf

    jp, tp = _packed_pair(_np_trees(n_parties))
    w = None if weights is None else [1.0 + 0.75 * i for i in range(n_parties)]
    want = np.asarray(jf.packed_weighted_sum(jp, w).buf)
    assert _raw(tf.packed_weighted_sum(tp, w).buf) == _raw(want)
    bufs = [np.asarray(p.buf).reshape(-1) for p in jp]
    for seed in (0, 7):
        got, ref_assembled = _both_assemblies(bufs, w, n_parties, 1 << 10, seed)
        assert got.tobytes() == ref_assembled.tobytes() == want.tobytes()


@pytest.mark.parametrize("n_parties", [2, 3, 4])
def test_ring_stripes_equal_the_reference_on_a_resnet_tree(n_parties):
    import jax

    from rayfed_tpu.fl import compression as jc
    from rayfed_tpu.fl import fedavg as jf
    from rayfed_tpu.models import resnet

    cfg = resnet.resnet18(num_classes=10, width=16)
    jp = [jc.pack_tree(resnet.init_resnet(jax.random.PRNGKey(i), cfg)) for i in range(n_parties)]
    want = np.asarray(jf.packed_weighted_sum(jp).buf)
    bufs = [np.asarray(p.buf).reshape(-1) for p in jp]
    got, ref_assembled = _both_assemblies(bufs, None, n_parties, 1 << 14, 3)
    assert got.tobytes() == ref_assembled.tobytes() == want.tobytes()


def test_quantized_stripes_equal_the_reference():
    """Compressed-domain stripes: uint8 codes folded in i32 and rescaled on
    the stripe's grid rows with its reference slice, as the reference's."""
    from rayfed_tpu.fl import quantize as jqz
    from rayfed_tpu.fl.streaming import StripeAggregator as JStripe

    rng = np.random.default_rng(5)
    ce, n, size = 1 << 10, 3, 5 * 1024 + 77
    ref = rng.normal(size=size).astype(np.float32)
    tgrid = tqz.make_round_grid(rng.normal(size=size).astype(np.float32), chunk_elems=ce, expand=4.0)
    jgrid = jqz.QuantGrid(tgrid.scales, tgrid.zps, ce, size, "uint8", "delta")
    codes = [rng.integers(0, 256, size=size).astype(np.uint8) for _ in range(n)]
    nb = tf.packed_block_grid(size, ce)
    for blocks in tf.packed_stripe_schedule(nb, n):
        se = tring._stripe_elems(blocks, ce, nb, size)
        rslice = tring._stripe_slice(ref, blocks, ce, size)
        outs = []
        for cls, grid, kw in ((JStripe, jgrid, {}), (StripeAggregator, tgrid, {"device": CPU})):
            agg = cls(n, weights=[1, 2, 3], chunk_elems=ce, expect_elems=se, quant=grid,
                      quant_blocks=blocks, quant_ref=rslice, **kw)
            for i in (2, 1):
                agg.sink(i).on_complete(_payload({"data": tring._stripe_slice(codes[i], blocks, ce, size)}))
            agg.add_local(0, tring._stripe_slice(codes[0], blocks, ce, size))
            outs.append(_raw(agg.result(timeout=30)))
        assert outs[0] == outs[1]


def test_stripe_aggregator_rejects_what_the_reference_rejects():
    """A manifest from another chunk grid, a payload without its manifest,
    and a stripe of the wrong size fail before any block folds."""
    jp, _ = _packed_pair(_np_trees(2))
    buf = np.asarray(jp[0].buf).reshape(-1)
    want = {"s": 0, "n": 2, "nb": 8, "el": int(buf.size), "ph": "rs"}
    agg = StripeAggregator(2, chunk_elems=1 << 10, device=CPU,
                           meta_check=lambda v: tring._check_meta(v, want))
    bad = json.dumps(tring.make_stripe_meta(0, 2, 4, buf.size, str(buf.dtype), "rs"))
    agg.sink(1).on_complete(_payload({"data": buf[: 1 << 11], "rsm": bad}))
    with pytest.raises(ValueError, match="disagree"):
        agg.result(timeout=30)
    agg2 = StripeAggregator(2, chunk_elems=1 << 10, device=CPU,
                            meta_check=lambda v: tring._check_meta(v, want))
    agg2.sink(1).on_complete(_payload({"data": buf[: 1 << 11]}))
    with pytest.raises(ValueError, match="missing its 'rsm'"):
        agg2.result(timeout=30)
    agg3 = StripeAggregator(2, chunk_elems=1 << 10, expect_elems=17, device=CPU)
    agg3.sink(1).on_complete(_payload({"data": buf[: 1 << 10]}))
    with pytest.raises(ValueError, match="expects 17"):
        agg3.result(timeout=30)
    agg4 = StripeAggregator(2, chunk_elems=1 << 10, expect_elems=17, device=CPU)
    agg4.add_local(0, buf[:33])
    with pytest.raises(ValueError, match="expects 17"):
        agg4.result(timeout=30)
    with pytest.raises(ValueError, match="quant_blocks"):
        StripeAggregator(2, chunk_elems=1 << 10, device=CPU,
                         quant=tqz.make_round_grid(np.ones(2048, np.float32), chunk_elems=1 << 10, mode="abs"))


# -- validation ------------------------------------------------------------------


RING_CASES = [
    {"mode": "star"},
    {"mode": "ring"},
    {"mode": "ring", "compress_wire": True, "packed_wire": True, "sample": 2},
    {"mode": "ring", "compress_wire": True, "packed_wire": True, "aggregator": lambda vs: vs[0]},
    {"mode": "ring", "compress_wire": True, "packed_wire": True, "streaming_agg": True},
    {"mode": "ring", "compress_wire": True, "packed_wire": True, "sample": 3},
    {"mode": "ring", "compress_wire": True, "packed_wire": True, "ring_chunk_elems": 64},
    {"mode": "ring", "compress_wire": True, "packed_wire": True, "wire_quant": "uint8"},
    {"mode": "ring", "compress_wire": True, "packed_wire": True, "error_feedback": True},
    {"coordinator": "zed"},
]


def _verdict(fn, kw):
    try:
        return ("ok", fn({"a": None, "b": None, "c": None}, **kw))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("kw", RING_CASES, ids=lambda kw: ",".join(sorted(kw)) + f"={kw.get('mode')}")
def test_ring_validation_verdicts_equal_the_reference(kw):
    from rayfed_tpu.fl import trainer as jtrainer

    assert _verdict(ttrainer.validate_round_config, kw) == _verdict(jtrainer.validate_round_config, kw)


# -- the mixed three-party ring --------------------------------------------------


PARTIES = ("alice", "bob", "carol")  # carol runs the JAX package
PARTY_TIMEOUT_S = 90
D, CLASSES, N = 16, 3, 128


def _contribution_tree(i):
    rng = np.random.default_rng(100 + i)
    return {"w": rng.standard_normal(5000).astype(np.float32), "n": np.arange(4, dtype=np.int32) + i}


def _crc(buf):
    return zlib.crc32(_raw(buf))


def run_mixed_ring(party, cluster):
    """alice and bob: the port; carol: the JAX package."""
    weights = [1.0, 2.0, 3.0]
    if party == "carol":
        import jax.numpy as jnp

        import rayfed_tpu as pkg
        from rayfed_tpu.fl import compression as C
        from rayfed_tpu.fl import fedavg as F
        from rayfed_tpu.fl import ring as R
        from rayfed_tpu.fl import run_fedavg_rounds
        from rayfed_tpu.models import logistic as L

        def pack(tree):
            return C.compress({k: jnp.asarray(v) for k, v in tree.items()}, packed=True)

        @pkg.remote
        class Trainer:
            def __init__(self, seed):
                from tests.test_torch_fl_round import _data

                x, y = _data(seed)
                self._x, self._y = jnp.asarray(x), jnp.asarray(y)
                self._step = L.make_train_step(L.apply_logistic, lr=0.3)
                self.contrib = None

            def train(self, params):
                params = C.decompress(params, jnp.float32)
                for _ in range(2):
                    params, _ = self._step(params, self._x, self._y)
                self.contrib = C.compress(params, packed=True)
                return self.contrib

            def last(self):
                return self.contrib

        pkg.init(address="local", cluster=cluster, party=party)
        params = {"w": jnp.zeros((D, CLASSES), jnp.float32), "b": jnp.zeros(CLASSES, jnp.float32)}
        one_shot, ring_aggregate, stats = F.packed_weighted_sum, R.ring_aggregate, R.RING_STATS
    else:
        import rayfed_tpu_torch as pkg
        from rayfed_tpu_torch.models import logistic
        from tests.test_torch_fl_round import PortTrainer as Trainer

        def pack(tree):
            return tc.compress({k: torch.from_numpy(v) for k, v in tree.items()}, packed=True)

        pkg.init(address="local", cluster=cluster, party=party, device=CPU)
        params = logistic.init_logistic(D, CLASSES, device=CPU)
        one_shot, ring_aggregate, stats = tf.packed_weighted_sum, tring.ring_aggregate, tring.RING_STATS
        run_fedavg_rounds = pkg.fl.run_fedavg_rounds

    # 1. A direct ring round: 5 blocks over 3 stripes, an int passthrough leaf.
    produce = pkg.remote(lambda i: pack(_contribution_tree(i)))
    objs = [produce.party(p).remote(i) for i, p in enumerate(PARTIES)]
    got = ring_aggregate(objs, weights, stream="t-ring", chunk_elems=1 << 10)
    want = one_shot([pack(_contribution_tree(i)) for i in range(3)], weights)
    assert _raw(got.buf) == _raw(want.buf)
    assert _raw(got.passthrough[0]) == _raw(want.passthrough[0])
    crc = pkg.remote(lambda t: _crc(t.buf))
    crcs = pkg.get([crc.party(p).remote(got) for p in PARTIES])
    assert len(set(crcs)) == 1, crcs

    # 2. Two ring rounds of the round loop; alice's ring faults in the
    # second, at its reduce-scatter, and all three fall back together.
    calls = {"n": 0}

    def hook(phase):
        if phase == "rs" and party == "alice":
            calls["n"] += 1
            if calls["n"] == 2:
                raise ConnectionError("injected mid-round ring failure")

    if party != "carol":
        tring._fault_hook = hook
    trainers = {p: Trainer.party(p).remote(i + 1) for i, p in enumerate(PARTIES)}
    try:
        final = run_fedavg_rounds(trainers, params, rounds=2, compress_wire=True, packed_wire=True, mode="ring")
    finally:
        tring._fault_hook = None
    assert stats["rounds_completed"] >= 2 and stats["rounds_aborted"] >= 1 and stats["fallback_rounds"] >= 1, stats
    contribs = pkg.get([trainers[p].last.remote() for p in PARTIES])
    want = one_shot(contribs)
    mine = pack({k: np.asarray(v) for k, v in final.items()}) if party == "carol" else tc.compress(final, packed=True)
    assert _raw(mine.buf) == _raw(want.buf)
    crcs = pkg.get([crc.party(p).remote(mine) for p in PARTIES])
    assert len(set(crcs)) == 1, crcs
    pkg.shutdown()


def _port_child(fn_name, party, args):
    getattr(sys.modules[__name__], fn_name)(party, *args)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "rayfed_tpu"))
    assert not loaded, loaded


def test_mixed_three_party_ring_and_its_fallback():
    from tests.multiproc import _CHILD_ENV, _child_entry

    cluster = make_cluster(list(PARTIES))
    ctx = mp.get_context("spawn")
    procs = {
        p: ctx.Process(target=_port_child, args=("run_mixed_ring", p, (cluster,)))
        for p in ("alice", "bob")
    }
    procs["carol"] = ctx.Process(target=_child_entry,
                                 args=(_CHILD_ENV, __name__, "run_mixed_ring", "carol", (cluster,)))
    for proc in procs.values():
        proc.start()
    deadline = time.monotonic() + PARTY_TIMEOUT_S
    for proc in procs.values():
        proc.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p, proc in procs.items() if proc.is_alive()]
    for p in hung:
        procs[p].kill()
        procs[p].join(5)
    assert not hung, f"parties {hung} timed out after {PARTY_TIMEOUT_S}s"
    assert {p: proc.exitcode for p, proc in procs.items()} == {p: 0 for p in PARTIES}
