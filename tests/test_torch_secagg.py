"""The port's secure aggregation (CPU) against the JAX package's, after
``tests/test_secagg.py``.

The keystream (AES-256-CTR and Philox), the pair seeds, the net masks, the
masked codes at the wrap edges of the mod-2³² ring, the dropout corrections
and the finalized aggregates are held to the JAX package's bytes on the
same numpy-seeded inputs; ``MaskedCodeTree`` payloads are its bytes and each
side decodes the other's; the recovery messages and the round loops'
verdicts are its schemas and ``ValueError``s.  Each of the reference file's
21 cases has a counterpart here.

Masked rounds over the transport run between bare ``TransportManager``
virtual parties in one process (threads, real loopback sockets), the
port's ``quorum_aggregate`` and the JAX package's side by side, with a shim
runtime per party.  One party-process run mixes the packages: alice on the
JAX package, bob, carol and dave on the port; masked streaming rounds equal
the plain ones, then masked quorum rounds in which dave crashes after round
1, so round 2's cutoff recovers his masks; every final equals the all-JAX
run's bytes.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayfed_tpu.fl import compression as jc
from rayfed_tpu.fl import fedavg as jf
from rayfed_tpu.fl import quantize as jqz
from rayfed_tpu.fl import secagg as jsa
from rayfed_tpu.fl.streaming import StreamingAggregator as JStreamingAggregator
from rayfed_tpu.transport import wire as jwire
from rayfed_tpu.transport.secagg import HAVE_AES, KeyAgreement as JKeyAgreement
from rayfed_tpu_torch.fl import compression as tc
from rayfed_tpu_torch.fl import fedavg as tf
from rayfed_tpu_torch.fl import quantize as qz
from rayfed_tpu_torch.fl import secagg as sa
from rayfed_tpu_torch.fl.streaming import StreamingAggregator
from rayfed_tpu_torch.transport import wire
from rayfed_tpu_torch.transport.secagg import HAVE_X25519, KeyAgreement
from tests.multiproc import get_free_ports, make_cluster, run_parties

CPU = torch.device("cpu")
GROUP_KEY = b"test-secagg-group-key"
PARTIES = ["alice", "bob", "carol", "dave"]
N_ELEMS = 5000
CHUNK = 1024
SCHEMES = ["philox"] + (["aes"] if HAVE_AES else [])


def _raw(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _keyring(parties=PARTIES, group_key=GROUP_KEY, pkg=None):
    """Cross-recorded KeyAgreement instances, as HELLO would leave them;
    ``pkg`` maps a party to ``"jax"`` to hold the JAX package's instance."""
    keys = {
        p: (JKeyAgreement if (pkg or {}).get(p) == "jax" else KeyAgreement)(p, group_key=group_key)
        for p in parties
    }
    for p in parties:
        for q in parties:
            if p != q:
                keys[p].record_peer(q, keys[q].hello_value())
    return keys


# -- key agreement and the keystream -----------------------------------------------


def test_pair_seed_symmetric_scoped_and_shared_with_the_reference():
    """Both endpoints derive one seed, every scope component re-keys it, and
    a port endpoint and a JAX endpoint (cross-recorded HELLO values) agree."""
    keys = _keyring(pkg={"bob": "jax", "dave": "jax"})
    kw = dict(session="s1", stream="fedavg", round_index=3)
    for a, b in (("alice", "bob"), ("bob", "dave"), ("alice", "carol")):
        assert keys[a].pair_seed(b, **kw) == keys[b].pair_seed(a, **kw)
    ab = keys["alice"].pair_seed("bob", **kw)
    assert len(ab) == 32
    for scope in (dict(kw, round_index=4), dict(kw, stream="fedavg.fo.bob"), dict(kw, session="s2")):
        assert ab != keys["alice"].pair_seed("bob", **scope)
    assert ab != keys["alice"].pair_seed("carol", **kw)


def test_length_prefixed_preimage_equals_the_reference():
    """``pairwise_key`` is the reference's digest, and names holding ``|``
    cannot collide across pairs."""
    for a, b in (("a", "b|c"), ("a|b", "c"), ("alice", "bob"), ("bob", "alice")):
        assert sa.pairwise_key(GROUP_KEY, a, b, 7) == jsa.pairwise_key(GROUP_KEY, a, b, 7)
    assert sa.pairwise_key(b"k", "a", "b|c", 0) != sa.pairwise_key(b"k", "a|b", "c", 0)


def test_missing_peer_and_group_key_fail_loudly(monkeypatch):
    monkeypatch.delenv("RAYFED_SECAGG_GROUP_KEY", raising=False)
    k = KeyAgreement("alice", group_key=GROUP_KEY)
    with pytest.raises(sa.SecAggError, match="no secure-aggregation key recorded"):
        k.pair_seed("bob", session="s", stream="f", round_index=0)
    if not HAVE_X25519:
        a, b = KeyAgreement("alice"), KeyAgreement("bob")
        a.record_peer("bob", b.hello_value())
        with pytest.raises(sa.SecAggError, match="group key"):
            a.pair_seed("bob", session="s", stream="f", round_index=0)


def test_malformed_hello_values_ignored_and_rekey_invalidates():
    a = KeyAgreement("alice", group_key=GROUP_KEY)
    for bad in ("", "junk", "9999.x25519.aes." + "ff" * 32, "1.x.y.zz"):
        a.record_peer("bob", bad)
    assert not a.has_peer("bob")
    a.record_peer("alice", a.hello_value())
    assert not a.has_peer("alice")
    keys = _keyring(["alice", "bob"])
    kw = dict(session="s", stream="f", round_index=0)
    before = keys["alice"].pair_seed("bob", **kw)
    fresh = KeyAgreement("bob", group_key=GROUP_KEY)
    keys["alice"].record_peer("bob", fresh.hello_value())
    fresh.record_peer("alice", keys["alice"].hello_value())
    after = keys["alice"].pair_seed("bob", **kw)
    assert after != before and after == fresh.pair_seed("alice", **kw)


@pytest.mark.skipif(not HAVE_X25519, reason="the x25519 suite needs the cryptography package")
def test_x25519_pair_needs_no_group_key(monkeypatch):
    monkeypatch.delenv("RAYFED_SECAGG_GROUP_KEY", raising=False)
    a, b = KeyAgreement("alice"), JKeyAgreement("bob")
    a.record_peer("bob", b.hello_value())
    b.record_peer("alice", a.hello_value())
    kw = dict(session="s", stream="f", round_index=0)
    assert a.kex_scheme == "x25519" and a.pair_seed("bob", **kw) == b.pair_seed("alice", **kw)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("n", [1, 4, 4096, 100_003])
def test_prg_mask_equals_the_reference(scheme, n):
    for s in range(3):
        seed = np.random.default_rng(s).bytes(32)
        got = sa.prg_mask(seed, n, scheme)
        assert got.dtype == np.uint32 and got.shape == (n,)
        assert got.tobytes() == jsa.prg_mask(seed, n, scheme).tobytes()
    assert not np.array_equal(sa.prg_mask(b"\x01" * 32, 64, scheme), sa.prg_mask(b"\x02" * 32, 64, scheme))
    with pytest.raises(sa.SecAggError, match="32-byte seed"):
        sa.prg_mask(b"short", 16, scheme)
    with pytest.raises(sa.SecAggError, match="unknown mask PRG"):
        sa.prg_mask(b"\x01" * 32, 16, "rc4")


@pytest.mark.parametrize("self_mask", [False, True])
def test_net_mask_equals_the_reference(self_mask):
    """The port's masker and the JAX package's, on one keyring: the same
    seeds and the same net mask (the self-mask seed copied across)."""
    keys = _keyring()
    for p in PARTIES:
        kw = dict(session="s", stream="f", round_index=2, weight=3, self_mask=self_mask)
        peers = [q for q in PARTIES if q != p]
        mine, theirs = sa.RoundMasker(keys[p], p, peers, **kw), jsa.RoundMasker(keys[p], p, peers, **kw)
        if self_mask:
            theirs._self_seed = mine._self_seed
        mine.prefetch(N_ELEMS)
        assert mine.net_mask(N_ELEMS).tobytes() == theirs.net_mask(N_ELEMS).tobytes()
        assert mine.recovery_seeds(["dave"]) == theirs.recovery_seeds(["dave"])
        with pytest.raises(sa.SecAggError, match="prefetched mask covers"):
            mine.net_mask(N_ELEMS + 1)


# -- the masked steps at the wrap edges --------------------------------------------

EDGE_MASKS = np.array([0, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)


@pytest.mark.parametrize("wire_dtype", ["uint8", "int8"])
def test_masked_code_kernel_bytes_at_the_wrap_edges(wire_dtype):
    """Codes at the grid's extremes, weights up to the headroom bound
    ``qabs_max·W ≤ 2³¹−1``, masks at 0, 2³¹−1, 2³¹ and 2³²−1: the port's
    int32 step equals the reference's uint32 one, byte for byte."""
    info = np.iinfo(wire_dtype)
    qabs = max(abs(int(info.min)), int(info.max))
    codes = np.array([info.min, info.max, 0, 1, -1 if info.min < 0 else 2], wire_dtype)
    step = jf.masked_code_kernel()
    for w in (0, 1, 7, (2**31 - 1) // qabs):
        for m in EDGE_MASKS:
            q = np.repeat(codes, 4)
            mask = np.tile(EDGE_MASKS, len(codes)) + m
            want = np.asarray(step(q, np.int32(w), mask))
            got = tf.masked_code_kernel(torch.from_numpy(q), w, mask)
            assert got.dtype == torch.int32 and _raw(got) == want.tobytes(), (w, int(m))


def test_masked_correction_kernel_bytes_at_the_wrap_edges():
    rng = np.random.default_rng(0)
    acc = np.concatenate([np.array([0, 2**31 - 1, -(2**31), -1], np.int32),
                          rng.integers(-(2**31), 2**31 - 1, 60, dtype=np.int32)])
    for corr in (np.tile(EDGE_MASKS, 16), rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)):
        want = np.asarray(jf.masked_correction_kernel()(jnp.asarray(acc), corr))
        mine = torch.from_numpy(acc.copy())
        out = tf.masked_correction_kernel(mine, corr)
        assert out is mine and _raw(mine) == want.tobytes()


# -- masked folds ------------------------------------------------------------------


def _round_fixture(weights, n=N_ELEMS, parties=PARTIES, hot=False):
    """Both packages' updates (the same values), the grid and reference,
    and the JAX package's unmasked codes, as the reference's tests make them."""
    ref = (np.arange(n, dtype=np.float32) * np.float32(1e-4)).astype(np.float32)
    prev = (1e-3 * np.random.default_rng(0).standard_normal(n)).astype(np.float32)
    grids = {"torch": qz.make_round_grid(prev, mode="delta", chunk_elems=CHUNK),
             "jax": jqz.make_round_grid(prev, mode="delta", chunk_elems=CHUNK)}
    vals = {p: (ref + 1.0) if hot else (ref + (1e-3 * np.random.default_rng(i).standard_normal(n)).astype(np.float32))
            for i, p in enumerate(parties)}
    ups = {
        "torch": {p: tc.pack_tree({"w": torch.from_numpy(v.copy())}, torch.float32) for p, v in vals.items()},
        "jax": {p: jc.pack_tree({"w": jnp.asarray(v)}, jnp.float32) for p, v in vals.items()},
    }
    qts = {p: jqz.quantize_packed(ups["jax"][p], grids["jax"], ref=ref) for p in parties}
    return grids, ref, ups, qts


def _masked(keys, grids, ref, ups, wmap, r=1, stream="f", parties=PARTIES, self_mask=False, pkg="torch"):
    """Each party's masked codes from one package's codec (the JAX
    package's maskers reuse the port's self-mask seeds)."""
    out, maskers = {}, {}
    for p in parties:
        kw = dict(session="s", stream=stream, round_index=r, weight=int(wmap[p]), self_mask=self_mask)
        peers = [q for q in parties if q != p]
        m = sa.RoundMasker(keys[p], p, peers, **kw)
        if pkg == "torch":
            out[p] = sa.MaskedRoundCodec(grids["torch"], ref, None, m).to_wire(ups["torch"][p])
        else:
            jm = jsa.RoundMasker(keys[p], p, peers, **kw)
            jm._self_seed = m._self_seed
            out[p] = jsa.MaskedRoundCodec(grids["jax"], ref, None, jm).to_wire(ups["jax"][p])
        maskers[p] = m
    return out, maskers


@pytest.mark.parametrize("weights", [None, [2.0, 1.0, 3.0, 1.0]])
def test_masked_codes_and_fold_equal_the_reference_under_shuffled_orders(weights):
    """The masked codes are the JAX package's bytes, and the masked fold in
    any order equals the unmasked round's and the JAX package's masked fold."""
    keys = _keyring()
    grids, ref, ups, qts = _round_fixture(weights)
    wmap = dict(zip(PARTIES, weights or [1] * len(PARTIES)))
    mts, _ = _masked(keys, grids, ref, ups, wmap)
    jmts, _ = _masked(keys, grids, ref, ups, wmap, pkg="jax")
    for p in PARTIES:
        assert isinstance(mts[p], sa.MaskedCodeTree) and _raw(mts[p].buf) == _raw(jmts[p].buf), p
    want = jf.packed_quantized_sum([qts[p] for p in PARTIES], weights, ref=ref)
    jagg = JStreamingAggregator(len(PARTIES), weights=weights, quant=grids["jax"], quant_ref=ref,
                                chunk_elems=CHUNK, masked=True, labels=PARTIES)
    for i, p in enumerate(PARTIES):
        jagg.add_local(i, jmts[p])
    assert _raw(jagg.result(timeout=60).buf) == _raw(want.buf)
    for trial in range(3):
        agg = StreamingAggregator(len(PARTIES), weights=weights, quant=grids["torch"], quant_ref=ref,
                                  chunk_elems=CHUNK, masked=True, labels=PARTIES, device=CPU)
        order = list(range(len(PARTIES)))
        random.Random(trial).shuffle(order)
        for i in order:
            agg.add_local(i, mts[PARTIES[i]])
        assert _raw(agg.result(timeout=60).buf) == _raw(want.buf), trial


def test_masked_fold_headroom_edge_mod_2_32():
    """Weights near the uint8 headroom ceiling and saturated codes (Σw·q ≈
    2.09e9): the masked intermediates wrap freely, the residual is the true
    sum, and the bytes equal the unmasked fold's and the reference's."""
    parties = ["alice", "bob"]
    keys = _keyring(parties)
    weights = [4_200_000.0, 4_000_000.0]
    grids, ref, ups, qts = _round_fixture(weights, n=2048, parties=parties, hot=True)
    grids["torch"].check_weight_headroom(sum(int(w) for w in weights))
    with pytest.raises(ValueError, match="integer-fold overflow"):
        grids["torch"].check_weight_headroom(9_000_000)
    want = jf.packed_quantized_sum([qts[p] for p in parties], weights, ref=ref)
    mts, _ = _masked(keys, grids, ref, ups, dict(zip(parties, weights)), parties=parties)
    jmts, _ = _masked(keys, grids, ref, ups, dict(zip(parties, weights)), parties=parties, pkg="jax")
    assert all(_raw(mts[p].buf) == _raw(jmts[p].buf) for p in parties)
    agg = StreamingAggregator(2, weights=weights, quant=grids["torch"], quant_ref=ref, chunk_elems=CHUNK,
                              masked=True, labels=parties, device=CPU)
    agg.add_local(1, mts["bob"])
    agg.add_local(0, mts["alice"])
    assert _raw(agg.result(timeout=60).buf) == _raw(want.buf)


@pytest.mark.parametrize("dropped", [["dave"], ["bob", "dave"]])
def test_dropout_recovery_correction_equals_the_reference(dropped):
    """A quorum cutoff with one or two dropped parties: the survivors' seeds
    expand exactly the orphaned masks (pairwise and the members'
    self-masks), the correction is the JAX package's bytes, and the
    corrected fold equals the unmasked subset fold."""
    keys = _keyring()
    weights = [2.0, 1.0, 3.0, 1.0]
    grids, ref, ups, qts = _round_fixture(weights)
    mts, maskers = _masked(keys, grids, ref, ups, dict(zip(PARTIES, weights)), r=2, self_mask=True)
    members = [p for p in PARTIES if p not in dropped]
    recoveries = []

    def hook(member_labels):
        assert member_labels == members
        drop = sorted(set(PARTIES) - set(member_labels))
        seeds = {p: maskers[p].recovery_seeds(drop) for p in member_labels}
        self_seeds = {p: maskers[p].self_seed_hex() for p in member_labels}
        corr = sa.mask_correction(seeds, drop, N_ELEMS, keys["alice"].prg_scheme, members=member_labels,
                                  self_seeds=self_seeds)
        want_corr = jsa.mask_correction(seeds, drop, N_ELEMS, keys["alice"].prg_scheme, members=member_labels,
                                        self_seeds=self_seeds)
        assert corr.tobytes() == want_corr.tobytes()
        recoveries.append(drop)
        return corr

    agg = StreamingAggregator(4, weights=weights, quant=grids["torch"], quant_ref=ref, chunk_elems=CHUNK,
                              masked=True, labels=PARTIES, quorum=len(members), mask_recovery=hook, device=CPU)
    for p in members:
        agg.add_local(PARTIES.index(p), mts[p])
    res = agg.result(timeout=60, deadline_s=0.5)
    want = jf.packed_quantized_sum([qts[p] for p in members], [weights[PARTIES.index(p)] for p in members], ref=ref)
    assert _raw(res.buf) == _raw(want.buf)
    assert recoveries == [dropped]
    assert agg.quorum_members == [PARTIES.index(p) for p in members]


def test_passthrough_leaves_refused_unmasked():
    keys = _keyring(["alice", "bob"])
    grids, ref, _, _ = _round_fixture(None, parties=["alice", "bob"])
    packed = tc.compress({"w": torch.from_numpy(ref.copy()), "step": torch.tensor(7, dtype=torch.int32)},
                         packed=True, wire_dtype=torch.float32)
    assert packed.passthrough
    m = sa.RoundMasker(keys["alice"], "alice", ["bob"], session="s", stream="f", round_index=0)
    with pytest.raises(sa.SecAggError, match="UNMASKED"):
        sa.MaskedRoundCodec(grids["torch"], ref, None, m).to_wire(packed)
    with pytest.raises(sa.SecAggError, match="requires the shared quantization"):
        sa.MaskedRoundCodec(None, ref, None, m)


def test_excluded_straggler_stays_noise_after_recovery():
    """Double masking closes the straggler attack: with every pairwise seed
    toward an excluded party recovered, its late payload minus all the
    coordinator can rebuild still differs by PRG(b)."""
    keys = _keyring()
    grids, ref, ups, qts = _round_fixture(None)
    mts, maskers = _masked(keys, grids, ref, ups, {p: 1 for p in PARTIES}, r=3, self_mask=True)
    straggler = "dave"
    members = [p for p in PARTIES if p != straggler]
    known = np.zeros(N_ELEMS, np.uint32)
    for p in members:
        ks = sa.prg_mask(bytes.fromhex(maskers[p].recovery_seeds([straggler])[straggler]), N_ELEMS,
                         keys[p].prg_scheme)
        if straggler < p:
            known += ks
        else:
            known -= ks
    leaked = (mts[straggler].buf.view(np.uint32)
              - np.asarray(qts[straggler].buf).astype(np.int64).astype(np.uint32) - known)
    want_b = sa.prg_mask(bytes.fromhex(maskers[straggler].self_seed_hex()), N_ELEMS, keys[straggler].prg_scheme)
    np.testing.assert_array_equal(leaked, want_b)
    assert np.count_nonzero(leaked) > N_ELEMS * 0.99
    other = sa.RoundMasker(keys[straggler], straggler, members, session="s", stream="f", round_index=3,
                           self_mask=True)
    assert other.self_seed_hex() != maskers[straggler].self_seed_hex()
    with pytest.raises(sa.SecAggError, match="no self-mask"):
        sa.RoundMasker(keys["alice"], "alice", ["bob"], session="s", stream="f", round_index=0).self_seed_hex()


def test_mask_correction_survivor_coverage_validated():
    keys = _keyring(["alice", "bob", "carol"])
    maskers = {p: sa.RoundMasker(keys[p], p, [q for q in ("alice", "bob", "carol") if q != p],
                                 session="s", stream="f", round_index=0) for p in ("alice", "bob")}
    seeds = {p: m.recovery_seeds(["carol"]) for p, m in maskers.items()}
    ok = sa.mask_correction(seeds, ["carol"], 16, keys["alice"].prg_scheme, members=["alice", "bob"])
    assert ok.shape == (16,)
    assert ok.tobytes() == jsa.mask_correction(seeds, ["carol"], 16, keys["alice"].prg_scheme,
                                               members=["alice", "bob"]).tobytes()
    with pytest.raises(sa.SecAggError, match="pinned member set"):
        sa.mask_correction({"alice": seeds["alice"]}, ["carol"], 16, keys["alice"].prg_scheme,
                           members=["alice", "bob"])
    with pytest.raises(sa.SecAggError, match="not a mask peer"):
        maskers["alice"].recovery_seeds(["erin"])


def test_mask_correction_missing_seed_fails_loudly():
    keys = _keyring(["alice", "bob", "carol"])
    m = sa.RoundMasker(keys["alice"], "alice", ["bob", "carol"], session="s", stream="f", round_index=0)
    with pytest.raises(sa.SecAggError, match="no seed toward"):
        sa.mask_correction({"alice": {}, "bob": {}}, ["carol"], 16)
    with pytest.raises(sa.SecAggError, match="no self-mask seed"):
        sa.mask_correction({"alice": {}}, [], 16, members=["alice"], self_seeds={})
    corr = sa.mask_correction({"alice": m.recovery_seeds(["carol"])}, ["carol"], 16, keys["alice"].prg_scheme)
    assert corr.dtype == np.uint32 and corr.shape == (16,)


def test_masked_unmasked_mode_guards():
    keys = _keyring()
    grids, ref, ups, qts = _round_fixture(None)
    mts, _ = _masked(keys, grids, ref, ups, {p: 1 for p in PARTIES})
    agg = StreamingAggregator(4, quant=grids["torch"], quant_ref=ref, chunk_elems=CHUNK, masked=True, device=CPU)
    agg.add_local(0, qz.quantize_packed(ups["torch"]["alice"], grids["torch"], ref=ref))
    with pytest.raises(TypeError, match="unmasked contribution"):
        agg.result(timeout=10)
    agg2 = StreamingAggregator(4, quant=grids["torch"], quant_ref=ref, chunk_elems=CHUNK, device=CPU)
    agg2.add_local(0, mts["alice"])
    with pytest.raises(TypeError, match="MaskedCodeTree"):
        agg2.result(timeout=10)
    with pytest.raises(ValueError, match="masked aggregation requires"):
        StreamingAggregator(2, masked=True, device=CPU)
    with pytest.raises(ValueError, match="mask_recovery"):
        StreamingAggregator(2, mask_recovery=lambda m: None, device=CPU)
    with pytest.raises(ValueError, match="presummed and masked"):
        StreamingAggregator(2, quant=grids["torch"], quant_ref=ref, chunk_elems=CHUNK, masked=True,
                            presummed="int32", device=CPU)
    with pytest.raises(sa.SecAggError, match="already masked"):
        sa.MaskedRoundCodec(grids["torch"], ref, None, sa.RoundMasker(
            keys["alice"], "alice", ["bob"], session="s", stream="f", round_index=0)).to_wire(mts["alice"])


def _encode_bytes(mod, value):
    return b"".join(bytes(b.produce()) if isinstance(b, mod.LazyBuffer) else bytes(b)
                    for b in mod.encode_payload(value))


def test_masked_tree_refuses_decode_and_pickles_both_ways():
    """A ``MaskedCodeTree`` refuses to decode; the port's payload is the JAX
    package's bytes, and each package decodes the other's into its own
    class (the port's under the reference's module path)."""
    keys = _keyring(["alice", "bob"])
    grids, ref, ups, _ = _round_fixture(None, parties=["alice", "bob"])
    mts, _ = _masked(keys, grids, ref, ups, {"alice": 1, "bob": 1}, parties=["alice", "bob"])
    jmts, _ = _masked(keys, grids, ref, ups, {"alice": 1, "bob": 1}, parties=["alice", "bob"], pkg="jax")
    mt, jmt = mts["alice"], jmts["alice"]
    assert mt.buf.dtype == np.int32 and mt.spec.wire_dtype == "int32"
    with pytest.raises(sa.SecAggError, match="ring noise"):
        mt.dequantize(np.float32, ref=ref)
    with pytest.raises(sa.SecAggError):
        mt.unpack()
    blob, jblob = _encode_bytes(wire, mt), _encode_bytes(jwire, jmt)
    assert blob == jblob
    back = jwire.decode_payload(blob)
    assert isinstance(back, jsa.MaskedCodeTree) and back.gmeta == jmt.gmeta
    np.testing.assert_array_equal(np.asarray(back.buf), np.asarray(jmt.buf))
    mine = wire.decode_payload(jblob)
    assert isinstance(mine, sa.MaskedCodeTree) and tuple(mine.gmeta) == tuple(jmt.gmeta)
    assert _raw(mine.buf) == _raw(mt.buf)


def test_recovery_message_schema_equals_the_reference():
    req = sa.make_recovery_request(["b", "a"], ["c"])
    assert req == jsa.make_recovery_request(["b", "a"], ["c"]) and req["m"] == ["a", "b"]
    assert sa.check_recovery_message(req, "request") is req
    rep = sa.make_recovery_reply("a", {"c": "00" * 32}, "11" * 32)
    assert rep == jsa.make_recovery_reply("a", {"c": "00" * 32}, "11" * 32)
    assert sa.check_recovery_message(rep, "reply") is rep
    for bad, match in (({"v": 1, "m": []}, "missing field"), ({"v": 99, "m": [], "dr": []}, "schema v99"),
                       ({"v": "2.x", "m": [], "dr": []}, "non-integer version"), ([], "malformed")):
        with pytest.raises(sa.SecAggError, match=match):
            sa.check_recovery_message(bad, "request")
        with pytest.raises(jsa.SecAggError, match=match):
            jsa.check_recovery_message(bad, "request")
    with pytest.raises(sa.SecAggError, match="not a hex seed"):
        sa.mask_correction({"a": {"c": "zz"}}, ["c"], 8, members=["a"])


def test_fixed_point_primitives_equal_the_reference():
    """``mask_update`` gives the JAX package's uint32 words; ``unmask_sum``
    the reference's float sum; the shim warns and re-exports them."""
    parties = ["alice", "bob", "carol"]
    rng = np.random.default_rng(1)
    trees = {p: {"a": rng.normal(size=(3, 5)).astype(np.float32) * 4, "b": rng.normal(size=7).astype(np.float32)}
             for p in parties}
    jm, tm = {}, {}
    for p in parties:
        kw = dict(party=p, parties=parties, round_num=5, group_key=GROUP_KEY, clip=8.0, frac_bits=16)
        jm[p] = jsa.mask_update({k: jnp.asarray(v) for k, v in trees[p].items()}, **kw)
        tm[p] = sa.mask_update({k: torch.from_numpy(v) for k, v in trees[p].items()}, **kw)
        for k in trees[p]:
            assert tm[p][k].dtype == torch.uint32 and _raw(tm[p][k]) == _raw(jm[p][k]), (p, k)
    want = jsa.unmask_sum([jm[p] for p in parties])
    got = sa.unmask_sum([tm[p] for p in parties])
    for k in want:
        assert _raw(got[k]) == _raw(want[k]), k
    with pytest.raises(ValueError, match="overflow the ring"):
        sa.unmask_sum([tm["alice"]] * 3, clip=2**15)
    with pytest.raises(ValueError, match="not in"):
        sa.mask_update(trees["alice"], party="erin", parties=parties, round_num=0, group_key=GROUP_KEY)
    import importlib
    import sys

    sys.modules.pop("rayfed_tpu_torch.fl.secure", None)
    with pytest.warns(DeprecationWarning, match="rayfed_tpu_torch.fl.secagg"):
        secure = importlib.import_module("rayfed_tpu_torch.fl.secure")
    assert secure.mask_update is sa.mask_update and secure.unmask_sum is sa.unmask_sum


# -- the round loops' verdicts ----------------------------------------------------

SECURE_CASES = [
    dict(streaming_agg=True, secure_agg=True),
    dict(mode="ring", wire_quant="uint8", secure_agg=True),
    dict(streaming_agg=True, wire_quant="uint8", secure_agg=True, sample=1),
    dict(mode="hierarchy", region_size=1, wire_quant="uint8", secure_agg=True),
    dict(overlap=True, wire_quant="uint8", secure_agg=True),
    dict(streaming_agg=True, wire_quant="uint8", secure_agg=True, server_opt="packed"),
    dict(quorum=2, round_deadline_s=5.0, wire_quant="uint8", secure_agg=True),
    dict(streaming_agg=True, wire_quant="uint8", secure_agg=True),
]


def _verdict(validate, trainers, kw):
    try:
        return ("ok", validate(trainers, **kw))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("kw", SECURE_CASES, ids=lambda kw: ",".join(f"{k}" for k in sorted(kw)))
def test_secure_agg_verdicts_equal_the_reference(kw):
    from rayfed_tpu.fl import server_opt as jso
    from rayfed_tpu.fl import trainer as jtrainer
    from rayfed_tpu_torch.fl import server_opt as tso
    from rayfed_tpu_torch.fl import trainer as ttrainer

    trainers = {"alice": None, "bob": None}
    base = dict(compress_wire=True, packed_wire=True)
    jkw, tkw = dict(base, **kw), dict(base, **kw)
    if kw.get("server_opt") == "packed":
        jkw["server_opt"], tkw["server_opt"] = jso.fedac(1.0, 3.0, 0.5), tso.fedac(1.0, 3.0, 0.5)
    assert _verdict(ttrainer.validate_round_config, trainers, tkw) == \
        _verdict(jtrainer.validate_round_config, trainers, jkw)


def test_quorum_secagg_refusals_equal_the_reference():
    from rayfed_tpu_torch.fl.quorum import QuorumRoundError, quorum_aggregate

    rt = types.SimpleNamespace(party="alice", job_config=types.SimpleNamespace(recv_backstop_s=1))
    kw = dict(session="s", round_index=0, quorum=1, deadline_s=None, coordinator="alice", stream="f", epoch=0)
    with pytest.raises(QuorumRoundError, match="requires the quantized domain"):
        quorum_aggregate(rt, {"alice": None}, None, secagg=object(), **kw)
    with pytest.raises(QuorumRoundError, match="server_step does not compose"):
        quorum_aggregate(rt, {"alice": None}, None, secagg=object(), server_step=lambda r: r, **kw)


# -- key exchange and masked rounds over the transport (in process) ------------------


def _manager(pkg, party, ports):
    if pkg == "jax":
        from rayfed_tpu.config import ClusterConfig, JobConfig, PartyConfig
        from rayfed_tpu.transport.manager import TransportManager

        kw = {}
    else:
        from rayfed_tpu_torch.config import ClusterConfig, JobConfig, PartyConfig
        from rayfed_tpu_torch.transport.manager import TransportManager

        kw = {"device": CPU}
    cc = ClusterConfig(parties={p: PartyConfig.from_dict({"address": f"127.0.0.1:{port}"})
                                for p, port in ports.items()}, current_party=party)
    return TransportManager(cc, JobConfig(device_put_received=False, zero_copy_host_arrays=True,
                                          cross_silo_timeout_s=20), **kw)


class _Cluster:
    """In-process virtual parties, one TransportManager each (``jax``: the
    parties on the JAX package), sharing one group key."""

    def __init__(self, parties, jax=()):
        self.parties = list(parties)
        self.jax = set(jax)
        ports = dict(zip(self.parties, get_free_ports(len(self.parties))))
        self.mgrs = {p: _manager("jax" if p in self.jax else "torch", p, ports) for p in self.parties}
        for m in self.mgrs.values():
            m.start()
            m.secagg_keys.set_group_key(GROUP_KEY)

    def pkg(self, p):
        return "jax" if p in self.jax else "torch"

    def stop(self):
        threads = [threading.Thread(target=m.stop, daemon=True) for m in self.mgrs.values()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)


def test_hello_key_exchange_over_transport_between_the_packages():
    """One ping establishes the pair both ways, between a port manager and
    a JAX manager, and both derive the same seed."""
    c = _Cluster(["alice", "bob"], jax=["bob"])
    try:
        a, b = c.mgrs["alice"], c.mgrs["bob"]
        assert not a.secagg_keys.has_peer("bob")
        a.ensure_secagg_peer_keys(["bob"], timeout_s=20)
        assert a.secagg_keys.has_peer("bob") and b.secagg_keys.has_peer("alice")
        st = a.get_stats()["secagg"]
        assert "bob" in st["peers"] and st["kex"] in ("x25519", "nonce")
        kw = dict(session="s", stream="f", round_index=0)
        assert a.secagg_keys.pair_seed("bob", **kw) == b.secagg_keys.pair_seed("alice", **kw)
    finally:
        c.stop()


class _Update:
    """A FedObject stand-in: the party's own contribution, already resolved."""

    def __init__(self, ref):
        self._ref = ref

    def get_local_ref(self):
        return self._ref


def _run_quorum_round(cluster, ups, grids, ref, *, weights, quorum, deadline_s, dead=(), r=1, session="q"):
    """One masked ``quorum_aggregate`` on every live party's thread, each
    on its package, through a shim runtime over its bare manager.  Returns
    ({party: (result buf bytes, members)}, {party: exception})."""
    from rayfed_tpu.executor import LocalRef as JLocalRef
    from rayfed_tpu.fl import quorum as JQ
    from rayfed_tpu_torch.executor import LocalRef
    from rayfed_tpu_torch.fl import quorum as TQ

    results, errors = {}, {}
    live = [p for p in cluster.parties if p not in dead]
    for p in live:
        cluster.mgrs[p].ensure_secagg_peer_keys(cluster.parties, timeout_s=20)

    def run_party(p):
        pkg = cluster.pkg(p)
        mgr = cluster.mgrs[p]
        rt = types.SimpleNamespace(
            party=p, transport=mgr, send_proxy=mgr, recv_proxy=mgr,
            cluster_config=types.SimpleNamespace(serializing_allowed_list=None),
            job_config=types.SimpleNamespace(recv_backstop_s=30),
        )
        ref_cls, mod = (JLocalRef, JQ) if pkg == "jax" else (LocalRef, TQ)
        updates = {q: _Update(ref_cls.from_value(ups[pkg][q]) if q == p else None) for q in cluster.parties}
        try:
            out = mod.quorum_aggregate(
                rt, updates, weights, session=session, round_index=r, quorum=quorum, deadline_s=deadline_s,
                coordinator=cluster.parties[0], stream="fedavg", epoch=0, backstop=30,
                quant=grids[pkg], quant_ref=ref, quant_scope=None, secagg=mgr.secagg_keys,
            )
            results[p] = (_raw(out.result.buf), list(out.members))
        except BaseException as e:
            errors[p] = e

    threads = [threading.Thread(target=run_party, args=(p,), daemon=True) for p in live]
    for t in threads:
        t.start()
    for t in threads:
        t.join(90)
    assert not any(t.is_alive() for t in threads), "a party thread hung"
    return results, errors


@pytest.mark.parametrize("jax_parties", [(), ("bob", "dave")], ids=["port", "mixed"])
def test_masked_quorum_round_with_a_dropout_equals_the_reference(jax_parties):
    """Four in-process parties, dave dropped: the coordinator's cutoff pins
    {alice, bob, carol}, recovers dave's masks from the members' replies,
    and every member holds the bytes of the all-JAX round (the unmasked
    subset fold, re-quantized for the downlink)."""
    from rayfed_tpu.fl.secagg import SECAGG_STATS as JSTATS

    weights = {p: float(w) for p, w in zip(PARTIES, [2, 1, 3, 1])}
    grids, ref, ups, _ = _round_fixture(None)
    all_jax = _Cluster(PARTIES, jax=PARTIES)
    try:
        want, errors = _run_quorum_round(all_jax, ups, grids, ref, weights=weights, quorum=3, deadline_s=1.0,
                                         dead=["dave"])
        assert not errors, errors
    finally:
        all_jax.stop()
    assert JSTATS["mask_recoveries"] >= 1
    before = sa.SECAGG_STATS["mask_recoveries"]
    c = _Cluster(PARTIES, jax=jax_parties)
    try:
        results, errors = _run_quorum_round(c, ups, grids, ref, weights=weights, quorum=3, deadline_s=1.0,
                                            dead=["dave"])
        assert not errors, errors
    finally:
        c.stop()
    for p in ("alice", "bob", "carol"):
        assert results[p] == want["alice"], p
        assert results[p][1] == ["alice", "bob", "carol"]
    assert sa.SECAGG_STATS["mask_recoveries"] == before + 1  # alice coordinates on the port


def test_masked_quorum_round_all_arrived_equals_the_unmasked_round():
    """No dropout: the announcement names every member, each replies with
    its self-mask seed only, and the bytes equal the unmasked round's."""
    weights = {p: 1.0 for p in PARTIES}
    grids, ref, ups, _ = _round_fixture(None)
    c = _Cluster(PARTIES)
    try:
        masked, errors = _run_quorum_round(c, ups, grids, ref, weights=weights, quorum=4, deadline_s=None)
        assert not errors, errors
    finally:
        c.stop()
    from rayfed_tpu.fl.quantize import quantize_downlink

    jq = [jqz.quantize_packed(ups["jax"][p], grids["jax"], ref=ref) for p in PARTIES]
    unmasked = jf.packed_quantized_sum(jq, [1.0] * 4, ref=ref)
    _, want, _ = quantize_downlink(unmasked, grids["jax"], ref, None)
    for p in PARTIES:
        assert masked[p][0] == _raw(want.buf), p


# -- one party-process run: the packages mixed, a crash, mask recovery ---------------

DIM = 2048
DELTAS = {"alice": 0.25, "bob": 0.5, "carol": 1.0, "dave": 2.0}
MIXED_ROUNDS = 4


def _run_mixed_party(party, cluster, outdir, jax_parties):
    os.environ["RAYFED_SECAGG_GROUP_KEY"] = "mixed-test-key"
    if party in jax_parties:
        import rayfed_tpu as fed
        from rayfed_tpu import chaos
        from rayfed_tpu.fl import compression as C
        from rayfed_tpu.fl.quantize import reset_compressors
        from rayfed_tpu.fl.secagg import SECAGG_STATS

        dt, zeros, kw = jnp.float32, jnp.zeros((DIM,), jnp.float32), {}
    else:
        import rayfed_tpu_torch as fed
        from rayfed_tpu_torch import chaos
        from rayfed_tpu_torch.fl import compression as C
        from rayfed_tpu_torch.fl.quantize import reset_compressors
        from rayfed_tpu_torch.fl.secagg import SECAGG_STATS

        dt, zeros, kw = torch.float32, torch.zeros(DIM), {"device": CPU}
    chaos.install({"seed": 7, "rules": [
        # dave crashes after round 1: round 2's cutoff pins the three
        # survivors and recovers his masks.
        {"hook": "round", "party": "dave", "match": {"round": 2}, "op": "crash_party"},
    ]})
    fed.init(address="local", cluster=cluster, party=party, enable_waiting_for_other_parties_ready=True,
             peer_health_interval_in_seconds=1.0, peer_death_pings=3, cross_silo_timeout_in_seconds=15,
             cross_silo_retry_policy={"maxAttempts": 2, "initialBackoff": "0.2s", "maxBackoff": "0.5s"},
             recv_backstop_in_seconds=60, **kw)

    @fed.remote
    class Trainer:
        def __init__(self, delta):
            self._d = float(delta)

        def train(self, params):
            tree = C.decompress(params, dt)
            return C.compress({"w": tree["w"] + self._d * 1e-2}, packed=True, wire_dtype=dt)

    trainers = {p: Trainer.party(p).remote(DELTAS[p]) for p in PARTIES}
    base = dict(compress_wire=True, packed_wire=True, wire_dtype=dt, wire_quant="uint8")
    report = {"crashed": False}
    # The streaming rounds (all four parties), plain then masked, from the
    # same codec state.
    for name, extra in (("stream_plain", {}), ("stream_secure", {"secure_agg": True})):
        reset_compressors()
        out = fed.fl.run_fedavg_rounds(trainers, {"w": zeros}, rounds=3, streaming_agg=True, **base, **extra)
        report[name] = _host_hex(out["w"])
    report["stream_masked_rounds"] = int(SECAGG_STATS["masked_rounds"])
    reset_compressors()
    log: list = []
    try:
        final = fed.fl.run_fedavg_rounds(
            trainers, {"w": zeros}, rounds=MIXED_ROUNDS, secure_agg=True, quorum=3, round_deadline_s=3.0,
            round_log=log, coordinator="alice", **base,
        )
    except chaos.ChaosPartyCrash:
        with open(os.path.join(outdir, f"{party}.json"), "w") as f:
            json.dump({"crashed": True}, f)
        os._exit(0)
    report.update(final=_host_hex(final["w"]), members=[e["members"] for e in log],
                  mask_recoveries=int(SECAGG_STATS["mask_recoveries"]),
                  masked_rounds=int(SECAGG_STATS["masked_rounds"]))
    with open(os.path.join(outdir, f"{party}.json"), "w") as f:
        json.dump(report, f)
    fed.shutdown()


def _host_hex(w):
    return np.asarray(w.numpy() if isinstance(w, torch.Tensor) else w, np.float32).tobytes().hex()


def _mixed_run(tmp_path, jax_parties):
    outdir = tmp_path / ("mixed" if len(jax_parties) < len(PARTIES) else "alljax")
    outdir.mkdir()
    cluster = make_cluster(PARTIES)
    cluster["dave"]["transport_options"] = {"heartbeat_interval_s": 0.3, "death_deadline_s": 0.9}
    run_parties(_run_mixed_party, PARTIES, args=(cluster, str(outdir), tuple(jax_parties)), timeout=150)
    return {p: json.loads((outdir / f"{p}.json").read_text()) for p in PARTIES}


def test_masked_rounds_mixing_the_packages_equal_the_all_jax_run(tmp_path):
    """alice on the JAX package, bob, carol and dave on the port.  Three
    streaming rounds, plain and masked, give the same bytes; then masked
    quorum rounds in which dave crashes after round 1: round 2 finalizes
    through mask recovery at alice.  Every party's bytes equal the all-JAX
    run's."""
    mixed = _mixed_run(tmp_path, ["alice"])
    ref = _mixed_run(tmp_path, PARTIES)
    for p in ("alice", "bob", "carol"):
        assert mixed[p]["stream_secure"] == mixed[p]["stream_plain"] == ref[p]["stream_secure"], p
    for rep in (mixed, ref):
        assert rep["dave"]["crashed"]
        survivors = {p: r for p, r in rep.items() if not r["crashed"]}
        assert sorted(survivors) == ["alice", "bob", "carol"]
        assert len({r["final"] for r in survivors.values()}) == 1
        assert survivors["alice"]["members"][2] == ["alice", "bob", "carol"]
        assert survivors["alice"]["mask_recoveries"] >= 1
        assert all(r["masked_rounds"] >= MIXED_ROUNDS - 1 + 2 for r in survivors.values())
    assert mixed["bob"]["final"] == ref["bob"]["final"]


# -- the wire lock -----------------------------------------------------------------------


def test_secagg_section_holds_the_wire_format_lock(monkeypatch):
    """``tool/wire_format.lock``'s secagg entries (the HELLO key, the
    version, the recovery request and reply schemas): the lock's
    fingerprint, recomputed with the port's ``fl.secagg`` producers and its
    ``transport.secagg`` version in place of the JAX package's, is still
    the pinned one."""
    import pathlib

    from rayfed_tpu.transport import secagg as jtsa
    from rayfed_tpu_torch.transport import secagg as ttsa
    from tool import check_wire_format

    monkeypatch.setattr(jsa, "make_recovery_request", sa.make_recovery_request)
    monkeypatch.setattr(jsa, "make_recovery_reply", sa.make_recovery_reply)
    monkeypatch.setattr(jtsa, "SECAGG_VERSION", ttsa.SECAGG_VERSION)
    monkeypatch.setattr(jwire, "SECAGG_PUB_KEY", wire.SECAGG_PUB_KEY)
    lock = json.loads((pathlib.Path(check_wire_format.__file__).parent / "wire_format.lock").read_text())
    assert check_wire_format.compute_fingerprint() == lock["fingerprint"]
