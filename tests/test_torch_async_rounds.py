"""The port's buffered asynchronous rounds (``fl/async_rounds.py``) against
the JAX package's, after ``tests/test_async_rounds.py``.

The buffer folds integer codes in i32 and ends in the one rescale every
synchronous topology ends in, so every emitted version is held to byte
identity with a sorted-order ``packed_quantized_sum`` refold of its
recorded folds, through the port's refold and the JAX package's.  The
fleets are the reference's own harness: in-process virtual parties, one
thread each over bare ``TransportManager``\\s on loopback, no party
processes; the mixed fleets put a JAX coordinator beside port members and a
port coordinator beside JAX members.
"""

import collections
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rayfed_tpu.fl import async_rounds as jar
from rayfed_tpu.fl import compression as jc
from rayfed_tpu.fl import fedavg as jf
from rayfed_tpu.fl import quantize as jqz
from rayfed_tpu.transport import wire as jwire
from rayfed_tpu_torch import chaos, telemetry
from rayfed_tpu_torch.fl import async_rounds as ar
from rayfed_tpu_torch.fl import compression as tc
from rayfed_tpu_torch.fl import fedavg as tf
from rayfed_tpu_torch.fl import quantize as qz
from rayfed_tpu_torch.fl.server_opt import fedac
from rayfed_tpu_torch.transport import wire
from rayfed_tpu_torch.utils.ports import free_loopback_ports

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean_state():
    for mod in (ar, jar):
        mod.reset_async_stats()
    qz.reset_compressors()
    jqz.reset_compressors()
    yield
    chaos.uninstall()
    telemetry.uninstall()
    for mod in (ar, jar):
        mod.reset_async_stats()
    qz.reset_compressors()
    jqz.reset_compressors()


def _raw(x):
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _payload(bufs):
    return b"".join(
        bytes(b) if isinstance(b, (bytes, bytearray)) else bytes(memoryview(b).cast("B"))
        for b in bufs
    )


def _params(d=500, seed=7):
    rng = np.random.default_rng(seed)
    return {"x": np.linspace(-1.0, 1.0, d, dtype=np.float32), "y": rng.standard_normal(7).astype(np.float32)}


def _template(d=500, seed=7):
    """The reference test's model in both packages: (port params, port
    template, JAX template, the f32 buffer)."""
    p = _params(d, seed)
    tparams = {k: torch.from_numpy(v) for k, v in p.items()}
    tmpl = tc.pack_tree(tparams, torch.float32)
    jtmpl = jc.pack_tree({k: jnp.asarray(v) for k, v in p.items()}, jnp.float32)
    return tparams, tmpl, jtmpl, tmpl.buf.numpy().copy()


# -- the exact integer decay ----------------------------------------------------------


def test_decay_weight_is_exact_integer_shift():
    cases = [(64, 0, 8), (64, 3, 8), (1, 1, 8), (1 << 20, 8, 8), (1 << 20, 99, 8), (1 << 20, 3, 2)]
    for w, s, cap in cases:
        assert ar.decay_weight(w, s, cap) == jar.decay_weight(w, s, cap) == w >> min(s, cap)
    assert ar.decay_weight(64, 3) == 8 and ar.decay_weight(1, 1) == 0
    assert ar.DEFAULT_STALENESS_CAP == jar.DEFAULT_STALENESS_CAP
    assert ar.DEFAULT_BUFFER_K == jar.DEFAULT_BUFFER_K
    assert set(ar.ASYNC_STATS) == set(jar.ASYNC_STATS)
    with pytest.raises(ValueError, match="integral weights"):
        ar.decay_weight(1.5, 0)
    with pytest.raises(ValueError, match="integral weights"):
        ar.decay_weight(-2, 0)
    with pytest.raises(ValueError, match="never negative"):
        ar.decay_weight(4, -1)


def test_bootstrap_grid_is_negotiation_free():
    """The version-0 abs grid is the JAX package's, byte for byte, from a
    tensor or an array."""
    _, _, _, buf = _template()
    g1 = ar.bootstrap_grid(buf.copy(), "uint8", 64)
    g2 = ar.bootstrap_grid(torch.from_numpy(buf.copy()), "uint8", 64)
    jg = jar.bootstrap_grid(buf.copy(), "uint8", 64)
    assert g1.mode == jg.mode == "abs"
    assert g1.fingerprint() == g2.fingerprint() == jg.fingerprint()
    assert _raw(g1.scales) == _raw(jg.scales) and _raw(g1.zps) == _raw(jg.zps)
    assert g1.fingerprint() != ar.bootstrap_grid(buf + np.float32(0.5), "uint8", 64).fingerprint()
    with pytest.raises(ValueError, match="all-constant"):
        ar.bootstrap_grid(np.zeros(256, np.float32), "uint8", 64)


# -- the running buffer ---------------------------------------------------------------


def _coded_set(tmpl, ref, n=9, seed=0, ce=64):
    rng = np.random.default_rng(seed)
    grid = qz.make_round_grid((1e-2 * rng.standard_normal(ref.size)).astype(np.float32),
                              chunk_elems=ce, wire_dtype="uint8", mode="delta")
    qts, ws, ss = [], [], []
    for _ in range(n):
        contrib = tc.PackedTree(torch.from_numpy(ref + (1e-2 * rng.standard_normal(ref.size)).astype(np.float32)),
                                tmpl.passthrough, tmpl.spec)
        qts.append(qz.quantize_packed(contrib, grid, ref=ref))
        ws.append(int(rng.integers(1, 64)))
        ss.append(int(rng.integers(0, 5)))
    return grid, qts, ws, ss


def _to_jax(qt):
    """A port QuantizedPackedTree as the JAX package reads it off the wire."""
    return jwire.decode_payload(_payload(wire.encode_payload(qt)), allowed={})


def _jax_refold(qts, ws, ref):
    return np.asarray(jf.packed_quantized_sum([_to_jax(q) for q in qts], ws, ref=ref).buf)


def test_async_buffer_adversarial_order_refold_identity():
    """Any arrival order folds to the bytes of the sorted-order refold at
    the decayed weights (the port's and the JAX package's), with some
    contributions decayed out entirely."""
    _, tmpl, _, ref = _template()
    grid, qts, ws, ss = _coded_set(tmpl, ref)
    ws[0], ss[0] = 1, 3  # decays to zero
    w_effs = [ar.decay_weight(w, s) for w, s in zip(ws, ss)]
    keep = [i for i, w in enumerate(w_effs) if w > 0]
    assert 0 < len(keep) < len(qts)
    oracle = tf.packed_quantized_sum([qts[i] for i in keep], [w_effs[i] for i in keep], ref=ref).buf
    assert _raw(oracle) == _raw(_jax_refold([qts[i] for i in keep], [w_effs[i] for i in keep], ref))
    orders = [list(range(len(qts))), list(reversed(range(len(qts))))] + [
        list(np.random.default_rng(k).permutation(len(qts))) for k in range(3)
    ]
    for order in orders:
        buf = ar.AsyncBuffer(grid, ref, tmpl, device=CPU)
        for i in order:
            assert buf.fold(qts[i], ws[i], ss[i]) == w_effs[i]
        assert buf.occupancy == len(keep)
        assert buf.total_weight == sum(w_effs)
        out = buf.finalize(np.float32)
        assert out.spec.wire_dtype == "float32"
        assert _raw(out.buf) == _raw(oracle)
    # The JAX package's buffer over the same codes gives the same bytes.
    jbuf = jar.AsyncBuffer(_to_jax(qts[0]).grid(), ref,
                           jc.pack_tree({"x": jnp.zeros(500), "y": jnp.zeros(7)}, jnp.float32))
    for i in range(len(qts)):
        jbuf.fold(_to_jax(qts[i]), ws[i], ss[i])
    assert _raw(jbuf.finalize(np.float32).buf) == _raw(oracle)


def test_async_buffer_reset_rotates_grid_in_place():
    _, tmpl, _, ref = _template()
    grid, qts, ws, ss = _coded_set(tmpl, ref)
    buf = ar.AsyncBuffer(grid, ref, tmpl, device=CPU)
    for qt, w, s in zip(qts, ws, ss):
        buf.fold(qt, w, s)
    first = buf.finalize(np.float32).buf.numpy().copy()
    acc = buf._acc
    grid2, qts2, ws2, _ = _coded_set(tmpl, first, seed=1)
    buf.reset(grid2, first)
    assert buf.occupancy == 0 and buf._acc.numel() == acc.numel()
    for qt, w in zip(qts2, ws2):
        buf.fold(qt, w, 0)
    oracle2 = tf.packed_quantized_sum(qts2, ws2, ref=first).buf
    assert _raw(buf.finalize(np.float32).buf) == _raw(oracle2) == _raw(_jax_refold(qts2, ws2, first))


def test_async_buffer_guards():
    _, tmpl, _, ref = _template()
    grid, qts, ws, _ = _coded_set(tmpl, ref)
    buf = ar.AsyncBuffer(grid, ref, tmpl, device=CPU)
    other = qz.make_round_grid(np.full(ref.size, 0.5, np.float32), chunk_elems=64, wire_dtype="uint8",
                               mode="delta")
    alien = qz.quantize_packed(tc.PackedTree(torch.from_numpy(ref.copy()), tmpl.passthrough, tmpl.spec),
                               other, ref=ref)
    with pytest.raises(ValueError, match="re-code through the shared"):
        buf.fold(alien, 1, 0)
    with pytest.raises(ValueError, match="integer-fold overflow"):
        buf.fold(qts[0], (2**31 - 1) // grid.qabs_max + 1, 0)
    assert buf.occupancy == 0 and not bool(buf._acc.any())
    with pytest.raises(ValueError, match="empty buffer"):
        buf.finalize()
    with pytest.raises(ValueError, match="shared reference buffer"):
        buf.reset(grid, None)
    with pytest.raises(TypeError, match="QuantizedPackedTree"):
        buf.fold(tc.PackedTree(torch.from_numpy(ref), tmpl.passthrough, tmpl.spec), 1, 0)
    wide = qz.make_round_grid(np.full(ref.size + 64, 0.5, np.float32), chunk_elems=64, wire_dtype="uint8",
                              mode="abs")
    with pytest.raises(ValueError, match="packed layout"):
        buf.reset(wide, None)


def test_async_buffer_accumulator_lives_on_its_device(monkeypatch):
    """The i32 accumulator lives on ``device``; without one the buffer asks
    for the card and raises where there is none."""
    _, tmpl, _, ref = _template()
    grid, _, _, _ = _coded_set(tmpl, ref)
    assert ar.AsyncBuffer(grid, ref, tmpl, device="cpu")._acc.device == CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ar.AsyncBuffer(grid, ref, tmpl)


# -- the fleet --------------------------------------------------------------------------


def _local_step(party, packed, version, cycle):
    seed = (sum(map(ord, party)) & 0xFFFF) * 1000 + version * 37 + cycle
    noise = (1e-3 * np.random.default_rng(seed).standard_normal(_n(packed))).astype(np.float32)
    if isinstance(packed.buf, torch.Tensor):
        buf = packed.buf.to(torch.float32)
        new = buf - 0.05 * (buf - 0.25) + torch.from_numpy(noise).to(buf.device)
        return tc.PackedTree(new, packed.passthrough, packed.spec)
    buf = np.asarray(packed.buf).astype(np.float32)
    new = buf - np.float32(0.05) * (buf - np.float32(0.25)) + noise
    return jc.PackedTree(new, packed.passthrough, packed.spec)


def _n(packed):
    return int(packed.buf.numel() if isinstance(packed.buf, torch.Tensor) else np.size(packed.buf))


def _check_version_refold(version_log, record_folds):
    """Each emitted version equals the sorted refold of its recorded
    ``(codes, w_eff)`` set, through the port's ``packed_quantized_sum`` and
    the JAX package's."""
    by_v = collections.defaultdict(list)
    for f in record_folds:
        if f["w_eff"] > 0:
            by_v[f["version"]].append(f)
    prev_model, checked = None, 0
    for rec in version_log:
        fold_set = sorted(by_v[rec["version"] - 1], key=lambda f: f["party"])
        assert fold_set, "an emitted version folded nothing"
        qts = [f["qt"] for f in fold_set]
        if not isinstance(qts[0], qz.QuantizedPackedTree):  # a JAX coordinator's folds
            qts = [wire.decode_payload(_payload(jwire.encode_payload(q)), allowed={}) for q in qts]
        ws = [f["w_eff"] for f in fold_set]
        ref = prev_model if qts[0].gmeta.mode == "delta" else None
        model = np.asarray(rec["model"])
        assert _raw(tf.packed_quantized_sum(qts, ws, ref=ref).buf) == _raw(model)
        assert _raw(_jax_refold(qts, ws, ref)) == _raw(model)
        prev_model = model
        checked += 1
    return checked


def test_async_fleet_version_refold_identity():
    """Real loopback transport, thread-scheduled arrival orders,
    heterogeneous weights and cycle counts, grid rotation every version and
    stale contributions re-coded: every version equals its sorted refold."""
    params, _, _, _ = _template(d=300)
    vlog, folds = [], []
    out = ar.run_async_fleet(
        ["coord", "a", "b", "c"], params, _local_step,
        cycles={"a": 5, "b": 5, "c": 3}, weights={"a": 8, "b": 16, "c": 32},
        buffer_k=3, chunk_elems=64, timeout_s=120,
        version_log=vlog, record_folds=folds, device="cpu",
    )
    assert out["versions"] == len(vlog) >= 3
    assert out["folds"] == sum(r["folds"] for r in vlog) == 13
    assert _check_version_refold(vlog, folds) == out["versions"]
    assert _raw(vlog[-1]["model"]) == _raw(out["w"])
    assert out["epoch"] == 3
    assert ar.ASYNC_STATS["recoded_stale"] > 0
    assert ar.ASYNC_STATS["versions_emitted"] == out["versions"]
    assert sum(ar.ASYNC_STATS["staleness_hist"].values()) == 13
    for r in out["party_results"].values():
        assert 0 < r["version"] <= out["versions"]


def test_async_fleet_chaos_straggler_spread():
    """A seeded ``local_slowdown`` makes one member a straggler; nothing is
    cut, every contribution folds, and the flight recorder's fold spans
    carry the staleness the JAX package's trace report aggregates."""
    params, _, _, _ = _template(d=200)
    chaos.install({"seed": 5, "rules": [{"hook": "local_step", "party": "b", "op": "local_slowdown",
                                         "value": [4.0, 10.0]}]})
    rec = telemetry.install("async_chaos_test")
    vlog, folds = [], []
    out = ar.run_async_fleet(
        ["coord", "a", "b"], params, _local_step, cycles=4, weights={"a": 16, "b": 16},
        buffer_k=2, chunk_elems=64, timeout_s=120, version_log=vlog, record_folds=folds, device="cpu",
    )
    assert out["folds"] == 8
    assert _check_version_refold(vlog, folds) == out["versions"]
    sched = chaos.installed()
    assert sched is not None and sched.rules[0].fired == 4
    fold_spans = [r for r in rec.records() if r.phase == "async.fold"]
    assert len(fold_spans) == 8
    for r in fold_spans:
        assert r.round is not None and "staleness" in r.detail and "w_eff" in r.detail
    assert [r for r in rec.records() if r.phase == "async.version"]
    assert [r for r in rec.records() if r.phase == "async.local"]
    from tool.trace_report import format_report, round_report

    recs = [r._asdict() for r in rec.records()]
    st_sections = [info["staleness"] for info in round_report(recs).values() if info["staleness"]]
    assert st_sections
    assert sum(s["folds"] for s in st_sections) == 8
    assert sum(s["weight_pushed"] for s in st_sections) == 8 * 16
    assert "staleness:" in format_report(recs)


def test_async_fleet_server_opt_composes():
    """The server step consumes each buffered mean; the emitted model is
    ``reference_step`` replayed from the recorded versions (the mean the
    buffer finalized, stepped from the replicated state)."""
    from rayfed_tpu_torch.fl.server_opt import PackedServerOptimizer

    params, _, _, _ = _template(d=200)
    plain = ar.run_async_fleet(["coord", "a", "b"], params, _local_step, cycles=3, weights={"a": 8, "b": 8},
                               buffer_k=2, chunk_elems=64, timeout_s=120, device="cpu")
    qz.reset_compressors()
    ar.reset_async_stats()
    vlog, folds = [], []
    accel = ar.run_async_fleet(["coord", "a", "b"], params, _local_step, cycles=3, weights={"a": 8, "b": 8},
                               buffer_k=2, chunk_elems=64, timeout_s=120, server_opt=fedac(1.0, 3.0, 0.5),
                               version_log=vlog, record_folds=folds, device="cpu")
    assert accel["versions"] > 0
    assert _raw(plain["w"]) != _raw(accel["w"])
    # Replay: each version's mean is its sorted refold, then one step.
    by_v = collections.defaultdict(list)
    for f in folds:
        if f["w_eff"] > 0:
            by_v[f["version"]].append(f)
    replica = PackedServerOptimizer(fedac(1.0, 3.0, 0.5), device=CPU)
    model = tc.pack_tree(params, torch.float32).buf
    for rec in vlog:
        fold_set = sorted(by_v[rec["version"] - 1], key=lambda f: f["party"])
        qts = [f["qt"] for f in fold_set]
        ref = model if qts[0].gmeta.mode == "delta" else None
        mean = tf.packed_quantized_sum(qts, [f["w_eff"] for f in fold_set], ref=ref)
        replica.ensure(model)
        stepped = replica.step_fn(model)(mean)
        replica.resync(model, stepped.buf)
        assert _raw(stepped.buf) == _raw(rec["model"]), rec["version"]
        model = stepped.buf


# -- mixed fleets: both packages in one fleet ---------------------------------------------


def _mixed_fleet(coord_pkg, parties, cycles, weights, buffer_k=2, ce=64):
    """One fleet in one process whose coordinator runs ``coord_pkg`` and
    whose members run the other package, over plain TCP loopback."""
    from rayfed_tpu.config import ClusterConfig as JCC, JobConfig as JJC, PartyConfig as JPC
    from rayfed_tpu.transport.manager import TransportManager as JTM
    from rayfed_tpu_torch.config import ClusterConfig, JobConfig, PartyConfig
    from rayfed_tpu_torch.transport.manager import TransportManager

    ports = dict(zip(parties, free_loopback_ports(len(parties))))
    entries = {p: {"address": f"127.0.0.1:{ports[p]}"} for p in parties}
    coordinator, members = parties[0], parties[1:]

    def mk(p):
        if (p == coordinator) == (coord_pkg == "jax"):
            cc = JCC(parties={q: JPC.from_dict(entries[q]) for q in parties}, current_party=p)
            return JTM(cc, JJC(device_put_received=False, zero_copy_host_arrays=True))
        cc = ClusterConfig(parties={q: PartyConfig.from_dict(entries[q]) for q in parties}, current_party=p)
        return TransportManager(cc, JobConfig(device_put_received=False, zero_copy_host_arrays=True), device=CPU)

    mgrs = {p: mk(p) for p in parties}
    p = _params(d=300)
    tparams = {k: torch.from_numpy(v) for k, v in p.items()}
    jparams = {k: jnp.asarray(v) for k, v in p.items()}
    coord_mod, member_mod = (jar, ar) if coord_pkg == "jax" else (ar, jar)
    coord_params, member_params = (jparams, tparams) if coord_pkg == "jax" else (tparams, jparams)
    vlog, folds, results, errors = [], [], {}, {}

    def run_coord():
        try:
            results[coordinator] = coord_mod.run_async_coordinator(
                mgrs[coordinator], coordinator, members, coord_params, cycles=cycles, buffer_k=buffer_k,
                chunk_elems=ce, timeout_s=120, version_log=vlog, record_folds=folds,
                **({"device": CPU} if coord_mod is ar else {}))
        except BaseException as e:  # re-raised below
            errors[coordinator] = e

    def run_member(m):
        try:
            results[m] = member_mod.run_async_party(
                mgrs[m], m, coordinator, member_params, _local_step, cycles=cycles, weight=weights[m],
                chunk_elems=ce, timeout_s=120, **({"device": CPU} if member_mod is ar else {}))
        except BaseException as e:  # re-raised below
            errors[m] = e

    try:
        for m in mgrs.values():
            m.start()
        threads = [threading.Thread(target=run_coord, daemon=True)] + [
            threading.Thread(target=run_member, args=(m,), daemon=True) for m in members]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
        assert not errors, errors
        assert not any(t.is_alive() for t in threads)
    finally:
        for m in mgrs.values():
            m.stop()
    return results[coordinator], vlog, folds


@pytest.mark.parametrize("coord_pkg", ["jax", "torch"])
def test_mixed_fleet_versions_equal_the_refold(coord_pkg):
    """A JAX coordinator with port members, and a port coordinator with
    JAX members: every emitted version equals the sorted refold of its
    recorded folds through both packages, the model the all-JAX fleet emits
    for the same folds."""
    out, vlog, folds = _mixed_fleet(coord_pkg, ["coord", "a", "b", "c"], cycles=3,
                                    weights={"a": 8, "b": 16, "c": 32})
    assert out["versions"] == len(vlog) >= 2
    assert out["folds"] == 9
    assert _check_version_refold(vlog, folds) == out["versions"]
    assert _raw(vlog[-1]["model"]) == _raw(out["w"])


# -- the wire lock ------------------------------------------------------------------------


def test_async_version_key_and_server_opt_keys_follow_the_wire_lock(monkeypatch):
    """``tool/wire_format.lock``'s ``async_version_key`` and its
    server-opt check: the lock's fingerprint, recomputed with the port's
    version key and the port's ``fl.server_opt`` (which must declare no
    ``*_KEY``) in place of the JAX package's, is still the pinned one."""
    import rayfed_tpu.fl as jfl
    from rayfed_tpu.transport import wire as jwire_mod
    from rayfed_tpu_torch.fl import server_opt
    from tool import check_wire_format

    assert not [k for k in dir(server_opt) if k.endswith("_KEY") and not k.startswith("_")]
    monkeypatch.setattr(jwire_mod, "ASYNC_VERSION_KEY", wire.ASYNC_VERSION_KEY)
    monkeypatch.setattr(jfl, "server_opt", server_opt)
    lock = json.loads((ROOT / "tool" / "wire_format.lock").read_text())
    assert check_wire_format.compute_fingerprint() == lock["fingerprint"]
