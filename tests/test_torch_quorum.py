"""The port's quorum (k-of-n) rounds (CPU) against the JAX package's.

In process, byte identity with the reference: the ``StreamingAggregator``
quorum cases of ``tests/test_quorum.py`` (all arrived; a deadline cutoff
equals the subset's fold; a failed stream completes without burning the
deadline; a transient error recovers; an unreachable quorum fails loudly; a
timeout names the missing parties; validation), each with the reference's
bytes or verdict; the successor rule; ``run_fedavg_rounds``' quorum
verdicts; ``dga_correct``'s bytes.

One party-process run of four port parties (~15 s), ``quorum=2``: carol
straggles past round 0's deadline and is cut; the coordinator alice and dave
``fed.leave()`` at round 0, alice handing the lease to bob; dave then
``fed.join()``s and re-enters with his welcome ticket.  The survivors' final
bytes are equal, and equal to the JAX package's replay of the recorded
member log; ``QUORUM_STATS`` and ``metrics_snapshot()["quorum"]`` show the
handover.
"""

import json
import multiprocessing as mp
import os
import time

import numpy as np
import pytest
import torch

from rayfed_tpu_torch.fl import compression as tc
from rayfed_tpu_torch.fl import trainer as ttrainer
from rayfed_tpu_torch.fl.streaming import StreamingAggregator
from rayfed_tpu_torch.transport import wire
from tests.multiproc import make_cluster

CPU = torch.device("cpu")


def _raw(x):
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _np_trees(n=3):
    return [{"w": np.arange(10, dtype=np.float32) * np.float32(0.1) + np.float32(i),
             "n": np.arange(4, dtype=np.int32) + i} for i in range(n)]


def _port(trees):
    return [tc.compress({k: torch.from_numpy(v.copy()) for k, v in t.items()}, packed=True) for t in trees]


def _ref_sum(idx, weights=None):
    """The reference's one-shot fold of the listed trees."""
    import jax.numpy as jnp

    from rayfed_tpu.fl import compression as jc
    from rayfed_tpu.fl.fedavg import packed_weighted_sum

    trees = _np_trees()
    packed = [jc.compress({k: jnp.asarray(v) for k, v in trees[i].items()}, packed=True) for i in idx]
    return packed_weighted_sum(packed, weights)


def _payload(packed):
    return b"".join(
        bytes(b) if isinstance(b, (bytes, bytearray)) else bytes(memoryview(b).cast("B"))
        for b in wire.encode_payload(packed)
    )


def _agg(n=3, **kw):
    return StreamingAggregator(n, labels=["a", "b", "c"][:n], device=CPU, **kw)


def test_quorum_all_arrived_is_byte_identical():
    packed = _port(_np_trees())
    agg = _agg(quorum=3)
    for i, p in enumerate(packed):
        agg.add_local(i, p)
    r = agg.result(timeout=30, deadline_s=30)
    ref = _ref_sum([0, 1, 2])
    assert _raw(r.buf) == _raw(ref.buf)
    assert _raw(r.passthrough[0]) == _raw(ref.passthrough[0])
    assert agg.quorum_members == [0, 1, 2]
    assert agg.stats["quorum_excluded"] == 0


def test_quorum_deadline_cutoff_matches_subset_reduce():
    packed = _port(_np_trees())
    agg = _agg(quorum=2)
    agg.add_local(0, packed[0])
    agg.add_local(2, packed[2])
    r = agg.result(timeout=30, deadline_s=0.3)
    ref = _ref_sum([0, 2])
    assert _raw(r.buf) == _raw(ref.buf)
    assert _raw(r.passthrough[0]) == _raw(ref.passthrough[0])
    assert agg.quorum_members == [0, 2]
    assert agg.stats["quorum_excluded"] == 1


def test_quorum_cutoff_refolds_what_was_already_folded():
    """A straggler's blocks folded before the cutoff are rolled back: the
    refold over the arrived subset is the subset's fold."""
    packed = _port(_np_trees())
    agg = _agg(quorum=2, chunk_elems=4)
    agg.add_local(0, packed[0])
    # Source 1 lands two of its three blocks (no completion) and stalls:
    # its payload ends with the packed buffer's last block (2 bf16
    # elements) and the int32[4] passthrough leaf.
    payload = _payload(packed[1])
    agg.sink(1).on_bytes(memoryview(payload), len(payload) - 16 - 3)
    agg.add_local(2, packed[2])
    r = agg.result(timeout=30, deadline_s=0.5)
    assert _raw(r.buf) == _raw(_ref_sum([0, 2]).buf)
    assert agg.quorum_members == [0, 2]


def test_quorum_failed_stream_completes_without_deadline_burn():
    packed = _port(_np_trees())
    agg = _agg(quorum=2, weights=[1.0, 2.0, 3.0])
    agg.add_local(0, packed[0])
    agg.add_local(2, packed[2])
    agg._on_error(1, RuntimeError("injected death"))
    t0 = time.monotonic()
    r = agg.result(timeout=30, deadline_s=25)
    assert time.monotonic() - t0 < 10  # not the 25 s deadline
    assert _raw(r.buf) == _raw(_ref_sum([0, 2], [1.0, 3.0]).buf)
    assert agg.stats["quorum_failed_sources"] == ["b"]


def test_errored_stream_recovers_on_clean_completion():
    packed = _port(_np_trees())
    agg = _agg(quorum=2)
    agg.add_local(0, packed[0])
    agg._on_error(1, RuntimeError("transient"))
    agg._on_complete(1, _payload(packed[1]))
    agg.add_local(2, packed[2])
    r = agg.result(timeout=30, deadline_s=20)
    assert _raw(r.buf) == _raw(_ref_sum([0, 1, 2]).buf)
    assert agg.quorum_members == [0, 1, 2]


def test_quorum_unreachable_fails_loudly():
    packed = _port(_np_trees())
    agg = _agg(quorum=3)
    agg.add_local(0, packed[0])
    agg._on_error(1, RuntimeError("dead"))
    agg._on_error(2, RuntimeError("dead too"))
    with pytest.raises(RuntimeError, match="quorum 3/3 unreachable"):
        agg.result(timeout=10, deadline_s=1)


def test_transient_error_recovers_before_deadline_verdict():
    packed = _port(_np_trees())
    agg = _agg(quorum=3)
    agg.add_local(0, packed[0])
    agg._on_error(1, RuntimeError("transient"))
    agg._on_error(2, RuntimeError("transient"))
    for i in (1, 2):
        agg._on_complete(i, _payload(packed[i]))
    r = agg.result(timeout=30, deadline_s=10)
    assert _raw(r.buf) == _raw(_ref_sum([0, 1, 2]).buf)
    assert agg.quorum_members == [0, 1, 2]


def test_timeout_names_missing_parties():
    from rayfed_tpu_torch.exceptions import PartyWaitTimeout

    packed = _port(_np_trees(2))
    agg = StreamingAggregator(2, labels=["alice", "bob"], device=CPU)
    agg.add_local(0, packed[0])
    with pytest.raises(PartyWaitTimeout) as ei:
        agg.result(timeout=0.4)
    assert ei.value.missing_parties == ["bob"]


def _ctor_verdict(cls, **kw):
    try:
        cls(**kw)
        return "ok"
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("kw", [
    {"n_sources": 3, "quorum": 4}, {"n_sources": 3, "quorum": 0}, {"n_sources": 3, "quorum": 3},
    {"n_sources": 3, "labels": ["a"]},
])
def test_quorum_validation_equals_the_reference(kw):
    from rayfed_tpu.fl.streaming import StreamingAggregator as JAgg

    assert _ctor_verdict(StreamingAggregator, device=CPU, **kw) == _ctor_verdict(JAgg, **kw)
    agg = StreamingAggregator(2, labels=["a", "b"], device=CPU)
    with pytest.raises(ValueError, match="deadline_s needs quorum"):
        agg.result(timeout=1, deadline_s=1)


def test_roster_successor_rule():
    from rayfed_tpu.transport.manager import roster_successor as jsucc
    from rayfed_tpu_torch.transport.manager import roster_successor

    members = ["alice", "bob", "carol", "dave"]
    cases = [
        (members, "alice", ()), (members, "alice", ("bob",)), (members, "dave", ()),
        (["bob", "carol"], "alice", ()), (members, "alice", ("alice",)),
        (["bob", "carol", "dave"], "bob", ("bob",)), (["carol", "dave"], "alice", ()),
        (["alice"], "alice", ()), ([], "alice", ()), (["alice", "bob"], "alice", ("bob",)),
    ]
    for m, c, dead in cases:
        assert roster_successor(m, c, dead) == jsucc(m, c, dead), (m, c, dead)
    assert roster_successor(members, "dave") == "alice"
    assert roster_successor(["alice"], "alice") is None


QUORUM_CASES = [
    {"quorum": 3, "compress_wire": True, "packed_wire": True},
    {"quorum": 2},
    {"quorum": 2, "compress_wire": True, "packed_wire": True, "server_opt": "sgd"},
    {"round_deadline_s": 5.0},
    {"quorum": 2, "compress_wire": True, "packed_wire": True, "round_deadline_s": 0.0},
    {"join_ticket": {}},
    {"round_log": []},
    {"quorum": 1, "compress_wire": True, "packed_wire": True, "checkpoint_every": 2},
    {"quorum": 2, "compress_wire": True, "packed_wire": True, "round_deadline_s": 5.0, "round_log": [],
     "join_ticket": {"round": 3}},
    {"quorum": 2, "compress_wire": True, "packed_wire": True, "mode": "ring", "wire_quant": "uint8",
     "ring_chunk_elems": 64},
    {"quorum": 2, "compress_wire": True, "packed_wire": True, "error_feedback": True},
    {"quorum": 2, "compress_wire": True, "packed_wire": True, "sample": 1},
]


@pytest.mark.parametrize("kw", QUORUM_CASES, ids=lambda kw: ",".join(f"{k}" for k in sorted(kw)))
def test_quorum_round_config_verdicts_equal_the_reference(kw):
    from rayfed_tpu.fl import fedopt as jfedopt
    from rayfed_tpu.fl import trainer as jtrainer
    from rayfed_tpu_torch.fl import fedopt as tfedopt

    def verdict(fn, opt):
        k = dict(kw)
        if k.get("server_opt") == "sgd":
            k["server_opt"] = opt
        try:
            return ("ok", fn({"a": None, "b": None}, **k))
        except ValueError as e:
            return ("ValueError", str(e))

    assert verdict(ttrainer.validate_round_config, tfedopt.server_sgd(0.1)) == verdict(
        jtrainer.validate_round_config, jfedopt.server_sgd(0.1))


def test_dga_correct_equals_the_reference():
    import jax.numpy as jnp

    from rayfed_tpu.fl import compression as jc
    from rayfed_tpu.fl.overlap import dga_correct as jdga
    from rayfed_tpu_torch.fl.overlap import dga_correct

    rng = np.random.default_rng(2)
    trees = [{"w": rng.standard_normal(4099).astype(np.float32), "n": np.arange(3, dtype=np.int32) + i}
             for i in range(3)]
    for wire_dtype in ("bfloat16", "float32"):
        jt = [jc.compress({k: jnp.asarray(v) for k, v in t.items()}, packed=True, wire_dtype=jnp.dtype(wire_dtype))
              for t in trees]
        tt = [tc.compress({k: torch.from_numpy(v.copy()) for k, v in t.items()}, packed=True,
                          wire_dtype=tc.torch_dtype(wire_dtype)) for t in trees]
        want, got = jdga(*jt), dga_correct(*tt)
        assert _raw(got.buf) == _raw(want.buf)
        assert _raw(got.passthrough[0]) == _raw(want.passthrough[0])
    with pytest.raises(TypeError, match="PackedTrees"):
        dga_correct(tt[0], {"w": 1}, tt[0])


# -- four port parties: a straggler, a coordinator handover, a join -----------------


PARTIES4 = ["alice", "bob", "carol", "dave"]
DELTAS = {"alice": 0.25, "bob": 0.5, "carol": 1.0, "dave": 2.0}
DIM, ROUNDS, DEADLINE_S = 8, 4, 2.0
PARTY_TIMEOUT_S = 60


def run_quorum_party(party, cluster, outdir, server_opt=None):
    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import chaos
    from rayfed_tpu_torch.fl.quorum import QUORUM_STATS
    from rayfed_tpu_torch.fl.server_opt import PackedServerOptimizer, fedac

    states = []
    if server_opt is not None:
        # Every resync's state bytes, to hold the replicas (a welcomed
        # joiner's included) against each other.
        resync = PackedServerOptimizer.resync

        def recording_resync(self, x_buf, new_buf):
            resync(self, x_buf, new_buf)
            states.append(self.state.bufs[0].numpy().tolist())

        PackedServerOptimizer.resync = recording_resync
        kw_opt = {"server_opt": fedac(*server_opt)}
    else:
        kw_opt = {}

    chaos.install({"seed": 3, "rules": [
        # carol's round 0 starts past its deadline: cut, late-folded.
        {"hook": "round", "party": "carol", "match": {"round": 0}, "op": "delay_ms",
         "value": int(DEADLINE_S * 1000) + 2000},
        # Round 1 under its deadline: long enough for dave's join request
        # to reach bob before round 1's announcement.
        {"hook": "round", "party": "carol", "match": {"round": 1}, "op": "delay_ms", "value": 1000},
    ]})
    fed.init(address="local", cluster=cluster, party=party, device=CPU,
             enable_waiting_for_other_parties_ready=True, recv_backstop_in_seconds=45)

    @fed.remote
    class Trainer:
        def __init__(self, delta):
            self._d = float(delta)

        def train(self, params):
            tree = tc.decompress(params, torch.float32)
            return tc.compress({"w": tree["w"] + self._d}, packed=True, wire_dtype=torch.float32)

    trainers = {p: Trainer.party(p).remote(DELTAS[p]) for p in PARTIES4}
    params = {"w": torch.zeros(DIM)}
    kw = dict(compress_wire=True, packed_wire=True, wire_dtype=torch.float32, quorum=2,
              round_deadline_s=DEADLINE_S, **kw_opt)
    if party in ("alice", "dave"):
        fed.leave()  # alice is the coordinator: a graceful handover
    log: list = []
    final = fed.fl.run_fedavg_rounds(trainers, params, rounds=ROUNDS, round_log=log, **kw)
    report = {"log": log}
    if party == "dave":
        ticket = fed.join(coordinator="bob", timeout=30)
        report["ticket"] = {k: ticket[k] for k in ("round", "epoch", "members", "coordinator")}
        log2: list = []
        final = fed.fl.run_fedavg_rounds(trainers, params, rounds=ROUNDS, round_log=log2,
                                         join_ticket=ticket, **kw)
        report["log"] = log + log2
    report["final"] = final["w"].numpy().tolist()
    report["states"] = states
    report["stats"] = dict(QUORUM_STATS)
    report["metrics"] = fed.metrics_snapshot()["quorum"]
    with open(os.path.join(outdir, f"{party}.json"), "w") as f:
        json.dump(report, f)
    # Stay up until every party has reported: a leaver still holds a
    # welcome's model and serves the object plane.
    deadline = time.monotonic() + PARTY_TIMEOUT_S
    while len([n for n in os.listdir(outdir) if n.endswith(".json")]) < len(PARTIES4):
        assert time.monotonic() < deadline, "peers never reported"
        time.sleep(0.1)
    time.sleep(0.5)
    fed.shutdown()


def _port_child(fn_name, party, args):
    import sys

    getattr(sys.modules[__name__], fn_name)(party, *args)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "rayfed_tpu"))
    assert not loaded, loaded


def _replay(log, server_opt=None):
    """The quorum recurrence from the member log, by the JAX package:
    members' mean (sorted-party fold order), DGA late folds for active
    stragglers, the broadcast as a (re)joiner's input; under ``server_opt``
    (FedAC's hyperparameters) the mean stepped from the replicated state.
    Returns the final params and the final state."""
    import jax.numpy as jnp

    from rayfed_tpu.fl import compression as C
    from rayfed_tpu.fl import server_opt as SO
    from rayfed_tpu.fl.fedavg import packed_weighted_sum
    from rayfed_tpu.fl.overlap import dga_correct

    current = C.compress({"w": jnp.zeros(DIM, jnp.float32)}, packed=True, wire_dtype=jnp.float32)
    sopt = None if server_opt is None else SO.PackedServerOptimizer(SO.fedac(*server_opt))
    late = {}
    for entry in log:
        active, members = entry["active"], entry["members"]
        for p in list(late):
            if p not in active:
                late.pop(p)
        inputs = {p: late.pop(p, current) for p in active}
        ups = {p: C.compress({"w": C.decompress(inputs[p], jnp.float32)["w"] + DELTAS[p]}, packed=True,
                             wire_dtype=jnp.float32) for p in active}
        x_srv = np.asarray(current.buf).astype(np.float32)
        current = packed_weighted_sum([ups[p] for p in sorted(members)], None)
        if sopt is not None:
            sopt.ensure(x_srv)
            current = sopt.step_fn(x_srv)(current)
            sopt.resync(x_srv, np.asarray(current.buf))
        for p in active:
            if p not in members:
                late[p] = dga_correct(current, ups[p], inputs[p])
    state = None if sopt is None else np.asarray(sopt.state.bufs[0], np.float32)
    return np.asarray(C.decompress(current, jnp.float32)["w"], np.float32), state


def _run_quorum_parties(tmp_path, server_opt=None):
    cluster = make_cluster(PARTIES4)
    ctx = mp.get_context("spawn")
    procs = {p: ctx.Process(target=_port_child,
                            args=("run_quorum_party", p, (cluster, str(tmp_path), server_opt)))
             for p in PARTIES4}
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
    assert {p: proc.exitcode for p, proc in procs.items()} == {p: 0 for p in PARTIES4}
    return {p: json.loads((tmp_path / f"{p}.json").read_text()) for p in PARTIES4}


def test_quorum_straggler_handover_and_join(tmp_path):
    rep = _run_quorum_parties(tmp_path)
    log = rep["bob"]["log"]
    assert len(log) == ROUNDS
    # Round 0: alice coordinated, carol missed the deadline.
    assert log[0]["coordinator"] == "alice" and log[0]["members"] == ["alice", "bob", "dave"]
    # The handover: bob coordinates from round 1, alice and dave are off.
    assert [e["coordinator"] for e in log[1:]] == ["bob"] * (ROUNDS - 1)
    assert log[1]["active"] == ["bob", "carol"] and log[1]["epoch"] >= 1
    # dave's welcome put him back on the roster from its round on (round 2
    # unless his request missed round 1's announcement).
    t = rep["dave"]["ticket"]
    w = t["round"]
    assert t["coordinator"] == "bob" and "dave" in t["members"] and t["epoch"] >= 2 and 2 <= w < ROUNDS
    assert [e["active"] for e in log[1:]] == [PARTIES4[1:3]] * (w - 1) + [PARTIES4[1:]] * (ROUNDS - w)
    assert rep["dave"]["log"] == log[:1] + log[w:]
    assert rep["alice"]["log"] == log[:1]
    # The survivors hold the same bytes: the JAX package's replay.
    want, _ = _replay(log)
    for p in ("bob", "carol", "dave"):
        assert np.asarray(rep[p]["final"], np.float32).tobytes() == want.tobytes(), p
    for p in ("alice", "bob", "carol"):
        assert rep[p]["stats"]["graceful_handovers"] >= 1, p
        assert rep[p]["metrics"] == rep[p]["stats"], p


def test_quorum_handover_and_join_carry_the_server_opt_state(tmp_path):
    """The same four-party run under ``server_opt=fedac(1, 3, 0.5)``: the
    coordinators step each round's mean, alice's handover passes the lease
    to bob with the state every replica already holds, and dave's welcome
    carries the optimizer's stamp and a content handle to its state.  The
    survivors' params and their last state equal the JAX package's replay,
    byte for byte, dave's included."""
    hyper = (1.0, 3.0, 0.5)
    rep = _run_quorum_parties(tmp_path, server_opt=hyper)
    log = rep["bob"]["log"]
    assert len(log) == ROUNDS and log[0]["coordinator"] == "alice"
    want, want_state = _replay(log, server_opt=hyper)
    w = rep["dave"]["ticket"]["round"]
    for p in ("bob", "carol", "dave"):
        assert np.asarray(rep[p]["final"], np.float32).tobytes() == want.tobytes(), p
        assert np.asarray(rep[p]["states"][-1], np.float32).tobytes() == want_state.tobytes(), p
    # One resync per round a party took part in (dave: round 0, then his
    # welcome's round on, from the welcomed state).
    assert len(rep["bob"]["states"]) == ROUNDS
    assert len(rep["dave"]["states"]) == 1 + ROUNDS - w
