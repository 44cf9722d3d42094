"""The port's pipelined (overlapped) rounds (CPU) against the JAX package's,
after ``tests/test_overlap.py``, and the round drivers of the hierarchy.

One party-process run of three port parties (~15 s; the fed runtime is
process-global, so each party needs its own process; a ring needs three
parties for a relay hop, and three parties at ``region_size=2`` make a tree
of two regions): ``run_fedavg_rounds(overlap=True)`` in coordinator mode,
the synchronous streaming rounds, one round of each, the ``wire_quant``
overlap and a ring overlap whose second round bob aborts (the same round
re-aggregates over the coordinator topology); then
``run_fedavg_rounds(mode="hierarchy")`` beside the flat quantized hub, a
hierarchy round bob aborts (the lockstep flat fallback) and
``run_quorum_rounds(mode="hierarchy")``.  The parent holds every result to
the JAX package's replay of the recurrence byte for byte: the training,
``dga_correct``, the folds, the codec and its residuals and the finalize
are deterministic on both packages.

In process: ``send_data_async`` (the lane's send future), the round tag on
the frame, ``dga_correct``, the driver's and the runner's validation
(``server_opt=`` raises naming Queue A item 8) and the comms lane.
"""

import asyncio
import json
import multiprocessing as mp
import os
import time

import numpy as np
import pytest
import torch

from rayfed_tpu_torch.fl import compression as tc
from tests.multiproc import get_free_ports, make_cluster

CPU = torch.device("cpu")
D = 96  # model width of the toy quadratic trainers
PARTIES = ["alice", "bob", "carol"]
SEEDS = {p: i + 1 for i, p in enumerate(PARTIES)}
ROUNDS, QUANT_ROUNDS = 3, 4
PARTY_TIMEOUT_S = 120


def _center(seed):
    return np.random.default_rng(seed).standard_normal(D).astype(np.float32)


def _init_params():
    return np.linspace(-1.0, 1.0, D, dtype=np.float32)


def _hex(tree):
    return tree["x"].detach().contiguous().view(torch.uint8).numpy().tobytes().hex()


# -- the party processes ----------------------------------------------------------


def run_overlap_party(party, cluster, outdir):
    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch.fl import quantize as qz
    from rayfed_tpu_torch.fl import ring as ring_mod
    from rayfed_tpu_torch.fl import run_fedavg_rounds

    fed.init(address="local", cluster=cluster, party=party, device=CPU, recv_backstop_in_seconds=60)

    @fed.remote
    class Quad:
        """Deterministic quadratic pull toward a seeded centre."""

        def __init__(self, seed):
            self._c = torch.from_numpy(_center(seed))

        def train(self, params):
            x = tc.decompress(params, torch.float32)["x"]
            for _ in range(2):
                x = x - 0.25 * (x - self._c)
            return tc.compress({"x": x}, packed=True)

    trainers = {p: Quad.party(p).remote(SEEDS[p]) for p in PARTIES}
    params = {"x": torch.from_numpy(_init_params())}
    kw = dict(compress_wire=True, packed_wire=True)
    report = {}
    timings: list = []
    report["overlap"] = _hex(run_fedavg_rounds(trainers, params, rounds=ROUNDS, overlap=True,
                                               timings=timings, **kw))
    report["timings"] = timings
    sync_t: list = []
    report["sync"] = _hex(run_fedavg_rounds(trainers, params, rounds=ROUNDS, streaming_agg=True,
                                            timings=sync_t, **kw))
    report["sync_hidden"] = [rec["hidden_s"] for rec in sync_t]
    report["one_overlap"] = _hex(run_fedavg_rounds(trainers, params, rounds=1, overlap=True, **kw))
    report["one_sync"] = _hex(run_fedavg_rounds(trainers, params, rounds=1, streaming_agg=True, **kw))
    qz.reset_compressors()
    report["quant"] = _hex(run_fedavg_rounds(trainers, params, rounds=QUANT_ROUNDS, streaming_agg=True,
                                             overlap=True, wire_quant="uint8", **kw))
    # Only bob faults, at the reduce-scatter of his second ring round: the
    # others learn of the abort through the poison cascade.
    calls = {"n": 0}

    def hook(phase):
        if phase == "rs" and party == "bob":
            calls["n"] += 1
            if calls["n"] == 2:
                raise ConnectionError("injected mid-overlap ring failure")

    zeros = {"x": torch.zeros(D)}
    ring_mod._fault_hook = hook
    try:
        report["ring"] = _hex(run_fedavg_rounds(trainers, zeros, rounds=ROUNDS, overlap=True, mode="ring",
                                                ring_chunk_elems=16, **kw))
    finally:
        ring_mod._fault_hook = None
    report["ring_stats"] = dict(ring_mod.RING_STATS)
    report["coord"] = _hex(run_fedavg_rounds(trainers, zeros, rounds=ROUNDS, overlap=True, **kw))

    # The hierarchy's drivers: each leg from a fresh residual registry.
    from rayfed_tpu_torch.fl import hierarchy as hier

    def hier_leg(name, **leg_kw):
        qz.reset_compressors()
        before = dict(hier.HIER_STATS)
        report[name] = _hex(run_fedavg_rounds(trainers, params, rounds=ROUNDS, wire_quant="uint8",
                                              **leg_kw, **kw))
        report[f"{name}_stats"] = {k: hier.HIER_STATS[k] - before[k] for k in before}

    hier_leg("hier", mode="hierarchy", region_size=2)
    hier_leg("hub_quant", streaming_agg=True)
    tries = {"n": 0}

    def hier_hook(phase, who):
        if phase == "ps" and who == "bob" == party:
            tries["n"] += 1
            if tries["n"] == 2:
                raise ConnectionError("injected hierarchy failure")

    hier._fault_hook = hier_hook
    try:
        hier_leg("hier_fault", mode="hierarchy", region_size=2)
    finally:
        hier._fault_hook = None
    hier_leg("hier_quorum", mode="hierarchy", region_size=2, quorum=len(PARTIES), round_deadline_s=30.0)
    qz.reset_compressors()
    with open(os.path.join(outdir, f"{party}.json"), "w") as f:
        json.dump(report, f)
    deadline = time.monotonic() + PARTY_TIMEOUT_S
    while len([n for n in os.listdir(outdir) if n.endswith(".json")]) < len(PARTIES):
        assert time.monotonic() < deadline, "peers never reported"
        time.sleep(0.1)
    time.sleep(0.5)
    fed.shutdown()


def _port_child(fn_name, party, args):
    import sys

    getattr(sys.modules[__name__], fn_name)(party, *args)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "rayfed_tpu"))
    assert not loaded, loaded


# -- the JAX package's replay -------------------------------------------------------


def _jax_train(x_packed, seed):
    import jax.numpy as jnp

    from rayfed_tpu.fl import compression as C

    c = jnp.asarray(_center(seed))
    x = C.decompress(x_packed, jnp.float32)["x"]
    for _ in range(2):
        x = x - 0.25 * (x - c)
    return C.compress({"x": x}, packed=True)


def _replay(init, rounds, overlap, quant=False):
    """The round recurrence by the JAX package: train, the DGA correction
    against the latest broadcast (under overlap), the fold (under
    ``quant``: each party's codec on the broadcast-anchored delta grid with
    its own residual, the integer fold, the downlink recode)."""
    import jax.numpy as jnp

    from rayfed_tpu.fl import compression as C
    from rayfed_tpu.fl import quantize as jqz
    from rayfed_tpu.fl.compression import pack_tree
    from rayfed_tpu.fl.fedavg import packed_quantized_sum, packed_weighted_sum
    from rayfed_tpu.fl.overlap import dga_correct

    jqz.reset_compressors()
    params = {"x": jnp.asarray(init)}
    inputs = {p: C.compress(params, packed=True) for p in PARTIES}
    ref = np.asarray(pack_tree(params, jnp.float32).buf)
    prev_delta, agg = None, None
    for r in range(rounds):
        u = {p: _jax_train(inputs[p], SEEDS[p]) for p in PARTIES}
        contribs = u if (r == 0 or not overlap) else {p: dga_correct(agg, u[p], inputs[p]) for p in PARTIES}
        grid = None
        if quant and prev_delta is not None:
            grid = jqz.make_round_grid(prev_delta, wire_dtype="uint8", mode="delta", expand=jqz.QUANT_DELTA_EXPAND)
        if grid is None:
            agg = packed_weighted_sum([contribs[p] for p in PARTIES])
        else:
            qts = []
            for p in PARTIES:
                codec = jqz.RoundCodec(grid, ref, f"rp.{p}")
                qts.append(codec.to_wire(contribs[p]))
                codec.commit()
            _, agg, _ = jqz.quantize_downlink(packed_quantized_sum(qts, None, ref=ref), grid, ref, "rp")
        new_ref = np.asarray(agg.buf).astype(np.float32)
        prev_delta, ref = new_ref - ref, new_ref
        # The synchronous driver ships the broadcast model in its wire dtype.
        inputs = contribs if overlap else {p: C.compress(C.decompress(agg), packed=True) for p in PARTIES}
    jqz.reset_compressors()
    return np.asarray(C.decompress(agg)["x"], np.float32).tobytes().hex()


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """Every party's report of the one party-process run."""
    tmp_path = tmp_path_factory.mktemp("overlap")
    cluster = make_cluster(PARTIES)
    ctx = mp.get_context("spawn")
    procs = {p: ctx.Process(target=_port_child, args=("run_overlap_party", p, (cluster, str(tmp_path))))
             for p in PARTIES}
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
    return {p: json.loads((tmp_path / f"{p}.json").read_text()) for p in PARTIES}


def test_overlap_rounds_follow_the_reference_recurrence(reports):
    rep = reports
    for key in ("overlap", "sync", "one_overlap", "one_sync", "quant", "ring", "coord"):
        assert len({rep[p][key] for p in PARTIES}) == 1, f"parties disagree on {key}"
    got = rep["alice"]
    init, zeros = _init_params(), np.zeros(D, np.float32)
    # overlap=True follows the DGA recurrence byte for byte.
    assert got["overlap"] == _replay(init, ROUNDS, overlap=True)
    # overlap=False is the synchronous recurrence; one round has nothing to
    # overlap.
    assert got["sync"] == _replay(init, ROUNDS, overlap=False)
    assert got["one_overlap"] == got["one_sync"] == _replay(init, 1, overlap=False)
    # The wire_quant half of the reference's composition test: the
    # corrected contributions code exactly (the unified recurrence).
    assert got["quant"] == _replay(init, QUANT_ROUNDS, overlap=True, quant=True)
    assert got["quant"] != _replay(init, QUANT_ROUNDS, overlap=True)
    # The ring fault: the same round re-aggregated over the coordinator
    # topology; the bytes equal an overlap run that never used the ring.
    assert got["ring"] == got["coord"] == _replay(zeros, ROUNDS, overlap=True)
    for p in PARTIES:
        stats = rep[p]["ring_stats"]
        assert stats["rounds_aborted"] >= 1 and stats["fallback_rounds"] >= 1, (p, stats)
        assert stats["rounds_completed"] >= 2, (p, stats)
        timings = rep[p]["timings"]
        assert [rec["round"] for rec in timings] == list(range(ROUNDS))
        for rec in timings:
            assert {"local_s", "push_s", "agg_s", "hidden_s", "round", "epoch", "coordinator"} <= set(rec)
            assert rec["agg_s"] >= 0.0 and rec["hidden_s"] >= 0.0
        assert rep[p]["sync_hidden"] == [0.0] * ROUNDS


# -- in process: the transport hooks ------------------------------------------------


def _self_manager(party="alice", **job_kw):
    from rayfed_tpu_torch.config import ClusterConfig, JobConfig, PartyConfig
    from rayfed_tpu_torch.transport.manager import TransportManager

    (port,) = get_free_ports(1)
    job_kw.setdefault("device_put_received", False)
    mgr = TransportManager(
        ClusterConfig(parties={party: PartyConfig(address=f"127.0.0.1:{port}")}, current_party=party),
        JobConfig(**job_kw), device=CPU,
    )
    mgr.start()
    return mgr


def test_send_data_async_resolves_on_ack():
    from rayfed_tpu_torch.transport import wire

    mgr = _self_manager()
    try:
        recv_ref = mgr.recv("alice", "async", "0")
        client = mgr._get_client("alice")
        ref = client.send_data_async(wire.encode_payload({"x": np.arange(64)}), "async", "0")
        assert ref.resolve(timeout=30) == "OK"
        np.testing.assert_array_equal(recv_ref.resolve(timeout=30)["x"], np.arange(64))
    finally:
        mgr.stop()


def test_send_data_async_errs_on_failure():
    """A dead peer: the completion future errs after the retries, never
    hangs or turns into a bool."""
    from rayfed_tpu_torch.config import ClusterConfig, JobConfig, PartyConfig, RetryPolicy
    from rayfed_tpu_torch.transport import wire
    from rayfed_tpu_torch.transport.client import SendError
    from rayfed_tpu_torch.transport.manager import TransportManager

    port_a, port_dead = get_free_ports(2)
    mgr = TransportManager(
        ClusterConfig(parties={"alice": PartyConfig(address=f"127.0.0.1:{port_a}"),
                               "ghost": PartyConfig(address=f"127.0.0.1:{port_dead}")},
                      current_party="alice"),
        JobConfig(device_put_received=False,
                  retry_policy=RetryPolicy(max_attempts=2, initial_backoff_s=0.05, max_backoff_s=0.1)),
        device=CPU,
    )
    mgr.start()
    try:
        ref = mgr._get_client("ghost").send_data_async(wire.encode_payload({"x": 1}), "dead", "0")
        with pytest.raises((SendError, OSError, ConnectionError)):
            ref.resolve(timeout=30)
    finally:
        mgr.stop()


def test_send_data_async_requires_bound_loop():
    from rayfed_tpu_torch.config import RetryPolicy
    from rayfed_tpu_torch.transport.client import TransportClient

    client = TransportClient("a", "b", "127.0.0.1:1", RetryPolicy(), 1.0, 1 << 20, checksum=False)
    with pytest.raises(RuntimeError, match="event loop"):
        client.send_data_async([], "u", "d")


def test_round_tag_rides_frame_metadata():
    from rayfed_tpu_torch.transport import wire

    mgr = _self_manager()
    try:
        assert mgr.send("alice", {"x": 7}, "tagged", "0", round_tag=12).resolve(timeout=30)
        msg = asyncio.run_coroutine_threadsafe(
            mgr._mailbox.get("tagged", "0", timeout_s=30), mgr._loop).result(timeout=30)
        assert msg.metadata[wire.ROUND_TAG_KEY] == "12"
        assert mgr.send("alice", {"x": 8}, "untagged", "0").resolve(timeout=30)
        msg = asyncio.run_coroutine_threadsafe(
            mgr._mailbox.get("untagged", "0", timeout_s=30), mgr._loop).result(timeout=30)
        assert wire.ROUND_TAG_KEY not in msg.metadata
    finally:
        mgr.stop()


# -- in process: the DGA correction, validation, the comms lane ----------------------


def test_dga_correct_recurrence_and_passthrough():
    import jax.numpy as jnp

    from rayfed_tpu.fl import compression as C
    from rayfed_tpu.fl.overlap import dga_correct as jdga
    from rayfed_tpu_torch.fl.overlap import dga_correct

    def trees(pkg):
        arr = (lambda v: jnp.asarray(v)) if pkg == "jax" else (lambda v: torch.from_numpy(v))
        comp = C if pkg == "jax" else tc
        return [comp.compress({"w": arr(np.arange(8, dtype=np.float32) * k + d), "n": np.int32(n)}, packed=True)
                for k, d, n in ((0.5, 0.0, 10), (1.0, 2.0, 6), (1.0, 0.0, 4))]

    out = dga_correct(*trees("torch"))
    want = jdga(*trees("jax"))
    agg = trees("torch")[0]
    # agg + (cur − base), in f32 then cast to the wire dtype: exact here.
    np.testing.assert_array_equal(out.buf.float().numpy(), agg.buf.float().numpy() + 2.0)
    assert out.buf.view(torch.uint16).numpy().tobytes() == np.asarray(want.buf).view(np.uint16).tobytes()
    assert int(out.passthrough[0]) == int(want.passthrough[0]) == 10 + (6 - 4)


def test_dga_correct_rejects_mismatched_specs():
    from rayfed_tpu_torch.fl.overlap import dga_correct

    a = tc.compress({"w": torch.ones(4)}, packed=True)
    b = tc.compress({"w": torch.ones(8)}, packed=True)
    with pytest.raises(ValueError, match="spec"):
        dga_correct(a, b, b)
    with pytest.raises(TypeError, match="PackedTree"):
        dga_correct({"w": torch.ones(4)}, a, a)


def test_overlap_driver_validation():
    from rayfed_tpu_torch.fl import run_fedavg_rounds
    from rayfed_tpu_torch.fl.fedopt import server_sgd

    trainers = {"a": None, "b": None}
    with pytest.raises(ValueError, match="overlap"):
        run_fedavg_rounds(trainers, {}, rounds=1, overlap=True)
    with pytest.raises(ValueError, match="incompatible"):
        run_fedavg_rounds(trainers, {}, rounds=1, overlap=True, compress_wire=True, packed_wire=True,
                          server_opt=server_sgd(lr=1.0))
    with pytest.raises(ValueError, match="incompatible"):
        run_fedavg_rounds(trainers, {}, rounds=1, overlap=True, compress_wire=True, packed_wire=True,
                          error_feedback=True)
    with pytest.raises(ValueError, match="ring_chunk_elems"):
        run_fedavg_rounds(trainers, {}, rounds=1, compress_wire=True, packed_wire=True, ring_chunk_elems=64)


def test_runner_validation_and_the_unported_server_step():
    from rayfed_tpu_torch.fl.overlap import PipelinedRoundRunner

    trainers = {"a": None, "b": None}
    with pytest.raises(ValueError, match="needs trainers"):
        PipelinedRoundRunner({})
    with pytest.raises(ValueError, match="unknown mode"):
        PipelinedRoundRunner(trainers, mode="hierarchy")
    with pytest.raises(ValueError, match="1 weights for 2"):
        PipelinedRoundRunner(trainers, weights=[1.0])
    with pytest.raises(ValueError, match="not a training party"):
        PipelinedRoundRunner(trainers, coordinator="zed")
    # The server_opt half of the reference's composition test: a bare
    # packed spec is wrapped as run_fedavg_rounds wraps it, anything else
    # is refused, as in the JAX package.
    from rayfed_tpu.fl import overlap as jov
    from rayfed_tpu.fl import server_opt as jso
    from rayfed_tpu_torch.fl import server_opt as tso

    runner = PipelinedRoundRunner(trainers, server_opt=tso.fedac(1.0, 3.0, 0.5))
    assert isinstance(runner._sopt, tso.PackedServerOptimizer)
    assert runner._sopt.opt == tso.fedac(1.0, 3.0, 0.5)
    jrunner = jov.PipelinedRoundRunner(trainers, server_opt=jso.fedac(1.0, 3.0, 0.5))
    assert isinstance(jrunner._sopt, jso.PackedServerOptimizer)
    with pytest.raises(TypeError, match="wraps a PackedServerOpt"):
        PipelinedRoundRunner(trainers, server_opt=object())
    with pytest.raises(TypeError, match="wraps a PackedServerOpt"):
        jov.PipelinedRoundRunner(trainers, server_opt=object())
    with pytest.raises(ValueError, match="rounds must be >= 1"):
        PipelinedRoundRunner(trainers).run({}, 0)


def test_comms_lane_binds_and_shuts_down():
    from rayfed_tpu_torch.executor import CommsLane

    seen = []
    lane = CommsLane(bind_runtime_fn=lambda: seen.append("bound"))
    assert lane.submit(lambda a, b: a + b, 2, 3).resolve(timeout=10) == 5
    assert seen == ["bound"]
    boom = lane.submit(lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        boom.resolve(timeout=10)
    lane.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        lane.submit(lambda: None)


def test_hierarchy_rounds_equal_the_flat_quantized_rounds(reports):
    """``run_fedavg_rounds(mode="hierarchy")``: round 0 the flat bootstrap,
    rounds 1–2 over the tree (two regions), byte-equal to the flat quantized
    hub and to the JAX package's replay; a round the tree aborts falls back
    in lockstep at every party; ``run_quorum_rounds(mode="hierarchy")``
    completes its graded round over the tree."""
    rep = reports
    for key in ("hier", "hub_quant", "hier_fault", "hier_quorum"):
        assert len({rep[p][key] for p in PARTIES}) == 1, f"parties disagree on {key}"
    got = rep["alice"]
    want = _replay(_init_params(), ROUNDS, overlap=False, quant=True)
    assert got["hier"] == got["hub_quant"] == want
    for p in PARTIES:
        assert rep[p]["hier_stats"] == {"rounds_completed": ROUNDS - 1, "rounds_aborted": 0,
                                        "fallback_rounds": 0, "region_cutoffs": 0}, p
        assert rep[p]["hub_quant_stats"]["rounds_completed"] == 0, p
        fault = rep[p]["hier_fault_stats"]
        assert fault["rounds_completed"] == ROUNDS - 2 and fault["rounds_aborted"] == 1, (p, fault)
        assert fault["fallback_rounds"] == 1, (p, fault)
        quorum = rep[p]["hier_quorum_stats"]
        assert quorum["rounds_completed"] == ROUNDS - 1 and quorum["fallback_rounds"] == 0, (p, quorum)
