"""The checkpointer arms of the port's round drivers, held against the JAX
package's tests: ``tests/test_fl_trainer.py`` (resume with a server
optimizer, ``checkpoint_every`` defaulting to 1, the validation),
``tests/test_quorum.py`` (a fully crashed quorum cluster resumes; the
validation).  The checkpointer's own verdicts are
``tests/test_torch_fl_round.py``'s.

The classic-loop cases run one party in this process (the reference runs
two processes; one party exercises the same save, restore and stamp path).
The quorum case runs two port party processes (~10 s): the cluster stops
after two rounds, fresh runtimes resume from the snapshots, and the final
bytes equal the JAX package's replay of the restored member log.
"""

import json
import multiprocessing as mp
import os
import time

import numpy as np
import pytest
import torch

from rayfed_tpu_torch.checkpoint import FedCheckpointer
from rayfed_tpu_torch.fl import compression as tc
from rayfed_tpu_torch.fl import trainer as ttrainer
from rayfed_tpu_torch.fl.server_opt import describe_server_opt
from tests.multiproc import make_cluster

CPU = torch.device("cpu")


def _raw(t):
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _solo_rounds(fn):
    """Run ``fn(fed, trainers, params)`` inside a one-party runtime on the
    CPU; the trainer takes two logistic-regression steps per round."""
    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch.fl import quantize as qz
    from rayfed_tpu_torch.models import logistic

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((96, 16)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, 96).astype(np.int64))
    step = logistic.make_train_step(logistic.apply_logistic, lr=0.3)

    @fed.remote
    class Trainer:
        def train(self, params):
            packed = isinstance(params, tc.PackedTree)
            tree = tc.decompress(params, torch.float32) if packed else params
            for _ in range(2):
                tree, _ = step(tree, x, y)
            return tc.compress(tree, packed=True) if packed else tree

    qz.reset_compressors()
    fed.init(address="local", cluster=make_cluster(["solo"]), party="solo", device=CPU)
    try:
        params = logistic.init_logistic(16, 3, device=CPU)
        return fn(fed, {"solo": Trainer.party("solo").remote()}, params)
    finally:
        fed.shutdown()
        qz.reset_compressors()


def _server_opt(kind):
    from rayfed_tpu_torch.fl import fedopt, server_opt

    if kind == "legacy_adam":
        return fedopt.server_adam(lr=0.05), {}
    return server_opt.fedac(1.0, 3.0, 0.5), dict(compress_wire=True, packed_wire=True, streaming_agg=True)


@pytest.mark.parametrize("kind", ["legacy_adam", "packed_fedac"])
def test_run_fedavg_rounds_server_opt_resume(tmp_path, kind):
    """Six uninterrupted rounds against four with snapshots every second
    round and a fresh call that resumes from round 4: the same bytes.  A
    call whose target round the checkpoint has passed returns the
    checkpointed params untouched."""

    def body(fed, trainers, params):
        opt, kw = _server_opt(kind)
        reference = fed.fl.run_fedavg_rounds(trainers, params, rounds=6, server_opt=opt, **kw)
        ckpt = FedCheckpointer(str(tmp_path), "solo")
        seen = []
        fed.fl.run_fedavg_rounds(trainers, params, rounds=4, server_opt=_server_opt(kind)[0],
                                 checkpointer=ckpt, checkpoint_every=2,
                                 on_round=lambda r, _p: seen.append(r), **kw)
        assert seen == [0, 1, 2, 3]
        assert ckpt.rounds() == [2, 4]
        assert ckpt.load_metadata()["server_opt"] == describe_server_opt(opt)
        resumed = fed.fl.run_fedavg_rounds(trainers, params, rounds=6, server_opt=_server_opt(kind)[0],
                                           checkpointer=ckpt, checkpoint_every=2,
                                           on_round=lambda r, _p: seen.append(r), **kw)
        assert seen == [0, 1, 2, 3, 4, 5]
        for name in ("w", "b"):
            assert _raw(resumed[name]) == _raw(reference[name]), name
            assert resumed[name].device.type == "cpu"
        again = fed.fl.run_fedavg_rounds(trainers, params, rounds=4, server_opt=_server_opt(kind)[0],
                                         checkpointer=ckpt, **kw)
        assert all(_raw(again[k]) == _raw(resumed[k]) for k in ("w", "b"))
        # A run under another server optimizer refuses the snapshot.
        with pytest.raises(ValueError, match="server_opt mismatch"):
            fed.fl.run_fedavg_rounds(trainers, params, rounds=8, checkpointer=ckpt, **kw)

    _solo_rounds(body)


def test_run_fedavg_rounds_checkpointer_defaults_every_round(tmp_path):
    """A checkpointer with ``checkpoint_every`` left at 0 still saves, every
    round (the pipelined path is off under it)."""

    def body(fed, trainers, params):
        ckpt = FedCheckpointer(str(tmp_path / "solo"), party="solo")
        fed.fl.run_fedavg_rounds(trainers, params, rounds=3, checkpointer=ckpt)
        assert ckpt.rounds() == [1, 2, 3]
        _, snap = ckpt.restore(target={"params": params})
        assert set(snap) == {"params"} and snap["params"]["w"].device.type == "cpu"

    _solo_rounds(body)


def test_quorum_composes_with_checkpointer_validation():
    """quorum= x checkpointer= passes validation; checkpoint_every without a
    checkpointer still fails first."""
    with pytest.raises(ValueError, match="checkpoint_every set without"):
        ttrainer.run_fedavg_rounds({"a": object()}, {}, 1, quorum=1, compress_wire=True,
                                   packed_wire=True, checkpoint_every=2)
    kw = dict(quorum=1, compress_wire=True, packed_wire=True, checkpointer=object())
    assert ttrainer.validate_round_config({"a": None}, **kw)["checkpoint_every"] == 1


CKPT_TRAINERS = {"alice": None, "bob": None}


@pytest.mark.parametrize("every", [0, 1, 3])
def test_checkpoint_every_normalizes_as_the_reference(every):
    from rayfed_tpu.fl import trainer as jtrainer

    kw = dict(checkpointer=object(), checkpoint_every=every)
    port = ttrainer.validate_round_config(CKPT_TRAINERS, **kw)
    ref = jtrainer.validate_round_config(CKPT_TRAINERS, **kw)
    assert port == ref and port["checkpoint_every"] == (every or 1)


# -- a fully crashed two-party quorum cluster resumes --------------------------------

QUORUM_PARTIES = ["alice", "bob"]
PARTY_TIMEOUT_S = 120


def run_ckpt_party(party, cluster, outdir):
    import rayfed_tpu_torch as fed
    from tests.test_torch_quorum import DELTAS, DIM

    @fed.remote
    class Trainer:
        def __init__(self, delta):
            self._d = float(delta)

        def train(self, params):
            tree = tc.decompress(params, torch.float32)
            return tc.compress({"w": tree["w"] + self._d}, packed=True, wire_dtype=torch.float32)

    params = {"w": torch.zeros(DIM)}
    kw = dict(compress_wire=True, packed_wire=True, wire_dtype=torch.float32, quorum=2,
              round_deadline_s=30.0, checkpoint_every=1)

    def init():
        fed.init(address="local", cluster=cluster, party=party, device=CPU,
                 enable_waiting_for_other_parties_ready=True, recv_backstop_in_seconds=60)
        return {p: Trainer.party(p).remote(DELTAS[p]) for p in QUORUM_PARTIES}

    # Run A: two rounds, a snapshot at every boundary, then the whole
    # cluster stops.
    trainers = init()
    log_a: list = []
    fed.fl.run_fedavg_rounds(trainers, params, rounds=2, round_log=log_a,
                             checkpointer=FedCheckpointer(os.path.join(outdir, "ckpt"), party), **kw)
    fed.shutdown()
    # Every party down before any comes back (a round-2 push acknowledged
    # by a dying runtime would vanish with it).
    open(os.path.join(outdir, f"down.{party}"), "w").close()
    deadline = time.monotonic() + 60
    while not all(os.path.exists(os.path.join(outdir, f"down.{p}")) for p in QUORUM_PARTIES):
        assert time.monotonic() < deadline, "peers never finished run A"
        time.sleep(0.05)
    # Run B: fresh runtimes resume the same run from the snapshots (round
    # index, roster epoch, member log, session) and finish rounds 2..3.
    trainers = init()
    ckpt = FedCheckpointer(os.path.join(outdir, "ckpt"), party)
    log_b: list = []
    final = fed.fl.run_fedavg_rounds(trainers, params, rounds=4, round_log=log_b, checkpointer=ckpt, **kw)
    with open(os.path.join(outdir, f"{party}.json"), "w") as f:
        json.dump({"final": final["w"].numpy().tolist(), "log_a": log_a, "log_b": log_b,
                   "rounds": ckpt.rounds(), "meta": ckpt.load_metadata()}, f)
    fed.shutdown()


def _child(fn_name, party, args):
    import sys

    getattr(sys.modules[__name__], fn_name)(party, *args)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "rayfed_tpu"))
    assert not loaded, loaded


def test_quorum_checkpoint_restore_roundtrip(tmp_path):
    """quorum x checkpointer: the restored member log spans the restart and
    the final model equals the JAX package's replay over all four rounds."""
    from tests.test_torch_quorum import _replay

    cluster = make_cluster(QUORUM_PARTIES)
    ctx = mp.get_context("spawn")
    procs = {p: ctx.Process(target=_child, args=("run_ckpt_party", p, (cluster, str(tmp_path))))
             for p in QUORUM_PARTIES}
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
    assert {p: proc.exitcode for p, proc in procs.items()} == {p: 0 for p in QUORUM_PARTIES}
    rep = {p: json.loads((tmp_path / f"{p}.json").read_text()) for p in QUORUM_PARTIES}
    log_b = rep["alice"]["log_b"]
    assert [e["round"] for e in log_b] == [0, 1, 2, 3]
    assert log_b[:2] == rep["alice"]["log_a"]
    assert rep["bob"]["log_b"] == log_b
    assert rep["alice"]["rounds"] == [2, 3, 4]
    meta = rep["alice"]["meta"]
    assert meta["member_log"] == log_b and meta["members"] == QUORUM_PARTIES
    assert meta["coordinator"] == "alice" and meta["server_opt"] == {"kind": "none"}
    want, _ = _replay(log_b)
    for p in QUORUM_PARTIES:
        assert np.asarray(rep[p]["final"], np.float32).tobytes() == want.tobytes(), p
