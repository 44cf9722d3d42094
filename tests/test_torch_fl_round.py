"""The port's round loop (CPU): ``validate_round_config`` verdicts against
the JAX package's, ``run_fedavg_rounds`` in one party, and one mixed
two-process round.

The mixed run is this slice's one new party-process pair: alice runs the
port (the coordinator, folding on its device) and bob the JAX package,
both with logistic trainers, ``streaming_agg=True``, two rounds.  Both
parties must return the same bytes, equal to the JAX package's
``packed_weighted_sum`` of the round's contributions (tolerance: byte
identity).
"""

import itertools
import multiprocessing as mp
import sys
import time
import zlib

import numpy as np
import pytest
import torch

import rayfed_tpu_torch as fed
from rayfed_tpu_torch.fl import compression as tc
from rayfed_tpu_torch.fl import fedopt as tfedopt
from rayfed_tpu_torch.fl import trainer as ttrainer
from rayfed_tpu_torch.models import logistic
from tests.multiproc import make_cluster

CPU = torch.device("cpu")
TRAINERS = {"a": None, "b": None}


def _agg(values):
    return values[0]


# Options the port supports, each with a value that may clash with another.
# (This module imports no JAX at the top: the port's party process of the
# mixed round below imports it and must load no JAX.)
SGD = "server_sgd()"  # each package's own ServerOptimizer
FEDAC = "fedac()"  # each package's own packed server optimizer spec
SUPPORTED = [
    ("rounds", 0),
    ("server_opt", SGD),
    ("server_opt", FEDAC),
    ("server_opt", "not-an-optimizer"),
    ("weights", [1.0, 2.0]),
    ("compress_wire", True),
    ("packed_wire", True),
    ("checkpoint_every", 2),
    ("checkpoint_every", -1),
    ("sample", 1),
    ("sample", 5),
    ("aggregator", _agg),
    ("streaming_agg", True),
    ("error_feedback", True),
    ("mode", "bogus"),
    ("coordinator", "a"),
    ("coordinator", "zed"),
    ("ring_chunk_elems", 8),
    ("mode", "ring"),
    ("mode", "hierarchy"),
    ("region_size", 2),
    ("region_branch", 2),
    ("region_quorum", 1),
    ("region_deadline_s", 1.0),
    ("overlap", True),
    ("quorum", 1),
    ("quorum", 5),
    ("round_deadline_s", 1.0),
    ("round_deadline_s", -1.0),
    ("join_ticket", {}),
    ("round_log", []),
]
PAIRS = [
    (x, y) for x, y in itertools.combinations(SUPPORTED, 2) if x[0] != y[0]
]


def _verdict(fn, kwargs):
    try:
        return ("ok", fn(TRAINERS, **kwargs))
    except ValueError as e:
        return ("ValueError", str(e))


def _split(pair):
    from rayfed_tpu.fl import fedopt as jfedopt
    from rayfed_tpu.fl import server_opt as jso
    from rayfed_tpu_torch.fl import server_opt as tso

    ref_kw, port_kw = {}, {}
    for name, value in pair:
        if value is SGD:
            ref_kw[name], port_kw[name] = jfedopt.server_sgd(), tfedopt.server_sgd()
        elif value is FEDAC:
            ref_kw[name], port_kw[name] = jso.fedac(1.0, 3.0, 0.5), tso.fedac(1.0, 3.0, 0.5)
        else:
            ref_kw[name] = port_kw[name] = value
    return ref_kw, port_kw


def _pair_id(pair):
    """A test id that is the same in every process (no object addresses)."""
    return "+".join(
        f"{name}={getattr(value, '__name__', None) or repr(value)}" for name, value in pair
    )


@pytest.mark.parametrize("pair", PAIRS, ids=_pair_id)
def test_validate_round_config_verdicts_equal_the_reference(pair):
    from rayfed_tpu.fl import trainer as jtrainer

    ref_kw, port_kw = _split(pair)
    assert _verdict(ttrainer.validate_round_config, port_kw) == _verdict(
        jtrainer.validate_round_config, ref_kw
    )


# The port's features of tests/test_composition_matrix.py, pairwise (and its
# quorum x ring x quant triple): each merged configuration gets the
# reference's verdict.
PORTED_FEATURES = ("wire_quant", "quorum", "ring", "server_opt", "server_opt_legacy", "streaming_agg",
                   "error_feedback", "sample", "hierarchy", "overlap", "checkpointer", "secure_agg")


def _feature(name, which):
    from rayfed_tpu_torch.fl import server_opt as tso
    from tests import test_composition_matrix as cm

    frag = dict(cm.FEATURES[name])
    if name == "server_opt_legacy" and which == "port":
        frag["server_opt"] = tfedopt.server_sgd(0.5, 0.9)
    if name == "server_opt" and which == "port":
        frag["server_opt"] = tso.fedac(1.0, 3.0, 0.5)
    return frag


@pytest.mark.parametrize("a,b", list(itertools.combinations(PORTED_FEATURES, 2)), ids=lambda v: str(v))
def test_composition_pairs_equal_the_reference(a, b):
    from rayfed_tpu.fl import trainer as jtrainer
    from tests import test_composition_matrix as cm

    trainers = dict(cm.PARTIES)
    merged = {w: cm._merge({a, b}, _feature(a, w), _feature(b, w)) for w in ("ref", "port")}
    if merged["ref"] is None:
        assert merged["port"] is None
        return

    def verdict(fn, kw):
        try:
            return ("ok", fn(trainers, **kw))
        except ValueError as e:
            return ("ValueError", str(e))

    assert verdict(ttrainer.validate_round_config, merged["port"]) == verdict(
        jtrainer.validate_round_config, merged["ref"])


def test_quorum_ring_quant_triple_equals_the_reference():
    from rayfed_tpu.fl import trainer as jtrainer

    kw = dict(quorum=2, round_deadline_s=5.0, mode="ring", wire_quant="uint8", compress_wire=True,
              packed_wire=True, ring_chunk_elems=64)
    trainers = {f"p{i}": None for i in range(4)}
    assert ttrainer.validate_round_config(trainers, **kw) == jtrainer.validate_round_config(trainers, **kw)


@pytest.mark.parametrize("option,item", [
    ({"secure_agg": True}, "item 8"),
    ({"checkpointer": object()}, "item 9"),
])
def test_unported_options_name_their_item(option, item):
    if "secure_agg" in option:
        # Item 8 is ported: secure_agg gets the JAX package's verdict, here
        # its ValueError without wire_quant.
        with pytest.raises(ValueError, match="secure_agg requires wire_quant"):
            ttrainer.validate_round_config(TRAINERS, compress_wire=True, packed_wire=True, **option)
        return
    # Item 9 is ported: the checkpointer gets the JAX package's verdicts.
    from rayfed_tpu.fl import trainer as jtrainer

    for clash, match in [
        ({"checkpointer": None, "checkpoint_every": 2}, "checkpoint_every set without a checkpointer"),
        ({"checkpoint_every": -1}, "checkpoint_every must be >= 0"),
        ({"overlap": True}, r"overlap=True is incompatible with \['checkpointer'\]"),
    ]:
        for validate in (ttrainer.validate_round_config, jtrainer.validate_round_config):
            with pytest.raises(ValueError, match=match):
                validate(TRAINERS, compress_wire=True, packed_wire=True, **{**option, **clash})
    assert ttrainer.validate_round_config(TRAINERS, **option)["checkpoint_every"] == 1


@pytest.mark.parametrize("option,match", [
    ({"region_branch": 2}, "region_branch only applies"),
    ({"mode": "hierarchy", "region_size": 1}, "requires wire_quant"),
    ({"region_size": 2}, "region_size only applies"),
    ({"region_quorum": 1}, "region_quorum only applies"),
    ({"region_deadline_s": 1.0}, "needs region_quorum"),
    ({"mode": "hierarchy", "wire_quant": "uint8"}, "requires region_size"),
    ({"mode": "hierarchy", "wire_quant": "uint8", "region_size": 2, "overlap": True},
     "incompatible with mode='hierarchy'"),
    ({"overlap": True, "quorum": 2}, r"quorum is incompatible with \['overlap'\]"),
    ({"overlap": True, "error_feedback": True}, "overlap=True is incompatible with"),
], ids=lambda v: v if isinstance(v, str) else "+".join(sorted(v)))
def test_hierarchy_and_overlap_options_give_the_reference_errors(option, match):
    """The options that raised ``NotImplementedError`` (Queue A item 7)
    until the hierarchy and the pipelined rounds were ported now give the
    JAX package's ``ValueError`` for each clash."""
    from rayfed_tpu.fl import trainer as jtrainer

    kw = dict(compress_wire=True, packed_wire=True, **option)
    with pytest.raises(ValueError, match=match):
        ttrainer.validate_round_config(TRAINERS, **kw)
    assert _verdict(ttrainer.validate_round_config, kw) == _verdict(jtrainer.validate_round_config, kw)


def test_sample_parties_equals_the_reference():
    from rayfed_tpu.fl import trainer as jtrainer

    for seed, r in ((0, 0), (3, 7), (11, 2)):
        assert ttrainer.sample_parties(["c", "a", "b", "d"], 2, seed, r) == jtrainer.sample_parties(
            ["c", "a", "b", "d"], 2, seed, r)
    assert ttrainer.QUANT_DELTA_EXPAND == 4.0


# -- one party, in process ----------------------------------------------------


D, CLASSES, N = 16, 3, 128


def _data(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    w = np.random.default_rng(9).standard_normal((D, CLASSES)).astype(np.float32)
    return x, np.argmax(x @ w, axis=-1).astype(np.int32)


@fed.remote
class PortTrainer:
    def __init__(self, seed):
        x, y = _data(seed)
        self._x, self._y = torch.from_numpy(x), torch.from_numpy(y)
        self._step = logistic.make_train_step(logistic.apply_logistic, lr=0.3)
        self.contrib = None

    def train(self, params):
        params = tc.decompress(params, torch.float32)
        for _ in range(2):
            params, _ = self._step(params, self._x, self._y)
        self.contrib = tc.compress(params, packed=True)
        return self.contrib

    def last(self):
        return self.contrib

    def loss(self, params):
        return float(logistic.softmax_cross_entropy(logistic.apply_logistic(params, self._x), self._y))


@pytest.fixture()
def solo():
    cluster = make_cluster(["solo"])
    fed.init(address="local", cluster=cluster, party="solo", device=CPU)
    yield {"solo": PortTrainer.party("solo").remote(1)}
    fed.shutdown()


@pytest.mark.parametrize("kw", [
    {"compress_wire": True, "packed_wire": True, "streaming_agg": True},
    {"compress_wire": True, "packed_wire": True, "error_feedback": True},
    {"compress_wire": True},
    {"compress_wire": True, "packed_wire": True, "server_opt": "sgd-momentum"},
], ids=["streaming", "error-feedback", "per-leaf-wire", "server-opt"])
def test_one_party_rounds_run(solo, kw):
    kw = dict(kw)
    if kw.get("server_opt") == "sgd-momentum":
        kw["server_opt"] = tfedopt.server_sgd(lr=1.0, momentum=0.5)
    params = logistic.init_logistic(D, CLASSES, device=CPU)
    first = fed.get(solo["solo"].loss.remote(params))
    seen, timings = [], []
    final = fed.fl.run_fedavg_rounds(
        solo, params, rounds=3, on_round=lambda r, p: seen.append(r), timings=timings, **kw
    )
    assert seen == [0, 1, 2] and len(timings) == 3
    assert set(timings[0]) >= {"local_s", "push_s", "agg_s", "hidden_s", "round"}
    assert final["w"].dtype == torch.float32 and final["w"].device.type == "cpu"
    assert fed.get(solo["solo"].loss.remote(final)) < first
    if kw.get("streaming_agg"):
        # One party: the streamed mean of one contribution is that contribution.
        last = fed.get(solo["solo"].last.remote())
        assert torch.equal(final["w"], tc.decompress(last)["w"])


def test_one_party_rounds_validate_before_running(solo):
    with pytest.raises(ValueError, match="streaming_agg requires"):
        fed.fl.run_fedavg_rounds(solo, {}, rounds=1, streaming_agg=True)
    with pytest.raises(ValueError, match="overlap=True requires compress_wire"):
        fed.fl.run_fedavg_rounds(solo, {}, rounds=1, overlap=True)


# -- the mixed two-process round ------------------------------------------------


PARTY_TIMEOUT_S = 60


def _fingerprint(tree):
    """CRC of a tree's packed f32 bytes, the same in either package."""
    leaves = sorted(tree.items())
    return zlib.crc32(b"".join(np.ascontiguousarray(np.asarray(v, np.float32)).tobytes()
                               for _, v in leaves))


def run_mixed_round(party, cluster):
    """alice: the port (coordinator); bob: the JAX package."""
    if party == "bob":
        import jax
        import jax.numpy as jnp

        import rayfed_tpu as pkg
        from rayfed_tpu.fl import compression as C
        from rayfed_tpu.fl import fedavg as F
        from rayfed_tpu.fl import run_fedavg_rounds
        from rayfed_tpu.models import logistic as L

        @pkg.remote
        class Trainer:
            def __init__(self, seed):
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
        params = jax.tree_util.tree_map(
            jnp.asarray, {"w": np.zeros((D, CLASSES), np.float32), "b": np.zeros(CLASSES, np.float32)})

        def host(tree):
            return {k: np.asarray(v) for k, v in tree.items()}

        def fold(contribs):
            return host(C.decompress(F.packed_weighted_sum(contribs), jnp.float32))
    else:
        pkg = fed
        Trainer = PortTrainer
        pkg.init(address="local", cluster=cluster, party=party, device=CPU)
        params = logistic.init_logistic(D, CLASSES, device=CPU)

        def host(tree):
            return {k: v.numpy() for k, v in tree.items()}

        def fold(contribs):
            return host(tc.decompress(fed.fl.packed_weighted_sum(contribs)))

    trainers = {p: Trainer.party(p).remote(i + 1) for i, p in enumerate(("alice", "bob"))}
    final = (run_fedavg_rounds if party == "bob" else fed.fl.run_fedavg_rounds)(
        trainers, params, rounds=2, compress_wire=True, packed_wire=True, streaming_agg=True,
    )
    got = host(final)
    contribs = pkg.get([trainers[p].last.remote() for p in ("alice", "bob")])
    want = fold(contribs)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k
    fp = pkg.remote(lambda t: _fingerprint(host(t)))
    fps = pkg.get([fp.party(p).remote(final) for p in ("alice", "bob")])
    assert fps[0] == fps[1] == _fingerprint(got), fps
    pkg.shutdown()


def _port_child(fn_name, party, args):
    getattr(sys.modules[__name__], fn_name)(party, *args)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "rayfed_tpu"))
    assert not loaded, loaded


def test_mixed_jax_and_port_streaming_round():
    from tests.multiproc import _CHILD_ENV, _child_entry

    cluster = make_cluster(["alice", "bob"])
    ctx = mp.get_context("spawn")
    procs = {
        "alice": ctx.Process(target=_port_child, args=("run_mixed_round", "alice", (cluster,))),
        "bob": ctx.Process(target=_child_entry,
                           args=(_CHILD_ENV, __name__, "run_mixed_round", "bob", (cluster,))),
    }
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
    assert {p: proc.exitcode for p, proc in procs.items()} == {"alice": 0, "bob": 0}
