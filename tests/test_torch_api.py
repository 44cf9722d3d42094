"""The port's federated API (CPU, ``device="cpu"``): ports of
tests/test_api.py and tests/test_executor.py, a two-process run of
tests/test_simple_example.py's program, and a mixed two-party run in which
one party runs the JAX package and the other the port, on one driver.

This module imports neither JAX nor the JAX package at its top: the
port's party processes import it to find their entry, and must not load
JAX.  Tolerance: exact values, arrays byte for byte.
"""

import multiprocessing as mp
import sys
import time

import numpy as np
import pytest
import torch

import rayfed_tpu_torch as fed
from rayfed_tpu_torch.api import _get_cluster, _get_party, _get_tls
from rayfed_tpu_torch.executor import ActorInstance, LocalRef, TaskExecutor, is_local_refs
from rayfed_tpu_torch.runtime import get_runtime_or_none
from tests.multiproc import make_cluster

CPU = "cpu"
PARTY_TIMEOUT_S = 150


# -- ports of tests/test_api.py -------------------------------------------------


def test_init_and_shutdown():
    cluster = make_cluster(["test_party"])
    runtime = fed.init(address="local", cluster=cluster, party="test_party", device=CPU)
    assert _get_party() == "test_party"
    assert _get_cluster() == {"test_party": cluster["test_party"]["address"]}
    assert _get_tls() is None
    assert runtime.transport.device == torch.device("cpu")
    fed.shutdown()
    assert get_runtime_or_none() is None


def test_single_party_task_and_actor():
    cluster = make_cluster(["solo"])
    fed.init(address="local", cluster=cluster, party="solo", device=CPU)

    @fed.remote
    def double(x):
        return 2 * x

    @fed.remote
    class Acc:
        def __init__(self, v0):
            self.v = v0

        def add(self, d):
            self.v += d
            return self.v

    o = double.party("solo").remote(21)
    assert fed.get(o) == 42
    t = double.party("solo").remote(torch.arange(3))
    assert torch.equal(fed.get(t), torch.tensor([0, 2, 4]))

    acc = Acc.party("solo").remote(10)
    r1 = acc.add.remote(5)
    r2 = acc.add.remote(fed.get(r1))
    assert fed.get(r2) == 30
    fed.shutdown()


def test_num_returns_local():
    cluster = make_cluster(["solo"])
    fed.init(address="local", cluster=cluster, party="solo", device=CPU)

    @fed.remote
    def pair():
        return 1, 2

    a, b = pair.party("solo").options(num_returns=2).remote()
    assert fed.get(a) == 1 and fed.get(b) == 2
    fed.shutdown()


def test_seq_id_reset_on_reinit():
    cluster = make_cluster(["solo"])
    fed.init(address="local", cluster=cluster, party="solo", device=CPU)

    @fed.remote
    def f():
        return 0

    o1 = f.party("solo").remote()
    assert o1.get_fed_task_id() == "1#0"
    fed.shutdown()

    fed.init(address="local", cluster=make_cluster(["solo"]), party="solo", device=CPU)
    o2 = f.party("solo").remote()
    assert o2.get_fed_task_id() == "1#0"
    fed.shutdown()


def test_cleanup_thread_lifecycle():
    for _ in range(3):
        cluster = make_cluster(["solo"])
        runtime = fed.init(address="local", cluster=cluster, party="solo", device=CPU)
        assert runtime.cleanup_manager.check_thread_alive
        cm = runtime.cleanup_manager
        fed.shutdown()
        assert not cm.check_thread_alive


def _one_rank_mesh():
    from rayfed_tpu_torch.parallel.mesh import single_device_mesh

    return {"mesh": single_device_mesh(CPU)}


def _one_process_party():
    from tests.multiproc import get_free_ports

    return {"coordinator_address": f"127.0.0.1:{get_free_ports(1)[0]}", "num_party_processes": 1,
            "party_process_id": 0, "mesh_shape": {"dp": 1}}


@pytest.mark.parametrize(
    "make_kwargs",
    [lambda: {"mesh_shape": {"dp": 1}}, _one_rank_mesh, _one_process_party],
    ids=["mesh_shape", "mesh", "multi_host"],
)
def test_unported_init_options_raise(make_kwargs):
    """The party-mesh and multi-process options of fed.init (once refused):
    each builds the party's DeviceMesh, a one-rank world for a one-process
    party; a shape whose size is not the party's process count, and a
    coordinator without its process count and id, raise ValueError as the
    JAX package does."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    kwargs = make_kwargs()
    cluster = make_cluster(["solo"])
    runtime = fed.init(address="local", cluster=cluster, party="solo", device=CPU, **kwargs)
    try:
        assert isinstance(runtime.mesh, DeviceMesh)
        assert runtime.mesh.mesh_dim_names == ("dp",) and runtime.mesh.size() == 1
        assert fed.get(fed.remote(lambda x: 2 * x).party("solo").remote(21)) == 42
        if "coordinator_address" in kwargs:
            assert runtime.transport.get_stats()["party_num_processes"] == 1
    finally:
        fed.shutdown()
    if "mesh" in kwargs:  # the caller's world stays the caller's
        assert dist.is_initialized()
        dist.destroy_process_group()
    assert not dist.is_initialized()
    assert get_runtime_or_none() is None

    bad = dict(kwargs, mesh_shape={"dp": 2}) if "mesh" not in kwargs else {"mesh_shape": {"dp": 2}}
    if "coordinator_address" in bad:
        bad["coordinator_address"] = _one_process_party()["coordinator_address"]
    with pytest.raises(ValueError, match=r"requires 2 devices, but 1 are visible"):
        fed.init(address="local", cluster=cluster, party="solo", device=CPU, **bad)
    assert not dist.is_initialized() and get_runtime_or_none() is None
    with pytest.raises(ValueError, match="num_party_processes"):
        fed.init(address="local", cluster=cluster, party="solo", device=CPU,
                 coordinator_address="127.0.0.1:1")
    assert get_runtime_or_none() is None


def test_join_and_leave_raise():
    # Elastic membership is ported (fl.quorum, its own tests): without a
    # runtime there is no roster to join or leave, and both say so.
    with pytest.raises(RuntimeError, match="fed.init"):
        fed.join("alice")
    with pytest.raises(RuntimeError, match="fed.init"):
        fed.leave()
    # The coordinator cannot join its own run.
    fed.init(address="local", cluster=make_cluster(["solo"]), party="solo", device=CPU)
    try:
        with pytest.raises(ValueError, match="cannot join its own run"):
            fed.join("solo")
    finally:
        fed.shutdown()


def test_metrics_snapshot_leaves_out_unported_sections():
    fed.init(address="local", cluster=make_cluster(["solo"]), party="solo", device=CPU)
    try:
        snap = fed.metrics_snapshot()
        # Every section of the reference's snapshot, "async" included
        # since fl.async_rounds is ported.
        assert set(snap) == {"transport", "secagg", "object_plane", "telemetry", "quorum", "async"}
        assert snap["quorum"].keys() == {"coordinator_failovers", "graceful_handovers"}
        assert {"versions_emitted", "folds", "staleness_hist", "recoded_stale"} <= snap["async"].keys()
        assert "send_op_count" in snap["transport"]
    finally:
        fed.shutdown()


# -- ports of tests/test_executor.py --------------------------------------------


@pytest.fixture()
def executor():
    ex = TaskExecutor(max_workers=4)
    yield ex
    ex.shutdown()


def test_submit_and_resolve(executor):
    assert executor.submit(lambda a, b: a + b, (1, 2), {}).resolve() == 3


def test_top_level_ref_resolution(executor):
    dep = executor.submit(lambda: 40, (), {})
    assert executor.submit(lambda x: x + 2, (dep,), {}).resolve() == 42


def test_nested_refs_not_resolved(executor):
    dep = executor.submit(lambda: 1, (), {})

    def consumer(container):
        assert isinstance(container[0], LocalRef)
        return container[0].resolve() + 1

    assert executor.submit(consumer, ([dep],), {}).resolve() == 2


def test_num_returns(executor):
    refs = executor.submit(lambda: (1, 2, 3), (), {}, num_returns=3)
    assert [r.resolve() for r in refs] == [1, 2, 3]


def test_num_returns_mismatch(executor):
    refs = executor.submit(lambda: (1, 2), (), {}, num_returns=3)
    with pytest.raises(ValueError):
        refs[0].resolve()


def test_exception_propagates(executor):
    def boom():
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        executor.submit(boom, (), {}).resolve()


def test_is_local_refs():
    assert is_local_refs(LocalRef.from_value(1))
    assert is_local_refs([LocalRef.from_value(1), LocalRef.from_value(2)])
    assert not is_local_refs([LocalRef.from_value(1), 2])
    assert not is_local_refs(3)
    assert not is_local_refs([])


class Counter:
    def __init__(self, start):
        self.value = start

    def add(self, n):
        v = self.value  # non-atomic on purpose: serial execution keeps it right
        time.sleep(0.001)
        self.value = v + n
        return self.value

    def get(self):
        return self.value


def test_actor_serial_execution():
    actor = ActorInstance(Counter, (0,), {})
    refs = [actor.call_method("add", (1,), {}) for _ in range(20)]
    assert refs[-1].resolve() == 20
    assert actor.call_method("get", (), {}).resolve() == 20
    actor.kill()
    with pytest.raises(RuntimeError):
        actor.call_method("get", (), {})


def test_actor_constructor_failure_surfaces():
    class Bad:
        def __init__(self):
            raise ValueError("ctor failed")

        def m(self):
            return 1

    actor = ActorInstance(Bad, (), {})
    with pytest.raises(ValueError, match="ctor failed"):
        actor.call_method("m", (), {}).resolve()


# -- party processes ------------------------------------------------------------


def _port_child_entry(fn_name, party, args):
    """Entry of a port party process: it runs the driver and must not have
    loaded JAX or the JAX package."""
    getattr(sys.modules[__name__], fn_name)(party, *args)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "rayfed_tpu"))
    assert not loaded, loaded


def _run(entries):
    """Run ``{party: (target, args)}``, one spawned process each; every
    process must exit 0 within PARTY_TIMEOUT_S, or the run fails."""
    ctx = mp.get_context("spawn")
    procs = {p: ctx.Process(target=t, args=a, name=f"party-{p}") for p, (t, a) in entries.items()}
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
    codes = {p: proc.exitcode for p, proc in procs.items()}
    assert all(c == 0 for c in codes.values()), codes


def run_simple_example(party, cluster):
    """tests/test_simple_example.py's program on the port."""

    @fed.remote
    class MyActor:
        def __init__(self, party, data):
            self._data = data
            self._party = party

        def f(self):
            return f"f({self._party})"

        def g(self, obj):
            return obj + "g"

        def h(self, obj):
            return obj + "h"

    @fed.remote
    def agg_fn(obj1, obj2):
        return f"agg-{obj1}-{obj2}"

    fed.init(address="local", cluster=cluster, party=party, device=CPU)
    actor_alice = MyActor.party("alice").remote(party, 123)
    actor_bob = MyActor.party("bob").remote(party, 789)
    obj_alice_g = actor_alice.g.remote(actor_alice.f.remote())
    obj_bob_h = actor_bob.h.remote(actor_bob.f.remote())
    obj = agg_fn.party("bob").remote(obj_alice_g, obj_bob_h)
    result = fed.get(obj)
    assert result == "agg-f(alice)g-f(bob)h", result
    fed.shutdown()


def test_simple_example_two_port_processes():
    cluster = make_cluster(["alice", "bob"])
    _run({p: (_port_child_entry, ("run_simple_example", p, (cluster,))) for p in ("alice", "bob")})


def _expected(seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    h = rng.standard_normal((8, 8)).astype(np.float32)
    return w, h


def run_mixed(party, cluster, jax_party):
    """One driver, two packages: ``jax_party`` runs the JAX package, the
    other the port.  Each party produces arrays of its own framework,
    each result crosses to the other party (both directions), is doubled
    there, and both parties ``fed.get`` every result."""
    if party == jax_party:
        import jax
        import jax.numpy as jnp
        import ml_dtypes
        import rayfed_tpu as pkg

        def make(x, bf16=False):
            return jnp.asarray(x.astype(ml_dtypes.bfloat16) if bf16 else x)

        def raw(v):
            return np.asarray(v).tobytes()

        native = jax.Array
        init_kw = {}
    else:
        pkg = fed

        def make(x, bf16=False):
            t = torch.from_numpy(np.asarray(x))
            return t.to(torch.bfloat16) if bf16 else t

        def raw(v):
            return v.reshape(-1).view(torch.uint8).numpy().tobytes()

        native = torch.Tensor
        init_kw = {"device": CPU}

    @pkg.remote
    def produce(seed):
        w, h = _expected(seed)
        return {"w": make(w), "h": make(h, bf16=True), "s": make(w[0, 0]), "n": w[:2], "tag": f"p{seed}"}

    @pkg.remote
    def double(v):
        assert all(isinstance(v[k], native) for k in ("w", "h", "s")), [type(v[k]) for k in v]
        return {"w": v["w"] * 2, "h": v["h"] * 2, "s": v["s"] * 2, "n": v["n"] * 2, "tag": v["tag"] + "!"}

    pkg.init(address="local", cluster=cluster, party=party, **init_kw)
    from_alice = double.party("bob").remote(produce.party("alice").remote(1))
    from_bob = double.party("alice").remote(produce.party("bob").remote(2))
    for seed, obj in ((1, from_alice), (2, from_bob)):
        got = pkg.get(obj)
        w, h = _expected(seed)
        h2 = torch.from_numpy(h).to(torch.bfloat16) * 2  # exact in bf16
        assert all(isinstance(got[k], native) for k in ("w", "h", "s")), got
        assert raw(got["w"]) == (w * 2).tobytes()
        assert tuple(got["s"].shape) == () and raw(got["s"]) == (w[0, 0] * 2).tobytes()
        assert raw(got["h"]) == h2.view(torch.int16).numpy().tobytes()
        assert np.array_equal(got["n"], w[:2] * 2) and got["tag"] == f"p{seed}!"
    pkg.shutdown()


@pytest.mark.parametrize("jax_party", ["alice", "bob"])
def test_mixed_jax_and_port_parties(jax_party):
    from tests.multiproc import _CHILD_ENV, _child_entry

    cluster = make_cluster(["alice", "bob"])
    entries = {}
    for party in ("alice", "bob"):
        args = (cluster, jax_party)
        if party == jax_party:
            entries[party] = (_child_entry, (_CHILD_ENV, __name__, "run_mixed", party, args))
        else:
            entries[party] = (_port_child_entry, ("run_mixed", party, args))
    _run(entries)
