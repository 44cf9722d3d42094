"""A party of two processes (``tests/test_multihost.py``'s bulk case), mixed.

Party ``alice`` runs the port in two processes, one world of two gloo
ranks on the CPU with the party mesh ``{"dp": 2}``; only process 0 runs
the wire transport.  Party ``bob`` runs the JAX package in one process
with two CPU devices and pushes an array sharded ``P("dp", None)`` over
them.  It reaches alice's leader shard by shard, the leader re-pushes the
raw payload to alice's second process over the bridge, and each alice
process decodes onto her DeviceMesh (``decode_payload(mesh=)``): a DTensor
``Shard(0)`` holding its own rows.  Re-encoding that DTensor hits the
"non-fully-addressable" guard, and an all-reduce over her mesh gives the
sum, which bob receives back.  Tolerance: exact (each shard byte for byte,
the sum in f64 over integers).

This module imports neither JAX nor the JAX package at its top: alice's
processes import it to find their entry, and must not load JAX.
"""

import multiprocessing as mp
import sys
import time

import numpy as np

from tests.multiproc import _CHILD_ENV, get_free_ports

ROWS, COLS = 2048, 2048  # 16 MB f32: above the 8 MB shard-stream threshold
RUN_TIMEOUT_S = 120


def _data():
    return (np.arange(ROWS * COLS) % 1021).astype(np.float32).reshape(ROWS, COLS)


def _program(fed, q, role, rank):
    @fed.remote
    def make_big():  # bob, the JAX package
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from rayfed_tpu.api import get_runtime

        return jax.device_put(jnp.asarray(_data()), NamedSharding(get_runtime().mesh, P("dp", None)))

    @fed.remote
    def alice_check(x):  # each alice process, the port
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor, Shard

        from rayfed_tpu_torch.parallel import collectives as coll
        from rayfed_tpu_torch.runtime import get_runtime
        from rayfed_tpu_torch.transport import wire

        mesh = get_runtime().mesh
        assert isinstance(x, DTensor) and x.device_mesh is mesh, type(x)
        assert tuple(x.placements) == (Shard(0),) and tuple(x.shape) == (ROWS, COLS)
        r = dist.get_rank()
        local = x.to_local()
        half = ROWS // 2
        assert local.numpy().tobytes() == _data()[r * half:(r + 1) * half].tobytes()
        try:
            wire.encode_payload({"x": x})
        except ValueError as e:
            assert "non-fully-addressable" in str(e), e
        else:
            raise AssertionError("encode guard did not fire")
        total = coll.all_reduce_sum(local.double().sum(), mesh.get_group("dp"))
        return float(total)

    big = make_big.party("bob").remote()
    out = fed.get(alice_check.party("alice").remote(big))
    assert out == float(_data().astype(np.float64).sum()), out
    fed.shutdown()
    q.put((role, rank, out))


def _alice(rank, coord_port, cluster, q):
    import rayfed_tpu_torch as fed

    fed.init(address="local", cluster=cluster, party="alice", device="cpu",
             coordinator_address=f"127.0.0.1:{coord_port}", num_party_processes=2,
             party_process_id=rank, mesh_shape={"dp": 2})
    _program(fed, q, "alice", rank)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "rayfed_tpu"))
    assert not loaded, loaded


def _bob(coord_port, cluster, q):
    import os

    os.environ.update(_CHILD_ENV)
    from rayfed_tpu.utils import force_cpu_devices

    force_cpu_devices(2)
    import rayfed_tpu as fed

    fed.init(address="local", cluster=cluster, party="bob", mesh_shape={"dp": 2})
    _program(fed, q, "bob", 0)


def _reap(procs, timeout=10):
    """Terminate, then SIGKILL, every member and join it (a member parked
    in ``fed.get`` must not outlive the test)."""
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(timeout)
        if p.is_alive():
            p.kill()
            p.join(10)


def test_bulk_sharded_push_to_two_process_party():
    coord_port, alice_port, bob_port = get_free_ports(3)
    cluster = {
        "alice": {"address": f"127.0.0.1:{alice_port}"},
        "bob": {"address": f"127.0.0.1:{bob_port}"},
    }
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_alice, args=(r, coord_port, cluster, q), name=f"alice-{r}") for r in (0, 1)]
    procs.append(ctx.Process(target=_bob, args=(coord_port, cluster, q), name="bob-0"))
    for p in procs:
        p.start()
    try:
        results, deadline = [], time.monotonic() + RUN_TIMEOUT_S
        while len(results) < len(procs) and time.monotonic() < deadline:
            try:
                results.append(q.get(timeout=2))
            except Exception:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
        for p in procs:
            p.join(30)
        codes = [p.exitcode for p in procs]
        assert len(results) == len(procs), f"member crashed or hung; exit codes {codes}"
        assert codes == [0, 0, 0], codes
        assert sorted((role, rank) for role, rank, _ in results) == [("alice", 0), ("alice", 1), ("bob", 0)]
    finally:
        _reap(procs)
