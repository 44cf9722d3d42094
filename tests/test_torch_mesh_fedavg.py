"""``tests/test_mesh_fedavg.py``'s program on the port: FedAvg between MESH
parties, each party a world of two processes.

Each party (alice, bob) spans two gloo ranks on the CPU with the party
mesh ``{"fsdp": 2}``; its trainer holds the weight ``Shard(0)`` over
``fsdp`` (half the rows a process) and updates it there.  A process holds
only its half, so a contribution crosses parties as the whole value: the
trainer gathers it (``Replicate()``, all the mesh's processes holding all
of it), the leader pushes it shard-streamed with its layout, the peer's
leader re-pushes it to its second process over the bridge, and both decode
it onto their own mesh (``resolve_sharding``: a DTensor, no host
re-assembly).  The round mean runs on DTensors; the next round's trainer
re-shards the mean locally (no data moves) and trains on.  Tolerance:
``rtol=1e-6``, as the reference's.
"""

import multiprocessing as mp
import time

import numpy as np

from tests.multiproc import get_free_ports

PARTIES = ("alice", "bob")
ROWS, COLS = 2048, 1024  # 8.4 MB f32 — above the 8 MB shard-stream bar
RUN_TIMEOUT_S = 120


def _w0():
    return np.arange(ROWS * COLS, dtype=np.float32).reshape(ROWS, COLS) / 1e6


def _run_mesh_party(party, rank, ports, q):
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch.fl import aggregate
    from rayfed_tpu_torch.runtime import get_runtime
    from rayfed_tpu_torch.transport import wire

    cluster = {p: {"address": f"127.0.0.1:{ports[p]}"} for p in PARTIES}
    fed.init(address="local", cluster=cluster, party=party, device="cpu",
             coordinator_address=f"127.0.0.1:{ports[party + '_coord']}", num_party_processes=2,
             party_process_id=rank, mesh_shape={"fsdp": 2})
    mesh = get_runtime().mesh
    assert mesh is not None and mesh.size() == 2

    @fed.remote
    class Trainer:
        """Party-pinned trainer holding fsdp-sharded params on its mesh."""

        def __init__(self, scale: float):
            self._scale = scale

        def train(self, params):
            # A tree from another party has LANDED on this party's mesh:
            # its layout resolved against the local mesh, a DTensor here.
            w = params["w"]
            assert isinstance(w, DTensor) and w.device_mesh is get_runtime().mesh, type(w)
            w = w.redistribute(placements=[Shard(0)])  # from Replicate: local, no collective
            assert w.to_local().shape == (ROWS // 2, COLS)
            out = w + self._scale
            assert tuple(out.placements) == (Shard(0),)
            # The whole update in every process of the party: the push's form.
            return {"w": out.redistribute(placements=[Replicate()]), "b": params["b"] + self._scale}

    trainers = {p: Trainer.party(p).remote(float(i + 1)) for i, p in enumerate(PARTIES)}
    w = torch.from_numpy(_w0())
    assert w.numel() * 4 >= wire.SHARD_STREAM_THRESHOLD
    params = {"w": distribute_tensor(w, mesh, [Shard(0)]), "b": torch.zeros(COLS)}

    # One FedAvg round, all-to-all at N=2: each party fetches the peer's
    # contribution over the wire and averages locally.
    avg = aggregate([trainers[p].train.remote(params) for p in PARTIES])
    expected = _w0() + 1.5
    assert isinstance(avg["w"], DTensor) and avg["w"].device_mesh is mesh
    np.testing.assert_allclose(avg["w"].full_tensor().numpy(), expected, rtol=1e-6)
    np.testing.assert_allclose(avg["b"].numpy(), np.full((COLS,), 1.5), rtol=1e-6)

    # The second round consumes the averaged tree directly.
    avg2 = aggregate([trainers[p].train.remote(avg) for p in PARTIES])
    np.testing.assert_allclose(avg2["w"].full_tensor().numpy(), expected + 1.5, rtol=1e-6)
    fed.shutdown()
    q.put((party, rank))


def test_mesh_party_fedavg_sharded_wire():
    free = get_free_ports(4)
    ports = {"alice": free[0], "bob": free[1], "alice_coord": free[2], "bob_coord": free[3]}
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_run_mesh_party, args=(p, r, ports, q), name=f"{p}-{r}")
             for p in PARTIES for r in (0, 1)]
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + RUN_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        codes = {p.name: p.exitcode for p in procs}
        assert all(c == 0 for c in codes.values()), codes
        done = sorted(q.get(timeout=5) for _ in procs)
        assert done == [(p, r) for p in PARTIES for r in (0, 1)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
