"""FedAvg between MESH parties (BASELINE config #3's program shape), on the
PyTorch port.

Each party is a mesh of its processes, one card a process (two here, in
one gloo world; on one card they share it): its model is fsdp-sharded
over the party mesh (``Shard(0)``), gathered whole (``Replicate()``)
before it crosses the wire, where it streams per shard; it lands on the
peer's mesh via the sender's sharding description (``resolve_sharding``:
each process cuts its own shard, no host re-assembly), and the round
average runs as DTensor arithmetic.  The cross-party hop is the only
"DCN" traffic; everything inside a party rides the mesh.

Where ``examples/mesh_fedavg.py`` makes a party one process with 8
virtual devices, a party here is two processes (``coordinator_address``,
``num_party_processes=2``, ``mesh_shape={"fsdp": 2}``): a party mesh is
made of the party's processes.

Run both parties in one go (spawns four processes):

    python examples_torch/mesh_fedavg.py

or one party (its two processes) per terminal, or one process of it:

    python examples_torch/mesh_fedavg.py alice
    python examples_torch/mesh_fedavg.py bob 1
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

CLUSTER = {
    "alice": {"address": "127.0.0.1:12140"},
    "bob": {"address": "127.0.0.1:12141"},
}
# Each party's store (``coordinator_address``): its process 0 listens there.
COORDINATORS = {"alice": "127.0.0.1:12142", "bob": "127.0.0.1:12143"}
PROCESSES = 2  # a party's processes: its mesh {"fsdp": PROCESSES}

ROUNDS = 3
ROWS, COLS = 2048, 1024  # 8.4 MB f32 leaf — rides the wire per shard


def run(party: str, rounds: int = ROUNDS, device=None, cluster=None,
        coordinators=None, process_id: int = 0) -> float:
    """Process ``process_id`` of ``party``.  ``device``: the process's
    device (``None``: card ``process_id % device_count``, raising without
    one); ``cluster``: the parties' addresses (``None``: :data:`CLUSTER`);
    ``coordinators``: each party's store address (``None``:
    :data:`COORDINATORS`)."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch.fl import aggregate
    from rayfed_tpu_torch.runtime import get_runtime

    rt = fed.init(
        address="local", cluster=cluster or CLUSTER, party=party, device=device,
        coordinator_address=(coordinators or COORDINATORS)[party],
        num_party_processes=PROCESSES, party_process_id=process_id,
        mesh_shape={"fsdp": PROCESSES},
    )
    mesh = rt.mesh

    @fed.remote
    class Trainer:
        """Party-pinned trainer; params stay sharded on the party mesh."""

        def __init__(self, delta: float):
            self._delta = delta

        def train(self, params):
            # The incoming tree sits on THIS party's mesh (a tree from the
            # other party landed there through its sharding description).
            w = params["w"]
            assert isinstance(w, DTensor) and w.device_mesh is get_runtime().mesh, type(w)
            w = w.redistribute(placements=[Shard(0)])  # from Replicate: local
            assert w.to_local().shape == (ROWS // PROCESSES, COLS)
            w = w + self._delta
            # The whole update in every process of the party: a DTensor
            # sharded across processes cannot be pushed.
            return {"w": w.redistribute(placements=[Replicate()])}

    trainers = {
        p: Trainer.party(p).remote(float(i + 1))
        for i, p in enumerate(("alice", "bob"))
    }

    w = torch.zeros((ROWS, COLS), dtype=torch.float32, device=rt.transport.device)
    params = {"w": distribute_tensor(w, mesh, [Shard(0)])}

    for _ in range(rounds):
        updates = [trainers[p].train.remote(params) for p in trainers]
        params = aggregate(updates)  # mean(w+1, w+2) = w + 1.5 per round

    got = float(params["w"].full_tensor().mean())
    expected = 1.5 * rounds
    assert abs(got - expected) < 1e-4, (got, expected)
    print(
        f"[{party}:{process_id}] {rounds} mesh-party rounds ok: mean={got:.2f}, "
        f"result {params['w'].placements} over {dict(zip(mesh.mesh_dim_names, mesh.shape))}",
        flush=True,
    )
    fed.shutdown()
    return got


def _run_processes(procs):
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    for p in procs:
        if p.is_alive():  # a hung process must fail the run, not wedge it
            p.terminate()
            p.join(10)
    codes = [p.exitcode for p in procs]
    assert codes == [0] * len(procs), codes


def main():
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    if len(sys.argv) > 2:
        run(sys.argv[1], process_id=int(sys.argv[2]))
        return
    parties = sys.argv[1:] or list(CLUSTER)
    _run_processes([
        ctx.Process(target=run, args=(p,), kwargs={"process_id": r})
        for p in parties for r in range(PROCESSES)
    ])
    print(f"mesh_fedavg: {', '.join(parties)} exited 0")


if __name__ == "__main__":
    main()
