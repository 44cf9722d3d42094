"""Two-party hello-world on the PyTorch port: the canonical cross-silo program.

Run the SAME script once per party (multi-controller execution), each on
its party's CUDA card:

    python examples_torch/simple_example.py alice &
    python examples_torch/simple_example.py bob

or with no argument to launch both parties as local processes.

The program of ``examples/simple_example.py``: actors pinned to parties,
cross-party results pushed by the owner, aggregate fetched on both sides.
"""

import multiprocessing
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CLUSTER = {
    "alice": {"address": "127.0.0.1:21110"},
    "bob": {"address": "127.0.0.1:21111"},
}


def run(party, device=None, cluster=None):
    """One party's program.  ``device``: the party's device (``None``: its
    CUDA card, raising without one); ``cluster``: the parties' addresses
    (``None``: :data:`CLUSTER`)."""
    import torch

    import rayfed_tpu_torch as fed

    dev = fed.init(
        address="local", cluster=cluster or CLUSTER, party=party, device=device
    ).transport.device

    @fed.remote
    class MyActor:
        def __init__(self, party, data):
            self._data = data
            self._party = party

        def f(self):
            return f"f({self._party})"

        def weights(self):
            return torch.full((4,), self._data, dtype=torch.float32, device=dev)

    @fed.remote
    def agg_fn(obj1, obj2):
        return f"agg-{obj1}-{obj2}"

    @fed.remote
    def mean_fn(w1, w2):
        return (w1 + w2) / 2

    print(f"Running the script in party {party}")

    actor_alice = MyActor.party("alice").remote(party, 1.0)
    actor_bob = MyActor.party("bob").remote(party, 3.0)

    obj = agg_fn.party("bob").remote(
        actor_alice.f.remote(), actor_bob.f.remote()
    )
    result = fed.get(obj)
    print(f"[{party}] string aggregate: {result}")
    assert result == "agg-f(alice)-f(bob)", result

    mean = mean_fn.party("alice").remote(
        actor_alice.weights.remote(), actor_bob.weights.remote()
    )
    mean_value = fed.get(mean)
    print(f"[{party}] federated mean: {mean_value}")
    assert float(mean_value[0]) == 2.0
    fed.shutdown()
    print(f"[{party}] OK")


def main():
    procs = [
        multiprocessing.get_context("spawn").Process(target=run, args=(p,))
        for p in ("alice", "bob")
    ]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    print("simple_example: both parties exited 0")


if __name__ == "__main__":
    if len(sys.argv) > 1:
        run(sys.argv[1])
    else:
        main()
