"""2-party FedAvg on synthetic MNIST-shaped data (BASELINE config #2), on
the PyTorch port.

Run both parties in one go (spawns two processes, each on the card):

    python examples_torch/fedavg_mnist.py

or one party per terminal:

    python examples_torch/fedavg_mnist.py alice
    python examples_torch/fedavg_mnist.py bob

The program of ``examples/fedavg_mnist.py``; its random draws come
from ``torch.Generator``s seeded with that file's seeds.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

CLUSTER = {
    "alice": {"address": "127.0.0.1:12110"},
    "bob": {"address": "127.0.0.1:12111"},
}

ROUNDS = 5
LOCAL_EPOCHS = 2
LR = 0.2
N, D, CLASSES = 512, 784, 10
SEEDS = {"alice": 1, "bob": 2}


def party_data(seed: int):
    """A party's shard on the host: ``x`` [N, D] standard normal from
    ``seed``, labels from a random linear teacher drawn from seed 0."""
    import torch

    x = torch.randn((N, D), generator=torch.Generator().manual_seed(seed))
    w = torch.randn((D, CLASSES), generator=torch.Generator().manual_seed(0))
    return x, torch.argmax(x @ w, dim=-1)


def fedavg(party: str, rounds: int = ROUNDS, device=None, cluster=None):
    """The federated program: ``(final params, accuracy@alice)``."""
    import torch

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch.fl import aggregate, run_fedavg_rounds
    from rayfed_tpu_torch.models import logistic

    dev = fed.init(
        address="local", cluster=cluster or CLUSTER, party=party, device=device
    ).transport.device

    @fed.remote
    class Trainer:
        """Party-local trainer: data + train step stay resident."""

        def __init__(self, seed: int):
            x, y = party_data(seed)
            self._x, self._y = x.to(dev), y.to(dev)
            self._step = logistic.make_train_step(logistic.apply_logistic, lr=LR)

        def train(self, params):
            for _ in range(LOCAL_EPOCHS):
                params, loss = self._step(params, self._x, self._y)
            return params

        def accuracy(self, params) -> float:
            return float(
                logistic.accuracy(logistic.apply_logistic(params, self._x), self._y)
            )

    alice = Trainer.party("alice").remote(SEEDS["alice"])
    bob = Trainer.party("bob").remote(SEEDS["bob"])

    params0 = logistic.init_logistic(D, CLASSES, device=dev)

    # The explicit loop (how the pieces compose):
    params = params0
    for _ in range(rounds):
        params = aggregate([alice.train.remote(params), bob.train.remote(params)])

    # ...or, equivalently, the one-call driver from the same start — it
    # also pipelines rounds and can add a server optimizer /
    # checkpointing.
    via_driver = run_fedavg_rounds(
        {"alice": alice, "bob": bob}, params0, rounds=rounds
    )
    assert torch.allclose(via_driver["w"], params["w"], atol=1e-5)

    acc = fed.get(alice.accuracy.remote(params))
    print(f"[{party}] final train accuracy@alice: {acc:.3f}", flush=True)
    fed.shutdown()
    return params, acc


def run(party: str, rounds: int = ROUNDS, device=None, cluster=None) -> float:
    """One party's run: the accuracy@alice.  ``device``: the party's device
    (``None``: its CUDA card, raising without one); ``cluster``: the
    parties' addresses (``None``: :data:`CLUSTER`)."""
    return fedavg(party, rounds, device, cluster)[1]


def main():
    if len(sys.argv) > 1:
        run(sys.argv[1])
        return
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=run, args=(p,)) for p in ("alice", "bob")]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    for p in procs:
        if p.is_alive():  # a hung party must fail the run, not wedge it
            p.terminate()
            p.join(10)
    codes = [p.exitcode for p in procs]
    assert codes == [0, 0], codes
    print("fedavg_mnist: both parties exited 0")


if __name__ == "__main__":
    main()
