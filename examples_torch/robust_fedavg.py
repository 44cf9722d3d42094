"""Byzantine-robust FedAvg on the PyTorch port: one poisoned party, a
trimmed-mean reducer.

Three parties train a shared logistic model; carol is compromised and
pushes garbage updates every round.  The round loop swaps the mean for
a coordinate-wise trimmed mean (``fl.tree_trimmed_mean``) via the
driver's ``aggregator=`` hook — the reducer runs coordinator-side (one
party reduces, the result broadcasts) and carol's updates never move
the global model.

Run all parties in one go (spawns three processes, each on the card):

    python examples_torch/robust_fedavg.py

or one party per terminal:

    python examples_torch/robust_fedavg.py alice   # and bob, carol

The program of ``examples/robust_fedavg.py``; its random draws come
from ``torch.Generator``s seeded with that file's seeds.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

CLUSTER = {
    "alice": {"address": "127.0.0.1:12150"},
    "bob": {"address": "127.0.0.1:12151"},
    "carol": {"address": "127.0.0.1:12152"},
}

ROUNDS = 4
LOCAL_STEPS = 2
LR = 0.3
POISON = 1e6
N, D, CLASSES = 256, 32, 4
PARTIES = ("alice", "bob", "carol")
BYZANTINE = "carol"


def party_data(seed: int):
    """A party's shard on the host: ``x`` [N, D] standard normal from
    ``seed``, labels from a random linear teacher drawn from seed 0."""
    import torch

    x = torch.randn((N, D), generator=torch.Generator().manual_seed(seed))
    w = torch.randn((D, CLASSES), generator=torch.Generator().manual_seed(0))
    return x, torch.argmax(x @ w, dim=-1)


def robust_fedavg(party: str, rounds: int = ROUNDS, device=None, cluster=None):
    """The federated program: ``(final params, accuracy@alice)``."""
    import functools

    import torch

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import tree_util
    from rayfed_tpu_torch.fl import run_fedavg_rounds, tree_trimmed_mean
    from rayfed_tpu_torch.models import logistic

    dev = fed.init(
        address="local", cluster=cluster or CLUSTER, party=party, device=device
    ).transport.device

    @fed.remote
    class Trainer:
        def __init__(self, seed: int, byzantine: bool):
            x, y = party_data(seed)
            self._x, self._y = x.to(dev), y.to(dev)
            self._byzantine = byzantine
            self._step = logistic.make_train_step(logistic.apply_logistic, lr=LR)

        def train(self, params):
            if self._byzantine:
                # A compromised silo: huge adversarial updates.
                return tree_util.tree_map(lambda p: p + POISON, params)
            for _ in range(LOCAL_STEPS):
                params, _ = self._step(params, self._x, self._y)
            return params

        def accuracy(self, params) -> float:
            return float(
                logistic.accuracy(
                    logistic.apply_logistic(params, self._x), self._y
                )
            )

    trainers = {
        p: Trainer.party(p).remote(i + 1, p == BYZANTINE)
        for i, p in enumerate(PARTIES)
    }
    params = logistic.init_logistic(D, CLASSES, device=dev)

    # trim=1 tolerates one Byzantine party per coordinate: carol's 1e6
    # outliers are dropped before averaging, every round.
    final = run_fedavg_rounds(
        trainers,
        params,
        rounds=rounds,
        aggregator=functools.partial(tree_trimmed_mean, trim=1),
    )

    # The model must have LEARNED (not been dragged to 1e6-land).
    assert float(torch.max(torch.abs(final["w"]))) < 1e3
    acc = fed.get(trainers["alice"].accuracy.remote(final))
    assert acc > 0.5, acc
    print(
        f"[{party}] robust fedavg survived the Byzantine party: "
        f"accuracy@alice {acc:.3f}",
        flush=True,
    )
    fed.shutdown()
    return final, acc


def run(party: str, rounds: int = ROUNDS, device=None, cluster=None) -> float:
    """One party's run: the accuracy@alice.  ``device``: the party's device
    (``None``: its CUDA card, raising without one); ``cluster``: the
    parties' addresses (``None``: :data:`CLUSTER`)."""
    return robust_fedavg(party, rounds, device, cluster)[1]


def main():
    if len(sys.argv) > 1:
        run(sys.argv[1])
        return
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=run, args=(p,)) for p in PARTIES]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
    codes = [p.exitcode for p in procs]
    assert codes == [0, 0, 0], codes
    print("robust_fedavg: all parties exited 0")


if __name__ == "__main__":
    main()
