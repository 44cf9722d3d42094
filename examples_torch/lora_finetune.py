"""2-party cross-silo Llama-LoRA federated fine-tune (BASELINE config #4),
on the PyTorch port.

Each party holds the same frozen base model and its own private corpus;
only the low-rank adapter factors cross the wire each round (kilobytes
instead of the full model).  Run both parties in one go (spawns two
processes, each on the card):

    python examples_torch/lora_finetune.py

or one party per terminal:

    python examples_torch/lora_finetune.py alice
    python examples_torch/lora_finetune.py bob

The program of ``examples/lora_finetune.py``; its random draws come
from ``torch.Generator``s seeded with that file's seeds.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

CLUSTER = {
    "alice": {"address": "127.0.0.1:12120"},
    "bob": {"address": "127.0.0.1:12121"},
}

ROUNDS = 3
LOCAL_STEPS = 2
BATCH, SEQ = 4, 32


def run(party: str, rounds: int = ROUNDS, device=None, cluster=None) -> float:
    """One party's run: alice's loss after the rounds.  ``device``: the
    party's device (``None``: its CUDA card, raising without one);
    ``cluster``: the parties' addresses (``None``: :data:`CLUSTER`)."""
    import torch

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch.fl import aggregate
    from rayfed_tpu_torch.models import llama, lora

    cluster = cluster or CLUSTER
    dev = fed.init(
        address="local", cluster=cluster, party=party, device=device
    ).transport.device

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    cfg = llama.llama_tiny()
    # Adapters on attention projections + the lm_head.
    lcfg = lora.LoraConfig(rank=4, targets=(r"w[qv]$", r"lm_head$"))

    @fed.remote
    class Tuner:
        """Party-local fine-tuner: frozen base + private ids stay resident."""

        def __init__(self, seed: int):
            # Same base everywhere (fixed seed); real deployments load a
            # shared pretrained checkpoint instead.
            self._base = llama.init_llama(cfg, gen(42), dev)
            self._ids = torch.randint(
                0, cfg.vocab_size, (BATCH, SEQ), generator=gen(seed), device=dev
            )
            self._step = llama.make_lora_train_step(cfg, lr=5e-3)

        def train(self, adapters):
            opt = llama.init_adam(adapters)
            for _ in range(LOCAL_STEPS):
                adapters, opt, loss = self._step(
                    adapters, opt, self._base, self._ids
                )
            return adapters

        def loss(self, adapters) -> float:
            with torch.no_grad():
                logits = llama.apply_llama(
                    self._base, self._ids, cfg, lora=adapters
                )
                return float(llama.lm_loss(logits[:, :-1], self._ids[:, 1:]))

    tuners = {p: Tuner.party(p).remote(i + 10) for i, p in enumerate(cluster)}

    base = llama.init_llama(cfg, gen(42), dev)
    adapters = lora.init_lora(base, lcfg, gen(7), dev)
    n_params = lora.num_lora_params(adapters)
    first = fed.get(tuners["alice"].loss.remote(adapters))

    for _ in range(rounds):
        adapters = aggregate(
            [tuners[p].train.remote(adapters) for p in cluster]
        )

    last = fed.get(tuners["alice"].loss.remote(adapters))
    print(
        f"[{party}] {n_params} adapter params; loss@alice "
        f"{first:.3f} -> {last:.3f} over {rounds} rounds",
        flush=True,
    )
    fed.shutdown()
    return last


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
    print("lora_finetune: both parties exited 0")


if __name__ == "__main__":
    main()
