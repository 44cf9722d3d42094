"""Vertical/split federated learning on the PyTorch port: BERT encoder@alice
→ head@bob (BASELINE config #5).

Alice owns the embeddings, transformer layers, and pooler, and her token
ids never leave her silo; bob owns the classification head and the
labels, which never leave his.  Each step alice *pushes* pooled [CLS]
activations (owner-initiated, per the framework's push perimeter), bob
steps the head and pushes the activation gradient back, and alice closes
the backward.  ``step_pipelined`` streams K microbatches back-to-back so
wire and both parties' compute overlap.

Run both parties in one go (spawns two processes, each on the card):

    python examples_torch/split_fl_bert.py

or one party per terminal:

    python examples_torch/split_fl_bert.py alice
    python examples_torch/split_fl_bert.py bob

The program of ``examples/split_fl_bert.py``; its random draws come
from ``torch.Generator``s seeded with that file's seeds.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

CLUSTER = {
    "alice": {"address": "127.0.0.1:12130"},
    "bob": {"address": "127.0.0.1:12131"},
}

STEPS = 8
N, T = 32, 8
MICROBATCHES = 4


def run(party: str, steps: int = STEPS, device=None, cluster=None) -> float:
    """One party's run: the last step's mean loss.  ``device``: the party's
    device (``None``: its CUDA card, raising without one); ``cluster``: the
    parties' addresses (``None``: :data:`CLUSTER`)."""
    import torch

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch.fl import SplitTrainer
    from rayfed_tpu_torch.models import bert
    from rayfed_tpu_torch.models.logistic import softmax_cross_entropy

    dev = fed.init(
        address="local", cluster=cluster or CLUSTER, party=party, device=device
    ).transport.device

    cfg = bert.BertConfig(
        vocab_size=128,
        hidden_size=32,
        num_layers=2,
        num_heads=2,
        intermediate_size=64,
        max_position=16,
        num_classes=2,
    )

    # Both controllers derive the same initial split deterministically;
    # each party's actor keeps only its own half resident.
    full = bert.init_bert(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    enc_params, head_params = bert.split_params(full)

    def token_ids():
        return torch.randint(
            0, cfg.vocab_size, (N, T),
            generator=torch.Generator(device=dev).manual_seed(5), device=dev,
        )

    @fed.remote
    def load_ids(mb):
        ids = token_ids()
        return ids if mb is None else torch.tensor_split(ids, MICROBATCHES)[mb]

    @fed.remote
    def load_labels(mb):
        # Learnable signal: label = parity of the first token id.
        y = token_ids()[:, 0] % 2
        return y if mb is None else torch.tensor_split(y, MICROBATCHES)[mb]

    def encoder_apply(params, ids):
        hidden = bert.apply_encoder(params, ids, cfg)
        return bert.apply_pooler(params, hidden)

    trainer = SplitTrainer(
        encoder_party="alice",
        head_party="bob",
        encoder_params=enc_params,
        encoder_apply=encoder_apply,
        head_params=head_params,
        head_apply=bert.apply_head,
        loss_fn=softmax_cross_entropy,
        lr=0.05,
        wire_dtype=torch.bfloat16,  # half the activation bytes per hop
    )

    ids_obj = load_ids.party("alice").remote(None)
    y_obj = load_labels.party("bob").remote(None)
    first = float(fed.get(trainer.step(ids_obj, y_obj)))

    # Microbatched steps: K activation pushes stream while the next
    # microbatch computes; one accumulated update at the end of each.
    x_mbs = [load_ids.party("alice").remote(i) for i in range(MICROBATCHES)]
    y_mbs = [load_labels.party("bob").remote(i) for i in range(MICROBATCHES)]
    last = first
    for _ in range(steps):
        losses = trainer.step_pipelined(x_mbs, y_mbs)
        last = sum(float(x) for x in fed.get(losses)) / len(losses)

    print(
        f"[{party}] split BERT: loss {first:.3f} -> {last:.3f} over "
        f"{steps} pipelined steps ({MICROBATCHES} microbatches each, "
        f"bf16 wire)",
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
    print("split_fl_bert: both parties exited 0")


if __name__ == "__main__":
    main()
