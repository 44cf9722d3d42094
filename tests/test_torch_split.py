"""Port's split learning (``rayfed_tpu_torch.fl.split``) vs the JAX
reference (CPU), BASELINE.md config #5's shape: a BERT encoder and pooler at
one party, the classification head at the other.

In process, without ``fed.init``: the reference's ``_EncoderActor`` and
``_HeadActor`` and the port's are called directly, step for step on the same
params (the reference's ``init_bert``, carried across) and numpy token ids:
3 serialized steps, then one step accumulated over 4 microbatches.  The
activations, their gradients, the losses and both halves' params agree at
atol = rtol = 1e-5 (f32 on both sides; summation order only), with an f32
wire and with a bf16 one.

One two-process run of the port (``tests/test_fl.py``'s
``run_split_fl_bert``): a split step crosses parties, and what it holds are
the actors, ``num_returns=2`` and the pushes of activations and gradients
between two real processes.  This module imports JAX only inside the
in-process tests, so the party processes, which import it to find their
entry, load none.
"""

import multiprocessing as mp
import sys
import time

import numpy as np
import pytest
import torch

import rayfed_tpu_torch as fed
from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.fl import split
from rayfed_tpu_torch.models import bert
from rayfed_tpu_torch.models.logistic import softmax_cross_entropy
from tests.multiproc import make_cluster

TOL = dict(atol=1e-5, rtol=1e-5)
CPU = torch.device("cpu")
TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position=16, num_classes=2)
PARTY_TIMEOUT_S = 120


def _ids(n, t, seed):
    ids = np.random.default_rng(seed).integers(0, TINY["vocab_size"], size=(n, t)).astype(np.int32)
    return ids, (ids[:, 0] % 2).astype(np.int32)  # label: parity of the first token id


def _actors(wire):
    """The reference's and the port's (encoder, head) actors on equal params."""
    import jax
    import jax.numpy as jnp

    from rayfed_tpu.fl import split as jsplit
    from rayfed_tpu.models import bert as jbert
    from rayfed_tpu.models.logistic import softmax_cross_entropy as jxent
    from rayfed_tpu_torch.models.convert import bert_params_from_jax

    jcfg, cfg = jbert.BertConfig(**TINY), bert.BertConfig(**TINY)
    jparams = jbert.init_bert(jax.random.PRNGKey(0), jcfg)
    jenc, jhead = jbert.split_params(jparams)
    enc, head = (bert_params_from_jax(jax.tree_util.tree_map(np.asarray, t), device=CPU)
                 for t in (jenc, jhead))
    jwire, twire = {None: (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}[wire]

    def jenc_apply(p, ids):
        return jbert.apply_pooler(p, jbert.apply_encoder(p, ids, jcfg))

    def enc_apply(p, ids):
        return bert.apply_pooler(p, bert.apply_encoder(p, ids, cfg))

    ref = (jsplit._EncoderActor(jenc, jenc_apply, 0.05, jwire),
           jsplit._HeadActor(jhead, jbert.apply_head, jxent, 0.05, jwire))
    port = (split._EncoderActor(enc, enc_apply, 0.05, twire),
            split._HeadActor(head, bert.apply_head, softmax_cross_entropy, 0.05, twire))
    return ref, port


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), err_msg=what, **TOL)


def _close_trees(got, want, what):
    import jax

    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for k in path:
            g = g[k.key]
        _close(g, w, f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("wire", [None, "bf16"], ids=["f32-wire", "bf16-wire"])
def test_split_actors_match_the_reference(wire):
    import jax.numpy as jnp

    (jenc, jhead), (enc, head) = _actors(wire)
    ids, labels = _ids(16, 8, seed=5)

    def both(ref_call, port_call, *args):
        return ref_call(*(jnp.asarray(a) for a in args)), port_call(*(torch.from_numpy(a).long() for a in args))

    for step in range(3):  # the serialized step, as SplitTrainer.step issues it
        jh, h = both(jenc.forward, enc.forward, ids)
        assert h.dtype == (torch.bfloat16 if wire else torch.float32)
        _close(h, jh, f"step {step} activations")
        (jg, jl), (g, loss) = jhead.step(jh, jnp.asarray(labels)), head.step(h, torch.from_numpy(labels).long())
        assert g.dtype == h.dtype
        _close(g, jg, f"step {step} activation gradient")
        _close(loss, jl, f"step {step} loss")
        assert jenc.backward(jg) and enc.backward(g)
        assert jenc.apply_update() and enc.apply_update()
        _close_trees(enc.get_params(), jenc.get_params(), f"step {step} encoder")
        _close_trees(head.get_params(), jhead.get_params(), f"step {step} head")

    # One step accumulated over 4 microbatches (SplitTrainer.step_pipelined).
    mbs = [_ids(4, 8, seed=10 + i) for i in range(4)]
    jhs = [jenc.forward(jnp.asarray(x), mb) for mb, (x, _) in enumerate(mbs)]
    hs = [enc.forward(torch.from_numpy(x).long(), mb) for mb, (x, _) in enumerate(mbs)]
    for mb, ((_, y), jh, h) in enumerate(zip(mbs, jhs, hs)):
        _close(h, jh, f"microbatch {mb} activations")
        (jg, jl), (g, loss) = jhead.step_accum(jh, jnp.asarray(y)), head.step_accum(h, torch.from_numpy(y).long())
        _close(g, jg, f"microbatch {mb} activation gradient")
        _close(loss, jl, f"microbatch {mb} loss")
        assert jenc.backward(jg, mb) and enc.backward(g, mb)
    for ref_half, port_half in ((jenc, enc), (jhead, head)):
        assert ref_half.apply_update() and port_half.apply_update()
        assert not port_half.apply_update()  # nothing left to apply
    _close_trees(enc.get_params(), jenc.get_params(), "accumulated encoder")
    _close_trees(head.get_params(), jhead.get_params(), "accumulated head")


def test_accumulated_step_equals_one_step_on_the_whole_batch():
    """GPipe semantics: the mean of 4 equal microbatches' gradients (each of
    a mean loss), applied once, is the update of one step on the
    concatenated batch."""
    cfg = bert.BertConfig(**TINY)

    def enc_apply(p, ids):
        return bert.apply_pooler(p, bert.apply_encoder(p, ids, cfg))

    params = bert.init_bert(cfg, torch.Generator().manual_seed(0), device=CPU)
    halves = []
    for _ in range(2):
        e, h = bert.split_params(tree_util.tree_map(torch.clone, params))
        halves.append((split._EncoderActor(e, enc_apply, 0.05),
                       split._HeadActor(h, bert.apply_head, softmax_cross_entropy, 0.05)))
    ids, labels = (torch.from_numpy(a).long() for a in _ids(16, 8, seed=7))
    (enc1, head1), (enc4, head4) = halves
    g, _ = head1.step(enc1.forward(ids), labels)
    enc1.backward(g)
    enc1.apply_update()
    for mb in range(4):
        sl = slice(4 * mb, 4 * mb + 4)
        g, _ = head4.step_accum(enc4.forward(ids[sl], mb), labels[sl])
        enc4.backward(g, mb)
    enc4.apply_update()
    head4.apply_update()
    for one, four in ((enc1, enc4), (head1, head4)):
        for a, b in zip(tree_util.tree_leaves(one.get_params()), tree_util.tree_leaves(four.get_params())):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_backward_before_forward_raises():
    enc = split._EncoderActor({"w": torch.ones(2)}, lambda p, x: x * p["w"], 0.1)
    with pytest.raises(RuntimeError, match="before its forward"):
        enc.backward(torch.ones(2), 3)
    assert enc.apply_update() is False
    enc.forward(torch.ones(2), 3)
    assert enc.backward(torch.ones(2), 3) and enc.apply_update()
    torch.testing.assert_close(enc.get_params()["w"], torch.full((2,), 0.9))


def test_the_update_leaves_the_callers_params_intact():
    w = torch.ones(3)
    head = split._HeadActor({"w": w}, lambda p, h: h * p["w"], lambda out, y: out.sum(), 0.5)
    g_h, loss = head.step(torch.full((3,), 2.0), None)
    torch.testing.assert_close(g_h, torch.ones(3))
    assert loss.item() == 6.0 and torch.equal(w, torch.ones(3))
    torch.testing.assert_close(head.get_params()["w"], torch.zeros(3))


# -- two processes ------------------------------------------------------------


def run_split_fl_bert(party, cluster):
    """tests/test_fl.py's run_split_fl_bert on the port: the BERT encoder
    and pooler at alice, the head and the labels at bob."""
    from rayfed_tpu_torch.fl import SplitTrainer

    fed.init(address="local", cluster=cluster, party=party, device=CPU)
    cfg = bert.BertConfig(**TINY)
    n, t = 32, 8
    full = bert.init_bert(cfg, torch.Generator().manual_seed(0), device=CPU)
    enc_params, head_params = bert.split_params(full)

    @fed.remote
    def load_ids():
        return torch.from_numpy(_ids(n, t, seed=5)[0]).long()

    @fed.remote
    def load_labels():
        return torch.from_numpy(_ids(n, t, seed=5)[1]).long()

    def encoder_apply(params, ids):
        return bert.apply_pooler(params, bert.apply_encoder(params, ids, cfg))

    trainer = SplitTrainer(
        encoder_party="alice", head_party="bob",
        encoder_params=enc_params, encoder_apply=encoder_apply,
        head_params=head_params, head_apply=bert.apply_head,
        loss_fn=softmax_cross_entropy, lr=0.05,
    )
    ids_obj = load_ids.party("alice").remote()
    y_obj = load_labels.party("bob").remote()
    losses = [float(fed.get(trainer.step(ids_obj, y_obj))) for _ in range(12)]
    assert losses[-1] < losses[0], losses
    losses = [float(fed.get(x)) for x in trainer.step_pipelined([ids_obj] * 2, [y_obj] * 2)]
    assert len(losses) == 2 and all(np.isfinite(losses)), losses
    head = fed.get(trainer.head_params())
    assert isinstance(head["head"]["kernel"], torch.Tensor)
    fed.shutdown()


def _port_child(fn_name, party, args):
    getattr(sys.modules[__name__], fn_name)(party, *args)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "rayfed_tpu"))
    assert not loaded, loaded


def test_split_fl_bert_two_port_processes():
    cluster = make_cluster(["alice", "bob"])
    ctx = mp.get_context("spawn")
    procs = {p: ctx.Process(target=_port_child, args=("run_split_fl_bert", p, (cluster,)), name=f"party-{p}")
             for p in ("alice", "bob")}
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
