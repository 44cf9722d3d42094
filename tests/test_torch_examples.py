"""The port's examples (``examples_torch/``) stay runnable and run the JAX
examples' programs: each federated example's ``run()`` runs in real party
processes on the CPU (``device="cpu"``, free ports), as
``tests/test_examples.py`` runs ``examples/``, and each process asserts that
it loaded neither JAX nor the JAX package.  Parity tests hold the results
against the JAX package in this process: the FedAvg model and accuracy
(the same data, the JAX train step and mean), the robust run's accuracy
(the JAX trimmed mean), and the served tokens (the JAX params carried
across)."""

import importlib
import multiprocessing as mp
import queue
import sys
import time

import numpy as np
import pytest

from tests.multiproc import get_free_ports, make_cluster

RUN_TIMEOUT_S = 240
EXAMPLES = ("simple_example", "fedavg_mnist", "robust_fedavg", "mesh_fedavg",
            "serve_llama", "lora_finetune", "split_fl_bert")


def _host(value):
    """A child's result as host values: tensors as numpy."""
    import torch
    from torch.utils import _pytree as pytree

    return pytree.tree_map(lambda x: x.cpu().numpy() if isinstance(x, torch.Tensor) else x, value)


def _child(example, fn_name, party, args, kwargs, out):
    """A party process: runs ``examples_torch.<example>.<fn_name>`` and puts
    its result on ``out``; it must not have loaded JAX or the JAX package."""
    fn = getattr(importlib.import_module(f"examples_torch.{example}"), fn_name)
    result = fn(party, *args, **kwargs)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "rayfed_tpu"))
    assert not loaded, loaded
    out.put((party, kwargs.get("process_id", 0), _host(result)))


def _run(example, parties, args=(), fn_name="run", per_process=None):
    """Run ``fn_name(party, *args, device="cpu", cluster=...)`` of an example
    in one spawned process per party (or per ``per_process`` entry: extra
    keywords of each process).  Every process must exit 0 within
    RUN_TIMEOUT_S.  Returns ``{(party, process_id): result}``."""
    cluster = make_cluster(parties)
    per_process = per_process or {(p, 0): {} for p in parties}
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = {
        key: ctx.Process(
            target=_child, name=f"party-{key}",
            args=(example, fn_name, key[0], args, {"device": "cpu", "cluster": cluster, **kw}, out),
        )
        for key, kw in per_process.items()
    }
    for proc in procs.values():
        proc.start()
    results = {}
    deadline = time.monotonic() + RUN_TIMEOUT_S
    try:
        while len(results) < len(procs) and time.monotonic() < deadline:
            try:  # drain the queue before joining
                party, pid, value = out.get(timeout=1)
                results[(party, pid)] = value
            except queue.Empty:
                if any(not p.is_alive() and p.exitcode != 0 for p in procs.values()):
                    break
        for proc in procs.values():
            proc.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [k for k, p in procs.items() if p.is_alive()]
        for p in procs.values():
            if p.is_alive():
                p.kill()
                p.join(5)
    assert not hung, f"processes {hung} timed out after {RUN_TIMEOUT_S}s"
    codes = {k: p.exitcode for k, p in procs.items()}
    assert all(c == 0 for c in codes.values()), codes
    return results


# -- the examples as tests/test_examples.py runs them -------------------------


def test_simple_example():
    _run("simple_example", ["alice", "bob"])


def test_fedavg_mnist_example():
    # Fewer rounds than the standalone default, as tests/test_examples.py.
    res = _run("fedavg_mnist", ["alice", "bob"], args=(2,))
    assert res[("alice", 0)] == res[("bob", 0)]


# slow, as in tests/test_examples.py: tests/test_torch_lora.py and
# tests/test_torch_split.py hold the step and the split round.
@pytest.mark.slow
def test_lora_finetune_example():
    _run("lora_finetune", ["alice", "bob"], args=(1,))


@pytest.mark.slow
def test_split_fl_bert_example():
    _run("split_fl_bert", ["alice", "bob"], args=(2,))


def test_robust_fedavg_example():
    _run("robust_fedavg", ["alice", "bob", "carol"], args=(3,))


def test_mesh_fedavg_example():
    # A party is two processes here (its mesh {"fsdp": 2}), where the JAX
    # example's is one process of 8 virtual devices.
    coord = dict(zip(("alice", "bob"), (f"127.0.0.1:{p}" for p in get_free_ports(2))))
    res = _run("mesh_fedavg", ["alice", "bob"], args=(2,), per_process={
        (p, r): {"coordinators": coord, "process_id": r} for p in ("alice", "bob") for r in (0, 1)})
    assert set(res.values()) == {1.5 * 2}


def test_serve_llama_example():
    from examples_torch.serve_llama import run

    assert run(8, device="cpu") == 8


@pytest.mark.parametrize("example", EXAMPLES)
def test_example_raises_without_a_card(example):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the examples run on it")
    run = importlib.import_module(f"examples_torch.{example}").run
    cluster = make_cluster(["alice", "bob", "carol"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if example == "serve_llama":
            run(1)
        elif example == "mesh_fedavg":
            run("alice", 1, cluster=cluster, coordinators={"alice": f"127.0.0.1:{get_free_ports(1)[0]}"})
        elif example == "simple_example":
            run("alice", cluster=cluster)
        else:
            run("alice", 1, cluster=cluster)


# -- parity with the JAX package ---------------------------------------------------


def _jax_rounds(example, seeds, rounds, train, reduce):
    """The example's rounds in this process on the JAX package: every party's
    data rebuilt by the example's ``party_data``, ``train(params, x, y,
    party)`` each round, then ``reduce`` over the parties' trees.  Returns
    the final params and the accuracy on alice's data."""
    import jax
    import jax.numpy as jnp

    from rayfed_tpu.models import logistic

    data = {}
    for p, seed in seeds.items():
        x, y = example.party_data(seed)
        data[p] = (jnp.asarray(x.numpy()), jnp.asarray(y.numpy().astype(np.int32)))
    params = logistic.init_logistic(jax.random.PRNGKey(0), example.D, example.CLASSES)
    for _ in range(rounds):
        params = reduce([train(params, *data[p], p) for p in seeds])
    x, y = data["alice"]
    acc = float(logistic.accuracy(logistic.apply_logistic(params, x), y))
    return {k: np.asarray(v) for k, v in params.items()}, acc


def test_fedavg_mnist_matches_the_jax_package():
    """Both parties' final model within rtol 1e-5 of the JAX package's
    rounds (its train step, a two-tree mean; atol 1e-8, ``np.allclose``'s,
    for the elements near zero, whose relative gap the two libraries' sums
    leave larger), accuracy@alice within 2 of the 512 samples."""
    from examples_torch import fedavg_mnist as ex
    from rayfed_tpu.fl import tree_average
    from rayfed_tpu.models import logistic

    rounds = 2
    res = _run("fedavg_mnist", ["alice", "bob"], args=(rounds,), fn_name="fedavg")
    step = logistic.make_train_step(logistic.apply_logistic, lr=ex.LR)

    def train(params, x, y, party):
        for _ in range(ex.LOCAL_EPOCHS):
            params, _ = step(params, x, y)
        return params

    want, want_acc = _jax_rounds(ex, ex.SEEDS, rounds, train, tree_average)
    for party in ("alice", "bob"):
        params, acc = res[(party, 0)]
        for k in ("w", "b"):
            np.testing.assert_allclose(params[k], want[k], rtol=1e-5, atol=1e-8)
        assert abs(acc - want_acc) <= 2 / ex.N, (party, acc, want_acc)


def test_robust_fedavg_matches_the_jax_package():
    """Carol's poisoned rounds through the JAX package's trimmed mean:
    accuracy@alice within 2 of the 256 samples at every party."""
    import functools

    import jax

    from examples_torch import robust_fedavg as ex
    from rayfed_tpu.fl import tree_trimmed_mean
    from rayfed_tpu.models import logistic

    rounds = 3
    res = _run("robust_fedavg", list(ex.PARTIES), args=(rounds,), fn_name="robust_fedavg")
    step = logistic.make_train_step(logistic.apply_logistic, lr=ex.LR)

    def train(params, x, y, party):
        if party == ex.BYZANTINE:
            return jax.tree_util.tree_map(lambda p: p + ex.POISON, params)
        for _ in range(ex.LOCAL_STEPS):
            params, _ = step(params, x, y)
        return params

    seeds = {p: i + 1 for i, p in enumerate(ex.PARTIES)}
    _, want_acc = _jax_rounds(ex, seeds, rounds, train, functools.partial(tree_trimmed_mean, trim=1))
    for party in ex.PARTIES:
        _, acc = res[(party, 0)]
        assert abs(acc - want_acc) <= 2 / ex.N, (party, acc, want_acc)


def test_serve_llama_tokens_match_the_jax_package():
    """The JAX example's int8 params and prompt served by both packages:
    equal greedy tokens at every step, up to the first step whose JAX
    logits' top-two gap is below 1e-4·max|logit| (a near tie, where the
    comparison stops)."""
    import jax
    import jax.numpy as jnp
    import torch

    from examples_torch import serve_llama as ex
    from rayfed_tpu.models import llama
    from rayfed_tpu_torch.models.convert import llama_params_from_jax

    cfg = llama.llama_tiny(sliding_window=ex.WINDOW, kv_quant=True)
    params = llama.quantize_llama_base(llama.init_llama(jax.random.PRNGKey(0), cfg))
    prompt = jax.random.randint(jax.random.PRNGKey(1), (ex.BATCH, ex.PROMPT_LEN), 0, cfg.vocab_size)

    # examples/serve_llama.py's steps, each step's logits kept.
    cache, logits = llama.prefill(params, cfg, prompt, ex.PROMPT_LEN)
    cache = llama.roll_kv_cache(cache, cfg, ex.PROMPT_LEN)
    step = llama.make_decode_step(cfg, rolling=True)
    want, step_logits = [], []
    for i in range(ex.NEW_TOKENS):
        step_logits.append(np.asarray(logits, np.float32))
        tok = jnp.argmax(logits, axis=-1).astype(prompt.dtype)
        want.append(np.asarray(tok))
        cache, logits = step(params, cache, tok, ex.PROMPT_LEN + i)

    got, _ = ex.serve(llama_params_from_jax(params, device="cpu"), ex.config(),
                      torch.from_numpy(np.asarray(prompt).astype(np.int64)), ex.NEW_TOKENS)
    assert got.shape == (ex.BATCH, ex.NEW_TOKENS)
    compared = 0
    for i, lg in enumerate(step_logits):
        top2 = np.sort(lg, axis=-1)[:, -2:]
        if np.min(top2[:, 1] - top2[:, 0]) < 1e-4 * np.max(np.abs(lg)):
            print(f"serve_llama: a near tie in the JAX logits at step {i}; compared steps 0..{i - 1}")
            break
        np.testing.assert_array_equal(got[:, i].numpy(), want[i], err_msg=f"step {i}")
        compared += 1
    assert compared > 0
