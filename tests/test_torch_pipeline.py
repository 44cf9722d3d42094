"""The port's pipeline schedules against the JAX package's
(``tests/test_pipeline.py``'s cases, the same numpy inputs).

The JAX side runs on the 8-device CPU mesh of ``conftest.py``; the port's
on one world of 8 gloo ranks on the CPU, spawned once for the module (each
case a test of its own reading the stored result of every rank), each case
on the sub-mesh ``{"pp": S}`` of the world's first S ranks.  The rank
programs live in the package (``tools/parallel_check.py``) and import no
JAX.  Cases: GPipe at (S, M) ∈ {(4, 4), (2, 8), (8, 8)}, its gradients by
autograd, 1F1B against the JAX package's 1F1B and against autograd through
the port's GPipe, the interleaved schedule against both packages' 1F1B,
the ``make_*`` functions' errors, SGD on 1F1B gradients, and a tiny Llama's decoder
layers as the stage (flash attention: the port's plain version, the JAX
package's kernel in interpret mode).

Tolerance (f32): ``|port − ref| ≤ 1e-5·max|ref| + 1e-5·|ref|`` — the two
packages' matmuls and ``tanh`` sum and round in their own orders.  Every
rank holds the same result: their bytes must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rayfed_tpu.models import llama as jax_llama
from rayfed_tpu.ops.flash_attention import flash_attention as jax_flash
from rayfed_tpu.parallel import create_mesh
from rayfed_tpu.parallel.pipeline import make_pipeline, make_pipeline_train, stack_params
from rayfed_tpu_torch.parallel.launch import run_world
from rayfed_tpu_torch.tools.parallel_check import pipeline_cases

RANKS = 8
TOL = 1e-5
LLAMA = dict(num_layers=4)
LLAMA_B, LLAMA_T, LLAMA_M, LLAMA_S = 4, 16, 2, 2


def _mlp_layer_params(key, width, n_layers):
    keys = jax.random.split(key, n_layers)
    return stack_params(
        [{"w": jax.random.normal(k, (width, width)) * (1.0 / width**0.5), "b": jnp.zeros((width,))}
         for k in keys]
    )


def _stage_fn(stage_params, x):
    def body(x, layer):
        return jnp.tanh(x @ layer["w"] + layer["b"]), None

    out, _ = jax.lax.scan(body, x, stage_params)
    return out


def _mse(y, tgt):
    return jnp.mean((y - tgt) ** 2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mesh(n):
    return create_mesh({"pp": n}, devices=jax.devices()[:n])


def _llama_stage(cfg):
    cos, sin = jax_llama.rope_tables(jnp.arange(LLAMA_T), cfg.head_dim, cfg.rope_theta)

    def stage(p, x):
        b, t = x.shape[:2]
        for i in range(p["wq"].shape[0]):
            x, _ = jax_llama._layer_fwd(x, {k: w[i] for k, w in p.items()}, cfg, cos, sin, jax_flash, b, t)
        return x

    return stage


def _inputs():
    """Every case's inputs (numpy) and the JAX package's results."""
    cases, refs = {}, {}
    for n, m in ((4, 4), (2, 8), (8, 8)):
        params = _mlp_layer_params(jax.random.PRNGKey(0), 16, 8)
        x = jax.random.normal(jax.random.PRNGKey(1), (32, 16))
        cases[f"gpipe_{n}_{m}"] = dict(kind="gpipe", stages=n, mb=m, params=_np(params), x=np.asarray(x))
        refs[f"gpipe_{n}_{m}"] = np.asarray(jax.jit(make_pipeline(_mesh(n), _stage_fn, num_microbatches=m))(params, x))

    params = _mlp_layer_params(jax.random.PRNGKey(0), 8, 4)
    x = jax.random.normal(jax.random.PRNGKey(1), (16, 8))
    piped = make_pipeline(_mesh(4), _stage_fn, num_microbatches=4)
    cases["gpipe_grad"] = dict(kind="gpipe_grad", stages=4, mb=4, params=_np(params), x=np.asarray(x))
    refs["gpipe_grad"] = _np(jax.jit(jax.grad(lambda p: jnp.sum(piped(p, x) ** 2)))(params))

    params = _mlp_layer_params(jax.random.PRNGKey(0), 8, 8)
    x = jax.random.normal(jax.random.PRNGKey(1), (32, 8))
    tgt = jax.random.normal(jax.random.PRNGKey(2), (32, 8))
    common = dict(params=_np(params), x=np.asarray(x), tgt=np.asarray(tgt))
    for n, m in ((4, 4), (2, 8), (4, 8)):
        cases[f"1f1b_{n}_{m}"] = dict(kind="train", stages=n, mb=m, **common)
        cases[f"gpipe_ad_{n}_{m}"] = dict(kind="gpipe_loss_grad", stages=n, mb=m, **common)
        refs[f"1f1b_{n}_{m}"] = _np(jax.jit(make_pipeline_train(_mesh(n), _stage_fn, _mse, num_microbatches=m))(
            params, x, tgt))
    for n, m, v in ((4, 8, 2), (2, 4, 2), (2, 4, 4)):
        cases[f"inter_{n}_{m}_{v}"] = dict(kind="train", stages=n, mb=m, v=v, **common)
        cases[f"1f1b_{n}_{m}"] = dict(kind="train", stages=n, mb=m, **common)
        refs[f"inter_{n}_{m}_{v}"] = _np(jax.jit(make_pipeline_train(
            _mesh(n), _stage_fn, _mse, num_microbatches=m, virtual_stages=v))(params, x, tgt))

    params = _mlp_layer_params(jax.random.PRNGKey(0), 8, 4)
    x = jax.random.normal(jax.random.PRNGKey(1), (16, 8))
    cases["sgd"] = dict(kind="sgd", stages=4, mb=4, steps=21, lr=0.5, params=_np(params), x=np.asarray(x),
                        tgt=np.asarray(0.5 * jnp.tanh(x)))

    cfg = jax_llama.llama_tiny(**LLAMA)
    lparams = jax_llama.init_llama(jax.random.PRNGKey(0), cfg)
    ids = jax.random.randint(jax.random.PRNGKey(3), (LLAMA_B, LLAMA_T), 0, cfg.vocab_size)
    hx = lparams["embed"][ids]
    htgt = jax.random.normal(jax.random.PRNGKey(4), hx.shape)
    lcommon = dict(stages=LLAMA_S, mb=LLAMA_M, llama=LLAMA, params=_np(lparams["layers"]), x=np.asarray(hx),
                   tgt=np.asarray(htgt))
    stage = _llama_stage(cfg)
    cases["llama_gpipe"] = dict(kind="gpipe", **lcommon)
    refs["llama_gpipe"] = np.asarray(jax.jit(make_pipeline(_mesh(LLAMA_S), stage, num_microbatches=LLAMA_M))(
        lparams["layers"], hx))
    cases["llama_1f1b"] = dict(kind="train", **lcommon)
    refs["llama_1f1b"] = _np(jax.jit(make_pipeline_train(_mesh(LLAMA_S), stage, _mse, num_microbatches=LLAMA_M))(
        lparams["layers"], hx, htgt))
    return cases, refs


@pytest.fixture(scope="module")
def world():
    cases, refs = _inputs()
    return cases, refs, run_world(pipeline_cases, RANKS, (cases,), device="cpu", timeout_s=300)


def _close(port, ref):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(port, ref, atol=TOL * float(np.abs(ref).max()), rtol=TOL)


def _tree_close(port, ref):
    port_leaves = jax.tree_util.tree_leaves(port)
    ref_leaves = jax.tree_util.tree_leaves(ref)
    assert len(port_leaves) == len(ref_leaves)
    for a, b in zip(port_leaves, ref_leaves):
        _close(a, b)


def _same_on_every_rank(results, name, n, key):
    first = jax.tree_util.tree_leaves(results[0][name][key])
    for r in range(1, n):
        for a, b in zip(jax.tree_util.tree_leaves(results[r][name][key]), first):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), (name, key, r)
    for r in range(n, RANKS):  # outside the sub-mesh
        assert results[r][name] == {}


@pytest.mark.parametrize("n_stages,num_mb", [(4, 4), (2, 8), (8, 8)])
def test_pipeline_matches_reference(world, n_stages, num_mb):
    cases, refs, results = world
    name = f"gpipe_{n_stages}_{num_mb}"
    _close(results[0][name]["out"], refs[name])
    _same_on_every_rank(results, name, n_stages, "out")
    # Idle ticks are skipped: each stage ran M live ticks of M + S − 1.
    for r in range(n_stages):
        stats = results[r][name]["stats"]
        assert stats["ticks"] == num_mb + n_stages - 1 and stats["live"] == num_mb
        assert stats["hops"] == (num_mb if r < n_stages - 1 else 0)


def test_pipeline_gradients_match(world):
    cases, refs, results = world
    _tree_close(results[0]["gpipe_grad"]["grads"], refs["gpipe_grad"])
    _same_on_every_rank(results, "gpipe_grad", 4, "grads")


@pytest.mark.parametrize("n_stages,num_mb", [(4, 4), (2, 8), (4, 8)])
def test_pipeline_1f1b_matches_reference_and_gpipe_autograd(world, n_stages, num_mb):
    cases, refs, results = world
    res = results[0][f"1f1b_{n_stages}_{num_mb}"]
    ref_loss, ref_grads = refs[f"1f1b_{n_stages}_{num_mb}"]
    _close(res["loss"], ref_loss)
    _tree_close(res["grads"], ref_grads)
    _same_on_every_rank(results, f"1f1b_{n_stages}_{num_mb}", n_stages, "grads")
    ad = results[0][f"gpipe_ad_{n_stages}_{num_mb}"]
    _close(res["loss"], ad["loss"])
    _tree_close(res["grads"], ad["grads"])
    for r in range(n_stages):
        stats = results[r][f"1f1b_{n_stages}_{num_mb}"]["stats"]
        assert stats["ticks"] == num_mb + 2 * (n_stages - 1) and stats["live"] == num_mb


@pytest.mark.parametrize("n_stages,num_mb,v", [(4, 8, 2), (2, 4, 2), (2, 4, 4)])
def test_pipeline_interleaved_matches_reference_and_1f1b(world, n_stages, num_mb, v):
    cases, refs, results = world
    res = results[0][f"inter_{n_stages}_{num_mb}_{v}"]
    ref_loss, ref_grads = refs[f"inter_{n_stages}_{num_mb}_{v}"]
    _close(res["loss"], ref_loss)
    _tree_close(res["grads"], ref_grads)
    one = results[0][f"1f1b_{n_stages}_{num_mb}"]
    _close(res["loss"], one["loss"])
    _tree_close(res["grads"], one["grads"])
    _same_on_every_rank(results, f"inter_{n_stages}_{num_mb}_{v}", n_stages, "grads")
    for r in range(n_stages):  # per direction M·v + S − 1 fine ticks, M·v live units
        stats = results[r][f"inter_{n_stages}_{num_mb}_{v}"]["stats"]
        assert stats["ticks"] == 2 * (num_mb * v + n_stages - 1) and stats["live"] == num_mb * v


def test_pipeline_1f1b_trains(world):
    """A few 1F1B SGD steps reduce the loss (the reference's bar: below half)."""
    losses = world[2][0]["sgd"]["losses"]
    assert losses[-1] < 0.5 * losses[0], losses


def test_pipeline_validation_errors_match_reference(world):
    mesh = _mesh(4)
    p6 = _mlp_layer_params(jax.random.PRNGKey(0), 8, 6)
    p4 = _mlp_layer_params(jax.random.PRNGKey(0), 8, 4)
    p8 = _mlp_layer_params(jax.random.PRNGKey(0), 8, 8)
    x8, x9, x6 = (jnp.zeros((r, 8)) for r in (8, 9, 6))
    calls = {
        "leading": lambda: make_pipeline(mesh, _stage_fn, num_microbatches=4)(p6, x8),
        "batch": lambda: make_pipeline(mesh, _stage_fn, num_microbatches=4)(p4, x9),
        "virtual_leading": lambda: make_pipeline_train(mesh, _stage_fn, _mse, num_microbatches=4,
                                                       virtual_stages=2)(p6, x8, x8),
        "virtual_stages": lambda: make_pipeline_train(mesh, _stage_fn, _mse, num_microbatches=4,
                                                      virtual_stages=0),
        "interleaved_mb": lambda: make_pipeline_train(mesh, _stage_fn, _mse, num_microbatches=6,
                                                      virtual_stages=2)(p8, x6, x6),
        "train_batch": lambda: make_pipeline_train(mesh, _stage_fn, _mse, num_microbatches=4)(p4, x9, x9),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError) as ref:
            call()
        for r in range(4):
            assert world[2][r]["errors"][name] == str(ref.value), name


def test_llama_stage_pipeline_matches_reference(world):
    """A run of tiny Llama decoder layers as the stage (4 layers, 2 stages,
    flash attention): the GPipe forward and one 1F1B step."""
    cases, refs, results = world
    _close(results[0]["llama_gpipe"]["out"], refs["llama_gpipe"])
    _same_on_every_rank(results, "llama_gpipe", LLAMA_S, "out")
    res = results[0]["llama_1f1b"]
    ref_loss, ref_grads = refs["llama_1f1b"]
    _close(res["loss"], ref_loss)
    assert sorted(res["grads"]) == sorted(ref_grads)
    for k in ref_grads:
        _close(res["grads"][k], ref_grads[k])
