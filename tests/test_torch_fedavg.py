"""The port's FedAvg reduces (CPU) against the JAX package's.

Inputs are made from a numpy seed and go through both packages.  Packed
folds (``packed_weighted_sum``, the f32 chain of one multiply then one add
per party, then one divide and one cast) are held to byte identity, bf16
and f32 outputs alike; so are the float leaves of ``tree_average`` and
``tree_weighted_sum``.  Integer passthrough leaves follow each library's
promotion (jax: int32 → float32; torch: int32 → float32 too), compared at
rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayfed_tpu.fl import compression as jc
from rayfed_tpu.fl import fedavg as jf
from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.fl import compression as tc
from rayfed_tpu_torch.fl import fedavg as tf
from rayfed_tpu_torch.fl.streaming import StreamingAggregator


def _np_trees(n, seed=0, shapes=((400, 33), (1000,), (7, 11, 13))):
    rng = np.random.default_rng(seed)
    return [
        {
            **{f"w{j}": rng.standard_normal(s).astype(np.float32) for j, s in enumerate(shapes)},
            "count": np.arange(4, dtype=np.int32) * (i + 1),
        }
        for i in range(n)
    ]


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _raw(x):
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


WEIGHTS = [None, [3, 5, 7, 11]]


@pytest.mark.parametrize("weights", WEIGHTS, ids=["mean", "3-5-7-11"])
@pytest.mark.parametrize("out_dtype", [None, "float32"], ids=["bf16-out", "f32-out"])
def test_packed_weighted_sum_equals_the_reference(weights, out_dtype):
    trees = _np_trees(4)
    jp = [jc.pack_tree(_jax(t)) for t in trees]
    tp = [tc.pack_tree(_torch(t)) for t in trees]
    jr = jf.packed_weighted_sum(jp, weights, out_dtype=None if out_dtype is None else jnp.float32)
    tr = tf.packed_weighted_sum(tp, weights, out_dtype=out_dtype)
    assert tr.buf.dtype == (torch.bfloat16 if out_dtype is None else torch.float32)
    assert _raw(tr.buf) == _raw(jr.buf)
    assert tr.spec.entries == jr.spec.entries and tr.spec.wire_dtype == jr.spec.wire_dtype
    # Passthrough (int) leaves: tree_average's per-leaf semantics.
    np.testing.assert_allclose(
        tr.passthrough[0].numpy(), np.asarray(jr.passthrough[0]), rtol=1e-6
    )


def test_packed_weighted_sum_of_f32_wire_and_tree_average_route():
    trees = _np_trees(3, seed=1)
    jp = [jc.pack_tree(_jax(t), jnp.float32) for t in trees]
    tp = [tc.pack_tree(_torch(t), torch.float32) for t in trees]
    assert _raw(tf.packed_weighted_sum(tp).buf) == _raw(jf.packed_weighted_sum(jp).buf)
    auto = tf.tree_average(tp, weights=[1.0, 2.5, 0.25])
    assert isinstance(auto, tc.PackedTree)
    assert _raw(auto.buf) == _raw(jf.tree_average(jp, weights=[1.0, 2.5, 0.25]).buf)


def test_packed_weighted_sum_takes_numpy_and_tensor_buffers():
    """A JAX party's buffer may arrive as a host array: both forms fold to
    the same bytes."""
    tp = [tc.pack_tree(_torch(t)) for t in _np_trees(2, seed=2)]
    mixed = [tp[0], tc.PackedTree(tp[1].buf.view(torch.int16).numpy().view(
        jnp.bfloat16), tp[1].passthrough, tp[1].spec)]
    assert _raw(tf.packed_weighted_sum(mixed).buf) == _raw(tf.packed_weighted_sum(tp).buf)


@pytest.mark.parametrize("weights", WEIGHTS, ids=["mean", "3-5-7-11"])
def test_tree_average_equals_the_reference(weights):
    trees = _np_trees(4, seed=3)
    jr = jf.tree_average([_jax(t) for t in trees], weights)
    tr = tf.tree_average([_torch(t) for t in trees], weights)
    for k in jr:
        if k == "count":
            np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]), rtol=1e-6)
            assert tr[k].dtype == torch.float32 and jr[k].dtype == jnp.float32
        else:
            assert _raw(tr[k]) == _raw(jr[k]), k


def test_tree_weighted_sum_and_bf16_mean_equal_the_reference():
    trees = _np_trees(3, seed=4)
    w = [0.25, 0.5, 0.25]
    jr = jf.tree_weighted_sum([_jax(t) for t in trees], w)
    tr = tf.tree_weighted_sum([_torch(t) for t in trees], w)
    for k in ("w0", "w1", "w2"):
        assert _raw(tr[k]) == _raw(jr[k]), k
    np.testing.assert_allclose(tr["count"].numpy(), np.asarray(jr["count"]), rtol=1e-6)
    bf = [{"w": np.full((8,), 1.0 + i * 1e-2, np.float32)} for i in range(4)]
    javg = jf.tree_average([{"w": jnp.asarray(t["w"], jnp.bfloat16)} for t in bf])
    tavg = tf.tree_average([{"w": torch.from_numpy(t["w"]).to(torch.bfloat16)} for t in bf])
    assert tavg["w"].dtype == torch.bfloat16 and _raw(tavg["w"]) == _raw(javg["w"])


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_weight_guards_behave_the_same(pkg):
    f, c, conv = (jf, jc, _jax) if pkg == "jax" else (tf, tc, _torch)
    trees = [conv(t) for t in _np_trees(2, seed=5)]
    with pytest.raises(ValueError, match="zero"):
        f.tree_weighted_sum(trees, [0.0, 0.0])
    with pytest.raises(ValueError, match="non-empty"):
        f.tree_weighted_sum([], [])
    with pytest.raises(ValueError, match="zero"):
        f.tree_average(trees, weights=[0, 0])
    with pytest.raises(ValueError, match="non-finite"):
        f.tree_weighted_sum(trees, [float("inf"), 1.0])
    with pytest.raises(ValueError, match="3 weights for 2"):
        f.tree_average(trees, weights=[1, 1, 1])
    packed = [c.pack_tree(t) for t in trees]
    with pytest.raises(ValueError, match="zero"):
        f.packed_weighted_sum(packed, [0.0, 0.0])
    with pytest.raises(ValueError, match="at least one"):
        f.packed_weighted_sum([])
    with pytest.raises(ValueError, match="same spec"):
        f.packed_weighted_sum([packed[0], c.pack_tree({"w": conv({"w": np.ones(3, np.float32)})["w"]})])
    if pkg == "torch":
        with pytest.raises(ValueError):
            StreamingAggregator(2, weights=[0.0, 0.0], device="cpu")


def test_block_grid_and_stripe_schedule_equal_the_reference():
    for total, ce in ((0, 8), (1, 8), (8, 8), (9, 8), (5_000_000, None)):
        assert tf.packed_block_grid(total, ce) == jf.packed_block_grid(total, ce)
    for nb, ns in ((9, 4), (1, 3), (16, 1)):
        assert tf.packed_stripe_schedule(nb, ns) == jf.packed_stripe_schedule(nb, ns)
    with pytest.raises(ValueError):
        tf.packed_stripe_schedule(4, 0)
    acc = np.random.default_rng(6).standard_normal(100).astype(np.float32)
    for out in ("bfloat16", "float32"):
        j = jf.finalize_packed_stripe(jnp.asarray(acc), 7.0, 97, jnp.dtype(out))
        t = tf.finalize_packed_stripe(torch.from_numpy(acc), 7.0, 97, out)
        assert _raw(t) == _raw(j)
