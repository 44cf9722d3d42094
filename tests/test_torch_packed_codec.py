"""The port's packed wire form (CPU) against the JAX package's.

Each tree is made from a numpy seed and packed by both packages: the specs,
the packed buffers, the ``encode_payload`` bytes of a ``PackedTree`` (its
skeleton pickles the spec's tree structure as a jaxlib ``PyTreeDef``) and
the error-feedback residuals must be equal.  Tolerance: byte identity.
"""

import collections
import json
import pickle
import struct

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from rayfed_tpu.fl import compression as jc
from rayfed_tpu.transport import wire as jwire
from rayfed_tpu_torch import serialization, tree_util
from rayfed_tpu_torch.fl import compression as tc
from rayfed_tpu_torch.transport import wire as twire

Pair = collections.namedtuple("Pair", "left right")


def _np_trees(seed):
    """Trees of numpy leaves (f32, bf16 bits, ints, python scalars, None,
    nested dicts, lists, tuples and a namedtuple)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return [
        {"w": f(3, 4), "b": f(5)},
        {"layer": {"k": f(7, 3), "i": np.arange(4, dtype=np.int32) + seed, "n": None},
         "t": (f(2), 3)},
        [f(6), {"z": f(2, 2), "half": f(4).astype(ml_dtypes.bfloat16)}, None, "tag"],
        Pair(f(3), {"q": f(1), "count": np.int64(seed)}),
        {"only_ints": np.arange(3, dtype=np.int32)},
        {"scalar": np.float32(2.5), "vec": f(9)},
    ]


def _to_jax(tree):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) and x.dtype.kind in "fV" else x, tree
    )


def _to_torch(tree):
    def conv(x):
        if isinstance(x, np.ndarray) and x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
        if isinstance(x, np.ndarray) and x.dtype.kind == "f":
            return torch.from_numpy(x.copy())
        return x

    return tree_util.tree_map(conv, tree)


def _bytes_of(buf):
    if isinstance(buf, torch.Tensor):
        return buf.reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(buf).tobytes()


def _payload(bufs):
    return b"".join(
        bytes(b) if isinstance(b, (bytes, bytearray)) else bytes(memoryview(b).cast("B"))
        for b in bufs
    )


CASES = [(seed, i) for seed in (0, 1) for i in range(len(_np_trees(0)))]


@pytest.mark.parametrize("seed,index", CASES)
def test_pack_specs_and_buffers_equal_the_reference(seed, index):
    tree = _np_trees(seed)[index]
    jp = jc.pack_tree(_to_jax(tree))
    tp = tc.pack_tree(_to_torch(tree))
    assert tp.spec.entries == jp.spec.entries
    assert tp.spec.wire_dtype == jp.spec.wire_dtype == "bfloat16"
    assert tp.spec.treedef.jax_nodes() == jp.spec.treedef.__getstate__()[1]
    assert _bytes_of(tp.buf) == _bytes_of(jp.buf)
    # Unpacked leaves equal the reference's, with and without a cast.
    for dtype, jdt in ((None, None), (torch.float32, jnp.float32)):
        jl = jax.tree_util.tree_leaves(jc.unpack_tree(jp, jdt))
        tl = tree_util.tree_leaves(tc.unpack_tree(tp, dtype))
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            if isinstance(b, torch.Tensor):
                assert _bytes_of(b) == np.asarray(a).tobytes()
                assert tc.dtype_name(b.dtype) == np.dtype(a.dtype).name
            elif isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


@pytest.mark.parametrize("seed,index", CASES)
def test_packed_payload_bytes_equal_the_reference(seed, index):
    tree = _np_trees(seed)[index]
    jp = jc.pack_tree(_to_jax(tree))
    tp = tc.pack_tree(_to_torch(tree))
    jb = _payload(jwire.encode_payload(jp))
    tb = _payload(twire.encode_payload(tp))
    assert tb == jb
    # Each package decodes the other's payload into its own PackedTree.
    back = twire.decode_payload(jb)
    assert isinstance(back, tc.PackedTree) and back.spec == tp.spec
    assert _bytes_of(back.buf) == _bytes_of(tp.buf)
    jback = jwire.decode_payload(tb)
    assert isinstance(jback, jc.PackedTree) and jback.spec == jp.spec


def test_packed_payload_under_the_allowlist():
    """The packed classes and the PyTreeDef globals are always admitted,
    as the reference admits them."""
    tp = tc.pack_tree({"w": torch.ones(3), "n": None})
    jb = _payload(jwire.encode_payload(jc.pack_tree({"w": jnp.ones(3), "n": None})))
    allowed = {"numpy": "*"}
    for payload in (_payload(twire.encode_payload(tp)), jb):
        back = twire.decode_payload(payload, allowed=allowed)
        assert back.spec == tp.spec
    with pytest.raises(pickle.UnpicklingError):
        serialization.restricted_loads(pickle.dumps(collections.Counter()), allowed)


def test_allowlist_admits_the_packed_and_pytreedef_globals_only():
    import io

    u = serialization.RestrictedUnpickler(io.BytesIO(b""), {"numpy": "*"})
    assert u.find_class("rayfed_tpu.fl.compression", "PackedTree") is tc.PackedTree
    assert u.find_class("rayfed_tpu.fl.compression", "PackSpec") is tc.PackSpec
    assert u.find_class("jax._src.tree_util", "default_registry") is serialization.JAX_DEFAULT_REGISTRY
    for module in ("jaxlib._jax.pytree", "jaxlib.xla_extension.pytree", "jax.tree_util", "jaxlib"):
        assert u.find_class(module, "PyTreeDef") is tree_util.TreeDef
    for module, name in (("jaxlib_evil", "PyTreeDef"), ("rayfed_tpu.fl.compression", "ErrorFeedback"),
                         ("rayfed_tpu_torch.fl.compression", "PackedTree")):
        with pytest.raises(pickle.UnpicklingError):
            u.find_class(module, name)


TREEDEF_CASES = [
    {"b": 1, "a": 2},
    {"x": {"y": 1, "z": [2, 3]}},
    [1, (2, None), {}],
    (),
    None,
    7,
    Pair(1, {"k": (2, 3)}),
    {"o": collections.OrderedDict(b=1, a=2)},
    {"d": collections.defaultdict(list, a=1, c=2)},
]


@pytest.mark.parametrize("index", range(len(TREEDEF_CASES)))
def test_treedef_pickle_round_trips_both_ways(index):
    tree = TREEDEF_CASES[index]
    jdef = jax.tree_util.tree_structure(tree)
    tdef = tree_util.tree_flatten(tree)[1]
    jbytes = pickle.dumps(jdef, protocol=pickle.HIGHEST_PROTOCOL)
    tbytes = serialization.dumps_skeleton(tdef)
    assert tbytes == jbytes
    # jaxlib reads the port's bytes; the port reads jaxlib's.
    assert pickle.loads(tbytes) == jdef
    back = serialization.loads(jbytes)
    assert isinstance(back, tree_util.TreeDef) and back == tdef
    leaves = list(range(tdef.num_leaves))
    assert tree_util.tree_unflatten(leaves, back) == jax.tree_util.tree_unflatten(jdef, leaves)


def test_treedef_of_a_custom_node_is_refused():
    inner = tc.pack_tree({"w": torch.ones(2)})
    tdef = tree_util.tree_flatten({"p": inner})[1]
    with pytest.raises(NotImplementedError, match="PackedTree"):
        serialization.dumps_skeleton(tdef)


def test_error_feedback_residuals_equal_over_three_rounds():
    rng = np.random.default_rng(3)
    jef, tef = jc.ErrorFeedback(jnp.bfloat16), tc.ErrorFeedback(torch.bfloat16)
    for r in range(3):
        tree = {"w": rng.standard_normal(4096).astype(np.float32) * (r + 1),
                "b": rng.standard_normal((3, 5)).astype(np.float32), "step": r}
        jp, tp = jef.compress(_to_jax(tree)), tef.compress(_to_torch(tree))
        assert tp.spec == tc.PackSpec(tp.spec.entries, tp.spec.treedef, "bfloat16")
        assert tp.spec.entries == jp.spec.entries
        assert _bytes_of(tp.buf) == _bytes_of(jp.buf)
        assert _bytes_of(tef.residual) == _bytes_of(jef.residual)
        assert _payload(twire.encode_payload(tp)) == _payload(jwire.encode_payload(jp))
    with pytest.raises(ValueError, match="reset"):
        tef.compress({"w": torch.ones(8)})
    tef.reset()
    assert tef.compress({"w": torch.ones(8)}).buf.dtype == torch.bfloat16


def test_compress_decompress_both_forms():
    tree = _to_torch(_np_trees(4)[1])
    per_leaf = tc.decompress(tc.compress(tree))
    packed = tc.decompress(tc.compress(tree, packed=True))
    for a, b in zip(tree_util.tree_leaves(per_leaf), tree_util.tree_leaves(packed)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b)
        else:
            assert a is b or np.array_equal(a, b)
    assert tc.cast_floats({"i": torch.arange(3)}, torch.bfloat16)["i"].dtype == torch.int64


def test_numpy_tree_packs_to_a_host_buffer_like_the_reference():
    tree = {"w": np.arange(6, dtype=np.float32), "v": np.ones(2, np.float32)}
    tp, jp = tc.pack_tree(tree), jc.pack_tree(tree)
    assert isinstance(tp.buf, np.ndarray) and tp.buf.dtype == jp.buf.dtype
    assert _payload(twire.encode_payload(tp)) == _payload(jwire.encode_payload(jp))


def test_lock_tree_packed_leaf_encodes_like_the_reference():
    """The packed part of tool/wire_format.lock's tree: the manifest entry,
    the manifest schema and the skeleton bytes of a packed leaf equal the
    reference's."""
    from tool.check_wire_format import _schema

    def parts(bufs):
        (mlen,) = struct.unpack(">I", bytes(bufs[0]))
        manifest = json.loads(bytes(bufs[1])[:mlen])
        return manifest, bytes(bufs[2])

    jm, jskel = parts(jwire.encode_payload({"packed": jc.pack_tree({"w": jnp.ones((3,))})}))
    tm, tskel = parts(twire.encode_payload({"packed": tc.pack_tree({"w": torch.ones(3)})}))
    assert tm == jm and _schema(tm) == _schema(jm)
    assert tskel == jskel
