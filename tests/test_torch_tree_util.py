"""The port's pytree rules against ``jax.tree_util`` (CPU).

The wire manifest lists leaves in flatten order and pickles the skeleton
that unflatten rebuilds, so the two packages must agree exactly: leaves
are compared as lists, rebuilt trees by type and key order, and the
pickled skeletons byte for byte.
"""

import collections
import pickle
from collections import OrderedDict, defaultdict, namedtuple

import jax
import numpy as np
import pytest
import torch

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.executor import LocalRef
from rayfed_tpu_torch.fed_object import FedObject

Point = namedtuple("Point", ["x", "y"])

TREES = {
    "unsorted_dict": {"b": 1, "a": 2, "c": None},
    "nested_dict": {"z": {"q": [1, 2], "p": (3,)}, "a": {"y": 4, "x": 5}},
    "ordered_dict": OrderedDict([("z", 1), ("a", 2), ("m", None)]),
    "namedtuple": Point(1, (2, Point(3, None))),
    "none": None,
    "nested_lists_tuples": [1, (2, [3, (4,)], ()), [], [None, 5]],
    "defaultdict": defaultdict(list, {"b": [1], "a": [2, 3]}),
    "mixed": {"b": [Point("s", 1.5)], "a": OrderedDict([("k", (True, None))])},
    "int_keys": {3: "c", 1: "a", 2: "b"},
    "leaf": 7,
    "empty": {},
}


def _structure(tree):
    """Type and key order of every node, to compare rebuilt trees exactly."""
    if isinstance(tree, dict):
        return (type(tree).__name__, [(k, _structure(v)) for k, v in tree.items()])
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, [_structure(v) for v in tree])
    return repr(tree)


@pytest.mark.parametrize("name", sorted(TREES))
def test_flatten_order_matches_jax(name):
    tree = TREES[name]
    leaves, _ = tree_util.tree_flatten(tree)
    jleaves, _ = jax.tree_util.tree_flatten(tree)
    assert leaves == jleaves


@pytest.mark.parametrize("name", sorted(TREES))
def test_unflatten_rebuilds_what_jax_rebuilds(name):
    tree = TREES[name]
    leaves, treedef = tree_util.tree_flatten(tree)
    jleaves, jtreedef = jax.tree_util.tree_flatten(tree)
    slots = [f"slot-{i}" for i in range(len(leaves))]
    ours = tree_util.tree_unflatten(slots, treedef)
    theirs = jax.tree_util.tree_unflatten(jtreedef, slots)
    assert _structure(ours) == _structure(theirs)
    # The skeleton's pickled bytes depend on that order (tolerance: none).
    assert pickle.dumps(ours, protocol=5) == pickle.dumps(theirs, protocol=5)
    assert treedef.num_leaves == jtreedef.num_leaves


def test_dict_rebuilds_in_sorted_key_order():
    tree = {"b": 1, "a": 2, "c": None}
    leaves, treedef = tree_util.tree_flatten(tree)
    assert leaves == [2, 1]
    assert list(tree_util.tree_unflatten(leaves, treedef)) == ["a", "b", "c"]


def test_fed_objects_local_refs_tensors_are_leaves():
    fo = FedObject("alice", 3, None)
    ref = LocalRef.from_value(1)
    t = torch.ones(2)
    size = torch.Size([2, 3])  # a tuple subclass: a leaf, as in JAX
    tree = {"f": [fo], "r": (ref, None), "t": t, "s": size}
    leaves, treedef = tree_util.tree_flatten(tree)
    assert [type(x) for x in leaves] == [FedObject, LocalRef, torch.Size, torch.Tensor]
    jleaves, _ = jax.tree_util.tree_flatten(tree)
    assert [type(x) for x in jleaves] == [type(x) for x in leaves]
    rebuilt = tree_util.tree_unflatten(leaves, treedef)
    assert rebuilt["f"][0] is fo and rebuilt["t"] is t


def test_is_leaf_stops_descent():
    tree = {"a": [1, 2], "b": None, "c": (3, [4])}
    for pred in (lambda x: isinstance(x, list), lambda x: x is None):
        assert tree_util.tree_leaves(tree, is_leaf=pred) == jax.tree_util.tree_leaves(
            tree, is_leaf=pred
        )


def test_tree_map_several_trees():
    a = {"y": [1, 2], "x": Point(3, 4)}
    b = {"x": Point(10, 20), "y": [30, 40]}
    out = tree_util.tree_map(lambda u, v: u + v, a, b)
    assert out == jax.tree_util.tree_map(lambda u, v: u + v, a, b)
    with pytest.raises(ValueError):
        tree_util.tree_map(lambda u, v: u, a, {"x": 1, "y": [1, 2]})


def test_leaf_count_mismatch_raises():
    _, treedef = tree_util.tree_flatten([1, (2, 3)])
    with pytest.raises(ValueError):
        tree_util.tree_unflatten([1, 2], treedef)
    with pytest.raises(ValueError):
        tree_util.tree_unflatten([1, 2, 3, 4], treedef)


# Ports of tests/test_tree_utils.py.


def test_flatten_unflatten_roundtrip():
    tree = {
        "a": [1, 2, (3, 4)],
        "b": {"c": 5, "d": None},
        "e": OrderedDict([("k", 6)]),
        "p": Point(7, 8),
    }
    leaves, treedef = tree_util.tree_flatten(tree)
    rebuilt = tree_util.tree_unflatten(leaves, treedef)
    assert rebuilt == tree


def test_leaf_replacement():
    tree = ["hello", [1, 2], {"k": 3}]
    leaves, treedef = tree_util.tree_flatten(tree)
    replaced = [f"leaf-{i}" for i in range(len(leaves))]
    rebuilt = tree_util.tree_unflatten(replaced, treedef)
    assert rebuilt == ["leaf-0", ["leaf-1", "leaf-2"], {"k": "leaf-3"}]


def test_fed_objects_are_leaves():
    fo = FedObject("alice", 3, None)
    tree = ["x", [fo], {"k": [fo, 1]}]
    leaves, _ = tree_util.tree_flatten(
        tree, is_leaf=lambda x: isinstance(x, FedObject)
    )
    assert sum(1 for leaf in leaves if isinstance(leaf, FedObject)) == 2


def test_arrays_are_leaves():
    arr = np.ones((2, 2))
    leaves, treedef = tree_util.tree_flatten({"w": arr, "b": [arr, arr]})
    assert len(leaves) == 3
    rebuilt = tree_util.tree_unflatten(leaves, treedef)
    assert np.all(rebuilt["w"] == arr)


def test_defaultdict_keeps_its_factory():
    tree = collections.defaultdict(int, {"b": 1, "a": 2})
    leaves, treedef = tree_util.tree_flatten(tree)
    rebuilt = tree_util.tree_unflatten(leaves, treedef)
    assert type(rebuilt) is collections.defaultdict and rebuilt.default_factory is int
    assert list(rebuilt) == ["a", "b"]
