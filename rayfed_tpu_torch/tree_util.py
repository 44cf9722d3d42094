"""Pytree helpers with ``jax.tree_util``'s node rules, in plain Python.

The wire codec lists a payload's leaves in flatten order and pickles the
container skeleton rebuilt by unflatten, so both are part of the wire
format: a party of this package and a party of the JAX package must agree
on them exactly.  ``torch.utils._pytree`` does not: it flattens a ``dict``
in insertion order, treats ``None`` as a leaf, and its registry is global
to the process (re-registering ``dict`` would change torch's own
behavior).  So this module walks the containers itself, with JAX's rules:

- ``dict`` and ``defaultdict``: children in **sorted key order**; unflatten
  rebuilds them with their keys in that order;
- ``OrderedDict``: insertion order;
- ``list``, ``tuple`` and every namedtuple are nodes (other tuple or list
  subclasses, such as ``torch.Size``, are leaves);
- ``None`` is a node with no children;
- a class given to :func:`register_pytree_node` (``fl.compression``'s
  ``PackedTree``) is a node with the children and static data its flatten
  function returns;
- everything else is a leaf — tensors, arrays, ``FedObject``,
  ``LocalRef``.

A :class:`TreeDef` also travels inside a packed tree's spec, where the JAX
package pickles a jaxlib ``PyTreeDef``: :meth:`TreeDef.jax_nodes` gives the
node list that pickle carries and :meth:`TreeDef.__setstate__` reads it back
(``serialization`` writes and admits the jaxlib names).
"""

from __future__ import annotations

import collections
from typing import Any, Callable, List, Optional, Tuple

_LEAF = "leaf"
_NONE = "none"
_TUPLE = "tuple"
_LIST = "list"
_DICT = "dict"
_ORDERED = "ordered"
_DEFAULT = "default"
_NAMED = "named"
_CUSTOM = "custom"

# Custom node classes: ``cls -> (flatten, unflatten)`` with
# ``flatten(x) -> (children, aux)`` and ``unflatten(aux, children) -> x``.
_REGISTRY: dict = {}


def register_pytree_node(cls: type, flatten: Callable, unflatten: Callable) -> None:
    """Make ``cls`` a node: ``flatten(x) -> (children, aux)`` and
    ``unflatten(aux, children) -> x`` (``jax.tree_util``'s signature)."""
    _REGISTRY[cls] = (flatten, unflatten)


# The node kinds of a pickled jaxlib PyTreeDef (its ``__getstate__`` list).
_JAX_LEAF, _JAX_NONE, _JAX_TUPLE, _JAX_NAMED, _JAX_LIST, _JAX_DICT, _JAX_CUSTOM = range(7)
_JAX_KINDS = {
    _LEAF: _JAX_LEAF, _NONE: _JAX_NONE, _TUPLE: _JAX_TUPLE,
    _NAMED: _JAX_NAMED, _LIST: _JAX_LIST, _DICT: _JAX_DICT,
}


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _sorted_keys(d: dict) -> list:
    try:
        return sorted(d)
    except TypeError as e:
        raise ValueError(
            f"pytree dict keys must be sortable, got {list(d)!r}"
        ) from e


class TreeDef:
    """The structure of a flattened pytree (a node kind, its static data
    and its children's structures)."""

    __slots__ = ("kind", "aux", "children", "num_leaves", "num_nodes")

    def __init__(self, kind: str, aux: Any = None, children: Tuple = ()) -> None:
        self.kind = kind
        self.aux = aux
        self.children = tuple(children)
        self.num_leaves = 1 if kind == _LEAF else sum(c.num_leaves for c in children)
        self.num_nodes = 1 + sum(c.num_nodes for c in children)

    def __repr__(self) -> str:
        if self.kind == _LEAF:
            return "*"
        return f"TreeDef({self.kind}, {self.aux!r}, {list(self.children)!r})"

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, TreeDef):
            return NotImplemented
        return (
            self.kind == other.kind
            and self.aux == other.aux
            and self.children == other.children
        )

    def __reduce__(self):
        return (TreeDef, (self.kind, self.aux, self.children))

    # -- the pickled form of a jaxlib PyTreeDef --------------------------------

    def jax_nodes(self) -> List[tuple]:
        """The node list a jaxlib ``PyTreeDef`` pickles for this structure:
        post-order ``(kind, arity, node_data, custom, num_leaves,
        num_nodes)`` tuples.  Each tuple and key list is a new object, as
        jaxlib builds them (the pickle memo keys on identity)."""
        out: List[tuple] = []
        self._jax_nodes(out)
        return out

    def _jax_nodes(self, out: List[tuple]) -> None:
        for c in self.children:
            c._jax_nodes(out)
        kind, custom = self.kind, None
        if kind == _DICT:
            data: Any = list(self.aux)
        elif kind == _NAMED:
            data = self.aux
        elif kind == _ORDERED:
            data, custom = tuple(list(self.aux)), collections.OrderedDict
        elif kind == _DEFAULT:
            data = (self.aux[0], tuple(list(self.aux[1])))
            custom = collections.defaultdict
        elif kind in _JAX_KINDS:
            data = None
        else:
            raise NotImplementedError(
                f"a {self.aux[0].__name__} node inside a pickled tree "
                f"structure has no PyTreeDef form here"
            )
        code = _JAX_KINDS.get(kind, _JAX_CUSTOM)
        out.append(tuple([
            code, len(self.children), data, custom, self.num_leaves, self.num_nodes,
        ]))

    def __setstate__(self, state: tuple) -> None:
        """Rebuild from a pickled jaxlib ``PyTreeDef``'s state
        ``(registry, nodes)`` (the unpickler maps that class onto this one)."""
        _registry, nodes = state
        stack: List[TreeDef] = []
        for code, arity, data, custom, _nl, _nn in nodes:
            children = tuple(stack[len(stack) - arity:]) if arity else ()
            del stack[len(stack) - arity:]
            if code == _JAX_LEAF:
                node = TreeDef(_LEAF)
            elif code == _JAX_NONE:
                node = TreeDef(_NONE)
            elif code == _JAX_TUPLE:
                node = TreeDef(_TUPLE, None, children)
            elif code == _JAX_LIST:
                node = TreeDef(_LIST, None, children)
            elif code == _JAX_DICT:
                node = TreeDef(_DICT, tuple(data), children)
            elif code == _JAX_NAMED:
                node = TreeDef(_NAMED, data, children)
            elif code == _JAX_CUSTOM and custom is collections.OrderedDict:
                node = TreeDef(_ORDERED, tuple(data), children)
            elif code == _JAX_CUSTOM and custom is collections.defaultdict:
                node = TreeDef(_DEFAULT, (data[0], tuple(data[1])), children)
            else:
                raise ValueError(
                    f"pickled tree structure has a node of kind {code} "
                    f"({custom!r}) this package cannot rebuild"
                )
            stack.append(node)
        if len(stack) != 1:
            raise ValueError("pickled tree structure is not a single tree")
        root = stack[0]
        for name in TreeDef.__slots__:
            setattr(self, name, getattr(root, name))

    def unflatten(self, leaves: List[Any]) -> Any:
        it = iter(leaves)
        out = self._build(it)
        if next(it, _END) is not _END:
            raise ValueError(
                f"too many leaves for a tree of {self.num_leaves} leaves"
            )
        return out

    def _build(self, it) -> Any:
        kind = self.kind
        if kind == _LEAF:
            leaf = next(it, _END)
            if leaf is _END:
                raise ValueError("too few leaves for the tree structure")
            return leaf
        if kind == _NONE:
            return None
        values = [c._build(it) for c in self.children]
        if kind == _TUPLE:
            return tuple(values)
        if kind == _LIST:
            return values
        if kind == _DICT:
            return dict(zip(self.aux, values))
        if kind == _ORDERED:
            return collections.OrderedDict(zip(self.aux, values))
        if kind == _DEFAULT:
            factory, keys = self.aux
            return collections.defaultdict(factory, zip(keys, values))
        if kind == _CUSTOM:
            cls, aux = self.aux
            return _REGISTRY[cls][1](aux, values)
        return self.aux(*values)  # namedtuple

    def flatten_up_to(self, tree: Any) -> List[Any]:
        """The subtrees of ``tree`` at this structure's leaf positions."""
        out: List[Any] = []
        self._up_to(tree, out)
        return out

    def _up_to(self, tree: Any, out: List[Any]) -> None:
        if self.kind == _LEAF:
            out.append(tree)
            return
        node = _node_of(tree)
        if node is None or node[0] != self.kind or node[1] != self.aux:
            raise ValueError(f"tree {tree!r} does not match structure {self!r}")
        for child, sub in zip(self.children, node[2]):
            child._up_to(sub, out)


_END = object()


def _node_of(x: Any) -> Optional[Tuple[str, Any, list]]:
    """``(kind, aux, children)`` of a container node, or None for a leaf."""
    if x is None:
        return _NONE, None, []
    t = type(x)
    if t is tuple:
        return _TUPLE, None, list(x)
    if t is list:
        return _LIST, None, list(x)
    if t is dict:
        keys = _sorted_keys(x)
        return _DICT, tuple(keys), [x[k] for k in keys]
    if t is collections.OrderedDict:
        keys = tuple(x)
        return _ORDERED, keys, [x[k] for k in keys]
    if t is collections.defaultdict:
        keys = _sorted_keys(x)
        return _DEFAULT, (x.default_factory, tuple(keys)), [x[k] for k in keys]
    if _is_namedtuple(x):
        return _NAMED, t, list(x)
    rule = _REGISTRY.get(t)
    if rule is not None:
        children, aux = rule[0](x)
        return _CUSTOM, (t, aux), list(children)
    return None


def _flatten(tree: Any, is_leaf, leaves: List[Any]) -> TreeDef:
    if is_leaf is not None and is_leaf(tree):
        leaves.append(tree)
        return _LEAF_DEF
    node = _node_of(tree)
    if node is None:
        leaves.append(tree)
        return _LEAF_DEF
    kind, aux, children = node
    return TreeDef(kind, aux, tuple(_flatten(c, is_leaf, leaves) for c in children))


_LEAF_DEF = TreeDef(_LEAF)


def tree_flatten(
    tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None
) -> Tuple[list, TreeDef]:
    """Flatten ``tree``; returns ``(leaves, treedef)``."""
    leaves: List[Any] = []
    treedef = _flatten(tree, is_leaf, leaves)
    return leaves, treedef


def tree_unflatten(leaves: list, treedef: TreeDef) -> Any:
    """Inverse of :func:`tree_flatten` (note: leaves first, like the reference)."""
    return treedef.unflatten(list(leaves))


def tree_map(
    fn: Callable, tree: Any, *rest: Any, is_leaf: Optional[Callable[[Any], bool]] = None
) -> Any:
    leaves, treedef = tree_flatten(tree, is_leaf=is_leaf)
    others = [treedef.flatten_up_to(r) for r in rest]
    return treedef.unflatten([fn(*xs) for xs in zip(leaves, *others)])


def tree_leaves(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None) -> list:
    return tree_flatten(tree, is_leaf=is_leaf)[0]
