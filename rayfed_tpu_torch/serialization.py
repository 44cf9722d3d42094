"""Restricted deserialization — anti-pickle-attack allowlist.

Capability parity with reference ``fed/_private/serialization_utils.py``:
cross-silo payload bytes are untrusted, so any pickled sub-payload is
deserialized through a :class:`RestrictedUnpickler` whose ``find_class``
only admits allowlisted modules/classes.  The allowlist format matches the
reference (``serialization_utils.py:63-77``): a dict mapping module name →
list of attribute names, with ``"*"`` admitting every attribute of the
module, e.g. ``{"numpy": ["float64"], "pandas": "*"}``.

Unlike the reference (which monkey-patches ``cloudpickle.loads`` inside the
recv proxy, ``barriers.py:342-345``), the allowlist here is threaded
explicitly through the wire codec — no global mutation, safe with multiple
in-process parties.

**Wire names of the skeleton classes.**  The wire codec's container
skeleton pickles two classes, ``_Skeleton`` and ``_LeafSlot``.  A party of
the JAX package writes them under that package's module path and admits
exactly those two globals; so that a party of this package can share a
round with it, this package writes them under the same module path
(:data:`SKELETON_WIRE_MODULE`), byte for byte, and reads them back as its
own classes.  Pickle resolves a global's module by importing it, which
would import the JAX package, so :func:`dumps_skeleton` uses a pickler
that writes those two globals itself, and every unpickler here maps them
in ``find_class``.

The packed wire form (``fl.compression``'s ``PackedTree`` and its
``PackSpec``) travels the same way, under :data:`PACKED_WIRE_MODULE`, and
its integer-coded form (``fl.quantize``'s ``QuantizedPackedTree`` and its
``QuantMeta``) under :data:`QUANT_WIRE_MODULE`, the hierarchy's partial
sum (``fl.hierarchy``'s ``RegionSumTree``) under
:data:`HIERARCHY_WIRE_MODULE`, and the server optimizer's replicated state
(``fl.server_opt``'s ``PackedServerState``) under
:data:`SERVER_OPT_WIRE_MODULE`, and a secure round's masked codes
(``fl.secagg``'s ``MaskedCodeTree``) under :data:`SECAGG_WIRE_MODULE`.  A
spec carries the tree's structure, which the JAX package pickles as a
jaxlib ``PyTreeDef``: a NEWOBJ of that class, then a BUILD with
``(jax._src.tree_util.default_registry, [nodes in post-order])``.  The
skeleton pickler writes a :class:`~rayfed_tpu_torch.tree_util.TreeDef` in
that form (:meth:`~rayfed_tpu_torch.tree_util.TreeDef.jax_nodes`), and the
unpicklers read it back as a ``TreeDef``.  All of these globals are admitted
whatever the allowlist says, as the reference admits them.
"""

from __future__ import annotations

import copyreg
import io
import pickle
from typing import Any, Dict, Optional

import cloudpickle

from rayfed_tpu_torch.tree_util import TreeDef

# The module paths the skeleton and packed classes travel under (see above).
SKELETON_WIRE_MODULE = "rayfed_tpu.transport.wire"
_SKELETON_NAMES = ("_Skeleton", "_LeafSlot")
_PORT_WIRE_MODULE = "rayfed_tpu_torch.transport.wire"
PACKED_WIRE_MODULE = "rayfed_tpu.fl.compression"
_PACKED_NAMES = ("PackedTree", "PackSpec")
_PORT_PACKED_MODULE = "rayfed_tpu_torch.fl.compression"
QUANT_WIRE_MODULE = "rayfed_tpu.fl.quantize"
_QUANT_NAMES = ("QuantizedPackedTree", "QuantMeta")
_PORT_QUANT_MODULE = "rayfed_tpu_torch.fl.quantize"
HIERARCHY_WIRE_MODULE = "rayfed_tpu.fl.hierarchy"
_HIERARCHY_NAMES = ("RegionSumTree",)
_PORT_HIERARCHY_MODULE = "rayfed_tpu_torch.fl.hierarchy"
SERVER_OPT_WIRE_MODULE = "rayfed_tpu.fl.server_opt"
_SERVER_OPT_NAMES = ("PackedServerState",)
_PORT_SERVER_OPT_MODULE = "rayfed_tpu_torch.fl.server_opt"
SECAGG_WIRE_MODULE = "rayfed_tpu.fl.secagg"
_SECAGG_NAMES = ("MaskedCodeTree",)
_PORT_SECAGG_MODULE = "rayfed_tpu_torch.fl.secagg"
# The globals of a pickled jaxlib PyTreeDef.
_TREEDEF_WIRE = ("jaxlib._jax.pytree", "PyTreeDef")
_REGISTRY_WIRE = ("jax._src.tree_util", "default_registry")


class _JaxDefaultRegistry:
    """Stands for ``jax._src.tree_util.default_registry`` in a pickled
    tree structure (the only registry the JAX package pickles)."""

    def __reduce__(self):
        return _REGISTRY_WIRE[1]


JAX_DEFAULT_REGISTRY = _JaxDefaultRegistry()


def _wire_global(module: str, name: str) -> Any:
    """This package's object for a global written under a wire name, or
    None.  ``PyTreeDef`` is admitted from any jax-owned module: its
    defining module moved across jaxlib versions."""
    if module == SKELETON_WIRE_MODULE and name in _SKELETON_NAMES:
        from rayfed_tpu_torch.transport import wire

        return getattr(wire, name)
    if module == PACKED_WIRE_MODULE and name in _PACKED_NAMES:
        from rayfed_tpu_torch.fl import compression

        return getattr(compression, name)
    if module == QUANT_WIRE_MODULE and name in _QUANT_NAMES:
        from rayfed_tpu_torch.fl import quantize

        return getattr(quantize, name)
    if module == HIERARCHY_WIRE_MODULE and name in _HIERARCHY_NAMES:
        from rayfed_tpu_torch.fl import hierarchy

        return getattr(hierarchy, name)
    if module == SERVER_OPT_WIRE_MODULE and name in _SERVER_OPT_NAMES:
        from rayfed_tpu_torch.fl import server_opt

        return getattr(server_opt, name)
    if module == SECAGG_WIRE_MODULE and name in _SECAGG_NAMES:
        from rayfed_tpu_torch.fl import secagg

        return getattr(secagg, name)
    if name == _TREEDEF_WIRE[1] and (
        module == "jaxlib" or module.startswith(("jaxlib.", "jax."))
    ):
        return TreeDef
    if (module, name) == _REGISTRY_WIRE:
        return JAX_DEFAULT_REGISTRY
    return None


def _wire_name_of(obj: Any) -> Optional[tuple]:
    """The wire name the skeleton pickler writes ``obj`` under, or None."""
    if obj is TreeDef:
        return _TREEDEF_WIRE
    if obj is JAX_DEFAULT_REGISTRY:
        return _REGISTRY_WIRE
    module = getattr(obj, "__module__", None)
    qualname = getattr(obj, "__qualname__", None)
    if module == _PORT_WIRE_MODULE and qualname in _SKELETON_NAMES:
        return SKELETON_WIRE_MODULE, qualname
    if module == _PORT_PACKED_MODULE and qualname in _PACKED_NAMES:
        return PACKED_WIRE_MODULE, qualname
    if module == _PORT_QUANT_MODULE and qualname in _QUANT_NAMES:
        return QUANT_WIRE_MODULE, qualname
    if module == _PORT_HIERARCHY_MODULE and qualname in _HIERARCHY_NAMES:
        return HIERARCHY_WIRE_MODULE, qualname
    if module == _PORT_SERVER_OPT_MODULE and qualname in _SERVER_OPT_NAMES:
        return SERVER_OPT_WIRE_MODULE, qualname
    if module == _PORT_SECAGG_MODULE and qualname in _SECAGG_NAMES:
        return SECAGG_WIRE_MODULE, qualname
    return None


def _compose_whitelist(allowed: Dict[str, Any]) -> tuple[set, set]:
    """Returns (exact {(module, name)}, wildcard {module})."""
    exact: set = set()
    wildcard: set = set()
    for module, names in (allowed or {}).items():
        if names == "*" or names is None:
            wildcard.add(module)
            continue
        if isinstance(names, str):
            names = [names]
        for name in names:
            if name == "*":
                wildcard.add(module)
            else:
                exact.add((module, name))
    return exact, wildcard


class _Unpickler(pickle.Unpickler):
    """Maps the wire names (see above) onto this package's objects."""

    def find_class(self, module: str, name: str):
        obj = _wire_global(module, name)
        if obj is not None:
            return obj
        return super().find_class(module, name)


class RestrictedUnpickler(_Unpickler):
    def __init__(self, file, allowed: Dict[str, Any], **kw) -> None:
        super().__init__(file, **kw)
        self._exact, self._wildcard = _compose_whitelist(allowed)

    def find_class(self, module: str, name: str):
        obj = _wire_global(module, name)
        if obj is not None:
            return obj
        if (module, name) in self._exact:
            return pickle.Unpickler.find_class(self, module, name)
        # Wildcard admits the module and any of its submodules
        # (reference admits e.g. "numpy.core.numeric" under "numpy": "*").
        parts = module.split(".")
        for i in range(len(parts), 0, -1):
            if ".".join(parts[:i]) in self._wildcard:
                return pickle.Unpickler.find_class(self, module, name)
        raise pickle.UnpicklingError(
            f"global '{module}.{name}' is forbidden by the serializing allowed list"
        )


def restricted_loads(data: bytes, allowed: Dict[str, Any]) -> Any:
    return RestrictedUnpickler(io.BytesIO(data), allowed).load()


def loads(data: bytes, allowed: Optional[Dict[str, Any]] = None) -> Any:
    """Deserialize with the allowlist if one is configured, else plain loads.

    Matches reference behavior: the restriction is applied only when
    ``serializing_allowed_list`` was passed to ``fed.init``
    (``barriers.py:342-345``).  Either way the skeleton classes' wire
    names resolve to this package's classes.
    """
    if allowed:
        return restricted_loads(data, allowed)
    return _Unpickler(io.BytesIO(data)).load()


def dumps(obj: Any) -> bytes:
    return cloudpickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


class _SkeletonPickler(pickle._Pickler):
    """The pure-Python pickler, writing the skeleton and packed classes
    under their wire names and a ``TreeDef`` as a jaxlib ``PyTreeDef``.
    The C pickler cannot be taught that (it verifies every global by
    importing its module); for everything else the two write the same
    bytes, and classes defined where they cannot be imported go by value
    through cloudpickle's reducer, as :func:`dumps` sends them."""

    def reducer_override(self, obj: Any):
        if type(obj) is TreeDef:
            # What pickling a PyTreeDef gives: NEWOBJ of the class, then
            # BUILD with (registry, nodes).
            return (
                copyreg.__newobj__, (TreeDef,),
                (JAX_DEFAULT_REGISTRY, obj.jax_nodes()),
            )
        return cloudpickle.Pickler.reducer_override(self, obj)

    # cloudpickle's reducers are plain methods that the pure-Python
    # pickler calls the same way the C one does.
    _function_reduce = cloudpickle.Pickler._function_reduce
    _dynamic_function_reduce = cloudpickle.Pickler._dynamic_function_reduce
    _function_getnewargs = cloudpickle.Pickler._function_getnewargs

    def __init__(self, file) -> None:
        super().__init__(file, protocol=pickle.HIGHEST_PROTOCOL)
        self.dispatch_table = cloudpickle.Pickler.dispatch_table
        self.globals_ref: Dict[int, Any] = {}

    def save_global(self, obj: Any, name: Optional[str] = None) -> None:
        wire_name = _wire_name_of(obj)
        if wire_name is not None:
            self.save(wire_name[0])
            self.save(wire_name[1])
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


def dumps_skeleton(obj: Any) -> bytes:
    """Pickle a wire skeleton with the wire names above: the bytes a party
    of the JAX package writes for the same tree."""
    buf = io.BytesIO()
    _SkeletonPickler(buf).dump(obj)
    return buf.getvalue()
