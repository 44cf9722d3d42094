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
"""

from __future__ import annotations

import io
import pickle
from typing import Any, Dict, Optional

import cloudpickle

# The one module path the skeleton classes travel under (see above).
SKELETON_WIRE_MODULE = "rayfed_tpu.transport.wire"
_SKELETON_NAMES = ("_Skeleton", "_LeafSlot")
_PORT_WIRE_MODULE = "rayfed_tpu_torch.transport.wire"


def _skeleton_class(name: str):
    from rayfed_tpu_torch.transport import wire

    return getattr(wire, name)


def _is_skeleton_global(module: str, name: str) -> bool:
    return module == SKELETON_WIRE_MODULE and name in _SKELETON_NAMES


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
    """Maps the skeleton classes' wire names onto this package's classes."""

    def find_class(self, module: str, name: str):
        if _is_skeleton_global(module, name):
            return _skeleton_class(name)
        return super().find_class(module, name)


class RestrictedUnpickler(_Unpickler):
    def __init__(self, file, allowed: Dict[str, Any], **kw) -> None:
        super().__init__(file, **kw)
        self._exact, self._wildcard = _compose_whitelist(allowed)

    def find_class(self, module: str, name: str):
        if _is_skeleton_global(module, name):
            return _skeleton_class(name)
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
    """The pure-Python pickler, writing the skeleton classes under their
    wire names.  The C pickler cannot be taught that (it verifies every
    global by importing its module); for everything else the two write
    the same bytes, and classes defined where they cannot be imported go
    by value through cloudpickle's reducer, as :func:`dumps` sends them."""

    # cloudpickle's reducers are plain methods that the pure-Python
    # pickler calls the same way the C one does.
    reducer_override = cloudpickle.Pickler.reducer_override
    _function_reduce = cloudpickle.Pickler._function_reduce
    _dynamic_function_reduce = cloudpickle.Pickler._dynamic_function_reduce
    _function_getnewargs = cloudpickle.Pickler._function_getnewargs

    def __init__(self, file) -> None:
        super().__init__(file, protocol=pickle.HIGHEST_PROTOCOL)
        self.dispatch_table = cloudpickle.Pickler.dispatch_table
        self.globals_ref: Dict[int, Any] = {}

    def save_global(self, obj: Any, name: Optional[str] = None) -> None:
        if (
            getattr(obj, "__module__", None) == _PORT_WIRE_MODULE
            and getattr(obj, "__qualname__", None) in _SKELETON_NAMES
        ):
            self.save(SKELETON_WIRE_MODULE)
            self.save(obj.__qualname__)
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


def dumps_skeleton(obj: Any) -> bytes:
    """Pickle a wire skeleton with the skeleton classes under their wire
    names: the bytes a party of the JAX package writes for the same tree."""
    buf = io.BytesIO()
    _SkeletonPickler(buf).dump(obj)
    return buf.getvalue()
