"""Wire compression for federated exchanges.

Casting float leaves to bfloat16 for the wire halves a round's push bytes
and keeps about three decimal digits, which is safe for parameter averaging
when the accumulate runs in f32 (:func:`~rayfed_tpu_torch.fl.fedavg.
tree_average` does).

Two wire forms, as in the JAX package:

**Per-leaf** (:func:`cast_floats`): every float leaf is cast on its own.

**Packed** (:class:`PackedTree`): all float leaves are flattened into ONE
contiguous wire-dtype buffer by one cast and one concatenation, with a
static :class:`PackSpec` carrying each leaf's ``(offset, size, shape,
dtype)``, so decode is one cast (or none) plus per-leaf views into the
buffer.  Non-float leaves ride alongside untouched.  ``PackedTree`` is a
node of :mod:`rayfed_tpu_torch.tree_util` with children ``(buf,
*passthrough)`` and the spec as static data, so the wire codec sees one
large tensor leaf.  Its payload bytes are the JAX package's: the classes
travel under that package's module path and the spec's tree structure as a
jaxlib ``PyTreeDef`` (:mod:`rayfed_tpu_torch.serialization`).

The spec's dtype names are numpy's (``"bfloat16"``, ``"float32"``), taken
from a table of torch dtypes: numpy knows ``bfloat16`` only through
``ml_dtypes``, which a host with the card need not have.

Usage (each side of the exchange)::

    push:     fed_obj = train.remote(...)  # task returns compress(tree)
    consume:  params = decompress(fed.get(obj), torch.float32)
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.transport import wire

# ml_dtypes' dtypes hand back one stored ``.name`` string, numpy's own
# dtypes a new one on each call.  A PackSpec's pickle memo keys on string
# identity, so names follow the same rule to give the JAX package's bytes.
_SHARED_NAMES = ("bfloat16", "float8_e4m3fn", "float8_e5m2")


def torch_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype name or a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    return wire._torch_dtype(name)


def dtype_name(dtype: Any) -> str:
    """numpy's name of ``dtype`` (a torch dtype, a name or a numpy dtype)."""
    name = wire._DTYPE_NAMES[torch_dtype(dtype)]
    return name if name in _SHARED_NAMES else name.encode().decode()


def _leaf_dtype_name(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        return dtype_name(leaf.dtype)
    return np.dtype(leaf.dtype).name


def _is_float_leaf(leaf: Any) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point()
    if isinstance(leaf, np.ndarray) or isinstance(leaf, np.generic):
        name = leaf.dtype.name
        return name in wire._TORCH_DTYPES and wire._TORCH_DTYPES[name].is_floating_point
    return False


def _cast_leaf(leaf: Any, dtype: Any) -> Any:
    if isinstance(leaf, torch.Tensor):
        return leaf.to(torch_dtype(dtype))
    return np.asarray(leaf).astype(np.dtype(dtype_name(dtype)))


def cast_floats(tree: Any, dtype: Any) -> Any:
    """Cast every floating leaf to ``dtype`` (ints/bools untouched)."""
    return tree_util.tree_map(
        lambda leaf: _cast_leaf(leaf, dtype) if _is_float_leaf(leaf) else leaf, tree
    )


class PackSpec(NamedTuple):
    """Static description of a packed tree.

    ``entries`` — one tuple per original leaf, in flatten order:
    ``("f", offset, size, shape, orig_dtype_name)`` for packed float
    leaves (offset/size in *elements* of the wire dtype), or
    ``("p", index)`` for passthrough leaves.  ``treedef`` — the original
    tree structure.  ``wire_dtype`` — dtype name of the packed buffer.
    """

    entries: Tuple
    treedef: Any
    wire_dtype: str


class PackedTree:
    """Wire form of a pytree: one contiguous float buffer + passthrough.

    A node of :mod:`rayfed_tpu_torch.tree_util` whose children are
    ``(buf, *passthrough)``; the :class:`PackSpec` rides as static data
    (pickled with the container skeleton on the wire).  ``buf`` is a
    ``torch.Tensor``, or an ``np.ndarray`` when a party packed host arrays.
    """

    __slots__ = ("buf", "passthrough", "spec")

    def __init__(self, buf: Any, passthrough: Tuple, spec: PackSpec) -> None:
        self.buf = buf
        self.passthrough = tuple(passthrough)
        self.spec = spec

    @property
    def nbytes(self) -> int:
        total = getattr(self.buf, "nbytes", 0)
        for leaf in self.passthrough:
            total += getattr(leaf, "nbytes", 0)
        return total

    def unpack(self, dtype: Any = None) -> Any:
        """Reconstruct the original tree; see :func:`unpack_tree`."""
        return unpack_tree(self, dtype)

    def __reduce__(self):
        return (PackedTree, (self.buf, self.passthrough, self.spec))

    def __repr__(self) -> str:  # pragma: no cover
        n = sum(1 for e in self.spec.entries if e[0] == "f")
        return (
            f"PackedTree({n} float leaves packed as "
            f"{self.spec.wire_dtype}[{tuple(getattr(self.buf, 'shape', ()))}], "
            f"{len(self.passthrough)} passthrough)"
        )


tree_util.register_pytree_node(
    PackedTree,
    lambda pt: ((pt.buf, *pt.passthrough), pt.spec),
    lambda spec, children: PackedTree(children[0], tuple(children[1:]), spec),
)


def pack_tree(tree: Any, wire_dtype: Any = torch.bfloat16) -> PackedTree:
    """Pack every float leaf of ``tree`` into one ``wire_dtype`` buffer.

    Tensor leaves are cast and concatenated on their device (one buffer
    there); a tree of host arrays only is packed into one ``np.ndarray``.
    Leaf order is flatten order and offsets are deterministic, so two
    parties packing the same structure produce identical specs.
    """
    leaves, treedef = tree_util.tree_flatten(tree)
    wire_name = dtype_name(wire_dtype)
    entries = []
    float_leaves = []
    passthrough = []
    offset = 0
    for leaf in leaves:
        if _is_float_leaf(leaf):
            shape = tuple(int(d) for d in leaf.shape)
            size = math.prod(shape) if shape else 1
            entries.append(("f", offset, size, shape, _leaf_dtype_name(leaf)))
            float_leaves.append(leaf)
            offset += size
        else:
            entries.append(("p", len(passthrough)))
            passthrough.append(leaf)
    spec = PackSpec(tuple(entries), treedef, wire_name)

    dt = torch_dtype(wire_name)
    if not float_leaves:
        # The reference's empty buffer is a host array; numpy knows
        # bfloat16 only with ml_dtypes, so without it the buffer is an
        # empty tensor (the payload then marks it a device leaf).
        try:
            buf: Any = np.zeros(0, dtype=np.dtype(wire_name))
        except TypeError:
            buf = torch.zeros(0, dtype=dt)
    elif any(isinstance(l, torch.Tensor) for l in float_leaves):
        device = next(l.device for l in float_leaves if isinstance(l, torch.Tensor))
        buf = torch.cat([
            torch.as_tensor(l, device=device).reshape(-1).to(dt) for l in float_leaves
        ])
    else:
        buf = np.empty(offset, dtype=np.dtype(wire_name))
        pos = 0
        for leaf in float_leaves:
            n = math.prod(leaf.shape) if leaf.shape else 1
            buf[pos : pos + n] = np.asarray(leaf).reshape(-1)  # casts in place
            pos += n
    return PackedTree(buf, tuple(passthrough), spec)


def unpack_tree(packed: PackedTree, dtype: Any = None) -> Any:
    """Reconstruct the original tree from a :class:`PackedTree`.

    ``dtype=None`` keeps the wire dtype: the float leaves come back as
    views into the packed buffer (no cast, no allocation).  With a target
    ``dtype`` the whole buffer is cast ONCE and the per-leaf reshapes are
    views of that single allocation.
    """
    entries, treedef, wire_name = packed.spec
    buf = packed.buf
    name = None if dtype is None else dtype_name(dtype)
    if name == wire_name:
        name = None

    float_views: Tuple = ()
    if any(e[0] == "f" for e in entries):
        if isinstance(buf, torch.Tensor):
            if name is not None:
                buf = buf.to(torch_dtype(name))
        else:
            buf = np.asarray(buf)
            if name is not None:
                buf = buf.astype(np.dtype(name))
        float_views = tuple(
            buf[e[1] : e[1] + e[2]].reshape(e[3]) for e in entries if e[0] == "f"
        )

    leaves = []
    fi = 0
    for entry in entries:
        if entry[0] == "f":
            leaves.append(float_views[fi])
            fi += 1
        else:
            leaves.append(packed.passthrough[entry[1]])
    return tree_util.tree_unflatten(leaves, treedef)


def _ef_step(buf32: torch.Tensor, resid: torch.Tensor, wire_dt: torch.dtype):
    """The error-feedback step over the packed f32 buffer: add the carried
    residual, cast to the wire dtype, carry the new cast error; subnormals
    flushed as the JAX package's program flushes them."""
    from rayfed_tpu_torch.ops import ftz

    corrected = ftz.add(buf32, resid)
    wire_buf = corrected.to(wire_dt)
    return wire_buf, ftz.sub(corrected, wire_buf.to(torch.float32))


class ErrorFeedback:
    """Residual error feedback keeping lossy wire dtypes convergent.

    Each :meth:`compress` adds the residual cast error of the PREVIOUS
    round to the outgoing update before casting to the wire dtype, then
    carries the new round's error forward (EF14/EF-SGD).  Keep one instance
    per outgoing compressed stream, and :meth:`reset` it when the tree
    structure changes.
    """

    def __init__(self, wire_dtype: Any = torch.bfloat16) -> None:
        self._wire_name = dtype_name(wire_dtype)
        self._resid: Any = None

    @property
    def residual(self) -> Any:
        """The carried f32 residual buffer (None before the first round)."""
        return self._resid

    def reset(self) -> None:
        self._resid = None

    def compress(self, tree: Any) -> PackedTree:
        """Pack ``tree`` with error feedback; returns the wire PackedTree."""
        packed32 = pack_tree(tree, torch.float32)
        buf32 = torch.as_tensor(packed32.buf)
        if self._resid is None:
            self._resid = torch.zeros_like(buf32)
        elif self._resid.shape != buf32.shape:
            raise ValueError(
                f"tree structure changed under error feedback "
                f"({tuple(self._resid.shape)} residual vs "
                f"{tuple(buf32.shape)} buffer) — call reset() when switching models"
            )
        wire_buf, self._resid = _ef_step(
            buf32, self._resid, torch_dtype(self._wire_name)
        )
        spec = PackSpec(packed32.spec.entries, packed32.spec.treedef, self._wire_name)
        return PackedTree(wire_buf, packed32.passthrough, spec)


def compress(tree: Any, *, packed: bool = False, wire_dtype: Any = torch.bfloat16):
    """Wire form of a float param tree (half the push bytes at bf16).

    ``packed=True`` selects the single-buffer form (:class:`PackedTree`).
    """
    if packed:
        return pack_tree(tree, wire_dtype)
    return cast_floats(tree, wire_dtype)


def decompress(tree: Any, dtype: Any = torch.float32) -> Any:
    """Restore a wire-compressed tree (any form) to the compute dtype,
    through ``tree.unpack`` (the integer form dequantizes first)."""
    if isinstance(tree, PackedTree):
        return tree.unpack(dtype)
    return cast_floats(tree, dtype)


# The shared-grid integer codec, re-exported: one import surface for wire
# forms.  Lazy (PEP 562): fl.quantize subclasses PackedTree, so it imports
# this module first.
_QUANTIZE_EXPORTS = (
    "QuantCompressor",
    "QuantGrid",
    "QuantizedPackedTree",
    "dequantize_packed",
    "make_round_grid",
    "quantize_packed",
)


def __getattr__(name: str):
    if name in _QUANTIZE_EXPORTS:
        from rayfed_tpu_torch.fl import quantize

        return getattr(quantize, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "PackSpec",
    "PackedTree",
    "ErrorFeedback",
    "cast_floats",
    "compress",
    "decompress",
    "pack_tree",
    "unpack_tree",
    *_QUANTIZE_EXPORTS,
]
