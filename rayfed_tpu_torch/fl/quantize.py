"""Shared-grid integer quantization: the compressed-domain wire codec (the
port of ``rayfed_tpu/fl/quantize.py``).

A **shared quantization grid** makes the sum commute with the encoding::

    sum_i w_i * x_i  ==  scale_b * (sum_i w_i * q_i  -  zp_b * W)      (*)

where every party codes block ``b`` of its packed update on the SAME affine
grid ``x ~ scale_b * (q - zp_b)`` and ``W = sum_i w_i``.  The aggregator
folds the integer codes (an exact i32 multiply-add) and rescales once at
finalize (:mod:`rayfed_tpu_torch.fl.fedavg`, :mod:`~rayfed_tpu_torch.fl.
streaming`).  Wire bytes drop to the integer width.

- :class:`QuantGrid`: the per-round grid, one scale and zero point per
  block of the canonical chunk grid (``fedavg.packed_block_grid``),
  derived by :func:`make_round_grid` from a buffer every controller holds
  bit-identically; pure numpy, so the derivation, the CRC32
  :meth:`~QuantGrid.fingerprint` and the frame descriptor are the JAX
  package's byte for byte.
- :class:`QuantizedPackedTree`: the wire form, the codes as ``buf`` plus
  the grid's scale and zero-point vectors and a :class:`QuantMeta`.  Its
  payload bytes are the JAX package's: both classes travel under that
  package's module path (:data:`~rayfed_tpu_torch.serialization.
  QUANT_WIRE_MODULE`).  Like the reference, the codes are a host
  ``np.ndarray``; the grid vectors too.
- :class:`QuantCompressor`: the sender's error-feedback residual, in two
  phases (``quantize`` → ``commit``/``rollback``); :class:`RoundCodec`
  bundles one round's sender-side discipline.

The JAX package's two jitted programs are plain torch ops here, run on the
device of the buffer (or of the reference buffer) they are given:
:func:`_quantize_codes` (subtract the reference, add the residual, round
half to even, clip, carry the new residual) and :func:`_dequantize_codes`.
Divisions stay true divisions.  Two of their multiply-adds XLA compiles
into fused multiply-adds (one rounding): the new residual ``corrected −
scale·(q − zp)`` and the reference add ``ref + scale·(q − zp)``.  Those two
are computed here as exactly rounded fused multiply-adds, the same bytes on
the CPU and the card: :func:`rayfed_tpu_torch.ops.fold.fma_rows`, its
plain version on CPU tensors and the fold kernel's rows form on the card
(one launch a piece of block rows, the codes read as they are); every other
multiply-add stays two ops.  So codes, residuals and dequantized buffers
equal the reference's bytes on the CPU.

Overflow headroom: a folded code is bounded by ``qabs_max`` (255 for
uint8), so the i32 accumulator holds ``|acc| <= qabs_max * W``; the integer
path takes non-negative integral weights with ``qabs_max * W <= 2**31 - 1``
(:meth:`QuantGrid.check_weight_headroom`).
"""

from __future__ import annotations

import json
import zlib
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.fl import compression
from rayfed_tpu_torch.fl.compression import PackedTree, PackSpec
from rayfed_tpu_torch.ops import ftz
from rayfed_tpu_torch.ops.fold import fma_rows

# Version of the shared-grid descriptor and semantics (the JAX package's).
QUANT_GRID_VERSION = 1

# Headroom factor of compressed-domain uplink grids: per-party deltas
# overshoot their mean, and what still clips rides the residual.
QUANT_DELTA_EXPAND = 4.0

# Integer wire dtypes the grid supports → (qmin, qmax).
_QRANGES: Dict[str, Tuple[int, int]] = {
    "uint8": (0, 255),
    "int8": (-128, 127),
}


def _qrange(wire_dtype: str) -> Tuple[int, int]:
    try:
        return _QRANGES[wire_dtype]
    except KeyError:
        raise ValueError(
            f"unsupported quantized wire dtype {wire_dtype!r} — one of "
            f"{sorted(_QRANGES)}"
        ) from None


def _numel(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel()
    return int(getattr(x, "size", 0))


def _host_f32(x: Any) -> np.ndarray:
    """A flat f32 numpy copy of a tensor (any device) or an array."""
    if isinstance(x, PackedTree):
        x = x.buf
    if isinstance(x, torch.Tensor):
        return x.detach().reshape(-1).to(torch.float32).cpu().numpy()
    return np.asarray(x).reshape(-1).astype(np.float32)


def _device_of(*xs: Any) -> torch.device:
    """The device of the first tensor among ``xs`` (the CPU for none)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def _f32_on(x: Any, device: torch.device) -> torch.Tensor:
    """``x`` (a tensor or an array) as a flat f32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.detach().reshape(-1).to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).reshape(-1), np.float32)).to(device)


class QuantGrid:
    """The per-round shared quantization grid.

    ``scales``/``zps``: one f32 scale and zero point per canonical
    packed-buffer block (``fedavg.packed_block_grid`` over ``total_elems``
    at ``chunk_elems`` granularity).  Code ``q`` of block ``b`` represents
    ``scales[b] * (q - zps[b])``.  :meth:`fingerprint` is what receivers
    compare.
    """

    __slots__ = ("scales", "zps", "chunk_elems", "total_elems",
                 "wire_dtype", "mode", "_fp")

    def __init__(self, scales: np.ndarray, zps: np.ndarray,
                 chunk_elems: int, total_elems: int,
                 wire_dtype: str = "uint8", mode: str = "delta") -> None:
        from rayfed_tpu_torch.fl.fedavg import packed_block_grid

        _qrange(wire_dtype)
        if mode not in ("abs", "delta"):
            raise ValueError(
                f"grid mode must be 'abs' or 'delta', got {mode!r}"
            )
        self.mode = mode
        self.scales = np.ascontiguousarray(scales, np.float32)
        self.zps = np.ascontiguousarray(zps, np.float32)
        self.chunk_elems = int(chunk_elems)
        self.total_elems = int(total_elems)
        self.wire_dtype = str(wire_dtype)
        nb = packed_block_grid(self.total_elems, self.chunk_elems)
        if self.scales.shape != (nb,) or self.zps.shape != (nb,):
            raise ValueError(
                f"grid has {self.scales.shape}/{self.zps.shape} "
                f"scale/zero-point entries; the canonical grid over "
                f"{self.total_elems} elements at {self.chunk_elems} "
                f"elems/block has {nb} blocks"
            )
        if not np.all(self.scales > 0):
            raise ValueError("grid scales must be strictly positive")
        self._fp: Optional[int] = None

    @property
    def nblocks(self) -> int:
        return int(self.scales.shape[0])

    @property
    def qabs_max(self) -> int:
        """Bound on |code|: the i32 headroom term."""
        qmin, qmax = _qrange(self.wire_dtype)
        return max(abs(qmin), abs(qmax))

    def fingerprint(self) -> int:
        """CRC32 over the grid's exact bytes and geometry."""
        if self._fp is None:
            head = json.dumps(
                [QUANT_GRID_VERSION, self.chunk_elems, self.total_elems,
                 self.wire_dtype, self.mode],
                separators=(",", ":"),
            ).encode()
            fp = zlib.crc32(head)
            fp = zlib.crc32(self.scales.tobytes(), fp)
            fp = zlib.crc32(self.zps.tobytes(), fp)
            self._fp = fp
        return self._fp

    def meta(self) -> "QuantMeta":
        """The static descriptor stamped into quantized wire forms."""
        return QuantMeta(
            QUANT_GRID_VERSION, self.chunk_elems, self.total_elems,
            self.wire_dtype, self.mode, self.fingerprint(),
        )

    def rows(self, blocks: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        """(scales, zps) of a block subset, in the given order."""
        idx = np.asarray(list(blocks), np.int64)
        return self.scales[idx], self.zps[idx]

    def check_weight_headroom(self, total_weight: int) -> None:
        """i32 overflow guard: ``qabs_max * W`` must fit int32."""
        bound = self.qabs_max * int(total_weight)
        if bound > 2**31 - 1:
            raise ValueError(
                f"integer-fold overflow: qabs_max({self.wire_dtype})="
                f"{self.qabs_max} x total weight {total_weight} = "
                f"{bound} exceeds the i32 accumulator bound {2**31 - 1} "
                f"— the widening add holds only for total weight <= "
                f"{(2**31 - 1) // self.qabs_max}; rescale the example "
                f"counts or aggregate hierarchically"
            )

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, QuantGrid) and self.meta() == other.meta()

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"QuantGrid({self.nblocks} blocks x {self.chunk_elems} "
            f"{self.wire_dtype} elems, {self.total_elems} total, "
            f"fp={self.fingerprint():#010x})"
        )


class QuantMeta(NamedTuple):
    """Hashable static descriptor of a grid.

    ``mode``: ``"delta"`` — the codes represent ``x - ref`` against the
    round's shared reference buffer; ``"abs"`` — the values themselves.
    """

    version: int
    chunk_elems: int
    total_elems: int
    wire_dtype: str
    mode: str
    fp: int


def grid_descriptor(grid: QuantGrid) -> Dict[str, Any]:
    """The compact per-frame grid descriptor (rides the frame metadata
    under ``wire.QUANT_GRID_KEY``)."""
    return {
        "v": QUANT_GRID_VERSION,
        "fp": int(grid.fingerprint()),
        "nb": int(grid.nblocks),
        "ce": int(grid.chunk_elems),
        "el": int(grid.total_elems),
        "dt": str(grid.wire_dtype),
        "md": str(grid.mode),
    }


def check_descriptor(descriptor: Any, grid: QuantGrid) -> None:
    """Validate a received grid descriptor (JSON str or dict) against the
    locally derived grid; raises naming both on any mismatch."""
    gd = (
        json.loads(descriptor) if isinstance(descriptor, (str, bytes))
        else dict(descriptor)
    )
    if gd.get("v", 0) > QUANT_GRID_VERSION:
        raise ValueError(
            f"quantized frame uses grid descriptor v{gd.get('v')}; this "
            f"party understands up to v{QUANT_GRID_VERSION}"
        )
    want = grid_descriptor(grid)
    for key in ("fp", "nb", "ce", "el", "dt", "md"):
        if gd.get(key) != want[key]:
            raise ValueError(
                f"quantization grid mismatch: frame carries "
                f"{key}={gd.get(key)!r}, this round's grid has "
                f"{want[key]!r} — sender and receiver disagree on the "
                f"round's shared grid"
            )


def make_round_grid(
    reference: Any,
    chunk_elems: Optional[int] = None,
    wire_dtype: str = "uint8",
    expand: float = 1.25,
    min_scale: float = 1e-12,
    mode: str = "delta",
    floor_frac: float = 0.05,
) -> QuantGrid:
    """Derive a shared grid from a reference range buffer.

    ``reference``: a buffer every controller holds bit-identically (a
    PackedTree, a tensor on any device or an array) whose per-block range
    predicts the values to be coded: the previous round's aggregate delta
    for the round loop's ``mode="delta"`` uplink, the values themselves for
    ``mode="abs"``.  Per block the range is the block's [min, max] expanded
    by ``expand`` around its midpoint, floored at ``floor_frac`` of the
    buffer's global RMS, then mapped affinely onto the integer range;
    ``min_scale`` floors the all-zero case.  Pure numpy, as in the JAX
    package.
    """
    arr = _host_f32(reference)
    if arr.size == 0:
        raise ValueError(
            "cannot derive a quantization grid from an empty buffer"
        )
    from rayfed_tpu_torch.fl.fedavg import DEFAULT_CHUNK_ELEMS, packed_block_grid

    if chunk_elems is None:
        chunk_elems = DEFAULT_CHUNK_ELEMS
    ce = int(chunk_elems)
    qmin, qmax = _qrange(wire_dtype)
    nb = packed_block_grid(arr.size, ce)
    total = arr.size
    rms = float(np.sqrt(np.mean(np.square(arr, dtype=np.float64))))
    # Pad the tail block with its last value: the padded row's min/max are
    # the block's own.
    pad = nb * ce - total
    if pad:
        arr = np.concatenate([arr, np.full(pad, arr[-1], np.float32)])
    a2 = arr.reshape(nb, ce)
    lo = a2.min(axis=1)
    hi = a2.max(axis=1)
    mid = 0.5 * (hi + lo)
    half = np.maximum(
        0.5 * (hi - lo) * np.float32(expand),
        np.float32(float(floor_frac) * rms),
    )
    lo = mid - half
    hi = mid + half
    scales = np.maximum(
        (hi - lo) / np.float32(qmax - qmin), np.float32(min_scale)
    ).astype(np.float32)
    zps = (qmin - lo / scales).astype(np.float32)
    return QuantGrid(scales, zps, ce, total, wire_dtype, mode)


class QuantizedPackedTree(PackedTree):
    """Integer-coded wire form of a :class:`PackedTree`.

    ``buf`` holds the codes (``gmeta.wire_dtype``); ``scales`` and ``zps``
    are the grid's per-block vectors riding alongside, so every payload
    carries the grid it was coded with.  ``gmeta`` is the static
    :class:`QuantMeta`; the fold compares its ``fp`` against the round grid
    before trusting any codes.  A node of :mod:`rayfed_tpu_torch.tree_util`
    with children ``(buf, scales, zps, *passthrough)``: leaf 0 stays the
    packed wire buffer.
    """

    __slots__ = ("scales", "zps", "gmeta")

    def __init__(self, buf: Any, scales: Any, zps: Any,
                 passthrough: Tuple, spec: PackSpec,
                 gmeta: QuantMeta) -> None:
        super().__init__(buf, passthrough, spec)
        self.scales = scales
        self.zps = zps
        self.gmeta = gmeta

    @property
    def nbytes(self) -> int:
        total = super().nbytes
        for extra in (self.scales, self.zps):
            total += getattr(extra, "nbytes", 0)
        return total

    def grid(self) -> QuantGrid:
        """The grid this tree was coded with (checked against its
        fingerprint)."""
        g = QuantGrid(
            _host_f32(self.scales), _host_f32(self.zps),
            self.gmeta.chunk_elems, self.gmeta.total_elems,
            self.gmeta.wire_dtype, self.gmeta.mode,
        )
        if g.fingerprint() != self.gmeta.fp:
            raise ValueError(
                f"quantized payload is internally inconsistent: carried "
                f"grid fingerprints {g.fingerprint():#010x}, descriptor "
                f"says {self.gmeta.fp:#010x}"
            )
        return g

    def dequantize(self, out_dtype: Any = np.float32,
                   ref: Optional[Any] = None) -> PackedTree:
        """One rescale (+ reference add, for ``mode="delta"`` codes) of the
        whole buffer to ``out_dtype``, on the device of the codes or, for
        host codes, of ``ref``."""
        grid = self.grid()
        ref = _check_ref(grid, ref)
        out_name = compression.dtype_name(out_dtype)
        buf = _dequantize_codes(self.buf, ref, grid, out_name)
        spec = PackSpec(self.spec.entries, self.spec.treedef, out_name)
        return PackedTree(buf, self.passthrough, spec)

    def unpack(self, dtype: Any = None) -> Any:
        """Dequantize and unpack (f32 for ``dtype=None``).  Delta-coded
        trees need :meth:`dequantize` with the reference first: this
        raises for them."""
        out = np.float32 if dtype is None else dtype
        return self.dequantize(out).unpack(out)

    def __reduce__(self):
        return (
            QuantizedPackedTree,
            (self.buf, self.scales, self.zps, self.passthrough,
             self.spec, self.gmeta),
        )

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"QuantizedPackedTree({self.gmeta.total_elems} "
            f"{self.gmeta.wire_dtype} codes, {self.gmeta.chunk_elems} "
            f"elems/block, fp={self.gmeta.fp:#010x}, "
            f"{len(self.passthrough)} passthrough)"
        )


tree_util.register_pytree_node(
    QuantizedPackedTree,
    lambda qt: ((qt.buf, qt.scales, qt.zps, *qt.passthrough), (qt.spec, qt.gmeta)),
    lambda aux, ch: QuantizedPackedTree(ch[0], ch[1], ch[2], tuple(ch[3:]), aux[0], aux[1]),
)


def _grid_vectors(grid: QuantGrid, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grid's scales and zero points as [nblocks, 1] f32 on ``device``,
    read flushed (a subnormal is a zero of its sign), as the JAX package's
    programs read them."""
    return (ftz.flush(torch.from_numpy(grid.scales).to(device)[:, None]),
            ftz.flush(torch.from_numpy(grid.zps).to(device)[:, None]))


def _block_rows(x: torch.Tensor, grid: QuantGrid) -> List[Tuple[torch.Tensor, int, int]]:
    """A flat buffer of the grid's ``total_elems`` as block rows, without
    padding: ``(rows, first block, end block)`` for the full blocks as
    [k, chunk_elems] and for a short last block as [1, rest].  Only the
    buffer's own elements are computed, however wide the grid's blocks."""
    n, ce = grid.total_elems, grid.chunk_elems
    full = n // ce
    out = []
    if full:
        out.append((x[: full * ce].reshape(full, ce), 0, full))
    if n > full * ce:
        out.append((x[full * ce: n].reshape(1, n - full * ce), full, full + 1))
    return out


def _joined(parts: List[torch.Tensor], like: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The pieces of ``_block_rows`` as one flat tensor (empty for a grid of
    no elements)."""
    flat = [p.reshape(-1) for p in parts]
    if len(flat) == 1:
        return flat[0]
    return torch.cat(flat) if flat else like.new_zeros(0, dtype=dtype)


def _quantize_codes(buf: Any, ref: Optional[Any], resid: Optional[torch.Tensor],
                    grid: QuantGrid) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``_quantize_kernel``: (subtract the reference,) add
    the carried residual, code onto the grid, and carry the new residual
    ``corrected − scale·(q − zp)``; ``(codes, new residual)`` on the
    buffer's device (or the reference's, for host buffers)."""
    from rayfed_tpu_torch.fl.fedavg import as_tensor

    qmin, qmax = _qrange(grid.wire_dtype)
    device = _device_of(buf, ref, resid)
    value = as_tensor(buf, device).reshape(-1).to(torch.float32)
    if ref is not None:
        value = ftz.sub(value, _f32_on(ref, device))
    if resid is None:  # the reference adds zeros: -0.0 + 0.0 is +0.0
        resid = torch.zeros(grid.total_elems, dtype=torch.float32, device=device)
    corrected = ftz.add(value, resid.to(device))
    scales, zps = _grid_vectors(grid, device)
    code_dt = compression.torch_dtype(grid.wire_dtype)
    codes, resids = [], []
    for a, lo, hi in _block_rows(corrected, grid):
        sc, zp = scales[lo:hi], zps[lo:hi]
        q = torch.clamp(torch.round(ftz.add(ftz.div(a, sc), zp)), qmin, qmax)
        codes.append(q.to(code_dt))
        # corrected − scale·(q − zp), one rounding (see the module doc).
        resids.append(fma_rows(sc, q, a, zp, negate=True))
    return _joined(codes, corrected, code_dt), _joined(resids, corrected, torch.float32)


def _dequantize_codes(codes: Any, ref: Optional[Any], grid: QuantGrid, out_name: str) -> torch.Tensor:
    """The JAX package's ``_dequantize_kernel``: ``[ref +] scale·(q − zp)``
    cast to ``out_name``."""
    from rayfed_tpu_torch.fl.fedavg import as_tensor

    device = _device_of(codes, ref)
    q = as_tensor(codes, device).reshape(-1)
    if ref is None:
        q = q.to(torch.float32)  # the rows form reads the codes themselves
    scales, zps = _grid_vectors(grid, device)
    refs = None if ref is None else _block_rows(_f32_on(ref, device).reshape(-1), grid)
    out = []
    for k, (a, lo, hi) in enumerate(_block_rows(q, grid)):
        sc, zp = scales[lo:hi], zps[lo:hi]
        if refs is None:
            out.append(ftz.mul(sc, a - zp))  # a − zp: integers, exact
        else:
            # ref + scale·(q − zp), one rounding (see the module doc).
            out.append(fma_rows(sc, a, refs[k][0], zp))
    return _joined(out, q, torch.float32).to(compression.torch_dtype(out_name))


def _check_ref(grid: QuantGrid, ref: Optional[Any]):
    """Validate and normalize the shared reference buffer against the
    grid's mode (delta codes need it, abs codes must not get one)."""
    if grid.mode == "delta":
        if ref is None:
            raise ValueError(
                "grid mode 'delta' codes x - ref: pass ref= (the "
                "round's shared reference buffer, e.g. the starting "
                "model's packed f32 buffer)"
            )
        if isinstance(ref, PackedTree):
            ref = ref.buf
        if _numel(ref) != grid.total_elems:
            raise ValueError(
                f"reference buffer has {_numel(ref)} "
                f"elements, grid covers {grid.total_elems}"
            )
        return ref
    if ref is not None:
        raise ValueError(
            "grid mode 'abs' codes the values themselves — ref= does "
            "not apply"
        )
    return None


def _quantize_with_resid(
    packed: PackedTree, grid: QuantGrid, resid: Optional[torch.Tensor],
    ref: Optional[Any] = None,
) -> Tuple[QuantizedPackedTree, torch.Tensor]:
    if isinstance(packed, QuantizedPackedTree):
        raise TypeError("tree is already quantized")
    if not isinstance(packed, PackedTree):
        raise TypeError(
            f"quantize_packed consumes PackedTree contributions, got "
            f"{type(packed).__name__} — pack with fl.compress(tree, "
            f"packed=True) first"
        )
    n = _numel(packed.buf)
    if n != grid.total_elems:
        raise ValueError(
            f"packed buffer has {n} elements, grid covers "
            f"{grid.total_elems} — the grid must be derived on the same "
            f"packed layout the parties push"
        )
    ref = _check_ref(grid, ref)
    codes, new_resid = _quantize_codes(packed.buf, ref, resid, grid)
    spec = PackSpec(packed.spec.entries, packed.spec.treedef, grid.wire_dtype)
    qt = QuantizedPackedTree(
        codes.cpu().numpy(), grid.scales, grid.zps, packed.passthrough,
        spec, grid.meta(),
    )
    return qt, new_resid


def quantize_packed(
    packed: PackedTree, grid: QuantGrid, ref: Optional[Any] = None
) -> QuantizedPackedTree:
    """Stateless (no error feedback) grid quantization of a PackedTree;
    ``ref`` is the shared reference buffer of ``mode="delta"`` grids."""
    qt, _ = _quantize_with_resid(packed, grid, None, ref)
    return qt


def dequantize_packed(
    qtree: QuantizedPackedTree, out_dtype: Any = np.float32,
    ref: Optional[Any] = None,
) -> PackedTree:
    """Decode a quantized tree back to a float PackedTree (``ref`` required
    for delta-coded trees)."""
    if not isinstance(qtree, QuantizedPackedTree):
        raise TypeError(
            f"dequantize_packed consumes QuantizedPackedTree, got "
            f"{type(qtree).__name__}"
        )
    return qtree.dequantize(out_dtype, ref)


class QuantCompressor:
    """Per-sender error-feedback state for the grid codec.

    :meth:`quantize` computes the coded tree and the *pending* residual;
    :meth:`commit` promotes it once the round that shipped the codes
    succeeded; :meth:`rollback` discards it.  Keep one per outgoing stream
    (:func:`compressor`) and :meth:`reset` it when the tree changes.
    """

    def __init__(self) -> None:
        self._resid: Optional[torch.Tensor] = None
        self._pending: Optional[torch.Tensor] = None

    @property
    def residual(self) -> Optional[torch.Tensor]:
        """The committed f32 residual (None before the first commit), on
        the device the codes were computed on."""
        return self._resid

    def quantize(self, packed: PackedTree, grid: QuantGrid,
                 ref: Optional[Any] = None) -> QuantizedPackedTree:
        if self._resid is not None and int(self._resid.shape[0]) != grid.total_elems:
            raise ValueError(
                f"tree structure changed under quantized error feedback "
                f"({self._resid.shape[0]} residual elements vs grid over "
                f"{grid.total_elems}) — call reset() when switching "
                f"models"
            )
        qt, self._pending = _quantize_with_resid(packed, grid, self._resid, ref)
        return qt

    def commit(self) -> None:
        if self._pending is not None:
            self._resid = self._pending
            self._pending = None

    def rollback(self) -> None:
        self._pending = None

    def reset(self) -> None:
        self._resid = None
        self._pending = None


class RoundCodec:
    """One round's sender-side codec discipline: the grid, the normalized
    shared reference buffer, the frame descriptor, the check of
    pre-quantized contributions and the residual's commit/rollback.  With
    ``grid=None`` every method is the identity or a no-op.

    The reference buffer stays where it is: a tensor keeps its device (as
    a flat f32 tensor), an array becomes a flat f32 array.
    """

    __slots__ = ("grid", "ref", "descriptor", "_scope")

    def __init__(self, grid: Optional[QuantGrid],
                 ref: Optional[Any] = None,
                 scope: Optional[str] = None) -> None:
        self.grid = grid
        self._scope = scope
        self.ref: Optional[Any] = None
        self.descriptor: Optional[Dict[str, Any]] = None
        if grid is not None:
            self.descriptor = grid_descriptor(grid)
            if ref is not None:
                if isinstance(ref, PackedTree):
                    ref = ref.buf
                if isinstance(ref, torch.Tensor):
                    self.ref = ref.detach().reshape(-1).to(torch.float32)
                else:
                    self.ref = np.asarray(ref).reshape(-1).astype(np.float32)

    def to_wire(self, value: Any) -> Any:
        """This party's contribution quantized onto the round grid (a
        pre-quantized value passes after a fingerprint check; with a scope
        the error-feedback residual rides along, committed only after the
        round lands)."""
        if self.grid is None:
            return value
        if isinstance(value, QuantizedPackedTree):
            if value.gmeta != self.grid.meta():
                raise ValueError(
                    f"pre-quantized contribution was coded on a "
                    f"different grid (fp={value.gmeta.fp:#010x} vs "
                    f"{self.grid.fingerprint():#010x})"
                )
            return value
        if not isinstance(value, PackedTree):
            raise TypeError(
                "compressed-domain aggregation consumes PackedTree "
                f"contributions, got {type(value).__name__}"
            )
        if self._scope is not None:
            return compressor(self._scope).quantize(value, self.grid, ref=self.ref)
        return quantize_packed(value, self.grid, ref=self.ref)

    def commit(self) -> None:
        if self.grid is not None and self._scope is not None:
            compressor(self._scope).commit()

    def rollback(self) -> None:
        if self.grid is not None and self._scope is not None:
            compressor(self._scope).rollback()


def quantize_downlink(
    result: Any,
    grid: QuantGrid,
    ref: Optional[Any],
    scope: Optional[str],
    out_dtype: Any = np.float32,
) -> Tuple[QuantizedPackedTree, Any, Dict[str, Any]]:
    """Re-quantize a round aggregate for the result broadcast, on a FRESH
    grid derived from the aggregate (``aggregate − ref`` for delta rounds),
    carried in the payload.  Returns ``(wire form, dequantized aggregate,
    grid descriptor)``: the coordinator returns the dequantized codes, so
    every controller holds the same bytes.  ``scope`` keys the downlink's
    own residual (``{scope}/down``); None quantizes statelessly.
    """
    if ref is not None:
        down_grid = make_round_grid(
            _host_f32(result.buf) - _host_f32(ref), chunk_elems=grid.chunk_elems,
            wire_dtype=grid.wire_dtype, mode="delta",
        )
    else:
        down_grid = make_round_grid(
            result.buf, chunk_elems=grid.chunk_elems,
            wire_dtype=grid.wire_dtype, mode="abs",
        )
    dcomp = compressor(f"{scope}/down") if scope is not None else None
    wire_result = (
        dcomp.quantize(result, down_grid, ref=ref)
        if dcomp is not None
        else quantize_packed(result, down_grid, ref=ref)
    )
    decoded = wire_result.dequantize(out_dtype, ref=ref)
    if dcomp is not None:
        dcomp.commit()
    return wire_result, decoded, grid_descriptor(down_grid)


# Per-process compressor registry, keyed by stream scope.
_COMPRESSORS: Dict[str, QuantCompressor] = {}


def compressor(scope: str) -> QuantCompressor:
    """The process-wide :class:`QuantCompressor` for ``scope`` (created on
    first use): ``"fedavg"`` for the round loop's uplink, ``"fedavg/down"``
    for the coordinator's broadcast."""
    comp = _COMPRESSORS.get(scope)
    if comp is None:
        comp = _COMPRESSORS[scope] = QuantCompressor()
    return comp


def reset_compressors() -> None:
    """Drop every registered compressor's state (tests, model swap)."""
    _COMPRESSORS.clear()


__all__ = [
    "QUANT_DELTA_EXPAND",
    "QUANT_GRID_VERSION",
    "QuantCompressor",
    "QuantGrid",
    "QuantMeta",
    "QuantizedPackedTree",
    "RoundCodec",
    "check_descriptor",
    "compressor",
    "dequantize_packed",
    "grid_descriptor",
    "make_round_grid",
    "quantize_downlink",
    "quantize_packed",
    "reset_compressors",
]
