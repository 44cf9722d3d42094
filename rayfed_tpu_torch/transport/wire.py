"""Wire format: frames + zero-copy tensor payload codec.

The reference ships ``cloudpickle.dumps(data)`` of whole Python objects
(``barriers.py:151``) — for device arrays that means device→host copy,
pickle memcpy, and a pickle parse on the far side.  Here array leaves
travel as **raw buffers** described by a small JSON manifest: the receiver
rebuilds ``np.ndarray`` leaves with ``np.frombuffer`` (zero-copy) and
``torch.Tensor`` leaves with ``torch.frombuffer``, and can copy tensors
straight onto its own card.  Non-array leaves fall back to
(allowlist-restricted) pickle per skeleton.

The payload bytes are the JAX package's: a ``torch.Tensor`` is the
counterpart of a ``jax.Array`` (``"dev": 1``, the same manifest entries,
the same skeleton pickle), so a party of either package decodes the
other's pushes.

Frame layout (all integers big-endian)::

    magic   4s   b"RFW1"
    type    u8   DATA=1 ACK=2 PING=3 PONG=4 ERR=5
    flags   u8
    hlen    u32  header (JSON) length
    plen    u64  payload length
    header  hlen bytes of JSON
    payload plen bytes

Header fields: ``rid`` (request id for ACK matching), ``src`` party,
``up``/``down`` rendezvous seq ids, ``meta`` metadata headers.
"""

from __future__ import annotations

import functools
import json
import struct
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

try:  # registers 'bfloat16' & friends as numpy dtypes, for np.ndarray leaves
    import ml_dtypes  # noqa: F401
except ImportError:  # pragma: no cover - tensor leaves never need it
    pass

from rayfed_tpu_torch import serialization
from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.utils import platform

MAGIC = b"RFW1"
_HEADER_STRUCT = struct.Struct(">4sBBIQ")
HEADER_SIZE = _HEADER_STRUCT.size

# Version of the payload manifest layout.  BUMP THIS whenever the
# manifest schema changes (new leaf kinds, renamed/removed fields,
# different framing of the skeleton) — ``tool/check_wire_format.py``
# (run by test.sh) fails the build when the layout fingerprint drifts
# without a version bump.  Receivers reject payloads from a NEWER
# format than they understand instead of misparsing them, and — since
# v4 — every connection opens with a HELLO handshake carrying this
# version, so two parties on different builds fail with a clean
# ProtocolMismatchError naming both versions instead of a confusing
# manifest-decode error mid-payload.
# History: 1 = unversioned original; 2 = "v" field added to manifest;
# 3 = stream/delta frames ("stm"/"ccsz"/"ccrc"/"dlt" header fields:
# per-chunk CRCs + changed-chunk bitmap manifest for per-peer delta
# sends — see make_delta_manifest); 4 = connection HELLO handshake
# (MSG_HELLO + "ver"), multi-rail stripe frames ("stp" marker, "dlt"
# with optional "bfp": a large payload's chunks fan out round-robin
# across the per-destination connection pool as per-chunk frames and
# are reassembled by (stream, chunk index) on the receiver).
WIRE_FORMAT_VERSION = 4

MSG_DATA = 1
MSG_ACK = 2
MSG_PING = 3
MSG_PONG = 4
MSG_ERR = 5
# Connection handshake (v4): the first frame a client sends on every
# new connection, header {"ver": WIRE_FORMAT_VERSION, "src": party}.
# The server replies MSG_HELLO {"ver": ...} on match, or a fatal
# MSG_ERR code="protocol" naming both versions on mismatch.
MSG_HELLO = 6

# Frame flag: a 4-byte CRC32-C trailer follows the payload (streamed
# sends compute the checksum incrementally, so it can't ride the header).
FLAG_CRC_TRAILER = 0x01

# Device arrays at or above this size are encoded per shard and fetched
# lazily, so the send path can overlap device→host fetch of shard k+1
# with the socket write of shard k.
SHARD_STREAM_THRESHOLD = 8 * 1024 * 1024

# With zero_copy decode, plain "nd" leaves at or above this size come
# back as READONLY views aliasing the payload (e.g. a packed-tree
# buffer just under the shard-stream threshold).  Smaller leaves keep
# the writable-copy behavior: a retained few-KB view must not pin a
# multi-GB payload buffer alive, and in-place consumers of small
# host leaves keep working.
ND_ZERO_COPY_MIN_BYTES = 1 * 1024 * 1024

# Granularity of stream/delta frames (wire v3): per-peer delta caches
# diff and ship the payload in chunks of this size, and per-chunk CRCs
# cover exactly these ranges.  Matches the client's WRITE_CHUNK_BYTES so
# a shipped chunk is one writev unit.
DELTA_CHUNK_BYTES = 4 * 1024 * 1024

# Payloads at or above this size ship as per-chunk stripe frames (wire
# v4) fanned round-robin across the per-destination connection pool:
# chunk k is on a socket while chunk k+1 is still being fetched from
# device and CRC'd — no full-payload serialization barrier — and the
# receiver reassembles by (stream, chunk index) with the delta-bitmap
# machinery.  Below it — or when fewer than 2 rails are available
# (client._default_stripe_rails: striping needs spare cores to pay for
# the per-frame ACKs and the receiver's reassembly memcpy) — the
# single-frame paths (cheaper per-payload header/ACK overhead, zero-
# copy delivery) are kept.
STRIPE_MIN_BYTES = 8 * 1024 * 1024

# Metadata key stamping a DATA frame with the federated round it belongs
# to (pipelined rounds keep one round's aggregation in flight under the
# next round's compute — the tag is what lets a receiver's logs and the
# runner's fallback attribute a late or failed frame to the ROUND that
# owns it, rather than silently folding it into whichever round is
# current).  Rides the ordinary per-send metadata dict inside the JSON
# header's "meta" field: no frame-layout change, but the key name is a
# cross-party contract — fingerprinted by tool/check_wire_format.py.
ROUND_TAG_KEY = "rnd"

# Metadata key carrying the sender's ROSTER EPOCH (elastic membership):
# quorum-round frames are stamped with the epoch their sender's roster
# was at, and a receiver whose roster has advanced PAST the frame's
# epoch rejects it loudly (a fatal MSG_ERR naming both epochs) instead
# of parking a stale round's bytes in the mailbox forever.  Frames from
# a NEWER epoch are accepted — the advanced coordinator's broadcast is
# what carries the roster transition to lagging stragglers.  Late
# contributions are never lost by the rejection — they fold into the
# NEXT round via the sender's own local DGA correction, not via the
# stale wire push.  Same
# meta-dict transport as ROUND_TAG_KEY: no frame-layout change, but the
# key name is a cross-party contract — fingerprinted by
# tool/check_wire_format.py.
EPOCH_TAG_KEY = "ep"

# Metadata key carrying the round's shared QUANTIZATION-GRID descriptor
# (compressed-domain aggregation, fl.quantize): frames whose payload is
# integer codes on the round's shared grid are stamped with the compact
# JSON descriptor produced by ``fl.quantize.grid_descriptor`` —
# {version, fingerprint, block count, chunk elems, total elems, wire
# dtype} — so receivers and logs can attribute the frame to its grid
# without decoding the payload, and a cross-grid push is diagnosable at
# the transport layer (the fold layer independently re-verifies the
# fingerprint before any rescale).  Same meta-dict transport as
# ROUND_TAG_KEY: no frame-layout change, but the key name AND the
# descriptor schema are cross-party contracts — both fingerprinted by
# tool/check_wire_format.py.
QUANT_GRID_KEY = "qg"

# Metadata key carrying the coordinator's MODEL VERSION for buffered
# asynchronous rounds (fl.async_rounds): async broadcasts are stamped
# with the version they publish, and async contributions with the
# version of the broadcast they trained FROM — the coordinator derives
# each arrival's staleness as (current_version - trained_from) and a
# version-stale contribution against a rotated grid re-codes through
# the shared RoundCodec instead of folding garbage.  Same meta-dict
# transport as ROUND_TAG_KEY (the synchronous loops' round index plays
# this role there): no frame-layout change, but the key name is a
# cross-party contract — fingerprinted by tool/check_wire_format.py.
ASYNC_VERSION_KEY = "av"

# Content-addressed object plane (transport/objectstore.py): the
# repo's FIRST pull direction.  Three frame-metadata keys, all riding
# the ordinary per-send "meta" dict — NO frame-layout change, but the
# key names AND the JSON value schemas (single producers in
# rayfed_tpu_torch/objects.py) are cross-party contracts, fingerprinted by
# tool/check_wire_format.py together with OBJECT_PLANE_VERSION.
#
# BLOB_GET_KEY — a pull REQUEST frame (tiny, empty payload): the
# requester asks a holder for the blob whose content fingerprint it
# was handed, naming the reply rendezvous key the requester is already
# parked on.  Value: ``objects.make_blob_request`` JSON.
BLOB_GET_KEY = "bget"
# BLOB_PUT_KEY — the pull REPLY frame: the holder pushes the stored
# wire bytes to the requester's reply key (ordinary DATA framing, so
# per-chunk CRCs, multi-rail striping and the stripe reassembly all
# apply unchanged), or a payload-less miss notice so the requester
# fails over to the next named holder instead of waiting out the
# backstop.  Value: ``objects.make_blob_reply_meta`` JSON.
BLOB_PUT_KEY = "bput"
# BLOB_HANDLE_KEY — stamped on a frame whose PAYLOAD is a blob handle
# offered in place of the object it names (fed.get broadcast of large
# immutable objects sends the fingerprint first; receivers with a
# content cache hit never transfer the payload at all).  Value: the
# bare fingerprint string — receiver logs can attribute the offer
# without decoding.
BLOB_HANDLE_KEY = "bhd"

# Federated flight recorder (rayfed_tpu_torch/telemetry.py): cross-party
# trace collection rides the SAME request/reply shape as the object
# plane's BLOB_GET — a tiny payload-less request frame consumed by a
# server observer, answered by an ordinary DATA push onto a per-pull
# nonce reply key the requester is already parked on.  Two
# frame-metadata keys on the ordinary per-send "meta" dict — NO
# frame-layout change, but the key names AND the JSON value schemas
# (single producers ``telemetry.make_trace_request`` /
# ``make_trace_reply_meta``) are cross-party contracts, fingerprinted
# by tool/check_wire_format.py together with TELEMETRY_VERSION.
#
# TRACE_GET_KEY — the collection REQUEST: asks a peer for its flight-
# recorder ring window (optionally round-bounded), naming the reply
# rendezvous key and carrying the requester's wall-clock send stamp
# (one half of the NTP-style clock-offset estimate).
TRACE_GET_KEY = "tget"
# TRACE_PUT_KEY — the collection REPLY metadata: the serving party, its
# record count, its wall clock at serve time (the offset estimate's
# peer sample) and whether its recorder was armed.  The payload is the
# JSON-encoded record window (``telemetry.encode_records``).
TRACE_PUT_KEY = "tput"


def blob_fingerprint(data) -> str:
    """Content fingerprint of a serialized payload — THE single
    producer for the object plane's handles (``rayfed_tpu_torch/objects.py``)
    and for checkpoint metadata stamps.

    Built ON the delta-cache's base-fingerprint machinery rather than
    beside it: the first field is exactly
    ``crc_fingerprint(chunk_crcs(data))`` — the same per-chunk-CRC word
    the per-peer delta cache maintains for its ``bfp`` frames — so a
    stored blob is directly cross-checkable against delta-cache state,
    and the chunk-CRC pass is shared work.  A sha256 tail makes the
    handle collision-resistant as a content ADDRESS (32-bit CRC words
    alone are fine for desync detection but not for skipping a
    transfer on fingerprint equality).
    """
    import hashlib

    mv = memoryview(data)
    if mv.format != "B":
        mv = mv.cast("B")
    base = crc_fingerprint(chunk_crcs(mv))
    strong = hashlib.sha256(mv).hexdigest()[:24]
    return f"b1.{base:08x}.{len(mv):x}.{strong}"


# Header key of the connection HELLO handshake carrying the sender's
# SECURE-AGGREGATION key advertisement (transport/secagg.py): a compact
# ``"<version>.<kex>.<prg>.<hex key>"`` string — an ephemeral X25519
# public key (or the stdlib fallback's per-session nonce) plus the mask
# PRG suite.  The client publishes its value in the HELLO it opens every
# connection with, the server records it and replies with its own, so
# ONE ping per pair establishes the pairwise mask-seed state in both
# directions with zero extra round trips and zero payload bytes (masks
# are generated from derived seeds, never transmitted —
# fl/secagg.py).  Absent on builds that never enable secure
# aggregation is fine: the value is opportunistic, and the loud failure
# lives at mask time.  Rides the HELLO header beside ``ver``/``src`` —
# NO frame-layout change, but the key name AND the value format version
# (``transport.secagg.SECAGG_VERSION``) are cross-party contracts,
# fingerprinted by tool/check_wire_format.py.
SECAGG_PUB_KEY = "sapk"

# Local-link colocation advertisement (transport/local.py) — three HELLO
# header keys the server volunteers on every handshake so a client can
# prove colocation and upgrade the link off TCP.  No frame-layout
# change: like SECAGG_PUB_KEY these ride the existing HELLO header, but
# the key names (and the identity semantics behind them) are
# cross-party contracts fingerprinted by tool/check_wire_format.py.
#
# LOCAL_HOST_KEY — the server host's boot-scoped identity fingerprint
# (``local.host_identity``: machine-id + boot-id hash).  A client whose
# own fingerprint matches has PROVED both ends share a kernel, which is
# what makes the advertised AF_UNIX path dialable and the CRC elision
# trustworthy (the bytes never leave the machine).
LOCAL_HOST_KEY = "lh"
# LOCAL_UDS_KEY — filesystem path of the server's AF_UNIX twin listener
# (same frame parser, same wire lock; absent when the listener could
# not be created).  Only meaningful when LOCAL_HOST_KEY matched: a path
# from a different host (or an unshared mount namespace) simply fails
# to connect, which the client treats as a loud fall-back to TCP.
LOCAL_UDS_KEY = "lu"
# LOCAL_TOKEN_KEY — the server PROCESS's random boot token
# (``local.process_token``): equality with the client's own token
# proves same-process (in-process virtual parties), unlocking the
# shared-memory handoff that skips sockets entirely.
LOCAL_TOKEN_KEY = "lt"


def pack_frame(
    msg_type: int,
    header: Dict[str, Any],
    payload: bytes = b"",
    payload_len: Optional[int] = None,
    flags: int = 0,
) -> List:
    """Returns a list of buffers to write (avoids concatenating the payload).

    ``payload_len`` lets a caller declare the length of payload buffers it
    will write itself (vectored sends) — this is the single producer of
    frame prefixes for both client and server.
    """
    hdr = json.dumps(header, separators=(",", ":")).encode()
    plen = payload_len if payload_len is not None else len(payload)
    prefix = _HEADER_STRUCT.pack(MAGIC, msg_type, flags, len(hdr), plen)
    out = [prefix, hdr]
    if payload:
        out.append(payload)
    return out


def unpack_frame_prefix(prefix: bytes) -> Tuple[int, int, int, int]:
    magic, msg_type, flags, hlen, plen = _HEADER_STRUCT.unpack(prefix)
    if magic != MAGIC:
        raise ValueError(f"bad frame magic {magic!r}")
    return msg_type, flags, hlen, plen


# ---------------------------------------------------------------------------
# Tensor payload codec
# ---------------------------------------------------------------------------


class _LeafSlot:
    """Placeholder for a leaf inside the pickled container skeleton.

    This class and :class:`_Skeleton` travel under the JAX package's wire
    names (``serialization.SKELETON_WIRE_MODULE``), so both packages read
    each other's skeletons."""

    __slots__ = ("index",)

    def __init__(self, index: int) -> None:
        self.index = index

    def __reduce__(self):
        return (_LeafSlot, (self.index,))


class _Skeleton:
    """Wrapper marking the pickled skeleton object."""

    __slots__ = ("tree",)

    def __init__(self, tree: Any) -> None:
        self.tree = tree

    def __reduce__(self):
        return (_Skeleton, (self.tree,))


class LazyBuffer:
    """A payload buffer produced on demand (device→host fetch deferred).

    The streaming send path calls :meth:`produce` for shard k+1 while
    shard k is still being written to the socket, overlapping the fetch
    with the wire.  ``nbytes`` is known up front (from shard metadata) so
    the frame length can be declared before any fetch happens.
    ``device``: the CUDA device the bytes come from, or None.
    """

    __slots__ = ("_produce", "nbytes", "device")

    def __init__(self, produce, nbytes: int, device: Optional[torch.device] = None) -> None:
        self._produce = produce
        self.nbytes = nbytes
        self.device = device

    def produce(self, stages=None) -> memoryview:
        """The bytes on the host; the copy from the card runs here.
        ``stages`` (a :class:`~rayfed_tpu_torch.telemetry.FrameSpans`,
        given only while the flight recorder is armed) gets the copy as
        ``wire.d2h``, preceded for a CUDA source by ``wire.device_wait``:
        an event recorded on the source's default stream ahead of the copy
        and waited on, the time the card still owed the payload."""
        if stages is not None:
            t0 = time.time()
            if self.device is not None:
                ready = torch.cuda.Event(blocking=True)
                ready.record(torch.cuda.default_stream(self.device))
                ready.synchronize()
                t1 = time.time()
                stages.add("wire.device_wait", t0, t1)
                t0 = t1
        buf = self._produce()
        if buf.nbytes != self.nbytes:  # pragma: no cover - internal invariant
            raise ValueError(
                f"lazy buffer produced {buf.nbytes} bytes, declared {self.nbytes}"
            )
        if stages is not None:
            stages.add("wire.d2h", t0)
        return buf


class SharedLazyBuffer(LazyBuffer):
    """A LazyBuffer whose produce runs once and is shared by N readers.

    Fan-out sends push the SAME payload to several parties; without
    sharing, each destination's write path would repeat the device→host
    fetch.  The cached view lives until the last send drops the buffer
    list.  Only the reader whose produce copies records stage spans: a
    cached view waits on nothing of the card.
    """

    __slots__ = ("_lock", "_cached")

    def __init__(self, inner: LazyBuffer) -> None:
        super().__init__(inner._produce, inner.nbytes, inner.device)
        self._lock = threading.Lock()
        self._cached: Optional[memoryview] = None

    def produce(self, stages=None) -> memoryview:
        with self._lock:
            if self._cached is None:
                self._cached = super().produce(stages)
            return self._cached


def fetch(buf, stages=None) -> Tuple[memoryview, float]:
    """One payload buffer as a byte view, and the seconds its fetch took;
    a LazyBuffer's copy to the host runs here (``stages``: see
    :meth:`LazyBuffer.produce`)."""
    t0 = time.time()
    host = buf.produce(stages) if isinstance(buf, LazyBuffer) else buf
    mv = host if isinstance(host, memoryview) else memoryview(host)
    return (mv if mv.format == "B" else mv.cast("B")), time.time() - t0


def share_buffers(buffers: List) -> List:
    """Wrap every LazyBuffer for one-fetch fan-out (see SharedLazyBuffer)."""
    return [
        SharedLazyBuffer(b) if isinstance(b, LazyBuffer) else b
        for b in buffers
    ]


# Manifest dtype names of tensor leaves: numpy's names, as the JAX package
# writes them (``ml_dtypes``' names for bfloat16 and the float8 types).  A
# tensor leaf decodes through this table alone and never asks numpy for
# its dtype: a host without ``ml_dtypes`` has no numpy bfloat16.
_TORCH_DTYPES: Dict[str, torch.dtype] = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
    "uint16": torch.uint16,
    "uint32": torch.uint32,
    "uint64": torch.uint64,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}
_DTYPE_NAMES = {dtype: name for name, dtype in _TORCH_DTYPES.items()}


def _dtype_name(t: torch.Tensor) -> str:
    try:
        return _DTYPE_NAMES[t.dtype]
    except KeyError:
        raise TypeError(f"a {t.dtype} tensor has no wire dtype") from None


def _torch_dtype(name: str) -> torch.dtype:
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise TypeError(f"wire dtype {name!r} has no torch dtype") from None


def _tensor_nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_dtensor(t: torch.Tensor) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _fully_addressable(t: torch.Tensor) -> bool:
    """A DTensor whose local tensor is the whole value: every mesh
    dimension of size > 1 carries ``Replicate()`` (this process holds one
    card, so a shard over a larger axis lies partly in other processes —
    the reference's ``jax.Array.is_fully_addressable``)."""
    return all(size == 1 or p.is_replicate() for size, p in zip(t.device_mesh.mesh.shape, t.placements))


def _sharding_desc(t: torch.Tensor) -> Optional[Dict[str, Any]]:
    """Portable description of a DTensor's layout: the mesh's axis names
    and sizes, and for each tensor dim the axes that shard it, in mesh
    order (the reference's NamedSharding description, one spec entry a
    dim: ``P("dp", None)``'s form).  None for a mesh without axis names."""
    from torch.distributed.tensor import Shard

    mesh = t.device_mesh
    if not mesh.mesh_dim_names:
        return None
    entries: List[Any] = [[] for _ in range(t.dim())]
    for name, placement in zip(mesh.mesh_dim_names, t.placements):
        if isinstance(placement, Shard):
            entries[placement.dim].append(str(name))
    return {
        "axes": [[str(n), int(s)] for n, s in zip(mesh.mesh_dim_names, mesh.mesh.shape)],
        "spec": [e if e else None for e in entries],
    }


class MeshSharding(NamedTuple):
    """A layout on the receiver's party mesh: the mesh and one placement a
    mesh dimension (what ``DTensor.from_local`` takes)."""

    mesh: Any
    placements: tuple


def resolve_sharding(desc: Optional[Dict[str, Any]], mesh) -> Optional[MeshSharding]:
    """Rebuild the sender's layout on the *receiver's* ``DeviceMesh`` from a
    wire desc.

    Only when the local mesh carries every axis the sender's spec uses, at
    the same size (and an entry of several axes in the mesh's order) —
    otherwise None (the caller decodes a plain tensor)."""
    if not desc or mesh is None or not mesh.mesh_dim_names:
        return None
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    local_axes = dict(zip(names, mesh.mesh.shape))
    sender_axes = dict((n, s) for n, s in desc["axes"])
    placements: List[Any] = [Replicate()] * len(names)
    for dim, entry in enumerate(desc["spec"]):
        order = []
        for axis in entry or ():
            if local_axes.get(axis) != sender_axes.get(axis):
                return None
            order.append(names.index(axis))
            placements[names.index(axis)] = Shard(dim)
        if order != sorted(order):
            return None
    return MeshSharding(mesh, tuple(placements))


def _local_region(shape, sharding: MeshSharding) -> Optional[List[Tuple[int, int]]]:
    """This process's ``[start, stop)`` per dim of a DTensor of ``shape``
    laid out by ``sharding`` (each Shard a ``torch.chunk``, mesh dims in
    order, as DTensor splits); None off the mesh."""
    coord = sharding.mesh.get_coordinate()
    if coord is None:
        return None
    region = [(0, d) for d in shape]
    for i, placement in enumerate(sharding.placements):
        if placement.is_shard():
            d = placement.dim
            start, stop = region[d]
            n = int(sharding.mesh.mesh.shape[i])
            step = -(-(stop - start) // n)
            lo = min(start + coord[i] * step, stop)
            region[d] = (lo, min(lo + step, stop))
    return region


def _place_local_shard(mv, offset, spec, name, shape, sharding: MeshSharding, device):
    """This process's DTensor shard of an ``nds`` leaf, cut from the wire
    shards that overlap it (one wire shard that is exactly the region is
    taken as it is); no data moves between processes.  None off the mesh."""
    from torch.distributed.tensor import DTensor

    region = _local_region(shape, sharding)
    if region is None:
        return None
    extents = [e - s for s, e in region]
    local = None
    off = offset
    for entry in spec["shards"]:
        n = entry["n"]
        idx = [tuple(i) for i in entry["idx"]]
        if idx == region:
            local = _decode_tensor(mv[off : off + n], name, extents, device, view=False)
            break
        lo = [max(a, s) for (a, _), (s, _) in zip(idx, region)]
        hi = [min(b, e) for (_, b), (_, e) in zip(idx, region)]
        if all(a < b for a, b in zip(lo, hi)):
            if local is None:
                local = torch.empty(extents, dtype=_torch_dtype(name))
            src = _region_tensor(mv[off : off + n], name, [b - a for a, b in idx], copy=False)
            local[tuple(slice(a - s, b - s) for a, b, (s, _) in zip(lo, hi, region))] = (
                src[tuple(slice(a - s, b - s) for a, b, (s, _) in zip(lo, hi, idx))])
        off += n
    if local is None:  # an empty region
        local = torch.empty(extents, dtype=_torch_dtype(name))
    if device is not None and local.device != device:
        local = local.to(device)
    return DTensor.from_local(local, sharding.mesh, sharding.placements, run_check=False,
                              shape=torch.Size(shape), stride=torch.empty(shape, device="meta").stride())


def _host_tensor(t: torch.Tensor) -> torch.Tensor:
    """A C-contiguous CPU tensor holding ``t``'s values.

    A CUDA tensor leaves the card through a pinned host buffer, copied on
    its device's default stream — the stream the party's work is ordered
    on when it is handed to the transport
    (:func:`~rayfed_tpu_torch.utils.platform.fence_for_handoff`) — and
    this thread waits for that copy alone.  A contiguous CPU tensor is
    returned as it is (0-d included: no promotion to shape ``(1,)``).
    Pushed tensors must not be written in place until their send has
    completed: the copy may run after this call returns (lazy shards).
    """
    t = t.detach().resolve_conj().resolve_neg()  # no-ops without the bits
    if t.device.type == "cpu":
        return t.contiguous()
    if t.device.type != "cuda":
        raise TypeError(f"cannot fetch a tensor on {t.device} to the host")
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    stream = torch.cuda.default_stream(t.device)
    with torch.cuda.stream(stream):
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return host


def _tensor_buffer(host: torch.Tensor) -> memoryview:
    """Zero-copy byte view of a contiguous CPU tensor, through ``uint8``
    (bfloat16 and float8 have no buffer-protocol format)."""
    flat = host.reshape(-1)
    if flat.numel() == 0:
        return memoryview(b"")
    return memoryview(flat.view(torch.uint8).numpy())


def _tensor_host_view(t: torch.Tensor) -> memoryview:
    return _tensor_buffer(_host_tensor(t))


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """``t``'s values as a host ``np.ndarray`` (numpy must know the dtype:
    bfloat16 needs ``ml_dtypes``)."""
    host = _host_tensor(t)
    return np.frombuffer(
        _tensor_buffer(host), dtype=np.dtype(_dtype_name(host))
    ).reshape(tuple(host.shape))


def _encode_sharded_leaf(leaf: torch.Tensor, manifest_leaves: List, buffers: List,
                         desc: Optional[Dict[str, Any]] = None):
    """Encode a large tensor as one lazily fetched buffer: the manifest a
    fully addressable ``jax.Array`` gets in the JAX package — one shard that
    covers it (the tensor is whole in this process), with ``desc`` the
    layout of the DTensor it came from (``"spec": null`` for a plain
    tensor) — with the device→host copy deferred to the send."""
    shape = list(leaf.shape)
    nbytes = _tensor_nbytes(leaf)
    buffers.append(LazyBuffer(functools.partial(_tensor_host_view, leaf), nbytes,
                              leaf.device if leaf.is_cuda else None))
    manifest_leaves.append(
        {
            "k": "nds",
            "dtype": _dtype_name(leaf),
            "shape": shape,
            "spec": desc,
            "shards": [{"idx": [[0, d] for d in shape], "n": nbytes}],
        }
    )


def _array_buffer(host: np.ndarray) -> memoryview:
    """Zero-copy byte view; handles dtypes outside the buffer protocol (bf16, fp8)."""
    try:
        return memoryview(host).cast("B")
    except (ValueError, TypeError):
        return memoryview(host.reshape(-1).view(np.uint8))


def encode_payload(obj: Any, lazy_shards: bool = False) -> List:
    """Encode a pytree into wire buffers: ``[u32 manifest_len, manifest, *bufs]``.

    Array leaves (``torch.Tensor`` on any device / ``np.ndarray``) become
    raw buffers; CUDA tensors are fetched to host once, through a pinned
    buffer.  Everything else — including the container skeleton — is
    pickled.  Returns a list of buffers suitable for vectored writes (no
    large concatenation).

    With ``lazy_shards=True``, tensors of at least SHARD_STREAM_THRESHOLD
    bytes are encoded as :class:`LazyBuffer`s, letting the streaming send
    path overlap device→host fetches with socket writes.

    A DTensor is encoded when this process holds all of it (every mesh
    dimension of size > 1 replicates it): its local tensor, and with
    ``lazy_shards`` its layout on the party mesh, which a receiver whose
    mesh carries the same axes decodes onto (:func:`decode_payload`).  A
    DTensor sharded across processes raises ``ValueError``.
    """
    leaves, treedef = tree_util.tree_flatten(obj)
    manifest_leaves: List[Dict[str, Any]] = []
    buffers: List = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            desc = None
            if _is_dtensor(leaf):
                if not _fully_addressable(leaf):
                    raise ValueError(
                        f"cannot encode a non-fully-addressable global array "
                        f"(shape {tuple(leaf.shape)}) for a cross-party push: this "
                        f"process only holds its local shards.  Gather it onto "
                        f"the party's processes first (e.g. DTensor."
                        f"full_tensor()) or push per-process shards"
                    )
                desc = _sharding_desc(leaf)
                leaf = leaf.to_local()
            if (
                lazy_shards
                and _tensor_nbytes(leaf) >= SHARD_STREAM_THRESHOLD
                and leaf.dim()  # 0-d can't be sharded
            ):
                _encode_sharded_leaf(leaf, manifest_leaves, buffers, desc)
                continue
            host = _host_tensor(leaf)
            manifest_leaves.append(
                {
                    "k": "nd",
                    "dtype": _dtype_name(host),
                    "shape": list(host.shape),
                    "n": _tensor_nbytes(host),
                    "dev": 1,
                }
            )
            buffers.append(_tensor_buffer(host))
        elif isinstance(leaf, np.ndarray):
            host = leaf if leaf.flags["C_CONTIGUOUS"] else np.ascontiguousarray(leaf)
            if host.dtype == object:
                blob = serialization.dumps(host)
                manifest_leaves.append({"k": "pkl", "n": len(blob)})
                buffers.append(blob)
            else:
                manifest_leaves.append(
                    {
                        "k": "nd",
                        "dtype": host.dtype.name,
                        "shape": list(host.shape),
                        "n": host.nbytes,
                        "dev": 0,
                    }
                )
                buffers.append(_array_buffer(host))
        elif isinstance(leaf, (bool, int, float, str)) or leaf is None:
            manifest_leaves.append({"k": "py", "v": leaf, "t": type(leaf).__name__})
        else:
            blob = serialization.dumps(leaf)
            manifest_leaves.append({"k": "pkl", "n": len(blob)})
            buffers.append(blob)

    # The skeleton: the original container structure with leaves replaced
    # by indexed slots, pickled (restricted-loads on the far side) with
    # the skeleton classes under their wire names.
    skeleton = tree_util.tree_unflatten(
        [_LeafSlot(i) for i in range(len(leaves))], treedef
    )
    skeleton_blob = serialization.dumps_skeleton(_Skeleton(skeleton))
    manifest = json.dumps(
        {
            "v": WIRE_FORMAT_VERSION,
            "leaves": manifest_leaves,
            "skel": len(skeleton_blob),
        },
        separators=(",", ":"),
    ).encode()
    out: List = [struct.pack(">I", len(manifest)), manifest, skeleton_blob]
    out.extend(buffers)
    return out


def _shards_tile_axis0(spec, shape) -> bool:
    """True when the wire shards split the array only along axis 0, in
    order, covering it exactly — then the payload region IS the array in
    C order and decode can alias it zero-copy (no np.empty + assembly)."""
    if not shape:
        return False
    pos = 0
    for entry in spec["shards"]:
        idx = entry["idx"]
        if idx[0][0] != pos:
            return False
        for (s, e), dim in zip(idx[1:], shape[1:]):
            if s != 0 or e != dim:
                return False
        pos = idx[0][1]
    return pos == shape[0]


def _region_tensor(region: memoryview, name: str, shape, copy: bool) -> torch.Tensor:
    """A CPU tensor over a payload region: an alias when ``copy`` is False
    and the region is writable, else an owned copy (torch has no
    read-only tensors, so a read-only region is never aliased).  Built
    through ``uint8``, so bfloat16 needs nothing of numpy."""
    dtype = _torch_dtype(name)
    n = region.nbytes
    if n and not copy and not region.readonly:
        raw = torch.frombuffer(region, dtype=torch.uint8)
    else:
        raw = torch.empty(n, dtype=torch.uint8)
        if n:
            raw.numpy()[:] = np.frombuffer(region, dtype=np.uint8)
    return raw.view(dtype).reshape(shape)


def _decode_tensor(region: memoryview, name: str, shape, device, view: bool):
    """A device-array leaf as a tensor: on ``device`` when it is a card,
    else on the host — aliasing the payload when ``view``, else owned."""
    if device is not None and device.type != "cpu":
        return _region_tensor(region, name, shape, copy=False).to(device)
    return _region_tensor(region, name, shape, copy=not view)


_PY_CASTS = {"bool": bool, "int": int, "float": float, "str": str}


def decode_payload(
    payload: memoryview | bytes,
    allowed: Optional[Dict[str, Any]] = None,
    device_put: bool = False,
    device: Any = None,
    mesh: Any = None,
    zero_copy: bool = False,
) -> Any:
    """Decode wire buffers back into the original pytree.

    ``allowed`` is the serializing allowlist (applied to every pickled
    sub-blob including the skeleton).  Leaves that were device arrays on
    the sender (a ``torch.Tensor`` or a ``jax.Array``) decode as
    ``torch.Tensor``s; host arrays as ``np.ndarray``s.  With
    ``device_put=True`` the tensors are placed on ``device`` (a
    ``torch.device`` or its name; ``None`` is the current CUDA card, and
    raises where there is none).  ``mesh``: the receiver's party
    ``DeviceMesh`` — with ``device_put``, shard-encoded leaves whose sender
    layout fits it (:func:`resolve_sharding`) decode as DTensors on it,
    each process building its own shard from the payload.
    ``zero_copy``: without device_put, large array leaves decode as
    views aliasing the payload — plain ``nd`` leaves at or above
    :data:`ND_ZERO_COPY_MIN_BYTES`, and shard-streamed leaves whose wire
    layout is already C-order (no assembly copy) — opt-in because
    in-place consumers need owned arrays; small leaves stay owned copies
    so a retained view can't pin a huge payload.  ``np.ndarray`` views
    are READONLY; tensor views are not (torch has no such flag) and must
    not be written, and a read-only payload decodes as copies.
    """
    target: List[torch.device] = []

    def _target() -> torch.device:
        if not target:
            target.append(platform.resolve_device(device))
        return target[0]

    mv = memoryview(payload)
    (mlen,) = struct.unpack(">I", mv[:4])
    offset = 4
    manifest = json.loads(bytes(mv[offset : offset + mlen]))
    offset += mlen
    fmt_version = manifest.get("v", 1)
    if fmt_version > WIRE_FORMAT_VERSION:
        raise ValueError(
            f"payload uses wire format v{fmt_version}; this receiver "
            f"understands up to v{WIRE_FORMAT_VERSION} — upgrade the "
            f"receiving party"
        )
    skel_len = manifest["skel"]
    skeleton_obj = serialization.loads(bytes(mv[offset : offset + skel_len]), allowed)
    offset += skel_len
    if not isinstance(skeleton_obj, _Skeleton):
        raise ValueError("corrupt payload: missing skeleton")

    leaves: List[Any] = []
    for spec in manifest["leaves"]:
        kind = spec["k"]
        if kind == "nd":
            n = spec["n"]
            region = mv[offset : offset + n]
            offset += n
            if spec.get("dev"):
                # A device array on the sender: a tensor here.
                leaves.append(
                    _decode_tensor(
                        region, spec["dtype"], spec["shape"],
                        _target() if device_put else None,
                        view=zero_copy and not device_put
                        and n >= ND_ZERO_COPY_MIN_BYTES,
                    )
                )
                continue
            as_view = zero_copy and n >= ND_ZERO_COPY_MIN_BYTES
            if as_view:
                # Zero-copy opt-in, large leaves only: READONLY view
                # aliasing the payload (same contract as the "nds" path
                # below) — e.g. a packed-tree buffer below the
                # shard-stream threshold decodes with no memcpy at all.
                arr = np.frombuffer(region.toreadonly(), dtype=np.dtype(spec["dtype"]))
            else:
                arr = np.frombuffer(region, dtype=np.dtype(spec["dtype"]))
            arr = arr.reshape(spec["shape"])
            if not as_view:
                # Host-array leaves must be writable (reference's pickle
                # path returned writable arrays) and must not pin the whole
                # payload buffer alive — one copy, same cost as pickle.
                arr = arr.copy()
            leaves.append(arr)
        elif kind == "nds":
            name = spec["dtype"]
            shape = tuple(spec["shape"])
            total = sum(e["n"] for e in spec["shards"])
            sharding = resolve_sharding(spec.get("spec"), mesh) if device_put else None
            placed = None
            if sharding is not None:
                placed = _place_local_shard(mv, offset, spec, name, shape, sharding, _target())
            if placed is not None:
                leaves.append(placed)
            elif _shards_tile_axis0(spec, shape):
                # Shards split only axis 0, in wire order: the payload
                # region already IS the array in C order — alias it (or
                # feed it straight to the H2D copy) instead of assembling.
                leaves.append(
                    _decode_tensor(
                        mv[offset : offset + total], name, shape,
                        _target() if device_put else None,
                        view=zero_copy and not device_put,
                    )
                )
            else:
                # Any other shard layout (a sharded jax.Array): assemble
                # on the host, then place.
                out = torch.empty(shape, dtype=_torch_dtype(name))
                off = offset
                for entry in spec["shards"]:
                    idx = tuple(slice(s, e) for s, e in entry["idx"])
                    extents = [e - s for s, e in entry["idx"]]
                    n = entry["n"]
                    out[idx] = _region_tensor(mv[off : off + n], name, extents, copy=False)
                    off += n
                if device_put and _target().type != "cpu":
                    out = out.to(_target())
                leaves.append(out)
            offset += total
        elif kind == "pkl":
            n = spec["n"]
            leaves.append(serialization.loads(bytes(mv[offset : offset + n]), allowed))
            offset += n
        elif kind == "py":
            v = spec["v"]
            cast = _PY_CASTS.get(spec.get("t", ""))
            leaves.append(cast(v) if (cast is not None and v is not None) else v)
        else:  # pragma: no cover
            raise ValueError(f"unknown leaf kind {kind!r}")

    slots, treedef = tree_util.tree_flatten(
        skeleton_obj.tree, is_leaf=lambda x: isinstance(x, _LeafSlot)
    )
    ordered = [leaves[s.index] for s in slots]
    return tree_util.tree_unflatten(ordered, treedef)


def payload_nbytes(buffers: List) -> int:
    return sum(len(b) if isinstance(b, (bytes, bytearray)) else b.nbytes for b in buffers)


# ---------------------------------------------------------------------------
# Stream/delta frames (wire format v3)
# ---------------------------------------------------------------------------
#
# A DATA frame sent on a named *stream* carries extra header fields:
#
#   stm   stream key (stable across rounds; scopes the delta cache)
#   ccsz  chunk size the per-chunk CRCs / bitmap refer to
#   ccrc  list of per-chunk CRC32 (zlib) values, one per TRANSMITTED
#         chunk in payload order — the receiver verifies each chunk and
#         skips the whole-payload CRC re-check entirely
#   dlt   delta manifest (absent on a full send):
#           total  full logical payload length in bytes
#           map    hex bitmap, bit i set = chunk i of the logical
#                  payload is INCLUDED in this frame (it changed)
#           bfp    fingerprint of the base payload the delta applies to
#                  (crc32 over the base's packed per-chunk CRC words) —
#                  a mismatch means the receiver's cached base desynced
#                  (e.g. peer restart) and it replies
#                  code="delta_base" so the sender falls back to a
#                  full payload
#
# CRCs here are zlib.crc32 (always C-speed, stdlib) rather than the
# native CRC32-C path: delta caching must not degrade to a ~MB/s pure-
# Python checksum when the native codec isn't built.


def chunk_crcs(buf, chunk_bytes: int = DELTA_CHUNK_BYTES) -> List[int]:
    """Per-chunk zlib CRC32 of ``buf`` (last chunk may be short)."""
    import zlib

    mv = memoryview(buf)
    if mv.format != "B":
        mv = mv.cast("B")
    return [
        zlib.crc32(mv[off : off + chunk_bytes])
        for off in range(0, len(mv), chunk_bytes)
    ] or [zlib.crc32(b"")]


def crc_fingerprint(crcs: List[int]) -> int:
    """One fingerprint of a payload from its per-chunk CRC list.

    Cheap to maintain incrementally (patch the changed chunks' words and
    re-hash the small list) — both ends use it to prove their delta
    bases match without re-hashing the multi-GB payload."""
    import zlib

    return zlib.crc32(b"".join(struct.pack(">I", c) for c in crcs))


def encode_chunk_bitmap(indices: List[int], nchunks: int) -> str:
    """Hex bitmap with bit ``i`` set for every included chunk index."""
    bits = bytearray((nchunks + 7) // 8)
    for i in indices:
        bits[i >> 3] |= 1 << (i & 7)
    return bits.hex()


def decode_chunk_bitmap(hexmap: str, nchunks: int) -> List[int]:
    bits = bytes.fromhex(hexmap)
    return [i for i in range(nchunks) if bits[i >> 3] & (1 << (i & 7))]


def make_delta_manifest(
    total: int, bitmap_hex: str, base_fp: Optional[int] = None
) -> Dict[str, Any]:
    """The ``dlt`` header field — the single producer of its schema
    (``tool/check_wire_format.py`` fingerprints it).

    ``base_fp=None`` (v4 stripe frames only) omits ``bfp``: the frame's
    chunks are a segment of a FRESH payload to assemble, not a delta
    against a cached base.  Ordinary delta frames always carry ``bfp``.
    """
    d: Dict[str, Any] = {"total": int(total), "map": bitmap_hex}
    if base_fp is not None:
        d["bfp"] = int(base_fp)
    return d


def make_stripe_marker(sid: int, nf: int) -> Dict[str, int]:
    """The ``stp`` header field of a multi-rail stripe frame (wire v4).

    ``sid`` — payload generation id, monotonically increasing per
    client: a retry re-ships the whole payload under a fresh sid and
    the receiver discards any stale partial assembly for the same
    rendezvous.  ``nf`` — total frames in this payload's stripe group;
    assembly completes when all ``nf`` frames verified.  Single
    producer of the schema (fingerprinted by tool/check_wire_format).
    """
    return {"sid": int(sid), "nf": int(nf)}
