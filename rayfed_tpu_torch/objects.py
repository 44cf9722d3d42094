"""Content-addressed object handles — the fingerprint-passing half of
the pull-on-demand object plane.

Large immutable objects (base weights, join welcomes, checkpoint
snapshots) used to be eagerly pushed by their owner on every transfer,
even when the receiver already held the identical bytes — RayFed's
transport is purely push-based.  The object plane splits "name the
bytes" from "move the bytes", per "Transparent Object Proxies":

- the OWNER serializes once, fingerprints the wire bytes
  (:func:`rayfed_tpu_torch.transport.wire.blob_fingerprint` — the single
  producer, built on the delta-cache's chunk-CRC machinery) and passes
  a small **handle** ``{fingerprint, nbytes, holders}``;
- the RECEIVER resolves the handle lazily: a content-cache hit costs
  zero payload bytes; a miss issues a ``BLOB_GET`` pull to any named
  holder and caches the verified bytes by content
  (:class:`rayfed_tpu_torch.transport.objectstore.ObjectPlane`).

This module is the schema + resolve layer: the single producers of the
handle / request / reply-metadata shapes (fingerprinted as cross-party
contracts by ``tool/check_wire_format.py``), plus the helpers the
``fed.get`` receive path and ``fed.join`` use to turn a handle back
into the object it names.  The transport half — the bounded
content-addressed store and the pull protocol — lives in
:mod:`rayfed_tpu_torch.transport.objectstore`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

# Version of the handle / pull-protocol semantics (what a fingerprint
# covers, how holders are tried, the request/reply schemas).  Like
# RING_STRIPE_VERSION / SECAGG_VERSION this is a payload-level contract
# knob: bumping it re-pins tool/wire_format.lock WITHOUT a
# WIRE_FORMAT_VERSION bump — the frame layout itself is untouched.
OBJECT_PLANE_VERSION = 1

# The sentinel key marking a dict payload as a blob handle (its value
# is the protocol version).  A receiver that decodes a handle but has
# no object plane MUST fail loudly rather than hand the dict to user
# code as if it were the object.
BLOB_HANDLE_MARK = "__rayfed_blob__"


class ObjectPlaneError(RuntimeError):
    """A blob pull could not complete (no holder had the bytes, every
    holder was dead/corrupt, or the resolver has no object plane)."""


# ---------------------------------------------------------------------------
# Schemas — single producers, fingerprinted by tool/check_wire_format.py
# ---------------------------------------------------------------------------


def make_blob_handle(
    fp: str, nbytes: int, holders: Sequence[str]
) -> Dict[str, Any]:
    """The handle passed IN PLACE of a large immutable object: content
    fingerprint, payload size, and the parties known to hold the bytes
    (tried in order by the puller, with dead-holder failover)."""
    holders = [str(h) for h in holders]
    if not holders:
        raise ValueError("a blob handle must name at least one holder")
    return {
        BLOB_HANDLE_MARK: int(OBJECT_PLANE_VERSION),
        "fp": str(fp),
        "n": int(nbytes),
        "holders": holders,
    }


def is_blob_handle(value: Any) -> bool:
    return isinstance(value, dict) and BLOB_HANDLE_MARK in value


def check_blob_handle(handle: Any) -> Dict[str, Any]:
    """Validate a received handle; loud errors, never silent garbage."""
    if not is_blob_handle(handle):
        raise ObjectPlaneError(f"not a blob handle: {type(handle).__name__}")
    ver = handle.get(BLOB_HANDLE_MARK)
    if int(ver) > OBJECT_PLANE_VERSION:
        raise ObjectPlaneError(
            f"blob handle uses object-plane protocol v{ver}; this party "
            f"understands up to v{OBJECT_PLANE_VERSION} — upgrade the "
            f"receiving party"
        )
    fp, n, holders = handle.get("fp"), handle.get("n"), handle.get("holders")
    if not isinstance(fp, str) or not fp:
        raise ObjectPlaneError(f"blob handle carries no fingerprint: {handle!r}")
    if not isinstance(n, int) or n < 0:
        raise ObjectPlaneError(f"blob handle carries a bad size: {handle!r}")
    if not isinstance(holders, list) or not holders:
        raise ObjectPlaneError(f"blob handle names no holders: {handle!r}")
    return {
        BLOB_HANDLE_MARK: int(ver),
        "fp": fp,
        "n": n,
        "holders": [str(h) for h in holders],
    }


def make_blob_request(fp: str, reply_key: str) -> Dict[str, Any]:
    """The ``wire.BLOB_GET_KEY`` frame-metadata value: a pull request
    naming the wanted fingerprint and the reply rendezvous key the
    requester is already parked on (so the holder's reply needs no
    negotiation)."""
    return {
        "v": int(OBJECT_PLANE_VERSION),
        "fp": str(fp),
        "rk": str(reply_key),
    }


def check_blob_request(req: Any) -> Dict[str, Any]:
    if not isinstance(req, dict):
        raise ObjectPlaneError(f"malformed blob request: {req!r}")
    fp, rk = req.get("fp"), req.get("rk")
    if not isinstance(fp, str) or not fp or not isinstance(rk, str) or not rk:
        raise ObjectPlaneError(f"malformed blob request: {req!r}")
    return {"v": int(req.get("v", 1)), "fp": fp, "rk": rk}


def make_blob_reply_meta(
    fp: str, nbytes: Optional[int] = None, miss: bool = False
) -> Dict[str, Any]:
    """The ``wire.BLOB_PUT_KEY`` frame-metadata value: stamps a pull
    reply with the fingerprint it answers.  ``miss=True`` marks a
    payload-less "I don't hold these bytes" notice — the requester
    fails over to the next named holder immediately instead of waiting
    out the recv backstop."""
    d: Dict[str, Any] = {"v": int(OBJECT_PLANE_VERSION), "fp": str(fp)}
    if miss:
        d["miss"] = 1
    else:
        d["n"] = int(nbytes if nbytes is not None else 0)
    return d


def check_blob_reply_meta(rep: Any) -> Dict[str, Any]:
    if not isinstance(rep, dict) or not isinstance(rep.get("fp"), str):
        raise ObjectPlaneError(f"malformed blob reply metadata: {rep!r}")
    return rep


# ---------------------------------------------------------------------------
# Serialize / deserialize — the wire codec applied to one standalone blob
# ---------------------------------------------------------------------------


def canonical_host(value: Any) -> Any:
    """Residency-normalized copy of a pytree: every array leaf (a
    ``torch.Tensor`` on any device, or an ``np.ndarray``) fetched to host
    numpy.

    The wire codec stamps a leaf's manifest with WHERE it lived
    (``dev``) — so two controllers holding the same VALUES at different
    residencies (the coordinator's freshly finalized device array vs a
    member's decoded host view) would serialize to different bytes and
    derive DIFFERENT fingerprints, silently splitting the content
    space.  Every publish site that needs cross-controller fingerprint
    agreement (the quorum loop's round-model slot, welcome-carried
    server-opt state) canonicalizes first; owner-scoped publishes
    (fed.get offers — only the owner ever fingerprints) don't need to.
    """
    import numpy as np
    import torch

    from rayfed_tpu_torch import tree_util
    from rayfed_tpu_torch.transport import wire

    return tree_util.tree_map(
        lambda x: wire.tensor_to_numpy(x)
        if isinstance(x, torch.Tensor)
        else (np.asarray(x) if isinstance(x, np.ndarray) else x),
        value,
    )


def serialize_blob(value: Any) -> bytes:
    """One contiguous wire-payload byte string for ``value`` — exactly
    the bytes an eager push of the same object would put on the wire
    (``wire.encode_payload`` framing), so a handle-resolved object
    decodes BYTE-identically to the eager-push path.  Lazy shard
    encoding is off: a stored blob must be self-contained bytes."""
    from rayfed_tpu_torch.transport import wire

    bufs = wire.encode_payload(value, lazy_shards=False)
    return b"".join(
        bytes(b) if not isinstance(b, (bytes, bytearray)) else b
        for b in bufs
    )


def fingerprint_value(value: Any) -> tuple:
    """``(fingerprint, serialized bytes)`` of one object — fingerprint
    determinism across controllers is what makes handle equality mean
    content equality (tested in tests/test_objectstore.py)."""
    from rayfed_tpu_torch.transport import wire

    data = serialize_blob(value)
    return wire.blob_fingerprint(data), data


def deserialize_blob(
    data,
    allowed: Optional[Dict[str, Any]] = None,
    device_put: bool = False,
    mesh: Any = None,
    zero_copy: bool = False,
    device: Any = None,
) -> Any:
    from rayfed_tpu_torch.transport import wire

    return wire.decode_payload(
        data, allowed=allowed, device_put=device_put, device=device,
        mesh=mesh, zero_copy=zero_copy,
    )


# ---------------------------------------------------------------------------
# Resolve — turn a received handle back into the object it names
# ---------------------------------------------------------------------------


def maybe_resolve_handle(
    transport: Any, value: Any, timeout: Optional[float] = None
) -> Any:
    """If ``value`` is a blob handle, pull/decode the object it names
    through ``transport``'s object plane; otherwise return it
    unchanged.  The ``fed.get`` receive path chains this after decode,
    so handle-passing is transparent to callers.

    A handle arriving at a transport WITHOUT an object plane (e.g. a
    multi-host non-leader bridge) raises loudly — handing user code
    the raw handle dict as if it were the object would be the silent
    failure mode this layer refuses.
    """
    if not is_blob_handle(value):
        return value
    handle = check_blob_handle(value)
    plane = getattr(transport, "objects", None)
    if plane is None:
        raise ObjectPlaneError(
            f"received a blob handle for {handle['fp']} but this "
            f"transport has no object plane to resolve it (multi-host "
            f"non-leader bridges cannot pull; disable handle offers on "
            f"the sender with blob_broadcast_min_bytes=None)"
        )
    return plane.fetch(handle, timeout_s=timeout)


def holders_for(handle: Dict[str, Any], exclude: Sequence[str] = ()) -> List[str]:
    """The handle's holders minus ``exclude`` (typically the local
    party), order preserved — the pull's failover order."""
    skip = set(exclude)
    return [h for h in handle["holders"] if h not in skip]
