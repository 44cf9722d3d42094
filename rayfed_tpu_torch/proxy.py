"""Module-level ``send`` / ``recv`` primitives.

Parity with reference ``fed/barriers.py:418-438``: ``send`` routes through
the party's send proxy and registers the in-flight result with the cleanup
watchdog; ``recv`` returns a future that parks until the owner's push
arrives.
"""

from __future__ import annotations

from typing import Any

from rayfed_tpu_torch.executor import LocalRef
from rayfed_tpu_torch.runtime import Runtime, get_runtime


def send_on_runtime(
    runtime: Runtime,
    dest_party: str,
    data: Any,
    upstream_seq_id: Any,
    downstream_seq_id: Any,
    stream: Any = None,
    round_tag: Any = None,
    epoch_tag: Any = None,
    quant_meta: Any = None,
) -> LocalRef:
    """``stream``: stable stream name enabling the transport's per-peer
    delta cache (ship only changed chunks — see TransportClient).
    ``round_tag``: federated round index stamped into the frame metadata
    (``wire.ROUND_TAG_KEY``) so in-flight pipelined rounds stay
    attributable — see :meth:`TransportManager.send`.  ``epoch_tag``:
    roster epoch stamped into the metadata (``wire.EPOCH_TAG_KEY``;
    cross-epoch frames are rejected loudly by the receiver).
    ``quant_meta``: shared-quantization-grid descriptor stamped into the
    metadata (``wire.QUANT_GRID_KEY``) for compressed-domain payloads."""
    if runtime.send_proxy is None:
        raise RuntimeError("transport not started; call fed.init() first")
    result_ref = runtime.send_proxy.send(
        dest_party=dest_party,
        data=data,
        upstream_seq_id=upstream_seq_id,
        downstream_seq_id=downstream_seq_id,
        stream=stream,
        round_tag=round_tag,
        epoch_tag=epoch_tag,
        quant_meta=quant_meta,
    )
    if runtime.cleanup_manager is not None:
        runtime.cleanup_manager.push_to_sending(result_ref)
    return result_ref


def send_many_on_runtime(
    runtime: Runtime,
    dest_parties,
    data: Any,
    upstream_seq_id: Any,
    downstream_seq_id: Any,
    stream: Any = None,
    round_tag: Any = None,
    epoch_tag: Any = None,
    quant_meta: Any = None,
    blob_offer: bool = False,
) -> dict:
    """Broadcast fan-out: ONE payload encode shared by every destination.

    The transport encodes (and checksums, and device→host fetches) the
    value once and pushes it to all parties concurrently — the owner's
    broadcast-on-get cost becomes max(per-peer wire time), not
    N × (encode + wire).  Each per-party result ref registers with the
    cleanup watchdog exactly like a single send.

    ``blob_offer=True``: large immutable payloads may ship as
    fingerprint handles resolved pull-on-demand by the receivers — see
    :meth:`TransportManager.send_many`.
    """
    if runtime.send_proxy is None:
        raise RuntimeError("transport not started; call fed.init() first")
    refs = runtime.send_proxy.send_many(
        dest_parties=dest_parties,
        data=data,
        upstream_seq_id=upstream_seq_id,
        downstream_seq_id=downstream_seq_id,
        stream=stream,
        round_tag=round_tag,
        epoch_tag=epoch_tag,
        quant_meta=quant_meta,
        blob_offer=blob_offer,
    )
    if runtime.cleanup_manager is not None:
        for ref in refs.values():
            runtime.cleanup_manager.push_to_sending(ref)
    return refs


def recv_on_runtime(
    runtime: Runtime,
    src_party: str,
    upstream_seq_id: Any,
    curr_seq_id: Any,
) -> LocalRef:
    if runtime.recv_proxy is None:
        raise RuntimeError("transport not started; call fed.init() first")
    return runtime.recv_proxy.recv(
        src_party=src_party,
        upstream_seq_id=upstream_seq_id,
        downstream_seq_id=curr_seq_id,
    )


def send(dest_party: str, data: Any, upstream_seq_id: Any, downstream_seq_id: Any):
    return send_on_runtime(
        get_runtime(), dest_party, data, upstream_seq_id, downstream_seq_id
    )


def recv(party: str, src_party: str, upstream_seq_id: Any, curr_seq_id: Any):
    assert party, "Party can not be None."
    return recv_on_runtime(get_runtime(), src_party, upstream_seq_id, curr_seq_id)
