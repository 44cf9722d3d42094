"""Cross-party DCN transport.

Replaces the reference's Ray-actor-hosted gRPC unary push transport
(``fed/barriers.py``, ``fed/grpc/fed.proto``) with an asyncio framed-TCP
transport designed for device arrays: a zero-copy tensor wire format
(:mod:`rayfed_tpu_torch.transport.wire`), an either-side-first rendezvous mailbox
(:mod:`rayfed_tpu_torch.transport.rendezvous`), persistent multiplexed
connections with retry policy (:mod:`rayfed_tpu_torch.transport.client`), and an
in-process :class:`~rayfed_tpu_torch.transport.manager.TransportManager` hosting
both proxies on one asyncio loop thread.
"""

from rayfed_tpu_torch.transport.manager import TransportManager
from rayfed_tpu_torch.transport.wire import encode_payload, decode_payload

__all__ = ["TransportManager", "encode_payload", "decode_payload"]
