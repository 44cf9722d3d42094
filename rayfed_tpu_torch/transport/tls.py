"""TLS/mTLS context construction from the reference's tls_config shape.

``tls_config = {"ca_cert": <path>, "cert": <path>, "key": <path>}``
(reference ``fed/utils.py:114-128``).  Both directions authenticate: the
server requires a client certificate signed by the shared CA (the
reference enables mutual TLS on its gRPC channels the same way).
"""

from __future__ import annotations

import ssl
from typing import Dict, Optional


def validate_tls_config(tls_config: Dict[str, str]) -> None:
    if not tls_config:
        return
    missing = {"ca_cert", "cert", "key"} - set(tls_config)
    if missing:
        raise ValueError(f"tls_config missing required keys: {sorted(missing)}")


def server_ssl_context(tls_config: Optional[Dict[str, str]]) -> Optional[ssl.SSLContext]:
    if not tls_config:
        return None
    validate_tls_config(tls_config)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile=tls_config["cert"], keyfile=tls_config["key"])
    ctx.load_verify_locations(cafile=tls_config["ca_cert"])
    ctx.verify_mode = ssl.CERT_REQUIRED  # mutual TLS
    return ctx


def client_ssl_context(tls_config: Optional[Dict[str, str]]) -> Optional[ssl.SSLContext]:
    if not tls_config:
        return None
    validate_tls_config(tls_config)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_verify_locations(cafile=tls_config["ca_cert"])
    ctx.load_cert_chain(certfile=tls_config["cert"], keyfile=tls_config["key"])
    # Cross-silo peers are addressed by IP from a private cluster map; the
    # CA is the trust anchor, not DNS naming.
    ctx.check_hostname = False
    return ctx
