"""Address / cluster validation (parity: reference ``fed/utils.py:162-198``)."""

from __future__ import annotations

from typing import Dict, Optional


def validate_address(address: Optional[str]) -> None:
    """Accepts None, 'local', or 'host:port'-shaped strings.

    The reference forwards this to ``ray.init``; here 'local' (or None)
    simply means in-process execution — there is no external cluster to
    join, the party controller *is* the runtime.
    """
    if address is None or address == "local":
        return
    if not isinstance(address, str):
        raise ValueError(f"address must be a string, got {type(address).__name__}")
    if address.count(":") < 1:
        raise ValueError(
            f"Invalid address {address!r}: expected 'local' or '<host>:<port>'."
        )


def _validate_party_addr(party: str, addr: str) -> None:
    if not isinstance(addr, str) or ":" not in addr:
        raise ValueError(
            f"Invalid address {addr!r} for party {party!r}: "
            "expected '<host>:<port>'."
        )
    host, _, port = addr.rpartition(":")
    if not host:
        raise ValueError(f"Invalid address {addr!r} for party {party!r}: no host.")
    try:
        p = int(port)
    except ValueError:
        raise ValueError(
            f"Invalid address {addr!r} for party {party!r}: port must be an int."
        ) from None
    if not (0 < p < 65536):
        raise ValueError(
            f"Invalid address {addr!r} for party {party!r}: port out of range."
        )


def validate_cluster_info(cluster: Dict) -> None:
    if not isinstance(cluster, dict) or not cluster:
        raise ValueError("cluster must be a non-empty dict of party -> config")
    for party, cfg in cluster.items():
        if not isinstance(cfg, dict) or "address" not in cfg:
            raise ValueError(
                f"cluster entry for party {party!r} must be a dict with 'address'"
            )
        _validate_party_addr(party, cfg["address"])
        if cfg.get("listen_addr"):
            _validate_party_addr(party, cfg["listen_addr"])
