"""Loopback ports for listeners that bind later."""

from __future__ import annotations

import random
import socket
import threading
from typing import List

# Ports handed out in this process: never the same one twice.
_GIVEN: set = set()
_LOCK = threading.Lock()


def _ephemeral_range() -> tuple:
    """The kernel's ephemeral port range (Linux's default if unreadable)."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            lo, hi = map(int, f.read().split())
    except (OSError, ValueError):
        lo, hi = 32768, 60999
    return lo, hi


def free_loopback_ports(n: int) -> List[int]:
    """``n`` loopback ports, each free when chosen, never handed out twice
    in this process.

    A port is released before its listener binds it.  A port from the
    kernel's ephemeral range could meanwhile become the local port of an
    outgoing connection, and the bind would fail with EADDRINUSE; so the
    ports come from 10000 up, outside that range, where only an explicit
    bind takes a port."""
    lo, hi = _ephemeral_range()
    pool = [p for p in range(10000, 65536) if not lo <= p <= hi]
    random.SystemRandom().shuffle(pool)
    ports: List[int] = []
    with _LOCK:
        for port in pool:
            if port in _GIVEN:
                continue
            with socket.socket() as s:  # no SO_REUSEADDR: a port in TIME_WAIT is passed over
                try:
                    s.bind(("127.0.0.1", port))
                except OSError:
                    continue
            _GIVEN.add(port)
            ports.append(port)
            if len(ports) == n:
                return ports
    raise RuntimeError(f"no {n} free loopback ports outside the ephemeral range {lo}-{hi}")
