"""Global sequence-id context — the determinism backbone.

Every party deterministically walks the same logical DAG; task N on alice
*is* task N on bob because both allocate ids from this monotonic counter in
the shared code path only (capability of reference
``fed/_private/global_context.py:16-22``).  Any party-conditional counter
allocation would desync cross-party rendezvous keys, so the counter must be
bumped exactly once per logical call site on every party.
"""

from __future__ import annotations

import threading


class GlobalContext:
    """Monotonic per-job sequence counter.

    Thread-safe: task bodies may submit sub-calls from worker threads in
    simulation mode, so allocation takes a lock (the reference relied on the
    GIL; we make it explicit).
    """

    def __init__(self) -> None:
        self._seq_count = 0
        self._lock = threading.Lock()

    def next_seq_id(self) -> int:
        with self._lock:
            self._seq_count += 1
            return self._seq_count

    def current_seq_id(self) -> int:
        with self._lock:
            return self._seq_count
