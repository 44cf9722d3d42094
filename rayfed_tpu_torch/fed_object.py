"""FedObject — the distributed future that crosses party boundaries.

Capability parity with reference ``fed/fed_object.py``: an owning party +
fed task id + an optional *local* handle (here a :class:`~rayfed_tpu_torch.executor.LocalRef`
future into the party's executor instead of a ``ray.ObjectRef``), plus
exactly-once sending bookkeeping and recv-side caching.
"""

from __future__ import annotations

import threading
from typing import Any, Optional


class FedObjectSendingContext:
    """Tracks which parties this object was already (or is being) pushed to.

    The exactly-once dedup here is what makes broadcast-on-get and repeated
    cross-party arg use safe with >2 parties (reference
    ``fed/fed_object.py:18-31``).
    """

    def __init__(self) -> None:
        self._is_sending_or_sent: dict[str, bool] = {}
        self._lock = threading.Lock()

    def mark_is_sending_to_party(self, target_party: str) -> None:
        with self._lock:
            self._is_sending_or_sent[target_party] = True

    def was_sending_or_sent_to_party(self, target_party: str) -> bool:
        with self._lock:
            return target_party in self._is_sending_or_sent

    def mark_if_not_sending_to_party(self, target_party: str) -> bool:
        """Atomically test-and-set; returns True if WE should do the send."""
        with self._lock:
            if target_party in self._is_sending_or_sent:
                return False
            self._is_sending_or_sent[target_party] = True
            return True


class FedObject:
    """Handle for the result of a fed task.

    If ``node_party`` is the current party, ``local_ref`` is a live
    :class:`LocalRef`; otherwise it is ``None`` until (and unless) the value
    is received from the owner, at which point the received ref is cached
    (reference ``fed/fed_object.py:76-78``).
    """

    def __init__(
        self,
        node_party: str,
        fed_task_id: int,
        local_ref: Optional[Any],
        idx_in_task: int = 0,
    ) -> None:
        self._node_party = node_party
        self._local_ref = local_ref
        self._fed_task_id = fed_task_id
        self._idx_in_task = idx_in_task
        self._sending_context = FedObjectSendingContext()

    def get_local_ref(self):
        return self._local_ref

    # Reference-compatible alias (``fed/fed_object.py:54``).
    get_ray_object_ref = get_local_ref

    def get_fed_task_id(self) -> str:
        """Rendezvous-key half: ``"{seq}#{idx}"`` (reference ``fed_object.py:62-63``)."""
        return f"{self._fed_task_id}#{self._idx_in_task}"

    def get_party(self) -> str:
        return self._node_party

    def _mark_is_sending_to_party(self, target_party: str) -> None:
        self._sending_context.mark_is_sending_to_party(target_party)

    def _was_sending_or_sent_to_party(self, target_party: str) -> bool:
        return self._sending_context.was_sending_or_sent_to_party(target_party)

    def _mark_if_not_sending_to_party(self, target_party: str) -> bool:
        return self._sending_context.mark_if_not_sending_to_party(target_party)

    def _cache_local_ref(self, local_ref) -> None:
        """Cache the received local ref so repeated consumption skips recv."""
        self._local_ref = local_ref

    # Reference-compatible alias.
    _cache_ray_object_ref = _cache_local_ref

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "bound" if self._local_ref is not None else "placeholder"
        return (
            f"FedObject(party={self._node_party!r}, "
            f"task_id={self.get_fed_task_id()!r}, {state})"
        )
