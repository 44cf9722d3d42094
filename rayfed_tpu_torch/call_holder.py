"""Submit-time brain: party-pinned call dispatch + dependency resolution.

Capability parity with reference ``fed/_private/fed_call_holder.py`` and
``fed/utils.py:26-61``:

- allocate one seq id per logical call on *every* party (determinism);
- same-party path: deep-substitute FedObject leaves with local refs
  (mine → its LocalRef; theirs → a ``recv`` future, cached), then submit
  the real task to the party executor;
- other-party path: push any locally-owned FedObject args to the task's
  party (exactly-once per (object, dest) pair), then return placeholder
  FedObject(s) without executing anything.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Optional

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.fed_object import FedObject
from rayfed_tpu_torch.runtime import Runtime

logger = logging.getLogger(__name__)


def resolve_dependencies(
    runtime: Runtime, current_fed_task_id: int, args: tuple, kwargs: dict
):
    """Swap FedObject leaves for local/received refs (ref ``utils.py:26-61``)."""
    from rayfed_tpu_torch.proxy import recv_on_runtime

    current_party = runtime.party
    flattened_args, tree = tree_util.tree_flatten(
        (args, kwargs), is_leaf=lambda x: isinstance(x, FedObject)
    )
    for idx, arg in enumerate(flattened_args):
        if not isinstance(arg, FedObject):
            continue
        if arg.get_party() == current_party:
            flattened_args[idx] = arg.get_local_ref()
        else:
            cached = arg.get_local_ref()
            if cached is not None:
                # Already received in this party; don't recv again
                # (reference utils.py:44-47).
                flattened_args[idx] = cached
            else:
                received = recv_on_runtime(
                    runtime,
                    src_party=arg.get_party(),
                    upstream_seq_id=arg.get_fed_task_id(),
                    curr_seq_id=current_fed_task_id,
                )
                arg._cache_local_ref(received)
                flattened_args[idx] = received
    resolved_args, resolved_kwargs = tree_util.tree_unflatten(flattened_args, tree)
    return resolved_args, resolved_kwargs


def push_arguments_to_party(
    runtime: Runtime, dest_party: str, downstream_seq_id: int, args: tuple, kwargs: dict
) -> None:
    """Owner-initiated push of locally-owned args consumed by ``dest_party``.

    The demander never pulls — the data owner holds transmission authority
    (reference ``fed_call_holder.py:75-91``, README "push-based").
    """
    from rayfed_tpu_torch.proxy import send_on_runtime

    flattened_args, _ = tree_util.tree_flatten(
        (args, kwargs), is_leaf=lambda x: isinstance(x, FedObject)
    )
    for arg in flattened_args:
        if isinstance(arg, FedObject) and arg.get_party() == runtime.party:
            # Atomic test-and-set: exactly-once per (object, dest).
            if arg._mark_if_not_sending_to_party(dest_party):
                send_on_runtime(
                    runtime,
                    dest_party=dest_party,
                    data=arg.get_local_ref(),
                    upstream_seq_id=arg.get_fed_task_id(),
                    downstream_seq_id=downstream_seq_id,
                )


class FedCallHolder:
    """Holder for one party-pinned call site: ``f.party("alice")``.

    ``submit_task_fn(resolved_args, resolved_kwargs)`` executes the real
    work on the local executor and returns LocalRef(s) — it plays the role
    of the reference's ``submit_ray_task_func`` (``api.py:294-297``).
    """

    def __init__(
        self,
        runtime: Runtime,
        node_party: str,
        submit_task_fn: Callable[[tuple, dict], Any],
        options: Optional[dict] = None,
    ) -> None:
        self._runtime = runtime
        self._party = runtime.party
        self._node_party = node_party
        self._options = dict(options or {})
        self._submit_task_fn = submit_task_fn

    def options(self, **options):
        self._options = options
        return self

    def internal_remote(self, *args, **kwargs):
        runtime = self._runtime
        fed_task_id = runtime.next_seq_id()
        if runtime.sequence_tracer is not None:
            runtime.sequence_tracer.record_call(fed_task_id, self._node_party)
        if self._party == self._node_party:
            resolved_args, resolved_kwargs = resolve_dependencies(
                runtime, fed_task_id, args, kwargs
            )
            refs = self._submit_task_fn(resolved_args, resolved_kwargs)
            if isinstance(refs, list):
                return [
                    FedObject(self._node_party, fed_task_id, ref, i)
                    for i, ref in enumerate(refs)
                ]
            return FedObject(self._node_party, fed_task_id, refs)
        else:
            push_arguments_to_party(
                runtime, self._node_party, fed_task_id, args, kwargs
            )
            num_returns = self._options.get("num_returns", 1)
            if num_returns > 1:
                return [
                    FedObject(self._node_party, fed_task_id, None, i)
                    for i in range(num_returns)
                ]
            return FedObject(self._node_party, fed_task_id, None)
