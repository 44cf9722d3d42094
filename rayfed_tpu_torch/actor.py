"""Cross-party stateful actors.

Capability parity with reference ``fed/_private/fed_actor.py``: a
:class:`FedActorHandle` whose ``__getattr__`` manufactures a
:class:`FedActorMethod` per method; construction executes only in the
owning party; every method call flows through the shared
:class:`~rayfed_tpu_torch.call_holder.FedCallHolder` so seq ids stay aligned on
all parties.

Difference from Ray: the actor body lives in-process on a dedicated
serial executor (:class:`~rayfed_tpu_torch.executor.ActorInstance`), so
``torch.Tensor`` state stays resident on the party's card between calls.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

from rayfed_tpu_torch.call_holder import FedCallHolder
from rayfed_tpu_torch.executor import ActorInstance
from rayfed_tpu_torch.runtime import Runtime

logger = logging.getLogger(__name__)


class FedActorHandle:
    def __init__(
        self,
        runtime: Runtime,
        fed_class_task_id: int,
        cls: type,
        node_party: str,
        options: Optional[dict] = None,
    ) -> None:
        self._runtime = runtime
        self._fed_class_task_id = fed_class_task_id
        self._body = cls
        self._party = runtime.party
        self._node_party = node_party
        self._options = dict(options or {})
        self._actor_instance: Optional[ActorInstance] = None

    def __getattr__(self, method_name: str):
        if method_name.startswith("_"):
            raise AttributeError(method_name)
        # Validate the method exists on the user class (ref fed_actor.py:46).
        getattr(self._body, method_name)
        # Creation options propagate to method call nodes (ref fed_actor.py:47-55).
        return FedActorMethod(
            self._runtime, self._node_party, self, method_name
        ).options(**self._options)

    def _execute_impl(self, cls_args: tuple, cls_kwargs: dict) -> None:
        """Construct the actor — only in the owning party (ref :57-70)."""
        if self._node_party == self._party:
            self._actor_instance = ActorInstance(
                self._body,
                cls_args,
                cls_kwargs,
                bind_runtime_fn=self._runtime._bind_to_current_thread,
                name=f"{self._body.__name__}-{self._fed_class_task_id}",
                party=self._party,
            )
            self._runtime.register_actor(self._actor_instance)

    def _execute_remote_method(
        self, method_name: str, options: dict, args: tuple, kwargs: dict
    ):
        num_returns = int(options.get("num_returns", 1)) if options else 1
        assert self._actor_instance is not None, (
            "actor methods can only execute in the owning party"
        )
        return self._actor_instance.call_method(
            method_name, args, kwargs, num_returns=num_returns
        )

    def _kill(self) -> None:
        if self._actor_instance is not None:
            self._actor_instance.kill()


class FedActorMethod:
    def __init__(
        self,
        runtime: Runtime,
        node_party: str,
        fed_actor_handle: FedActorHandle,
        method_name: str,
    ) -> None:
        self._runtime = runtime
        self._node_party = node_party
        self._fed_actor_handle = fed_actor_handle
        self._method_name = method_name
        self._options: dict = {}
        self._fed_call_holder = FedCallHolder(
            runtime, node_party, self._execute_impl
        )

    def remote(self, *args, **kwargs):
        return self._fed_call_holder.internal_remote(*args, **kwargs)

    def options(self, **options):
        self._options = options
        self._fed_call_holder.options(**options)
        return self

    def _execute_impl(self, args: tuple, kwargs: dict):
        return self._fed_actor_handle._execute_remote_method(
            self._method_name, self._options, args, kwargs
        )
