"""Per-party Runtime — the single-controller replacement for Ray.

The reference spreads per-party state across a Ray cluster: config in the
GCS internal KV, proxies as named actors, a module-global seq counter.
Here everything a party owns lives on one :class:`Runtime` object:

- the deterministic sequence counter (:class:`~rayfed_tpu_torch.context.GlobalContext`),
- the local :class:`~rayfed_tpu_torch.executor.TaskExecutor`,
- the cross-party send/recv proxies (asyncio transport),
- the cleanup/send-watchdog,
- the party-local device mesh for sharded compute (a ``DeviceMesh`` over
  the party's world of processes, or None).

Runtime resolution is thread-local with a process-wide default.  This is
what enables *multi-party-in-one-process simulation*: each simulated party
gets its own Runtime bound to its own threads, so all parties can share
the one local card while still exercising the real wire transport.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Optional

from rayfed_tpu_torch.config import ClusterConfig, JobConfig
from rayfed_tpu_torch.context import GlobalContext
from rayfed_tpu_torch.executor import ActorInstance, TaskExecutor

logger = logging.getLogger(__name__)

_tls = threading.local()
_process_default_runtime: Optional["Runtime"] = None
_default_lock = threading.Lock()


class Runtime:
    def __init__(
        self,
        cluster_config: ClusterConfig,
        job_config: JobConfig,
        max_workers: int = 16,
        mesh: Optional[Any] = None,
    ) -> None:
        self.cluster_config = cluster_config
        self.job_config = job_config
        self.global_context = GlobalContext()
        self.mesh = mesh  # party-local DeviceMesh, or None
        # True when fed.init started a one-rank world for this party's mesh
        # (fed.shutdown then leaves it).
        self.owned_world = False
        self.executor = TaskExecutor(
            max_workers=max_workers,
            thread_name_prefix=f"rayfed-{cluster_config.current_party}",
            bind_runtime_fn=self._bind_to_current_thread,
            party=cluster_config.current_party,
        )
        self._actors: list[ActorInstance] = []
        self._actors_lock = threading.Lock()
        # Late-bound by api.init(): transport proxies + cleanup manager.
        self.send_proxy = None
        self.recv_proxy = None
        self.transport = None
        self.cleanup_manager = None
        self.sequence_tracer = None

    @property
    def party(self) -> str:
        return self.cluster_config.current_party

    def _bind_to_current_thread(self) -> None:
        _tls.runtime = self

    def register_actor(self, actor: ActorInstance) -> None:
        with self._actors_lock:
            self._actors.append(actor)

    def next_seq_id(self) -> int:
        return self.global_context.next_seq_id()

    def shutdown_actors(self) -> None:
        with self._actors_lock:
            actors, self._actors = self._actors, []
        for actor in actors:
            actor.kill()


def set_current_runtime(runtime: Optional[Runtime], process_default: bool = True):
    """Bind ``runtime`` for the current thread (and optionally the process)."""
    global _process_default_runtime
    _tls.runtime = runtime
    if process_default:
        with _default_lock:
            _process_default_runtime = runtime


def get_runtime() -> Runtime:
    runtime = getattr(_tls, "runtime", None)
    if runtime is None:
        runtime = _process_default_runtime
    if runtime is None:
        raise RuntimeError(
            "rayfed_tpu_torch is not initialized in this thread; call fed.init() first"
        )
    return runtime


def get_runtime_or_none() -> Optional[Runtime]:
    runtime = getattr(_tls, "runtime", None)
    return runtime if runtime is not None else _process_default_runtime
