"""In-party execution substrate — replaces Ray tasks/actors/object store.

The reference delegates local execution to Ray (``fed/api.py:294-297``,
``fed/_private/fed_actor.py:66-70``): every ``fed.remote`` call becomes a
``ray.remote`` task in a worker *process*, and values flow through the
plasma object store.  On an accelerator that model is wrong: a party owns
exactly one set of local devices, the expensive work is device computation
whose dispatch is already asynchronous, and moving arrays through an object store
would force device→host copies.

So the substrate here is deliberately in-process:

- :class:`LocalRef` — the in-party future (replaces ``ray.ObjectRef``).
- :class:`TaskExecutor` — a thread pool that resolves *top-level* LocalRef
  arguments to values and invokes the (usually jit-compiled) callable.
  CUDA streams own device parallelism; threads only overlap host work, transfers
  and dispatch.  Nested LocalRefs inside containers are passed through
  un-resolved, matching Ray's argument semantics that the reference relies
  on (see ``tests/test_pass_fed_objects_in_containers_in_normal_tasks.py``
  in the reference: the consumer calls ``fed.get`` inside the task body).
- :class:`ActorInstance` — a stateful object bound to a single-thread
  executor, so method calls execute serially in submission order (Ray
  actor semantics without a process boundary).
"""

from __future__ import annotations

import concurrent.futures
import logging
import threading
import time
from typing import Any, Callable, Optional, Sequence

from rayfed_tpu_torch import telemetry
from rayfed_tpu_torch.utils.platform import fence_for_handoff

logger = logging.getLogger(__name__)


class LocalRef:
    """A future for a value produced inside this party.

    Wraps :class:`concurrent.futures.Future`.  ``resolve()`` blocks until
    the value is available (the analogue of ``ray.get`` on an ObjectRef).
    """

    __slots__ = ("_future",)

    def __init__(self, future: Optional[concurrent.futures.Future] = None) -> None:
        self._future = future if future is not None else concurrent.futures.Future()

    @classmethod
    def from_value(cls, value: Any) -> "LocalRef":
        ref = cls()
        ref._future.set_result(value)
        return ref

    def resolve(self, timeout: Optional[float] = None) -> Any:
        return self._future.result(timeout=timeout)

    def done(self) -> bool:
        return self._future.done()

    def exception(self, timeout: Optional[float] = None):
        return self._future.exception(timeout=timeout)

    def set_result(self, value: Any) -> None:
        self._future.set_result(value)

    def set_exception(self, exc: BaseException) -> None:
        self._future.set_exception(exc)

    def add_done_callback(self, fn: Callable[["LocalRef"], None]) -> None:
        self._future.add_done_callback(lambda _f: fn(self))

    def then(
        self,
        fn: Callable[[Any], Any],
        executor: Optional[concurrent.futures.Executor] = None,
    ) -> "LocalRef":
        """Chain ``fn`` onto this ref without parking a thread.

        Returns a new LocalRef resolving to ``fn(value)``; an exception
        (from this ref or from ``fn``) propagates to the returned ref.

        THREADING CONTRACT: without ``executor``, ``fn`` runs inline on
        whichever thread RESOLVES this ref — a task-pool worker, the
        transport event loop, or the caller itself when the ref is
        already done.  Callbacks must therefore be quick and non-blocking
        (a slow callback on the event loop stalls every connection), and
        must not assume any particular thread identity.  Pass
        ``executor`` to move the work — e.g. the transport decodes
        received payloads on its codec pool rather than the event loop.
        """
        out = LocalRef()

        def _run(value: Any) -> None:
            try:
                out.set_result(fn(value))
            # fedlint: disable=FED004 — transferred, not swallowed: KI/SE resolve the chained LocalRef and re-raise at resolve()
            except BaseException as e:
                out.set_exception(e)

        def _cb(ref: "LocalRef") -> None:
            try:
                exc = ref.exception()
            # fedlint: disable=FED004 — transferred, not swallowed: the cancellation/KI resolves the chained ref and re-raises at resolve()
            except BaseException as e:
                # exception() on a CANCELLED future raises instead of
                # returning (e.g. shutdown cancelling a parked recv) —
                # the chained ref must still resolve or callers hang.
                out.set_exception(e)
                return
            if exc is not None:
                out.set_exception(exc)
                return
            if executor is not None:
                try:
                    executor.submit(_run, ref.resolve())
                # fedlint: disable=FED004 — transferred, not swallowed: a shutdown-pool submit failure resolves the chained ref
                except BaseException as e:  # pool shut down mid-flight
                    out.set_exception(e)
            else:
                _run(ref.resolve())

        self.add_done_callback(_cb)
        return out

    def __repr__(self) -> str:  # pragma: no cover
        return f"LocalRef(done={self._future.done()})"


def resolve_local_refs(refs: Sequence[LocalRef], timeout: Optional[float] = None):
    return [r.resolve(timeout=timeout) for r in refs]


def is_local_ref(obj: Any) -> bool:
    return isinstance(obj, LocalRef)


def is_local_refs(objects: Any) -> bool:
    """True if ``objects`` is a LocalRef or a non-empty list of LocalRefs.

    Parity with reference ``fed/utils.py:64-74`` (``is_ray_object_refs``)
    used for the ``fed.get`` passthrough path.
    """
    if isinstance(objects, LocalRef):
        return True
    if isinstance(objects, list) and objects:
        return all(isinstance(o, LocalRef) for o in objects)
    return False


def _materialize_arg(arg: Any) -> Any:
    """Resolve a *top-level* argument if it is a LocalRef.

    Containers are not traversed: a LocalRef nested inside a list stays a
    LocalRef, which the task body resolves via ``fed.get`` (matches Ray's
    top-level-only ObjectRef resolution that the reference depends on).
    """
    if isinstance(arg, LocalRef):
        return arg.resolve()
    return arg


def _call(fn: Callable, args: tuple, kwargs: dict, rec, party, name: str, t_submit: float) -> Any:
    """Materialise the top-level arguments, run the body and fence its result
    for the threads it is handed to.

    With the flight recorder armed (``rec``, read once at submission) the
    call leaves three spans with ``detail["fn"]`` naming the body:
    ``exec.args`` (the wait for the inputs), ``exec.call`` (the body on the
    host, with the time it queued in the pool) and ``exec.device`` (the
    body's return until the card has run the work its tensors depend on,
    closed by the recorder's watcher thread)."""
    if rec is None:
        value = fn(*(_materialize_arg(a) for a in args),
                   **{k: _materialize_arg(v) for k, v in kwargs.items()})
        fence_for_handoff(value)
        return value
    detail = {"fn": name}
    t_args = time.time()
    resolved_args = tuple(_materialize_arg(a) for a in args)
    resolved_kwargs = {k: _materialize_arg(v) for k, v in kwargs.items()}
    t_call = time.time()
    rec.emit("exec.args", party=party, t_start=t_args, dur_s=t_call - t_args, detail=detail)
    call_detail = {"fn": name, "queued_ms": round((t_args - t_submit) * 1e3, 3)}
    try:
        value = fn(*resolved_args, **resolved_kwargs)
    except BaseException:
        rec.emit("exec.call", party=party, t_start=t_call, dur_s=time.time() - t_call,
                 outcome="error", detail=call_detail)
        raise
    t_ret = time.time()
    rec.emit("exec.call", party=party, t_start=t_call, dur_s=t_ret - t_call, detail=call_detail)
    events = fence_for_handoff(value, record_events=True)
    if events:
        rec.watch(events, "exec.device", t_ret, party=party, detail=detail)
    return value


class TaskExecutor:
    """Thread-pool dispatch of party-local work.

    ``bind_runtime_fn`` is called in each worker thread before executing a
    task body so that ``fed.*`` calls made *inside* tasks see the right
    per-party runtime (required for multi-party-in-one-process simulation
    and for ``fed.get`` inside task bodies).
    """

    def __init__(
        self,
        max_workers: int = 16,
        thread_name_prefix: str = "rayfed-worker",
        bind_runtime_fn: Optional[Callable[[], None]] = None,
        party: Optional[str] = None,
    ) -> None:
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix=thread_name_prefix
        )
        self._bind_runtime_fn = bind_runtime_fn
        self._party = party  # stamped on the flight recorder's exec.* spans
        self._shutdown = False

    def submit(
        self,
        fn: Callable,
        args: tuple,
        kwargs: dict,
        num_returns: int = 1,
        name: Optional[str] = None,
    ):
        """Submit ``fn(*args, **kwargs)``; returns LocalRef or list of them.

        ``name`` (defaults to the callable's ``__name__``) is stamped
        onto the worker thread for the task's duration and into the
        exception log line, so a traceback or a thread dump of a hung
        party names the fed task instead of an anonymous
        ``rayfed-worker-3``.
        """
        if self._shutdown:
            raise RuntimeError("TaskExecutor has been shut down")
        task_name = name or getattr(fn, "__name__", None) or repr(fn)
        rec = telemetry.active()
        t_submit = time.time() if rec is not None else 0.0

        def _run():
            if self._bind_runtime_fn is not None:
                self._bind_runtime_fn()
            thread = threading.current_thread()
            base_name = thread.name
            thread.name = f"{base_name}[{task_name}]"
            try:
                # The result leaves this thread: its CUDA work is ordered
                # before the transport's copies (platform.py).
                return _call(fn, args, kwargs, rec, self._party, task_name, t_submit)
            except BaseException as e:
                # The exception also travels to the LocalRef; this log
                # line is the one place that pairs it with the task name.
                logger.debug("fed task %r failed: %r", task_name, e)
                raise
            finally:
                thread.name = base_name

        future = self._pool.submit(_run)
        if num_returns == 1:
            return LocalRef(future)
        return _split_future(future, num_returns)

    def submit_resolved(self, fn: Callable, *args, **kwargs) -> LocalRef:
        """Submit without argument materialization (internal use)."""

        def _run():
            if self._bind_runtime_fn is not None:
                self._bind_runtime_fn()
            return fn(*args, **kwargs)

        return LocalRef(self._pool.submit(_run))

    def shutdown(self, wait: bool = True) -> None:
        self._shutdown = True
        self._pool.shutdown(wait=wait)


class CommsLane(TaskExecutor):
    """A dedicated single-thread lane for cross-party comms orchestration.

    The pipelined round engine (:mod:`rayfed_tpu_torch.fl.overlap`) hands each
    round's push + aggregation to this lane and immediately returns to
    local compute.  The lane is deliberately NOT the task executor and
    NOT the transport codec pool:

    - Task-pool threads run training bodies; a blocking multi-second
      ``streaming_aggregate`` wait parked there would steal a worker
      from (and at pool saturation, deadlock behind) the very training
      work the overlap is supposed to hide it under.
    - Codec-pool threads encode/decode payload bytes; the aggregation
      wait must be free to *consume* codec work, so waiting on the codec
      pool could self-deadlock.

    One thread, not a pool: round *k+1*'s aggregate depends on round
    *k*'s anyway (the DGA correction consumes it), so comms jobs are
    inherently serial — a single lane makes that ordering structural
    instead of relying on callers to chain futures.

    ``bind_runtime_fn`` is invoked on the lane thread before each job so
    ``fed.*``/``get_runtime()`` calls made inside resolve to the owning
    party's runtime (the same contract as :class:`TaskExecutor`).

    Implementation-wise this IS a one-worker :class:`TaskExecutor` — the
    isolation argument above is about not sharing the *instances*, not
    about needing different machinery — so it subclasses rather than
    duplicating the pool/bind/shutdown plumbing.
    """

    def __init__(
        self,
        name: str = "rayfed-comms",
        bind_runtime_fn: Optional[Callable[[], None]] = None,
    ) -> None:
        super().__init__(
            max_workers=1, thread_name_prefix=name,
            bind_runtime_fn=bind_runtime_fn,
        )

    def submit(self, fn: Callable, *args, **kwargs) -> LocalRef:
        """Queue ``fn(*args, **kwargs)`` on the lane; returns a LocalRef.

        (Simpler signature than :meth:`TaskExecutor.submit` — lane jobs
        pass their arguments pre-resolved and need no name stamping.)
        """
        if self._shutdown:
            raise RuntimeError("CommsLane has been shut down")
        return self.submit_resolved(fn, *args, **kwargs)


def _split_future(
    future: concurrent.futures.Future, num_returns: int
) -> list[LocalRef]:
    """Fan a single future producing a sequence into ``num_returns`` refs."""
    children = [LocalRef() for _ in range(num_returns)]

    def _distribute(parent: concurrent.futures.Future) -> None:
        exc = parent.exception()
        if exc is not None:
            for child in children:
                child.set_exception(exc)
            return
        values = parent.result()
        try:
            values = list(values)
        except TypeError:
            for child in children:
                child.set_exception(
                    TypeError(
                        f"task declared num_returns={num_returns} but returned "
                        f"non-iterable {type(values).__name__}"
                    )
                )
            return
        if len(values) != num_returns:
            for child in children:
                child.set_exception(
                    ValueError(
                        f"task declared num_returns={num_returns} but returned "
                        f"{len(values)} values"
                    )
                )
            return
        for child, value in zip(children, values):
            child.set_result(value)

    future.add_done_callback(_distribute)
    return children


class ActorInstance:
    """A party-local stateful actor: one object + one serial executor.

    Method calls run one-at-a-time in submission order on a dedicated
    thread, reproducing Ray's default actor concurrency semantics.  State
    (e.g. model params as CUDA ``torch.Tensor``s) stays on-device between
    calls — no object-store round trips.
    """

    def __init__(
        self,
        cls: type,
        cls_args: tuple,
        cls_kwargs: dict,
        bind_runtime_fn: Optional[Callable[[], None]] = None,
        name: str = "actor",
        party: Optional[str] = None,
    ) -> None:
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"rayfed-actor-{name}"
        )
        self._bind_runtime_fn = bind_runtime_fn
        self._cls_name = getattr(cls, "__name__", "actor")
        self._party = party  # stamped on the flight recorder's exec.* spans
        self._instance: Any = None
        self._killed = False
        self._lock = threading.Lock()

        def _construct():
            if self._bind_runtime_fn is not None:
                self._bind_runtime_fn()
            resolved_args = tuple(_materialize_arg(a) for a in cls_args)
            resolved_kwargs = {k: _materialize_arg(v) for k, v in cls_kwargs.items()}
            self._instance = cls(*resolved_args, **resolved_kwargs)
            return None

        self._ready_ref = LocalRef(self._pool.submit(_construct))

    @property
    def ready_ref(self) -> LocalRef:
        return self._ready_ref

    def call_method(
        self, method_name: str, args: tuple, kwargs: dict, num_returns: int = 1
    ):
        with self._lock:
            if self._killed:
                raise RuntimeError("actor has been killed")
            rec = telemetry.active()
            t_submit = time.time() if rec is not None else 0.0

            def _run():
                if self._bind_runtime_fn is not None:
                    self._bind_runtime_fn()
                # Surface constructor failure on first method call.
                self._ready_ref.resolve()
                return _call(
                    getattr(self._instance, method_name), args, kwargs, rec,
                    self._party, f"{self._cls_name}.{method_name}", t_submit,
                )

            future = self._pool.submit(_run)
        if num_returns == 1:
            return LocalRef(future)
        return _split_future(future, num_returns)

    def kill(self) -> None:
        with self._lock:
            self._killed = True
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._instance = None
