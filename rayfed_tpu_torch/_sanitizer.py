"""Runtime lock-order sanitizer — the dynamic half of fedlint FED007.

A copy of the JAX package's sanitizer (it imports no JAX), installed by
``rayfed_tpu_torch/__init__.py`` from the same ``RAYFED_SANITIZE=1``, so a
party process that imports only this package runs under it too.  Two
processes import both packages, in either order, and each lock must be
tracked once:

- the JAX package's sanitizer installed first: this copy stands down
  (:func:`install` returns False) and takes the real primitives from
  ``_thread``, never the patched ``threading`` names;
- this copy installed first: the JAX package's then captures this copy's
  factories as its "real" primitives, so a construction site inside
  either sanitizer module is untracked here (the lock is tracked once,
  by the sanitizer that wrapped it, at its true site).

The static pass (``tool/fedlint`` FED007) sees only *lexically* nested
``with <lock>:`` pairs.  The orderings that actually bite are dynamic:
a callback fired while a lock is held takes another lock three modules
away, two subsystems nest the same pair in opposite orders on different
threads.  This module catches those at test time:

- enabled via ``RAYFED_SANITIZE=1`` (``tests/conftest.py`` exports it,
  so every tier-1 test — party subprocesses included, env is inherited —
  runs under it); **near-zero cost when disabled**: nothing is patched.
- :func:`install` wraps ``threading.Lock`` / ``threading.RLock`` /
  ``threading.Condition`` *construction*.  Only locks constructed by
  code inside this repo are tracked — jax/stdlib/grpc locks get the
  real primitive untouched, keeping overhead bounded and the graph
  free of third-party noise.
- every tracked acquire records the per-thread acquisition stack and
  adds an acquired-before edge (previous innermost held → acquiring)
  to one process-global graph; the edge that closes a cycle raises
  :class:`LockOrderError` **at the moment the second ordering appears**
  — before blocking, i.e. before the interleaving that would actually
  deadlock has to occur.
- guard-lock refinement: orderings that disagree but always run under a
  common outer lock are serialized by that guard and not reported (the
  classic false positive of naive detectors).

The wrappers preserve ``threading.Condition`` compatibility
(``_is_owned`` / ``_release_save`` / ``_acquire_restore``), re-entrant
RLock semantics (re-acquiring a held lock records no edge), and treat
non-blocking ``acquire(blocking=False)`` as unable to deadlock (held
tracking only, no cycle check).
"""

from __future__ import annotations

import _thread
import os
import sys
import threading
import traceback
import weakref
from typing import Dict, List, Optional

ENV_VAR = "RAYFED_SANITIZE"

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The real primitives, from ``_thread``: another sanitizer may already
# have patched the ``threading`` names.  A real Condition is a class; a
# patched one is a factory, whose product (built from a stdlib site, so
# untracked) is still of the real class.
_REAL_LOCK = _thread.allocate_lock
_REAL_RLOCK = _thread.RLock
_REAL_CONDITION = (
    threading.Condition if isinstance(threading.Condition, type)
    else type(threading.Event()._cond)
)
# What ``threading.Lock`` is when nobody patched it (the name of the type
# differs between Python versions).
_UNPATCHED_LOCKS = frozenset(
    f for f in (_thread.allocate_lock, getattr(_thread, "LockType", None))
    if f is not None
)
# Construction sites that are sanitizer plumbing, not repo code: this
# module and the JAX package's copy.
_SANITIZER_FILES = frozenset((
    os.path.abspath(__file__),
    os.path.join(_REPO_ROOT, "rayfed_tpu", "_sanitizer.py"),
))


class LockOrderError(RuntimeError):
    """Two tracked locks were acquired in conflicting orders.

    Raised at the acquire that would *create* the cycle — the report
    names both orderings with the thread and stack that recorded the
    first one, so the fix (pick one global order) is mechanical.
    """


class _Edge:
    __slots__ = ("guards", "thread", "stack")

    def __init__(self, guards: frozenset, thread: str, stack: str) -> None:
        self.guards = guards
        self.thread = thread
        self.stack = stack


class _Graph:
    """Process-global acquired-before graph.

    Guarded by a REAL (untracked) lock; no user code ever runs while it
    is held, so the sanitizer cannot deadlock the program it watches.
    """

    def __init__(self) -> None:
        self._lock = _REAL_LOCK()
        # edge uid→uid2 means "uid held when uid2 was acquired".
        self._edges: Dict[int, Dict[int, _Edge]] = {}
        self._labels: Dict[int, str] = {}
        self._uid = 0
        # uids of GC'd locks, appended by weakref finalizers.  A
        # finalizer can fire via cyclic GC triggered by an allocation
        # made INSIDE `with self._lock` (record's frozensets, stack
        # capture...) on the same thread — taking the non-reentrant
        # lock there would self-deadlock, so finalizers only do a
        # lock-free list.append and the next graph operation drains it.
        self._pending_forget: List[int] = []

    def new_uid(self, label: str) -> int:
        with self._lock:
            self._uid += 1
            self._labels[self._uid] = label
            return self._uid

    def label(self, uid: int) -> str:
        return self._labels.get(uid, f"<lock #{uid}>")

    def reset(self) -> None:
        with self._lock:
            self._drain_forgotten_locked()
            self._edges.clear()

    def forget(self, uid: int) -> None:
        """Mark a garbage-collected lock for removal from the graph.

        Per-object locks (one per FedObject, per connection, ...) would
        otherwise grow the graph without bound over a long sanitized
        soak.  Nothing is lost semantically: a dead instance can never
        participate in a future deadlock, and fresh instances get fresh
        uids.  MUST stay lock-free — called from a weakref finalizer,
        potentially mid-GC on a thread already inside ``self._lock``.
        """
        self._pending_forget.append(uid)

    def _drain_forgotten_locked(self) -> None:
        while self._pending_forget:
            uid = self._pending_forget.pop()
            self._labels.pop(uid, None)
            self._edges.pop(uid, None)
            for targets in self._edges.values():
                targets.pop(uid, None)

    def snapshot(self) -> Dict[str, List[str]]:
        with self._lock:
            self._drain_forgotten_locked()
            return {
                self.label(a): sorted(self.label(b) for b in bs)
                for a, bs in self._edges.items()
            }

    def record(self, prev: int, new: int, guards: frozenset,
               thread_name: str) -> None:
        """Add edge prev→new; raise LockOrderError if it closes an
        unguarded cycle.  The cycle check runs BEFORE the edge is
        stored and before the caller blocks on the real acquire."""
        with self._lock:
            self._drain_forgotten_locked()
            known = self._edges.setdefault(prev, {})
            existing = known.get(new)
            # The edge's effective guard set is the weakest seen across
            # occurrences — a later occurrence under FEWER guards can
            # turn a previously-serialized cycle into a real one, so the
            # cycle check re-runs whenever the set shrinks (an
            # unchanged/superset occurrence carries no new information).
            eff_guards = guards if existing is None \
                else existing.guards & guards
            if existing is not None and eff_guards == existing.guards:
                return
            path = self._find_path(new, prev)
            if path is not None:
                common = eff_guards
                for a, b in path:
                    common = common & self._edges[a][b].guards
                if not common:
                    # Raise WITHOUT storing: the cycle stays on record
                    # as unresolved, so every recurrence re-raises.
                    raise LockOrderError(self._render(prev, new, path,
                                                      thread_name))
            if existing is not None:
                existing.guards = eff_guards
            else:
                known[new] = _Edge(
                    eff_guards, thread_name,
                    "".join(
                        traceback.format_stack(sys._getframe(3), limit=5)
                    ),
                )

    def _find_path(self, start: int, goal: int) -> Optional[List]:
        """BFS start→goal over recorded edges; returns the edge list."""
        if start not in self._edges:
            return None
        seen = {start}
        frontier = [(start, [])]
        while frontier:
            node, path = frontier.pop(0)
            for nxt in self._edges.get(node, ()):
                if nxt == goal:
                    return path + [(node, nxt)]
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append((nxt, path + [(node, nxt)]))
        return None

    def _render(self, prev: int, new: int, path, thread_name: str) -> str:
        lines = [
            "lock-order cycle detected (RAYFED_SANITIZE): thread "
            f"{thread_name!r} is acquiring {self.label(new)} while "
            f"holding {self.label(prev)}, but the REVERSE ordering is "
            "already on record:",
        ]
        for a, b in path:
            e = self._edges[a][b]
            lines.append(
                f"  {self.label(a)} acquired-before {self.label(b)} "
                f"on thread {e.thread!r} at:\n{e.stack.rstrip()}"
            )
        lines.append(
            "pick one global acquisition order (or guard both orderings "
            "with a common outer lock)."
        )
        return "\n".join(lines)


_GRAPH = _Graph()
_TLS = threading.local()
_installed = False


def _held() -> List[int]:
    held = getattr(_TLS, "held", None)
    if held is None:
        held = _TLS.held = []
    return held


class _TrackedBase:
    """Shared acquire/release bookkeeping around a real primitive."""

    __slots__ = ("_inner", "_uid", "_owner_held", "__weakref__")

    def __init__(self, inner, label: str) -> None:
        self._inner = inner
        self._uid = _GRAPH.new_uid(label)
        # The held-list of the thread that last acquired this lock —
        # plain Locks may legally be RELEASED on a different thread
        # (signaling idiom), and the release must fix up the ACQUIRER's
        # bookkeeping, not the releaser's.
        self._owner_held: Optional[List[int]] = None
        # Bound memory: a GC'd lock leaves the global graph.
        weakref.finalize(self, _GRAPH.forget, self._uid)

    # -- ordering hooks ------------------------------------------------------

    def _before_blocking_acquire(self) -> None:
        # Snapshot: a cross-thread release (_pop's owner-list scrub) may
        # shrink the live list between the emptiness check and the
        # [-1] read — bookkeeping must never crash the acquiring thread.
        held = list(_held())
        if not held or self._uid in held:
            return  # first lock on this thread / re-entrant re-acquire
        _GRAPH.record(
            held[-1], self._uid,
            frozenset(held[:-1]),
            threading.current_thread().name,
        )

    def _push(self) -> None:
        held = _held()
        held.append(self._uid)
        self._owner_held = held

    def _pop(self) -> Optional[List[int]]:
        """Remove this lock's bookkeeping entry; returns the list it was
        removed from (for rollback), or None when no entry was found."""
        held = _held()
        # Out-of-order releases are legal for plain locks — remove the
        # LAST occurrence of this uid, wherever it sits.
        for i in range(len(held) - 1, -1, -1):
            if held[i] == self._uid:
                del held[i]
                return held
        # Released on a DIFFERENT thread than the acquirer (legal for
        # plain Locks): scrub the acquirer's held list instead, or every
        # later acquire on that thread would record bogus edges from
        # this stale entry.  Best-effort under the GIL; bookkeeping must
        # never crash the program it watches.
        owner = self._owner_held
        if owner is not None and owner is not held:
            try:
                for i in range(len(owner) - 1, -1, -1):
                    if owner[i] == self._uid:
                        del owner[i]
                        return owner
            except (IndexError, ValueError):  # pragma: no cover - racy scrub
                pass
        return None

    # -- lock protocol -------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if blocking:
            self._before_blocking_acquire()
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._push()
        return ok

    def release(self) -> None:
        # Order matters per subclass: plain Locks pop BEFORE the real
        # release (SanitizedLock overrides) — releasing first opens a
        # window where a racing acquirer overwrites _owner_held and the
        # cross-thread scrub deletes the NEW holder's entry.  RLocks
        # keep release-first: a cross-thread RLock release is illegal
        # and must raise from the inner lock WITHOUT any scrub running.
        self._inner.release()
        self._pop()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<sanitized {self._inner!r} as {_GRAPH.label(self._uid)}>"


class SanitizedLock(_TrackedBase):
    __slots__ = ()

    def release(self) -> None:
        # Pop while the lock is STILL HELD: after the real release a
        # blocked acquirer can win the lock and repoint _owner_held at
        # its own list before our cross-thread scrub runs, which would
        # strip the new holder's entry and leave the old one stale.
        removed_from = self._pop()
        try:
            self._inner.release()
        except BaseException:
            if removed_from is not None:  # release didn't happen: undo
                removed_from.append(self._uid)
            raise


class SanitizedRLock(_TrackedBase):
    """Tracked RLock — also speaks ``threading.Condition``'s private
    protocol so a repo ``Condition()`` tracks its underlying lock."""

    __slots__ = ()

    def _is_owned(self) -> bool:
        return self._inner._is_owned()

    def _release_save(self):
        # Condition.wait: full release regardless of recursion depth —
        # drop every held entry for this uid.
        held = _held()
        held[:] = [u for u in held if u != self._uid]
        return self._inner._release_save()

    def _acquire_restore(self, state) -> None:
        # Reacquire on wakeup blocks like a fresh acquire — but the
        # Condition's lock state must be RESTORED even when the order
        # check trips: raising un-held would make the enclosing `with
        # cond:` exit fail with 'cannot release un-acquired lock',
        # masking the cycle report.  So: restore first, then check (the
        # pre-push held list gives the same edges a fresh acquire would
        # record), and push in a finally so the bookkeeping matches the
        # actually-held lock even while the report propagates.
        self._inner._acquire_restore(state)
        try:
            self._before_blocking_acquire()
        finally:
            self._push()


def _caller_is_tracked(depth: int) -> bool:
    """True when the construction site is repo code (the packages, tests,
    bench) — third-party, stdlib and sanitizer construction sites get real
    locks."""
    try:
        frame = sys._getframe(depth)
    except ValueError:  # pragma: no cover - shallow stack
        return False
    filename = frame.f_code.co_filename
    return (
        filename.startswith(_REPO_ROOT)
        and "site-packages" not in filename
        and filename not in _SANITIZER_FILES
    )


def _site_label(depth: int) -> str:
    frame = sys._getframe(depth)
    rel = os.path.relpath(frame.f_code.co_filename, _REPO_ROOT)
    return f"{rel}:{frame.f_lineno}"


def _lock_factory():
    if _caller_is_tracked(2):
        return SanitizedLock(_REAL_LOCK(), _site_label(2))
    return _REAL_LOCK()


def _rlock_factory():
    if _caller_is_tracked(2):
        return SanitizedRLock(_REAL_RLOCK(), _site_label(2))
    return _REAL_RLOCK()


def _condition_factory(lock=None):
    # A repo Condition() with no explicit lock gets a TRACKED RLock, so
    # `with cond:` participates in the ordering graph (fl/streaming's
    # _cond is exactly this shape).
    if lock is None and _caller_is_tracked(2):
        lock = SanitizedRLock(_REAL_RLOCK(), _site_label(2) + " (Condition)")
    return _REAL_CONDITION(lock)


def _patched_by_another() -> bool:
    """True when some other sanitizer's factories stand in ``threading``."""
    return (
        threading.Lock not in _UNPATCHED_LOCKS
        or not isinstance(threading.Condition, type)
    ) and threading.Lock is not _lock_factory


def install() -> bool:
    """Patch lock construction process-wide.  Idempotent.  Call BEFORE
    the modules whose locks you want tracked are imported (the package's
    ``__init__`` does, when ``RAYFED_SANITIZE=1``).  Returns False, and
    patches nothing, when this copy or another sanitizer is installed."""
    global _installed
    if _installed or _patched_by_another():
        return False
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    threading.Condition = _condition_factory
    _installed = True
    return True


def uninstall() -> None:
    """Undo :func:`install`; leaves another sanitizer's patch in place."""
    global _installed
    if threading.Lock is _lock_factory:
        threading.Lock = _REAL_LOCK
        threading.RLock = _REAL_RLOCK
        threading.Condition = _REAL_CONDITION
    _installed = False


def installed() -> bool:
    return _installed


def reset() -> None:
    """Clear the acquired-before graph (test isolation)."""
    _GRAPH.reset()


def graph_snapshot() -> Dict[str, List[str]]:
    """{lock label: [labels it was acquired before]} — debugging aid."""
    return _GRAPH.snapshot()


def maybe_install_from_env() -> bool:
    return os.environ.get(ENV_VAR) == "1" and install()
