"""The port's lock-order sanitizer (``rayfed_tpu_torch/_sanitizer.py``).

The JAX package's sanitizer cases (``tests/test_fedlint.py``) run against
the port's copy: for each test, whatever sanitizer this process runs under
steps aside and the copy installs alone.  Then, in subprocesses under
``RAYFED_SANITIZE=1``, both packages are imported in either order (and the
port alone): one sanitizer tracks each lock, at its true construction site,
and an AB/BA interleave raises exactly one ``LockOrderError``.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def sanitizer():
    from rayfed_tpu_torch import _sanitizer

    saved = (threading.Lock, threading.RLock, threading.Condition, _sanitizer._installed)
    threading.Lock = _sanitizer._REAL_LOCK
    threading.RLock = _sanitizer._REAL_RLOCK
    threading.Condition = _sanitizer._REAL_CONDITION
    _sanitizer._installed = False
    assert _sanitizer.install()
    _sanitizer.reset()
    yield _sanitizer
    _sanitizer.reset()
    _sanitizer.uninstall()
    threading.Lock, threading.RLock, threading.Condition, _sanitizer._installed = saved


def _tracked_locks(n):
    """threading.Lock() from THIS file — a repo path, so tracked."""
    return [threading.Lock() for _ in range(n)]


def test_sanitizer_tracks_repo_locks_only(sanitizer):
    lk = threading.Lock()
    assert type(lk).__name__ == "SanitizedLock"


def test_sanitizer_raises_on_ab_ba_interleave(sanitizer):
    a, b = _tracked_locks(2)
    with a:
        with b:
            pass
    with pytest.raises(sanitizer.LockOrderError) as exc_info:
        with b:
            with a:
                pass
    msg = str(exc_info.value)
    assert "lock-order cycle" in msg and "acquired-before" in msg


def test_sanitizer_silent_on_consistent_ordering(sanitizer):
    a, b, c = _tracked_locks(3)
    for _ in range(3):
        with a:
            with b:
                with c:
                    pass
        with b:
            with c:
                pass


def test_sanitizer_raises_on_cross_thread_interleave(sanitizer):
    a, b = _tracked_locks(2)
    with a:
        with b:
            pass

    failures = []
    step = threading.Event()

    def reversed_order():
        try:
            with b:
                with a:
                    pass
        except sanitizer.LockOrderError as e:
            failures.append(e)
        finally:
            step.set()

    t = threading.Thread(target=reversed_order)
    t.start()
    assert step.wait(timeout=10)
    t.join(timeout=10)
    assert len(failures) == 1


def test_sanitizer_guard_lock_suppresses_false_positive(sanitizer):
    g, a, b = _tracked_locks(3)
    with g:
        with a:
            with b:
                pass
    with g:
        with b:
            with a:  # serialized by g on both sides — benign
                pass


def test_sanitizer_unguarded_recurrence_of_guarded_cycle_raises(sanitizer):
    # Both orderings first observed under a common guard (silent), then
    # one ordering recurs WITHOUT the guard: the weakened edge now forms
    # a real cycle (this thread holding only `a` can deadlock against a
    # thread holding guard+`b`) and must raise at that acquire.
    g, a, b = _tracked_locks(3)
    with g:
        with a:
            with b:
                pass
    with g:
        with b:
            with a:
                pass
    with pytest.raises(sanitizer.LockOrderError):
        with a:
            with b:
                pass


def test_sanitizer_reentrant_rlock_records_no_edge(sanitizer):
    rl = threading.RLock()
    assert type(rl).__name__ == "SanitizedRLock"
    other, = _tracked_locks(1)
    with rl:
        with rl:  # re-entry: no self-edge, no crash
            with other:
                pass
    with rl:
        with other:
            pass


def test_sanitizer_condition_participates(sanitizer):
    cond = threading.Condition()
    hit = []

    def waiter():
        with cond:
            while not hit:
                cond.wait(timeout=5)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cond:
        hit.append(1)
        cond.notify_all()
    t.join(timeout=10)
    assert not t.is_alive()
    # The condition's internal RLock is tracked; ordering vs another
    # lock in both directions must raise.
    lk, = _tracked_locks(1)
    with cond:
        with lk:
            pass
    with pytest.raises(sanitizer.LockOrderError):
        with lk:
            with cond:
                pass


def test_sanitizer_cross_thread_release_keeps_books(sanitizer):
    # Plain Locks may legally be acquired on one thread and released on
    # another (signaling idiom).  The release must scrub the ACQUIRER's
    # held list — a stale entry would stamp bogus acquired-before edges
    # onto everything this thread locks next.
    sig = threading.Lock()
    sig.acquire()
    released = threading.Event()

    def release_elsewhere():
        sig.release()
        released.set()

    t = threading.Thread(target=release_elsewhere)
    t.start()
    assert released.wait(10)
    t.join(10)
    assert sig._uid not in sanitizer._TLS.held


def test_sanitizer_cross_thread_release_race_keeps_new_holder_tracked(sanitizer):
    # B releasing A's lock while C is parked in acquire: the scrub must
    # hit A's entry (pop BEFORE the real release) — after the release,
    # C wins the lock and must own the bookkeeping entry.
    s = threading.Lock()
    c_acquired = threading.Event()
    c_may_release = threading.Event()
    seen = {}

    s.acquire()  # main thread is "A"

    def c_thread():
        s.acquire()  # parks until B releases A's hold
        seen["held"] = list(sanitizer._TLS.held)
        c_acquired.set()
        c_may_release.wait(10)
        s.release()

    tc = threading.Thread(target=c_thread)
    tc.start()
    time.sleep(0.1)  # let C park inside the real acquire
    tb = threading.Thread(target=s.release)  # "B": cross-thread release
    tb.start()
    tb.join(10)
    assert c_acquired.wait(10)
    assert s._uid in seen["held"]  # the NEW holder is tracked
    assert s._uid not in sanitizer._TLS.held  # A's entry was scrubbed
    c_may_release.set()
    tc.join(10)
    assert not tc.is_alive()


def test_sanitizer_gc_forgets_dead_locks(sanitizer):
    import gc

    a = threading.Lock()
    b = threading.Lock()
    with a:
        with b:
            pass
    label_a = repr(a).rsplit(" as ", 1)[1].rstrip(">")
    snap = sanitizer.graph_snapshot()
    assert label_a in snap
    del a, b
    gc.collect()
    snap = sanitizer.graph_snapshot()
    assert label_a not in snap
    assert not any(label_a in targets for targets in snap.values())


def test_sanitizer_forget_is_finalizer_safe(sanitizer):
    # forget() runs from weakref finalizers, which cyclic GC can fire on
    # a thread ALREADY inside the graph lock — it must never take that
    # lock itself (self-deadlock), only queue for the next drain.
    import gc

    a = threading.Lock()
    label_a = repr(a).rsplit(" as ", 1)[1].rstrip(">")
    with a:
        pass
    graph = sanitizer._GRAPH
    with graph._lock:  # simulate GC firing while the graph lock is held
        del a
        gc.collect()   # finalizer must return without touching the lock
    assert label_a not in sanitizer.graph_snapshot()  # drained afterwards


def test_sanitizer_condition_restore_survives_order_report(sanitizer, monkeypatch):
    # If the cycle check trips at a Condition.wait wakeup, the lock must
    # already be RE-ACQUIRED when the error propagates — otherwise the
    # enclosing `with cond:` exit dies with 'cannot release un-acquired
    # lock' and masks the report.
    from rayfed_tpu_torch._sanitizer import LockOrderError, _TrackedBase

    cond = threading.Condition()
    rl = cond._lock
    rl.acquire()
    state = rl._release_save()
    assert not rl._is_owned()

    def boom(self):
        raise LockOrderError("injected cycle report")

    monkeypatch.setattr(_TrackedBase, "_before_blocking_acquire", boom)
    with pytest.raises(LockOrderError, match="injected"):
        rl._acquire_restore(state)
    monkeypatch.undo()
    assert rl._is_owned()  # restored despite the report
    rl.release()


def test_sanitizer_nonblocking_acquire_never_raises(sanitizer):
    a, b = _tracked_locks(2)
    with a:
        with b:
            pass
    with b:
        assert a.acquire(blocking=False)  # trylock cannot deadlock
        a.release()



def test_sanitizer_enabled_for_the_port():
    """Under RAYFED_SANITIZE=1 (tests/conftest.py exports it) a process that
    imported the port runs under a sanitizer: the port's copy, or the JAX
    package's when that one installed first."""
    from rayfed_tpu_torch import _sanitizer

    if os.environ.get("RAYFED_SANITIZE") != "1":  # pragma: no cover - explicit opt-out run
        pytest.skip("RAYFED_SANITIZE disabled for this run")
    assert _sanitizer.installed() or _sanitizer._patched_by_another()


# -- both packages in one process ---------------------------------------------

def _ab_ba_probe():
    """Run in a subprocess after the imports under test: two locks built
    here (a tracked site), ordered AB then BA; prints what each sanitizer
    recorded."""
    import rayfed_tpu_torch._sanitizer as port

    ref = sys.modules.get("rayfed_tpu._sanitizer")
    a, b = threading.Lock(), threading.Lock()
    errors = []
    with a:
        with b:
            pass
    for _ in range(2):  # the unresolved cycle re-raises on every recurrence
        try:
            with b:
                with a:
                    pass
        except RuntimeError as e:
            errors.append(type(e).__module__)
    graphs = {"port": port.graph_snapshot()}
    if ref is not None:
        graphs["ref"] = ref.graph_snapshot()
    labels = [k for g in graphs.values() for k in g]
    print(json.dumps({
        "port_installed": port.installed(),
        "ref_installed": None if ref is None else ref.installed(),
        "errors": errors,
        "wrapper": type(a).__module__,
        "probe_labels": [k for k in labels if "test_torch_sanitizer.py" in k],
        "sanitizer_labels": [k for k in labels if k.split(":")[0] in (
            "rayfed_tpu/_sanitizer.py", "rayfed_tpu_torch/_sanitizer.py")],
        "a_label": repr(a).rsplit(" as ", 1)[-1].rstrip(">"),
    }))


_PROBE = """
import sys
for name in sys.argv[1:]:
    __import__(name)
from tests.test_torch_sanitizer import _ab_ba_probe
_ab_ba_probe()
"""


def _probe(*imports):
    env = dict(os.environ, RAYFED_SANITIZE="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _PROBE, *imports], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("order,installed,wrapper", [
    (("rayfed_tpu", "rayfed_tpu_torch"), {"ref_installed": True, "port_installed": False},
     "rayfed_tpu._sanitizer"),
    (("rayfed_tpu_torch", "rayfed_tpu"), {"ref_installed": True, "port_installed": True},
     "rayfed_tpu._sanitizer"),
    (("rayfed_tpu_torch",), {"ref_installed": None, "port_installed": True},
     "rayfed_tpu_torch._sanitizer"),
], ids=["reference_first", "port_first", "port_alone"])
def test_each_lock_is_tracked_once_whatever_the_import_order(order, installed, wrapper):
    """Reference first: the port's copy stands down.  Port first: the JAX
    package's sanitizer wraps the port's factories, which hand it real
    locks, so the lock is wrapped once and labelled at its site, not at
    a sanitizer's.  Each recurrence of the reversed order raises once."""
    rep = _probe(*order)
    assert {k: rep[k] for k in installed} == installed
    assert rep["wrapper"] == wrapper
    assert rep["errors"] == [wrapper, wrapper]
    assert rep["sanitizer_labels"] == []
    # Two locks, one edge recorded (a -> b), under one label each.
    assert rep["probe_labels"] == [rep["a_label"]]
