"""Send watchdog — delivery tracking + exit-on-failure.

Capability parity with reference ``fed/cleanup.py``: a background thread
drains the queue of in-flight send results; a failed send (False result or
exception) optionally SIGTERMs the process; a monitor thread joins the
main thread so pending sends are flushed at interpreter exit; and
``wait_sending`` blocks shutdown until the queue is drained.

Unlike the reference's module globals, state lives on a per-Runtime
:class:`CleanupManager` so multiple in-process parties don't share a queue.
"""

from __future__ import annotations

import logging
import os
import queue
import signal
import threading
from typing import Optional, Union

from rayfed_tpu_torch.executor import LocalRef

logger = logging.getLogger(__name__)

_SENTINEL = object()


class CleanupManager:
    def __init__(self, exit_on_failure_sending: bool = False) -> None:
        self._q: "queue.Queue[Union[LocalRef, object]]" = queue.Queue()
        self._exit_on_failure = exit_on_failure_sending
        self._check_thread: Optional[threading.Thread] = None
        self._monitor_thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def set_exit_on_failure_sending(self, flag: bool) -> None:
        self._exit_on_failure = flag

    @property
    def check_thread_alive(self) -> bool:
        t = self._check_thread
        return t is not None and t.is_alive()

    def _signal_exit(self) -> None:
        os.kill(os.getpid(), signal.SIGTERM)

    def _check_sending_objs(self) -> None:
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                break
            assert isinstance(item, LocalRef)
            try:
                res = item.resolve()
            except Exception as e:
                logger.warning("Failed to send %s with error: %s", item, e)
                res = False
            if not res and self._exit_on_failure:
                logger.warning("Signal self to exit.")
                self._signal_exit()
                break
        logger.debug("Check sending thread exited.")

    def _main_thread_monitor(self) -> None:
        threading.main_thread().join()
        self.notify_to_exit()

    def start(self) -> None:
        with self._lock:
            if self._check_thread is None or not self._check_thread.is_alive():
                self._check_thread = threading.Thread(
                    target=self._check_sending_objs, name="rayfed-send-watchdog"
                )
                self._check_thread.start()
            if self._monitor_thread is None or not self._monitor_thread.is_alive():
                self._monitor_thread = threading.Thread(
                    target=self._main_thread_monitor,
                    name="rayfed-main-monitor",
                    daemon=True,
                )
                self._monitor_thread.start()

    def push_to_sending(self, ref: LocalRef) -> None:
        self.start()
        self._q.put(ref)

    def notify_to_exit(self) -> None:
        self._q.put(_SENTINEL)

    def wait_sending(self) -> None:
        """Block until every tracked send completed (ref ``cleanup.py:115-119``)."""
        with self._lock:
            thread = self._check_thread
        if thread is not None and thread.is_alive():
            self.notify_to_exit()
            thread.join()
        with self._lock:
            self._check_thread = None
