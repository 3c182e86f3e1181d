"""The progress engine: central polling loop for async completion.

Port of ``ompi_tpu/core/progress.py`` (reference:
opal/runtime/opal_progress.c:223-259 — an array of registered callbacks,
low-priority callbacks run every 8th call, yield when idle; components
register on demand).

In the port, device work is enqueued on a CUDA stream and a request
completes when the CUDA event recorded after it has passed
(``event.query()``). The engine pumps host-side state machines and the
predicates of timed waits: ``progress_until`` drives a request's
``_poll`` until it completes or the timeout lapses, one thread pumping
while other waiters sleep on completion notifications. The heartbeat seam
(``set_heartbeat``) stays unset until the health plane is ported.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable

# Reference constant: low-priority callbacks every 8th call
# (opal_progress.c:240-245).
LOW_PRIORITY_PERIOD = 8

ProgressFn = Callable[[], int]  # returns number of "events" progressed

# Heartbeat hook stamped once per sweep (health/sentinel installs its
# beat() here via set_heartbeat — injection keeps core free of any
# health import). None = disabled; the cost is one attribute load.
_heartbeat: Callable[[], None] | None = None


def set_heartbeat(fn: Callable[[], None] | None) -> None:
    """Install (or clear, with None) the per-sweep heartbeat hook."""
    global _heartbeat
    _heartbeat = fn


class ProgressEngine:
    def __init__(self) -> None:
        self._callbacks: list[ProgressFn] = []
        self._low_priority: list[ProgressFn] = []
        self._lock = threading.RLock()
        self._call_count = 0
        # multi-waiter coordination (reference: wait_sync.h): one thread
        # pumps, the rest sleep on completion notifications. Reentrant:
        # a callback's nested wait must still be able to pump.
        self._pumper = threading.RLock()
        self._wait_cv = threading.Condition()
        self._sleepers = 0  # waiters asleep on the condition
        self._waiters = 0  # threads inside progress_until
        self._last_wake = 0.0

    def register(self, fn: ProgressFn, low_priority: bool = False) -> None:
        with self._lock:
            target = self._low_priority if low_priority else self._callbacks
            if fn not in target:
                target.append(fn)

    def unregister(self, fn: ProgressFn) -> None:
        with self._lock:
            if fn in self._callbacks:
                self._callbacks.remove(fn)
            if fn in self._low_priority:
                self._low_priority.remove(fn)

    def progress(self) -> int:
        """One sweep over registered callbacks; returns events completed."""
        hb = _heartbeat
        if hb is not None:
            hb()
        with self._lock:
            cbs = list(self._callbacks)
            self._call_count += 1
            run_low = (self._call_count % LOW_PRIORITY_PERIOD) == 0
            lows = list(self._low_priority) if run_low else []
        events = 0
        for fn in cbs:
            events += fn()
        for fn in lows:
            events += fn()
        return events

    def pump_once(self) -> int | None:
        """One sweep, unless a thread is waiting in ``progress_until``
        (it pumps for itself) or pumping (then None): a background
        pumper stands aside for the waiters instead of taking turns
        with them, which under the GIL would cost each of them a switch
        interval at every release."""
        if self._waiters or not self._pumper.acquire(blocking=False):
            return None
        try:
            return self.progress()
        finally:
            self._pumper.release()

    def notify_completion(self) -> None:
        """Wake sleeping waiters: a request completed (called from
        ``Request._complete``, the wait_sync 'signal' side)."""
        # Racy reads: a missed wake costs a sleeper at most its 2 ms tick.
        # The hot path (a completion a transfer) pays no lock when none
        # sleeps, and wakes the sleepers at most once a millisecond: each
        # wake takes the GIL from the pumper, which completes thousands
        # of requests a sweep on a training step.
        if self._sleepers:
            now = time.monotonic()
            if now - self._last_wake >= 1e-3:
                self._last_wake = now
                with self._wait_cv:
                    self._wait_cv.notify_all()

    def progress_until(
        self,
        predicate: Callable[[], bool],
        timeout: float | None = None,
    ) -> bool:
        """Drive the engine until predicate() or timeout. With several
        blocked threads ONE pumps the callbacks (yielding the scheduler
        between sweeps, reference: opal_progress's sched_yield idle
        path) while the others sleep on a condition variable that
        request completion notifies, bounded to 2 ms (the reference's
        multi-waiter wait_sync design). Parking the pumper on a
        transport's doorbell comes with the first transport that
        parks."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            self._waiters += 1
        try:
            return self._wait(predicate, deadline)
        finally:
            with self._lock:
                self._waiters -= 1

    def _wait(self, predicate, deadline) -> bool:
        while not predicate():
            if self._pumper.acquire(blocking=False):
                try:
                    self.progress()
                finally:
                    self._pumper.release()
                if predicate():
                    return True
                if deadline is not None and time.monotonic() >= deadline:
                    return False
                os.sched_yield()
            else:
                # someone else is pumping: sleep until a completion fires
                with self._wait_cv:
                    if not predicate():
                        self._sleepers += 1
                        try:
                            self._wait_cv.wait(timeout=0.002)
                        finally:
                            self._sleepers -= 1
                if predicate():
                    return True
                if deadline is not None and time.monotonic() >= deadline:
                    return False
        return True


ENGINE = ProgressEngine()


def progress() -> int:
    return ENGINE.progress()


def register(fn: ProgressFn, low_priority: bool = False) -> None:
    ENGINE.register(fn, low_priority)


def unregister(fn: ProgressFn) -> None:
    ENGINE.unregister(fn)
