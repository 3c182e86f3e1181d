"""The progress engine: central polling loop for async completion.

Port of ``ompi_tpu/core/progress.py`` (reference:
opal/runtime/opal_progress.c:223-259 — an array of registered callbacks,
low-priority callbacks run every 8th call, yield when idle; components
register on demand).

In the port, device work is enqueued on a CUDA stream and a request
completes when the CUDA event recorded after it has passed
(``event.query()``). The engine pumps host-side state machines and the
predicates of timed waits: ``progress_until`` drives a request's
``_poll`` until it completes or the timeout lapses. The heartbeat seam
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

    def notify_completion(self) -> None:
        """A request completed (called from ``Request._complete``, the
        wait_sync 'signal' side). The port's waiters never park:
        ``progress_until`` sweeps and yields, so there is no one to wake
        yet. Parking on a transport's doorbell, and this wake with it,
        come with the first transport that parks."""

    def progress_until(
        self,
        predicate: Callable[[], bool],
        timeout: float | None = None,
    ) -> bool:
        """Sweep the engine until predicate() or timeout, yielding the
        scheduler between sweeps (reference: opal_progress's
        sched_yield idle path). Parking on a transport's doorbell, and
        waking the other waiters, come with the first transport that
        parks."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not predicate():
            self.progress()
            if predicate():
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            os.sched_yield()
        return True


ENGINE = ProgressEngine()


def progress() -> int:
    return ENGINE.progress()


def register(fn: ProgressFn, low_priority: bool = False) -> None:
    ENGINE.register(fn, low_priority)


def unregister(fn: ProgressFn) -> None:
    ENGINE.unregister(fn)
