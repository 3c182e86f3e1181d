"""PERUSE — request-lifecycle introspection events.

Port of ``ompi_tpu/core/peruse.py`` (reference: peruse.c — the PERUSE
spec's event hooks on the request lifecycle: activate, match, transfer
start/end, complete; tools subscribe per event to watch the p2p engine
without interposing). The event points are raised by the request layer
and the ob1 matching engine; subscribers are plain callables.
"""

from __future__ import annotations

import enum
import itertools
import threading
from typing import Any, Callable

from .logging import get_logger

logger = get_logger("peruse")


class PeruseEvent(enum.Enum):
    REQ_ACTIVATE = "req_activate"  # request created/started
    REQ_MATCH = "req_match"  # recv matched a send (ob1 matching)
    REQ_XFER_BEGIN = "req_xfer_begin"  # payload movement begins
    REQ_COMPLETE = "req_complete"  # request completed
    QUEUE_UNEXPECTED = "queue_unexpected"  # send parked unmatched
    QUEUE_POSTED = "queue_posted"  # recv parked unmatched


_subs: dict[int, tuple[PeruseEvent, Callable]] = {}
_ids = itertools.count(1)
_lock = threading.Lock()
_active = 0  # fast path: skip fire() entirely with no subscribers


def subscribe(event: PeruseEvent, cb: Callable[..., None]) -> int:
    global _active
    with _lock:
        sid = next(_ids)
        _subs[sid] = (event, cb)
        _active += 1
        return sid


def unsubscribe(sid: int) -> None:
    global _active
    with _lock:
        if _subs.pop(sid, None) is not None:
            _active -= 1


def clear() -> None:
    global _active
    with _lock:
        _subs.clear()
        _active = 0


def fire(event: PeruseEvent, **info: Any) -> None:
    if not _active:
        return
    with _lock:
        targets = [cb for ev, cb in _subs.values() if ev == event]
    for cb in targets:
        try:
            cb(event=event, **info)
        except Exception:
            logger.exception("peruse subscriber failed for %s", event)
