"""Request lifecycle: nonblocking-operation handles with wait/test.

Port of ``ompi_tpu/core/request.py`` (reference: ompi/request/request.h,
req_wait.c:92-141; test/wait{any,some,all} in req_test.c/req_wait.c;
generalized requests in grequest.c; persistent requests via ``start``,
pml.h:292): ``Status``, ``RequestState``, ``Request``,
``CompletedRequest``, ``GeneralizedRequest`` and the wait/test families.

A request completes either at creation (``CompletedRequest``) or when
its ``_poll`` sees its work finished; ``wait`` drives the progress
engine until then. A collective's request (``coll.framework
.PersistentColl``, ``DeviceRequest``) and a point-to-point receive
(``pml.ob1.RecvRequest``) hold the CUDA event recorded after their
work. ``_complete`` wakes the progress engine, fires peruse's
``REQ_COMPLETE`` and marks the result defined for the memchecker, as
the JAX package's does. Partitioned requests come with the
partitioned-communication slice; the sanitizer's tracker with the
analysis tools.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

from . import memchecker, peruse
from . import progress as _progress
from .errors import RequestError

ANY_SOURCE = -1
ANY_TAG = -1


@dataclass
class Status:
    """MPI_Status equivalent."""

    source: int = ANY_SOURCE
    tag: int = ANY_TAG
    error: Optional[BaseException] = None
    count: int = 0  # elements transferred
    cancelled: bool = False
    extra: dict = field(default_factory=dict)


class RequestState(enum.Enum):
    INACTIVE = "inactive"  # persistent request not started
    ACTIVE = "active"
    COMPLETE = "complete"
    CANCELLED = "cancelled"


class Request:
    """Base nonblocking-operation handle."""

    def __init__(self, *, persistent: bool = False) -> None:
        self.state = (
            RequestState.INACTIVE if persistent else RequestState.ACTIVE
        )
        self.persistent = persistent
        self.status = Status()
        self._result: Any = None
        self._callbacks: list[Callable[["Request"], None]] = []
        # Set once a some-family call has returned this request: MPI
        # Waitsome/Testsome deallocate completed requests (persistent
        # ones go inactive), so later calls must not re-harvest them.
        # The handle itself stays usable (result()/status) — start()
        # clears the mark for persistent reuse.
        self._harvested = False

    # -- completion -------------------------------------------------------

    def _poll(self) -> bool:
        """Advance host-side state; return True when complete. Subclasses
        driving host state machines override this."""
        return self.state == RequestState.COMPLETE

    def _complete(self, result: Any = None, status: Status | None = None):
        if self.state in (RequestState.COMPLETE, RequestState.CANCELLED):
            return
        self._result = result
        if status is not None:
            self.status = status
        self.state = RequestState.COMPLETE
        _progress.ENGINE.notify_completion()  # wake sleeping waiters
        peruse.fire(peruse.PeruseEvent.REQ_COMPLETE, request=self)
        if result is not None:
            memchecker.mark_defined(result)
        for cb in self._callbacks:
            cb(self)

    def on_complete(self, cb: Callable[["Request"], None]) -> None:
        if self.state == RequestState.COMPLETE:
            cb(self)
        else:
            self._callbacks.append(cb)

    # -- public API -------------------------------------------------------

    @property
    def done(self) -> bool:
        return self.state in (RequestState.COMPLETE, RequestState.CANCELLED)

    def test(self) -> tuple[bool, Optional[Status]]:
        if self.state == RequestState.INACTIVE:
            # MPI_Test on an inactive persistent request: flag=true,
            # empty status (MPI-3.1 §3.7.3).
            return True, None
        if self.state == RequestState.ACTIVE:
            _progress.progress()
            self._poll()
        if self.done:
            return True, self.status
        return False, None

    def wait(self, timeout: float | None = None) -> Status:
        if self.state == RequestState.INACTIVE:
            raise RequestError("wait on inactive persistent request")
        ok = _progress.ENGINE.progress_until(
            lambda: self._poll() or self.done, timeout
        )
        if not ok:
            raise TimeoutError("request wait timed out")
        if self.status.error is not None:
            raise self.status.error
        return self.status

    def result(self, timeout: float | None = None) -> Any:
        self.wait(timeout)
        return self._result

    def cancel(self) -> None:
        if self.state == RequestState.ACTIVE:
            self.state = RequestState.CANCELLED
            self.status.cancelled = True

    def start(self) -> "Request":
        """(Re)activate a persistent request (MPI_Start)."""
        if not self.persistent:
            raise RequestError("start() on non-persistent request")
        if self.state == RequestState.ACTIVE:
            raise RequestError("start() on already-active request")
        self.state = RequestState.ACTIVE
        self.status = Status()
        self._harvested = False
        self._start()
        return self

    def _start(self) -> None:
        """Subclass hook for persistent re-activation."""

    def free(self) -> None:
        self._callbacks.clear()


class CompletedRequest(Request):
    """A request born complete."""

    def __init__(self, result: Any = None, status: Status | None = None):
        super().__init__()
        self._complete(result, status)


class GeneralizedRequest(Request):
    """MPI_Grequest equivalent: user supplies a poll function."""

    def __init__(self, poll_fn: Callable[[], tuple[bool, Any]]) -> None:
        super().__init__()
        self._poll_fn = poll_fn

    def _poll(self) -> bool:
        if self.done:
            return True
        finished, result = self._poll_fn()
        if finished:
            self._complete(result)
        return self.done


# -- collections ----------------------------------------------------------

def wait_all(
    requests: Sequence[Request], timeout: float | None = None
) -> list[Status]:
    def all_done() -> bool:
        return all(r._poll() or r.done for r in requests)

    if not _progress.ENGINE.progress_until(all_done, timeout):
        raise TimeoutError("wait_all timed out")
    out = []
    for r in requests:
        if r.status.error is not None:
            raise r.status.error
        out.append(r.status)
    return out


def wait_any(
    requests: Sequence[Request], timeout: float | None = None
) -> tuple[int | None, Status]:
    """MPI_Waitany: block until one ACTIVE request completes. Entries a
    some-call already harvested read as MPI_REQUEST_NULL and are
    skipped; (None, empty Status) when nothing in the list is active
    (the MPI_UNDEFINED index, consistent with test_any). Unlike the
    some-family, wait_any does not deallocate — the returned handle
    stays live for result()."""
    if not requests:
        raise RequestError("wait_any on empty request list")
    live = _active_indices(requests)
    if not live:
        return None, Status()

    def any_done() -> bool:
        return any(
            requests[i]._poll() or requests[i].done for i in live
        )

    if not _progress.ENGINE.progress_until(any_done, timeout):
        raise TimeoutError("wait_any timed out")
    for i in live:
        r = requests[i]
        if r.done:
            if r.status.error is not None:
                raise r.status.error
            return i, r.status
    raise RequestError("unreachable")


def _active_indices(requests: Sequence[Request]) -> list[int]:
    """Indices participating in a some/any completion call. Inactive
    persistent requests are ignored per MPI-3.1 §3.7.5, and so are
    requests a previous some-call already harvested (MPI deallocates
    those — they read as MPI_REQUEST_NULL afterwards; reference:
    req_wait.c MPI_Waitsome skips inactive entries; req_test.c)."""
    return [
        i for i, r in enumerate(requests)
        if r.state != RequestState.INACTIVE and not r._harvested
    ]


def _harvest(
    requests: Sequence[Request], live: Sequence[int]
) -> list[tuple[int, Status]]:
    """Collect every complete request in `live` for a some-family call.
    Error checking happens BEFORE any harvest mark lands: a failed
    request must not cause successful completions to be marked
    deallocated yet never reported (the caller retries and would skip
    them forever). Shared by wait_some and test_some so Waitsome and
    Testsome semantics can't diverge."""
    done_idx = [
        i for i in live if requests[i]._poll() or requests[i].done
    ]
    for i in done_idx:
        if requests[i].status.error is not None:
            raise requests[i].status.error
    out = []
    for i in done_idx:
        requests[i]._harvested = True
        out.append((i, requests[i].status))
    return out


def wait_some(
    requests: Sequence[Request], timeout: float | None = None
) -> list[tuple[int, Status]] | None:
    """MPI_Waitsome (reference: ompi/request/req_wait.c:92-141 — block
    until >=1 active request completes, then harvest EVERY complete
    one). Returns [(index, status), ...]; None when the list holds no
    active requests (the MPI_UNDEFINED outcount)."""
    live = _active_indices(requests)
    if not live:
        return None

    def some_done() -> bool:
        return any(
            requests[i]._poll() or requests[i].done for i in live
        )

    if not _progress.ENGINE.progress_until(some_done, timeout):
        raise TimeoutError("wait_some timed out")
    return _harvest(requests, live)


def test_all(requests: Sequence[Request]) -> tuple[bool, list[Status] | None]:
    _progress.progress()
    if all(r._poll() or r.done for r in requests):
        return True, [r.status for r in requests]
    return False, None


def test_any(
    requests: Sequence[Request],
) -> tuple[bool, int | None, Status | None]:
    """MPI_Testany (reference: ompi/request/req_test.c): flag=True with
    the first complete active index, or (True, None, None) when no
    request in the list is active (the MPI_UNDEFINED index), else
    (False, None, None)."""
    live = _active_indices(requests)
    if not live:
        return True, None, None
    _progress.progress()
    for i in live:
        r = requests[i]
        if r._poll() or r.done:
            if r.status.error is not None:
                raise r.status.error
            return True, i, r.status
    return False, None, None


def test_some(
    requests: Sequence[Request],
) -> list[tuple[int, Status]] | None:
    """MPI_Testsome (reference: ompi/request/req_test.c): one progress
    sweep, then harvest every complete active request — [] when none
    finished yet, None when no request is active (MPI_UNDEFINED)."""
    live = _active_indices(requests)
    if not live:
        return None
    _progress.progress()
    return _harvest(requests, live)
