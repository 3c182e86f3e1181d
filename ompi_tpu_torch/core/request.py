"""Request lifecycle: nonblocking-operation handles with wait/test.

Port of ``ompi_tpu/core/request.py`` (reference: ompi/request/request.h,
req_wait.c:92-141; test/wait{any,some,all} in req_test.c/req_wait.c;
generalized requests in grequest.c; persistent requests via ``start``,
pml.h:292): ``Status``, ``RequestState``, ``Request``,
``CompletedRequest``, ``PartitionedRequest`` (MPI-4 Pready/Parrived
over the part framework's hooks), ``GeneralizedRequest`` and the
wait/test families.

A request completes either at creation (``CompletedRequest``) or when
its ``_poll`` sees its work finished; ``wait`` drives the progress
engine until then. A collective's request (``coll.framework
.PersistentColl``, ``DeviceRequest``) and a point-to-point receive
(``pml.ob1.RecvRequest``) hold the CUDA event recorded after their
work. ``_complete`` wakes the progress engine, fires peruse's
``REQ_COMPLETE`` and marks the result defined for the memchecker, as
the JAX package's does. The sanitizer's tracker comes with the
analysis tools.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

from . import memchecker, peruse
from . import progress as _progress
from .errors import ArgumentError, RequestError

ANY_SOURCE = -1
ANY_TAG = -1

# Orders a completion against an on_complete() on another thread: the
# state change and the taking of the callback list are one step, and so
# are the state check and the append, so no callback is lost.
_COMPLETION_LOCK = threading.Lock()


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
        with _COMPLETION_LOCK:
            if self.state in (RequestState.COMPLETE, RequestState.CANCELLED):
                return
            self._result = result
            if status is not None:
                self.status = status
            self.state = RequestState.COMPLETE
            callbacks = list(self._callbacks)
        _progress.ENGINE.notify_completion()  # wake sleeping waiters
        peruse.fire(peruse.PeruseEvent.REQ_COMPLETE, request=self)
        if result is not None:
            memchecker.mark_defined(result)
        for cb in callbacks:
            cb(self)

    def on_complete(self, cb: Callable[["Request"], None]) -> None:
        with _COMPLETION_LOCK:
            done = self.state == RequestState.COMPLETE
            if not done:
                self._callbacks.append(cb)
        if done:
            cb(self)

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


class PartitionedRequest(Request):
    """MPI-4 partitioned-communication handle (MPI_Psend_init /
    MPI_Precv_init; reference: ompi/mca/part/persist's
    ompi_part_persist_request_t). The user declares N partitions of one
    buffer; a part component maps them onto M internal transfers. This
    base type owns the partition bookkeeping and the Pready / Parrived
    argument contract; components implement the transfer machinery via
    the `_partition_ready` / `_partition_arrived` hooks.

    Semantics (MPI-4 §4.2): the request is persistent — start()
    re-arms it and resets every partition to not-ready; Pready is legal
    only on an active send-side request and only once per partition per
    start cycle; Parrived polls an active (or completed) receive-side
    request and may be called repeatedly, before or after overall
    completion."""

    def __init__(self, partitions: int, *, sending: bool) -> None:
        if partitions < 1:
            raise ArgumentError(
                f"partitioned request needs >= 1 partition, got {partitions}"
            )
        super().__init__(persistent=True)
        self.partitions = partitions
        self.sending = sending
        self._flagged = [False] * partitions

    def _check_partition(self, partition: int) -> int:
        if not 0 <= partition < self.partitions:
            raise ArgumentError(
                f"partition {partition} out of range "
                f"[0, {self.partitions})"
            )
        return partition

    def pready(self, partition: int) -> None:
        """MPI_Pready: mark one send partition filled; the component may
        drain it (and any transfer it completes) immediately."""
        self._pready_burst([partition])

    def pready_range(self, lo: int, hi: int) -> None:
        """MPI_Pready_range: inclusive bounds, matching the MPI binding.
        The whole range is validated up front and handed to the
        component as ONE burst (one drain sweep / dispatch window), not
        partition-at-a-time."""
        self._check_partition(lo)
        self._check_partition(hi)
        if hi < lo:
            raise ArgumentError(f"Pready_range: hi {hi} < lo {lo}")
        self._pready_burst(list(range(lo, hi + 1)))

    def pready_list(self, partitions: Sequence[int]) -> None:
        """MPI_Pready_list — same burst contract as pready_range."""
        self._pready_burst(list(partitions))

    def _pready_burst(self, partitions: Sequence[int]) -> None:
        """Validate a Pready burst ATOMICALLY, then flag and hand the
        whole set to the component in one call. A duplicate anywhere in
        the burst (against this cycle's flags or within the burst
        itself) raises BEFORE any partition is flagged, so an erroneous
        overlapping Pready_range can never double-send a transfer."""
        if not self.sending:
            raise RequestError("Pready on a receive-side partitioned request")
        if self.state is not RequestState.ACTIVE:
            raise RequestError("Pready on a partitioned request that is "
                               "not active (call start() first)")
        seen = set()
        for partition in partitions:
            p = self._check_partition(partition)
            if self._flagged[p] or p in seen:
                raise RequestError(
                    f"Pready: partition {p} already marked ready this "
                    "cycle"
                )
            seen.add(p)
        for p in partitions:
            self._flagged[p] = True
        self._partitions_ready(list(partitions))

    def parrived(self, partition: int) -> bool:
        """MPI_Parrived: has this receive partition fully arrived?"""
        if self.sending:
            raise RequestError("Parrived on a send-side partitioned request")
        self._check_partition(partition)
        if self.state is RequestState.INACTIVE:
            raise RequestError("Parrived on a partitioned request that is "
                               "not active (call start() first)")
        return self._partition_arrived(partition)

    def start(self) -> "Request":
        if self.state is RequestState.ACTIVE:
            raise RequestError("start() on already-active request")
        self._flagged = [False] * self.partitions
        return super().start()

    # -- component hooks --------------------------------------------------

    def _partitions_ready(self, partitions: list) -> None:
        """Burst hook: every partition is already flagged. Components
        override to coalesce the burst (one probe sweep, one dispatch
        window); the default degrades to partition-at-a-time."""
        for p in partitions:
            self._partition_ready(p)

    def _partition_ready(self, partition: int) -> None:
        raise NotImplementedError

    def _partition_arrived(self, partition: int) -> bool:
        raise NotImplementedError


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
