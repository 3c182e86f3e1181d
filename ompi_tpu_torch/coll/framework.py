"""The coll framework: per-communicator collective selection, plans and
persistent requests.

Port of ``ompi_tpu/coll/framework.py``. ``select_for_comm`` merges, per
operation, the highest-priority available component that implements it
(coll_base_comm_select.c:110-152). ``compile_plan`` caches a callable
per (operation, algorithm, op, shape, dtype) key on the communicator.
There is no ``shard_map`` in the port: a plan takes the whole rank-major
``(n, ...)`` tensor and returns a rank-major ``(n, ...)`` tensor.

``PersistentColl`` is the persistent collective (``comm.<op>_init``):
its first ``start()`` resolves the dispatch once (the component's
``persistent_program``, else the component's method), and every start
after that is that dispatch alone. It completes on a CUDA event recorded
on the current stream right after the dispatch; on the CPU it completes
at once. ``DeviceRequest`` is a nonblocking ``i*`` collective: the
blocking dispatch enqueued the work, and the request completes on the
CUDA event recorded after it (at once on the CPU).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..core import component as mca
from ..core import progress as _progress
from ..core.counters import SPC
from ..core.errors import ArgumentError, CommError, RequestError
from ..core.request import Request, RequestState, Status
from ..trace import span as tspan

# Collective operations a component may provide (the JAX package's
# OPERATIONS tuple).
OPERATIONS = (
    "allreduce", "bcast", "reduce", "allgather", "reduce_scatter_block",
    "alltoall", "gather", "scatter", "scan", "exscan", "barrier",
    "allgatherv", "gatherv", "scatterv", "alltoallv", "alltoallw",
    "reduce_scatter", "neighbor_allgather", "neighbor_alltoall",
)

COLL = mca.framework("coll", "collective operations")


class CollComponent(mca.Component):
    """Base class: a coll component provides a subset of OPERATIONS as
    methods fn(comm, *args)."""

    def provided(self) -> list[str]:
        return [op for op in OPERATIONS if hasattr(self, op)]

    def persistent_program(self, comm, opname: str, x, args):
        """Pre-bound dispatch for persistent collectives: return
        ``prog(buffer) -> result`` with every per-call decision
        (validation, algorithm choice, cache-key build, plan lookup)
        already resolved against (comm, args) — or None when the
        operation has no single-plan form, and ``PersistentColl`` calls
        the component's method instead."""
        return None


def register_components() -> None:
    """Import all coll components the port has so they self-register."""
    from . import basic, pallas_ring, selfcoll, sync, tuned, xla  # noqa: F401


_registered = False


def ensure_components() -> None:
    global _registered
    if not _registered:
        register_components()
        _registered = True


def select_for_comm(comm) -> dict[str, tuple[Any, Callable]]:
    """Merge per-operation tables: for each op, the highest-priority
    available component that implements it."""
    ensure_components()
    table: dict[str, tuple[Any, Callable]] = {}
    for comp in COLL.select_all(comm=comm):
        for opname in comp.provided():
            if opname not in table:
                table[opname] = (comp, getattr(comp, opname))
    return table


def compile_plan(comm, key: tuple, fn: Callable) -> Callable:
    """Fetch (or store) the cached callable ``fn(x) -> out`` over the
    whole rank-major tensor."""
    cache = comm._plan_cache
    plan = cache.get(key)
    if plan is None:
        plan = cache[key] = fn
        SPC.record("coll_plans_compiled")
    return plan


def rank_major_check(comm, x, min_ndim: int = 1) -> torch.Tensor:
    """x must be a tensor on the comm's device with leading dim
    comm.size. Nothing is moved between devices: a tensor elsewhere is
    an error, not a copy."""
    if not isinstance(x, torch.Tensor):
        raise ArgumentError(
            f"expected a rank-major torch.Tensor, got {type(x).__name__}"
        )
    if x.ndim < min_ndim or x.shape[0] != comm.size:
        raise ArgumentError(
            f"expected rank-major buffer with leading dim {comm.size}, "
            f"got shape {tuple(x.shape)}"
        )
    if x.device != comm.device:
        raise ArgumentError(
            f"buffer on {x.device}, communicator {comm.name} on "
            f"{comm.device}"
        )
    return x


def _card_device(result: Any) -> Optional[torch.device]:
    """The card of the first tensor in ``result`` that lies on one."""
    if isinstance(result, torch.Tensor):
        return result.device if result.is_cuda else None
    if isinstance(result, dict):
        result = result.values()
    elif not isinstance(result, (tuple, list)):
        return None
    for leaf in result:
        device = _card_device(leaf)
        if device is not None:
            return device
    return None


def record_completion(result: Any) -> Optional["torch.cuda.Event"]:
    """A CUDA event recorded on the current stream after the work that
    produces ``result``, or None when no tensor of it lies on a card (the
    CPU computed it already)."""
    device = _card_device(result)
    if device is None:
        return None
    event = torch.cuda.Event()
    # the stream named by its device: torch.cuda.current_stream() with no
    # device first asks for the current device, a cost that shows at one
    # event per point-to-point transfer
    event.record(torch.cuda.current_stream(device.index))
    return event


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------

class DeviceRequest(Request):
    """A nonblocking collective: the device work is already enqueued on
    the current stream; completion is the CUDA event recorded after it
    (``_poll`` queries it, ``wait()`` synchronizes it)."""

    def __init__(self, result: Any) -> None:
        super().__init__()
        self._pending = result
        self._event = record_completion(result)
        if self._event is None:
            self._complete(result)

    def _poll(self) -> bool:
        if self.done:
            return True
        if self._event.query():
            self._complete(self._pending)
        return self.done

    def wait(self, timeout: float | None = None) -> Status:
        if not self.done:
            if timeout is None:
                self._event.synchronize()
                self._complete(self._pending)
            elif not _progress.ENGINE.progress_until(self._poll, timeout):
                raise TimeoutError("collective wait timed out")
        return self.status


class PersistentColl(Request):
    """Persistent collective (MPI_Allreduce_init / pcollreq extension):
    binds (comm, operation, args); each start() re-dispatches the
    resolved program against the bound buffer."""

    def __init__(self, comm, opname: str, args: tuple, x: Any) -> None:
        super().__init__(persistent=True)
        self._comm = comm
        self._opname = opname
        self._args = args
        self.buffer = x
        self._pending = None
        self._event = None
        self._dispatch = None  # resolved once, on first start()
        # Interned at construction: start() must do no per-call string
        # building beyond the dispatch itself.
        self._spc_name = f"coll_persistent_{opname}_starts"

    def bind(self, x: Any) -> None:
        """Rebind the input buffer (same shape/dtype reuses the plan)."""
        self.buffer = x

    def _resolve(self) -> None:
        """First-start binding: the providing component's pre-bound
        program, else a direct (vtable-resolved once) call of its method.
        Later starts never re-enter ``_coll_call``."""
        comm = self._comm
        comm._check_alive()
        entry = comm._coll.get(self._opname)
        if entry is None:
            raise CommError(
                f"{comm.name}: no coll component provides {self._opname}"
            )
        component, fn = entry
        prog = component.persistent_program(
            comm, self._opname, self.buffer, self._args
        )
        if prog is not None:
            self._dispatch = prog
        elif self._opname == "barrier":  # the one bufferless operation
            self._dispatch = lambda _x, f=fn, c=comm: f(c)
        else:
            self._dispatch = (
                lambda x, f=fn, c=comm, a=self._args: f(c, x, *a)
            )

    def _start(self) -> None:
        if self._dispatch is None:
            self._resolve()
        SPC.record(self._spc_name)
        # One instant per start marks persistent traffic on the timeline.
        tspan.instant("coll.persistent_start", cat="coll",
                      op=self._opname, cid=self._comm.cid)
        # Drop the last start's result first: unless the caller holds it,
        # its memory is free for this start's result.
        self._pending = self._result = None
        self._pending = self._dispatch(self.buffer)
        self._event = record_completion(self._pending)
        if self._event is None:
            self._complete(self._pending)

    def _poll(self) -> bool:
        if self.done:
            return True
        if self._event is not None and self._event.query():
            self._complete(self._pending)
        return self.done

    def wait(self, timeout: float | None = None) -> Status:
        if self.state == RequestState.INACTIVE:
            raise RequestError("wait on persistent collective before start()")
        if not self.done:
            if timeout is None:
                self._event.synchronize()
                self._complete(self._pending)
            elif not _progress.ENGINE.progress_until(self._poll, timeout):
                raise TimeoutError("persistent collective wait timed out")
        return self.status
