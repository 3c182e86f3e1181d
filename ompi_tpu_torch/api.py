"""Top-level runtime API: init / finalize / world.

Port of ``ompi_tpu/api.py`` without the trace, health, telemetry and
hook seams. ``init`` discovers n virtual ranks on one device (``cuda:0``
unless the caller passes ``device="cpu"``) and builds COMM_WORLD and
COMM_SELF, whose constructors run coll selection. The MPI-4
partitioned calls (``Psend_init``, ``Precv_init``, ``Pready``,
``Pready_range``, ``Pready_list``, ``Parrived``) wrap the
communicator's and the request's methods, as in the JAX package.
"""

from __future__ import annotations

import threading
from typing import Optional

from .communicator import Communicator, live_comms
from .core.counters import SPC
from .core.device import resolve_device
from .core.errors import NotInitializedError
from .core.logging import get_logger
from .group import Group
from .runtime import mesh as mesh_mod

logger = get_logger("runtime")

_lock = threading.Lock()
_state: Optional["_World"] = None


class _World:
    def __init__(self, procs, comm_world, comm_self):
        self.procs = procs
        self.comm_world = comm_world
        self.comm_self = comm_self


def init(nranks: int = mesh_mod.DEFAULT_NRANKS, *, device=None
         ) -> Communicator:
    """Initialize the runtime and return COMM_WORLD. Idempotent: a
    second call returns the existing world (and raises if it asks for
    another size or device)."""
    global _state
    dev = resolve_device(device)
    with _lock:
        if _state is not None:
            world = _state.comm_world
            if world.size != nranks or world.device != dev:
                raise NotInitializedError(
                    f"already initialized with {world.size} ranks on "
                    f"{world.device}; finalize() first"
                )
            return world
        procs = mesh_mod.discover(nranks, dev)
        comm_world = Communicator(Group(range(nranks)), procs, name="WORLD")
        comm_self = Communicator(Group([0]), procs, name="SELF")
        _state = _World(procs, comm_world, comm_self)
        SPC.record("init_calls")
        logger.info("initialized: %d ranks on %s", nranks, dev)
    return comm_world


def finalize() -> None:
    """Free every live communicator (MPI_Finalize). Safe to call twice."""
    global _state
    with _lock:
        if _state is None:
            return
        for comm in list(live_comms):
            if not comm._freed:
                comm.free()
        _state = None


# -- MPI-4 partitioned communication (reference: ompi/mca/part) -------------

def Psend_init(comm, value, partitions: int, dest: int, tag: int = 0, *,
               source=None):
    """MPI_Psend_init: a persistent partitioned send of ``value`` split
    into ``partitions`` contiguous partitions."""
    return comm.psend_init(value, partitions, dest, tag, source=source)


def Precv_init(comm, partitions: int, source: int, tag: int = 0, *,
               dest: int, like):
    """MPI_Precv_init: ``like`` supplies the receive shape/dtype."""
    return comm.precv_init(partitions, source, tag, dest=dest, like=like)


def Pready(request, partition: int) -> None:
    """MPI_Pready: mark one send partition filled (eager drain)."""
    request.pready(partition)


def Pready_range(request, lo: int, hi: int) -> None:
    """MPI_Pready_range (inclusive bounds, matching the MPI binding)."""
    request.pready_range(lo, hi)


def Pready_list(request, partitions) -> None:
    """MPI_Pready_list."""
    request.pready_list(partitions)


def Parrived(request, partition: int) -> bool:
    """MPI_Parrived: poll one receive partition's completion."""
    return request.parrived(partition)


def world() -> Communicator:
    if _state is None:
        raise NotInitializedError(
            "ompi_tpu_torch.init() has not been called (or finalize() "
            "already was)"
        )
    return _state.comm_world
