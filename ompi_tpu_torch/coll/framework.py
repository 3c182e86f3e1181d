"""The coll framework: per-communicator collective selection + plans.

Port of ``ompi_tpu/coll/framework.py``. ``select_for_comm`` merges, per
operation, the highest-priority available component that implements it
(coll_base_comm_select.c:110-152). ``compile_plan`` caches a callable
per (operation, algorithm, op, shape, dtype) key on the communicator.
There is no ``shard_map`` in the port: a plan takes the whole rank-major
``(n, ...)`` tensor and returns a rank-major ``(n, ...)`` tensor.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..core import component as mca
from ..core.counters import SPC
from ..core.errors import ArgumentError

# Collective operations a component may provide (the JAX package's
# OPERATIONS tuple; the port has allreduce, bcast, reduce, allgather,
# reduce_scatter_block, alltoall, gather and scatter so far).
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


def ensure_components() -> None:
    """Import the component modules so they register with COLL."""
    from . import basic, pallas_ring, tuned, xla  # noqa: F401


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
