"""Communicators: groups of ranks with collective capability.

Port of ``ompi_tpu/communicator.py`` (so far: construction, the
per-communicator coll vtable, ``allreduce``, ``bcast``, ``reduce``,
``allgather``, ``reduce_scatter_block``, ``alltoall``, ``gather``,
``scatter``, ``check_rank``, ``dup``,
``split``, the plan cache, the cid counter and ``_check_alive``; epochs
and revocation come with the fault-tolerance slice).

Buffer convention ("rank-major"): a collective argument is
a contiguous ``(size, ...)`` tensor on the communicator's device whose
leading axis is the rank. ``put_rank_major`` builds one. All ranks of a
communicator share one device.
"""

from __future__ import annotations

import itertools
import threading
import weakref
from typing import Any, Optional, Sequence

import torch

from .core.counters import SPC
from .core.errors import ArgumentError, CommError, RankError
from .group import Group

_cid_counter = itertools.count(0)
_cid_lock = threading.Lock()

live_comms: "weakref.WeakSet[Communicator]" = weakref.WeakSet()


def _next_cid() -> int:
    with _cid_lock:
        return next(_cid_counter)


class Communicator:
    """A communication context over an ordered set of virtual ranks."""

    def __init__(
        self,
        group: Group,
        world_procs: Sequence,
        *,
        name: str = "",
        parent_cid: Optional[int] = None,
    ) -> None:
        self.group = group
        self.cid = _next_cid()
        self.name = name or f"comm{self.cid}"
        self.parent_cid = parent_cid
        self._freed = False
        self._world_procs = world_procs
        self.procs = [world_procs[r] for r in group.world_ranks]
        self.device = world_procs[0].device
        self._plan_cache: dict[tuple, Any] = {}
        self._coll: dict[str, tuple[Any, Any]] = {}
        self._select_frameworks()
        live_comms.add(self)

    def _select_frameworks(self) -> None:
        from .coll.framework import select_for_comm as coll_select

        self._coll = coll_select(self)

    @property
    def size(self) -> int:
        return self.group.size

    def put_rank_major(self, value) -> torch.Tensor:
        """A contiguous (size, ...) tensor on this comm's device (from a
        tensor or a numpy array)."""
        arr = torch.as_tensor(value)
        if arr.ndim < 1 or arr.shape[0] != self.size:
            raise ArgumentError(
                f"rank-major leading dim "
                f"{arr.shape[0] if arr.ndim else None} != comm size "
                f"{self.size}"
            )
        return arr.to(self.device).contiguous()

    def check_rank(self, rank: int) -> int:
        if not 0 <= rank < self.size:
            raise RankError(
                f"rank {rank} out of range for {self.name} (size {self.size})"
            )
        return rank

    def _check_alive(self) -> None:
        if self._freed:
            raise CommError(f"{self.name} has been freed")

    # -- collectives (dispatch through the per-comm vtable) ---------------

    def _coll_call(self, opname: str, *args, **kw):
        self._check_alive()
        entry = self._coll.get(opname)
        if entry is None:
            raise CommError(
                f"{self.name}: no coll component provides {opname}"
            )
        _component, fn = entry
        SPC.record(f"coll_{opname}_calls")
        return fn(self, *args, **kw)

    def allreduce(self, x, op="sum"):
        return self._coll_call("allreduce", x, op)

    def bcast(self, x, root: int = 0):
        return self._coll_call("bcast", x, self.check_rank(root))

    def reduce(self, x, op="sum", root: int = 0):
        return self._coll_call("reduce", x, op, self.check_rank(root))

    def allgather(self, x):
        return self._coll_call("allgather", x)

    def reduce_scatter_block(self, x, op="sum"):
        return self._coll_call("reduce_scatter_block", x, op)

    def alltoall(self, x):
        """(size, size, ...) rank-major -> (size, size, ...): rank r's
        row s is rank s's block for rank r."""
        return self._coll_call("alltoall", x)

    def gather(self, x, root: int = 0):
        """(size, ...) rank-major -> root's (size, ...) gathered rows."""
        return self._coll_call("gather", x, self.check_rank(root))

    def scatter(self, x, root: int = 0):
        """Root's (size, ...) buffer -> (size, ...) rank-major, rank r
        holding row r."""
        return self._coll_call("scatter", x, self.check_rank(root))

    # -- construction of derived communicators ----------------------------

    def dup(self) -> "Communicator":
        """A new communicator over the same group; re-runs coll
        selection, so it sees priority vars set since this one."""
        self._check_alive()
        return Communicator(
            self.group, self._world_procs, name=f"{self.name}.dup",
            parent_cid=self.cid,
        )

    def split(self, colors: Sequence[int], keys: Optional[Sequence[int]] = None
              ) -> dict[int, "Communicator"]:
        """MPI_Comm_split, single-controller form: the caller supplies every
        rank's (color, key); returns {color: communicator}. Color < 0
        (MPI_UNDEFINED) ranks are excluded."""
        self._check_alive()
        if len(colors) != self.size:
            raise ArgumentError("need one color per rank")
        keys = list(keys) if keys is not None else list(range(self.size))
        if len(keys) != self.size:
            raise ArgumentError(
                f"need one key per rank: got {len(keys)} for size {self.size}"
            )
        buckets: dict[int, list[tuple[int, int]]] = {}
        for r, (c, k) in enumerate(zip(colors, keys)):
            if c < 0:
                continue
            buckets.setdefault(c, []).append((k, r))
        out = {}
        for color, members in sorted(buckets.items()):
            members.sort()
            g = Group(self.group.world_rank(r) for _, r in members)
            out[color] = Communicator(
                g, self._world_procs, name=f"{self.name}.split{color}",
                parent_cid=self.cid,
            )
        return out

    def free(self) -> None:
        self._plan_cache.clear()
        self._freed = True

    def __repr__(self) -> str:
        return (
            f"<Communicator {self.name} cid={self.cid} size={self.size} "
            f"device={self.device}>"
        )
