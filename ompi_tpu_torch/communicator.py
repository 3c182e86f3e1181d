"""Communicators: groups of ranks with collective capability.

Port of ``ompi_tpu/communicator.py``: construction, the per-communicator
coll vtable, every blocking collective (allreduce, bcast, reduce,
allgather, reduce_scatter_block, alltoall, gather, scatter, scan,
exscan, barrier, the ragged variants and the neighborhood collectives),
the persistent ``*_init`` forms and ``start_all``, ``check_rank``,
``dup``, ``create``, ``split``, ``set_name``, ``info``, attributes and
the errhandler, the plan cache, the cid counter and ``_check_alive``;
the nonblocking ``i*`` collectives (``DeviceRequest``s completing on
the CUDA event recorded after the blocking dispatch); point-to-point
through the selected PML (``send``/``recv``/``isend``/``irecv``,
``probe``/``iprobe``/``improbe``, the persistent ``send_init``/
``recv_init``, ``start_all``), the partitioned ``psend_init``/
``precv_init`` (the part framework) and ``RankEndpoint``, a rank's
view with the MPI call signatures. Epochs and revocation come with
fault tolerance.

Buffer convention ("rank-major"): a collective argument is a contiguous
``(size, ...)`` tensor on the communicator's device whose leading axis
is the rank. ``put_rank_major`` and ``from_rank_values`` build one. All
ranks of a communicator share one device.

Ragged convention: the vector variants take per-rank lists of blocks
whose leading dims are the counts (``blocks[src][dst]`` for the
alltoalls). Their results are tensors on the communicator's device: a
list with one entry per receiving rank, or one tensor for a result
every rank holds (allgatherv) or that root alone holds (gatherv), as a
gather's result is root's rows alone. The neighborhood collectives
return ``{rank: tensor}``.
"""

from __future__ import annotations

import itertools
import threading
import weakref
from typing import Any, Optional, Sequence

import torch

from .core.attributes import HasAttributes
from .core.counters import SPC
from .core.errors import ArgumentError, CommError, HasErrhandler, RankError
from .core.info import Info
from .core.request import Request, RequestState
from .core.tree import map_leaves
from .group import Group

_cid_counter = itertools.count(0)
_cid_lock = threading.Lock()

live_comms: "weakref.WeakSet[Communicator]" = weakref.WeakSet()


def _next_cid() -> int:
    with _cid_lock:
        return next(_cid_counter)


class Communicator(HasAttributes, HasErrhandler):
    """A communication context over an ordered set of virtual ranks."""

    def __init__(
        self,
        group: Group,
        world_procs: Sequence,
        *,
        name: str = "",
        info: Optional[Info] = None,
        parent_cid: Optional[int] = None,
    ) -> None:
        self.group = group
        self.cid = _next_cid()
        self.name = name or f"comm{self.cid}"
        self.info = info or Info()
        self.parent_cid = parent_cid
        self._freed = False
        self._world_procs = world_procs
        self.procs = [world_procs[r] for r in group.world_ranks]
        self.device = world_procs[0].device
        self._plan_cache: dict[tuple, Any] = {}
        self._coll: dict[str, tuple[Any, Any]] = {}
        self._pml = None
        self.topo = None  # attached by topo (cart/graph/dist_graph)
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

    def from_rank_values(self, values: Sequence) -> torch.Tensor:
        """One contiguous (size, ...) tensor on this comm's device from
        one value per rank (tensors or numpy arrays of one shape)."""
        if len(values) != self.size:
            raise ArgumentError(
                f"{len(values)} values for comm of size {self.size}"
            )
        return torch.stack(
            [torch.as_tensor(v).to(self.device) for v in values])

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

    def scan(self, x, op="sum"):
        """Inclusive prefix reduction: rank r gets ranks 0..r combined."""
        return self._coll_call("scan", x, op)

    def exscan(self, x, op="sum"):
        """Exclusive prefix reduction: rank r gets ranks 0..r-1 combined,
        rank 0 the op's identity (zeros where the op has none, and from
        BasicColl, as in the JAX package)."""
        return self._coll_call("exscan", x, op)

    def barrier(self) -> None:
        """Returns once the barrier's one-int32-per-rank reduction has
        completed (its CUDA event on the current stream has passed)."""
        from .coll.framework import record_completion

        event = record_completion(self._coll_call("barrier"))
        if event is not None:
            event.synchronize()

    # vector (ragged) variants — per-rank block lists carry the counts
    def allgatherv(self, values):
        return self._coll_call("allgatherv", list(values))

    def gatherv(self, values, root: int = 0):
        return self._coll_call("gatherv", list(values),
                               self.check_rank(root))

    def scatterv(self, blocks, root: int = 0):
        return self._coll_call("scatterv", list(blocks),
                               self.check_rank(root))

    def alltoallv(self, blocks):
        return self._coll_call("alltoallv", [list(b) for b in blocks])

    def alltoallw(self, blocks):
        return self._coll_call("alltoallw", [list(b) for b in blocks])

    def reduce_scatter(self, values, counts, op="sum"):
        return self._coll_call("reduce_scatter", list(values),
                               list(counts), op)

    # neighborhood collectives (need an attached cart/graph topology)
    def neighbor_allgather(self, x):
        return self._coll_call("neighbor_allgather", x)

    def neighbor_alltoall(self, sendblocks):
        return self._coll_call("neighbor_alltoall", sendblocks)

    # Nonblocking variants: the blocking dispatch enqueues the device
    # work; the request completes on the CUDA event recorded after it.
    def _icoll(self, opname: str, *args, **kw):
        from .coll.framework import DeviceRequest

        return DeviceRequest(self._coll_call(opname, *args, **kw))

    def iallreduce(self, x, op="sum"):
        return self._icoll("allreduce", x, op)

    def ibcast(self, x, root: int = 0):
        return self._icoll("bcast", x, self.check_rank(root))

    def ireduce(self, x, op="sum", root: int = 0):
        return self._icoll("reduce", x, op, self.check_rank(root))

    def iallgather(self, x):
        return self._icoll("allgather", x)

    def ireduce_scatter_block(self, x, op="sum"):
        return self._icoll("reduce_scatter_block", x, op)

    def ialltoall(self, x):
        return self._icoll("alltoall", x)

    def igather(self, x, root: int = 0):
        return self._icoll("gather", x, self.check_rank(root))

    def iscatter(self, x, root: int = 0):
        return self._icoll("scatter", x, self.check_rank(root))

    def iscan(self, x, op="sum"):
        return self._icoll("scan", x, op)

    def ibarrier(self):
        return self._icoll("barrier")

    def iallgatherv(self, values):
        return self._icoll("allgatherv", list(values))

    def ialltoallv(self, blocks):
        return self._icoll("alltoallv", [list(b) for b in blocks])

    def ireduce_scatter(self, values, counts, op="sum"):
        return self._icoll("reduce_scatter", list(values), list(counts), op)

    def ineighbor_allgather(self, x):
        return self._icoll("neighbor_allgather", x)

    def ineighbor_alltoall(self, sendblocks):
        return self._icoll("neighbor_alltoall", sendblocks)

    # Persistent collectives (MPI-4 *_init; reference: the operation table
    # of coll_base_functions.h:45-66 and ompi/mpiext/pcollreq): start()
    # re-dispatches the program resolved on the first start against the
    # bound buffer. Every blocking operation above has an _init form.
    def _pinit(self, opname: str, x, *args):
        from .coll.framework import PersistentColl

        return PersistentColl(self, opname, args, x)

    def allreduce_init(self, x, op="sum"):
        return self._pinit("allreduce", x, op)

    def bcast_init(self, x, root: int = 0):
        return self._pinit("bcast", x, self.check_rank(root))

    def reduce_init(self, x, op="sum", root: int = 0):
        return self._pinit("reduce", x, op, self.check_rank(root))

    def allgather_init(self, x):
        return self._pinit("allgather", x)

    def reduce_scatter_block_init(self, x, op="sum"):
        return self._pinit("reduce_scatter_block", x, op)

    def alltoall_init(self, x):
        return self._pinit("alltoall", x)

    def gather_init(self, x, root: int = 0):
        return self._pinit("gather", x, self.check_rank(root))

    def scatter_init(self, x, root: int = 0):
        return self._pinit("scatter", x, self.check_rank(root))

    def scan_init(self, x, op="sum"):
        return self._pinit("scan", x, op)

    def exscan_init(self, x, op="sum"):
        return self._pinit("exscan", x, op)

    def barrier_init(self):
        return self._pinit("barrier", None)

    def allgatherv_init(self, values):
        return self._pinit("allgatherv", list(values))

    def gatherv_init(self, values, root: int = 0):
        return self._pinit("gatherv", list(values), self.check_rank(root))

    def scatterv_init(self, blocks, root: int = 0):
        return self._pinit("scatterv", list(blocks), self.check_rank(root))

    def alltoallv_init(self, blocks):
        return self._pinit("alltoallv", [list(b) for b in blocks])

    def alltoallw_init(self, blocks):
        return self._pinit("alltoallw", [list(b) for b in blocks])

    def reduce_scatter_init(self, values, counts, op="sum"):
        return self._pinit("reduce_scatter", list(values), list(counts), op)

    def neighbor_allgather_init(self, x):
        return self._pinit("neighbor_allgather", x)

    def neighbor_alltoall_init(self, sendblocks):
        return self._pinit("neighbor_alltoall", sendblocks)

    # Persistent p2p (MPI_Send_init / MPI_Recv_init, reference pml.h:292
    # `pml_isend_init`): binds the envelope once; each start() re-issues
    # through the selected PML against the currently bound buffer.
    def send_init(self, value, dest: int, tag: int = 0, *, source=None):
        return PersistentSend(
            self, value, self.check_rank(dest), tag, source
        )

    def recv_init(self, source: int = -1, tag: int = -1, *, dest: int):
        return PersistentRecv(self, source, tag, dest)

    # Partitioned p2p (MPI-4 MPI_Psend_init / MPI_Precv_init, reference
    # ompi/mca/part): N user partitions of one buffer drain as M
    # internal pml transfers, eagerly as Pready flags land.
    def psend_init(self, value, partitions: int, dest: int, tag: int = 0,
                   *, source=None):
        self._check_alive()
        from .part.framework import select_for_comm as part_select

        if source is not None:
            source = self.check_rank(source)
        return part_select(self).psend_init(
            self, value, partitions, self.check_rank(dest), tag,
            source=source,
        )

    def precv_init(self, partitions: int, source: int, tag: int = 0, *,
                   dest: int, like):
        """``like`` supplies the receive shape/dtype (a tensor, a
        ``meta`` tensor or anything with ``shape`` and ``dtype``); total
        element count and dtype must match the sender's buffer."""
        self._check_alive()
        from .part.framework import select_for_comm as part_select

        return part_select(self).precv_init(
            self, partitions, self.check_rank(source), tag,
            dest=self.check_rank(dest), like=like,
        )

    # -- p2p (delegated to the selected PML) ------------------------------

    @property
    def pml(self):
        if self._pml is None:
            from .pml.framework import select_for_comm as pml_select

            self._pml = pml_select(self)
        return self._pml

    def send(self, value, dest: int, tag: int = 0, *, source=None):
        """Send ``value`` to rank ``dest`` from rank ``source`` (needed
        unless the comm has one rank: every rank shares the device)."""
        self._check_alive()
        return self.pml.send(
            self, value, self.check_rank(dest), tag, source=source
        )

    def recv(self, source: int = -1, tag: int = -1, *, dest: int):
        self._check_alive()
        return self.pml.recv(self, source, tag, dest=dest)

    def isend(self, value, dest: int, tag: int = 0, *, source=None):
        self._check_alive()
        return self.pml.isend(
            self, value, self.check_rank(dest), tag, source=source
        )

    def irecv(self, source: int = -1, tag: int = -1, *, dest: int):
        self._check_alive()
        return self.pml.irecv(self, source, tag, dest=dest)

    def probe(self, source: int = -1, tag: int = -1, *, dest: int):
        self._check_alive()
        return self.pml.probe(self, source, tag, dest=dest, blocking=True)

    def iprobe(self, source: int = -1, tag: int = -1, *, dest: int):
        self._check_alive()
        return self.pml.probe(self, source, tag, dest=dest, blocking=False)

    def improbe(self, source: int = -1, tag: int = -1, *, dest: int):
        """MPI_Improbe: match-and-remove; returns a Message or None."""
        self._check_alive()
        return self.pml.improbe(self, source, tag, dest=dest)

    def rank(self, rank: int) -> "RankEndpoint":
        """A rank's-eye view with the MPI-faithful call signatures."""
        return RankEndpoint(self, self.check_rank(rank))

    # -- construction of derived communicators ----------------------------

    def dup(self, info: Optional[Info] = None) -> "Communicator":
        """A new communicator over the same group, with a copy of this
        one's info (or ``info``) and attributes (each keyval's copy
        callback decides); re-runs coll selection, so it sees priority
        vars set since this one."""
        self._check_alive()
        new = Communicator(
            self.group, self._world_procs, name=f"{self.name}.dup",
            info=(info or self.info.dup()), parent_cid=self.cid,
        )
        self.copy_attrs_to(new)
        return new

    def create(self, group: Group) -> "Communicator":
        """MPI_Comm_create: a new communicator over a subgroup."""
        self._check_alive()
        for wr in group.world_ranks:
            if wr not in self.group:
                raise ArgumentError(
                    f"group rank {wr} not in parent {self.name}"
                )
        return Communicator(
            group, self._world_procs, name=f"{self.name}.sub",
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
        self.free_attrs()
        self._plan_cache.clear()
        if self._pml is not None:
            self._pml.comm_freed(self)
        self._freed = True

    def set_name(self, name: str) -> None:
        self.name = name

    def __repr__(self) -> str:
        return (
            f"<Communicator {self.name} cid={self.cid} size={self.size} "
            f"device={self.device}>"
        )


class _PersistentP2P(Request):
    """Shared machinery: a persistent request owning an inner active
    request per start() (reference: ob1 persistent requests re-enter
    the start path, pml_ob1_start.c)."""

    def __init__(self, comm) -> None:
        super().__init__(persistent=True)
        self._comm = comm
        self._inner = None

    def _poll(self) -> bool:
        if self.done:
            return True
        inner = self._inner
        if inner is not None and inner._poll():
            self._complete(inner._result, inner.status)
        return self.done

    def wait(self, timeout: float | None = None):
        inner = self._inner
        if inner is None or self.state == RequestState.INACTIVE:
            # base wait: raises on inactive persistent requests
            return super().wait(timeout)
        if not self.done:
            inner.wait(timeout)
            self._poll()
        if self.status.error is not None:
            raise self.status.error
        return self.status


class PersistentSend(_PersistentP2P):
    def __init__(self, comm, value, dest, tag, source) -> None:
        super().__init__(comm)
        self.buffer = value
        self._dest = dest
        self._tag = tag
        self._source = source

    def bind(self, value) -> None:
        """Rebind the send buffer for the next start()."""
        self.buffer = value

    def _start(self) -> None:
        self._inner = self._comm.isend(
            self.buffer, self._dest, self._tag, source=self._source
        )


class PersistentRecv(_PersistentP2P):
    def __init__(self, comm, source, tag, dest) -> None:
        super().__init__(comm)
        self._source = source
        self._tag = tag
        self._dest = dest

    def _start(self) -> None:
        self._inner = self._comm.irecv(
            self._source, self._tag, dest=self._dest
        )


def start_all(requests) -> list:
    """MPI_Startall: start every request in order (the port has no
    cross-process fabric whose dispatches a batch could coalesce)."""
    return [r.start() for r in requests]


class RankEndpoint:
    """One rank's view of a communicator: MPI-faithful p2p signatures
    (send(value, dest, tag) / recv(source, tag)) with the endpoint's rank
    as the implicit source/destination — the single-controller
    equivalent of "my rank" inside an SPMD process."""

    def __init__(self, comm: Communicator, rank: int) -> None:
        self.comm = comm
        self.rank = rank

    @property
    def device(self) -> torch.device:
        return self.comm.device

    def send(self, value, dest: int, tag: int = 0):
        return self.comm.send(value, dest, tag, source=self.rank)

    def isend(self, value, dest: int, tag: int = 0):
        return self.comm.isend(value, dest, tag, source=self.rank)

    def recv(self, source: int = -1, tag: int = -1):
        return self.comm.recv(source, tag, dest=self.rank)

    def irecv(self, source: int = -1, tag: int = -1):
        return self.comm.irecv(source, tag, dest=self.rank)

    def probe(self, source: int = -1, tag: int = -1):
        return self.comm.probe(source, tag, dest=self.rank)

    def iprobe(self, source: int = -1, tag: int = -1):
        return self.comm.iprobe(source, tag, dest=self.rank)

    def sendrecv(self, value, dest: int, source: int = -1, tag: int = 0):
        req = self.isend(value, dest, tag)
        out = self.recv(source, tag)
        req.wait()
        return out

    def put(self, value):
        """Place a value (a tensor, numpy array or scalar, or nested
        tuples, lists and dicts of them) on the comm's device: a tensor
        already there is itself, anything else a new tensor."""
        dev = self.comm.device

        def one(leaf):
            if isinstance(leaf, torch.Tensor):
                return leaf.to(dev)
            return torch.tensor(leaf, device=dev)

        return map_leaves(one, value)

    def __repr__(self) -> str:
        return f"<RankEndpoint {self.comm.name}:{self.rank}>"
