"""coll/nbc — nonblocking collectives as compiled round schedules.

Port of ``ompi_tpu/coll/nbc.py`` (reference: ompi/mca/coll/libnbc —
every nonblocking collective compiles into a *schedule*, rounds of
{SEND, RECV, OP, COPY} primitives, nbc_internal.h:149-155, started by
NBC_Start (nbc.c:265) and advanced one round at a time by the progress
engine). The schedules run over the ob1 p2p stack (``pml/ob1.py``):
each round's payloads are copied by the BTL, and local reductions run
as torch ops on the comm's device.

What schedules give beside the fused collectives of coll/pallas_ring
and coll/tuned (libnbc's rationale):

- true overlap: start many collectives, advance them round-by-round
  from the progress engine, complete out of order;
- algorithm transparency: the round structure *is* the algorithm
  (binomial tree, dissemination, recursive doubling, ring), testable
  round by round;
- p2p-composed collectives for communicators whose peers are reached
  over different transports.

Algorithms follow libnbc's choices (reference files
ompi/mca/coll/libnbc/nbc_i{bcast,barrier,allreduce,reduce,allgather,
alltoall,gather,scatter,scan,exscan,reduce_scatter}.c): binomial bcast
and reduce, dissemination barrier, recursive-doubling allreduce with
the non-power-of-two fold, ring allgather, pairwise alltoall, linear
gather/scatter/scan.

Tensors are mutable and buffers alias: a rank-major input's rows are
views of it, and a COPY primitive shares a tensor between two buffer
names. No primitive writes in place: an OP binds a new tensor (the op's
out-of-place combine) and every transfer copies. A round's receives
are retired once matched; their copies, the OPs that read them and the
result's assembly are all ordered on the current stream, and the
request's ``wait`` synchronizes the CUDA event recorded after the
result.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from ..core import progress as _progress
from ..core.counters import SPC
from ..core.errors import ArgumentError
from ..core.request import Request, Status
from ..ops import lookup as op_lookup
from ..ops.op import Op
from .framework import record_completion

__all__ = [
    "Schedule", "NbcRequest",
    "ibcast", "ibarrier", "iallreduce", "ireduce", "iallgather",
    "ialltoall", "igather", "iscatter", "ireduce_scatter_block",
    "iscan", "iexscan",
]

# Internal tag space for schedule traffic, disjoint from user tags
# (reference: collective-decomposed traffic runs on negative tags,
# common_monitoring.c internal-tag split; our PML requires tags >= 0 so
# the internal window starts high instead).
_NBC_TAG_BASE = 1 << 20
_tag_counter = itertools.count()


# ---------------------------------------------------------------------------
# Schedule IR (reference: nbc_internal.h:149-155 — NBC_Fn_type
# {SEND, RECV, OP, COPY, UNPACK}; rounds delimited by barriers)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _Send:
    src: int
    dst: int
    buf: str


@dataclass(frozen=True)
class _Recv:
    src: int
    dst: int
    buf: str  # destination buffer name on `dst`


@dataclass(frozen=True)
class _OpPrim:
    rank: int
    a: str
    b: str
    out: str


@dataclass(frozen=True)
class _Copy:
    rank: int
    src: str
    out: str


@dataclass
class Schedule:
    """Compiled collective: rounds of primitives for ALL ranks (the
    controller issues every rank's operations, so one schedule holds
    the whole job's round structure rather than one rank's slice)."""

    name: str
    size: int
    rounds: list[list[Any]] = field(default_factory=list)
    _current: list[Any] = field(default_factory=list)

    # -- builder API (reference: NBC_Sched_send/recv/op/copy +
    #    NBC_Sched_barrier ends a round) --------------------------------
    def send(self, src: int, dst: int, buf: str) -> None:
        self._current.append(_Send(src, dst, buf))

    def recv(self, src: int, dst: int, buf: str) -> None:
        self._current.append(_Recv(src, dst, buf))

    def move(self, src: int, dst: int, sbuf: str, rbuf: str) -> None:
        """send+recv pair: sbuf@src -> rbuf@dst."""
        self.send(src, dst, sbuf)
        self.recv(src, dst, rbuf)

    def op(self, rank: int, a: str, b: str, out: str) -> None:
        self._current.append(_OpPrim(rank, a, b, out))

    def copy(self, rank: int, src: str, out: str) -> None:
        self._current.append(_Copy(rank, src, out))

    def barrier(self) -> None:
        """End the current round (reference: NBC_Sched_barrier)."""
        if self._current:
            self.rounds.append(self._current)
            self._current = []

    def commit(self) -> "Schedule":
        self.barrier()
        return self

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

class NbcRequest(Request):
    """A started schedule (reference: NBC_Handle). One round advances
    per progress-engine tick (reference: NBC_Progress executes the
    current round's requests and only then moves to the next), so
    concurrently started collectives interleave their rounds."""

    def __init__(self, comm, sched: Schedule, env: dict, op: Optional[Op],
                 finish: Callable[[dict], Any]) -> None:
        super().__init__()
        self._comm = comm
        self._sched = sched
        self._env = env  # (rank, bufname) -> tensor on the comm's device
        self._op = op
        self._finish = finish
        self._event = None  # CUDA event after the result's assembly
        self._round = 0
        self._tag = _NBC_TAG_BASE + (next(_tag_counter) % (1 << 16))
        self._pending: list[tuple[Any, int, str]] = []  # (req, rank, buf)
        SPC.record("nbc_schedules_started")
        _progress.register(self._progress_cb)
        self._registered = True

    # -- round machinery --------------------------------------------------
    def _issue_round(self) -> None:
        """Round semantics: OP/COPY first (they consume the previous
        round's arrivals), then sends, then recvs — so a round reads
        "combine what arrived, then exchange". Sends precede recvs so
        every recv can match immediately (the controller issues both:
        arrival order == issue order)."""
        prims = self._sched.rounds[self._round]
        pml = self._comm.pml
        tag = self._tag + self._round
        for p in prims:
            if isinstance(p, _OpPrim):
                self._env[(p.rank, p.out)] = self._op.combine(
                    self._env[(p.rank, p.a)], self._env[(p.rank, p.b)]
                )
            elif isinstance(p, _Copy):
                self._env[(p.rank, p.out)] = self._env[(p.rank, p.src)]
        for p in prims:
            if isinstance(p, _Send):
                # in-process transport: matched by the irecv loop below
                pml.isend(
                    self._comm, self._env[(p.src, p.buf)], p.dst, tag,
                    source=p.src,
                )
        for p in prims:
            if isinstance(p, _Recv):
                req = pml.irecv(self._comm, p.src, tag, dest=p.dst)
                self._pending.append((req, p.dst, p.buf))

    def _round_done(self) -> bool:
        return all(r.done for r, _, _ in self._pending)

    def _retire_round(self) -> None:
        # Matched: the copies are enqueued, and what reads them next is
        # ordered after them on the stream — no host wait per round.
        for req, rank, buf in self._pending:
            self._env[(rank, buf)] = req._result
        self._pending = []
        self._round += 1
        SPC.record("nbc_rounds_progressed")

    def _progress_cb(self) -> int:
        """One tick: finish the in-flight round and/or start the next.
        Returns work count (progress-engine convention)."""
        if self.done:
            return 0
        if self._pending:
            if not self._round_done():
                return 0
            self._retire_round()
            return 1
        if self._round >= self._sched.n_rounds:
            result = self._finish(self._env)
            self._event = record_completion(result)
            self._complete(result)
            self._unregister()
            return 1
        self._issue_round()
        if self._round_done():
            self._retire_round()
        return 1

    def _unregister(self) -> None:
        if self._registered:
            _progress.unregister(self._progress_cb)
            self._registered = False

    # -- Request interface -------------------------------------------------
    def _poll(self) -> bool:
        if not self.done and not self._registered:
            # A previous wait() timed out and detached us; re-attach so
            # global progress() sweeps advance this schedule again.
            _progress.register(self._progress_cb)
            self._registered = True
        self._progress_cb()
        return self.done

    def wait(self, timeout: float | None = None) -> Status:
        if not _progress.ENGINE.progress_until(self._poll, timeout):
            # Detach from the engine so an abandoned schedule doesn't
            # pin its device buffers or spin on every future tick;
            # _poll re-attaches if the caller retries.
            self._unregister()
            raise TimeoutError(
                f"nbc {self._sched.name} stuck at round "
                f"{self._round}/{self._sched.n_rounds}"
            )
        if self._event is not None:
            self._event.synchronize()
        return self.status

    @property
    def rounds_done(self) -> int:
        return self._round


# ---------------------------------------------------------------------------
# Schedule compilers (one per collective; cached per shape-independent
# key — the round structure depends only on (size, root), mirroring
# libnbc's schedule cache keyed on the argument tuple)
# ---------------------------------------------------------------------------

_sched_cache: dict[tuple, Schedule] = {}


def _cached(key: tuple, build: Callable[[], Schedule]) -> Schedule:
    s = _sched_cache.get(key)
    if s is None:
        s = _sched_cache[key] = build().commit()
        SPC.record("nbc_schedules_compiled")
    return s


def _vrank(rank: int, root: int, size: int) -> int:
    return (rank - root) % size


def _rank_of(vrank: int, root: int, size: int) -> int:
    return (vrank + root) % size


def sched_bcast_binomial(size: int, root: int) -> Schedule:
    """Binomial-tree broadcast (reference: nbc_ibcast.c binomial path).

    Round k: every vrank < 2^k holding the data sends to vrank + 2^k.
    """
    s = Schedule("ibcast", size)
    dist = 1
    while dist < size:
        for v in range(dist):
            peer = v + dist
            if peer < size:
                s.move(
                    _rank_of(v, root, size), _rank_of(peer, root, size),
                    "buf", "buf",
                )
        s.barrier()
        dist <<= 1
    return s


def sched_barrier_dissemination(size: int) -> Schedule:
    """Dissemination barrier (reference: nbc_ibarrier.c — log2(n) rounds,
    round k: rank r sends to (r + 2^k) % n and receives from
    (r - 2^k) % n)."""
    s = Schedule("ibarrier", size)
    dist = 1
    while dist < size:
        for r in range(size):
            s.move(r, (r + dist) % size, "tok", "tok")
        s.barrier()
        dist <<= 1
    return s


def sched_allreduce_recursive_doubling(size: int) -> Schedule:
    """Recursive doubling with the non-power-of-two pre/post fold
    (reference: nbc_iallreduce.c NBC_ARED_RDBL; same structure as
    coll_base_allreduce.c:130)."""
    s = Schedule("iallreduce", size)
    pow2 = 1
    while pow2 * 2 <= size:
        pow2 *= 2
    rem = size - pow2
    # Pre-fold: ranks [pow2, size) send into ranks [0, rem).
    if rem:
        for i in range(rem):
            s.move(pow2 + i, i, "buf", "tmp")
        s.barrier()
        for i in range(rem):
            s.op(i, "buf", "tmp", "buf")
    # Recursive doubling among the first pow2 ranks.
    dist = 1
    while dist < pow2:
        for r in range(pow2):
            s.move(r, r ^ dist, "buf", "tmp")
        s.barrier()
        for r in range(pow2):
            s.op(r, "buf", "tmp", "buf")
        dist <<= 1
    # Post-fold: results back out to the folded ranks.
    if rem:
        for i in range(rem):
            s.move(i, pow2 + i, "buf", "buf")
        s.barrier()
    return s


def sched_reduce_binomial(size: int, root: int) -> Schedule:
    """Binomial-tree reduce (reference: nbc_ireduce.c binomial path;
    assumes a commutative op, as the reference's binomial path does)."""
    s = Schedule("ireduce", size)
    dist = 1
    while dist < size:
        for v in range(0, size, dist * 2):
            peer = v + dist
            if peer < size:
                s.move(
                    _rank_of(peer, root, size), _rank_of(v, root, size),
                    "buf", "tmp",
                )
        s.barrier()
        for v in range(0, size, dist * 2):
            if v + dist < size:
                s.op(_rank_of(v, root, size), "buf", "tmp", "buf")
        dist <<= 1
    return s


def sched_allgather_ring(size: int) -> Schedule:
    """Ring allgather (reference: nbc_iallgather.c / the ring in
    coll_base_allgather.c): step k, rank r passes block (r - k) mod n
    to rank r+1."""
    s = Schedule("iallgather", size)
    for step in range(size - 1):
        for r in range(size):
            blk = (r - step) % size
            s.move(r, (r + 1) % size, f"blk{blk}", f"blk{blk}")
        s.barrier()
    return s


def sched_alltoall_pairwise(size: int) -> Schedule:
    """Pairwise-exchange alltoall (reference: nbc_ialltoall.c
    NBC_A2A_PAIRWISE; coll_base_alltoall.c pairwise): step k, rank r
    sends its block for (r + k) and receives from (r - k)."""
    s = Schedule("ialltoall", size)
    for step in range(1, size):
        for r in range(size):
            dst = (r + step) % size
            s.move(r, dst, f"out{dst}", f"in{r}")
        s.barrier()
    return s


def sched_gather_linear(size: int, root: int) -> Schedule:
    """Linear gather (reference: nbc_igather.c — one round, everyone
    sends to root)."""
    s = Schedule("igather", size)
    for r in range(size):
        if r != root:
            s.move(r, root, "buf", f"in{r}")
    return s


def sched_scatter_linear(size: int, root: int) -> Schedule:
    """Linear scatter (reference: nbc_iscatter.c)."""
    s = Schedule("iscatter", size)
    for r in range(size):
        if r != root:
            s.move(root, r, f"out{r}", "buf")
    return s


def sched_scan_linear(size: int, *, exclusive: bool) -> Schedule:
    """Linear scan chain (reference: nbc_iscan.c / nbc_iexscan.c — rank
    r receives the running prefix from r-1, combines, forwards)."""
    s = Schedule("iexscan" if exclusive else "iscan", size)
    if size == 1:
        return s
    # Rank r's forwarded value is the inclusive prefix through r; the
    # exclusive result at r is exactly what arrives from r-1. Combines
    # open the round AFTER the arrival (OP runs at round issue).
    s.copy(0, "buf", "acc")
    for r in range(1, size):
        s.move(r - 1, r, "acc", "prev")
        s.barrier()
        s.op(r, "prev", "buf", "acc")
        s.copy(r, "prev" if exclusive else "acc", "res")
    if not exclusive:
        s.copy(0, "buf", "res")
    return s


# ---------------------------------------------------------------------------
# Public API: rank-major input -> NbcRequest -> rank-major result
# ---------------------------------------------------------------------------

def _rank_major(comm, x) -> torch.Tensor:
    """``x`` as a rank-major tensor on the comm's device: a tensor
    already there is itself; anything else (a numpy array, a tensor
    elsewhere) goes through ``put_rank_major``."""
    if not (isinstance(x, torch.Tensor) and x.device == comm.device):
        return comm.put_rank_major(x)
    if x.ndim < 1 or x.shape[0] != comm.size:
        raise ArgumentError(
            f"expected rank-major leading dim {comm.size}, got "
            f"{tuple(x.shape)}"
        )
    return x


def _rank_blocks(comm, x, buf: str = "buf") -> dict:
    """Split a rank-major buffer into per-rank blocks env: rank r's
    block is the view ``x[r]`` on the comm's device."""
    x = _rank_major(comm, x)
    return {(r, buf): x[r] for r in range(comm.size)}


def _rank_rows(comm, x, min_ndim: int = 1) -> list:
    """Per-rank rows of a rank-major buffer (views on the comm's
    device)."""
    env = _rank_blocks(comm, x)
    rows = [env[(r, "buf")] for r in range(comm.size)]
    if rows[0].ndim < min_ndim:
        raise ArgumentError(
            f"expected rank blocks of ndim >= {min_ndim}, got "
            f"{tuple(rows[0].shape)}"
        )
    return rows


def _assemble(comm, env, buf: str = "buf"):
    return comm.from_rank_values(
        [env[(r, buf)] for r in range(comm.size)]
    )


def ibcast(comm, x, root: int = 0) -> NbcRequest:
    root = comm.check_rank(root)
    n = comm.size
    sched = _cached(("bcast", n, root), lambda: sched_bcast_binomial(n, root))
    env = _rank_blocks(comm, x)
    return NbcRequest(comm, sched, env, None, lambda e: _assemble(comm, e))


def ibarrier(comm) -> NbcRequest:
    n = comm.size
    sched = _cached(("barrier", n), lambda: sched_barrier_dissemination(n))
    env = {
        (r, "tok"): torch.zeros((), dtype=torch.int32, device=comm.device)
        for r in range(n)
    }
    return NbcRequest(comm, sched, env, None, lambda e: None)


def iallreduce(comm, x, op="sum") -> NbcRequest:
    op = op_lookup(op)
    n = comm.size
    sched = _cached(
        ("allreduce", n), lambda: sched_allreduce_recursive_doubling(n)
    )
    env = _rank_blocks(comm, x)
    return NbcRequest(comm, sched, env, op, lambda e: _assemble(comm, e))


def ireduce(comm, x, op="sum", root: int = 0) -> NbcRequest:
    op = op_lookup(op)
    root = comm.check_rank(root)
    n = comm.size
    sched = _cached(
        ("reduce", n, root), lambda: sched_reduce_binomial(n, root)
    )
    env = _rank_blocks(comm, x)
    # One rank: root's buf is still the input's row; hand back a
    # tensor of its own, as every transfer does.
    return NbcRequest(
        comm, sched, env, op,
        lambda e: e[(root, "buf")] if n > 1 else e[(root, "buf")].clone()
    )


def iallgather(comm, x) -> NbcRequest:
    n = comm.size
    sched = _cached(("allgather", n), lambda: sched_allgather_ring(n))
    rows = _rank_rows(comm, x)
    env = {(r, f"blk{r}"): rows[r] for r in range(n)}

    def finish(e):
        return comm.from_rank_values([
            torch.stack([e[(r, f"blk{i}")] for i in range(n)])
            for r in range(n)
        ])

    return NbcRequest(comm, sched, env, None, finish)


def ialltoall(comm, x) -> NbcRequest:
    n = comm.size
    sched = _cached(("alltoall", n), lambda: sched_alltoall_pairwise(n))
    rows = _rank_rows(comm, x, min_ndim=1)
    if rows[0].shape[0] != n:
        raise ArgumentError(
            f"expected [size, size, ...] blocks, got rank rows of "
            f"shape {tuple(rows[0].shape)}"
        )
    env = {}
    for r in range(n):
        for d in range(n):
            env[(r, f"out{d}")] = rows[r][d]  # a view on the device
        env[(r, f"in{r}")] = env[(r, f"out{r}")]  # self block stays

    def finish(e):
        return comm.from_rank_values([
            torch.stack([e[(r, f"in{src}")] for src in range(n)])
            for r in range(n)
        ])

    return NbcRequest(comm, sched, env, None, finish)


def igather(comm, x, root: int = 0) -> NbcRequest:
    root = comm.check_rank(root)
    n = comm.size
    sched = _cached(("gather", n, root), lambda: sched_gather_linear(n, root))
    env = _rank_blocks(comm, x)
    env[(root, f"in{root}")] = env[(root, "buf")]

    def finish(e):
        return torch.stack([e[(root, f"in{r}")] for r in range(n)])

    return NbcRequest(comm, sched, env, None, finish)


def iscatter(comm, x, root: int = 0) -> NbcRequest:
    root = comm.check_rank(root)
    n = comm.size
    sched = _cached(
        ("scatter", n, root), lambda: sched_scatter_linear(n, root)
    )
    rows = _rank_major(comm, x)
    env = {(root, f"out{r}"): rows[r] for r in range(n)}
    env[(root, "buf")] = env[(root, f"out{root}")]
    return NbcRequest(comm, sched, env, None, lambda e: _assemble(comm, e))


def ireduce_scatter_block(comm, x, op="sum") -> NbcRequest:
    """Reduce+scatter composition (reference: nbc_ireduce_scatter.c uses
    a reduce-then-scatterv schedule)."""
    op = op_lookup(op)
    n = comm.size
    root = 0
    key = ("reduce_scatter_block", n)

    def build():
        s = sched_reduce_binomial(n, root)
        s.barrier()
        # Scatter row r of the reduced rank-major buffer to rank r.
        for r in range(n):
            if r != root:
                s.move(root, r, f"rsblk{r}", "rsout")
        return s

    sched = _cached(key, build)
    env = _rank_blocks(comm, x)
    if env[(0, "buf")].ndim < 1 or env[(0, "buf")].shape[0] != n:
        raise ArgumentError(
            f"expected [size, size, ...] blocks, got rank rows of "
            f"shape {tuple(env[(0, 'buf')].shape)}"
        )

    def finish(e):
        reduced = e[(root, "buf")]  # [n, ...] reduced blocks at root
        out = [None] * n
        for r in range(n):
            out[r] = e[(r, "rsout")] if r != root else reduced[root]
        return comm.from_rank_values(out)

    # rsblk slices of root's reduced buffer only exist after the reduce
    # rounds; a lazy env takes them (views on the device) when the
    # scatter round reads them. Built BEFORE the request so no progress
    # tick can observe the plain dict.
    class _LazyEnv(dict):
        def __getitem__(self, key):
            rank, buf = key
            if buf.startswith("rsblk") and key not in self:
                idx = int(buf[5:])
                self[key] = dict.__getitem__(self, (rank, "buf"))[idx]
            return dict.__getitem__(self, key)

    return NbcRequest(comm, sched, _LazyEnv(env), op, finish)


def iscan(comm, x, op="sum") -> NbcRequest:
    op = op_lookup(op)
    n = comm.size
    sched = _cached(("scan", n), lambda: sched_scan_linear(n, exclusive=False))
    env = _rank_blocks(comm, x)
    if n == 1:
        env[(0, "res")] = env[(0, "buf")]
    return NbcRequest(
        comm, sched, env, op, lambda e: _assemble(comm, e, "res")
    )


def iexscan(comm, x, op="sum") -> NbcRequest:
    """Exclusive scan; rank 0's result is op-identity-shaped zeros
    (MPI leaves it undefined; we define it as identity when known)."""
    op = op_lookup(op)
    n = comm.size
    sched = _cached(("exscan", n), lambda: sched_scan_linear(n, exclusive=True))
    env = _rank_blocks(comm, x)
    env[(0, "res")] = (
        op.identity_like(env[(0, "buf")])
        if op.has_identity
        else env[(0, "buf")]
    )
    return NbcRequest(
        comm, sched, env, op, lambda e: _assemble(comm, e, "res")
    )
