"""pml/ob1 — the matching/protocol engine for point-to-point messaging.

Port of ``ompi_tpu/pml/ob1.py`` (reference: protocol choice in
pml_ob1_sendreq.h:385-455 — eager / rendezvous split; receive-side
matching in pml_ob1_recvfrag.c — per-peer sequence ordering :387-412,
posted-recv vs unexpected queues :323,771).

Single-controller mapping: the controller issues every rank's sends and
receives, so the "wire" is the BTL transfer (a copy within the device's
memory) and the matching engine is a host-side state machine:

- envelope = (src, dst, tag, nbytes); MPI's non-overtaking order per
  (src, dst) is the unexpected queue's arrival order.
- eager (payload ≤ btl.eager_limit): the copy is made at send time; an
  unmatched arrival parks in the unexpected queue, its payload already
  copied for the destination — ob1's unexpected eager frag.
- rendezvous (payload > limit): the payload stays with the sender; the
  copy is made when a recv matches — ob1's RNDV/RGET.

Completion: a send completes once its payload is copied out (enqueued on
the current stream). A receive's copy onto a card is followed by a CUDA
event; ``RecvRequest.wait`` and ``Message.mrecv`` synchronize it before
they return. On the CPU the copy is done when ``transfer`` returns.

Left out until their slices: the cross-process branches (the fabric
engine, remote arrivals, ``block_on_progress``) and the monitoring of
p2p traffic. The source rank is never inferred from placement: every
rank of a process shares one device, so a send passes ``source=``
unless the communicator has one rank.
"""

from __future__ import annotations

import collections
import itertools
import threading
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from ..btl.framework import Bml
from ..coll.framework import record_completion
from ..core import memchecker, peruse
from ..core.counters import SPC
from ..core.errors import CommError, RankError, RequestError, TagError
from ..core.request import (ANY_SOURCE, ANY_TAG, Request, RequestState,
                            Status)
from ..core.tree import leaves
from .framework import PML, PmlComponent


@dataclass
class _Envelope:
    src: int
    dst: int
    tag: int
    nbytes: int


class SendRequest(Request):
    def __init__(self, env: _Envelope) -> None:
        super().__init__()
        self.env = env
        self.status = Status(source=env.src, tag=env.tag, count=env.nbytes)

    def _mark_sent(self, payload_dst: Any) -> None:
        self._complete(payload_dst, self.status)

    def _poll(self) -> bool:
        return self.done

    def wait(self, timeout: float | None = None) -> Status:
        if not self.done:
            # A rendezvous send completes only when a recv matches it. In
            # the single-controller model every recv is issued by this
            # same controller thread, so an unmatched blocking wait can never
            # be satisfied — fail fast instead of spinning (the blocking-
            # probe guard's twin; reference deadlocks instead).
            raise CommError(
                f"send {self.env} not matched by any recv: blocking wait "
                "would deadlock (post the matching recv first)"
            )
        return super().wait(timeout)


class RecvRequest(Request):
    def __init__(self, src: int, dst: int, tag: int) -> None:
        super().__init__()
        self.want_src = src
        self.dst = dst
        self.want_tag = tag
        self._event = None  # CUDA event after the payload's copy

    def _matched(self, env: _Envelope, payload: Any, event) -> None:
        self._event = event
        self.status = Status(source=env.src, tag=env.tag, count=env.nbytes)
        self._complete(payload, self.status)

    def _poll(self) -> bool:
        return self.done

    def wait(self, timeout: float | None = None) -> Status:
        if not self.done:
            # Same single-controller deadlock guard as SendRequest.wait:
            # no concurrent sender exists to match this recv later.
            raise CommError(
                f"recv (src={self.want_src}, dst={self.dst}, "
                f"tag={self.want_tag}) has no matching send: blocking "
                "wait would deadlock (issue the send first)"
            )
        st = super().wait(timeout)
        # Data completion: the copy into the received tensors has run.
        if self._event is not None:
            self._event.synchronize()
        return st


@dataclass
class _PendingSend:
    env: _Envelope
    payload_src: Any  # the sender's value (rndv until matched)
    eager: bool
    transferred: Any  # the receiver's copy once made
    event: Any  # CUDA event after that copy (None on the CPU)
    request: SendRequest
    src_proc: Any
    dst_proc: Any
    btl: Any

    def transfer(self) -> None:
        self.transferred = self.btl.transfer(
            self.payload_src, self.src_proc, self.dst_proc)
        self.event = record_completion(self.transferred)


class _CommP2P:
    """Per-communicator matching state. MPI's non-overtaking order falls
    out of arrival order: the controller issues sends/recvs sequentially, so
    arrival order IS send order per (src, dst) — the reference needs
    explicit per-peer sequence counters (pml_ob1_recvfrag.c:387-412) only
    because its fragments race over the wire.

    The unexpected queue is a dict in arrival order (sequence number ->
    pending send) beside an index of the sequence numbers per envelope
    (src, dst, tag), so a receive or probe naming its source and tag
    finds its first match without walking the queue (the partitioned
    layer keeps thousands of transfers in flight); a wildcard walks the
    queue in arrival order, as before."""

    def __init__(self) -> None:
        self.unexpected: dict[int, _PendingSend] = {}  # arrival order
        self.by_envelope: dict[tuple, collections.deque] = {}
        self.posted: list[RecvRequest] = []  # post order
        self._seq = itertools.count()
        self.arrivals = 0  # sends parked so far

    def park(self, pending: _PendingSend) -> None:
        seq = next(self._seq)
        self.arrivals += 1
        self.unexpected[seq] = pending
        env = pending.env
        self.by_envelope.setdefault(
            (env.src, env.dst, env.tag), collections.deque()).append(seq)

    def find(self, req: "RecvRequest") -> Optional[int]:
        """Sequence number of the first parked send ``req`` matches."""
        if req.state is not RequestState.ACTIVE:
            return None
        if req.want_src != ANY_SOURCE and req.want_tag != ANY_TAG:
            key = (req.want_src, req.dst, req.want_tag)
            q = self.by_envelope.get(key)  # take() keeps it exact
            return q[0] if q else None
        for seq, pending in self.unexpected.items():
            if Ob1Pml._compatible(req, pending.env):
                return seq
        return None

    def take(self, seq: int) -> _PendingSend:
        pending = self.unexpected.pop(seq)
        env = pending.env
        key = (env.src, env.dst, env.tag)
        q = self.by_envelope[key]
        q.remove(seq)  # its head: matching is first-come per envelope
        if not q:
            del self.by_envelope[key]
        return pending


def _nbytes_of(value) -> int:
    total = 0
    for leaf in leaves(value):
        if hasattr(leaf, "nbytes"):
            total += int(leaf.nbytes)
        elif isinstance(leaf, (bytes, bytearray, str)):
            total += len(leaf)
        elif isinstance(leaf, (bool, int, float, complex)):
            total += 8
        else:  # uncommon leaf types: best-effort array view
            try:
                total += np.asarray(leaf).nbytes
            except (TypeError, ValueError):
                total += 8
    return total


@PML.register
class Ob1Pml(PmlComponent):
    NAME = "ob1"
    PRIORITY = 50
    DESCRIPTION = "matching engine with eager/rndv protocols"

    def __init__(self, framework) -> None:
        super().__init__(framework)
        self._comm_state: dict[int, _CommP2P] = {}
        self._bml: dict[int, Bml] = {}
        # Matching mutex: posted/unexpected queues are check-then-act
        # structures; concurrent isend/irecv/progress threads must
        # match-or-park atomically (the reference serializes matching
        # with the ob1 matching lock; OPAL_THREAD_LOCK in
        # pml_ob1_recvfrag.c).
        self._mu = threading.RLock()

    # -- infrastructure ---------------------------------------------------

    def _state(self, comm) -> _CommP2P:
        st = self._comm_state.get(comm.cid)
        if st is None:
            # made once: a second thread's first touch (a send against
            # a progress sweep) must not park into a copy that is dropped
            with self._mu:
                st = self._comm_state.get(comm.cid)
                if st is None:
                    st = self._comm_state[comm.cid] = _CommP2P()
        return st

    def comm_freed(self, comm) -> None:
        """Drop per-comm matching state (called from Communicator.free);
        unmatched pending sends' buffers are released with it."""
        self._comm_state.pop(comm.cid, None)
        self._bml.pop(comm.cid, None)

    def bml(self, comm) -> Bml:
        b = self._bml.get(comm.cid)
        if b is None:
            b = Bml(comm)
            self._bml[comm.cid] = b
        return b

    @staticmethod
    def _infer_source(comm, source: Optional[int]) -> int:
        if source is not None:
            return comm.check_rank(source)
        # The JAX package reads the rank off the value's device; here
        # every rank shares the device, so only a one-rank comm knows.
        if comm.size == 1:
            return 0
        raise RankError(
            "cannot infer source rank from value placement; pass source="
        )

    def arrivals(self, comm) -> int:
        """How many sends have parked in ``comm``'s unexpected queue so
        far: a poller that found nothing to match needs to probe again
        only after this moves (the partitioned drain's skip)."""
        return self._state(comm).arrivals

    # -- send path --------------------------------------------------------

    def isend(self, comm, value, dest: int, tag: int,
              source: Optional[int] = None) -> SendRequest:
        if tag < 0:
            raise TagError(f"send tag must be >= 0, got {tag}")
        src = self._infer_source(comm, source)
        st = self._state(comm)
        env = _Envelope(
            src=src, dst=dest, tag=tag, nbytes=_nbytes_of(value)
        )
        btl = self.bml(comm).btl_for(src, dest)
        req = SendRequest(env)
        eager = env.nbytes <= btl.eager_limit
        pending = _PendingSend(
            env=env, payload_src=value, eager=eager, transferred=None,
            event=None, request=req, src_proc=comm.procs[src],
            dst_proc=comm.procs[dest], btl=btl,
        )
        SPC.record("pml_isend_calls")
        SPC.record("pml_send_bytes", env.nbytes)
        if eager:
            # Copy now; parks in the unexpected queue if no recv matches.
            pending.transfer()
            SPC.record("pml_eager_sends")
        else:
            SPC.record("pml_rndv_sends")
        memchecker.check_defined(value, "send buffer")
        peruse.fire(peruse.PeruseEvent.REQ_ACTIVATE, request=req,
                    kind="send")
        # Try to match an already-posted recv (order: post order);
        # match-or-park is atomic under the matching mutex.
        with self._mu:
            if not self._match_posted(st, pending):
                st.park(pending)
                peruse.fire(
                    peruse.PeruseEvent.QUEUE_UNEXPECTED, env=env
                )
        if eager:
            req._mark_sent(pending.transferred)
        return req

    def send(self, comm, value, dest: int, tag: int,
             source: Optional[int] = None):
        req = self.isend(comm, value, dest, tag, source=source)
        req.wait()
        return req

    # -- receive path -----------------------------------------------------

    def irecv(self, comm, source: int, tag: int,
              dest: Optional[int] = None) -> RecvRequest:
        if dest is None:
            raise RankError(
                "single-controller recv needs dest= (the receiving rank); or use "
                "comm.rank(i).recv(...)"
            )
        dest = comm.check_rank(dest)
        if source != ANY_SOURCE:
            source = comm.check_rank(source)
        req = RecvRequest(source, dest, tag)
        st = self._state(comm)
        SPC.record("pml_irecv_calls")
        peruse.fire(peruse.PeruseEvent.REQ_ACTIVATE, request=req,
                    kind="recv")
        with self._mu:
            if not self._match_unexpected(st, req):
                st.posted.append(req)
                peruse.fire(peruse.PeruseEvent.QUEUE_POSTED,
                            request=req)
        return req

    def recv(self, comm, source: int, tag: int,
             dest: Optional[int] = None):
        req = self.irecv(comm, source, tag, dest=dest)
        req.wait()
        return req.result()

    # -- matching ---------------------------------------------------------

    @staticmethod
    def _compatible(req: RecvRequest, env: _Envelope) -> bool:
        if req.state is not RequestState.ACTIVE:
            return False  # cancelled/completed recvs never match
        if env.dst != req.dst:
            return False
        if req.want_src != ANY_SOURCE and req.want_src != env.src:
            return False
        if req.want_tag != ANY_TAG and req.want_tag != env.tag:
            return False
        return True

    def _deliver(self, pending: _PendingSend, req: RecvRequest) -> None:
        peruse.fire(
            peruse.PeruseEvent.REQ_MATCH,
            env=pending.env, recv=req,
        )
        if pending.transferred is None:
            # Rendezvous: copy the payload now that the recv is matched.
            peruse.fire(
                peruse.PeruseEvent.REQ_XFER_BEGIN, env=pending.env
            )
            pending.transfer()
            pending.request._mark_sent(pending.transferred)
        req._matched(pending.env, pending.transferred, pending.event)

    def _match_posted(self, st: _CommP2P, pending: _PendingSend) -> bool:
        st.posted = [r for r in st.posted if r.state is RequestState.ACTIVE]
        for i, req in enumerate(st.posted):
            if self._compatible(req, pending.env):
                st.posted.pop(i)
                self._deliver(pending, req)
                return True
        return False

    def _match_unexpected(self, st: _CommP2P, req: RecvRequest) -> bool:
        seq = st.find(req)
        if seq is None:
            return False
        self._deliver(st.take(seq), req)
        return True

    # -- probe ------------------------------------------------------------

    def _probe_req(self, comm, source: int, tag: int,
                   dest: Optional[int], what: str) -> RecvRequest:
        if dest is None:
            raise RankError(f"single-controller {what} needs dest=")
        return RecvRequest(
            source if source == ANY_SOURCE else comm.check_rank(source),
            comm.check_rank(dest),
            tag,
        )

    def probe(self, comm, source: int, tag: int, *, dest: Optional[int] = None,
              blocking: bool = True) -> Optional[Status]:
        probe_req = self._probe_req(comm, source, tag, dest, "probe")
        st = self._state(comm)
        with self._mu:  # concurrent pops change the queue
            seq = st.find(probe_req)
            if seq is not None:
                env = st.unexpected[seq].env
                return Status(source=env.src, tag=env.tag, count=env.nbytes)
        if not blocking:
            return None
        raise TagError(
            "blocking probe would deadlock: no matching message and the "
            "controller issues all sends; use iprobe"
        )

    # -- matched probe (MPI_Mprobe/Mrecv; reference: ompi/message +
    # the mprobe entry in the pml module struct, pml.h:134-358) -------

    def improbe(self, comm, source: int, tag: int, *,
                dest: Optional[int] = None) -> Optional["Message"]:
        """Atomically match-and-remove an unexpected message; the
        returned handle can only be received via mrecv (no other recv
        can steal it — the matched-probe guarantee)."""
        probe_req = self._probe_req(comm, source, tag, dest, "improbe")
        st = self._state(comm)
        with self._mu:  # match-and-remove must be atomic vs matching
            seq = st.find(probe_req)
            if seq is not None:
                SPC.record("pml_improbe_hits")
                return Message(self, comm, st.take(seq), probe_req.dst)
        return None


class Message:
    """A matched-but-unreceived message (ompi_message_t analog)."""

    def __init__(self, pml, comm, pending, dest: int) -> None:
        self._pml = pml
        self._comm = comm
        self._pending = pending
        self._dest = dest
        self._received = False

    @property
    def status(self) -> Status:
        env = self._pending.env
        return Status(source=env.src, tag=env.tag, count=env.nbytes)

    def imrecv(self) -> RecvRequest:
        """MPI_Imrecv: receive exactly this message."""
        if self._received:
            raise RequestError("message already received")
        self._received = True
        env = self._pending.env
        req = RecvRequest(env.src, self._dest, env.tag)
        self._pml._deliver(self._pending, req)
        return req

    def mrecv(self):
        """MPI_Mrecv."""
        req = self.imrecv()
        req.wait()
        return req.result()
