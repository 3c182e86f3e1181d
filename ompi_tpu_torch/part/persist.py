"""part/persist — default partitioned-communication component.

Port of ``ompi_tpu/part/persist.py`` (reference: part_persist.h /
part_persist_sendreq.h — partitioned requests layered on persistent
point-to-point: the user's N partitions are re-blocked onto M internal
transfers, each an ordinary pml send/recv; Pready flags partitions and
transfers drain EAGERLY, out of order, the moment every partition
overlapping a transfer's range is flagged).

- Both sides derive the SAME internal-transfer count T from the total
  payload (element count x itemsize) and the shared
  ``part_persist_transfer_bytes`` / ``part_persist_max_transfers``
  cvars, so no handshake is needed. Partitions on either side are views
  over one flattened element space and transfers are block ranges of
  it (``framework.block_range``): N sender partitions vs M receiver
  partitions stay well-defined.
- Transfer k moves its element range as an ordinary pml isend tagged in
  a derived namespace: ``(user_tag + 1) * part_persist_tag_stride + k``.
  User traffic on the same (src, dst) must stay below the stride or use
  tags outside the band; wildcard source/tag matching is not available
  for partitioned receives.
- The receive side drains probe-then-recv (after a successful iprobe
  the matching irecv completes at once), pumped from the progress
  engine: the component registers one callback sweeping every active
  partitioned receive.

In the port the buffers are tensors on the communicator's device: a
send stages into its buffer in place (``stage``), each transfer is a
slice of it, the receiver's pieces are the pml's copies on the card,
and the assembled result is one tensor there. The JAX package's
``_fabric_engine`` returns the shm fabric's batch-dispatch engine when
one is live; ob1 has no cross-process fabric in the port yet (ROADMAP
Queue 1 item 8), so it returns None and a burst's transfers go out one
by one, as in the JAX package when no fabric is live.
"""

from __future__ import annotations

import math
import threading
from functools import partial
from typing import Any

import numpy as np
import torch

from ..core import config
from ..core import progress as _progress
from ..core.counters import SPC
from ..core.errors import ArgumentError, CommError, RequestError, TagError
from ..core.request import PartitionedRequest, RequestState, Status
from .framework import PART, PartComponent, block_range

_V = partial(config.register, "part", "persist")
_transfer_bytes = _V(
    "transfer_bytes", type=int, default=256 << 10,
    description="target bytes per internal transfer; a partitioned "
                "buffer drains as ceil(total_bytes / transfer_bytes) "
                "pml sends (clamped by part_persist_max_transfers)",
)
_max_transfers = _V(
    "max_transfers", type=int, default=64,
    description="upper bound on internal transfers per partitioned "
                "request",
)
_tag_stride = _V(
    "tag_stride", type=int, default=4096,
    description="derived-tag namespace width: transfer k of a "
                "partitioned pair with user tag t travels as pml tag "
                "(t + 1) * tag_stride + k",
)

# mpit pvars (pre-registered so MPI_T listings show them before use)
SPC.counter("part_partitions_flagged", "send partitions marked by Pready")
SPC.counter("part_partitions_arrived", "receive partitions completed")
SPC.counter("part_transfers_sent", "internal partitioned transfers sent")
SPC.counter("part_transfers_received",
            "internal partitioned transfers drained")
SPC.counter("part_drain_sweeps",
            "probe-then-recv sweeps over missing transfers")
SPC.counter("part_overlap_window_coalesced_total",
            "Pready bursts whose transfers rode one fastpath "
            "batch-dispatch window")


def _fabric_engine():
    """The fastpath fabric engine when ob1's shm fabric is live; ob1 has
    no cross-process fabric in the port yet, so there is none."""
    return None


def _transfer_count(total_elems: int, itemsize: int) -> int:
    nbytes = max(1, total_elems * itemsize)
    t = max(1, math.ceil(nbytes / max(1, _transfer_bytes.value)))
    return max(1, min(t, _max_transfers.value, total_elems))


def _base_tag(tag: int) -> int:
    if tag < 0:
        raise TagError(
            f"partitioned requests need a concrete tag >= 0, got {tag} "
            "(no wildcard matching in the derived-tag namespace)"
        )
    return (tag + 1) * _tag_stride.value


def torch_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).removeprefix("torch.")
    got = getattr(torch, name, None)
    if isinstance(got, torch.dtype):
        return got
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def _shape_dtype(like) -> tuple[tuple, torch.dtype]:
    """Shape/dtype of the receive template (a tensor, a ``meta`` tensor,
    anything with ``shape`` and ``dtype``, or what numpy accepts)."""
    if hasattr(like, "shape") and hasattr(like, "dtype"):
        return tuple(like.shape), torch_dtype(like.dtype)
    arr = np.asarray(like)
    return tuple(arr.shape), torch_dtype(arr.dtype)


def _as_buffer(value, device: torch.device) -> torch.Tensor:
    """``value`` as a tensor on ``device``: a tensor already there is
    used as it is (stage() writes land in it, the MPI "fill your
    partition region, then Pready it" pattern); numpy on the CPU shares
    its memory."""
    t = torch.as_tensor(value)
    return t if t.device == device else t.to(device)


class PersistPartSend(PartitionedRequest):
    """Send side: Pready flags partitions; a transfer fires the moment
    every partition overlapping its range is flagged (eager,
    out-of-order drain — reference part_persist_pready)."""

    def __init__(self, comp, comm, value, partitions, dest, tag,
                 source) -> None:
        super().__init__(partitions, sending=True)
        self._comp = comp
        self._comm = comm
        self._dest = dest
        self._tag = tag
        self._source = source
        self.buffer = _as_buffer(value, comm.device)
        self._elems = int(self.buffer.numel())
        self._itemsize = int(self.buffer.element_size())
        if self._elems < 1:
            raise ArgumentError("empty partitioned send buffer")
        if partitions > self._elems:
            raise ArgumentError(
                f"{partitions} partitions over {self._elems} elements"
            )
        _base_tag(tag)  # validate the tag up front
        self._ntransfers = _transfer_count(self._elems, self._itemsize)
        if self._ntransfers >= _tag_stride.value:
            raise ArgumentError(
                f"{self._ntransfers} transfers >= part_persist_tag_stride "
                f"{_tag_stride.value}; raise the stride or transfer_bytes"
            )
        self._flat = None
        self._fired = [False] * self._ntransfers
        # Transfers sent and not yet matched. The requests themselves are
        # not kept: a completed send's result is the receiver's copy,
        # which on one card should go once the receiver is done with it.
        self._unmatched = 0
        self._count_lock = threading.Lock()

    def bind(self, value) -> None:
        """Rebind the send buffer for the next start() (same total size
        and dtype, so both sides' transfer mapping stays valid)."""
        t = _as_buffer(value, self._comm.device)
        if (int(t.numel()) != self._elems
                or int(t.element_size()) != self._itemsize):
            raise ArgumentError(
                "bind() must preserve the partitioned buffer's element "
                "count and itemsize"
            )
        self.buffer = t

    def _start(self) -> None:
        # A view when the buffer is contiguous: stage() writes land in
        # the buffer itself and are picked up at fire time.
        self._flat = self.buffer.reshape(-1)
        self._fired = [False] * self._ntransfers
        self._unmatched = 0

    def stage(self, lo: int, hi: int, values) -> None:
        """Fill elements ``[lo, hi)`` of the ACTIVE send buffer before
        marking the covering partitions ready. Rejected once any
        partition overlapping the region is flagged (its transfer may
        already be on the wire)."""
        if self.state is not RequestState.ACTIVE:
            raise RequestError("stage() on a partitioned request that is "
                               "not active (call start() first)")
        if not 0 <= lo < hi <= self._elems:
            raise ArgumentError(
                f"stage range [{lo}, {hi}) outside [0, {self._elems})"
            )
        for p in range(self.partitions):
            plo, phi = block_range(p, self.partitions, self._elems)
            if phi <= lo:
                continue
            if plo >= hi:
                break
            if self._flagged[p]:
                raise RequestError(
                    f"stage([{lo}, {hi})) overlaps partition {p} already "
                    "marked ready this cycle"
                )
        flat_vals = torch.as_tensor(values).reshape(-1)
        if flat_vals.numel() != hi - lo:
            raise ArgumentError(
                f"stage([{lo}, {hi})) expects {hi - lo} elements, got "
                f"{flat_vals.numel()}"
            )
        self._flat[lo:hi].copy_(flat_vals, non_blocking=True)

    def _partitions_ready(self, partitions: list) -> None:
        """One burst: scan for newly covered transfers once, then fire
        them all. (The JAX package fires a burst of several inside the
        shm fabric's batch-dispatch window, counted on
        ``part_overlap_window_coalesced_total``; the port has no fabric
        yet.)"""
        SPC.record("part_partitions_flagged", len(partitions))
        for k in range(self._ntransfers):
            if not self._fired[k] and self._covered(k):
                self._fire(k)

    def _partition_ready(self, partition: int) -> None:
        self._partitions_ready([partition])

    def _covered(self, k: int) -> bool:
        """Is every partition overlapping transfer k's range flagged?"""
        lo, hi = block_range(k, self._ntransfers, self._elems)
        # partitions are block ranges too: only [p(lo), p(hi-1)] overlap
        for p in range(_block_of(lo, self.partitions, self._elems),
                       _block_of(hi - 1, self.partitions, self._elems) + 1):
            if not self._flagged[p]:
                return False
        return True

    def _fire(self, k: int) -> None:
        lo, hi = block_range(k, self._ntransfers, self._elems)
        req = self._comm.isend(
            self._flat[lo:hi], self._dest, _base_tag(self._tag) + k,
            source=self._source,
        )
        self._fired[k] = True
        with self._count_lock:
            self._unmatched += 1
        req.on_complete(self._matched)
        SPC.record("part_transfers_sent")

    def _matched(self, _req) -> None:
        with self._count_lock:
            self._unmatched -= 1

    def _poll(self) -> bool:
        if self.done:
            return True
        if all(self._fired) and not self._unmatched:
            self._complete(self.buffer, Status(
                source=self._source if self._source is not None else -1,
                tag=self._tag,
                count=self._elems * self._itemsize,
            ))
        return self.done


def _block_of(i: int, n: int, total: int) -> int:
    """The block of ``block_range(., n, total)`` holding element i."""
    base, rem = divmod(total, n)
    big = rem * (base + 1)  # elements in the first rem (larger) blocks
    if i < big:
        return i // (base + 1)
    return rem + (i - big) // base


class PersistPartRecv(PartitionedRequest):
    """Receive side: transfers drain probe-then-recv out of the pml as
    they land; Parrived(j) is true once every transfer overlapping
    partition j's range has drained. Draining runs from the component's
    progress callback and from Parrived/wait polling."""

    def __init__(self, comp, comm, partitions, source, tag, dest,
                 like) -> None:
        super().__init__(partitions, sending=False)
        if source is None or source < 0:
            raise ArgumentError(
                "partitioned recv needs a concrete source rank (no "
                "wildcard matching in the derived-tag namespace)"
            )
        shape, dtype = _shape_dtype(like)
        self._comp = comp
        self._comm = comm
        self._source = source
        self._tag = tag
        self._dest = dest
        self._shape = shape
        self._dtype = dtype
        self._elems = 1
        for d in shape:
            self._elems *= int(d)
        self._itemsize = int(torch.empty((), dtype=dtype).element_size())
        if self._elems < 1:
            raise ArgumentError("empty partitioned recv template")
        if partitions > self._elems:
            raise ArgumentError(
                f"{partitions} partitions over {self._elems} elements"
            )
        _base_tag(tag)  # validate the tag up front
        self._ntransfers = _transfer_count(self._elems, self._itemsize)
        self._got: dict[int, Any] = {}
        self._inflight: dict[int, Any] = {}
        self._arrived_parts = [False] * partitions
        # the assembled flat payload: once it exists the pieces are
        # dropped (on one card they would double the receive memory)
        self._flat = None
        self._seen = -1  # the pml's arrival count at the last probe
        self.narrived = 0  # partitions accounted as arrived

    def _start(self) -> None:
        self._got = {}
        self._inflight = {}
        self._arrived_parts = [False] * self.partitions
        self._flat = None
        self._seen = -1
        self.narrived = 0
        self._comp._activate(self)

    def _sweeps(self) -> bool:
        """Would a drain sweep run (active, transfers missing)?"""
        return (self.state is RequestState.ACTIVE and self._flat is None
                and len(self._got) < self._ntransfers)

    def _drain(self, stamp: int | None = None) -> int:
        """One probe-then-recv sweep over the still-missing transfers;
        returns the number drained (progress-engine event count).
        ``stamp`` is the pml's arrival count when the caller (the
        component's sweep) already read it and recorded the sweep."""
        if stamp is None:
            if not self._sweeps():
                return 0
            SPC.record("part_drain_sweeps")
            stamp = self._comm.pml.arrivals(self._comm)
        # Nothing parked since the last probe and nothing in flight: the
        # probes would all miss (thousands of them on a training step).
        if stamp == self._seen and not self._inflight:
            return 0
        self._seen = stamp
        n = 0
        for k in range(self._ntransfers):
            if k in self._got:
                continue
            req = self._inflight.get(k)
            if req is None:
                tag = _base_tag(self._tag) + k
                st = self._comm.iprobe(self._source, tag, dest=self._dest)
                if st is None:
                    continue
                req = self._comm.irecv(self._source, tag, dest=self._dest)
                self._inflight[k] = req
            if req._poll() or req.done:
                del self._inflight[k]
                self._got[k] = req._result
                n += 1
                SPC.record("part_transfers_received")
        if n:
            self._account_partitions()
            if len(self._got) == self._ntransfers:
                self._assemble()
        return n

    def _account_partitions(self) -> None:
        for j in range(self.partitions):
            if not self._arrived_parts[j] and self._part_done(j):
                self._arrived_parts[j] = True
                self.narrived += 1
                SPC.record("part_partitions_arrived")

    def _part_done(self, j: int) -> bool:
        if self._flat is not None:
            return True
        lo, hi = block_range(j, self.partitions, self._elems)
        for k in range(_block_of(lo, self._ntransfers, self._elems),
                       _block_of(hi - 1, self._ntransfers, self._elems) + 1):
            if k not in self._got:
                return False
        return True

    def _assemble(self) -> None:
        self._comp._deactivate(self)
        pieces = [self._got[k].reshape(-1) for k in range(self._ntransfers)]
        flat = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
        if int(flat.numel()) != self._elems or flat.dtype != self._dtype:
            self._complete(None, Status(
                source=self._source, tag=self._tag,
                error=CommError(
                    f"partitioned payload mismatch: received "
                    f"{int(flat.numel())} {flat.dtype} elements, template "
                    f"expects {self._elems} {self._dtype} (sender and "
                    f"receiver must agree on total count and dtype)"
                ),
            ))
            return
        self._flat = flat
        self._got = {}
        self._complete(flat.reshape(self._shape), Status(
            source=self._source, tag=self._tag,
            count=self._elems * self._itemsize,
        ))

    def _partition_arrived(self, partition: int) -> bool:
        if self._arrived_parts[partition]:
            # Already accounted: no probe sweep for a tile polled again.
            return True
        self._drain()
        return self._part_done(partition)

    def arrived_partitions(self) -> tuple:
        """Snapshot of per-partition arrival flags (no probe sweep)."""
        return tuple(self._arrived_parts)

    def partition_view(self, partition: int) -> torch.Tensor:
        """The arrived partition's elements as a flat tensor (the MPI-4
        guarantee that partition p's receive region is usable once
        Parrived(p) is true). Raises RequestError before arrival."""
        if not 0 <= partition < self.partitions:
            raise ArgumentError(
                f"partition {partition} out of range [0, "
                f"{self.partitions})"
            )
        if not self.parrived(partition):
            raise RequestError(
                f"partition_view({partition}) before arrival"
            )
        lo, hi = block_range(partition, self.partitions, self._elems)
        if self._flat is not None:
            return self._flat[lo:hi]
        pieces = []
        for k in range(_block_of(lo, self._ntransfers, self._elems),
                       _block_of(hi - 1, self._ntransfers, self._elems) + 1):
            klo, _ = block_range(k, self._ntransfers, self._elems)
            piece = self._got[k].reshape(-1)
            pieces.append(piece[max(lo - klo, 0):hi - klo])
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces)

    def _poll(self) -> bool:
        if self.done:
            return True
        self._drain()
        return self.done

    def wait(self, timeout: float | None = None) -> Status:
        st = super().wait(timeout)
        if isinstance(self._result, torch.Tensor) and self._result.is_cuda:
            torch.cuda.current_stream(self._result.device).synchronize()
        return st


@PART.register
class PersistPart(PartComponent):
    NAME = "persist"
    PRIORITY = 50
    DESCRIPTION = ("partitioned requests over pml sends (reference: "
                   "part/persist)")

    def __init__(self, framework) -> None:
        super().__init__(framework)
        self._active: list[PersistPartRecv] = []

    def open(self) -> None:
        super().open()
        _progress.register(self._progress)

    def close(self) -> None:
        _progress.unregister(self._progress)
        self._active.clear()
        super().close()

    def _activate(self, req: PersistPartRecv) -> None:
        if req not in self._active:
            self._active.append(req)

    def _deactivate(self, req: PersistPartRecv) -> None:
        try:
            self._active.remove(req)
        except ValueError:
            pass

    def _progress(self) -> int:
        """One drain sweep over every active receive: the pml's arrival
        count read once per communicator, the sweeps counted at once."""
        n = swept = 0
        stamps: dict = {}
        for req in list(self._active):
            if not req._sweeps():
                continue
            swept += 1
            comm = req._comm
            stamp = stamps.get(comm.cid)
            if stamp is None:
                stamp = stamps[comm.cid] = comm.pml.arrivals(comm)
            n += req._drain(stamp)
        if swept:
            SPC.record("part_drain_sweeps", swept)
        return n

    def psend_init(self, comm, value, partitions, dest, tag=0, *,
                   source=None):
        SPC.record("part_psend_init_calls")
        return PersistPartSend(self, comm, value, partitions, dest, tag,
                               source)

    def precv_init(self, comm, partitions, source, tag=0, *, dest, like):
        SPC.record("part_precv_init_calls")
        return PersistPartRecv(self, comm, partitions, source, tag, dest,
                               like)
