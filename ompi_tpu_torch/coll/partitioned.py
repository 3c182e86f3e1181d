"""coll/partitioned — bucketed collectives fed by partition readiness.

Port of ``ompi_tpu/coll/partitioned.py``: a large reduction buffer is
split into buckets (or tiles) along the element axis, and each one's
reduction is dispatched the moment the producing computation marks it
ready, instead of one collective after all the compute finishes.

- :class:`BucketedAllreduce` sends each bucket through the
  communicator's vtable (``comm.allreduce``), so tuned's table (and the
  quantized wire, when enabled) decides per bucket at bucket size.
- :class:`PartitionedAllreduce` reduces one rank-major ``(size, E)``
  bucket tile by tile over the part framework: persistent
  ``Psend_init``/``Precv_init`` pairs (every peer to the root) bound
  once and re-armed each step, the root combining each tile as it
  lands, then one ``comm.bcast`` of the reduced buffer (or, under a
  compiled step program, one merged broadcast for the whole step).

Bucket ranges come from :func:`ompi_tpu_torch.part.framework.block_range`,
the distribution part/persist uses for its partition→transfer mapping.

In the port every buffer of the data path is a tensor on the
communicator's device: the peers' wire buffers, the root's accumulator
(float64, as the JAX package's host accumulator), the quant codec
(``coll.quant``'s torch codec) and the broadcast's input. The host keeps
the per-tile bookkeeping only. The stream current at ``start()`` orders
a flow's device work: ``ready_range`` and the drain enter it on
whichever thread runs them (the DP overlap session's producer, pump and
caller threads), so the staging copies, the arrivals' combines and the
broadcast run in the order the host issued them.
"""

from __future__ import annotations

import itertools
import math
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable

import torch

from ..core import progress as _progress
from ..core.counters import SPC
from ..core.errors import ArgumentError, RequestError
from ..part.framework import block_range

SPC.counter(
    "part_coll_buckets_ready",
    "buckets handed to the coll layer by readiness order",
)
SPC.counter(
    "part_tiles_ready_total",
    "gradient tiles marked ready on partitioned allreduces",
)


@contextmanager
def _batch_window():
    """The fastpath dispatch-coalescing window when a shm fabric is
    live; ob1 has none in the port yet, so it is transparent."""
    from ..part.persist import _fabric_engine

    eng = _fabric_engine()
    if eng is None:
        yield
    else:
        with eng.batch_dispatch():
            yield


def current_stream(device: torch.device):
    """The thread's current CUDA stream on ``device`` (None on the
    CPU)."""
    return torch.cuda.current_stream(device) if device.type == "cuda" else None


@contextmanager
def on_stream(stream):
    """Enter ``stream`` on this thread (nothing for None)."""
    if stream is None:
        yield
    else:
        with torch.cuda.stream(stream):
            yield


def _rank_major_2d(comm, x, what: str) -> torch.Tensor:
    arr = torch.as_tensor(x)
    if arr.ndim < 2 or arr.shape[0] != comm.size:
        raise ArgumentError(
            f"{what} needs rank-major (size, E, ...) buffer, got shape "
            f"{tuple(arr.shape)}")
    return arr if arr.device == comm.device else arr.to(comm.device)


class BucketedAllreduce:
    """Allreduce over a rank-major ``(size, E)`` buffer, dispatched one
    bucket at a time as ``ready(b)`` is called (any order). ``wait()``
    returns the assembled ``(size, E)`` result.

    Each ``ready(b)`` enqueues that bucket's collective on the current
    stream and returns, so bucket b's device time runs under the
    caller's compute for bucket b+1. Each bucket goes through
    ``comm.allreduce``, the normal vtable."""

    def __init__(self, comm, x, op: Any = "sum", nbuckets: int = 8) -> None:
        arr = _rank_major_2d(comm, x, "bucketed allreduce")
        elems = arr.shape[1]
        if nbuckets < 1:
            raise ArgumentError(f"nbuckets must be >= 1, got {nbuckets}")
        if nbuckets > elems:
            nbuckets = elems
        self._comm = comm
        self._op = op
        self.buffer = arr
        self.nbuckets = nbuckets
        self._elems = elems
        self._pending: list[Any] = [None] * nbuckets
        self._done = False

    def bucket_range(self, b: int) -> tuple[int, int]:
        """Element range [lo, hi) of bucket b along axis 1."""
        if not 0 <= b < self.nbuckets:
            raise ArgumentError(
                f"bucket {b} out of range [0, {self.nbuckets})"
            )
        return block_range(b, self.nbuckets, self._elems)

    def ready(self, b: int, data=None) -> None:
        """Mark bucket b produced and dispatch its allreduce. ``data``
        optionally supplies fresh values for the bucket's ``(size,
        hi-lo, ...)`` slab; omitted, the constructor buffer's slab is
        used."""
        lo, hi = self.bucket_range(b)
        if self._pending[b] is not None:
            raise RequestError(f"bucket {b} already dispatched")
        if data is None:
            slab = self.buffer[:, lo:hi]
        else:
            slab = torch.as_tensor(data).to(self._comm.device)
        if tuple(slab.shape[:2]) != (self._comm.size, hi - lo):
            raise ArgumentError(
                f"bucket {b} slab must be ({self._comm.size}, {hi - lo}, "
                f"...), got {tuple(slab.shape)}"
            )
        SPC.record("part_coll_buckets_ready")
        self._pending[b] = self._comm.allreduce(slab.contiguous(), self._op)

    def ready_all(self) -> None:
        """Dispatch every not-yet-ready bucket in index order."""
        for b in range(self.nbuckets):
            if self._pending[b] is None:
                self.ready(b)

    def wait(self) -> torch.Tensor:
        """Return the reassembled rank-major ``(size, E, ...)`` result
        once every bucket's collective is complete."""
        missing = [b for b, p in enumerate(self._pending) if p is None]
        if missing:
            raise RequestError(
                f"wait() before ready() on buckets {missing}"
            )
        out = torch.cat(self._pending, dim=1)
        if out.is_cuda:
            torch.cuda.current_stream(out.device).synchronize()
        self._done = True
        return out


class PartitionedAllreduce:
    """Persistent tile-granular allreduce of one rank-major ``(size,
    E)`` bucket over the part framework: one ``Psend_init`` /
    ``Precv_init`` pair per peer bound ONCE at construction and re-armed
    every step by ``start()``. ``ready(t, data)`` / ``ready_range(lo,
    hi, data)`` stage a tile's values into the persistent wire buffers
    and fire ``Pready`` on every peer; arrivals drain via ``Parrived``
    from the progress engine (``_pump``), and the root combines each
    tile the moment it lands from all peers.

    Reduction plan: gather-to-root with eager per-tile combine (arrival
    order, hence the commutative-op requirement), then one
    ``comm.bcast`` of the reduced buffer fired from the drain the moment
    the last tile lands.

    Wire tier: the bucket's precision is chosen by the same tuned
    precedence as a monolithic allreduce of its size
    (``tuned.decide_allreduce``). A quantized decision that coll/quant
    supports sends block-scaled int8 + f32 scales; otherwise exact.
    Tiles are padded to a uniform size (on the quant wire to a
    scale-block multiple) so tile t owns wire range ``[t*W, (t+1)*W)``.
    """

    #: Tag allocator for auto-tagged instances (one user tag each).
    _tags = itertools.count(768)

    def __init__(self, comm, like, op: Any = "sum", tiles: int = 8,
                 tag: int | None = None, root: int = 0,
                 allow_quant: bool | None = None,
                 label: str | None = None,
                 tile_elems: int | None = None,
                 defer_bcast: bool = False,
                 auto_pump: bool = True) -> None:
        from ..ops import lookup as op_lookup
        from . import quant as _quant
        from . import tuned as _tuned

        arr = torch.as_tensor(like)
        if arr.ndim != 2 or arr.shape[0] != comm.size:
            raise ArgumentError(
                f"partitioned allreduce needs a rank-major (size, E) "
                f"template, got shape {tuple(arr.shape)}"
            )
        self._comm = comm
        self._root = comm.check_rank(root)
        self._op = op_lookup(op)
        if not self._op.commutative:
            raise ArgumentError(
                f"partitioned allreduce combines tiles in arrival "
                f"order; op {self._op.name!r} is not commutative"
            )
        self._elems = int(arr.shape[1])
        if self._elems < 1:
            raise ArgumentError("empty partitioned allreduce template")
        self.tiles = max(1, min(int(tiles), self._elems))
        self._dtype = arr.dtype
        self.label = label or f"cid{comm.cid}"
        # Step-program executor hooks: defer the per-bucket bcast (the
        # executor fires ONE merged broadcast) and leave the drain to
        # the executor's single merged callback.
        self._defer_bcast = bool(defer_bcast)
        self._auto_pump = bool(auto_pump)
        self._local = None

        itemsize = arr.element_size()
        nbytes = self._elems * itemsize
        self.algo = _tuned.decide_allreduce(
            self._op, nbytes, comm.size, arr.dtype,
            allow_quant=allow_quant,
        )
        self.quant_wire = bool(
            _tuned.is_quant_algo(self.algo)
            and _quant.supports(self._op, arr.dtype)
        )

        # Uniform tile geometry over a padded element space (on the
        # quant wire a tile rounds up to a scale-block multiple).
        if tile_elems is not None:
            et = max(1, min(int(tile_elems), self._elems))
        else:
            et = math.ceil(self._elems / self.tiles)
        if self.quant_wire:
            block = _quant._block_var.value
            et = block * math.ceil(et / block)
            self._scales_per_tile = et // block
            self._wire_tile = et + 4 * self._scales_per_tile  # bytes
            wire_dtype = torch.uint8
        else:
            self._scales_per_tile = 0
            self._wire_tile = et  # elements
            wire_dtype = self._dtype
        self.tiles = math.ceil(self._elems / et)
        self.tile_elems = et
        wire_len = self.tiles * self._wire_tile

        # Persistent pairs, bound once: every peer sends its shard to
        # root; root receives one partitioned request per peer.
        self.tag = next(self._tags) if tag is None else int(tag)
        self._peers = [r for r in range(comm.size) if r != self._root]
        dev = comm.device
        self._send_bufs = {
            r: torch.zeros(wire_len, dtype=wire_dtype, device=dev)
            for r in self._peers
        }
        self._sreqs = {
            r: comm.psend_init(self._send_bufs[r], self.tiles,
                               self._root, self.tag, source=r)
            for r in self._peers
        }
        wire_like = torch.empty((wire_len,), dtype=wire_dtype,
                                device="meta")
        self._rreqs = {
            r: comm.precv_init(self.tiles, r, self.tag,
                               dest=self._root, like=wire_like)
            for r in self._peers
        }
        self._active = False
        self._stream = None
        # Serializes tile accumulation between the producer (the root's
        # own contribution in ready_range) and drain sweeps on other
        # threads; RLock so a pump nested under _finish_reduce's bcast
        # never self-deadlocks.
        self._lock = threading.RLock()
        self._acc = None
        self._reduce_done = False
        self._result = None
        self.trace_id = 0
        self.t_first_ready = None
        self.t_reduce_done = None

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "PartitionedAllreduce":
        """Re-arm every persistent pair and reset per-step tile state."""
        from ..communicator import start_all

        if self._active:
            raise RequestError("start() on an active partitioned "
                               "allreduce")
        start_all(list(self._sreqs.values()) + list(self._rreqs.values()))
        self._active = True
        self._stream = current_stream(self._comm.device)
        self._acc = torch.zeros(self.tiles * self.tile_elems,
                                dtype=torch.float64,
                                device=self._comm.device)
        # start() happens-before every pready/_combine of this epoch, so
        # no combiner thread races these resets.
        self._have = [0] * self.tiles
        self._ready = [False] * self.tiles
        self._integrated = {r: [False] * self.tiles for r in self._peers}
        self._nintegrated = {r: 0 for r in self._peers}
        self._tiles_reduced = 0
        self._reduce_done = False
        self._result = None
        self._local = None
        self.trace_id = 0
        self.t_first_ready = None
        self.t_reduce_done = None
        if self._auto_pump:
            _progress.register(self._pump)
        return self

    def tile_range(self, t: int) -> tuple[int, int]:
        """Logical element range [lo, hi) of tile t (unpadded space)."""
        if not 0 <= t < self.tiles:
            raise ArgumentError(f"tile {t} out of range [0, {self.tiles})")
        lo = t * self.tile_elems
        return lo, min(lo + self.tile_elems, self._elems)

    # -- producer side ----------------------------------------------------

    def ready(self, t: int, data) -> None:
        """Mark tile t produced: ``data`` is the rank-major ``(size,
        hi-lo)`` slab of fresh values for the tile's element range."""
        self.ready_range(t, t, data)

    def ready_range(self, lo: int, hi: int, data) -> None:
        """Pready_range analog (inclusive bounds): stage tiles lo..hi
        and flag them on every peer in one batch-dispatch window."""
        from ..trace import span as tspan

        if not self._active:
            raise RequestError("ready() before start()")
        llo, _ = self.tile_range(lo)
        _, lhi = self.tile_range(hi)
        if hi < lo:
            raise ArgumentError(f"ready_range: hi {hi} < lo {lo}")
        slab = torch.as_tensor(data)
        if slab.device != self._comm.device:
            slab = slab.to(self._comm.device)
        if tuple(slab.shape) != (self._comm.size, lhi - llo):
            raise ArgumentError(
                f"tiles [{lo}, {hi}] slab must be "
                f"({self._comm.size}, {lhi - llo}), got {tuple(slab.shape)}"
            )
        for t in range(lo, hi + 1):
            if self._ready[t]:
                raise RequestError(
                    f"tile {t} already marked ready this step"
                )
        now = time.perf_counter()
        if self.t_first_ready is None:
            self.t_first_ready = now
        padded = lhi - llo != (hi - lo + 1) * self.tile_elems
        with on_stream(self._stream), _batch_window():
            for r in self._peers:
                if self.quant_wire:
                    wire = torch.cat([self._encode_tile(slab[r], t, llo)
                                      for t in range(lo, hi + 1)])
                elif not padded:
                    wire = slab[r]  # no padding in range: the row itself
                else:
                    # only the buffer's LAST tile is ever short: one
                    # zero-padded copy covers the range
                    wire = torch.zeros((hi - lo + 1) * self.tile_elems,
                                       dtype=self._dtype,
                                       device=slab.device)
                    wire[: lhi - llo] = slab[r]
                sreq = self._sreqs[r]
                sreq.stage(lo * self._wire_tile,
                           (hi + 1) * self._wire_tile, wire)
                sreq.pready_range(lo, hi)
            for t in range(lo, hi + 1):
                self._ready[t] = True
                tlo, thi = self.tile_range(t)
                self._combine(t, slab[self._root, tlo - llo:thi - llo])
                tspan.instant(
                    "part.ready", cat="part", trace_id=self.trace_id,
                    tile=t, bucket=self.label, tag=self.tag,
                )
        SPC.record("part_tiles_ready_total", hi - lo + 1)

    def _encode_tile(self, row: torch.Tensor, t: int, base_lo: int
                     ) -> torch.Tensor:
        """Wire image of one peer's tile t from ``row`` (the peer's
        values for the staged logical range starting at base_lo)."""
        from . import quant as _quant

        tlo, thi = self.tile_range(t)
        seg = torch.zeros(self.tile_elems, dtype=self._dtype,
                          device=row.device)
        seg[: thi - tlo] = row[tlo - base_lo: thi - base_lo]
        if not self.quant_wire:
            return seg
        q, scales = _quant.quantize_block_scaled(seg)
        return torch.cat([q.view(torch.uint8),
                          scales.to(torch.float32).view(torch.uint8)])

    def _decode_tile(self, wire: torch.Tensor) -> torch.Tensor:
        from . import quant as _quant

        if not self.quant_wire:
            return wire
        q = wire[: self.tile_elems].view(torch.int8)
        # a copy: the scales may start at any byte of a received piece
        scales = wire[self.tile_elems:].clone().view(torch.float32)
        return _quant.dequantize_block_scaled(q, scales)

    # -- consumer side (progress-engine drain) ----------------------------

    def _combine(self, t: int, vals: torch.Tensor) -> None:
        lo = t * self.tile_elems
        v = vals.reshape(-1).to(torch.float64)
        # The producer's root contribution and the drain race here: the
        # _have check-then-act and the _tiles_reduced tally are atomic,
        # and so is the order of the device ops on the accumulator.
        with self._lock:
            # the accumulator's pad (the final tile's tail) stays zero
            # from start() and is trimmed before use
            view = self._acc[lo: lo + v.numel()]
            if self._have[t] == 0:
                view.copy_(v)
            else:
                view.copy_(self._op.combine(view, v))
            self._have[t] += 1
            tile_done = self._have[t] == self._comm.size
            if tile_done:
                self._tiles_reduced += 1
            all_done = tile_done and self._tiles_reduced == self.tiles
        if tile_done:
            from ..trace import span as tspan

            tspan.instant(
                "part.arrived", cat="part", trace_id=self.trace_id,
                tile=t, bucket=self.label, tag=self.tag,
            )
        if all_done:
            # Exactly one thread observes the final increment; the bcast
            # runs outside the lock.
            self._finish_reduce()

    def _pump(self) -> int:
        """Progress callback: integrate newly arrived tiles (the part
        component's own callback runs the probe-then-recv sweep)."""
        if not self._active or self._reduce_done:
            return 0
        with on_stream(self._stream):
            return self._integrate()

    def _integrate(self) -> int:
        n = 0
        for r in self._peers:
            rreq = self._rreqs[r]
            if rreq.narrived == self._nintegrated[r]:
                continue  # nothing new from this peer
            arrived = rreq.arrived_partitions()
            mine = self._integrated[r]
            for t in range(self.tiles):
                if arrived[t] and not mine[t]:
                    # claim under the lock: a tile integrates once even
                    # when two sweeps run concurrently
                    with self._lock:
                        if mine[t]:
                            continue
                        mine[t] = True
                        self._nintegrated[r] += 1
                    vals = self._decode_tile(rreq.partition_view(t))
                    n += 1
                    self._combine(t, vals)
                    if self._reduce_done:
                        return n
        return n

    def _finish_reduce(self) -> None:
        """All tiles combined: cut the padding and broadcast the reduced
        buffer through the coll vtable (from the drain, so it still
        overlaps any remaining producer compute)."""
        self.t_reduce_done = time.perf_counter()
        reduced = self._acc[: self._elems].to(self._dtype)
        self._acc = None  # start() makes the next step's
        if self._defer_bcast:
            # Step-program mode: hold the root-local reduced buffer for
            # the executor's one merged broadcast.
            self._local = reduced
            self._reduce_done = True
            return
        stacked = torch.zeros((self._comm.size, self._elems),
                              dtype=self._dtype, device=reduced.device)
        stacked[self._root] = reduced
        self._result = self._comm.bcast(stacked, self._root)
        # Flag AFTER the result lands: a waiter released by this flag
        # must never observe a half-built result.
        self._reduce_done = True

    def local_reduced(self) -> torch.Tensor:
        """Root-local reduced 1-D buffer (defer_bcast mode): the step
        executor's input to the merged broadcast."""
        if not self._reduce_done:
            raise RequestError("local_reduced() before reduction done")
        return self._local

    @property
    def tail_armed(self) -> bool:
        """The deferred broadcast tail is armed: reduction complete and
        the root-local buffer held for the merged broadcast (the
        slipstream readiness hook). False always in eager-broadcast
        mode."""
        return bool(self._defer_bcast and self._reduce_done
                    and self._local is not None)

    @property
    def reduced(self) -> bool:
        """True once every tile is combined and the reduced buffer
        broadcast."""
        return bool(self._reduce_done)

    def poll(self) -> bool:
        """Drive one progress round and report :attr:`reduced`."""
        if not self._reduce_done:
            _progress.ENGINE.progress_until(
                lambda: self._reduce_done, timeout=0.0)
        return bool(self._reduce_done)

    def wait(self, timeout: float = 60.0):
        """Drive progress until every tile is reduced and every
        persistent sub-request has completed (so start() can re-arm);
        returns the replicated rank-major ``(size, E)`` result (None
        under ``defer_bcast``)."""
        if not self._active:
            raise RequestError("wait() before start()")
        missing = [t for t in range(self.tiles) if not self._ready[t]]
        if missing:
            raise RequestError(
                f"wait() before ready() on tiles {missing}"
            )
        deadline = time.monotonic() + timeout
        try:
            if not _progress.ENGINE.progress_until(
                    lambda: self._reduce_done, timeout=timeout):
                raise RequestError(
                    f"partitioned allreduce {self.label}: tiles "
                    f"{self._tiles_reduced}/{self.tiles} reduced before "
                    f"timeout"
                )
            pend = list(self._sreqs.values()) + list(self._rreqs.values())
            if not _progress.ENGINE.progress_until(
                    lambda: all(r._poll() or r.done for r in pend),
                    timeout=max(0.0, deadline - time.monotonic())):
                raise RequestError(
                    f"partitioned allreduce {self.label}: sub-requests "
                    "incomplete at timeout"
                )
        finally:
            # success and timeout alike: the drain callback never
            # outlives the step, and start() can re-arm
            _progress.unregister(self._pump)
            self._active = False
        return self._result

    def abort(self) -> None:
        """Tear down an armed step without waiting for completion
        (in-flight wire traffic is abandoned; re-arming is safe once the
        persistent sub-requests have drained). No-op when no step is
        open."""
        if not self._active:
            return
        _progress.unregister(self._pump)
        self._active = False


def bucketed_allreduce(
    comm,
    x,
    op: Any = "sum",
    nbuckets: int = 8,
    produce: Callable[[int, Any], Any] | None = None,
):
    """Allreduce ``x`` bucket by bucket. With ``produce``, each bucket's
    slab is ``produce(b, slab)``, the compute whose cost the per-bucket
    dispatch overlaps."""
    br = BucketedAllreduce(comm, x, op, nbuckets)
    for b in range(br.nbuckets):
        if produce is None:
            br.ready(b)
        else:
            lo, hi = br.bucket_range(b)
            br.ready(b, produce(b, br.buffer[:, lo:hi]))
    return br.wait()
