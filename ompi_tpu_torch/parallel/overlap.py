"""parallel/overlap — T3-style tile-granular compute/comm overlap for
the data-parallel gradient reduction.

Port of ``ompi_tpu/parallel/overlap.py`` (T3, arxiv 2401.16677: track
output-tile completion during backprop, trigger sub-operation
collectives as tiles land):

* The bucketer's buckets compile into ONE step program
  (``coll.sched.stepprogram.compile_step``) whose executor owns one
  persistent ``PartitionedAllreduce`` (or ZeRO shard flows) per bucket;
  the bucketer's fusion boundary is the partitioned-request boundary.
* :meth:`DpOverlapSession.mark_ready` maps a gradient leaf (or a flat
  slice of one) onto the tiles it covers; fully covered tiles fire as
  coalesced ``Pready_range`` bursts, and arrivals drain from the
  progress engine: early tiles reduce while the backward pass still
  produces late ones.
* :func:`grad_marker` is a ``torch.autograd.Function`` whose backward
  records its name (the gradient passes through unchanged), so a
  training loop can replay production in true backward order;
  :func:`autograd_backward_order` reads the order in which autograd
  accumulates a model's parameter gradients.

On the card the session's buffers (the staging slabs, the flows' wire
buffers and accumulators, the merged broadcast, the reassembled
gradients) are CUDA tensors; the host keeps the coverage masks and the
bookkeeping. The session owns one CUDA stream and enters it on every
thread that touches its buffers: the producer (``mark_ready``, which may
run on autograd's device thread from a gradient hook), the pump thread
and the caller of ``finish``/``flush``. A CUDA event recorded on the
producer's stream orders its gradient before the staging copy; the
finished gradients are ordered before the caller's stream the same way.

Per-step accounting lands in :class:`OverlapReport`: ``overlap_pct`` is
the share of allreduce wall-time hidden under backprop,
``exposed_comm_ms`` the tail left after backward ends.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..coll.partitioned import on_stream
from ..core import config
from ..core import progress as _progress
from ..core import tree as _tree
from ..core.counters import SPC
from ..core.errors import ArgumentError, RequestError
from ..ops import SUM
from ..part.persist import torch_dtype
from . import bucketer

_tile_bytes_var = config.register(
    "parallel", "overlap", "tile_bytes",
    type=int, default=256 << 10,
    description="Target bytes per readiness tile inside a gradient "
                "bucket (each tile fires one Pready as its gradient "
                "materializes)",
)

SPC.counter(
    "parallel_overlap_marks",
    "mark_ready calls mapped onto bucket tiles",
)


class LeafPiece(NamedTuple):
    """One leaf's flat slice [leaf_lo, leaf_hi) lives in bucket
    ``bucket`` at bucket offsets [bucket_lo, bucket_hi)."""
    bucket: int
    bucket_lo: int
    bucket_hi: int
    leaf_lo: int
    leaf_hi: int


@dataclasses.dataclass
class OverlapPlan:
    """Deterministic leaf→bucket→tile map for one gradient pytree."""
    buckets: list
    leaf_pieces: dict            # leaf_id -> [LeafPiece]
    leaf_paths: list             # leaf_id -> keystr
    treedef: Any
    leaf_shapes: list            # per-rank shapes
    leaf_dtypes: list
    # Per-bucket tile geometry: seeded from plan_overlap's tile_bytes; a
    # session compiling a step program stamps the autotuned geometry
    # back, so the plan names the geometry that executes.
    tiles: Optional[list] = None
    tile_elems: Optional[list] = None
    tile_sources: Optional[list] = None


def _tile_geometry(elems: int, nbytes: int, tile_bytes: int) -> tuple:
    """(tiles, tile_elems) for one bucket — the same uniform rounding
    PartitionedAllreduce applies."""
    tiles = max(1, min(-(-nbytes // max(1, tile_bytes)), elems))
    te = -(-elems // tiles)
    return -(-elems // te), te


def plan_overlap(per_rank_leaves: list, treedef,
                 bucket_bytes: Optional[int] = None,
                 tile_bytes: Optional[int] = None) -> OverlapPlan:
    """Build the overlap plan over PER-RANK leaves (shapes only: tensors,
    ``meta`` tensors or numpy arrays). The bucket composition is exactly
    ``bucketer.plan_buckets``."""
    plans = bucketer.plan_buckets(per_rank_leaves, bucket_bytes)
    pieces: dict = {}
    for b_idx, bucket in enumerate(plans):
        off = 0
        for leaf_id, lo, hi in bucket.pieces:
            pieces.setdefault(leaf_id, []).append(
                LeafPiece(b_idx, off, off + (hi - lo), lo, hi)
            )
            off += hi - lo
    paths = [f"leaf{i}" for i in range(len(per_rank_leaves))]
    tb = _tile_bytes_var.value if tile_bytes is None else int(tile_bytes)
    geom = [_tile_geometry(b.elems, b.elems * b.dtype.itemsize, tb)
            for b in plans]
    return OverlapPlan(
        buckets=plans,
        leaf_pieces=pieces,
        leaf_paths=paths,
        treedef=treedef,
        leaf_shapes=[tuple(leaf.shape) for leaf in per_rank_leaves],
        leaf_dtypes=[torch_dtype(leaf.dtype) for leaf in per_rank_leaves],
        tiles=[g[0] for g in geom],
        tile_elems=[g[1] for g in geom],
        tile_sources=["default"] * len(plans),
    )


@dataclasses.dataclass
class OverlapReport:
    """Per-step overlap accounting. Window sessions (``window >= 2``)
    also account the step's merged broadcast tail: ``tail_ms`` is its
    dispatch wall-time and ``tail_overlap_ms`` the share hidden under
    the NEXT step's backward pass."""
    backward_ms: float = 0.0
    comm_ms: float = 0.0
    exposed_comm_ms: float = 0.0
    tiles: int = 0
    buckets: int = 0
    tail_ms: float = 0.0
    tail_overlap_ms: float = 0.0

    @property
    def overlap_pct(self) -> float:
        """Share (percent) of allreduce wall-time hidden under the
        backward pass."""
        if self.comm_ms <= 0.0:
            return 100.0
        pct = 100.0 * (1.0 - self.exposed_comm_ms / self.comm_ms)
        return max(0.0, min(100.0, pct))


class _TailNode:
    """One closed step's armed broadcast tail, queued for dispatch.
    Whoever claims it first (under the fire lock) runs
    ``finish_tail()``; everyone else waits on the event."""

    __slots__ = ("exec_", "phase", "report", "event", "claimed",
                 "result", "error")

    def __init__(self, exec_, phase: int, report: OverlapReport) -> None:
        self.exec_ = exec_
        self.phase = phase
        self.report = report
        self.event = threading.Event()
        self.claimed = False
        self.result = None
        self.error: Optional[BaseException] = None


class DpOverlapSession:
    """Tile-granular gradient allreduce session.

    Bind once per (comm, gradient structure); then every step::

        sess.begin_step()
        for name, value in backward_order:   # as grads materialize
            sess.mark_ready(name, value)
        grads, report = sess.finish()

    Leaves are rank-major ``(size, ...)`` tensors (the same convention
    as ``bucketer.allreduce_pytree``); names are the JAX package's leaf
    paths (``core.tree.keystr``, e.g. ``['l00']``).

    The session's comm is ONE compiled step program (``compile_step``:
    per-bucket tile geometry from the autotuner's precedence, RS/AG vs
    allreduce per bucket via ``node_choices``, cross-bucket interleave)
    bound to live transport by a ``StepExecutor``.
    ``step_program=False`` runs the per-bucket behaviour (one broadcast
    and one progress callback per bucket).

    ``window >= 2`` makes it a **slipstream window**
    (``coll.sched.slipstream``)::

        sess.begin_step(); ...mark_ready...; sess.step()   # step N
        sess.begin_step(); ...mark_ready...; sess.step()   # step N+1
        results = sess.flush()       # [(grads, report), ...] in order

    ``step()`` closes the step at ``wait_reduced()`` (reductions done,
    the merged broadcast tail armed) and queues the tail for the pump
    thread, which dispatches it while step N+1's backward produces. Each
    phase owns its executor (disjoint tags). ``finish()`` is close +
    flush (the last step's result); :meth:`abort_window` collapses the
    window.
    """

    def __init__(self, comm, template: Any, op: Any = SUM,
                 bucket_bytes: Optional[int] = None,
                 tile_bytes: Optional[int] = None,
                 allow_quant: Optional[bool] = None,
                 tag_base: int = 820,
                 progress_thread: bool = True,
                 step_program: bool = True,
                 node_choices: Optional[list] = None,
                 seed: Optional[int] = None,
                 window: int = 1,
                 ag_deadlines: Optional[list] = None) -> None:
        from ..coll.sched.stepprogram import StepExecutor, compile_step

        paths_leaves, treedef = _tree.flatten_with_path(template)
        if not paths_leaves:
            raise ArgumentError("empty gradient template")
        size = comm.size
        leaves = [leaf for _, leaf in paths_leaves]
        for leaf in leaves:
            shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
            if len(shape) < 1 or shape[0] != size:
                raise ArgumentError(
                    f"overlap session needs rank-major (size, ...) "
                    f"leaves, got shape {shape}"
                )
        # Full template shapes, kept apart from the plan's PER-RANK
        # shapes: a 1-D (size,) leaf plans as a per-rank (1,) proxy, and
        # reassembly must restore (size,), not (size, 1).
        self._template_shapes = [tuple(leaf.shape) for leaf in leaves]
        proxies = [torch.empty(tuple(leaf.shape)[1:] or (1,),
                               dtype=torch_dtype(leaf.dtype), device="meta")
                   for leaf in leaves]
        self.plan = plan_overlap(proxies, treedef, bucket_bytes)
        self.plan.leaf_paths = [_tree.keystr(p) for p, _ in paths_leaves]
        self._name_to_leaf = {
            p: i for i, p in enumerate(self.plan.leaf_paths)
        }
        self._comm = comm
        self._op = op
        self._window = int(window)
        if self._window < 1:
            raise ArgumentError(f"window must be >= 1, got {window}")
        if self._window >= 2 and not step_program:
            raise ArgumentError(
                "window sessions pipeline compiled step programs — "
                "window >= 2 needs step_program=True")
        dev = comm.device
        self._stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        bucket_list = [(b.elems, b.dtype) for b in self.plan.buckets]
        if self._window >= 2:
            from ..coll.sched import slipstream
            self.compiled_window = slipstream.compile_window(
                size, bucket_list, tile_bytes=tile_bytes, seed=seed,
                node_choices=node_choices, ag_deadlines=ag_deadlines)
            self.compiled = self.compiled_window.step
        else:
            self.compiled_window = None
            self.compiled = compile_step(
                size, bucket_list, tile_bytes=tile_bytes, seed=seed,
                node_choices=node_choices, ag_deadlines=ag_deadlines)
        # One executor per window phase, disjoint tag ranges plus slack,
        # so step N's armed tail and step N+1's reductions coexist.
        self._execs = []
        tag = tag_base
        for _ in range(self._window):
            ex = StepExecutor(
                comm, self.compiled, op=op, allow_quant=allow_quant,
                tag_base=tag, legacy=not step_program)
            self._execs.append(ex)
            tag += sum(getattr(b, "nshards", 1)
                       for b in ex.bindings) + 8
        self._phase = 0
        self._pas = self._exec.bindings
        # the plan names the geometry that executes
        self.plan.tiles = [n.tiles for n in self.compiled.nodes]
        self.plan.tile_elems = [n.tile_elems for n in self.compiled.nodes]
        self.plan.tile_sources = [n.tile_source
                                  for n in self.compiled.nodes]
        with self._on_stream():
            self._stage = [torch.zeros((size, b.elems), dtype=b.dtype,
                                       device=dev)
                           for b in self.plan.buckets]
        self._covered = None
        self._fired = None
        self._active = False
        self._report = None
        # Async progress pumper (opal progress-thread analog): drains
        # tile arrivals while the producer and the consumer compute.
        self._use_pump_thread = bool(progress_thread)
        self._pump_stop: Optional[threading.Event] = None
        self._pump_thread: Optional[threading.Thread] = None
        # Completed tile runs queued for dispatch off the producer
        # thread: mark_ready() stays a staging copy plus bookkeeping.
        self._fire_q: deque = deque()
        self._fire_lock = threading.Lock()
        # Set when work is queued for the pump thread, which sleeps on
        # it when a sweep found nothing to do: a spinning pump would
        # take the GIL from the producer for a whole switch interval at
        # each of its releases.
        self._wake = threading.Event()
        # Window state: closed steps whose broadcast tails are armed
        # but not yet drained, in step order (_tails) and queued for
        # the pump thread (_tail_q).
        self._tails: list = []
        self._tail_q: deque = deque()

    @property
    def _exec(self):
        """The executor owning the CURRENT phase of the window."""
        return self._execs[self._phase]

    def _on_stream(self):
        """Enter the session's stream on this thread."""
        return on_stream(self._stream) if self._stream is not None \
            else nullcontext()

    def buffers(self) -> list:
        """Every tensor the session stages or sends through: the
        staging slabs and each flow's wire buffers (for checks of where
        they live)."""
        out = list(self._stage)
        for ex in self._execs:
            for b in ex.bindings:
                flows = ([pa for *_, pa in b._shards]
                         if hasattr(b, "_shards") else [b])
                for pa in flows:
                    out.extend(pa._send_bufs.values())
        return out

    # -- step lifecycle ---------------------------------------------------

    def begin_step(self) -> "DpOverlapSession":
        """Re-arm the compiled step program and reset tile coverage."""
        if self._active:
            raise RequestError("begin_step() inside an open step")
        if self._window >= 2:
            # A phase's executor cannot re-arm until its previous tail
            # consumed the deferred buffers: force-complete same-phase
            # pending tails, and surface any stashed tail error.
            for rec in self._tails:
                if rec.phase == self._phase and not rec.event.is_set():
                    self._complete_tail(rec)
            for rec in self._tails:
                if rec.error is not None:
                    err = rec.error
                    self.abort_window()
                    raise err
        self._pas = self._exec.bindings
        with self._on_stream():
            self._exec.begin_step()
            for buf in self._stage:
                buf.zero_()
        self._covered = [np.zeros(pa.tiles, np.int64) for pa in self._pas]
        self._covmask = [np.zeros(b.elems, bool) for b in self.plan.buckets]
        self._fired = [np.zeros(pa.tiles, bool) for pa in self._pas]
        self._fire_q.clear()
        self._active = True
        self._t0 = time.perf_counter()
        self._t_bwd_end = None
        self._report = None
        # Window mode keeps ONE pump thread alive across the window;
        # single-step mode cycles it per step.
        if self._use_pump_thread and self._pump_thread is None:
            self._pump_stop = threading.Event()
            self._pump_thread = threading.Thread(
                target=self._pump_loop, args=(self._pump_stop,),
                name="dp-overlap-progress", daemon=True,
            )
            self._pump_thread.start()
        return self

    def _pump_loop(self, stop: threading.Event) -> None:
        """Background drain: dispatch queued tile runs and window tails,
        then pump the progress engine until the step's buckets are all
        reduced or finish() signals stop."""
        with self._on_stream():
            while not stop.is_set():
                busy = self._drain_fire_q()
                # queued window tails dispatch here, outside the fire
                # queue's batch-dispatch window
                busy = self._drain_tails() or busy
                if busy:
                    continue
                if all(pa.reduced for pa in self._pas):
                    self._wake.wait(0.002)
                else:
                    # one sweep, unless a waiter (finish) pumps for
                    # itself: then sleep until woken (a queued run or
                    # tail sets the event)
                    events = _progress.ENGINE.pump_once()
                    if events:
                        continue
                    self._wake.wait(0.02 if events is None else 0.001)
                self._wake.clear()

    def _drain_fire_q(self) -> bool:
        """Dispatch every queued completed-tile run as Pready bursts in
        one coalescing window (serialized by the fire lock). The lock is
        taken even when the queue is empty: the pump thread may have
        popped the last run and still be readying it, and a caller about
        to wait on the tiles must wait for that first."""
        from ..coll.partitioned import _batch_window

        with self._fire_lock:
            if not self._fire_q:
                return False
            with self._on_stream(), _batch_window():
                while self._fire_q:
                    b, run_lo, run_hi = self._fire_q.popleft()
                    pa = self._pas[b]
                    llo = pa.tile_range(run_lo)[0]
                    lhi = pa.tile_range(run_hi)[1]
                    pa.ready_range(run_lo, run_hi,
                                   self._stage[b][:, llo:lhi])
        return True

    # -- window tails -----------------------------------------------------

    def _drain_tails(self) -> bool:
        """Pump-thread pass: dispatch every queued window tail."""
        ran = False
        while self._tail_q:
            try:
                rec = self._tail_q.popleft()
            except IndexError:
                break
            self._run_tail(rec)
            ran = True
        return ran

    def _run_tail(self, rec: _TailNode) -> None:
        """Claim-then-run one armed tail (the merged per-root broadcast
        of a closed step), unlocked. Errors are stashed on the record
        and re-raised at the next begin_step/flush."""
        with self._fire_lock:
            if rec.claimed:
                return
            rec.claimed = True
        t0 = time.perf_counter()
        try:
            with self._on_stream():
                rec.result = rec.exec_.finish_tail()
        except BaseException as e:  # the pump thread has no caller
            rec.error = e
        tail_ms = (time.perf_counter() - t0) * 1e3
        # the tail overlapped iff the NEXT step's backward was still
        # producing while it ran
        overlap_ms = (tail_ms if self._active and self._t_bwd_end is None
                      else 0.0)
        rec.report.tail_ms = tail_ms
        rec.report.tail_overlap_ms = overlap_ms
        SPC.record("sched_tail_overlap_ms", overlap_ms)
        rec.event.set()

    def _complete_tail(self, rec: _TailNode) -> None:
        """Force one tail to completion: run it inline if unclaimed,
        else wait out whoever claimed it."""
        self._run_tail(rec)
        rec.event.wait()

    def _close_report(self) -> OverlapReport:
        t_done = max(pa.t_reduce_done for pa in self._pas)
        t_first = min(pa.t_first_ready for pa in self._pas)
        return OverlapReport(
            backward_ms=(self._t_bwd_end - self._t0) * 1e3,
            comm_ms=max(0.0, (t_done - t_first) * 1e3),
            exposed_comm_ms=max(0.0, (t_done - self._t_bwd_end) * 1e3),
            tiles=sum(pa.tiles for pa in self._pas),
            buckets=len(self._pas),
        )

    def step(self) -> None:
        """Close the open step WITHOUT draining its broadcast tail (the
        slipstream boundary): reductions are waited to completion, the
        merged tail stays armed and is queued for the pump thread.
        Results come back from :meth:`flush` in step order."""
        if self._window < 2:
            raise RequestError(
                "step() needs a window session (window >= 2) — "
                "single-step sessions use finish()")
        if not self._active:
            raise RequestError("step() before begin_step()")
        self._check_all_fired("step")
        self._t_bwd_end = time.perf_counter()
        try:
            self._drain_fire_q()
            with self._on_stream():
                self._exec.wait_reduced()
        except BaseException:
            # a mid-window reduction failure must not leak armed tails
            # or the pump thread
            self.abort_window()
            raise
        report = self._close_report()
        rec = _TailNode(self._exec, self._phase, report)
        self._tails.append(rec)
        self._tail_q.append(rec)
        self._wake.set()
        SPC.record("sched_window_spans_total")
        self._report = report
        self._active = False
        self._phase = (self._phase + 1) % self._window

    def flush(self) -> list:
        """Close the window: auto-close an open step, complete every
        queued tail in step order, stop the pump thread, and return
        ``[(grads, report), ...]``, one entry per step() since the last
        flush. The session resets to phase 0."""
        if self._window < 2:
            raise RequestError(
                "flush() needs a window session (window >= 2)")
        if self._active:
            self.step()
        try:
            for rec in self._tails:
                self._complete_tail(rec)
                if rec.error is not None:
                    raise rec.error
        except BaseException:
            self.abort_window()
            raise
        self._stop_pump()
        out = []
        for rec in self._tails:
            out.append((self._reassemble(rec.result), rec.report))
            rec.result = None  # one step's buckets at a time
        self._tails = []
        self._tail_q.clear()
        self._phase = 0
        return out

    def mark_ready(self, param, value, slice: Optional[tuple] = None
                   ) -> list:
        """Mark a gradient (or a flat slice of one) materialized.

        ``param`` is a leaf index or a leaf path (keystr of the template
        tree); ``value`` is the rank-major ``(size, ...)`` gradient for
        that leaf (or for ``slice=(lo, hi)``, its flat element range).
        Returns the (bucket, tile) pairs this call completed; their
        Pready bursts dispatch inline without a progress thread, else on
        the pump thread (the producer pays only the staging copy)."""
        from ..coll.partitioned import _batch_window

        if not self._active:
            raise RequestError("mark_ready() before begin_step()")
        leaf_id = self._resolve(param)
        size = self._comm.size
        src = torch.as_tensor(value)
        leaf_elems = int(np.prod(self.plan.leaf_shapes[leaf_id],
                                 dtype=np.int64)) \
            if self.plan.leaf_shapes[leaf_id] else 1
        ncols = src.numel() // size if size else 0
        lo, hi = (0, ncols) if slice is None else slice
        if not 0 <= lo < hi <= max(leaf_elems, 1):
            raise ArgumentError(
                f"mark_ready slice [{lo}, {hi}) outside leaf "
                f"{self.plan.leaf_paths[leaf_id]} ({leaf_elems} elems)"
            )
        if ncols != hi - lo or src.numel() != size * ncols:
            raise ArgumentError(
                f"mark_ready payload has {ncols} elems per rank, slice "
                f"[{lo}, {hi}) needs {hi - lo}"
            )
        SPC.record("parallel_overlap_marks")
        # Atomic duplicate/overlap validation: a mark touching any
        # element already marked this step raises BEFORE anything from
        # this call is staged or flagged.
        hits = []
        for piece in self.plan.leaf_pieces.get(leaf_id, ()):
            plo = max(piece.leaf_lo, lo)
            phi = min(piece.leaf_hi, hi)
            if phi <= plo:
                continue
            b = piece.bucket
            blo = piece.bucket_lo + (plo - piece.leaf_lo)
            if self._covmask[b][blo: blo + (phi - plo)].any():
                raise RequestError(
                    f"mark_ready [{lo}, {hi}) of leaf "
                    f"{self.plan.leaf_paths[leaf_id]} overlaps elements "
                    "already marked ready this step"
                )
            hits.append((plo, phi, b, blo))
        # The producer's stream (autograd's, from a gradient hook) made
        # the gradient: an event orders it before the staging copies.
        producer = (torch.cuda.current_stream(src.device)
                    if src.is_cuda else None)
        with self._on_stream():
            if producer is not None and self._stream is not None:
                ev = torch.cuda.Event()
                ev.record(producer)
                self._stream.wait_event(ev)
                src.record_stream(self._stream)
            if src.device != self._comm.device:
                src = src.to(self._comm.device)
            host = src.reshape(size, ncols)
            completed: list = []
            touched: set = set()
            for plo, phi, b, blo in hits:
                self._covmask[b][blo: blo + (phi - plo)] = True
                self._stage[b][:, blo: blo + (phi - plo)].copy_(
                    host[:, plo - lo: phi - lo])
                pa = self._pas[b]
                t_lo = blo // pa.tile_elems
                t_hi = (blo + (phi - plo) - 1) // pa.tile_elems
                for t in range(t_lo, t_hi + 1):
                    tlo, thi = pa.tile_range(t)
                    self._covered[b][t] += (
                        min(thi, blo + (phi - plo)) - max(tlo, blo)
                    )
                    touched.add((b, t))
            # Fire every tile this call completed, as contiguous
            # Pready_range bursts; with the pump thread running the runs
            # are queued (a completed tile's staging region is never
            # rewritten, so the deferred dispatch reads what was staged
            # here, ordered on the session's stream).
            runs: list = []
            for b in sorted({bt[0] for bt in touched}):
                pa = self._pas[b]
                ready = sorted(
                    t for (bb, t) in touched if bb == b
                    and not self._fired[b][t]
                    and self._covered[b][t] == pa.tile_range(t)[1]
                    - pa.tile_range(t)[0]
                )
                for run_lo, run_hi in _runs(ready):
                    runs.append((b, run_lo, run_hi))
                    for t in range(run_lo, run_hi + 1):
                        self._fired[b][t] = True
                        completed.append((b, t))
            if self._pump_thread is not None:
                self._fire_q.extend(runs)
                self._wake.set()
            elif runs:
                with _batch_window():
                    for b, run_lo, run_hi in runs:
                        pa = self._pas[b]
                        llo = pa.tile_range(run_lo)[0]
                        lhi = pa.tile_range(run_hi)[1]
                        pa.ready_range(run_lo, run_hi,
                                       self._stage[b][:, llo:lhi])
        return completed

    def poll(self) -> list:
        """Drive one progress round; return the bucket indices whose
        reduction has completed so far."""
        if not self._active:
            if all(pa.reduced for pa in self._pas):
                return list(range(len(self._pas)))
            raise RequestError("poll() before begin_step()")
        done = []
        passive = self._pump_thread is not None
        for b, pa in enumerate(self._pas):
            # with the pump thread driving progress, read the flag only
            if pa.reduced or (not passive and pa.poll()):
                done.append(b)
        return done

    def finish(self) -> tuple:
        """Backward pass over: wait out the tail, reassemble the reduced
        pytree, and report the step's overlap accounting. Unready tiles
        raise WITHOUT tearing anything down (mark the rest and finish()
        again, or :meth:`abort_step`). On a window session this is
        close-plus-flush, returning the LAST step's result."""
        if self._window >= 2:
            if not self._active and not self._tails:
                raise RequestError("finish() before begin_step()")
            return self.flush()[-1]
        if not self._active:
            raise RequestError("finish() before begin_step()")
        self._check_all_fired("finish")
        self._t_bwd_end = time.perf_counter()
        try:
            self._drain_fire_q()
            with self._on_stream():
                reduced = self._exec.wait_all()
        except BaseException:
            # any reduction failure must not leak the pump thread or
            # the buckets' progress callbacks
            self.abort_step()
            raise
        self._stop_pump()
        self._active = False
        self._report = self._close_report()
        return self._reassemble(reduced), self._report

    def _check_all_fired(self, verb: str) -> None:
        unfired = [
            (b, t) for b, fired in enumerate(self._fired)
            for t in range(len(fired)) if not fired[t]
        ]
        if unfired:
            raise RequestError(
                f"{verb}() with unready tiles {unfired[:8]} — every "
                "gradient leaf must be mark_ready()'d (the step stays "
                f"open: mark the rest and {verb}() again, or "
                "abort_step())"
            )

    def abort_step(self) -> None:
        """Tear down an open step without completing it (stop the pump
        thread, abort every bucket's partitioned pair). On a window
        session the window is one unit of teardown: abort_window()."""
        if self._window >= 2:
            self.abort_window()
            return
        if not self._active:
            return
        self._stop_pump()
        self._exec.abort()
        self._active = False

    def abort_window(self) -> None:
        """Collapse the whole window: stop the pump thread first, abort
        every phase's executor (armed tails included), drop queued
        tails and reset to phase 0. No-op when the window is idle."""
        if (not self._active and not self._tails
                and self._pump_thread is None):
            return
        self._stop_pump()
        for ex in self._execs:
            ex.abort()
        self._tails = []
        self._tail_q.clear()
        self._active = False
        self._phase = 0

    def _stop_pump(self) -> None:
        if self._pump_thread is not None:
            self._pump_stop.set()
            self._wake.set()
            self._pump_thread.join()
            self._pump_thread = None
            self._pump_stop = None

    def last_report(self) -> Optional[OverlapReport]:
        return self._report

    # -- helpers ----------------------------------------------------------

    def _resolve(self, param) -> int:
        if isinstance(param, int):
            if not 0 <= param < len(self.plan.leaf_paths):
                raise ArgumentError(f"leaf index {param} out of range")
            return param
        leaf_id = self._name_to_leaf.get(param)
        if leaf_id is None:
            matches = [
                i for i, p in enumerate(self.plan.leaf_paths)
                if str(param) in p
            ]
            if len(matches) != 1:
                raise ArgumentError(
                    f"cannot resolve {param!r} to one gradient leaf "
                    f"(matches: {len(matches)})"
                )
            leaf_id = matches[0]
        return leaf_id

    def _reassemble(self, reduced: list):
        """The gradient pytree from the reduced buckets, on the
        communicator's device, ordered before the caller's stream."""
        size = self._comm.size
        dev = self._comm.device
        caller = (torch.cuda.current_stream(dev)
                  if self._stream is not None else None)
        out_leaves = []
        with self._on_stream():
            for i, shape in enumerate(self.plan.leaf_shapes):
                elems = int(np.prod(shape, dtype=np.int64)) if shape else 1
                flat = torch.zeros((size, elems),
                                   dtype=self.plan.leaf_dtypes[i],
                                   device=dev)
                for piece in self.plan.leaf_pieces.get(i, ()):
                    flat[:, piece.leaf_lo: piece.leaf_hi] = (
                        reduced[piece.bucket][:, piece.bucket_lo:
                                              piece.bucket_hi])
                out_leaves.append(flat.reshape(self._template_shapes[i]))
        if caller is not None:
            caller.wait_stream(self._stream)
            for leaf in out_leaves:
                leaf.record_stream(caller)
        return _tree.unflatten(self.plan.treedef, out_leaves)


def _runs(idx: list) -> list:
    """Collapse a sorted index list into inclusive (lo, hi) runs."""
    runs: list = []
    for t in idx:
        if runs and t == runs[-1][1] + 1:
            runs[-1] = (runs[-1][0], t)
        else:
            runs.append((t, t))
    return runs


# ---------------------------------------------------------------------------
# Readiness capture (autograd hooks)
# ---------------------------------------------------------------------------

#: Backprop completion order: grad_marker's backward appends as each
#: marked boundary's gradient is formed (on autograd's thread).
_BWD_ORDER: list = []
_BWD_LOCK = threading.Lock()
_LAST_SCHEDULE: Optional[dict] = None


class _GradMarker(torch.autograd.Function):
    """Identity whose backward records a name (``grad_marker``)."""

    @staticmethod
    def forward(ctx, x, name):
        ctx.marker_name = name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        note_backward(ctx.marker_name)
        return g, None


def grad_marker(x: torch.Tensor, name: str = "") -> torch.Tensor:
    """Identity whose BACKWARD records ``name``: placed on a layer's
    input, it fires after every gradient inside that layer has been
    produced, capturing the true backprop order for the overlap session
    to replay. Forward value and gradient pass through unchanged."""
    return _GradMarker.apply(x, name)


def note_backward(name: str) -> None:
    """Record one backprop completion boundary (any thread)."""
    with _BWD_LOCK:
        _BWD_ORDER.append(name)


def backward_order() -> tuple:
    with _BWD_LOCK:
        return tuple(_BWD_ORDER)


def reset_capture() -> None:
    global _LAST_SCHEDULE
    with _BWD_LOCK:
        del _BWD_ORDER[:]
        _LAST_SCHEDULE = None


def capture_ready_schedule(tree: Any) -> Any:
    """Capture the gradient readiness schedule at the sync seam: the
    leaf paths about to be reduced together with the backprop order the
    grad markers observed; returns ``tree`` unchanged. Host sessions
    read :func:`last_schedule` to replay production in backward
    order."""
    global _LAST_SCHEDULE
    paths_leaves, _ = _tree.flatten_with_path(tree)
    _LAST_SCHEDULE = {
        "leaf_paths": tuple(_tree.keystr(p) for p, _ in paths_leaves),
        "bwd_order": backward_order(),
    }
    return tree


def last_schedule() -> Optional[dict]:
    return _LAST_SCHEDULE


# ---------------------------------------------------------------------------
# Readiness order from autograd's own execution order
# ---------------------------------------------------------------------------

def autograd_backward_order(loss_fn, params: Any) -> tuple:
    """Gradient-leaf production order as autograd runs it: a
    post-accumulate-grad hook on every leaf of ``params`` that requires
    grad records its index while ``loss_fn(params).backward()`` runs.
    Returns leaf indices (into the flattened ``params``) in production
    order — the port's counterpart of the JAX package's
    ``jaxpr_backward_order``, which reads the order off the traced
    program."""
    leaves, _ = _tree.flatten(params)
    order: list = []
    lock = threading.Lock()

    def hook(i):
        def record(_p):
            with lock:
                order.append(i)
        return record

    handles = [leaf.register_post_accumulate_grad_hook(hook(i))
               for i, leaf in enumerate(leaves)
               if isinstance(leaf, torch.Tensor) and leaf.requires_grad]
    try:
        loss_fn(params).backward()
    finally:
        for h in handles:
            h.remove()
    return tuple(order)


def readiness_order(loss_fn=None, params: Any = None) -> tuple:
    """The overlap session's readiness source: ``("autograd", order)``
    from autograd's execution order when a loss function and its
    parameters are given, else ``("marker", backward_order())`` — the
    :func:`grad_marker` capture. Both name the sequence gradients
    materialize in during the backward pass."""
    if loss_fn is not None and params is not None:
        return ("autograd", autograd_backward_order(loss_fn, params))
    return ("marker", backward_order())
