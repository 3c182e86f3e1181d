"""coll/sched/stepprogram — the training step as the compilation unit.

Port of ``ompi_tpu/coll/sched/stepprogram.py``:

* :func:`compile_step` turns the step's bucket list into one
  :class:`~ompi_tpu_torch.coll.sched.ir.Program`: a named sub-collective
  per bucket, ZeRO-style reduce-scatter + allgather pairs as node pairs
  with an explicit readiness dependency, per-bucket tile geometry from
  the autotuner's program-level precedence (caller > winner cache >
  model), and a cross-bucket interleave order. Everything that decides
  what executes lands in the program meta, so ``Program.digest()`` is
  byte-identical across same-seed controllers, and across the two
  packages (a dtype is rendered by its JAX name, ``cache.dtype_name``).
* Dense round-uniform node groups fuse per op through
  :func:`~.pallas_lower.fuse_schedules` into ONE table program
  (``CompiledStep.fused``), which ``pallas_lower.sched_table`` runs on
  the card.
* :class:`StepExecutor` binds the compiled program to live transport:
  per-node ``PartitionedAllreduce`` flows (the allreduce choice) or
  per-shard flows rooted at the shard owner (the RS/AG choice), armed
  in interleave order, drained by ONE merged progress callback, and
  finished with ONE merged broadcast per root (the deferred root-local
  segments concatenated as raw bytes on the card).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import torch

from ...core import progress as _progress
from ...core.counters import SPC
from ...core.errors import ArgumentError, RequestError
from ...part.framework import block_range
from ...part.persist import torch_dtype
from . import autotune as _autotune
from . import cache as _cache
from . import ir
from . import pallas_lower as _pallas


@dataclass(frozen=True)
class NodePlan:
    """Executable decisions for one bucket of the compiled step."""

    bucket: int
    name: str
    choice: str        # "allreduce" | "rs_ag" | "rs_resident"
    elems: int
    dtype: Any         # torch.dtype
    tile_bytes: int
    tile_elems: int
    tiles: int
    tile_source: str   # "caller" | "cache" | "model"
    #: forward-consume deadline behind an "rs_ag"/"rs_resident" choice
    #: (slipstream); None when the caller supplied no deadlines.
    ag_deadline: Optional[int] = None


@dataclass(frozen=True)
class CompiledStep:
    """One training step's comm, compiled: the IR program (digest =
    identity), the per-bucket execution plan, the arm order, and the
    fused table-kernel schedules."""

    program: ir.Program
    nodes: tuple       # NodePlan per bucket
    interleave: tuple  # bucket indices in arm order (biggest first)
    fused: dict = field(default_factory=dict)  # op -> fused Schedule
    nranks: int = 0
    seed: int = 0
    topo_fp: str = ""
    compile_ms: float = 0.0

    def digest(self) -> str:
        return self.program.digest()


def compile_step(nranks: int, buckets: Sequence, *,
                 tile_bytes=None, seed: Optional[int] = None,
                 topo_fp: Optional[str] = None,
                 node_choices: Optional[Sequence] = None,
                 ag_deadlines: Optional[Sequence] = None,
                 order: Optional[Sequence] = None,
                 name: str = "step") -> CompiledStep:
    """Compile a step's bucket list into one multi-collective program.

    ``buckets`` is a sequence of ``(elems, dtype)`` per-bucket specs (a
    torch dtype, a numpy dtype or a name). Per bucket the autotuner
    resolves the tile geometry and the RS/AG-vs-allreduce decision;
    ``node_choices`` pins the latter ("allreduce" / "rs_ag" /
    "rs_resident" / None); ``ag_deadlines`` feeds the shard-residency
    model (a bucket whose owner shard can stay resident compiles to a
    lone reduce-scatter node, counted on ``sched_ag_elided_total``).
    Deterministic: same (buckets, nranks, seed, cache state) yields a
    byte-identical ``Program`` render and digest.
    """
    t0 = time.perf_counter()
    seed = _autotune._seed_var.value if seed is None else int(seed)
    if topo_fp is None:
        topo_fp = _autotune.fingerprint()
    if not buckets:
        raise ArgumentError("compile_step needs at least one bucket")
    specs = [(int(e), torch_dtype(d)) for e, d in buckets]
    choices = _autotune.program_choices(
        [e * d.itemsize for e, d in specs], nranks,
        dtypes=[_cache.dtype_name(d) for _, d in specs], seed=seed,
        topo_fp=topo_fp, tile_bytes=tile_bytes, node_choices=node_choices,
        ag_deadlines=ag_deadlines)
    nodes: list[NodePlan] = []
    prog_nodes: list[ir.ProgramNode] = []
    for i, ((elems, dtype), ch) in enumerate(zip(specs, choices)):
        nbytes = elems * dtype.itemsize
        tb = int(ch["tile_bytes"])
        tiles = max(1, min(-(-nbytes // max(1, tb)), elems))
        tile_elems = -(-elems // tiles)
        tiles = -(-elems // tile_elems)
        choice = ch["choice"]
        if nranks < 2:
            choice = "allreduce"  # degenerate comm: nothing to scatter
        dl = ch.get("ag_deadline")
        nodes.append(NodePlan(
            bucket=i, name=f"b{i}", choice=choice, elems=elems,
            dtype=dtype, tile_bytes=tb, tile_elems=tile_elems,
            tiles=tiles, tile_source=ch["tile_source"],
            ag_deadline=dl))
        if nranks >= 2:
            if choice == "rs_ag":
                prog_nodes.extend(ir.zero_pair(f"b{i}", nranks, order,
                                               ag_deadline=dl))
            elif choice == "rs_resident":
                # the owner shard stays resident: the allgather node is
                # elided entirely
                rs, _ag = ir.zero_pair(f"b{i}", nranks, order,
                                       ag_deadline=dl)
                prog_nodes.append(rs)
                SPC.record("sched_ag_elided_total")
            else:
                prog_nodes.append(ir.ProgramNode(
                    f"b{i}", ir.ring(nranks, order), ()))
    interleave = tuple(sorted(
        range(len(nodes)), key=lambda i: choices[i]["interleave"]))
    meta = {
        "seed": seed,
        "topo": (topo_fp or "none")[:16],
        "choices": ",".join(f"b{i}:{n.choice}"
                            for i, n in enumerate(nodes)),
        "tiles": ",".join(f"b{i}:{n.tiles}x{n.tile_elems}"
                          for i, n in enumerate(nodes)),
        "sources": ",".join(f"b{i}:{n.tile_source}"
                            for i, n in enumerate(nodes)),
        "interleave": ",".join(str(i) for i in interleave),
    }
    if any(n.ag_deadline is not None for n in nodes):
        # deadlines changed what executes: they join the digest (absent
        # entirely, the meta and digest stay byte-stable)
        meta["deadlines"] = ",".join(
            f"b{i}:{'-' if n.ag_deadline is None else n.ag_deadline}"
            for i, n in enumerate(nodes))
    program = ir.Program(name=name, nranks=nranks,
                         nodes=tuple(prog_nodes), meta=meta)
    ir.check_program(program)
    # Fuse dense round-uniform node groups per op into single table
    # programs (reduce_scatter keeps per-node kernels — its output
    # contract is one chunk per rank).
    fused: dict[str, ir.Schedule] = {}
    if nranks >= 2:
        for op in ("allreduce", "allgather"):
            group = [nd.schedule for nd in program.nodes
                     if nd.schedule.op == op]
            if len(group) >= 2:
                fused[op] = _pallas.fuse_schedules(
                    f"{name}.fused_{op}", group)
    SPC.record("sched_program_compiles_total")
    return CompiledStep(
        program=program, nodes=tuple(nodes), interleave=interleave,
        fused=fused, nranks=nranks, seed=seed, topo_fp=topo_fp,
        compile_ms=(time.perf_counter() - t0) * 1e3)


class ShardedAllreduce:
    """ZeRO-style execution of one bucket: its tile span splits into
    per-shard :class:`~ompi_tpu_torch.coll.partitioned.PartitionedAllreduce`
    flows, each rooted at its shard OWNER (the reduce-scatter half is
    the gather-to-owner, the allgather half the owner's slice of the
    merged broadcast). Shard boundaries are tile-aligned (shard s owns
    ``block_range(s, nshards, tiles)``), and every shard pins the
    bucket's ``tile_elems`` so bucket tile t maps to exactly one
    shard-local tile. Duck-types the PartitionedAllreduce surface the
    overlap session drives."""

    def __init__(self, comm, elems: int, dtype, *, op: Any = "sum",
                 tiles: int = 8, tile_elems: Optional[int] = None,
                 tag_base: int = 900, label: str = "",
                 defer_bcast: bool = False,
                 auto_pump: bool = True) -> None:
        from ..partitioned import PartitionedAllreduce

        self._comm = comm
        self._elems = int(elems)
        self._dtype = torch_dtype(dtype)
        self.tiles = max(1, min(int(tiles), self._elems))
        et = (int(tile_elems) if tile_elems
              else -(-self._elems // self.tiles))
        self.tile_elems = max(1, min(et, self._elems))
        self.tiles = -(-self._elems // self.tile_elems)
        self.label = label or "rsag"
        self.quant_wire = False  # shard flows always ride the exact wire
        self.nshards = min(comm.size, self.tiles)
        self._shards: list = []
        for s in range(self.nshards):
            t_lo, t_hi = block_range(s, self.nshards, self.tiles)
            e_lo = t_lo * self.tile_elems
            e_hi = min(t_hi * self.tile_elems, self._elems)
            pa = PartitionedAllreduce(
                comm, torch.empty((comm.size, e_hi - e_lo),
                                  dtype=self._dtype, device="meta"),
                op=op, tiles=t_hi - t_lo, tag=tag_base + s, root=s,
                allow_quant=False, label=f"{self.label}.s{s}",
                tile_elems=self.tile_elems, defer_bcast=defer_bcast,
                auto_pump=auto_pump)
            self._shards.append((t_lo, t_hi, e_lo, e_hi, pa))

    # -- PartitionedAllreduce-compatible surface -----------------------

    @property
    def _active(self) -> bool:
        return any(pa._active for *_, pa in self._shards)

    @property
    def reduced(self) -> bool:
        return all(pa.reduced for *_, pa in self._shards)

    @property
    def t_first_ready(self):
        ts = [pa.t_first_ready for *_, pa in self._shards
              if pa.t_first_ready is not None]
        return min(ts) if ts else None

    @property
    def t_reduce_done(self):
        ts = [pa.t_reduce_done for *_, pa in self._shards]
        return None if any(t is None for t in ts) else max(ts)

    def start(self) -> "ShardedAllreduce":
        for *_, pa in self._shards:
            pa.start()
        return self

    def tile_range(self, t: int) -> tuple:
        if not 0 <= t < self.tiles:
            raise ArgumentError(f"tile {t} out of range [0, {self.tiles})")
        lo = t * self.tile_elems
        return lo, min(lo + self.tile_elems, self._elems)

    def ready(self, t: int, data) -> None:
        self.ready_range(t, t, data)

    def ready_range(self, lo: int, hi: int, data) -> None:
        """Split a bucket-tile range across the shard flows; each shard
        sees shard-local tile indices and its slab slice."""
        if hi < lo:
            raise ArgumentError(f"ready_range: hi {hi} < lo {lo}")
        slab = torch.as_tensor(data)
        base = lo * self.tile_elems
        for t_lo, t_hi, e_lo, e_hi, pa in self._shards:
            s_lo, s_hi = max(lo, t_lo), min(hi, t_hi - 1)
            if s_hi < s_lo:
                continue
            col_lo = s_lo * self.tile_elems - base
            col_hi = min((s_hi + 1) * self.tile_elems, self._elems) - base
            pa.ready_range(s_lo - t_lo, s_hi - t_lo,
                           slab[:, col_lo:col_hi])

    def _pump(self) -> int:
        return sum(pa._pump() for *_, pa in self._shards)

    def poll(self) -> bool:
        if not self.reduced:
            _progress.ENGINE.progress_until(
                lambda: self.reduced, timeout=0.0)
        return self.reduced

    def wait(self, timeout: float = 60.0):
        deadline = time.monotonic() + timeout
        parts = []
        for *_, pa in self._shards:
            parts.append(pa.wait(max(0.1, deadline - time.monotonic())))
        if any(p is None for p in parts):
            return None  # defer_bcast: the executor assembles the step
        return torch.cat(parts, dim=1)

    def abort(self) -> None:
        for *_, pa in self._shards:
            pa.abort()

    @property
    def tail_armed(self) -> bool:
        """Every shard's deferred broadcast tail is armed."""
        return all(pa.tail_armed for *_, pa in self._shards)

    def local_segments(self) -> list:
        """(root, col_lo, col_hi, local_1d) per shard — the merged
        broadcast's input slices (defer_bcast mode)."""
        return [(pa._root, e_lo, e_hi, pa.local_reduced())
                for _, _, e_lo, e_hi, pa in self._shards]


class StepExecutor:
    """Live-transport binding of one :class:`CompiledStep`.

    Owns the per-bucket collective flows, arms them in the compiled
    interleave order, drains arrivals through ONE merged progress
    callback, and — in step-program mode — finishes with ONE merged
    broadcast per distinct root instead of one per bucket.
    ``legacy=True`` runs the per-bucket behaviour (per-bucket broadcast
    fired from the drain, one engine callback per bucket)."""

    def __init__(self, comm, compiled: CompiledStep, *,
                 op: Any = "sum", allow_quant: Optional[bool] = None,
                 tag_base: int = 820, legacy: bool = False) -> None:
        from ..partitioned import PartitionedAllreduce

        if compiled.nranks != comm.size:
            raise ArgumentError(
                f"step program compiled for {compiled.nranks} ranks, "
                f"comm has {comm.size}")
        self._comm = comm
        self.compiled = compiled
        self._legacy = bool(legacy)
        self._pump_on = False
        self._stream = None
        self.bindings: list = []
        tag = tag_base
        for nd in compiled.nodes:
            if (nd.choice in ("rs_ag", "rs_resident")
                    and comm.size >= 2):
                b = ShardedAllreduce(
                    comm, nd.elems, nd.dtype, op=op, tiles=nd.tiles,
                    tile_elems=nd.tile_elems, tag_base=tag,
                    label=nd.name, defer_bcast=not legacy,
                    auto_pump=legacy)
                tag += b.nshards
            else:
                b = PartitionedAllreduce(
                    comm, torch.empty((comm.size, nd.elems),
                                      dtype=nd.dtype, device="meta"),
                    op=op, tiles=nd.tiles, tag=tag,
                    allow_quant=allow_quant, label=nd.name,
                    tile_elems=nd.tile_elems, defer_bcast=not legacy,
                    auto_pump=legacy)
                tag += 1
            self.bindings.append(b)

    def begin_step(self) -> "StepExecutor":
        """Arm every node's persistent flow in the compiled interleave
        order, inside one dispatch window; register the merged drain."""
        from ..partitioned import _batch_window, current_stream

        self._stream = current_stream(self._comm.device)
        with _batch_window():
            for i in self.compiled.interleave:
                self.bindings[i].start()
        if not self._legacy:
            _progress.register(self._pump)
            self._pump_on = True
        return self

    def _pump(self) -> int:
        """The step's single merged progress callback."""
        return sum(b._pump() for b in self.bindings)

    def wait_all(self, timeout: float = 60.0) -> list:
        """Wait every node's reduction, then resolve results (legacy:
        each bucket's own broadcast result; step-program mode: the
        merged per-root broadcast, reassembled)."""
        got = self.wait_reduced(timeout)
        if self._legacy:
            return got
        return self.finish_tail()

    def wait_reduced(self, timeout: float = 60.0):
        """Drive every node's reduction to completion WITHOUT firing the
        merged broadcast tail. Legacy mode returns the per-bucket
        results; step-program mode returns None with every binding's
        tail armed and the merged drain dropped."""
        deadline = time.monotonic() + timeout
        raw = []
        for b in self.bindings:
            raw.append(b.wait(max(0.1, deadline - time.monotonic())))
        if self._legacy:
            return raw
        self._drop_pump()
        return None

    def finish_tail(self) -> list:
        """Fire the merged per-root broadcast tail and reassemble the
        step's outputs (every binding's tail must be armed)."""
        for i, b in enumerate(self.bindings):
            if not b.tail_armed:
                raise RequestError(
                    f"finish_tail: node {self.compiled.nodes[i].name} "
                    f"tail not armed — wait_reduced() first")
        from ..partitioned import on_stream

        try:
            with on_stream(self._stream):
                return self._merged_bcast()
        finally:
            self._drop_pump()

    def _merged_bcast(self) -> list:
        """ONE broadcast per distinct root for the whole step: every
        deferred root-local segment concatenates as raw bytes (so
        mixed-dtype buckets share the collective) into a single
        rank-major uint8 buffer on the card, and each rank's row of the
        result splits back into per-bucket ``(size, elems)`` tensors.

        rs_resident buckets never enter the broadcast: every rank's
        next-forward read is assembled from the resident owner segment
        (the elided allgather is this skipped wire traffic)."""
        size = self._comm.size
        dev = self._comm.device
        nodes = self.compiled.nodes
        # allocated at first write: on one card the broadcast's input
        # and output should not coexist with a whole step's outputs
        out: list = [None] * len(nodes)

        def dst(i):
            if out[i] is None:
                out[i] = torch.empty((size, nodes[i].elems),
                                     dtype=nodes[i].dtype, device=dev)
            return out[i]

        segs: list = []  # (root, bucket, col_lo, col_hi, bytes_1d)
        for i, b in enumerate(self.bindings):
            if nodes[i].choice == "rs_resident":
                for root, lo, hi, local in b.local_segments():
                    dst(i)[:, lo:hi] = local[None, :]
                continue
            if isinstance(b, ShardedAllreduce):
                for root, lo, hi, local in b.local_segments():
                    segs.append((root, i, lo, hi, _bytes_of(local)))
            else:
                segs.append((b._root, i, 0, b._elems,
                             _bytes_of(b.local_reduced())))
        by_root: dict[int, list] = {}
        for seg in segs:
            by_root.setdefault(seg[0], []).append(seg)
        for root in sorted(by_root):
            group = sorted(by_root[root], key=lambda s: (s[1], s[2]))
            total = sum(s[4].numel() for s in group)
            stacked = torch.zeros((size, total), dtype=torch.uint8,
                                  device=dev)
            torch.cat([s[4] for s in group], out=stacked[root])
            rep = self._comm.bcast(stacked, root)
            del stacked
            off = 0
            for _, i, lo, hi, raw in group:
                isz = nodes[i].dtype.itemsize
                dst(i).view(torch.uint8)[:, lo * isz:hi * isz].copy_(
                    rep[:, off:off + raw.numel()])
                off += raw.numel()
            del rep
        return out

    def abort(self) -> None:
        """Abandon the open step: drop the merged drain and abort every
        node flow."""
        self._drop_pump()
        for b in self.bindings:
            b.abort()

    def _drop_pump(self) -> None:
        if self._pump_on:
            _progress.unregister(self._pump)
            self._pump_on = False


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    """A 1-D tensor's bytes as a uint8 view (a copy only if strided)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


__all__ = ["CompiledStep", "NodePlan", "ShardedAllreduce",
           "StepExecutor", "compile_step"]
