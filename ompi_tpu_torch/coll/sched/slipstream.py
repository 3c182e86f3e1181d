"""coll/sched/slipstream — pipeline compiled step programs across the
step boundary.

Port of ``ompi_tpu/coll/sched/slipstream.py``: a **two-step sliding
window** over the step IR.

* **The tail becomes a schedulable node.** Step N's merged broadcast
  tail (one deferred collective, ``PartitionedAllreduce.tail_armed``)
  compiles into an explicit ``s0.tail`` Program node whose deps are the
  step's terminal reduction nodes. Step N+1's nodes carry NO dep on the
  tail: that missing edge is the overlap the window session
  (``parallel.overlap``, ``window >= 2``) dispatches under step N+1's
  first backward buckets.
* **Shard residency (ZeRO-2/3).** :func:`compile_window` feeds each
  bucket's ``ag_deadline`` (the step-N+1 forward layer that first
  consumes it) into the autotuner's residency model: buckets whose
  owner shard can stay resident compile to a lone reduce-scatter node,
  the allgather elided (``rs_resident``), visible in the digest.
* **Fusion spans the boundary.** When the contract holds, the tail's
  dense round-uniform allgather members fuse with step N+1's first
  reduce-scatter group into ONE table program
  (``pallas_lower.fuse_window``, op="window"), which the table kernel
  (``pallas_lower.sched_table``) runs on the card.

:func:`window_cost_model` is the pure alpha-beta A/B of the two-step
window against the single-step barrier.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from ...core.errors import ArgumentError
from . import autotune as _autotune
from . import ir
from . import pallas_lower as _pallas
from .stepprogram import CompiledStep, compile_step


@dataclass(frozen=True)
class CompiledWindow:
    """A two-step sliding window, compiled: the residency-aware step
    program it repeats, the window Program (s0 nodes + s0.tail + s1
    nodes; digest = identity), the fused boundary table program when
    the contract held, and the elision record."""

    step: CompiledStep
    program: ir.Program
    boundary: Optional[ir.Schedule]  # fused tail+next-RS, or None
    elided: tuple       # bucket indices whose allgather was elided
    ag_deadlines: tuple
    nranks: int = 0
    seed: int = 0
    topo_fp: str = ""
    compile_ms: float = 0.0

    def digest(self) -> str:
        return self.program.digest()


def _terminal_name(nd) -> str:
    """The node name whose completion arms a bucket's tail share."""
    return f"b{nd.bucket}.ag" if nd.choice == "rs_ag" else f"b{nd.bucket}"


def compile_window(nranks: int, buckets: Sequence, *,
                   tile_bytes=None, seed: Optional[int] = None,
                   topo_fp: Optional[str] = None,
                   node_choices: Optional[Sequence] = None,
                   ag_deadlines: Optional[Sequence] = None,
                   order: Optional[Sequence] = None,
                   name: str = "window") -> CompiledWindow:
    """Compile a two-step sliding window over one step's bucket list.

    ``ag_deadlines`` defaults to the identity mapping (bucket i's
    parameters are first consumed by forward layer i — the bucketer
    plans buckets in layer order); pass explicit deadlines when the
    next forward's consume order differs. Everything else matches
    :func:`~.stepprogram.compile_step`, which this calls with the
    deadlines threaded through the residency model.

    Deterministic: same (buckets, nranks, seed, cache state) on any
    controller yields a byte-identical window Program render/digest —
    including which allgather nodes were elided and whether the
    boundary fused.
    """
    if not buckets:
        raise ArgumentError("compile_window needs at least one bucket")
    t0 = time.perf_counter()
    if ag_deadlines is None:
        ag_deadlines = tuple(range(len(buckets)))
    else:
        ag_deadlines = tuple(
            None if d is None else int(d) for d in ag_deadlines)
        if len(ag_deadlines) != len(buckets):
            raise ArgumentError(
                f"ag_deadlines has {len(ag_deadlines)} entries for "
                f"{len(buckets)} buckets")
    step = compile_step(
        nranks, buckets, tile_bytes=tile_bytes, seed=seed,
        topo_fp=topo_fp, node_choices=node_choices,
        ag_deadlines=ag_deadlines, order=order, name=f"{name}.step")
    elided = tuple(nd.bucket for nd in step.nodes
                   if nd.choice == "rs_resident")

    # The window program: step N's nodes (s0.*), its broadcast tail as
    # an explicit schedulable node gated on the terminal reduction
    # nodes, then step N+1's nodes (s1.*) with NO dep on the tail —
    # that missing edge is the overlap the executor exploits.
    nodes: list[ir.ProgramNode] = []
    for prefix in ("s0", "s1"):
        for nd in step.program.nodes:
            nodes.append(ir.ProgramNode(
                name=f"{prefix}.{nd.name}", schedule=nd.schedule,
                deps=tuple(f"{prefix}.{d}" for d in nd.deps),
                deadline=nd.deadline))
        if prefix == "s0" and nranks >= 2:
            tail_deps = tuple(
                f"s0.{_terminal_name(nd)}" for nd in step.nodes
                if nd.choice != "rs_resident")
            if tail_deps:
                nodes.append(ir.ProgramNode(
                    name="s0.tail",
                    schedule=ir.allgather(nranks, order=order),
                    deps=tail_deps))
    meta = dict(step.program.meta)
    meta["window"] = 2
    meta["elided"] = (",".join(f"b{i}" for i in elided) if elided
                     else "-")

    # Boundary fusion: the tail's dense round-uniform allgather members
    # with step N+1's first reduce-scatter group, one table program
    # when the contract holds (ArgumentError means "keep per-node
    # kernels for this boundary", never a failed compile).
    boundary = None
    if nranks >= 2:
        tail_ags = [nd.schedule for nd in step.program.nodes
                    if nd.schedule.op == "allgather"]
        next_rs = [nd.schedule for nd in step.program.nodes
                   if nd.schedule.op == "reduce_scatter"]
        if tail_ags and next_rs:
            try:
                boundary = _pallas.fuse_window(
                    f"{name}.boundary", tail_ags, next_rs)
            except ArgumentError:
                boundary = None
    meta["boundary"] = boundary.digest() if boundary is not None else "none"

    program = ir.Program(name=name, nranks=nranks, nodes=tuple(nodes),
                         meta=meta)
    ir.check_program(program)
    return CompiledWindow(
        step=step, program=program, boundary=boundary, elided=elided,
        ag_deadlines=ag_deadlines, nranks=nranks, seed=step.seed,
        topo_fp=step.topo_fp,
        compile_ms=(time.perf_counter() - t0) * 1e3)


def window_cost_model(nranks: int, bucket_nbytes: Sequence[int], *,
                      backward_s: float,
                      coll_time_s: Callable[[str, int], float],
                      seed: Optional[int] = None,
                      ag_deadlines: Optional[Sequence] = None) -> dict:
    """Pure alpha-beta A/B of the two-step window vs the single-step
    barrier.

    ``coll_time_s(algo, nbytes)`` prices one collective; a ring
    allreduce's time splits evenly into its reduce half (hidden under
    backward in BOTH arms) and its broadcast-tail half (exposed at the
    barrier, overlapped or elided by the window). Residency decisions
    come from the same ``program_node_choice`` model the compiler
    uses, so the A/B prices exactly the window a controller would
    compile. Deterministic; all floats rounded for digest stability.
    """
    seed = _autotune._seed_var.value if seed is None else int(seed)
    sizes = [int(b) for b in bucket_nbytes]
    if ag_deadlines is None:
        ag_deadlines = tuple(range(len(sizes)))
    tail_all = 0.0      # barrier arm: every bucket's tail share
    tail_window = 0.0   # window arm: non-elided tails only
    elided = 0
    for nbytes, dl in zip(sizes, ag_deadlines):
        share = coll_time_s("ring", nbytes) / 2.0
        tail_all += share
        # The window arm runs the ZeRO pair configuration, so the
        # decision axis priced here is elide-vs-keep the allgather —
        # the same ag_elision_wins model the compiler applies to
        # (pinned or modeled) rs_ag nodes.
        if _autotune.ag_elision_wins(nbytes, nranks, seed, dl):
            elided += 1
        else:
            tail_window += share
    backward_s = float(backward_s)
    # Two steps each: barrier pays the full tail exposed at finish();
    # the window hides step 1's tail under step 2's backward and only
    # exposes the final tail (and any overhang) at flush().
    barrier_s = 2.0 * (backward_s + tail_all)
    window_s = (backward_s + max(backward_s, tail_window)
                + tail_window)
    overlap_s = min(backward_s, tail_window)
    return {
        "nranks": int(nranks),
        "buckets": len(sizes),
        "ag_elided": int(elided),
        "tail_s": round(tail_all, 9),
        "tail_window_s": round(tail_window, 9),
        "tail_overlap_s": round(overlap_s, 9),
        "barrier_s": round(barrier_s, 9),
        "window_s": round(window_s, 9),
        "speedup_x": round(barrier_s / max(window_s, 1e-12), 4),
    }


__all__ = ["CompiledWindow", "compile_window", "window_cost_model"]
