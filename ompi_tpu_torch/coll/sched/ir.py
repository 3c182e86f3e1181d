"""Schedule IR — declarative chunk/step collective programs (a copy of
``ompi_tpu/coll/sched/ir.py``, which imports nothing of JAX: the port
keeps its own, and ``render``/``digest`` are byte-identical to it).

GC3-style intermediate representation (PAPERS.md: "GC3: An Optimizing
Compiler for GPU Collective Communication"): a collective algorithm is
a ``Schedule`` — a per-rank program of send / reduce / copy steps over
named chunks of the flattened payload, grouped into rounds. The
generators below emit the classic algorithm shapes (ring,
recursive-doubling, segmented ring, hierarchical intra-host /
inter-host, quantized wire) parameterized by the physical topology
(runtime/mesh ring ordering, host grouping); the lowering pass
(sched/lower.py) interprets or tier-maps a Schedule into a callable
over the rank-major tensor.

Step kinds:

    send     rank ships chunk to peer this round (value read *after*
             any previous-round mutation of the chunk)
    reduce   rank combines the value received this round into chunk
    copy     rank overwrites chunk with the value received this round
    quant    annotation: the preceding send is wire-quantized
    dequant  annotation: the received value is dequantized before use

Well-formedness (``check``): within one round each rank sends at most
once and receives at most once, every send has a matching receive at
its peer, and chunk ids stay inside [0, nchunks). ``render`` dumps the
step program as text (the tools/sched CLI surface); ``digest`` is the
sha256 of that canonical text — the schedule identity the cache and
validity checker key on.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Optional, Sequence

KINDS = ("send", "reduce", "copy", "quant", "dequant")

#: Annotation kinds carry no data movement; the interpreter skips them.
ANNOTATIONS = ("quant", "dequant")


@dataclass(frozen=True)
class Step:
    """One IR statement: what ``rank`` does in ``round``."""

    round: int
    kind: str
    rank: int
    peer: int = -1  # -1 on local annotations
    chunk: int = 0

    def render(self) -> str:
        if self.kind == "send":
            return f"r{self.round}: {self.rank}->{self.peer} send c{self.chunk}"
        if self.kind in ("reduce", "copy"):
            return (f"r{self.round}: {self.rank}<-{self.peer} "
                    f"{self.kind} c{self.chunk}")
        return f"r{self.round}: {self.rank} {self.kind} c{self.chunk}"


@dataclass(frozen=True)
class Schedule:
    """A complete chunk/step program for one collective operation.

    ``nchunks`` is the data layout: the payload is flattened and
    zero-padded into ``nchunks`` equal chunks per rank. ``meta`` holds
    the lowering directive (``lowering``: 'interpret' | 'primitive',
    ``tier``: the transport tier of health/ledger's lattice) plus
    generator parameters (order, groups, wire, block, segments).
    """

    name: str
    op: str  # collective family, e.g. "allreduce"
    nranks: int
    nchunks: int
    steps: tuple = ()
    meta: dict = field(default_factory=dict)

    def rounds(self) -> int:
        return 1 + max((s.round for s in self.steps), default=-1)

    def render(self) -> str:
        head = (f"schedule {self.name} op={self.op} nranks={self.nranks} "
                f"nchunks={self.nchunks} rounds={self.rounds()} "
                f"tier={self.meta.get('tier', 'device')} "
                f"lowering={self.meta.get('lowering', 'interpret')}")
        # lowering-relevant generator params must reach the digest (the
        # lowering memo is keyed by it): two schedules with identical
        # steps but different wire codecs are different programs.
        extra = " ".join(
            f"{k}={self.meta[k]}"
            for k in ("primitive", "wire", "block", "segments")
            if k in self.meta
        )
        if extra:
            head = f"{head} {extra}"
        return "\n".join([head] + [s.render() for s in self.steps])

    def digest(self) -> str:
        return hashlib.sha256(self.render().encode()).hexdigest()[:16]


class ScheduleError(ValueError):
    """Malformed schedule program."""


def check(sched: Schedule) -> None:
    """Well-formedness: raise ScheduleError on the first violation."""
    sends: dict[int, dict[int, Step]] = {}
    recvs: dict[int, dict[int, Step]] = {}
    for s in sched.steps:
        if s.kind not in KINDS:
            raise ScheduleError(f"unknown step kind {s.kind!r}: {s}")
        if not 0 <= s.rank < sched.nranks:
            raise ScheduleError(f"rank out of range: {s}")
        if not 0 <= s.chunk < sched.nchunks:
            raise ScheduleError(f"chunk out of range: {s}")
        if s.kind in ANNOTATIONS:
            continue
        if not 0 <= s.peer < sched.nranks:
            raise ScheduleError(f"peer out of range: {s}")
        if s.peer == s.rank:
            raise ScheduleError(f"self-send: {s}")
        table = sends if s.kind == "send" else recvs
        per_round = table.setdefault(s.round, {})
        if s.rank in per_round:
            raise ScheduleError(
                f"rank {s.rank} {'sends' if s.kind == 'send' else 'receives'}"
                f" twice in round {s.round}"
            )
        per_round[s.rank] = s
    for rnd, by_rank in sends.items():
        for s in by_rank.values():
            match = recvs.get(rnd, {}).get(s.peer)
            if match is None or match.peer != s.rank:
                raise ScheduleError(
                    f"send without matching receive at peer: {s}"
                )
    for rnd, by_rank in recvs.items():
        for s in by_rank.values():
            match = sends.get(rnd, {}).get(s.peer)
            if match is None or match.peer != s.rank:
                raise ScheduleError(
                    f"receive without matching send at peer: {s}"
                )


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------

def _order_or_identity(nranks: int, order: Optional[Sequence[int]]
                       ) -> list[int]:
    if order is None:
        return list(range(nranks))
    order = list(order)
    if sorted(order) != list(range(nranks)):
        raise ScheduleError(
            f"order must be a permutation of range({nranks}): {order}"
        )
    return order


def _ring_steps(nranks: int, order: list[int], chunk_base: int = 0,
                round_base: int = 0) -> list[Step]:
    """Reduce-scatter + allgather ring rounds over chunk ids
    [chunk_base, chunk_base + nranks). Position p in the ring is rank
    order[p]; the chunk indices are computed in position space (any
    bijection is correct — every chunk visits every rank)."""
    n = nranks
    steps: list[Step] = []
    for k in range(n - 1):  # reduce-scatter phase
        rnd = round_base + k
        for p in range(n):
            succ = order[(p + 1) % n]
            pred = order[(p - 1) % n]
            steps.append(Step(rnd, "send", order[p], succ,
                              chunk_base + (p - k) % n))
            steps.append(Step(rnd, "reduce", order[p], pred,
                              chunk_base + (p - k - 1) % n))
    for k in range(n - 1):  # allgather phase
        rnd = round_base + n - 1 + k
        for p in range(n):
            succ = order[(p + 1) % n]
            pred = order[(p - 1) % n]
            steps.append(Step(rnd, "send", order[p], succ,
                              chunk_base + (p + 1 - k) % n))
            steps.append(Step(rnd, "copy", order[p], pred,
                              chunk_base + (p - k) % n))
    return steps


def ring(nranks: int, order: Optional[Sequence[int]] = None) -> Schedule:
    """Bandwidth-optimal ring (reference: coll_base_allreduce.c:341):
    n-1 reduce-scatter rounds + n-1 allgather rounds over n chunks.
    ``order`` is the topology-aware ring permutation (mesh.ring_order)
    so consecutive neighbors ride single-hop ICI links."""
    order = _order_or_identity(nranks, order)
    sched = Schedule(
        name="ring", op="allreduce", nranks=nranks, nchunks=nranks,
        steps=tuple(_ring_steps(nranks, order)),
        meta={"tier": "device", "lowering": "interpret", "order": order},
    )
    check(sched)
    return sched


def recursive_doubling(nranks: int) -> Schedule:
    """Butterfly exchange over the full buffer, log2(n) rounds
    (reference: coll_base_allreduce.c:130). Power-of-two rank counts
    only — callers degrade to ring otherwise, as the reference's tuned
    layer does."""
    if nranks & (nranks - 1):
        raise ScheduleError(
            f"recursive_doubling needs a power-of-two rank count, "
            f"got {nranks}"
        )
    steps: list[Step] = []
    k = 0
    dist = 1
    while dist < nranks:
        for r in range(nranks):
            steps.append(Step(k, "send", r, r ^ dist, 0))
            steps.append(Step(k, "reduce", r, r ^ dist, 0))
        dist <<= 1
        k += 1
    sched = Schedule(
        name="recursive_doubling", op="allreduce", nranks=nranks,
        nchunks=1, steps=tuple(steps),
        meta={"tier": "device", "lowering": "interpret"},
    )
    check(sched)
    return sched


def segmented_ring(nranks: int, segments: int,
                   order: Optional[Sequence[int]] = None) -> Schedule:
    """Ring cut into ``segments`` independent chunk ranges (reference:
    coll_base_allreduce.c:618). The rounds of different segments have
    no data dependence between them, so XLA overlaps their ppermutes
    with the combines after jit — the pipelining the reference gets
    from explicit segmentation."""
    if segments < 1:
        raise ScheduleError(f"segments must be >= 1, got {segments}")
    order = _order_or_identity(nranks, order)
    steps: list[Step] = []
    for s in range(segments):
        steps.extend(_ring_steps(nranks, order, chunk_base=s * nranks,
                                 round_base=s * (2 * nranks - 2)))
    sched = Schedule(
        name="segmented_ring", op="allreduce", nranks=nranks,
        nchunks=nranks * segments, steps=tuple(steps),
        meta={"tier": "device", "lowering": "interpret",
              "segments": segments, "order": order},
    )
    check(sched)
    return sched


def reduce_scatter(nranks: int,
                   order: Optional[Sequence[int]] = None) -> Schedule:
    """The reduce-scatter phase of the ring on its own: n-1 rounds over
    n chunks, after which rank r owns the fully reduced chunk r. The
    chunk walk is the first loop of ``_ring_steps`` re-anchored so the
    final reduce at position p lands on chunk order[p] — the rank-owns-
    its-own-index convention of REDUCE_SCATTER_ALGOS."""
    order = _order_or_identity(nranks, order)
    n = nranks
    steps: list[Step] = []
    for k in range(n - 1):
        for p in range(n):
            succ = order[(p + 1) % n]
            pred = order[(p - 1) % n]
            steps.append(Step(k, "send", order[p], succ,
                              order[(p - k - 1) % n]))
            steps.append(Step(k, "reduce", order[p], pred,
                              order[(p - k - 2) % n]))
    sched = Schedule(
        name="reduce_scatter", op="reduce_scatter", nranks=nranks,
        nchunks=nranks, steps=tuple(steps),
        meta={"tier": "device", "lowering": "interpret", "order": order},
    )
    check(sched)
    return sched


def allgather(nranks: int,
              order: Optional[Sequence[int]] = None) -> Schedule:
    """The allgather phase of the ring on its own: n-1 rounds over n
    chunks, starting from the reduce_scatter ownership convention
    (rank order[p] owns fully-reduced chunk order[p]). After the last
    round every rank holds all n chunks — the second half of a
    ZeRO-style RS/AG pair."""
    order = _order_or_identity(nranks, order)
    n = nranks
    steps: list[Step] = []
    for k in range(n - 1):
        for p in range(n):
            succ = order[(p + 1) % n]
            pred = order[(p - 1) % n]
            steps.append(Step(k, "send", order[p], succ,
                              order[(p - k) % n]))
            steps.append(Step(k, "copy", order[p], pred,
                              order[(p - k - 1) % n]))
    sched = Schedule(
        name="allgather", op="allgather", nranks=nranks,
        nchunks=nranks, steps=tuple(steps),
        meta={"tier": "device", "lowering": "interpret", "order": order},
    )
    check(sched)
    return sched


def with_lowering(sched: Schedule, lowering: str, **meta) -> Schedule:
    """The same step program under a different lowering directive (and
    optional extra meta). The digest changes with it — a pallas-lowered
    ring is a different compiled artifact than the interpreted one."""
    import dataclasses

    return dataclasses.replace(
        sched, meta={**sched.meta, "lowering": lowering, **meta})


def hierarchical(groups: Sequence[Sequence[int]]) -> Schedule:
    """Hierarchical allreduce over host groups (the coll/sm + tuned
    split): phase A reduces each group onto its leader (first member),
    phase B chains the leaders (reduce forward, result copy back),
    phase C broadcasts from each leader to its members. Full-buffer
    steps (nchunks=1) — the inter-host phase is latency-bound."""
    groups = [list(g) for g in groups if g]
    if not groups:
        raise ScheduleError("hierarchical needs at least one group")
    nranks = sum(len(g) for g in groups)
    flat = sorted(r for g in groups for r in g)
    if flat != list(range(nranks)):
        raise ScheduleError(
            f"groups must partition range({nranks}): {groups}"
        )
    leaders = [g[0] for g in groups]
    steps: list[Step] = []
    maxlen = max(len(g) for g in groups)
    rnd = 0
    for j in range(maxlen - 1):  # phase A: members -> leader
        for g in groups:
            if len(g) > j + 1:
                steps.append(Step(rnd, "send", g[j + 1], g[0], 0))
                steps.append(Step(rnd, "reduce", g[0], g[j + 1], 0))
        rnd += 1
    for i in range(len(leaders) - 1):  # phase B: leader chain reduce
        steps.append(Step(rnd, "send", leaders[i], leaders[i + 1], 0))
        steps.append(Step(rnd, "reduce", leaders[i + 1], leaders[i], 0))
        rnd += 1
    for i in range(len(leaders) - 1, 0, -1):  # phase B: result back
        steps.append(Step(rnd, "send", leaders[i], leaders[i - 1], 0))
        steps.append(Step(rnd, "copy", leaders[i - 1], leaders[i], 0))
        rnd += 1
    for j in range(maxlen - 1):  # phase C: leader -> members
        for g in groups:
            if len(g) > j + 1:
                steps.append(Step(rnd, "send", g[0], g[j + 1], 0))
                steps.append(Step(rnd, "copy", g[j + 1], g[0], 0))
        rnd += 1
    sched = Schedule(
        name="hierarchical", op="allreduce", nranks=nranks, nchunks=1,
        steps=tuple(steps),
        meta={"tier": "device", "lowering": "interpret",
              "groups": [list(g) for g in groups]},
    )
    check(sched)
    return sched


def quantized_wire(nranks: int, wire: str = "int8", block: int = 128,
                   order: Optional[Sequence[int]] = None) -> Schedule:
    """EQuARX-style quantized-wire ring: the ring step program with
    quant/dequant annotations at every hop. Lowered to the coll/quant
    primitive (the codec and the gate cannot disagree); the step
    program documents exactly where precision is traded for wire
    bytes."""
    order = _order_or_identity(nranks, order)
    base = _ring_steps(nranks, order)
    steps: list[Step] = []
    for s in base:
        if s.kind == "send":
            steps.append(Step(s.round, "quant", s.rank, -1, s.chunk))
            steps.append(s)
        elif s.kind == "reduce":
            steps.append(Step(s.round, "dequant", s.rank, -1, s.chunk))
            steps.append(s)
        else:
            steps.append(s)
    sched = Schedule(
        name="quantized_wire", op="allreduce", nranks=nranks,
        nchunks=nranks, steps=tuple(steps),
        meta={"tier": "device", "lowering": "primitive",
              "primitive": "quant_ring", "wire": wire, "block": block,
              "order": order},
    )
    check(sched)
    return sched


# ---------------------------------------------------------------------------
# multi-collective programs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ProgramNode:
    """One named sub-collective of a step Program.

    ``deps`` are names of other nodes whose completion gates this
    node's start — the readiness-dependency edge set the overlap
    executor honors (a ZeRO allgather depends on its reduce-scatter;
    a bucket allreduce depends on nothing but its own gradient tiles).
    """

    name: str
    schedule: Schedule
    deps: tuple = ()
    #: forward-consume deadline (slipstream): the step-N+1 layer index
    #: that first reads this node's output, or -1 when unknown.  Enters
    #: the render (and hence the program digest) only when set, so
    #: pre-slipstream programs keep their digests.
    deadline: int = -1

    def render(self) -> str:
        dep = ",".join(self.deps) if self.deps else "-"
        head = f"node {self.name} deps={dep}"
        if self.deadline >= 0:
            head = f"{head} deadline={self.deadline}"
        body = "\n".join("  " + ln
                         for ln in self.schedule.render().splitlines())
        return f"{head}\n{body}"


@dataclass(frozen=True)
class Program:
    """A whole-step communication program: named sub-collectives with
    explicit readiness dependencies between them (GC3's compilation
    unit lifted from one collective to the training step). ``meta``
    carries program-level compile decisions (per-node tile bytes,
    interleave order, RS/AG-vs-allreduce choices) so they reach the
    digest — two programs with the same nodes but different tile
    geometry are different compiled artifacts."""

    name: str
    nranks: int
    nodes: tuple = ()
    meta: dict = field(default_factory=dict)

    def node(self, name: str) -> ProgramNode:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def render(self) -> str:
        head = (f"program {self.name} nranks={self.nranks} "
                f"nodes={len(self.nodes)}")
        extra = " ".join(f"{k}={self.meta[k]}"
                         for k in sorted(self.meta)
                         if isinstance(self.meta[k],
                                       (str, int, float, bool)))
        if extra:
            head = f"{head} {extra}"
        return "\n".join([head] + [n.render() for n in self.nodes])

    def digest(self) -> str:
        return hashlib.sha256(self.render().encode()).hexdigest()[:16]


def check_program(prog: Program) -> None:
    """Program well-formedness: every sub-schedule checks, node names
    are unique, dependency edges resolve to earlier-declared or
    existing nodes, the dep graph is acyclic, and all nodes agree on
    the rank count."""
    names: set[str] = set()
    for node in prog.nodes:
        if node.name in names:
            raise ScheduleError(f"duplicate program node {node.name!r}")
        names.add(node.name)
        if node.schedule.nranks != prog.nranks:
            raise ScheduleError(
                f"node {node.name!r} nranks={node.schedule.nranks} "
                f"!= program nranks={prog.nranks}")
        check(node.schedule)
    for node in prog.nodes:
        for d in node.deps:
            if d not in names:
                raise ScheduleError(
                    f"node {node.name!r} depends on unknown node {d!r}")
            if d == node.name:
                raise ScheduleError(f"node {node.name!r} depends on itself")
    # cycle check: iteratively peel nodes whose deps are all peeled
    remaining = {n.name: set(n.deps) for n in prog.nodes}
    while remaining:
        ready = [k for k, deps in remaining.items()
                 if not deps & set(remaining)]
        if not ready:
            raise ScheduleError(
                f"dependency cycle among program nodes: "
                f"{sorted(remaining)}")
        for k in ready:
            del remaining[k]


def zero_pair(name: str, nranks: int,
              order: Optional[Sequence[int]] = None,
              ag_deadline: Optional[int] = None
              ) -> tuple[ProgramNode, ProgramNode]:
    """A ZeRO-style reduce-scatter + allgather node pair: ``<name>.rs``
    reduces shard order[p] onto rank order[p], ``<name>.ag`` (gated on
    the rs) circulates the reduced shards back out. Together they move
    the same bytes as a ring allreduce but expose the shard-owner
    boundary as a schedulable dependency edge.

    ``ag_deadline`` stamps the allgather node with the step-N+1 forward
    layer that first consumes this bucket's parameters (slipstream's
    residency cost input); it enters the node render and therefore the
    program digest."""
    rs = ProgramNode(name=f"{name}.rs",
                     schedule=reduce_scatter(nranks, order=order))
    ag = ProgramNode(name=f"{name}.ag",
                     schedule=allgather(nranks, order=order),
                     deps=(f"{name}.rs",),
                     deadline=-1 if ag_deadline is None else int(ag_deadline))
    return rs, ag


#: Generator registry for the CLI (`tools/sched dump --name ...`).
GENERATORS = {
    "ring": ring,
    "recursive_doubling": recursive_doubling,
    "segmented_ring": segmented_ring,
    "hierarchical": hierarchical,
    "quantized_wire": quantized_wire,
    "reduce_scatter": reduce_scatter,
    "allgather": allgather,
}


def generate(name: str, nranks: int, **params) -> Schedule:
    """Build a schedule by generator name (CLI entry)."""
    gen = GENERATORS.get(name)
    if gen is None:
        raise ScheduleError(
            f"unknown schedule generator {name!r}; known: "
            f"{sorted(GENERATORS)}"
        )
    if name == "hierarchical":
        groups = params.get("groups") or [list(range(nranks))]
        return gen(groups)
    if name == "segmented_ring":
        return gen(nranks, params.get("segments", 2),
                   order=params.get("order"))
    if name == "quantized_wire":
        return gen(nranks, params.get("wire", "int8"),
                   params.get("block", 128), order=params.get("order"))
    if name in ("ring", "reduce_scatter", "allgather"):
        return gen(nranks, order=params.get("order"))
    return gen(nranks)


__all__ = [
    "ANNOTATIONS", "GENERATORS", "KINDS", "Program", "ProgramNode",
    "Schedule", "ScheduleError", "Step", "allgather", "check",
    "check_program", "generate", "hierarchical", "quantized_wire",
    "recursive_doubling", "reduce_scatter", "ring", "segmented_ring",
    "with_lowering", "zero_pair",
]
