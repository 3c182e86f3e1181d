"""The table-driven lowering: Schedule IR -> one CUDA kernel.

Port of ``ompi_tpu/coll/sched/pallas_lower.py``. ``analyze`` checks the
"dense chained round-uniform" contract and extracts the kernel tables,
with the same ``ArgumentError`` clauses as the JAX package:

- **dense**: every rank sends exactly once and receives exactly once
  in every round (ring, segmented ring, the reduce-scatter and
  allgather phases; *not* hierarchical);
- **chained or fresh**: for each round r >= 1 either every rank sends
  the chunk it received in round r-1 (the ring chain), or every rank
  sends a chunk it has never received (a segment boundary, ``brk``:
  re-stage from the input);
- **round-uniform**: the receive kind (reduce/copy) and the
  is-last-receive-of-chunk property do not vary across ranks within a
  round.

``fuse_schedules`` and ``fuse_window`` chain members into one program;
``simulate`` is the lock-step oracle, as in the JAX package, on
tensors.

The kernel (``csrc/sched_table.cu``, replacing ``_kernel`` at
``ompi_tpu/coll/sched/pallas_lower.py:439``) runs any analyzed program:
the four (rounds, n) int32 tables (dst, src, send chunk, recv chunk)
and the per-round mode/last/brk go to the card as small int32 tensors,
and the kernel loops over the rounds at run time, so a fused program of
hundreds of rounds needs no recompilation. Round r sends from slot r%2
and lands in slot (r+1)%2, as in the JAX package. ``sched_table`` is
its wrapper, ``simulate_table`` its plain version: the same slot and
flag schedule rank by rank (``pallas_ring._drive``), lock-step or under
a seeded random interleaving.

Credit placement differs from the reference on purpose. ``_kernel``
sends a post-seed credit to ``t_src[1, me]`` (``pallas_lower.py:454-457``)
and credits slot ``nslot`` to ``t_src[r+2, me]`` right after FILLING it
(``:510-513``), though the rank still sends from that slot at round
r+1: the race ROADMAP Queue 3 records for the hand rings. The port
credits ``t_src[r+1, me]`` for slot r%2 right after round r's send
FROM it (r = 0..rounds-2), waits for that credit before the store of
round r >= 1 into ``t_dst[r, me]``'s slot (r+1)%2, and has no post-seed
credit: every wait meets exactly one credit and every flag ends at 0.
A sender counts its credits on one flag per (receiver, slot), where
``_kernel`` has one per slot: in a program whose peers change from
round to round (a ``fuse_window``, or a fused program whose members
take different ring orders) a credit from a later round's receiver
can otherwise arrive first and satisfy an earlier round's wait, and
the store lands on a slot that still holds an unsent partial. Each
slot has its own flags (at n = 2, ``t_src`` and ``t_dst`` name the same
peer). A stage round (round 0 and every ``brk`` round)
sends its chunk straight from the input: the reference stores it in
the rank's own slot first, where nothing reads it again before the
next arrival overwrites it.
"""

from __future__ import annotations

import collections
import dataclasses
import random
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ...core.counters import KernelCounter
from ...core.errors import ArgumentError
from ...ops import lookup as op_lookup
from ..pallas_ring import (LANES, _PAUSE, _check_credit, _checked, _codes,
                           _drive, _launch, _pad_chunk, _residue, _unpad)
from .ir import ANNOTATIONS, Schedule, Step, check as _check

#: The program kinds the table kernel runs (the JAX package keys its
#: collective ids by the same names).
_OPS = ("allgather", "allreduce", "reduce_scatter", "window")
_KIND = {"allreduce": 0, "reduce_scatter": 1, "allgather": 2, "window": 3}
#: Per-round info word of the kernel: mode in bits 0-1, last, brk.
_LAST, _BRK = 4, 8

#: compiled-wrapper memo keyed by schedule digest.
_COMPILED: dict[str, Callable] = {}

SCHED_TABLE = KernelCounter("sched_table")


@dataclass(frozen=True)
class _Program:
    """Kernel-ready constants extracted from a Schedule.

    The tables are (rounds, nranks) int32 CPU tensors; ``mode``/``last``
    /``brk`` are per-round Python constants. ``device_tables`` keeps
    the packed copy each card was given."""

    op: str
    nranks: int
    nchunks: int
    rounds: int
    mode: tuple       # 1=reduce, 2=copy
    last: tuple       # this round's value is the chunk's final value
    brk: tuple        # chain-break round: re-stage send chunk from x
    t_dst: torch.Tensor    # [r, k] -> peer k sends to
    t_src: torch.Tensor    # [r, k] -> peer that sends to k
    t_schunk: torch.Tensor  # [r, k] -> chunk k sends
    t_rchunk: torch.Tensor  # [r, k] -> chunk k receives into
    device_tables: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False)


def analyze(sched: Schedule) -> _Program:
    """Check the dense/chained/round-uniform contract and extract the
    kernel tables. Raises ArgumentError with the violated clause."""
    n, rounds = sched.nranks, sched.rounds()
    if sched.op not in _OPS:
        raise ArgumentError(
            f"pallas lowering supports ops {sorted(_OPS)}, "
            f"schedule {sched.name!r} is op={sched.op!r}")
    if any(s.kind in ANNOTATIONS for s in sched.steps):
        raise ArgumentError(
            f"schedule {sched.name!r} carries quant/dequant annotations"
            f" — quantized wires keep the primitive lowering")
    if rounds < 1:
        raise ArgumentError(f"schedule {sched.name!r} has no rounds")
    sends: list[dict] = [{} for _ in range(rounds)]
    recvs: list[dict] = [{} for _ in range(rounds)]
    for s in sched.steps:
        (sends if s.kind == "send" else recvs)[s.round][s.rank] = s
    t_dst = [[0] * n for _ in range(rounds)]
    t_src = [[0] * n for _ in range(rounds)]
    t_schunk = [[0] * n for _ in range(rounds)]
    t_rchunk = [[0] * n for _ in range(rounds)]
    mode, last, brk = [], [], []
    seen: list[set] = [set() for _ in range(n)]  # chunks k received
    for r in range(rounds):
        if set(sends[r]) != set(range(n)) or set(recvs[r]) != set(range(n)):
            raise ArgumentError(
                f"schedule {sched.name!r} round {r} is not dense: every"
                f" rank must send once and receive once (hierarchical-"
                f"style idle ranks have no pallas lowering)")
        kinds = {recvs[r][k].kind for k in range(n)}
        if len(kinds) != 1:
            raise ArgumentError(
                f"schedule {sched.name!r} round {r} mixes receive kinds"
                f" {sorted(kinds)} across ranks")
        mode.append(1 if kinds.pop() == "reduce" else 2)
        for k in range(n):
            t_dst[r][k] = sends[r][k].peer
            t_src[r][k] = recvs[r][k].peer
            t_schunk[r][k] = sends[r][k].chunk
            t_rchunk[r][k] = recvs[r][k].chunk
        if r == 0:
            brk.append(True)  # round 0 always stages from the input
        else:
            chained = all(t_schunk[r][k] == t_rchunk[r - 1][k]
                          for k in range(n))
            fresh = all(t_schunk[r][k] not in seen[k] for k in range(n))
            if not chained and not fresh:
                raise ArgumentError(
                    f"schedule {sched.name!r} round {r} is neither "
                    f"chained (send what round {r - 1} received) nor a "
                    f"uniform re-stage of untouched chunks")
            brk.append(not chained)
        if mode[r] == 1:
            for k in range(n):
                if t_rchunk[r][k] in seen[k]:
                    raise ArgumentError(
                        f"schedule {sched.name!r} round {r}: rank {k} "
                        f"reduces into chunk {t_rchunk[r][k]} it already"
                        f" received — the kernel combines against the "
                        f"original input")
        for k in range(n):
            seen[k].add(t_rchunk[r][k])
    for r in range(rounds):
        flags = {t_rchunk[r][k] not in
                 {t_rchunk[q][k] for q in range(r + 1, rounds)}
                 for k in range(n)}
        if len(flags) != 1:
            raise ArgumentError(
                f"schedule {sched.name!r} round {r}: is-last-receive "
                f"varies across ranks")
        last.append(flags.pop())
    if sched.op == "allreduce":
        for k in range(n):
            if seen[k] != set(range(sched.nchunks)):
                raise ArgumentError(
                    f"schedule {sched.name!r}: rank {k} never receives "
                    f"chunks {sorted(set(range(sched.nchunks)) - seen[k])}"
                    f" — the output would be partial")
    if sched.op == "allgather":
        # A rank never receives its own chunk: it reaches the output at
        # the stage/re-stage rounds instead, so completeness is
        # received ∪ staged.
        for k in range(n):
            own = {t_schunk[r][k] for r in range(rounds) if brk[r]}
            missing = set(range(sched.nchunks)) - (seen[k] | own)
            if missing:
                raise ArgumentError(
                    f"schedule {sched.name!r}: rank {k} neither receives"
                    f" nor stages chunks {sorted(missing)} — the output "
                    f"would be partial")
    if sched.op == "window":
        # Boundary-spanning programs (slipstream): completeness holds
        # member-wise. Segments are the brk-delimited round runs; each
        # must be mode-uniform, and copy segments must cover their chunk
        # universe like a standalone allgather.
        seg_start = [r for r in range(rounds) if brk[r]]
        for si, s0 in enumerate(seg_start):
            s1 = (seg_start[si + 1] if si + 1 < len(seg_start)
                  else rounds)
            modes = {mode[r] for r in range(s0, s1)}
            if len(modes) != 1:
                raise ArgumentError(
                    f"schedule {sched.name!r}: window segment rounds "
                    f"{s0}..{s1 - 1} mix reduce and copy receive kinds")
            if modes == {2}:
                universe = {t_schunk[r][k]
                            for r in range(s0, s1) for k in range(n)}
                universe |= {t_rchunk[r][k]
                             for r in range(s0, s1) for k in range(n)}
                for k in range(n):
                    got = {t_rchunk[r][k] for r in range(s0, s1)}
                    got |= {t_schunk[r][k] for r in range(s0, s1)
                            if brk[r]}
                    missing = universe - got
                    if missing:
                        raise ArgumentError(
                            f"schedule {sched.name!r}: window copy "
                            f"segment at round {s0}: rank {k} neither "
                            f"receives nor stages chunks "
                            f"{sorted(missing)}")

    def table(rows):
        return torch.tensor(rows, dtype=torch.int32)

    return _Program(op=sched.op, nranks=n, nchunks=sched.nchunks,
                    rounds=rounds, mode=tuple(mode), last=tuple(last),
                    brk=tuple(brk), t_dst=table(t_dst), t_src=table(t_src),
                    t_schunk=table(t_schunk), t_rchunk=table(t_rchunk))


def fuse_schedules(name: str, scheds) -> Schedule:
    """Chain same-op, same-rank-count dense schedules into ONE table
    program: member i's chunks occupy the id range ``[base_i, base_i +
    nchunks_i)`` and its rounds follow member i-1's. The first round of
    each member is a segment boundary — every rank re-stages a chunk it
    has never received, exactly ``segmented_ring``'s structure — so a
    whole step program's worth of ring collectives runs as one kernel
    launch instead of one per bucket.

    Reduce-scatter members are rejected: the RS kernel's output
    contract is one chunk per rank, which a multi-segment table would
    silently violate.
    """
    scheds = list(scheds)
    if not scheds:
        raise ArgumentError("fuse_schedules needs at least one schedule")
    op, n = scheds[0].op, scheds[0].nranks
    if op == "reduce_scatter":
        raise ArgumentError(
            "fuse_schedules: reduce_scatter programs keep per-node "
            "kernels (single-chunk output contract)")
    for s in scheds:
        if s.op != op or s.nranks != n:
            raise ArgumentError(
                f"fuse_schedules: member {s.name!r} is "
                f"(op={s.op!r}, nranks={s.nranks}), group is "
                f"(op={op!r}, nranks={n})")
    steps: list[Step] = []
    chunk_base = round_base = 0
    for s in scheds:
        for st in s.steps:
            steps.append(Step(st.round + round_base, st.kind, st.rank,
                              st.peer, st.chunk + chunk_base))
        chunk_base += s.nchunks
        round_base += s.rounds()
    fused = Schedule(
        name=name, op=op, nranks=n, nchunks=chunk_base,
        steps=tuple(steps),
        meta={"tier": "device_pallas", "lowering": "pallas",
              "segments": len(scheds)},
    )
    _check(fused)
    analyze(fused)  # enforce the dense/chained/round-uniform contract
    return fused


def fuse_window(name: str, tail_scheds, next_scheds) -> Schedule:
    """Fuse a step-boundary window into ONE table program (slipstream):
    step N's allgather members chained with step N+1's first
    reduce-scatter group, with ``fuse_schedules``' chunk-base/round-base
    chaining. The fused op is ``"window"``: copy segments write like an
    allgather, reduce segments emit each rank's own reduced chunk at
    their segment-final round.

    The contract is strict — every tail member must be op="allgather",
    every next-step member op="reduce_scatter", all on one rank count."""
    tail = list(tail_scheds)
    nxt = list(next_scheds)
    if not tail or not nxt:
        raise ArgumentError(
            "fuse_window needs at least one tail member and one "
            "next-step member")
    n = tail[0].nranks
    for s in tail:
        if s.op != "allgather":
            raise ArgumentError(
                f"fuse_window: tail member {s.name!r} is op={s.op!r}, "
                f"the broadcast tail fuses allgather members only")
    for s in nxt:
        if s.op != "reduce_scatter":
            raise ArgumentError(
                f"fuse_window: next-step member {s.name!r} is "
                f"op={s.op!r}, the boundary fuses into the next step's "
                f"reduce-scatter group only")
    for s in tail + nxt:
        if s.nranks != n:
            raise ArgumentError(
                f"fuse_window: member {s.name!r} has nranks="
                f"{s.nranks}, window is nranks={n}")
    steps: list[Step] = []
    chunk_base = round_base = 0
    for s in tail + nxt:
        for st in s.steps:
            steps.append(Step(st.round + round_base, st.kind, st.rank,
                              st.peer, st.chunk + chunk_base))
        chunk_base += s.nchunks
        round_base += s.rounds()
    fused = Schedule(
        name=name, op="window", nranks=n, nchunks=chunk_base,
        steps=tuple(steps),
        meta={"tier": "device_pallas", "lowering": "pallas",
              "segments": len(tail) + len(nxt),
              "boundary": len(tail)},
    )
    _check(fused)
    analyze(fused)  # enforce the dense/chained/round-uniform contract
    return fused


def compile_schedule(sched: Schedule) -> Callable:
    """Schedule -> callable. Allreduce programs get the ALLREDUCE_ALGOS
    signature ``fn(b, op)`` over the rank-major (n, ...) tensor;
    reduce-scatter programs the REDUCE_SCATTER_ALGOS one ((n, n, ...)
    contributions -> (n, ...) own reduced blocks)."""
    key = sched.digest()
    fn = _COMPILED.get(key)
    if fn is None:
        prog = analyze(sched)
        fn = _COMPILED[key] = _make_wrapper(prog, sched.name)
    return fn


def clear_compiled() -> None:
    """Forget compiled wrappers (tests / re-init)."""
    _COMPILED.clear()


def _as_program(sched) -> _Program:
    return analyze(sched) if isinstance(sched, Schedule) else sched


def _check_data(prog: _Program, data: torch.Tensor) -> None:
    if data.ndim != 3 or data.shape[0] != prog.nranks \
            or data.shape[1] != prog.nchunks:
        raise ArgumentError(
            f"simulate expects data shaped ({prog.nranks}, "
            f"{prog.nchunks}, chunk), got {tuple(data.shape)}")


def simulate(sched, data: torch.Tensor, op) -> torch.Tensor:
    """Host-side oracle: execute the extracted table program with the
    exact slot/store semantics of the JAX package's ``_kernel``, one
    rank at a time, every round in lock-step (the JAX package's
    ``simulate``, on tensors).

    ``data`` is the stacked per-rank input, shape (nranks, nchunks,
    chunk). Returns the stacked per-rank outputs: (nranks, nchunks,
    chunk) for allreduce, allgather and window, (nranks, chunk) for
    reduce_scatter."""
    op = op_lookup(op)
    prog = _as_program(sched)
    n, rounds = prog.nranks, prog.rounds
    _check_data(prog, data)
    t_src, t_sch, t_rch = (prog.t_src.tolist(), prog.t_schunk.tolist(),
                           prog.t_rchunk.tolist())
    comm: list[list] = [[None, None] for _ in range(n)]
    if prog.op == "reduce_scatter":
        out: list = [None] * n
    else:
        out = [[None] * prog.nchunks for _ in range(n)]
    for k in range(n):
        comm[k][0] = data[k, t_sch[0][k]]
    for r in range(rounds):
        slot, nslot = r % 2, (r + 1) % 2
        if r >= 1 and prog.brk[r]:
            for k in range(n):
                comm[k][slot] = data[k, t_sch[r][k]]
        if prog.brk[r] and (prog.op == "allgather"
                            or (prog.op == "window"
                                and prog.mode[r] == 2)):
            # Own chunk never travels: it reaches the output at the
            # stage round (copy segments only).
            for k in range(n):
                c = t_sch[r][k]
                out[k][c] = data[k, c]
        # All round-r sends read their source slot before any round-r
        # arrival lands.
        arrivals = [comm[t_src[r][k]][slot] for k in range(n)]
        for k in range(n):
            comm[k][nslot] = arrivals[k]
            if prog.mode[r] == 1:
                val = op.combine(comm[k][nslot], data[k, t_rch[r][k]])
                if r + 1 < rounds and not prog.brk[r + 1]:
                    comm[k][nslot] = val
            else:
                val = comm[k][nslot]
            if prog.op == "reduce_scatter":
                if r == rounds - 1:
                    out[k] = val
            elif prog.op == "window" and prog.mode[r] == 1:
                # Reduce segment of a boundary window: only the
                # segment-final receive is fully reduced (the rank's
                # own shard).
                if r == rounds - 1 or prog.brk[r + 1]:
                    out[k][t_rch[r][k]] = val
            elif prog.last[r]:
                out[k][t_rch[r][k]] = val
    if prog.op == "reduce_scatter":
        return torch.stack(out)
    if prog.op == "window":
        # Reduce-segment chunks a rank does not own never reach its
        # output — backfill with the rank's input so the stacked
        # result is dense.
        for k in range(n):
            for c in range(prog.nchunks):
                if out[k][c] is None:
                    out[k][c] = data[k, c]
    return torch.stack([torch.stack(row) for row in out])


# ---------------------------------------------------------------------------
# The kernel's plain version and wrapper.
# ---------------------------------------------------------------------------

def _out_like(prog: _Program, data: torch.Tensor) -> torch.Tensor:
    """The output buffer: (n, chunk) for reduce_scatter; for a window a
    copy of the input, which stands for every chunk the program never
    writes (``simulate``'s backfill); empty otherwise."""
    if prog.op == "reduce_scatter":
        return data.new_empty((prog.nranks, data.shape[2]))
    if prog.op == "window":
        return data.clone()
    return torch.empty_like(data)


def simulate_table(sched, data: torch.Tensor, op, *, credit: str = "port",
                   rng: Optional[random.Random] = None,
                   shared_caps: bool = False):
    """Run the table kernel's slot and flag schedule on ``data`` (n,
    nchunks, chunk), one generator per rank driven by
    ``pallas_ring._drive``: lock-step with ``rng`` None, a seeded random
    interleaving with a ``random.Random``. Returns (out, residue):
    residue maps every flag not back at 0 to its count.

    ``credit`` "port" is the kernel's protocol (module docstring);
    "reference" is the JAX package's ``_kernel``: the seed and every
    re-stage stored in the rank's own slot, a post-seed credit, and a
    credit for slot (r+1)%2 to ``t_src[r+2]`` right after filling it,
    counted on one flag per slot, whoever grants it. The port keeps a
    sender's credits apart by the receiver that grants them;
    ``shared_caps`` counts them on one flag per slot instead (the
    negative control: where a program's peers change from round to
    round, a later receiver's credit satisfies an earlier wait)."""
    _check_credit(credit)
    op = op_lookup(op)
    prog = _as_program(sched)
    _check_data(prog, data)
    n, rounds = prog.nranks, prog.rounds
    ref = credit == "reference"
    per_peer = not (ref or shared_caps)
    t_dst, t_src = prog.t_dst.tolist(), prog.t_src.tolist()
    t_sch, t_rch = prog.t_schunk.tolist(), prog.t_rchunk.tolist()
    comm = data.new_empty((n, 2, data.shape[2]))
    out = _out_like(prog, data)
    sems: dict = collections.defaultdict(int)

    def cap(sender: int, receiver: int, slot: int) -> tuple:
        """The flag on which ``sender`` counts the credits for its
        writes into ``slot`` of ``receiver``."""
        return (sender, "cap", receiver if per_peer else None, slot)

    def own_out(r: int) -> bool:
        return prog.brk[r] and (prog.op == "allgather" or (
            prog.op == "window" and prog.mode[r] == 2))

    def rank(me):
        xr = data[me]
        if ref:
            comm[me, 0] = xr[t_sch[0][me]]
            if rounds >= 2:
                sems[cap(t_src[1][me], me, 0)] += 1
            yield _PAUSE
        for r in range(rounds):
            slot, nslot = r % 2, (r + 1) % 2
            stage = xr[t_sch[r][me]]
            if own_out(r):
                out[me, t_sch[r][me]] = stage
            dst = t_dst[r][me]
            if r >= 1:
                yield cap(me, dst, nslot), 1
            if ref and r >= 1 and prog.brk[r]:
                comm[me, slot] = stage
            comm[dst, nslot] = comm[me, slot] \
                if ref or not prog.brk[r] else stage
            sems[dst, "recv", nslot] += 1
            if not ref and r <= rounds - 2:
                sems[cap(t_src[r + 1][me], me, slot)] += 1
            yield (me, "recv", nslot), 1
            rc = t_rch[r][me]
            if prog.mode[r] == 1:
                val = op.combine(comm[me, nslot], xr[rc])
                if r + 1 < rounds and not prog.brk[r + 1]:
                    comm[me, nslot] = val
            else:
                val = comm[me, nslot]
            if prog.op == "reduce_scatter":
                if r == rounds - 1:
                    out[me] = val
            elif prog.op == "window" and prog.mode[r] == 1:
                if r == rounds - 1 or prog.brk[r + 1]:
                    out[me, rc] = val
            elif prog.last[r]:
                out[me, rc] = val
            if ref and r <= rounds - 3:
                sems[cap(t_src[r + 2][me], me, nslot)] += 1

    _drive([rank(k) for k in range(n)], sems, rng)
    return out, _residue(sems)


def sched_table_plain(sched, data: torch.Tensor, op) -> torch.Tensor:
    return _checked(simulate_table(sched, data, op))


def _device_tables(prog: _Program, device: torch.device):
    """The packed (4, rounds, n) tables and the per-round info words on
    ``device``, uploaded once per program and card."""
    got = prog.device_tables.get(device)
    if got is None:
        info = [m | (_LAST if l else 0) | (_BRK if b else 0)
                for m, l, b in zip(prog.mode, prog.last, prog.brk)]
        got = prog.device_tables[device] = (
            torch.stack([prog.t_dst, prog.t_src, prog.t_schunk,
                         prog.t_rchunk]).to(device),
            torch.tensor(info, dtype=torch.int32).to(device))
    return got


def sched_table(sched, data: torch.Tensor, op) -> torch.Tensor:
    """Run an analyzed program on ``data`` (n, nchunks, chunk): the
    kernel for a CUDA tensor, the plain version for a CPU one. Returns
    what ``simulate`` returns."""
    op = op_lookup(op)
    prog = _as_program(sched)
    _check_data(prog, data)
    if not data.is_cuda:
        return sched_table_plain(prog, data, op)
    tables, info = _device_tables(prog, data.device)
    chunk = data.shape[2]
    out = _out_like(prog, data)
    return _launch("sched_table", SCHED_TABLE, data, out.shape, chunk,
                   2 * prog.nranks, 2 + 2 * prog.nranks,
                   (tables.data_ptr(), info.data_ptr(), prog.rounds,
                    prog.nchunks, chunk, _KIND[prog.op]),
                   _codes(op, data.dtype), out=out)


def _make_wrapper(prog: _Program, name: str, *,
                  table: Callable = sched_table) -> Callable:
    """The registered-algorithm callable over the rank-major tensor,
    with the JAX package's layout: an allreduce's per-rank payload cut
    into ``nchunks`` chunks of ``ceil(total / nchunks)`` rounded up to
    128 elements (the chunk boundaries decide each element's fold
    order); a reduce-scatter's (n, ...) contribution rows each padded to
    128. n == 1 returns the input unchanged. ``table`` lets a caller run
    the plain version on the same layout."""
    def check_ranks(n: int) -> None:
        if n != prog.nranks:
            raise ArgumentError(
                f"schedule {name!r} compiled for {prog.nranks} ranks, "
                f"got {n}")

    if prog.op == "reduce_scatter":
        def run_rs(b: torch.Tensor, op) -> torch.Tensor:
            n = b.shape[0]
            check_ranks(n)
            if b.ndim < 2 or b.shape[1] != n:
                raise ArgumentError(
                    f"reduce_scatter input must be (ranks, ranks, ...), "
                    f"got {tuple(b.shape)}")
            if n == 1:
                return b[:, 0]
            flat, pad, shape = _pad_chunk(b, lead=2)
            return _unpad(table(prog, flat, op), pad, shape)

        return run_rs

    def run(b: torch.Tensor, op) -> torch.Tensor:
        n = b.shape[0]
        check_ranks(n)
        if n == 1:
            return b
        flat = b.reshape(n, -1)
        total = flat.shape[1]
        chunk = -(-total // prog.nchunks)
        chunk = -(-chunk // LANES) * LANES
        if chunk * prog.nchunks != total:
            flat = torch.nn.functional.pad(
                flat, (0, chunk * prog.nchunks - total))
        out = table(prog, flat.reshape(n, prog.nchunks, chunk), op)
        return out.reshape(n, -1)[:, :total].reshape(b.shape).contiguous()

    return run


__all__ = ["SCHED_TABLE", "analyze", "clear_compiled", "compile_schedule",
           "fuse_schedules", "fuse_window", "sched_table",
           "sched_table_plain", "simulate", "simulate_table"]
