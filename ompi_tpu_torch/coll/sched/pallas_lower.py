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
and a per-round info word (mode, last, brk and the links between
stages) go to the card once per program as small int32 tensors, and
the kernel loops over the rounds at run time, so a fused program of
hundreds of rounds needs no recompilation. ``sched_table`` is its
wrapper, ``sched_table_plain`` (``simulate_table_fused``) its plain
version: the same buffers and flags, rank by rank
(``pallas_ring._drive``), lock-step or under a seeded random
interleaving.

The kernel folds and forwards in one pass per round, in a wavefront
over segments. A stage is a stage round (round 0 and every ``brk``
round) and the chained rounds after it. At round k of a stage a rank
folds ``combine(arrival, x[me][t_rchunk])`` (the JAX package's operands
in its order) or takes the arrival as it is, writes it where ``_kernel``
writes it, and stores it straight into the buffer of ``t_dst[k+1]``
when round k+1 is chained; a stage round reads the sender's chunk from
its input, with no handover. In time slot t a rank makes round k on
segment t - k for every k that has one; two buffers per chained round
of a stage, by the parity of t. Arrival flags belong to (round of the
stage, parity) at the receiver, credit flags to (receiver, round of the
stage, parity) at the sender: a round's peers may change from stage to
stage (a fused program, a window, members with other ring orders), and
a credit counted on a flag of the slot alone lets a later stage's
receiver satisfy an earlier wait. A rank credits a buffer it read to
the rank that writes it next (the same sender two slots later, or the
sender of that round of the next stage that has one); a sender waits
for a credit before each write into a buffer that was written before.
Every wait meets exactly one raise and every flag ends at 0.

``simulate_table`` keeps the first port's two-slot schedule (one slot
pair per rank, a copy then a fold each round) with its credit
placement and, as ``credit="reference"``, the JAX package's.
``_kernel`` sends a post-seed credit to ``t_src[1, me]``
(``pallas_lower.py:454-457``) and credits slot ``nslot`` to
``t_src[r+2, me]`` right after FILLING it (``:510-513``), though the
rank still sends from that slot at round r+1: the race ROADMAP Queue 3
records for the hand rings. The first port credited ``t_src[r+1, me]``
for slot r%2 right after round r's send FROM it, waited for that credit
before its store of round r >= 1 into ``t_dst[r, me]``'s slot (r+1)%2,
had no post-seed credit, and counted a sender's credits on one flag per
(receiver, slot), where ``_kernel`` has one per slot (``shared_caps``).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import random
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ...core import build
from ...core.counters import KernelCounter
from ...core.device import require_kernel_device
from ...core.errors import ArgumentError, KernelError
from ...ops import lookup as op_lookup
from ..pallas_ring import (LANES, _PAUSE, _aligned, _check_credit,
                           _check_fused_credit, _checked, _codes, _drive,
                           _entry, _pad_chunk, _plain_seg, _raw_stream,
                           _residue, _scratch, _stripes, _unpad)
from .ir import ANNOTATIONS, Schedule, Step, check as _check

#: The program kinds the table kernel runs (the JAX package keys its
#: collective ids by the same names).
_OPS = ("allgather", "allreduce", "reduce_scatter", "window")
_KIND = {"allreduce": 0, "reduce_scatter": 1, "allgather": 2, "window": 3}
#: Per-round info word of the kernel: mode in bits 0-1, last, brk, prv
#: (an earlier stage has a round at this round's place), and from bit
#: ``_NEXT_SHIFT`` up nxt + 1 (the round at this place of the next stage
#: that has one; 0 for none).
_LAST, _BRK, _PRV, _NEXT_SHIFT = 4, 8, 16, 8
#: The table kernel's plans (csrc/sched_table.cu, ``_table_plan``), as
#: the ring reduce-scatter's (``pallas_ring._rs_plan``): bytes of a
#: segment (one buffer; a stripe takes at least one), threads per block
#: and blocks per SM. Up to ``TABLE_CLUSTER_RANKS`` ranks (the portable
#: cluster size) one cluster of the n ranks' blocks runs each stripe,
#: its buffers and flags in the reading (or waiting) rank's shared
#: memory, a block's buffers within ``TABLE_SMEM_BYTES``; beyond, the
#: buffers are in HBM, all blocks' within ``TABLE_SLOT_BYTES`` so that
#: they stay in the 50 MB L2. The sweep of the segmented program at 1 GiB
#: per rank, n = 8, on an NVIDIA H100 (PERF.md, tools/bidir_table_check.py):
#: in shared memory 62 stripes x 128 threads at 2 KiB 9.09 ms, 30 x 256
#: at 4 KiB 9.71, 15 x 512 at 8 KiB 10.60, a segment of fewer bytes than
#: 16 per thread 13.4-50.5; in L2 11.55 at best (16 x 512 at 8 KiB).
TABLE_CLUSTER_RANKS = 8
TABLE_CLUSTER_SEG_BYTES, TABLE_CLUSTER_THREADS, \
    TABLE_CLUSTER_BLOCKS_PER_SM = 2 << 10, 128, 4
TABLE_SEG_BYTES, TABLE_THREADS, TABLE_BLOCKS_PER_SM = 8 << 10, 512, 1
TABLE_SMEM_BYTES, TABLE_SLOT_BYTES = 56 << 10, 24 << 20
#: Buffers per chained round of a stage, one for each parity of the time
#: slot, and the most rounds a stage may have (a lane per pass of a slot,
#: with the own chunk's copy, in blocks of at least 64 threads).
TABLE_BUFS, TABLE_MAX_STAGE = 2, 63

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
    #: (segments, credit flags per peer) -> ``_wavefront``'s schedule.
    wavefronts: dict = dataclasses.field(
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
    """Run the two-slot schedule of the first port's table kernel on
    ``data`` (n, nchunks, chunk): a copy into the receiver's slot, then a
    fold, every round. One generator per rank driven by
    ``pallas_ring._drive``: lock-step with ``rng`` None, a seeded random
    interleaving with a ``random.Random``. Returns (out, residue):
    residue maps every flag not back at 0 to its count.

    ``credit`` "port" is the first port's placement (module docstring);
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


def _stages(prog: _Program) -> list[tuple[int, int]]:
    """(first round, rounds) of each stage: round 0 and every brk round
    start one, and the chained rounds after it belong to it."""
    starts = [r for r in range(prog.rounds) if prog.brk[r]]
    ends = starts[1:] + [prog.rounds]
    return [(b, e - b) for b, e in zip(starts, ends)]


def _links(prog: _Program) -> tuple[list[bool], list[int]]:
    """Per round at place j of its stage: whether an earlier stage has a
    round at place j (``prv``), and the round at place j of the next
    stage that has one, or -1 (``nxt``). A buffer (j, parity) is written
    by stage after stage; these name its previous and next writer's
    round."""
    stages = _stages(prog)
    prv, nxt = [False] * prog.rounds, [-1] * prog.rounds
    for si, (b, length) in enumerate(stages):
        for j in range(length):
            prv[b + j] = any(lo > j for _, lo in stages[:si])
            nxt[b + j] = next((b2 + j for b2, lo in stages[si + 1:]
                               if lo > j), -1)
    return prv, nxt


@dataclass
class _Wavefront:
    """The table kernel's schedule for chunks of ``n_segs`` segments
    (``_wavefront``). ``plans[me]`` lists rank me's time slots, stage
    after stage: (the flags to wait for, the credits to grant after the
    passes, its passes). A pass is (its node, the buffer it reads or
    None at a stage round, the buffer and the flag of its forward or
    None, the node the schedule means it to read). ``meant`` maps every
    node to what it means to read (a node, or a token of x at a stage
    round); ``written`` maps each output chunk (rank, chunk, or None for
    a reduce-scatter's one) to the node or token each of its segments
    takes. Flags, buffers, nodes and tokens are ints, for speed:
    ``flags[f]`` names flag f, node (me * rounds + rd) * n_segs + i is
    the pass of round rd on segment i, token -1 - (row * n_segs + i)
    segment i of row ``row`` of x (n * nchunks rows)."""

    n_segs: int
    plans: list
    flags: list
    meant: dict
    written: dict


def _wavefront(prog: _Program, n_segs: int, per_peer: bool) -> _Wavefront:
    """The table kernel's schedule (``_Wavefront``), stage by stage
    (``_stages``). Flags: arrivals keyed (receiver, "recv", round of the
    stage, parity), credits (sender, "cap", receiver, round of the
    stage, parity), the receiver None unless ``per_peer``. Kept on the
    program per (n_segs, per_peer)."""
    key = (n_segs, per_peer)
    if key in prog.wavefronts:
        return prog.wavefronts[key]
    n, rounds, nchunks = prog.nranks, prog.rounds, prog.nchunks
    t_dst, t_src = prog.t_dst.tolist(), prog.t_src.tolist()
    t_sch, t_rch = prog.t_schunk.tolist(), prog.t_rchunk.tolist()
    rs, window = prog.op == "reduce_scatter", prog.op == "window"
    prv, nxt = _links(prog)
    names: dict = {}
    meant: dict = {}
    written: dict = collections.defaultdict(lambda: [None] * n_segs)

    def flag(*name) -> int:
        return names.setdefault(name, len(names))

    def cap(sender, receiver, j, p):
        return flag(sender, "cap", receiver if per_peer else None, j, p)

    def buf(rank, j, p):
        return (rank * rounds + j) * 2 + p

    def writes(rd: int) -> bool:
        if rs:
            return rd == rounds - 1
        if window and prog.mode[rd] == 1:
            return rd == rounds - 1 or prog.brk[rd + 1]
        return prog.last[rd]

    plans = []
    for me in range(n):
        plan = []
        for b0, length in _stages(prog):
            own_copy = prog.op == "allgather" or (window
                                                  and prog.mode[b0] == 2)
            for t in range(n_segs + length - 1):
                p, np_ = t % 2, (t + 1) % 2
                waits, credits, passes = [], [], []
                for k in range(max(0, t - n_segs + 1),
                               min(length - 1, t) + 1):
                    rd, i = b0 + k, t - k
                    src = t_src[rd][me]
                    node = (me * rounds + rd) * n_segs + i
                    read = None
                    if k:
                        read = buf(me, k, p)
                        meant[node] = (src * rounds + rd - 1) * n_segs + i
                        waits.append((flag(me, "recv", k, p), 1))
                        nx = rd if t + 2 <= k + n_segs - 1 else nxt[rd]
                        if nx >= 0:
                            credits.append(cap(t_src[nx][me], me, k, p))
                    else:
                        meant[node] = -1 - ((src * nchunks + t_sch[rd][src])
                                            * n_segs + i)
                    fwd = raise_ = None
                    if k < length - 1:
                        dst = t_dst[rd + 1][me]
                        fwd, raise_ = (buf(dst, k + 1, np_),
                                       flag(dst, "recv", k + 1, np_))
                        if t - 1 >= k + 1 or prv[rd + 1]:
                            waits.append((cap(me, dst, k + 1, np_), 1))
                    if writes(rd):
                        written[me, None if rs else t_rch[rd][me]][i] = node
                    passes.append((node, read, fwd, raise_, meant[node]))
                if own_copy and t < n_segs:
                    sc = t_sch[b0][me]
                    written[me, sc][t] = -1 - ((me * nchunks + sc) * n_segs
                                               + t)
                plan.append((waits, credits, passes))
        plans.append(plan)
    got = prog.wavefronts[key] = _Wavefront(n_segs, plans, list(names),
                                            meant, dict(written))
    return got


def simulate_table_fused(sched, data: torch.Tensor, op, *,
                         seg_cols: Optional[int] = None,
                         credit: str = "after_read", flags: str = "port",
                         rng: Optional[random.Random] = None):
    """Run the table kernel's fold-then-forward wavefront on ``data`` (n,
    nchunks, chunk), each chunk cut into segments of ``seg_cols`` columns
    (the last ragged; default one), one generator per rank driven by
    ``pallas_ring._drive``: lock-step with ``rng`` None, a seeded random
    interleaving with a ``random.Random``. Returns (out, residue) as
    ``simulate_table`` does; out is bitwise ``simulate``'s.

    Stage by stage (``_stages``), in time slot t rank me makes round k
    of the stage on segment t - k for every k that has one
    (``_wavefront``). Round k's arrival is the sender's chunk from its
    input (k = 0) or buffer (k, t mod 2), which the sender filled in its
    slot t - 1; the rank folds ``combine(arrival, x[me][t_rchunk])`` (a
    copy round takes the arrival), writes it where ``simulate`` writes
    it, and stores it into buffer (k + 1, (t + 1) mod 2) of
    ``t_dst[k+1][me]`` when round k+1 is chained. An allgather, or a
    window's copy segment, writes its own chunk at the stage round.
    Before a slot it waits for each arrival's flag, keyed (receiver,
    round of the stage, parity), and for a credit before each write into
    a buffer that was written before, keyed (sender, receiver, round of
    the stage, parity); after its passes it raises the receivers'
    arrival flags and credits each buffer it read to the rank that
    writes it next (``_links``). ``credit`` "before_read" credits before
    the passes: a negative control. ``flags`` "slot" counts a sender's
    credits on one flag per (round of the stage, parity), whoever grants
    them: the other negative control (a later stage's receiver can
    satisfy a wait for another).

    A pass that reads a buffer records what it found there where that
    is not the value the schedule means (the pass that stored it, or
    nothing); the values are computed after the run (``_table_values``)."""
    _check_fused_credit(credit)
    if flags not in ("port", "slot"):
        raise ArgumentError(f"unknown flag layout {flags!r}")
    op = op_lookup(op)
    prog = _as_program(sched)
    _check_data(prog, data)
    W = data.shape[2]
    seg = W if seg_cols is None else seg_cols
    if seg <= 0:
        raise ArgumentError(f"bad wavefront segment {seg}")
    wave = _wavefront(prog, -(-W // seg), flags == "port")
    deviant: dict = {}  # node -> what it read, where not what it meant
    bufs: dict = {}
    sems: dict = collections.defaultdict(int)

    def rank(me):
        for waits, credits, passes in wave.plans[me]:
            if waits:
                yield waits
            if credit == "before_read" and credits:
                for c in credits:
                    sems[c] += 1
                yield _PAUSE
            for node, read, fwd, raise_, meant in passes:
                if read is not None:
                    got = bufs.get(read)
                    if got != meant:
                        deviant[node] = got
                if fwd is not None:
                    bufs[fwd] = node
                    sems[raise_] += 1
            if credit == "after_read":
                for c in credits:
                    sems[c] += 1

    _drive([rank(k) for k in range(prog.nranks)], sems, rng)
    residue = {wave.flags[k]: v for k, v in _residue(sems).items()}
    return _table_values(prog, data, op, seg, wave, deviant), residue


def _table_values(prog: _Program, data: torch.Tensor, op, seg: int,
                  wave: _Wavefront, deviant: dict) -> torch.Tensor:
    """The output of a ``simulate_table_fused`` run: where every pass
    read what the schedule means, round by round a whole chunk per rank,
    keeping only the last round's (as the kernel's buffers do);
    otherwise segment by segment, each pass from what it read
    (``deviant``, else ``wave.meant``)."""
    n, rounds, nchunks, W = (prog.nranks, prog.rounds, prog.nchunks,
                             data.shape[2])
    n_segs = wave.n_segs
    t_src, t_sch = prog.t_src.tolist(), prog.t_schunk.tolist()
    t_rch = prog.t_rchunk.tolist()
    data = data.contiguous()
    flat = data.view(n * nchunks, W)
    out = _out_like(prog, data)

    def own(me, rd):
        return me * nchunks + t_rch[rd][me] if prog.mode[rd] == 1 else None

    def target(me, c):
        return out[me] if c is None else out[me, c]

    if not deviant:
        # Every rank's value of a round in one (n, W) tensor, from the
        # last round's. A written chunk takes every segment from one
        # pass group (or from one row of x, the own chunk's copy).
        rows = out.view(-1, W)
        due = collections.defaultdict(lambda: ([], []))
        for (me, c), toks in wave.written.items():
            row = me if c is None else me * nchunks + c
            if toks[0] < 0:
                rows[row] = flat[(-1 - toks[0]) // n_segs]
            else:
                ranks, at = due[(toks[0] // n_segs) % rounds]
                ranks.append(toks[0] // n_segs // rounds)
                at.append(row)
        stage_pos = [r - b for b, length in _stages(prog)
                     for r in range(b, b + length)]
        cur = None
        for rd in range(rounds):
            src = t_src[rd]
            cur = (flat[[s * nchunks + t_sch[rd][s] for s in src]]
                   if stage_pos[rd] == 0 else cur[src])
            if prog.mode[rd] == 1:
                cur = op.combine(cur, flat[[me * nchunks + t_rch[rd][me]
                                            for me in range(n)]])
            if rd in due:
                ranks, at = due[rd]
                rows[at] = cur[ranks]
        return out

    xsegs = flat.split(seg, dim=1)
    memo: dict = {}

    def value(tok, i):
        """Segment value of a node or token read by a pass on segment
        i."""
        if tok is None:  # a buffer never written
            return torch.zeros_like(xsegs[i][0])
        if tok < 0:
            row, j = divmod(-1 - tok, n_segs)
            return xsegs[j][row]
        if tok not in memo:
            g, j = divmod(tok, n_segs)
            arrival = value(deviant.get(tok, wave.meant[tok]), j)
            o = own(*divmod(g, rounds))
            memo[tok] = (arrival if o is None
                         else op.combine(arrival, xsegs[j][o]))
        return memo[tok]

    for (me, c), toks in wave.written.items():
        target(me, c).copy_(torch.cat([value(tok, i)
                                       for i, tok in enumerate(toks)]))
    memo.clear()
    return out


def sched_table_plain(sched, data: torch.Tensor, op,
                      seg_cols: Optional[int] = None) -> torch.Tensor:
    """The table kernel's plain version: ``simulate_table_fused`` over
    segments of ``seg_cols`` columns, checked. By default the kernel's
    cluster segment, or a longer one so that a chunk makes at most
    ``pallas_ring.PLAIN_SEGS`` segments: the simulator takes a Python step per
    segment and round, and no bit depends on the segment."""
    if seg_cols is None:
        seg_cols = _plain_seg(data.shape[2], TABLE_CLUSTER_SEG_BYTES
                              // data.element_size())
    return _checked(simulate_table_fused(sched, data, op,
                                         seg_cols=seg_cols))


def _device_tables(prog: _Program, device: torch.device):
    """The packed (4, rounds, n) tables and the per-round info words on
    ``device``, uploaded once per program and card, with the chained
    rounds of the program's longest stage."""
    got = prog.device_tables.get(device)
    if got is None:
        prv, nxt = _links(prog)
        info = [m | (_LAST if l else 0) | (_BRK if b else 0)
                | (_PRV if p else 0) | ((q + 1) << _NEXT_SHIFT)
                for m, l, b, p, q in zip(prog.mode, prog.last, prog.brk,
                                         prv, nxt)]
        longest = max(length for _, length in _stages(prog))
        if longest > TABLE_MAX_STAGE:
            raise KernelError(f"sched_table: a stage of {longest} rounds "
                              f"(the kernel takes at most "
                              f"{TABLE_MAX_STAGE})")
        got = prog.device_tables[device] = (
            torch.stack([prog.t_dst, prog.t_src, prog.t_schunk,
                         prog.t_rchunk]).to(device),
            torch.tensor(info, dtype=torch.int32).to(device), longest - 1)
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
    return _table_launch(prog, data, op)


def _table_plan(n: int, chunk_bytes: int, chained: int, sm_count: int,
                cluster: Optional[bool] = None
                ) -> tuple[int, int, int, bool]:
    """(stripes, threads per block, segment bytes, cluster) of the table
    kernel for n ranks, chunks of ``chunk_bytes`` bytes and ``chained``
    chained rounds in its longest stage: clusters up to
    ``TABLE_CLUSTER_RANKS`` ranks (unless ``cluster`` says otherwise),
    each form with its segment, threads and blocks per SM; stripes of at
    least a segment, as many as that many blocks per SM allow; segments
    no longer than a stripe, and shortened until a block's
    TABLE_BUFS x ``chained`` buffers take at most ``TABLE_SMEM_BYTES`` of
    its shared memory (clusters) or all blocks' at most
    ``TABLE_SLOT_BYTES`` (L2)."""
    if cluster is None:
        cluster = n <= TABLE_CLUSTER_RANKS
    elif cluster and n > TABLE_CLUSTER_RANKS:
        raise ArgumentError(f"no cluster of {n} ranks (at most "
                            f"{TABLE_CLUSTER_RANKS})")
    seg, threads, per_sm = (
        (TABLE_CLUSTER_SEG_BYTES, TABLE_CLUSTER_THREADS,
         TABLE_CLUSTER_BLOCKS_PER_SM) if cluster
        else (TABLE_SEG_BYTES, TABLE_THREADS, TABLE_BLOCKS_PER_SM))
    stripes = _stripes(n, chunk_bytes, per_sm * sm_count, seg)
    seg = min(seg, -(-chunk_bytes // 16 // stripes) * 16)
    per_block = TABLE_BUFS * chained
    budget = TABLE_SMEM_BYTES if cluster else TABLE_SLOT_BYTES // (
        n * stripes)
    if per_block:
        seg = min(seg, max(16, budget // per_block // 16 * 16))
    return stripes, threads, seg, cluster


@functools.lru_cache(maxsize=64)
def _table_clusters(n: int, threads: int, seg_bytes: int, chained: int,
                    device: int) -> int:
    """Clusters of the table kernel's n blocks that the card holds at
    once (the cluster launch runs the rest after them)."""
    fn = build.library("sched_table").ompi_sched_table_clusters
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    got = fn(n, threads, seg_bytes // 16, chained, device)
    if got <= 0:
        raise KernelError(f"sched_table: no cluster of {n} blocks fits "
                          f"(CUDA error {-got})")
    return got


def _table_launch(prog: _Program, data: torch.Tensor, op,
                  stripes: Optional[int] = None,
                  threads: Optional[int] = None,
                  seg_bytes: Optional[int] = None,
                  cluster: Optional[bool] = None,
                  defines: tuple = ()) -> torch.Tensor:
    """Launch csrc/sched_table.cu on CUDA ``data`` (n, nchunks, chunk)
    with the plan's stripes, threads, segment and buffer memory (shared
    memory in clusters, or L2), or the ones given: the tests' and the
    measurement tools' choices; ``defines`` names a probe build. Chunks
    are padded to whole 16-byte vectors only when they are not already;
    a cluster launch takes at most as many stripes as clusters fit on
    the card at once. ``SCHED_TABLE.last_plan`` records what was
    launched."""
    n, nchunks, chunk = data.shape
    codes = _codes(op_lookup(op), data.dtype)
    cap = require_kernel_device(data)
    tables, info, chained = _device_tables(prog, data.device)
    vec = 16 // data.element_size()
    cols = -(-chunk // vec) * vec  # chunks of whole 16-byte vectors
    x = _aligned(data, cols)
    c_bytes = cols * data.element_size()
    plan = _table_plan(n, c_bytes, chained, cap.sm_count, cluster)
    threads, seg_bytes = threads or plan[1], seg_bytes or plan[2]
    cluster = plan[3]
    dev = x.device.index or 0
    if stripes is None:
        stripes = plan[0]
        if cluster:
            stripes = min(stripes, _table_clusters(n, threads, seg_bytes,
                                                   chained, dev))
    seg_v = seg_bytes // 16
    sw = -(-(c_bytes // 16) // stripes)  # vectors per stripe
    n_segs = -(-sw // seg_v)
    out = _out_like(prog, x)
    stream = _raw_stream(x)
    buffer_bytes = n * stripes * TABLE_BUFS * chained * seg_bytes
    comm = _scratch(x, stream, "comm", 0 if cluster else buffer_bytes)
    # with clusters the flags live in shared memory, and each block
    # leaves one word here: what is left on them
    sems = _scratch(x, stream, "flags", n * stripes * (
        1 if cluster else TABLE_BUFS * chained * (n + 1)))
    err = _entry("sched_table", defines)(
        x.data_ptr(), out.data_ptr(), comm.data_ptr(), sems.data_ptr(), n,
        stripes, threads, tables.data_ptr(), info.data_ptr(), prog.rounds,
        nchunks, c_bytes, seg_v, n_segs, chained, int(cluster),
        _KIND[prog.op], *codes, dev, stream)
    if err:
        raise KernelError(f"sched_table launch failed: CUDA error {err}")
    SCHED_TABLE.launched(sems, {
        "stripes": stripes, "threads": threads, "segment_bytes": seg_bytes,
        "segments": n_segs,
        "buffers": "cluster shared memory" if cluster else "L2",
        "buffer_bytes": buffer_bytes})
    return out[..., :chunk].contiguous() if cols != chunk else out


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
           "sched_table_plain", "simulate", "simulate_table",
           "simulate_table_fused"]
