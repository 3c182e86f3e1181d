"""Lowering: compile a Schedule IR program to a callable over the
rank-major tensor (port of ``ompi_tpu/coll/sched/lower.py``).

Three lowering modes, selected by ``Schedule.meta["lowering"]`` (or
the explicit ``lower(sched, strategy=...)`` override):

``interpret``
    A genuine IR executor: each round is one permutation over the rank
    axis (who sends which chunk where — the JAX package's
    ``lax.ppermute``) followed by the ``where`` of reduce, copy or idle
    on every receiving rank, with the Op's combine as
    ``combine(received, own)``. The same rounds and fold order as the
    JAX package, so the same bits.

``primitive``
    Tier-mapped: the schedule names an existing lowered entry point —
    the native collective, the rank-ordered gather-reduce, the hand
    ring kernel (``pallas_ring``) or the quantized wire (``quant_ring``,
    pinned to the schedule's wire and block; ``quant_pallas``, the
    quantized ring kernel).

``pallas``
    Compiled: the step program itself runs on the table-driven kernel
    (``sched/pallas_lower.py``, ``csrc/sched_table.cu``).

The lowered callable has the ALLREDUCE_ALGOS signature ``fn(b, op)``
(REDUCE_SCATTER_ALGOS' for reduce-scatter programs).

``validate_schedule`` is the validity checker: it holds a lowered
schedule bit-identical to a reference over power-of-two payloads
({1, 2}: exactly representable at every combine, so a different
reduction order cannot produce round-off): the spmd ring for an
allreduce, the rank-ordered fold for a reduce-scatter. The int8
quantized wire is lossy by design, so it is held to
``quant.analytic_error_bound`` of the spmd ring instead; the bf16 wire
(casts and adds, exact on these payloads) stays bit-identical.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from ...core.errors import ArgumentError
from ...ops import lookup as op_lookup
from .ir import ANNOTATIONS, Schedule

#: lowered-callable memo, keyed by (schedule digest, strategy).
_LOWERED: dict[tuple, Callable] = {}

#: The three lowering strategies, in maturity order.
STRATEGIES = ("interpret", "primitive", "pallas")


def _round_tables(sched: Schedule) -> list[tuple]:
    """Per-round constant tables: (perm, send_chunk, recv_mode,
    recv_chunk) with recv_mode 0=idle, 1=reduce, 2=copy."""
    n = sched.nranks
    by_round: dict[int, list] = {}
    for s in sched.steps:
        if s.kind in ANNOTATIONS:
            continue
        by_round.setdefault(s.round, []).append(s)
    tables = []
    for rnd in sorted(by_round):
        perm: list[tuple[int, int]] = []
        send_chunk = [0] * n
        recv_mode = [0] * n
        recv_chunk = [0] * n
        for s in by_round[rnd]:
            if s.kind == "send":
                perm.append((s.rank, s.peer))
                send_chunk[s.rank] = s.chunk
            else:
                recv_mode[s.rank] = 1 if s.kind == "reduce" else 2
                recv_chunk[s.rank] = s.chunk
        tables.append((tuple(perm), send_chunk, recv_mode, recv_chunk))
    return tables


def _lower_interpret(sched: Schedule) -> Callable:
    """Compile the step program into a round loop over the rank axis.
    A round touches only the ranks its permutation reaches: the others
    receive nothing and keep their state (``recv_mode`` 0), as every
    rank not in a ``lax.ppermute`` pair does in the JAX package."""
    tables = _round_tables(sched)
    nranks, nchunks = sched.nranks, sched.nchunks

    def run(b: torch.Tensor, op) -> torch.Tensor:
        from .. import spmd

        op = op_lookup(op)
        n = b.shape[0]
        if n != nranks:
            raise ArgumentError(
                f"schedule {sched.name!r} compiled for {nranks} ranks, "
                f"got {n}")
        flat, total = spmd._flatten_pad(b, nchunks)
        state = flat.reshape(n, nchunks, -1).clone()
        for perm, send_chunk, recv_mode, recv_chunk in tables:
            if not perm:
                continue
            src = [s for s, _ in perm]
            dst = [d for _, d in perm]
            recvd = state[src, [send_chunk[s] for s in src]]
            rows = [recv_chunk[d] for d in dst]
            cur = state[dst, rows]
            mode = torch.tensor([recv_mode[d] for d in dst],
                                device=b.device)
            mode = mode.view((-1,) + (1,) * (cur.ndim - 1))
            state[dst, rows] = torch.where(
                mode == 1, op.combine(recvd, cur),
                torch.where(mode == 2, recvd, cur))
        return spmd._unflatten(state, total, b)

    return run


def _lower_primitive(sched: Schedule) -> Callable:
    """Map the schedule to an already-lowered tier entry point."""
    prim = sched.meta.get("primitive", "")
    if prim == "native":
        from .. import spmd

        return spmd.allreduce_native
    if prim == "gather_reduce":
        from .. import spmd

        return spmd._allreduce_gather_reduce
    if prim == "quant_ring":
        from .. import quant

        wire = sched.meta.get("wire")
        block = sched.meta.get("block")

        def _quant_ring(b, op):
            # the schedule pins the wire/block it was generated (and
            # validated/tuned) for; cvars only fill the gaps
            return quant.allreduce_quant_ring(b, op, wire=wire, block=block)

        return _quant_ring
    if prim == "quant_pallas":
        from .. import quant

        return quant.allreduce_block_quant
    if prim == "pallas_ring":
        from .. import pallas_ring

        return pallas_ring.allreduce_block
    raise ArgumentError(
        f"schedule {sched.name!r} names unknown primitive {prim!r}"
    )


def lower(sched: Schedule, strategy: Optional[str] = None) -> Callable:
    """Schedule -> callable with the registered-algo signature
    (ALLREDUCE_ALGOS for allreduce programs, REDUCE_SCATTER_ALGOS for
    reduce-scatter ones). ``strategy`` overrides the schedule's own
    ``meta["lowering"]`` directive. Memoized on (digest, strategy);
    counts every selection in the per-strategy SPC counters
    (``sched_lower_strategy_<strategy>``)."""
    if strategy is None:
        strategy = sched.meta.get("lowering", "interpret")
        if strategy not in STRATEGIES:
            strategy = "interpret"
    elif strategy not in STRATEGIES:
        raise ArgumentError(
            f"unknown lowering strategy {strategy!r}; known: "
            f"{list(STRATEGIES)}")
    from ...core.counters import SPC

    SPC.record(f"sched_lower_strategy_{strategy}")
    key = (sched.digest(), strategy)
    fn = _LOWERED.get(key)
    if fn is not None:
        return fn
    if strategy == "primitive":
        fn = _lower_primitive(sched)
    elif strategy == "pallas":
        from . import pallas_lower

        fn = pallas_lower.compile_schedule(sched)
    else:
        fn = _lower_interpret(sched)
    _LOWERED[key] = fn
    from ...trace import span as tspan

    tspan.instant("sched.compile", cat="sched", schedule=sched.name,
                  nranks=sched.nranks, rounds=sched.rounds(),
                  lowering=strategy, digest=key[0])
    return fn


def clear_lowered() -> None:
    """Forget memoized lowerings (tests / re-init)."""
    _LOWERED.clear()
    from . import pallas_lower

    pallas_lower.clear_compiled()


# ---------------------------------------------------------------------------
# validity checker
# ---------------------------------------------------------------------------

def _payload(shape: tuple, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """Power-of-two payload ({1, 2}), exactly representable in every
    supported dtype under every reduction order and every op: sums over
    8 ranks top out at 16, products at 256 = 2^8."""
    gen = torch.Generator().manual_seed(0xC011)
    data = torch.pow(2, torch.randint(0, 2, shape, generator=gen))
    return data.to(dtype).to(device)


def _validate_bounded(fn: Callable, x: torch.Tensor, op, *, wire,
                      block) -> bool:
    """Lossy-tier validity: the result within coll/quant's analytic
    worst-case error bound of the spmd ring, elementwise."""
    from .. import quant, spmd

    ref = spmd.allreduce_ring(x, op).to(torch.float64)
    got = fn(x, op)
    bound = quant.analytic_error_bound(x, wire=wire, block=block)
    return ref.shape == got.shape and bool(torch.all(
        (ref - got.to(torch.float64)).abs()
        <= bound.to(torch.float64)[None, :] + 1e-12))


def validate_schedule(comm, sched: Schedule, op, dtype, *,
                      nelems: int = 192) -> bool:
    """Validity of a lowered Schedule on ``comm`` over the power-of-two
    payload. Exact tiers are held bit-identical to a reference: the spmd
    ring for an allreduce program, the rank-ordered fold of every rank's
    contributions for a reduce-scatter one (rank k's result is chunk k).
    The bf16 quantized wire is held to the same bar (its hops are casts
    and adds, exact on these payloads); the int8 wire is lossy by design
    and is held to ``quant.analytic_error_bound`` of the spmd ring."""
    from .. import spmd

    op = op_lookup(op)
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    n = comm.size
    if sched.nranks != n:
        raise ArgumentError(
            f"schedule {sched.name!r} compiled for {sched.nranks} ranks, "
            f"comm has {n}")
    fn = lower(sched)
    quantized = sched.meta.get("primitive", "").startswith("quant") \
        or any(s.kind in ANNOTATIONS for s in sched.steps)
    if quantized and sched.meta.get("wire", "int8") != "bf16":
        return _validate_bounded(
            fn, _payload((n, nelems), dtype, comm.device), op,
            wire=sched.meta.get("wire", "int8"),
            block=sched.meta.get("block"))
    if sched.op == "reduce_scatter":
        x = _payload((n, n, nelems), dtype, comm.device)
        ref = functools.reduce(op.combine, [x[k] for k in range(n)])
    else:
        x = _payload((n, nelems), dtype, comm.device)
        ref = spmd.allreduce_ring(x, op)
    got = fn(x, op)
    return got.dtype == ref.dtype and got.shape == ref.shape \
        and torch.equal(got, ref)


__all__ = ["STRATEGIES", "clear_lowered", "lower", "validate_schedule"]
