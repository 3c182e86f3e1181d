"""coll/sched: the schedule compiler (port of ``ompi_tpu/coll/sched``).

Collective algorithm choice as a compiler pipeline instead of an
if-ladder:

- ``ir``        declarative chunk/step programs (Schedule) + generators
                (ring, recursive doubling, segmented ring, hierarchical,
                quantized wire) parameterized by topology
- ``lower``     Schedule -> callable over the rank-major tensor, plus
                the validity checker
- ``pallas_lower`` the table-driven kernel (``csrc/sched_table.cu``)
                behind the ``sched_pallas_*`` names
- ``lattice``   the algorithm/tier/fallback lattice
- ``priors``    the static cold-start decision tables
- ``cache``     versioned on-disk winner cache
- ``autotune``  the candidate sweep that fills the cache

``lookup`` is the dispatch-path entry: tuned's decide_* consult it
after the correctness guards and fall back to the priors only on a
cache miss. Not ported yet: ``stepprogram`` and ``slipstream`` (the
training-step programs, ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

from typing import Optional

from ...core.counters import SPC
from ...trace import span as tspan
from .. import tuned
from . import autotune, cache as _cache, ir, lattice
from .ir import Schedule, ScheduleError

#: (algo, nranks, ...) -> built Schedule.
_SCHED_MEMO: dict = {}

#: Algorithms this package registers into tuned.ALLREDUCE_ALGOS. The
#: sched_pallas_* names are the same IR programs lowered to the table
#: kernel — the device_pallas tier; ``sched_quant`` is the quantized
#: wire's program, lowered to ``coll/quant``'s ring.
ALGOS = ("sched_ring", "sched_rd", "sched_ring_seg", "sched_hier",
         "sched_quant", "sched_pallas_ring", "sched_pallas_ring_seg")


# ---------------------------------------------------------------------------
# topology-aware schedule construction
# ---------------------------------------------------------------------------

def _topo_order(nranks: int) -> Optional[list]:
    """The live world's ring order when it matches ``nranks`` (None
    otherwise — e.g. sub-communicators). On one card it is the
    identity: every rank shares one HBM."""
    from ...runtime import mesh

    procs = mesh.live_procs()
    if len(procs) == nranks:
        return mesh.ring_order(procs)
    return None


def _host_groups(nranks: int) -> list:
    """Host-grouped rank partition for the hierarchical schedule; one
    group when the live world doesn't match ``nranks`` (and on one
    card, where every rank is on one host)."""
    from ...runtime import mesh

    procs = mesh.live_procs()
    if len(procs) == nranks:
        groups = [sorted(p.rank for p in g)
                  for _h, g in sorted(mesh.hosts_of(procs).items())]
        if sum(len(g) for g in groups) == nranks:
            return groups
    return [list(range(nranks))]


def build_schedule(algo: str, nranks: int, *, segments: int = 2,
                   groups=None) -> Schedule:
    """Build (memoized) the Schedule behind a registered sched_* name,
    enriched with live topology (ring order, host groups) when the
    world matches. The JAX package also reshapes these schedules from
    straggler penalties (its ``retune``), which wait for the control
    planes (ROADMAP Queue 1 item 9); without penalties its schedules
    are these."""
    key = (algo, nranks, segments,
           tuple(map(tuple, groups)) if groups else None)
    if algo == "sched_quant":
        from .. import quant

        # the wire codec is part of the program; a cvar flip must
        # rebuild, not hit the memo
        key = key + (quant._wire_var.value, quant._block_var.value)
    sch = _SCHED_MEMO.get(key)
    if sch is not None:
        return sch
    if algo == "sched_ring":
        sch = ir.ring(nranks, order=_topo_order(nranks))
    elif algo == "sched_rd":
        if nranks & (nranks - 1):
            # degrade like tuned's pallas_rd guard: rd on a
            # non-power-of-two world gets the ring
            sch = ir.ring(nranks, order=_topo_order(nranks))
        else:
            sch = ir.recursive_doubling(nranks)
    elif algo == "sched_ring_seg":
        sch = ir.segmented_ring(nranks, segments,
                                order=_topo_order(nranks))
    elif algo == "sched_hier":
        sch = ir.hierarchical(groups or _host_groups(nranks))
    elif algo == "sched_quant":
        from .. import quant

        sch = ir.quantized_wire(nranks, quant._wire_var.value,
                                quant._block_var.value,
                                order=_topo_order(nranks))
    elif algo == "sched_pallas_ring":
        sch = ir.with_lowering(
            ir.ring(nranks, order=_topo_order(nranks)), "pallas",
            tier="device_pallas")
    elif algo == "sched_pallas_ring_seg":
        sch = ir.with_lowering(
            ir.segmented_ring(nranks, segments,
                              order=_topo_order(nranks)), "pallas",
            tier="device_pallas")
    elif algo == "sched_pallas_rs":
        sch = ir.with_lowering(
            ir.reduce_scatter(nranks, order=_topo_order(nranks)),
            "pallas", tier="device_pallas")
    else:
        raise ScheduleError(f"unknown sched algorithm {algo!r}; "
                            f"known: {list(ALGOS)}")
    _SCHED_MEMO[key] = sch
    return sch


def clear_schedules() -> None:
    """Forget built schedules and lowerings (tests / re-init)."""
    from . import lower as _lower

    _SCHED_MEMO.clear()
    _lower.clear_lowered()


# ---------------------------------------------------------------------------
# registered algorithm wrappers (ALLREDUCE_ALGOS signature)
# ---------------------------------------------------------------------------

def _run(algo: str, b, op):
    from . import lower as _lower

    if b.shape[0] == 1:
        # One rank: every program is the identity (the lowered wrappers
        # return their input there; a one-rank ring has no rounds).
        return b[:, 0] if algo == "sched_pallas_rs" else b
    sch = build_schedule(algo, b.shape[0])
    return _lower.lower(sch)(b, op)


def allreduce_sched_ring(b, op):
    return _run("sched_ring", b, op)


def allreduce_sched_rd(b, op):
    return _run("sched_rd", b, op)


def allreduce_sched_ring_seg(b, op):
    return _run("sched_ring_seg", b, op)


def allreduce_sched_hier(b, op):
    return _run("sched_hier", b, op)


def allreduce_sched_quant(b, op):
    return _run("sched_quant", b, op)


def allreduce_sched_pallas_ring(b, op):
    return _run("sched_pallas_ring", b, op)


def allreduce_sched_pallas_ring_seg(b, op):
    return _run("sched_pallas_ring_seg", b, op)


def reduce_scatter_sched_pallas(b, op):
    """REDUCE_SCATTER_ALGOS signature: (n, n, ...) contributions ->
    (n, ...), rank r's own reduced block."""
    return _run("sched_pallas_rs", b, op)


# ---------------------------------------------------------------------------
# dispatch-path cache consult
# ---------------------------------------------------------------------------

def _usable(opname: str, algo: str, dtype, op) -> bool:
    """Is a cached winner selectable right now? Guards the cases where
    the cache was tuned under settings the current call doesn't meet
    (quant consent/support, unknown algorithm after a version skew).
    Membership tests only: this runs on every cache hit."""
    if (algo not in ALGOS and algo not in tuned._SPACES.get(opname, ())
            and algo not in tuned._LAZY_ALGOS.get(opname, ())):
        return False
    if tuned.is_quant_algo(algo) or algo == "sched_quant":
        from .. import quant

        if not quant._enable_var.value:
            return False
        if not quant.supports(op or "sum", dtype):
            return False
    return True


def lookup(opname: str, nbytes_per_rank: int, nranks: int, dtype=None,
           op=None) -> Optional[str]:
    """The compiled-schedule cache consult. Returns the tuned winner's
    algorithm name, or None (miss / disabled / unusable winner) — the
    caller then falls back to the static priors. Counts
    ``sched_cache_hits``/``sched_cache_misses`` in SPC; misses only
    once the cache is active, so an untuned process is not drowned in
    miss counts. The JAX package's SLO re-ranking (its ``slo``) needs
    the live baselines its watchtower stamps, so it waits with the
    control planes (ROADMAP Queue 1 item 9)."""
    if not _cache._enable_var.value:
        return None
    fp = autotune.fingerprint()
    _cache.CACHE.ensure_loaded(fp, nranks)
    if not _cache.CACHE.active():
        return None
    key = _cache.cache_key(opname, nbytes_per_rank, nranks, dtype, fp)
    ent = _cache.CACHE.get(key)
    if ent is None:
        SPC.record("sched_cache_misses")
        tspan.instant("sched.cache_miss", cat="sched", key=key)
        return None
    algo = ent.get("algorithm", "")
    if not _usable(opname, algo, dtype, op):
        SPC.record("sched_cache_misses")
        tspan.instant("sched.cache_miss", cat="sched", key=key,
                      algo=algo, reason="unusable")
        return None
    SPC.record("sched_cache_hits")
    tspan.instant("sched.cache_hit", cat="sched", key=key, algo=algo)
    return algo


def warm(nranks: int, **kw) -> dict:
    """Offline cache warm: run the autotuner (model mode by default —
    no devices needed) and persist winners to the default path."""
    return autotune.tune(nranks, **kw)


__all__ = [
    "ALGOS", "Schedule", "ScheduleError", "allreduce_sched_hier",
    "allreduce_sched_pallas_ring", "allreduce_sched_pallas_ring_seg",
    "allreduce_sched_quant", "allreduce_sched_rd",
    "allreduce_sched_ring", "allreduce_sched_ring_seg",
    "build_schedule", "clear_schedules", "ir", "lattice", "lookup",
    "reduce_scatter_sched_pallas", "warm",
]
