"""The schedule lattice: one declarative map from algorithm to
(transport tier, next-cheaper fallback). A copy of
``ompi_tpu/coll/sched/lattice.py``; the port has no breaker yet, so
only the autotuner reads the tiers here (``tier_of``).

Before this module the degradation knowledge lived twice — breaker.py
carried a hand-wired NEXT_TIER dict and health/ledger.py a parallel
_ALGO_TIER map — and every new tier had to be threaded through both.
Now the lattice is the single source of truth: ``breaker.NEXT_TIER``
and ``health.tier_of_algo`` derive from it, and routing around broken
or quarantined tiers is a *deny-set walk over this lattice*
(``route``): start at the chosen algorithm, follow fallback edges past
every denied node, land on the first allowed one. Terminal is
``gather_reduce`` — the ordered pure-XLA + host tier every input
shape/pytree accepts, riding the never-quarantined "host" plane.

Pure data + walks: this module imports nothing from coll/health so it
is safe to import from either side of that boundary.
"""

from __future__ import annotations

from typing import Iterable, Optional

TERMINAL = "gather_reduce"

#: algorithm -> (transport tier, next-cheaper fallback). Tier names are
#: health/ledger's TIERS lattice; a fallback of None ends the chain.
#: Quant tiers fall back to the plain-precision chain (bit-identical
#: across ranks regardless of breaker state); sched_* interpreted
#: schedules fall back within the lattice before leaving it. The
#: sched_pallas_* compiled kernels sit on the distinct "device_pallas"
#: tier and degrade to their interpreted/hand-written equivalent, so a
#: Mosaic-kernel fault quarantines the compiled tier without touching
#: the plain device plane.
LATTICE: dict[str, tuple[str, Optional[str]]] = {
    "sched_pallas_ring": ("device_pallas", "sched_ring"),
    "sched_pallas_ring_seg": ("device_pallas", "sched_ring_seg"),
    "sched_pallas_rs": ("device_pallas", "ring"),
    "quant_pallas": ("device", "quant_ring"),
    "quant_ring": ("device", "ring"),
    "sched_quant": ("device", "sched_ring"),
    "pallas_ring": ("device", "ring"),
    "pallas_bidir": ("device", "ring"),
    "pallas_rd": ("device", "ring"),
    "pallas_ring_chunked": ("device", "ring"),
    "pallas_rsag": ("device", "ring"),
    "sched_hier": ("device", "sched_ring"),
    "sched_rd": ("device", "sched_ring"),
    "sched_ring_seg": ("device", "sched_ring"),
    "sched_ring": ("device", "ring"),
    "ring_segmented": ("device", "ring"),
    "recursive_doubling": ("device", "ring"),
    "ring": ("device", TERMINAL),
    "native": ("device", TERMINAL),
    TERMINAL: ("host", None),
}

#: Default placement for algorithms not named above (rabenseifner,
#: nonoverlapping, bcast trees, ...): they launch XLA programs over the
#: fabric and degrade straight to the terminal.
_DEFAULT = ("device", TERMINAL)


def tier_of(algo: str) -> str:
    """The transport tier an algorithm executes on."""
    return LATTICE.get(algo, _DEFAULT)[0]


def fallback(algo: str) -> Optional[str]:
    """The next-cheaper algorithm, or None at the end of the chain."""
    if algo == TERMINAL:
        return None
    return LATTICE.get(algo, _DEFAULT)[1]


def fallback_map() -> dict[str, str]:
    """The lattice's fallback edges as a plain dict (breaker.NEXT_TIER
    compatibility view)."""
    return {a: nxt for a, (_t, nxt) in LATTICE.items() if nxt is not None}


def chain(algo: str) -> list[str]:
    """The full degradation chain starting at ``algo`` (inclusive)."""
    out = [algo]
    seen = {algo}
    cur = algo
    while True:
        nxt = fallback(cur)
        if nxt is None or nxt in seen:
            return out
        out.append(nxt)
        seen.add(nxt)
        cur = nxt


def route(algo: str, denied: Iterable[str] = ()) -> str:
    """Deny-set walk: the first algorithm on ``algo``'s chain whose
    name is not denied. The terminal is returned even when denied —
    there must always be a routable tier."""
    denied = set(denied)
    last = algo
    for cand in chain(algo):
        last = cand
        if cand not in denied:
            return cand
    return last


__all__ = [
    "LATTICE", "TERMINAL", "chain", "fallback", "fallback_map", "route",
    "tier_of",
]
