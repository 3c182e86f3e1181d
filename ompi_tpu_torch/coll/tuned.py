"""coll/tuned — the decision layer (port of ``ompi_tpu/coll/tuned.py``
for allreduce, alltoall, bcast, reduce, allgather, reduce_scatter_block,
gather, scatter, scan and exscan; the ragged variants and the barrier
are XlaColl's, inherited).

Precedence, as in the JAX package: forced var
(``coll_tuned_<op>_algorithm``) > the user's rules file
(``coll_tuned_rules_file``, :class:`Rules`) > correctness guard
(non-commutative or joint op → the rank-ordered path) > the schedule
compiler's winner cache (``sched.lookup``) > static priors
(``sched/priors.prior_*``, where the quantized-wire gate comes first
for allreduce). Before that pipeline, ``TunedColl.allreduce`` takes the
host tier and the dispatch memo, as in the JAX package: a whole
rank-major buffer of at most ``coll_tuned_host_small_max_bytes`` is
reduced on the host with numpy's ``ufunc.reduce`` over the rank axis
(bfloat16 folded in rank order), and the plan chosen for a (shape,
dtype, op) is kept on the communicator until the config or the winner
cache changes. The circuit breaker and the health/fault seams are not
ported yet: a fault in the chosen tier propagates to the caller instead
of degrading to the next tier. Every
name the priors return is ported, with ``coll_tuned_prefer_native``
on or off, and every spmd algorithm name of the JAX package's bcast,
reduce, allgather and reduce_scatter tables, so a rules file naming
one is obeyed, as there.

Tiers registered lazily, as in the JAX package: the hand kernels
(``pallas_*``), the schedule compiler (``sched_*``, whose
``sched_pallas_*`` names run the table kernel) and the quantized wire
(``quant_ring``, the XLA ring over the wire; ``quant_pallas``, the
quantized ring kernel).
A forced name runs its algorithm even on a one-rank communicator (every
algorithm is the identity there; the JAX package returns the input
before dispatch), which is how the one-rank chunked kernel is reached
through the API.

As in the JAX package there is no hand-kernel alltoall name: the
alltoall kernel is reached through ``PallasColl``. A gather algorithm
returns root's rows and a scatter algorithm takes root's buffer (see
``spmd``).
"""

from __future__ import annotations

import json
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from ..core import config
from ..core.counters import SPC
from ..core.errors import ArgumentError
from ..core.logging import get_logger
from ..ops import Op, lookup as op_lookup
from . import spmd
from .framework import COLL, compile_plan, rank_major_check
from .xla import XlaColl, _dtype_key, _leaf_check, scatter_buffer

logger = get_logger("coll.tuned")

_V = partial(config.register, "coll", "tuned")
_large = _V("bcast_large_cutoff", type=int, default=1 << 20,
            description="Bytes above which rooted ops take the "
                        "segmented pipeline tier (reference: 1MiB "
                        "segments, coll_tuned_decision_fixed.c:250-310)")
_small = _V("allreduce_small_cutoff", type=int, default=10_000,
            description="Allreduce: bytes/rank below which recursive "
                        "doubling is used (reference: 10000B)")
_ring_limit = _V("allreduce_ring_limit", type=int, default=1 << 20,
                 description="Allreduce: max bytes/rank for plain ring "
                             "before switching to segmented ring")
_seg_bytes = _V("segment_bytes", type=int, default=1 << 20,
                description="Segment size for segmented algorithms "
                            "(reference: 1MiB)")
_prefer_native = _V("prefer_native", type=bool, default=True,
                    description="Use the native collective when the op "
                                "supports it")
_rules_file = _V("rules_file", type=str, default="",
                 description="JSON dynamic-rules file (reference: "
                             "coll_tuned_dynamic_file.c)")
_force_allreduce = _V("allreduce_algorithm", type=str, default="",
                      description="Force an allreduce algorithm by name")
_force_allgather = _V("allgather_algorithm", type=str, default="",
                      description="Force an allgather algorithm by name")
_force_bcast = _V("bcast_algorithm", type=str, default="",
                  description="Force a bcast algorithm by name")
_force_reduce = _V("reduce_algorithm", type=str, default="",
                   description="Force a reduce algorithm by name")
_force_scan = _V("scan_algorithm", type=str, default="",
                 description="Force the scan algorithm")
_force_exscan = _V("exscan_algorithm", type=str, default="",
                   description="Force the exscan algorithm")
_force_reduce_scatter = _V("reduce_scatter_algorithm", type=str, default="",
                           description="Force a reduce_scatter algorithm "
                                       "by name")
_force_alltoall = _V("alltoall_algorithm", type=str, default="",
                     description="Force an alltoall algorithm by name")
_force_gather = _V("gather_algorithm", type=str, default="",
                   description="Force a gather algorithm by name")
_force_scatter = _V("scatter_algorithm", type=str, default="",
                    description="Force a scatter algorithm by name")
_gather_binomial_max = _V("gather_binomial_max_bytes", type=int,
                          default=6 << 10,
                          description="Gather: per-rank bytes below which "
                                      "the binomial tree is used")
_alltoall_small = _V("alltoall_small_msg", type=int, default=256,
                     description="Alltoall: bytes/dest below which bruck "
                                 "is used")
_alltoall_large = _V("alltoall_large_msg", type=int, default=32 << 10,
                     description="Alltoall: bytes/dest above which "
                                 "pairwise exchange is used")
_fast_cache_var = _V("fast_dispatch_cache", type=bool, default=True,
                     description="Memoize the routed allreduce dispatch "
                                 "per (comm, shape, dtype, op): repeat "
                                 "calls skip the decision pipeline "
                                 "entirely. Invalidated by any config "
                                 "mutation or winner-cache change")
_host_small_max = _V("host_small_max_bytes", type=int, default=4096,
                     description="Allreduces of a whole rank-major buffer "
                                 "at or below this many bytes reduce on "
                                 "the HOST (numpy over the rank axis, then "
                                 "one copy back to the card) instead of "
                                 "launching device work: dispatch latency "
                                 "beats device compute at this size. 0 "
                                 "disables. Skipped under forced "
                                 "algorithms or a rules file")

ALLREDUCE_ALGOS: dict[str, Callable] = {
    "native": spmd.allreduce_native,
    "recursive_doubling": spmd.allreduce_recursive_doubling,
    "ring": spmd.allreduce_ring,
    "ring_segmented": spmd.allreduce_ring_segmented,
    "rabenseifner": spmd.allreduce_reduce_scatter_allgather,
    "nonoverlapping": spmd.allreduce_nonoverlapping,
    "gather_reduce": spmd._allreduce_gather_reduce,
}
ALLGATHER_ALGOS: dict[str, Callable] = {
    "native": spmd.allgather_native,
    "ring": spmd.allgather_ring,
    "bruck": spmd.allgather_bruck,
}
BCAST_ALGOS: dict[str, Callable] = {
    "native": spmd.bcast_native,
    "binomial": spmd.bcast_binomial,
    "chain": spmd.bcast_chain,
    "binary": spmd.bcast_binary,
    "pipelined": spmd.bcast_pipelined,
}
REDUCE_ALGOS: dict[str, Callable] = {
    "native": spmd.reduce_native,
    "binomial": spmd.reduce_binomial,
    "pipelined": spmd.reduce_pipelined,
}
SCAN_ALGOS: dict[str, Callable] = {
    "native": spmd.scan_native,
    "recursive_doubling": spmd.scan_recursive_doubling,
    "linear_chain": spmd.scan_linear_chain,
}
EXSCAN_ALGOS: dict[str, Callable] = {
    "native": spmd.exscan_native,
    "recursive_doubling": spmd.exscan_recursive_doubling,
    "linear_chain": spmd.exscan_linear_chain,
}
REDUCE_SCATTER_ALGOS: dict[str, Callable] = {
    "native": spmd.reduce_scatter_native,
    "ring": spmd.reduce_scatter_ring,
    "recursive_halving": spmd.reduce_scatter_recursive_halving,
}
ALLTOALL_ALGOS: dict[str, Callable] = {
    "native": spmd.alltoall_native,
    "pairwise": spmd.alltoall_pairwise,
    "bruck": spmd.alltoall_bruck,
}
GATHER_ALGOS: dict[str, Callable] = {
    "native": spmd.gather_native,
    "binomial": spmd.gather_binomial,
}
SCATTER_ALGOS: dict[str, Callable] = {
    "native": spmd.scatter_native,
    "binomial": spmd.scatter_binomial,
}


def _pallas_algos() -> None:
    """Register the hand-kernel tier's names (lazily, as the JAX package
    does)."""
    if "pallas_ring" in ALLREDUCE_ALGOS:
        return
    from . import pallas_ring as pr

    def _pallas_rd_guarded(b, op):
        # recursive doubling needs a power-of-two ring; on other sizes
        # the name degrades to the plain ring instead of failing
        n = b.shape[0]
        if n & (n - 1):
            return pr.allreduce_block(b, op)
        return pr.allreduce_block_rd(b, op)

    ALLREDUCE_ALGOS["pallas_ring"] = pr.allreduce_block
    ALLREDUCE_ALGOS["pallas_bidir"] = pr.allreduce_block_bidir
    ALLREDUCE_ALGOS["pallas_rd"] = _pallas_rd_guarded
    ALLREDUCE_ALGOS["pallas_ring_chunked"] = pr.allreduce_block_chunked
    ALLREDUCE_ALGOS["pallas_rsag"] = pr.allreduce_block_rsag
    BCAST_ALGOS["pallas_binomial"] = pr.bcast_block
    ALLGATHER_ALGOS["pallas_ring"] = pr.allgather_block
    REDUCE_ALGOS["pallas_tree"] = pr.reduce_block
    REDUCE_SCATTER_ALGOS["pallas_ring"] = pr.reduce_scatter_block
    GATHER_ALGOS["pallas_linear"] = pr.gather_block
    SCATTER_ALGOS["pallas_linear"] = pr.scatter_block


def _quant_algos() -> None:
    """Register the quantized-wire names (lazily, like _pallas_algos:
    the names are selectable from rules files and forced vars before
    the module is imported)."""
    if "quant_ring" in ALLREDUCE_ALGOS:
        return
    from . import quant

    ALLREDUCE_ALGOS["quant_ring"] = quant.allreduce_quant_ring
    ALLREDUCE_ALGOS["quant_pallas"] = quant.allreduce_block_quant


def _sched_algos() -> None:
    """Register the schedule-compiler tier (coll/sched): IR programs
    lowered to callables over the rank-major tensor, the
    ``sched_pallas_*`` ones to the table kernel."""
    if "sched_ring" in ALLREDUCE_ALGOS:
        return
    from . import sched

    ALLREDUCE_ALGOS["sched_ring"] = sched.allreduce_sched_ring
    ALLREDUCE_ALGOS["sched_rd"] = sched.allreduce_sched_rd
    ALLREDUCE_ALGOS["sched_ring_seg"] = sched.allreduce_sched_ring_seg
    ALLREDUCE_ALGOS["sched_hier"] = sched.allreduce_sched_hier
    ALLREDUCE_ALGOS["sched_quant"] = sched.allreduce_sched_quant
    ALLREDUCE_ALGOS["sched_pallas_ring"] = sched.allreduce_sched_pallas_ring
    ALLREDUCE_ALGOS["sched_pallas_ring_seg"] = \
        sched.allreduce_sched_pallas_ring_seg
    REDUCE_SCATTER_ALGOS["sched_pallas_rs"] = sched.reduce_scatter_sched_pallas


def is_pallas_algo(name: str) -> bool:
    """The hand-kernel names, the table kernel's (``sched_pallas_*``)
    and the quantized wire's kernel."""
    return name.startswith(("pallas", "sched_pallas")) \
        or name == "quant_pallas"


def is_quant_algo(name: str) -> bool:
    return name.startswith("quant")


def is_sched_algo(name: str) -> bool:
    """Schedule-compiler tier names (lowered IR programs)."""
    return name.startswith("sched_")


def _ensure_lazy(algo: str) -> None:
    """Trigger whichever lazy tier registration ``algo`` needs."""
    if is_pallas_algo(algo):
        _pallas_algos()
    if is_quant_algo(algo):
        _quant_algos()
    if is_sched_algo(algo):
        _sched_algos()


_SPACES = {
    "allreduce": ALLREDUCE_ALGOS,
    "alltoall": ALLTOALL_ALGOS,
    "allgather": ALLGATHER_ALGOS,
    "bcast": BCAST_ALGOS,
    "reduce": REDUCE_ALGOS,
    "scan": SCAN_ALGOS,
    "exscan": EXSCAN_ALGOS,
    "reduce_scatter": REDUCE_SCATTER_ALGOS,
    "gather": GATHER_ALGOS,
    "scatter": SCATTER_ALGOS,
}

#: Algorithm names that exist but are registered lazily.
_LAZY_ALGOS: dict[str, frozenset] = {
    "allreduce": frozenset({
        "pallas_ring", "pallas_bidir", "pallas_rd", "pallas_ring_chunked",
        "pallas_rsag", "quant_ring", "quant_pallas",
        "sched_ring", "sched_rd", "sched_ring_seg", "sched_hier",
        "sched_quant", "sched_pallas_ring", "sched_pallas_ring_seg",
    }),
    "bcast": frozenset({"pallas_binomial"}),
    "allgather": frozenset({"pallas_ring"}),
    "reduce": frozenset({"pallas_tree"}),
    "reduce_scatter": frozenset({"pallas_ring", "sched_pallas_rs"}),
    "gather": frozenset({"pallas_linear"}),
    "scatter": frozenset({"pallas_linear"}),
}


def _resolve_algo(opname: str, algo: str) -> Optional[Callable]:
    """The callable behind an algorithm name (None if unknown),
    triggering lazy tier registrations on demand — how the autotuner
    resolves candidates by name."""
    _ensure_lazy(algo)
    space = _SPACES.get(opname)
    return None if space is None else space.get(algo)


def _algo_space(opname: str) -> set:
    """Every selectable algorithm name for ``opname``, including the
    lazily registered tiers (without importing them)."""
    space = _SPACES.get(opname)
    if space is None:
        return set()
    return set(space) | set(_LAZY_ALGOS.get(opname, ()))


def _algo(algos: dict, opname: str, name: str) -> Callable:
    """The algorithm registered under ``name`` for ``opname``."""
    _ensure_lazy(name)
    fn = algos.get(name)
    if fn is None:
        raise ArgumentError(
            f"unknown {opname} algorithm {name!r}; known: {sorted(algos)}")
    return fn


#: Operation names a rules file may key (the JAX package's).
_KNOWN_OPNAMES = frozenset({
    "allreduce", "alltoall", "allgather", "bcast", "reduce", "scan",
    "exscan", "reduce_scatter", "gather", "scatter",
})

class Rules:
    """Dynamic decision rules loaded from a JSON file:
    {"allreduce": [{"max_bytes": N, "min_ranks": M, "algorithm": "ring"},
     ...], ...} — first matching entry wins.

    Band keys: min_bytes/max_bytes/min_ranks/max_ranks, plus the
    precision dimension: ``"dtype": "float32"`` restricts a rule to one
    payload dtype, and ``"allow_quant": false`` vetoes the automatic
    quantized-wire tier inside the rule's band (a rule carrying only
    the veto needs no "algorithm").

    Unknown opname keys and unknown algorithm names are not silent: each
    is logged once, counted on the ``coll_tuned_rules_unknown`` pvar,
    and the rule is skipped, so a bogus rules file can never select a
    nonexistent algorithm."""

    def __init__(self, path: str) -> None:
        with open(path, "r", encoding="utf-8") as f:
            self._rules = json.load(f)
        self._warned: set = set()
        for opname in self._rules:
            if opname not in _KNOWN_OPNAMES:
                self._warn_once(
                    ("opname", opname),
                    "rules file names unknown operation %r "
                    "(known: %s)", opname, sorted(_KNOWN_OPNAMES),
                )

    def _warn_once(self, key: tuple, msg: str, *args) -> None:
        if key in self._warned:
            return
        self._warned.add(key)
        SPC.record("coll_tuned_rules_unknown")
        logger.warning(msg, *args)

    @staticmethod
    def _matches(rule: dict, nbytes: int, nranks: int, dtype) -> bool:
        if nbytes > rule.get("max_bytes", float("inf")):
            return False
        if nbytes < rule.get("min_bytes", 0):
            return False
        if nranks < rule.get("min_ranks", 0):
            return False
        if nranks > rule.get("max_ranks", float("inf")):
            return False
        want = rule.get("dtype")
        if want is not None and (dtype is None or _dtype_name(dtype) != want):
            return False
        return True

    def decide(self, opname: str, nbytes: int, nranks: int,
               dtype=None) -> Optional[str]:
        known = _algo_space(opname)
        for rule in self._rules.get(opname, ()):
            if not self._matches(rule, nbytes, nranks, dtype):
                continue
            algo = rule.get("algorithm")
            if algo is None:
                continue  # veto-only rule (allow_quant band)
            if algo not in known:
                self._warn_once(
                    ("algo", opname, algo),
                    "rules file names unknown %s algorithm %r "
                    "(known: %s); rule skipped", opname, algo,
                    sorted(known),
                )
                continue
            return algo
        return None

    def allows_quant(self, opname: str, nbytes: int, nranks: int,
                     dtype=None) -> bool:
        """False when the first matching rule carries
        ``"allow_quant": false`` — the user-rules veto on the
        automatic quantized-wire tier."""
        for rule in self._rules.get(opname, ()):
            if not self._matches(rule, nbytes, nranks, dtype):
                continue
            if "allow_quant" in rule:
                return bool(rule["allow_quant"])
        return True


def _dtype_name(dtype) -> str:
    """A dtype as the JAX package prints it ("float32"), from a torch
    dtype or a name."""
    return str(dtype).removeprefix("torch.")


_rules_cache: dict[str, Rules] = {}


def _rules() -> Optional[Rules]:
    """The rules file ``coll_tuned_rules_file`` names, loaded once per
    path (None when unset). A file that cannot be read or parsed is
    logged and gives no rules."""
    path = _rules_file.value
    if not path:
        return None
    r = _rules_cache.get(path)
    if r is None:
        try:
            r = Rules(path)
        except (OSError, ValueError, KeyError) as exc:
            logger.warning("cannot load rules file %s: %s", path, exc)
            r = Rules.__new__(Rules)
            r._rules = {}
            r._warned = set()
        _rules_cache[path] = r
    return r


def _ruled(opname: str, nbytes: int, nranks: int,
           dtype=None) -> Optional[str]:
    """The rules file's pick for the call, or None."""
    rules = _rules()
    if rules is None:
        return None
    return rules.decide(opname, nbytes, nranks, dtype)


def _nbytes(x) -> int:
    """Bytes per rank of a rank-major tensor (or tuple of tensors)."""
    leaves = list(x) if isinstance(x, (tuple, list)) else [x]
    return sum((l.numel() // max(l.shape[0], 1)) * l.element_size()
               for l in leaves)


def _ordered(op: Op) -> bool:
    """Must the op be folded in rank order (the correctness guard)?"""
    return not op.commutative or op.joint


def _sched_lookup(opname: str, nbytes: int, nranks: int, dtype=None,
                  op=None) -> Optional[str]:
    """Compiled-schedule cache consult (the precedence slot between the
    correctness guards and the static priors). ``nbytes`` is bytes per
    rank, the cache's size-bucket convention."""
    from . import sched

    return sched.lookup(opname, nbytes, nranks, dtype=dtype, op=op)


def decide_allreduce(op: Op, nbytes: int, nranks: int, dtype=None,
                     allow_quant: Optional[bool] = None) -> str:
    """Pick the allreduce algorithm; ``nbytes`` is bytes per rank.
    ``dtype`` is the payload element type (None = unknown → quant
    refused). ``allow_quant`` overrides the coll_quant_enable cvar (True
    forces consideration, False vetoes, a cached quant winner too); user
    rules can veto per band via ``"allow_quant": false``.

    Precedence: forced var > rules file > correctness guard
    (non-commutative/joint → ordered gather_reduce) > the winner cache >
    static priors."""
    forced = _force_allreduce.value
    if forced:
        return forced
    rules = _rules()
    if rules is not None:
        got = rules.decide("allreduce", nbytes, nranks, dtype)
        if got:
            return got
    if _ordered(op):
        return "gather_reduce"
    got = _sched_lookup("allreduce", nbytes, nranks, dtype, op)
    if got and not (allow_quant is False and (is_quant_algo(got)
                                              or got == "sched_quant")):
        return got  # the caller's explicit lossy-wire veto wins
    from .sched import priors

    return priors.prior_allreduce(op, nbytes, nranks, dtype, allow_quant,
                                  rules)


def allreduce_by_decision(x: torch.Tensor, op,
                          allow_quant: Optional[bool] = None
                          ) -> torch.Tensor:
    """Allreduce of a rank-major ``(n, ...)`` tensor routed through the
    same decision pipeline the comm vtable uses, without a communicator
    (the JAX package's traced form, inside ``shard_map``, takes the
    per-rank array and an axis name): how ``parallel.bucketer
    .allreduce_tree`` gets tuned scheduling and the quant tier per
    bucket. ``nbytes`` is bytes per rank. The JAX package routes the
    name through its circuit breaker here; the breaker is not ported
    yet (ROADMAP Queue 1 item 9), so the decision stands as made."""
    from ..trace import span as tspan

    op = op_lookup(op)
    nranks = x.shape[0]
    if nranks == 1:
        return x
    nbytes = (x.numel() // nranks) * x.element_size()
    algo = decide_allreduce(op, nbytes, nranks, dtype=x.dtype,
                            allow_quant=allow_quant)
    fn = _algo(ALLREDUCE_ALGOS, "allreduce", algo)
    SPC.record(f"coll_allreduce_algo_{algo}")
    tspan.instant("tuned.tier", cat="coll", op="allreduce", algo=algo,
                  nbytes=nbytes)
    if is_quant_algo(algo) or algo == "sched_quant":
        from . import quant

        quant.record_wire_stats(nbytes, x.element_size())
    if algo == "ring_segmented":
        seg_elems = max(1, _seg_bytes.value // x.element_size())
        return fn(x, op, segment_elems=seg_elems)
    return fn(x, op)


def decide_allgather(nbytes: int, nranks: int) -> str:
    forced = _force_allgather.value
    if forced:
        return forced
    got = _ruled("allgather", nbytes, nranks)
    if got:
        return got
    got = _sched_lookup("allgather", nbytes, nranks)
    if got:
        return got
    from .sched import priors

    return priors.prior_allgather(nbytes, nranks)


def decide_bcast(nbytes: int, nranks: int) -> str:
    forced = _force_bcast.value
    if forced:
        return forced
    got = _ruled("bcast", nbytes, nranks)
    if got:
        return got
    got = _sched_lookup("bcast", nbytes, nranks)
    if got:
        return got
    from .sched import priors

    return priors.prior_bcast(nbytes, nranks)


def decide_scan(op: Op, nbytes: int, nranks: int) -> str:
    """Scan space: the log-depth doubling exchange for small payloads,
    the associative-scan native plan otherwise; joint (paired-word) ops
    stay native — the variants exchange leaves positionally."""
    forced = _force_scan.value
    if forced:
        return forced
    got = _ruled("scan", nbytes, nranks)
    if got:
        return got
    if op.joint:
        return "native"
    got = _sched_lookup("scan", nbytes, nranks)
    if got:
        return got
    from .sched import priors

    return priors.prior_scan(op, nbytes, nranks)


def decide_exscan(op: Op, nbytes: int, nranks: int) -> str:
    forced = _force_exscan.value
    if forced:
        return forced
    got = _ruled("exscan", nbytes, nranks)
    if got:
        return got
    if op.joint:
        return "native"
    got = _sched_lookup("exscan", nbytes, nranks)
    if got:
        return got
    from .sched import priors

    return priors.prior_exscan(op, nbytes, nranks)


def decide_reduce(op: Op, nbytes: int, nranks: int) -> str:
    forced = _force_reduce.value
    if forced:
        return forced
    got = _ruled("reduce", nbytes, nranks)
    if got:
        return got
    if _ordered(op):
        return "native"  # ordered handling lives in the algo fallback
    got = _sched_lookup("reduce", nbytes, nranks)
    if got:
        return got
    from .sched import priors

    return priors.prior_reduce(op, nbytes, nranks)


def decide_reduce_scatter(op: Op, nbytes: int, nranks: int) -> str:
    forced = _force_reduce_scatter.value
    if forced:
        return forced
    got = _ruled("reduce_scatter", nbytes, nranks)
    if got:
        return got
    if _ordered(op):
        # ring/halving accumulate out of rank order; the native path's
        # ordered reduction is the only correct one
        return "native"
    got = _sched_lookup("reduce_scatter", nbytes, nranks)
    if got:
        return got
    from .sched import priors

    return priors.prior_reduce_scatter(op, nbytes, nranks)


def decide_alltoall(nbytes_per_dest: int, nranks: int) -> str:
    forced = _force_alltoall.value
    if forced:
        return forced
    got = _ruled("alltoall", nbytes_per_dest, nranks)
    if got:
        return got
    got = _sched_lookup("alltoall", nbytes_per_dest, nranks)
    if got:
        return got
    from .sched import priors

    return priors.prior_alltoall(nbytes_per_dest, nranks)


def decide_gather(nbytes: int, nranks: int) -> str:
    forced = _force_gather.value
    if forced:
        return forced
    got = _ruled("gather", nbytes, nranks)
    if got:
        return got
    got = _sched_lookup("gather", nbytes, nranks)
    if got:
        return got
    from .sched import priors

    return priors.prior_gather(nbytes, nranks)


def decide_scatter(nbytes: int, nranks: int) -> str:
    """Native (a reshard of root's buffer) unless forced: the tree and
    kernel forms are reachable only by the forced var."""
    forced = _force_scatter.value
    if forced:
        return forced
    got = _ruled("scatter", nbytes, nranks)
    if got:
        return got
    got = _sched_lookup("scatter", nbytes, nranks)
    if got:
        return got
    from .sched import priors

    return priors.prior_scatter(nbytes, nranks)


@COLL.register
class TunedColl(XlaColl):
    """Decision layer over the algorithm space. Inherits the native
    lowering for operations whose decision says 'native'."""

    NAME = "tuned"
    PRIORITY = 80
    DESCRIPTION = "algorithm decision layer (reference: coll/tuned)"

    def persistent_program(self, comm, opname, x, args):
        """The allreduce decision and its plan, resolved once (the host
        tier is the blocking call's alone, as in the JAX package)."""
        if opname != "allreduce" or comm.size == 1:
            return super().persistent_program(comm, opname, x, args)
        op = op_lookup(args[0])
        return self._allreduce_choice(comm, _leaf_check(comm, x), op)[1]

    def _allreduce_choice(self, comm, x, op):
        """(algo, plan) of the decision pipeline for allreduce; x is
        leaf-checked."""
        is_plain = isinstance(x, torch.Tensor)
        algo = decide_allreduce(op, _nbytes(x), comm.size,
                                dtype=x.dtype if is_plain else None)
        fn = _algo(ALLREDUCE_ALGOS, "allreduce", algo)
        # The single-buffer algorithms take one plain tensor; a tuple
        # (a joint op's pair) goes through the ordered gather-reduce.
        if algo not in ("native", "gather_reduce") and not is_plain:
            algo = "gather_reduce"
            fn = ALLREDUCE_ALGOS[algo]
        key = ("allreduce", algo, op.cache_key, _dtype_key(x))
        if is_quant_algo(algo) or algo == "sched_quant":
            from . import quant

            wire = quant._wire_var.value
            blk = quant._block_var.value
            key = key + (wire, blk)
            quant.record_wire_stats(_nbytes(x), x.element_size(), wire, blk)
        if algo == "ring_segmented":
            seg_elems = max(1, _seg_bytes.value // x.element_size())
            key = key + (seg_elems,)
            per_rank = lambda b: fn(b, op, segment_elems=seg_elems)  # noqa: E731
        else:
            per_rank = lambda b: fn(b, op)  # noqa: E731
        SPC.record(f"coll_allreduce_algo_{algo}")
        return algo, compile_plan(comm, key, per_rank)

    # Host-reducible predefined ops: ufunc.reduce over the rank axis, as
    # the JAX package's host tier computes them.
    _HOST_NP_OPS = {
        "sum": np.add, "prod": np.multiply,
        "max": np.maximum, "min": np.minimum,
    }
    _HOST_TORCH_OPS = {
        "sum": torch.add, "prod": torch.mul,
        "max": torch.maximum, "min": torch.minimum,
    }

    def _fast_allreduce(self, comm, x, op):
        """Memoized hot-path dispatch: the routed plan for (shape, dtype,
        op) is kept on the comm and repeat calls skip the decision
        pipeline. Tiny buffers get the host tier instead. Returns the
        result, or None when the slow path must run (memo off, a tuple
        or a buffer the slow path refuses, a plan that failed)."""
        if not _fast_cache_var.value or not isinstance(x, torch.Tensor):
            return None
        if x.ndim < 1 or x.shape[0] != comm.size or x.device != comm.device:
            return None  # the slow path raises the proper ArgumentError
        from .sched import cache as sched_cache

        # The JAX package also stamps its circuit breaker's, health
        # ledger's and SLO's generations; the port stamps them when
        # those modules land.
        stamp = (config.generation(), sched_cache.CACHE.generation())
        cache = comm.__dict__.setdefault("_tuned_fast", {})
        key = (tuple(x.shape), x.dtype, op.cache_key)
        ent = cache.get(key)
        if ent is None or ent[0] != stamp:
            fn = self._build_fast_allreduce(comm, x, op)
            if fn is None:
                return None
            ent = cache[key] = (stamp, fn)
        try:
            return ent[1](x)
        except ArgumentError:
            raise
        except Exception:  # a tier fault, not a caller error
            # A fault under a memoized plan: forget the entry and let
            # the slow path route (and raise) again.
            cache.pop(key, None)
            return None

    def _build_fast_allreduce(self, comm, x, op):
        limit = _host_small_max.value
        if (0 < limit >= x.numel() * x.element_size() and op.predefined
                and op.name in self._HOST_NP_OPS
                and not _force_allreduce.value and _rules() is None):
            SPC.record("coll_allreduce_algo_host")
            return partial(self._host_plan, op.name)
        try:
            _algo_name, plan = self._allreduce_choice(comm, x, op)
        except ArgumentError:
            raise
        except Exception:  # a tier fault, not a caller error
            return None  # the slow path surfaces the real error
        return plan

    @classmethod
    def _host_plan(cls, opname: str, buf: torch.Tensor) -> torch.Tensor:
        """``ufunc.reduce(a, axis=0)`` on the host, bit for bit as numpy
        computes it, broadcast to every rank on the buffer's device.
        Float32 (and every type numpy holds) goes through numpy itself:
        its add-reduce sums pairwise where the rank axis is the innermost
        loop (one element per rank, n >= 8) and in rank order otherwise,
        and only numpy's own loop gives those bits. Integer sums and
        products come back from numpy in int64 and are cast back, which
        wraps to the bits of the payload type. numpy has no bfloat16 here,
        so bfloat16 folds in rank order on the CPU, rounding to bfloat16
        at every step, as ml_dtypes' loop does (never ``torch.sum``, which
        accumulates in float32)."""
        a = buf.detach().cpu()
        if a.dtype == torch.bfloat16:
            combine = cls._HOST_TORCH_OPS[opname]
            red = a[0]
            for i in range(1, a.shape[0]):
                red = combine(red, a[i])
        else:
            arr = a.numpy()
            red = torch.from_numpy(np.array(
                cls._HOST_NP_OPS[opname].reduce(arr, axis=0),
                dtype=arr.dtype))
        return red.to(buf.device).expand(buf.shape).contiguous()

    def allreduce(self, comm, x, op):
        op = op_lookup(op)
        if comm.size > 1:
            out = self._fast_allreduce(comm, x, op)
            if out is not None:
                return out
        x = _leaf_check(comm, x)
        if comm.size == 1 and not _force_allreduce.value:
            return x
        return self._allreduce_choice(comm, x, op)[1](x)

    def allgather(self, comm, x):
        x = rank_major_check(comm, x)
        if comm.size == 1:
            return x[:, None]
        algo = decide_allgather(_nbytes(x), comm.size)
        fn = _algo(ALLGATHER_ALGOS, "allgather", algo)
        key = ("allgather", algo, tuple(x.shape), str(x.dtype))
        return compile_plan(comm, key, fn)(x)

    def bcast(self, comm, x, root):
        x = _leaf_check(comm, x)
        if comm.size == 1:
            return x
        algo = decide_bcast(_nbytes(x), comm.size)
        fn = _algo(BCAST_ALGOS, "bcast", algo)
        key = ("bcast", algo, root, _dtype_key(x))
        return compile_plan(comm, key, lambda b: fn(b, root=root))(x)

    def reduce(self, comm, x, op, root):
        op = op_lookup(op)
        if comm.size == 1:
            return super().reduce(comm, x, op, root)
        algo = decide_reduce(op, _nbytes(x), comm.size)
        if algo == "native" or not isinstance(x, torch.Tensor):
            return super().reduce(comm, x, op, root)
        fn = _algo(REDUCE_ALGOS, "reduce", algo)
        x = rank_major_check(comm, x)
        SPC.record(f"coll_reduce_algo_{algo}")
        key = ("reduce", algo, op.cache_key, root, tuple(x.shape),
               str(x.dtype))
        plan = compile_plan(comm, key, lambda b: fn(b, op, root=root))
        return plan(x)[root]

    def _prefix(self, comm, x, op, opname: str, decide, algos, native):
        """Shared scan/exscan dispatch over the tuned decision space
        (reference: the per-op decision functions of coll/tuned)."""
        op = op_lookup(op)
        x = rank_major_check(comm, x)
        if comm.size == 1:
            return native(self, comm, x, op)
        algo = decide(op, _nbytes(x), comm.size)
        fn = _algo(algos, opname, algo)
        key = (opname, algo, op.cache_key, tuple(x.shape), str(x.dtype))
        return compile_plan(comm, key, lambda b: fn(b, op))(x)

    def scan(self, comm, x, op):
        return self._prefix(comm, x, op, "scan", decide_scan, SCAN_ALGOS,
                            XlaColl.scan)

    def exscan(self, comm, x, op):
        return self._prefix(comm, x, op, "exscan", decide_exscan,
                            EXSCAN_ALGOS, XlaColl.exscan)

    def reduce_scatter_block(self, comm, x, op):
        op = op_lookup(op)
        x = rank_major_check(comm, x, min_ndim=2)
        if x.shape[1] != comm.size:
            raise ArgumentError(
                f"reduce_scatter_block needs (size, size, ...) buffer, "
                f"got {tuple(x.shape)}")
        if comm.size == 1:
            return x[:, 0]
        per_rank = (x.numel() // (comm.size * comm.size)) * x.element_size()
        algo = decide_reduce_scatter(op, per_rank, comm.size)
        if algo == "native":
            return super().reduce_scatter_block(comm, x, op)
        fn = _algo(REDUCE_SCATTER_ALGOS, "reduce_scatter", algo)
        SPC.record(f"coll_reduce_scatter_algo_{algo}")
        key = ("reduce_scatter_block", algo, op.cache_key, tuple(x.shape),
               str(x.dtype))
        return compile_plan(comm, key, lambda b: fn(b, op))(x)

    def alltoall(self, comm, x):
        x = rank_major_check(comm, x, min_ndim=2)
        if x.shape[1] != comm.size:
            raise ArgumentError(
                f"alltoall needs (size, size, ...) buffer, got "
                f"{tuple(x.shape)}")
        if comm.size == 1:
            return x
        per_dest = (x.numel() // (comm.size * comm.size)) * x.element_size()
        algo = decide_alltoall(per_dest, comm.size)
        fn = _algo(ALLTOALL_ALGOS, "alltoall", algo)
        SPC.record(f"coll_alltoall_algo_{algo}")
        key = ("alltoall", algo, tuple(x.shape), str(x.dtype))
        return compile_plan(comm, key, fn)(x)

    def gather(self, comm, x, root):
        x = rank_major_check(comm, x)
        if comm.size == 1:
            return x[:, None][root]
        algo = decide_gather(_nbytes(x), comm.size)
        if algo == "native":
            return super().gather(comm, x, root)
        fn = _algo(GATHER_ALGOS, "gather", algo)
        SPC.record(f"coll_gather_algo_{algo}")
        key = ("gather", algo, root, tuple(x.shape), str(x.dtype))
        return compile_plan(comm, key, lambda b: fn(b, root=root))(x)

    def scatter(self, comm, x, root):
        buf = scatter_buffer(comm, x)
        if comm.size == 1:
            return buf
        algo = decide_scatter(_nbytes(buf), comm.size)
        if algo == "native":
            return super().scatter(comm, buf, root)
        fn = _algo(SCATTER_ALGOS, "scatter", algo)
        SPC.record(f"coll_scatter_algo_{algo}")
        key = ("scatter", algo, root, tuple(buf.shape), str(buf.dtype))
        return compile_plan(comm, key, lambda b: fn(b, root=root))(buf)
