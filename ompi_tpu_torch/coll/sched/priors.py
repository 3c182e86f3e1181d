"""Cold-start priors: the static algorithm tables (port of
``ompi_tpu/coll/sched/priors.py``: allreduce, alltoall, bcast, scan,
exscan, reduce, allgather, reduce_scatter, gather and scatter).

The reference's fixed decision rules (coll_tuned_decision_fixed.c),
demoted to the cold-start prior that ``coll/tuned`` consults only when
the forced var, the rules file, the correctness guards and the winner
cache have not decided. The byte thresholds stay on the coll_tuned
cvars; this module turns them into picks. For allreduce the
quantized-wire gate comes first: ``quant_ring`` when the user consents
(``coll_quant_enable`` or the caller's ``allow_quant``), the payload is
at least ``coll_quant_min_bytes`` per rank, ``quant.supports`` the op
and dtype (a floating SUM) and no rules-file band vetoes it.

Every ``nbytes`` parameter is BYTES PER RANK (the block size of the
rank-major payload), the convention shared with the rules-file bands
and the winner cache's size buckets.
"""

from __future__ import annotations

from typing import Optional

from ...ops import Op
from .. import quant


def _t():
    # tuned registers the cvars and imports this module lazily from its
    # decide_* bodies, so by first call the module object exists.
    from .. import tuned

    return tuned


def prior_allreduce(op: Op, nbytes: int, nranks: int, dtype=None,
                    allow_quant: Optional[bool] = None,
                    rules=None) -> str:
    """Reference regime: recursive doubling < 10 KB/rank, ring to
    1 MiB/rank, segmented ring above — with the native preference and
    the quantized-wire gate ahead of all three."""
    t = _t()
    # Quantized wire: before native — trading representable values for
    # wire bytes only pays on the wire-bound (large, floating, SUM)
    # band, and only when the user (cvar/caller) and rules all agree.
    if allow_quant is None:
        allow_quant = quant._enable_var.value
    if (allow_quant
            and nbytes >= quant._min_bytes_var.value
            and quant.supports(op, dtype)
            and (rules is None
                 or rules.allows_quant("allreduce", nbytes, nranks,
                                       dtype))):
        return "quant_ring"
    if t._prefer_native.value and op.native_reduce is not None:
        return "native"
    if nbytes < t._small.value:
        return "recursive_doubling"
    if nbytes <= t._ring_limit.value:
        return "ring"
    return "ring_segmented"


def prior_alltoall(nbytes_per_dest: int, nranks: int) -> str:
    t = _t()
    if nbytes_per_dest <= t._alltoall_small.value and nranks >= 8:
        return "bruck"
    if nbytes_per_dest >= t._alltoall_large.value:
        return "pairwise"
    return "native"


def prior_allgather(nbytes: int, nranks: int) -> str:
    return "native"


def prior_bcast(nbytes: int, nranks: int) -> str:
    """Reference regime (coll_tuned_decision_fixed.c:250-310): binomial
    small, binary tree mid-size, segmented pipeline for bulk; native
    wins when preferred."""
    t = _t()
    if t._prefer_native.value:
        return "native"
    if nbytes < t._small.value:
        return "binomial"
    if nbytes < t._large.value:
        return "binary"
    return "pipelined"


def prior_scan(op: Op, nbytes: int, nranks: int) -> str:
    """The doubling exchange for small payloads unless native is
    preferred; joint (paired-word) ops stay native."""
    t = _t()
    if op.joint:
        return "native"
    if t._prefer_native.value:
        return "native"
    if nbytes < t._small.value:
        return "recursive_doubling"
    return "native"


def prior_exscan(op: Op, nbytes: int, nranks: int) -> str:
    return prior_scan(op, nbytes, nranks)


def prior_reduce(op: Op, nbytes: int, nranks: int) -> str:
    """Reference: binomial small, pipelined chains above; the ordered
    native path for non-commutative ops."""
    t = _t()
    if not op.commutative or op.joint:
        return "native"  # ordered handling lives in the algo fallback
    if t._prefer_native.value and op.native_reduce is not None:
        return "native"
    if nbytes < t._small.value:
        return "binomial"
    if nbytes >= t._large.value:
        return "pipelined"
    return "native"


def prior_reduce_scatter(op: Op, nbytes: int, nranks: int) -> str:
    """Reference: recursive halving for small commutative power-of-two
    cases, ring for large."""
    t = _t()
    if not op.commutative or op.joint:
        # ring/halving accumulate out of rank order; the native path's
        # ordered reduction is the only correct one
        return "native"
    if t._prefer_native.value and op.native_reduce is not None:
        return "native"
    pof2 = nranks & (nranks - 1) == 0
    if pof2 and nbytes < t._small.value:
        return "recursive_halving"
    return "ring"


def prior_gather(nbytes: int, nranks: int) -> str:
    t = _t()
    if nbytes < t._gather_binomial_max.value and nranks >= 4:
        return "binomial"
    return "native"


def prior_scatter(nbytes: int, nranks: int) -> str:
    # Always native: scatter is a reshard of root's buffer; the tree and
    # kernel forms are reachable only by the forced var.
    return "native"
