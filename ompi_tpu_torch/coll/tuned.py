"""coll/tuned — the decision layer (port of ``ompi_tpu/coll/tuned.py``
for allreduce, alltoall, bcast, reduce, allgather, reduce_scatter_block,
gather and scatter).

Precedence, as in the JAX package: forced var
(``coll_tuned_<op>_algorithm``) > correctness guard (non-commutative or
joint op → the rank-ordered path) > static priors
(``sched/priors.prior_*``). The rules file, the schedule-compiler
winner cache, the host tier, the circuit breaker and the
health/fault/trace seams are not ported yet: a fault in the chosen tier
propagates to the caller instead of degrading to the next tier. The
alltoall, gather and scatter priors' names are all ported; those of the
other operations other than ``native`` (``recursive_doubling``,
``binomial``, ``ring``, ...) are spmd algorithms the port does not have
yet: they raise ``ArgumentError``.

As in the JAX package there is no hand-kernel alltoall name: the
alltoall kernel is reached through ``PallasColl``. A gather algorithm
returns root's rows and a scatter algorithm takes root's buffer (see
``spmd``).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from ..core import config
from ..core.counters import SPC
from ..core.errors import ArgumentError
from ..ops import Op, lookup as op_lookup
from . import spmd
from .framework import COLL, compile_plan, rank_major_check
from .xla import XlaColl, _dtype_key, _leaf_check, scatter_buffer

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
_prefer_native = _V("prefer_native", type=bool, default=True,
                    description="Use the native collective when the op "
                                "supports it")
_force_allreduce = _V("allreduce_algorithm", type=str, default="",
                      description="Force an allreduce algorithm by name")
_force_allgather = _V("allgather_algorithm", type=str, default="",
                      description="Force an allgather algorithm by name")
_force_bcast = _V("bcast_algorithm", type=str, default="",
                  description="Force a bcast algorithm by name")
_force_reduce = _V("reduce_algorithm", type=str, default="",
                   description="Force a reduce algorithm by name")
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

ALLREDUCE_ALGOS: dict[str, Callable] = {
    "native": spmd.allreduce_native,
    "gather_reduce": spmd._allreduce_gather_reduce,
}
ALLGATHER_ALGOS: dict[str, Callable] = {"native": spmd.allgather_native}
BCAST_ALGOS: dict[str, Callable] = {"native": spmd.bcast_native}
REDUCE_ALGOS: dict[str, Callable] = {"native": spmd.reduce_native}
REDUCE_SCATTER_ALGOS: dict[str, Callable] = {
    "native": spmd.reduce_scatter_native,
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


def is_pallas_algo(name: str) -> bool:
    return name.startswith("pallas")


def _algo(algos: dict, opname: str, name: str) -> Callable:
    """The algorithm registered under ``name`` for ``opname``."""
    if is_pallas_algo(name):
        _pallas_algos()
    fn = algos.get(name)
    if fn is None:
        raise ArgumentError(
            f"unknown {opname} algorithm {name!r}; known: {sorted(algos)}")
    return fn


def _nbytes(x) -> int:
    """Bytes per rank of a rank-major tensor (or tuple of tensors)."""
    leaves = list(x) if isinstance(x, (tuple, list)) else [x]
    return sum((l.numel() // max(l.shape[0], 1)) * l.element_size()
               for l in leaves)


def _ordered(op: Op) -> bool:
    """Must the op be folded in rank order (the correctness guard)?"""
    return not op.commutative or op.joint


def decide_allreduce(op: Op, nbytes: int, nranks: int, dtype=None) -> str:
    """Pick the allreduce algorithm; ``nbytes`` is bytes per rank."""
    forced = _force_allreduce.value
    if forced:
        return forced
    if _ordered(op):
        return "gather_reduce"
    from .sched import priors

    return priors.prior_allreduce(op, nbytes, nranks, dtype)


def decide_allgather(nbytes: int, nranks: int) -> str:
    forced = _force_allgather.value
    if forced:
        return forced
    from .sched import priors

    return priors.prior_allgather(nbytes, nranks)


def decide_bcast(nbytes: int, nranks: int) -> str:
    forced = _force_bcast.value
    if forced:
        return forced
    from .sched import priors

    return priors.prior_bcast(nbytes, nranks)


def decide_reduce(op: Op, nbytes: int, nranks: int) -> str:
    forced = _force_reduce.value
    if forced:
        return forced
    if _ordered(op):
        return "native"  # ordered handling lives in the algo fallback
    from .sched import priors

    return priors.prior_reduce(op, nbytes, nranks)


def decide_reduce_scatter(op: Op, nbytes: int, nranks: int) -> str:
    forced = _force_reduce_scatter.value
    if forced:
        return forced
    if _ordered(op):
        # ring/halving accumulate out of rank order; the native path's
        # ordered reduction is the only correct one
        return "native"
    from .sched import priors

    return priors.prior_reduce_scatter(op, nbytes, nranks)


def decide_alltoall(nbytes_per_dest: int, nranks: int) -> str:
    forced = _force_alltoall.value
    if forced:
        return forced
    from .sched import priors

    return priors.prior_alltoall(nbytes_per_dest, nranks)


def decide_gather(nbytes: int, nranks: int) -> str:
    forced = _force_gather.value
    if forced:
        return forced
    from .sched import priors

    return priors.prior_gather(nbytes, nranks)


def decide_scatter(nbytes: int, nranks: int) -> str:
    """Native (a reshard of root's buffer) unless forced: the tree and
    kernel forms are reachable only by the forced var."""
    forced = _force_scatter.value
    if forced:
        return forced
    from .sched import priors

    return priors.prior_scatter(nbytes, nranks)


@COLL.register
class TunedColl(XlaColl):
    """Decision layer over the algorithm space. Inherits the native
    lowering for operations whose decision says 'native'."""

    NAME = "tuned"
    PRIORITY = 80
    DESCRIPTION = "algorithm decision layer (reference: coll/tuned)"

    def allreduce(self, comm, x, op):
        op = op_lookup(op)
        x = _leaf_check(comm, x)
        if comm.size == 1:
            return x
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
        SPC.record(f"coll_allreduce_algo_{algo}")
        plan = compile_plan(comm, key, lambda b: fn(b, op))
        return plan(x)

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
