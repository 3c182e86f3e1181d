"""coll/tuned — the allreduce decision layer (port of
``ompi_tpu/coll/tuned.py``, allreduce only).

Precedence, as in the JAX package: forced var
(``coll_tuned_allreduce_algorithm``) > correctness guard
(non-commutative or joint op → rank-ordered ``gather_reduce``) > static
priors (``sched/priors.prior_allreduce``). The rules file, the
schedule-compiler winner cache, the host tier, the circuit breaker and
the health/fault/trace seams are not ported in this slice: a fault in
the chosen tier propagates to the caller instead of degrading to the
next tier.
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
from .framework import COLL, compile_plan
from .xla import XlaColl, _dtype_key, _leaf_check

_V = partial(config.register, "coll", "tuned")
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

ALLREDUCE_ALGOS: dict[str, Callable] = {
    "native": spmd.allreduce_native,
    "gather_reduce": spmd._allreduce_gather_reduce,
}


def _pallas_algos() -> None:
    """Register the hand-kernel tier's allreduce names (lazily, as the
    JAX package does)."""
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
    ALLREDUCE_ALGOS["pallas_rd"] = _pallas_rd_guarded
    ALLREDUCE_ALGOS["pallas_ring_chunked"] = pr.allreduce_block_chunked


def is_pallas_algo(name: str) -> bool:
    return name.startswith("pallas")


def _nbytes(x) -> int:
    """Bytes per rank of a rank-major tensor (or tuple of tensors)."""
    leaves = list(x) if isinstance(x, (tuple, list)) else [x]
    return sum((l.numel() // max(l.shape[0], 1)) * l.element_size()
               for l in leaves)


def decide_allreduce(op: Op, nbytes: int, nranks: int, dtype=None) -> str:
    """Pick the allreduce algorithm; ``nbytes`` is bytes per rank."""
    forced = _force_allreduce.value
    if forced:
        return forced
    if not op.commutative or op.joint:
        return "gather_reduce"
    from .sched import priors

    return priors.prior_allreduce(op, nbytes, nranks, dtype)


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
        if is_pallas_algo(algo):
            _pallas_algos()
        fn = ALLREDUCE_ALGOS.get(algo)
        if fn is None:
            raise ArgumentError(
                f"unknown allreduce algorithm {algo!r}; known: "
                f"{sorted(ALLREDUCE_ALGOS)}"
            )
        # The single-buffer algorithms take one plain tensor; a tuple
        # (a joint op's pair) goes through the ordered gather-reduce.
        if algo not in ("native", "gather_reduce") and not is_plain:
            algo = "gather_reduce"
            fn = ALLREDUCE_ALGOS[algo]
        key = ("allreduce", algo, op.cache_key, _dtype_key(x))
        SPC.record(f"coll_allreduce_algo_{algo}")
        plan = compile_plan(comm, key, lambda b: fn(b, op))
        return plan(x)
