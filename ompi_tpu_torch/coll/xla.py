"""coll/xla — the native collective component (port of
``ompi_tpu/coll/xla.py``).

It keeps the component name ``xla`` so selection vars
(``coll_xla_priority``, ``coll_select``) mean the same thing in both
packages. Its allreduce is PyTorch's own reduction over the rank axis
(``spmd.allreduce_native``): the JAX package leaves this path to XLA
and has no Pallas kernel on it.
"""

from __future__ import annotations

from ..core.errors import ArgumentError
from ..ops import lookup as op_lookup
from . import spmd
from .framework import COLL, CollComponent, compile_plan, rank_major_check


def _leaf_check(comm, x):
    """Validate every leaf of x (a tensor or a tuple of tensors) is
    rank-major on the comm's device; return x."""
    leaves = list(x) if isinstance(x, (tuple, list)) else [x]
    if not leaves:
        raise ArgumentError("empty buffer")
    for leaf in leaves:
        rank_major_check(comm, leaf)
    return x


def _dtype_key(x) -> tuple:
    leaves = list(x) if isinstance(x, (tuple, list)) else [x]
    return tuple((tuple(l.shape), str(l.dtype)) for l in leaves)


@COLL.register
class XlaColl(CollComponent):
    NAME = "xla"
    PRIORITY = 40
    DESCRIPTION = "native collectives (torch reductions over the rank axis)"

    def allreduce(self, comm, x, op):
        op = op_lookup(op)
        x = _leaf_check(comm, x)
        if comm.size == 1:
            return x
        key = ("allreduce", "native", op.cache_key, _dtype_key(x))
        plan = compile_plan(
            comm, key, lambda b: spmd.allreduce_native(b, op))
        return plan(x)
