"""coll/basic — the rank-ordered linear oracle (port of
``ompi_tpu/coll/basic.py``: allreduce, bcast, reduce, allgather,
reduce_scatter_block, alltoall, gather and scatter).

The lowest-priority component: it handles every op and dtype by folding
``acc = op(acc, x[i])`` for i = 1..n-1 in rank order, so it is right for
non-commutative ops, and ``PallasColl.reduce`` sends them here. The JAX
package stages the buffers through the host to fold them with numpy;
the fold order, not the staging, is what makes the result right, so the
port folds with torch on the communicator's device and copies nothing
to the host.
"""

from __future__ import annotations

from typing import Any

from ..core.errors import ArgumentError
from ..ops import lookup as op_lookup
from .framework import COLL, CollComponent, rank_major_check
from .spmd import _broadcast_ranks
from .xla import _leaf_check, scatter_buffer


def _row(x: Any, i: int) -> Any:
    """Rank i's block of x (a tensor, or a tuple of tensors for a joint
    op's pair)."""
    if isinstance(x, (tuple, list)):
        return type(x)(leaf[i] for leaf in x)
    return x[i]


def _fold(x: Any, op, n: int) -> Any:
    acc = _row(x, 0)
    for i in range(1, n):
        acc = op.combine(acc, _row(x, i))
    return acc


def _spread(red: Any, n: int) -> Any:
    if isinstance(red, (tuple, list)):
        return type(red)(_broadcast_ranks(leaf, n) for leaf in red)
    return _broadcast_ranks(red, n)


@COLL.register
class BasicColl(CollComponent):
    NAME = "basic"
    PRIORITY = 10
    DESCRIPTION = "rank-ordered linear fallbacks (reference: coll/basic)"

    def allreduce(self, comm, x, op):
        op = op_lookup(op)
        x = _leaf_check(comm, x)
        return _spread(_fold(x, op, comm.size), comm.size)

    def bcast(self, comm, x, root):
        x = _leaf_check(comm, x)
        return _spread(_row(x, root), comm.size)

    def reduce(self, comm, x, op, root):
        """Root's block of the allreduce: the rank-ordered fold."""
        del root
        op = op_lookup(op)
        x = _leaf_check(comm, x)
        return _fold(x, op, comm.size)

    def allgather(self, comm, x):
        x = rank_major_check(comm, x)
        return _broadcast_ranks(x, comm.size)

    def reduce_scatter_block(self, comm, x, op):
        op = op_lookup(op)
        x = rank_major_check(comm, x, min_ndim=2)
        if x.shape[1] != comm.size:
            raise ArgumentError(
                f"reduce_scatter_block needs (size, size, ...), got "
                f"{tuple(x.shape)}")
        # acc[j] is rank j's block.
        return _fold(x, op, comm.size)

    def alltoall(self, comm, x):
        x = rank_major_check(comm, x, min_ndim=2)
        if x.shape[1] != comm.size:
            raise ArgumentError(
                f"alltoall needs (size, size, ...), got {tuple(x.shape)}")
        return x.transpose(0, 1).contiguous()

    def gather(self, comm, x, root):
        """Root's rows: every rank's block, in rank order."""
        del root
        return rank_major_check(comm, x).clone()

    def scatter(self, comm, x, root):
        del root
        return scatter_buffer(comm, x).clone()
