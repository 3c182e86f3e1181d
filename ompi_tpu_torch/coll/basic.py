"""coll/basic — the rank-ordered linear oracle (port of
``ompi_tpu/coll/basic.py``: every operation of the coll framework,
the ragged variants and the neighborhood collectives included).

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

import torch

from ..core.errors import ArgumentError
from ..ops import lookup as op_lookup
from .framework import COLL, CollComponent, rank_major_check
from .spmd import _broadcast_ranks, scan_linear_chain
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

    def scan(self, comm, x, op):
        """The rank-order fold: the linear chain's prefixes."""
        return scan_linear_chain(rank_major_check(comm, x), op_lookup(op))

    def exscan(self, comm, x, op):
        """Rank r gets the fold of ranks 0..r-1; rank 0 gets zeros (not
        the op's identity), as the JAX package's oracle gives it."""
        x = rank_major_check(comm, x)
        out = torch.zeros_like(x)
        out[1:] = scan_linear_chain(x[:-1], op_lookup(op))
        return out

    def barrier(self, comm):
        return None

    # -- vector (ragged) variants -----------------------------------------

    @staticmethod
    def _ragged_in(comm, values) -> list:
        if len(values) != comm.size:
            raise ArgumentError(
                f"need one block per rank ({comm.size}), got {len(values)}"
            )
        return [torch.as_tensor(v).to(comm.device) for v in values]

    def allgatherv(self, comm, values):
        return torch.cat(self._ragged_in(comm, values), 0)

    def gatherv(self, comm, values, root):
        del root
        return torch.cat(self._ragged_in(comm, values), 0)

    def scatterv(self, comm, blocks, root):
        del root
        return self._ragged_in(comm, blocks)

    def alltoallv(self, comm, blocks):
        """blocks[src][dst] = rows for dst; returns out[dst] = the
        concatenation over src of blocks[src][dst]."""
        n = comm.size
        if len(blocks) != n:
            raise ArgumentError(f"need {n} send lists, got {len(blocks)}")
        return [torch.cat([torch.as_tensor(blocks[src][dst]).to(comm.device)
                           for src in range(n)], 0)
                for dst in range(n)]

    def alltoallw(self, comm, blocks):
        """Like alltoallv but fully heterogeneous: no concatenation —
        out[dst][src] keeps each block's own shape and dtype (reference
        MPI_Alltoallw's per-block datatypes)."""
        n = comm.size
        if len(blocks) != n:
            raise ArgumentError(f"need {n} send lists, got {len(blocks)}")
        return [[torch.as_tensor(blocks[src][dst]).to(comm.device)
                 for src in range(n)]
                for dst in range(n)]

    def reduce_scatter(self, comm, values, counts, op):
        """MPI_Reduce_scatter: fold the per-rank (total, ...) buffers in
        rank order, then piece r (counts[r] rows) goes to rank r."""
        op = op_lookup(op)
        bufs = self._ragged_in(comm, values)
        n = comm.size
        if len(counts) != n:
            raise ArgumentError(f"need {n} counts, got {len(counts)}")
        total = sum(counts)
        for b in bufs:
            if b.shape[0] != total:
                raise ArgumentError(
                    f"buffer rows {b.shape[0]} != sum(counts) {total}")
        acc = bufs[0]
        for i in range(1, n):
            acc = op.combine(acc, bufs[i])
        out, start = [], 0
        for c in counts:
            out.append(acc[start:start + c])
            start += c
        return out

    # -- neighborhood collectives over the attached topology --------------

    def neighbor_allgather(self, comm, x):
        from ..topo import topology as topo_mod

        return topo_mod.neighbor_allgather(comm, x)

    def neighbor_alltoall(self, comm, sendblocks):
        from ..topo import topology as topo_mod

        return topo_mod.neighbor_alltoall(comm, sendblocks)
