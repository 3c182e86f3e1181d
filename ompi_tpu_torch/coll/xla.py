"""coll/xla — the native collective component (port of
``ompi_tpu/coll/xla.py``).

It keeps the component name ``xla`` so selection vars
(``coll_xla_priority``, ``coll_select``) mean the same thing in both
packages. Its collectives are PyTorch's own operations over the rank
axis (``spmd.*_native``): the JAX package leaves this path to XLA and
has no Pallas kernel on it.

The ragged variants (allgatherv, alltoallv, reduce_scatter) pad every
block to the longest count, run the fixed-shape collective of this
component (so ``TunedColl``'s decisions, which inherit them) and slice
the live rows back out, all on the communicator's device. A result every
rank holds is one tensor, as the port's gather convention has it.
"""

from __future__ import annotations

import torch

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


def scatter_buffer(comm, x) -> torch.Tensor:
    """Root's ``(size, ...)`` scatter buffer (a tensor or numpy array) on
    the comm's device, moved there if it lies elsewhere."""
    arr = torch.as_tensor(x)
    if arr.ndim < 1 or arr.shape[0] != comm.size:
        raise ArgumentError(
            f"scatter needs (size, ...) buffer, got {tuple(arr.shape)}")
    return comm.put_rank_major(arr)


def _dtype_key(x) -> tuple:
    leaves = list(x) if isinstance(x, (tuple, list)) else [x]
    return tuple((tuple(l.shape), str(l.dtype)) for l in leaves)


@COLL.register
class XlaColl(CollComponent):
    NAME = "xla"
    PRIORITY = 40
    DESCRIPTION = "native collectives (torch reductions over the rank axis)"

    def _allreduce_plan(self, comm, x, op):
        key = ("allreduce", "native", op.cache_key, _dtype_key(x))
        return compile_plan(
            comm, key, lambda b: spmd.allreduce_native(b, op))

    def allreduce(self, comm, x, op):
        op = op_lookup(op)
        x = _leaf_check(comm, x)
        if comm.size == 1:
            return x
        return self._allreduce_plan(comm, x, op)(x)

    def persistent_program(self, comm, opname, x, args):
        """The native allreduce plan, bound once."""
        if opname != "allreduce":
            return None
        op = op_lookup(args[0])
        x = _leaf_check(comm, x)
        if comm.size == 1:
            return lambda b: b
        return self._allreduce_plan(comm, x, op)

    def bcast(self, comm, x, root):
        x = _leaf_check(comm, x)
        if comm.size == 1:
            return x
        key = ("bcast", "native", root, _dtype_key(x))
        plan = compile_plan(comm, key,
                            lambda b: spmd.bcast_native(b, root=root))
        return plan(x)

    def reduce(self, comm, x, op, root):
        op = op_lookup(op)
        x = _leaf_check(comm, x)
        if comm.size == 1:
            out = x
        else:
            # The allreduce's plan (root reads its row): same cache entry.
            out = self._allreduce_plan(comm, x, op)(x)
        if isinstance(out, (tuple, list)):
            return type(out)(leaf[root] for leaf in out)
        return out[root]

    def allgather(self, comm, x):
        x = rank_major_check(comm, x)
        if comm.size == 1:
            return x[:, None]
        key = ("allgather", "native", tuple(x.shape), str(x.dtype))
        return compile_plan(comm, key, spmd.allgather_native)(x)

    def reduce_scatter_block(self, comm, x, op):
        op = op_lookup(op)
        x = rank_major_check(comm, x, min_ndim=2)
        if x.shape[1] != comm.size:
            raise ArgumentError(
                f"reduce_scatter_block needs (size, size, ...) buffer, got "
                f"{tuple(x.shape)}")
        if comm.size == 1:
            return x[:, 0]
        key = ("reduce_scatter_block", "native", op.cache_key,
               tuple(x.shape), str(x.dtype))
        plan = compile_plan(
            comm, key, lambda b: spmd.reduce_scatter_native(b, op))
        return plan(x)

    def alltoall(self, comm, x):
        x = rank_major_check(comm, x, min_ndim=2)
        if x.shape[1] != comm.size:
            raise ArgumentError(
                f"alltoall needs (size, size, ...) buffer, got "
                f"{tuple(x.shape)}")
        if comm.size == 1:
            return x
        key = ("alltoall", "native", tuple(x.shape), str(x.dtype))
        return compile_plan(comm, key, spmd.alltoall_native)(x)

    def gather(self, comm, x, root):
        """Root's rows of the allgather (built for root alone: see
        ``spmd.gather_native``)."""
        x = rank_major_check(comm, x)
        key = ("gather", "native", tuple(x.shape), str(x.dtype))
        return compile_plan(comm, key, spmd.gather_native)(x)

    def scatter(self, comm, x, root):
        """A reshard of root's (size, ...) buffer, one row per rank, into
        a tensor of its own."""
        buf = scatter_buffer(comm, x)
        key = ("scatter", "native", tuple(buf.shape), str(buf.dtype))
        return compile_plan(comm, key, spmd.scatter_native)(buf)

    def scan(self, comm, x, op):
        op = op_lookup(op)
        x = rank_major_check(comm, x)
        if comm.size == 1:
            return x
        key = ("scan", "native", op.cache_key, tuple(x.shape), str(x.dtype))
        return compile_plan(
            comm, key, lambda b: spmd.scan_native(b, op))(x)

    def exscan(self, comm, x, op):
        op = op_lookup(op)
        x = rank_major_check(comm, x)
        if comm.size == 1:
            return torch.zeros_like(x)
        key = ("exscan", "native", op.cache_key, tuple(x.shape),
               str(x.dtype))
        return compile_plan(
            comm, key, lambda b: spmd.exscan_native(b, op))(x)

    def barrier(self, comm):
        """The fabric token: one int32 per rank summed over the ranks.
        The communicator waits for it (``barrier()``) or a persistent
        request records its completion event after it."""
        if comm.size == 1:
            return None
        plan = compile_plan(comm, ("barrier",), spmd.barrier)
        return plan(torch.ones(comm.size, dtype=torch.int32,
                               device=comm.device))

    # -- vector (ragged) variants ----------------------------------------
    # Pad every ragged block to the max count, run the cached fixed-shape
    # plan, slice the live rows back out on the device. Counts are Python
    # ints, so each count profile is its own plan.

    @staticmethod
    def _pad_stack(comm, values, max_len):
        """(size, max_len, ...) on the comm's device: rank r's rows, then
        zeros."""
        first = torch.as_tensor(values[0])
        out = torch.zeros((comm.size, max_len) + tuple(first.shape[1:]),
                          dtype=first.dtype, device=comm.device)
        for r, v in enumerate(values):
            v = torch.as_tensor(v)
            out[r, :v.shape[0]] = v
        return out

    def allgatherv(self, comm, values):
        if len(values) != comm.size:
            raise ArgumentError(
                f"need one block per rank ({comm.size}), got {len(values)}")
        counts = [torch.as_tensor(v).shape[0] for v in values]
        m = max(counts) if counts else 0
        if m == 0:
            return torch.as_tensor(values[0]).to(comm.device)
        gathered = self.allgather(comm, self._pad_stack(comm, values, m))
        # (size, size, m, ...): every rank's copy is the same; take rank
        # 0's and drop the padding of each segment.
        full = gathered[0]
        return torch.cat([full[r, :c] for r, c in enumerate(counts)], 0)

    def alltoallv(self, comm, blocks):
        n = comm.size
        if len(blocks) != n:
            raise ArgumentError(f"need {n} send lists, got {len(blocks)}")
        tensors = [[torch.as_tensor(blocks[s][d]).to(comm.device)
                    for d in range(n)] for s in range(n)]
        counts = [[tensors[s][d].shape[0] for d in range(n)]
                  for s in range(n)]
        m = max((c for row in counts for c in row), default=0)
        if m == 0:
            return [tensors[0][d] for d in range(n)]
        padded = []
        for s in range(n):
            row = tensors[s][0].new_zeros(
                (n, m) + tuple(tensors[s][0].shape[1:]))
            for d in range(n):
                row[d, :counts[s][d]] = tensors[s][d]
            padded.append(row)
        swapped = self.alltoall(comm, comm.from_rank_values(padded))
        # swapped[d, s] is src s's padded block for dst d
        return [torch.cat([swapped[d, s, :counts[s][d]] for s in range(n)],
                          0)
                for d in range(n)]

    def reduce_scatter(self, comm, values, counts, op):
        op = op_lookup(op)
        n = comm.size
        if len(values) != n:
            raise ArgumentError(
                f"need one buffer per rank ({n}), got {len(values)}")
        if len(counts) != n:
            raise ArgumentError(f"need {n} counts, got {len(counts)}")
        total = sum(counts)
        for v in values:
            if torch.as_tensor(v).shape[0] != total:
                raise ArgumentError(
                    f"buffer rows {torch.as_tensor(v).shape[0]} != "
                    f"sum(counts) {total}")
        red = self.allreduce(comm, comm.from_rank_values(values), op)[0]
        out, start = [], 0
        for c in counts:
            out.append(red[start:start + c])
            start += c
        return out
