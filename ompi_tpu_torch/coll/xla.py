"""coll/xla — the native collective component (port of
``ompi_tpu/coll/xla.py``).

It keeps the component name ``xla`` so selection vars
(``coll_xla_priority``, ``coll_select``) mean the same thing in both
packages. Its collectives are PyTorch's own operations over the rank
axis (``spmd.*_native``): the JAX package leaves this path to XLA and
has no Pallas kernel on it.
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
