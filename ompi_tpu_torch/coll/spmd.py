"""Native collectives over the rank axis (part of the port of
``ompi_tpu/coll/spmd.py``).

The JAX package writes each algorithm inside ``shard_map`` over a named
mesh axis. In the port an algorithm receives the whole rank-major
``(n, ...)`` tensor and returns the rank-major result. This slice ports
the native allreduce, bcast, reduce, allgather and reduce-scatter, and
the rank-ordered gather-reduce that the non-commutative guard routes
to.
"""

from __future__ import annotations

from typing import Any

import torch

from ..ops import Op


def _broadcast_ranks(red: torch.Tensor, n: int) -> torch.Tensor:
    return red.unsqueeze(0).expand((n,) + tuple(red.shape)).contiguous()


def _reduce_ranks(x: torch.Tensor, op: Op) -> torch.Tensor:
    """x reduced over its leading rank axis: PyTorch's own reduction
    where the op has one (SUM/MAX/MIN), else the rank-ordered tree."""
    if op.native_reduce is None:
        return _tree_reduce_ranks(x, x.shape[0], op)
    if op.native_reduce == "sum":
        return torch.sum(x, 0, dtype=x.dtype)
    return getattr(torch, op.native_reduce)(x, 0)


def allreduce_native(x: torch.Tensor, op: Op) -> torch.Tensor:
    """PyTorch's own reduction over the rank axis where the op has one
    (SUM/MAX/MIN), else the rank-ordered gather-reduce. The JAX package
    leaves this to XLA's psum/pmax/pmin; its summation order is XLA's,
    and this one is PyTorch's."""
    if op.native_reduce is None:
        return _allreduce_gather_reduce(x, op)  # tensor or joint pair
    return _broadcast_ranks(_reduce_ranks(x, op), x.shape[0])


def bcast_native(x: Any, root: int = 0) -> Any:
    """Every rank gets root's row (of each leaf). The JAX package masks
    the other ranks to zero and sums, so a root ``-0.0`` arrives there as
    ``+0.0``; here root's row is copied as it is."""
    if isinstance(x, (tuple, list)):
        return type(x)(bcast_native(leaf, root) for leaf in x)
    return _broadcast_ranks(x[root], x.shape[0])


def reduce_native(x: torch.Tensor, op: Op, root: int = 0) -> torch.Tensor:
    """Reduce via the native allreduce (every rank computes; root
    reads)."""
    del root
    return allreduce_native(x, op)


def allgather_native(x: torch.Tensor) -> torch.Tensor:
    """(n, ...) -> (n, n, ...): every rank gets every rank's block."""
    return _broadcast_ranks(x, x.shape[0])


def reduce_scatter_native(x: torch.Tensor, op: Op) -> torch.Tensor:
    """(n, n, ...) -> (n, ...): rank r gets block r reduced over the
    ranks, by the same reduction as ``allreduce_native``."""
    return _reduce_ranks(x, op)


def _allreduce_gather_reduce(x: Any, op: Op) -> Any:
    """Gather every rank's block, then a rank-order-preserving tree
    reduce (valid for non-commutative and joint ops)."""
    if isinstance(x, (tuple, list)):
        n = x[0].shape[0]
        red = _tree_reduce_ranks(x, n, op)
        return type(x)(_broadcast_ranks(r, n) for r in red)
    n = x.shape[0]
    return _broadcast_ranks(_tree_reduce_ranks(x, n, op), n)


def _tree_reduce_ranks(gathered: Any, n: int, op: Op) -> Any:
    """Reduce a leading rank axis with a balanced tree that preserves
    rank order: pairs (0,1), (2,3), ... then pairs of pairs."""
    if isinstance(gathered, (tuple, list)):
        parts = [type(gathered)(g[i] for g in gathered) for i in range(n)]
    else:
        parts = [gathered[i] for i in range(n)]
    while len(parts) > 1:
        nxt = [op.combine(parts[i], parts[i + 1])
               for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]
