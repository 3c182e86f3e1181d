"""Allreduce algorithms over the rank axis (part of the port of
``ompi_tpu/coll/spmd.py``).

The JAX package writes each algorithm inside ``shard_map`` over a named
mesh axis. In the port an algorithm receives the whole rank-major
``(n, ...)`` tensor and returns the rank-major result, every row equal.
This slice ports the native allreduce and the rank-ordered
gather-reduce that the non-commutative guard routes to.
"""

from __future__ import annotations

from typing import Any

import torch

from ..ops import Op


def _broadcast_ranks(red: torch.Tensor, n: int) -> torch.Tensor:
    return red.unsqueeze(0).expand((n,) + tuple(red.shape)).contiguous()


def allreduce_native(x: torch.Tensor, op: Op) -> torch.Tensor:
    """PyTorch's own reduction over the rank axis where the op has one
    (SUM/MAX/MIN), else the rank-ordered gather-reduce. The JAX package
    leaves this to XLA's psum/pmax/pmin; its summation order is XLA's,
    and this one is PyTorch's."""
    if op.native_reduce is None:
        return _allreduce_gather_reduce(x, op)
    if op.native_reduce == "sum":
        red = torch.sum(x, 0, dtype=x.dtype)
    else:
        red = getattr(torch, op.native_reduce)(x, 0)
    return _broadcast_ranks(red, x.shape[0])


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
