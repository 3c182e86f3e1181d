"""Tensor parallelism: Megatron-style column/row sharded matmuls with
sequence-parallel transitions (port of ``ompi_tpu/parallel/tp.py``).

SURVEY §2.6 TP row — allgather / reduce_scatter / alltoall algorithms
(reference: coll_base_{allgather,reduce_scatter,alltoall}.c) as the
building blocks of sharded matmul layers:

- activations travel sequence-sharded between blocks (each tp rank holds
  S/ntp tokens — "sequence parallel" regions);
- entering a TP region: allgather tokens over tp → full sequence;
- column-parallel W1 then row-parallel W2 produce partial sums;
- leaving: reduce_scatter sums the partials AND re-shards the sequence
  in one fused collective (the Megatron-SP identity:
  allreduce = allgather ∘ reduce_scatter, split across the region).

Every tensor is rank-major: its leading axis is the rank, and ``axis``
(a :class:`~ompi_tpu_torch.parallel.mesh_utils.Axis`) names the mesh
axis the collectives run over (default: the whole rank axis).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..coll import spmd
from ..ops import SUM
from .mesh_utils import Axis, rank_axis


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-rank ``x @ w`` of rank-major (n, ..., K) x and (n, K, M) w:
    one batched product over the ranks, x's middle axes folded into its
    rows (the weight is never broadcast into copies)."""
    n, k = x.shape[0], x.shape[-1]
    out = torch.bmm(x.reshape(n, -1, k), w)
    return out.reshape(tuple(x.shape[:-1]) + (w.shape[-1],))


def allgather_sequence(x: torch.Tensor, axis: Optional[Axis] = None
                       ) -> torch.Tensor:
    """(n, S/k, D) -> (n, S, D): gather the sequence shards."""
    gathered = rank_axis(x, axis).apply(spmd.allgather_native, x, 0, 1)
    return gathered.reshape((x.shape[0], -1) + tuple(x.shape[2:]))


def reduce_scatter_sequence(x: torch.Tensor, axis: Optional[Axis] = None
                            ) -> torch.Tensor:
    """(n, S, D) partial sums -> (n, S/k, D): sum partials across the
    axis' ranks and keep this rank's sequence shard."""
    ax = rank_axis(x, axis)
    blocked = x.reshape((x.shape[0], ax.size, -1) + tuple(x.shape[2:]))
    return ax.apply(lambda b: spmd.reduce_scatter_native(b, SUM), blocked,
                    1, 0)


def column_parallel(x: torch.Tensor, w: torch.Tensor,
                    axis: Optional[Axis] = None) -> torch.Tensor:
    """x @ w with w column-sharded: each rank computes its feature slice.
    Input must be full (allgathered); output is feature-sharded."""
    return matmul(x, w)


def row_parallel(x: torch.Tensor, w: torch.Tensor,
                 axis: Optional[Axis] = None) -> torch.Tensor:
    """x @ w with w row-sharded: input is feature-sharded; output is a
    partial sum awaiting reduce(_scatter)."""
    return matmul(x, w)


def tp_mlp(x_seq_sharded: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
           axis: Optional[Axis] = None, activation=gelu) -> torch.Tensor:
    """Full Megatron-SP MLP: allgather -> col-parallel -> act ->
    row-parallel -> reduce_scatter. In: (n, S/k, D), w1 (n, D, F/k)
    column shards, w2 (n, F/k, D) row shards. Out: (n, S/k, D)."""
    full = allgather_sequence(x_seq_sharded, axis)  # (n, S, D)
    h = activation(column_parallel(full, w1, axis))  # (n, S, F/k)
    partial = row_parallel(h, w2, axis)  # (n, S, D) partial
    return reduce_scatter_sequence(partial, axis)  # (n, S/k, D)
