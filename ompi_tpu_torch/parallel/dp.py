"""Data parallelism: gradient reduction over the rank axis.

Port of ``ompi_tpu/parallel/dp.py`` (SURVEY §2.6 DP row — the allreduce
family applied to gradient pytrees). The pytree is flattened into
size-capped flat buckets (``parallel.bucketer``, cvar
``parallel_dp_bucket_bytes``) with ONE collective per bucket routed
through coll/tuned's decision, so algorithm choice and the quantized
wire apply per bucket. The JAX package's functions run inside
``shard_map`` over an axis name on per-rank arrays; these take
rank-major ``(n, ...)`` leaves.
"""

from __future__ import annotations

from typing import Any

import torch

from ..core import tree as _tree
from ..ops import SUM
from . import bucketer
from . import overlap as _overlap


def allreduce_gradients(grads: Any) -> Any:
    """Mean-free allreduce (sum) of a pytree of rank-major gradients,
    fused into size-capped buckets (one collective per bucket). The
    readiness schedule is captured first, so host-side overlap sessions
    can replay production tile by tile in true backward order."""
    grads = _overlap.capture_ready_schedule(grads)
    return bucketer.allreduce_tree(grads, SUM)


def mean_gradients(grads: Any) -> Any:
    """Allreduce-mean of rank-major gradients (the usual DP update
    input)."""
    leaves = _tree.leaves(grads)
    if not leaves:
        return grads
    n = torch.as_tensor(leaves[0]).shape[0]
    summed = allreduce_gradients(grads)
    return _tree.map_leaves(lambda g: g / n, summed)


def window_session(comm, template: Any, *, window: int = 2,
                   **kwargs) -> "_overlap.DpOverlapSession":
    """A slipstream window session over ``template``'s gradient
    structure: a :class:`~ompi_tpu_torch.parallel.overlap.DpOverlapSession`
    whose compiled step program pipelines across the step boundary
    (``window >= 2``). Drive it with ``begin_step()/mark_ready()/step()``
    per training step and ``flush()`` at window close. Keyword arguments
    pass through to the session constructor."""
    return _overlap.DpOverlapSession(
        comm, template, window=window, **kwargs)


def shard_batch(batch: Any, n: int) -> Any:
    """Split each leaf of a replicated batch into the rank-major ``(n,
    per, ...)`` shards the dp ranks hold: rank r gets rows ``[r*per,
    (r+1)*per)`` (the JAX package's dynamic slice at ``axis_index``)."""
    def slc(x):
        x = torch.as_tensor(x)
        per = x.shape[0] // n
        return x[: n * per].reshape((n, per) + tuple(x.shape[1:]))

    return _tree.map_leaves(slc, batch)
