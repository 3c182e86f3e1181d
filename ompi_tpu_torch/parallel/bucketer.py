"""parallel/bucketer — gradient bucket coalescing for data parallelism.

Port of ``ompi_tpu/parallel/bucketer.py``. A step produces many
gradient leaves, and per-call dispatch overhead dominates small
collectives, so the coalescer flattens the gradient pytree into a few
size-capped flat buckets (cvar ``parallel_dp_bucket_bytes``) and issues
ONE allreduce per bucket: the whole decision stack — tuned's algorithm
table, the hand-written kernels, the quantized wire — schedules per
bucket, at bucket size (torch's DDP gradient buckets are the mainstream
analog).

Determinism and ordering: bucket composition is a pure function of
(pytree structure, leaf shapes/dtypes, bucket_bytes). Leaves are taken
in ``jax.tree`` flatten order (``core.tree``: dicts by sorted key),
grouped by dtype (groups in the order of their JAX names, each keeping
its leaves' order), concatenated, and cut at element boundaries. Values
are bit-identical to per-leaf dispatch for the exact tiers: an
elementwise reduction of a concatenation is the concatenation of the
reductions.

Both entry points take rank-major ``(n, ...)`` leaves (the JAX
package's :func:`allreduce_tree` runs inside ``shard_map`` on per-rank
leaves over an axis name):

* :func:`allreduce_tree` — one ``coll.tuned.allreduce_by_decision`` per
  bucket, no communicator;
* :func:`allreduce_pytree` — one ``comm.allreduce`` per bucket through
  the comm vtable, with optional error feedback.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..coll.sched.cache import dtype_name
from ..core import config
from ..core import tree as _tree
from ..core.counters import SPC
from ..part.persist import torch_dtype

_bucket_bytes_var = config.register(
    "parallel", "dp", "bucket_bytes",
    type=int, default=4 << 20,
    description="Max bytes per fused gradient-allreduce bucket "
                "(0 disables fusion: one dispatch per leaf)",
)

SPC.counter(
    "parallel_dp_bucket_dispatches",
    "fused gradient buckets dispatched (one collective each)",
)
SPC.counter(
    "parallel_dp_bucket_leaves",
    "gradient leaves coalesced into buckets",
)


class Bucket(NamedTuple):
    """One planned bucket: ``pieces`` index the flattened pytree;
    ``elems`` is the flat element count of the bucket's payload."""
    dtype: Any
    elems: int
    #: (leaf_id, lo, hi): leaf's flat slice [lo, hi) lives in this
    #: bucket at the running offset (a leaf larger than the cap spans
    #: consecutive buckets).
    pieces: tuple


def _dtype_size(leaf) -> tuple[torch.dtype, int]:
    """(dtype, element count) of a leaf (a tensor, a numpy array, a
    ``meta`` tensor, a scalar)."""
    if hasattr(leaf, "dtype") and hasattr(leaf, "shape"):
        return torch_dtype(leaf.dtype), int(np.prod(tuple(leaf.shape),
                                                    dtype=np.int64))
    t = torch.as_tensor(leaf)
    return t.dtype, int(t.numel())


def plan_buckets(tree: Any, bucket_bytes: Optional[int] = None
                 ) -> list[Bucket]:
    """Deterministic bucket plan for a pytree (shapes only, no data).
    The plan length IS the collective-dispatch count of a fused
    allreduce of ``tree``."""
    if bucket_bytes is None:
        bucket_bytes = _bucket_bytes_var.value
    leaves = _tree.leaves(tree)
    groups: dict = {}
    sizes = []
    for i, leaf in enumerate(leaves):
        dt, size = _dtype_size(leaf)
        sizes.append(size)
        groups.setdefault(dtype_name(dt), (dt, []))[1].append(i)
    plans: list[Bucket] = []
    for _, (dt, ids) in sorted(groups.items()):
        fused = bucket_bytes > 0
        cap = max(1, bucket_bytes // dt.itemsize) if fused else 0
        pieces: list = []
        elems = 0
        for i in ids:
            size = sizes[i]
            lo = 0
            while lo < size or size == 0:
                take = min(size - lo, cap - elems) if fused else size
                pieces.append((i, lo, lo + take))
                elems += take
                lo += take
                if fused and elems >= cap:
                    plans.append(Bucket(dt, elems, tuple(pieces)))
                    pieces, elems = [], 0
                if size == 0:
                    break
            if not fused and pieces:
                # Fusion disabled: one bucket (dispatch) per leaf.
                plans.append(Bucket(dt, elems, tuple(pieces)))
                pieces, elems = [], 0
        if pieces:
            plans.append(Bucket(dt, elems, tuple(pieces)))
    return plans


def gather_bucket(leaves: list, bucket: Bucket) -> torch.Tensor:
    """The ``(n, elems)`` payload of one bucket from rank-major leaves."""
    n = leaves[bucket.pieces[0][0]].shape[0]
    parts = [leaves[i].reshape(n, -1)[:, lo:hi]
             for i, lo, hi in bucket.pieces]
    return parts[0].contiguous() if len(parts) == 1 else torch.cat(parts, 1)


def reassemble(leaves: list, plan: list, reduced: list) -> list:
    """Rank-major leaves of the reduced buckets, shaped as ``leaves``."""
    out_flat: dict = {}
    for bucket, red in zip(plan, reduced):
        off = 0
        for i, lo, hi in bucket.pieces:
            out_flat.setdefault(i, []).append(red[:, off:off + (hi - lo)])
            off += hi - lo
    out = []
    for i, leaf in enumerate(leaves):
        if i not in out_flat:          # zero-size leaf: nothing moved
            out.append(leaf)
            continue
        parts = out_flat[i]
        flat = parts[0] if len(parts) == 1 else torch.cat(parts, 1)
        out.append(flat.reshape(leaf.shape))
    return out


def _rank_major_leaves(tree: Any, n: Optional[int], what: str):
    leaves, treedef = _tree.flatten(tree)
    leaves = [torch.as_tensor(leaf) for leaf in leaves]
    for leaf in leaves:
        if leaf.ndim < 1 or (n is not None and leaf.shape[0] != n):
            raise ValueError(
                f"{what} needs rank-major (size, ...) leaves, got shape "
                f"{tuple(leaf.shape)}")
    return leaves, treedef


def allreduce_tree(tree: Any, op: Any = "sum",
                   bucket_bytes: Optional[int] = None,
                   allow_quant: Optional[bool] = None) -> Any:
    """Fused allreduce of a pytree of rank-major ``(n, ...)`` gradient
    leaves: one collective per planned bucket, each routed through
    coll/tuned's decision (``allreduce_by_decision``), so the quant tier
    and the explicit algorithms apply per bucket."""
    from ..coll import tuned

    leaves, treedef = _rank_major_leaves(tree, None, "allreduce_tree")
    if not leaves:
        return tree
    plan = plan_buckets([leaf[0] for leaf in leaves], bucket_bytes)
    SPC.record("parallel_dp_bucket_leaves", len(leaves))
    reduced = []
    for bucket in plan:
        reduced.append(tuned.allreduce_by_decision(
            gather_bucket(leaves, bucket), op, allow_quant=allow_quant))
        SPC.record("parallel_dp_bucket_dispatches")
    return _tree.unflatten(treedef, reassemble(leaves, plan, reduced))


def allreduce_pytree(comm, tree: Any, op: Any = "sum",
                     bucket_bytes: Optional[int] = None,
                     error_feedback=None) -> Any:
    """Fused allreduce of a pytree of rank-major ``(size, ...)`` buffers
    through the comm VTABLE: one ``comm.allreduce`` per bucket, so
    component selection and the quant tier run per bucket.
    ``error_feedback`` is an optional dict used as a residual bank: one
    :class:`ompi_tpu_torch.coll.quant.ErrorFeedback` per bucket index,
    created on first use and carried across calls (pass the same dict
    every step)."""
    leaves, treedef = _rank_major_leaves(tree, comm.size,
                                         "allreduce_pytree")
    if not leaves:
        return tree
    leaves = [leaf if leaf.device == comm.device else leaf.to(comm.device)
              for leaf in leaves]
    # Plan over the per-rank payload (axis 0 is the rank axis).
    plan = plan_buckets([leaf[0] for leaf in leaves], bucket_bytes)
    SPC.record("parallel_dp_bucket_leaves", len(leaves))
    reduced = []
    for bi, bucket in enumerate(plan):
        payload = gather_bucket(leaves, bucket)
        if error_feedback is not None:
            from ..coll.quant import ErrorFeedback

            ef = error_feedback.setdefault(bi, ErrorFeedback())
            payload = ef.compensate(payload)
        reduced.append(comm.allreduce(payload, op))
        SPC.record("parallel_dp_bucket_dispatches")
    return _tree.unflatten(treedef, reassemble(leaves, plan, reduced))
