"""Cold-start priors: the static algorithm tables (port of
``ompi_tpu/coll/sched/priors.py``, allreduce only).

Every ``nbytes`` parameter is BYTES PER RANK (the block size of the
rank-major payload). The quantized-wire tier is not ported yet, so its
gate, which the JAX package checks first, is treated as off.
"""

from __future__ import annotations

from typing import Optional

from ...ops import Op


def prior_allreduce(op: Op, nbytes: int, nranks: int, dtype=None,
                    allow_quant: Optional[bool] = None) -> str:
    """Reference regime: recursive doubling < 10 KB/rank, ring to
    1 MiB/rank, segmented ring above — with the native preference ahead
    of all three."""
    from .. import tuned as t

    if t._prefer_native.value and op.native_reduce is not None:
        return "native"
    if nbytes < t._small.value:
        return "recursive_doubling"
    if nbytes <= t._ring_limit.value:
        return "ring"
    return "ring_segmented"
