"""On-device reduction helpers — the execution engine behind the op
framework.

Port of ``ompi_tpu/ops/device.py`` (reference:
ompi/mca/op/avx/op_avx_functions.c:28-66, the per-(op x dtype) SIMD
loops). Here the loops are PyTorch's elementwise and reduction kernels
on the tensor's own device.
"""

from __future__ import annotations

from typing import Any

from .op import Op, lookup


def reduce_local(op: "Op | str", inbuf: Any, inoutbuf: Any) -> Any:
    """MPI_Reduce_local: combine two buffers on their device
    (reference: ompi/op + test/datatype/reduce_local.c)."""
    op = lookup(op)
    return op.combine(inoutbuf, inbuf)


def reduce_ranks(x, op: "Op | str"):
    """Reduce a (n_ranks, ...) stacked buffer down its leading axis with
    the op's combine: PyTorch's sum for SUM (the JAX package's
    ``jnp.sum``), else the rank-order-preserving tree fold the
    collectives execute."""
    op = lookup(op)
    if op.native_reduce == "sum":
        return x.sum(0, dtype=x.dtype)
    from ..coll.spmd import _tree_reduce_ranks  # lazy: avoids cycle

    return _tree_reduce_ranks(x, x.shape[0], op)
