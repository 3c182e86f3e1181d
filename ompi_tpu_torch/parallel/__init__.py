"""Parallelism strategies built on the collective substrate (part of the
port of ``ompi_tpu/parallel``).

Ported so far: ``sp``, sequence/context parallelism (ring attention over
the rank axis of rank-major tensors), and data parallelism: ``bucketer``
(gradient buckets, one allreduce each), ``overlap`` (the tile-granular
DP overlap session over a compiled step program) and ``dp``.
"""

from . import bucketer, dp, overlap, sp

__all__ = ["bucketer", "dp", "overlap", "sp"]
