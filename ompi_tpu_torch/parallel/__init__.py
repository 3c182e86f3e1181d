"""Parallelism strategies built on the collective substrate (part of the
port of ``ompi_tpu/parallel``).

Ported so far: ``sp``, sequence/context parallelism (ring attention over
the rank axis of rank-major tensors).
"""

from . import sp

__all__ = ["sp"]
