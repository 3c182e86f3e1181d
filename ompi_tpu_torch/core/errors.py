"""Error classes (the MPI error-class families as Python exceptions).

Port of ``ompi_tpu/core/errors.py``: the same class names and the same
``errclass`` strings, so a caller catching ``ArgumentError`` or
``CommError`` sees one surface in both packages. ``KernelError`` is the
port's own: a hand-written CUDA kernel that does not build or does not
launch raises it, and nothing falls back.
"""

from __future__ import annotations


class OmpiTpuError(Exception):
    """Base class for all framework errors (MPI_ERR_* family)."""

    errclass = "ERR_OTHER"


class ComponentError(OmpiTpuError):
    errclass = "ERR_INTERN"


class ArgumentError(OmpiTpuError, ValueError):
    errclass = "ERR_ARG"


class CommError(OmpiTpuError):
    errclass = "ERR_COMM"


class GroupError(OmpiTpuError):
    errclass = "ERR_GROUP"


class RankError(OmpiTpuError):
    errclass = "ERR_RANK"


class OpError(OmpiTpuError):
    errclass = "ERR_OP"


class NotInitializedError(OmpiTpuError):
    errclass = "ERR_OTHER"


class KernelError(OmpiTpuError):
    """A CUDA kernel failed to build or to launch, or the device cannot
    run it (no sm_90 card, no nvcc)."""

    errclass = "ERR_INTERN"
