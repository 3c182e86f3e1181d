"""Error classes (the MPI error-class families as Python exceptions).

Port of ``ompi_tpu/core/errors.py``: the same class names and the same
``errclass`` strings, so a caller catching ``ArgumentError`` or
``CommError`` sees one surface in both packages, and the same
per-object errhandler model (``HasErrhandler``: ERRORS_ARE_FATAL /
ERRORS_RETURN / a user callback). ``KernelError`` is the port's own: a
hand-written CUDA kernel that does not build or does not launch raises
it, and nothing falls back.
"""

from __future__ import annotations

from typing import Callable, Optional


class OmpiTpuError(Exception):
    """Base class for all framework errors (MPI_ERR_* family)."""

    errclass = "ERR_OTHER"


class ComponentError(OmpiTpuError):
    errclass = "ERR_INTERN"


class ArgumentError(OmpiTpuError, ValueError):
    errclass = "ERR_ARG"


class DatatypeError(OmpiTpuError):
    errclass = "ERR_TYPE"


class TruncationError(OmpiTpuError):
    """Receive buffer too small (MPI_ERR_TRUNCATE)."""

    errclass = "ERR_TRUNCATE"


class CommError(OmpiTpuError):
    errclass = "ERR_COMM"


class GroupError(OmpiTpuError):
    errclass = "ERR_GROUP"


class RankError(OmpiTpuError):
    errclass = "ERR_RANK"


class TagError(OmpiTpuError):
    errclass = "ERR_TAG"


class OpError(OmpiTpuError):
    errclass = "ERR_OP"


class RequestError(OmpiTpuError):
    errclass = "ERR_REQUEST"


class TopologyError(OmpiTpuError):
    errclass = "ERR_TOPOLOGY"


class NotInitializedError(OmpiTpuError):
    errclass = "ERR_OTHER"


class KernelError(OmpiTpuError):
    """A CUDA kernel failed to build or to launch, or the device cannot
    run it (no sm_90 card, no nvcc)."""

    errclass = "ERR_INTERN"


# -- errhandlers ---------------------------------------------------------

ErrhandlerFn = Callable[[object, BaseException], None]


def errors_are_fatal(obj: object, exc: BaseException) -> None:
    """Default handler: abort the process (MPI_ERRORS_ARE_FATAL)."""
    raise SystemExit(f"[ompi_tpu_torch] fatal error on {obj!r}: {exc}")


def errors_return(obj: object, exc: BaseException) -> None:
    """MPI_ERRORS_RETURN: propagate to caller as exception (Pythonic)."""
    raise exc


class Errhandler:
    def __init__(self, fn: ErrhandlerFn, name: str = "user") -> None:
        self.fn = fn
        self.name = name

    def __call__(self, obj: object, exc: BaseException) -> None:
        self.fn(obj, exc)


ERRORS_ARE_FATAL = Errhandler(errors_are_fatal, "ERRORS_ARE_FATAL")
ERRORS_RETURN = Errhandler(errors_return, "ERRORS_RETURN")


class HasErrhandler:
    """Mixin giving objects a settable errhandler (comm/win/file)."""

    _errhandler: Optional[Errhandler] = None

    def get_errhandler(self) -> Errhandler:
        return self._errhandler or ERRORS_RETURN

    def set_errhandler(self, handler: Errhandler) -> None:
        self._errhandler = handler

    def _invoke_errhandler(self, exc: BaseException) -> None:
        self.get_errhandler()(self, exc)
