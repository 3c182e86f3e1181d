"""Memchecker — buffer definedness guards at API boundaries.

Port of ``ompi_tpu/core/memchecker.py`` (reference:
opal/mca/memchecker/valgrind — MEMCHECKER(...) blocks at every MPI
entry assert user buffers are defined/addressable, and mark recv
buffers undefined until completion; ompi/mpi/c/allreduce.c:53-66,
ompi/memchecker.h). There is no valgrind client on the tensor path;
the analogs are:

- **definedness**: float inputs (tensors and numpy arrays) are checked
  for NaN/Inf at API entry;
- **undefined-until-complete**: buffers returned by in-flight
  nonblocking ops are registered here; touching them through
  ``assert_accessible`` before completion raises.

All checks are gated by ``memchecker_base_enable`` and free when off.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np
import torch

from . import config
from .counters import SPC
from .errors import OmpiTpuError
from .tree import leaves

_enable = config.register(
    "memchecker", "base", "enable", type=bool, default=False,
    description="Buffer definedness checks at API entries",
)


class MemcheckError(OmpiTpuError):
    errclass = "ERR_BUFFER"


def enabled() -> bool:
    return _enable.value


_undefined: dict[int, str] = {}  # id(buffer) -> why
_lock = threading.Lock()


def _all_finite(leaf: Any) -> bool:
    if isinstance(leaf, torch.Tensor):
        return not leaf.is_floating_point() or bool(
            torch.isfinite(leaf).all())
    arr = np.asarray(leaf)
    return not np.issubdtype(arr.dtype, np.floating) or bool(
        np.isfinite(arr).all())


def check_defined(x: Any, what: str = "buffer") -> None:
    """API-entry guard: reject NaN/Inf float inputs (the reference's
    'reading uninitialized memory' class of bug)."""
    if not _enable.value:
        return
    for leaf in leaves(x):
        if not _all_finite(leaf):
            SPC.record("memchecker_violations")
            raise MemcheckError(
                f"{what} contains NaN/Inf (undefined contents)"
            )


def mark_undefined(buf: Any, why: str) -> None:
    """Recv-side: contents are undefined until the request completes."""
    if not _enable.value:
        return
    with _lock:
        for leaf in leaves(buf):
            _undefined[id(leaf)] = why


def mark_defined(buf: Any) -> None:
    if not _enable.value:
        return
    with _lock:
        for leaf in leaves(buf):
            _undefined.pop(id(leaf), None)


def assert_accessible(buf: Any, what: str = "buffer") -> None:
    """Raise if ``buf`` is currently marked undefined (pending recv)."""
    if not _enable.value:
        return
    with _lock:
        for leaf in leaves(buf):
            why = _undefined.get(id(leaf))
            if why is not None:
                SPC.record("memchecker_violations")
                raise MemcheckError(
                    f"{what} read while undefined: {why}"
                )


def leak_report(what: str) -> MemcheckError:
    """Request-leak reporting channel: a leaked nonblocking request is
    exactly a buffer that stays undefined forever, so leaks count as
    memchecker violations and surface through the same error class."""
    SPC.record("memchecker_violations")
    return MemcheckError(what)


def reset() -> None:
    with _lock:
        _undefined.clear()
