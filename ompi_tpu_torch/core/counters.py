"""Software performance counters and per-kernel launch counters.

``SPC`` is the minimal port of ``ompi_tpu/core/counters.py``'s scalar
counters: event counters (``SPC.record(name)`` at each dispatch) and
gauges that are set (``SPC.set(name, v)``, e.g. the quantized wire's
last compression ratio). ``KernelCounter`` is
the port's own: every hand-written CUDA kernel's wrapper owns one and
adds one to it at the single place where it launches the kernel, so a
run can show that the main path went through the kernel.
"""

from __future__ import annotations

import threading
from typing import Optional


class SpcRegistry:
    """Process-local named counters (MPI_T pvars): event counts and
    gauges that are set."""

    def __init__(self) -> None:
        self._counts: dict[str, float] = {}
        self._lock = threading.Lock()

    def record(self, name: str, amount: float = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + amount

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self._counts[name] = value

    def read(self, name: str) -> float:
        with self._lock:
            return self._counts.get(name, 0)


SPC = SpcRegistry()


class KernelCounter:
    """Launch count of one CUDA kernel, plus the semaphore scratch of its
    last launch (read back to check that every flag ended at 0) and, for
    wrappers that plan their grid, that launch's plan (a dict: blocks,
    threads, segments, as the wrapper chose them)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.launches = 0
        self.last_sems: Optional[object] = None
        self.last_plan: Optional[dict] = None
        KERNELS[name] = self

    def launched(self, sems, plan: Optional[dict] = None) -> None:
        self.launches += 1
        self.last_sems = sems
        self.last_plan = plan


#: name -> counter of every kernel wrapper that has been imported.
KERNELS: dict[str, KernelCounter] = {}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for counter in KERNELS.values():
        counter.launches = 0


def launches() -> dict[str, int]:
    return {name: c.launches for name, c in KERNELS.items()}
