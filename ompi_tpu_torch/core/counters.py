"""Software performance counters (SPC), the performance-variable
registry, and per-kernel launch counters.

Port of ``ompi_tpu/core/counters.py`` (reference: ompi/runtime/
ompi_spc.h:55- per-op counters, SPC_RECORD at each API entry; the MPI_T
pvar registry of opal/mca/base/mca_base_pvar.c): ``Counter``,
``Histogram`` (log2-bucketed latencies with ``percentile``,
``snapshot`` and ``cumulative_buckets``), ``CounterRegistry`` (``counter``,
``record``, ``hwm``, ``timer``, ``histogram``, ``record_latency``,
``record_ns``, ``dump``, ``reset``), ``PvarSession`` (snapshot at start,
diff on read) and ``pvar_class_of``. ``SPC.read(name)`` and
``SPC.set(name, v)`` are the port's shorthands for a counter's value and
a gauge that is set.

``KernelCounter`` is the port's own: every hand-written CUDA kernel's
wrapper owns one and adds one to it at the single place where it
launches the kernel, so a run can show that the main path went through
the kernel.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Iterator, Optional

#: MPI_T pvar classes (reference: mca_base_pvar.h MCA_BASE_PVAR_CLASS_*).
#: Scalar counters carry their class in the unit field; histograms are
#: their own class.
PVAR_COUNTER = "counter"
PVAR_WATERMARK = "watermark"
PVAR_TIMER = "timer"
PVAR_HISTOGRAM = "histogram"

#: unit -> scalar pvar class (hwm() registers unit="max", timer()
#: registers unit="seconds"; everything else is an event counter).
_UNIT_CLASS = {"max": PVAR_WATERMARK, "seconds": PVAR_TIMER}


def pvar_class_of(unit: str) -> str:
    """The MPI_T class tag for a scalar counter's unit."""
    return _UNIT_CLASS.get(unit, PVAR_COUNTER)


class Counter:
    __slots__ = ("name", "description", "unit", "value", "_lock")

    def __init__(self, name: str, description: str = "", unit: str = "count"):
        self.name = name
        self.description = description
        self.unit = unit
        self.value: float = 0
        self._lock = threading.Lock()

    def add(self, amount: float = 1) -> None:
        with self._lock:
            self.value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self.value = value

    def read(self) -> float:
        return self.value


class Histogram:
    """Log-bucketed latency histogram (the histogram pvar class). Bucket
    ``b`` counts samples whose duration in nanoseconds falls in
    ``[2^b, 2^(b+1))``; 64 buckets span 1 ns to ~584 years with ~2x
    resolution. Percentiles interpolate linearly inside the winning
    bucket."""

    __slots__ = ("name", "description", "unit", "counts", "count",
                 "total", "min", "max", "_lock")

    NBUCKETS = 64

    def __init__(self, name: str, description: str = "",
                 unit: str = "seconds"):
        self.name = name
        self.description = description
        self.unit = unit
        self.counts = [0] * self.NBUCKETS
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        self.record_ns(int(seconds * 1e9))

    def record_ns(self, ns: int) -> None:
        if ns < 1:
            ns = 1
        b = min(ns.bit_length() - 1, self.NBUCKETS - 1)
        s = ns * 1e-9
        with self._lock:
            self.counts[b] += 1
            self.count += 1
            self.total += s
            if s < self.min:
                self.min = s
            if s > self.max:
                self.max = s

    def percentile(self, q: float) -> float:
        """Approximate q-quantile in seconds (0 when empty)."""
        with self._lock:
            if self.count == 0:
                return 0.0
            target = q * self.count
            seen = 0.0
            for b, n in enumerate(self.counts):
                if n == 0:
                    continue
                if seen + n >= target:
                    frac = (target - seen) / n
                    lo = float(1 << b)
                    return (lo + frac * lo) * 1e-9  # within [2^b, 2^(b+1))
                seen += n
            return self.max

    def snapshot(self) -> dict[str, float]:
        p50 = self.percentile(0.50)
        p99 = self.percentile(0.99)
        with self._lock:
            n = self.count
            return {
                "count": n,
                "mean": self.total / n if n else 0.0,
                "min": self.min if n else 0.0,
                "max": self.max,
                "p50": p50,
                "p99": p99,
            }

    def cumulative_buckets(self) -> list[tuple[float, int]]:
        """(upper_bound_seconds, cumulative_count) per occupied prefix
        of the bucket array (the Prometheus exposition shape: bucket
        ``b``'s bound is 2^(b+1) ns; trailing empty buckets dropped)."""
        with self._lock:
            counts = list(self.counts)
            total = self.count
        out: list[tuple[float, int]] = []
        seen = 0
        for b, n in enumerate(counts):
            seen += n
            out.append((float(1 << (b + 1)) * 1e-9, seen))
            if seen >= total:
                break
        return out


class CounterRegistry:
    """Process-local named counters and histograms (MPI_T pvars)."""

    def __init__(self) -> None:
        self._counters: dict[str, Counter] = {}
        self._histograms: dict[str, Histogram] = {}
        self._lock = threading.Lock()
        self.enabled = True

    def counter(self, name: str, description: str = "",
                unit: str = "count") -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = Counter(name, description, unit)
                self._counters[name] = c
            return c

    def record(self, name: str, amount: float = 1) -> None:
        # dict.get is atomic under the GIL; a racing first registration
        # falls through to the locked counter() path.
        if self.enabled:
            c = self._counters.get(name)
            if c is None:
                c = self.counter(name)
            c.add(amount)

    def set(self, name: str, value: float) -> None:
        """A gauge: the counter's value becomes ``value``."""
        if self.enabled:
            self.counter(name).set(value)

    def read(self, name: str) -> float:
        """A counter's value (0 for one never registered)."""
        c = self._counters.get(name)
        return 0 if c is None else c.value

    def hwm(self, name: str, value: float) -> None:
        """High-watermark counter: keeps the max ever observed."""
        if not self.enabled:
            return
        c = self.counter(name, unit="max")
        with c._lock:
            if value > c.value:
                c.value = value

    @contextmanager
    def timer(self, name: str) -> Iterator[None]:
        """Accumulate wall seconds into ``<name>_seconds``."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.counter(f"{name}_seconds", unit="seconds").add(
                time.perf_counter() - t0)

    def histogram(self, name: str, description: str = "",
                  unit: str = "seconds") -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = Histogram(name, description, unit)
                self._histograms[name] = h
            return h

    def record_latency(self, name: str, seconds: float) -> None:
        if self.enabled:
            h = self._histograms.get(name)
            if h is None:
                h = self.histogram(name)
            h.record(seconds)

    def record_ns(self, name: str, ns: int) -> None:
        """``record_latency`` for a duration already in nanoseconds."""
        if self.enabled:
            h = self._histograms.get(name)
            if h is None:
                h = self.histogram(name)
            h.record_ns(int(ns))

    def histogram_snapshots(self) -> dict[str, dict[str, float]]:
        with self._lock:
            hists = list(self._histograms.values())
        return {h.name: h.snapshot()
                for h in sorted(hists, key=lambda h: h.name)}

    def get_histogram(self, name: str) -> Optional[Histogram]:
        return self._histograms.get(name)

    def histogram_dump(self) -> list[dict]:
        with self._lock:
            hists = sorted(self._histograms.values(), key=lambda h: h.name)
        return [{"name": h.name, "unit": h.unit,
                 "description": h.description, "snapshot": h.snapshot()}
                for h in hists]

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return {n: c.value for n, c in self._counters.items()}

    def dump(self) -> list[dict]:
        with self._lock:
            return [{"name": c.name, "value": c.value, "unit": c.unit,
                     "description": c.description}
                    for c in sorted(self._counters.values(),
                                    key=lambda c: c.name)]

    def reset(self) -> None:
        """Drop every counter and histogram."""
        with self._lock:
            self._counters.clear()
            self._histograms.clear()


SPC = CounterRegistry()


class PvarSession:
    """MPI_T-style session: snapshot at start, diff on read. ``read()``
    is the scalar-counter delta; ``read_histograms()`` the per-histogram
    sample-count delta with the current percentile estimates."""

    def __init__(self, registry: CounterRegistry = SPC) -> None:
        self._registry = registry
        self._base = registry.snapshot()
        self._base_hist = registry.histogram_snapshots()

    def read(self) -> dict[str, float]:
        now = self._registry.snapshot()
        return {k: v - self._base.get(k, 0) for k, v in now.items()
                if v != self._base.get(k, 0)}

    def read_histograms(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, snap in self._registry.histogram_snapshots().items():
            base = self._base_hist.get(name, {})
            delta = snap["count"] - base.get("count", 0)
            if delta:
                out[name] = dict(snap, count=delta)
        return out

    def reset(self) -> None:
        self._base = self._registry.snapshot()
        self._base_hist = self._registry.histogram_snapshots()


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
