"""The port's SPC registry against the JAX package's, on the CPU.

The same sequence of ``counter``/``record``/``hwm``/``timer``/
``histogram``/``record_latency``/``record_ns`` calls on a fresh
registry of each package gives equal ``snapshot``, ``dump``, pvar
classes, histogram ``percentile``/``snapshot``/``cumulative_buckets``
and ``histogram_dump``, and equal ``PvarSession`` deltas. The timer's
seconds are wall time, so only its name, unit and class are compared.
The port's shorthands ``read``/``set`` and the launch counters
(``KernelCounter``, ``launches``, ``reset_launches``) keep working.
"""

import numpy as np
import pytest

from ompi_tpu.core import counters as jc
from ompi_tpu_torch.core import counters as tc


def _drive(mod, seed):
    """One seeded call sequence on a fresh registry of ``mod``."""
    reg = mod.CounterRegistry()
    rng = np.random.default_rng(seed)
    sess = mod.PvarSession(reg)
    reg.counter("pml_isend_calls", "sends", "count")
    for i in range(40):
        k = int(rng.integers(0, 5))
        if k == 0:
            reg.record(f"ev{int(rng.integers(0, 4))}",
                       int(rng.integers(1, 9)))
        elif k == 1:
            reg.hwm("queue_depth_hwm", int(rng.integers(0, 1000)))
        elif k == 2:
            reg.record_latency("coll_latency",
                               float(rng.integers(1, 10**7)) * 1e-9)
        elif k == 3:
            reg.histogram("p2p_latency", "p2p", "seconds").record_ns(
                int(rng.integers(0, 10**9)))
        else:
            with reg.timer("sched_compile"):
                pass
    mid = mod.PvarSession(reg)
    reg.record("ev0", 3)
    reg.record_latency("coll_latency", 5e-6)
    return reg, sess, mid


def _scalar_view(reg, mod):
    dump = reg.dump()
    for d in dump:
        d["class"] = mod.pvar_class_of(d["unit"])
        if d["unit"] == "seconds":
            d["value"] = None  # wall time
    return dump


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_sequences_equal(seed):
    jreg, jsess, jmid = _drive(jc, seed)
    treg, tsess, tmid = _drive(tc, seed)
    assert _scalar_view(treg, tc) == _scalar_view(jreg, jc)
    assert treg.histogram_snapshots() == jreg.histogram_snapshots()
    assert treg.histogram_dump() == jreg.histogram_dump()
    for name in ("coll_latency", "p2p_latency"):
        th, jh = treg.get_histogram(name), jreg.get_histogram(name)
        assert (th is None) == (jh is None)
        if th is None:
            continue
        for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
            assert th.percentile(q) == jh.percentile(q)
        assert th.snapshot() == jh.snapshot()
        assert th.cumulative_buckets() == jh.cumulative_buckets()
        assert th.counts == jh.counts
    strip = lambda d: {k: v for k, v in d.items()  # noqa: E731
                       if not k.endswith("_seconds")}
    assert strip(tsess.read()) == strip(jsess.read())
    assert tmid.read() == jmid.read() == {"ev0": 3}
    assert tmid.read_histograms() == jmid.read_histograms()
    assert tsess.read_histograms() == jsess.read_histograms()
    tmid.reset()
    jmid.reset()
    assert tmid.read() == jmid.read() == {}


def test_pvar_classes_and_empty_histogram():
    for unit in ("count", "max", "seconds", "bytes", "ms"):
        assert tc.pvar_class_of(unit) == jc.pvar_class_of(unit)
    assert (tc.PVAR_COUNTER, tc.PVAR_WATERMARK, tc.PVAR_TIMER,
            tc.PVAR_HISTOGRAM) == (jc.PVAR_COUNTER, jc.PVAR_WATERMARK,
                                   jc.PVAR_TIMER, jc.PVAR_HISTOGRAM)
    th, jh = tc.Histogram("h"), jc.Histogram("h")
    assert th.percentile(0.5) == jh.percentile(0.5) == 0.0
    assert th.snapshot() == jh.snapshot()
    assert th.cumulative_buckets() == jh.cumulative_buckets()
    for ns in (0, 1, 3, 1 << 62, (1 << 70)):
        th.record_ns(ns)
        jh.record_ns(ns)
    assert th.counts == jh.counts
    assert th.snapshot() == jh.snapshot()
    assert th.cumulative_buckets() == jh.cumulative_buckets()


def test_disabled_registry_and_reset():
    for mod in (tc, jc):
        reg = mod.CounterRegistry()
        reg.enabled = False
        reg.record("a")
        reg.hwm("b", 5)
        reg.record_latency("c", 1e-3)
        with reg.timer("d"):
            pass
        assert reg.snapshot() == {} and reg.histogram_snapshots() == {}
    reg = tc.CounterRegistry()
    reg.record("a", 2)
    reg.record_ns("h", 1000)
    reg.reset()
    assert reg.snapshot() == {} and reg.get_histogram("h") is None


def test_port_shorthands_and_launch_counters():
    reg = tc.CounterRegistry()
    assert reg.read("never") == 0
    assert "never" not in reg.snapshot()   # read() registers nothing
    reg.set("gauge", 2.5)
    reg.set("gauge", 1.5)
    assert reg.read("gauge") == 1.5
    reg.record("gauge", 1)
    assert reg.read("gauge") == 2.5
    k = tc.KernelCounter("test_counters_kernel")
    try:
        k.launched("sems", {"blocks": 3})
        assert tc.launches()["test_counters_kernel"] == 1
        assert k.last_plan == {"blocks": 3} and k.last_sems == "sems"
        tc.reset_launches()
        assert k.launches == 0
    finally:
        tc.KERNELS.pop("test_counters_kernel", None)
