"""The port's partitioned communication (part/persist over ob1) against
the JAX package's, on the CPU (mirrors ``tests/test_part.py``).

- Every scenario of ``tests/test_part.py`` that runs over ob1 runs on a
  fresh ``dup`` of each package's world: the received values bitwise,
  the ``Parrived`` sequences, the statuses, the transfer counts, the
  exception classes and the ``part_*``/``pml_*`` SPC deltas are equal.
- ``api.Psend_init``/``Precv_init``/``Pready*``/``Parrived`` drive the
  same pair in both packages.
- A completion on one thread and an ``on_complete`` on another lose no
  callback, and a partitioned send whose transfers fire on one thread
  while another thread's progress matches them completes every cycle.
- The tree bcast's dtype gate: both packages' PallasColl ``comm.bcast``
  of uint8 and int8 rank-major buffers at n = 3 and 8, bitwise equal
  (the JAX package's kernel in interpret mode), and the port's wrapper
  takes every element size its plain version takes.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch
from ompi_tpu import api as japi
from ompi_tpu.coll import pallas_ring as jpallas
from ompi_tpu.core import config as jconfig
from ompi_tpu.core.counters import SPC as JSPC
from ompi_tpu.part import framework as jpart
from ompi_tpu_torch import api as tapi
from ompi_tpu_torch.coll import pallas_ring as tpallas
from ompi_tpu_torch.core import config as tconfig
from ompi_tpu_torch.core.counters import SPC as TSPC
from ompi_tpu_torch.core import request as trequest
from ompi_tpu_torch.core.errors import ArgumentError
from ompi_tpu_torch.part import framework as tpart
from ompi_tpu_torch.pml import ob1 as tob1

jpart.ensure_components()
tpart.ensure_components()

SPC_NAMES = (
    "part_partitions_flagged", "part_partitions_arrived",
    "part_transfers_sent", "part_transfers_received", "part_drain_sweeps",
    "part_psend_init_calls", "part_precv_init_calls",
    "part_overlap_window_coalesced_total",
    "pml_isend_calls", "pml_send_bytes", "pml_eager_sends",
    "pml_rndv_sends", "pml_irecv_calls",
)


class Side:
    def __init__(self, name, world, config, spc, api, wrap, host):
        self.name = name
        self.world = world
        self.config = config
        self.spc = spc
        self.api = api
        self.wrap = wrap   # numpy -> this package's send value
        self.host = host   # received value -> numpy


@pytest.fixture(scope="module")
def sides():
    jw = ompi_tpu.init()
    tw = ompi_tpu_torch.init(device="cpu")
    try:
        yield (Side("jax", jw, jconfig, lambda n: JSPC.counter(n).value,
                    japi, lambda a: a, np.asarray),
               Side("torch", tw, tconfig, TSPC.read, tapi,
                    torch.from_numpy, lambda v: v.numpy()))
    finally:
        ompi_tpu_torch.finalize()


def raises(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - compared across packages
        return type(exc).__name__
    return None


def _pair(s, c, data, nparts, tag, rparts=None):
    sreq = c.psend_init(s.wrap(data), nparts, 1, tag, source=0)
    rreq = c.precv_init(rparts or nparts, 0, tag, dest=1, like=data)
    sreq.start()
    rreq.start()
    return sreq, rreq


def _finish(s, sreq, rreq):
    st = rreq.wait()
    sreq.wait()
    return [s.host(rreq._result), (st.source, st.tag, st.count),
            sreq.state.value, rreq.state.value]


def sc_roundtrip_in_order(s, c):
    data = np.arange(24, dtype=np.float32)
    sreq, rreq = _pair(s, c, data, 6, 11)
    obs = [sreq._ntransfers]
    for p in range(6):
        sreq.pready(p)
    return obs + _finish(s, sreq, rreq)


def sc_out_of_order(s, c):
    data = np.arange(24, dtype=np.float32) * 2
    sreq, rreq = _pair(s, c, data, 6, 12)
    for p in (5, 0, 3, 1, 4, 2):
        sreq.pready(p)
    return _finish(s, sreq, rreq)


def sc_range_and_list(s, c):
    data = np.arange(24, dtype=np.float32) + 7
    sreq, rreq = _pair(s, c, data, 6, 13)
    sreq.pready_range(1, 3)
    sreq.pready_list([5, 0, 4])
    return _finish(s, sreq, rreq)


def sc_parrived_before_and_after(s, c):
    data = np.arange(24, dtype=np.float32)
    sreq, rreq = _pair(s, c, data, 6, 14)
    seq = [rreq.parrived(0)]
    sreq.pready(0)
    seq += [rreq.parrived(0), rreq.parrived(5)]
    for p in (1, 2, 3, 4, 5):
        sreq.pready(p)
        seq.append([rreq.parrived(q) for q in range(6)])
    out = _finish(s, sreq, rreq)
    return [seq, [rreq.parrived(p) for p in range(6)]] + out


def sc_straddling(s, c):
    data = np.arange(24, dtype=np.float32)
    sreq, rreq = _pair(s, c, data, 4, 21)
    sreq.pready(0)
    seq = [rreq.parrived(0)]
    sreq.pready(1)
    seq += [rreq.parrived(0), rreq.parrived(1)]
    sreq.pready_range(2, 3)
    return [seq] + _finish(s, sreq, rreq)


def sc_partition_view(s, c):
    data = np.arange(24, dtype=np.float32) * 3
    sreq, rreq = _pair(s, c, data, 6, 15)
    obs = [raises(lambda: rreq.partition_view(1))]
    sreq.pready(1)
    obs.append(s.host(rreq.partition_view(1)))
    for p in (0, 2, 3, 4, 5):
        sreq.pready(p)
    obs += _finish(s, sreq, rreq)
    obs.append(s.host(rreq.partition_view(5)))
    obs.append(s.host(rreq.partition_view(2)))
    obs.append(raises(lambda: rreq.partition_view(6)))
    return obs


def sc_restart_completed(s, c):
    a = np.arange(24, dtype=np.float32)
    b = a + 100
    sreq, rreq = _pair(s, c, a, 4, 16)
    sreq.pready_range(0, 3)
    obs = _finish(s, sreq, rreq)
    sreq.bind(s.wrap(b))
    sreq.start()
    rreq.start()
    obs.append(rreq.parrived(0))
    for p in (3, 2, 1, 0):
        sreq.pready(p)
    return obs + _finish(s, sreq, rreq)


def sc_partition_mismatch(s, c):
    data = np.arange(30, dtype=np.float32)
    sreq, rreq = _pair(s, c, data, 5, 17, rparts=3)
    obs = [sreq._ntransfers, rreq._ntransfers]
    for p in (4, 2, 0, 1, 3):
        sreq.pready(p)
    obs += _finish(s, sreq, rreq)
    return obs + [[rreq.parrived(p) for p in range(3)]]


def sc_single_transfer(s, c):
    data = np.arange(12, dtype=np.float32)
    sreq, rreq = _pair(s, c, data, 3, 18)
    obs = [sreq._ntransfers]
    sreq.pready(0)
    sreq.pready(2)
    obs.append(rreq.parrived(0))
    sreq.pready(1)
    return obs + _finish(s, sreq, rreq)


def sc_argument_errors(s, c):
    data = np.arange(8, dtype=np.float32)
    sreq, rreq = _pair(s, c, data, 2, 19)
    obs = [raises(lambda: rreq.pready(0)),
           raises(lambda: sreq.parrived(0)),
           raises(lambda: sreq.pready(2)),
           raises(lambda: sreq.pready_range(1, 0))]
    sreq.pready(0)
    obs += [raises(lambda: sreq.pready(0)), raises(sreq.start)]
    sreq.pready(1)
    obs += _finish(s, sreq, rreq)
    return obs + [raises(lambda: sreq.pready(1))]


def sc_init_validation(s, c):
    data = np.arange(8, dtype=np.float32)
    v = s.wrap(data)
    obs = [raises(lambda: c.psend_init(v, 0, 1, 1, source=0)),
           raises(lambda: c.psend_init(v, 9, 1, 1, source=0)),
           raises(lambda: c.psend_init(v, 2, 1, -1, source=0)),
           raises(lambda: c.precv_init(2, 0, -1, dest=1, like=data))]
    wild = raises(lambda: c.precv_init(2, -1, 1, dest=1, like=data))
    obs.append(wild in ("ArgumentError", "RankError"))
    sreq = c.psend_init(v, 2, 1, 1, source=0)
    obs.append(raises(lambda: sreq.pready(0)))
    rreq = c.precv_init(2, 0, 1, dest=1, like=data)
    obs.append(raises(lambda: rreq.parrived(0)))
    obs.append(raises(lambda: sreq.bind(s.wrap(
        np.arange(4, dtype=np.float32)))))
    return obs


def sc_overlapping_range_atomic(s, c):
    data = np.arange(24, dtype=np.float32)
    sreq, rreq = _pair(s, c, data, 6, 31)
    sreq.pready_range(1, 3)
    obs = [raises(lambda: sreq.pready_range(3, 5))]
    obs.append(list(sreq._flagged))
    sreq.pready_list([4, 5, 0])
    return obs + _finish(s, sreq, rreq)


def sc_duplicate_in_list(s, c):
    data = np.arange(24, dtype=np.float32)
    sreq, rreq = _pair(s, c, data, 6, 32)
    obs = [raises(lambda: sreq.pready_list([0, 2, 0])),
           list(sreq._flagged)]
    sreq.pready_list([0, 2])
    sreq.pready_list([1, 3, 4, 5])
    return obs + _finish(s, sreq, rreq)


def sc_before_start(s, c):
    data = np.arange(8, dtype=np.float32)
    sreq = c.psend_init(s.wrap(data), 2, 1, 33, source=0)
    obs = [raises(lambda: sreq.pready_range(0, 1)),
           raises(lambda: sreq.pready_list([0]))]
    rreq = c.precv_init(2, 0, 33, dest=1, like=data)
    sreq.start()
    rreq.start()
    sreq.pready_range(0, 1)
    return obs + _finish(s, sreq, rreq)


def sc_reblocking(s, c):
    s.config.set("part_persist_transfer_bytes", 48)
    try:
        data = np.arange(28, dtype=np.float32) + 0.5
        sreq, rreq = _pair(s, c, data, 7, 34)
        obs = [sreq._ntransfers]
        sreq.pready_list([6, 0, 2])
        obs.append([rreq.parrived(p) for p in range(7)])
        sreq.pready(1)
        obs.append([rreq.parrived(0), rreq.parrived(1), rreq.parrived(2)])
        sreq.pready_range(3, 5)
        obs += _finish(s, sreq, rreq)
        return obs + [rreq.parrived(2)]
    finally:
        s.config.set("part_persist_transfer_bytes", 16)


def sc_burst(s, c):
    data = np.arange(24, dtype=np.float32)
    sreq, rreq = _pair(s, c, data, 6, 35)
    sreq.pready_range(0, 5)
    return _finish(s, sreq, rreq)


def sc_api_functions(s, c):
    """The MPI-4 API spellings over one pair, ranks 3 -> 5."""
    data = np.arange(40, dtype=np.float32) - 3
    sreq = s.api.Psend_init(c, s.wrap(data), 8, 5, 40, source=3)
    rreq = s.api.Precv_init(c, 4, 3, 40, dest=5, like=data)
    sreq.start()
    rreq.start()
    s.api.Pready(sreq, 7)
    s.api.Pready_range(sreq, 0, 2)
    seq = [s.api.Parrived(rreq, p) for p in range(4)]
    s.api.Pready_list(sreq, [6, 3, 5, 4])
    seq += [s.api.Parrived(rreq, p) for p in range(4)]
    return [seq] + _finish(s, sreq, rreq)


SCENARIOS = [
    (sc_roundtrip_in_order, True), (sc_out_of_order, True),
    (sc_range_and_list, True), (sc_parrived_before_and_after, True),
    (sc_straddling, True), (sc_partition_view, True),
    (sc_restart_completed, True), (sc_partition_mismatch, True),
    (sc_single_transfer, False), (sc_argument_errors, False),
    (sc_init_validation, False), (sc_overlapping_range_atomic, True),
    (sc_duplicate_in_list, True), (sc_before_start, False),
    (sc_reblocking, True), (sc_burst, True), (sc_api_functions, True),
]


def _same(got, want, what):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), what
        assert (got.dtype, got.shape) == (want.dtype, want.shape), what
        assert got.tobytes() == want.tobytes(), what
    else:
        assert got == want, what


@pytest.mark.parametrize("scenario,small", SCENARIOS,
                         ids=[f.__name__[3:] for f, _ in SCENARIOS])
def test_scenario_matches_jax(sides, scenario, small):
    seen = []
    for s in sides:
        c = s.world.dup()
        if small:
            s.config.set("part_persist_transfer_bytes", 16)
        try:
            before = {k: s.spc(k) for k in SPC_NAMES}
            obs = scenario(s, c)
            delta = {k: s.spc(k) - before[k] for k in SPC_NAMES}
        finally:
            s.config.set("part_persist_transfer_bytes", 256 << 10)
        seen.append((obs, delta))
    (jobs, jdelta), (tobs, tdelta) = seen
    _same(tobs, jobs, scenario.__name__)
    assert tdelta == jdelta


def test_transfer_geometry_and_tags_match(sides):
    """Both packages derive the same transfer count and derived tag for
    every (elements, itemsize, cvars) the training step meets."""
    from ompi_tpu.part import persist as jp
    from ompi_tpu_torch.part import persist as tp

    for elems, isz in ((1, 4), (24, 4), (1 << 20, 4), (11008 * 4096, 4),
                       (4096, 2), (3 << 20, 1), (123457, 8)):
        assert tp._transfer_count(elems, isz) == \
            jp._transfer_count(elems, isz)
    for tag in (0, 1, 768, 820, 4000):
        assert tp._base_tag(tag) == jp._base_tag(tag)
    assert (tp._transfer_bytes.value, tp._max_transfers.value,
            tp._tag_stride.value) == (256 << 10, 64, 4096)


# -- the tree bcast's dtype gate --------------------------------------------

@pytest.fixture
def pallas_worlds(sides):
    jconfig.VARS.set("coll_pallas_priority", 100)
    tconfig.VARS.set("coll_pallas_priority", 100)
    try:
        yield sides[0].world, sides[1].world
    finally:
        jconfig.VARS.set("coll_pallas_priority", 30)
        tconfig.VARS.set("coll_pallas_priority", 30)


def _sub(world, n):
    if n == world.size:
        return world.dup()
    return world.split([0 if r < n else -1 for r in range(world.size)])[0]


@pytest.mark.skipif(not jpallas.interpret_available(),
                    reason="this jax build has no Mosaic TPU interpret "
                           "mode for the JAX package's kernel")
@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("dtype", ["uint8", "int8"])
def test_pallas_bcast_bytes_matches_jax(pallas_worlds, n, dtype):
    jw, tw = pallas_worlds
    jc, tc = _sub(jw, n), _sub(tw, n)
    assert type(jc._coll["bcast"][0]).__name__ == "PallasColl"
    assert type(tc._coll["bcast"][0]).__name__ == "PallasColl"
    rng = np.random.default_rng(n)
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max + 1, (n, 301)).astype(dtype)
    for root in (0, n - 1):
        jout = np.asarray(jc.bcast(jc.put_rank_major(x), root))
        tout = tc.bcast(tc.put_rank_major(torch.from_numpy(x)),
                        root).numpy()
        assert tout.dtype == jout.dtype == x.dtype
        assert tout.tobytes() == jout.tobytes()
        assert tout.tobytes() == np.broadcast_to(x[root], x.shape).tobytes()


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8, torch.float16,
                                   torch.float64, torch.int64])
def test_tree_bcast_takes_every_element_size(dtype):
    """On the CPU the wrapper runs its plain version; the kernel's
    launch has no dtype table left: any element size dividing 16."""
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(5, 37, generator=g) * 50).to(dtype)
    out = tpallas.tree_bcast(x, 4)
    assert torch.equal(out, x[4].expand_as(x))
    assert torch.equal(out, tpallas.tree_bcast_plain(x, 4))
    with pytest.raises(ArgumentError):
        tpallas.tree_bcast(x, 5)


class _CompleteDuringAppend(list):
    """A callback list whose append first lets another thread complete
    the request: the window between on_complete's state check and its
    append."""

    def __init__(self, req):
        super().__init__()
        self.req = req
        self.completer = None

    def append(self, cb):
        self.completer = threading.Thread(target=self.req._complete,
                                          args=("done",))
        self.completer.start()
        self.completer.join(timeout=0.2)  # blocks while the append holds
        super().append(cb)


def test_on_complete_loses_no_callback_to_a_completion_on_another_thread():
    req = trequest.Request()
    req._callbacks = hooked = _CompleteDuringAppend(req)
    seen = []
    req.on_complete(seen.append)
    hooked.completer.join(timeout=10)
    assert not hooked.completer.is_alive()
    assert req.done and seen == [req]
    req.on_complete(seen.append)  # registered after completion: runs now
    assert seen == [req, req]


def test_partitioned_send_fired_and_matched_on_two_threads(sides):
    """Rendezvous transfers fire on a worker thread (Pready) while the
    main thread's progress matches them, which completes each send on
    the main thread: every transfer's match is counted and every cycle
    completes, bitwise."""
    s = sides[1]
    c = s.world.dup()
    assert c.pml.bml(c).btl_for(0, 1).NAME == "ici"  # registers its cvars
    knobs = {"btl_ici_eager_limit": 0, "part_persist_transfer_bytes": 64}
    saved = {k: tconfig.VARS.get(k) for k in knobs}
    interval = sys.getswitchinterval()
    rng = np.random.default_rng(5)
    data = rng.standard_normal(4096).astype(np.float32)
    try:
        for k, v in knobs.items():
            tconfig.VARS.set(k, v)
        sys.setswitchinterval(1e-6)
        rndv = TSPC.read("pml_rndv_sends")
        for _ in range(8):
            sreq, rreq = _pair(s, c, data, 64, 3)
            assert sreq._ntransfers == 64
            order = rng.permutation(64).tolist()
            th = threading.Thread(
                target=lambda: [sreq.pready(p) for p in order])
            th.start()
            while th.is_alive():
                rreq.test()
            th.join()
            rreq.wait(timeout=10)
            sreq.wait(timeout=10)
            assert rreq._result.numpy().tobytes() == data.tobytes()
        assert TSPC.read("pml_rndv_sends") - rndv == 8 * 64
        c.free()
    finally:
        sys.setswitchinterval(interval)
        for k, v in saved.items():
            tconfig.VARS.set(k, v)


def test_matching_state_is_made_once_under_two_first_touches(sides,
                                                             monkeypatch):
    """Two threads touching a fresh comm's matching state at once (a
    send and a progress sweep) get the same state: a send parked into a
    second copy would never be matched."""
    c = sides[1].world.dup()
    made = []

    class Slow(tob1._CommP2P):
        def __init__(self):
            time.sleep(0.05)
            super().__init__()
            made.append(self)

    monkeypatch.setattr(tob1, "_CommP2P", Slow)
    got = []
    threads = [threading.Thread(target=lambda: got.append(c.pml._state(c)))
               for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(made) == 1 and got == made * 2
    c.free()


def test_envelope_index_drops_matched_envelopes(sides):
    """Exact and wildcard receives take parked sends in arrival order
    per envelope, and the envelope index keeps no key once its sends are
    matched (a comm's distinct tags would otherwise pile up)."""
    c = sides[1].world.dup()
    try:
        sends = [(0, 1, 1), (0, 1, 2), (0, 1, 1), (2, 1, 1), (0, 1, 2)]
        for i, (src, dst, tag) in enumerate(sends):
            c.isend(torch.full((4,), float(i)), dst, tag, source=src)
        index = c.pml._state(c).by_envelope
        assert sorted(index) == [(0, 1, 1), (0, 1, 2), (2, 1, 1)]
        got = [c.irecv(src, tag, dest=1).result()[0].item()
               for src, tag in ((0, trequest.ANY_TAG),
                                (trequest.ANY_SOURCE, 1), (2, 1),
                                (0, 2), (0, 2))]
        assert got == [0.0, 2.0, 3.0, 1.0, 4.0]
        assert index == {}
    finally:
        c.free()
