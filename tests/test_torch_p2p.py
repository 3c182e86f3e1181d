"""The port's point-to-point stack and nonblocking ``i*`` collectives
against the JAX package's, on the CPU (mirrors ``tests/test_p2p.py``).

- Every scenario of ``tests/test_p2p.py`` (and RankEndpoint's
  ``sendrecv``, persistent send/recv started twice, the memchecker's
  send guard) runs on a fresh ``dup`` of each package's world; the
  received values bitwise, the ``Status`` fields, the request states,
  the exception classes and the p2p SPC deltas are equal.
- Peruse's event sequences of an eager send/recv pair, of an
  unexpected arrival and of a rendezvous onto a posted recv are equal.
- The port's own rules: every transfer hands the receiver a tensor in
  storage of its own (a sender writing its buffer after the send
  completed changes nothing the receiver got: eager, rendezvous either
  way round, self, and each leaf of a nested payload); ``self`` for a
  rank to itself, ``ici`` between ranks, in both packages; the source
  rank is never inferred from placement (the JAX package reads it off
  the device, the port raises ``RankError`` unless the comm has one
  rank); ``pml_select=cm`` raises ``ComponentError``; the template BTL
  records the bytes the JAX package's records.
- The 15 ``i*`` collectives on the default route: bitwise their
  blocking calls and the JAX package's results (the inputs of
  ``tests/test_torch_persistent.py``: the SUM reductions whose route is
  the native sum take int32); PallasColl's eight kernel-backed forms
  bitwise their blocking calls with no launch on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch
from ompi_tpu import btl as jbtl
from ompi_tpu import communicator as jcommunicator
from ompi_tpu.core import config as jconfig
from ompi_tpu.core import memchecker as jmemchecker  # noqa: F401 - its cvar
from ompi_tpu.core import peruse as jperuse
from ompi_tpu.core.counters import SPC as JSPC
from ompi_tpu.topo import topology as jtopo
from ompi_tpu_torch import btl as tbtl
from ompi_tpu_torch import communicator as tcommunicator
from ompi_tpu_torch.core import config as tconfig
from ompi_tpu_torch.core import counters
from ompi_tpu_torch.core import errors as terrors
from ompi_tpu_torch.core import peruse as tperuse
from ompi_tpu_torch.core.counters import SPC as TSPC
from ompi_tpu_torch.pml import framework as tpml
from ompi_tpu_torch.topo import topology as ttopo
from test_torch_persistent import (CASES, PALLAS_CASES, _as_input,
                                   _assert_bitwise, _rank_major)

P2P_SPC = ("pml_isend_calls", "pml_send_bytes", "pml_eager_sends",
           "pml_rndv_sends", "pml_irecv_calls", "pml_improbe_hits")


class Side:
    """One package's surface, as the scenarios use it."""

    def __init__(self, name, world, lib, spc, modules):
        self.name = name
        self.world = world
        self.lib = lib  # what _as_input builds tensors with
        self.spc = spc
        self.peruse, self.config, self.btl, self.comm_mod = modules


@pytest.fixture(scope="module")
def sides():
    jw = ompi_tpu.init()
    tw = ompi_tpu_torch.init(device="cpu")
    try:
        yield (Side("jax", jw, jnp, lambda n: JSPC.counter(n).value,
                    (jperuse, jconfig, jbtl, jcommunicator)),
               Side("torch", tw, torch, TSPC.read,
                    (tperuse, tconfig, tbtl, tcommunicator)))
    finally:
        ompi_tpu_torch.finalize()


def host(v):
    """A received value on the host: numpy arrays, nested as sent."""
    if isinstance(v, dict):
        return {k: host(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [host(x) for x in v]
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def status(st):
    return (st.source, st.tag, st.count, st.cancelled)


def raises(fn):
    """The exception class ``fn()`` raised (by name, with its MPI error
    class), or None."""
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - compared across packages
        return type(exc).__name__, getattr(exc, "errclass", None)
    return None


def same(got, want, what):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            same(got[k], want[k], f"{what}[{k}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), what
        assert (got.dtype, got.shape) == (want.dtype, want.shape), what
        assert got.tobytes() == want.tobytes(), what
    else:
        assert got == want, what


def data(seed, shape=(10,), dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return rng.integers(-1000, 1000, shape).astype(np.int32)
    return rng.standard_normal(shape).astype(dtype)


# -- the scenarios of tests/test_p2p.py (each on a fresh dup) --------------

def sc_send_recv_basic(s, c):
    r0, r3 = c.rank(0), c.rank(3)
    r0.send(r0.put(data(1)), dest=3, tag=7)
    return [host(r3.recv(source=0, tag=7))]


def sc_send_to_self(s, c):
    r2 = c.rank(2)
    req = r2.isend(r2.put(data(2, (5,))), dest=2, tag=1)
    out = r2.recv(source=2, tag=1)
    st = req.wait()
    return [host(out), req.done, status(st)]


def sc_nonovertaking_order(s, c):
    r0, r1 = c.rank(0), c.rank(1)
    r0.send(r0.put(np.float32(1.0)), dest=1, tag=5)
    r0.send(r0.put(np.float32(2.0)), dest=1, tag=5)
    return [host(r1.recv(source=0, tag=5)), host(r1.recv(source=0, tag=5))]


def sc_wildcard_source_and_tag(s, c):
    r0, r1, r4 = c.rank(0), c.rank(1), c.rank(4)
    r0.send(r0.put(np.float32(10.0)), dest=4, tag=3)
    r1.send(r1.put(np.float32(20.0)), dest=4, tag=9)
    req = r4.irecv(source=-1, tag=-1)
    st = req.wait()
    return [host(req.result()), status(st),
            host(r4.recv(source=-1, tag=9))]


def sc_recv_posted_before_send(s, c):
    r5, r6 = c.rank(5), c.rank(6)
    req = r6.irecv(source=5, tag=2)
    before = req.done
    r5.send(r5.put(data(3, (4,))), dest=6, tag=2)
    st = req.wait(timeout=10)
    return [before, host(req.result()), status(st)]


def sc_rendezvous_large_message(s, c):
    r0, r7 = c.rank(0), c.rank(7)
    req = r0.isend(r0.put(data(4, (128 * 1024,))), dest=7, tag=4)
    before = req.done
    out = r7.recv(source=0, tag=4)
    return [before, req.done, host(out), status(req.status)]


def sc_eager_completes_immediately(s, c):
    r1 = c.rank(1)
    req = r1.isend(r1.put(np.float32(5.0)), dest=2, tag=8)
    return [req.done, host(c.rank(2).recv(source=1, tag=8))]


def sc_iprobe(s, c):
    r0, r3 = c.rank(0), c.rank(3)
    none = r3.iprobe(source=0, tag=77)
    r0.send(r0.put(np.arange(6, dtype=np.int32)), dest=3, tag=77)
    st = r3.iprobe(source=0, tag=77)
    return [none, status(st), host(r3.recv(source=0, tag=77))]


def sc_probe_blocking_raises(s, c):
    return [raises(lambda: c.rank(1).probe(source=0, tag=12345))]


def sc_source_inference_failure(s, c):
    return [raises(lambda: c.send(np.float32(1.0), dest=0, tag=0))]


def sc_sendrecv_ring(s, c):
    n = c.size
    reqs = [c.rank(i).isend(c.rank(i).put(np.float32(i)), dest=(i + 1) % n,
                            tag=0) for i in range(n)]
    vals = [host(c.rank(i).recv(source=(i - 1) % n, tag=0))
            for i in range(n)]
    return vals + [status(r.wait()) for r in reqs]


def sc_pytree_payload(s, c):
    r0, r1 = c.rank(0), c.rank(1)
    payload = {"w": r0.put(data(5, (3, 3))), "b": r0.put(data(6, (3,))),
               "t": (r0.put(np.int32(7)), [r0.put(data(7, (2,)))])}
    req = r0.isend(payload, dest=1, tag=2)
    out = r1.recv(source=0, tag=2)
    return [host(out), status(req.wait())]


def sc_unmatched_recv_raises(s, c):
    req = c.rank(3).irecv(source=2, tag=999)
    exc = raises(req.wait)
    r2 = c.rank(2)
    r2.send(r2.put(np.float32(0.0)), dest=3, tag=999)
    return [exc, status(req.wait()), host(req.result())]


def sc_unmatched_rndv_send_raises(s, c):
    r0 = c.rank(0)
    req = r0.isend(r0.put(data(8, (64 * 1024,))), dest=1, tag=888)
    exc = raises(req.wait)
    out = c.rank(1).recv(source=0, tag=888)
    return [exc, status(req.wait()), host(out)]


def sc_comm_free_drops_state(s, c):
    r0 = c.rank(0)
    r0.send(r0.put(np.float32(1.0)), dest=1, tag=0)
    pml = c.pml
    before = c.cid in pml._comm_state
    c.free()
    return [before, c.cid in pml._comm_state]


def sc_cancelled_recv(s, c):
    r0, r1 = c.rank(0), c.rank(1)
    req = r1.irecv(source=0, tag=555)
    req.cancel()
    r0.send(r0.put(np.float32(42.0)), dest=1, tag=555)
    out = r1.recv(source=0, tag=555)
    return [req.status.cancelled, host(out), req._result is None]


def sc_improbe_removes(s, c):
    c.rank(0).isend(np.float32(42.0), dest=1, tag=7)
    msg = c.improbe(source=0, tag=7, dest=1)
    st = status(msg.status)
    gone = c.iprobe(source=-1, tag=-1, dest=1)
    out = host(msg.mrecv())
    return [st, gone, out, raises(msg.imrecv)]


def sc_improbe_none(s, c):
    return [c.improbe(source=0, tag=99, dest=1)]


def sc_improbe_wildcard(s, c):
    c.rank(2).isend(np.float32(5.0), dest=3, tag=11)
    msg = c.improbe(source=-1, tag=-1, dest=3)
    return [status(msg.status), host(msg.mrecv())]


def sc_endpoint_sendrecv(s, c):
    # rank 4 sends to 5 and receives what 3 sent it
    r3, r4 = c.rank(3), c.rank(4)
    r3.isend(r3.put(data(9, (6,))), dest=4, tag=1)
    out = r4.sendrecv(r4.put(data(10, (6,))), dest=5, source=3, tag=1)
    return [host(out), host(c.rank(5).recv(source=4, tag=1))]


def sc_persistent_send_recv(s, c):
    send = c.send_init(c.rank(0).put(data(11, (300,))), dest=6, tag=3,
                       source=0)
    recv = c.recv_init(source=0, tag=3, dest=6)
    out = []
    for seed in (12, 13):
        s.comm_mod.start_all([recv, send])
        send.wait()
        recv.wait()
        out += [host(recv.result()), status(recv.status)]
        send.bind(c.rank(0).put(data(seed, (300,))))
    return out + [raises(lambda: c.send_init(1.0, dest=9))]


def sc_memchecker_send_guard(s, c):
    var = "memchecker_base_enable"
    s.config.VARS.set(var, True)
    try:
        bad = raises(lambda: c.rank(0).send(
            c.rank(0).put(np.array([1.0, np.nan], np.float32)), dest=1))
    finally:
        s.config.VARS.set(var, False)
    return [bad]


SCENARIOS = {name[3:]: fn for name, fn in globals().items()
             if name.startswith("sc_")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(sides, name):
    seen = []
    for s in sides:
        before = {k: s.spc(k) for k in P2P_SPC}
        obs = SCENARIOS[name](s, s.world.dup())
        seen.append((obs, {k: s.spc(k) - before[k] for k in P2P_SPC}))
    (jobs, jspc), (tobs, tspc) = seen
    same(tobs, jobs, name)
    assert tspc == jspc, name


# -- peruse ------------------------------------------------------------------

def _eager_pair(c):
    c.rank(0).send(c.rank(0).put(np.float32(1.0)), dest=1, tag=4)
    c.rank(1).recv(source=0, tag=4)


def _unexpected_arrival(c):
    c.rank(2).isend(c.rank(2).put(data(1, (4,))), dest=5, tag=9)
    c.rank(5).iprobe(source=2, tag=9)
    c.rank(5).recv(source=-1, tag=-1)


def _rndv_posted(c):
    req = c.rank(6).irecv(source=3, tag=1)
    c.rank(3).send(c.rank(3).put(data(2, (32 * 1024,))), dest=6, tag=1)
    req.wait()


@pytest.mark.parametrize("drive", [_eager_pair, _unexpected_arrival,
                                   _rndv_posted])
def test_peruse_sequences_match_jax(sides, drive):
    seqs = []
    for s in sides:
        c = s.world.dup()
        seq = []
        sids = [s.peruse.subscribe(ev, lambda event, **info: seq.append(
            (event.name, info.get("kind"))))
            for ev in s.peruse.PeruseEvent]
        try:
            drive(c)
        finally:
            for sid in sids:
                s.peruse.unsubscribe(sid)
        seqs.append(seq)
    assert seqs[0] and seqs[1] == seqs[0]


# -- the port's own rules ----------------------------------------------------

def _send_then_mutate(c, how):
    """Send a tensor, let the send complete, write the sender's buffer;
    returns (buffer, received, sent values)."""
    big = how.startswith("rndv")
    x = torch.from_numpy(data(3, (32 * 1024,) if big else (1024,)))
    sent = x.clone()
    src, dst = (2, 2) if how == "self" else (0, 3)
    if how == "rndv_posted":
        rreq = c.rank(dst).irecv(source=src, tag=5)
        sreq = c.rank(src).isend(x, dest=dst, tag=5)
    else:
        sreq = c.rank(src).isend(x, dest=dst, tag=5)
        assert sreq.done == (not big)
        rreq = c.rank(dst).irecv(source=src, tag=5)
    assert sreq.done and rreq.done
    x.mul_(-3.0).add_(1.0)  # MPI allows reuse once the send completed
    return x, rreq.result(), sent


@pytest.mark.parametrize("how", ["eager", "rndv", "rndv_posted", "self"])
def test_receiver_owns_its_storage(sides, how):
    c = sides[1].world.dup()
    x, got, sent = _send_then_mutate(c, how)
    assert torch.equal(got, sent)
    assert got.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()


def test_nested_payload_leaves_are_copied(sides):
    c = sides[1].world.dup()
    row = torch.arange(16, dtype=torch.float32).reshape(2, 8)
    payload = {"a": row[0], "b": [row[1], torch.ones(3)]}
    c.rank(1).send(payload, dest=4)
    got = c.rank(4).recv(source=1)
    row.zero_()
    payload["b"][1].zero_()
    assert got["a"].tolist() == list(range(8))
    assert got["b"][0].tolist() == list(range(8, 16))
    assert got["b"][1].tolist() == [1.0] * 3
    ptrs = {t.untyped_storage().data_ptr()
            for t in (got["a"], got["b"][0], got["b"][1])}
    assert len(ptrs) == 3 and row.untyped_storage().data_ptr() not in ptrs


@pytest.mark.parametrize("pair,name", [((2, 2), "self"), ((0, 3), "ici"),
                                       ((7, 0), "ici"), ((5, 5), "self")])
def test_btl_per_pair(sides, pair, name):
    for s in sides:
        c = s.world.dup()
        assert c.pml.bml(c).btl_for(*pair).NAME == name, s.name
        assert c.pml.bml(c).wire_label(*pair) == name, s.name


def test_source_inferred_only_by_the_jax_package(sides):
    """The JAX package reads the source rank off the value's device
    (``tests/test_p2p.py::test_source_inference_from_device``); every
    rank of the port shares one device, so it raises ``RankError``
    unless the comm has one rank (ROADMAP Queue 3)."""
    (js, ts) = sides
    jc, tc = js.world.dup(), ts.world.dup()
    jc.send(jax.device_put(np.float32(3.0), jc.devices[6]), dest=0, tag=6)
    assert float(jc.rank(0).recv(source=6, tag=6)) == 3.0
    with pytest.raises(terrors.RankError, match="pass source="):
        tc.send(torch.tensor(3.0), dest=0, tag=6)
    tc.send(torch.tensor(3.0), dest=0, tag=6, source=6)
    assert float(tc.rank(0).recv(source=6, tag=6)) == 3.0
    one = tc.split([0] + [-1] * (tc.size - 1))[0]
    one.send(torch.tensor(4.0), dest=0, tag=1)
    assert one.recv(source=0, tag=1, dest=0).item() == 4.0


def test_pml_select_cm_raises(sides):
    tc = sides[1].world.dup()
    tpml.reset_selection()
    tconfig.VARS.set("pml_select", "cm")
    try:
        with pytest.raises(terrors.ComponentError):
            tc.pml
    finally:
        tconfig.VARS.set("pml_select", "")
        tpml.reset_selection()
    assert tc.pml.NAME == "ob1"


def test_template_btl_records_transfers(sides):
    nbytes = []
    for s in sides:
        tmpl = s.btl.BTL.component("template")  # registers its cvars
        s.config.VARS.set("btl_template_enable", True)
        s.config.VARS.set("btl_template_priority", 200)
        try:
            c = s.world.dup()
            tmpl.transfers.clear()
            assert c.pml.bml(c).btl_for(0, 0).NAME == "template"
            # 12 000 B: the template's rendezvous, moved at the match
            c.rank(0).isend(c.rank(0).put(data(1, (3000,))), dest=0, tag=1)
            r = c.rank(0).irecv(source=0, tag=1)
            c.rank(1).send(c.rank(1).put(data(2, (5,))), dest=0, tag=2)
            c.rank(0).recv(source=1, tag=2)
            nbytes.append(([t[2] for t in tmpl.transfers],
                           host(r.result())))
        finally:
            s.config.VARS.set("btl_template_enable", False)
            s.config.VARS.set("btl_template_priority", 0)
    same(nbytes[1], nbytes[0], "template")
    assert nbytes[1][0] == [12000, 20]


# -- the i* collectives ------------------------------------------------------

ICOLLS = ("allreduce", "bcast", "reduce", "allgather",
          "reduce_scatter_block", "alltoall", "gather", "scatter", "scan",
          "allgatherv", "alltoallv", "reduce_scatter", "neighbor_allgather",
          "neighbor_alltoall")


@pytest.fixture(scope="module")
def carts(sides):
    jw, tw = (s.world for s in sides)
    return (jtopo.cart_create(jw, [jw.size], [True]),
            ttopo.cart_create(tw, [tw.size], [True]))


@pytest.mark.parametrize("opname", ICOLLS)
def test_icoll_matches_blocking_and_jax(sides, carts, opname):
    uses_cart, make, args = CASES[opname]
    got = []
    for s, cart in zip(sides, carts):
        comm = cart if uses_cart else s.world
        x = _as_input(opname, comm, make(comm.size, 31), s.lib)
        req = getattr(comm, f"i{opname}")(x, *args)
        out = req.result()
        assert req.done
        _assert_bitwise(out, getattr(comm, opname)(x, *args), opname)
        got.append(out)
    _assert_bitwise(got[1], got[0], (opname, "jax"))


def test_ibarrier(sides):
    for s in sides:
        req = s.world.ibarrier()
        req.wait()
        assert req.done and req.test()[0]


def test_pallas_route_icolls_match_blocking(sides):
    tw = sides[1].world
    tconfig.VARS.set("coll_pallas_priority", 100)
    try:
        pcomm = tw.dup()
    finally:
        tconfig.VARS.set("coll_pallas_priority", 30)
    counters.reset_launches()
    for opname, (shape, args) in PALLAS_CASES.items():
        assert pcomm._coll[opname][0].NAME == "pallas"
        x = torch.from_numpy(_rank_major(8, 5, shape))
        req = getattr(pcomm, f"i{opname}")(x, *args)
        assert req.done and req._event is None  # the CPU: done at once
        _assert_bitwise(req.result(), getattr(pcomm, opname)(x, *args),
                        opname)
    assert not any(counters.launches().values())


def test_port_imports_neither_jax_nor_the_jax_package():
    """No module of the port, and not ``chip_smoke.py``, imports ``jax``
    or anything of ``ompi_tpu``: the port keeps its own copies."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    files = sorted((root / "ompi_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            else:
                continue
            bad += [(path.name, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "ompi_tpu")]
    assert len(files) > 60 and not bad, bad
