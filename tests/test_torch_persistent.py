"""The port's persistent collectives and requests against the JAX
package's, on the CPU (mirrors ``tests/test_persistent_coll.py``).

- Every collective ``*_init`` started twice (the buffer rebound for the
  second start) on the default route: bitwise the port's blocking call
  and the JAX package's persistent result on the same inputs. The two
  SUM reductions whose persistent route is the native sum take int32
  inputs here, exact in any order.
- The same two in float32, below and above the host tier's 4096 bytes:
  within 1e-6 of the JAX package (a float32 native sum is PyTorch's
  order, not XLA's: ``test_torch_colls.py`` holds it to 1e-6) and
  bitwise the blocking call, but for the allreduce at or below 4096
  bytes, whose persistent form skips the host tier as the JAX package's
  does (1e-6; ROADMAP Queue 3).
- The PallasColl route's eight ``*_init`` forms on small inputs: bitwise
  their blocking calls, and no kernel launches on the CPU (the wrappers
  run their plain versions).
- ``barrier_init``, ``bind``, the plan cache reused, ``start()``
  skipping ``_coll_call`` (one ``coll_persistent_<op>_starts`` count per
  start), ``wait`` before ``start`` raising ``RequestError``, and
  ``start_all``.
- The request module: ``wait_all/any/some``, ``test_*`` and
  ``progress_until`` on ``GeneralizedRequest``s, each scenario run on
  both packages' request modules with the same outcomes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch
from ompi_tpu.core import progress as jprogress
from ompi_tpu.core import request as jrequest
from ompi_tpu.topo import topology as jtopo
from ompi_tpu_torch.communicator import start_all
from ompi_tpu_torch.core import config as tconfig
from ompi_tpu_torch.core import counters
from ompi_tpu_torch.core import progress as tprogress
from ompi_tpu_torch.core import request as trequest
from ompi_tpu_torch.core.counters import SPC
from ompi_tpu_torch.core.errors import RequestError
from ompi_tpu_torch.topo import topology as ttopo


@pytest.fixture(scope="module")
def worlds():
    jworld = ompi_tpu.init()
    tworld = ompi_tpu_torch.init(device="cpu")
    try:
        yield jworld, tworld
    finally:
        ompi_tpu_torch.finalize()


@pytest.fixture(scope="module")
def carts(worlds):
    jw, tw = worlds
    return (jtopo.cart_create(jw, [jw.size], [True]),
            ttopo.cart_create(tw, [tw.size], [True]))


def _rank_major(n, seed, shape=(6,), dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return rng.integers(-1000, 1000, (n,) + shape).astype(np.int32)
    return rng.standard_normal((n,) + shape).astype(np.float32)


def _ragged(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(r + 1).astype(np.float32) for r in range(n)]


def _square(n, seed):
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal(3).astype(np.float32) for _ in range(n)]
            for _ in range(n)]


def _counts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(-1000, 1000, 2 * n).astype(np.int32)
            for _ in range(n)]


# op name -> (uses_cart, make(n, seed) -> numpy input, extra args)
CASES = {
    "allreduce": (False, lambda n, s: _rank_major(n, s, dtype=np.int32),
                  ("sum",)),
    "reduce": (False, _rank_major, ("max", 0)),
    "bcast": (False, _rank_major, (3,)),
    "allgather": (False, _rank_major, ()),
    "alltoall": (False, lambda n, s: _rank_major(n, s, (n, 2)), ()),
    "gather": (False, _rank_major, (2,)),
    "scatter": (False, lambda n, s: _rank_major(n, s, (n, 2)), (1,)),
    "scan": (False, _rank_major, ("sum",)),
    "exscan": (False, _rank_major, ("sum",)),
    "reduce_scatter_block": (False, lambda n, s: _rank_major(
        n, s, (n, 2), np.int32), ("sum",)),
    "allgatherv": (False, _ragged, ()),
    "gatherv": (False, _ragged, (1,)),
    "scatterv": (False, _ragged, (0,)),
    "alltoallv": (False, _square, ()),
    "alltoallw": (False, _square, ()),
    "reduce_scatter": (False, _counts, ([2] * 8, "sum")),
    "neighbor_allgather": (True, _rank_major, ()),
    "neighbor_alltoall": (True, lambda n, s: _rank_major(n, s, (2, 2)), ()),
}
RANK_MAJOR = {"allreduce", "reduce", "bcast", "allgather", "alltoall",
              "gather", "scatter", "scan", "exscan", "reduce_scatter_block",
              "neighbor_allgather"}


def _as_input(opname, comm, data, lib):
    """The numpy input as the package's collective takes it."""
    if lib is torch:
        conv = torch.from_numpy
    else:
        conv = jnp.asarray
    if opname in RANK_MAJOR:
        return comm.put_rank_major(conv(data))
    if opname == "neighbor_alltoall":
        return {r: conv(data[r]) for r in range(len(data))}
    if opname in ("alltoallv", "alltoallw"):
        return [[conv(b) for b in row] for row in data]
    return [conv(v) for v in data]


def _to_np(v):
    if v is None:
        return None
    if isinstance(v, dict):
        return {k: _to_np(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_to_np(x) for x in v]
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_bitwise(got, want, what):
    got, want = _to_np(got), _to_np(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _assert_bitwise(got[k], want[k], f"{what}[{k}]")
    elif isinstance(want, list):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_bitwise(g, w, f"{what}[{i}]")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, what
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), \
            what


def _persistent_twice(comm, opname, make, args, lib):
    """The op's persistent form started twice (rebound for the second
    start), and the blocking call on each input."""
    preq, results, blocking = None, [], []
    for seed in (11, 22):
        x = _as_input(opname, comm, make(comm.size, seed), lib)
        if preq is None:
            preq = getattr(comm, f"{opname}_init")(x, *args)
        else:
            preq.bind(x)
        assert preq.start() is preq
        preq.wait(timeout=120)
        results.append(preq.result())
        blocking.append(getattr(comm, opname)(x, *args))
    assert preq.persistent
    return results, blocking


@pytest.mark.parametrize("opname", sorted(CASES))
def test_persistent_started_twice_matches_blocking_and_jax(worlds, carts,
                                                           opname):
    uses_cart, make, args = CASES[opname]
    jcomm, tcomm = carts if uses_cart else worlds
    jgot, _ = _persistent_twice(jcomm, opname, make, args, jnp)
    before = SPC.read(f"coll_persistent_{opname}_starts")
    tgot, tblocking = _persistent_twice(tcomm, opname, make, args, torch)
    assert SPC.read(f"coll_persistent_{opname}_starts") == before + 2
    for cycle in range(2):
        _assert_bitwise(tgot[cycle], tblocking[cycle], (opname, cycle))
        _assert_bitwise(tgot[cycle], jgot[cycle], (opname, cycle, "jax"))


# The two SUM reductions in float32, at or below the host tier's 4096
# bytes and above it: (shape per rank, whole rank-major bytes).
F32_SUM = {
    ("allreduce", "host_tier"): (6,),              # 192 B
    ("allreduce", "device"): (2000,),              # 64 000 B
    ("reduce_scatter_block", "host_tier"): (8, 2),     # 512 B
    ("reduce_scatter_block", "device"): (8, 250),      # 64 000 B
}


@pytest.mark.parametrize("opname,size", sorted(F32_SUM))
def test_persistent_float32_sum_matches_blocking_and_jax(worlds, opname,
                                                         size):
    """Float32 SUM: within 1e-6 of the JAX package (the native sum is
    PyTorch's order, not XLA's) and bitwise the blocking call, except a
    persistent allreduce at or below the host tier's bytes: it binds the
    decision's device plan and never the blocking call's host tier, as
    in the JAX package (ROADMAP Queue 3), so it too is held to 1e-6."""
    shape = F32_SUM[(opname, size)]
    make = lambda n, s: _rank_major(n, s, shape)  # noqa: E731
    jw, tw = worlds
    jgot, _ = _persistent_twice(jw, opname, make, ("sum",), jnp)
    tgot, tblocking = _persistent_twice(tw, opname, make, ("sum",), torch)
    for cycle in range(2):
        got = tgot[cycle].numpy()
        np.testing.assert_allclose(got, np.asarray(jgot[cycle]), rtol=1e-6,
                                   atol=1e-6)
        if opname == "allreduce" and size == "host_tier":
            np.testing.assert_allclose(got, tblocking[cycle].numpy(),
                                       rtol=1e-6, atol=1e-6)
        else:
            _assert_bitwise(tgot[cycle], tblocking[cycle], (opname, cycle))


PALLAS_CASES = {
    "allreduce": ((40,), ("sum",)), "bcast": ((40,), (3,)),
    "reduce": ((40,), ("max", 5)), "allgather": ((40,), ()),
    "reduce_scatter_block": ((8, 5), ("sum",)), "alltoall": ((8, 5), ()),
    "gather": ((40,), (3,)), "scatter": ((8, 5), (5,)),
}


def test_pallas_route_persistent_forms_match_blocking(worlds):
    """The eight PallasColl operations: the first start resolves the
    component's method once, each result is bitwise its blocking call,
    and on the CPU nothing launches (the plain versions run)."""
    _, tw = worlds
    tconfig.VARS.set("coll_pallas_priority", 100)
    try:
        pcomm = tw.dup()
    finally:
        tconfig.VARS.set("coll_pallas_priority", 30)
    counters.reset_launches()
    for opname, (shape, args) in PALLAS_CASES.items():
        assert pcomm._coll[opname][0].NAME == "pallas"
        preq = None
        for seed in (1, 2):
            x = torch.from_numpy(_rank_major(8, seed, shape))
            if preq is None:
                preq = getattr(pcomm, f"{opname}_init")(x, *args)
            else:
                preq.bind(x)
            preq.start().wait()
            _assert_bitwise(preq.result(), getattr(pcomm, opname)(x, *args),
                            opname)
    assert not any(counters.launches().values())


def test_barrier_init_starts_twice(worlds):
    jw, tw = worlds
    for comm in (jw, tw):
        preq = comm.barrier_init()
        for _ in range(2):
            preq.start()
            preq.wait(timeout=60)
        assert preq.persistent and preq.done
    assert tw.barrier_init().start().wait().error is None


def test_persistent_plan_cache_reused_and_start_skips_dispatch(worlds,
                                                               monkeypatch):
    _, tw = worlds
    comm = tw.dup()
    x = torch.from_numpy(_rank_major(8, 7, (2000,)))  # past the host tier
    preq = comm.allreduce_init(x)
    preq.start()
    preq.wait(timeout=60)
    n_plans = len(comm._plan_cache)
    calls = SPC.read("coll_allreduce_calls")

    def no_dispatch(*a, **k):
        raise AssertionError("start() went through _coll_call")

    monkeypatch.setattr(comm, "_coll_call", no_dispatch)
    starts = SPC.read("coll_persistent_allreduce_starts")
    for seed in (8, 9, 10):
        y = torch.from_numpy(_rank_major(8, seed, (2000,)))
        preq.bind(y)
        preq.start()
        preq.wait()
        assert torch.equal(preq.result(), tw.allreduce(y))
    assert len(comm._plan_cache) == n_plans
    assert SPC.read("coll_persistent_allreduce_starts") == starts + 3
    assert SPC.read("coll_allreduce_calls") == calls + 3  # tw's, not comm's
    # the plan resolved once: the decision's native plan, no host tier
    assert any(k[:2] == ("allreduce", "native") for k in comm._plan_cache)


def test_wait_before_start_and_start_all(worlds):
    _, tw = worlds
    x = torch.from_numpy(_rank_major(8, 3))
    preq = tw.allreduce_init(x)
    with pytest.raises(RequestError):
        preq.wait()
    assert preq.test() == (True, None)  # inactive: flag set, no status
    reqs = [tw.allreduce_init(x), tw.scan_init(x), tw.barrier_init()]
    assert start_all(reqs) == reqs
    statuses = trequest.wait_all(reqs, timeout=10)
    assert len(statuses) == 3
    assert torch.equal(reqs[1].result(), tw.scan(x))
    active = trequest.Request(persistent=True).start()
    with pytest.raises(RequestError):
        active.start()  # started again before it completed
    with pytest.raises(RequestError):
        trequest.CompletedRequest(1).start()  # not persistent
    jreq = ompi_tpu.world().allreduce_init(
        ompi_tpu.world().put_rank_major(_rank_major(8, 3)))
    from ompi_tpu.core.errors import RequestError as JRequestError
    with pytest.raises(JRequestError):
        jreq.wait()


# ---------------------------------------------------------------------------
# The request module, scenario by scenario on both packages
# ---------------------------------------------------------------------------

def _scenario(req, prog):
    """The JAX package's request tests (tests/test_core.py) as one
    scenario over a request module; returns what each step observed."""
    seen = []
    state = {"n": 0}

    def poll():
        state["n"] += 1
        return (state["n"] >= 3, "done")

    g = req.GeneralizedRequest(poll)
    seen.append(g.wait(timeout=5) is not None and g.result())
    reqs = [req.CompletedRequest(i) for i in range(3)]
    seen.append(len(req.wait_all(reqs, timeout=1)))
    seen.append(req.wait_any(reqs, timeout=1)[0])

    done = req.CompletedRequest("a")
    inactive = req.Request(persistent=True)
    state2 = {"n": 0}

    def poll2():
        state2["n"] += 1
        return (state2["n"] >= 2, "g")

    pending = req.GeneralizedRequest(poll2)
    seen.append(sorted(i for i, _ in req.wait_some(
        [done, inactive, pending], timeout=5)))
    seen.append(req.wait_some([inactive]))

    never = req.GeneralizedRequest(lambda: (False, None))
    done = req.CompletedRequest(7)
    seen.append(req.test_any([inactive]))
    seen.append(req.test_any([never])[:2])
    flag, idx, st = req.test_any([inactive, never, done])
    seen.append((flag, idx, st is done.status))
    seen.append(req.test_some([inactive]))
    seen.append(req.test_some([never]))
    seen.append([i for i, _ in req.test_some([never, done, inactive])])
    seen.append([i for i, _ in req.test_some([done, never])])
    seen.append(req.test_some([done]))
    seen.append(req.test_all([req.CompletedRequest(1), never])[0])

    preq = req.Request(persistent=True)
    seen.append(preq.state.value)
    preq.start()
    seen.append(req.test_some([preq, never]))
    preq._complete("one")
    seen.append([i for i, _ in req.wait_some([preq], timeout=5)])
    seen.append(req.wait_some([preq], timeout=5))
    preq.start()
    preq._complete("two")
    seen.append((preq.result(), preq.state.value))

    with pytest.raises(TimeoutError):
        never.wait(timeout=0.01)
    with pytest.raises(TimeoutError):
        req.wait_all([never], timeout=0.01)
    cb = []
    c = req.CompletedRequest(5)
    c.on_complete(lambda r: cb.append(r.result()))
    g2 = req.GeneralizedRequest(lambda: (True, 6))
    g2.on_complete(lambda r: cb.append(r.result()))
    g2.wait(timeout=1)
    seen.append(cb)
    never.cancel()
    seen.append((never.done, never.status.cancelled))

    ticks = {"n": 0}

    def pump():
        ticks["n"] += 1
        return 0

    prog.register(pump)
    try:
        seen.append(prog.ENGINE.progress_until(lambda: ticks["n"] >= 5,
                                               timeout=5.0))
        seen.append(prog.ENGINE.progress_until(lambda: False, timeout=0.01))
    finally:
        prog.unregister(pump)
    eng = prog.ProgressEngine()
    hits = {"hi": 0, "lo": 0}
    eng.register(lambda: hits.__setitem__("hi", hits["hi"] + 1) or 0)
    eng.register(lambda: hits.__setitem__("lo", hits["lo"] + 1) or 0,
                 low_priority=True)
    for _ in range(16):
        eng.progress()
    seen.append(dict(hits))
    return seen


def test_request_module_matches_jax_package():
    want = _scenario(jrequest, jprogress)
    got = _scenario(trequest, tprogress)
    assert got == want
    assert want[0] == "done" and want[-1] == {"hi": 16, "lo": 2}

