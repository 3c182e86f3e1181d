"""The rest of the port's collective surface against the JAX package's,
on the CPU.

- Scan and exscan: the three algorithms, forced by
  ``coll_tuned_{scan,exscan}_algorithm`` and by the default decision
  (with ``coll_tuned_prefer_native`` on and off), through both
  packages' TunedColl, bitwise, on a diagonal over op x dtype x n in
  {2, 3, 5, 8}. Native is ``lax.associative_scan``'s combine tree; a
  sequential ``cumsum`` of the same float32 input differs from both.
- ``decide_scan`` / ``decide_exscan`` pick the JAX package's names for
  forced, rules-file, joint and prior cases.
- The barrier; SelfColl on a one-rank communicator; SyncColl's barrier
  every N rooted operations (``coll_sync_barriers``).
- The ragged variants of XlaColl, BasicColl and the default route
  against the JAX package's, as ``tests/test_coll_vector.py`` runs them:
  bitwise, except XlaColl's ``reduce_scatter``, which sums through the
  native allreduce (PyTorch's order, not XLA's) and is held to 1e-6
  relative, as ``test_torch_colls.py`` holds native.
- The topologies and the neighborhood collectives on cart, graph and
  dist_graph (duplicate edges, the mismatched-edge ``TopologyError``).
- The communicator's info, attributes, errhandler, ``create``,
  ``from_rank_values`` and ``set_name``; ``ops.device``.
- The slice as a whole: ``init(8, device="cpu")`` through every new
  entry point, equal to the JAX package's for the same seed.
"""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch
from ompi_tpu import ops as jops
from ompi_tpu.coll import tuned as jtuned
from ompi_tpu.core import attributes as jattrs
from ompi_tpu.core import config as jconfig
from ompi_tpu.topo import topology as jtopo
from ompi_tpu_torch import ops as tops
from ompi_tpu_torch.coll import spmd as tspmd
from ompi_tpu_torch.coll import tuned as ttuned
from ompi_tpu_torch.core import attributes as tattrs
from ompi_tpu_torch.core import config as tconfig
from ompi_tpu_torch.core.counters import SPC as TSPC
from ompi_tpu_torch.core.errors import (ArgumentError, CommError,
                                        TopologyError)
from ompi_tpu_torch.core.info import Info
from ompi_tpu_torch.group import Group
from ompi_tpu_torch.ops import device as tdevice
from ompi_tpu_torch.topo import topology as ttopo

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16),
          "int32": (np.int32, jnp.int32, torch.int32)}


@pytest.fixture(scope="module")
def worlds():
    jworld = ompi_tpu.init()
    tworld = ompi_tpu_torch.init(device="cpu")
    try:
        yield jworld, tworld
    finally:
        ompi_tpu_torch.finalize()


class both_vars:
    """Set config vars in both packages for the duration of a block."""

    def __init__(self, values: dict) -> None:
        self.values = values

    def __enter__(self):
        self.old = {k: (jconfig.get(k), tconfig.get(k)) for k in self.values}
        for k, v in self.values.items():
            jconfig.VARS.set(k, v)
            tconfig.VARS.set(k, v)

    def __exit__(self, *exc):
        for k, (j, t) in self.old.items():
            jconfig.VARS.set(k, j)
            tconfig.VARS.set(k, t)


def _sub(world, n):
    if n == world.size:
        return world.dup()
    return world.split([0 if r < n else -1 for r in range(world.size)])[0]


def make_input(shape, dtype: str, seed: int, op: str = "sum") -> np.ndarray:
    """Seeded numpy input: int32 in [-1000, 1000); floats
    standard_normal scaled by 10^k per rank row (so the summation order
    shows), near 1 for products."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-1000, 1000, shape).astype(np.int32)
    x = rng.standard_normal(shape)
    if op == "prod":
        return (1 + 0.25 * x).astype(np.float32)
    scale = 10.0 ** rng.integers(-3, 4, (shape[0],) + (1,) * (len(shape) - 1))
    return (x * scale).astype(np.float32)


def to_np(v) -> np.ndarray:
    """A result of either package as numpy (bfloat16 as ml_dtypes)."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.float().numpy().astype(ml_dtypes.bfloat16)
        return v.numpy()
    return np.asarray(v)


def assert_bitwise(got, want, what=""):
    g, w = to_np(got), to_np(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (what, g.shape,
                                                       w.shape, g.dtype,
                                                       w.dtype)
    gb = g.view(np.uint16 if g.dtype.itemsize == 2 else np.uint32)
    wb = w.view(np.uint16 if w.dtype.itemsize == 2 else np.uint32)
    assert np.array_equal(gb, wb), (what, int((gb != wb).sum()))


def assert_same_tree(got, want, what=""):
    """Lists, dicts and tensors of both packages, leaf by leaf."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            assert_same_tree(got[k], want[k], f"{what}[{k}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{what}[{i}]")
    elif want is None:
        assert got is None, what
    else:
        assert_bitwise(got, want, what)


# ---------------------------------------------------------------------------
# Scan and exscan
# ---------------------------------------------------------------------------

ALGOS = ("native", "recursive_doubling", "linear_chain", "")
OPNAMES = ("sum", "prod", "max", "min")
NS = (2, 3, 5, 8)
# (scan|exscan, algorithm ("" = the default decision), op, dtype, n,
# prefer_native): a diagonal, three cases per (operation, algorithm).
PREFIX_CASES = []
for i, (which, algo) in enumerate((w, a) for w in ("scan", "exscan")
                                  for a in ALGOS):
    for j in range(3):
        PREFIX_CASES.append((
            which, algo, OPNAMES[(i + j) % 4],
            ("float32", "bfloat16", "int32")[(i + 2 * j) % 3],
            NS[(i + 3 * j) % 4], j != 1))


def _prefix(world, lib, which, algo, op, dtype, n, prefer_native, seed):
    x = make_input((n, 333), dtype, seed, op)
    var = f"coll_tuned_{which}_algorithm"
    with both_vars({var: algo, "coll_tuned_prefer_native": prefer_native}):
        comm = _sub(world, n)
        if lib is torch:
            buf = comm.put_rank_major(torch.from_numpy(x).to(
                DTYPES[dtype][2]))
        else:
            buf = comm.put_rank_major(jnp.asarray(x, DTYPES[dtype][1]))
        out = getattr(comm, which)(buf, op)
    return out, comm


@pytest.mark.parametrize("case", PREFIX_CASES, ids=[
    f"{c[0]}-{c[1] or 'default'}-{c[2]}-{c[3]}-n{c[4]}"
    f"{'' if c[5] else '-noprefer'}" for c in PREFIX_CASES])
def test_scan_exscan_match_jax_package(worlds, case):
    which, algo, op, dtype, n, prefer = case
    seed = PREFIX_CASES.index(case)
    want, jc = _prefix(worlds[0], jnp, *case, seed)
    got, tc = _prefix(worlds[1], torch, *case, seed)
    assert_bitwise(got, want, case)
    assert tc._coll[which][0].NAME == jc._coll[which][0].NAME == "tuned"
    # the same algorithm ran in both (its name is in the plan keys)
    tkeys = {k[1] for k in tc._plan_cache if k[0] == which}
    jkeys = {k[1] for k in jc._plan_cache if k[0] == which}
    assert tkeys == jkeys and len(tkeys) == 1, (tkeys, jkeys)


@pytest.mark.parametrize("route", ["xla", "basic"])
def test_scan_exscan_of_xla_and_basic_match_jax_package(worlds, route):
    """XlaColl's native scan (the associative tree) and BasicColl's
    rank-order fold (rank 0's exscan block zeros, not the identity)."""
    jw, tw = worlds
    with both_vars({"coll_select": route}):
        jc, tc = _sub(jw, 5), _sub(tw, 5)
    for which in ("scan", "exscan"):
        assert tc._coll[which][0].NAME == jc._coll[which][0].NAME == route
        for i, (op, dtype) in enumerate((("sum", "float32"),
                                         ("prod", "bfloat16"),
                                         ("max", "int32"))):
            x = make_input((5, 257), dtype, 60 + i, op)
            got = getattr(tc, which)(tc.put_rank_major(
                torch.from_numpy(x).to(DTYPES[dtype][2])), op)
            want = getattr(jc, which)(jc.put_rank_major(
                jnp.asarray(x, DTYPES[dtype][1])), op)
            assert_bitwise(got, want, (route, which, op, dtype))


@pytest.mark.parametrize("n", [5, 8])
def test_native_scan_is_the_associative_scan_not_a_cumsum(worlds, n):
    """Float32 SUM at n = 5 and 8: both packages' native scan and
    exscan are ``lax.associative_scan``'s tree, bitwise; a sequential
    cumsum of the same input, and the linear chain's fold, differ."""
    x = make_input((n, 4000), "float32", 100 + n)
    tree = np.asarray(jax.jit(lambda a: jax.lax.associative_scan(
        jnp.add, a, axis=0))(jnp.asarray(x)))
    jc, tc = _sub(worlds[0], n), _sub(worlds[1], n)
    tx = torch.from_numpy(x)
    jscan = jc.scan(jc.put_rank_major(jnp.asarray(x)), "sum")
    tscan = tc.scan(tx, "sum")
    assert_bitwise(tscan, jscan)
    assert_bitwise(tscan, tree)
    jex = jc.exscan(jc.put_rank_major(jnp.asarray(x)), "sum")
    tex = tc.exscan(tx, "sum")
    assert_bitwise(tex, jex)
    assert_bitwise(tex[1:], tree[:-1])
    assert not tex[0].any()
    cumsum = torch.cumsum(tx, 0)
    assert int((cumsum != tscan).sum()) > 0
    chain = tspmd.scan_linear_chain(tx, tops.SUM)
    assert int((chain != tscan).sum()) > 0


def test_decide_scan_exscan_match_jax_package(tmp_path):
    user_j = jops.create_op(lambda a, b: a - b, commutative=False)
    user_t = tops.create_op(lambda a, b: a - b, commutative=False)
    cases = [(jops.lookup(o), tops.lookup(o)) for o in
             ("sum", "max", "prod", "maxloc", "minloc")]
    cases.append((user_j, user_t))
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps({
        "scan": [{"max_bytes": 4096, "algorithm": "linear_chain"},
                 {"min_ranks": 6, "algorithm": "no_such_algorithm"}],
        "exscan": [{"min_bytes": 100000, "algorithm": "recursive_doubling"}],
    }))
    settings = [{}, {"coll_tuned_prefer_native": False},
                {"coll_tuned_scan_algorithm": "linear_chain",
                 "coll_tuned_exscan_algorithm": "native"},
                {"coll_tuned_rules_file": str(rules)},
                {"coll_tuned_rules_file": str(rules),
                 "coll_tuned_prefer_native": False}]
    seen = set()
    for setting in settings:
        with both_vars(setting):
            for jop, top in cases:
                for nbytes in (4, 4096, 9_999, 10_000, 1 << 20):
                    for nranks in (2, 3, 8):
                        for j, t in ((jtuned.decide_scan, ttuned.decide_scan),
                                     (jtuned.decide_exscan,
                                      ttuned.decide_exscan)):
                            want = j(jop, nbytes, nranks)
                            assert t(top, nbytes, nranks) == want, (
                                setting, jop.name, nbytes, nranks)
                            seen.add(want)
    assert seen == {"native", "recursive_doubling", "linear_chain"}
    assert ttuned._algo_space("scan") == jtuned._algo_space("scan")


# ---------------------------------------------------------------------------
# Barrier, SelfColl, SyncColl
# ---------------------------------------------------------------------------

def test_barrier(worlds):
    jw, tw = worlds
    for route in ("", "xla", "basic"):
        with both_vars({"coll_select": route}):
            jc, tc = jw.dup(), tw.dup()
        before = TSPC.read("coll_barrier_calls")
        assert tc.barrier() is None and jc.barrier() is None
        assert TSPC.read("coll_barrier_calls") == before + 1
        assert tc._coll["barrier"][0].NAME == jc._coll["barrier"][0].NAME
    c = tw.dup()
    token = c._coll["barrier"][0].barrier(c)
    assert token.dtype == torch.int32 and token.tolist() == [8] * 8
    assert ("barrier",) in c._plan_cache


def test_selfcoll_on_one_rank(worlds):
    jw, tw = worlds
    js, ts = _sub(jw, 1), _sub(tw, 1)
    for opname in ("allreduce", "scan", "exscan", "barrier", "gather",
                   "scatter", "alltoall", "reduce"):
        assert ts._coll[opname][0].NAME == js._coll[opname][0].NAME \
            == "self"
    for dtype in ("float32", "bfloat16", "int32"):
        x = make_input((1, 7), dtype, 3)
        tx = ts.put_rank_major(torch.from_numpy(x).to(DTYPES[dtype][2]))
        jx = js.put_rank_major(jnp.asarray(x, DTYPES[dtype][1]))
        assert ts.allreduce(tx) is tx and ts.scan(tx) is tx
        for op in ("sum", "prod", "max", "min"):
            assert_bitwise(ts.exscan(tx, op), js.exscan(jx, op), (dtype, op))
        assert_bitwise(ts.reduce(tx, "max", 0), js.reduce(jx, "max", 0))
        assert_bitwise(ts.allgather(tx), js.allgather(jx))
        assert_bitwise(ts.gather(tx, 0), js.gather(jx, 0))
        assert_bitwise(ts.scatter(tx, 0), js.scatter(jx, 0))
    assert ts.barrier() is None
    assert ts.allreduce_init(tx).start().wait().error is None
    # below tuned's 80, SelfColl leaves a one-rank communicator to tuned
    with both_vars({"coll_self_priority": 70}):
        assert _sub(tw, 1)._coll["allreduce"][0].NAME == "tuned"


def test_syncoll_barrier_every_n_rooted_ops(worlds):
    _, tw = worlds
    x = torch.from_numpy(make_input((8, 10), "float32", 5))
    with both_vars({"coll_sync_enable": True}):
        c = tw.dup()
    plain = tw.dup()
    assert c._coll["bcast"][0].NAME == "sync"
    assert plain._coll["bcast"][0].NAME == "tuned"
    before = TSPC.read("coll_sync_barriers")
    with both_vars({"coll_sync_barrier_before_nops": 3}):
        for i in range(7):
            assert torch.equal(c.bcast(x, i % 8), plain.bcast(x, i % 8))
        assert TSPC.read("coll_sync_barriers") == before + 2
        c.scatter(x, 0)  # the 8th rooted op
        c.gather(x, 1)  # the 9th: a barrier
        assert TSPC.read("coll_sync_barriers") == before + 3
        c.allreduce(x)  # not rooted: no count
        assert TSPC.read("coll_sync_barriers") == before + 3


# ---------------------------------------------------------------------------
# Ragged variants (tests/test_coll_vector.py's cases)
# ---------------------------------------------------------------------------

def _ragged_inputs(n, seed):
    rng = np.random.RandomState(seed)
    counts = [(r * 2 + 1) % 4 for r in range(n)]
    vals = [rng.randn(c, 3).astype(np.float32) for c in counts]
    blocks = [[rng.randn((s + d) % 3, 2).astype(np.float32)
               for d in range(n)] for s in range(n)]
    wblocks = [[np.full((1, s + 1), s * n + d,
                        np.int32 if (s + d) % 2 else np.float32)
                for d in range(n)] for s in range(n)]
    rs_counts = [(r + 1) % 3 for r in range(n)]
    rs_vals = [rng.randn(sum(rs_counts), 2).astype(np.float32)
               for _ in range(n)]
    return vals, blocks, wblocks, rs_counts, rs_vals


def _ragged_call(comm, opname, inputs, torch_side):
    vals, blocks, wblocks, rs_counts, rs_vals = inputs
    conv = (lambda a: torch.from_numpy(a)) if torch_side else (lambda a: a)
    if opname == "allgatherv":
        return comm.allgatherv([conv(v) for v in vals])
    if opname == "gatherv":
        return comm.gatherv([conv(v) for v in vals], root=comm.size - 1)
    if opname == "scatterv":
        return comm.scatterv([conv(v) for v in vals], root=0)
    if opname == "alltoallv":
        return comm.alltoallv([[conv(b) for b in row] for row in blocks])
    if opname == "alltoallw":
        return comm.alltoallw([[conv(b) for b in row] for row in wblocks])
    return comm.reduce_scatter([conv(v) for v in rs_vals], rs_counts, "sum")


RAGGED = ("allgatherv", "gatherv", "scatterv", "alltoallv", "alltoallw",
          "reduce_scatter")
RAGGED_CASES = [(route, opname) for route in ("", "basic") for opname in
                RAGGED] + [("xla", o) for o in ("allgatherv", "alltoallv",
                                                 "reduce_scatter")]


@pytest.mark.parametrize("route,opname", RAGGED_CASES,
                         ids=[f"{r or 'default'}-{o}" for r, o in
                              RAGGED_CASES])
def test_ragged_variants_match_jax_package(worlds, route, opname):
    jw, tw = worlds
    with both_vars({"coll_select": route}):
        jc, tc = jw.dup(), tw.dup()
    assert tc._coll[opname][0].NAME == jc._coll[opname][0].NAME
    inputs = _ragged_inputs(8, RAGGED.index(opname))
    want = _ragged_call(jc, opname, inputs, False)
    got = _ragged_call(tc, opname, inputs, True)
    leaves = got if isinstance(got, list) else [got]
    for leaf in leaves:
        for t in (leaf if isinstance(leaf, list) else [leaf]):
            assert t.device == tc.device
    if route == "xla" and opname == "reduce_scatter":
        # XlaColl sums through its native allreduce: PyTorch's order
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
        return
    assert_same_tree(got, want, opname)


def test_ragged_argument_errors(worlds):
    _, tw = worlds
    c = tw.dup()
    with pytest.raises(ArgumentError):
        c.allgatherv([torch.ones(2, 3)] * 7)
    with pytest.raises(ArgumentError):
        c.reduce_scatter([torch.zeros(4, 1)] * 8, [1] * 8)  # 8 != 4 rows
    with pytest.raises(ArgumentError):
        c.alltoallv([[torch.ones(1)] * 8] * 3)
    with both_vars({"coll_select": "xla"}):
        x = tw.dup()
    with pytest.raises(CommError):
        x.gatherv([torch.ones(1)] * 8)  # no component provides it there


# ---------------------------------------------------------------------------
# Topologies and neighborhood collectives
# ---------------------------------------------------------------------------

def test_cart_topology_matches_jax_package(worlds):
    jw, tw = worlds
    assert ttopo.dims_create(8, 2) == jtopo.dims_create(8, 2)
    assert ttopo.dims_create(12, 3) == jtopo.dims_create(12, 3)
    jcart = jtopo.cart_create(jw, [2, 4], [False, True])
    tcart = ttopo.cart_create(tw, [2, 4], [False, True])
    assert tcart.name == jcart.name.replace(jw.name, tw.name)
    for r in range(8):
        assert tcart.topo.coords(r) == jcart.topo.coords(r)
        assert tcart.topo.neighbors(r) == jcart.topo.neighbors(r)
        for d in (0, 1):
            for disp in (1, -1, 2):
                assert tcart.topo.shift_for(r, d, disp) == \
                    jcart.topo.shift_for(r, d, disp)
    with pytest.raises(TopologyError):
        tcart.topo.rank([2, 0])
    subs_t, subs_j = tcart.topo.sub([False, True]), jcart.topo.sub(
        [False, True])
    assert sorted(subs_t) == sorted(subs_j)
    for key in subs_j:
        assert subs_t[key].group.world_ranks == \
            subs_j[key].group.world_ranks
        assert subs_t[key].topo.dims == subs_j[key].topo.dims
    with pytest.raises(ArgumentError, match="Queue 1 item 7"):
        ttopo.cart_create(tw, [8], [True], reorder=True)
    with pytest.raises(ArgumentError):
        ttopo.cart_create(tw, [3, 2])


def _neighbor_case(world, topo_mod, lib, kind, sub):
    """A topology communicator of ``kind`` and its neighbor collectives'
    results on seeded inputs."""
    comm = _sub(world, sub)
    n = comm.size
    if kind == "cart":
        new = topo_mod.cart_create(comm, [2, 4], [True, True])
    elif kind == "ring2":
        new = topo_mod.cart_create(comm, [2], [True])
    elif kind == "graph":
        index, edges = [2, 4, 6, 8], [1, 3, 0, 2, 1, 3, 0, 2]
        new = topo_mod.graph_create(comm, index, edges)
    else:
        srcs = {r: [(r - 1) % n, (r - 2) % n] for r in range(n)}
        dsts = {r: [(r + 2) % n, (r + 1) % n] for r in range(n)}
        new = topo_mod.dist_graph_create(comm, srcs, dsts)
    x = make_input((n, 3), "float32", 7)
    _, ins = topo_mod.edge_fns(new.topo)
    outs, _ = topo_mod.edge_fns(new.topo)
    rng = np.random.default_rng(8)
    send = {r: rng.standard_normal((len(outs(r)), 2)).astype(np.float32)
            for r in range(n)}
    if lib is torch:
        ag = new.neighbor_allgather(torch.from_numpy(x))
        a2a = new.neighbor_alltoall({r: torch.from_numpy(v)
                                     for r, v in send.items()})
    else:
        ag = new.neighbor_allgather(new.put_rank_major(x))
        a2a = new.neighbor_alltoall(send)
    return ag, a2a, new


@pytest.mark.parametrize("kind,sub", [("cart", 8), ("ring2", 2),
                                      ("graph", 4), ("dist_graph", 8)])
def test_neighbor_collectives_match_jax_package(worlds, kind, sub):
    jag, ja2a, jnew = _neighbor_case(worlds[0], jtopo, jnp, kind, sub)
    tag, ta2a, tnew = _neighbor_case(worlds[1], ttopo, torch, kind, sub)
    assert_same_tree(tag, jag, "neighbor_allgather")
    assert_same_tree(ta2a, ja2a, "neighbor_alltoall")
    if kind in ("cart", "ring2"):
        # a periodic dim of size 2 lists one neighbor twice: both blocks
        # arrive, in order
        nb = tnew.topo.neighbors(0)
        assert nb[0] == nb[1] and nb == jnew.topo.neighbors(0)


def test_neighbor_errors(worlds):
    _, tw = worlds
    with pytest.raises(TopologyError):
        tw.dup().neighbor_allgather(torch.ones(8, 2))  # no topology
    bad = ttopo.dist_graph_create(tw, {0: [1]}, {})  # 1 never sends to 0
    with pytest.raises(TopologyError):
        bad.neighbor_alltoall({r: torch.ones(0, 2) for r in range(8)})
    jbad = jtopo.dist_graph_create(ompi_tpu.world(), {0: [1]}, {})
    from ompi_tpu.core.errors import TopologyError as JTopologyError
    with pytest.raises(JTopologyError):
        jbad.neighbor_alltoall({r: np.ones((0, 2), np.float32)
                                for r in range(8)})
    with pytest.raises(ArgumentError):
        ttopo.graph_create(tw, [1, 2], [1, 0])  # index not one per rank


# ---------------------------------------------------------------------------
# Communicator methods, ops.device
# ---------------------------------------------------------------------------

def test_comm_info_attributes_create_and_names(worlds):
    _, tw = worlds
    copied = tattrs.create_keyval(copy_fn=lambda o, k, v: (True, v + 1))
    dropped = tattrs.create_keyval()
    deleted = []
    kept = tattrs.create_keyval(
        copy_fn=lambda o, k, v: (True, v),
        delete_fn=lambda o, k, v: deleted.append(v))
    c = tw.dup(info=Info({"hint": "a"}))
    c.set_attr(copied, 1)
    c.set_attr(dropped, 2)
    c.set_attr(kept, 3)
    d = c.dup()
    assert d.info.get("hint") == "a" and d.info is not c.info
    assert d.get_attr(copied) == (True, 2)
    assert d.get_attr(dropped) == (False, None)
    assert d.get_attr(kept) == (True, 3)
    d.free()
    assert deleted == [3]
    e = c.dup(info=Info({"hint": "b"}))
    assert e.info.get("hint") == "b"
    c.set_name("renamed")
    assert c.name == "renamed"
    assert c.get_errhandler().name == "ERRORS_RETURN"
    sub = tw.create(Group([1, 3, 5]))
    assert sub.size == 3 and sub.group.world_ranks == (1, 3, 5)
    assert sub.topo is None
    with pytest.raises(ArgumentError):
        sub.create(Group([0]))
    vals = [np.full(4, r, np.float32) for r in range(8)]
    x = tw.from_rank_values(vals)
    assert x.shape == (8, 4) and x.device == tw.device and x.is_contiguous()
    assert torch.equal(x[:, 0], torch.arange(8, dtype=torch.float32))
    with pytest.raises(ArgumentError):
        tw.from_rank_values(vals[:3])
    assert jattrs.create_keyval() > 0  # the JAX package's registry apart


def test_ops_device_matches_jax_package():
    from ompi_tpu.ops import device as jdevice

    rng = np.random.default_rng(0)
    a = rng.standard_normal(40).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    assert_bitwise(tdevice.reduce_local("sum", torch.from_numpy(a),
                                        torch.from_numpy(b)),
                   jdevice.reduce_local("sum", jnp.asarray(a),
                                        jnp.asarray(b)))
    stacked = rng.uniform(1, 2, (5, 3)).astype(np.float32)
    for op in ("prod", "max", "min"):
        assert_bitwise(tdevice.reduce_ranks(torch.from_numpy(stacked), op),
                       jdevice.reduce_ranks(jnp.asarray(stacked), op), op)
    np.testing.assert_allclose(
        tdevice.reduce_ranks(torch.from_numpy(stacked), "sum").numpy(),
        stacked.sum(0), rtol=1e-6)


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------

def _drive(world, lib, cart_mod):
    """Every new entry point of one package on the same seeded inputs."""
    n = world.size
    rng = np.random.default_rng(42)
    x = make_input((n, 50), "float32", 42)
    sq = make_input((n, n, 6), "int32", 43)
    put = (lambda a: world.put_rank_major(torch.from_numpy(a))) \
        if lib is torch else (lambda a: world.put_rank_major(a))
    conv = torch.from_numpy if lib is torch else (lambda a: a)
    vals = [conv(rng.standard_normal((r % 3 + 1, 2)).astype(np.float32))
            for r in range(n)]
    blocks = [[conv(rng.standard_normal(((s * d) % 4, 1)).astype(np.float32))
               for d in range(n)] for s in range(n)]
    out = {}
    out["scan"] = world.scan(put(x), "max")
    out["exscan"] = world.exscan(put(x), "min")
    out["barrier"] = world.barrier()
    out["allgatherv"] = world.allgatherv(vals)
    out["gatherv"] = world.gatherv(vals, root=2)
    out["scatterv"] = world.scatterv(vals, root=1)
    out["alltoallv"] = world.alltoallv(blocks)
    out["alltoallw"] = world.alltoallw(blocks)
    out["reduce_scatter"] = world.reduce_scatter(
        [conv(v) for v in make_input((n, 24, 2), "int32", 44)], [3] * n,
        "sum")
    cart = cart_mod.cart_create(world, [2, n // 2], [True, False])
    out["neighbor_allgather"] = cart.neighbor_allgather(put(x))
    out["neighbor_alltoall"] = cart.neighbor_alltoall(
        {r: conv(np.full((len(cart.topo.neighbors(r)), 2), r, np.float32))
         for r in range(n)})
    preq = world.alltoall_init(put(sq))
    for _ in range(2):
        preq.start()
        preq.wait()
    out["alltoall_init"] = preq.result()
    preq = world.scan_init(put(x), "sum")
    preq.start()
    preq.wait()
    out["scan_init"] = preq.result()
    return out


def test_slice_whole_path_matches_jax_package(worlds):
    assert ompi_tpu_torch.init(8, device="cpu") is worlds[1]
    want = _drive(ompi_tpu.world(), jnp, jtopo)
    got = _drive(ompi_tpu_torch.world(), torch, ttopo)
    assert sorted(got) == sorted(want)
    for key in want:
        assert_same_tree(got[key], want[key], key)
