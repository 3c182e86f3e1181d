"""The port's bcast, reduce, allgather and reduce_scatter_block (and the
``pallas_rsag`` allreduce) against the JAX package's, on the CPU.

- Parity, exact: the same numpy inputs go through ``ompi_tpu`` (its
  Pallas kernels in TPU-interpret mode on the 8-device CPU mesh) and
  ``ompi_tpu_torch`` on ``device="cpu"`` (the kernels' plain versions,
  the protocol simulators). Each case runs the JAX package once, along
  one route (PallasColl at priority 100, or TunedColl with the forced
  kernel name; the result is cached per module), and the port along
  both routes. The cases are a diagonal over op x dtype x n in
  {2, 3, 8}, trees at two roots, ragged sizes (not multiples of 128).
  Exact because every element folds at the same ranks in the same
  order, bfloat16 in float32 rounded once per step on both sides.
- Sweeps, exact: reduce-scatter and tree reduce over every op x dtype at
  n in {2, 3, 4, 8} on the port's simulators against numpy oracles that
  fold in the kernels' orders (bfloat16 through ml_dtypes, which also
  computes in float32 and rounds once); allgather and bcast over every
  dtype.
- Native and basic: XlaColl and BasicColl for the four ops against the
  JAX package's. Native float sums are PyTorch's, not XLA's: held to
  1e-6 relative (as in test_torch_comm.py); everything else exact.
  Native bcast copies root's row where the JAX package masks and sums,
  so a root ``-0.0`` arrives there as ``+0.0``; the comparison is by
  value, which treats the two as equal.
- Decisions: every ``decide_*`` of the four ops picks the JAX package's
  name for forced, guarded and prior cases.
- Interleavings of the tree simulators under 200 seeded random
  schedules (the ring halves' are in test_torch_pallas_ring.py).

The kernels themselves, on a card, are tested in test_torch_kernels.py.
"""

import random

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch
from ompi_tpu import ops as jops
from ompi_tpu.coll import tuned as jtuned
from ompi_tpu.coll.framework import COLL as JCOLL
from ompi_tpu.core import config as jconfig
from ompi_tpu_torch import ops as tops
from ompi_tpu_torch.coll import pallas_ring as pr
from ompi_tpu_torch.coll import tuned as ttuned
from ompi_tpu_torch.coll.framework import COLL as TCOLL
from ompi_tpu_torch.core import config as tconfig
from ompi_tpu_torch.core import counters
from ompi_tpu_torch.core.errors import ArgumentError, RankError

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16),
          "int32": (np.int32, jnp.int32, torch.int32)}
NP_OPS = {"sum": np.add, "prod": np.multiply, "max": np.maximum,
          "min": np.minimum}
# The forced TunedColl name of each operation's kernel.
TUNED_VAR = {
    "bcast": ("coll_tuned_bcast_algorithm", "pallas_binomial"),
    "reduce": ("coll_tuned_reduce_algorithm", "pallas_tree"),
    "allgather": ("coll_tuned_allgather_algorithm", "pallas_ring"),
    "reduce_scatter_block": ("coll_tuned_reduce_scatter_algorithm",
                             "pallas_ring"),
    "allreduce": ("coll_tuned_allreduce_algorithm", "pallas_rsag"),
}


def make_input(shape, dtype: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-1000, 1000, shape).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32)


def as_f64(t) -> np.ndarray:
    """float64 numpy copy, exact for int32 and for bfloat16."""
    if isinstance(t, torch.Tensor):
        return t.to(torch.float64).numpy()
    if jnp.issubdtype(t.dtype, jnp.integer):
        return np.asarray(t).astype(np.float64)
    return np.asarray(jnp.asarray(t, jnp.float32)).astype(np.float64)


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


def _comm(world, n, route: str, opname: str):
    """A size-n communicator of ``world`` whose ``opname`` goes through
    ``route``: "pallas" (PallasColl at priority 100) or "tuned" (TunedColl,
    the kernel forced by name while the caller holds the var)."""
    prio = 100 if route == "pallas" else 30
    with both_vars({"coll_pallas_priority": prio}):
        comm = _sub(world, n)
    assert comm._coll[opname][0].NAME == route, comm._coll[opname][0]
    return comm


def _call(comm, opname, x, op, root):
    if opname == "bcast":
        return comm.bcast(x, root)
    if opname == "reduce":
        return comm.reduce(x, op, root)
    if opname == "allgather":
        return comm.allgather(x)
    if opname == "reduce_scatter_block":
        return comm.reduce_scatter_block(x, op)
    return comm.allreduce(x, op)


def _shape(opname, n, elems):
    return (n, n, elems) if opname == "reduce_scatter_block" else (n, elems)


def _run(world, lib_dtype, route, opname, n, dtype, op, root, elems, seed):
    """One call of ``opname`` through ``route`` of one package; returns
    (float64 result, the communicator)."""
    x = make_input(_shape(opname, n, elems), dtype, seed)
    var, algo = TUNED_VAR[opname]
    with both_vars({var: algo if route == "tuned" else ""}):
        comm = _comm(world, n, route, opname)
        if lib_dtype is torch:
            buf = comm.put_rank_major(torch.from_numpy(x).to(
                DTYPES[dtype][2]))
        else:
            buf = comm.put_rank_major(jnp.asarray(x, DTYPES[dtype][1]))
        out = _call(comm, opname, buf, op, root)
    return as_f64(out), comm


# (operation, n, dtype, op, root, elems per rank or per block, the JAX
# package's route). A diagonal: every op, dtype and n on each operation.
CASES = [
    ("bcast", 2, "float32", None, 1, 100, "pallas"),
    ("bcast", 3, "bfloat16", None, 2, 300, "tuned"),
    ("bcast", 8, "int32", None, 0, 128, "pallas"),
    ("bcast", 8, "float32", None, 5, 77, "tuned"),
    ("reduce", 2, "int32", "prod", 0, 256, "tuned"),
    ("reduce", 3, "float32", "sum", 1, 333, "pallas"),
    ("reduce", 3, "bfloat16", "max", 0, 128, "tuned"),
    ("reduce", 8, "bfloat16", "sum", 6, 200, "pallas"),
    ("reduce", 8, "int32", "max", 5, 1000, "tuned"),
    ("reduce", 8, "float32", "min", 0, 129, "pallas"),
    ("reduce_scatter_block", 2, "bfloat16", "min", None, 50, "pallas"),
    ("reduce_scatter_block", 3, "float32", "sum", None, 33, "tuned"),
    ("reduce_scatter_block", 3, "int32", "prod", None, 128, "pallas"),
    ("reduce_scatter_block", 8, "float32", "max", None, 130, "tuned"),
    ("reduce_scatter_block", 8, "bfloat16", "sum", None, 64, "pallas"),
    ("reduce_scatter_block", 8, "int32", "sum", None, 200, "tuned"),
    ("allgather", 2, "int32", None, None, 300, "pallas"),
    ("allgather", 3, "float32", None, None, 128, "tuned"),
    ("allgather", 8, "bfloat16", None, None, 77, "pallas"),
    ("allreduce", 2, "int32", "max", None, 150, "tuned"),
    ("allreduce", 3, "bfloat16", "sum", None, 100, "tuned"),
    ("allreduce", 8, "float32", "prod", None, 300, "tuned"),
]
_JAX_OUT: dict = {}


def _jax_out(worlds, case):
    """The JAX package's result for a case, computed once per module."""
    if case not in _JAX_OUT:
        opname, n, dtype, op, root, elems, route = case
        out, comm = _run(worlds[0], jnp, route, opname, n, dtype, op, root,
                         elems, seed=CASES.index(case))
        # the JAX package really ran the kernel's route (a tuned breaker
        # would otherwise have degraded silently to another algorithm)
        tag = "pallas" if route == "pallas" else TUNED_VAR[opname][1]
        assert any(k[1] == tag for k in comm._plan_cache), \
            list(comm._plan_cache)
        _JAX_OUT[case] = out
    return _JAX_OUT[case]


# Both of the port's routes per case; pallas_rsag is a TunedColl name
# only (PallasColl's allreduce tiers are in test_torch_pallas_ring.py).
ROUTED = [(case, route) for case in CASES
          for route in (("tuned",) if case[0] == "allreduce"
                        else ("pallas", "tuned"))]


@pytest.mark.parametrize("case,route", ROUTED, ids=[
    f"{c[0]}-n{c[1]}-{c[2]}-{c[3]}-r{c[4]}-{r}" for c, r in ROUTED])
def test_port_matches_jax_package(worlds, case, route):
    opname, n, dtype, op, root, elems, _ = case
    want = _jax_out(worlds, case)
    got, comm = _run(worlds[1], torch, route, opname, n, dtype, op, root,
                     elems, seed=CASES.index(case))
    tag = "pallas" if route == "pallas" else TUNED_VAR[opname][1]
    assert any(k[1] == tag for k in comm._plan_cache), list(comm._plan_cache)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,dtype,op", [(2, "int32", "sum"),
                                        (3, "bfloat16", "max"),
                                        (8, "float32", "prod")])
def test_rsag_is_bitwise_the_ring(n, dtype, op):
    x = torch.from_numpy(make_input((n, 1000), dtype, n)).to(
        DTYPES[dtype][2])
    a, b = pr.allreduce_block_rsag(x, op), pr.allreduce_block(x, op)
    assert a.dtype == b.dtype and torch.equal(a, b)


def test_noncommutative_reduce_goes_to_basic_and_matches(worlds):
    jw, tw = worlds
    x = make_input((8, 45), "float32", 11)
    jop = jops.create_op(lambda a, b: a * 0.5 - b, commutative=False)
    top = tops.create_op(lambda a, b: a * 0.5 - b, commutative=False)
    with both_vars({"coll_pallas_priority": 100}):
        jc, tc = jw.dup(), tw.dup()
    assert tc._coll["reduce"][0].NAME == "pallas"
    j = as_f64(jc.reduce(jc.put_rank_major(x), jop, 3))
    t = as_f64(tc.reduce(tc.put_rank_major(torch.from_numpy(x)), top, 3))
    assert not tc._plan_cache  # no tree plan: the basic fold ran
    np.testing.assert_array_equal(t, j)


# ---------------------------------------------------------------------------
# Native (XlaColl) and the linear oracle (BasicColl)
# ---------------------------------------------------------------------------

NATIVE_CASES = [  # (operation, op, dtype)
    ("bcast", None, "float32"), ("bcast", None, "int32"),
    ("reduce", "sum", "float32"), ("reduce", "max", "bfloat16"),
    ("reduce", "prod", "int32"),
    ("allgather", None, "bfloat16"),
    ("reduce_scatter_block", "sum", "float32"),
    ("reduce_scatter_block", "min", "int32"),
    ("reduce_scatter_block", "prod", "float32"),
]


@pytest.mark.parametrize("component", ["xla", "basic"])
@pytest.mark.parametrize("opname,op,dtype", NATIVE_CASES)
def test_native_and_basic_match_jax_package(worlds, component, opname, op,
                                            dtype):
    jw, tw = worlds
    n, root = 8, 5
    x = make_input(_shape(opname, n, 203), dtype, seed=len(opname))
    if opname == "bcast" and dtype == "float32":
        x[root, :3] = -0.0  # arrives as +0.0 in the JAX package's native
    jc, tc = jw.dup(), tw.dup()
    args = {"bcast": (root,), "reduce": (op, root), "allgather": (),
            "reduce_scatter_block": (op,)}[opname]
    j = as_f64(getattr(JCOLL.component(component), opname)(
        jc, jc.put_rank_major(jnp.asarray(x, DTYPES[dtype][1])), *args))
    t = as_f64(getattr(TCOLL.component(component), opname)(
        tc, tc.put_rank_major(torch.from_numpy(x).to(DTYPES[dtype][2])),
        *args))
    assert t.shape == j.shape
    if component == "xla" and op == "sum" and dtype == "float32":
        # PyTorch and XLA sum in different orders: float32 round-off.
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-5)
    else:
        np.testing.assert_array_equal(t, j)


def test_size_one_and_argument_errors(worlds):
    _, tw = worlds
    solo = tw.split([0] + [-1] * 7)[0]
    x = solo.put_rank_major(np.arange(6, dtype=np.float32).reshape(1, 6))
    for route in ("pallas", "tuned", "xla"):
        with both_vars({"coll_select": route}):
            c = solo.dup()
        assert torch.equal(c.bcast(x), x)
        assert torch.equal(c.reduce(x, "sum"), x[0])
        assert c.allgather(x).shape == (1, 1, 6)
        assert c.reduce_scatter_block(x.reshape(1, 1, 6), "sum").shape \
            == (1, 6)
    c = tw.dup()
    with pytest.raises(RankError):
        c.bcast(torch.ones(8, 4), root=8)
    with pytest.raises(RankError):
        c.reduce(torch.ones(8, 4), "sum", root=-1)
    with pytest.raises(ArgumentError):
        c.reduce_scatter_block(torch.ones(8, 3, 4), "sum")
    with both_vars({"coll_tuned_bcast_algorithm": "no_such_algorithm"}):
        with pytest.raises(ArgumentError):  # a name neither package has
            tw.dup().bcast(torch.ones(8, 4), 0)


# ---------------------------------------------------------------------------
# Decision layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefer_native", [True, False])
def test_decisions_match_jax_package(prefer_native):
    user = (jops.create_op(lambda a, b: a - b, commutative=False),
            tops.create_op(lambda a, b: a - b, commutative=False))
    ops = [(jops.lookup(name), tops.lookup(name))
           for name in ("sum", "max", "prod", "maxloc")] + [user]
    sizes = (4, 9_999, 10_000, 1 << 20, (1 << 20) + 1, 1 << 30)
    with both_vars({"coll_tuned_prefer_native": prefer_native}):
        for nbytes in sizes:
            for nranks in (2, 3, 8):
                for fn in ("decide_bcast", "decide_allgather"):
                    assert getattr(ttuned, fn)(nbytes, nranks) == \
                        getattr(jtuned, fn)(nbytes, nranks), (fn, nbytes)
                for jop, top in ops:
                    for fn in ("decide_reduce", "decide_reduce_scatter"):
                        assert getattr(ttuned, fn)(top, nbytes, nranks) == \
                            getattr(jtuned, fn)(jop, nbytes, nranks), \
                            (fn, jop.name, nbytes, nranks)
        for var, algo in TUNED_VAR.values():
            with both_vars({var: algo}):
                assert ttuned.decide_bcast(64, 4) == \
                    jtuned.decide_bcast(64, 4)
                assert ttuned.decide_allgather(64, 4) == \
                    jtuned.decide_allgather(64, 4)
                assert ttuned.decide_reduce(user[1], 64, 4) == \
                    jtuned.decide_reduce(user[0], 64, 4)
                assert ttuned.decide_reduce_scatter(user[1], 64, 4) == \
                    jtuned.decide_reduce_scatter(user[0], 64, 4)


# ---------------------------------------------------------------------------
# Simulator sweeps against numpy oracles (the port alone)
# ---------------------------------------------------------------------------

def rs_oracle(x: np.ndarray, op: str, dtype: str) -> np.ndarray:
    """Block b folded in ring order from rank b+1 round to rank b."""
    n = x.shape[0]
    v, f = x.astype(DTYPES[dtype][0]), NP_OPS[op]
    out = []
    for b in range(n):
        acc = v[(b + 1) % n, b]
        for k in range(2, n + 1):
            acc = f(acc, v[(b + k) % n, b])
        out.append(acc)
    return np.stack(out).astype(np.float64)


def tree_oracle(x: np.ndarray, op: str, dtype: str, root: int) -> np.ndarray:
    """The binomial fold: in round k, relative rank rel (low k+1 bits 0)
    takes combine(acc[rel], acc[rel + 2^k])."""
    n = x.shape[0]
    f = NP_OPS[op]
    acc = [x.astype(DTYPES[dtype][0])[(rel + root) % n] for rel in range(n)]
    bit = 1
    while bit < n:
        for rel in range(0, n, 2 * bit):
            if rel + bit < n:
                acc[rel] = f(acc[rel], acc[rel + bit])
        bit <<= 1
    return acc[0].astype(np.float64)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("op", sorted(NP_OPS))
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_reductions_sweep_match_oracles(n, op, dtype):
    x = make_input((n, n, 131), dtype, seed=n * 10 + len(op))
    t = torch.from_numpy(x).to(DTYPES[dtype][2])
    got = pr.reduce_scatter_block(t, op)
    assert got.shape == (n, 131) and got.dtype == t.dtype
    np.testing.assert_array_equal(as_f64(got), rs_oracle(x, op, dtype))
    flat = t[:, 0]
    for root in {0, n // 2, n - 1}:
        got = pr.reduce_block(flat, op, root)
        np.testing.assert_array_equal(as_f64(got[root]),
                                      tree_oracle(x[:, 0], op, dtype, root))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", [2, 3, 8])
def test_data_movers_sweep(n, dtype):
    x = torch.from_numpy(make_input((n, 5, 27), dtype, seed=n)).to(
        DTYPES[dtype][2])
    got = pr.allgather_block(x)
    assert got.shape == (n, n, 5, 27)
    assert all(torch.equal(got[r], x) for r in range(n))
    for root in range(n):
        got = pr.bcast_block(x, root)
        assert torch.equal(got, x[root].expand_as(x))


def test_layouts_match_the_jax_padding():
    flat, pad, shape = pr._pad_chunk(torch.zeros(3, 5, 7))
    assert flat.shape == (3, 128) and pad == 128 - 35 and shape == (5, 7)
    flat, pad, shape = pr._pad_chunk(torch.zeros(4, 4, 130), lead=2)
    assert flat.shape == (4, 4, 256) and pad == 126 and shape == (130,)
    out = pr._unpad(torch.arange(2 * 3 * 128).reshape(2, 3, 128), 128 - 35,
                    (5, 7))
    assert out.shape == (2, 3, 5, 7) and int(out[1, 2, 4, 6]) == \
        (1 * 3 + 2) * 128 + 34


# ---------------------------------------------------------------------------
# Interleavings of the tree protocols
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 4, 8])
@pytest.mark.parametrize("tree", ["reduce", "bcast"])
def test_tree_protocols_exact_under_random_interleavings(tree, n):
    flat = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (n, 256)).astype(np.float32))
    op = tops.lookup("sum")
    for root in (0, n - 1):
        if tree == "reduce":
            run = lambda rng: pr.simulate_tree_reduce(  # noqa: E731
                flat, op, root, rng=rng)
        else:
            run = lambda rng: pr.simulate_tree_bcast(  # noqa: E731
                flat, root, rng=rng)
        want, residue = run(None)
        assert not residue
        for seed in range(200):
            out, residue = run(random.Random(seed))
            assert not residue, (root, seed, residue)
            assert torch.equal(out, want), (root, seed)


# ---------------------------------------------------------------------------
# Wrappers: CPU tensors take the plain version; bad inputs raise.
# ---------------------------------------------------------------------------

def test_cpu_wrappers_use_plain_versions_without_launching():
    before = counters.launches()
    x = torch.ones(4, 4, 128)
    assert torch.equal(pr.ring_reduce_scatter(x, "sum"),
                       torch.full((4, 128), 4.0))
    assert torch.equal(pr.ring_allgather(x[:, 0]), x)
    assert torch.equal(pr.tree_reduce(x[:, 0], "max", 2), x[:, 0])
    assert torch.equal(pr.tree_bcast(x[:, 0], 3), x[:, 0])
    assert counters.launches() == before


def test_new_kernel_input_validation():
    with pytest.raises(ArgumentError):
        pr.ring_reduce_scatter(torch.ones(3, 2, 128), "sum")
    with pytest.raises(ArgumentError):
        pr.ring_allgather(torch.ones(3, 3, 128))
    with pytest.raises(ArgumentError):
        pr.tree_reduce(torch.ones(3, 128), "sum", root=3)
    with pytest.raises(ArgumentError):
        pr.tree_bcast(torch.ones(3, 128), root=-1)
    with pytest.raises(ArgumentError):
        pr.simulate_ring(torch.ones(2, 2, 8), None, phase="bogus")
