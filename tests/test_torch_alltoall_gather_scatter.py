"""The port's alltoall, gather, scatter and bidirectional-ring allreduce
against the JAX package's, on the CPU.

- Parity, exact: the same numpy inputs go through ``ompi_tpu`` (its
  Pallas kernels in TPU-interpret mode on the 8-device CPU mesh) and
  ``ompi_tpu_torch`` on ``device="cpu"`` (the kernels' plain versions,
  the protocol simulators). Each case runs the JAX package once, along
  one route, and the port along both: PallasColl at priority 100 (with
  ``coll_pallas_bidir=1`` for the allreduce), and TunedColl with the
  kernel's name forced (``pallas_linear``, ``pallas_bidir``) or, for
  alltoall, which has no kernel name in tuned, its default route. The
  cases are a diagonal over dtype x n in {2, 3, 8} x roots, at ragged
  sizes (not multiples of 128). Exact: the data movers copy bits, and
  the bidirectional ring folds every element at the same ranks in the
  same order in both packages (bfloat16 in float32, rounded once per
  step).
- The spmd algorithms (``pairwise``, ``bruck``, gather and scatter
  ``binomial``), forced in both packages' TunedColl: exact.
- Native and basic: XlaColl and BasicColl for the three ops against
  the JAX package's: exact (data movement).
- Decisions: ``decide_alltoall``, ``decide_gather`` and
  ``decide_scatter`` pick the JAX package's name for forced and prior
  cases; the default tuned route runs at every prior's size.

The protocols' interleavings are in test_torch_pallas_ring.py; the
kernels themselves, on a card, in test_torch_kernels.py.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch
from ompi_tpu.coll import tuned as jtuned
from ompi_tpu.coll.framework import COLL as JCOLL
from ompi_tpu.core import config as jconfig
from ompi_tpu_torch.coll import pallas_ring as pr
from ompi_tpu_torch.coll import tuned as ttuned
from ompi_tpu_torch.coll.framework import COLL as TCOLL
from ompi_tpu_torch.core import config as tconfig
from ompi_tpu_torch.core import counters
from ompi_tpu_torch.core.errors import ArgumentError, RankError

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16),
          "int32": (np.int32, jnp.int32, torch.int32)}
# The kernel's TunedColl route: (var, name), or None for tuned's default.
TUNED_VAR = {
    "alltoall": None,
    "gather": ("coll_tuned_gather_algorithm", "pallas_linear"),
    "scatter": ("coll_tuned_scatter_algorithm", "pallas_linear"),
    "allreduce": ("coll_tuned_allreduce_algorithm", "pallas_bidir"),
}
# Both packages: the bidirectional ring on PallasColl, also below the
# recursive-doubling cutoff.
BIDIR_VARS = {"coll_pallas_bidir": True, "coll_pallas_rd_cutoff_bytes": 0}


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


def _shape(opname, n, elems):
    return (n, n, elems) if opname == "alltoall" else (n, elems)


def _run(world, lib, route, opname, n, dtype, root, elems, seed):
    """One call of ``opname`` through ``route`` ("pallas" or "tuned") of
    one package; returns (float64 result, the communicator)."""
    x = make_input(_shape(opname, n, elems), dtype, seed)
    forced = TUNED_VAR[opname]
    vars_ = dict(BIDIR_VARS if opname == "allreduce" else {},
                 coll_pallas_priority=100 if route == "pallas" else 30)
    if forced is not None:
        vars_[forced[0]] = forced[1] if route == "tuned" else ""
    with both_vars(vars_):
        comm = _sub(world, n)
        assert comm._coll[opname][0].NAME == route
        if lib is torch:
            buf = torch.from_numpy(x).to(DTYPES[dtype][2])
        else:
            buf = jnp.asarray(x, DTYPES[dtype][1])
        if opname == "scatter":
            out = comm.scatter(buf, root)  # root's buffer, as it is
        else:
            buf = comm.put_rank_major(buf)
            if opname == "alltoall":
                out = comm.alltoall(buf)
            elif opname == "gather":
                out = comm.gather(buf, root)
            else:
                out = comm.allreduce(buf, "sum" if dtype != "int32" else "max")
    return as_f64(out), comm


def _tag(opname, route):
    """What the route's plan cache key must name (key[1] or key[2])."""
    if route == "pallas":
        return "allreduce_block_bidir" if opname == "allreduce" else "pallas"
    forced = TUNED_VAR[opname]
    return forced[1] if forced else None


def _ran(comm, opname, route) -> bool:
    tag = _tag(opname, route)
    if tag is None:  # tuned's default alltoall: any spmd name
        return any(k[0] == "alltoall" for k in comm._plan_cache)
    return any(tag in k[:3] for k in comm._plan_cache)


# (operation, n, dtype, root, elems per rank or per block, the JAX
# package's route). A diagonal over dtype, n and root on each operation.
CASES = [
    ("alltoall", 2, "int32", None, 300, "pallas"),
    ("alltoall", 3, "bfloat16", None, 77, "pallas"),
    ("alltoall", 8, "float32", None, 130, "pallas"),
    ("gather", 2, "float32", 1, 100, "tuned"),
    ("gather", 3, "int32", 2, 333, "pallas"),
    ("gather", 8, "bfloat16", 0, 77, "tuned"),
    ("gather", 8, "float32", 7, 129, "pallas"),
    ("scatter", 2, "bfloat16", 0, 50, "pallas"),
    ("scatter", 3, "float32", 1, 128, "tuned"),
    ("scatter", 8, "int32", 7, 129, "pallas"),
    ("scatter", 8, "float32", 3, 64, "tuned"),
    ("allreduce", 2, "int32", None, 300, "tuned"),
    ("allreduce", 3, "bfloat16", None, 100, "pallas"),
    ("allreduce", 8, "float32", None, 1000, "pallas"),
]
_JAX_OUT: dict = {}


def _jax_out(worlds, case):
    """The JAX package's result for a case, computed once per module."""
    if case not in _JAX_OUT:
        opname, n, dtype, root, elems, route = case
        out, comm = _run(worlds[0], jnp, route, opname, n, dtype, root,
                         elems, seed=CASES.index(case))
        # the JAX package really ran the kernel's route (a tuned breaker
        # would otherwise have degraded silently to another algorithm)
        assert _ran(comm, opname, route), list(comm._plan_cache)
        _JAX_OUT[case] = out
    return _JAX_OUT[case]


ROUTED = [(case, route) for case in CASES for route in ("pallas", "tuned")]


@pytest.mark.parametrize("case,route", ROUTED, ids=[
    f"{c[0]}-n{c[1]}-{c[2]}-r{c[3]}-{r}" for c, r in ROUTED])
def test_port_matches_jax_package(worlds, case, route):
    opname, n, dtype, root, elems, _ = case
    want = _jax_out(worlds, case)
    got, comm = _run(worlds[1], torch, route, opname, n, dtype, root, elems,
                     seed=CASES.index(case))
    assert _ran(comm, opname, route), list(comm._plan_cache)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# spmd algorithms (forced in both TunedColls), native and basic
# ---------------------------------------------------------------------------

SPMD_CASES = [  # (operation, forced name, n, dtype, root, elems)
    ("alltoall", "pairwise", 8, "float32", None, 33),
    ("alltoall", "bruck", 8, "bfloat16", None, 130),
    ("alltoall", "bruck", 3, "int32", None, 7),
    ("gather", "binomial", 8, "float32", 5, 41),
    ("gather", "binomial", 3, "int32", 1, 128),
    ("scatter", "binomial", 8, "bfloat16", 6, 19),
    ("scatter", "binomial", 3, "float32", 0, 200),
]


def _call(comm, opname, lib, x, dtype, root):
    buf = (torch.from_numpy(x).to(DTYPES[dtype][2]) if lib is torch
           else jnp.asarray(x, DTYPES[dtype][1]))
    if opname == "scatter":
        return comm.scatter(buf, root)
    buf = comm.put_rank_major(buf)
    return comm.alltoall(buf) if opname == "alltoall" else \
        comm.gather(buf, root)


@pytest.mark.parametrize("opname,algo,n,dtype,root,elems", SPMD_CASES)
def test_spmd_algorithms_match_jax_package(worlds, opname, algo, n, dtype,
                                           root, elems):
    x = make_input(_shape(opname, n, elems), dtype, seed=n + elems)
    outs = []
    with both_vars({f"coll_tuned_{opname}_algorithm": algo}):
        for world, lib in zip(worlds, (jnp, torch)):
            comm = _sub(world, n)
            outs.append(as_f64(_call(comm, opname, lib, x, dtype, root)))
            assert any(k[:2] == (opname, algo) for k in comm._plan_cache)
    assert outs[1].shape == outs[0].shape
    np.testing.assert_array_equal(outs[1], outs[0])
    want = x.swapaxes(0, 1) if opname == "alltoall" else x
    np.testing.assert_array_equal(
        outs[1], as_f64(torch.from_numpy(want).to(DTYPES[dtype][2])))


@pytest.mark.parametrize("component", ["xla", "basic"])
@pytest.mark.parametrize("opname,dtype", [("alltoall", "bfloat16"),
                                          ("gather", "int32"),
                                          ("scatter", "float32")])
def test_native_and_basic_match_jax_package(worlds, component, opname,
                                            dtype):
    jw, tw = worlds
    n, root = 8, 5
    x = make_input(_shape(opname, n, 203), dtype, seed=len(opname))
    jc, tc = jw.dup(), tw.dup()
    outs = []
    for comm, coll, lib in ((jc, JCOLL, jnp), (tc, TCOLL, torch)):
        buf = (torch.from_numpy(x).to(DTYPES[dtype][2]) if lib is torch
               else jnp.asarray(x, DTYPES[dtype][1]))
        if opname != "scatter":
            buf = comm.put_rank_major(buf)
        args = () if opname == "alltoall" else (root,)
        outs.append(as_f64(getattr(coll.component(component), opname)(
            comm, buf, *args)))
    assert outs[1].shape == outs[0].shape
    np.testing.assert_array_equal(outs[1], outs[0])


def test_results_own_their_memory(worlds):
    """A collective's result is not the caller's buffer: writing to it
    leaves the input as it was."""
    _, tw = worlds
    x = torch.arange(8 * 8 * 3, dtype=torch.float32).reshape(8, 8, 3)
    for route in ("pallas", "tuned", "xla", "basic"):
        with both_vars({"coll_select": route}):
            c = tw.dup()
        keep = x.clone()
        for out in (c.alltoall(x), c.gather(x[:, 0], 3),
                    c.scatter(x[:, 0], 3)):
            out.fill_(-1)
        assert torch.equal(x, keep), route


# ---------------------------------------------------------------------------
# Decision layer and the default tuned route
# ---------------------------------------------------------------------------

def test_decisions_match_jax_package():
    sizes = (1, 255, 256, 257, 6143, 6144, 32767, 32768, 1 << 30)
    for nbytes in sizes:
        for nranks in (2, 3, 4, 8):
            for fn in ("decide_alltoall", "decide_gather", "decide_scatter"):
                assert getattr(ttuned, fn)(nbytes, nranks) == \
                    getattr(jtuned, fn)(nbytes, nranks), (fn, nbytes, nranks)
    for var, algo in (("coll_tuned_alltoall_algorithm", "bruck"),
                      ("coll_tuned_gather_algorithm", "pallas_linear"),
                      ("coll_tuned_scatter_algorithm", "binomial")):
        with both_vars({var: algo}):
            for fn in ("decide_alltoall", "decide_gather", "decide_scatter"):
                assert getattr(ttuned, fn)(64, 4) == \
                    getattr(jtuned, fn)(64, 4)


@pytest.mark.parametrize("per_dest,algo", [(128, "bruck"), (1024, "native"),
                                           (32 << 10, "pairwise")])
def test_default_tuned_alltoall_runs_every_prior(worlds, per_dest, algo):
    _, tw = worlds
    c = tw.dup()
    assert c._coll["alltoall"][0].NAME == "tuned"
    x = torch.from_numpy(make_input((8, 8, per_dest // 4), "float32", 3))
    before = counters.launches()
    out = c.alltoall(x)
    assert torch.equal(out, x.transpose(0, 1))
    assert any(k[:2] == ("alltoall", algo) for k in c._plan_cache)
    assert counters.launches() == before


def test_default_tuned_gather_below_6_kib_is_binomial(worlds):
    _, tw = worlds
    c = tw.dup()
    x = torch.from_numpy(make_input((8, 1000), "int32", 4))  # 4000 B
    out = c.gather(x, 6)
    assert torch.equal(out, x)
    assert any(k[:2] == ("gather", "binomial") for k in c._plan_cache)
    big = torch.from_numpy(make_input((8, 2000), "int32", 4))  # 8000 B
    assert torch.equal(c.gather(big, 1), big)
    assert any(k[:2] == ("gather", "native") for k in c._plan_cache)


def test_size_one_and_argument_errors(worlds):
    _, tw = worlds
    solo = tw.split([0] + [-1] * 7)[0]
    x = torch.arange(6, dtype=torch.float32).reshape(1, 6)
    for route in ("pallas", "tuned", "xla", "basic"):
        with both_vars({"coll_select": route}):
            c = solo.dup()
        assert torch.equal(c.alltoall(x.reshape(1, 1, 6)), x.reshape(1, 1, 6))
        assert torch.equal(c.gather(x), x)
        assert torch.equal(c.scatter(x), x)
    c = tw.dup()
    with pytest.raises(RankError):
        c.gather(torch.ones(8, 4), root=8)
    with pytest.raises(RankError):
        c.scatter(torch.ones(8, 4), root=-1)
    for route in ("pallas", "tuned", "xla", "basic"):
        with both_vars({"coll_select": route}):
            c = tw.dup()
        with pytest.raises(ArgumentError):
            c.alltoall(torch.ones(8, 3, 4))
        with pytest.raises(ArgumentError):
            c.scatter(torch.ones(7, 4))
    with both_vars({"coll_tuned_gather_algorithm": "bogus"}):
        with pytest.raises(ArgumentError):
            tw.dup().gather(torch.ones(8, 4), 0)


def test_cpu_wrappers_use_plain_versions_without_launching():
    before = counters.launches()
    x = torch.arange(3 * 3 * 4, dtype=torch.float32).reshape(3, 3, 4)
    assert torch.equal(pr.ring_alltoall(x), x.transpose(0, 1))
    assert torch.equal(pr.linear_gather(x[:, 0], 2), x[:, 0])
    assert torch.equal(pr.linear_scatter(x[:, 0], 1), x[:, 0])
    ones = torch.ones(3, 3, 256)
    assert torch.equal(pr.ring_allreduce_bidir(ones, "sum"), ones * 3)
    assert counters.launches() == before
    with pytest.raises(ArgumentError):
        pr.ring_allreduce_bidir(torch.ones(3, 3, 255), "sum")
    with pytest.raises(ArgumentError):
        pr.ring_alltoall(torch.ones(3, 2, 4))
    with pytest.raises(ArgumentError):
        pr.linear_gather(torch.ones(3, 4), root=3)
