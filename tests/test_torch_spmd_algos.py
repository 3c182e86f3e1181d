"""The port's spmd algorithms behind tuned's priors against the JAX
package's, on the CPU.

With ``coll_tuned_prefer_native=false`` the priors pick the JAX
package's spmd algorithms for bcast (``binomial``, ``binary``,
``pipelined``), reduce (``binomial``, ``pipelined``) and reduce_scatter
(``recursive_halving``, ``ring``), and a rules file may name any entry
of the tables, allgather's ``ring`` and ``bruck`` and bcast's ``chain``
among them. Each of the nine is held bitwise against the JAX function:

- directly, every rank's view: the JAX function under ``shard_map`` on
  the 8-device CPU mesh, the port's on the rank-major tensor, at n = 8
  and at a non-power-of-two n (5, and 3 for the reduce-scatters; the
  halving falls back to the ring there in both packages), float32,
  bfloat16 and int32, sizes that cut into several pipeline segments;
- through TunedColl with the name forced, in both packages;
- the three calls that raised in the port before the algorithms were
  ported, through the default route with ``coll_tuned_prefer_native``
  off: their outputs, not only the names the priors pick;
- a rules file naming ``ring`` or ``bruck`` for allgather is obeyed,
  not skipped as unknown;
- ``reduce_scatter_ring`` refuses a per-rank leading dim other than n
  with ``ArgumentError``, as the JAX function does.

Exact: the data movers copy bits, and the reductions fold every element
at the same ranks in the same order (bfloat16 in float32, rounded once
per combine, in both packages).
"""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import ompi_tpu
import ompi_tpu_torch
from ompi_tpu import ops as jops
from ompi_tpu.coll import spmd as jspmd
from ompi_tpu.coll import tuned as jtuned
from ompi_tpu.core import config as jconfig
from ompi_tpu.core.errors import ArgumentError as JArgumentError
from ompi_tpu_torch import ops as tops
from ompi_tpu_torch.coll import spmd as tspmd
from ompi_tpu_torch.coll import tuned as ttuned
from ompi_tpu_torch.core import config as tconfig
from ompi_tpu_torch.core.counters import SPC
from ompi_tpu_torch.core.errors import ArgumentError

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16),
          "int32": (np.int32, jnp.int32, torch.int32)}


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


def jax_tensor(x, dtype):
    return jnp.asarray(x, DTYPES[dtype][1])


def torch_tensor(x, dtype):
    return torch.from_numpy(x).to(DTYPES[dtype][2])


def spmd_run(fn, x):
    """fn on each rank's row of the rank-major x under shard_map."""
    n = x.shape[0]
    mesh = Mesh(np.array(jax.devices()[:n]), ("r",))
    return jax.jit(jax.shard_map(
        lambda b: fn(b[0])[None], mesh=mesh, in_specs=P("r"),
        out_specs=P("r")))(x)


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


@pytest.fixture(scope="module")
def worlds():
    jworld = ompi_tpu.init()
    tworld = ompi_tpu_torch.init(device="cpu")
    try:
        yield jworld, tworld
    finally:
        ompi_tpu_torch.finalize()


def _sub(world, n):
    if n == world.size:
        return world.dup()
    return world.split([0 if r < n else -1 for r in range(world.size)])[0]


# (opname, algorithm, the function's name in both spmd modules)
ALGOS = [
    ("bcast", "binomial", "bcast_binomial"),
    ("bcast", "chain", "bcast_chain"),
    ("bcast", "pipelined", "bcast_pipelined"),
    ("bcast", "binary", "bcast_binary"),
    ("reduce", "pipelined", "reduce_pipelined"),
    ("allgather", "ring", "allgather_ring"),
    ("allgather", "bruck", "allgather_bruck"),
    ("reduce_scatter", "ring", "reduce_scatter_ring"),
    ("reduce_scatter", "recursive_halving",
     "reduce_scatter_recursive_halving"),
]
# (n, dtype, op, root, elements per rank) of each direct case: 70 000
# float32 elements are 280 000 bytes, four pipeline segments.
DIRECT = [(8, "float32", "sum", 3, 70_000), (5, "bfloat16", "prod", 4, 37),
          (8, "int32", "max", 0, 203)]


def _shape(opname, n, elems):
    return (n, n, elems) if opname == "reduce_scatter" else (n, elems)


@pytest.mark.parametrize("n,dtype,op,root,elems", DIRECT)
@pytest.mark.parametrize("opname,algo,fn", ALGOS)
def test_spmd_algorithm_is_the_jax_function(opname, algo, fn, n, dtype, op,
                                            root, elems):
    if opname == "reduce_scatter":
        n = 3 if n == 5 else n
        elems = min(elems, 4099)
    x = make_input(_shape(opname, n, elems), dtype, seed=n + elems)
    jfn, tfn = getattr(jspmd, fn), getattr(tspmd, fn)
    if opname == "bcast":
        want = spmd_run(lambda b: jfn(b, "r", root=root), jax_tensor(x, dtype))
        got = tfn(torch_tensor(x, dtype), root=root)
    elif opname == "reduce":
        want = spmd_run(lambda b: jfn(b, "r", jops.lookup(op), root=root),
                        jax_tensor(x, dtype))
        got = tfn(torch_tensor(x, dtype), tops.lookup(op), root=root)
    elif opname == "allgather":
        want = spmd_run(lambda b: jfn(b, "r"), jax_tensor(x, dtype))
        got = tfn(torch_tensor(x, dtype))
    else:
        want = spmd_run(lambda b: jfn(b, "r", jops.lookup(op)),
                        jax_tensor(x, dtype))
        got = tfn(torch_tensor(x, dtype), tops.lookup(op))
    assert got.dtype == DTYPES[dtype][2]
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(as_f64(got), as_f64(want))


def test_pipelined_segments_are_the_jax_packages():
    x = torch.zeros(8, 70_000)
    assert tspmd._auto_segments(x) == 4
    assert tspmd._auto_segments((x, x)) == 8
    assert tspmd._auto_segments(x[:, :10]) == 1
    chunks, restore = tspmd._segment_leaf(torch.arange(8 * 10).reshape(8, 10),
                                          4)
    assert [c.shape[1] for c in chunks] == [2, 3, 2, 3]
    assert torch.equal(restore(chunks), torch.arange(80).reshape(8, 10))


def test_bcast_algorithms_take_tuples():
    x = torch.arange(8 * 5).reshape(8, 5)
    y = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    for name in ("bcast_binomial", "bcast_chain", "bcast_pipelined",
                 "bcast_binary"):
        a, b = getattr(tspmd, name)((x, y), root=6)
        assert torch.equal(a, x[6].expand(8, 5))
        assert torch.equal(b, y[6].expand(8, 3))


# ---------------------------------------------------------------------------
# Through TunedColl
# ---------------------------------------------------------------------------

def _call(comm, opname, lib, x, dtype, op, root):
    buf = torch_tensor(x, dtype) if lib is torch else jax_tensor(x, dtype)
    buf = comm.put_rank_major(buf)
    if opname == "bcast":
        return comm.bcast(buf, root)
    if opname == "reduce":
        return comm.reduce(buf, op, root)
    if opname == "allgather":
        return comm.allgather(buf)
    return comm.reduce_scatter_block(buf, op)


@pytest.mark.parametrize("opname,algo,fn", ALGOS)
def test_forced_names_match_jax_package(worlds, opname, algo, fn):
    n, dtype, op, root = (8, "float32", "sum", 5) if "bruck" in algo \
        or "halving" in algo else (5, "bfloat16", "sum", 2)
    x = make_input(_shape(opname, n, 1000), dtype, seed=len(fn))
    outs = []
    with both_vars({f"coll_tuned_{opname}_algorithm": algo}):
        for world, lib in zip(worlds, (jnp, torch)):
            comm = _sub(world, n)
            outs.append(as_f64(_call(comm, opname, lib, x, dtype, op, root)))
            if opname == "reduce_scatter":
                opname_key = "reduce_scatter_block"
            else:
                opname_key = opname
            assert any(k[:2] == (opname_key, algo) for k in comm._plan_cache)
    assert outs[1].shape == outs[0].shape
    np.testing.assert_array_equal(outs[1], outs[0])


# The three calls that raised ArgumentError in the port with the native
# preference off, and the algorithm the priors pick for each.
PRIOR_CASES = [
    ("bcast", (8, 64), 3, "binomial"),
    ("reduce_scatter", (8, 8, 8), None, "recursive_halving"),
    ("reduce", (8, 263_168), 0, "pipelined"),
]


@pytest.mark.parametrize("opname,shape,root,algo", PRIOR_CASES)
def test_priors_without_native_preference_match_jax_package(
        worlds, opname, shape, root, algo):
    x = (np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
         if opname != "reduce" else np.ones(shape, np.float32))
    outs = []
    with both_vars({"coll_tuned_prefer_native": False}):
        for world, lib in zip(worlds, (jnp, torch)):
            comm = world.dup()
            outs.append(as_f64(_call(comm, opname, lib, x, "float32", "sum",
                                     root)))
            key = "reduce_scatter_block" if opname == "reduce_scatter" \
                else opname
            assert any(k[:2] == (key, algo) for k in comm._plan_cache)
    assert outs[1].shape == outs[0].shape
    np.testing.assert_array_equal(outs[1], outs[0])
    if opname == "reduce":
        np.testing.assert_array_equal(outs[1], np.full(shape[1:], 8.0))


@pytest.mark.parametrize("algo", ["ring", "bruck"])
def test_rules_file_naming_allgather_algorithm_is_obeyed(worlds, tmp_path,
                                                         algo):
    path = tmp_path / "rules.json"
    path.write_text(json.dumps({"allgather": [{"algorithm": algo}]}))
    jtuned._rules_cache.clear()
    ttuned._rules_cache.clear()
    x = make_input((8, 77), "int32", seed=11)
    before = SPC.read("coll_tuned_rules_unknown")
    outs = []
    try:
        with both_vars({"coll_tuned_rules_file": str(path)}):
            for world, lib in zip(worlds, (jnp, torch)):
                comm = world.dup()
                outs.append(as_f64(_call(comm, "allgather", lib, x, "int32",
                                         None, None)))
                assert any(k[:2] == ("allgather", algo)
                           for k in comm._plan_cache)
    finally:
        jtuned._rules_cache.clear()
        ttuned._rules_cache.clear()
    assert SPC.read("coll_tuned_rules_unknown") == before
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1], np.broadcast_to(x, (8, 8, 77)))


def test_reduce_scatter_ring_refuses_a_wrong_leading_dim():
    x = np.ones((8, 3, 4), np.float32)  # per rank: leading dim 3, not 8
    with pytest.raises(JArgumentError):
        spmd_run(lambda b: jspmd.reduce_scatter_ring(b, "r",
                                                     jops.lookup("sum")),
                 jnp.asarray(x))
    for fn in (tspmd.reduce_scatter_ring,
               tspmd.reduce_scatter_recursive_halving):
        with pytest.raises(ArgumentError):
            fn(torch.from_numpy(x), tops.lookup("sum"))


def test_ring_shift_and_sendrecv():
    x = torch.arange(5 * 2).reshape(5, 2)
    y = torch.arange(5, dtype=torch.float32)
    a, b = tspmd.ring_shift((x, y), 2)
    assert torch.equal(a, torch.roll(x, 2, 0))
    assert torch.equal(b, torch.roll(y, 2, 0))
    assert torch.equal(tspmd.ring_shift(x, -1), torch.roll(x, -1, 0))
    got = tspmd.sendrecv(x, [(0, 3), (3, 0)])
    want = torch.zeros_like(x)
    want[3], want[0] = x[0], x[3]
    assert torch.equal(got, want)
