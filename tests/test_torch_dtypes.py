"""The reduction kernels' dtypes: float64, float16, int8 and uint8
through the port's PallasColl, against the JAX package's.

- ``PallasColl`` ``allreduce``, ``reduce`` and ``reduce_scatter_block``
  of float16, int8 and uint8 at n = 3: bitwise the JAX ``PallasColl``
  (its kernels in interpret mode) and, for the integers, numpy's
  wrapping reduction. At n = 8 the JAX kernels take seconds a call in
  interpret mode, so there float16 SUM and PROD (whose bits depend on
  the fold order) are held to the JAX package, and MAX, MIN and the
  integers (exact in any order) to numpy.
- float64: the JAX package runs with x64 off, so the yardstick is a
  float64 numpy oracle: SUM and PROD within rtol 1e-12, MAX and MIN
  bitwise.
- Each of the seven wrappers that launch a reduction kernel
  (``_ring_launch``, ``_chunked_launch``, ``_rd_launch``,
  ``_rs_launch``, ``_tree_launch``, ``_bidir_launch`` and
  ``sched/pallas_lower._table_launch``) takes the four dtypes: on a CPU
  tensor it gets past the dtype gate and stops at the device gate
  (``KernelError``). int16, which the JAX ``PallasColl`` takes, has no
  kernel yet: the gate raises ``ArgumentError`` (ROADMAP Queue 3), and
  on the CPU the plain versions give the JAX package's sum.

The kernels themselves run only on a card: ``chip_smoke.py``'s kernel
checks and ``tests/test_torch_kernels.py`` hold each bitwise to its
plain version there at all seven dtypes.
"""

import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch
from ompi_tpu.coll import pallas_ring as jpallas
from ompi_tpu.core import config as jconfig
from ompi_tpu_torch.coll import pallas_ring as tpallas
from ompi_tpu_torch.coll.sched import ir as tir
from ompi_tpu_torch.coll.sched import pallas_lower as tpl
from ompi_tpu_torch.core import config as tconfig
from ompi_tpu_torch.core.errors import ArgumentError, KernelError
from ompi_tpu_torch.ops import lookup

OPS = ("sum", "prod", "max", "min")
NP_OPS = {"sum": np.add, "prod": np.multiply, "max": np.maximum,
          "min": np.minimum}
COLS = 301  # per rank: ragged against every tile


def _sub(world, n):
    if n == world.size:
        return world.dup()
    return world.split([0 if r < n else -1 for r in range(world.size)])[0]


@pytest.fixture(scope="module")
def comms():
    """{n: (JAX comm, port comm)} on PallasColl, n in (3, 8)."""
    jw = ompi_tpu.init()
    tw = ompi_tpu_torch.init(device="cpu")
    jconfig.VARS.set("coll_pallas_priority", 100)
    tconfig.VARS.set("coll_pallas_priority", 100)
    try:
        out = {n: (_sub(jw, n), _sub(tw, n)) for n in (3, 8)}
    finally:
        jconfig.VARS.set("coll_pallas_priority", 30)
        tconfig.VARS.set("coll_pallas_priority", 30)
    for jc, tc in out.values():
        assert type(jc._coll["allreduce"][0]).__name__ == "PallasColl"
        assert type(tc._coll["allreduce"][0]).__name__ == "PallasColl"
    yield out
    ompi_tpu_torch.finalize()


def _inputs(n, dtype, seed):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        x = rng.standard_normal((n, COLS))
        xs = rng.standard_normal((n, n, COLS))
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max + 1, (n, COLS))
        xs = rng.integers(info.min, info.max + 1, (n, n, COLS))
    return x.astype(dtype), xs.astype(dtype)


def _port(tc, x, xs, op, root):
    return (tc.allreduce(tc.put_rank_major(torch.from_numpy(x)), op).numpy(),
            tc.reduce(tc.put_rank_major(torch.from_numpy(x)), op,
                      root).numpy(),
            tc.reduce_scatter_block(tc.put_rank_major(torch.from_numpy(xs)),
                                    op).numpy())


def _jax(jc, x, xs, op, root):
    return (np.asarray(jc.allreduce(jc.put_rank_major(x), op)),
            np.asarray(jc.reduce(jc.put_rank_major(x), op, root)),
            np.asarray(jc.reduce_scatter_block(jc.put_rank_major(xs), op)))


def _numpy(x, xs, op):
    f = NP_OPS[op]
    red = f.reduce(x, axis=0, dtype=x.dtype)
    return (np.broadcast_to(red, x.shape), red,
            f.reduce(xs, axis=0, dtype=xs.dtype))


def _same_bits(got, want, what):
    for g, w, name in zip(got, want, ("allreduce", "reduce",
                                      "reduce_scatter_block")):
        assert g.dtype == w.dtype, (what, name)
        assert g.shape == w.shape, (what, name)
        assert g.tobytes() == w.tobytes(), (what, name)


# The JAX package's PallasColl at n = 3 everywhere, and at n = 8 where the
# bits depend on the fold order; numpy's exact reduction elsewhere.
JAX_CASES = ([(3, d, op) for d in ("float16", "int8", "uint8") for op in OPS]
             + [(8, "float16", op) for op in ("sum", "prod")])
NUMPY_CASES = ([(8, "float16", op) for op in ("max", "min")]
               + [(8, d, op) for d in ("int8", "uint8") for op in OPS])


@pytest.mark.skipif(not jpallas.interpret_available(),
                    reason="this jax build has no Mosaic TPU interpret "
                           "mode for the JAX package's kernels")
@pytest.mark.parametrize("n,dtype,op", JAX_CASES)
def test_pallas_matches_jax(comms, n, dtype, op):
    jc, tc = comms[n]
    x, xs = _inputs(n, dtype, seed=n)
    got = _port(tc, x, xs, op, n - 1)
    _same_bits(got, _jax(jc, x, xs, op, n - 1), (n, dtype, op))
    if dtype != "float16":  # exact in any order: numpy's too
        _same_bits(got, _numpy(x, xs, op), (n, dtype, op, "numpy"))


@pytest.mark.parametrize("n,dtype,op", NUMPY_CASES)
def test_pallas_exact_ops_match_numpy(comms, n, dtype, op):
    _, tc = comms[n]
    x, xs = _inputs(n, dtype, seed=n + 1)
    _same_bits(_port(tc, x, xs, op, 0), _numpy(x, xs, op), (n, dtype, op))


def test_int8_sum_wraps(comms):
    """100 on each of 8 ranks: 800 modulo 256, as int8 arithmetic."""
    _, tc = comms[8]
    x = np.full((8, COLS), 100, np.int8)
    xs = np.full((8, 8, COLS), 100, np.int8)
    for got in _port(tc, x, xs, "sum", 0):
        assert (got == 32).all()


@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("op", OPS)
def test_float64_against_numpy(comms, n, op):
    _, tc = comms[n]
    x, xs = _inputs(n, "float64", seed=10 + n)
    got = _port(tc, x, xs, op, n - 1)
    want = _numpy(x, xs, op)
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        if op in ("sum", "prod"):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
        else:
            assert g.tobytes() == np.ascontiguousarray(w).tobytes()


def _table(x):
    prog = tpl.analyze(tir.ring(2))
    return tpl._table_launch(prog, x.reshape(2, prog.nchunks, -1), "sum")


# The seven wrappers that launch a reduction kernel, on a (2, 512) input.
GATES = {
    "ring_allreduce": lambda x: tpallas._ring_launch(x.reshape(2, 2, -1),
                                                     "sum"),
    "ring_allreduce_chunked": lambda x: tpallas._chunked_launch(
        x.reshape(2, 2, -1), "sum"),
    "ring_allreduce_rd": lambda x: tpallas._rd_launch(x, "sum"),
    "ring_reduce_scatter": lambda x: tpallas._rs_launch(x.reshape(2, 2, -1),
                                                        "sum"),
    "tree_reduce": lambda x: tpallas._tree_launch(x, "sum", 0),
    "ring_allreduce_bidir": lambda x: tpallas._bidir_launch(
        x.reshape(2, 2, -1), "sum"),
    "sched_table": _table,
}


@pytest.mark.parametrize("gate", sorted(GATES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float16, torch.int8,
                                   torch.uint8])
def test_gate_takes_the_new_dtypes(gate, dtype):
    for op in OPS:
        assert tpallas._codes(lookup(op), dtype)[1] == \
            tpallas._DTYPE_CODES[dtype]
    with pytest.raises(KernelError, match="CUDA tensor"):
        GATES[gate](torch.zeros(2, 512, dtype=dtype))


@pytest.mark.parametrize("gate", sorted(GATES))
def test_gate_refuses_int16(gate):
    """int16 has no kernel yet (ROADMAP Queue 3): the wrappers raise
    before any launch, on the card as here."""
    with pytest.raises(ArgumentError, match="no ring kernel"):
        GATES[gate](torch.zeros(2, 512, dtype=torch.int16))


@pytest.mark.skipif(not jpallas.interpret_available(),
                    reason="this jax build has no Mosaic TPU interpret "
                           "mode for the JAX package's kernels")
def test_int16_plain_matches_jax(comms):
    """The standing int16 record: on the CPU the plain versions give the
    JAX PallasColl's wrapping sum (n = 8, SUM); on the card the port
    raises at the gate (``test_gate_refuses_int16``)."""
    jc, tc = comms[8]
    x = np.random.default_rng(0).integers(-30000, 30000,
                                          (8, COLS)).astype(np.int16)
    got = tc.allreduce(tc.put_rank_major(torch.from_numpy(x)), "sum").numpy()
    assert got.tobytes() == np.asarray(
        jc.allreduce(jc.put_rank_major(x), "sum")).tobytes()
