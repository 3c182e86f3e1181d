"""The port's quantized wire (``ompi_tpu_torch/coll/quant.py``) and the
tuned rules file against the JAX package's, on the CPU.

Inputs come from seeded numpy arrays handed to both packages. Only
finite inputs are used: a NaN row's int8 cast is implementation-defined
in XLA.

Where the bits differ, and why. Under ``jit`` XLA rewrites the int8
codec's ``m / 127`` into ``m * (1/127)`` (its algebraic simplifier
turns a division by a constant into a product with the reciprocal) and
its CPU backend contracts the dequantize-accumulate ``q * s + x`` into
one fused multiply-add. The port's codec, its kernel and the kernel's
plain version keep both as IEEE operations (a division, a rounded
product, a rounded sum), which is what the JAX package's functions
compute when they run eagerly. So:

- the JAX kernel (``allreduce_block_quant``, TPU-interpret mode under
  ``shard_map``) is bitwise its own schedule run in lock-step from the
  JAX package's ``_quant_rows``/``_dequant_rows`` under ``jit`` (which
  shows the cause), and the port is bitwise the same lock-step run
  eagerly; the port against the interpret-mode kernel is held to
  ``|port - jax| <= analytic_error_bound``. The interpret-mode kernel
  runs at n = 2 only: at n = 3 and n = 8 it did not finish within
  10 minutes on the test host, so the eager lock-step carries n in
  {2, 3, 8};
- the XLA ring (``allreduce_quant_ring``) on the bf16 wire is bitwise
  the JAX package's; on the int8 wire the port is bitwise the same ring
  run eagerly from the JAX package's own codec, and held to the bound
  against the jitted ring;
- ``sched_quant`` likewise: bitwise on the bf16 wire, the bound on
  int8.

Every result is also within ``analytic_error_bound`` of the float64 sum
(bfloat16 outputs: plus half an ulp of the final cast) and every rank's
rows are identical. The codec, ``quant_roundtrip``, ``wire_bytes``,
``compression_ratio``, ``supports`` and ``ErrorFeedback`` are bitwise
(eager JAX) or exactly equal; ``analytic_error_bound`` agrees to 1e-6
relative (its sum over ranks runs in another order than XLA's). The protocol: under 200
seeded random interleavings at n in {3, 4, 8} the port's credit
placement is exact with every flag at 0; the JAX kernel's placement
loses partials (the negative control). Decisions, rules files, the SPC
wire statistics, the bounded schedule validation and the model-mode
autotune digest with the quantized wire on are the JAX package's.

The kernel itself, on a card, is tested in test_torch_kernels.py.
"""

import dataclasses
import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import ompi_tpu
import ompi_tpu_torch
from ompi_tpu import ops as jops
from ompi_tpu.coll import quant as jquant
from ompi_tpu.coll import tuned as jtuned
from ompi_tpu.coll.sched import autotune as jautotune
from ompi_tpu.coll.sched import cache as jcache
from ompi_tpu.core import config as jconfig
from ompi_tpu.core.counters import SPC as JSPC
from ompi_tpu_torch.coll import quant as tquant
from ompi_tpu_torch.coll import tuned as ttuned
from ompi_tpu_torch.coll.sched import autotune as tautotune
from ompi_tpu_torch.coll.sched import cache as tcache
from ompi_tpu_torch.coll.sched import ir as tir
from ompi_tpu_torch.coll.sched import lower as tlower
from ompi_tpu_torch.core import config as tconfig
from ompi_tpu_torch.core.counters import SPC
from ompi_tpu_torch.core.errors import ArgumentError
from ompi_tpu_torch.ops import create_op, lookup

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
Q = 128 * 128  # elements of one kernel quantum per rank and ring block


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


@pytest.fixture(scope="module", autouse=True)
def isolated_state():
    """Fresh winner caches for this file, and the JAX package's
    registries restored after it (its TunedColl registers the quant tier
    here while other test files run in the same process). PyTorch runs
    on one thread here: the protocol simulator's small steps run 5x
    slower on eight."""
    saved = dict(jtuned.ALLREDUCE_ALGOS)
    caches = jcache.CACHE, tcache.CACHE
    jcache.CACHE = jcache.ScheduleCache()
    tcache.CACHE = tcache.ScheduleCache()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        jcache.CACHE, tcache.CACHE = caches
        jtuned.ALLREDUCE_ALGOS.clear()
        jtuned.ALLREDUCE_ALGOS.update(saved)


@pytest.fixture(scope="module")
def worlds():
    jworld = ompi_tpu.init()
    tworld = ompi_tpu_torch.init(device="cpu")
    try:
        yield jworld, tworld
    finally:
        ompi_tpu_torch.finalize()


def make_input(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def f32(t) -> np.ndarray:
    """A result as float32 numpy (bfloat16 converts exactly)."""
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def rounded(data: np.ndarray, dtype: str) -> np.ndarray:
    """The input as the collective sees it (bfloat16 cases round it)."""
    return np.array(jnp.asarray(data).astype(DT[dtype][0])
                    .astype(jnp.float32))


def check_bound(out: np.ndarray, data: np.ndarray, dtype: str,
                wire: str = "int8", block: int = 128) -> np.ndarray:
    """Every rank's row identical and within the analytic bound of the
    float64 sum of the inputs as the collective sees them (bfloat16
    outputs: plus half an ulp of the final cast). Returns the bound."""
    x = rounded(data, dtype)
    bound = tquant.analytic_error_bound(torch.from_numpy(x), wire=wire,
                                        block=block).numpy().astype(
                                            np.float64)
    exact = x.astype(np.float64).sum(0)
    slack = 0.0
    if dtype == "bfloat16":
        slack = np.abs(out[0]).astype(np.float64) * 2.0 ** -8
    assert (np.abs(out[0] - exact) <= bound + slack).all()
    for r in range(1, out.shape[0]):
        np.testing.assert_array_equal(bits(out[r]), bits(out[0]))
    return bound


# ---------------------------------------------------------------------------
# The JAX kernel and the port's plain version
# ---------------------------------------------------------------------------

def jax_schedule(data: np.ndarray, dtype: str, qr, dq) -> np.ndarray:
    """``allreduce_block_quant``'s wrapper (the n·128·128 padding) and
    ``_quant_allreduce_kernel``'s schedule, in lock-step, from the JAX
    package's own ``_quant_rows`` (``qr``) and dequantize-accumulate
    (``dq``)."""
    n, L = data.shape
    x = rounded(data, dtype)
    pad = (-L) % (n * Q)
    blocks = np.pad(x, ((0, 0), (0, pad))).reshape(n, n, -1, 128)
    out = np.empty_like(blocks)
    slots = [qr(jnp.asarray(blocks[me, (me - 1) % n])) for me in range(n)]
    for step in range(2 * (n - 1)):
        slots = [slots[(me - 1) % n] for me in range(n)]  # one hop right
        for me in range(n):
            q, s = slots[me]
            if step < n - 1:
                blk = (me - step - 2) % n
                q, s = slots[me] = qr(dq(q, s, jnp.asarray(blocks[me, blk])))
                if step == n - 2:
                    out[me, blk] = np.asarray(jquant._dequant_rows(q, s))
            else:
                blk = (me - (step - (n - 1)) - 1) % n
                out[me, blk] = np.asarray(jquant._dequant_rows(q, s))
    res = out.reshape(n, -1)[:, :L]
    return f32(jnp.asarray(res).astype(DT[dtype][0]))


def _eager_dq(q, s, x):
    return jquant._dequant_rows(q, s) + x


_jit_qr = jax.jit(jquant._quant_rows)
_jit_dq = jax.jit(_eager_dq)


def jax_kernel(data: np.ndarray, dtype: str) -> np.ndarray:
    """The JAX kernel in TPU-interpret mode, as tests/test_quant.py
    runs it."""
    n = data.shape[0]
    mesh = Mesh(np.array(jax.devices()[:n]), ("r",))
    fn = jax.jit(jax.shard_map(
        lambda b: jquant.allreduce_block_quant(b[0], "r", "sum")[None],
        mesh=mesh, in_specs=(P("r"),), out_specs=P("r"), check_vma=False))
    return f32(fn(jnp.asarray(data).astype(DT[dtype][0])))


def port_block_quant(data: np.ndarray, dtype: str) -> np.ndarray:
    x = torch.from_numpy(data).to(DT[dtype][1])
    out = tquant.allreduce_block_quant(x, "sum")
    assert out.dtype == x.dtype and out.shape == x.shape
    return f32(out)


@pytest.mark.parametrize("elems,dtype", [(Q, "float32"), (2 * Q, "bfloat16"),
                                         (Q + 1000, "float32")])
def test_kernel_is_jax_interpret_kernel_within_bound(elems, dtype):
    """n = 2: the interpret-mode kernel is bitwise its schedule under
    jit (XLA's reciprocal and fused multiply-add, see the module
    docstring); the port differs from it by no more than the bound."""
    data = make_input((2, 2 * elems), seed=elems)
    want = jax_kernel(data, dtype)
    np.testing.assert_array_equal(
        bits(want), bits(jax_schedule(data, dtype, _jit_qr, _jit_dq)))
    got = port_block_quant(data, dtype)
    bound = check_bound(got, data, dtype)
    check_bound(want, data, dtype)
    assert (np.abs(got.astype(np.float64) - want) <= bound
            + np.abs(want) * (2.0 ** -8 if dtype == "bfloat16" else 0)).all()


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("elems,dtype", [(Q, "float32"), (2 * Q, "bfloat16"),
                                         (Q - 300, "float32")])
def test_kernel_schedule_bitwise_jax_package(n, elems, dtype):
    """The port's allreduce_block_quant on the CPU (the kernel's plain
    version, the protocol simulator in lock-step) is bitwise the JAX
    kernel's wrapper and schedule run eagerly from the JAX package's
    codec; one or two quanta per rank and ring block, and a ragged
    size."""
    data = make_input((n, n * elems), seed=n * 31 + elems)
    got = port_block_quant(data, dtype)
    want = jax_schedule(data, dtype, jquant._quant_rows, _eager_dq)
    np.testing.assert_array_equal(bits(got), bits(want))
    check_bound(got, data, dtype)


def test_kernel_wrapper_edges():
    """One rank returns its input, non-SUM raises ValueError (as in the
    JAX package), and the wrapper refuses what the kernel does not
    take."""
    x = torch.randn(1, 300)
    assert tquant.allreduce_block_quant(x, "sum") is x
    with pytest.raises(ValueError, match="SUM only"):
        tquant.allreduce_block_quant(torch.randn(4, 300), "max")
    with pytest.raises(ArgumentError, match="rows a multiple of 128"):
        tquant.quant_allreduce(torch.zeros(2, 2, 64, 128))
    with pytest.raises(ArgumentError, match="float32"):
        tquant.quant_allreduce(torch.zeros(2, 2, 128, 128,
                                           dtype=torch.bfloat16))
    zeros = torch.zeros(3, 3 * Q)
    assert torch.equal(tquant.allreduce_block_quant(zeros), zeros)


# ---------------------------------------------------------------------------
# The XLA ring
# ---------------------------------------------------------------------------

def jax_ring(data: np.ndarray, dtype: str, wire: str, block: int):
    n = data.shape[0]
    mesh = Mesh(np.array(jax.devices()[:n]), ("r",))
    fn = jax.jit(jax.shard_map(
        lambda b: jquant.allreduce_quant_ring(
            b[0], "r", "sum", wire=wire, block=block)[None],
        mesh=mesh, in_specs=(P("r"),), out_specs=P("r")))
    return f32(fn(jnp.asarray(data).astype(DT[dtype][0])))


def jax_ring_eager(data: np.ndarray, dtype: str, block: int) -> np.ndarray:
    """``allreduce_quant_ring``'s int8 schedule over the rank axis, run
    eagerly from the JAX package's own codec."""
    n, L = data.shape
    x = rounded(data, dtype)
    blocks = np.pad(x, ((0, 0), (0, (-L) % (n * block)))).reshape(n, n, -1)

    def quant(v):
        return jquant.quantize_block_scaled(jnp.asarray(v), block)

    def dequant(qs):
        return np.asarray(jquant.dequantize_block_scaled(*qs, block))

    qs = [quant(blocks[r, r]) for r in range(n)]
    for k in range(n - 1):
        qs = [qs[(r - 1) % n] for r in range(n)]
        qs = [quant(jquant.dequantize_block_scaled(*qs[r], block)
                    + jnp.asarray(blocks[r, (r - k - 1) % n]))
              for r in range(n)]
    out = np.empty_like(blocks)
    for r in range(n):
        out[r, (r + 1) % n] = dequant(qs[r])
    for k in range(n - 1):
        qs = [qs[(r - 1) % n] for r in range(n)]
        for r in range(n):
            out[r, (r - k) % n] = dequant(qs[r])
    return f32(jnp.asarray(out.reshape(n, -1)[:, :L]).astype(DT[dtype][0]))


# Both wires at every n, the two blocks alternating between the ns.
RING_CASES = [(n, wire, block, "float32", 2 * n * block)
              for n, blocks in ((2, (128, 64)), (3, (64, 128)),
                                (4, (128, 64)), (8, (64, 128)))
              for wire, block in zip(("int8", "bf16"), blocks)]
RING_CASES += [(3, "int8", 128, "float32", 1000), (8, "bf16", 64, "float32",
                                                    1000),
               (8, "int8", 128, "bfloat16", 2048),
               (4, "bf16", 128, "bfloat16", 777)]


@pytest.mark.parametrize("n,wire,block,dtype,elems", RING_CASES)
def test_xla_ring_matches_jax_package(n, wire, block, dtype, elems):
    data = make_input((n, elems), seed=n * 100 + elems + block)
    got = f32(tquant.allreduce_quant_ring(
        torch.from_numpy(data).to(DT[dtype][1]), "sum", wire=wire,
        block=block))
    want = jax_ring(data, dtype, wire, block)
    bound = check_bound(got, data, dtype, wire, block)
    if wire == "bf16":
        np.testing.assert_array_equal(bits(got), bits(want))
        return
    # int8: bitwise the eager ring; the jitted one (XLA's reciprocal and
    # fused multiply-add) within the bound
    np.testing.assert_array_equal(bits(got),
                                  bits(jax_ring_eager(data, dtype, block)))
    slack = np.abs(want) * 2.0 ** -8 if dtype == "bfloat16" else 0.0
    assert (np.abs(got.astype(np.float64) - want) <= bound + slack).all()


def test_xla_ring_edges():
    x = torch.randn(1, 5)
    assert tquant.allreduce_quant_ring(x, "sum") is x
    with pytest.raises(ValueError, match="SUM only"):
        tquant.allreduce_quant_ring(torch.randn(4, 256), "max")


# ---------------------------------------------------------------------------
# Codec and helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", [128, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codec_bitwise_jax_package(block, dtype):
    x = make_input(block * 40, seed=block)
    x[:block] = 0.0  # an all-zero block: scale 1, exact roundtrip
    jx = jnp.asarray(x).astype(DT[dtype][0])
    tx = torch.from_numpy(x).to(DT[dtype][1])
    jq, js = jquant.quantize_block_scaled(jx, block)
    tq, ts = tquant.quantize_block_scaled(tx, block)
    assert tq.dtype == torch.int8 and ts.shape == (40,)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(bits(ts.numpy()), bits(np.asarray(js)))
    np.testing.assert_array_equal(
        bits(tquant.dequantize_block_scaled(tq, ts, block).numpy()),
        bits(np.asarray(jquant.dequantize_block_scaled(jq, js, block))))
    assert float(ts[0]) == 1.0
    for wire in ("int8", "bf16"):
        for shape in ((40 * block,), (7, 333)):
            v = x[:int(np.prod(shape))].reshape(shape)
            got = tquant.quant_roundtrip(torch.from_numpy(v), wire, block)
            want = jquant.quant_roundtrip(jnp.asarray(v), wire, block)
            assert tuple(got.shape) == shape
            np.testing.assert_array_equal(bits(got.numpy()),
                                          bits(np.asarray(want)))
    rows = make_input((128, 128), seed=block)
    tqr, tsr = tquant._quant_rows(torch.from_numpy(rows))
    jqr, jsr = jquant._quant_rows(jnp.asarray(rows))
    assert tuple(tsr.shape) == (1, 128)
    np.testing.assert_array_equal(tqr.numpy(), np.asarray(jqr))
    np.testing.assert_array_equal(bits(tsr.numpy()), bits(np.asarray(jsr)))
    np.testing.assert_array_equal(
        bits(tquant._dequant_rows(tqr, tsr).numpy()),
        bits(np.asarray(jquant._dequant_rows(jqr, jsr))))


@pytest.mark.parametrize("n", [2, 3, 8])
def test_analytic_error_bound_is_jax_package(n):
    for wire, block, trailing in (("int8", 128, (1000,)),
                                  ("bf16", 64, (3, 257)),
                                  ("int8", 64, (n * 64,))):
        data = make_input((n,) + trailing, seed=n + block)
        got = tquant.analytic_error_bound(torch.from_numpy(data), wire=wire,
                                          block=block)
        want = jquant.analytic_error_bound(data, wire=wire, block=block)
        assert tuple(got.shape) == trailing
        # the sum over ranks runs in another order: an ulp apart
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=0)


def test_wire_bytes_and_ratio_are_jax_package():
    for wire in ("int8", "bf16"):
        for block in (128, 64, 100):
            for logical in (1, 4, 1000, 4 << 20, (1 << 30) + 12):
                for itemsize in (4, 2):
                    assert tquant.wire_bytes(logical, itemsize, wire, block) \
                        == jquant.wire_bytes(logical, itemsize, wire, block)
            assert tquant.compression_ratio(4, wire, block) == \
                jquant.compression_ratio(4, wire, block)
    assert round(tquant.compression_ratio(4, "int8", 128), 2) == 3.88
    with both_vars({"coll_quant_wire": "bf16", "coll_quant_block": 64}):
        assert tquant.wire_bytes(4096) == jquant.wire_bytes(4096) == 2048


def test_supports_is_jax_package():
    user_c = (create_op(lambda a, b: a + b, commutative=True),
              jops.create_op(lambda a, b: a + b, commutative=True))
    user_n = (create_op(lambda a, b: a - b, commutative=False),
              jops.create_op(lambda a, b: a - b, commutative=False))
    pairs = [(lookup(o), jops.lookup(o)) for o in (
        "sum", "prod", "max", "min", "land", "band", "maxloc", "minloc",
        "replace")] + [user_c, user_n]
    dtypes = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
              (torch.float16, jnp.float16), (torch.int32, jnp.int32),
              (torch.int8, jnp.int8), (torch.bool, jnp.bool_),
              ("float32", "float32"), ("int32", "int32"), (None, None)]
    for top, jop in pairs:
        for tdt, jdt in dtypes:
            assert tquant.supports(top, tdt) == jquant.supports(jop, jdt), \
                (top.name, tdt)
    assert tquant.supports("sum", torch.float32)
    assert not tquant.supports(None, torch.float32)
    assert not tquant.supports("sum", "no_such_dtype")


@pytest.mark.parametrize("wire", ["int8", "bf16"])
def test_error_feedback_is_jax_package(wire):
    """Five steps of the same gradient: the transmitted value and the
    residual are bitwise the JAX package's at every step."""
    data = make_input((8, 1000), seed=9)
    jef, tef = jquant.ErrorFeedback(wire), tquant.ErrorFeedback(wire)
    for step in range(5):
        x = data * (1.0 + step / 4.0)
        got = tef.compensate(torch.from_numpy(x))
        want = jef.compensate(jnp.asarray(x))
        np.testing.assert_array_equal(bits(got.numpy()),
                                      bits(np.asarray(want)))
        np.testing.assert_array_equal(bits(tef.residual.numpy()),
                                      bits(np.asarray(jef.residual)))
    assert tef.residual_norm() == pytest.approx(jef.residual_norm(),
                                                rel=1e-6)
    assert tef.residual_norm() > 0.0
    zero = tquant.ErrorFeedback()
    assert torch.equal(zero.compensate(torch.zeros(256)), torch.zeros(256))
    assert zero.residual_norm() == 0.0


def test_error_feedback_allreduce_converges(worlds):
    """tests/test_quant.py::test_error_feedback_converges on the port."""
    comm = worlds[1].dup()
    data = make_input((8, 2048), seed=9)
    exact = data.sum(0)
    ef = tquant.ErrorFeedback()
    acc = np.zeros_like(exact)
    errs = []
    for t in range(1, 17):
        out = tquant.allreduce_error_feedback(comm, torch.from_numpy(data),
                                              ef)
        acc += out[0].numpy()
        errs.append(np.abs(acc / t - exact).mean())
    assert errs[-1] < errs[0] / 4.0, (errs[0], errs[-1])


# ---------------------------------------------------------------------------
# The protocol
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 4, 8])
def test_protocol_exact_under_random_interleavings(n):
    x = torch.from_numpy(make_input((n, n, 128, 128), seed=n))
    want, residue = tquant.simulate_quant_ring(x)
    assert not residue
    for seed in range(200):
        got, residue = tquant.simulate_quant_ring(x,
                                                  rng=random.Random(seed))
        assert not residue, (seed, residue)
        assert torch.equal(got, want), seed


def test_reference_credit_placement_loses_partials():
    """The JAX kernel's credits (a post-seed credit, then one right
    after filling a slot it still sends from) let a left neighbour that
    runs ahead overwrite a partial before it is forwarded."""
    for n in (3, 4, 8):
        x = torch.from_numpy(make_input((n, n, 128, 128), seed=n))
        want = tquant.quant_allreduce_plain(x)
        lockstep, residue = tquant.simulate_quant_ring(x, credit="reference")
        assert torch.equal(lockstep, want) and not residue
        lost = sum(not torch.equal(tquant.simulate_quant_ring(
            x, credit="reference", rng=random.Random(seed))[0], want)
            for seed in range(40))
        assert lost > 0, n
    with pytest.raises(ArgumentError, match="credit"):
        tquant.simulate_quant_ring(x, credit="eager")


# ---------------------------------------------------------------------------
# Decisions and the rules file
# ---------------------------------------------------------------------------

RULES = {
    "allreduce": [
        {"max_bytes": 1023, "algorithm": "recursive_doubling"},
        {"dtype": "bfloat16", "allow_quant": False},
        {"min_bytes": 1 << 20, "max_bytes": (1 << 20) + 10,
         "min_ranks": 4, "algorithm": "quant_pallas"},
        {"max_ranks": 2, "algorithm": "no_such_algorithm"},
        {"min_bytes": 1 << 30, "allow_quant": False},
    ],
    "alltoall": [{"max_bytes": 100, "algorithm": "bruck"}],
    "allgather": [{"min_ranks": 4, "algorithm": "pallas_ring"}],
    "bcast": [{"min_bytes": 10, "algorithm": "pallas_binomial"}],
    "reduce": [{"max_bytes": 4096, "algorithm": "binomial"}],
    "reduce_scatter": [{"algorithm": "sched_pallas_rs", "max_ranks": 4}],
    "gather": [{"algorithm": "binomial"}],
    "scatter": [{"min_bytes": 64, "algorithm": "pallas_linear"}],
    # The port has no scan spaces yet: a veto-only rule names no
    # algorithm.
    "scan": [{"allow_quant": False}],
    "exscan": [{"allow_quant": False}],
    "no_such_op": [{"algorithm": "native"}],
}
SIZES = (4, 1023, 4096, (64 << 10) - 1, 64 << 10, 1 << 20, (1 << 20) + 5,
         1 << 30)


@pytest.fixture
def rules_file(tmp_path):
    p = tmp_path / "rules.json"
    p.write_text(json.dumps(RULES))
    jtuned._rules_cache.clear()
    ttuned._rules_cache.clear()
    yield str(p)
    jtuned._rules_cache.clear()
    ttuned._rules_cache.clear()


def test_rules_decide_and_allows_quant_are_jax_package(rules_file):
    before = SPC.read("coll_tuned_rules_unknown")
    jbefore = JSPC.counter("coll_tuned_rules_unknown").read()
    jr, tr = jtuned.Rules(rules_file), ttuned.Rules(rules_file)
    for opname in RULES:
        for nbytes in SIZES:
            for nranks in (2, 3, 8):
                for tdt, jdt in ((None, None),
                                 (torch.float32, jnp.dtype("float32")),
                                 (torch.bfloat16, jnp.dtype("bfloat16"))):
                    assert tr.decide(opname, nbytes, nranks, tdt) == \
                        jr.decide(opname, nbytes, nranks, jdt), \
                        (opname, nbytes, nranks, tdt)
                    assert tr.allows_quant(opname, nbytes, nranks, tdt) == \
                        jr.allows_quant(opname, nbytes, nranks, jdt)
    # counted once each: the unknown operation, the unknown allreduce
    # algorithm, and "native" under the unknown operation
    assert SPC.read("coll_tuned_rules_unknown") - before == 3
    assert JSPC.counter("coll_tuned_rules_unknown").read() - jbefore == 3


def test_unreadable_rules_file_gives_no_rules(tmp_path):
    p = tmp_path / "broken.json"
    p.write_text("{not json")
    with both_vars({"coll_tuned_rules_file": str(p)}):
        ttuned._rules_cache.clear()
        rules = ttuned._rules()
        assert rules.decide("allreduce", 4, 8) is None
        assert rules.allows_quant("allreduce", 4, 8)
    ttuned._rules_cache.clear()


@pytest.mark.parametrize("with_rules", [False, True])
def test_allreduce_decisions_with_quant_are_jax_package(with_rules,
                                                        rules_file):
    ops = [(lookup(o), jops.lookup(o)) for o in ("sum", "max", "prod",
                                                 "maxloc")]
    dtypes = ((None, None), (torch.float32, jnp.dtype("float32")),
              (torch.bfloat16, jnp.dtype("bfloat16")),
              (torch.int32, jnp.dtype("int32")))
    values = {"coll_sched_cache_enable": False, "coll_quant_enable": True,
              "coll_tuned_rules_file": rules_file if with_rules else ""}
    picked = set()
    with both_vars(values):
        for nbytes in SIZES:
            for nranks in (2, 3, 8):
                for top, jop in ops:
                    for tdt, jdt in dtypes:
                        for allow in (None, True, False):
                            got = ttuned.decide_allreduce(
                                top, nbytes, nranks, tdt, allow_quant=allow)
                            assert got == jtuned.decide_allreduce(
                                jop, nbytes, nranks, jdt,
                                allow_quant=allow), \
                                (nbytes, nranks, top.name, tdt, allow)
                            picked.add(got)
        for name, args in (("alltoall", (64, 8)), ("allgather", (64, 8)),
                           ("bcast", (64, 8)), ("gather", (64, 8)),
                           ("scatter", (64, 8))):
            assert getattr(ttuned, f"decide_{name}")(*args) == \
                getattr(jtuned, f"decide_{name}")(*args)
        for opname in ("reduce", "reduce_scatter"):
            for op in ("sum", "max"):
                assert getattr(ttuned, f"decide_{opname}")(
                    lookup(op), 4096, 4) == getattr(
                        jtuned, f"decide_{opname}")(jops.lookup(op), 4096, 4)
    assert "quant_ring" in picked
    assert ("quant_pallas" in picked) == with_rules


def _quant_ring_count() -> float:
    return SPC.read("coll_allreduce_algo_quant_ring")


@pytest.fixture
def quant_enabled():
    with both_vars({"coll_quant_enable": True,
                    "coll_quant_min_bytes": 1 << 10,
                    "coll_sched_cache_enable": False}):
        yield


def test_rules_file_can_veto_quant(worlds, tmp_path, quant_enabled):
    """tests/test_quant.py::test_rules_file_can_veto_quant on the port."""
    p = str(tmp_path / "noquant.json")
    with open(p, "w") as f:
        json.dump({"allreduce": [{"allow_quant": False}]}, f)
    comm = worlds[1].dup()
    data = make_input((comm.size, 4096), seed=8)
    before = _quant_ring_count()
    with both_vars({"coll_tuned_rules_file": p}):
        out = comm.allreduce(comm.put_rank_major(torch.from_numpy(data)))
    assert _quant_ring_count() == before, "rules veto ignored"
    np.testing.assert_allclose(out[0].numpy(), data.sum(0), rtol=1e-5,
                               atol=1e-5)
    # without the file the same call takes the quantized wire
    comm.allreduce(comm.put_rank_major(torch.from_numpy(data)))
    assert _quant_ring_count() == before + 1


def test_comm_max_stays_exact_under_quant(worlds, quant_enabled):
    """tests/test_quant.py::test_comm_max_stays_exact_under_quant on the
    port: MAX is refused by supports() and lands on an exact
    algorithm."""
    comm = worlds[1].dup()
    data = make_input((comm.size, 4096), seed=6)
    before = _quant_ring_count()
    out = comm.allreduce(comm.put_rank_major(torch.from_numpy(data)), "max")
    assert _quant_ring_count() == before
    np.testing.assert_array_equal(out[0].numpy(), data.max(axis=0))


@pytest.mark.parametrize("wire", ["int8", "bf16"])
def test_comm_routes_and_wire_stats_are_jax_package(worlds, quant_enabled,
                                                    wire):
    """The same calls through both packages' TunedColl: the same
    algorithm, the same SPC wire statistics, and the same result
    (bitwise on the bf16 wire, within the bound on int8)."""
    jcomm, tcomm = worlds[0].dup(), worlds[1].dup()
    names = ("coll_quant_bytes_on_wire", "coll_quant_bytes_logical",
             "coll_allreduce_algo_quant_ring")
    jb = {k: JSPC.counter(k).read() for k in names}
    tb = {k: SPC.read(k) for k in names}
    data = make_input((8, 4099), seed=5)
    with both_vars({"coll_quant_wire": wire}):
        want = f32(jcomm.allreduce(jcomm.put_rank_major(data), "sum"))
        got = f32(tcomm.allreduce(tcomm.put_rank_major(
            torch.from_numpy(data)), "sum"))
        for k in names:
            assert SPC.read(k) - tb[k] == JSPC.counter(k).read() - jb[k], k
        assert SPC.read("coll_quant_compression_ratio") == \
            JSPC.counter("coll_quant_compression_ratio").read()
        assert SPC.read("coll_quant_bytes_on_wire") - tb[names[0]] == \
            tquant.wire_bytes(4099 * 4, 4)
    assert [k[1] for k in tcomm._plan_cache] == ["quant_ring"]
    bound = check_bound(got, data, "float32", wire)
    if wire == "bf16":
        np.testing.assert_array_equal(bits(got), bits(want))
    else:
        assert (np.abs(got.astype(np.float64) - want) <= bound).all()


# ---------------------------------------------------------------------------
# The schedule compiler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", ["int8", "bf16"])
def test_sched_quant_is_jax_package(worlds, wire):
    jcomm, tcomm = worlds[0].dup(), worlds[1].dup()
    data = make_input((8, 3000), seed=12)
    with both_vars({"coll_quant_wire": wire,
                    "coll_tuned_allreduce_algorithm": "sched_quant"}):
        want = f32(jcomm.allreduce(jcomm.put_rank_major(data), "sum"))
        got = f32(tcomm.allreduce(tcomm.put_rank_major(
            torch.from_numpy(data)), "sum"))
    ring = f32(tquant.allreduce_quant_ring(torch.from_numpy(data), "sum",
                                           wire=wire))
    np.testing.assert_array_equal(bits(got), bits(ring))
    bound = check_bound(got, data, "float32", wire)
    if wire == "bf16":
        np.testing.assert_array_equal(bits(got), bits(want))
    else:
        assert (np.abs(got.astype(np.float64) - want) <= bound).all()


def test_validate_schedule_holds_quantized_wire_to_bound(worlds):
    comm = worlds[1].dup()
    for wire in ("int8", "bf16"):
        for block in (128, 64):
            sch = tir.quantized_wire(8, wire, block)
            for dtype in ("float32", "bfloat16"):
                assert tlower.validate_schedule(comm, sch, "sum", dtype)
    # quant_pallas as the primitive: the kernel's plain version here
    sch = tir.quantized_wire(8)
    pallas = dataclasses.replace(sch, meta={**sch.meta,
                                            "primitive": "quant_pallas"})
    assert tlower.validate_schedule(comm, pallas, "sum", "float32")

    def broken(b, op):  # a quantized wire that drops rank 3's part
        c = b.clone()
        c[3] = 0
        return tquant.allreduce_quant_ring(c, op)

    assert not tlower._validate_bounded(
        broken, torch.ones(8, 192), lookup("sum"), wire="int8", block=128)


def test_model_mode_digest_with_quant_is_jax_package():
    jcache.CACHE.clear()
    tcache.CACHE.clear()
    with both_vars({"coll_quant_enable": True}):
        want = jautotune.tune(8, mode="model", seed=0, topo_fp="fixed",
                              save=False)
        got = tautotune.tune(8, mode="model", seed=0, topo_fp="fixed",
                             save=False)
        allowed, _ = tautotune.candidates("allreduce", 8, "float32")
        assert allowed == jautotune.candidates("allreduce", 8,
                                               "float32")[0]
        assert "quant_ring" in allowed and "quant_pallas" not in allowed
        assert "quant_ring" not in tautotune.candidates(
            "allreduce", 8, "int32")[0]
    assert got["winners"] == want["winners"]
    assert got["digest"] == want["digest"]
    assert got["times"] == want["times"]
    assert {"quant_ring", "sched_quant"} & set(got["winners"].values())
    jcache.CACHE.clear()
    tcache.CACHE.clear()


def test_cached_quant_winner_needs_consent(worlds, tmp_path):
    """A cached quant winner routes only with the user's consent and a
    supported op; ``allow_quant=False`` vetoes it (JAX package's
    ``_usable`` and the caller's veto)."""
    with both_vars({"coll_sched_cache_dir": str(tmp_path)}):
        fp = tautotune.fingerprint()
        key = tcache.cache_key("allreduce", 1 << 20, 8, "float32", fp)
        tcache.CACHE.clear()
        tcache.CACHE.put(key, "quant_ring")
        tcache.CACHE.save(tcache.default_path(fp, 8))
        tcache.CACHE.clear()
        sum_, max_ = lookup("sum"), lookup("max")
        with both_vars({"coll_quant_enable": False}):
            assert ttuned.decide_allreduce(sum_, 1 << 20, 8,
                                           torch.float32) == "native"
        with both_vars({"coll_quant_enable": True}):
            assert ttuned.decide_allreduce(sum_, 1 << 20, 8,
                                           torch.float32) == "quant_ring"
            assert ttuned.decide_allreduce(
                sum_, 1 << 20, 8, torch.float32, allow_quant=False) == \
                "native"
            assert ttuned.decide_allreduce(max_, 1 << 20, 8,
                                           torch.float32) == "native"
    tcache.CACHE.clear()
