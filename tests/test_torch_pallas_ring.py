"""The port's ring allreduce tier (``ompi_tpu_torch/coll/pallas_ring.py``)
against the JAX package's Pallas kernels and a numpy ring-order oracle.

- Parity: the same numpy inputs go through ``ompi_tpu``'s
  ``PallasColl`` (its kernels in TPU-interpret mode on the 8-device CPU
  mesh) and the port's ``PallasColl`` on ``device="cpu"`` (the kernels'
  plain versions, the protocol simulators). Tolerance: exact. Each
  element's reduction starts at the same rank and folds in the same
  order in both, and both combine bfloat16 in float32 rounded once per
  step.
- Sweeps: every tier x n in {2, 3, 4, 8} x sum/max/min/prod x
  float32/bfloat16/int32 on the port's simulators against a numpy
  oracle that folds each block in ring order (bfloat16 through
  ml_dtypes, which also computes in float32 and rounds once). Exact.
- Interleavings: the ring simulator, the chunked kernel's wavefront
  (``simulate_ring_chunked``), the ring's two halves (the
  reduce-scatter's two-pass schedule and the allgather kernel's
  wavefront, ``simulate_ring_ag_fused``) and the bidirectional ring,
  under 200 seeded random schedules at n in {3, 4, 8} must give the
  lock-step result exactly with every flag back at 0; the reference's
  credit placement (for the chunked and allgather kernels, the JAX
  package's own schedule) must fail (the negative control), as must the
  bidirectional ring at n = 2 with one set of flags for both
  directions. The alltoall, gather and scatter simulators likewise (the
  scatter's rows in pieces streamed by two of root's blocks), with one
  flag per step, sender or receiver; with a shared flag (the JAX
  package's docstrings say why) some wait returns before the row it
  certifies has landed.

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
from ompi_tpu.core import config as jconfig
from ompi_tpu_torch.coll import pallas_ring as pr
from ompi_tpu_torch.core import config as tconfig
from ompi_tpu_torch.core import counters
from ompi_tpu_torch.core.errors import ArgumentError
from ompi_tpu_torch.ops import lookup

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16),
          "int32": (np.int32, jnp.int32, torch.int32)}
NP_OPS = {"sum": np.add, "prod": np.multiply, "max": np.maximum,
          "min": np.minimum}
# Vars lowered in both packages to reach the chunked tier (and several
# segments) at small sizes, and to force the plain ring below the
# recursive-doubling cutoff.
CHUNKED_VARS = {"coll_pallas_chunk_threshold_bytes": 1024,
                "coll_pallas_segment_bytes": 4096}
RING_VARS = {"coll_pallas_rd_cutoff_bytes": 0}


def make_input(n: int, elems: int, dtype: str, seed: int) -> np.ndarray:
    """(n, elems) float32 or int32 numpy data; bfloat16 cases round it
    on the way into each package."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-1000, 1000, (n, elems)).astype(np.int32)
    return rng.standard_normal((n, elems)).astype(np.float32)


def to_torch(x: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(x).to(DTYPES[dtype][2])


def as_f64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(t, jnp.float32)).astype(np.float64)


def oracle(x: np.ndarray, op: str, dtype: str, tier: str,
           seg_bytes: int = 1 << 20) -> np.ndarray:
    """Ring-order (or, for rd, rank-ordered tree) reduction in numpy, in
    the working dtype, returned rank-major as float64."""
    n, L = x.shape
    v = x.astype(DTYPES[dtype][0])
    f = NP_OPS[op]
    if tier == "rd":
        parts = list(v)
        while len(parts) > 1:
            parts = [f(parts[i], parts[i + 1]) for i in range(0, len(parts), 2)]
        red = parts[0]
    else:
        if tier == "ring":
            width = -(-L // (n * pr.LANES)) * pr.LANES
        else:
            rows, _ = pr._chunked_layout(L, n, DTYPES[dtype][2], seg_bytes)
            width = rows * pr.LANES
        padded = np.zeros((n, n * width), v.dtype)
        padded[:, :L] = v
        blocks = padded.reshape(n, n, width)  # [rank, block, col]
        red = np.empty((n, width), v.dtype)
        for b in range(n):
            acc = blocks[(b + 1) % n, b]
            for k in range(2, n + 1):
                acc = f(acc, blocks[(b + k) % n, b])
            red[b] = acc
        red = red.reshape(-1)[:L]
    return np.broadcast_to(red.astype(np.float64), (n, L))


# ---------------------------------------------------------------------------
# Parity with the JAX package (PallasColl route on both sides).
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds():
    jworld = ompi_tpu.init()
    tworld = ompi_tpu_torch.init(device="cpu")
    jconfig.VARS.set("coll_pallas_priority", 100)
    tconfig.VARS.set("coll_pallas_priority", 100)
    try:
        yield jworld, tworld
    finally:
        jconfig.VARS.set("coll_pallas_priority", 30)
        tconfig.VARS.set("coll_pallas_priority", 30)
        ompi_tpu_torch.finalize()


def _sub(world, n):
    if n == world.size:
        return world.dup()
    return world.split([0 if r < n else -1 for r in range(world.size)])[0]


def run_both(worlds, n, elems, dtype, op, vars_, seed):
    """One allreduce through each package with the same vars and
    inputs; returns (jax out, port out, jax comm, port comm)."""
    jworld, tworld = worlds
    old_j = {k: jconfig.get(k) for k in vars_}
    old_t = {k: tconfig.get(k) for k in vars_}
    for k, v in vars_.items():
        jconfig.VARS.set(k, v)
        tconfig.VARS.set(k, v)
    try:
        jc, tc = _sub(jworld, n), _sub(tworld, n)
        x = make_input(n, elems, dtype, seed)
        jout = jc.allreduce(jc.put_rank_major(
            jnp.asarray(x, DTYPES[dtype][1])), op)
        tout = tc.allreduce(tc.put_rank_major(to_torch(x, dtype)), op)
        return as_f64(jout), as_f64(tout), jc, tc
    finally:
        for k in vars_:
            jconfig.VARS.set(k, old_j[k])
            tconfig.VARS.set(k, old_t[k])


# (n, body the JAX PallasColl must pick, op, dtype, elems per rank, vars)
PARITY_CASES = [
    (2, "allreduce_block_rd", "max", "bfloat16", 40, {}),
    (2, "allreduce_block", "prod", "int32", 300, RING_VARS),
    (2, "allreduce_block_chunked", "sum", "float32", 3000, CHUNKED_VARS),
    (3, "allreduce_block", "sum", "float32", 33, {}),
    (3, "allreduce_block_chunked", "min", "bfloat16", 7000, CHUNKED_VARS),
    (4, "allreduce_block_rd", "sum", "float32", 70, {}),
    (4, "allreduce_block", "max", "int32", 1000, RING_VARS),
    (8, "allreduce_block", "sum", "bfloat16", 130, RING_VARS),
    (8, "allreduce_block_chunked", "prod", "float32", 2100, CHUNKED_VARS),
    (8, "allreduce_block_rd", "min", "int32", 33, {}),
]


@pytest.mark.parametrize("n,body,op,dtype,elems,vars_", PARITY_CASES,
                         ids=[f"n{c[0]}-{c[1]}-{c[2]}-{c[3]}"
                              for c in PARITY_CASES])
def test_pallas_component_matches_jax(worlds, n, body, op, dtype, elems,
                                      vars_):
    j, t, jc, tc = run_both(worlds, n, elems, dtype, op, vars_,
                            seed=1000 + n * 7 + elems)
    assert tc._coll["allreduce"][0].NAME == "pallas"
    assert any(body in k for k in jc._plan_cache), list(jc._plan_cache)
    assert any(body in k for k in tc._plan_cache), list(tc._plan_cache)
    np.testing.assert_array_equal(t, j)
    tier = {"allreduce_block": "ring", "allreduce_block_rd": "rd",
            "allreduce_block_chunked": "chunked"}[body]
    np.testing.assert_array_equal(
        t, oracle(make_input(n, elems, dtype, 1000 + n * 7 + elems), op,
                  dtype, tier, vars_.get("coll_pallas_segment_bytes",
                                         1 << 20)))


# ---------------------------------------------------------------------------
# Simulator sweeps against the numpy oracle (the port alone).
# ---------------------------------------------------------------------------

SWEEP = [(tier, n) for tier in ("ring", "chunked", "rd")
         for n in (2, 3, 4, 8) if not (tier == "rd" and n == 3)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("op", sorted(NP_OPS))
@pytest.mark.parametrize("tier,n", SWEEP)
def test_simulator_sweep_matches_ring_order_oracle(tier, n, op, dtype):
    seg_bytes = 4096
    elems = {"ring": 333, "rd": 201, "chunked": n * 128 * 20 + 7}[tier]
    x = make_input(n, elems, dtype, seed=n * 100 + len(op))
    t = to_torch(x, dtype)
    if tier == "ring":
        out = pr.allreduce_block(t, op)
    elif tier == "rd":
        out = pr.allreduce_block_rd(t, op)
    else:
        out = pr.allreduce_block_chunked(t, op, seg_bytes)
    assert out.shape == t.shape and out.dtype == t.dtype
    np.testing.assert_array_equal(as_f64(out),
                                  oracle(x, op, dtype, tier, seg_bytes))


def test_layouts_match_the_jax_blocking():
    blocks, pad, shape = pr._split_ring(torch.zeros(3, 5, 7))
    assert blocks.shape == (3, 3, 128) and pad == 3 * 128 - 35
    assert shape == (5, 7)
    # (size, n, dtype, segment bytes) -> (rows, seg_rows), worked by hand
    # from ring_allreduce_chunked's formula (pallas_ring.py:477-481)
    assert pr._chunked_layout(1 << 28, 8, torch.float32, 1 << 20) \
        == (262144, 2048)
    assert pr._chunked_layout(3000, 2, torch.float32, 4096) == (16, 8)
    assert pr._chunked_layout(7000, 3, torch.bfloat16, 4096) == (32, 16)
    assert pr._chunked_layout(33, 8, torch.int32, 100) == (8, 8)
    assert pr._sublane(torch.bfloat16) == 16 and pr._sublane(torch.int32) == 8


# ---------------------------------------------------------------------------
# Interleavings: the credit protocol under concurrency.
# ---------------------------------------------------------------------------

def _ring_case(kernel, n):
    """simulate(credit=..., rng=...) -> (out, residue) of a ring kernel:
    the allreduce ring, its chunked form, one of its halves
    (reduce-scatter, allgather), or the bidirectional ring."""
    blocks = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (n, n, 256)).astype(np.float32))
    op = lookup("sum")
    if kernel == "bidir":
        return lambda **kw: pr.simulate_ring_bidir(blocks, op, **kw)
    if kernel == "chunked":
        # the chunked kernel's wavefront over four segments; its credit
        # "reference" runs the JAX package's segmented two-pass schedule
        return lambda **kw: pr.simulate_ring_chunked(blocks, op, seg_cols=64,
                                                     **kw)
    if kernel == "ag":
        # the allgather kernel's wavefront over four segments; its credit
        # "reference" runs the JAX package's two-pass schedule
        own = blocks[:, 0].contiguous()
        return lambda **kw: pr.simulate_ring_ag_fused(own, seg_cols=64, **kw)
    kw0 = dict(phase="rs") if kernel == "rs" else {}
    return lambda **kw: pr.simulate_ring(blocks, op, **kw0, **kw)


RING_KERNELS = ["ring", "chunked", "rs", "ag", "bidir"]


@pytest.mark.parametrize("n", [3, 4, 8])
@pytest.mark.parametrize("kernel", RING_KERNELS)
def test_port_protocol_exact_under_random_interleavings(kernel, n):
    simulate = _ring_case(kernel, n)
    want, residue = simulate()
    assert not residue
    for seed in range(200):
        out, residue = simulate(rng=random.Random(seed))
        assert not residue, (seed, residue)
        assert torch.equal(out, want), seed


@pytest.mark.parametrize("n", [3, 4, 8])
@pytest.mark.parametrize("kernel", RING_KERNELS)
def test_reference_credit_placement_fails_under_interleavings(kernel, n):
    """Negative control: the JAX package's credit placement
    (pallas_ring.py:263-267, :387-391; in the halves a post-seed credit,
    :135-137 and :184-186, then :159-164 and :208-214; in the
    bidirectional ring :664-668 and :700-705) in the same simulator
    loses a partial under some schedule — the interleaver has teeth."""
    simulate = _ring_case(kernel, n)
    want, _ = simulate()
    lockstep, residue = simulate(credit="reference")
    assert torch.equal(lockstep, want) and not residue
    bad = [seed for seed in range(200)
           if not torch.equal(simulate(credit="reference",
                                       rng=random.Random(seed))[0], want)]
    assert bad, "reference placement survived every schedule"


def _faulty(simulate, rng) -> bool:
    """Did a run end with a wrong result, a flag not back at 0 or a
    deadlock?"""
    try:
        out, residue = simulate(rng=rng)
    except RuntimeError:  # protocol deadlock
        return True
    return bool(residue) or not torch.equal(out, simulate()[0])


def test_bidir_directions_need_their_own_flags():
    """At n = 2 both directions signal the same neighbour: with their
    own flags the bidirectional ring is exact on every schedule; with
    one set of flags for both, some schedule goes wrong."""
    blocks = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 2, 256)).astype(np.float32))
    op = lookup("sum")
    own = lambda **kw: pr.simulate_ring_bidir(blocks, op, **kw)  # noqa: E731
    shared = lambda **kw: pr.simulate_ring_bidir(  # noqa: E731
        blocks, op, shared_flags=True, **kw)
    assert not any(_faulty(own, random.Random(seed)) for seed in range(200))
    assert any(_faulty(shared, random.Random(seed)) for seed in range(200))


def _mover_case(kind, n):
    """(simulate(flags=..., rng=...), the result it must give) of a
    data-movement kernel; gather and scatter at root n-1."""
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (n, n, 64)).astype(np.float32))
    if kind == "alltoall":
        return (lambda **kw: pr.simulate_alltoall(x, **kw)), x.transpose(0, 1)
    flat = x[:, 0].contiguous()
    if kind == "scatter":  # four pieces a row, two of root's blocks
        return (lambda **kw: pr.simulate_scatter(
            flat, n - 1, piece_cols=16, senders=2, **kw)), flat
    return (lambda **kw: pr.simulate_gather(flat, n - 1, **kw)), flat


@pytest.mark.parametrize("n", [3, 4, 8])
@pytest.mark.parametrize("kind", ["alltoall", "gather", "scatter"])
def test_data_mover_protocols_exact_under_random_interleavings(kind, n):
    simulate, truth = _mover_case(kind, n)
    for seed in [None] + list(range(200)):
        out, residue = simulate(
            rng=None if seed is None else random.Random(seed))
        assert not residue, (seed, residue)
        assert torch.equal(out, truth), seed


@pytest.mark.parametrize("kind,n", [("alltoall", 8), ("gather", 4),
                                    ("gather", 8), ("scatter", 4),
                                    ("scatter", 8)])
def test_shared_flag_lets_a_wait_return_early(kind, n):
    """Negative control: with two flags rotated over the alltoall's
    steps (pallas_ring.py:988-993), or one flag for all of the gather's
    senders (:1042-1051) or the scatter's receivers, some wait returns
    before the row it certifies has landed. (The alltoall's rotation is
    safe up to n = 4: its step-3 writer has itself waited on a chain
    that starts with the step-1 writer's store.)"""
    simulate, _ = _mover_case(kind, n)
    early = [seed for seed in range(200)
             if any(k[0] == "early" for k in simulate(
                 flags="shared", rng=random.Random(seed))[1])]
    assert early, "a shared flag survived every schedule"


def test_rd_protocol_exact_under_random_interleavings():
    flat = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (8, 300)).astype(np.float32))
    op = lookup("sum")
    want, residue = pr.simulate_rd(flat, op)
    assert not residue
    for seed in range(200):
        out, residue = pr.simulate_rd(flat, op, rng=random.Random(seed))
        assert not residue and torch.equal(out, want), seed


# ---------------------------------------------------------------------------
# Wrappers: CPU tensors take the plain version; bad inputs raise.
# ---------------------------------------------------------------------------

def test_cpu_wrappers_use_plain_versions_without_launching():
    before = counters.launches()
    x = torch.ones(4, 4, 128)
    assert torch.equal(pr.ring_allreduce(x, "sum"), torch.full_like(x, 4))
    assert torch.equal(pr.ring_allreduce_chunked(x, "sum", 64),
                       torch.full_like(x, 4))
    assert torch.equal(pr.ring_allreduce_rd(torch.ones(4, 128), "max"),
                       torch.ones(4, 128))
    assert counters.launches() == before


def test_kernel_input_validation():
    with pytest.raises(ArgumentError):
        pr.ring_allreduce_rd(torch.ones(3, 128), "sum")
    with pytest.raises(ArgumentError):
        pr.ring_allreduce_chunked(torch.ones(2, 2, 128), "sum", 100)
    with pytest.raises(ArgumentError):
        pr._codes(lookup("land"), torch.float32)
    with pytest.raises(ArgumentError):
        pr._codes(lookup("sum"), torch.int16)
    with pytest.raises(ArgumentError):
        pr.simulate_ring(torch.ones(2, 2, 8), lookup("sum"), credit="bogus")
