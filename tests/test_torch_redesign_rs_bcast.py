"""The protocols of the redesigned bcast tree and ring reduce-scatter, on
the CPU: the segmented "get" bcast (``pallas_ring.simulate_tree_bcast``,
its tree ``bcast_children``) and the reduce-scatter's fold-then-forward
wavefront (``pallas_ring.simulate_ring_rs_fused``, its plan
``_rs_plan``).

- Interleavings: 200 seeded random schedules at n in {3, 4, 8} give the
  lock-step result exactly, with every flag back at 0: the bcast at
  roots 0 and n - 1 over rows of several segments ending on a ragged one,
  one to three thread blocks per rank; the reduce-scatter with fewer
  segments than its n - 1 steps, as many, and more, the last ragged.
  Negative controls must fail under some schedule: a child that copies
  a segment before its flag, and a slot credited before the passes that
  read it.
- Exactness: every bcast row is row ``root``; the wavefront is bitwise
  ``simulate_ring(phase="rs")``, the schedule it replaced, for every op
  in float32, bfloat16 and int32 at n in {2, 3, 4, 8} and several
  segment sizes.
- Parity: the wavefront over several segments and the segmented bcast,
  against the JAX package's ``ring_reduce_scatter`` and ``tree_bcast``
  under ``shard_map`` (its Pallas kernels in TPU-interpret mode on the
  CPU mesh), at n = 3 (int32 MAX) and n = 8 (bfloat16 SUM; float32 is
  in test_torch_colls.py). Tolerance: bitwise; both fold the arrival
  on the left, in ring order, and the bcast copies bits.
- The tree: ``bcast_children`` is the reference's rounds (each rank
  receives once, from rel minus its highest bit). The wavefront's
  ``_rs_forwards`` is its schedule's closed form. The plan: a cluster
  up to ``RS_CLUSTER_RANKS`` ranks, a block's buffers within
  ``RS_SMEM_BYTES`` of its shared memory there, and every block's within
  ``RS_SLOT_BYTES`` of L2 otherwise.

The kernels themselves, on a card, are tested in test_torch_kernels.py.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ompi_tpu.coll import pallas_ring as jpr
from ompi_tpu_torch.coll import pallas_ring as pr
from ompi_tpu_torch.core.errors import ArgumentError
from ompi_tpu_torch.ops import lookup

SEG = 128  # bcast segment columns: 300 = 2 + a ragged one
OPS = ("sum", "prod", "max", "min")


def _rows(shape, seed: int, dtype=torch.float32) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        return torch.from_numpy(rng.integers(-1000, 1000, shape).astype(
            np.int32))
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype)


def _bcast(n: int, root: int):
    x = _rows((n, 300), seed=n * 10 + root)
    blocks = [1 + (rel % 3) for rel in range(n)]  # 1-3 blocks per rank
    return x, lambda **k: pr.simulate_tree_bcast(
        x, root, seg_cols=SEG, blocks=blocks, **k)


# ---------------------------------------------------------------------------
# The segmented get bcast
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 4, 8])
def test_bcast_exact_under_random_interleavings(n):
    for root in (0, n - 1):
        x, simulate = _bcast(n, root)
        want, residue = simulate()
        assert not residue
        assert torch.equal(want, x[root].expand_as(x))
        for seed in range(200):
            out, residue = simulate(rng=random.Random(seed))
            assert not residue, (root, seed, residue)
            assert torch.equal(out, want), (root, seed)


@pytest.mark.parametrize("n", [3, 4, 8])
def test_bcast_copy_before_flag_loses_values(n):
    """Negative control: a child that copies its parent's segment before
    the segment's flag copies a segment not yet written under some
    schedule."""
    for root in (0, n - 1):
        _, simulate = _bcast(n, root)
        want, _ = simulate()
        assert any(not torch.equal(simulate(copy="before_flag",
                                            rng=random.Random(seed))[0], want)
                   for seed in range(200)), \
            (root, "copying before the flag survived every schedule")


def _reference_rounds(n: int) -> dict:
    """rel -> the relative ranks it sends to, from the JAX package's
    rounds: in round k every rel < 2^k with rel + 2^k < n sends to
    rel + 2^k."""
    sends = {rel: [] for rel in range(n)}
    for k in range(max(1, (n - 1).bit_length())):
        bit = 1 << k
        for rel in range(n):
            if rel < bit and rel + bit < n:
                sends[rel].append(rel + bit)
    return sends


def test_bcast_children_are_the_reference_rounds():
    assert [pr.bcast_children(rel, 8) for rel in range(8)] == [
        [1, 2, 4], [3, 5], [6], [7], [], [], [], []]
    for n in range(1, 18):
        sends = _reference_rounds(n)
        assert [pr.bcast_children(rel, n) for rel in range(n)] == \
            [sends[rel] for rel in range(n)], n
        # every rank but the root receives once, from rel - highbit(rel)
        edges = [(p, c) for p in range(n) for c in pr.bcast_children(p, n)]
        assert sorted(c for _, c in edges) == list(range(1, n))
        assert all(p == c - (1 << (c.bit_length() - 1)) for p, c in edges)


# ---------------------------------------------------------------------------
# The fold-then-forward reduce-scatter wavefront
# ---------------------------------------------------------------------------

def _rs_blocks(n: int, n_segs: int, seg: int = 16):
    """(blocks of n_segs segments, the last ragged, segment columns)."""
    return _rows((n, n, n_segs * seg - 5), seed=n * 100 + n_segs), seg


def _rs_cases(n: int):
    """Blocks with fewer segments than the n - 1 steps, as many, and
    more."""
    for n_segs in sorted({max(1, n - 3), n - 1, n + 1}):
        yield _rs_blocks(n, n_segs)


@pytest.mark.parametrize("n", [3, 4, 8])
def test_rs_wavefront_exact_under_random_interleavings(n):
    for blocks, seg in _rs_cases(n):
        want, residue = pr.simulate_ring_rs_fused(blocks, lookup("sum"),
                                                  seg_cols=seg)
        assert not residue
        assert torch.equal(want, pr.simulate_ring(blocks, lookup("sum"),
                                                  phase="rs")[0])
        for seed in range(200):
            out, residue = pr.simulate_ring_rs_fused(
                blocks, lookup("sum"), seg_cols=seg, rng=random.Random(seed))
            assert not residue, (blocks.shape, seed, residue)
            assert torch.equal(out, want), (blocks.shape, seed)


def test_rs_forwards_is_the_wavefront_schedule():
    """The closed form that the kernel and the simulator share: slot p
    forwards when some step k in 0 .. n-3 falls on a segment p - k in
    0 .. n_segs-1."""
    for n in range(2, 10):
        for n_segs in range(1, 12):
            for p in range(-3, n_segs + n + 2):
                want = any(0 <= p - k < n_segs for k in range(n - 2))
                assert pr._rs_forwards(p, n, n_segs) == want, (n, n_segs, p)


@pytest.mark.parametrize("n", [3, 4, 8])
def test_rs_wavefront_credit_before_read_loses_values(n):
    """Negative control: buffers credited to the left neighbour before
    the passes that read them are overwritten under some schedule (with
    enough segments that every buffer is written again)."""
    blocks, seg = _rs_blocks(n, n + 2 * pr.RS_BUFS)
    want, _ = pr.simulate_ring_rs_fused(blocks, lookup("sum"), seg_cols=seg)
    assert any(not torch.equal(pr.simulate_ring_rs_fused(
        blocks, lookup("sum"), seg_cols=seg, credit="before_read",
        rng=random.Random(seed))[0], want) for seed in range(200)), \
        "crediting before the read survived every schedule"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_rs_wavefront_is_bitwise_the_two_pass_ring(n, dtype):
    blocks = _rows((n, n, 70), seed=n, dtype=dtype)
    for op in OPS:
        want, _ = pr.simulate_ring(blocks, lookup(op), phase="rs")
        for seg in (None, 8, 32):  # 1, 9 and 3 segments
            got, residue = pr.simulate_ring_rs_fused(blocks, lookup(op),
                                                     seg_cols=seg)
            assert not residue and got.dtype == dtype
            assert torch.equal(got, want), (op, seg)


def test_rs_plan_keeps_the_buffers_in_shared_memory_or_l2():
    for n in (2, 3, 8, 12):
        for block_bytes in (512, 128 << 10, 128 << 20):  # 4 KiB..1 GiB sent
            for cluster in (None, False):
                stripes, threads, seg, used = pr._rs_plan(n, block_bytes, 132,
                                                          cluster)
                assert used == (n <= pr.RS_CLUSTER_RANKS and cluster is None)
                per_sm = (pr.RS_CLUSTER_BLOCKS_PER_SM if used
                          else pr.RS_BLOCKS_PER_SM)
                assert 1 <= stripes <= per_sm * 132 // n
                assert 32 <= threads <= 512 and seg % 16 == 0 and seg > 0
                per_block = pr.RS_BUFS * max(n - 2, 0) * seg
                if used:  # a block's buffers in its shared memory
                    assert per_block <= pr.RS_SMEM_BYTES
                else:  # every block's buffers in L2
                    assert n * stripes * per_block <= pr.RS_SLOT_BYTES
                stripe = -(-block_bytes // 16 // stripes) * 16
                assert seg <= max(stripe, 16)
    # the main path: 128 MiB ring blocks at n = 8 fill the card, one
    # vector per thread and pass
    stripes, threads, seg, used = pr._rs_plan(8, 128 << 20, 132)
    assert used and stripes * 8 >= 4 * 128 and seg == 16 * threads


def test_redesigned_simulators_refuse_unknown_placements():
    with pytest.raises(ArgumentError):
        pr.simulate_tree_bcast(torch.ones(3, 128), copy="bogus")
    with pytest.raises(ArgumentError):
        pr.simulate_tree_bcast(torch.ones(3, 128), blocks=[1, 0, 1])
    with pytest.raises(ArgumentError):
        pr.simulate_ring_rs_fused(torch.ones(3, 3, 128), lookup("sum"),
                                  credit="bogus")
    with pytest.raises(ArgumentError):
        pr.simulate_ring_rs_fused(torch.ones(3, 3, 128), lookup("sum"),
                                  seg_cols=0)
    with pytest.raises(ArgumentError):  # clusters hold at most 8 ranks
        pr._rs_plan(12, 128 << 10, 132, cluster=True)


# ---------------------------------------------------------------------------
# Against the JAX package's kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def devices():
    return np.array(jax.devices())


@pytest.mark.parametrize("n,op,dtype", [(3, "max", torch.int32),
                                        (8, "sum", torch.bfloat16)])
def test_segmented_schedules_match_jax_package(devices, n, op, dtype):
    """The wavefront over six segments (fewer than seven steps at n = 8,
    more than two at n = 3) and the bcast over three, bitwise the JAX
    package's kernels under shard_map."""
    mesh = Mesh(devices[:n], ("x",))
    x = _rows((n, n, 333), seed=n * 7 + len(op), dtype=dtype)
    xj = jnp.asarray(x.float().numpy()).astype(
        {torch.float32: jnp.float32, torch.int32: jnp.int32,
         torch.bfloat16: jnp.bfloat16}[dtype])
    f = shard_map(lambda v: jpr.ring_reduce_scatter(v[0], "x", op)[None],
                  mesh=mesh, in_specs=P("x"), out_specs=P("x"),
                  check_vma=False)
    want = torch.from_numpy(np.asarray(jax.jit(f)(xj)).astype(np.float32))
    got, residue = pr.simulate_ring_rs_fused(x, lookup(op), seg_cols=64)
    assert not residue
    assert torch.equal(got.float(), want)
    flat, fj = x[:, 0].contiguous(), xj[:, 0]
    for root in (0, n - 1):
        f = shard_map(lambda v, root=root: jpr.tree_bcast(v[0], "x",
                                                          root)[None],
                      mesh=mesh, in_specs=P("x"), out_specs=P("x"),
                      check_vma=False)
        want = torch.from_numpy(np.asarray(jax.jit(f)(fj)).astype(np.float32))
        got, residue = pr.simulate_tree_bcast(flat, root, seg_cols=128,
                                              blocks=[2] * n)
        assert not residue
        assert torch.equal(got.float(), want)
