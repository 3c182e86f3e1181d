"""The protocols of the two redesigned kernels, on the CPU: the tree
reduce's segmented "get" tree (``pallas_ring.simulate_tree_reduce``,
its block split ``tree_blocks``) and the whole-payload ring's
fold-then-forward schedule (``pallas_ring.simulate_ring_fused``).

- Interleavings: 200 seeded random schedules at n in {3, 4, 8} (the tree
  at roots 0 and n - 1, rows of several segments ending on a ragged one,
  a few thread blocks per rank) give the lock-step result exactly, with
  every flag back at 0. Negative controls must fail under some schedule:
  a parent that folds a segment before its children's flags, and a ring
  slot credited before the pass that reads it.
- Exactness: the tree's lock-step result equals the reference's fold
  over whole rows (``tools.tree_check.tree_rows``; every row, not only
  root's); the fused ring equals
  ``simulate_ring``, the schedule it replaced, bit for bit.
- Parity: the port's whole (n, L) ``tree_reduce`` output, every row,
  against the JAX package's ``tree_reduce`` under ``shard_map`` (its
  Pallas kernel in TPU-interpret mode on the CPU mesh), at n in {3, 8}
  and two roots, float32 SUM and int32 MAX. Tolerance: bitwise; both
  fold the accumulator on the left, children in round order.
- The block split: weights 2 + children per relative rank, the counts
  sum to the grid, at least one block per rank, at n in {2, 3, 8} and
  132 SMs.

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
from ompi_tpu_torch.tools.tree_check import tree_rows

SEG = 128  # tree segment columns in the simulator tests: 300 = 2 + ragged


def _rows(n: int, cols: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, cols)).astype(np.float32))


def _tree(n: int, root: int, **kw):
    x = _rows(n, 300, seed=n * 10 + root)
    blocks = [1 + (rel % 3) for rel in range(n)]  # 1-3 blocks per rank
    return x, lambda **k: pr.simulate_tree_reduce(
        x, lookup("sum"), root, seg_cols=SEG, blocks=blocks, **kw, **k)


# ---------------------------------------------------------------------------
# The segmented get tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 4, 8])
def test_tree_exact_under_random_interleavings(n):
    for root in (0, n - 1):
        x, simulate = _tree(n, root)
        want, residue = simulate()
        assert not residue
        assert torch.equal(want, tree_rows(x, "sum", root))
        for seed in range(200):
            out, residue = simulate(rng=random.Random(seed))
            assert not residue, (root, seed, residue)
            assert torch.equal(out, want), (root, seed)


@pytest.mark.parametrize("n", [3, 4, 8])
def test_tree_fold_before_flag_loses_values(n):
    """Negative control: a parent that reads its children's rows before
    their segment flags folds rows not yet written under some schedule."""
    for root in (0, n - 1):
        _, simulate = _tree(n, root)
        want, _ = simulate()
        bad = [seed for seed in range(200)
               if not torch.equal(simulate(fold="before_flag",
                                           rng=random.Random(seed))[0], want)]
        assert bad, (root, "folding before the flag survived every schedule")


@pytest.mark.parametrize("n", [2, 3, 8])
def test_tree_blocks_follow_the_bytes(n):
    weights = [2 + len(pr.tree_children(rel, n)) for rel in range(n)]
    if n == 8:
        assert weights == [5, 2, 3, 2, 4, 2, 3, 2]
    for total in (132, 2 * 132):
        counts = pr.tree_blocks(n, total)
        assert sum(counts) == total and min(counts) >= 1
        # every rank streams its rows at about the same pace
        per_block = [w / c for w, c in zip(weights, counts)]
        assert max(per_block) <= min(per_block) * 1.5, counts
    counts = pr.tree_blocks(n, 132, most=2)  # two segments: two blocks
    assert counts == [2] * n
    assert pr.tree_blocks(n, n) == [1] * n
    with pytest.raises(ArgumentError):
        pr.tree_blocks(n, n - 1)


def test_tree_children_are_the_reference_rounds():
    assert [pr.tree_children(rel, 8) for rel in range(8)] == [
        [1, 2, 4], [], [3], [], [5, 6], [], [7], []]
    assert [pr.tree_children(rel, 3) for rel in range(3)] == [[1, 2], [], []]


@pytest.fixture(scope="module")
def devices():
    return np.array(jax.devices())


@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("op,dtype", [("sum", "float32"), ("max", "int32")])
def test_tree_every_row_matches_jax_package(devices, n, op, dtype):
    """Every row, root's and the partial accumulators, bitwise the JAX
    package's tree_reduce under shard_map (interpret mode)."""
    mesh = Mesh(devices[:n], ("x",))
    rng = np.random.default_rng(n * 7 + len(op))
    if dtype == "int32":
        x = rng.integers(-1000, 1000, (n, 333)).astype(np.int32)
    else:
        x = rng.standard_normal((n, 333)).astype(np.float32)
    for root in (0, n - 1):
        f = shard_map(
            lambda v, root=root: jpr.tree_reduce(v[0], "x", op,
                                                 root=root)[None],
            mesh=mesh, in_specs=P("x"), out_specs=P("x"), check_vma=False)
        want = np.asarray(jax.jit(f)(jnp.asarray(x)))
        got = pr.tree_reduce(torch.from_numpy(x), op, root).numpy()
        np.testing.assert_array_equal(got, want)
        got = pr.reduce_block(torch.from_numpy(x), op, root).numpy()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The fold-then-forward ring
# ---------------------------------------------------------------------------

def _ring_blocks(n: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(n).standard_normal(
        (n, n, 256)).astype(np.float32))


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_fused_ring_is_bitwise_the_two_pass_ring(n):
    for dtype in (torch.float32, torch.bfloat16):
        blocks = _ring_blocks(n).to(dtype)
        for op in ("sum", "prod", "max", "min"):
            want, _ = pr.simulate_ring(blocks, lookup(op))
            got, residue = pr.simulate_ring_fused(blocks, lookup(op))
            assert not residue and torch.equal(got, want), (dtype, op)


@pytest.mark.parametrize("n", [3, 4, 8])
def test_fused_ring_exact_under_random_interleavings(n):
    blocks = _ring_blocks(n)
    want, residue = pr.simulate_ring_fused(blocks, lookup("sum"))
    assert not residue
    for seed in range(200):
        out, residue = pr.simulate_ring_fused(blocks, lookup("sum"),
                                              rng=random.Random(seed))
        assert not residue, (seed, residue)
        assert torch.equal(out, want), seed


@pytest.mark.parametrize("n", [3, 4, 8])
def test_fused_ring_credit_before_read_loses_values(n):
    """Negative control: a slot credited to the left neighbour before the
    pass that reads it is overwritten under some schedule."""
    blocks = _ring_blocks(n)
    want, _ = pr.simulate_ring_fused(blocks, lookup("sum"))
    bad = [seed for seed in range(200)
           if not torch.equal(pr.simulate_ring_fused(
               blocks, lookup("sum"), credit="before_read",
               rng=random.Random(seed))[0], want)]
    assert bad, "crediting before the read survived every schedule"


def test_redesigned_simulators_refuse_unknown_placements():
    x = torch.ones(3, 128)
    with pytest.raises(ArgumentError):
        pr.simulate_tree_reduce(x, lookup("sum"), fold="bogus")
    with pytest.raises(ArgumentError):
        pr.simulate_tree_reduce(x, lookup("sum"), blocks=[1, 0, 1])
    with pytest.raises(ArgumentError):
        pr.simulate_ring_fused(torch.ones(3, 3, 128), lookup("sum"),
                               credit="bogus")
