"""The protocols of the redesigned linear gather and recursive-doubling
allreduce, on the CPU: the gather's rows streamed by a pool of blocks
per rank in ticketed pieces onto root's counted flags
(``pallas_ring.simulate_gather``, the plain version of
``linear_gather``; its plan ``_gather_plan``) and recursive doubling in
its two forms, its slots and flags in a cluster's shared memory or in
global memory (``pallas_ring.simulate_rd``, the plain version of
``ring_allreduce_rd``; its plan ``_rd_plan``).

- Parity: the gather, bitwise the JAX package's PallasColl gather (its
  ``_gather_kernel`` in TPU-interpret mode on the CPU mesh) at n in {2,
  3, 8}, roots 0, 1 and n - 1, float32, bfloat16 and int32 taken in
  turn, over several pieces and pool sizes, and the port's PallasColl on
  ``device="cpu"`` likewise. Both forms of recursive doubling, bitwise
  the JAX package's ``allreduce_block_rd`` through its PallasColl (its
  ``_allreduce_rd_kernel`` in interpret mode) at n in {2, 4, 8} for sum,
  max and prod, each op on the three dtypes taken in turn over the n, at
  sizes the lane padding pads and sizes it does not, and the port's
  PallasColl likewise. Exact: the
  gather copies bits, and recursive doubling combines in rank order at
  the same ranks in the same rounds (bfloat16 in float32, rounded once a
  round).
- Interleavings: 200 seeded random schedules give the lock-step result
  exactly with every flag, ticket, count and credit back at 0: the
  gather at n in {3, 4, 8} over ragged pieces, pools of one to three
  blocks and pools of unequal sizes, publishing one to three pieces at a
  time; recursive doubling at n in {4, 8}
  in both forms. Negative controls: with one flag for all senders some
  gather wait returns before its row has landed; with one slot and one
  flag for all rounds a fast pair's later round overwrites or satisfies
  an earlier one.
- The plans: the gather's pools fill the resident slots, never with more
  blocks than pieces; recursive doubling takes the cluster form only up
  to 8 ranks, its slots within a block's shared memory, and the L2 form
  beyond. The wrappers refuse what they do not take.

The kernels themselves, on a card, are tested in test_torch_kernels.py.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch
from ompi_tpu.core import config as jconfig
from ompi_tpu_torch.coll import pallas_ring as pr
from ompi_tpu_torch.core import config as tconfig
from ompi_tpu_torch.core import counters
from ompi_tpu_torch.core.errors import ArgumentError, KernelError
from ompi_tpu_torch.ops import lookup

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.int32: jnp.int32}
DTYPES = (torch.float32, torch.bfloat16, torch.int32)
# PallasColl chosen in both packages: its gather, and its allreduce's rd
# tier below coll_pallas_rd_cutoff_bytes on power-of-two rings.
PALLAS_VARS = {"coll_pallas_priority": 100}


def _rows(shape, seed: int, dtype=torch.float32) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if not dtype.is_floating_point:
        return torch.from_numpy(rng.integers(-100, 100, shape).astype(
            np.int32)).to(dtype)
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype)


def _jax(x: torch.Tensor):
    return jnp.asarray(x.float().numpy()).astype(JDT[x.dtype])


def _from_jax(a) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))


@pytest.fixture(scope="module")
def worlds():
    jworld = ompi_tpu.init()
    tworld = ompi_tpu_torch.init(device="cpu")
    old = {k: (jconfig.get(k), tconfig.get(k)) for k in PALLAS_VARS}
    for k, v in PALLAS_VARS.items():
        jconfig.VARS.set(k, v)
        tconfig.VARS.set(k, v)
    try:
        yield jworld, tworld
    finally:
        for k, (j, t) in old.items():
            jconfig.VARS.set(k, j)
            tconfig.VARS.set(k, t)
        ompi_tpu_torch.finalize()


def _sub(world, n):
    if n == world.size:
        return world.dup()
    return world.split([0 if r < n else -1 for r in range(world.size)])[0]


# ---------------------------------------------------------------------------
# Against the JAX package's kernels (interpret mode) and PallasColl
# ---------------------------------------------------------------------------

def _gather_plans(n):
    """(piece columns, pool sizes, pieces per publication): one piece a
    row with one block, three pieces (the last ragged) with one, ragged
    pieces with three blocks a pool published two at a time, and pools of
    unequal sizes, some larger than their pieces, publishing every
    piece."""
    return ((None, 1, 1), (128, 1, 2), (37, 3, 2),
            (64, [1 + q % 3 for q in range(n)], 1))


@pytest.mark.parametrize("n", [2, 3, 8])
def test_gather_is_bitwise_jax_package(worlds, n):
    """The JAX package's PallasColl gather at roots 0, 1 and n - 1, the
    dtypes taken in turn, against the pools' protocol and the port's
    PallasColl on the CPU."""
    jcomm, tcomm = _sub(worlds[0], n), _sub(worlds[1], n)
    for i, root in enumerate(sorted({0, 1, n - 1})):
        dtype = DTYPES[(i + n) % 3]
        x = _rows((n, 300), seed=n * 13 + root, dtype=dtype)
        want = _from_jax(jcomm.gather(jcomm.put_rank_major(_jax(x)), root))
        assert tuple(want.shape) == (n, 300)
        for piece, blocks, publish in _gather_plans(n):
            got, residue = pr.simulate_gather(x, root, piece_cols=piece,
                                              blocks=blocks, publish=publish)
            assert not residue and got.dtype == dtype
            assert torch.equal(got.float(), want), (root, piece, blocks)
        before = counters.launches()
        got = tcomm.gather(tcomm.put_rank_major(x), root)
        assert counters.launches() == before  # the plain version, no card
        assert any(k[1] == "pallas" for k in tcomm._plan_cache
                   if k[0] == "gather")
        assert torch.equal(got.float(), want), root


def _rd_forms(form):
    def rd(flat, op):
        got, residue = pr.simulate_rd(flat, lookup(op), form=form)
        assert not residue
        return got
    return rd


RD_NS = (2, 4, 8)


def _rd_cases(n):
    """(op, dtype, elements per rank) at n: sum, max and prod, each with
    a dtype taken in turn by n, so that over the three n every op meets
    every dtype; elements that the 128-lane padding pads (200) and that
    it does not (256), both at every n."""
    m = RD_NS.index(n)
    return [(op, DTYPES[(i + m) % 3], (200, 256)[(i + m) % 2])
            for i, op in enumerate(("sum", "max", "prod"))]


def test_rd_cases_cover_every_op_dtype_and_size():
    cases = [c for n in RD_NS for c in _rd_cases(n)]
    assert {(op, dtype) for op, dtype, _ in cases} == {
        (op, dtype) for op in ("sum", "max", "prod") for dtype in DTYPES}
    assert all({e for _, _, e in _rd_cases(n)} == {200, 256} for n in RD_NS)


@pytest.mark.parametrize("n", RD_NS)
def test_rd_forms_are_bitwise_jax_package(worlds, n):
    jcomm, tcomm = _sub(worlds[0], n), _sub(worlds[1], n)
    for i, (op, dtype, elems) in enumerate(_rd_cases(n)):
        x = _rows((n, elems), seed=n * 31 + i, dtype=dtype)
        if op == "prod" and dtype.is_floating_point:
            x = 1 + x / 8  # products that stay finite and informative
        want = _from_jax(jcomm.allreduce(jcomm.put_rank_major(_jax(x)), op))
        assert any("allreduce_block_rd" in k for k in jcomm._plan_cache)
        for form in ("l2", "cluster"):
            got = pr.allreduce_block_rd(x, op, rd=_rd_forms(form))
            assert got.dtype == dtype
            assert torch.equal(got.float(), want), (op, dtype, form)
        before = counters.launches()
        got = tcomm.allreduce(tcomm.put_rank_major(x), op)
        assert counters.launches() == before
        assert any("allreduce_block_rd" in k for k in tcomm._plan_cache)
        assert torch.equal(got.float(), want), (op, dtype)


# ---------------------------------------------------------------------------
# The gather's pools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 4, 8])
def test_gather_exact_under_random_interleavings(n):
    cases = ((70, 16, 1, 1), (70, 9, 3, 2), (33, 40, 2, 1),
             (64, 8, [1 + q % 3 for q in range(n)], 3))
    for L, piece, blocks, publish in cases:
        x = _rows((n, L), seed=n * L)
        for root in (0, n - 1):
            for seed in [None] + list(range(200)):
                out, residue = pr.simulate_gather(
                    x, root, piece_cols=piece, blocks=blocks, publish=publish,
                    rng=None if seed is None else random.Random(seed))
                assert not residue, (L, piece, blocks, root, seed, residue)
                assert torch.equal(out, x), (L, piece, blocks, root, seed)


@pytest.mark.parametrize("n", [3, 4, 8])
def test_gather_shared_flag_lets_a_wait_return_early(n):
    """Negative control: with one flag for all senders, counting pieces,
    some wait of root's is met by other senders' pieces before its own
    sender's row has wholly landed."""
    x = _rows((n, 64), seed=n)
    assert any(any(k[0] == "early" for k in pr.simulate_gather(
        x, n - 1, flags="shared", piece_cols=16, blocks=2, publish=2,
        rng=random.Random(seed))[1]) for seed in range(200)), \
        "a shared flag survived every schedule"


def test_gather_plan_fills_the_card_with_pools():
    for sms in (132, 7):
        for per_sm in (1, 2, 4):
            slots = per_sm * sms
            for n in (2, 3, 5, 8, 12):
                if n > slots:
                    continue
                for row in (0, 100, 4 << 10, 100 << 10, (1 << 30) + 3):
                    pool, extra, pieces = pr._gather_plan(
                        n, row, sms, pr.GATHER_PIECE_BYTES, per_sm)
                    assert pieces * pr.GATHER_PIECE_BYTES >= row >= \
                        (pieces - 1) * pr.GATHER_PIECE_BYTES
                    sizes = [pool + (q < extra) for q in range(n)]
                    assert 1 <= min(sizes) and max(sizes) <= pieces
                    assert max(sizes) - min(sizes) <= 1
                    assert sum(sizes) == min(slots, n * pieces) or \
                        sizes == [pieces] * n
                    if pieces * n >= slots:
                        assert sum(sizes) == slots  # every slot holds a block
    assert pr._gather_plan(8, 1 << 30, 132) == (33, 0, 16384)
    assert pr._gather_plan(3, 4 << 10, 132) == (1, 0, 1)
    assert pr._gather_plan(5, 1 << 30, 132) == (52, 4, 16384)  # 5*52+4
    with pytest.raises(KernelError):  # more ranks than resident blocks
        pr._gather_plan(300, 1 << 20, 132, per_sm=2)


def test_gather_refuses_what_it_does_not_take():
    x = torch.ones(3, 128)
    with pytest.raises(ArgumentError):
        pr.simulate_gather(x, flags="bogus")
    for kw in ({"piece_cols": 0}, {"blocks": 0}, {"blocks": [1, 2]},
               {"publish": 0}):
        with pytest.raises(ArgumentError):
            pr.simulate_gather(x, **kw)
    with pytest.raises(ArgumentError):
        pr.linear_gather(x, root=3)
    with pytest.raises(ArgumentError):
        pr._gather_launch(x, 0, piece=24)  # not a 16-byte multiple
    with pytest.raises(ArgumentError):
        pr._gather_launch(x, 0, publish=-1)
    with pytest.raises(KernelError):  # a CPU tensor: no kernel
        pr._gather_launch(x, 0)
    before = counters.launches()
    assert torch.equal(pr.linear_gather(x, 2), x)  # a CPU tensor: plain
    assert counters.launches() == before


# ---------------------------------------------------------------------------
# Recursive doubling's two forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [4, 8])
def test_rd_forms_exact_under_random_interleavings(n):
    for dtype, op in ((torch.float32, "sum"), (torch.bfloat16, "prod"),
                      (torch.int32, "max")):
        x = _rows((n, 40), seed=n, dtype=dtype)
        want, residue = pr.simulate_rd(x, lookup(op))
        assert not residue
        for form in ("l2", "cluster"):
            for seed in [None] + list(range(200)):
                out, residue = pr.simulate_rd(
                    x, lookup(op), form=form,
                    rng=None if seed is None else random.Random(seed))
                assert not residue, (form, seed, residue)
                assert torch.equal(out, want), (form, seed)


@pytest.mark.parametrize("form", ["l2", "cluster"])
@pytest.mark.parametrize("n", [4, 8])
def test_rd_shared_slot_lets_a_later_round_in(n, form):
    """Negative control: with one slot and one flag for every round, a
    fast pair's later round overwrites an earlier round's arrival or
    satisfies its wait under some schedule."""
    x = _rows((n, 16), seed=n)
    op = lookup("sum")
    want, _ = pr.simulate_rd(x, op, form=form)
    faulty = 0
    for seed in range(200):
        out, residue = pr.simulate_rd(x, op, form=form, slots="shared",
                                      rng=random.Random(seed))
        faulty += bool(residue) or not torch.equal(out, want)
    assert faulty, "one slot for all rounds survived every schedule"


def test_rd_plan_takes_clusters_within_shared_memory():
    for n in (2, 4, 8, 16, 64):
        rounds = (n - 1).bit_length()
        for elem in (2, 4):
            for cols in (1, 33, 1024, 2500, 4096, (1 << 18) + 1):
                for cluster in (None, False):
                    stripes, threads, used = pr._rd_plan(n, cols, elem, 132,
                                                         cluster)
                    assert used == (cluster is None
                                    and n <= pr.RS_CLUSTER_RANKS)
                    assert 32 <= threads <= 1024 and threads % 32 == 0
                    if used:
                        vectors = -(-cols * elem // 16)
                        sv = -(-vectors // stripes)
                        assert sv <= threads and stripes * sv >= vectors
                        assert rounds <= pr.RD_MAX_ROUNDS
                        smem = 16 + rounds * sv * 16
                        assert smem <= 16 + pr.RD_MAX_ROUNDS * \
                            pr.RD_STRIPE_BYTES <= 227 << 10
                    else:
                        assert threads == 1024
                        assert 1 <= stripes and n * stripes <= 132
    # the tier's 4 KiB per rank: one cluster of 8 blocks of 256 threads
    assert pr._rd_plan(8, 1024, 4, 132) == (1, 256, True)
    with pytest.raises(ArgumentError):  # clusters hold at most 8 ranks
        pr._rd_plan(16, 1024, 4, 132, cluster=True)


def test_rd_refuses_what_it_does_not_take():
    x = torch.ones(4, 128)
    op = lookup("sum")
    for kw in ({"form": "bogus"}, {"slots": "bogus"}):
        with pytest.raises(ArgumentError):
            pr.simulate_rd(x, op, **kw)
    with pytest.raises(ArgumentError):
        pr.simulate_rd(torch.ones(6, 8), op)
    with pytest.raises(ArgumentError):
        pr._rd_launch(torch.ones(6, 128), "sum")  # not a power of two
    with pytest.raises(ArgumentError):
        pr._rd_launch(x, "land")  # no kernel for the op
    with pytest.raises(ArgumentError):
        pr._rd_launch(x.to(torch.int16), "sum")  # nor for the dtype
    with pytest.raises(KernelError):  # a CPU tensor: no kernel
        pr._rd_launch(x, "sum")
    with pytest.raises(ArgumentError):
        pr._rd_plan(4, 128, 4, 132, stripe_bytes=8)
    before = counters.launches()
    assert torch.equal(pr.ring_allreduce_rd(x, "sum"), x * 4)
    assert torch.equal(pr.ring_allreduce_rd_plain(torch.ones(16, 8), "max"),
                       torch.ones(16, 8))  # n > 8: the L2 form's rounds
    assert counters.launches() == before
