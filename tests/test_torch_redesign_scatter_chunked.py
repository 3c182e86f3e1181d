"""The protocols of the redesigned linear scatter and chunked ring
allreduce, on the CPU: the chunked ring's one-pass wavefront
(``pallas_ring.simulate_ring_chunked``, the plain version of
``ring_allreduce_chunked``; its plan ``_chunked_plan``) and the
scatter's pieces streamed by root's blocks onto counted flags
(``pallas_ring.simulate_scatter``, the plain version of
``linear_scatter``; its plan ``_scatter_plan``).

- Parity: the chunked wavefront, bitwise the JAX package's
  ``allreduce_block_chunked`` through its PallasColl (its
  ``ring_allreduce_chunked`` Pallas kernel in TPU-interpret mode on the
  CPU mesh, with the segment and threshold vars lowered so that small
  sizes take it) at n in {2, 3, 8} for float32 SUM, bfloat16 MIN and
  int32 PROD at ragged sizes the layout pads, over several stripes and
  pipeline segments, and the port's PallasColl on ``device="cpu"``
  likewise. The scatter, bitwise the JAX package's PallasColl scatter at
  n in {2, 3, 8}, roots 0, 1 and n - 1, the three dtypes taken in turn,
  over several pieces and senders. Exact: the ring folds every element
  at the same ranks in the same order (bfloat16 in float32, rounded once
  per step), and the scatter copies bits.
- Interleavings: 200 seeded random schedules at n in {3, 4, 8} give the
  lock-step result exactly with every flag back at 0: the chunked ring
  over fewer segments than its 2(n-1) steps, more, and two stripes; the
  scatter over ragged pieces and one to three senders. Negative
  controls: a chunked buffer credited to the left before the passes
  that read it is overwritten under some schedule; with one flag for
  all receivers some scatter wait returns before its row has landed.
- Exactness: the chunked wavefront is bitwise ``simulate_ring(
  segmented=True)``, the schedule it replaced, for every op and three
  dtypes at n in {2, 3, 4, 8}.
- The plans: the chunked ring's buffers within ``CHUNKED_SMEM_BYTES`` of
  an SM's shared memory in clusters, within ``RS_SLOT_BYTES`` of L2
  beyond; the scatter's senders fill the resident slots the receivers
  leave, no more than its pieces.

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
# Lowered in both packages so that small sizes take the chunked tier
# over several 4 KiB layout segments.
CHUNKED_VARS = {"coll_pallas_chunk_threshold_bytes": 1024,
                "coll_pallas_segment_bytes": 4096,
                "coll_pallas_priority": 100}


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
    old = {k: (jconfig.get(k), tconfig.get(k)) for k in CHUNKED_VARS}
    for k, v in CHUNKED_VARS.items():
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

# (n, op, dtype, elements per rank): ragged sizes the layout pads; at
# n = 2 and 3 over several 4 KiB segments, at n = 8 over one (the JAX
# package's interpret-mode kernel takes seconds per segment there).
CHUNKED_PARITY = [(2, "sum", torch.float32, 2 * 128 * 20 + 77),
                  (3, "min", torch.bfloat16, 3 * 128 * 20 + 77),
                  (8, "prod", torch.int32, 2100)]


@pytest.mark.parametrize("n,op,dtype,elems", CHUNKED_PARITY,
                         ids=[f"n{c[0]}-{c[1]}" for c in CHUNKED_PARITY])
def test_chunked_wavefront_is_bitwise_jax_package(worlds, n, op, dtype,
                                                  elems):
    """The JAX package's PallasColl allreduce on its chunked tier against
    the wavefront on the same layout (one stripe and three, one pipeline
    segment and several, the last ragged), alone and through the port's
    PallasColl on the CPU."""
    x = _rows((n, elems), seed=n * 7 + elems, dtype=dtype)
    jcomm = _sub(worlds[0], n)
    want = _from_jax(jcomm.allreduce(jcomm.put_rank_major(_jax(x)), op))
    assert any("allreduce_block_chunked" in k for k in jcomm._plan_cache)
    rows, _ = pr._chunked_layout(elems, n, dtype, 4096)
    assert n * rows * pr.LANES > elems  # the layout pads

    def wavefront(seg, stripes):
        def chunked(blocks, op_, seg_cols):
            got, residue = pr.simulate_ring_chunked(
                blocks, lookup(op_), seg_cols=seg, stripes=stripes)
            assert not residue
            return got
        return chunked

    for seg, stripes in ((None, 1), (40, 1), (64, 3)):
        got = pr.allreduce_block_chunked(x, op, 4096,
                                         chunked=wavefront(seg, stripes))
        assert got.dtype == dtype
        assert torch.equal(got.float(), want), (seg, stripes)
    tcomm = _sub(worlds[1], n)
    before = counters.launches()
    got = tcomm.allreduce(tcomm.put_rank_major(x), op)
    assert counters.launches() == before  # the plain version, no card
    assert any("allreduce_block_chunked" in k for k in tcomm._plan_cache)
    assert torch.equal(got.float(), want)


@pytest.mark.parametrize("n", [2, 3, 8])
def test_scatter_is_bitwise_jax_package(worlds, n):
    """The JAX package's PallasColl scatter (its _scatter_kernel in
    TPU-interpret mode) of root's buffer at roots 0, 1 and n - 1, the
    dtypes taken in turn, against the pieces' protocol and the port's
    PallasColl on the CPU."""
    dtypes = (torch.bfloat16, torch.float32, torch.int32)
    jcomm, tcomm = _sub(worlds[0], n), _sub(worlds[1], n)
    for i, root in enumerate(sorted({0, 1, n - 1})):
        dtype = dtypes[(i + n) % 3]
        buf = _rows((n, 300), seed=n * 11 + root, dtype=dtype)
        want = _from_jax(jcomm.scatter(_jax(buf), root))
        assert tuple(want.shape) == (n, 300)
        for piece, senders in ((None, 1), (64, 1), (37, 3)):
            got, residue = pr.simulate_scatter(buf, root, piece_cols=piece,
                                               senders=senders)
            assert not residue and got.dtype == dtype
            assert torch.equal(got.float(), want), (root, piece, senders)
        before = counters.launches()
        got = tcomm.scatter(buf, root)
        assert counters.launches() == before
        assert torch.equal(got.float(), want), root


# ---------------------------------------------------------------------------
# The chunked wavefront's protocol
# ---------------------------------------------------------------------------

def _chunked_cases(n: int):
    """(blocks, segment columns, stripes): fewer segments than the
    2(n-1) steps, more (the last ragged), and two stripes of three."""
    for n_segs, stripes in ((max(1, n - 2), 1), (2 * n + 1, 1), (3, 2)):
        seg = 8
        yield (_rows((n, n, stripes * n_segs * seg - 3),
                     seed=n * 100 + n_segs), seg, stripes)


@pytest.mark.parametrize("n", [3, 4, 8])
def test_chunked_exact_under_random_interleavings(n):
    op = lookup("sum")
    for x, seg, stripes in _chunked_cases(n):
        want, residue = pr.simulate_ring_chunked(x, op, seg_cols=seg,
                                                 stripes=stripes)
        assert not residue
        assert torch.equal(want, pr.simulate_ring(x, op)[0])
        for seed in range(200):
            out, residue = pr.simulate_ring_chunked(
                x, op, seg_cols=seg, stripes=stripes, rng=random.Random(seed))
            assert not residue, (x.shape, stripes, seed, residue)
            assert torch.equal(out, want), (x.shape, stripes, seed)


@pytest.mark.parametrize("n", [3, 4, 8])
def test_chunked_credit_before_read_loses_values(n):
    """Negative control: buffers credited to the left neighbour before
    the passes that read them are overwritten under some schedule (with
    enough segments that every buffer is written again)."""
    x = _rows((n, n, 8 * (2 * n + 2 * pr.RS_BUFS) - 3), seed=n)
    op = lookup("sum")
    want, _ = pr.simulate_ring_chunked(x, op, seg_cols=8)
    assert any(not torch.equal(pr.simulate_ring_chunked(
        x, op, seg_cols=8, credit="before_read",
        rng=random.Random(seed))[0], want) for seed in range(200)), \
        "crediting before the read survived every schedule"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_chunked_is_bitwise_the_segmented_two_pass_ring(n, dtype):
    x = _rows((n, n, 96), seed=n, dtype=dtype)
    for name in ("sum", "max", "min", "prod"):
        op = lookup(name)
        want, residue = pr.simulate_ring(x, op, 32, segmented=True)
        assert not residue
        for seg, stripes in ((None, 1), (7, 1), (16, 3)):
            got, residue = pr.simulate_ring_chunked(x, op, seg_cols=seg,
                                                    stripes=stripes)
            assert not residue and got.dtype == dtype
            assert torch.equal(got, want), (name, seg, stripes)
        assert torch.equal(pr.ring_allreduce_chunked_plain(x, name, 32), want)


def test_chunked_plan_keeps_the_buffers_in_shared_memory_or_l2():
    for n in (2, 3, 8, 12):
        for block_bytes in (512, 16 << 10, 128 << 20):  # 4 KiB..1 GiB
            for cluster in (None, False):
                stripes, threads, seg, used = pr._chunked_plan(
                    n, block_bytes, 132, cluster)
                assert used == (n <= pr.RS_CLUSTER_RANKS and cluster is None)
                per_sm = (pr.CHUNKED_CLUSTER_BLOCKS_PER_SM if used
                          else pr.CHUNKED_BLOCKS_PER_SM)
                assert 1 <= stripes <= per_sm * 132 // n
                assert 32 <= threads <= 512 and seg % 16 == 0 and seg > 0
                per_block = pr.RS_BUFS * (2 * n - 3) * seg
                if used:
                    assert per_sm * per_block <= pr.CHUNKED_SMEM_BYTES
                else:
                    assert n * stripes * per_block <= pr.RS_SLOT_BYTES
                assert seg <= max(-(-block_bytes // 16 // stripes) * 16, 16)
    with pytest.raises(ArgumentError):  # clusters hold at most 8 ranks
        pr._chunked_plan(12, 128 << 10, 132, cluster=True)


def test_chunked_refuses_what_it_does_not_take():
    blocks = torch.ones(3, 3, 128)
    op = lookup("sum")
    for kw in ({"credit": "bogus"}, {"seg_cols": 0}, {"stripes": 0}):
        with pytest.raises(ArgumentError):
            pr.simulate_ring_chunked(blocks, op, **kw)
    with pytest.raises(ArgumentError):
        pr.simulate_ring_chunked(torch.ones(3, 128), op)
    with pytest.raises(ArgumentError):
        pr.ring_allreduce_chunked(blocks, "sum", 100)  # not whole segments
    with pytest.raises(ArgumentError):
        pr.ring_allreduce_chunked_plain(blocks, "sum", 0)


# ---------------------------------------------------------------------------
# The scatter's pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 4, 8])
def test_scatter_exact_under_random_interleavings(n):
    for L, piece, senders in ((70, 16, 1), (70, 9, 3), (33, 40, 2)):
        buf = _rows((n, L), seed=n * L)
        for root in (0, n - 1):
            for seed in [None] + list(range(200)):
                out, residue = pr.simulate_scatter(
                    buf, root, piece_cols=piece, senders=senders,
                    rng=None if seed is None else random.Random(seed))
                assert not residue, (L, piece, senders, root, seed, residue)
                assert torch.equal(out, buf), (L, piece, senders, root, seed)


@pytest.mark.parametrize("n", [3, 4, 8])
def test_scatter_shared_flag_lets_a_wait_return_early(n):
    """Negative control: with one flag for every receiver, counting
    pieces, some receiver's wait is met by other rows' pieces before its
    own row has wholly landed."""
    buf = _rows((n, 64), seed=n)
    assert any(any(k[0] == "early" for k in pr.simulate_scatter(
        buf, n - 1, flags="shared", piece_cols=16,
        rng=random.Random(seed))[1]) for seed in range(200)), \
        "a shared flag survived every schedule"


def test_scatter_plan_fills_the_card_with_root():
    for n in (2, 3, 8, 12):
        for row in (0, 100, 4 << 10, 1 << 30):
            senders, pieces = pr._scatter_plan(n, row, 132)
            slots = pr.SCATTER_BLOCKS_PER_SM * 132
            assert pieces * pr.SCATTER_PIECE_BYTES >= row and pieces >= 1
            assert 1 <= senders <= min(slots - (n - 1), n * pieces)
            assert senders == min(slots - (n - 1), n * pieces)
    assert pr._scatter_plan(8, 1 << 30, 132, 1 << 20, 1) == (125, 1024)
    with pytest.raises(KernelError):  # the receivers alone fill the card
        pr._scatter_plan(300, 1 << 20, 132, per_sm=2)


def test_scatter_refuses_what_it_does_not_take():
    buf = torch.ones(3, 128)
    with pytest.raises(ArgumentError):
        pr.simulate_scatter(buf, flags="bogus")
    with pytest.raises(ArgumentError):
        pr.simulate_scatter(buf, piece_cols=0)
    with pytest.raises(ArgumentError):
        pr.simulate_scatter(buf, senders=0)
    with pytest.raises(ArgumentError):
        pr.linear_scatter(buf, root=3)
    before = counters.launches()
    assert torch.equal(pr.linear_scatter(buf, 2), buf)  # a CPU tensor: plain
    assert counters.launches() == before
