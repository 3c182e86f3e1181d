"""The protocols of the redesigned ring allgather and one-rank chunked
identity, on the CPU: the allgather's one-pass wavefront
(``pallas_ring.simulate_ring_ag_fused``, the plain version of
``ring_allgather``; its plan ``_ag_plan``) and ``selfdma_chunked``'s
plain version.

- Parity: the wavefront, bitwise the JAX package's allgather through its
  PallasColl (its ``ring_allgather`` Pallas kernel in TPU-interpret mode
  on the CPU mesh) at n in {2, 3, 8} for float32, bfloat16 and int32,
  and the port's PallasColl on ``device="cpu"`` likewise. An allgather
  copies bits, so the tolerance is bitwise.
- Interleavings: 200 seeded random schedules at n in {3, 4, 8} give the
  lock-step result exactly, with every flag back at 0: fewer segments than
  the n - 1 steps, as many, and more (the last ragged), on one and on two
  stripes. Negative control: a buffer credited to the left before the
  passes that read it is overwritten under some schedule.
- Exactness: the wavefront is bitwise ``simulate_ring(phase="ag")``, the
  schedule it replaced, for five dtypes at n in {2, 3, 4, 8} and several
  segment sizes; every row is every rank's block.
- The plan: a cluster up to ``RS_CLUSTER_RANKS`` ranks, a block's
  buffers within ``RS_SMEM_BYTES`` of its shared memory there, every
  block's within ``RS_SLOT_BYTES`` of L2 otherwise.
- ``selfdma_chunked``'s plain version (two slots per segment) is the
  identity at aligned and ragged sizes in six dtypes, and the one-rank
  chunked allreduce through it too.

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
from ompi_tpu_torch.core.errors import ArgumentError

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.int32: jnp.int32}


def _rows(shape, seed: int, dtype=torch.float32) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if not dtype.is_floating_point:
        return torch.from_numpy(rng.integers(-100, 100, shape).astype(
            np.int32)).to(dtype)
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype)


def _gathered(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[0]
    return x.unsqueeze(0).expand((n,) + tuple(x.shape))


# ---------------------------------------------------------------------------
# Against the JAX package's kernel (interpret mode) and PallasColl
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds():
    jworld = ompi_tpu.init()
    tworld = ompi_tpu_torch.init(device="cpu")
    try:
        yield jworld, tworld
    finally:
        ompi_tpu_torch.finalize()


def _pallas_comm(world, config, n):
    """A size-n communicator of ``world`` whose allgather goes through
    PallasColl (priority 100 while it is made)."""
    old = config.get("coll_pallas_priority")
    config.VARS.set("coll_pallas_priority", 100)
    try:
        comm = world.split([0 if r < n else -1 for r in range(world.size)])[0] \
            if n < world.size else world.dup()
    finally:
        config.VARS.set("coll_pallas_priority", old)
    assert comm._coll["allgather"][0].NAME == "pallas"
    return comm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("n", [2, 3, 8])
def test_wavefront_is_bitwise_jax_package_allgather(worlds, n, dtype):
    """The JAX package's PallasColl allgather (its ring_allgather kernel
    in TPU-interpret mode) against the wavefront, alone and through the
    port's PallasColl on the CPU."""
    x = _rows((n, 300), seed=n * 13 + len(str(dtype)), dtype=dtype)
    jcomm = _pallas_comm(worlds[0], jconfig, n)
    xj = jnp.asarray(x.float().numpy()).astype(JDT[dtype])
    want = torch.from_numpy(np.asarray(jcomm.allgather(
        jcomm.put_rank_major(xj))).astype(np.float32))
    assert tuple(want.shape) == (n, n, 300)
    for seg in (None, 64):  # one segment, and five (the last ragged)
        got, residue = pr.simulate_ring_ag_fused(x, seg_cols=seg)
        assert not residue and got.dtype == dtype
        assert torch.equal(got.float(), want), seg
    tcomm = _pallas_comm(worlds[1], tconfig, n)
    before = counters.launches()
    got = tcomm.allgather(tcomm.put_rank_major(x))
    assert counters.launches() == before  # the plain version, no card
    assert torch.equal(got.float(), want)


# ---------------------------------------------------------------------------
# The wavefront's protocol
# ---------------------------------------------------------------------------

def _ag_cases(n: int):
    """(own blocks, segment columns, stripes): fewer segments than the
    n - 1 steps, as many, and more, the last ragged; then two stripes of
    two segments."""
    for n_segs, stripes in ((max(1, n - 3), 1), (n - 1, 1), (n + 1, 1),
                            (2, 2)):
        seg = 16
        yield (_rows((n, stripes * n_segs * seg - 5), seed=n * 100 + n_segs),
               seg, stripes)


@pytest.mark.parametrize("n", [3, 4, 8])
def test_wavefront_exact_under_random_interleavings(n):
    for x, seg, stripes in _ag_cases(n):
        want, residue = pr.simulate_ring_ag_fused(x, seg_cols=seg,
                                                  stripes=stripes)
        assert not residue and torch.equal(want, _gathered(x))
        for seed in range(200):
            out, residue = pr.simulate_ring_ag_fused(
                x, seg_cols=seg, stripes=stripes, rng=random.Random(seed))
            assert not residue, (x.shape, stripes, seed, residue)
            assert torch.equal(out, want), (x.shape, stripes, seed)


@pytest.mark.parametrize("n", [3, 4, 8])
def test_wavefront_credit_before_read_loses_blocks(n):
    """Negative control: buffers credited to the left neighbour before
    the passes that read them are overwritten under some schedule (with
    enough segments that every buffer is written again)."""
    x = _rows((n, 16 * (n + 2 * pr.RS_BUFS) - 5), seed=n)
    want = _gathered(x)
    bad = [seed for seed in range(200)
           if not torch.equal(pr.simulate_ring_ag_fused(
               x, seg_cols=16, credit="before_read",
               rng=random.Random(seed))[0], want)]
    assert bad, "crediting before the read survived every schedule"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.float64, torch.int8])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_wavefront_is_bitwise_the_two_pass_ring(n, dtype):
    x = _rows((n, 70), seed=n, dtype=dtype)
    want, residue = pr.simulate_ring(x, None, phase="ag")
    assert not residue and torch.equal(want, _gathered(x))
    for seg, stripes in ((None, 1), (8, 1), (32, 1), (8, 3)):
        got, residue = pr.simulate_ring_ag_fused(x, seg_cols=seg,
                                                 stripes=stripes)
        assert not residue and got.dtype == dtype
        assert torch.equal(got, want), (seg, stripes)
    assert torch.equal(pr.ring_allgather_plain(x), want)


def test_ag_plan_keeps_the_buffers_in_shared_memory_or_l2():
    for n in (2, 3, 8, 12):
        for block_bytes in (512, 16 << 10, 128 << 20):  # 4 KiB..1 GiB
            for cluster in (None, False):
                stripes, threads, seg, used = pr._ag_plan(n, block_bytes, 132,
                                                          cluster)
                assert used == (n <= pr.RS_CLUSTER_RANKS and cluster is None)
                per_sm = (pr.AG_CLUSTER_BLOCKS_PER_SM if used
                          else pr.AG_BLOCKS_PER_SM)
                assert 1 <= stripes <= per_sm * 132 // n
                assert 32 <= threads <= 512 and seg % 16 == 0 and seg > 0
                per_block = pr.RS_BUFS * max(n - 2, 0) * seg
                if used:
                    assert per_block <= pr.RS_SMEM_BYTES
                else:
                    assert n * stripes * per_block <= pr.RS_SLOT_BYTES
                assert seg <= max(-(-block_bytes // 16 // stripes) * 16, 16)
    with pytest.raises(ArgumentError):  # clusters hold at most 8 ranks
        pr._ag_plan(12, 128 << 10, 132, cluster=True)


def test_wavefront_refuses_what_it_does_not_take():
    with pytest.raises(ArgumentError):
        pr.simulate_ring_ag_fused(torch.ones(3, 128), credit="bogus")
    with pytest.raises(ArgumentError):
        pr.simulate_ring_ag_fused(torch.ones(3, 128), seg_cols=0)
    with pytest.raises(ArgumentError):
        pr.simulate_ring_ag_fused(torch.ones(3, 128), stripes=0)
    with pytest.raises(ArgumentError):
        pr.simulate_ring_ag_fused(torch.ones(3, 3, 128))
    with pytest.raises(ArgumentError):
        pr.ring_allgather(torch.ones(3, 3, 128))


# ---------------------------------------------------------------------------
# The one-rank chunked identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.float64,
                                   torch.float16, torch.int8])
def test_selfdma_plain_is_the_identity(dtype):
    before = counters.launches()
    for segs, seg_cols in ((1, 4096), (3, 1000), (8, 333)):
        x = _rows((1, segs * seg_cols), seed=segs, dtype=dtype)
        got = pr.selfdma_chunked(x, seg_cols)  # a CPU tensor: plain
        assert got.data_ptr() != x.data_ptr() and torch.equal(got, x)
        assert torch.equal(pr.selfdma_chunked_plain(x, seg_cols), x)
    # ragged: allreduce_block_chunked pads to whole segments
    y = _rows((1, 5000), seed=9, dtype=dtype)
    got = pr.allreduce_block_chunked(y, "sum", 4096)
    assert torch.equal(got, y) and got.data_ptr() != y.data_ptr()
    assert counters.launches() == before
    with pytest.raises(ArgumentError):
        pr.selfdma_chunked(x, 7)  # a segment that does not divide W
    with pytest.raises(ArgumentError):
        pr.selfdma_chunked(torch.ones(2, 128), 64)
