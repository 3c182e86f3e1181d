"""The protocols of the redesigned int8-wire ring allreduce and ring hop,
on the CPU: the quantized ring's one pass a step in a wavefront over
segments of rows, each requantized value stored straight into the right
neighbour's buffer (``quant.simulate_quant_ring``, the plain version of
``quant_allreduce``; its plan ``quant._quant_plan``), and the hop's two
forms, its receive certified by a cluster barrier or by a flag per
receiver (``pallas_ring.simulate_ppermute``, the plain version of
``ppermute_shift``; its plan ``pallas_ring._hop_plan``).

- Parity: the wavefront through ``allreduce_block_quant(x, "sum")`` on a
  CPU tensor, and at several stripes and segments, is bitwise the JAX
  package's ``_quant_allreduce_kernel`` schedule run eagerly from its own
  ``_quant_rows`` and dequantize-accumulate, at n in {2, 3, 8}, float32,
  bfloat16 and a ragged size (the JAX kernel in interpret mode finishes
  only at n = 2 on this CPU, and test_torch_quant.py holds the port to it
  there). Both hop forms are bitwise the JAX package's ``ppermute_shift``
  under ``shard_map``, and the port's ``ppermute_shift`` on the CPU.
- Exactness: the wavefront is bitwise the first port's lock-step
  schedule (``form="lockstep"``) at n in {2, 3, 4, 8}, over stripes and
  segments more and fewer than the 2(n-1) steps.
- Interleavings: 200 seeded random schedules give the lock-step result
  exactly with every flag back at 0: the quantized ring at n in {3, 4, 8}
  over stripes and segments taken in turn by the seed, the hop at n in
  {2, 3, 8} in both forms. Negative controls: a quantized-ring buffer
  credited to the left before the passes that read it
  (``credit="before_read"``) loses a value under some schedule; a hop
  with no barrier and no flag lets some rank go on before its row lands.
- The plans: the quantized ring's buffers fit a block's share of shared
  memory in the cluster form (at most 8 ranks) and L2 beyond; the hop's
  cluster form takes at most 8 ranks, its flags form resident blocks.
  The simulators and plans refuse what they do not take.

The kernels themselves, on a card, are tested in test_torch_kernels.py.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from ompi_tpu.coll import pallas_ring as jpr
from ompi_tpu.coll import quant as jquant
from ompi_tpu_torch.coll import pallas_ring as pr
from ompi_tpu_torch.coll import quant
from ompi_tpu_torch.core.errors import ArgumentError

Q = 128 * 128  # elements of one kernel quantum per rank and ring block
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def make_input(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def _eager_dq(q, s, x):
    return jquant._dequant_rows(q, s) + x


def jax_schedule(data: np.ndarray, dtype: str) -> np.ndarray:
    """``allreduce_block_quant``'s wrapper (the n·128·128 padding) and
    ``_quant_allreduce_kernel``'s schedule in lock-step, run eagerly from
    the JAX package's own ``_quant_rows`` and dequantize-accumulate."""
    n, L = data.shape
    x = np.array(jnp.asarray(data).astype(DT[dtype][0]).astype(jnp.float32))
    blocks = np.pad(x, ((0, 0), (0, (-L) % (n * Q)))).reshape(n, n, -1, 128)
    out = np.empty_like(blocks)
    slots = [jquant._quant_rows(jnp.asarray(blocks[me, (me - 1) % n]))
             for me in range(n)]
    for step in range(2 * (n - 1)):
        slots = [slots[(me - 1) % n] for me in range(n)]  # one hop right
        for me in range(n):
            q, s = slots[me]
            if step < n - 1:
                blk = (me - step - 2) % n
                q, s = slots[me] = jquant._quant_rows(
                    _eager_dq(q, s, jnp.asarray(blocks[me, blk])))
                if step == n - 2:
                    out[me, blk] = np.asarray(jquant._dequant_rows(q, s))
            else:
                blk = (me - (step - (n - 1)) - 1) % n
                out[me, blk] = np.asarray(jquant._dequant_rows(q, s))
    res = out.reshape(n, -1)[:, :L]
    return f32(jnp.asarray(res).astype(DT[dtype][0]))


def wavefront(**kw):
    """``quant_allreduce``'s plain version at the given stripes and
    segments, every flag checked back at 0."""
    return lambda b: pr._checked(quant.simulate_quant_ring(b, **kw))


# (n, elements per rank and ring block, dtype, stripes, segment rows)
PARITY_CASES = [(n, elems, dtype, stripes, seg)
                for n in (2, 3, 8)
                for elems, dtype, stripes, seg in (
                    (Q, "float32", 1, None), (2 * Q, "bfloat16", 3, 40),
                    (Q - 300, "float32", 2, 7))]


@pytest.mark.parametrize("n,elems,dtype,stripes,seg", PARITY_CASES)
def test_quant_wavefront_is_bitwise_jax_schedule(n, elems, dtype, stripes,
                                                 seg):
    data = make_input((n, n * elems), seed=n * 7 + elems)
    want = jax_schedule(data, dtype)
    x = torch.from_numpy(data).to(DT[dtype][1])
    got = quant.allreduce_block_quant(x, "sum")  # the plain version
    assert got.dtype == x.dtype and got.shape == x.shape
    np.testing.assert_array_equal(bits(f32(got)), bits(want))
    got = quant.allreduce_block_quant(x, "sum", quant=wavefront(
        stripes=stripes, seg_rows=seg))
    np.testing.assert_array_equal(bits(f32(got)), bits(want))


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_quant_wavefront_is_bitwise_lockstep(n):
    """More segments than steps (one-row and 16-row segments) and fewer
    (a segment a stripe), over one to three stripes."""
    x = torch.from_numpy(make_input((n, n, 256, 128), seed=n))
    want, residue = quant.simulate_quant_ring(x, form="lockstep")
    assert not residue
    for stripes, seg in ((1, None), (1, 16), (3, 40), (2, 1), (5, 64)):
        got, residue = quant.simulate_quant_ring(x, stripes=stripes,
                                                 seg_rows=seg)
        assert not residue, (stripes, seg, residue)
        assert torch.equal(got, want), (stripes, seg)


def _shape(seed: int) -> dict:
    return {"seg_rows": (16, 24, 48)[seed % 3], "stripes": 1 + seed % 2}


@pytest.mark.parametrize("n", [3, 4, 8])
def test_quant_wavefront_exact_under_random_interleavings(n):
    x = torch.from_numpy(make_input((n, n, 128, 128), seed=n + 50))
    want = quant.quant_allreduce_plain(x)
    for seed in range(200):
        got, residue = quant.simulate_quant_ring(
            x, rng=random.Random(seed), **_shape(seed))
        assert not residue, (seed, residue)
        assert torch.equal(got, want), seed


@pytest.mark.parametrize("n", [3, 4, 8])
def test_quant_credit_before_read_loses_a_value(n):
    """Crediting a buffer to the left before the passes that read it lets
    the left overwrite an arrival not yet read."""
    x = torch.from_numpy(make_input((n, n, 128, 128), seed=n + 60))
    want = quant.quant_allreduce_plain(x)
    lost = sum(not torch.equal(quant.simulate_quant_ring(
        x, credit="before_read", rng=random.Random(seed), seg_rows=32)[0],
        want) for seed in range(40))
    assert lost > 0, n


def test_quant_plan_keeps_buffers_in_shared_memory_or_l2():
    sm = 132
    for n in range(2, 65):
        for rows in (128, 1024, 262144):
            stripes, threads, seg, cluster = quant._quant_plan(n, rows, sm)
            assert cluster == (n <= pr.RS_CLUSTER_RANKS)
            per_sm = (quant.QUANT_CLUSTER_BLOCKS_PER_SM if cluster
                      else quant.QUANT_BLOCKS_PER_SM)
            assert 1 <= stripes and n * stripes <= per_sm * sm
            assert 1 <= seg <= -(-rows // stripes)
            bufs = pr.RS_BUFS * (2 * n - 3) * quant._buf_bytes(seg)
            if cluster:
                assert 16 + bufs <= pr.CHUNKED_SMEM_BYTES // per_sm
            else:
                assert n * stripes * bufs <= pr.RS_SLOT_BYTES
    # the sweep's shapes fit as well, and a segment never outgrows them
    for per_sm, seg in ((1, 64), (2, 32), (4, 16), (8, 8)):
        _, _, got, _ = quant._quant_plan(8, 262144, sm, True, seg, 128,
                                         per_sm)
        assert got <= seg
        assert 16 + pr.RS_BUFS * 13 * quant._buf_bytes(got) \
            <= pr.CHUNKED_SMEM_BYTES // per_sm
    with pytest.raises(ArgumentError, match="cluster"):
        quant._quant_plan(12, 128, sm, True)


def test_quant_simulator_refuses_what_it_does_not_take():
    x = torch.zeros(3, 3, 128, 128)
    with pytest.raises(ArgumentError, match="credit"):
        quant.simulate_quant_ring(x, credit="eager")
    with pytest.raises(ArgumentError, match="form"):
        quant.simulate_quant_ring(x, form="tree")
    with pytest.raises(ArgumentError, match="before_read"):
        quant.simulate_quant_ring(x, form="lockstep", credit="before_read")
    with pytest.raises(ArgumentError, match="segment"):
        quant.simulate_quant_ring(x, seg_rows=0)
    with pytest.raises(ArgumentError, match="stripe"):
        quant.simulate_quant_ring(x, stripes=0)
    lock, residue = quant.simulate_quant_ring(x, credit="reference")
    assert not residue and torch.equal(lock, x)


# ---------------------------------------------------------------------------
# The ring hop
# ---------------------------------------------------------------------------

def jax_hop(data: np.ndarray, shift: int) -> np.ndarray:
    n = data.shape[0]
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    return np.asarray(jax.jit(jax.shard_map(
        lambda b: jpr.ppermute_shift(b[0], "x", shift)[None], mesh=mesh,
        in_specs=(P("x"),), out_specs=P("x"), check_vma=False))(data))


@pytest.mark.parametrize("form", ["flags", "cluster"])
@pytest.mark.parametrize("n,shift", [(2, 1), (3, -1), (8, 1), (8, 3)])
def test_hop_forms_are_bitwise_jax_package(n, shift, form):
    data = make_input((n, 13, 5), seed=n + shift)
    want = jax_hop(data, shift)
    x = torch.from_numpy(data)
    got, residue = pr.simulate_ppermute(x.reshape(n, -1), shift % n,
                                        form=form)
    assert not residue
    np.testing.assert_array_equal(got.reshape(x.shape).numpy(), want)
    np.testing.assert_array_equal(pr.ppermute_shift(x, shift).numpy(), want)


@pytest.mark.parametrize("form", ["flags", "cluster"])
@pytest.mark.parametrize("n", [2, 3, 8])
def test_hop_forms_exact_under_random_interleavings(n, form):
    x = torch.arange(n * 6, dtype=torch.float32).reshape(n, 6)
    for seed in range(200):
        shift = 1 + seed % (n - 1) if n > 2 else 1
        out, residue = pr.simulate_ppermute(x, shift, form=form,
                                            rng=random.Random(seed))
        assert not residue, (seed, residue)
        assert torch.equal(out, torch.roll(x, shift, 0)), seed


@pytest.mark.parametrize("n", [2, 3, 8])
def test_hop_without_barrier_or_flag_reads_early(n):
    x = torch.arange(n * 6, dtype=torch.float32).reshape(n, 6)
    early = sum(any(k[0] == "early" for k in pr.simulate_ppermute(
        x, 1, form="unsynced", rng=random.Random(seed))[1])
        for seed in range(40))
    assert early > 0, n


def test_hop_plan_and_refusals():
    sm = 132
    for n in range(2, 33):
        for row in (16, 4096, 8 << 20):
            for bulk in (True, False):
                stripes, threads, cluster, piece = pr._hop_plan(n, row, sm,
                                                                bulk=bulk)
                assert cluster == (n <= pr.RS_CLUSTER_RANKS)
                assert stripes >= 1 and 32 <= threads <= 1024
                if cluster:
                    assert n * stripes <= pr.HOP_STRIPES_PER_SM * sm
                    assert (piece, threads) == ((pr.HOP_PIECE_BYTES, 32)
                                                if bulk else (0, 512))
                    assert piece % 16 == 0
                else:
                    assert n * stripes <= sm and threads == 1024
                    assert piece == 0  # bulk copies need a cluster launch
    assert pr._hop_plan(8, 8 << 20, sm)[0] > 1  # the KV block spreads
    assert pr._hop_plan(8, 4096, sm)[0] == 1
    with pytest.raises(ArgumentError, match="cluster"):
        pr._hop_plan(12, 4096, sm, True)
    with pytest.raises(ArgumentError, match="form"):
        pr.simulate_ppermute(torch.zeros(3, 4), 1, form="tree")
