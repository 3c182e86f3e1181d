"""The protocols of the redesigned bidirectional ring and table kernel,
on the CPU: the bidirectional ring as two fold-then-forward rings
(``pallas_ring.simulate_ring_bidir``, each direction
``simulate_ring_fused``'s schedule) and the table kernel's wavefront
(``pallas_lower.simulate_table_fused``, its stages ``_stages``, the
links between stages ``_links`` and its plan ``_table_plan``).

- Interleavings: 200 seeded random schedules give the lock-step result
  exactly, with every flag back at 0: the bidirectional ring at n in
  {2, 3, 8}; the table kernel on ``chip_smoke.table_programs``' eight
  programs at n in {2, 3, 4, 8}, each schedule over chunks of fewer
  segments than a stage's rounds, as many, or more (by the seed, in
  turn), the last segment ragged. Negative controls must fail under
  some schedule: the two directions sharing one set of flags, a slot
  credited before the pass that reads it (both simulators), and one
  table credit flag per (round of the stage, parity) for every receiver
  (the window program at n = 8, whose stages take other ring orders).
- Exactness: each simulator is bitwise the schedule it replaces, for
  sum, max, min and prod in float32, bfloat16 and int32: the
  bidirectional ring the two-pass rings (``credit="reference"``, exact
  in lock-step) at n in {2, 3, 8}; the table kernel ``simulate`` (the
  JAX package's oracle, ported) and ``simulate_table`` (the two-slot
  schedule) at n in {2, 3, 4, 8} over eight segments, the last ragged
  (one segment in test_torch_sched.py's plain-version test; 2 to 15 in
  the interleavings' lock-step runs).
- Parity: against the JAX package's kernels under ``shard_map``, in
  TPU-interpret mode on the CPU mesh, bitwise: the bidirectional ring
  at n = 3 (int32 MAX) and n = 8 (bfloat16 SUM); the registered table
  wrappers (``sched_pallas_ring_seg`` int32 PROD, ``sched_pallas_rs``
  int32 MIN, n = 3, as ``test_torch_sched.py``'s kernel route runs
  them) with the wavefront over several segments. Both fold the arrival
  on the left, in the reference's order.

The kernels themselves, on a card, are tested in test_torch_kernels.py.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from chip_smoke import table_programs
from ompi_tpu.coll import pallas_ring as jpr
from ompi_tpu.coll import sched as jsched
from ompi_tpu.coll.sched import pallas_lower as jpl
from ompi_tpu_torch.coll import pallas_ring as pr
from ompi_tpu_torch.coll import sched as tsched
from ompi_tpu_torch.coll.sched import ir
from ompi_tpu_torch.coll.sched import pallas_lower as pl
from ompi_tpu_torch.core.errors import ArgumentError
from ompi_tpu_torch.ops import lookup

OPS = ("sum", "prod", "max", "min")
DTYPES = (torch.float32, torch.bfloat16, torch.int32)
SEEDS = 200
SEG = 2  # wavefront segment columns in the interleavings


def _rows(shape, seed: int, dtype=torch.float32) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        return torch.from_numpy(rng.integers(-1000, 1000, shape).astype(
            np.int32))
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _faulty(simulate, rng, want) -> bool:
    """Did a run end with a wrong result, a flag not back at 0, a
    deadlock or mismatched segments?"""
    try:
        out, residue = simulate(rng=rng)
    except RuntimeError:
        return True
    return bool(residue) or not torch.equal(out, want)


# ---------------------------------------------------------------------------
# The bidirectional ring
# ---------------------------------------------------------------------------

def _bidir(n: int, cols: int = 64):
    blocks = _rows((n, n, cols), seed=n)
    return lambda **kw: pr.simulate_ring_bidir(blocks, lookup("sum"), **kw)


@pytest.mark.parametrize("n", [2, 3, 8])
def test_bidir_exact_under_random_interleavings(n):
    simulate = _bidir(n)
    want, residue = simulate()
    assert not residue
    for seed in range(SEEDS):
        out, residue = simulate(rng=random.Random(seed))
        assert not residue, (seed, residue)
        assert torch.equal(out, want), seed


@pytest.mark.parametrize("n", [2, 3, 8])
def test_bidir_negative_controls_fail(n):
    """One set of flags for both directions (at n = 2 both signal the
    same neighbour, but the mix-up shows at every n) and a slot credited
    before the pass that reads it go wrong under some schedule; at n = 2
    the fused ring has no credit (two steps), so the second control
    starts at n = 3."""
    simulate = _bidir(n)
    want, _ = simulate()
    assert any(_faulty(lambda **kw: simulate(shared_flags=True, **kw),
                       random.Random(seed), want) for seed in range(SEEDS))
    if n > 2:
        assert any(_faulty(lambda **kw: simulate(credit="before_read", **kw),
                           random.Random(seed), want)
                   for seed in range(SEEDS))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [2, 3, 8])
def test_bidir_is_bitwise_the_two_pass_rings(n, dtype):
    blocks = _rows((n, n, 70), seed=n + 1, dtype=dtype)
    for op in OPS:
        want, _ = pr.simulate_ring_bidir(blocks, lookup(op),
                                         credit="reference")
        got, residue = pr.simulate_ring_bidir(blocks, lookup(op))
        assert not residue and got.dtype == dtype
        assert torch.equal(_bits(got), _bits(want)), op
        # each direction is simulate_ring_fused's ring on its half
        for d, cols in ((1, slice(0, 35)), (-1, slice(35, 70))):
            half, residue = pr.simulate_ring_fused(
                blocks[..., cols].contiguous(), lookup(op), direction=d)
            assert not residue
            assert torch.equal(_bits(half), _bits(got[..., cols])), (op, d)


# ---------------------------------------------------------------------------
# The table kernel's wavefront
# ---------------------------------------------------------------------------

PROGRAM_NAMES = ("ring", "ring+order", "seg2", "seg4", "rs", "ag", "fuse3",
                 "window")


def _program(name: str, n: int):
    return pl.analyze(table_programs(ir, pl, n)[name])


def _segment_counts(prog) -> tuple:
    """Fewer segments than a stage's rounds, as many, and more."""
    rounds = max(length for _, length in pl._stages(prog))
    return (max(1, min(2, rounds - 1)), rounds, rounds + 1)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("name", PROGRAM_NAMES)
def test_table_exact_under_random_interleavings(name, n):
    prog = _program(name, n)
    cases = []
    for segs in _segment_counts(prog):
        # the last segment ragged (one column of SEG)
        x = _rows((n, prog.nchunks, SEG * segs - 1), seed=n + segs)
        want, residue = pl.simulate_table_fused(prog, x, "sum",
                                                seg_cols=SEG)
        assert not residue
        assert torch.equal(want, pl.simulate(prog, x, "sum"))
        cases.append((x, want))
    for seed in range(SEEDS):
        x, want = cases[seed % 3]
        out, residue = pl.simulate_table_fused(
            prog, x, "sum", seg_cols=SEG, rng=random.Random(seed))
        assert not residue, (seed, residue)
        assert torch.equal(out, want), seed


@pytest.mark.parametrize("n", [3, 4, 8])
def test_table_credit_before_read_loses_values(n):
    """Negative control: buffers credited to the next writer before the
    passes that read them are overwritten under some schedule (with
    enough segments that every buffer is written again)."""
    for name in ("ring", "window"):
        prog = _program(name, n)
        x = _rows((n, prog.nchunks, SEG * 6 - 1), seed=n)
        want = pl.simulate(prog, x, "sum")
        assert any(_faulty(lambda **kw: pl.simulate_table_fused(
            prog, x, "sum", seg_cols=SEG, credit="before_read", **kw),
            random.Random(seed), want) for seed in range(SEEDS)), name


def test_table_credits_need_a_flag_per_receiver():
    """The window's stages take other ring orders, so a buffer's next
    writer changes from stage to stage: with one credit flag per (round
    of the stage, parity) a later stage's receiver satisfies a wait for
    another under some schedule (with one per (receiver, round of the
    stage, parity) every schedule is exact: the interleavings above)."""
    prog = _program("window", 8)
    x = _rows((8, prog.nchunks, SEG * 6 - 1), seed=8)
    want = pl.simulate(prog, x, "sum")
    assert any(_faulty(lambda **kw: pl.simulate_table_fused(
        prog, x, "sum", seg_cols=SEG, flags="slot", **kw),
        random.Random(seed), want) for seed in range(SEEDS))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_table_is_bitwise_simulate_and_the_two_slot_schedule(n, dtype):
    for i, name in enumerate(PROGRAM_NAMES):
        prog = _program(name, n)
        x = _rows((n, prog.nchunks, 37), seed=10 * n + i, dtype=dtype)
        for op in OPS if name != "ag" else ("sum",):
            want = pl.simulate(prog, x, op)
            two_slot, residue = pl.simulate_table(prog, x, op)
            assert not residue and torch.equal(_bits(two_slot), _bits(want))
            # 8 segments, the last ragged
            got, residue = pl.simulate_table_fused(prog, x, op, seg_cols=5)
            assert not residue and got.dtype == dtype
            assert torch.equal(_bits(got), _bits(want)), (name, op)


def test_stages_and_links_are_the_program_structure():
    """A stage starts at every brk round; ``prv`` and ``nxt`` name, per
    round at place j of its stage, whether an earlier stage has a round
    at place j and the round at place j of the next stage that has
    one."""
    for n in (2, 3, 8):
        for name in PROGRAM_NAMES:
            prog = _program(name, n)
            stages = pl._stages(prog)
            assert [b for b, _ in stages] == [r for r in range(prog.rounds)
                                              if prog.brk[r]]
            assert sum(length for _, length in stages) == prog.rounds
            prv, nxt = pl._links(prog)
            for si, (b, length) in enumerate(stages):
                for j in range(length):
                    later = [b2 + j for b2, l2 in stages[si + 1:] if l2 > j]
                    assert nxt[b + j] == (later[0] if later else -1)
                    assert prv[b + j] == any(l2 > j for _, l2 in stages[:si])
    # fuse3 at n = 8: a ring, a segmented ring (two stages), a ring
    prog = _program("fuse3", 8)
    assert pl._stages(prog) == [(0, 14), (14, 14), (28, 14), (42, 14)]
    prv, nxt = pl._links(prog)
    assert nxt[:3] == [14, 15, 16] and nxt[42:] == [-1] * 14
    assert prv[:14] == [False] * 14 and all(prv[14:])


def test_table_plan_keeps_the_buffers_in_shared_memory_or_l2():
    for n in (2, 3, 8, 12):
        for chunk_bytes in (512, 128 << 10, 64 << 20):  # 4 KiB..1 GiB/rank
            for chained in (1, 6, 13, 21):
                for cluster in (None, False):
                    stripes, threads, seg, used = pl._table_plan(
                        n, chunk_bytes, chained, 132, cluster)
                    assert used == (n <= pl.TABLE_CLUSTER_RANKS
                                    and cluster is None)
                    per_sm = (pl.TABLE_CLUSTER_BLOCKS_PER_SM if used
                              else pl.TABLE_BLOCKS_PER_SM)
                    assert 1 <= stripes <= per_sm * 132 // n
                    assert 64 <= threads <= 512
                    assert seg % 16 == 0 and seg > 0
                    per_block = pl.TABLE_BUFS * chained * seg
                    if used:  # a block's buffers in its shared memory
                        assert per_block <= pl.TABLE_SMEM_BYTES
                    else:  # every block's buffers in L2
                        assert n * stripes * per_block <= pl.TABLE_SLOT_BYTES
                    stripe = -(-chunk_bytes // 16 // stripes) * 16
                    assert seg <= max(stripe, 16)
    # the main path: 64 MiB chunks of the segmented program at n = 8 fill
    # the card with clusters, one vector per thread and pass
    stripes, threads, seg, used = pl._table_plan(8, 64 << 20, 13, 132)
    assert used and stripes * 8 >= 4 * 128 and seg == 16 * threads


def test_redesigned_simulators_refuse_unknown_placements():
    prog = _program("ring", 3)
    x = torch.ones(3, prog.nchunks, 8)
    with pytest.raises(ArgumentError):
        pl.simulate_table_fused(prog, x, "sum", credit="bogus")
    with pytest.raises(ArgumentError):
        pl.simulate_table_fused(prog, x, "sum", flags="bogus")
    with pytest.raises(ArgumentError):
        pl.simulate_table_fused(prog, x, "sum", seg_cols=0)
    with pytest.raises(ArgumentError):
        pr.simulate_ring_bidir(torch.ones(3, 3, 8), lookup("sum"),
                               credit="port")
    with pytest.raises(ArgumentError):
        pr.simulate_ring_fused(torch.ones(3, 3, 8), lookup("sum"),
                               direction=2)
    with pytest.raises(ArgumentError):  # clusters hold at most 8 ranks
        pl._table_plan(12, 128 << 10, 21, 132, cluster=True)


# ---------------------------------------------------------------------------
# Against the JAX package's kernels (interpret mode)
# ---------------------------------------------------------------------------

JNP = {torch.float32: jnp.float32, torch.int32: jnp.int32,
       torch.bfloat16: jnp.bfloat16}


@pytest.fixture(scope="module")
def devices():
    return np.array(jax.devices())


def _run_jax(devices, n: int, fn, x: torch.Tensor) -> torch.Tensor:
    mesh = Mesh(devices[:n], ("x",))
    f = shard_map(lambda v: fn(v[0])[None], mesh=mesh, in_specs=P("x"),
                  out_specs=P("x"), check_vma=False)
    xj = jnp.asarray(x.float().numpy()).astype(JNP[x.dtype])
    return torch.from_numpy(np.asarray(jax.jit(f)(xj)).astype(np.float32))


@pytest.mark.parametrize("n,op,dtype", [(3, "max", torch.int32),
                                        (8, "sum", torch.bfloat16)])
def test_bidir_matches_jax_package(devices, n, op, dtype):
    """333-column ring blocks: the JAX package pads each to 512 and
    splits it at 256; the port's ring takes the same padded blocks."""
    x = _rows((n, n, 333), seed=n * 7 + len(op), dtype=dtype)
    want = _run_jax(devices, n, lambda v: jpr.ring_allreduce_bidir(
        v, "x", op), x)
    got, residue = pr.simulate_ring_bidir(F.pad(x, (0, 512 - 333)),
                                          lookup(op))
    assert not residue
    assert torch.equal(got[..., :333].float(), want)


@pytest.mark.parametrize("algo,op,elems", [
    ("sched_pallas_ring_seg", "prod", 200),
    ("sched_pallas_rs", "min", 130)])
def test_table_wrappers_match_jax_package(devices, algo, op, elems):
    """The registered wrappers' layout around the wavefront over several
    segments (32 columns), bitwise the JAX package's compiled schedule
    in interpret mode, n = 3, int32."""
    n = 3
    rs = algo == "sched_pallas_rs"
    x = _rows((n, n, elems) if rs else (n, elems), seed=elems) % 7 - 3
    jfn = jpl.compile_schedule(jsched.build_schedule(algo, n))
    want = _run_jax(devices, n, lambda v: jfn(v, "x", op), x)
    sched = tsched.build_schedule(algo, n)
    run = pl._make_wrapper(
        pl.analyze(sched), sched.name,
        table=lambda prog, d, o: pl.sched_table_plain(prog, d, o,
                                                      seg_cols=32))
    assert torch.equal(run(x, op).float(), want)
