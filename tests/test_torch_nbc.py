"""The port's libnbc-style schedules (``ompi_tpu_torch.coll.nbc``)
against the JAX package's, on the CPU (mirrors ``tests/test_nbc.py``).

- Every ``sched_*`` builder at n in {1, 2, 3, 5, 8} (roots 0 and n-1):
  the rounds equal the JAX package's ``Schedule.rounds`` primitive by
  primitive.
- Every case of ``tests/test_nbc.py`` (the eleven entry points, a split
  communicator, two schedules in flight completed out of order, the
  schedule cache), plus the recursive doubling's non-power-of-two fold
  at n = 3 and 5, MAX/MIN/PROD, int32 and bfloat16: bitwise the JAX
  package's result on the same inputs. Both packages run the same
  schedule and the same elementwise IEEE combines, so a SUM agrees bit
  for bit too.
- Round by round: ``rounds_done`` after each progress tick equals the
  JAX package's, tick by tick; the SPC counts of schedules started and
  rounds progressed equal.
- The port's own rules: the input is never written (no primitive works
  in place), a result never shares storage with the input, and a numpy
  input goes through ``put_rank_major``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch
from ompi_tpu.coll import nbc as jnbc
from ompi_tpu.core import progress as jprogress
from ompi_tpu.core.counters import SPC as JSPC
from ompi_tpu_torch.coll import nbc as tnbc
from ompi_tpu_torch.core import progress as tprogress
from ompi_tpu_torch.core.counters import SPC as TSPC
from ompi_tpu_torch.core.errors import ArgumentError


@pytest.fixture(scope="module")
def worlds():
    jw = ompi_tpu.init()
    tw = ompi_tpu_torch.init(device="cpu")
    try:
        yield jw, tw
    finally:
        ompi_tpu_torch.finalize()


def _sub(comm, n):
    """The first n ranks of ``comm`` as a communicator of their own."""
    if n == comm.size:
        return comm
    return comm.split([0] * n + [-1] * (comm.size - n))[0]


def rank_data(n, shape=(8,), seed=0, dtype="float32"):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-50, 50, (n,) + shape).astype(np.int32)
    return rng.standard_normal((n,) + shape).astype(np.float32)


def _inputs(jc, tc, x, dtype):
    """The same rank-major input for both packages (bfloat16 made from
    the float32 values by each package's own rounding)."""
    if dtype == "bfloat16":
        return (jc.put_rank_major(jnp.asarray(x).astype(jnp.bfloat16)),
                torch.from_numpy(x).to(torch.bfloat16))
    return jc.put_rank_major(x), torch.from_numpy(x)


def _host(v):
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy()
        return v.numpy()
    a = np.asarray(v)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _bitwise(tgot, jgot, what):
    t, j = _host(tgot), _host(jgot)
    assert t.shape == j.shape and t.dtype == j.dtype, what
    assert t.tobytes() == j.tobytes(), what


# -- schedule structure -----------------------------------------------------

BUILDERS = {
    "bcast": lambda m, n, root: m.sched_bcast_binomial(n, root),
    "barrier": lambda m, n, root: m.sched_barrier_dissemination(n),
    "allreduce": lambda m, n, root: m.sched_allreduce_recursive_doubling(n),
    "reduce": lambda m, n, root: m.sched_reduce_binomial(n, root),
    "allgather": lambda m, n, root: m.sched_allgather_ring(n),
    "alltoall": lambda m, n, root: m.sched_alltoall_pairwise(n),
    "gather": lambda m, n, root: m.sched_gather_linear(n, root),
    "scatter": lambda m, n, root: m.sched_scatter_linear(n, root),
    "scan": lambda m, n, root: m.sched_scan_linear(n, exclusive=False),
    "exscan": lambda m, n, root: m.sched_scan_linear(n, exclusive=True),
}


def _rounds(sched):
    return [[(type(p).__name__,) + dataclasses.astuple(p) for p in rnd]
            for rnd in sched.rounds]


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_schedules_match_jax(name):
    for n in (1, 2, 3, 5, 8):
        for root in sorted({0, n - 1}):
            j = BUILDERS[name](jnbc, n, root).commit()
            t = BUILDERS[name](tnbc, n, root).commit()
            assert (t.name, t.size, t.n_rounds) == (j.name, j.size,
                                                    j.n_rounds)
            assert _rounds(t) == _rounds(j), (name, n, root)
    # binomial tree and dissemination: ceil(log2(n)) rounds
    assert tnbc.sched_bcast_binomial(8, 0).commit().n_rounds == 3
    assert tnbc.sched_barrier_dissemination(8).commit().n_rounds == 3


# -- results ------------------------------------------------------------------

# id -> (entry point, per-rank shape (None: (n, n, 4)), args, n, dtype)
CASES = {
    "ibcast_root0": ("ibcast", (8,), (0,), 8, "float32"),
    "ibcast_root3": ("ibcast", (8,), (3,), 8, "float32"),
    "ibcast_root7": ("ibcast", (8,), (7,), 8, "float32"),
    "iallreduce_sum": ("iallreduce", (8,), ("sum",), 8, "float32"),
    "iallreduce_max": ("iallreduce", (8,), ("max",), 8, "float32"),
    "iallreduce_sum_n3": ("iallreduce", (8,), ("sum",), 3, "float32"),
    "iallreduce_prod_n5": ("iallreduce", (8,), ("prod",), 5, "float32"),
    "iallreduce_sum_int32_n5": ("iallreduce", (8,), ("sum",), 5, "int32"),
    "iallreduce_sum_bf16": ("iallreduce", (8,), ("sum",), 8, "bfloat16"),
    "ireduce_sum_root2": ("ireduce", (8,), ("sum", 2), 8, "float32"),
    "ireduce_min_root0_n5": ("ireduce", (8,), ("min", 0), 5, "float32"),
    "ireduce_sum_n1": ("ireduce", (8,), ("sum", 0), 1, "float32"),
    "iallgather": ("iallgather", (8,), (), 8, "float32"),
    "ialltoall": ("ialltoall", None, (), 8, "float32"),
    "igather_root1": ("igather", (8,), (1,), 8, "float32"),
    "iscatter_root1": ("iscatter", (8,), (1,), 8, "float32"),
    "ireduce_scatter_block": ("ireduce_scatter_block", None, ("sum",), 8,
                              "float32"),
    "iscan_sum": ("iscan", (8,), ("sum",), 8, "float32"),
    "iscan_sum_n1": ("iscan", (8,), ("sum",), 1, "float32"),
    "iexscan_sum": ("iexscan", (8,), ("sum",), 8, "float32"),
    "iexscan_max_int32_n3": ("iexscan", (8,), ("max",), 3, "int32"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_nbc_matches_jax(worlds, case):
    fn, shape, args, n, dtype = CASES[case]
    jc, tc = (_sub(w, n) for w in worlds)
    x = rank_data(n, (n, 4) if shape is None else shape, seed=len(case),
                  dtype=dtype)
    jx, tx = _inputs(jc, tc, x, dtype)
    keep = tx.clone()
    jreq = getattr(jnbc, fn)(jc, jx, *args)
    treq = getattr(tnbc, fn)(tc, tx, *args)
    assert _rounds(treq._sched) == _rounds(jreq._sched)
    jgot, tgot = jreq.result(), treq.result()
    _bitwise(tgot, jgot, case)
    # no primitive wrote the input, and the result owns its storage
    assert torch.equal(tx, keep)
    assert tgot.untyped_storage().data_ptr() != \
        tx.untyped_storage().data_ptr()


def test_ibarrier(worlds):
    for mod, comm in zip((jnbc, tnbc), worlds):
        req = mod.ibarrier(comm)
        req.wait()
        assert req.done and req.result() is None


def test_round_by_round_progress(worlds):
    """At most one round per progress tick (reference: NBC_Progress),
    and the same round count after each tick as the JAX package's."""
    jw, tw = worlds
    x = rank_data(tw.size, seed=10)
    seen = []
    for mod, prog, comm, spc in ((jnbc, jprogress, jw,
                                  lambda k: JSPC.counter(k).value),
                                 (tnbc, tprogress, tw, TSPC.read)):
        before = [spc(k) for k in ("nbc_schedules_started",
                                   "nbc_rounds_progressed")]
        req = mod.iallreduce(comm, comm.put_rank_major(x), "sum")
        assert not req.done
        ticks = [req.rounds_done]
        for _ in range(req._sched.n_rounds + 2):
            prog.progress()
            ticks.append(req.rounds_done)
        assert req.done
        assert all(b - a <= 1 for a, b in zip(ticks, ticks[1:]))
        after = [spc(k) for k in ("nbc_schedules_started",
                                  "nbc_rounds_progressed")]
        seen.append((ticks, [a - b for a, b in zip(after, before)],
                     req.result()))
    assert seen[1][:2] == seen[0][:2]
    _bitwise(seen[1][2], seen[0][2], "round by round")


def test_overlapping_schedules_complete_out_of_order(worlds):
    d1, d2, d3 = (rank_data(8, seed=s) for s in (11, 12, 13))
    got = []
    for mod, comm in zip((jnbc, tnbc), worlds):
        r1 = mod.iallreduce(comm, comm.put_rank_major(d1), "sum")
        r2 = mod.ibcast(comm, comm.put_rank_major(d2), root=0)
        r3 = mod.iallgather(comm, comm.put_rank_major(d3))
        r2.wait()
        r3.wait()
        r1.wait()
        got.append([r.result() for r in (r1, r2, r3)])
    for t, j in zip(*reversed(got)):
        _bitwise(t, j, "overlap")


def test_schedule_cache(worlds):
    """Same (op, size) reuses the compiled schedule (libnbc's cache)."""
    for mod, comm in zip((jnbc, tnbc), worlds):
        d = comm.put_rank_major(rank_data(comm.size, seed=13))
        r1 = mod.iallreduce(comm, d, "sum")
        r1.wait()
        r2 = mod.iallreduce(comm, d, "max")
        assert r2._sched is r1._sched
        r2.wait()


def test_subcommunicator(worlds):
    jw, tw = worlds
    colors = [r % 2 for r in range(tw.size)]
    jsub, tsub = jw.split(colors), tw.split(colors)
    for color in (0, 1):
        jc, tc = jsub[color], tsub[color]
        x = np.arange(tc.size * 4, dtype=np.float32).reshape(tc.size, 4)
        _bitwise(tnbc.iallreduce(tc, x, "sum").result(),
                 jnbc.iallreduce(jc, x, "sum").result(), color)


def test_numpy_input_goes_through_put_rank_major(worlds):
    _, tw = worlds
    x = rank_data(tw.size, seed=3)
    got = tnbc.ibcast(tw, x, root=2).result()
    assert torch.equal(got, torch.from_numpy(x[2]).expand(tw.size, -1))
    with pytest.raises(ArgumentError):
        tnbc.iallreduce(tw, x[:3], "sum")
