"""The port's schedule compiler (``ompi_tpu_torch/coll/sched``) and the
allreduce algorithms ``coll_tuned_prefer_native=false`` picks, against
the JAX package's, on the CPU.

- IR and tables: every generator at n in {2, 3, 4, 8}, with and without
  a ring order, renders and digests byte for byte as the JAX package's;
  ``analyze`` extracts the same tables, ``mode``, ``last`` and ``brk``
  from the eight table programs (ring, ring with an order, segmented
  ring at 2 and 4 segments, reduce-scatter, allgather, a 3-member
  ``fuse_schedules`` and a ``fuse_window``) and raises the same
  clauses on the negative programs of tests/test_sched_pallas.py.
- ``simulate``: the port's lock-step oracle is bitwise the JAX
  package's on the eight programs in float32/bfloat16/int32 with
  sum/max/min, and the table kernel's plain version (the flag-level
  simulator) is bitwise ``simulate``.
- The kernel route: ``comm.allreduce`` with ``sched_pallas_ring`` and
  ``sched_pallas_ring_seg`` forced, and ``comm.reduce_scatter_block``
  with ``sched_pallas_rs``, through the port's TunedColl on
  ``device="cpu"`` and the JAX package's on the 8-device CPU mesh,
  where the real ``_kernel`` runs in TPU-interpret mode. Exact: every
  element folds at the same ranks in the same order.
- The repair: ``recursive_doubling``, ``ring``, ``ring_segmented``,
  ``rabenseifner``, ``nonoverlapping`` and reduce's ``binomial`` are
  bitwise the JAX package's, and so is ``comm.allreduce`` with
  ``coll_tuned_prefer_native=false`` at 4 KiB, 64 KiB and 2 MiB per rank
  (the winner cache is off there, so the priors decide in both).
- The winner cache: model-mode ``autotune.tune`` gives the JAX
  package's winners and cache digest; a saved cache routes
  ``decide_allreduce`` and ``comm.allreduce``; the port's cache
  directory is its own; the hardware fingerprint hashes as the JAX
  package's.
- Interleavings: the table kernel's protocol is exact, with every flag
  back at 0, under 200 seeded random schedules at n in {2, 3, 4, 8} for
  every program; the JAX package's credit placement in the same
  simulator loses partials (the negative control).

The kernels themselves, on a card, are tested in test_torch_kernels.py.
"""

import dataclasses
import random

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch
from ompi_tpu import ops as jops
from ompi_tpu.coll import sched as jsched
from ompi_tpu.coll import tuned as jtuned
from ompi_tpu.coll.sched import autotune as jautotune
from ompi_tpu.coll.sched import cache as jcache
from ompi_tpu.coll.sched import ir as jir
from ompi_tpu.coll.sched import pallas_lower as jpl
from ompi_tpu.core import config as jconfig
from ompi_tpu.core.errors import ArgumentError as JArgumentError
from ompi_tpu_torch.coll import pallas_ring as pr
from ompi_tpu_torch.coll import sched as tsched
from ompi_tpu_torch.coll import tuned as ttuned
from ompi_tpu_torch.coll.sched import autotune as tautotune
from ompi_tpu_torch.coll.sched import cache as tcache
from ompi_tpu_torch.coll.sched import ir as tir
from ompi_tpu_torch.coll.sched import lower as tlower
from ompi_tpu_torch.coll.sched import pallas_lower as tpl
from ompi_tpu_torch.core import config as tconfig
from ompi_tpu_torch.core.counters import SPC
from ompi_tpu_torch.core.errors import ArgumentError, KernelError
from ompi_tpu_torch.ops import lookup

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16),
          "int32": (np.int32, jnp.int32, torch.int32)}


def make_input(shape, dtype: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-1000, 1000, shape).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32)


def raw(t) -> np.ndarray:
    """The bytes of a result as unsigned integers, so that equality is
    bitwise (``-0.0`` differs from ``+0.0``)."""
    if isinstance(t, torch.Tensor):
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        a = t.numpy()
    else:
        a = np.asarray(t)
    return np.ascontiguousarray(a).view(f"u{a.dtype.itemsize}")


def order_of(n: int) -> list:
    """A non-identity ring order: even ranks, then odd ones."""
    return list(range(0, n, 2)) + list(range(1, n, 2))


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
    """Leave both packages' global state as this file found it: the JAX
    package's TunedColl gets its schedule-compiler tier registered here
    and both winner caches are filled here, while other test files run
    in the same process."""
    registries = (jtuned.ALLREDUCE_ALGOS, jtuned.REDUCE_SCATTER_ALGOS)
    saved = [dict(r) for r in registries]
    caches = jcache.CACHE, tcache.CACHE
    jcache.CACHE = jcache.ScheduleCache()
    tcache.CACHE = tcache.ScheduleCache()
    try:
        yield
    finally:
        jcache.CACHE, tcache.CACHE = caches
        for reg, old in zip(registries, saved):
            reg.clear()
            reg.update(old)


@pytest.fixture(scope="module")
def worlds():
    jworld = ompi_tpu.init()
    tworld = ompi_tpu_torch.init(device="cpu")
    try:
        yield jworld, tworld
    finally:
        ompi_tpu_torch.finalize()


def _sub(world, n):
    if n == world.size:
        return world.dup()
    return world.split([0 if r < n else -1 for r in range(world.size)])[0]


# ---------------------------------------------------------------------------
# IR, tables and the lock-step oracle
# ---------------------------------------------------------------------------

def generated(irmod, n: int) -> dict:
    """Every generator's schedules at n ranks, with and without an order
    where the generator takes one (recursive doubling: a ScheduleError
    at a non-power-of-two n, whose message is compared instead)."""
    order = order_of(n)
    out = {}
    for o, tag in ((None, ""), (order, "+order")):
        out["ring" + tag] = irmod.ring(n, order=o)
        out["segmented_ring2" + tag] = irmod.segmented_ring(n, 2, order=o)
        out["segmented_ring4" + tag] = irmod.segmented_ring(n, 4, order=o)
        out["reduce_scatter" + tag] = irmod.reduce_scatter(n, order=o)
        out["allgather" + tag] = irmod.allgather(n, order=o)
        out["quantized_wire" + tag] = irmod.quantized_wire(n, order=o)
        out["hierarchical" + tag] = irmod.hierarchical(
            [list(range(n))] if o is None else [o[:n // 2], o[n // 2:]])
        out["generate:segmented_ring" + tag] = irmod.generate(
            "segmented_ring", n, segments=3, order=o)
    try:
        out["recursive_doubling"] = irmod.recursive_doubling(n)
    except irmod.ScheduleError as exc:
        out["recursive_doubling"] = str(exc)
    out["pallas:ring"] = irmod.with_lowering(
        irmod.ring(n), "pallas", tier="device_pallas")
    rs, ag = irmod.zero_pair("bucket0", n, order=order, ag_deadline=3)
    out["program"] = irmod.Program(name="step", nranks=n, nodes=(rs, ag),
                                   meta={"tile": 4096})
    irmod.check_program(out["program"])
    return out


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_ir_renders_and_digests_as_jax_package(n):
    got, want = generated(tir, n), generated(jir, n)
    assert got.keys() == want.keys()
    for name in want:
        if isinstance(want[name], str):
            assert got[name] == want[name], name
            continue
        assert got[name].render() == want[name].render(), name
        assert got[name].digest() == want[name].digest(), name


def programs(irmod, plmod, n: int) -> dict:
    """The eight table programs of the kernel's tests."""
    order = order_of(n)
    return {
        "ring": irmod.ring(n),
        "ring+order": irmod.ring(n, order=order),
        "seg2": irmod.segmented_ring(n, 2),
        "seg4": irmod.segmented_ring(n, 4),
        "rs": irmod.reduce_scatter(n),
        "ag": irmod.allgather(n),
        "fuse3": plmod.fuse_schedules(
            "fuse3", [irmod.ring(n), irmod.segmented_ring(n, 2),
                      irmod.ring(n, order=order)]),
        "window": plmod.fuse_window(
            "window", [irmod.allgather(n), irmod.allgather(n, order=order)],
            [irmod.reduce_scatter(n), irmod.reduce_scatter(n, order=order)]),
    }


PROGRAMS = ["ring", "ring+order", "seg2", "seg4", "rs", "ag", "fuse3",
            "window"]


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_analyze_extracts_jax_package_tables(n):
    got, want = programs(tir, tpl, n), programs(jir, jpl, n)
    for name in PROGRAMS:
        assert got[name].digest() == want[name].digest(), name
        t, j = tpl.analyze(got[name]), jpl.analyze(want[name])
        for field in ("op", "nranks", "nchunks", "rounds", "mode", "last",
                      "brk"):
            assert getattr(t, field) == getattr(j, field), (name, field)
        for table in ("t_dst", "t_src", "t_schunk", "t_rchunk"):
            np.testing.assert_array_equal(
                getattr(t, table).numpy(), getattr(j, table), (name, table))


def _negatives(irmod, plmod):
    """(label, thunk) of every program the contract rejects."""
    def mixed():
        s = irmod.ring(8)
        steps = list(s.steps)
        for i, st in enumerate(steps):
            if st.round == 0 and st.kind == "reduce" and st.rank == 0:
                steps[i] = dataclasses.replace(st, kind="copy")
                break
        return plmod.analyze(dataclasses.replace(s, steps=tuple(steps)))

    return [
        ("hierarchical", lambda: plmod.analyze(
            irmod.hierarchical([[0, 1, 2, 3], [4, 5, 6, 7]]))),
        ("quantized", lambda: plmod.analyze(irmod.quantized_wire(8))),
        ("mixed", mixed),
        ("op", lambda: plmod.analyze(dataclasses.replace(
            irmod.ring(4), op="bcast"))),
        ("empty", lambda: plmod.analyze(irmod.ring(1))),
        ("rd", lambda: plmod.analyze(irmod.recursive_doubling(8))),
        ("fuse-rs", lambda: plmod.fuse_schedules(
            "f", [irmod.reduce_scatter(4)])),
        ("fuse-mixed", lambda: plmod.fuse_schedules(
            "f", [irmod.ring(4), irmod.allgather(4)])),
        ("window-tail", lambda: plmod.fuse_window(
            "w", [irmod.ring(4)], [irmod.reduce_scatter(4)])),
        ("window-next", lambda: plmod.fuse_window(
            "w", [irmod.allgather(4)], [irmod.allgather(4)])),
        ("window-ranks", lambda: plmod.fuse_window(
            "w", [irmod.allgather(4)], [irmod.reduce_scatter(8)])),
    ]


def test_analyze_raises_jax_package_clauses():
    for (label, got), (_, want) in zip(_negatives(tir, tpl),
                                        _negatives(jir, jpl)):
        with pytest.raises(JArgumentError) as j:
            want()
        with pytest.raises(ArgumentError) as t:
            got()
        assert str(t.value) == str(j.value), label


def _sim_data(prog_sched, dtype: str, seed: int, chunk: int = 16):
    n, c = prog_sched.nranks, prog_sched.nchunks
    return make_input((n, c, chunk), dtype, seed)


@pytest.mark.parametrize("n", [3, 8])
def test_simulate_is_bitwise_jax_package_simulate(n):
    got, want = programs(tir, tpl, n), programs(jir, jpl, n)
    for i, name in enumerate(PROGRAMS):
        for dtype in DTYPES:
            for op in ("sum", "max", "min"):
                x = _sim_data(want[name], dtype, seed=i)
                j = jpl.simulate(want[name],
                                 jnp.asarray(x, DTYPES[dtype][1]), op)
                t = tpl.simulate(
                    got[name], torch.from_numpy(x).to(DTYPES[dtype][2]), op)
                np.testing.assert_array_equal(raw(t), raw(j),
                                              (name, dtype, op))


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_plain_version_is_bitwise_simulate(n):
    progs = programs(tir, tpl, n)
    for i, name in enumerate(PROGRAMS):
        for dtype, op in (("float32", "sum"), ("bfloat16", "max"),
                          ("int32", "prod"), ("float32", "min")):
            x = torch.from_numpy(_sim_data(progs[name], dtype, seed=i)).to(
                DTYPES[dtype][2])
            want = tpl.simulate(progs[name], x, op)
            got = tpl.sched_table(progs[name], x, op)
            assert torch.equal(raw_t(got), raw_t(want)), (name, dtype, op)


def raw_t(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


# ---------------------------------------------------------------------------
# Interleavings of the table kernel's protocol
# ---------------------------------------------------------------------------

def _protocol_case(name: str, n: int):
    prog = tpl.analyze(programs(tir, tpl, n)[name])
    x = torch.from_numpy(_sim_data(prog, "float32", seed=n, chunk=4))
    return lambda **kw: tpl.simulate_table(prog, x, "sum", **kw)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("name", PROGRAMS)
def test_table_protocol_exact_under_random_interleavings(name, n):
    simulate = _protocol_case(name, n)
    want, residue = simulate()
    assert not residue
    for seed in range(200):
        out, residue = simulate(rng=random.Random(seed))
        assert not residue, (seed, residue)
        assert torch.equal(out, want), seed


@pytest.mark.parametrize("name", PROGRAMS)
def test_reference_credit_placement_loses_partials(name):
    """Negative control: ``_kernel``'s placement (a post-seed credit,
    pallas_lower.py:454-457, then a credit right after filling a slot,
    :510-513) in the same simulator is exact in lock-step and loses a
    partial under some of 200 schedules at n = 4."""
    simulate = _protocol_case(name, 4)
    want, _ = simulate()
    lockstep, residue = simulate(credit="reference")
    assert torch.equal(lockstep, want) and not residue
    bad = [seed for seed in range(200)
           if not torch.equal(simulate(credit="reference",
                                       rng=random.Random(seed))[0], want)]
    assert bad, "reference placement survived every schedule"


def test_credits_need_a_flag_per_receiver():
    """A window whose members take different ring orders changes peers
    between rounds: with one credit flag per slot (``_kernel``'s
    semaphores, here under the port's placement) a later receiver's
    credit satisfies an earlier wait under some schedule; with one flag
    per (receiver, slot) every schedule is exact."""
    simulate = _protocol_case("window", 8)
    want, _ = simulate()
    bad = [seed for seed in range(200)
           if not torch.equal(simulate(shared_caps=True,
                                       rng=random.Random(seed))[0], want)]
    assert bad, "one flag per slot survived every schedule"


# ---------------------------------------------------------------------------
# The kernel route against the JAX package's interpret-mode kernel
# ---------------------------------------------------------------------------

# (operation, forced name, n, dtype, op, elements per rank or per block)
KERNEL_ROUTE = [
    ("allreduce", "sched_pallas_ring", 8, "float32", "sum", 1000),
    ("allreduce", "sched_pallas_ring", 3, "bfloat16", "max", 300),
    ("allreduce", "sched_pallas_ring_seg", 4, "float32", "sum", 1000),
    ("allreduce", "sched_pallas_ring_seg", 3, "int32", "prod", 200),
    ("reduce_scatter_block", "sched_pallas_rs", 8, "float32", "sum", 100),
    ("reduce_scatter_block", "sched_pallas_rs", 3, "int32", "min", 130),
]
VAR = {"allreduce": "coll_tuned_allreduce_algorithm",
       "reduce_scatter_block": "coll_tuned_reduce_scatter_algorithm"}


def _route(world, lib, opname, algo, n, dtype, op, elems, seed):
    shape = (n, n, elems) if opname == "reduce_scatter_block" else (n, elems)
    x = make_input(shape, dtype, seed)
    with both_vars({VAR[opname]: algo}):
        comm = _sub(world, n)
        assert comm._coll[opname][0].NAME == "tuned"
        if lib is torch:
            buf = comm.put_rank_major(torch.from_numpy(x).to(
                DTYPES[dtype][2]))
        else:
            buf = comm.put_rank_major(jnp.asarray(x, DTYPES[dtype][1]))
        out = getattr(comm, opname)(buf, op)
    assert any(k[1] == algo for k in comm._plan_cache), comm._plan_cache
    return raw(out)


@pytest.mark.parametrize("case", KERNEL_ROUTE,
                         ids=[f"{c[1]}-n{c[2]}-{c[3]}-{c[4]}"
                              for c in KERNEL_ROUTE])
def test_kernel_route_is_bitwise_jax_interpret_kernel(worlds, case):
    """The JAX package's TunedColl finds ``sched_pallas_rs`` only once
    its schedule-compiler tier is registered (its reduce_scatter_block
    registers the hand-kernel tier alone), so the tier is registered
    first here."""
    opname, algo, n, dtype, op, elems = case
    jtuned._sched_algos()
    seed = KERNEL_ROUTE.index(case)
    want = _route(worlds[0], jnp, opname, algo, n, dtype, op, elems, seed)
    before = SPC.read("sched_lower_strategy_pallas")
    got = _route(worlds[1], torch, opname, algo, n, dtype, op, elems, seed)
    assert SPC.read("sched_lower_strategy_pallas") == before + 1
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The repair: the spmd allreduce algorithms and the priors
# ---------------------------------------------------------------------------

SPMD_CASES = [  # (var, name, n, dtype, op, elems)
    ("coll_tuned_allreduce_algorithm", "recursive_doubling", 3, "float32",
     "sum", 257),
    ("coll_tuned_allreduce_algorithm", "recursive_doubling", 4, "bfloat16",
     "max", 200),
    ("coll_tuned_allreduce_algorithm", "recursive_doubling", 8, "int32",
     "prod", 130),
    ("coll_tuned_allreduce_algorithm", "recursive_doubling", 6, "float32",
     "min", 64),
    ("coll_tuned_allreduce_algorithm", "ring", 3, "bfloat16", "sum", 100),
    ("coll_tuned_allreduce_algorithm", "ring", 8, "float32", "sum", 1001),
    ("coll_tuned_allreduce_algorithm", "ring_segmented", 8, "float32",
     "sum", 1001),
    ("coll_tuned_allreduce_algorithm", "rabenseifner", 8, "float32", "sum",
     999),
    ("coll_tuned_allreduce_algorithm", "rabenseifner", 4, "int32", "max",
     100),
    ("coll_tuned_allreduce_algorithm", "nonoverlapping", 5, "float32",
     "sum", 300),
    ("coll_tuned_reduce_algorithm", "binomial", 8, "bfloat16", "sum", 77),
    ("coll_tuned_reduce_algorithm", "binomial", 5, "int32", "max", 128),
]


@pytest.mark.parametrize("case", SPMD_CASES,
                         ids=[f"{c[1]}-n{c[2]}-{c[3]}-{c[4]}"
                              for c in SPMD_CASES])
def test_spmd_algorithms_are_bitwise_jax_package(worlds, case):
    var, algo, n, dtype, op, elems = case
    x = make_input((n, elems), dtype, seed=SPMD_CASES.index(case))
    if dtype != "int32" and var == "coll_tuned_allreduce_algorithm":
        # every combine and broadcast keeps the sign of a zero. Not for
        # reduce: the JAX package reads root's row of its sharded result
        # by indexing, which XLA partitions as a masked sum over the
        # ranks, so every reduce route there turns -0.0 into +0.0.
        x[:, ::5] = -0.0
    # ring_segmented over several segments of 64 float32 elements
    extra = {"coll_tuned_segment_bytes": 256} if algo == "ring_segmented" \
        else {}
    outs = []
    for world, lib in ((worlds[0], jnp), (worlds[1], torch)):
        with both_vars({var: algo, **extra}):
            comm = _sub(world, n)
            buf = comm.put_rank_major(
                torch.from_numpy(x).to(DTYPES[dtype][2]) if lib is torch
                else jnp.asarray(x, DTYPES[dtype][1]))
            if var == "coll_tuned_reduce_algorithm":
                outs.append(raw(comm.reduce(buf, op, 2)))
            else:
                outs.append(raw(comm.allreduce(buf, op)))
        assert any(k[1] == algo for k in comm._plan_cache), comm._plan_cache
    np.testing.assert_array_equal(outs[1], outs[0])


@pytest.mark.parametrize("nbytes", [4 << 10, 64 << 10, 2 << 20])
def test_prefer_native_off_is_bitwise_jax_package(worlds, nbytes):
    """With the native preference off the priors pick recursive
    doubling, the ring and the segmented ring (1 MiB segments) at these
    sizes; the port raised ``ArgumentError`` there before it had them."""
    x = make_input((8, nbytes // 4), "float32", seed=nbytes)
    names, outs = [], []
    with both_vars({"coll_tuned_prefer_native": False,
                    "coll_sched_cache_enable": False}):
        for world, lib in ((worlds[0], jnp), (worlds[1], torch)):
            comm = world.dup()
            buf = comm.put_rank_major(torch.from_numpy(x) if lib is torch
                                      else jnp.asarray(x))
            outs.append(raw(comm.allreduce(buf, "sum")))
            names.append(sorted(k[1] for k in comm._plan_cache))
    assert names[0] == names[1] and names[1][0] in (
        "recursive_doubling", "ring", "ring_segmented"), names
    np.testing.assert_array_equal(outs[1], outs[0])


def test_allreduce_decisions_match_jax_package():
    ops = [(jops.lookup(n), lookup(n)) for n in ("sum", "max", "prod")]
    with both_vars({"coll_sched_cache_enable": False}):
        for prefer in (True, False):
            with both_vars({"coll_tuned_prefer_native": prefer}):
                for nbytes in (4, 9_999, 10_000, 1 << 20, (1 << 20) + 1):
                    for nranks in (2, 3, 8):
                        for jop, top in ops:
                            assert ttuned.decide_allreduce(
                                top, nbytes, nranks) == \
                                jtuned.decide_allreduce(jop, nbytes, nranks)


def test_registered_names_match_jax_package():
    for opname in ("allreduce", "reduce", "reduce_scatter", "bcast",
                   "allgather", "alltoall", "gather", "scatter"):
        want = jtuned._algo_space(opname)
        got = ttuned._algo_space(opname)
        if opname in ("bcast", "allgather", "reduce_scatter", "reduce"):
            # the spmd algorithms of these operations are still to port
            assert got <= want, (opname, got - want)
        else:
            assert got == want, (opname, got ^ want)
    for algo in ("quant_ring", "quant_pallas", "sched_quant"):
        # the quantized wire takes SUM alone, as in the JAX package
        fn = ttuned._resolve_algo("allreduce", algo)
        with pytest.raises(ValueError, match="SUM only"):
            fn(torch.ones(8, 4), lookup("max"))
    for algo in ("pallas_ring", "sched_pallas_ring", "quant_pallas"):
        assert ttuned.is_pallas_algo(algo) == jtuned.is_pallas_algo(algo)


def test_one_rank_forced_chunked_runs_the_one_rank_kernel(worlds):
    # SelfColl (priority 100) takes every one-rank communicator; below
    # tuned's 80 it leaves this one to TunedColl and its forced name.
    with both_vars({"coll_self_priority": 70}):
        solo = worlds[1].split([0] + [-1] * 7)[0]
    assert solo._coll["allreduce"][0].NAME == "tuned"
    old = tconfig.get("coll_pallas_segment_bytes")
    tconfig.VARS.set("coll_pallas_segment_bytes", 4096)
    try:
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            x = torch.arange(5000).reshape(1, 5000).to(dtype)
            with both_vars({"coll_tuned_allreduce_algorithm":
                            "pallas_ring_chunked"}):
                out = solo.allreduce(x, "sum")
            assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
    finally:
        tconfig.VARS.set("coll_pallas_segment_bytes", old)
    flat = x.reshape(1, -1)[:, :4096]
    assert torch.equal(pr.selfdma_chunked(flat, 1024), flat)
    assert solo.allreduce(x, "sum") is x  # unforced: the input itself


# ---------------------------------------------------------------------------
# The winner cache
# ---------------------------------------------------------------------------

@pytest.fixture
def clean_caches():
    jcache.CACHE.clear()
    tcache.CACHE.clear()
    yield
    jcache.CACHE.clear()
    tcache.CACHE.clear()


def test_model_mode_winners_and_digest_match_jax_package(clean_caches):
    want = jautotune.tune(8, mode="model", seed=0, topo_fp="fixed",
                          save=False)
    got = tautotune.tune(8, mode="model", seed=0, topo_fp="fixed",
                         save=False)
    assert got["winners"] == want["winners"]
    assert got["digest"] == want["digest"]
    assert got["times"] == want["times"]
    assert tcache.CACHE.entries()["allreduce|b2|float32|r8|fixed"][
        "schedule"] == jcache.CACHE.entries()[
        "allreduce|b2|float32|r8|fixed"]["schedule"]


def test_saved_cache_routes_decide_and_allreduce(worlds, clean_caches,
                                                 tmp_path):
    with both_vars({"coll_sched_cache_dir": str(tmp_path)}):
        fp = tautotune.fingerprint()
        res = tautotune.tune(8, mode="model", seed=0, sizes=(4096, 1 << 20),
                             topo_fp=fp)
        assert res["path"].startswith(str(tmp_path))
        tcache.CACHE.clear()  # the next consult loads the file
        winners = sorted(set(res["winners"].values()))
        hits = SPC.read("sched_cache_hits")
        algo = ttuned.decide_allreduce(lookup("sum"), 1 << 20, 8,
                                       dtype=torch.float32)
        assert algo == res["winners"][tcache.cache_key(
            "allreduce", 1 << 20, 8, "float32", fp)] and algo in winners
        assert SPC.read("sched_cache_hits") == hits + 1
        comm = worlds[1].dup()
        x = torch.from_numpy(make_input((8, 1024), "float32", 3))
        out = comm.allreduce(x, "sum")
        cached = res["winners"][tcache.cache_key("allreduce", 4096, 8,
                                                 "float32", fp)]
        assert [k[1] for k in comm._plan_cache] == [cached]
        with both_vars({"coll_tuned_allreduce_algorithm": cached}):
            assert torch.equal(worlds[1].dup().allreduce(x, "sum"), out)


def test_measure_mode_skips_refusals_and_raises_faults(worlds, clean_caches,
                                                      monkeypatch):
    """A candidate that refuses the shape (``ArgumentError``) drops out
    of a measure-mode sweep; a candidate whose kernel fails raises."""
    allowed, _ = tautotune.candidates("allreduce", 8)

    def refuse(b, op):
        raise ArgumentError("not at this shape")

    def broken(b, op):
        raise KernelError("the kernel did not build")

    monkeypatch.setitem(ttuned.ALLREDUCE_ALGOS, "ring", refuse)
    res = tautotune.tune(8, comm=worlds[1].dup(), mode="measure",
                         sizes=(4096,), save=False)
    assert set(res["times"]["float32|b12"]) == set(allowed) - {"ring"}
    monkeypatch.setitem(ttuned.ALLREDUCE_ALGOS, "ring", broken)
    with pytest.raises(KernelError, match="did not build"):
        tautotune.tune(8, comm=worlds[1].dup(), mode="measure",
                       sizes=(4096,), save=False)


def test_port_cache_dir_is_its_own(monkeypatch):
    monkeypatch.delenv("OMPI_TPU_SCHED_CACHE", raising=False)
    monkeypatch.delenv("OMPI_TPU_TORCH_SCHED_CACHE", raising=False)
    with both_vars({"coll_sched_cache_dir": ""}):
        assert tcache.cache_dir() != jcache.cache_dir()
        assert tcache.cache_dir().endswith("ompi_tpu_torch/sched")
        monkeypatch.setenv("OMPI_TPU_SCHED_CACHE", "/elsewhere")
        assert tcache.cache_dir().endswith("ompi_tpu_torch/sched")


def test_hardware_fingerprint_hashes_as_jax_package(worlds):
    from ompi_tpu.topo import hardware_fingerprint as jfp
    from ompi_tpu_torch.topo import hardware_fingerprint as tfp

    # 8 ranks, one host, one slice, kind "cpu" in both
    assert tfp(worlds[1].procs) == jfp()
    assert tautotune.fingerprint() == tfp(worlds[1].procs)


def test_lowering_memo_validator_and_quant_refusal(worlds):
    comm = worlds[1].dup()
    s = tir.with_lowering(tir.ring(8), "pallas", tier="device_pallas")
    before = SPC.read("sched_lower_strategy_pallas")
    fn = tlower.lower(s)
    assert tlower.lower(s) is fn
    assert SPC.read("sched_lower_strategy_pallas") == before + 2
    assert tlower.lower(s, strategy="interpret") is not fn
    with pytest.raises(ArgumentError, match="unknown lowering strategy"):
        tlower.lower(s, strategy="mosaic2")
    for sch in (s, tir.segmented_ring(8, 2),
                tir.hierarchical([[0, 1, 2], [3, 4, 5, 6, 7]]),
                tir.with_lowering(tir.reduce_scatter(8), "pallas")):
        for dtype, op in (("float32", "sum"), ("bfloat16", "prod")):
            assert tlower.validate_schedule(comm, sch, op, dtype), sch.name
    bad = dataclasses.replace(s, steps=tuple(
        dataclasses.replace(st, kind="copy")
        if st.round == 3 and st.kind == "reduce" else st for st in s.steps))
    assert not tlower.validate_schedule(comm, bad, "sum", "float32")
    # the quantized wire: int8 by the error bound, bf16 bit-exact; MAX
    # is refused, never quantized
    for wire in ("int8", "bf16"):
        assert tlower.validate_schedule(
            comm, tir.quantized_wire(8, wire), "sum", "float32"), wire
    with pytest.raises(ValueError, match="SUM only"):
        tlower.validate_schedule(comm, tir.quantized_wire(8), "max",
                                 "float32")
    assert tsched.build_schedule("sched_quant", 8).meta["primitive"] == \
        "quant_ring"
    assert jsched.ALGOS == tsched.ALGOS
