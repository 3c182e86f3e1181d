"""The port's compiled step program and slipstream window against the
JAX package's, on the CPU.

- ``compile_step`` / ``compile_window``: renders and digests
  byte-identical over bucket lists (float32 and bfloat16, the JAX
  package's dtype names from torch dtypes), seeds, ``node_choices`` and
  ``ag_deadlines``; the fused programs and the window boundary are the
  same schedules, and the port's ``simulate`` and table kernel (its
  plain version on the CPU) agree with the JAX package's ``simulate``.
- The program tier of the autotuner: ``program_choices``,
  ``program_tile_bytes``, ``ag_elision_wins``, ``program_node_choice``
  and ``window_cost_model`` equal; ``tune_step`` / ``tune_residency``
  write the same cache entries and digests, and a cache file written by
  one package steers the other's compile (the state carried across).
- ``ShardedAllreduce`` and ``StepExecutor`` (step program and legacy)
  give bitwise the JAX package's results on integer-valued inputs, at
  n = 3 and 8, with equal ``sched_*`` and ``part_*`` SPC deltas.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch
from ompi_tpu.coll.sched import autotune as jat
from ompi_tpu.coll.sched import cache as jcache
from ompi_tpu.coll.sched import pallas_lower as jpl
from ompi_tpu.coll.sched import slipstream as jslip
from ompi_tpu.coll.sched import stepprogram as jsp
from ompi_tpu.core.counters import SPC as JSPC
from ompi_tpu_torch.coll.sched import autotune as tat
from ompi_tpu_torch.coll.sched import cache as tcache
from ompi_tpu_torch.coll.sched import pallas_lower as tpl
from ompi_tpu_torch.coll.sched import slipstream as tslip
from ompi_tpu_torch.coll.sched import stepprogram as tsp
from ompi_tpu_torch.core.counters import SPC as TSPC

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": np.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture
def clean_caches():
    """Both packages' winner caches, emptied for the test and restored
    after it."""
    saved = (dict(jcache.CACHE._entries), dict(tcache.CACHE._entries))
    jcache.CACHE.clear()
    tcache.CACHE.clear()
    try:
        yield
    finally:
        jcache.CACHE.clear()
        tcache.CACHE.clear()
        jcache.CACHE._entries.update(saved[0])
        tcache.CACHE._entries.update(saved[1])


def _buckets(dtype, sizes):
    return ([(e, JAX_DT[dtype]) for e in sizes],
            [(e, TORCH_DT[dtype]) for e in sizes])


COMPILE_CASES = [
    # (nranks, dtype, elems per bucket, seed, node_choices, deadlines)
    (8, "float32", [1 << 20, 3000, 1 << 22], 5, None, None),
    (8, "bfloat16", [4096, 4096, 777], 0, ["rs_ag", None, "allreduce"],
     None),
    (3, "float32", [1 << 21, 1 << 23, 100], 7, ["rs_ag"] * 3, [0, 5, 31]),
    (8, "float32", [8 << 20, 8 << 20, 64], 5, ["rs_ag", "rs_resident",
                                              None], [31, None, 2]),
    (2, "bfloat16", [1 << 20], 1, None, [0]),
    (1, "float32", [512, 512], 0, ["rs_ag", "rs_ag"], None),
]


@pytest.mark.parametrize("case", COMPILE_CASES,
                         ids=[f"c{i}" for i in range(len(COMPILE_CASES))])
def test_compile_step_and_window_identical(case, clean_caches):
    n, dtype, sizes, seed, choices, deadlines = case
    jb, tb = _buckets(dtype, sizes)
    kw = dict(seed=seed, topo_fp="fp-test", node_choices=choices,
              ag_deadlines=deadlines)
    js, ts = jsp.compile_step(n, jb, **kw), tsp.compile_step(n, tb, **kw)
    assert ts.program.render() == js.program.render()
    assert ts.digest() == js.digest()
    assert ts.interleave == js.interleave
    for a, b in zip(ts.nodes, js.nodes):
        assert (a.choice, a.elems, a.tile_bytes, a.tile_elems, a.tiles,
                a.tile_source, a.ag_deadline) == \
            (b.choice, b.elems, b.tile_bytes, b.tile_elems, b.tiles,
             b.tile_source, b.ag_deadline)
        assert a.dtype == TORCH_DT[dtype]
    assert sorted(ts.fused) == sorted(js.fused)
    for op in ts.fused:
        assert ts.fused[op].render() == js.fused[op].render()
    jw = jslip.compile_window(n, jb, **kw)
    tw = tslip.compile_window(n, tb, **kw)
    assert tw.program.render() == jw.program.render()
    assert tw.digest() == jw.digest()
    assert (tw.elided, tw.ag_deadlines) == (jw.elided, jw.ag_deadlines)
    assert (tw.boundary is None) == (jw.boundary is None)
    if tw.boundary is not None:
        assert tw.boundary.render() == jw.boundary.render()


def test_program_tier_functions_identical():
    for n in (2, 3, 8):
        for nbytes in (4, 100, 64 << 10, 1 << 20, 4 << 20, 4 << 20 | 7,
                       32 << 20, 1 << 30):
            for seed in (0, 5):
                assert tat.program_tile_bytes(nbytes, n, seed) == \
                    jat.program_tile_bytes(nbytes, n, seed)
                for dl in (None, 0, 3, 31):
                    for res in (None, True, False):
                        assert tat.program_node_choice(
                            nbytes, n, seed, ag_deadline=dl,
                            resident=res) == jat.program_node_choice(
                            nbytes, n, seed, ag_deadline=dl, resident=res)
                    if dl is not None:
                        assert tat.ag_elision_wins(nbytes, n, seed, dl) \
                            == jat.ag_elision_wins(nbytes, n, seed, dl)
    assert tat.PROGRAM_TILE_CANDIDATES == jat.PROGRAM_TILE_CANDIDATES
    sizes = [4 << 20] * 3 + [30720, 32 << 20, 777]
    for kw in (dict(), dict(tile_bytes=65536),
               dict(tile_bytes=[1 << 20, 2, 3, 4, 5, 6]),
               dict(node_choices=["rs_ag", None, "allreduce", "rs_ag",
                                  "rs_ag", None],
                    ag_deadlines=[0, None, 3, 31, 31, 1]),
               dict(dtypes=["bfloat16"] * 6, seed=9)):
        assert tat.program_choices(sizes, 8, topo_fp="t", **kw) == \
            jat.program_choices(sizes, 8, topo_fp="t", **kw)
    cost = dict(backward_s=0.01,
                coll_time_s=lambda algo, nb: 1e-5 + nb * 1e-10)
    for n in (2, 8):
        assert tslip.window_cost_model(n, sizes, seed=3, **cost) == \
            jslip.window_cost_model(n, sizes, seed=3, **cost)


def _entries(cache):
    return {k: {f: e.get(f) for f in ("algorithm", "source", "tile_bytes",
                                       "ag_deadline", "resident",
                                       "version", "schedule")}
            for k, e in cache.entries().items()}


def test_tune_step_and_residency_cache_identical(clean_caches, tmp_path):
    sizes = [2048, 4096, 4 << 20, 32 << 20]
    jo = jat.tune_step(8, sizes, seed=3, topo_fp="tfp")
    to = tat.tune_step(8, sizes, seed=3, topo_fp="tfp")
    assert to["keys"] == jo["keys"] and to["digest"] == jo["digest"]
    ro = tat.tune_residency(8, [32 << 20, 32 << 20, 1 << 20], [0, 31, 2],
                            seed=5, topo_fp="tfp")
    rj = jat.tune_residency(8, [32 << 20, 32 << 20, 1 << 20], [0, 31, 2],
                            seed=5, topo_fp="tfp")
    assert ro["keys"] == rj["keys"] and ro["digest"] == rj["digest"]
    assert _entries(tcache.CACHE) == _entries(jcache.CACHE)
    assert tcache.CACHE.digest() == jcache.CACHE.digest()
    # the port's compile reads what its tuners wrote, as the JAX one does
    specs = [(512, "float32"), (8 << 20, "float32"), (1024, "float32")]
    kw = dict(seed=3, topo_fp="tfp", node_choices=["allreduce", "rs_ag",
                                                   None])
    tc = tsp.compile_step(8, specs, **kw)
    jc = jsp.compile_step(8, specs, **kw)
    assert [n.tile_source for n in tc.nodes] == ["cache"] * 3
    assert tc.digest() == jc.digest()


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_cache_file_carried_across_packages(clean_caches, tmp_path, writer):
    """A cache file one package's tuners wrote steers the other's
    compile: same entries, same digest, same compiled program."""
    w_at, w_cache = (tat, tcache) if writer == "torch" else (jat, jcache)
    r_cache = jcache if writer == "torch" else tcache
    w_at.tune_step(3, [4096, 1 << 20], seed=2, topo_fp="xfp")
    w_at.tune_residency(3, [32 << 20], [4], seed=2, topo_fp="xfp")
    path = str(tmp_path / "sched.json")
    w_cache.CACHE.save(path)
    doc = json.load(open(path))
    assert doc["digest"] == w_cache.CACHE.digest()
    assert r_cache.CACHE.load(path) == len(doc["entries"])
    assert r_cache.CACHE.digest() == w_cache.CACHE.digest()
    assert _entries(r_cache.CACHE) == _entries(w_cache.CACHE)
    specs = [(1024, "float32"), (1 << 18, "float32"), (8 << 20, "float32")]
    kw = dict(seed=2, topo_fp="xfp", node_choices=[None, None, "rs_ag"])
    # both packages hold the file's entries: each compiles the same
    # program (tile geometry from tune_step, residency from
    # tune_residency)
    jc, tc = jsp.compile_step(3, specs, **kw), tsp.compile_step(3, specs,
                                                                **kw)
    assert [n.tile_source for n in tc.nodes] == \
        [n.tile_source for n in jc.nodes] == ["cache", "cache", "model"]
    assert [n.choice for n in tc.nodes] == [n.choice for n in jc.nodes]
    assert tc.program.render() == jc.program.render()


@pytest.mark.parametrize("op", ["allreduce", "allgather", "window"])
def test_fused_programs_simulate_identical(op):
    """The step's fused programs (and the window's boundary) through
    both packages' ``simulate``, and the port's table kernel (its plain
    version here), bitwise."""
    n = 8 if op != "window" else 3
    if op == "window":
        w = tslip.compile_window(n, [(96, torch.float32)] * 3, seed=0,
                                 topo_fp="t", node_choices=["rs_ag"] * 3)
        sched = w.boundary
        jsched = jslip.compile_window(n, [(96, np.float32)] * 3, seed=0,
                                      topo_fp="t",
                                      node_choices=["rs_ag"] * 3).boundary
        assert sched is not None
    else:
        choices = ["allreduce"] * 3 if op == "allreduce" else ["rs_ag"] * 3
        sched = tsp.compile_step(n, [(256, torch.float32)] * 3,
                                 node_choices=choices, topo_fp="t").fused[op]
        jsched = jsp.compile_step(n, [(256, np.float32)] * 3,
                                  node_choices=choices,
                                  topo_fp="t").fused[op]
    assert sched.render() == jsched.render()
    rng = np.random.default_rng(4)
    data = rng.standard_normal((n, sched.nchunks, 8)).astype(np.float32)
    want = np.asarray(jpl.simulate(jsched, jnp.asarray(data), "sum"))
    got = tpl.simulate(sched, torch.from_numpy(data), "sum").numpy()
    assert got.tobytes() == want.tobytes()
    table = tpl.sched_table(sched, torch.from_numpy(data), "sum").numpy()
    assert table.tobytes() == want.tobytes()


# -- transport binding ------------------------------------------------------

@pytest.fixture(scope="module")
def worlds():
    jw = ompi_tpu.init()
    tw = ompi_tpu_torch.init(device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield jw, tw
    finally:
        torch.set_num_threads(threads)
        ompi_tpu_torch.finalize()


def _sub(world, n):
    if n == world.size:
        return world.dup()
    return world.split([0 if r < n else -1 for r in range(world.size)])[0]


SPC_DELTAS = ("part_transfers_sent", "part_transfers_received",
              "part_partitions_flagged", "part_partitions_arrived",
              "part_tiles_ready_total", "pml_isend_calls", "pml_send_bytes",
              "pml_rndv_sends", "pml_eager_sends",
              "sched_program_compiles_total", "sched_ag_elided_total")


def _spc(side):
    if side == "jax":
        return {k: JSPC.counter(k).value for k in SPC_DELTAS}
    return {k: TSPC.read(k) for k in SPC_DELTAS}


def _ints(n, elems, dtype, seed):
    """Values in {1, 2}: every arrival-order combine is exact."""
    return np.random.default_rng(seed).integers(1, 3, (n, elems)).astype(
        np.float32)


@pytest.mark.parametrize("n", [3, 8])
def test_sharded_allreduce_identical(worlds, n):
    jw, tw = worlds
    outs = []
    for side, world in (("jax", jw), ("torch", tw)):
        c = _sub(world, n)
        x = _ints(n, 96, "float32", n)
        mod = jsp if side == "jax" else tsp
        sh = mod.ShardedAllreduce(c, 96, np.float32 if side == "jax"
                                  else torch.float32, tiles=8,
                                  tag_base=5100, label="t")
        before = _spc(side)
        sh.start()
        data = x if side == "jax" else torch.from_numpy(x)
        for t in np.random.default_rng(0).permutation(sh.tiles):
            lo, hi = sh.tile_range(int(t))
            sh.ready(int(t), data[:, lo:hi])
        got = np.asarray(sh.wait()) if side == "jax" else sh.wait().numpy()
        after = _spc(side)
        outs.append((sh.nshards, sh.tiles, sh.tile_elems, got,
                     {k: after[k] - before[k] for k in SPC_DELTAS}))
    (jn, jt, je, jg, jd), (tn, tt, te, tg, td) = outs
    assert (tn, tt, te) == (jn, jt, je)
    assert tg.tobytes() == jg.tobytes()
    assert tg.tobytes() == np.broadcast_to(
        _ints(n, 96, "float32", n).sum(0), (n, 96)).tobytes()
    assert td == jd


@pytest.mark.parametrize("n,dtype,legacy", [(8, "float32", False),
                                            (3, "bfloat16", False),
                                            (8, "bfloat16", True)])
def test_step_executor_identical(worlds, n, dtype, legacy):
    jw, tw = worlds
    sizes = [300, 1024, 77]
    choices = ["rs_ag", "allreduce", "rs_resident"]
    got = []
    for side, world in (("jax", jw), ("torch", tw)):
        c = _sub(world, n)
        mod = jsp if side == "jax" else tsp
        dts = JAX_DT if side == "jax" else TORCH_DT
        before = _spc(side)
        comp = mod.compile_step(n, [(e, dts[dtype]) for e in sizes],
                                tile_bytes=256, seed=1, topo_fp="t",
                                node_choices=choices)
        ex = mod.StepExecutor(c, comp, tag_base=6000, legacy=legacy)
        results = []
        for step in range(2):
            ex.begin_step()
            xs = [_ints(n, e, dtype, 10 * step + i)
                  for i, e in enumerate(sizes)]
            for i in reversed(range(len(sizes))):
                b = ex.bindings[i]
                for t in range(b.tiles):
                    lo, hi = b.tile_range(t)
                    v = xs[i][:, lo:hi]
                    b.ready(t, jnp.asarray(v, dts[dtype]) if side == "jax"
                            else torch.from_numpy(v).to(dts[dtype]))
            out = ex.wait_all()
            results.append([np.asarray(o, np.float32) if side == "jax"
                            else o.float().numpy() for o in out])
            for o, x in zip(results[-1], xs):
                assert o.tobytes() == np.broadcast_to(
                    x.sum(0), x.shape).tobytes()
        after = _spc(side)
        got.append((comp.digest(), results,
                    {k: after[k] - before[k] for k in SPC_DELTAS}))
    (jd, jr, jdel), (td, tr, tdel) = got
    assert td == jd
    for a, b in zip(tr, jr):
        for x, y in zip(a, b):
            assert x.tobytes() == y.tobytes()
    assert tdel == jdel
