"""The port's gradient bucketer, partitioned allreduces, DP overlap
session and readiness capture against the JAX package's, on the CPU.

- ``plan_buckets`` / ``plan_overlap`` and the session's plan: bitwise
  equal (leaf paths by ``keystr``, dicts in sorted key order whatever
  their insertion order, buckets, pieces, tiles).
- ``BucketedAllreduce`` and ``PartitionedAllreduce`` (exact wire): within
  rtol 1e-6 of ``comm.allreduce`` and of the JAX package's result, and
  bitwise on integer-valued inputs; the quant wire within the int8
  wire's bound.
- ``DpOverlapSession`` (window 1 and 2, ``step_program`` on and off):
  within rtol 1e-4 / atol 1e-5 of the JAX package's session on random
  values, bitwise on integer-valued ones, with equal reports' bucket and
  tile counts and equal ``parallel_*``/``part_*``/``sched_*`` SPC
  deltas.
- ``grad_marker``'s backward order over ``bench.py``'s chain equals the
  JAX capture; ``autograd_backward_order`` reads autograd's own order.
- ``allreduce_pytree``, ``allreduce_tree``, ``dp.allreduce_gradients``,
  ``dp.mean_gradients`` and ``dp.shard_batch`` against the JAX package's
  (its traced forms under ``shard_map``), and ``ErrorFeedback`` banks
  under ``coll_quant_error_feedback`` and the quantized wire.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import ompi_tpu
import ompi_tpu_torch
from ompi_tpu.coll import partitioned as jpart
from ompi_tpu.coll import quant as jquant
from ompi_tpu.core import config as jconfig
from ompi_tpu.core.counters import SPC as JSPC
from ompi_tpu.parallel import bucketer as jbkt
from ompi_tpu.parallel import dp as jdp
from ompi_tpu.parallel import overlap as jovl
from ompi_tpu_torch.coll import partitioned as tpart
from ompi_tpu_torch.coll import quant as tquant
from ompi_tpu_torch.core import config as tconfig
from ompi_tpu_torch.core import tree as ttree
from ompi_tpu_torch.core.counters import SPC as TSPC
from ompi_tpu_torch.parallel import bucketer as tbkt
from ompi_tpu_torch.parallel import dp as tdp
from ompi_tpu_torch.parallel import overlap as tovl

SPC_NAMES = ("parallel_overlap_marks", "parallel_dp_bucket_dispatches",
             "parallel_dp_bucket_leaves", "part_tiles_ready_total",
             "part_transfers_sent", "part_transfers_received",
             "pml_isend_calls", "pml_send_bytes",
             "sched_program_compiles_total", "sched_window_spans_total",
             "sched_ag_elided_total")


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


def _spc(side):
    if side == "jax":
        return {k: JSPC.counter(k).value for k in SPC_NAMES}
    return {k: TSPC.read(k) for k in SPC_NAMES}


def _jt(a, dtype=None):
    return jnp.asarray(a) if dtype is None else jnp.asarray(a, dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    return np.asarray(x, np.float32) if str(x.dtype) == "bfloat16" \
        else np.asarray(x)


def _grads(n, sizes, seed, ints=False, shapes=None):
    """Rank-major leaves; insertion order deliberately NOT sorted."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, e in reversed(list(enumerate(sizes))):
        shape = (n,) + (shapes[i] if shapes else (e,))
        out[f"l{i:02d}"] = (rng.integers(1, 3, shape).astype(np.float32)
                            if ints else
                            rng.standard_normal(shape).astype(np.float32))
    return out


# -- plans ------------------------------------------------------------------

def test_plans_identical():
    rng = np.random.default_rng(0)
    tree = {
        "z": rng.standard_normal((3, 5)).astype(np.float32),
        "big": np.zeros(3_000_000 // 8, np.float32),
        "a": {"k": np.zeros(7, np.int32), "e": np.zeros(0, np.float32),
              "b": [np.zeros((2, 2), np.float32),
                    np.zeros(9, jnp.bfloat16)]},
        "m": np.float32(1.0),
    }
    ttree_ = {k: v for k, v in tree.items()}
    for bb in (None, 0, 64, 4096, 100_000):
        jp = jbkt.plan_buckets(tree, bb)
        tp = tbkt.plan_buckets(ttree_, bb)
        assert [(str(b.dtype), b.elems, b.pieces) for b in jp] == \
            [(str(b.dtype).removeprefix("torch."), b.elems, b.pieces)
             for b in tp]
    jleaves, jdef = jax.tree.flatten(tree)
    tleaves, tdef = ttree.flatten(ttree_)
    assert [np.shape(x) for x in jleaves] == [np.shape(x) for x in tleaves]
    jpaths = [jax.tree_util.keystr(p)
              for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    tpaths = [ttree.keystr(p) for p, _ in ttree.flatten_with_path(ttree_)[0]]
    assert tpaths == jpaths
    assert ttree.unflatten(tdef, tleaves).keys() == tree.keys()
    for bb, tb in ((4096, 512), (1 << 20, None)):
        jo = jovl.plan_overlap(jleaves, jdef, bb, tb)
        to = tovl.plan_overlap(tleaves, tdef, bb, tb)
        assert to.leaf_pieces == jo.leaf_pieces
        assert (to.tiles, to.tile_elems, to.tile_sources) == \
            (jo.tiles, jo.tile_elems, jo.tile_sources)
        assert to.leaf_shapes == jo.leaf_shapes


@pytest.mark.parametrize("n", [3, 8])
def test_session_plans_identical(worlds, n):
    jw, tw = worlds
    g = _grads(n, [300, 500, 200, 700, 5], 1,
               shapes=[(300,), (5, 100), (200,), (7, 100), ()])
    kw = dict(bucket_bytes=2048, tile_bytes=512, progress_thread=False)
    js = jovl.DpOverlapSession(_sub(jw, n), {k: _jt(v) for k, v in
                                             g.items()}, **kw)
    ts = tovl.DpOverlapSession(_sub(tw, n), {k: torch.from_numpy(v)
                                             for k, v in g.items()}, **kw)
    assert ts.plan.leaf_paths == js.plan.leaf_paths
    assert ts.plan.leaf_pieces == js.plan.leaf_pieces
    assert ts.plan.leaf_shapes == js.plan.leaf_shapes
    assert (ts.plan.tiles, ts.plan.tile_elems, ts.plan.tile_sources) == \
        (js.plan.tiles, js.plan.tile_elems, js.plan.tile_sources)
    assert ts.compiled.digest() == js.compiled.digest()
    assert [pa.tag for pa in ts._pas] == [pa.tag for pa in js._pas]


# -- BucketedAllreduce / PartitionedAllreduce -------------------------------

@pytest.mark.parametrize("n", [3, 8])
def test_bucketed_allreduce(worlds, n):
    jw, tw = worlds
    x = np.random.default_rng(3).random((n, 5000)).astype(np.float32)
    jc, tc = _sub(jw, n), _sub(tw, n)
    jb = jpart.BucketedAllreduce(jc, jc.put_rank_major(x), "sum", 4)
    tb = tpart.BucketedAllreduce(tc, torch.from_numpy(x), "sum", 4)
    for b in (2, 0, 3, 1):
        jb.ready(b)
        tb.ready(b)
    jout, tout = _np(jb.wait()), _np(tb.wait())
    np.testing.assert_allclose(
        tout, _np(tc.allreduce(torch.from_numpy(x))), rtol=1e-6)
    np.testing.assert_allclose(tout, jout, rtol=1e-6)
    out = tpart.bucketed_allreduce(
        tc, torch.ones(n, 16), "sum", 4, produce=lambda b, s: s * (b + 1))
    assert _np(out).tobytes() == np.repeat(
        np.arange(1, 5, dtype=np.float32) * n, 4)[None].repeat(
        n, 0).tobytes()


@pytest.mark.parametrize("n,ints", [(3, False), (8, False), (8, True)])
def test_partitioned_allreduce_exact(worlds, n, ints):
    jw, tw = worlds
    rng = np.random.default_rng(n)
    x = (rng.integers(1, 3, (n, 2050)).astype(np.float32) if ints
         else rng.random((n, 2050)).astype(np.float32))
    order = rng.permutation(6)
    outs = []
    for side, world, mod in (("jax", jw, jpart), ("torch", tw, tpart)):
        c = _sub(world, n)
        data = c.put_rank_major(x) if side == "jax" else torch.from_numpy(x)
        pa = mod.PartitionedAllreduce(c, data, tiles=6, tag=700)
        before = _spc(side)
        for _ in range(2):               # persistent re-arm
            pa.start()
            for t in order:
                lo, hi = pa.tile_range(int(t))
                pa.ready(int(t), data[:, lo:hi])
            got = _np(pa.wait())
        after = _spc(side)
        outs.append((got, pa.tiles, pa.tile_elems, pa.algo,
                     {k: after[k] - before[k] for k in SPC_NAMES}))
    (jg, *jrest, jd), (tg, *trest, td) = outs
    assert trest == jrest and td == jd
    tc = _sub(tw, n)
    np.testing.assert_allclose(
        tg, _np(tc.allreduce(torch.from_numpy(x))), rtol=1e-6)
    np.testing.assert_allclose(tg, jg, rtol=1e-6)
    if ints:
        assert tg.tobytes() == jg.tobytes()


def test_partitioned_allreduce_errors_and_poll(worlds):
    _, tw = worlds
    c = _sub(tw, 8)
    x = torch.from_numpy(np.random.default_rng(4).random(
        (8, 30)).astype(np.float32))
    pa = tpart.PartitionedAllreduce(c, x, tiles=3, tag=702)
    with pytest.raises(Exception) as e1:
        pa.ready(0, x[:, :10])
    assert type(e1.value).__name__ == "RequestError"
    pa.start()
    assert not pa.poll() and not pa.reduced
    pa.ready(0, x[:, :10])
    with pytest.raises(Exception) as e2:
        pa.ready(0, x[:, :10])
    assert type(e2.value).__name__ == "RequestError"
    pa.ready_range(1, 2, x[:, 10:])
    assert pa.poll()
    np.testing.assert_allclose(_np(pa.wait()), _np(c.allreduce(x)),
                               rtol=1e-6)
    with pytest.raises(Exception) as e3:
        tpart.PartitionedAllreduce(c, x, op="replace")
    assert type(e3.value).__name__ == "ArgumentError"


def test_partitioned_allreduce_quant_wire(worlds):
    jw, tw = worlds
    n = 8
    x = (np.random.default_rng(6).random((n, 512)) * 2.0).astype(np.float32)
    jconfig.set("coll_quant_min_bytes", 64)
    tconfig.set("coll_quant_min_bytes", 64)
    try:
        outs = []
        for side, world, mod in (("jax", jw, jpart), ("torch", tw, tpart)):
            c = _sub(world, n)
            data = (c.put_rank_major(x) if side == "jax"
                    else torch.from_numpy(x))
            pa = mod.PartitionedAllreduce(c, data, tiles=4, tag=705,
                                          allow_quant=True)
            exact = mod.PartitionedAllreduce(c, data, tiles=4, tag=715,
                                             allow_quant=False)
            assert pa.quant_wire and not exact.quant_wire
            pa.start()
            for t in range(pa.tiles):
                lo, hi = pa.tile_range(t)
                pa.ready(t, data[:, lo:hi])
            outs.append((_np(pa.wait()), pa.tiles, pa.tile_elems,
                         pa._wire_tile))
    finally:
        jconfig.set("coll_quant_min_bytes", 64 << 10)
        tconfig.set("coll_quant_min_bytes", 64 << 10)
    (jg, *jgeo), (tg, *tgeo) = outs
    assert tgeo == jgeo
    exact = np.broadcast_to(x.astype(np.float64).sum(0), x.shape)
    # every peer's tile is quantized once on the wire (the root's own
    # contribution is exact): at most half a step of each peer's block
    # scale, summed over the peers
    blk = tquant._block_var.value
    scale = np.abs(x[1:]).reshape(n - 1, -1, blk).max(-1) / 127.0
    bound = np.repeat((0.5 * scale).sum(0), blk) * (1 + 1e-5) + 1e-6
    assert (np.abs(tg - exact) <= bound).all()
    assert (np.abs(jg - exact) <= bound).all()
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-5)


# -- the DP overlap session ---------------------------------------------------

SESSION_CASES = [
    # (n, window, step_program, ints, dtype)
    (8, 1, True, False, "float32"),
    (3, 1, False, False, "float32"),
    (8, 2, True, True, "float32"),
    (3, 2, True, False, "float32"),
    (8, 1, True, True, "bfloat16"),
]


@pytest.mark.parametrize("n,window,program,ints,dtype", SESSION_CASES)
def test_session_matches_jax(worlds, n, window, program, ints, dtype):
    jw, tw = worlds
    sizes = [400, 150, 600, 250, 1000]
    steps = [_grads(n, sizes, 10 + s, ints=ints) for s in range(2)]
    names = sorted(steps[0])
    kw = dict(bucket_bytes=2048, tile_bytes=512, step_program=program,
              window=window, tag_base=5200)
    if window >= 2:
        kw["node_choices"] = ["rs_resident", "rs_ag", None, "allreduce",
                              "rs_ag"]
    results = []
    for side, world, mod in (("jax", jw, jovl), ("torch", tw, tovl)):
        c = _sub(world, n)
        cast = ((lambda v: _jt(v, jnp.dtype(dtype))) if side == "jax"
                else (lambda v: torch.from_numpy(v).to(getattr(torch,
                                                               dtype))))
        tmpl = {k: cast(v) for k, v in steps[0].items()}
        before = _spc(side)
        # The JAX session runs without its pump thread: its finish() and
        # step() can miss a run the pump thread popped and is still
        # readying (the port takes the fire lock; see
        # test_finish_waits_for_a_run_the_pump_thread_is_readying).
        sess = mod.DpOverlapSession(c, tmpl, **kw,
                                    progress_thread=side == "torch")
        outs = []
        for g in steps:
            sess.begin_step()
            for nm in reversed(names):        # backward order
                sess.mark_ready(f"['{nm}']", cast(g[nm]))
            if window >= 2:
                sess.step()
            else:
                outs.append(sess.finish())
        if window >= 2:
            outs = sess.flush()
        after = _spc(side)
        results.append(([{k: _np(v) for k, v in o.items()}
                         for o, _ in outs],
                        [(r.buckets, r.tiles) for _, r in outs],
                        {k: after[k] - before[k] for k in SPC_NAMES},
                        sess.compiled.digest()))
        for _, rep in outs:
            assert 0.0 <= rep.overlap_pct <= 100.0
            assert rep.exposed_comm_ms >= 0.0
    (jo, jr, jd, jdig), (to, tr, td, tdig) = results
    assert (tr, td, tdig) == (jr, jd, jdig)
    for s, g in enumerate(steps):
        for nm in names:
            want = np.broadcast_to(
                _np(cast_ref(g[nm], dtype)).sum(0, dtype=np.float64),
                g[nm].shape)
            if ints:
                assert to[s][nm].tobytes() == jo[s][nm].tobytes()
            np.testing.assert_allclose(to[s][nm], jo[s][nm], rtol=1e-4,
                                       atol=1e-5)
            tol = 1e-2 if dtype == "bfloat16" else 1e-4
            np.testing.assert_allclose(to[s][nm], want, rtol=tol,
                                       atol=1e-5 if tol < 1e-3 else tol)


def cast_ref(v, dtype):
    return torch.from_numpy(v).to(getattr(torch, dtype))


def test_session_mark_slices_validation_and_threaded_marks(worlds):
    """Slice marks complete a leaf once; an overlapping mark raises
    atomically; marks from another thread (as from an autograd hook)
    with the pump thread running give the exact sum."""
    _, tw = worlds
    c = _sub(tw, 8)
    g = _grads(8, [512, 300], 2, ints=True)
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    sess = tovl.DpOverlapSession(c, tg, bucket_bytes=1024, tile_bytes=256,
                                 progress_thread=False)
    sess.begin_step()
    v = tg["l00"].reshape(8, -1)
    with pytest.raises(Exception) as e:
        sess.mark_ready("nosuch", v)
    assert type(e.value).__name__ == "ArgumentError"
    done = sess.mark_ready("['l00']", v[:, :200], slice=(0, 200))
    with pytest.raises(Exception) as e:
        sess.mark_ready("['l00']", v[:, 100:300], slice=(100, 300))
    assert type(e.value).__name__ == "RequestError"
    done += sess.mark_ready("['l00']", v[:, 200:], slice=(200, 512))
    with pytest.raises(Exception) as e:
        sess.finish()                     # l01 still unmarked
    assert type(e.value).__name__ == "RequestError"
    sess.mark_ready(1, tg["l01"])
    out, _ = sess.finish()
    assert sorted(done) == sorted(set(done))
    for k in g:
        assert _np(out[k]).tobytes() == np.broadcast_to(
            g[k].sum(0), g[k].shape).tobytes()
    sess2 = tovl.DpOverlapSession(c, tg, bucket_bytes=1024,
                                  tile_bytes=256, tag_base=5600)
    sess2.begin_step()
    th = threading.Thread(target=lambda: [sess2.mark_ready(k, tg[k])
                                          for k in ("l01", "l00")])
    th.start()
    th.join()
    out, rep = sess2.finish()
    assert rep.buckets == len(sess2._pas)
    for k in g:
        assert _np(out[k]).tobytes() == np.broadcast_to(
            g[k].sum(0), g[k].shape).tobytes()
    assert all(b.device == c.device for b in sess2.buffers())


@pytest.mark.parametrize("window", [1, 2])
def test_finish_waits_for_a_run_the_pump_thread_is_readying(worlds, window):
    """The pump thread pops the last queued run and is slow to ready it:
    finish() (window 1) or step() (window 2) waits for it instead of
    finding the queue empty and the tiles unready."""
    _, tw = worlds
    c = _sub(tw, 3)
    g = _grads(3, [300, 200], 4, ints=True)
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    sess = tovl.DpOverlapSession(c, tg, bucket_bytes=1024, tile_bytes=256,
                                 window=window, tag_base=5700)
    for pa in sess._pas:
        def slow(lo, hi, *args, _ready=pa.ready_range, **kwargs):
            if threading.current_thread() is not threading.main_thread():
                time.sleep(0.1)
            return _ready(lo, hi, *args, **kwargs)
        pa.ready_range = slow
    sess.begin_step()
    for k in ("l01", "l00"):
        sess.mark_ready(k, tg[k])
    deadline = time.monotonic() + 10
    while sess._fire_q and time.monotonic() < deadline:
        time.sleep(0.001)  # the pump thread has popped every run
    if window == 1:
        out, _ = sess.finish()
    else:
        sess.step()
        [(out, _)] = sess.flush()
    for k in g:
        assert _np(out[k]).tobytes() == np.broadcast_to(
            g[k].sum(0), g[k].shape).tobytes()


# -- readiness capture --------------------------------------------------------

def test_grad_marker_order_matches_jax_capture():
    """bench.py's chain: layer i's marker fires once layer i's gradients
    are formed, so the capture reads back to front in both packages."""
    names = ["l%02d" % i for i in range(10)]
    jovl.reset_capture()

    def _loss(ws, x):
        h = x
        for i, nm in enumerate(names):
            h = jovl.grad_marker(h, nm)
            h = jnp.tanh(h * ws[i])
        return jnp.sum(h)

    jax.grad(_loss, argnums=(0, 1))([jnp.float32(1.0)] * 10,
                                    jnp.ones((4,), jnp.float32))
    jorder = jovl.backward_order()
    tovl.reset_capture()
    ws = [torch.tensor(1.0, requires_grad=True) for _ in names]
    x = torch.ones(4, requires_grad=True)
    h = x
    for i, nm in enumerate(names):
        h = tovl.grad_marker(h, nm)
        h = torch.tanh(h * ws[i])
    h.sum().backward()
    torder = tovl.backward_order()
    assert torder == jorder and torder[0] == names[-1]
    # the marker is the identity both ways
    y = torch.randn(5, requires_grad=True)
    z = tovl.grad_marker(y, "id")
    assert torch.equal(z, y)
    z.backward(torch.arange(5.0))
    assert torch.equal(y.grad, torch.arange(5.0))
    assert tovl.capture_ready_schedule({"b": 1, "a": 2}) == {"b": 1, "a": 2}
    assert tovl.last_schedule()["leaf_paths"] == ("['a']", "['b']")
    assert tovl.last_schedule()["bwd_order"][:10] == jorder
    kind, order = tovl.readiness_order(
        lambda p: torch.tanh(p[1] * torch.tanh(p[0] * x)).sum(), ws[:2])
    assert kind == "autograd" and order == (1, 0)
    assert tovl.readiness_order()[0] == "marker"


# -- bucketer and dp ----------------------------------------------------------

def _shard_map(fn, tree):
    mesh = Mesh(np.array(jax.devices()), ("dp",))
    return jax.jit(jax.shard_map(
        lambda t: jax.tree.map(lambda y: y[None],
                               fn(jax.tree.map(lambda x: x[0], t))),
        mesh=mesh, in_specs=(P("dp"),), out_specs=P("dp")))(tree)


@pytest.mark.parametrize("ints", [True, False])
def test_allreduce_tree_and_dp_match_jax(worlds, ints):
    g = _grads(8, [300, 7, 1200, 64], 5, ints=ints,
               shapes=[(300,), (7,), (30, 40), (8, 8)])
    jg = {k: _jt(v) for k, v in g.items()}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    checks = [
        (lambda t: jbkt.allreduce_tree(t, "dp", bucket_bytes=2048),
         lambda t: tbkt.allreduce_tree(t, bucket_bytes=2048)),
        (lambda t: jdp.allreduce_gradients(t, "dp"),
         tdp.allreduce_gradients),
        (lambda t: jdp.mean_gradients(t, "dp"), tdp.mean_gradients),
    ]
    for jfn, tfn in checks:
        jb, tb = _spc("jax"), _spc("torch")
        jout = _shard_map(jfn, jg)
        tout = tfn(tg)
        jd = {k: _spc("jax")[k] - jb[k] for k in SPC_NAMES}
        td = {k: _spc("torch")[k] - tb[k] for k in SPC_NAMES}
        assert td == jd
        assert list(tout) == sorted(g)
        for k in g:
            a, b = _np(tout[k]), _np(jout[k])
            assert a.shape == b.shape and a.dtype == b.dtype
            if ints:
                assert a.tobytes() == b.tobytes()
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert tdp.shard_batch({"x": torch.arange(12)}, 4)["x"].tolist() == \
        [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11]]


@pytest.mark.parametrize("n", [3, 8])
def test_allreduce_pytree_matches_jax(worlds, n):
    jw, tw = worlds
    g = _grads(n, [700, 701, 702, 5], 3, ints=True)
    jc, tc = _sub(jw, n), _sub(tw, n)
    jb, tb = _spc("jax"), _spc("torch")
    jout = jbkt.allreduce_pytree(jc, {k: jc.put_rank_major(v)
                                      for k, v in g.items()},
                                 bucket_bytes=4096)
    tout = tbkt.allreduce_pytree(tc, {k: torch.from_numpy(v)
                                      for k, v in g.items()},
                                 bucket_bytes=4096)
    assert {k: _spc("torch")[k] - tb[k] for k in SPC_NAMES} == \
        {k: _spc("jax")[k] - jb[k] for k in SPC_NAMES}
    for k in g:
        assert _np(tout[k]).tobytes() == _np(jout[k]).tobytes()
    with pytest.raises(ValueError):
        tbkt.allreduce_pytree(tc, {"a": torch.zeros(n + 1)})


def test_error_feedback_under_quant_wire(worlds):
    jw, tw = worlds
    n = 8
    g = _grads(n, [4000, 4001, 4002], 4)
    for cfg in (jconfig, tconfig):
        cfg.set("coll_quant_enable", True)
        cfg.set("coll_quant_min_bytes", 1 << 10)
        cfg.set("coll_quant_error_feedback", True)
    try:
        assert tquant.ErrorFeedback.enabled_by_config() == \
            jquant.ErrorFeedback.enabled_by_config() is True
        jc, tc = _sub(jw, n).dup(), _sub(tw, n).dup()
        jbank, tbank = {}, {}
        for step in range(2):
            jb = JSPC.counter("coll_allreduce_algo_quant_ring").value
            tb = TSPC.read("coll_allreduce_algo_quant_ring")
            jout = jbkt.allreduce_pytree(
                jc, {k: jc.put_rank_major(v) for k, v in g.items()},
                error_feedback=jbank, bucket_bytes=16 << 10)
            tout = tbkt.allreduce_pytree(
                tc, {k: torch.from_numpy(v) for k, v in g.items()},
                error_feedback=tbank, bucket_bytes=16 << 10)
            assert TSPC.read("coll_allreduce_algo_quant_ring") - tb == \
                JSPC.counter("coll_allreduce_algo_quant_ring").value - jb
            assert sorted(tbank) == sorted(jbank)
            for bi in tbank:
                np.testing.assert_allclose(
                    tbank[bi].residual_norm(), jbank[bi].residual_norm(),
                    rtol=1e-3)
            for k in g:
                # the wire image of the compensated input, then the
                # int8 ring: the residual plus the ring's bound
                exact = g[k].astype(np.float64).sum(0)
                bound = tquant.analytic_error_bound(
                    torch.from_numpy(g[k])).numpy()
                for out in (_np(tout[k]), _np(jout[k])):
                    err = np.abs(out - exact[None])
                    assert (err <= 2 * bound[None] + 1e-3).all()
    finally:
        for cfg in (jconfig, tconfig):
            cfg.set("coll_quant_enable", False)
            cfg.set("coll_quant_min_bytes", 64 << 10)
            cfg.set("coll_quant_error_feedback", False)
    assert tquant.ErrorFeedback.enabled_by_config() is False
