"""The port's main path (``ompi_tpu_torch``: init -> Communicator -> coll
vtable -> allreduce) against the JAX package's, on the CPU.

- TunedColl with ``coll_tuned_allreduce_algorithm`` forcing each
  hand-kernel name runs in both packages on the same numpy inputs.
  Tolerance: exact (the same kernels' schedules; see
  test_torch_pallas_ring.py for why they agree bit for bit).
- The decision layer (forced > non-commutative guard > priors) picks
  the same names as the JAX package's for the same inputs.
- The native route is PyTorch's reduction over the rank axis where the
  JAX package uses XLA's: max/min and int32 sums are exact, float sums
  are held to 1e-6 relative (the two libraries sum in different orders).
- The rank-ordered gather-reduce taken by a non-commutative op is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch
from ompi_tpu import ops as jops
from ompi_tpu.coll import tuned as jtuned
from ompi_tpu.core import config as jconfig
from ompi_tpu_torch import ops as tops
from ompi_tpu_torch.coll import tuned as ttuned
from ompi_tpu_torch.core import config as tconfig
from ompi_tpu_torch.core import counters, device
from ompi_tpu_torch.core.errors import (ArgumentError, CommError,
                                        NotInitializedError)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "int32": torch.int32}


@pytest.fixture(scope="module")
def worlds():
    jworld = ompi_tpu.init()
    tworld = ompi_tpu_torch.init(device="cpu")
    try:
        yield jworld, tworld
    finally:
        ompi_tpu_torch.finalize()


def _input(n, elems, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-1000, 1000, (n, elems)).astype(np.int32)
    return rng.standard_normal((n, elems)).astype(np.float32)


def _f64(t):
    if isinstance(t, torch.Tensor):
        return t.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(t, jnp.float32)).astype(np.float64)


def _sub(world, n):
    if n == world.size:
        return world.dup()
    return world.split([0 if r < n else -1 for r in range(world.size)])[0]


def _set_both(values: dict) -> dict:
    old = {k: (jconfig.get(k), tconfig.get(k)) for k in values}
    for k, v in values.items():
        jconfig.VARS.set(k, v)
        tconfig.VARS.set(k, v)
    return old


def _restore(old: dict) -> None:
    for k, (j, t) in old.items():
        jconfig.VARS.set(k, j)
        tconfig.VARS.set(k, t)


# ---------------------------------------------------------------------------
# init / communicators
# ---------------------------------------------------------------------------

def test_init_world_and_vtable(worlds):
    _, tw = worlds
    assert tw.size == 8 and tw.device == torch.device("cpu")
    assert ompi_tpu_torch.init(device="cpu") is tw  # idempotent
    assert ompi_tpu_torch.world() is tw
    with pytest.raises(NotInitializedError):
        ompi_tpu_torch.init(4, device="cpu")  # another size: finalize first
    assert tw._coll["allreduce"][0].NAME == "tuned"


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NotInitializedError):
        device.resolve_device(None)
    with pytest.raises(NotInitializedError):
        device.resolve_device("cuda")
    assert device.resolve_device("cpu") == torch.device("cpu")


def test_dup_split_and_selection_vars(worlds):
    _, tw = worlds
    d = tw.dup()
    assert d.cid != tw.cid and d.parent_cid == tw.cid and d.size == 8
    parts = tw.split([r % 3 for r in range(8)], keys=list(range(8))[::-1])
    assert sorted(parts) == [0, 1, 2]
    assert parts[0].group.world_ranks == (6, 3, 0)  # key order
    assert tw.split([-1] * 7 + [0])[0].size == 1
    with pytest.raises(ArgumentError):
        tw.split([0, 1])
    tconfig.VARS.set("coll_pallas_priority", 100)
    try:
        assert tw.dup()._coll["allreduce"][0].NAME == "pallas"
    finally:
        tconfig.VARS.set("coll_pallas_priority", 30)
    tconfig.VARS.set("coll_select", "xla")
    try:
        assert tw.dup()._coll["allreduce"][0].NAME == "xla"
    finally:
        tconfig.VARS.set("coll_select", "")


def test_argument_and_lifetime_errors(worlds):
    _, tw = worlds
    c = tw.dup()
    with pytest.raises(ArgumentError):
        c.allreduce(torch.ones(3, 4))
    with pytest.raises(ArgumentError):
        c.allreduce(np.ones((8, 4), np.float32))  # not a tensor
    with pytest.raises(ArgumentError):
        c.put_rank_major(np.ones((3, 4)))
    c.free()
    with pytest.raises(CommError):
        c.allreduce(torch.ones(8, 4))


def test_size_one_comm_is_identity(worlds):
    _, tw = worlds
    solo = tw.split([0] + [-1] * 7)[0]
    x = solo.put_rank_major(np.arange(5, dtype=np.float32)[None])
    assert torch.equal(solo.allreduce(x), x)


# ---------------------------------------------------------------------------
# Decision layer parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefer_native", [True, False])
def test_decide_allreduce_matches_jax(prefer_native):
    old = _set_both({"coll_tuned_prefer_native": prefer_native})
    try:
        user_j = jops.create_op(lambda a, b: a - b, commutative=False)
        user_t = tops.create_op(lambda a, b: a - b, commutative=False)
        for name in ("sum", "max", "prod", "maxloc"):
            for nbytes in (4, 9_999, 10_000, 1 << 20, (1 << 20) + 1,
                           1 << 30):
                for nranks in (2, 3, 8):
                    want = jtuned.decide_allreduce(
                        jops.lookup(name), nbytes, nranks, "float32")
                    got = ttuned.decide_allreduce(
                        tops.lookup(name), nbytes, nranks, torch.float32)
                    assert got == want, (name, nbytes, nranks)
        assert ttuned.decide_allreduce(user_t, 64, 4) == \
            jtuned.decide_allreduce(user_j, 64, 4) == "gather_reduce"
        old2 = _set_both({"coll_tuned_allreduce_algorithm": "pallas_ring"})
        try:
            assert ttuned.decide_allreduce(user_t, 64, 4) == "pallas_ring"
        finally:
            _restore(old2)
    finally:
        _restore(old)


# ---------------------------------------------------------------------------
# TunedColl forced onto the hand kernels: parity with the JAX package
# ---------------------------------------------------------------------------

# (n, forced algorithm name, op, dtype, elems per rank, vars)
TUNED_CASES = [
    (4, "pallas_rd", "sum", "bfloat16", 50, {}),
    (3, "pallas_rd", "sum", "float32", 100, {}),  # non-pof2 -> ring
    (2, "pallas_ring", "min", "float32", 77, {}),
    (4, "pallas_ring_chunked", "sum", "int32", 3000,
     {"coll_pallas_segment_bytes": 4096}),
    (8, "pallas_ring", "max", "bfloat16", 200, {}),
]


@pytest.mark.parametrize("n,algo,op,dtype,elems,vars_", TUNED_CASES,
                         ids=[f"n{c[0]}-{c[1]}-{c[2]}-{c[3]}"
                              for c in TUNED_CASES])
def test_tuned_forced_kernel_matches_jax(worlds, n, algo, op, dtype, elems,
                                         vars_):
    jw, tw = worlds
    old = _set_both(dict(vars_, coll_tuned_allreduce_algorithm=algo))
    try:
        jc, tc = _sub(jw, n), _sub(tw, n)
        assert tc._coll["allreduce"][0].NAME == "tuned"
        x = _input(n, elems, dtype, seed=50 + n + elems)
        j = _f64(jc.allreduce(jc.put_rank_major(jnp.asarray(x, JDT[dtype])),
                              op))
        t = _f64(tc.allreduce(tc.put_rank_major(
            torch.from_numpy(x).to(TDT[dtype])), op))
        # the JAX package really ran the forced tier (its breaker would
        # otherwise have degraded silently to another algorithm)
        assert any(k[1] == algo for k in jc._plan_cache
                   if k[0] == "allreduce"), list(jc._plan_cache)
        assert any(k[1] == algo for k in tc._plan_cache), \
            list(tc._plan_cache)
        np.testing.assert_array_equal(t, j)
    finally:
        _restore(old)


def test_tuned_unknown_forced_algorithm_raises(worlds):
    _, tw = worlds
    tconfig.VARS.set("coll_tuned_allreduce_algorithm", "no_such_algo")
    try:
        with pytest.raises(ArgumentError):
            tw.dup().allreduce(torch.ones(8, 4))
    finally:
        tconfig.VARS.set("coll_tuned_allreduce_algorithm", "")


# ---------------------------------------------------------------------------
# Native and gather-reduce routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op,dtype", [("sum", "float32"), ("max", "float32"),
                                      ("min", "bfloat16"), ("sum", "int32")])
def test_native_route_matches_reduction(worlds, op, dtype):
    _, tw = worlds
    c = tw.dup()
    x = _input(8, 301, dtype, seed=3)
    out = c.allreduce(c.put_rank_major(torch.from_numpy(x).to(TDT[dtype])), op)
    assert any(k[1] == "native" for k in c._plan_cache)
    ref = {"sum": x.astype(np.float64).sum(0), "max": x.max(0),
           "min": _f64(torch.from_numpy(x).to(TDT[dtype])).min(0)}[op]
    got = _f64(out)
    assert (got == got[:1]).all()
    if op == "sum" and dtype == "float32":
        # PyTorch and XLA sum in different orders: float32 round-off.
        np.testing.assert_allclose(got[0], ref, rtol=1e-6, atol=1e-5)
    else:
        np.testing.assert_array_equal(got[0], np.asarray(ref, np.float64))


def test_noncommutative_op_takes_ordered_gather_reduce(worlds):
    jw, tw = worlds
    n = 8
    x = _input(n, 45, "float32", seed=11)
    jop = jops.create_op(lambda a, b: a * 0.5 - b, commutative=False)
    top = tops.create_op(lambda a, b: a * 0.5 - b, commutative=False)
    jc, tc = jw.dup(), tw.dup()
    j = _f64(jc.allreduce(jc.put_rank_major(x), jop))
    t = _f64(tc.allreduce(tc.put_rank_major(torch.from_numpy(x)), top))
    assert any(k[1] == "gather_reduce" for k in tc._plan_cache)
    np.testing.assert_array_equal(t, j)


def test_joint_op_pair_goes_through_gather_reduce_like_jax(worlds):
    jw, tw = worlds
    rng = np.random.default_rng(12)
    vals = rng.integers(0, 5, (8, 16)).astype(np.float32)
    idx = rng.integers(0, 100, (8, 16)).astype(np.int32)
    jc, tc = jw.dup(), tw.dup()
    jv, ji = jc.allreduce((jc.put_rank_major(vals), jc.put_rank_major(idx)),
                          "maxloc")
    before = counters.SPC.read("coll_allreduce_calls")
    tv, ti = tc.allreduce((tc.put_rank_major(torch.from_numpy(vals)),
                           tc.put_rank_major(torch.from_numpy(idx))),
                          "maxloc")
    assert counters.SPC.read("coll_allreduce_calls") == before + 1
    assert any(k[1] == "gather_reduce" for k in tc._plan_cache)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
