"""The decision layer's host tier and dispatch memo
(``ompi_tpu_torch/coll/tuned.py``: ``TunedColl._fast_allreduce``,
``_build_fast_allreduce``, ``_host_plan``) against the JAX package's,
on the CPU.

- Parity, bitwise: both packages' default ``comm.allreduce`` (TunedColl,
  no forced name, no rules file) on the same numpy inputs. At or below
  ``coll_tuned_host_small_max_bytes`` (4096 B of the whole rank-major
  buffer) both reduce on the host: numpy's ``ufunc.reduce`` over the
  rank axis, whose float32 add-reduce is pairwise where the rank axis is
  the innermost loop (``(n,)`` and ``(n, 1)`` at n = 8) and a rank-order
  fold otherwise; bfloat16 folds in rank order, rounding at every step;
  an int32 sum past 2**31 wraps. Cases at n = 3 and 8: bfloat16 SUM and
  float32 PROD at ``(n, 64)``, float32 SUM and PROD at ``(n,)`` and
  ``(n, 1)``, int32 SUM, MAX and MIN. The same cases with the limit at
  0 take the device route in both packages and must agree there too.
- The threshold: at n = 8 float32, 128 elements per rank (4096 B) take
  the host tier and 129 (4128 B) do not, read off the SPC counter
  ``coll_allreduce_algo_host`` in both packages.
- The memo: a repeat call reuses the plan; a config change
  (``host_small_max_bytes=0``) or a winner-cache ``put`` changes the
  stamp and rebuilds it; a forced algorithm or a rules file bypasses
  the host tier.
"""

import json

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch
from ompi_tpu.core import config as jconfig
from ompi_tpu.core.counters import SPC as JSPC
from ompi_tpu_torch.coll import tuned as ttuned
from ompi_tpu_torch.coll.sched import cache as tcache
from ompi_tpu_torch.core import config as tconfig
from ompi_tpu_torch.core.counters import SPC

HOST = "coll_allreduce_algo_host"
LIMIT = "coll_tuned_host_small_max_bytes"
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "int32": torch.int32}

# (per-rank shape, dtype, op, scale of the standard normal values): every
# buffer is at most 4096 B at n = 8.
CASES = [
    ((64,), "bfloat16", "sum", 1.0),
    ((64,), "float32", "prod", 1.0),
    ((), "float32", "sum", 1e3),
    ((), "float32", "prod", 10.0),
    ((1,), "float32", "sum", 1e3),
    ((1,), "float32", "prod", 10.0),
    ((16,), "int32", "sum", 0.0),
    ((33,), "float32", "max", 1.0),
    ((33,), "bfloat16", "min", 1.0),
]
IDS = [f"{d}-{op}-{s}" for s, d, op, _ in CASES]


@pytest.fixture(scope="module")
def worlds():
    jworld = ompi_tpu.init()
    tworld = ompi_tpu_torch.init(device="cpu")
    try:
        yield jworld, tworld
    finally:
        ompi_tpu_torch.finalize()


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


def _sub(world, n):
    if n == world.size:
        return world.dup()
    return world.split([0 if r < n else -1 for r in range(world.size)])[0]


def _data(n, shape, dtype, scale, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int32":  # rank sums past 2**31: the sum wraps
        return rng.integers(2**30, 2**31 - 1, (n,) + shape).astype(np.int32)
    return (rng.standard_normal((n,) + shape) * scale).astype(np.float32)


def _bits(t) -> np.ndarray:
    """The result's bits as unsigned integers (bfloat16 through
    ml_dtypes on the JAX side)."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy().view(np.uint32)
    a = np.asarray(t)
    return a.view(np.uint16 if a.dtype == ml_dtypes.bfloat16 else np.uint32)


def _both(worlds, n, x, dtype, op):
    """(JAX bits, port bits, port result) of both packages' default
    ``comm.allreduce`` on fresh communicators of n ranks."""
    jc, tc = _sub(worlds[0], n), _sub(worlds[1], n)
    j = jc.allreduce(jc.put_rank_major(jnp.asarray(x, JDT[dtype])), op)
    t = tc.allreduce(tc.put_rank_major(torch.from_numpy(x).to(TDT[dtype])),
                     op)
    return _bits(j), _bits(t), t


def _host_counts():
    return JSPC.counter(HOST).read(), SPC.read(HOST)


@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("shape,dtype,op,scale", CASES, ids=IDS)
def test_default_allreduce_is_bitwise_jax_package(worlds, n, shape, dtype, op,
                                                  scale):
    x = _data(n, shape, dtype, scale, seed=n * 31 + CASES.index(
        (shape, dtype, op, scale)))
    for limit in (4096, 0):
        before = _host_counts()
        with both_vars({LIMIT: limit}):
            j, t, out = _both(worlds, n, x, dtype, op)
        taken = [a - b for a, b in zip(_host_counts(), before)]
        assert taken == ([1, 1] if limit else [0, 0]), (limit, taken)
        assert out.shape == x.shape and out.dtype == TDT[dtype]
        np.testing.assert_array_equal(t, j, err_msg=f"limit={limit}")


def test_host_float32_sum_is_numpy_pairwise_at_one_element_per_rank(worlds):
    """At (8,) the host result is numpy's pairwise sum
    ((a0+a1)+(a2+a3))+((a4+a5)+(a6+a7)), which a rank-order fold misses on
    some of these seeds."""
    folded_differs = 0
    for seed in range(40):
        x = _data(8, (), "float32", 1e3, seed)
        a = [np.float32(v) for v in x]
        pairwise = ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5])
                                                      + (a[6] + a[7]))
        fold = a[0]
        for v in a[1:]:
            fold = np.float32(fold + v)
        _, _, out = _both(worlds, 8, x, "float32", "sum")
        assert (out.numpy() == pairwise).all(), seed
        folded_differs += fold != pairwise
    assert folded_differs, "no seed told the pairwise sum from a fold"


def test_host_bfloat16_sum_rounds_at_every_step(worlds):
    """The bfloat16 host sum is the rank-order fold rounded to bfloat16
    after every add, not a float32 sum rounded once."""
    x = _data(8, (64,), "bfloat16", 1.0, seed=5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    acc = xb[0].float()
    for i in range(1, 8):
        acc = (acc + xb[i].float()).to(torch.bfloat16).float()
    _, _, out = _both(worlds, 8, x, "bfloat16", "sum")
    assert torch.equal(out[0].float(), acc)
    once = xb.float().sum(0).to(torch.bfloat16).float()
    assert not torch.equal(acc, once), "the seed does not tell them apart"


@pytest.mark.parametrize("elems,host", [(128, True), (129, False)])
def test_host_tier_threshold_counts_the_whole_buffer(worlds, elems, host):
    """n = 8 float32: 128 elements per rank are 4096 B in all (host),
    129 are 4128 B (the device route) in both packages."""
    x = _data(8, (elems,), "float32", 1.0, seed=elems)
    for op in ("sum", "max"):
        before = _host_counts()
        j, t, _ = _both(worlds, 8, x, "float32", op)
        taken = [a - b for a, b in zip(_host_counts(), before)]
        assert taken == ([1, 1] if host else [0, 0]), (op, taken)
        if host or op == "max":
            # the device route's float32 sum is PyTorch's order there
            np.testing.assert_array_equal(t, j, err_msg=op)


def test_memo_repeat_call_reuses_the_plan(worlds):
    comm = worlds[1].dup()
    x = torch.from_numpy(_data(8, (4,), "float32", 1.0, seed=1))
    before = SPC.read(HOST)
    first = comm.allreduce(x, "sum")
    (key, (stamp, plan)), = comm._tuned_fast.items()
    assert key == ((8, 4), torch.float32, ttuned.op_lookup("sum").cache_key)
    for _ in range(3):
        assert torch.equal(comm.allreduce(x, "sum"), first)
    assert comm._tuned_fast[key] == (stamp, plan)
    assert SPC.read(HOST) == before + 1  # the plan was built once


def test_memo_stamp_changes_on_config_and_winner_cache(worlds):
    comm = worlds[1].dup()
    x = torch.from_numpy(_data(8, (4,), "float32", 1.0, seed=2))
    comm.allreduce(x, "sum")
    (key, (stamp, _)), = comm._tuned_fast.items()
    host, native = SPC.read(HOST), SPC.read("coll_allreduce_algo_native")
    with both_vars({LIMIT: 0}):
        comm.allreduce(x, "sum")
        stamp0 = comm._tuned_fast[key][0]
        assert stamp0 != stamp
        assert SPC.read(HOST) == host
        assert SPC.read("coll_allreduce_algo_native") == native + 1
    saved = tcache.CACHE.entries()
    gen = tcache.CACHE.generation()
    try:
        tcache.CACHE.put("allreduce|b0|float32|r99|none", "native")
        assert tcache.CACHE.generation() == gen + 1
        comm.allreduce(x, "sum")
        stamp1 = comm._tuned_fast[key][0]
        assert stamp1 not in (stamp, stamp0)
        assert stamp1[1] == tcache.CACHE.generation()
        assert SPC.read(HOST) == host + 1  # rebuilt: the host tier again
    finally:
        with tcache.CACHE._mu:
            tcache.CACHE._entries.clear()
            tcache.CACHE._entries.update(saved)


def test_forced_algorithm_and_rules_file_bypass_the_host_tier(worlds,
                                                              tmp_path):
    x = _data(8, (16,), "float32", 1.0, seed=3)
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps(
        {"allreduce": [{"algorithm": "recursive_doubling"}]}))
    for values, algo in (
            ({"coll_tuned_allreduce_algorithm": "ring"}, "ring"),
            ({"coll_tuned_rules_file": str(rules)}, "recursive_doubling")):
        before = _host_counts()
        picked = SPC.read(f"coll_allreduce_algo_{algo}")
        with both_vars(values):
            j, t, _ = _both(worlds, 8, x, "float32", "max")
        assert _host_counts() == before, values
        assert SPC.read(f"coll_allreduce_algo_{algo}") == picked + 1
        np.testing.assert_array_equal(t, j)


def test_memo_off_runs_the_decision_pipeline_every_call(worlds):
    comm = worlds[1].dup()
    x = torch.from_numpy(_data(8, (4,), "float32", 1.0, seed=4))
    before = SPC.read(HOST)
    with both_vars({"coll_tuned_fast_dispatch_cache": False}):
        out = comm.allreduce(x, "max")
        comm.allreduce(x, "max")
    assert SPC.read(HOST) == before and "_tuned_fast" not in vars(comm)
    assert torch.equal(out, x.amax(0).expand_as(x))
