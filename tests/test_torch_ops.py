"""Parity of the port's reduction operators (``ompi_tpu_torch.ops``)
with the JAX package's (``ompi_tpu.ops``), and of the port's copies of
the JAX-free substrate (config vars, MCA components, groups).

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: exact. Both packages combine bfloat16 by computing in float32
and rounding once, and wrap int32 in two's complement, so every result
here is compared bit for bit.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ompi_tpu import ops as jops
from ompi_tpu.core import config as jconfig
from ompi_tpu_torch import ops as tops
from ompi_tpu_torch.core import component as tcomponent
from ompi_tpu_torch.core import config as tconfig
from ompi_tpu_torch.core.errors import (ComponentError, GroupError, OpError,
                                        RankError)
from ompi_tpu_torch.group import Group

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int32": (jnp.int32, torch.int32)}


def _inputs(dtype: str, seed: int, n: int = 257):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return [rng.integers(-5000, 5000, n).astype(np.int32)
                for _ in range(2)]
    a, b = (rng.standard_normal(n).astype(np.float32) * 3 for _ in range(2))
    a[:3] = [np.nan, 1.0, -0.5]  # NaN must propagate through max/min
    b[:3] = [2.0, np.nan, -0.5]
    return [a, b]


def _both(name: str, dtype: str, a: np.ndarray, b: np.ndarray):
    jdt, tdt = DTYPES[dtype]
    jout = jops.lookup(name).combine(jnp.asarray(a, jdt), jnp.asarray(b, jdt))
    tout = tops.lookup(name).combine(torch.from_numpy(a).to(tdt),
                                     torch.from_numpy(b).to(tdt))
    return (np.asarray(jnp.asarray(jout, jnp.float32)),
            tout.to(torch.float32).numpy())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["sum", "prod", "max", "min",
                                  "land", "lor", "lxor"])
def test_combine_matches_jax(name, dtype):
    a, b = _inputs(dtype, seed=zlib.crc32(f"{name}{dtype}".encode()))
    j, t = _both(name, dtype, a, b)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("name", ["band", "bor", "bxor"])
def test_bitwise_ops_int_only(name):
    a, b = _inputs("int32", seed=7)
    j, t = _both(name, "int32", a, b)
    np.testing.assert_array_equal(t, j)
    with pytest.raises(OpError):
        tops.lookup(name).combine(torch.ones(2), torch.ones(2))


def test_int32_sum_and_prod_wrap_like_jax():
    a = np.array([2**31 - 1, -2**31, 65536, 3], np.int32)
    b = np.array([1, -1, 65536, -7], np.int32)
    for name in ("sum", "prod"):
        j, t = _both(name, "int32", a, b)
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("name", ["maxloc", "minloc"])
def test_joint_ops_match_jax(name):
    rng = np.random.default_rng(3)
    av, bv = (rng.integers(0, 4, 64).astype(np.float32) for _ in range(2))
    ai, bi = (rng.integers(0, 8, 64).astype(np.int32) for _ in range(2))
    jv, ji = jops.lookup(name).combine((jnp.asarray(av), jnp.asarray(ai)),
                                       (jnp.asarray(bv), jnp.asarray(bi)))
    tv, ti = tops.lookup(name).combine(
        (torch.from_numpy(av), torch.from_numpy(ai)),
        (torch.from_numpy(bv), torch.from_numpy(bi)))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_op_table_matches_jax():
    assert sorted(tops.PREDEFINED) == sorted(jops.op.PREDEFINED)
    for name, jop in jops.op.PREDEFINED.items():
        top = tops.PREDEFINED[name]
        assert top.commutative == jop.commutative, name
        assert top.cache_key == jop.cache_key == name
        assert (top.native_reduce is None) == (jop.xla_reduce is None), name


@pytest.mark.parametrize("name", ["sum", "prod", "max", "min"])
def test_identity_matches_jax(name):
    x = np.zeros(5, np.float32)
    j = np.asarray(jops.lookup(name).identity_like(jnp.asarray(x)))
    t = tops.lookup(name).identity_like(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(t, j)


def test_lookup_and_user_ops():
    assert tops.lookup("SUM") is tops.SUM
    with pytest.raises(OpError):
        tops.lookup("bogus")
    user = tops.create_op(lambda a, b: a - b, commutative=False, name="sub")
    assert not user.commutative and user.cache_key.startswith("sub#")
    assert tops.lookup(user) is user
    with pytest.raises(OpError):
        user.identity_like(torch.zeros(1))


def test_config_vars_share_names_and_precedence(monkeypatch):
    monkeypatch.setenv("OMPITPU_MCA_test_torchport_knob", "7")
    jvar = jconfig.register("test", "torchport", "knob", type=int, default=1)
    tvar = tconfig.register("test", "torchport", "knob", type=int, default=1)
    assert tvar.full_name == jvar.full_name == "test_torchport_knob"
    assert tvar.value == jvar.value == 7  # ENV beats DEFAULT in both
    gen = tconfig.generation()
    tconfig.VARS.set("test_torchport_knob", 9)  # API beats ENV
    assert tconfig.get("test_torchport_knob") == 9
    assert tconfig.generation() > gen
    with pytest.raises(KeyError):
        tconfig.VARS.set("test_torchport_missing", 1)


def test_component_priority_selection_and_filter():
    fw = tcomponent.framework("torchtestfw")

    @fw.register
    class Low(tcomponent.Component):
        NAME = "low"
        PRIORITY = 10

    @fw.register
    class High(tcomponent.Component):
        NAME = "high"
        PRIORITY = 50

    assert fw.select_one().NAME == "high"
    assert [c.NAME for c in fw.select_all()] == ["high", "low"]
    tconfig.VARS.set("torchtestfw_low_priority", 99)
    assert fw.select_one().NAME == "low"
    tconfig.VARS.set("torchtestfw_select", "^low")
    assert fw.select_one().NAME == "high"
    tconfig.VARS.set("torchtestfw_select", "nosuch")
    with pytest.raises(ComponentError):
        fw.select_one()
    tconfig.VARS.set("torchtestfw_select", "")


def test_group_operations():
    g = Group([3, 1, 2])
    assert g.size == 3 and g.world_rank(0) == 3 and g.rank_of_world(2) == 2
    assert g.union(Group([5, 1])).world_ranks == (3, 1, 2, 5)
    assert g.intersection(Group([2, 3])).world_ranks == (3, 2)
    assert g.excl([0]).world_ranks == (1, 2)
    with pytest.raises(GroupError):
        Group([1, 1])
    with pytest.raises(RankError):
        g.world_rank(3)
