"""The flagship model and its parallel strategies (``parallel/
{mesh_utils,tp,pp,ep}``, ``models/transformer``) against the JAX
package's, on the CPU (mirrors ``tests/test_parallel_model.py``).

- ``factorize``, ``make_mesh``'s rank order and its wrong-count error
  against the JAX functions.
- ``tp_mlp``, ``pipeline`` (with ``broadcast_from_last``),
  ``moe_dispatch_combine`` (generous capacity, and a capacity that
  drops tokens: the JAX package drops an out-of-range scatter and clamps
  an out-of-range gather) and ``aux_load_balance_loss`` against the JAX
  functions under ``shard_map``, rtol/atol 1e-5.
- The flagship at dp2·pp2·tp2 with the JAX package's parameters carried
  across (``params_from_jax``): the forward loss within rtol 1e-5, atol
  1e-6; one training step's loss and every updated parameter within
  rtol 1e-4, atol 1e-6; the second step's loss within rtol 1e-4. Top-1
  routing is discontinuous, so the MoE layers' inputs are checked to
  keep every token's top-1 router margin above 1e-4: a last-bit
  difference cannot flip an expert.
- The port's forward with ``parallel_sp_impl=pallas`` (the kernel's
  plain version on the CPU) against ``xla``, one ring attention per
  layer per pipeline tick, and the dense family (``moe_every=0``)
  training with its loss falling.

One JAX compile per function is shared through module-scoped fixtures.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from ompi_tpu.models import transformer as JT
from ompi_tpu.parallel import ep as jep
from ompi_tpu.parallel import mesh_utils as jmesh
from ompi_tpu.parallel import pp as jpp
from ompi_tpu.parallel import tp as jtp
from ompi_tpu_torch.core import config as tconfig
from ompi_tpu_torch.core.errors import ArgumentError
from ompi_tpu_torch.models import transformer as TT
from ompi_tpu_torch.parallel import ep as tep
from ompi_tpu_torch.parallel import mesh_utils as tmesh
from ompi_tpu_torch.parallel import pp as tpp
from ompi_tpu_torch.parallel import sp as tsp
from ompi_tpu_torch.parallel import tp as ttp

TOL = dict(rtol=1e-5, atol=1e-5)


def spmd_run(fn, n, *arrays, axis="x"):
    """fn(per-rank slices...) under shard_map on n devices."""
    mesh = JMesh(np.array(jax.devices()[:n]), (axis,))

    def wrapped(*blocks):
        out = fn(*[b[0] for b in blocks])
        return jax.tree.map(lambda r: r[None], out)

    return np.asarray(jax.jit(jax.shard_map(
        wrapped, mesh=mesh, in_specs=tuple(P(axis) for _ in arrays),
        out_specs=P(axis)))(*arrays))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- mesh_utils --------------------------------------------------------------

def test_factorize_matches_jax():
    for n in range(1, 33):
        for axes in range(1, 5):
            assert tmesh.factorize(n, axes) == jmesh.factorize(n, axes)


@pytest.mark.parametrize("sizes", [{"dp": 2, "pp": 2, "tp": 2},
                                   {"dp": 1, "pp": 2, "tp": 4},
                                   {"a": 4, "b": 2}])
def test_make_mesh_rank_order_matches_jax(sizes):
    """Rank r sits where the JAX mesh puts device r."""
    jm = jmesh.make_mesh(sizes, jax.devices()[:8])
    tm = tmesh.make_mesh(sizes, 8, device="cpu")
    assert tm.shape == dict(jm.shape)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r, c in enumerate(tm.coords().tolist()):
        assert ids[tuple(c)] == r
    for name in sizes:
        ax = tm.axis(name)
        assert ax.size == jm.shape[name]
        assert ax.index().tolist() == [c[tm.axis_names.index(name)]
                                       for c in tm.coords().tolist()]


def test_make_mesh_wrong_count_raises():
    from ompi_tpu.core.errors import ArgumentError as JArgumentError

    with pytest.raises(JArgumentError):
        jmesh.make_mesh({"a": 3, "b": 5})
    with pytest.raises(ArgumentError):
        tmesh.make_mesh({"a": 3, "b": 5}, 8, device="cpu")
    assert tmesh.auto_mesh(8, ("dp", "pp", "tp"), "cpu").shape == \
        dict(jmesh.auto_mesh(8, ("dp", "pp", "tp")).shape)


def test_axis_collective_acts_on_its_axis_alone():
    """An allgather over tp of a (dp, pp, tp) mesh: rank (d, p, t) gets
    the rows of the ranks (d, p, *)."""
    from ompi_tpu_torch.coll import spmd

    mesh = tmesh.make_mesh({"dp": 2, "pp": 2, "tp": 2}, device="cpu")
    x = torch.arange(8.0)[:, None].repeat(1, 3)
    got = mesh.axis("tp").apply(spmd.allgather_native, x, 0, 1)
    for r in range(8):
        assert got[r, :, 0].tolist() == [float(r - r % 2), float(r - r % 2
                                                                 + 1)]
    got = mesh.axis("dp").apply(spmd.allgather_native, x, 0, 1)
    for r in range(8):
        assert got[r, :, 0].tolist() == [float(r % 4), float(r % 4 + 4)]


# -- the strategies ----------------------------------------------------------

def test_tp_mlp_matches_jax():
    n, S, D, F = 4, 8, 16, 32
    rng = np.random.default_rng(1)
    x = rng.standard_normal((S, D)).astype(np.float32)
    w1 = rng.standard_normal((D, F)).astype(np.float32)
    w2 = rng.standard_normal((F, D)).astype(np.float32)
    xb = x.reshape(n, S // n, D)
    w1b = np.ascontiguousarray(w1.reshape(D, n, F // n).transpose(1, 0, 2))
    w2b = w2.reshape(n, F // n, D)
    want = spmd_run(lambda xs, a, b: jtp.tp_mlp(xs, a, b, "x"), n, xb, w1b,
                    w2b)
    got = ttp.tp_mlp(t(xb), t(w1b), t(w2b))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # jax.nn.gelu's default is the tanh approximation
    np.testing.assert_allclose(
        ttp.gelu(t(x)).numpy(), np.asarray(jax.nn.gelu(x)), **TOL)


def test_pipeline_matches_jax():
    n, M, D = 4, 3, 8
    rng = np.random.default_rng(2)
    ws = rng.standard_normal((n, D, D)).astype(np.float32) * 0.3
    micro = rng.standard_normal((M, 2, D)).astype(np.float32)

    def run(w_stage, mb):
        outs = jpp.pipeline(lambda w, x: jnp.tanh(x @ w), w_stage, mb,
                            axis_name="x")
        return jpp.broadcast_from_last(outs, "x")

    mesh = JMesh(np.array(jax.devices()[:n]), ("x",))
    want = np.asarray(jax.jit(jax.shard_map(
        lambda w, mb: run(w[0], mb), mesh=mesh, in_specs=(P("x"), P()),
        out_specs=P()))(jnp.asarray(ws), jnp.asarray(micro)))
    mb_rm = t(micro).unsqueeze(0).expand(n, M, 2, D).contiguous()
    outs = tpp.pipeline(lambda w, x: torch.tanh(ttp.matmul(x, w)), t(ws),
                        mb_rm)
    # valid on the last stage only, zeros elsewhere
    assert not outs[:n - 1].any()
    got = tpp.broadcast_from_last(outs)
    for r in range(n):
        np.testing.assert_allclose(got[r].numpy(), want, **TOL)
    # every rank holds all n stages' params: each keeps its own
    stacked = t(np.broadcast_to(ws, (n, n, D, D)))
    assert torch.equal(tpp.stage_slice(stacked), t(ws))


def _moe_inputs(seed, n=4, T_=6, D=8, E_local=2):
    rng = np.random.default_rng(seed)
    E = n * E_local
    x = rng.standard_normal((n, T_, D)).astype(np.float32)
    router = rng.standard_normal((D, E)).astype(np.float32)
    we1 = (rng.standard_normal((E, D, D)) * 0.3).astype(np.float32)
    we2 = (rng.standard_normal((E, D, D)) * 0.3).astype(np.float32)
    return x, router, we1.reshape(n, E_local, D, D), \
        we2.reshape(n, E_local, D, D)


def top1_margin(logits: torch.Tensor) -> float:
    """The smallest gap between a token's top two router probabilities."""
    top2 = torch.softmax(logits.double(), -1).topk(2, dim=-1).values
    return float((top2[..., 0] - top2[..., 1]).min())


@pytest.mark.parametrize("capacity", [8.0, 1.0])
def test_moe_dispatch_combine_matches_jax(capacity):
    """Generous capacity, and one that drops tokens (JAX drops the
    out-of-range scatter and clamps the gather; the port masks both)."""
    x, router, we1, we2 = _moe_inputs(3)
    n, T_, D = x.shape

    def jfn(xs, w1s, w2s):
        def expert_fn(e, toks):
            return jax.nn.gelu(toks @ w1s[e]) @ w2s[e]

        return jep.moe_dispatch_combine(xs, xs @ router, expert_fn, 2,
                                        axis_name="x",
                                        capacity_factor=capacity)

    want = spmd_run(jfn, n, x, we1, we2)
    tw1, tw2 = t(we1), t(we2)

    def expert_fn(e, toks):
        return ttp.matmul(ttp.gelu(ttp.matmul(toks, tw1[:, e])), tw2[:, e])

    logits = ttp.matmul(t(x), t(router).expand(n, D, -1).contiguous())
    assert top1_margin(logits) > 1e-4
    got = tep.moe_dispatch_combine(t(x), logits, expert_fn, 2,
                                   capacity_factor=capacity)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if capacity == 1.0:  # some tokens were dropped: zero rows
        assert (np.abs(want).sum(-1) == 0).any()


def test_aux_load_balance_loss_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((4, 6, 8)).astype(np.float32)
    want = spmd_run(lambda lg: jep.aux_load_balance_loss(lg, "x"), 4,
                    logits)
    got = tep.aux_load_balance_loss(t(logits))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# -- the flagship ------------------------------------------------------------

def _cfg(pkg, **kw):
    base = dict(vocab=32, d_model=16, n_heads=2, head_dim=8, d_ff=32,
                layers_per_stage=2, seq_len=16, n_experts=4, expert_ff=16,
                moe_every=2, capacity_factor=8.0, microbatches=2)
    base.update(kw)
    return pkg.ModelConfig(**base)


@pytest.fixture(scope="module")
def jax_flagship():
    """The JAX package at dp2·pp2·tp2: its global parameters, the forward
    loss, one step's loss and parameters, the second step's loss."""
    cfg = _cfg(JT)
    params = JT.init_params(jax.random.PRNGKey(0), cfg, pp_size=2)
    host = jax.tree.map(np.asarray, params)
    tokens, targets = JT.make_batch(cfg, batch=4)
    mesh = JT.demo_mesh(8)
    leaves, treedef = jax.tree.flatten(params)
    specs = jax.tree.leaves(JT.param_specs(cfg),
                            is_leaf=lambda s: isinstance(s, P))
    placed = jax.tree.unflatten(treedef, [
        jax.device_put(x, NamedSharding(mesh, s))
        for x, s in zip(leaves, specs)])
    fwd_loss = float(JT.build_forward(cfg, mesh)(placed, tokens, targets))
    step = JT.build_train_step(cfg, mesh)
    loss1, p1 = step(placed, tokens, targets)
    p1_host = jax.tree.map(np.asarray, p1)
    loss2, _ = step(p1, tokens, targets)
    return {"params": host, "fwd": fwd_loss, "loss1": float(loss1),
            "p1": p1_host, "loss2": float(loss2)}


@pytest.fixture
def mesh8():
    return TT.demo_mesh(8, device="cpu")


def _margins(monkeypatch):
    """Record the smallest top-1 router margin of every MoE layer call.
    A stage idle on its tick routes all-zero tokens, whose logits tie
    exactly (argmax takes the first in both packages): those tokens are
    checked to tie and left out."""
    seen = []
    orig = TT.ep_mod.moe_dispatch_combine

    def spy(x, logits, *a, **kw):
        live = x.detach().abs().amax(-1) > 0
        dead = logits.detach()[~live]
        assert torch.equal(dead, dead[..., :1].expand_as(dead))
        if live.any():
            seen.append(top1_margin(logits.detach()[live]))
        return orig(x, logits, *a, **kw)

    monkeypatch.setattr(TT.ep_mod, "moe_dispatch_combine", spy)
    return seen


def test_params_round_trip(jax_flagship, mesh8):
    cfg = _cfg(TT)
    pt = TT.params_from_jax(jax_flagship["params"], cfg, mesh8)
    assert pt["blocks"]["w1"].shape == (8, 2, 16, 16)  # d_ff over tp
    assert pt["blocks"]["we1"].shape == (8, 2, 2, 16, 16)  # experts over tp
    assert pt["embed"].shape == (8, 32, 16)  # replicated
    back = TT.gather_params(pt, cfg, mesh8)
    host = jax_flagship["params"]
    for k in ("embed", "pos", "head", "ln_f"):
        assert np.array_equal(back[k].numpy(), host[k])
    for k, v in host["blocks"].items():
        assert np.array_equal(back["blocks"][k].numpy(), v), k


def test_forward_matches_jax(jax_flagship, mesh8, monkeypatch):
    cfg = _cfg(TT)
    margins = _margins(monkeypatch)
    pt = TT.params_from_jax(jax_flagship["params"], cfg, mesh8)
    tokens, targets = TT.make_batch(cfg, batch=4)
    loss = float(TT.build_forward(cfg, mesh8)(pt, tokens, targets))
    np.testing.assert_allclose(loss, jax_flagship["fwd"], rtol=1e-5,
                               atol=1e-6)
    assert margins and min(margins) > 1e-4, margins


def test_train_steps_match_jax(jax_flagship, mesh8, monkeypatch):
    cfg = _cfg(TT)
    margins = _margins(monkeypatch)
    pt = TT.params_from_jax(jax_flagship["params"], cfg, mesh8)
    tokens, targets = TT.make_batch(cfg, batch=4)
    step = TT.build_train_step(cfg, mesh8)
    loss1, p1 = step(pt, tokens, targets)
    np.testing.assert_allclose(float(loss1), jax_flagship["loss1"],
                               rtol=1e-4, atol=1e-6)
    got = TT.gather_params(p1, cfg, mesh8)
    want = jax_flagship["p1"]
    for k in ("embed", "pos", "head", "ln_f"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for k, v in want["blocks"].items():
        np.testing.assert_allclose(got["blocks"][k].numpy(), v, rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    # every replica of a parameter took the same update
    for name, leaf in p1["blocks"].items():
        if name in TT._TP_REPLICATED:
            assert torch.equal(leaf[0::2], leaf[1::2]), name
    assert torch.equal(p1["embed"], p1["embed"][:1].expand_as(p1["embed"]))
    loss2, _ = step(p1, tokens, targets)
    np.testing.assert_allclose(float(loss2), jax_flagship["loss2"],
                               rtol=1e-4)
    assert margins and min(margins) > 1e-4, margins


def test_pallas_path_matches_xla(jax_flagship, mesh8, monkeypatch):
    """impl pallas (the fused kernel's plain version on the CPU) against
    xla: one ring attention per layer per tick, over the tp ring with
    dp, pp, the microbatch and the heads folded into its head axis."""
    cfg = _cfg(TT)
    pt = TT.params_from_jax(jax_flagship["params"], cfg, mesh8)
    tokens, targets = TT.make_batch(cfg, batch=4)
    fwd = TT.build_forward(cfg, mesh8)
    shapes = []
    orig = tsp.ring_attention

    def spy(q, k, v, causal=True, impl=None):
        shapes.append(tuple(q.shape))
        return orig(q, k, v, causal=causal, impl=impl)

    monkeypatch.setattr(TT.sp_mod, "ring_attention", spy)
    xla = float(fwd(pt, tokens, targets))
    tconfig.VARS.set("parallel_sp_impl", "pallas")
    try:
        fused = float(fwd(pt, tokens, targets))
    finally:
        tconfig.VARS.set("parallel_sp_impl", "xla")
    np.testing.assert_allclose(fused, xla, rtol=1e-5, atol=1e-6)
    # 2 layers x (M + P - 1 = 3) ticks a forward; (tp, T, dp pp mb H, Dh)
    assert shapes == [(2, 8, 2 * 2 * 1 * 2, 8)] * 12


def test_hidden_state_feeds_the_loss_on_either_path(jax_flagship, mesh8):
    """build_hidden's last pp stage, through the head, gives the forward's
    loss; the fused path's (its plain version on the CPU) is the xla
    path's."""
    cfg = _cfg(TT)
    pt = TT.params_from_jax(jax_flagship["params"], cfg, mesh8)
    tokens, targets = TT.make_batch(cfg, batch=4)
    hidden = TT.build_hidden(cfg, mesh8)
    h = hidden(pt, tokens)
    assert h.shape == (8, 2, 8, 16)  # (n, batch / dp, S / tp, D)
    last = TT.last_stage(mesh8)
    assert last.tolist() == [r // 2 % 2 == 1 for r in range(8)]
    tgt = TT._slice_tp(TT._rank_major_batch(targets, mesh8), mesh8, 8)
    logp = torch.log_softmax(TT.tp_mod.matmul(h, pt["head"]), dim=-1)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    loss = float(nll[last].sum()) / (4 * 16)  # every token once
    np.testing.assert_allclose(
        loss, float(TT.build_forward(cfg, mesh8)(pt, tokens, targets)),
        rtol=1e-6)
    tconfig.VARS.set("parallel_sp_impl", "pallas")
    try:
        fused = hidden(pt, tokens)
    finally:
        tconfig.VARS.set("parallel_sp_impl", "xla")
    np.testing.assert_allclose(fused[last].numpy(), h[last].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_dense_family_trains(mesh8):
    cfg = dataclasses.replace(_cfg(TT), moe_every=0)
    params = TT.sharded_init(cfg, mesh8)
    step = TT.build_train_step(cfg, mesh8)
    tokens, targets = TT.make_batch(cfg, batch=4)
    loss0, params = step(params, tokens, targets)
    loss1, params = step(params, tokens, targets)
    l0, l1 = float(loss0), float(loss1)
    assert np.isfinite(l0) and np.isfinite(l1)
    assert l1 < l0, (l0, l1)
