"""Entry points of the port (the twin of the JAX package's
``__graft_entry__.py``): a one-rank forward of the flagship model, and a
dry run of the full training step on n virtual ranks with the comm
vtable and the kernel tier.

Both run on ``cuda:0`` unless the caller passes ``device="cpu"`` (then
every kernel's plain version runs):

    from ompi_tpu_torch import graft_entry
    fn, args = graft_entry.entry()
    loss = fn(*args)
    graft_entry.dryrun_multichip(8)

The JAX dry run's spanning-communicator part (two controller processes,
``coll/hier`` over DCN) needs the fabric PML and the native engine,
which the port does not have yet (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _tiny_cfg(tp: int, pp: int, dp: int):
    from .models.transformer import ModelConfig

    return ModelConfig(
        vocab=64,
        d_model=32,
        n_heads=2,
        head_dim=16,
        d_ff=32 * tp,
        layers_per_stage=2,  # layer 0 dense TP MLP, layer 1 MoE
        seq_len=8 * max(tp, 1),
        n_experts=2 * tp,
        expert_ff=32,
        moe_every=2,
        capacity_factor=2.0,
        microbatches=2,
    )


def entry(device=None):
    """(fn, example_args): the forward step of the flagship model
    (3-D-parallel MoE transformer) on one rank; ``fn(*args)`` is the
    0-d loss."""
    from .models import transformer as T

    cfg = _tiny_cfg(tp=1, pp=1, dp=1)
    mesh = T.demo_mesh(1, device=device)
    params = T.sharded_init(cfg, mesh)
    fwd = T.build_forward(cfg, mesh)
    tokens, targets = T.make_batch(cfg, batch=4)
    return fwd, (params, tokens, targets)


def dryrun_multichip(n_devices: int, device=None) -> str:
    """Factorize n virtual ranks into a (dp, pp, tp) mesh, run the FULL
    training step (dp gradient sum through the bucketer, GPipe pipeline
    over pp, Megatron TP/SP + ring attention + MoE alltoall over tp)
    twice on tiny shapes, then one allreduce through the comm VTABLE and
    the kernel tier. Prints and returns one summary line."""
    import ompi_tpu_torch

    from .models import transformer as T
    from .parallel.mesh_utils import factorize

    dp, pp, tp = factorize(n_devices, 3)
    cfg = _tiny_cfg(tp=tp, pp=pp, dp=dp)
    mesh = T.demo_mesh(n_devices, device=device)
    params = T.sharded_init(cfg, mesh)
    step = T.build_train_step(cfg, mesh)
    batch = 2 * cfg.microbatches * dp
    tokens, targets = T.make_batch(cfg, batch=batch)
    loss, params = step(params, tokens, targets)
    loss = float(loss)
    assert math.isfinite(loss), f"non-finite loss {loss}"
    # A second step on the updated params.
    loss2 = float(step(params, tokens, targets)[0])
    assert math.isfinite(loss2), f"non-finite loss {loss2}"
    # Framework path, not only the model: one collective through the
    # comm VTABLE on this many ranks...
    world = ompi_tpu_torch.init(nranks=n_devices, device=mesh.device)
    out = world.allreduce(world.put_rank_major(
        np.ones((world.size, 8), np.float32)))
    assert bool(torch.all(out == world.size)), out[0]
    comp = type(world._coll["allreduce"][0]).__name__
    # ...and the kernel tier through the same vtable.
    pallas_msg = _dryrun_pallas_tier(world, mesh.device)
    line = (f"dryrun_multichip ok: mesh dp={dp} pp={pp} tp={tp}, "
            f"loss {loss:.4f} -> {loss2:.4f}; comm-vtable allreduce via "
            f"{comp}; pallas tier: {pallas_msg}; spanning comm: not ported "
            f"(ROADMAP Queue 1 item 8)")
    print(line)
    return line


def _dryrun_pallas_tier(world, device: torch.device) -> str:
    """The hand-written kernels on the n ranks (their plain versions on
    the CPU): a ring allreduce selected through the comm VTABLE
    (coll/pallas component), and the fused ring-attention kernel checked
    against the xla ring implementation."""
    from .core import config
    from .parallel import sp

    # 1. vtable-selected pallas allreduce (priority override, the
    # coll_base_comm_select.c:110-152 selection path)
    prior = config.VARS.get("coll_pallas_priority")
    config.VARS.set("coll_pallas_priority", 100)
    try:
        pworld = world.dup()
    finally:
        config.VARS.set("coll_pallas_priority", prior)
    try:
        pcomp = pworld._coll["allreduce"][0]
        assert pcomp.NAME == "pallas", pcomp.NAME
        rng = np.random.default_rng(0)
        pdata = rng.standard_normal((pworld.size, 33)).astype(np.float32)
        pout = pworld.allreduce(pworld.put_rank_major(pdata), "sum")
        np.testing.assert_allclose(
            pout.cpu().numpy(), np.broadcast_to(pdata.sum(0), pdata.shape),
            atol=1e-4, err_msg="pallas vtable allreduce mismatch")
    finally:
        pworld.free()

    # 2. fused ring-attention kernel over the same ranks
    n = world.size
    T_, H, Dh = 8, 2, 128
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((n, T_, H, Dh)).astype(
        np.float32)).to(device) for _ in range(3))
    fused = sp.ring_attention(q, k, v, impl="pallas")
    base = sp.ring_attention(q, k, v, impl="xla")
    np.testing.assert_allclose(fused.cpu().numpy(), base.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    return (f"allreduce via coll/pallas vtable (n={world.size}) + fused "
            f"ring-attention (n={n}) vs xla, on {device}")
