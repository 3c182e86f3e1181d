"""Flagship model: a 3-D-parallel MoE transformer LM built on the
port's collective substrate (port of ``ompi_tpu/models/transformer.py``).

This is the framework's "one model running end-to-end" (SURVEY §7 step 4
analog, extended to every §2.6 parallelism row):

- **dp**: batch sharded over the 'dp' mesh axis; gradients summed
  (parallel/dp, through the bucketer).
- **pp**: transformer blocks split into stages over 'pp'; activations
  hop stages by ring shifts in a GPipe schedule (parallel/pp).
- **tp**: Megatron column/row-sharded MLPs with sequence-parallel
  allgather / reduce_scatter transitions (parallel/tp).
- **sp**: the sequence dimension lives sharded over the 'tp' axis
  between blocks; attention is exact causal *ring attention* — KV blocks
  circulate the tp ring (parallel/sp).
- **ep**: alternating blocks use MoE MLPs whose experts are sharded over
  the same axis, dispatched by capacity-based all_to_all (parallel/ep).

Layout: every parameter and activation is one rank-major tensor per
leaf, ``(n, ...)`` viewed as ``(dp, pp, tp, ...)``: rank r = (d·pp +
p)·tp + t, the JAX mesh's row-major device order. A replicated leaf
holds one copy per rank. ``shard_params`` lays a global tree out so
(``param_specs`` says how), ``gather_params`` takes one back.

Attention folds dp, pp, the microbatch and the heads into one head
axis, so that each call is one ``sp.ring_attention`` over the tp ring
(one launch of the fused kernel under ``parallel_sp_impl=pallas``).

Gradient synchronization rules (encoded in `_sync_grads`):
- every param: summed over dp;
- tp-replicated params (attn, norms, router, embed/head): summed over
  tp (each tp rank saw only its sequence shard);
- tp-sharded params (MLP shards, experts): no tp sync — each rank owns
  its slice;
- stage-stacked params: no pp sync; embed/head/final-norm (used by one
  stage, stored replicated): summed over pp.

The JAX step differentiates each rank's local loss through the
collectives' transposes; the port differentiates the sum of the ranks'
local losses with respect to the rank-major parameters, the same
gradient (the transpose of an allgather is a reduce-scatter, of a ring
shift the reverse shift, of an alltoall an alltoall).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..coll import spmd
from ..core import tree as _tree
from ..ops import SUM
from ..parallel import dp as dp_mod
from ..parallel import ep as ep_mod
from ..parallel import overlap as overlap_mod
from ..parallel import pp as pp_mod
from ..parallel import sp as sp_mod
from ..parallel import tp as tp_mod
from ..parallel.mesh_utils import Mesh, factorize, make_mesh


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab: int = 256
    d_model: int = 64
    n_heads: int = 4
    head_dim: int = 16
    d_ff: int = 128
    layers_per_stage: int = 2
    seq_len: int = 64
    n_experts: int = 4  # total experts (0 = dense-only)
    expert_ff: int = 64
    moe_every: int = 2  # every k-th layer is MoE (0 = never)
    capacity_factor: float = 1.25
    microbatches: int = 2
    lr: float = 1e-2
    dtype: Any = torch.float32

    @property
    def qkv_dim(self) -> int:
        return self.n_heads * self.head_dim


# ---------------------------------------------------------------------------
# Parameter construction and layout
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: ModelConfig, pp_size: int,
                device: Optional[torch.device] = None) -> dict:
    """Global (unsharded) parameter tree; block params stacked over
    (stage, layer), drawn from ``generator`` (on its device unless
    ``device`` is given) in float32 and cast to ``cfg.dtype``."""
    device = generator.device if device is None else device
    D, V, S = cfg.d_model, cfg.vocab, cfg.seq_len
    L, Pn = cfg.layers_per_stage, pp_size
    QKV, F = cfg.qkv_dim, cfg.d_ff
    E, Fe = max(cfg.n_experts, 1), cfg.expert_ff

    def norm(*shape, scale=0.02):
        x = torch.randn(shape, generator=generator, device=device)
        return (x * scale).to(cfg.dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    return {
        "embed": norm(V, D),
        "pos": norm(S, D),
        "head": norm(D, V),
        "ln_f": ones(D),
        "blocks": {
            "ln1": ones(Pn, L, D),
            "wq": norm(Pn, L, D, QKV),
            "wk": norm(Pn, L, D, QKV),
            "wv": norm(Pn, L, D, QKV),
            "wo": norm(Pn, L, QKV, D),
            "ln2": ones(Pn, L, D),
            "w1": norm(Pn, L, D, F),
            "w2": norm(Pn, L, F, D),
            "router": norm(Pn, L, D, E),
            "we1": norm(Pn, L, E, D, Fe),
            "we2": norm(Pn, L, E, Fe, D),
        },
    }


def param_specs(cfg: ModelConfig) -> dict:
    """Per leaf, the mesh axis each dimension of the global leaf is
    sharded over (None: replicated), as the JAX package's
    PartitionSpecs: stage axis over 'pp'; Megatron shards over 'tp';
    experts sharded over 'tp' (= the ep axis)."""
    blocks = {name: ("pp",) for name in
              ("ln1", "wq", "wk", "wv", "wo", "ln2", "router")}
    blocks.update({
        "w1": ("pp", None, None, "tp"),
        "w2": ("pp", None, "tp", None),
        "we1": ("pp", None, "tp", None, None),
        "we2": ("pp", None, "tp", None, None),
    })
    return {"embed": (), "pos": (), "head": (), "ln_f": (),
            "blocks": blocks}


_TOP = ("embed", "pos", "head", "ln_f")


def _map_specs(fn, params: dict, cfg: ModelConfig) -> dict:
    """A tree of ``params``' structure holding ``fn(leaf, spec)``."""
    specs = param_specs(cfg)
    out = {k: fn(params[k], specs[k]) for k in _TOP}
    out["blocks"] = {k: fn(v, specs["blocks"][k])
                     for k, v in params["blocks"].items()}
    return out


def _shard_leaf(leaf: torch.Tensor, spec: tuple, mesh: Mesh,
                device: torch.device) -> torch.Tensor:
    """Rank r's piece of a global leaf, for every r: (n, ...)."""
    pieces = []
    for c in mesh.coords().tolist():
        at = dict(zip(mesh.axis_names, c))
        piece = leaf
        for dim, ax in enumerate(spec):
            if ax is not None:
                size = piece.shape[dim] // mesh.shape[ax]
                piece = piece.narrow(dim, at[ax] * size, size)
        if spec[:1] == ("pp",):  # each rank holds its own stage
            piece = piece[0]
        pieces.append(piece.to(device))
    return torch.stack(pieces)


def shard_params(params: dict, cfg: ModelConfig, mesh: Mesh,
                 device: Optional[torch.device] = None) -> dict:
    """A global tree (``init_params``'s) laid out rank-major by
    ``param_specs``: every leaf (n, ...) with each rank's piece, a
    replicated leaf copied to every rank, a 'pp'-stacked leaf's stage
    axis dropped (each rank holds its own stage)."""
    device = mesh.device if device is None else device
    return _map_specs(lambda leaf, spec: _shard_leaf(leaf, spec, mesh,
                                                     device), params, cfg)


def _gather_leaf(leaf: torch.Tensor, spec: tuple, mesh: Mesh
                 ) -> torch.Tensor:
    """The global leaf from its rank-major pieces (dp rank 0's)."""
    tp = mesh.shape["tp"]
    stages = spec[:1] == ("pp",)
    # rank (0, p, t) is p·tp + t; a piece has lost the stage axis
    tp_dims = [d - stages for d, ax in enumerate(spec) if ax == "tp"]
    per_stage = []
    for p in range(mesh.shape["pp"] if stages else 1):
        pieces = [leaf[p * tp + t] for t in range(tp if tp_dims else 1)]
        per_stage.append(torch.cat(pieces, tp_dims[0]) if tp_dims
                         else pieces[0])
    return torch.stack(per_stage) if stages else per_stage[0]


def gather_params(params: dict, cfg: ModelConfig, mesh: Mesh) -> dict:
    """The inverse of ``shard_params``: the global tree from rank-major
    leaves."""
    return _map_specs(lambda leaf, spec: _gather_leaf(leaf, spec, mesh),
                      params, cfg)


def params_from_jax(tree: dict, cfg: ModelConfig, mesh: Mesh,
                    device: Optional[torch.device] = None) -> dict:
    """The JAX package's global parameters (``init_params``' tree, its
    leaves as numpy arrays) in the port's rank-major layout."""
    device = mesh.device if device is None else device

    def conv(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=cfg.dtype)

    glob = {k: conv(tree[k]) for k in _TOP}
    glob["blocks"] = {k: conv(v) for k, v in tree["blocks"].items()}
    return shard_params(glob, cfg, mesh, device)


# Leaves whose gradients need a tp sum (saw only a sequence shard).
_TP_REPLICATED = {"ln1", "wq", "wk", "wv", "wo", "ln2", "router"}


# ---------------------------------------------------------------------------
# Model math (rank-major: every tensor's leading axis is the rank)
# ---------------------------------------------------------------------------

def _per_rank(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A rank-major (n, D) vector shaped to broadcast over (n, ..., D)."""
    return v.view((v.shape[0],) + (1,) * (like.ndim - 2) + (v.shape[-1],))


def _rmsnorm(x, scale):
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(var + 1e-6) * _per_rank(scale, x)


def _attention(x, wq, wk, wv, wo, cfg: ModelConfig, mesh: Mesh):
    """Ring attention over the tp axis; x is (n, B, T_local, D). The
    ranks of one tp ring differ in dp and pp, and the batch and heads
    are independent: all fold into the head axis, (n, B, T, H, Dh) ->
    (tp, T, dp·pp·B·H, Dh), so the whole layer is one ring attention
    over tp (global causal positions along the ring are unchanged)."""
    n, B, T, _ = x.shape
    H, Dh = cfg.n_heads, cfg.head_dim
    dims = mesh.dims  # (dp, pp, tp)
    g = n // dims[-1]

    def fold(w):
        h = tp_mod.matmul(x, w).reshape(g, dims[-1], B, T, H, Dh)
        return h.permute(1, 3, 0, 2, 4, 5).reshape(dims[-1], T, g * B * H,
                                                   Dh)

    attn = sp_mod.ring_attention(fold(wq), fold(wk), fold(wv), causal=True)
    attn = attn.reshape(dims[-1], T, g, B, H * Dh).permute(2, 0, 3, 1, 4)
    return tp_mod.matmul(attn.reshape(n, B, T, H * Dh), wo)


def _dense_mlp(x, w1, w2, mesh: Mesh):
    """Megatron TP MLP with sequence-parallel transitions; x (n,B,T,D)."""
    flat = x.reshape(x.shape[0], -1, x.shape[-1])  # (n, B*T_local, D)
    out = tp_mod.tp_mlp(flat, w1, w2, axis=mesh.axis("tp"))
    return out.reshape(x.shape)


def _moe_mlp(x, router, we1, we2, cfg: ModelConfig, mesh: Mesh):
    """Expert-parallel MoE over the tp(=ep) axis; x (n,B,T,D)."""
    n_local = we1.shape[1]  # experts each rank owns (E_total/ntp)
    flat = x.reshape(x.shape[0], -1, x.shape[-1])
    logits = tp_mod.matmul(flat, router)

    def expert_fn(e, toks):
        h = tp_mod.gelu(tp_mod.matmul(toks, we1[:, e]))
        return tp_mod.matmul(h, we2[:, e])

    out = ep_mod.moe_dispatch_combine(
        flat, logits, expert_fn, n_local, axis=mesh.axis("tp"),
        capacity_factor=cfg.capacity_factor)
    return out.reshape(x.shape)


def _block(x, bp, layer: int, cfg: ModelConfig, mesh: Mesh, use_moe: bool):
    def g(name):
        return bp[name][:, layer]

    h = x + _attention(_rmsnorm(x, g("ln1")), g("wq"), g("wk"), g("wv"),
                       g("wo"), cfg, mesh)
    norm2 = _rmsnorm(h, g("ln2"))
    if use_moe:
        return h + _moe_mlp(norm2, g("router"), g("we1"), g("we2"), cfg,
                            mesh)
    return h + _dense_mlp(norm2, g("w1"), g("w2"), mesh)


def _stage_fn(stage_blocks, x, cfg: ModelConfig, mesh: Mesh):
    """Apply each stage's layers_per_stage blocks to (n, B, T_local, D).

    Each block's input carries a grad_marker: its backward rule fires
    once every gradient inside the block has been produced, so the
    captured order is the true per-layer backprop tile schedule
    (parallel/overlap replays it for tile-granular Pready firing)."""
    for layer in range(cfg.layers_per_stage):
        use_moe = (cfg.n_experts > 0 and cfg.moe_every > 0
                   and (layer % cfg.moe_every) == (cfg.moe_every - 1))
        x = overlap_mod.grad_marker(x, f"blk{layer}")
        x = _block(x, stage_blocks, layer, cfg, mesh, use_moe)
    return x


# ---------------------------------------------------------------------------
# The training step
# ---------------------------------------------------------------------------

def _slice_tp(x: torch.Tensor, mesh: Mesh, T: int) -> torch.Tensor:
    """Each rank's sequence shard [t·T, (t+1)·T) of (n, B, S, ...)."""
    n = x.shape[0]
    v = x.reshape((n, x.shape[1], mesh.shape["tp"], T) + tuple(x.shape[3:]))
    idx = mesh.axis("tp").index().to(x.device)
    return v[torch.arange(n, device=x.device), :, idx]


def _forward_hidden(params, tokens, cfg: ModelConfig, mesh: Mesh):
    """Every rank's final hidden state (n, B_local, T_local, D), after
    the last norm, from rank-major tokens (n, B_local, S); only the last
    pp stage's is real."""
    n, B, S = tokens.shape
    T = S // mesh.shape["tp"]  # local sequence shard
    rows = torch.arange(n, device=tokens.device)[:, None, None]

    # Embed + positional, then shard the sequence over tp. The marker's
    # backward rule fires last — embed/pos grads close the backprop.
    x = overlap_mod.grad_marker(
        params["embed"][rows, tokens] + params["pos"][:, None, :S], "embed")
    x = _slice_tp(x, mesh, T)  # (n, B, T, D)

    # Microbatch split for the pipeline.
    M = cfg.microbatches
    micro = x.reshape(n, M, B // M, T, x.shape[-1])
    outs = pp_mod.pipeline(
        lambda bp, h: _stage_fn(bp, h, cfg, mesh), params["blocks"], micro,
        axis=mesh.axis("pp"))  # (n, M, mb, T, D), valid on last pp stage

    return _rmsnorm(outs.reshape(n, B, T, -1), params["ln_f"])


def _forward_loss(params, tokens, targets, cfg: ModelConfig, mesh: Mesh):
    """Every rank's forward and loss share. tokens/targets: rank-major
    (n, B_local, S), the same over pp/tp; returns (n,) local shares that
    sum to the global-mean loss."""
    n, B, S = tokens.shape
    T = S // mesh.shape["tp"]  # local sequence shard
    h = _forward_hidden(params, tokens, cfg, mesh)
    logits = tp_mod.matmul(h, params["head"])  # (n, B, T, V)

    tgt = _slice_tp(targets, mesh, T)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    local_sum = nll.sum(dim=(1, 2))

    # Only the last stage's activations are real; mask the others. The
    # LOCAL loss share: the ranks' shares sum to the loss (the caller's
    # sum), and the gradient of that sum is each rank's gradient.
    local_sum = torch.where(last_stage(mesh), local_sum, 0.0)
    return local_sum / (B * S * mesh.shape["dp"])


def _axis_sum(mesh: Mesh, name: str, g: torch.Tensor) -> torch.Tensor:
    return mesh.axis(name).apply(lambda a: spmd.allreduce_native(a, SUM), g)


def _sync_grads(grads: dict, cfg: ModelConfig, mesh: Mesh) -> dict:
    """Apply the gradient synchronization rules (module docstring).

    The local loss already carries the 1/(global tokens) normalization,
    so every cross-rank combination is a SUM: over dp for all params
    (each dp rank saw a batch shard), over tp for tp-replicated params
    (each tp rank saw a sequence shard), over pp for the stage-shared
    top-level params (only one stage's copy received gradient).

    The tp/pp sums are few and stay per-leaf; the dp sum — every
    parameter, the DDP-style gradient reduction — goes through the
    bucket coalescer (parallel/dp.allreduce_gradients), with the dp axis
    leading and (pp, tp, ...) the per-rank payload."""
    pre = {}
    for name in _TOP:
        pre[name] = _axis_sum(mesh, "pp", _axis_sum(mesh, "tp", grads[name]))
    pre["blocks"] = {
        name: _axis_sum(mesh, "tp", g) if name in _TP_REPLICATED else g
        for name, g in grads["blocks"].items()
    }
    dp = mesh.shape["dp"]
    by_dp = _tree.map_leaves(
        lambda g: g.reshape((dp, g.shape[0] // dp) + tuple(g.shape[1:])), pre)
    summed = dp_mod.allreduce_gradients(by_dp)
    return _tree.map_leaves(
        lambda g: g.reshape((mesh.size,) + tuple(g.shape[2:])), summed)


def _rank_major_batch(x, mesh: Mesh) -> torch.Tensor:
    """A global (batch, S) array -> (n, batch/dp, S): rank r holds its dp
    coordinate's rows, the same over pp and tp."""
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x).to(device=mesh.device, dtype=torch.int64)
    dp = mesh.shape["dp"]
    per = x.reshape((dp, x.shape[0] // dp) + tuple(x.shape[1:]))
    d = mesh.axis("dp").index().to(mesh.device)
    return per[d]


def build_train_step(cfg: ModelConfig, mesh: Mesh):
    """The full training step over a ('dp','pp','tp') mesh.

    Returns step(params, tokens, targets) -> (loss, new_params): params
    rank-major (``shard_params``), tokens/targets the global (batch, S)
    arrays; the loss a 0-d float32 tensor."""
    def step(params, tokens, targets):
        tok = _rank_major_batch(tokens, mesh)
        tgt = _rank_major_batch(targets, mesh)
        leaves, treedef = _tree.flatten(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            local = _forward_loss(_tree.unflatten(treedef, live), tok, tgt,
                                  cfg, mesh)
            # an unused leaf (the experts of a dense model) gets zeros,
            # as under jax.grad
            grads = torch.autograd.grad(local.sum(), live, allow_unused=True,
                                        materialize_grads=True)
        grads = _sync_grads(_tree.unflatten(treedef, list(grads)), cfg,
                            mesh)
        # Reported loss: the sum of the local shares, outside the grad.
        loss = local.detach().sum()
        new_params = _tree.unflatten(treedef, [
            (p - cfg.lr * g).to(p.dtype)
            for p, g in zip(leaves, _tree.leaves(grads))])
        return loss, new_params

    return step


def build_forward(cfg: ModelConfig, mesh: Mesh):
    """The forward+loss only (no grad) — the compile-check entry
    point: fwd(params, tokens, targets) -> 0-d loss."""
    def fwd(params, tokens, targets):
        with torch.no_grad():
            local = _forward_loss(params, _rank_major_batch(tokens, mesh),
                                  _rank_major_batch(targets, mesh), cfg,
                                  mesh)
            return local.sum()

    return fwd


def build_hidden(cfg: ModelConfig, mesh: Mesh):
    """The forward up to the last norm (no grad): hidden(params, tokens)
    -> (n, batch/dp, S/tp, D) rank-major, of which the last pp stage's
    ranks hold the model's output (``last_stage``)."""
    def hidden(params, tokens):
        with torch.no_grad():
            return _forward_hidden(params, _rank_major_batch(tokens, mesh),
                                   cfg, mesh)

    return hidden


def last_stage(mesh: Mesh) -> torch.Tensor:
    """The ranks of the last pp stage, a (n,) bool mask."""
    return mesh.axis("pp").index().to(mesh.device) == mesh.shape["pp"] - 1


def sharded_init(cfg: ModelConfig, mesh: Mesh, seed: int = 0) -> dict:
    """Init params from a generator seeded ``seed`` on the mesh's device
    and lay them out rank-major."""
    gen = torch.Generator(device=mesh.device).manual_seed(seed)
    return shard_params(init_params(gen, cfg, mesh.shape["pp"], mesh.device),
                        cfg, mesh)


def demo_mesh(n_ranks: int = 1, device=None) -> Mesh:
    """A (dp, pp, tp) mesh factorizing the ranks."""
    dims = factorize(n_ranks, 3)
    return make_mesh({"dp": dims[0], "pp": dims[1], "tp": dims[2]},
                     n_ranks, device)


def make_batch(cfg: ModelConfig, batch: int, seed: int = 0):
    """(tokens, targets), each (batch, seq_len) int64: the JAX package's
    numpy draw, so both packages get the same tokens."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(batch, cfg.seq_len))
    targets = np.roll(tokens, -1, axis=1)
    return torch.from_numpy(tokens), torch.from_numpy(targets)
