"""Expert parallelism: capacity-based MoE dispatch over all_to_all
(port of ``ompi_tpu/parallel/ep.py``).

SURVEY §2.6 EP row — the reference's alltoallv (vector alltoall,
coll_base_functions.h:75-76) is the MoE dispatch primitive. As in the
JAX package: static-shape capacity-based dispatch (ragged alltoallv
becomes fixed-capacity buckets with overflow drop — the standard
Switch/Mixtral formulation) over the alltoall.

Experts are sharded over ``axis``: each of its k ranks owns E_local =
E_total / k experts. Top-1 routing (the first maximum, as
``jnp.argmax``); gating weight applied on combine. Dropped
(over-capacity) tokens pass through with zero expert contribution
(residual connections keep them alive).

Two JAX indexing rules are kept by hand: a scatter-add at an
out-of-range position (``my_pos >= cap``) is dropped there, so a
dropped token's update here is zero and lands in range; a gather at an
out-of-range position is clamped there, and its value is masked.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..coll import spmd
from ..ops import SUM
from .mesh_utils import Axis, rank_axis


def _alltoall(ax: Axis, x: torch.Tensor) -> torch.Tensor:
    return ax.apply(spmd.alltoall_native, x, 1, 1)


def moe_dispatch_combine(
    x: torch.Tensor,  # (n, T, D) local tokens
    router_logits: torch.Tensor,  # (n, T, E_total)
    expert_fn: Callable[[int, torch.Tensor], torch.Tensor],
    n_local_experts: int,
    axis: Optional[Axis] = None,
    capacity_factor: float = 1.25,
) -> torch.Tensor:
    """Route each token to its top-1 expert (owned by expert_rank =
    expert // n_local), run the expert, and return combined (n, T, D).
    ``expert_fn(local_e, (n, N, D)) -> (n, N, D)`` runs each rank's own
    local expert ``local_e`` on its rows."""
    ax = rank_axis(x, axis)
    k = ax.size
    nr, T, D = x.shape
    e_total = router_logits.shape[-1]
    assert e_total == k * n_local_experts

    probs = torch.softmax(router_logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)  # (n, T)
    gate = torch.gather(probs, -1, expert[..., None])[..., 0]
    dest = expert // n_local_experts  # owning rank per token
    local_e = expert % n_local_experts

    cap = max(1, int(capacity_factor * T / k))

    # Position of each token within its destination bucket.
    pos = torch.cumsum(F.one_hot(dest, k), dim=1) - 1  # (n, T, k)
    my_pos = torch.gather(pos, -1, dest[..., None])[..., 0]  # (n, T)
    keep = my_pos < cap
    slot = torch.clamp(my_pos, max=cap - 1)  # dropped: a zero update
    rows = torch.arange(nr, device=x.device)[:, None].expand(nr, T)

    # Dispatch buffers: tokens + metadata (local expert id, validity).
    send = x.new_zeros((nr, k, cap, D)).index_put(
        (rows, dest, slot), torch.where(keep[..., None], x, 0),
        accumulate=True)
    meta_e = torch.zeros((nr, k, cap), dtype=torch.int32,
                         device=x.device).index_put(
        (rows, dest, slot),
        torch.where(keep, local_e + 1, 0).to(torch.int32), accumulate=True)
    # meta_e == 0 marks an empty slot; expert id is meta_e - 1.

    recv = _alltoall(ax, send)  # (n, k, cap, D)
    recv_e = _alltoall(ax, meta_e[..., None])[..., 0]

    flat = recv.reshape(nr, k * cap, D)
    flat_e = recv_e.reshape(nr, k * cap)
    out = torch.zeros_like(flat)
    for e in range(n_local_experts):
        mask = (flat_e == e + 1)[..., None]
        out = out + torch.where(mask, expert_fn(e, flat), 0)

    # Return the processed tokens to their source ranks and positions.
    back = _alltoall(ax, out.reshape(nr, k, cap, D))
    gathered = back[rows, dest, slot]  # (n, T, D)
    return torch.where(keep[..., None], gathered * gate[..., None], 0.0)


def aux_load_balance_loss(router_logits: torch.Tensor,
                          axis: Optional[Axis] = None,
                          n_local_experts: int = 1) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss over the global expert
    set (fraction-routed × mean-prob, allreduced across the axis' ranks);
    (n,), every rank's value."""
    ax = rank_axis(router_logits, axis)
    probs = torch.softmax(router_logits, dim=-1)  # (n, T, E)
    top = torch.argmax(probs, dim=-1)
    e_total = probs.shape[-1]
    frac = F.one_hot(top, e_total).to(torch.float32).mean(dim=1)
    mean_prob = probs.mean(dim=1)

    def allreduce(a):
        return ax.apply(lambda b: spmd.allreduce_native(b, SUM), a)

    frac = allreduce(frac) / ax.size
    mean_prob = allreduce(mean_prob) / ax.size
    return e_total * torch.sum(frac * mean_prob, dim=-1)
