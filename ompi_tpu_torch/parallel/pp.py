"""Pipeline parallelism: a GPipe schedule over ring-shift edge channels
(port of ``ompi_tpu/parallel/pp.py``).

SURVEY §2.6 PP row — the reference's p2p engine with per-peer ordering
(ob1) and persistent requests is the substrate pipelines are built from;
here, as in the JAX package, a static GPipe schedule: activations hop
stage→stage by a ring shift over the pp axis (a typed edge channel), and
the fill/drain bubble is the usual M + P - 1 ticks for M microbatches
over P stages. Every stage runs ``stage_fn`` on every tick, the idle
ones on the carry they hold, as in the JAX package: the same work and
the same launches. The schedule is differentiable (a shift's transpose
is the reverse shift), so autograd performs the backward pipeline.

Tensors are rank-major (leading rank axis); ``axis`` names the pp axis
of a mesh (default: the whole rank axis).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..coll import spmd
from ..core import tree as _tree
from .mesh_utils import Axis, rank_axis


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.view((-1,) + (1,) * (like.ndim - 1))


def pipeline(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
             stage_params: Any, microbatches: torch.Tensor,
             axis: Optional[Axis] = None) -> torch.Tensor:
    """Run a GPipe pipeline over the pp axis.

    ``microbatches`` is rank-major (n, M, ...), the same on every stage;
    every rank applies ``stage_fn(stage_params, x)`` (its own stage's
    rank-major params) to the microbatch flowing through it, then hands
    the result to the next stage. Returns the (n, M, ...) outputs, valid
    on the LAST stage (zeros elsewhere); combine with
    ``broadcast_from_last`` if all stages need them."""
    ax = rank_axis(microbatches, axis)
    stage = ax.index().to(microbatches.device)
    M, last = microbatches.shape[1], ax.size - 1
    first = _rows(stage == 0, microbatches[:, 0])
    carry = torch.zeros_like(microbatches[:, 0])
    outputs: list = [None] * M
    for t in range(M + ax.size - 1):
        inp = torch.where(first, microbatches[:, min(t, M - 1)], carry)
        h = stage_fn(stage_params, inp)
        # Collect finished microbatch t-(P-1) on the last stage.
        if t - last >= 0:
            outputs[t - last] = torch.where(_rows(stage == last, h), h,
                                            torch.zeros_like(h))
        if t != M + ax.size - 2:
            carry = ax.apply(lambda a: spmd.ring_shift(a, 1), h)
    return torch.stack(outputs, dim=1)


def broadcast_from_last(x: torch.Tensor, axis: Optional[Axis] = None
                        ) -> torch.Tensor:
    """Broadcast the last stage's value to all pipeline stages."""
    ax = rank_axis(x, axis)
    return ax.apply(lambda a: spmd.bcast_native(a, root=ax.size - 1), x)


def stage_slice(params_all: Any, axis: Optional[Axis] = None) -> Any:
    """Slice rank-major (n, P, ...) stacked per-stage params to each
    rank's own stage: (n, ...)."""
    def take(p):
        ax = rank_axis(p, axis)
        stage = ax.index().to(p.device)
        return p[torch.arange(p.shape[0], device=p.device), stage]

    return _tree.map_leaves(take, params_all)
