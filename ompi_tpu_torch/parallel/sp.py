"""Sequence/context parallelism: ring attention (port of
``ompi_tpu/parallel/sp.py``).

The sequence is sharded over the rank axis of rank-major ``(n, T, H,
Dh)`` tensors: rank r holds tokens ``[r*T, (r+1)*T)`` of S = n*T.
Causality is enforced against global positions, so the result is
single-device causal attention over the whole sequence.

Two implementations, chosen by ``impl`` or the cvar
``parallel_sp_impl``:

- ``xla``: the JAX package's unfused loop. The KV blocks go round the
  ring one hop a step (``spmd.ring_shift``, a roll over the rank axis)
  while an online softmax folds each block into f32 accumulators. Its
  dtypes are the JAX package's: the scale is computed in q's dtype, the
  scores come from an einsum in the input dtype cast to f32, ``p``
  multiplies V cast to f32, and ``o / max(l, 1e-30)`` is cast back.
- ``pallas``: the fused kernel (``coll/pallas_attn``,
  ``csrc/ring_attention.cu`` on the card) for a shape its gate
  ``supported`` takes, else the ``xla`` path, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..coll import spmd
from ..core import config
from ..core.errors import ArgumentError

_NEG = -1e30

_impl_var = config.register(
    "parallel", "sp", "impl", type=str, default="xla",
    description="Ring attention implementation: 'xla' (ppermute ring, "
                "compiler-scheduled overlap, any shape) or 'pallas' "
                "(fused kernel with guaranteed DMA/compute overlap; "
                "needs tile-aligned T/Dh and VMEM-resident blocks, "
                "falls back to xla otherwise)",
)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, impl: str | None = None
                   ) -> torch.Tensor:
    """Exact attention over the full sequence: rank-major (n, T, H, Dh)
    q, k, v -> (n, T, H, Dh), each rank's query block."""
    chosen = impl or _impl_var.value
    if chosen not in ("xla", "pallas"):
        raise ArgumentError(
            f"unknown ring attention impl {chosen!r}; known: xla, pallas")
    if chosen == "pallas":
        from ..coll import pallas_attn

        if pallas_attn.supported(q):
            return pallas_attn.ring_attention_block(q, k, v, causal=causal)
        # a shape the kernel does not take streams through the xla path
    n, t, nh, dh = q.shape
    scale = 1.0 / torch.sqrt(torch.tensor(dh, dtype=q.dtype,
                                          device=q.device))
    ranks = torch.arange(n, device=q.device)
    pos = torch.arange(t, device=q.device)
    q_pos = ranks[:, None] * t + pos  # (n, T) global positions

    m = torch.full((n, nh, t), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((n, nh, t), dtype=torch.float32, device=q.device)
    o = torch.zeros((n, nh, t, dh), dtype=torch.float32, device=q.device)

    kb, vb = k, v
    for step in range(n):
        src = (ranks - step) % n  # whose KV block each rank now holds
        kv_pos = src[:, None] * t + pos
        scores = torch.einsum("nqhd,nkhd->nhqk", q, kb).float() * scale
        if causal:
            mask = q_pos[:, :, None] >= kv_pos[:, None, :]  # (n, Tq, Tk)
            scores = torch.where(mask[:, None], scores, _NEG)
        m_new = torch.maximum(m, scores.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum("nhqk,nkhd->nhqd", p,
                                               vb.float())
        m = m_new
        if step != n - 1:
            kb, vb = spmd.ring_shift((kb, vb), 1)

    out = o / torch.clamp(l, min=1e-30)[..., None]  # (n, H, T, Dh)
    return out.transpose(1, 2).to(q.dtype).contiguous()


def shard_sequence(x: torch.Tensor, n: int) -> torch.Tensor:
    """A replicated (S, ...) tensor -> rank-major (n, S // n, ...): rank
    r takes tokens [r*per, (r+1)*per), as each rank slices its own in
    the JAX package (a tail past n*per is dropped there too)."""
    per = x.shape[0] // n
    return x[:n * per].reshape((n, per) + tuple(x.shape[1:]))
