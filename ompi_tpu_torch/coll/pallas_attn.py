"""coll/pallas_attn — exact ring attention, on Hopper.

Port of ``ompi_tpu/coll/pallas_attn.py``: the JAX package's fused
ring-attention kernel ``_ring_attn_kernel`` becomes the hand-written
CUDA kernel ``csrc/ring_attention.cu``, with the wrapper
``ring_attention_block``, the plain version ``simulate_ring_attention``
(``ring_attention_block_plain``) and the launch counter ``ATTN``.

What it computes: for every rank ``me`` of a rank-major ``(n, T, H,
Dh)`` q, k, v, head ``h`` and query row ``i``, softmax attention over
all ``n·T`` keys of the ring, scale ``1/sqrt(Dh)`` as a float32, with
the causal mask on global positions (``me*T + i >= src*T + j``, masked
scores set to ``-1e30``), f32 running max, denominator and output, and
``o / max(l, 1e-30)`` written in the input dtype.

The protocol, the JAX kernel's: the KV blocks circulate the ring in a
two-slot buffer per rank, one slot holding K stacked over V, ``(2T, H,
Dh)``. At every step a rank waits for its right neighbour's credit on
the next slot, stores its current block into that slot of the right
neighbour, folds its current block into the accumulators and waits for
the next block to arrive from the left. A slot is credited to the left
neighbour only once it has been both computed on and forwarded (steps
``< n-2``), after a post-seed credit for slot 1. Every flag ends at 0.

Two things differ, because thread blocks on one card are not one TPU
core:

- Each rank is played by G thread blocks (a persistent grid of n x G,
  every block resident), and every block reads the whole KV slot. So a
  slot has arrived only when all G senders' shares of the forward copy
  have landed, and it is free only when all G blocks of the receiver
  are done computing on it and forwarding their share: the arrival and
  credit flags are one per receiving block, and each of the G blocks
  on the other side adds one to each, so every wait counts to G and
  subtracts G. ``simulate_ring_attention`` runs this with G blocks per
  rank; ``count="one"`` (one credit, from block 0 alone, awaited as 1)
  is the negative control that shows the count matters.
- Step 0 reads the rank's own k and v straight from the inputs (the
  JAX kernel first copies them into slot 0); slot 0 is first written by
  the left neighbour's step 1.

``supported`` is the port's own gate: float32, bfloat16 or float16,
``Dh % 8 == 0`` (every K/V row is whole 16-byte vectors) and ``Dh <=
256`` (the kernel's tiles fit one block's shared memory), any T and H.
It reads shape and dtype only, never the device, so the same path is
chosen on the CPU and on the card.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import random
from typing import Optional

import torch

from ..core import build
from ..core.counters import KernelCounter
from ..core.device import require_kernel_device
from ..core.errors import ArgumentError, KernelError
from .pallas_ring import _I, _P, _PAUSE, _checked, _drive, _residue

_NEG = -1e30
MAX_HEAD_DIM = 256

ATTN = KernelCounter("ring_attention")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def supported(q: torch.Tensor) -> bool:
    """Whether ``ring_attention_block`` takes a rank-major ``(n, T, H,
    Dh)`` q of this shape and dtype: float32/bfloat16/float16, ``Dh %
    8 == 0`` and ``Dh <= 256``, any T and H."""
    if q.ndim != 4 or min(q.shape) < 1:
        return False
    dh = q.shape[3]
    return q.dtype in _DTYPE_CODES and dh % 8 == 0 and dh <= MAX_HEAD_DIM


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4:
        raise ArgumentError(
            f"ring attention takes rank-major (n, T, H, Dh), got "
            f"{tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ArgumentError(
            f"q, k, v shapes differ: {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ArgumentError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                            f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ArgumentError(f"q, k, v devices differ: {q.device}, "
                            f"{k.device}, {v.device}")


def _scale(dh: int) -> float:
    """The JAX kernel's scale: a Python float, used as a float32."""
    return 1.0 / float(dh) ** 0.5


# ---------------------------------------------------------------------------
# Plain version: the protocol simulator.
# ---------------------------------------------------------------------------

def _fold(q, kb, vb, me: int, src: int, h: int, causal: bool, scale: float,
          m, l, o) -> None:
    """Fold head h of rank src's KV block ``kb``/``vb`` (T, H, Dh) into
    rank me's f32 accumulators: the JAX kernel's whole-block online
    softmax (``pallas_attn.py:70-93``)."""
    t = q.shape[1]
    qh = q[me, :, h].float()
    kh = kb[:, h].float()
    vh = vb[:, h].float()
    scores = (qh @ kh.T) * scale
    if causal:
        pos = torch.arange(t, device=q.device)
        mask = me * t + pos[:, None] >= src * t + pos[None, :]
        scores = torch.where(mask, scores, _NEG)
    mh = m[me, h]
    m_new = torch.maximum(mh, scores.amax(-1))
    corr = torch.exp(mh - m_new)
    p = torch.exp(scores - m_new[:, None])
    l[me, h] = l[me, h] * corr + p.sum(-1)
    o[me, h] = o[me, h] * corr[:, None] + p @ vh
    m[me, h] = m_new


def simulate_ring_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True, *,
                            blocks: int = 1, count: str = "port",
                            rng: Optional[random.Random] = None):
    """Run the kernel's slot and credit schedule on rank-major (n, T, H,
    Dh) q, k, v, with ``blocks`` (G) programs per rank: block g forwards
    share g of the slot's rows and folds heads g, g+G, ... Each program
    is a generator for ``pallas_ring._drive``: lock-step with ``rng``
    None, a seeded random interleaving otherwise. Every head's fold is a
    scheduling point, and it checks that every share of the slot it
    reads still holds the block it expects (a fault is recorded in the
    residue otherwise).

    ``count`` "port": every block of the receiver credits every block
    of the sender, and a wait counts to G; "one": block 0 alone credits
    and the sender waits for 1 (the negative control). Returns (out,
    residue): residue maps every flag not back at 0, and every early
    read, to its count."""
    if count not in ("port", "one"):
        raise ArgumentError(f"unknown credit count {count!r}")
    if blocks < 1:
        raise ArgumentError(f"need at least one block per rank, got {blocks}")
    _check(q, k, v)
    n, t, nh, dh = q.shape
    g_all = blocks
    scale = _scale(dh)
    slots = k.new_empty((n, 2, 2 * t, nh, dh))
    bounds = [2 * t * g // g_all for g in range(g_all + 1)]
    m = torch.full((n, nh, t), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((n, nh, t), dtype=torch.float32, device=q.device)
    o = torch.zeros((n, nh, t, dh), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    sems: dict = collections.defaultdict(int)
    tags: dict = {}  # (rank, slot, share) -> the rank whose block it holds
    need = g_all if count == "port" else 1

    def credit(g, to, slot):
        if count == "port" or g == 0:
            for b in range(g_all):
                sems[to, "cap", slot, b] += 1

    def block(me, g):
        right, left = (me + 1) % n, (me - 1) % n
        rows = slice(bounds[g], bounds[g + 1])
        own = torch.cat([k[me], v[me]])
        if n > 1:
            credit(g, left, 1)  # post-seed: my slot 1 is free
        for step in range(n):
            slot, nslot = step % 2, (step + 1) % 2
            src = (me - step) % n
            cur = own if step == 0 else slots[me, slot]
            if step < n - 1:
                yield (me, "cap", nslot, g), need
                slots[right, nslot, rows] = cur[rows]
                tags[right, nslot, g] = src
                for b in range(g_all):
                    sems[right, "recv", nslot, b] += 1
                yield _PAUSE
            for h in range(g, nh, g_all):
                if step and any(tags.get((me, slot, s)) != src
                                for s in range(g_all)):
                    sems["early", me, step, h] += 1
                _fold(q, cur[:t], cur[t:], me, src, h, causal, scale, m, l, o)
                yield _PAUSE
            if step < n - 2:
                credit(g, left, slot)
            if step < n - 1:
                yield (me, "recv", nslot, g), g_all
        for h in range(g, nh, g_all):
            den = torch.clamp(l[me, h], min=1e-30)[:, None]
            out[me, :, h] = (o[me, h] / den).to(q.dtype)

    _drive([block(r, g) for r in range(n) for g in range(g_all)], sems, rng)
    return out, _residue(sems)


def ring_attention_block_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, causal: bool = True
                               ) -> torch.Tensor:
    return _checked(simulate_ring_attention(q, k, v, causal))


# ---------------------------------------------------------------------------
# Kernel wrapper.
# ---------------------------------------------------------------------------

def _lib():
    """csrc/ring_attention.cu's two C functions, built on first use."""
    lib = build.library("ring_attention")
    if lib.ompi_ring_attention.argtypes is None:
        # n, T, H, Dh, dtype, dev -> blocks per rank (< 0: CUDA error)
        lib.ompi_ring_attention_blocks.argtypes = [_I] * 6
        lib.ompi_ring_attention_blocks.restype = _I
        # q, k, v, out, slots, acc_o, acc_ml, sems, n, blocks, T, H, Dh,
        # causal, scale, dtype, dev, stream
        lib.ompi_ring_attention.argtypes = (
            [_P] * 8 + [_I] * 6 + [ctypes.c_float, _I, _I, _P])
        lib.ompi_ring_attention.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _blocks(n: int, t: int, nh: int, dh: int, code: int, dev: int) -> int:
    """Thread blocks per rank (G) of the resident grid, asked of the card
    once per shape and device; the query also allows the kernel its
    shared memory there, which every launch relies on."""
    blocks = _lib().ompi_ring_attention_blocks(n, t, nh, dh, code, dev)
    if blocks < 0:
        raise KernelError(f"ring_attention: no resident grid for {n} ranks "
                          f"(CUDA error {-blocks})")
    return blocks


def ring_attention_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Rank-major (n, T, H, Dh) q, k, v -> (n, T, H, Dh): each rank's
    query block attended over the full ring, exact. A shape that
    ``supported`` refuses raises."""
    _check(q, k, v)
    if not supported(q):
        raise ArgumentError(
            f"ring attention kernel takes float32/bfloat16/float16 with "
            f"Dh % 8 == 0 and Dh <= {MAX_HEAD_DIM}; got {q.dtype} "
            f"{tuple(q.shape)}")
    if not q.is_cuda:
        return ring_attention_block_plain(q, k, v, causal)
    require_kernel_device(q)
    n, t, nh, dh = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    dev = q.device.index or 0
    code = _DTYPE_CODES[q.dtype]
    blocks = _blocks(n, t, nh, dh, code, dev)
    out = torch.empty_like(q)
    f32 = dict(dtype=torch.float32, device=q.device)
    if n > 1:
        slots = q.new_empty((n, 2, 2 * t, nh, dh))
        acc_o = torch.empty((n, nh, t, dh), **f32)
        acc_ml = torch.empty((n, 2, nh, t), **f32)
    else:  # one step: no hop, no accumulator carried between steps
        slots = acc_o = acc_ml = torch.empty(0, **f32)
    # (n, {recv, cap}, slot, blocks): one flag per receiving block
    sems = torch.zeros(n * 2 * 2 * blocks, dtype=torch.int32,
                       device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().ompi_ring_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        slots.data_ptr(), acc_o.data_ptr(), acc_ml.data_ptr(),
        sems.data_ptr(), n, blocks, t, nh, dh, int(bool(causal)),
        _scale(dh), code, dev, stream)
    if err:
        raise KernelError(f"ring_attention launch failed: CUDA error {err}")
    ATTN.launched(sems)
    return out
