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
``1 .. n-3``), after post-seed credits. Every flag ends at 0.

What differs, because thread blocks on one card are not one TPU core:

- Each rank is played by its own thread blocks of one persistent grid
  (every block resident), and every block reads the whole KV slot. So
  a slot has arrived only when every share of the sending rank's
  forward copy has landed, and it is free only when every block of the
  reading rank is done computing on it and forwarding its share. The
  arrival and credit flags are one per receiving block; each block on
  the other side adds one to each. An arrival wait counts to the
  sending rank's blocks, a credit wait to the reading rank's, and
  subtracts as much, so every flag ends at 0.
- Under the causal mask, rank ``me`` skips the fold of every step whose
  block comes from a later rank (``src > me``): every key of it lies
  after every query of ``me``. Step 0 is the rank's own block, whose
  first key every query sees, so the running max is finite from then
  on; a wholly masked block then gives ``p = exp(-1e30 - m) = 0`` and
  a correction of ``exp(0) = 1``, and m, l and o stay as they were,
  bit for bit. The block is still forwarded and credited. So the ranks
  fold ``me + 1/2`` blocks' worth each, and ``split_blocks`` gives each
  rank blocks by that work (no fewer than the two-slot ring's coupling
  asks for the light ranks), floored at what its share of the forward
  copy needs. Without the mask every rank gets an equal share.
- Step 0 reads the rank's own k and v straight from the inputs (the
  JAX kernel first copies them into slot 0 and credits it after step
  0), so both slots start free: a post-seed credit for each. On the card
  a copy warp forwards while the block folds, and whichever finishes
  with a slot last credits it (the copy warp alone where the fold is
  skipped), so a rank that folds little holds up only the slots it
  folds.

``simulate_ring_attention`` runs this with any per-rank block counts;
``count="one"`` (one credit, from block 0 alone, awaited as 1) and
``count="recv"`` (arrivals awaited as the receiving rank's own block
count) are the negative controls that show the counts matter.

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
import itertools
import random
from typing import Optional, Sequence, Union

import torch

from ..core import build
from ..core.counters import KernelCounter
from ..core.device import require_kernel_device
from ..core.errors import ArgumentError, KernelError
from .pallas_ring import _I, _P, _PAUSE, _checked, _drive, _residue

_NEG = -1e30
MAX_HEAD_DIM = 256
#: Query rows of one work item of the kernel (a tile of one head).
TILE_ROWS = 64
#: Most bytes of a step's forward copy that one block takes on when the
#: split is uneven: a rank's blocks are floored at slot bytes / this (at
#: most half an equal share).
FWD_SHARE_BYTES = 1 << 20

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


def split_blocks(n: int, total: int, causal: bool, floor: int = 1,
                 items: int = 0) -> list[int]:
    """Thread blocks per rank of a grid of ``total`` (>= n) blocks.

    Without the causal mask every rank folds n blocks: an equal split,
    the first ``total % n`` ranks one more. Under it rank ``me`` folds
    ``me + 1/2`` blocks' worth (the masked folds skipped), in its steps
    0 .. me, so its work weighs ``2 me + 1``. Work alone under-serves the
    light ranks: with two slots a slot is refilled only once its reader
    has folded it, so rank j's early folds gate the blocks the heavier
    ranks wait for later (the credits travel back along the ring). Each
    rank's weight is therefore at least ``me + n/2 + 1`` (found on an
    NVIDIA H100 at 8 ranks: PERF.md, PR 7). Every rank gets at least
    ``floor`` blocks (what its share of the forward copy needs), the rest
    of the grid goes in proportion to the weights; with ``items`` (work
    items of one rank) each count is then cut to the fewest blocks that
    take the same number of items per block, and the blocks set free go
    one at a time to the rank whose weighted items per block they lower
    the most, or else to the ranks in order. The counts sum to
    ``total``."""
    if n < 1 or total < n:
        raise ArgumentError(f"need at least one block per rank: {total} "
                            f"blocks for {n} ranks")
    if not causal:
        return [total // n + (r < total % n) for r in range(n)]
    floor = max(1, min(floor, total // n))
    weight = [max(2 * r + 1, r + n / 2 + 1) for r in range(n)]
    k = 0  # ranks below k sit at the floor (the weights grow with r)
    while k < n - 1 and ((total - k * floor) * weight[k]
                         < floor * sum(weight[k:])):
        k += 1
    extra, whole = total - k * floor, sum(weight[k:])
    cum = [0.0, *itertools.accumulate(weight[k:])]
    counts = [floor] * k + [int(extra * cum[i + 1] / whole)
                            - int(extra * cum[i] / whole)
                            for i in range(n - k)]
    counts[-1] += total - sum(counts)
    if items > 0:
        per = [-(-items // g) for g in counts]  # items of the busiest block
        counts = [max(floor, -(-items // p)) for p in per]
        spare = total - sum(counts)
        while spare > 0:
            fits = [r for r in range(n) if per[r] > 1
                    and -(-items // (per[r] - 1)) - counts[r] <= spare]
            if not fits:
                break
            r = max(fits, key=lambda r: (weight[r] * per[r], r))
            per[r] -= 1
            need = max(counts[r], -(-items // per[r]))
            spare -= need - counts[r]
            counts[r] = need
        for r in range(spare):
            counts[r % n] += 1
    return counts


def simulate_ring_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True, *,
                            blocks: Union[int, Sequence[int]] = 1,
                            count: str = "port",
                            rng: Optional[random.Random] = None):
    """Run the kernel's slot and credit schedule on rank-major (n, T, H,
    Dh) q, k, v, with ``blocks`` programs per rank (one count for every
    rank, or one per rank): block g of rank r forwards share g of the
    slot's rows and folds heads g, g+G_r, ...; under the causal mask it
    skips the fold of a block from a later rank, as the kernel does.
    Each program is a generator for ``pallas_ring._drive``: lock-step
    with ``rng`` None, a seeded random interleaving otherwise. Every
    head's fold is a scheduling point, and it checks that every share of
    the slot it reads still holds the block it expects (a fault is
    recorded in the residue otherwise).

    ``count`` "port": every block of the receiver credits every block of
    the sender; an arrival wait counts to the sending rank's blocks and
    a credit wait to the reading rank's. "one": block 0 alone credits
    and the sender waits for 1; "recv": an arrival wait counts to the
    receiving rank's own blocks (both negative controls). Returns (out,
    residue): residue maps every flag not back at 0, and every early
    read, to its count."""
    if count not in ("port", "one", "recv"):
        raise ArgumentError(f"unknown credit count {count!r}")
    _check(q, k, v)
    n, t, nh, dh = q.shape
    g_of = [blocks] * n if isinstance(blocks, int) else list(blocks)
    if len(g_of) != n or min(g_of) < 1:
        raise ArgumentError(f"need at least one block for each of {n} "
                            f"ranks, got {blocks}")
    scale = _scale(dh)
    slots = k.new_empty((n, 2, 2 * t, nh, dh))
    m = torch.full((n, nh, t), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((n, nh, t), dtype=torch.float32, device=q.device)
    o = torch.zeros((n, nh, t, dh), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    sems: dict = collections.defaultdict(int)
    tags: dict = {}  # (rank, slot, share) -> the rank whose block it holds

    def credit(me, g, slot):
        left = (me - 1) % n
        if count != "one" or g == 0:
            for b in range(g_of[left]):
                sems[left, "cap", slot, b] += 1

    def block(me, g):
        right, left = (me + 1) % n, (me - 1) % n
        mine = g_of[me]
        rows = slice(2 * t * g // mine, 2 * t * (g + 1) // mine)
        own = torch.cat([k[me], v[me]])
        cap_need = 1 if count == "one" else g_of[right]
        recv_need = mine if count == "recv" else g_of[left]
        if n > 1:  # post-seed: both my slots are free (step 0 reads k, v)
            credit(me, g, 1)
        if n > 2:
            credit(me, g, 0)
        for step in range(n):
            slot, nslot = step % 2, (step + 1) % 2
            src = (me - step) % n
            cur = own if step == 0 else slots[me, slot]
            if step < n - 1:
                yield (me, "cap", nslot, g), cap_need
                slots[right, nslot, rows] = cur[rows]
                tags[right, nslot, g] = src
                for b in range(g_of[right]):
                    sems[right, "recv", nslot, b] += 1
                yield _PAUSE
            if not (causal and src > me):
                for h in range(g, nh, mine):
                    if step and any(tags.get((me, slot, s)) != src
                                    for s in range(g_of[left])):
                        sems["early", me, step, h] += 1
                    _fold(q, cur[:t], cur[t:], me, src, h, causal, scale,
                          m, l, o)
                    yield _PAUSE
            if 1 <= step < n - 2:
                credit(me, g, slot)
            if step < n - 1:
                yield (me, "recv", nslot, g), recv_need
        for h in range(g, nh, mine):
            den = torch.clamp(l[me, h], min=1e-30)[:, None]
            out[me, :, h] = (o[me, h] / den).to(q.dtype)

    _drive([block(r, g) for r in range(n) for g in range(g_of[r])], sems,
           rng)
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
        # T, H, Dh, dtype, dev -> resident blocks (< 0: CUDA error)
        lib.ompi_ring_attention_blocks.argtypes = [_I] * 5
        lib.ompi_ring_attention_blocks.restype = _I
        # q, k, v, out, slots, acc_o, acc_ml, sems, offs, n, blocks, T, H,
        # Dh, causal, scale, dtype, dev, stream
        lib.ompi_ring_attention.argtypes = (
            [_P] * 9 + [_I] * 6 + [ctypes.c_float, _I, _I, _P])
        lib.ompi_ring_attention.restype = _I
    return lib


def padded_head_dim(dh: int) -> int:
    """The head dim of the kernel's half-precision tiles: Dh padded with
    zeros to 32, 64, 128 or 256 (the tensor-core product's widths)."""
    return max(32, 1 << (dh - 1).bit_length())


@functools.lru_cache(maxsize=None)
def _plan(n: int, t: int, nh: int, dh: int, code: int, causal: bool,
          dev: int):
    """(blocks per rank, their prefix offsets on the card) of the
    resident grid, asked of the card once per shape and device; the
    query also allows the kernel its shared memory there, which every
    launch relies on. The grid has every block that fits, at most one
    per work item of the rank times n."""
    resident = _lib().ompi_ring_attention_blocks(t, nh, dh, code, dev)
    if resident < n:
        raise KernelError(f"ring_attention: no resident grid for {n} ranks "
                          f"({resident} blocks fit; < 0: CUDA error)")
    tiles = -(-t // TILE_ROWS)
    total = min(resident, n * nh * tiles)
    itemsize = 4 if code == 0 else 2
    floor = min(-(-2 * t * nh * dh * itemsize // FWD_SHARE_BYTES),
                total // (2 * n))
    # a block folds one query tile of a head at a time (f32), or two
    items = nh * (tiles if code == 0 else -(-tiles // 2))
    counts = split_blocks(n, total, causal, floor, items)
    offs = torch.tensor([0, *itertools.accumulate(counts)],
                        dtype=torch.int32, device=torch.device("cuda", dev))
    return counts, offs


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
    counts, offs = _plan(n, t, nh, dh, code, bool(causal), dev)
    total = sum(counts)
    out = torch.empty_like(q)
    f32 = dict(dtype=torch.float32, device=q.device)
    if n > 1:
        tiles = nh * -(-t // TILE_ROWS)
        slots = q.new_empty((n, 2, 2 * t, nh, dh))
        # per (rank, tile): the f32 output rows, then 4 floats of running
        # max and denominator for each of the tile's 128 threads
        acc_o = torch.empty(n * tiles * TILE_ROWS * padded_head_dim(dh),
                            **f32)
        acc_ml = torch.empty(n * tiles * 4 * 2 * TILE_ROWS, **f32)
    else:  # one step: no hop, no accumulator carried between steps
        slots = acc_o = acc_ml = torch.empty(0, **f32)
    # ({recv, cap}, slot, block): one flag per receiving block
    sems = torch.zeros(2 * 2 * total, dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().ompi_ring_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        slots.data_ptr(), acc_o.data_ptr(), acc_ml.data_ptr(),
        sems.data_ptr(), offs.data_ptr(), n, total, t, nh, dh,
        int(bool(causal)), _scale(dh), code, dev, stream)
    if err:
        raise KernelError(f"ring_attention launch failed: CUDA error {err}")
    ATTN.launched(sems)
    return out
