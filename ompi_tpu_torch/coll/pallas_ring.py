"""coll/pallas — the hand-scheduled ring allreduce kernels, on Hopper.

Port of ``ompi_tpu/coll/pallas_ring.py``'s allreduce path. The JAX
package writes three Pallas kernels for it; each is a hand-written CUDA
kernel here (``csrc/``), with a wrapper, a plain version and a launch
counter:

- ``ring_allreduce`` (``_allreduce_kernel``): the whole-payload ring,
  2(n-1) steps over a two-slot comm buffer with credits.
- ``ring_allreduce_rd`` (``_allreduce_rd_kernel``): recursive doubling,
  log2 n rounds with one slot and one flag per round, rank-ordered
  combine.
- ``ring_allreduce_chunked`` (``_allreduce_chunked_kernel``): the ring
  streamed in segments with a per-segment credit, so comm scratch stays
  at n·2·segment bytes however large the message.

Ranks on one card: a rank-major ``(n, ...)`` tensor holds n virtual
ranks. A Pallas remote DMA becomes stores into the peer rank's comm slot
followed by a release-increment of the peer's flag; a semaphore wait
becomes an acquire spin on the rank's own flag. Every flag ends each
launch at 0.

Credit placement differs from the reference on purpose. The reference
credits a comm slot to its left neighbour right after FILLING it
(``pallas_ring.py:263-267``, ``:387-391``), though it still has to send
from that slot at the next step; a left neighbour that runs ahead
overwrites the partial before it is forwarded. The port credits a slot
right after the send FROM it (steps 0..2n-4) and drops the post-seed
credit. ``simulate_ring`` runs either placement under seeded random
interleavings; the tests show the reference's placement fails there and
the port's does not.

Plain versions: ``simulate_ring``/``simulate_rd`` run the same slot and
flag schedule rank by rank on tensors (what ``pallas_lower.simulate`` is
to the JAX package). A wrapper uses its plain version only for a tensor
on the CPU; for a CUDA tensor it launches the kernel or raises.

Block boundaries equal the JAX package's: ``_split_ring`` and
``_chunked_layout`` copy its padding and blocking math, which decides
at which rank each element's reduction starts, and so the bits of a
floating-point sum.
"""

from __future__ import annotations

import collections
import ctypes
import random
from typing import Optional

import torch
import torch.nn.functional as F

from ..core import build, config
from ..core.counters import KernelCounter
from ..core.device import require_kernel_device
from ..core.errors import ArgumentError, KernelError
from ..ops import Op, lookup as op_lookup
from .framework import COLL, CollComponent, compile_plan, rank_major_check

_segment_var = config.register(
    "coll", "pallas", "segment_bytes",
    type=int, default=1 << 20,
    description="Segment size for the chunked streaming ring kernel "
                "(reference's segmented-ring knob: 1 MiB)",
)
_chunk_threshold_var = config.register(
    "coll", "pallas", "chunk_threshold_bytes",
    type=int, default=4 << 20,
    description="Per-rank payload size above which pallas allreduce "
                "streams segments (chunked kernel)",
)
_rd_cutoff_var = config.register(
    "coll", "pallas", "rd_cutoff_bytes",
    type=int, default=10_000,
    description="Per-rank bytes below which pallas allreduce uses "
                "recursive doubling (reference: 10000B cutoff)",
)

LANES = 128
#: Columns of a ring block (or segment) per thread block of one rank:
#: the kernels stripe each rank's work over blocks of this width.
STRIPE_COLS = 4096
#: Flags per (rank, stripe) of the ring kernels: recv[2], cap[2], seg.
RING_NSEM = 5

RING = KernelCounter("ring_allreduce")
RD = KernelCounter("ring_allreduce_rd")
CHUNKED = KernelCounter("ring_allreduce_chunked")

_OP_CODES = {"sum": 0, "prod": 1, "max": 2, "min": 3}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


# ---------------------------------------------------------------------------
# Protocol simulator: the plain versions of the kernels.
# ---------------------------------------------------------------------------

def _drive(programs: list, sems: dict, rng: Optional[random.Random]) -> None:
    """Run rank programs to completion. A program is a generator that
    yields ``(flag key, count)`` when it waits; a wait is satisfied when
    the flag is at least count, and then consumes count. Every wait is a
    scheduling point: with ``rng`` None the ranks take turns in ring
    order (lock-step), with a ``random.Random`` a ready rank is picked
    at random. A copy or a signal between two waits is atomic, as a DMA
    is at its start."""
    nranks = len(programs)
    waiting = {r: None for r in range(nranks)}
    last = nranks - 1
    while waiting:
        ready = [r for r, w in waiting.items()
                 if w is None or sems[w[0]] >= w[1]]
        if not ready:
            raise RuntimeError(f"protocol deadlock, ranks waiting on "
                               f"{waiting}")
        if rng is None:
            r = min(ready, key=lambda q: (q - last - 1) % nranks)
        else:
            r = rng.choice(ready)
        last = r
        w = waiting[r]
        if w is not None:
            sems[w[0]] -= w[1]
        try:
            waiting[r] = next(programs[r])
        except StopIteration:
            del waiting[r]


def _residue(sems: dict) -> dict:
    return {k: v for k, v in sems.items() if v}


def simulate_ring(blocks: torch.Tensor, op: Op, seg_cols: Optional[int] = None,
                  *, segmented: bool = False, credit: str = "port",
                  rng: Optional[random.Random] = None):
    """Run the ring allreduce schedule on ``blocks`` (rank, block, col)
    of shape (n, n, W), segment by segment of ``seg_cols`` columns.
    Returns (out, residue): out has the shape of blocks, residue maps
    every flag not back at 0 to its count.

    ``segmented`` adds the chunked kernel's per-segment credit (primed
    once, granted after each segment, drained at exit). ``credit``
    "port" is the kernels' placement; "reference" is the JAX package's
    (a post-seed credit, then a credit right after filling a slot)."""
    if credit not in ("port", "reference"):
        raise ArgumentError(f"unknown credit placement {credit!r}")
    n, nb, W = blocks.shape
    if nb != n:
        raise ArgumentError(f"ring blocks must be (n, n, W), got "
                            f"{tuple(blocks.shape)}")
    seg = W if seg_cols is None else seg_cols
    if seg <= 0 or W % seg:
        raise ArgumentError(f"segment {seg} does not divide {W}")
    n_segs = W // seg
    out = torch.empty_like(blocks)
    comm = blocks.new_empty((n, 2, seg))
    sems: dict = collections.defaultdict(int)
    nsteps = 2 * (n - 1)

    def rank(me):
        left, right = (me - 1) % n, (me + 1) % n
        x, o = blocks[me], out[me]
        if segmented:
            sems[left, "seg"] += 1
        for si in range(n_segs):
            cols = slice(si * seg, (si + 1) * seg)
            if segmented:
                yield (me, "seg"), 1
            comm[me, 0] = x[(me - 1) % n, cols]
            if credit == "reference":
                sems[left, "cap", 0] += 1
            for step in range(nsteps):
                slot, nslot = step % 2, (step + 1) % 2
                if step >= 1:
                    yield (me, "cap", nslot), 1
                comm[right, nslot] = comm[me, slot]
                sems[right, "recv", nslot] += 1
                if credit == "port" and step < nsteps - 1:
                    sems[left, "cap", slot] += 1
                yield (me, "recv", nslot), 1
                if step < n - 1:
                    blk = (me - step - 2) % n
                    val = op.combine(comm[me, nslot], x[blk, cols])
                    comm[me, nslot] = val
                    if step == n - 2:
                        o[blk, cols] = val
                else:
                    blk = (me - (step - (n - 1)) - 1) % n
                    o[blk, cols] = comm[me, nslot]
                if credit == "reference" and step < nsteps - 2:
                    sems[left, "cap", nslot] += 1
            if segmented:
                sems[left, "seg"] += 1
        if segmented:
            yield (me, "seg"), 1

    _drive([rank(r) for r in range(n)], sems, rng)
    return out, _residue(sems)


def simulate_rd(flat: torch.Tensor, op: Op, *,
                rng: Optional[random.Random] = None):
    """Run the recursive-doubling schedule on ``flat`` (n, L), n a power
    of two: round k exchanges the whole buffer with rank me ^ 2^k into
    that round's own slot and flag, and combines in rank order.
    Returns (out, residue) as ``simulate_ring`` does."""
    n, L = flat.shape
    rounds = (n - 1).bit_length()
    out = flat.clone()
    comm = flat.new_empty((n, max(rounds, 1), L))
    sems: dict = collections.defaultdict(int)

    def rank(me):
        for k in range(rounds):
            partner = me ^ (1 << k)
            comm[partner, k] = out[me]
            sems[partner, "recv", k] += 1
            yield (me, "recv", k), 1
            if partner < me:
                out[me] = op.combine(comm[me, k], out[me])
            else:
                out[me] = op.combine(out[me], comm[me, k])

    _drive([rank(r) for r in range(n)], sems, rng)
    return out, _residue(sems)


def _checked(result):
    out, residue = result
    if residue:
        raise RuntimeError(f"protocol left flags non-zero: {residue}")
    return out


def ring_allreduce_plain(blocks: torch.Tensor, op) -> torch.Tensor:
    return _checked(simulate_ring(blocks, op_lookup(op)))


def ring_allreduce_chunked_plain(blocks: torch.Tensor, op,
                                 seg_cols: int) -> torch.Tensor:
    return _checked(simulate_ring(blocks, op_lookup(op), seg_cols,
                                  segmented=True))


def ring_allreduce_rd_plain(flat: torch.Tensor, op) -> torch.Tensor:
    return _checked(simulate_rd(flat, op_lookup(op)))


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ARGTYPES = {
    # x, out, comm, sems, n, stripes, W, seg, n_segs, op, dtype, dev, stream
    "ring_allreduce": [_P, _P, _P, _P, _I, _I, _LL, _LL, _I, _I, _I, _I, _P],
    "ring_allreduce_chunked":
        [_P, _P, _P, _P, _I, _I, _LL, _LL, _I, _I, _I, _I, _P],
    # x, out, comm, sems, n, stripes, L, rounds, op, dtype, dev, stream
    "ring_allreduce_rd": [_P, _P, _P, _P, _I, _I, _LL, _I, _I, _I, _I, _P],
}


def _entry(name: str):
    """The C launch function of csrc/<name>.cu (built on first use)."""
    fn = getattr(build.library(name), f"ompi_{name}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _codes(op: Op, dtype: torch.dtype) -> tuple[int, int]:
    if not op.predefined or op.name not in _OP_CODES:
        raise ArgumentError(f"no ring kernel for op {op.name}")
    if dtype not in _DTYPE_CODES:
        raise ArgumentError(f"no ring kernel for dtype {dtype}")
    return _OP_CODES[op.name], _DTYPE_CODES[dtype]


def _stripes(n: int, cols: int, sm_count: int) -> int:
    """Thread blocks per rank: the whole grid (n x stripes) must be
    resident at once, so n * stripes <= the SM count."""
    if n > sm_count:
        raise KernelError(f"{n} ranks need {n} resident blocks; the card "
                          f"has {sm_count} SMs")
    return max(1, min(sm_count // n, -(-cols // STRIPE_COLS)))


def _launch(name: str, counter: KernelCounter, x: torch.Tensor, op: Op,
            cols: int, slots: int, nsem: int, scalars: tuple
            ) -> torch.Tensor:
    """Launch csrc/<name>.cu on x: each rank is striped over blocks of
    ``cols`` columns; comm scratch is (n, stripes, slots, stripe width)
    and the flags (n, stripes, nsem), zeroed here on every launch."""
    cap = require_kernel_device(x)
    opc, dtc = _codes(op, x.dtype)
    n = x.shape[0]
    stripes = _stripes(n, cols, cap.sm_count)
    sw = -(-cols // stripes)
    x = x.contiguous()
    out = torch.empty_like(x)
    comm = torch.empty((n, stripes, slots, sw), dtype=x.dtype,
                       device=x.device)
    sems = torch.zeros(n * stripes * nsem, dtype=torch.int32,
                       device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry(name)(x.data_ptr(), out.data_ptr(), comm.data_ptr(),
                       sems.data_ptr(), n, stripes, *scalars,
                       opc, dtc, x.device.index or 0, stream)
    if err:
        raise KernelError(f"{name} launch failed: CUDA error {err}")
    counter.launched(sems)
    return out


def ring_allreduce(blocks: torch.Tensor, op) -> torch.Tensor:
    """(n, n, C) per-rank ring blocks -> fully reduced (n, n, C): every
    rank's every block holds the combine of that block over all ranks,
    folded in ring order from rank b+1 round to rank b."""
    op = op_lookup(op)
    C = blocks.shape[2]
    if not blocks.is_cuda:
        return ring_allreduce_plain(blocks, op)
    return _launch("ring_allreduce", RING, blocks, op, C, 2, RING_NSEM,
                   (C, C, 1))


def ring_allreduce_chunked(blocks: torch.Tensor, op, seg_cols: int
                           ) -> torch.Tensor:
    """The ring of ``ring_allreduce`` over (n, n, W) blocks, streamed in
    segments of ``seg_cols`` columns with a per-segment credit."""
    op = op_lookup(op)
    W = blocks.shape[2]
    if W % seg_cols:
        raise ArgumentError(f"segment {seg_cols} does not divide {W}")
    if not blocks.is_cuda:
        return ring_allreduce_chunked_plain(blocks, op, seg_cols)
    return _launch("ring_allreduce_chunked", CHUNKED, blocks, op, seg_cols,
                   2, RING_NSEM, (W, seg_cols, W // seg_cols))


def ring_allreduce_rd(flat: torch.Tensor, op) -> torch.Tensor:
    """(n, L) per-rank buffers -> (n, L) recursive-doubling allreduce
    (n a power of two)."""
    op = op_lookup(op)
    n, L = flat.shape
    if n & (n - 1):
        raise ArgumentError(
            f"recursive doubling needs a power-of-two ring, got {n}")
    if not flat.is_cuda:
        return ring_allreduce_rd_plain(flat, op)
    rounds = (n - 1).bit_length()
    return _launch("ring_allreduce_rd", RD, flat, op, L, rounds, rounds,
                   (L, rounds))


# ---------------------------------------------------------------------------
# Layouts: the JAX package's padding and blocking, on the rank-major
# tensor (n, ...) -> per-rank kernel inputs.
# ---------------------------------------------------------------------------

def _sublane(dtype: torch.dtype) -> int:
    """The JAX package's minimum second-to-last tile for the dtype:
    (8,128) f32, (16,128) bf16, (32,128) int8."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return max(8, 32 // max(1, itemsize))


def _split_ring(b: torch.Tensor):
    """(n, ...) -> ((n, n, C) ring blocks, pad, per-rank shape): each
    rank's flat buffer zero-padded to a multiple of n*128 and cut into
    n blocks (``pallas_ring._split_ring``)."""
    n = b.shape[0]
    flat = b.reshape(n, -1)
    pad = (-flat.shape[1]) % (n * LANES)
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(n, n, -1), pad, tuple(b.shape[1:])


def _unsplit(out: torch.Tensor, pad: int, shape: tuple) -> torch.Tensor:
    n = out.shape[0]
    flat = out.reshape(n, -1)
    if pad:
        flat = flat[:, :flat.shape[1] - pad]
    return flat.reshape((n,) + shape).contiguous()


def _chunked_layout(size: int, n: int, dtype: torch.dtype,
                    seg_bytes: int) -> tuple[int, int]:
    """(rows, seg_rows) of ``ring_allreduce_chunked``'s (n, rows, 128)
    layout: rows aligned to the sublane tile and to whole segments."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    a = _sublane(dtype)
    rows = -(-size // (n * LANES))
    rows = -(-rows // a) * a
    seg_rows = max(a, min(-(-rows // a) * a,
                          (seg_bytes // (LANES * itemsize) // a) * a or a))
    rows = -(-rows // seg_rows) * seg_rows
    return rows, seg_rows


def allreduce_block(b: torch.Tensor, op, *, ring=ring_allreduce
                    ) -> torch.Tensor:
    """Rank-major contributions -> rank-major fully reduced buffer over
    the whole-payload ring. ``ring`` lets a caller run the plain
    version on the same layout."""
    if b.shape[0] == 1:
        return b
    blocks, pad, shape = _split_ring(b)
    return _unsplit(ring(blocks, op), pad, shape)


def allreduce_block_rd(b: torch.Tensor, op, *, rd=ring_allreduce_rd
                       ) -> torch.Tensor:
    """Rank-major allreduce by recursive doubling (power-of-two n)."""
    n = b.shape[0]
    if n == 1:
        return b
    flat = b.reshape(n, -1)
    pad = (-flat.shape[1]) % LANES
    if pad:
        flat = F.pad(flat, (0, pad))
    return _unsplit(rd(flat, op), pad, tuple(b.shape[1:]))


def allreduce_block_chunked(b: torch.Tensor, op,
                            seg_bytes: Optional[int] = None, *,
                            chunked=ring_allreduce_chunked) -> torch.Tensor:
    """Rank-major allreduce over the segmented streaming ring."""
    n = b.shape[0]
    if n == 1:
        return b
    if seg_bytes is None:
        seg_bytes = _segment_var.value
    flat = b.reshape(n, -1)
    size = flat.shape[1]
    rows, seg_rows = _chunked_layout(size, n, b.dtype, seg_bytes)
    pad = n * rows * LANES - size
    if pad:
        flat = F.pad(flat, (0, pad))
    out = chunked(flat.reshape(n, n, rows * LANES), op, seg_rows * LANES)
    return _unsplit(out, pad, tuple(b.shape[1:]))


# ---------------------------------------------------------------------------
# Component.
# ---------------------------------------------------------------------------

@COLL.register
class PallasColl(CollComponent):
    NAME = "pallas"
    PRIORITY = 30  # below coll/xla (40): opt-in via coll_select/priority
    DESCRIPTION = "hand-scheduled ring kernels (CUDA, one rank per block)"

    def allreduce(self, comm, x, op):
        op = op_lookup(op)
        x = rank_major_check(comm, x)
        if comm.size == 1:
            return x
        shard_bytes = (x.numel() // comm.size) * x.element_size()
        pof2 = comm.size & (comm.size - 1) == 0
        if shard_bytes > _chunk_threshold_var.value:
            seg = int(_segment_var.value)
            body = allreduce_block_chunked
            key_extra = (seg,)
            fn = lambda b: allreduce_block_chunked(b, op, seg)  # noqa: E731
        elif shard_bytes < _rd_cutoff_var.value and pof2:
            body, key_extra = allreduce_block_rd, ()
            fn = lambda b: allreduce_block_rd(b, op)  # noqa: E731
        else:
            body, key_extra = allreduce_block, ()
            fn = lambda b: allreduce_block(b, op)  # noqa: E731
        key = ("allreduce", "pallas", body.__name__, op.cache_key,
               tuple(x.shape), str(x.dtype)) + key_extra
        return compile_plan(comm, key, fn)(x)
