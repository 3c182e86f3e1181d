"""coll/pallas — the hand-scheduled collective kernels, on Hopper.

Port of ``ompi_tpu/coll/pallas_ring.py``'s allreduce, reduce, bcast,
allgather, reduce_scatter_block, alltoall, gather and scatter paths.
Each Pallas kernel on them is a hand-written CUDA kernel here
(``csrc/``), with a wrapper, a plain version and a launch counter:

- ``ring_allreduce`` (``_allreduce_kernel``): the whole-payload ring,
  2(n-1) steps over a two-slot comm buffer with credits, one pass per
  step: each arrival is folded (or, in the allgather half, stored) and
  forwarded straight into the right neighbour's next slot
  (``simulate_ring_fused``).
- ``ring_allreduce_rd`` (``_allreduce_rd_kernel``): recursive doubling,
  log2 n rounds with one slot and one flag per round, rank-ordered
  combine; up to 8 ranks the ranks' blocks of a stripe form a
  thread-block cluster, each rank's value in registers, the slots and
  flags in the receiving rank's shared memory (``simulate_rd``'s
  "cluster" form), beyond in global memory ("l2").
- ``ring_allreduce_chunked`` (``_allreduce_chunked_kernel``): the ring
  streamed in segments, so comm scratch stays bounded however large the
  message: the 2(n-1) steps of ``ring_allreduce``'s one-pass body in a
  wavefront over segments (``simulate_ring_chunked``), the values handed
  over in a thread-block cluster's shared memory up to 8 ranks, beyond
  in buffers that fit in L2; at n == 1
  ``selfdma_chunked`` (``_selfdma_chunked_kernel``), the identity, runs
  the reference's three stages (in, the copy to itself, out) as bulk
  copies through two pairs of shared-memory slots, pipelined.
- ``ring_reduce_scatter`` (``_reduce_scatter_kernel``) and
  ``ring_allgather`` (``_allgather_kernel``): the two halves of the
  ring, n-1 steps each; one after the other they are the
  ``pallas_rsag`` allreduce, bitwise equal to ``ring_allreduce``. Both
  make one pass per step, segment by segment, in a wavefront: in time
  slot t a rank makes step k of segment t-k for every k; the
  reduce-scatter folds and forwards (``simulate_ring_rs_fused``), the
  allgather stores each arrival and forwards it
  (``simulate_ring_ag_fused``; it moves bytes, any dtype). Up to 8 ranks
  the ranks' blocks of a stripe form a thread-block cluster and hand the
  segments over in each other's shared memory, beyond in buffers that
  fit in L2.
- ``tree_reduce`` (``_tree_reduce_kernel``): binomial reduce to a root,
  as a segmented "get" tree: a parent reads each child's finished row
  segment by segment after that segment's flag, with no comm slot.
- ``tree_bcast`` (``_tree_bcast_kernel``): binomial broadcast from a
  root, as a segmented "get" tree: a child copies each segment of its
  parent's finished row after that segment's flag, every round at once.
- ``ring_allreduce_bidir`` (``_allreduce_bidir_kernel``): the ring in
  both directions at once, half of every ring block each, as two
  independent groups of thread blocks with their own slots and flags,
  each running ``ring_allreduce``'s fold-then-forward body
  (``simulate_ring_bidir``).
- ``ring_alltoall`` (``_alltoall_kernel``): pairwise exchange, one flag
  per step per receiver; it moves bytes, so it takes any dtype.
- ``linear_gather`` (``_gather_kernel``): a pool of blocks per rank
  streams that rank's row into root's rows in pieces drawn from the
  rank's ticket counter, after root's ready credit, each piece counted
  on root's flag for that sender (``simulate_gather``). It moves bytes,
  any dtype.
- ``linear_scatter`` (``_scatter_kernel``): root's blocks, nearly the
  whole card, stream every row in pieces, all rows at once, drawn from
  a ticket counter, each piece counted on its receiver's flag; a
  receiver only waits for its count, no handshake
  (``simulate_scatter``). It moves bytes, any dtype.
- ``ppermute_shift`` (the inner kernel of ``ppermute_shift``): one ring
  hop, every rank's block stored into rank me+shift's row; up to 8 ranks
  the ranks' blocks of a stripe form a thread-block cluster whose
  barrier certifies the receive (``simulate_ppermute``'s "cluster"
  form), beyond one flag per receiver ("flags"); it moves bytes, any
  dtype. Ring attention's KV hop is fused into its own kernel
  (``pallas_attn``).

Ranks on one card: a rank-major ``(n, ...)`` tensor holds n virtual
ranks. A Pallas remote DMA becomes stores into the peer rank's comm slot
followed by a release-increment of the peer's flag; a semaphore wait
becomes an acquire spin on the rank's own flag. Every flag ends each
launch at 0.

Credit placement differs from the reference on purpose. The reference
credits a comm slot to its left neighbour right after FILLING it
(``pallas_ring.py:263-267``, ``:387-391``, and in the two halves
``:159-164``, ``:208-214``, after a post-seed credit ``:135-137``,
``:184-186``), though it still has to send from that slot at the next
step; a left neighbour that runs ahead overwrites the partial before it
is forwarded. The port credits a slot right after the send FROM it
(every step but the last) and drops the post-seed credit.
``simulate_ring`` runs either placement under seeded random
interleavings; the tests show the reference's placement fails there and
the port's does not.

Plain versions: ``simulate_ring``/``simulate_ring_fused``/
``simulate_ring_rs_fused``/``simulate_ring_ag_fused``/
``simulate_ring_chunked``/``simulate_rd``/
``simulate_tree_*``/
``simulate_ring_bidir``/``simulate_alltoall``/``simulate_gather``/
``simulate_scatter``/``simulate_ppermute`` run the same slot and flag
schedule rank by rank on tensors (what ``pallas_lower.simulate`` is to
the JAX package). The
data-movement simulators also record, as a fault, every wait that
returns before the row it certifies has landed. A wrapper uses its
plain version only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises.

Block boundaries equal the JAX package's: ``_split_ring``,
``_chunked_layout`` and ``_pad_chunk`` copy its padding and blocking
math, which decides at which rank each element's reduction starts, and
so the bits of a floating-point sum.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import random
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core import build, config
from ..core.counters import KernelCounter
from ..core.device import require_kernel_device
from ..core.errors import ArgumentError, KernelError
from ..ops import Op, lookup as op_lookup
from .framework import COLL, CollComponent, compile_plan, rank_major_check
from .xla import scatter_buffer

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
_bidir_var = config.register(
    "coll", "pallas", "bidir",
    type=bool, default=False,
    description="Use the bidirectional ring for pallas allreduce "
                "(half the payload round each ring direction)",
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
#: Bytes of a ring block that one thread block of ``ring_allreduce``
#: takes at least (``_ring_plan``).
RING_STRIPE_BYTES = 8192
#: Bytes of a half ring block that one thread block of
#: ``ring_allreduce_bidir`` takes at least, and its threads per block
#: (``_bidir_plan``). The sweep at 1 MiB per rank, n = 8, on an NVIDIA
#: H100 (PERF.md, tools/bidir_table_check.py): 8 stripes x 512 threads
#: 0.0557 ms, the best 16 x 256 (two blocks per SM) 0.0545, every shape
#: of 8 stripes or more 0.054-0.059, 2 stripes 0.068-0.095.
BIDIR_STRIPE_BYTES, BIDIR_THREADS = 8192, 512
#: Columns of a tree-reduce segment: a child publishes its row segment
#: by segment, so its parent folds segment i while it works on later ones.
TREE_SEG_COLS = 1 << 14
#: Threads of a tree-reduce block, and its blocks per SM (csrc/tree_reduce.cu).
TREE_THREADS, TREE_BLOCKS_PER_SM = 512, 2
#: Bytes of a tree-bcast segment, the threads of its blocks and its
#: blocks per SM, split equally over the ranks (csrc/tree_bcast.cu). The
#: best of a sweep at 1 GiB per rank, n = 8, on an NVIDIA H100 (PERF.md,
#: tools/rs_bcast_check.py): 3.955 ms; 128 Ki or 256 Ki bytes with 512 x 1
#: or 1024 x 1 and 64 Ki with 512 x 2 within 8%, 16 Ki with 512 x 1 8.6 ms.
BCAST_SEG_BYTES = 128 << 10
BCAST_THREADS, BCAST_BLOCKS_PER_SM = 512, 1
#: The ring reduce-scatter's plans (csrc/ring_reduce_scatter.cu,
#: ``_rs_plan``): bytes of a segment (one buffer; a stripe takes at least
#: one), threads per block and blocks per SM. Up to ``RS_CLUSTER_RANKS``
#: ranks (the portable cluster size) one cluster of the n ranks' blocks
#: runs each stripe, its buffers and flags in the reading rank's shared
#: memory, a block's buffers within ``RS_SMEM_BYTES``; beyond, the buffers
#: are in HBM, all blocks' within ``RS_SLOT_BYTES`` so that they stay in
#: the 50 MB L2. The sweep at 1 GiB sent per rank, n = 8, on an NVIDIA
#: H100 (PERF.md, tools/rs_bcast_check.py): in shared memory 5.308 ms at
#: 2 KiB, 128 x 4 (256 x 2 at 4 KiB 5.545, 512 x 1 at 8 KiB 5.924); in L2
#: 6.2-6.9 ms for every shape whose buffers take 6-26 MB (but 2-4 KiB
#: segments of 512 threads, which idle them: 11.6-22.2), 8.6-9.3 from 50
#: MB on; `x.sum(0)` 5.64-5.71.
RS_CLUSTER_RANKS = 8
RS_CLUSTER_SEG_BYTES, RS_CLUSTER_THREADS, RS_CLUSTER_BLOCKS_PER_SM = \
    2 << 10, 128, 4
RS_SEG_BYTES, RS_THREADS, RS_BLOCKS_PER_SM = 8 << 10, 512, 1
RS_SMEM_BYTES, RS_SLOT_BYTES = 48 << 10, 24 << 20
#: The ring allgather's plans (csrc/ring_allgather.cu, ``_ag_plan``), in
#: the same two forms and budgets as the reduce-scatter's. The best of a
#: sweep at 1 GiB received per rank, n = 8, on an NVIDIA H100 (PERF.md,
#: tools/ag_selfdma_check.py): in shared memory 4.153 ms at 4 KiB, 256 x 4
#: (2 KiB with 128 x 8 4.380; 128 x 4 at 2 KiB 5.326; 512 x 1 5.0-13.6);
#: in L2 5.790 at 4 KiB, 256 x 2 (5.9-15.2 otherwise); the library 6.841.
AG_CLUSTER_SEG_BYTES, AG_CLUSTER_THREADS, AG_CLUSTER_BLOCKS_PER_SM = \
    4 << 10, 256, 4
AG_SEG_BYTES, AG_THREADS, AG_BLOCKS_PER_SM = 4 << 10, 256, 2
#: The chunked ring's plans (csrc/ring_allreduce_chunked.cu,
#: ``_chunked_plan``), in the reduce-scatter's two forms; a block keeps
#: (2n-3) x RS_BUFS buffers, so its shared memory holds fewer segments:
#: the blocks of an SM share ``CHUNKED_SMEM_BYTES``. The sweep at 1 GiB
#: per rank, n = 8, on an NVIDIA H100 (PERF.md,
#: tools/scatter_chunked_check.py): in shared memory 7.84 ms at 2 KiB
#: segments, 128 threads x 4 blocks per SM (4 KiB with 256 x 2 8.39, with
#: 512 x 1 11.11; 2 KiB with 256 x 2 10.75, with 512 x 1 18.90; 1 KiB
#: with 128 x 4 10.59, with 256 x 2 19.82); in L2 11.22 at 8 KiB with 512
#: x 1, 11.49 at 4 KiB with 256 x 2, 11.68 at 2 KiB with 128 x 4, 13.22 at
#: 4 KiB with 512 x 1; ``allreduce_block_rsag`` 8.70 and the library 12.30
#: in another run.
CHUNKED_CLUSTER_SEG_BYTES, CHUNKED_CLUSTER_THREADS, \
    CHUNKED_CLUSTER_BLOCKS_PER_SM = 2 << 10, 128, 4
CHUNKED_SEG_BYTES, CHUNKED_THREADS, CHUNKED_BLOCKS_PER_SM = 4 << 10, 256, 2
CHUNKED_SMEM_BYTES = 216 << 10
#: The linear scatter's plan (csrc/linear_scatter.cu, ``_scatter_plan``):
#: bytes of a piece of a row, threads per block and blocks per SM; root
#: takes every block but the n - 1 receivers'. Sweeps at 1 GiB per rank,
#: n = 8, on an NVIDIA H100 (PERF.md, tools/scatter_chunked_check.py),
#: root's blocks drawing pieces from a ticket counter: 64 KiB x 256
#: threads x 2 per SM 5.748-5.755 ms, 512 x 2 5.768-5.804, 1024 x 1
#: 5.836-5.838, 256 KiB pieces 5.83-5.90, 16 KiB 6.32, eight loads in
#: flight or evict-first hints within 1%; ``x.clone()`` 5.675-5.696 in the
#: same runs. A fixed share of pieces per block took 5.94-6.12.
SCATTER_PIECE_BYTES, SCATTER_THREADS, SCATTER_BLOCKS_PER_SM = \
    64 << 10, 256, 2
#: The linear gather's plan (csrc/linear_gather.cu, ``_gather_plan``):
#: bytes of a piece of a row, threads per block and blocks per SM; the
#: resident slots are split into n pools, one per rank, and a rank's
#: group of flags takes ``GATHER_WORDS`` int32 (a 32-byte sector). A
#: sender's block publishes every ``GATHER_PUBLISH_PIECES`` pieces.
#: Sweeps at 1 GiB per rank, n = 8, on an NVIDIA H100 (PERF.md,
#: tools/gather_rd_check.py): 64 KiB x 256 threads x 2 per SM 5.765 ms,
#: 512 x 1 5.770, 16 KiB x 256 x 4 5.786, 1024 x 1 5.868, 256 KiB pieces
#: 5.85-5.92, 16 KiB pieces with 1024 or 512 threads a SM 7.35-7.39;
#: ``x.clone()`` 5.680 in the same run. Publishing every 1, 2, 4, 8, 16 or
#: 64 pieces: 5.946-5.998 against ``x.clone()`` 5.801 in one slower run,
#: every 8 or 16 the best; a fence a piece left every sender pool 0.44 ms
#: behind root's (a probe build), 8 pieces a fence 0.14.
GATHER_PIECE_BYTES, GATHER_THREADS, GATHER_BLOCKS_PER_SM = \
    64 << 10, 256, 2
GATHER_PUBLISH_PIECES = 8
GATHER_WORDS = 8
#: Recursive doubling's plans (csrc/ring_allreduce_rd.cu, ``_rd_plan``):
#: up to ``RS_CLUSTER_RANKS`` ranks one cluster of the n ranks' blocks per
#: column stripe of at most ``RD_STRIPE_BYTES``, a thread per 16-byte
#: vector, its rounds' slots (at most ``RD_MAX_ROUNDS``) in the receiving
#: rank's shared memory; beyond, the L2 form's stripes of at least
#: ``STRIPE_COLS`` columns, 1024 threads. At 4 KiB per rank, n = 8, on an
#: NVIDIA H100 (PERF.md, tools/gather_rd_check.py) the cluster form takes
#: 4.3 µs on the card against the L2 form's 8.3; by events stripes of
#: 256 B to 4 KiB gave 0.0249-0.0252 ms, the L2 form 0.0276, in turns.
RD_STRIPE_BYTES, RD_MAX_ROUNDS = 16 << 10, 3
#: Bytes of a piece of ``selfdma_chunked``'s bulk-copy pipeline (its
#: shared memory holds four) and its blocks per SM. Sweeps at 1 GiB on an
#: NVIDIA H100 (PERF.md, tools/ag_selfdma_check.py): 8 KiB x 4 0.753-0.786
#: ms, 16 KiB x 2 or 3 0.766-0.800, 4 KiB x 6 0.786, 32 KiB x 1 0.85;
#: ``x.clone()`` 0.725-0.755 in the same runs.
SELFDMA_PIECE_BYTES, SELFDMA_BLOCKS_PER_SM = 8 << 10, 4
#: The ring hop's plans (csrc/ppermute_shift.cu, ``_hop_plan``): bytes of
#: a row that one block copies at least; up to ``RS_CLUSTER_RANKS`` ranks
#: one cluster of the n ranks' blocks per stripe, ``HOP_STRIPES_PER_SM``
#: stripes a rank for each SM, each block one warp whose first thread
#: streams its stripe in bulk copies of ``HOP_PIECE_BYTES`` (rows of whole
#: 16-byte vectors) or ``HOP_THREADS`` threads that copy it; beyond, the
#: flags form's resident blocks of 1024 threads. A bulk block's four
#: pieces take 64 KiB of shared memory, so at most three reside on an SM
#: and the cluster launch runs the grid in waves: the stripe count sets
#: how the row is cut, not a residency. The sweeps at 8 MiB of bfloat16
#: per rank, n = 8, on an NVIDIA H100 (PERF.md, tools/quant_hop_check.py),
#: times on the card: bulk pieces of 16 KiB in stripes of at least two,
#: 8 stripes a SM (132 stripes) 0.0484 ms, 4 a SM 0.0496, 2 a SM 0.0508;
#: 8 KiB 0.0501-0.0585, 4 KiB 0.0577-0.0591; the threads' copy
#: 0.0503-0.0542 over stripes of 16 KiB to 1 MiB, 256 to 1024 threads and
#: 1 to 8 stripes a SM; the device-to-device memcpy of the same bytes
#: 0.0452.
HOP_STRIPE_BYTES, HOP_PIECE_BYTES, HOP_THREADS, HOP_STRIPES_PER_SM = \
    32 << 10, 16 << 10, 512, 8
#: Buffers per step of the reduce-scatter's and the allgather's
#: wavefronts, one for each parity of the time slot
#: (``simulate_ring_rs_fused``, ``simulate_ring_ag_fused``).
RS_BUFS = 2
#: Most segments (or pieces) per row or ring block in the plain versions
#: of the segmented kernels: the simulators take a Python step per
#: segment, and no bit depends on the segment.
PLAIN_SEGS = 64

RING = KernelCounter("ring_allreduce")
RD = KernelCounter("ring_allreduce_rd")
CHUNKED = KernelCounter("ring_allreduce_chunked")
RS = KernelCounter("ring_reduce_scatter")
AG = KernelCounter("ring_allgather")
TREE_REDUCE = KernelCounter("tree_reduce")
TREE_BCAST = KernelCounter("tree_bcast")
BIDIR = KernelCounter("ring_allreduce_bidir")
ALLTOALL = KernelCounter("ring_alltoall")
GATHER = KernelCounter("linear_gather")
SCATTER = KernelCounter("linear_scatter")
SELFDMA = KernelCounter("selfdma_chunked")
PPERMUTE = KernelCounter("ppermute_shift")

_OP_CODES = {"sum": 0, "prod": 1, "max": 2, "min": 3}
#: The reduction kernels' element types (csrc/ring_common.cuh's
#: DtypeCode): each kernel is instantiated for every pair of these and
#: ``_OP_CODES``.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2,
                torch.float64: 3, torch.float16: 4, torch.int8: 5,
                torch.uint8: 6}


# ---------------------------------------------------------------------------
# Protocol simulator: the plain versions of the kernels.
# ---------------------------------------------------------------------------

#: A wait that is always satisfied: a bare scheduling point.
_PAUSE = (None, 0)


def _drive(programs: list, sems: dict, rng: Optional[random.Random]) -> None:
    """Run rank programs to completion. A program is a generator that
    yields ``(flag key, count)`` when it waits, or a list of such pairs
    to wait for all of them (as a kernel's lanes wait, one flag each,
    before one block barrier); a wait is satisfied when each flag is at
    least its count, and then consumes the counts. Every wait is a
    scheduling point: with ``rng`` None the ranks take turns in ring
    order (lock-step), with a ``random.Random`` a ready rank is picked
    at random. A copy or a signal between two waits is atomic, as a DMA
    is at its start; a program yields ``_PAUSE`` where another rank may
    run between two of its actions without a wait. The flags of a list
    wait must have no other waiter: a flag found high enough is not
    checked again until its waiter runs."""
    nranks = len(programs)
    waiting: dict = {r: [] for r in range(nranks)}
    met = dict.fromkeys(waiting, 0)  # a list wait's flags found high enough
    last = nranks - 1
    while waiting:
        ready = []
        for r, w in waiting.items():
            i, n_w = met[r], len(w)
            while i < n_w and sems[w[i][0]] >= w[i][1]:
                i += 1
            if n_w > 1:
                met[r] = i
            if i == n_w:
                ready.append(r)
        if not ready:
            raise RuntimeError(f"protocol deadlock, ranks waiting on "
                               f"{waiting}")
        if rng is None:
            r = min(ready, key=lambda q: (q - last - 1) % nranks)
        else:
            r = rng.choice(ready)
        last = r
        for key, count in waiting[r]:
            sems[key] -= count
        met[r] = 0
        try:
            w = next(programs[r])
            waiting[r] = w if isinstance(w, list) else [w]
        except StopIteration:
            del waiting[r]


def _residue(sems: dict) -> dict:
    return {k: v for k, v in sems.items() if v}


def _ring_blocks(x: torch.Tensor, rs: bool) -> tuple[int, int]:
    """(n, W) of ring input x: (n, n, W) blocks when the schedule
    reduce-scatters, the (n, W) own blocks of an allgather alone."""
    n, W = x.shape[0], x.shape[-1]
    if tuple(x.shape) != ((n, n, W) if rs else (n, W)):
        raise ArgumentError(
            f"ring input must be {'(n, n, W)' if rs else '(n, W)'}, got "
            f"{tuple(x.shape)}")
    return n, W


def _ring_programs(x: torch.Tensor, out: torch.Tensor, op: Optional[Op],
                   seg: int, sems: dict, *, segmented: bool, credit: str,
                   phase: str, direction: int, tag: tuple = ()) -> list:
    """The n rank programs of one ring over ``x`` into ``out`` (either
    may be a column view), with its own comm slots and with flags keyed
    (rank, *tag, name, slot). ``direction`` +1 sends to rank me+1 (the
    ring of ``ring_allreduce``), -1 to rank me-1; block indices mirror
    with it (``blk = me - direction·(step + 2)``, as in the JAX
    package's bidirectional kernel)."""
    rs, ag = phase != "ag", phase != "rs"
    n, W = x.shape[0], x.shape[-1]
    n_segs = W // seg
    comm = x.new_empty((n, 2, seg))
    rs_steps = n - 1 if rs else 0
    nsteps = rs_steps + (n - 1 if ag else 0)
    d = direction

    def rank(me):
        left, right = (me - d) % n, (me + d) % n
        xr, o = x[me], out[me]
        own = o[me] if ag else o  # where this rank's own block ends up
        if segmented:
            sems[(left,) + tag + ("seg",)] += 1
        for si in range(n_segs):
            cols = slice(si * seg, (si + 1) * seg)
            if segmented:
                yield (me,) + tag + ("seg",), 1
            comm[me, 0] = xr[left, cols] if rs else xr[cols]
            if not rs:
                own[cols] = xr[cols]
            if credit == "reference" and nsteps > 1:
                sems[(left,) + tag + ("cap", 0)] += 1
            # The seed is not sent with the post-seed credit's signal.
            yield _PAUSE
            for step in range(nsteps):
                slot, nslot = step % 2, (step + 1) % 2
                if step >= 1:
                    yield (me,) + tag + ("cap", nslot), 1
                comm[right, nslot] = comm[me, slot]
                sems[(right,) + tag + ("recv", nslot)] += 1
                if credit == "port" and step < nsteps - 1:
                    sems[(left,) + tag + ("cap", slot)] += 1
                yield (me,) + tag + ("recv", nslot), 1
                if step < rs_steps:
                    blk = (me - d * (step + 2)) % n
                    val = op.combine(comm[me, nslot], xr[blk, cols])
                    comm[me, nslot] = val
                    if step == n - 2:
                        own[cols] = val
                else:
                    blk = (me - d * (step - rs_steps + 1)) % n
                    o[blk, cols] = comm[me, nslot]
                if credit == "reference" and step < nsteps - 2:
                    sems[(left,) + tag + ("cap", nslot)] += 1
            if segmented:
                sems[(left,) + tag + ("seg",)] += 1
        if segmented:
            yield (me,) + tag + ("seg",), 1

    return [rank(r) for r in range(n)]


def _check_credit(credit: str) -> None:
    if credit not in ("port", "reference"):
        raise ArgumentError(f"unknown credit placement {credit!r}")


def simulate_ring(x: torch.Tensor, op: Optional[Op],
                  seg_cols: Optional[int] = None, *, segmented: bool = False,
                  credit: str = "port", rng: Optional[random.Random] = None,
                  phase: str = "both"):
    """Run the ring schedule on ``x`` segment by segment of ``seg_cols``
    columns. ``phase`` picks the halves, as the kernels' ``RingPhase``
    does: "both" (the allreduce) takes and returns (rank, block, col)
    blocks of shape (n, n, W); "rs" (reduce-scatter) takes (n, n, W)
    and returns (n, W), each rank's own reduced block; "ag" (allgather,
    ``op`` unused) takes each rank's own block (n, W) and returns
    (n, n, W). Returns (out, residue): residue maps every flag not back
    at 0 to its count.

    ``segmented`` adds the chunked kernel's per-segment credit (primed
    once, granted after each segment, drained at exit). ``credit``
    "port" is the kernels' placement; "reference" is the JAX package's
    (a post-seed credit, then a credit right after filling a slot)."""
    _check_credit(credit)
    if phase not in ("both", "rs", "ag"):
        raise ArgumentError(f"unknown ring phase {phase!r}")
    rs, ag = phase != "ag", phase != "rs"
    n, W = _ring_blocks(x, rs)
    seg = W if seg_cols is None else seg_cols
    if seg <= 0 or W % seg:
        raise ArgumentError(f"segment {seg} does not divide {W}")
    out = x.new_empty((n, n, W) if ag else (n, W))
    sems: dict = collections.defaultdict(int)
    _drive(_ring_programs(x, out, op, seg, sems, segmented=segmented,
                          credit=credit, phase=phase, direction=1),
           sems, rng)
    return out, _residue(sems)


def _fused_ring_programs(blocks: torch.Tensor, out: torch.Tensor, op: Op,
                         sems: dict, *, credit: str, direction: int,
                         tag: tuple = ()) -> list:
    """The n rank programs of ``ring_allreduce``'s fold-then-forward ring
    over ``blocks`` into ``out`` (either may be a column view), with its
    own comm slots and with flags keyed (rank, *tag, name, slot).
    ``direction`` +1 sends to rank me+1, -1 to rank me-1, with the block
    indices mirrored (``blk = me - direction·(k + 2)``, as in the JAX
    package's bidirectional kernel)."""
    n, C = blocks.shape[0], blocks.shape[-1]
    nsteps = 2 * (n - 1)
    comm = blocks.new_zeros((n, 2, C))
    d = direction

    def rank(me):
        left, right = (me - d) % n, (me + d) % n
        for k in range(nsteps):
            send, credit_slot = k < nsteps - 1, 1 <= k <= nsteps - 3
            if k:
                yield (me,) + tag + ("recv", k % 2), 1
            if send and k >= 2:
                yield (me,) + tag + ("cap", (k + 1) % 2), 1
            if credit == "before_read" and credit_slot:
                sems[(left,) + tag + ("cap", k % 2)] += 1
                yield _PAUSE
            arrival = (blocks[left, (me - 2 * d) % n] if k == 0
                       else comm[me, k % 2])
            if k < n - 1:
                val = op.combine(arrival, blocks[me, (me - d * (k + 2)) % n])
                if k == n - 2:
                    out[me, me] = val
            else:
                val = arrival.clone()
                out[me, (me - d * (k - n + 2)) % n] = val
            if send:
                comm[right, (k + 1) % 2] = val
                sems[(right,) + tag + ("recv", (k + 1) % 2)] += 1
            if credit == "after_read" and credit_slot:
                sems[(left,) + tag + ("cap", k % 2)] += 1

    return [rank(r) for r in range(n)]


def _check_fused_credit(credit: str) -> None:
    if credit not in ("after_read", "before_read"):
        raise ArgumentError(f"unknown credit placement {credit!r}")


def simulate_ring_fused(blocks: torch.Tensor, op: Op, *,
                        credit: str = "after_read", direction: int = 1,
                        rng: Optional[random.Random] = None):
    """Run ``ring_allreduce``'s fold-then-forward ring on (n, n, C)
    blocks. Rank me takes 2(n-1) arrivals from its left neighbour (its
    right one for ``direction`` -1, with the block indices mirrored);
    arrival k lands in its slot k % 2, except arrival 0, the left
    neighbour's block me-2, which it reads straight from that neighbour's
    input. For each arrival it waits for the slot's flag (and, before its
    third and later sends, for the right neighbour's credit on the slot
    it sends into), then makes one pass: at a reduce-scatter step (k <
    n-1) it folds ``combine(arrival, x[me][me-k-2])``, the JAX package's
    operands in its order, writing out[me][me] at the last one; at an
    allgather step it stores the arrival to out[me][me-(k-n+1)-1]. The
    pass stores its result straight into the right neighbour's slot (k +
    1) % 2 (every step but the last) and signals it; then it credits its
    own slot back to the left neighbour (arrivals 1 .. 2n-5, whose slots
    the left fills again). ``credit`` "before_read" credits the slot
    before the pass that reads it: the negative control. Returns (out,
    residue) as ``simulate_ring`` does."""
    _check_fused_credit(credit)
    if direction not in (1, -1):
        raise ArgumentError(f"ring direction must be 1 or -1, got "
                            f"{direction}")
    _ring_blocks(blocks, True)
    out = torch.zeros_like(blocks)
    sems: dict = collections.defaultdict(int)
    _drive(_fused_ring_programs(blocks, out, op, sems, credit=credit,
                                direction=direction), sems, rng)
    return out, _residue(sems)


def _rs_forwards(p: int, n: int, n_segs: int) -> bool:
    """Whether time slot ``p`` of the reduce-scatter's wavefront has a
    pass that forwards into the right neighbour's buffers: a step k in
    0 .. n-3 whose segment p - k is in 0 .. n_segs-1."""
    return p >= 0 and n > 2 and p - n_segs + 1 <= n - 3


def simulate_ring_rs_fused(blocks: torch.Tensor, op: Op, *,
                           seg_cols: Optional[int] = None,
                           credit: str = "after_read",
                           rng: Optional[random.Random] = None):
    """Run ``ring_reduce_scatter``'s fold-then-forward wavefront on (n,
    n, W) blocks, each cut into segments of ``seg_cols`` columns (the
    last ragged; default one). Step k of segment i at rank me folds
    ``combine(arrival, x[me][me-k-2])``, the JAX package's operands in
    its order; step 0's arrival is the left neighbour's block me-2 of its
    input, step k's the left's step k-1 of the same segment, and step n-2
    writes out[me]. In time slot t rank me makes step k of segment
    t - k for every k that has one, so the arrivals it reads were made
    in the left's slot t - 1: they sit in its buffers (k, t mod 2), and
    it stores into the right's buffers (k+1, (t + 1) mod 2). Before slot
    t it waits for the left's arrivals (one recv flag per parity) and,
    before it forwards into the buffers the right read in slot t - 1,
    for the right's credit; after its passes it raises the right's recv
    flag and credits the parity it read to the left where the left
    writes it again. Every wait and raise is
    made only where the other side has its counterpart, so every flag
    ends at 0. ``credit`` "before_read" credits before the passes: the
    negative control. Returns (out (n, W), residue) as ``simulate_ring``
    does."""
    _check_fused_credit(credit)
    n, W = _ring_blocks(blocks, True)
    seg = W if seg_cols is None else seg_cols
    if seg <= 0:
        raise ArgumentError(f"bad wavefront segment {seg}")
    n_segs = -(-W // seg)
    out = blocks.new_zeros((n, W))
    comm = blocks.new_zeros((n, max(n - 2, 0), RS_BUFS, seg))
    sems: dict = collections.defaultdict(int)

    def fwd(p):
        return _rs_forwards(p, n, n_segs)

    def rank(me):
        left, right = (me - 1) % n, (me + 1) % n
        for t in range(n_segs + n - 2):
            if fwd(t - 1):
                yield (me, "recv", t % 2), 1
            if fwd(t) and fwd(t - 2):
                yield (me, "cap", (t + 1) % 2), 1
            credit_slot = fwd(t - 1) and fwd(t + 1)
            if credit == "before_read" and credit_slot:
                sems[left, "cap", t % 2] += 1
                yield _PAUSE
            for k in range(max(0, t - n_segs + 1), min(n - 2, t) + 1):
                cols = slice((t - k) * seg, min(W, (t - k + 1) * seg))
                w = cols.stop - cols.start
                arrival = (blocks[left, (me - 2) % n, cols] if k == 0
                           else comm[me, k - 1, t % 2, :w])
                val = op.combine(arrival, blocks[me, (me - k - 2) % n, cols])
                if k == n - 2:
                    out[me, cols] = val
                else:
                    comm[right, k, (t + 1) % 2, :w] = val
            if fwd(t):
                sems[right, "recv", (t + 1) % 2] += 1
            if credit == "after_read" and credit_slot:
                sems[left, "cap", t % 2] += 1

    _drive([rank(r) for r in range(n)], sems, rng)
    return out, _residue(sems)


def simulate_ring_ag_fused(x: torch.Tensor, *,
                           seg_cols: Optional[int] = None, stripes: int = 1,
                           credit: str = "after_read",
                           rng: Optional[random.Random] = None):
    """Run ``ring_allgather``'s one-pass wavefront on (n, W) own blocks;
    returns ((n, n, W) out, residue) as ``simulate_ring`` does. The
    columns are cut into ``stripes`` stripes, each a thread block of
    every rank with its own buffers and flags (one program per (rank,
    stripe)), and each stripe into segments of ``seg_cols`` columns (the
    last ragged; default one). Step k of segment i at rank me takes block
    me-k-1: step 0 reads it from the left rank's x, step k the left's
    step k-1 of the same segment from its buffer; it stores the arrival
    to out[me][me-k-1] and, but at the last step n-2, straight into the
    right's buffer for step k+1. In time slot t rank me makes step k of
    segment t - k for every k that has one, and copies x[me]'s segment t
    to out[me][me]; the arrivals it reads were made in the left's slot
    t - 1, in buffers (k, t mod 2). Waits and raises are those of
    ``simulate_ring_rs_fused`` (``_rs_forwards``), so every flag ends at
    0. ``credit`` "before_read" credits a buffer to the left before the
    passes that read it: the negative control. ``credit`` "reference" runs
    the JAX package's two-pass allgather instead (``simulate_ring(phase=
    "ag", credit="reference")``: a post-seed credit, then a credit right
    after filling a slot)."""
    if credit not in ("after_read", "before_read", "reference"):
        raise ArgumentError(f"unknown credit placement {credit!r}")
    if credit == "reference":
        return simulate_ring(x, None, credit="reference", phase="ag", rng=rng)
    n, W = _ring_blocks(x, False)
    if stripes < 1:
        raise ArgumentError(f"bad stripe count {stripes}")
    sw = -(-W // stripes)
    seg = sw if seg_cols is None else seg_cols
    if seg <= 0:
        raise ArgumentError(f"bad wavefront segment {seg}")
    n_segs = max(1, -(-sw // seg))
    out = x.new_zeros((n, n, W))
    # The passes copy bytes: on the CPU through numpy views of the
    # tensors' bytes, several times faster to slice than tensors.
    e = x.element_size()
    xb, ob = x.contiguous().view(torch.uint8), out.view(torch.uint8)
    comm = torch.zeros((n, stripes, max(n - 2, 0), RS_BUFS, seg * e),
                       dtype=torch.uint8, device=x.device)
    if x.device.type == "cpu":
        xb, ob, comm = xb.numpy(), ob.numpy(), comm.numpy()
    sems: dict = collections.defaultdict(int)

    def fwd(p):
        return _rs_forwards(p, n, n_segs)

    def rank(me, s):
        left, right = (me - 1) % n, (me + 1) % n
        c0, c1 = min(W, s * sw), min(W, (s + 1) * sw)

        def cols(i):  # segment i's bytes
            return slice(e * min(c1, c0 + i * seg),
                         e * min(c1, c0 + (i + 1) * seg))

        for t in range(n_segs + n - 2):
            if fwd(t - 1):
                yield (me, s, "recv", t % 2), 1
            if fwd(t) and fwd(t - 2):
                yield (me, s, "cap", (t + 1) % 2), 1
            credit_slot = fwd(t - 1) and fwd(t + 1)
            if credit == "before_read" and credit_slot:
                sems[left, s, "cap", t % 2] += 1
                yield _PAUSE
            if t < n_segs:
                ob[me, me, cols(t)] = xb[me, cols(t)]
            for k in range(max(0, t - n_segs + 1), min(n - 2, t) + 1):
                c = cols(t - k)
                w = c.stop - c.start
                arrival = (xb[left, c] if k == 0
                           else comm[me, s, k - 1, t % 2, :w])
                ob[me, (me - k - 1) % n, c] = arrival
                if k < n - 2:
                    comm[right, s, k, (t + 1) % 2, :w] = arrival
            if fwd(t):
                sems[right, s, "recv", (t + 1) % 2] += 1
            if credit == "after_read" and credit_slot:
                sems[left, s, "cap", t % 2] += 1

    _drive([rank(r, s) for s in range(stripes) for r in range(n)], sems, rng)
    return out, _residue(sems)


#: numpy's counterparts of the predefined ops, elementwise in the same
#: arithmetic as torch's on the CPU, for simulators that slice numpy
#: views (several times faster to slice than tensors).
_NP_COMBINE = {"sum": np.add, "prod": np.multiply, "max": np.maximum,
               "min": np.minimum}


def _np_combine(x: torch.Tensor, op: Op):
    """numpy's combine for ``op`` on x's dtype where a simulator may run
    on numpy views of CPU tensors (float32, int32), else None."""
    if (x.device.type != "cpu" or x.dtype not in (torch.float32, torch.int32)
            or not op.predefined):
        return None
    return _NP_COMBINE.get(op.name)


def _ch_forwards(p: int, n: int, n_segs: int) -> bool:
    """Whether time slot ``p`` of the chunked ring's wavefront has a pass
    that forwards into the right neighbour's buffers: a step k in
    0 .. 2n-4 whose segment p - k is in 0 .. n_segs-1."""
    return p >= 0 and p - n_segs + 1 <= 2 * n - 4


def simulate_ring_chunked(blocks: torch.Tensor, op: Op, *,
                          seg_cols: Optional[int] = None, stripes: int = 1,
                          credit: str = "after_read",
                          rng: Optional[random.Random] = None):
    """Run ``ring_allreduce_chunked``'s one-pass wavefront on (n, n, W)
    blocks; returns ((n, n, W) out, residue) as ``simulate_ring`` does.
    The columns are cut into ``stripes`` stripes, each a thread block of
    every rank with its own buffers and flags (one program per (rank,
    stripe)), and each stripe into segments of ``seg_cols`` columns (the
    last ragged; default one). Step k of segment i at rank me is
    ``simulate_ring_fused``'s step k on those columns: a reduce-scatter
    step (k < n-1) folds ``combine(arrival, x[me][me-k-2])``, writing
    out[me][me] at k = n-2; an allgather step stores the arrival to
    out[me][me-(k-n+2)]; every step but the last stores its value into
    the right's buffer for step k+1; step 0's arrival is the left's block
    me-2 of its input. In time slot t rank me makes step k of segment
    t - k for every k that has one, so the arrivals it reads were made in
    the left's slot t - 1, in buffers (k, t mod 2). Waits and raises are
    those of ``simulate_ring_rs_fused`` over 2(n-1) steps
    (``_ch_forwards``), so every flag ends at 0. ``credit``
    "before_read" credits a buffer to the left before the passes that
    read it: the negative control. ``credit`` "reference" runs the JAX
    package's schedule instead (``simulate_ring(segmented=True,
    credit="reference")`` over segments of ``seg_cols``: a post-seed
    credit, then a credit right after filling a slot)."""
    if credit not in ("after_read", "before_read", "reference"):
        raise ArgumentError(f"unknown credit placement {credit!r}")
    if credit == "reference":
        return simulate_ring(blocks, op, seg_cols, segmented=True,
                             credit="reference", rng=rng)
    n, W = _ring_blocks(blocks, True)
    if stripes < 1:
        raise ArgumentError(f"bad stripe count {stripes}")
    sw = -(-W // stripes)
    seg = sw if seg_cols is None else seg_cols
    if seg <= 0:
        raise ArgumentError(f"bad wavefront segment {seg}")
    n_segs = max(1, -(-sw // seg))
    nsteps = 2 * (n - 1)
    out = torch.zeros_like(blocks)
    comm = blocks.new_zeros((n, stripes, nsteps - 1, RS_BUFS, seg))
    x, o, combine = blocks, out, _np_combine(blocks, op)
    if combine is None:
        combine = op.combine
    else:  # numpy views: faster slices
        x, o, comm = blocks.numpy(), out.numpy(), comm.numpy()
    sems: dict = collections.defaultdict(int)

    def fwd(p):
        return _ch_forwards(p, n, n_segs)

    def rank(me, s):
        left, right = (me - 1) % n, (me + 1) % n
        c0, c1 = min(W, s * sw), min(W, (s + 1) * sw)

        def cols(i):
            return slice(min(c1, c0 + i * seg), min(c1, c0 + (i + 1) * seg))

        for t in range(n_segs + nsteps - 1):
            if fwd(t - 1):
                yield (me, s, "recv", t % 2), 1
            if fwd(t) and fwd(t - 2):
                yield (me, s, "cap", (t + 1) % 2), 1
            credit_slot = fwd(t - 1) and fwd(t + 1)
            if credit == "before_read" and credit_slot:
                sems[left, s, "cap", t % 2] += 1
                yield _PAUSE
            for k in range(max(0, t - n_segs + 1), min(nsteps - 1, t) + 1):
                c = cols(t - k)
                w = c.stop - c.start
                arrival = (x[left, (me - 2) % n, c] if k == 0
                           else comm[me, s, k - 1, t % 2, :w])
                if k < n - 1:
                    val = combine(arrival, x[me, (me - k - 2) % n, c])
                    if k == n - 2:
                        o[me, me, c] = val
                else:
                    val = arrival
                    o[me, (me - k + n - 2) % n, c] = val
                if k < nsteps - 1:
                    comm[right, s, k, (t + 1) % 2, :w] = val
            if fwd(t):
                sems[right, s, "recv", (t + 1) % 2] += 1
            if credit == "after_read" and credit_slot:
                sems[left, s, "cap", t % 2] += 1

    _drive([rank(r, s) for s in range(stripes) for r in range(n)], sems, rng)
    return out, _residue(sems)


def simulate_ring_bidir(blocks: torch.Tensor, op: Op, *,
                        credit: str = "after_read",
                        rng: Optional[random.Random] = None,
                        shared_flags: bool = False):
    """Run the bidirectional ring on (n, n, C) blocks, C even: columns
    [0, C/2) of every block go round ``simulate_ring_fused``'s ring to
    the right, [C/2, C) round it to the left (``direction`` -1), two
    independent rings with their own comm slots and flags, at the same
    time. ``shared_flags`` makes the two share one set of flags: the
    negative control, since at n = 2 both directions signal the same
    neighbour. ``credit`` "after_read" is the kernel's placement and
    "before_read" the fused ring's negative control; "reference" runs
    the JAX package's two-pass rings with its placement (a post-seed
    credit, then a credit right after filling a slot: the race ROADMAP
    Queue 3 records). Returns (out, residue) as ``simulate_ring``
    does."""
    if credit not in ("after_read", "before_read", "reference"):
        raise ArgumentError(f"unknown credit placement {credit!r}")
    n, C = _ring_blocks(blocks, True)
    if C % 2:
        raise ArgumentError(f"bidirectional ring needs even blocks, got {C}")
    half = C // 2
    out = torch.zeros_like(blocks)
    sems: dict = collections.defaultdict(int)
    programs = []
    for d, cols in ((1, slice(0, half)), (-1, slice(half, C))):
        tag = () if shared_flags else (d,)
        if credit == "reference":
            programs += _ring_programs(
                blocks[..., cols], out[..., cols], op, half, sems,
                segmented=False, credit=credit, phase="both", direction=d,
                tag=tag)
        else:
            programs += _fused_ring_programs(
                blocks[..., cols], out[..., cols], op, sems, credit=credit,
                direction=d, tag=tag)
    _drive(programs, sems, rng)
    return out, _residue(sems)


def _check_flags(flags: str) -> None:
    if flags not in ("port", "shared"):
        raise ArgumentError(f"unknown flag layout {flags!r}")


def _early(sems: dict, landed: set, rank: int, row: int) -> None:
    """A wait of ``rank`` certifying that ``row`` has landed returned:
    record a fault in the residue if it has not."""
    if (rank, row) not in landed:
        sems["early", rank, row] += 1


def simulate_alltoall(x: torch.Tensor, *, flags: str = "port",
                      rng: Optional[random.Random] = None):
    """Run the pairwise alltoall on (n, n, W): rank me copies its own
    block, then at step s stores block me+s into rank me+s's row me,
    signals that rank's step-s flag and waits for its own step-s flag,
    which certifies that row me-s has landed. ``flags`` "shared" rotates
    two flags (step % 2) instead of one per step: the hazard the JAX
    package's docstring names (a later step's store satisfies an earlier
    step's wait). Returns (out, residue); residue also holds every wait
    that returned before the row it certifies had landed."""
    _check_flags(flags)
    n = x.shape[0]
    out = torch.empty_like(x)
    sems: dict = collections.defaultdict(int)
    landed: set = set()

    def flag(step):
        return step if flags == "port" else step % 2

    def rank(me):
        out[me, me] = x[me, me]
        for step in range(1, n):
            dst = (me + step) % n
            out[dst, me] = x[me, dst]
            landed.add((dst, me))
            sems[dst, "recv", flag(step)] += 1
            yield (me, "recv", flag(step)), 1
            _early(sems, landed, me, (me - step) % n)

    _drive([rank(r) for r in range(n)], sems, rng)
    return out, _residue(sems)


def simulate_gather(flat: torch.Tensor, root: int = 0, *,
                    flags: str = "port", piece_cols: Optional[int] = None,
                    blocks=1, publish: int = 1,
                    rng: Optional[random.Random] = None):
    """Run the linear gather on (n, L) as its kernel does: every row is
    cut into pieces of ``piece_cols`` columns (the last ragged; default
    the whole row), and rank q's pool of programs (its thread blocks;
    ``blocks`` per pool, or a list of n pool sizes) draws row q's pieces
    from q's ticket counter, as the interleaving lets them run. Root's
    first program grants every sender its ready credit as it starts;
    each of a sender's programs reads the credit (without taking it)
    before its first store. A program stores its piece into root's row q
    and draws its next ticket; a sender's program publishes every
    ``publish`` pieces and after its last one, raising root's flag for q
    by the pieces it published. A program that draws past the last piece
    counts itself done; the last one done in a pool takes the pool's
    ticket, count and credit back to 0. Root's program j then waits for
    senders j + 1, j + 1 + pool, ... until each one's flag counts all of
    its row's pieces, and takes them off.
    ``flags`` "shared" gives root one flag for all senders (the hazard
    the JAX package's docstring names). Returns (root's (n, L) rows,
    residue) as ``simulate_alltoall`` does: residue also holds every wait
    that returned before its row had wholly landed."""
    _check_flags(flags)
    n, L = flat.shape
    piece = max(L, 1) if piece_cols is None else piece_cols
    sizes = [blocks] * n if isinstance(blocks, int) else list(blocks)
    if piece <= 0 or len(sizes) != n or min(sizes) < 1 or publish < 1:
        raise ArgumentError(f"bad gather plan: pieces of {piece} columns, "
                            f"pools {blocks}, {publish} a publication")
    pieces = max(1, -(-L // piece))
    out = torch.empty_like(flat)
    sems: dict = collections.defaultdict(int)
    landed: set = set()
    stored = collections.Counter()

    def flag(sender):
        return (root, "recv", sender if flags == "port" else None)

    def block(q, j):
        if q != root:
            yield (q, "ready"), 1
            sems[q, "ready"] += 1  # read, not taken
        elif j == 0:
            for d in range(1, n):
                sems[(root + d) % n, "ready"] += 1
        p = sems[q, "ticket"]
        sems[q, "ticket"] += 1
        held = 0
        while p < pieces:
            cols = slice(p * piece, min(L, (p + 1) * piece))
            out[q, cols] = flat[q, cols]
            p = sems[q, "ticket"]
            sems[q, "ticket"] += 1
            if q != root:
                stored[q] += 1
                if stored[q] == pieces:
                    landed.add((root, q))
                held += 1
                if held == publish or p >= pieces:
                    sems[flag(q)] += held
                    held = 0
            yield _PAUSE
        sems[q, "done"] += 1
        if sems[q, "done"] == sizes[q]:
            sems[q, "ticket"] = sems[q, "done"] = sems[q, "ready"] = 0
        if q == root:
            for d in range(j + 1, n, sizes[q]):
                sender = (root + d) % n
                yield flag(sender), pieces
                _early(sems, landed, root, sender)

    _drive([block(q, j) for q in range(n) for j in range(sizes[q])], sems,
           rng)
    return out, _residue(sems)


def simulate_scatter(buf: torch.Tensor, root: int = 0, *,
                     flags: str = "port", piece_cols: Optional[int] = None,
                     senders: int = 1,
                     rng: Optional[random.Random] = None):
    """Run the linear scatter of root's (n, L) buffer as its kernel
    does: every row is cut into pieces of ``piece_cols`` columns (the
    last ragged; default the whole row), piece p being row root + p % n,
    chunk p // n, and root's ``senders`` programs (its thread blocks)
    draw the pieces in that order from a ticket counter, as the
    interleaving lets them run: a program stores its piece into the
    destination rank's row and, for a receiver, raises that rank's flag
    by one. A program that draws past the last piece counts itself done;
    the last one done takes both counters back to 0. A receiver only
    waits until its flag counts all of its row's pieces, and takes them
    off. ``flags`` "shared" gives every receiver one flag (on one card
    the ranks' flags share one memory), so one receiver's pieces can
    satisfy another's wait. Returns (rank-major (n, L), residue) as
    ``simulate_alltoall`` does: residue also holds every wait that
    returned before its row had wholly landed."""
    _check_flags(flags)
    n, L = buf.shape
    piece = max(L, 1) if piece_cols is None else piece_cols
    if piece <= 0 or senders < 1:
        raise ArgumentError(f"bad scatter plan: pieces of {piece} columns, "
                            f"{senders} senders")
    pieces = max(1, -(-L // piece))
    out = torch.empty_like(buf)
    sems: dict = collections.defaultdict(int)
    landed: set = set()
    stored = collections.Counter()

    def flag(rank):
        return (rank if flags == "port" else None, "recv")

    def sender():
        while True:
            p = sems["ticket"]
            sems["ticket"] += 1
            if p >= n * pieces:
                break
            q, c = p % n, p // n
            dst = (root + q) % n
            cols = slice(c * piece, min(L, (c + 1) * piece))
            out[dst, cols] = buf[dst, cols]
            stored[dst] += 1
            if stored[dst] == pieces:
                landed.add((dst, dst))
            if q:
                sems[flag(dst)] += 1
            yield _PAUSE
        sems["done"] += 1
        if sems["done"] == senders:
            sems["ticket"] = sems["done"] = 0

    def receiver(me):
        yield flag(me), pieces
        _early(sems, landed, me, me)

    _drive([sender() for _ in range(senders)]
           + [receiver((root + q) % n) for q in range(1, n)], sems, rng)
    return out, _residue(sems)


def simulate_ppermute(x: torch.Tensor, shift: int = 1, *,
                      form: str = "flags",
                      rng: Optional[random.Random] = None):
    """Run one ring hop on (n, L): rank me stores its row into row
    (me + shift) mod n of out, then learns that its own row has landed.
    ``form`` "flags": it signals the receiver's flag and waits for its
    own, which the sender me - shift raises. "cluster": the ranks of a
    stripe form a cluster; after its store each rank arrives at a cluster
    barrier and waits for the other n - 1, a superset of its one sender.
    "unsynced": no flag and no barrier, the negative control. Returns
    (out, residue) as ``simulate_alltoall`` does: residue also records
    every rank that went on before its row landed."""
    if form not in ("flags", "cluster", "unsynced"):
        raise ArgumentError(f"unknown ring hop form {form!r}")
    n = x.shape[0]
    out = torch.empty_like(x)
    sems: dict = collections.defaultdict(int)
    landed: set = set()

    def rank(me):
        dst = (me + shift) % n
        out[dst] = x[me]
        landed.add((dst, dst))
        if form == "flags":
            sems[dst, "recv"] += 1
            yield (me, "recv"), 1
        elif form == "cluster":
            for r in range(n):
                if r != me:
                    sems[r, "barrier"] += 1
            yield (me, "barrier"), n - 1
        else:
            yield _PAUSE
        _early(sems, landed, me, me)

    _drive([rank(r) for r in range(n)], sems, rng)
    return out, _residue(sems)


def simulate_rd(flat: torch.Tensor, op: Op, *, form: str = "l2",
                slots: str = "round", rng: Optional[random.Random] = None):
    """Run the recursive-doubling schedule on ``flat`` (n, L), n a power
    of two, as its kernel does in either form: round k stores the whole
    running value into rank me ^ 2^k's slot for round k, raises that
    rank's flag for round k, waits for its own and combines in rank order
    (the lower rank's value on the left). ``form`` "l2": the slots and
    flags in global memory, each flag taken back to 0 by its waiter.
    "cluster": the slots and flags per receiver and per round in the
    receiving rank's shared memory, whose words are stale when a launch
    starts (1 here): each rank zeroes its flags, then a cluster barrier
    precedes every peer store, and a second barrier every rank's exit.
    ``slots`` "shared" gives every round one slot and one flag (the
    hazard the JAX package's docstring names). Returns (out, residue) as
    ``simulate_ring`` does: residue also holds every combine whose slot
    did not hold its own round's arrival from its own partner."""
    n, L = flat.shape
    if n & (n - 1) or form not in ("l2", "cluster") \
            or slots not in ("round", "shared"):
        raise ArgumentError(f"bad recursive doubling: n={n}, form {form!r}, "
                            f"slots {slots!r}")
    rounds = (n - 1).bit_length()
    out = flat.clone()
    comm = flat.new_empty((n, max(rounds, 1), L))
    sems: dict = collections.defaultdict(int)
    writer: dict = {}  # (rank, slot) -> (sender, round) of its last store
    where = "smem" if form == "cluster" else "recv"

    def slot(k):
        return k if slots == "round" else 0

    if form == "cluster":
        for r in range(n):
            for k in range(rounds):
                sems[r, where, slot(k)] = 1

    def barrier(me, phase):
        for r in range(n):
            if r != me:
                sems[r, "barrier", phase] += 1
        yield (me, "barrier", phase), n - 1

    def rank(me):
        if form == "cluster":
            for k in range(rounds):
                sems[me, where, slot(k)] = 0
            yield from barrier(me, 0)
        for k in range(rounds):
            partner = me ^ (1 << k)
            comm[partner, slot(k)] = out[me]
            writer[partner, slot(k)] = (me, k)
            sems[partner, where, slot(k)] += 1
            yield (me, where, slot(k)), 1
            if writer[me, slot(k)] != (partner, k):
                sems["early", me, k] += 1
            if partner < me:
                out[me] = op.combine(comm[me, slot(k)], out[me])
            else:
                out[me] = op.combine(out[me], comm[me, slot(k)])
        if form == "cluster":
            yield from barrier(me, 1)

    _drive([rank(r) for r in range(n)], sems, rng)
    return out, _residue(sems)


def tree_children(rel: int, n: int) -> list[int]:
    """Relative ranks whose accumulators relative rank ``rel`` folds, in
    the reference's round order: rel + 2^k for every round k below
    rel's lowest set bit (every round, for the root) with rel + 2^k < n.
    In round k a rank whose lowest set bit is 2^k sends to rel - 2^k."""
    low = rel & -rel if rel else n
    children, bit = [], 1
    while bit < low and rel + bit < n:
        children.append(rel + bit)
        bit <<= 1
    return children


def bcast_children(rel: int, n: int) -> list[int]:
    """Relative ranks that copy relative rank ``rel``'s row in the
    binomial bcast: rel + 2^k for every 2^k > rel with rel + 2^k < n,
    in round order. In round k of the reference every rel < 2^k with
    rel + 2^k < n sends to rel + 2^k, so rel's parent is rel minus its
    highest set bit."""
    children, bit = [], 1 << rel.bit_length() if rel else 1
    while rel + bit < n:
        children.append(rel + bit)
        bit <<= 1
    return children


def tree_blocks(n: int, total: int, most: Optional[int] = None) -> list[int]:
    """Thread blocks per relative rank of the tree reduce's grid of
    ``total`` blocks (at least n). Relative rank rel reads its input and
    each child's row and writes its own row once: (2 + children) rows of
    bytes, its weight (5, 2, 3, 2, 4, 2, 3, 2 at n = 8). Every rank gets
    one block; each further block goes to the rank with the most weight
    per block, so all ranks stream their rows at about the same pace.
    ``most`` caps a rank's blocks (its number of segments: a block
    beyond it would have nothing to do), and the grid then stays
    smaller than ``total``."""
    if n < 1 or total < n:
        raise ArgumentError(f"need at least one block per rank: {total} "
                            f"blocks for {n} ranks")
    weight = [2 + len(tree_children(rel, n)) for rel in range(n)]
    counts = [1] * n
    cap = total if most is None else max(1, most)
    for _ in range(total - n):
        open_ = [r for r in range(n) if counts[r] < cap]
        if not open_:
            break
        best = max(open_, key=lambda r: (weight[r] / counts[r], -r))
        counts[best] += 1
    return counts


def _tree_programs(flat: torch.Tensor, out: torch.Tensor, op: Op, root: int,
                   seg: int, blocks: list[int], sems: dict,
                   fold: str) -> list:
    """The programs of the segmented get tree, one per (relative rank,
    thread block): block j of relative rank rel's g blocks takes the
    segments j, j + g, ...; for each it waits for every child's flag of
    that segment, writes ``out[me] = fold(x[me], child rows...)`` in one
    pass, and raises its own flag for its parent (relative rank rel - 1's
    flag of segment s, keyed (rel, s)). ``fold`` "before_flag" folds the
    children's rows first and waits for their flags after it: the
    negative control."""
    n, L = flat.shape
    n_segs = -(-L // seg)

    def block(rel, j, g):
        me = (rel + root) % n
        kids = tree_children(rel, n)
        for s in range(j, n_segs, g):
            cols = slice(s * seg, min(L, (s + 1) * seg))
            if fold == "after_flag":
                for c in kids:
                    yield ("ready", c, s), 1
            acc = flat[me, cols]
            for c in kids:
                acc = op.combine(acc, out[(c + root) % n, cols])
            out[me, cols] = acc
            if fold == "before_flag":
                for c in kids:
                    yield ("ready", c, s), 1
            if rel:
                sems["ready", rel, s] += 1
            yield _PAUSE

    return [block(rel, j, blocks[rel]) for rel in range(n)
            for j in range(blocks[rel])]


def simulate_tree_reduce(flat: torch.Tensor, op: Op, root: int = 0, *,
                         seg_cols: Optional[int] = None,
                         blocks: Optional[list[int]] = None,
                         fold: str = "after_flag",
                         rng: Optional[random.Random] = None):
    """Run the segmented "get" binomial reduce-to-root on ``flat`` (n,
    L). With rel = (me - root) mod n, rank me's row of out is
    ``combine(...combine(x[me], acc(child_1))..., acc(child_k))``, its
    children (``tree_children``) in ascending round order, the
    accumulator on the left: the JAX package's fold. A child's
    accumulator is its finished row of out, which the parent reads
    segment by segment of ``seg_cols`` columns (default
    ``TREE_SEG_COLS``) after that segment's flag; the child never writes
    it again, so no comm slot is needed. ``blocks`` gives the thread
    blocks per relative rank (one each by default). Row ``root`` of out
    is the reduction, the others partial accumulators, as in the
    reference. Returns (out, residue)."""
    if fold not in ("after_flag", "before_flag"):
        raise ArgumentError(f"unknown fold placement {fold!r}")
    n, L = flat.shape
    seg = TREE_SEG_COLS if seg_cols is None else seg_cols
    if seg <= 0:
        raise ArgumentError(f"bad segment {seg}")
    blocks = [1] * n if blocks is None else blocks
    if len(blocks) != n or min(blocks) < 1:
        raise ArgumentError(f"need one or more blocks per rank, got {blocks}")
    out = torch.zeros_like(flat)  # rows not yet written read as 0
    sems: dict = collections.defaultdict(int)
    _drive(_tree_programs(flat, out, op, root, seg, blocks, sems, fold),
           sems, rng)
    return out, _residue(sems)


def simulate_tree_bcast(flat: torch.Tensor, root: int = 0, *,
                        seg_cols: Optional[int] = None,
                        blocks: Optional[list[int]] = None,
                        copy: str = "after_flag",
                        rng: Optional[random.Random] = None):
    """Run the segmented "get" binomial bcast on ``flat`` (n, L), one
    program per (relative rank, thread block): block j of relative rank
    rel's g blocks (``blocks[rel]``, one each by default) takes the
    segments j, j + g, ... of ``seg_cols`` columns (default
    ``BCAST_SEG_BYTES``' worth; the last ragged). For each it copies the
    segment of x[root] (the root) or of its parent's row of out (rel
    minus its highest bit; after the segment's flag, keyed (rel, s)) into
    its own row of out, then raises the flag of each child
    (``bcast_children``). ``copy`` "before_flag" copies first and waits
    for the flag after: the negative control. Returns (out, residue);
    every row of out is row ``root`` of flat."""
    if copy not in ("after_flag", "before_flag"):
        raise ArgumentError(f"unknown copy placement {copy!r}")
    n, L = flat.shape
    seg = (BCAST_SEG_BYTES // flat.element_size() if seg_cols is None
           else seg_cols)
    if seg <= 0:
        raise ArgumentError(f"bad segment {seg}")
    blocks = [1] * n if blocks is None else blocks
    if len(blocks) != n or min(blocks) < 1:
        raise ArgumentError(f"need one or more blocks per rank, got {blocks}")
    n_segs = -(-L // seg)
    out = torch.zeros_like(flat)  # rows not yet written read as 0
    sems: dict = collections.defaultdict(int)

    def block(rel, j, g):
        me = (rel + root) % n
        src = (out[(rel - (1 << (rel.bit_length() - 1)) + root) % n] if rel
               else flat[me])
        kids = bcast_children(rel, n)
        for s in range(j, n_segs, g):
            cols = slice(s * seg, min(L, (s + 1) * seg))
            if rel and copy == "after_flag":
                yield ("ready", rel, s), 1
            out[me, cols] = src[cols]
            if rel and copy == "before_flag":
                yield ("ready", rel, s), 1
            for c in kids:
                sems["ready", c, s] += 1
            yield _PAUSE

    _drive([block(rel, j, blocks[rel]) for rel in range(n)
            for j in range(blocks[rel])], sems, rng)
    return out, _residue(sems)


def _checked(result):
    out, residue = result
    if residue:
        raise RuntimeError(f"protocol fault (flags not back at 0, or early "
                           f"waits): {residue}")
    return out


def ring_allreduce_plain(blocks: torch.Tensor, op) -> torch.Tensor:
    return _checked(simulate_ring_fused(blocks, op_lookup(op)))


def ring_allreduce_chunked_plain(blocks: torch.Tensor, op,
                                 seg_cols: int) -> torch.Tensor:
    """The kernel's wavefront on one stripe. ``seg_cols`` is the
    layout's segment, checked as the wrapper checks it; the pipeline's
    segment is the plan's (no bit depends on it)."""
    W = _chunked_width(blocks, seg_cols)
    seg = _plain_seg(W, CHUNKED_CLUSTER_SEG_BYTES // blocks.element_size())
    return _checked(simulate_ring_chunked(blocks, op_lookup(op),
                                          seg_cols=seg))


def ring_allreduce_rd_plain(flat: torch.Tensor, op) -> torch.Tensor:
    """The kernel's rounds in the form its plan takes at n ranks."""
    form = "cluster" if flat.shape[0] <= RS_CLUSTER_RANKS else "l2"
    return _checked(simulate_rd(flat, op_lookup(op), form=form))


def _plain_seg(cols: int, seg: int) -> int:
    """A segmented kernel's segment of ``seg`` columns, or a longer one
    so that ``cols`` columns make at most ``PLAIN_SEGS`` segments."""
    return max(seg, -(-cols // PLAIN_SEGS))


def ring_reduce_scatter_plain(blocks: torch.Tensor, op) -> torch.Tensor:
    W = blocks.shape[-1]
    seg = _plain_seg(W, RS_SEG_BYTES // blocks.element_size())
    return _checked(simulate_ring_rs_fused(blocks, op_lookup(op),
                                           seg_cols=seg))


def ring_allgather_plain(flat: torch.Tensor) -> torch.Tensor:
    W = flat.shape[-1]
    seg = _plain_seg(W, AG_SEG_BYTES // flat.element_size())
    return _checked(simulate_ring_ag_fused(flat, seg_cols=seg))


def tree_reduce_plain(flat: torch.Tensor, op, root: int) -> torch.Tensor:
    return _checked(simulate_tree_reduce(flat, op_lookup(op), root))


def tree_bcast_plain(flat: torch.Tensor, root: int) -> torch.Tensor:
    seg = _plain_seg(flat.shape[1], BCAST_SEG_BYTES // flat.element_size())
    return _checked(simulate_tree_bcast(flat, root, seg_cols=seg))


def ring_allreduce_bidir_plain(blocks: torch.Tensor, op) -> torch.Tensor:
    return _checked(simulate_ring_bidir(blocks, op_lookup(op)))


def ring_alltoall_plain(x: torch.Tensor) -> torch.Tensor:
    return _checked(simulate_alltoall(x))


def linear_gather_plain(flat: torch.Tensor, root: int) -> torch.Tensor:
    """The kernel's pieces and publications, two programs a pool (one
    for a row of one piece); no bit depends on any of them."""
    L = flat.shape[1]
    piece = _plain_seg(L, max(1, GATHER_PIECE_BYTES // flat.element_size()))
    blocks = min(2, max(1, -(-L // piece)))
    return _checked(simulate_gather(flat, root, piece_cols=piece,
                                    blocks=blocks,
                                    publish=GATHER_PUBLISH_PIECES))


def linear_scatter_plain(buf: torch.Tensor, root: int) -> torch.Tensor:
    L = buf.shape[1]
    piece = _plain_seg(L, max(1, SCATTER_PIECE_BYTES // buf.element_size()))
    return _checked(simulate_scatter(buf, root, piece_cols=piece))


def _flat_shift(x: torch.Tensor, shift: int) -> tuple[torch.Tensor, int]:
    n = x.shape[0]
    return x.reshape(n, -1), shift % n


def ppermute_shift_plain(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """The hop in the form its plan takes at n ranks."""
    flat, shift = _flat_shift(x, shift)
    form = "cluster" if x.shape[0] <= RS_CLUSTER_RANKS else "flags"
    return _checked(simulate_ppermute(flat, shift, form=form)).reshape(
        x.shape)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ARGTYPES = {
    # x, out, comm, sems, n, stripes, threads, C, op, dtype, dev, stream
    "ring_allreduce": [_P, _P, _P, _P, _I, _I, _I, _LL, _I, _I, _I, _P],
    # x, out, comm, sems, n, stripes, threads, block bytes, seg vectors,
    # n_segs, cluster, op, dtype, dev, stream
    "ring_allreduce_chunked": [_P, _P, _P, _P, _I, _I, _I, _LL, _LL, _I, _I,
                               _I, _I, _I, _P],
    # x, out, comm, sems, n, stripes, threads, L, rounds, cluster, op,
    # dtype, dev, stream
    "ring_allreduce_rd": [_P, _P, _P, _P, _I, _I, _I, _LL, _I, _I, _I, _I,
                          _I, _P],
    # x, out, comm, sems, n, stripes, threads, block bytes, seg vectors,
    # n_segs, cluster, op, dtype, dev, stream
    "ring_reduce_scatter": [_P, _P, _P, _P, _I, _I, _I, _LL, _LL, _I, _I, _I,
                            _I, _I, _P],
    # x, out, comm, sems, n, stripes, threads, block bytes, seg vectors,
    # n_segs, cluster, dev, stream
    "ring_allgather": [_P, _P, _P, _P, _I, _I, _I, _LL, _LL, _I, _I, _I, _P],
    # x, out, sems, blocks per relative rank, n, threads, L, seg, n_segs,
    # root, op, dtype, dev, stream
    "tree_reduce": [_P, _P, _P, _P, _I, _I, _LL, _LL, _I, _I, _I, _I, _I,
                    _P],
    # x, out, sems, n, blocks per rank, threads, row bytes, seg bytes,
    # n_segs, root, dev, stream
    "tree_bcast": [_P, _P, _P, _I, _I, _I, _LL, _LL, _I, _I, _I, _P],
    # x, out, comm, sems, n, stripes, threads, W, half, op, dtype, dev,
    # stream
    "ring_allreduce_bidir": [_P, _P, _P, _P, _I, _I, _I, _LL, _LL, _I, _I,
                             _I, _P],
    # x, out, comm, sems, n, stripes, W, elem size, dev, stream
    "ring_alltoall": [_P, _P, _P, _P, _I, _I, _LL, _I, _I, _P],
    # x, out, sems, n, row bytes, root, piece bytes, pieces per row,
    # blocks per pool, pools with one more, pieces per publication,
    # threads, dev, stream
    "linear_gather": [_P, _P, _P, _I, _LL, _I, _LL, _I, _I, _I, _I, _I, _I,
                      _P],
    # buf, out, sems, n, row bytes, root, piece bytes, pieces per row,
    # senders, threads, dev, stream
    "linear_scatter": [_P, _P, _P, _I, _LL, _I, _LL, _I, _I, _I, _I, _P],
    # x, out, comm, sems, n, stripes, threads, tables, info, rounds,
    # nchunks, chunk bytes, seg vectors, n_segs, K, cluster, kind, op,
    # dtype, dev, stream
    "sched_table": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _LL, _LL,
                    _I, _I, _I, _I, _I, _I, _I, _P],
    # x, out, blocks, piece bytes, bytes, elem size, dev, stream
    "selfdma_chunked": [_P, _P, _I, _LL, _LL, _I, _I, _P],
    # x, out, comm, sems, n, stripes, threads, rows, seg rows, n_segs,
    # cluster, dev, stream
    "quant_allreduce": [_P, _P, _P, _P, _I, _I, _I, _LL, _I, _I, _I, _I,
                        _P],
    # x, out, sems, n, stripes, threads, L, shift, elem size, cluster,
    # piece bytes, dev, stream
    "ppermute_shift": [_P, _P, _P, _I, _I, _I, _LL, _I, _I, _I, _LL, _I,
                       _P],
}


@functools.lru_cache(maxsize=None)
def _entry(name: str, defines: tuple = ()):
    """The C launch function of csrc/<name>.cu (built on first use, with
    ``defines`` for a probe build)."""
    fn = getattr(build.library(name, defines), f"ompi_{name}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _dtype_code(dtype: torch.dtype) -> tuple[int]:
    if dtype not in _DTYPE_CODES:
        raise ArgumentError(f"no ring kernel for dtype {dtype}")
    return (_DTYPE_CODES[dtype],)


def _codes(op: Op, dtype: torch.dtype) -> tuple[int, int]:
    if not op.predefined or op.name not in _OP_CODES:
        raise ArgumentError(f"no ring kernel for op {op.name}")
    return (_OP_CODES[op.name],) + _dtype_code(dtype)


def _check_root(root: int, n: int) -> None:
    if not 0 <= root < n:
        raise ArgumentError(f"root {root} out of range for {n} ranks")


def _stripes(n: int, cols: int, sm_count: int,
             per: int = STRIPE_COLS) -> int:
    """Thread blocks per rank, each taking at least ``per`` of the
    ``cols`` columns (or bytes): the whole grid (n x stripes) must be
    resident at once, so n * stripes <= the SM count."""
    if n > sm_count:
        raise KernelError(f"{n} ranks need {n} resident blocks; the card "
                          f"has {sm_count} SMs")
    return max(1, min(sm_count // n, -(-cols // per)))


def ring_allreduce(blocks: torch.Tensor, op) -> torch.Tensor:
    """(n, n, C) per-rank ring blocks -> fully reduced (n, n, C): every
    rank's every block holds the combine of that block over all ranks,
    folded in ring order from rank b+1 round to rank b."""
    op = op_lookup(op)
    n, C = _ring_blocks(blocks, True)
    if not blocks.is_cuda:
        return ring_allreduce_plain(blocks, op)
    return _ring_launch(blocks, op)


def _ring_plan(n: int, block_bytes: int, sm_count: int) -> tuple[int, int]:
    """(stripes, threads per block) of ``ring_allreduce`` for n ranks of
    ``block_bytes``-byte ring blocks: stripes of at least
    ``RING_STRIPE_BYTES``, as many as fit one block per SM, each block
    512 threads. The rule of a stripes x threads sweep at n = 8 on an
    NVIDIA H100 (PERF.md, the ring's sweep): at 64 KiB per rank one stripe, at 1 MiB
    and 4 MiB sixteen; 512 threads within a few percent of the best
    everywhere."""
    return _stripes(n, block_bytes, sm_count, RING_STRIPE_BYTES), 512


#: (device index, stream handle, "flags" or "comm") -> scratch that the
#: ring and tree kernels' launches on that stream reuse: every launch
#: leaves its flags at 0 and writes each comm slot before reading it,
#: and launches on one stream run one after another.
_SCRATCH: dict = {}


def _scratch(x: torch.Tensor, stream: int, kind: str,
             count: int) -> torch.Tensor:
    """At least ``count`` int32 flags, all 0 (``kind`` "flags"), or
    ``count`` bytes of comm slots ("comm"), for a launch on ``stream``.
    A scratch too small grows in place: the kernel counters that hold it
    as their last launch's flags see the grown one, and keep no smaller
    one alive."""
    key = (x.device.index, stream, kind)
    buf = _SCRATCH.get(key)
    if buf is None:
        buf = torch.zeros(count, dtype=torch.int32 if kind == "flags"
                          else torch.uint8, device=x.device)
        _SCRATCH[key] = buf
    elif buf.numel() < count:
        buf.resize_(count).zero_()
    return buf


def _raw_stream(x: torch.Tensor) -> int:
    """The handle of the current CUDA stream on x's card: torch's own
    accessor, the one its generated kernel launchers call (a Stream
    object from ``torch.cuda.current_stream`` costs several µs more)."""
    return torch._C._cuda_getCurrentRawStream(x.device.index or 0)


def _ring_launch(blocks: torch.Tensor, op, stripes: Optional[int] = None,
                 threads: Optional[int] = None,
                 defines: tuple = ()) -> torch.Tensor:
    """Launch csrc/ring_allreduce.cu on (n, n, C) CUDA blocks with the
    plan's stripes and threads (or the ones given: the measurement
    tools' sweep; ``defines`` names a probe build)."""
    n, C = _ring_blocks(blocks, True)
    codes = _codes(op_lookup(op), blocks.dtype)
    cap = require_kernel_device(blocks)
    vec = 16 // blocks.element_size()
    cols = -(-C // vec) * vec  # rows of whole 16-byte vectors
    x = _aligned(blocks, cols)
    plan = _ring_plan(n, cols * blocks.element_size(), cap.sm_count)
    stripes, threads = stripes or plan[0], threads or plan[1]
    slot_bytes = -(-cols // vec // stripes) * 16
    out = torch.empty_like(x)
    stream = _raw_stream(x)
    comm = _scratch(x, stream, "comm", n * stripes * 2 * slot_bytes)
    sems = _scratch(x, stream, "flags", n * stripes * 4)
    err = _entry("ring_allreduce", defines)(
        x.data_ptr(), out.data_ptr(), comm.data_ptr(), sems.data_ptr(), n,
        stripes, threads, cols, *codes, x.device.index or 0, stream)
    if err:
        raise KernelError(f"ring_allreduce launch failed: CUDA error {err}")
    RING.launched(sems)
    return out[..., :C].contiguous() if cols != C else out


def _chunked_width(blocks: torch.Tensor, seg_cols: int) -> int:
    """W of (n, n, W) chunked-ring blocks, whole segments of
    ``seg_cols`` columns (the layout's)."""
    _, W = _ring_blocks(blocks, True)
    if seg_cols <= 0 or W % seg_cols:
        raise ArgumentError(f"segment {seg_cols} does not divide {W}")
    return W


def ring_allreduce_chunked(blocks: torch.Tensor, op, seg_cols: int
                           ) -> torch.Tensor:
    """The ring of ``ring_allreduce`` over (n, n, W) blocks, W whole
    segments of ``seg_cols`` columns, streamed so that its scratch stays
    bounded however large W is. ``seg_cols`` is the layout's segment
    (``allreduce_block_chunked`` pads to whole ``coll_pallas_segment_bytes``
    segments, which decides where ring blocks split, and so the bits of a
    float sum) and the plan key's; the kernel's own pipeline segment is
    its plan's (``_chunked_plan``), independent of it, and no bit depends
    on that one."""
    op = op_lookup(op)
    _chunked_width(blocks, seg_cols)
    if not blocks.is_cuda:
        return ring_allreduce_chunked_plain(blocks, op, seg_cols)
    return _chunked_launch(blocks, op)


def _chunked_plan(n: int, block_bytes: int, sm_count: int,
                  cluster: Optional[bool] = None
                  ) -> tuple[int, int, int, bool]:
    """``_wave_plan`` of ``ring_allreduce_chunked``: (2n-3) x RS_BUFS
    buffers a block, the blocks of an SM within ``CHUNKED_SMEM_BYTES`` of
    shared memory in the cluster form."""
    return _wave_plan(n, block_bytes, sm_count, cluster, (
        (CHUNKED_CLUSTER_SEG_BYTES, CHUNKED_CLUSTER_THREADS,
         CHUNKED_CLUSTER_BLOCKS_PER_SM),
        (CHUNKED_SEG_BYTES, CHUNKED_THREADS, CHUNKED_BLOCKS_PER_SM)),
        bufs=2 * n - 3,
        smem=CHUNKED_SMEM_BYTES // CHUNKED_CLUSTER_BLOCKS_PER_SM)


def _chunked_launch(blocks: torch.Tensor, op, stripes: Optional[int] = None,
                    threads: Optional[int] = None,
                    seg_bytes: Optional[int] = None,
                    cluster: Optional[bool] = None,
                    defines: tuple = ()) -> torch.Tensor:
    """Launch csrc/ring_allreduce_chunked.cu on (n, n, W) CUDA blocks with
    the plan's stripes, threads, segment and buffer memory (shared memory
    in clusters, or L2), or the ones given, as ``_rs_launch`` does.
    ``CHUNKED.last_plan`` records what was launched."""
    n, W = _ring_blocks(blocks, True)
    codes = _codes(op_lookup(op), blocks.dtype)
    cap = require_kernel_device(blocks)
    vec = 16 // blocks.element_size()
    cols = -(-W // vec) * vec  # ring blocks of whole 16-byte vectors
    x = _aligned(blocks, cols)
    c_bytes = cols * blocks.element_size()
    plan = _chunked_plan(n, c_bytes, cap.sm_count, cluster)
    threads, seg_bytes = threads or plan[1], seg_bytes or plan[2]
    cluster = plan[3]
    dev = x.device.index or 0
    if stripes is None:
        stripes = plan[0]
        if cluster:
            stripes = min(stripes, _clusters("ring_allreduce_chunked", n,
                                              threads, seg_bytes, dev))
    seg_v = seg_bytes // 16
    sw = -(-(c_bytes // 16) // stripes)  # vectors per stripe
    n_segs = -(-sw // seg_v)
    out = torch.empty_like(x)
    stream = _raw_stream(x)
    buffer_bytes = n * stripes * RS_BUFS * (2 * n - 3) * seg_bytes
    comm = _scratch(x, stream, "comm", 0 if cluster else buffer_bytes)
    sems = _scratch(x, stream, "flags", n * stripes * 2 * RS_BUFS)
    err = _entry("ring_allreduce_chunked", defines)(
        x.data_ptr(), out.data_ptr(), comm.data_ptr(), sems.data_ptr(), n,
        stripes, threads, c_bytes, seg_v, n_segs, int(cluster), *codes, dev,
        stream)
    if err:
        raise KernelError(f"ring_allreduce_chunked launch failed: CUDA error "
                          f"{err}")
    CHUNKED.launched(sems, {
        "stripes": stripes, "threads": threads, "segment_bytes": seg_bytes,
        "segments": n_segs,
        "buffers": "cluster shared memory" if cluster else "L2",
        "buffer_bytes": buffer_bytes})
    return out[..., :W].contiguous() if cols != W else out


def selfdma_chunked_plain(x: torch.Tensor, seg_cols: int) -> torch.Tensor:
    """The kernel's two copies per segment, in torch: the input segment
    into comm slot si % 2, that slot into the output."""
    out = torch.empty_like(x)
    comm = x.new_empty((2, seg_cols))
    for si in range(x.shape[1] // seg_cols):
        cols = slice(si * seg_cols, (si + 1) * seg_cols)
        comm[si % 2] = x[0, cols]
        out[0, cols] = comm[si % 2]
    return out


def selfdma_chunked(x: torch.Tensor, seg_cols: int) -> torch.Tensor:
    """(1, W) one-rank buffer -> a new (1, W) tensor equal to it, any
    dtype, streamed in segments of ``seg_cols`` columns: the n == 1 case
    of the chunked ring."""
    if x.ndim != 2 or x.shape[0] != 1:
        raise ArgumentError(
            f"one-rank chunked input must be (1, W), got {tuple(x.shape)}")
    W = x.shape[1]
    if seg_cols <= 0 or W % seg_cols:
        raise ArgumentError(f"segment {seg_cols} does not divide {W}")
    if not x.is_cuda:
        return selfdma_chunked_plain(x, seg_cols)
    return _selfdma_launch(x)


def _selfdma_launch(x: torch.Tensor, piece: Optional[int] = None,
                    per_sm: Optional[int] = None,
                    defines: tuple = ()) -> torch.Tensor:
    """Launch csrc/selfdma_chunked.cu on a (1, W) CUDA buffer with
    ``SELFDMA_PIECE_BYTES`` pieces and ``SELFDMA_BLOCKS_PER_SM`` blocks
    per SM (or the ones given: the measurement tools' sweep), no more
    blocks than pieces. ``SELFDMA.last_plan`` records what was
    launched."""
    cap = require_kernel_device(x)
    piece = piece or SELFDMA_PIECE_BYTES
    x = x.contiguous()
    out = torch.empty_like(x)
    nbytes = x.numel() * x.element_size()
    blocks = max(1, min((per_sm or SELFDMA_BLOCKS_PER_SM) * cap.sm_count,
                        -(-(nbytes // 16 * 16) // piece)))
    err = _entry("selfdma_chunked", defines)(
        x.data_ptr(), out.data_ptr(), blocks, piece, nbytes,
        x.element_size(), x.device.index or 0, _raw_stream(x))
    if err:
        raise KernelError(f"selfdma_chunked launch failed: CUDA error {err}")
    SELFDMA.launched(_no_flags(x.device), {"blocks": blocks,
                                           "piece_bytes": piece})
    return out


@functools.lru_cache(maxsize=None)
def _no_flags(device: torch.device) -> torch.Tensor:
    """The flags of a kernel that has none, for its counter."""
    return torch.zeros(0, dtype=torch.int32, device=device)


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
    return _rd_launch(flat, op)


@functools.lru_cache(maxsize=256)
def _rd_plan(n: int, cols: int, elem: int, sm_count: int,
             cluster: Optional[bool] = None,
             stripe_bytes: int = RD_STRIPE_BYTES) -> tuple[int, int, bool]:
    """(stripes, threads per block, cluster) of ``ring_allreduce_rd`` for
    n ranks of ``cols`` elements of ``elem`` bytes: clusters up to
    ``RS_CLUSTER_RANKS`` ranks (unless ``cluster`` says otherwise), each
    stripe at most ``stripe_bytes`` of whole 16-byte vectors, one a
    thread, so its ``RD_MAX_ROUNDS`` slots fit a block's shared memory;
    beyond, ``_stripes``' stripes of at least ``STRIPE_COLS`` columns
    with 1024 threads, every block resident."""
    if cluster is None:
        cluster = n <= RS_CLUSTER_RANKS
    elif cluster and n > RS_CLUSTER_RANKS:
        raise ArgumentError(f"no cluster of {n} ranks (at most "
                            f"{RS_CLUSTER_RANKS})")
    if not cluster:
        return _stripes(n, cols, sm_count), 1024, False
    if stripe_bytes < 16 or stripe_bytes > 1024 * 16:
        raise ArgumentError(f"rd stripes of {stripe_bytes} B (16 B to 16 "
                            f"KiB: one vector a thread)")
    vectors = max(1, -(-cols * elem // 16))
    stripes = -(-vectors // (stripe_bytes // 16))
    sv = -(-vectors // stripes)
    return stripes, max(32, -(-sv // 32) * 32), True


def _rd_launch(flat: torch.Tensor, op, cluster: Optional[bool] = None,
               stripe_bytes: Optional[int] = None) -> torch.Tensor:
    """Launch csrc/ring_allreduce_rd.cu on (n, L) CUDA buffers in the form
    and stripes of the plan (``cluster`` and ``stripe_bytes`` force them:
    the tests' and the measurement tools' choices). The cluster form
    takes rows of whole 16-byte vectors (zero-padded here) and needs no
    comm; the L2 form's comm and flags are the stream's scratch.
    ``RD.last_plan`` records what was launched."""
    n, L = flat.shape
    if n < 2 or n & (n - 1):
        raise ArgumentError(
            f"recursive doubling needs a power-of-two ring, got {n}")
    codes = _codes(op_lookup(op), flat.dtype)
    cap = require_kernel_device(flat)
    elem = flat.element_size()
    rounds = (n - 1).bit_length()
    stripes, threads, cluster = _rd_plan(
        n, L, elem, cap.sm_count, cluster, stripe_bytes or RD_STRIPE_BYTES)
    dev = flat.device.index or 0
    if cluster:
        vec = 16 // elem
        cols = -(-L // vec) * vec
        sv = -(-(cols // vec) // stripes)
        _clusters("ring_allreduce_rd", n, threads, 16 * sv, dev)
        comm_bytes, nflags = 0, n * stripes * RD_MAX_ROUNDS
    else:
        cols = L
        comm_bytes = n * stripes * rounds * -(-L // stripes) * elem
        nflags = n * stripes * rounds
    x = _aligned(flat, cols)
    out = torch.empty_like(x)
    stream = _raw_stream(x)
    comm = _scratch(x, stream, "comm", comm_bytes)
    sems = _scratch(x, stream, "flags", nflags)
    err = _entry("ring_allreduce_rd")(
        x.data_ptr(), out.data_ptr(), comm.data_ptr(), sems.data_ptr(), n,
        stripes, threads, cols, rounds, int(cluster), *codes, dev, stream)
    if err:
        raise KernelError(f"ring_allreduce_rd launch failed: CUDA error "
                          f"{err}")
    RD.launched(sems, {"form": "cluster" if cluster else "l2",
                       "stripes": stripes, "threads": threads,
                       "comm_bytes": comm_bytes})
    return out[:, :L].contiguous() if cols != L else out


def ring_reduce_scatter(blocks: torch.Tensor, op) -> torch.Tensor:
    """(n, n, C) per-rank ring blocks -> (n, C): row r is block r
    combined over all ranks, folded in ring order from rank r+1 round
    to rank r (the first half of ``ring_allreduce``)."""
    op = op_lookup(op)
    _ring_blocks(blocks, True)
    if not blocks.is_cuda:
        return ring_reduce_scatter_plain(blocks, op)
    return _rs_launch(blocks, op)


def _wave_plan(n: int, size: int, sm_count: int,
               cluster: Optional[bool], forms: tuple,
               bufs: Optional[int] = None, smem: int = RS_SMEM_BYTES,
               quantum: int = 16, unit_bytes: int = 1, slack: int = 0,
               per_warp: bool = False) -> tuple[int, int, int, bool]:
    """(stripes, threads per block, segment, cluster) of a wavefront
    kernel (``ring_reduce_scatter``, ``ring_allgather``,
    ``ring_allreduce_chunked``, ``quant_allreduce``) for n ranks of ring
    blocks of ``size`` units (bytes; the int8 ring's rows): clusters up to
    ``RS_CLUSTER_RANKS`` ranks (unless ``cluster`` says otherwise), each
    form (``forms``: the cluster's, then the L2 one's) with its segment,
    threads and blocks per SM; stripes of at least a segment (or, with
    ``per_warp``, a unit per warp), as many as that many blocks per SM
    allow; segments of whole ``quantum`` units, no longer than a stripe,
    and shortened until a block's ``bufs`` x RS_BUFS buffers (``bufs``
    forwarded steps; default n-2) of at most ``unit_bytes`` a unit plus
    ``slack`` take at most ``smem`` bytes of its shared memory (clusters)
    or all blocks' at most ``RS_SLOT_BYTES`` (L2)."""
    if cluster is None:
        cluster = n <= RS_CLUSTER_RANKS
    elif cluster and n > RS_CLUSTER_RANKS:
        raise ArgumentError(f"no cluster of {n} ranks (at most "
                            f"{RS_CLUSTER_RANKS})")
    seg, threads, per_sm = forms[0] if cluster else forms[1]
    least = max(1, threads // 32) if per_warp else seg
    stripes = _stripes(n, size, per_sm * sm_count, least)
    seg = min(seg, -(-size // quantum // stripes) * quantum)
    per_block = RS_BUFS * (max(n - 2, 0) if bufs is None else bufs)
    budget = smem if cluster else RS_SLOT_BYTES // (n * stripes)
    if per_block:
        most = (budget // per_block - slack) // unit_bytes
        seg = min(seg, max(quantum, most // quantum * quantum))
    return stripes, threads, seg, cluster


def _rs_plan(n: int, block_bytes: int, sm_count: int,
             cluster: Optional[bool] = None) -> tuple[int, int, int, bool]:
    """``_wave_plan`` of ``ring_reduce_scatter``."""
    return _wave_plan(n, block_bytes, sm_count, cluster, (
        (RS_CLUSTER_SEG_BYTES, RS_CLUSTER_THREADS, RS_CLUSTER_BLOCKS_PER_SM),
        (RS_SEG_BYTES, RS_THREADS, RS_BLOCKS_PER_SM)))


@functools.lru_cache(maxsize=64)
def _clusters(name: str, n: int, threads: int, seg_bytes: int,
              device: int) -> int:
    """Clusters of a cluster kernel's n blocks (csrc/<name>.cu; its
    segment, or recursive doubling's stripe, of ``seg_bytes``) that the
    card holds at once (the cluster launch runs the rest after them)."""
    fn = getattr(build.library(name), f"ompi_{name}_clusters")
    fn.argtypes, fn.restype = [_I, _I, _LL, _I], ctypes.c_int
    got = fn(n, threads, seg_bytes // 16, device)
    if got <= 0:
        raise KernelError(f"{name}: no cluster of {n} blocks fits (CUDA "
                          f"error {-got})")
    return got


def _rs_launch(blocks: torch.Tensor, op, stripes: Optional[int] = None,
               threads: Optional[int] = None,
               seg_bytes: Optional[int] = None,
               cluster: Optional[bool] = None,
               defines: tuple = ()) -> torch.Tensor:
    """Launch csrc/ring_reduce_scatter.cu on (n, n, C) CUDA blocks with
    the plan's stripes, threads, segment and buffer memory (shared memory
    in clusters, or L2), or the ones given: the tests' and the
    measurement tools' choices; ``defines`` names a probe build. A
    cluster launch takes at most as many stripes as clusters fit on the
    card at once. ``RS.last_plan`` records what was launched."""
    n, C = _ring_blocks(blocks, True)
    codes = _codes(op_lookup(op), blocks.dtype)
    cap = require_kernel_device(blocks)
    vec = 16 // blocks.element_size()
    cols = -(-C // vec) * vec  # ring blocks of whole 16-byte vectors
    x = _aligned(blocks, cols)
    c_bytes = cols * blocks.element_size()
    plan = _rs_plan(n, c_bytes, cap.sm_count, cluster)
    threads, seg_bytes = threads or plan[1], seg_bytes or plan[2]
    cluster = plan[3]
    dev = x.device.index or 0
    if stripes is None:
        stripes = plan[0]
        if cluster:
            stripes = min(stripes, _clusters("ring_reduce_scatter", n,
                                              threads, seg_bytes, dev))
    seg_v = seg_bytes // 16
    sw = -(-(c_bytes // 16) // stripes)  # vectors per stripe
    n_segs = -(-sw // seg_v)
    out = x.new_empty((n, cols))
    stream = _raw_stream(x)
    buffer_bytes = n * stripes * RS_BUFS * max(n - 2, 0) * seg_bytes
    comm = _scratch(x, stream, "comm", 0 if cluster else buffer_bytes)
    sems = _scratch(x, stream, "flags", n * stripes * 2 * RS_BUFS)
    err = _entry("ring_reduce_scatter", defines)(
        x.data_ptr(), out.data_ptr(), comm.data_ptr(), sems.data_ptr(), n,
        stripes, threads, c_bytes, seg_v, n_segs, int(cluster), *codes, dev,
        stream)
    if err:
        raise KernelError(f"ring_reduce_scatter launch failed: CUDA error "
                          f"{err}")
    RS.launched(sems, {
        "stripes": stripes, "threads": threads, "segment_bytes": seg_bytes,
        "segments": n_segs,
        "buffers": "cluster shared memory" if cluster else "L2",
        "buffer_bytes": buffer_bytes})
    return out[:, :C].contiguous() if cols != C else out


def ring_allgather(flat: torch.Tensor) -> torch.Tensor:
    """(n, C) per-rank blocks -> (n, n, C): every rank's row holds every
    rank's block, circulated once round the ring. It moves bytes, so it
    takes any dtype whose element size divides 16."""
    _ring_blocks(flat, False)
    if not flat.is_cuda:
        return ring_allgather_plain(flat)
    return _ag_launch(flat)


def _ag_plan(n: int, block_bytes: int, sm_count: int,
             cluster: Optional[bool] = None) -> tuple[int, int, int, bool]:
    """``_wave_plan`` of ``ring_allgather``."""
    return _wave_plan(n, block_bytes, sm_count, cluster, (
        (AG_CLUSTER_SEG_BYTES, AG_CLUSTER_THREADS, AG_CLUSTER_BLOCKS_PER_SM),
        (AG_SEG_BYTES, AG_THREADS, AG_BLOCKS_PER_SM)))


def _ag_launch(flat: torch.Tensor, stripes: Optional[int] = None,
               threads: Optional[int] = None,
               seg_bytes: Optional[int] = None,
               cluster: Optional[bool] = None,
               defines: tuple = ()) -> torch.Tensor:
    """Launch csrc/ring_allgather.cu on (n, C) CUDA blocks with the plan's
    stripes, threads, segment and buffer memory (shared memory in
    clusters, or L2), or the ones given, as ``_rs_launch`` does.
    ``AG.last_plan`` records what was launched."""
    n, C = _ring_blocks(flat, False)
    cap = require_kernel_device(flat)
    elem = flat.element_size()
    if 16 % elem:
        raise ArgumentError(f"no ring allgather for {flat.dtype}: its "
                            f"elements do not tile 16-byte vectors")
    vec = 16 // elem
    cols = -(-C // vec) * vec  # blocks of whole 16-byte vectors
    x = _aligned(flat, cols)
    c_bytes = cols * elem
    plan = _ag_plan(n, c_bytes, cap.sm_count, cluster)
    threads, seg_bytes = threads or plan[1], seg_bytes or plan[2]
    cluster = plan[3]
    dev = x.device.index or 0
    if stripes is None:
        stripes = plan[0]
        if cluster:
            stripes = min(stripes, _clusters("ring_allgather", n, threads,
                                              seg_bytes, dev))
    seg_v = seg_bytes // 16
    sw = -(-(c_bytes // 16) // stripes)  # vectors per stripe
    n_segs = -(-sw // seg_v)
    out = x.new_empty((n, n, cols))
    stream = _raw_stream(x)
    buffer_bytes = n * stripes * RS_BUFS * max(n - 2, 0) * seg_bytes
    comm = _scratch(x, stream, "comm", 0 if cluster else buffer_bytes)
    sems = _scratch(x, stream, "flags", n * stripes * 2 * RS_BUFS)
    err = _entry("ring_allgather", defines)(
        x.data_ptr(), out.data_ptr(), comm.data_ptr(), sems.data_ptr(), n,
        stripes, threads, c_bytes, seg_v, n_segs, int(cluster), dev, stream)
    if err:
        raise KernelError(f"ring_allgather launch failed: CUDA error {err}")
    AG.launched(sems, {
        "stripes": stripes, "threads": threads, "segment_bytes": seg_bytes,
        "segments": n_segs,
        "buffers": "cluster shared memory" if cluster else "L2",
        "buffer_bytes": buffer_bytes})
    return out[..., :C].contiguous() if cols != C else out


@functools.lru_cache(maxsize=64)
def _tree_grid(n: int, total: int, n_segs: int):
    """(per-relative-rank block counts as a C int array, grid size)."""
    counts = tree_blocks(n, total, n_segs)
    return (ctypes.c_int * n)(*counts), sum(counts)


def _aligned(x: torch.Tensor, cols: int) -> torch.Tensor:
    """x contiguous, its rows zero-padded to ``cols`` columns and its
    start 16-byte aligned, as the vector kernels read it."""
    pad = cols - x.shape[-1]
    x = F.pad(x, (0, pad)) if pad else x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def tree_reduce(flat: torch.Tensor, op, root: int = 0) -> torch.Tensor:
    """(n, L) per-rank buffers -> (n, L) whose row ``root`` is their
    binomial-tree reduction (the other rows: partial accumulators)."""
    op = op_lookup(op)
    n, L = flat.shape
    _check_root(root, n)
    if not flat.is_cuda:
        return tree_reduce_plain(flat, op, root)
    return _tree_launch(flat, op, root)


def _tree_launch(flat: torch.Tensor, op, root: int,
                 seg_cols: int = TREE_SEG_COLS,
                 blocks: Optional[list[int]] = None,
                 threads: int = TREE_THREADS, per_sm: int = TREE_BLOCKS_PER_SM,
                 defines: tuple = ()) -> torch.Tensor:
    """Launch csrc/tree_reduce.cu on (n, L) CUDA rows: ``per_sm`` blocks
    of ``threads`` per SM, split by ``tree_blocks`` (or by the ``blocks``
    per relative rank given; other segments, threads and blocks per SM
    are the measurement tools' sweep; ``defines`` names a probe build).
    ``TREE_REDUCE.last_plan`` records what was launched."""
    n, L = flat.shape
    codes = _codes(op_lookup(op), flat.dtype)
    cap = require_kernel_device(flat)
    cols = -(-L // LANES) * LANES  # rows of whole 16-byte vectors
    x = _aligned(flat, cols)
    n_segs = -(-cols // seg_cols)
    if blocks is None:
        counts, grid = _tree_grid(n, per_sm * cap.sm_count, n_segs)
    else:
        counts, grid = (ctypes.c_int * n)(*blocks), sum(blocks)
    out = torch.empty_like(x)
    stream = _raw_stream(x)
    sems = _scratch(x, stream, "flags", max(n - 1, 1) * n_segs)
    err = _entry("tree_reduce", defines)(
        x.data_ptr(), out.data_ptr(), sems.data_ptr(), counts, n, threads,
        cols, seg_cols, n_segs, root, *codes, x.device.index or 0, stream)
    if err:
        raise KernelError(f"tree_reduce launch failed: CUDA error {err} "
                          f"(grid {grid})")
    TREE_REDUCE.launched(sems, {
        "blocks_per_relative_rank": list(counts), "threads": threads,
        "segment_cols": seg_cols, "segments": n_segs})
    return out[:, :L].contiguous() if cols != L else out


def tree_bcast(flat: torch.Tensor, root: int = 0) -> torch.Tensor:
    """(n, L) per-rank buffers -> (n, L) with row ``root`` in every row,
    over a binomial tree."""
    n, _ = flat.shape
    _check_root(root, n)
    if not flat.is_cuda:
        return tree_bcast_plain(flat, root)
    return _bcast_launch(flat, root)


def _bcast_launch(flat: torch.Tensor, root: int,
                  seg_bytes: int = BCAST_SEG_BYTES,
                  threads: int = BCAST_THREADS,
                  per_sm: int = BCAST_BLOCKS_PER_SM,
                  defines: tuple = ()) -> torch.Tensor:
    """Launch csrc/tree_bcast.cu on (n, L) CUDA rows: ``per_sm`` blocks
    of ``threads`` per SM, split equally over the ranks (other segments,
    threads and blocks per SM are the measurement tools' sweep;
    ``defines`` names a probe build). ``TREE_BCAST.last_plan`` records
    what was launched."""
    n, L = flat.shape
    # The kernel copies bytes in 16-byte vectors: any element size that
    # divides 16 is taken, as by the plain version (the merged broadcast
    # of a training step sends uint8).
    if 16 % flat.element_size():
        raise ArgumentError(f"no tree_bcast for dtype {flat.dtype}")
    cap = require_kernel_device(flat)
    vec = 16 // flat.element_size()
    cols = -(-L // vec) * vec  # rows of whole 16-byte vectors
    x = _aligned(flat, cols)
    row = cols * flat.element_size()
    n_segs = -(-row // seg_bytes)
    per_rank = max(1, min(per_sm * cap.sm_count // n, n_segs))
    out = torch.empty_like(x)
    stream = _raw_stream(x)
    sems = _scratch(x, stream, "flags", max(n - 1, 1) * n_segs)
    err = _entry("tree_bcast", defines)(
        x.data_ptr(), out.data_ptr(), sems.data_ptr(), n, per_rank, threads,
        row, seg_bytes, n_segs, root, x.device.index or 0, stream)
    if err:
        raise KernelError(f"tree_bcast launch failed: CUDA error {err}")
    TREE_BCAST.launched(sems, {
        "blocks_per_rank": per_rank, "threads": threads,
        "segment_bytes": seg_bytes, "segments": n_segs})
    return out[:, :L].contiguous() if cols != L else out


def ring_allreduce_bidir(blocks: torch.Tensor, op) -> torch.Tensor:
    """(n, n, C) per-rank ring blocks, C even -> fully reduced (n, n,
    C): columns [0, C/2) of every block fold round the ring to the right
    (as ``ring_allreduce``), columns [C/2, C) round it to the left, from
    rank b-1 down to rank b, both at once."""
    op = op_lookup(op)
    n, C = _ring_blocks(blocks, True)
    if C % 2:
        raise ArgumentError(f"bidirectional ring needs even blocks, got {C}")
    if not blocks.is_cuda:
        return ring_allreduce_bidir_plain(blocks, op)
    return _bidir_launch(blocks, op)


def _bidir_plan(n: int, half_bytes: int, sm_count: int) -> tuple[int, int]:
    """(stripes, threads per block) of ``ring_allreduce_bidir`` for n
    ranks of ring blocks whose halves take ``half_bytes`` bytes: each
    direction's n x stripes blocks as ``_ring_plan`` stripes one ring,
    over half the SMs, so that the two directions' 2 x n x stripes blocks
    keep one block per SM under the cooperative launch."""
    return (_stripes(2 * n, half_bytes, sm_count, BIDIR_STRIPE_BYTES),
            BIDIR_THREADS)


def _bidir_launch(blocks: torch.Tensor, op, stripes: Optional[int] = None,
                  threads: Optional[int] = None,
                  defines: tuple = ()) -> torch.Tensor:
    """Launch csrc/ring_allreduce_bidir.cu on (n, n, C) CUDA blocks, C
    even, with the plan's stripes and threads (or the ones given: the
    measurement tools' sweep; ``defines`` names a probe build). Each half
    is padded to whole 16-byte vectors only when it is not already (the
    main path's halves are 128-lane multiples). ``BIDIR.last_plan``
    records what was launched."""
    n, C = _ring_blocks(blocks, True)
    codes = _codes(op_lookup(op), blocks.dtype)
    cap = require_kernel_device(blocks)
    half = C // 2
    vec = 16 // blocks.element_size()
    hp = -(-half // vec) * vec  # halves of whole 16-byte vectors
    x = blocks.contiguous()
    if hp != half:
        x = torch.cat([F.pad(x[..., :half], (0, hp - half)),
                       F.pad(x[..., half:], (0, hp - half))], dim=-1)
    x = _aligned(x, 2 * hp)
    plan = _bidir_plan(n, hp * blocks.element_size(), cap.sm_count)
    stripes, threads = stripes or plan[0], threads or plan[1]
    slot_bytes = -(-hp // vec // stripes) * 16
    out = torch.empty_like(x)
    stream = _raw_stream(x)
    comm = _scratch(x, stream, "comm", 2 * n * stripes * 2 * slot_bytes)
    sems = _scratch(x, stream, "flags", 2 * n * stripes * 4)
    err = _entry("ring_allreduce_bidir", defines)(
        x.data_ptr(), out.data_ptr(), comm.data_ptr(), sems.data_ptr(), n,
        stripes, threads, 2 * hp, hp, *codes, x.device.index or 0, stream)
    if err:
        raise KernelError(f"ring_allreduce_bidir launch failed: CUDA error "
                          f"{err}")
    BIDIR.launched(sems, {"stripes": stripes, "threads": threads,
                          "blocks": 2 * n * stripes,
                          "half_bytes": hp * blocks.element_size()})
    if hp != half:
        out = torch.cat([out[..., :half], out[..., hp:hp + half]], dim=-1)
    return out


def ring_alltoall(x: torch.Tensor) -> torch.Tensor:
    """(n, n, W) per-rank send blocks (row d for rank d) -> (n, n, W)
    received blocks (row s from rank s), any dtype, by pairwise
    exchange."""
    n = x.shape[0]
    if x.ndim != 3 or x.shape[1] != n:
        raise ArgumentError(
            f"alltoall input must be (n, n, W), got {tuple(x.shape)}")
    if not x.is_cuda:
        return ring_alltoall_plain(x)
    return _alltoall_launch(x)


def _alltoall_launch(x: torch.Tensor) -> torch.Tensor:
    """Launch csrc/ring_alltoall.cu on (n, n, W) CUDA blocks: each rank
    striped over blocks of at least ``STRIPE_COLS`` columns, its (n,
    stripes, n - 1) flags the stream's scratch (each wait takes its flag
    back to 0)."""
    cap = require_kernel_device(x)
    n, W = x.shape[0], x.shape[2]
    stripes = _stripes(n, W, cap.sm_count)
    x = x.contiguous()
    out = torch.empty_like(x)
    stream = _raw_stream(x)
    sems = _scratch(x, stream, "flags", n * stripes * (n - 1))
    err = _entry("ring_alltoall")(
        x.data_ptr(), out.data_ptr(), None, sems.data_ptr(), n, stripes, W,
        x.element_size(), x.device.index or 0, stream)
    if err:
        raise KernelError(f"ring_alltoall launch failed: CUDA error {err}")
    ALLTOALL.launched(sems)
    return out


def linear_gather(flat: torch.Tensor, root: int = 0) -> torch.Tensor:
    """(n, L) per-rank blocks -> root's (n, L) gathered rows, any dtype.
    The JAX package's kernel returns the rank-major (n, n, L) buffer,
    whose rows are defined at root only, and ``PallasColl`` keeps root's;
    this one builds root's alone: n·L elements instead of n²·L (8 GiB
    instead of 64 GiB at 1 GiB per rank and n = 8)."""
    n, L = flat.shape
    _check_root(root, n)
    if not flat.is_cuda:
        return linear_gather_plain(flat, root)
    return _gather_launch(flat, root)


def _gather_plan(n: int, row_bytes: int, sm_count: int,
                 piece: int = GATHER_PIECE_BYTES,
                 per_sm: int = GATHER_BLOCKS_PER_SM) -> tuple[int, int, int]:
    """(blocks per pool, pools with one block more, pieces per row) of
    ``linear_gather``: rows of ``row_bytes`` cut into ``piece``-byte
    pieces; the ``per_sm`` x SM resident slots split into n pools, one
    per rank, as equal as they divide (the first pools one block more),
    no pool with more blocks than its row has pieces."""
    slots = per_sm * sm_count
    if n > slots:
        raise KernelError(f"{n} ranks need {n} resident blocks; the card "
                          f"holds {slots}")
    pieces = max(1, -(-row_bytes // piece))
    pool, extra = divmod(slots, n)
    if pieces <= pool:
        return pieces, 0, pieces
    return pool, extra, pieces


def _gather_launch(flat: torch.Tensor, root: int,
                   piece: Optional[int] = None, threads: Optional[int] = None,
                   per_sm: Optional[int] = None, publish: Optional[int] = None,
                   defines: tuple = ()) -> torch.Tensor:
    """Launch csrc/linear_gather.cu on (n, L) CUDA blocks with
    ``GATHER_*``'s pieces, threads, blocks per SM and pieces per
    publication (or the ones given: the tests' and the measurement tools'
    choices; ``defines`` names a probe build). ``GATHER.last_plan``
    records what was launched."""
    n, L = flat.shape
    _check_root(root, n)
    piece = piece or GATHER_PIECE_BYTES
    threads = threads or GATHER_THREADS
    publish = publish or GATHER_PUBLISH_PIECES
    if piece % 16 or publish < 1:
        raise ArgumentError(f"gather pieces must be 16-byte multiples "
                            f"published at least one at a time, got {piece}"
                            f" B, {publish} a publication")
    cap = require_kernel_device(flat)
    x = _aligned(flat, L)
    row = L * flat.element_size()
    pool, extra, pieces = _gather_plan(n, row, cap.sm_count, piece,
                                       per_sm or GATHER_BLOCKS_PER_SM)
    out = torch.empty_like(x)
    stream = _raw_stream(x)
    sems = _scratch(x, stream, "flags", n * GATHER_WORDS)
    err = _entry("linear_gather", defines)(
        x.data_ptr(), out.data_ptr(), sems.data_ptr(), n, row, root, piece,
        pieces, pool, extra, publish, threads, x.device.index or 0, stream)
    if err:
        raise KernelError(f"linear_gather launch failed: CUDA error {err}")
    GATHER.launched(sems, {"blocks": n * pool + extra, "pool_blocks": pool,
                           "pools_with_one_more": extra, "threads": threads,
                           "piece_bytes": piece, "pieces": n * pieces,
                           "publish_pieces": publish})
    return out


def linear_scatter(buf: torch.Tensor, root: int = 0) -> torch.Tensor:
    """Root's (n, L) buffer -> rank-major (n, L), rank r holding row r,
    any dtype. The JAX package stages root's buffer on every rank,
    (n, n, L), and reads only root's copy; this one takes root's alone."""
    n, L = buf.shape
    _check_root(root, n)
    if not buf.is_cuda:
        return linear_scatter_plain(buf, root)
    return _scatter_launch(buf, root)


def _scatter_plan(n: int, row_bytes: int, sm_count: int,
                  piece: int = SCATTER_PIECE_BYTES,
                  per_sm: int = SCATTER_BLOCKS_PER_SM) -> tuple[int, int]:
    """(senders, pieces per row) of ``linear_scatter``: rows of
    ``row_bytes`` cut into ``piece``-byte pieces; root's blocks fill the
    ``per_sm`` x SM resident slots the n - 1 receivers' blocks leave, no
    more than there are pieces."""
    slots = per_sm * sm_count
    if n - 1 >= slots:
        raise KernelError(f"{n} ranks need {n} resident blocks; the card "
                          f"holds {slots}")
    pieces = max(1, -(-row_bytes // piece))
    return min(slots - (n - 1), n * pieces), pieces


def _scatter_launch(buf: torch.Tensor, root: int,
                    piece: Optional[int] = None, threads: Optional[int] = None,
                    per_sm: Optional[int] = None,
                    defines: tuple = ()) -> torch.Tensor:
    """Launch csrc/linear_scatter.cu on root's (n, L) CUDA buffer with
    ``SCATTER_*``'s pieces, threads and blocks per SM (or the ones given:
    the measurement tools' sweep; ``defines`` names a probe build).
    ``SCATTER.last_plan`` records what was launched."""
    n, L = buf.shape
    cap = require_kernel_device(buf)
    piece = piece or SCATTER_PIECE_BYTES
    threads = threads or SCATTER_THREADS
    if piece % 16:
        raise ArgumentError(f"scatter pieces must be 16-byte multiples, got "
                            f"{piece}")
    x = _aligned(buf, L)
    row = L * buf.element_size()
    senders, pieces = _scatter_plan(n, row, cap.sm_count, piece,
                                    per_sm or SCATTER_BLOCKS_PER_SM)
    out = torch.empty_like(x)
    stream = _raw_stream(x)
    sems = _scratch(x, stream, "flags", n + 2)  # and the two counters
    err = _entry("linear_scatter", defines)(
        x.data_ptr(), out.data_ptr(), sems.data_ptr(), n, row, root, piece,
        pieces, senders, threads, x.device.index or 0, stream)
    if err:
        raise KernelError(f"linear_scatter launch failed: CUDA error {err}")
    SCATTER.launched(sems, {"senders": senders, "receivers": n - 1,
                            "threads": threads, "piece_bytes": piece,
                            "pieces": n * pieces})
    return out


def ppermute_shift(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """One ring hop: rank-major (n, ...) -> (n, ...) where rank
    (r + shift) mod n holds rank r's block, any dtype. At n == 1 it
    returns x without a launch. The JAX package pads each block to 128
    lanes; this one moves the blocks as they are."""
    n = x.shape[0]
    if n == 1:
        return x
    if not x.is_cuda:
        return ppermute_shift_plain(x, shift)
    flat, shift = _flat_shift(x, shift)
    return _hop_launch(flat, shift).reshape(x.shape)


@functools.lru_cache(maxsize=256)
def _hop_plan(n: int, row_bytes: int, sm_count: int,
              cluster: Optional[bool] = None, bulk: bool = True,
              stripe_bytes: int = HOP_STRIPE_BYTES,
              per_sm: int = HOP_STRIPES_PER_SM
              ) -> tuple[int, int, bool, int]:
    """(stripes, threads per block, cluster, piece bytes) of
    ``ppermute_shift`` for n ranks of ``row_bytes``-byte rows: clusters
    up to ``RS_CLUSTER_RANKS`` ranks (unless ``cluster`` says otherwise),
    stripes of at least ``stripe_bytes``, at most ``per_sm`` a rank for
    each SM (the cluster launch runs them in waves), each block one warp
    streaming bulk copies of ``HOP_PIECE_BYTES``
    (``bulk``: rows of whole 16-byte vectors) or ``HOP_THREADS`` threads
    copying (piece 0); beyond, ``_stripes``' resident blocks of 1024
    threads."""
    if cluster is None:
        cluster = n <= RS_CLUSTER_RANKS
    elif cluster and n > RS_CLUSTER_RANKS:
        raise ArgumentError(f"no cluster of {n} ranks (at most "
                            f"{RS_CLUSTER_RANKS})")
    if not cluster:
        return _stripes(n, row_bytes, sm_count, stripe_bytes), 1024, False, 0
    stripes = _stripes(n, row_bytes, per_sm * sm_count, stripe_bytes)
    if bulk:
        return stripes, 32, True, HOP_PIECE_BYTES
    return stripes, HOP_THREADS, True, 0


def _hop_launch(flat: torch.Tensor, shift: int,
                cluster: Optional[bool] = None,
                stripe_bytes: Optional[int] = None,
                threads: Optional[int] = None,
                per_sm: Optional[int] = None,
                piece: Optional[int] = None) -> torch.Tensor:
    """Launch csrc/ppermute_shift.cu on (n, L) CUDA rows, shift in [0,
    n), in the form, stripes and copy of the plan (or the ones given: the
    tests' and the measurement tools' choices; ``piece`` 0 forces the
    threads' copy). The cluster form needs no flags; the flags form's are
    the stream's scratch. ``PPERMUTE.last_plan`` records what was
    launched."""
    n, L = flat.shape
    cap = require_kernel_device(flat)
    x = flat.contiguous()
    elem = x.element_size()
    bulk = piece != 0 and (x.data_ptr() | L * elem) % 16 == 0
    stripes, plan_threads, cluster, plan_piece = _hop_plan(
        n, L * elem, cap.sm_count, cluster, bulk,
        stripe_bytes or HOP_STRIPE_BYTES, per_sm or HOP_STRIPES_PER_SM)
    threads = threads or plan_threads
    piece = plan_piece if piece is None else piece
    out = torch.empty_like(x)
    stream = _raw_stream(x)
    sems = _no_flags(x.device) if cluster else _scratch(
        x, stream, "flags", n * stripes)
    err = _entry("ppermute_shift")(
        x.data_ptr(), out.data_ptr(), sems.data_ptr(), n, stripes, threads,
        L, shift, elem, int(cluster), piece, x.device.index or 0, stream)
    if err:
        raise KernelError(f"ppermute_shift launch failed: CUDA error {err}")
    PPERMUTE.launched(sems, {"form": "cluster" if cluster else "flags",
                             "stripes": stripes, "threads": threads,
                             "piece_bytes": piece})
    return out


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
    return _unpad(out.reshape(out.shape[0], -1), pad, shape)


def _pad_chunk(b: torch.Tensor, lead: int = 1):
    """(lead dims..., ...) -> ((lead dims..., L) zero-padded to a
    multiple of 128 lanes, pad, trailing shape): ``pallas_ring._pad_chunk``
    on every rank (lead 1), or the (n, chunk) lane padding of
    ``ring_reduce_scatter`` on every rank (lead 2)."""
    flat = b.reshape(tuple(b.shape[:lead]) + (-1,))
    pad = (-flat.shape[-1]) % LANES
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat, pad, tuple(b.shape[lead:])


def _unpad(out: torch.Tensor, pad: int, shape: tuple) -> torch.Tensor:
    """Drop ``pad`` lanes from the last axis and give it back ``shape``."""
    if pad:
        out = out[..., :out.shape[-1] - pad]
    return out.reshape(tuple(out.shape[:-1]) + shape).contiguous()


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


def allreduce_block_bidir(b: torch.Tensor, op, *, bidir=ring_allreduce_bidir
                          ) -> torch.Tensor:
    """Rank-major allreduce over the bidirectional ring: ``_split_ring``'s
    blocks, each zero-padded to a multiple of 256 columns so that it
    splits into two 128-lane-aligned halves (``ring_allreduce_bidir``'s
    padding in the JAX package)."""
    if b.shape[0] == 1:
        return b
    blocks, pad, shape = _split_ring(b)
    C = blocks.shape[-1]
    half_pad = (-C) % (2 * LANES)
    if half_pad:
        blocks = F.pad(blocks, (0, half_pad))
    out = bidir(blocks, op)
    if half_pad:
        out = out[..., :C]
    return _unsplit(out, pad, shape)


def allreduce_block_rd(b: torch.Tensor, op, *, rd=ring_allreduce_rd
                       ) -> torch.Tensor:
    """Rank-major allreduce by recursive doubling (power-of-two n)."""
    if b.shape[0] == 1:
        return b
    flat, pad, shape = _pad_chunk(b)
    return _unpad(rd(flat, op), pad, shape)


def allreduce_block_chunked(b: torch.Tensor, op,
                            seg_bytes: Optional[int] = None, *,
                            chunked=ring_allreduce_chunked,
                            selfdma=selfdma_chunked) -> torch.Tensor:
    """Rank-major allreduce over the segmented streaming ring; on one
    rank, the identity through the same segments (``selfdma``), into a
    new tensor."""
    n = b.shape[0]
    if seg_bytes is None:
        seg_bytes = _segment_var.value
    flat = b.reshape(n, -1)
    size = flat.shape[1]
    rows, seg_rows = _chunked_layout(size, n, b.dtype, seg_bytes)
    pad = n * rows * LANES - size
    if pad:
        flat = F.pad(flat, (0, pad))
    if n == 1:
        out = selfdma(flat, seg_rows * LANES)
    else:
        out = chunked(flat.reshape(n, n, rows * LANES), op, seg_rows * LANES)
    return _unsplit(out, pad, tuple(b.shape[1:]))


def allreduce_block_rsag(b: torch.Tensor, op, *, rs=ring_reduce_scatter,
                         ag=ring_allgather) -> torch.Tensor:
    """Rank-major allreduce as the standalone reduce-scatter then
    allgather kernels over ``_split_ring``'s blocks: the same steps and
    fold order as ``allreduce_block``, so the same bits."""
    if b.shape[0] == 1:
        return b
    blocks, pad, shape = _split_ring(b)
    return _unsplit(ag(rs(blocks, op)), pad, shape)


def reduce_scatter_block(b: torch.Tensor, op, *, rs=ring_reduce_scatter
                         ) -> torch.Tensor:
    """Rank-major (n, n, ...) contributions -> (n, ...): row r is block
    r reduced over all ranks, by the ring reduce-scatter."""
    if b.shape[0] == 1:
        return b[:, 0]
    flat, pad, shape = _pad_chunk(b, lead=2)
    return _unpad(rs(flat, op), pad, shape)


def allgather_block(b: torch.Tensor, *, ag=ring_allgather) -> torch.Tensor:
    """Rank-major (n, ...) blocks -> (n, n, ...): every rank gets every
    rank's block, by the ring allgather."""
    if b.shape[0] == 1:
        return b[:, None]
    flat, pad, shape = _pad_chunk(b)
    return _unpad(ag(flat), pad, shape)


def reduce_block(b: torch.Tensor, op, root: int = 0, *, tree=tree_reduce
                 ) -> torch.Tensor:
    """Rank-major contributions -> (n, ...) whose row ``root`` is the
    binomial-tree reduction (the other rows: partial accumulators)."""
    if b.shape[0] == 1:
        return b
    flat, pad, shape = _pad_chunk(b)
    return _unpad(tree(flat, op, root), pad, shape)


def bcast_block(b: torch.Tensor, root: int = 0, *, tree=tree_bcast
                ) -> torch.Tensor:
    """Rank-major buffers -> (n, ...) with row ``root`` in every row,
    over a binomial tree."""
    if b.shape[0] == 1:
        return b
    flat, pad, shape = _pad_chunk(b)
    return _unpad(tree(flat, root), pad, shape)


def alltoall_block(b: torch.Tensor, *, a2a=ring_alltoall) -> torch.Tensor:
    """Rank-major (n, n, ...) send blocks -> (n, n, ...) received blocks
    by the pairwise-exchange kernel, each block lane-padded to 128 as
    the JAX package pads it."""
    if b.shape[0] == 1:
        return b
    flat, pad, shape = _pad_chunk(b, lead=2)
    return _unpad(a2a(flat), pad, shape)


def gather_block(b: torch.Tensor, root: int = 0, *, gather=linear_gather
                 ) -> torch.Tensor:
    """Rank-major (n, ...) blocks -> root's (n, ...) gathered rows, by
    the linear gather."""
    if b.shape[0] == 1:
        return b
    flat, pad, shape = _pad_chunk(b)
    return _unpad(gather(flat, root), pad, shape)


def scatter_block(buf: torch.Tensor, root: int = 0, *,
                  scatter=linear_scatter) -> torch.Tensor:
    """Root's (n, ...) buffer -> rank-major (n, ...), rank r holding row
    r, by the linear scatter."""
    if buf.shape[0] == 1:
        return buf
    flat, pad, shape = _pad_chunk(buf)
    return _unpad(scatter(flat, root), pad, shape)


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
        elif _bidir_var.value:
            body, key_extra = allreduce_block_bidir, ()
            fn = lambda b: allreduce_block_bidir(b, op)  # noqa: E731
        else:
            body, key_extra = allreduce_block, ()
            fn = lambda b: allreduce_block(b, op)  # noqa: E731
        key = ("allreduce", "pallas", body.__name__, op.cache_key,
               tuple(x.shape), str(x.dtype)) + key_extra
        return compile_plan(comm, key, fn)(x)

    def reduce(self, comm, x, op, root):
        """Binomial-tree reduce; returns root's block."""
        op = op_lookup(op)
        x = rank_major_check(comm, x)
        if comm.size == 1:
            return x[0]
        if not op.commutative:
            # The tree folds out of rank order: the rank-ordered oracle
            # takes non-commutative ops, as in the JAX package.
            return COLL.component("basic").reduce(comm, x, op, root)
        key = ("reduce", "pallas", "tree", op.cache_key, root,
               tuple(x.shape), str(x.dtype))
        return compile_plan(
            comm, key, lambda b: reduce_block(b, op, root))(x)[root]

    def bcast(self, comm, x, root):
        x = rank_major_check(comm, x)
        if comm.size == 1:
            return x
        key = ("bcast", "pallas", root, tuple(x.shape), str(x.dtype))
        return compile_plan(comm, key, lambda b: bcast_block(b, root))(x)

    def allgather(self, comm, x):
        x = rank_major_check(comm, x)
        if comm.size == 1:
            return x[:, None]
        key = ("allgather", "pallas", tuple(x.shape), str(x.dtype))
        return compile_plan(comm, key, allgather_block)(x)

    def reduce_scatter_block(self, comm, x, op):
        op = op_lookup(op)
        x = rank_major_check(comm, x, min_ndim=2)
        if x.shape[1] != comm.size:
            raise ArgumentError(
                f"reduce_scatter_block needs (size, size, ...) buffer, got "
                f"{tuple(x.shape)}")
        if comm.size == 1:
            return x[:, 0]
        key = ("reduce_scatter_block", "pallas", op.cache_key,
               tuple(x.shape), str(x.dtype))
        return compile_plan(
            comm, key, lambda b: reduce_scatter_block(b, op))(x)

    def alltoall(self, comm, x):
        x = rank_major_check(comm, x, min_ndim=2)
        if x.shape[1] != comm.size:
            raise ArgumentError(
                f"alltoall needs (size, size, ...) buffer, got "
                f"{tuple(x.shape)}")
        if comm.size == 1:
            return x
        key = ("alltoall", "pallas", tuple(x.shape), str(x.dtype))
        return compile_plan(comm, key, alltoall_block)(x)

    def gather(self, comm, x, root):
        """Linear gather; returns root's rows."""
        x = rank_major_check(comm, x)
        if comm.size == 1:
            return x[:, None][root]
        key = ("gather", "pallas", root, tuple(x.shape), str(x.dtype))
        return compile_plan(comm, key, lambda b: gather_block(b, root))(x)

    def scatter(self, comm, x, root):
        """Linear scatter of root's (size, ...) buffer, which goes to the
        kernel as it is (the JAX package stages it on every rank)."""
        buf = scatter_buffer(comm, x)
        if comm.size == 1:
            return buf
        key = ("scatter", "pallas", root, tuple(buf.shape), str(buf.dtype))
        return compile_plan(comm, key, lambda b: scatter_block(b, root))(buf)
