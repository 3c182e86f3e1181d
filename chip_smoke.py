#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ompi_tpu_torch``) on one NVIDIA H100.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and the repository's ``ompi_tpu_torch`` package;
without a card, or without the package beside it, it exits non-zero
and prints no result.

The sixteen kernels (``ompi_tpu_torch/csrc/``): ``ring_allreduce``,
``ring_allreduce_rd``, ``ring_allreduce_chunked``,
``ring_reduce_scatter``, ``ring_allgather``, ``tree_reduce``,
``tree_bcast``, ``ring_allreduce_bidir``, ``ring_alltoall``,
``linear_gather``, ``linear_scatter``, ``sched_table`` (the schedule
compiler's table-driven kernel), ``selfdma_chunked`` (the one-rank
chunked identity), ``quant_allreduce`` (the ring over the int8 wire),
``ppermute_shift`` (one ring hop) and ``ring_attention`` (exact
attention over the ring: bfloat16 and float16 products on the tensor
cores, float32 on the CUDA cores, the causal mask's hidden folds
skipped and the causal ring's thread blocks split by fold work). The
tree reduce and the tree bcast are segmented "get" trees (a rank reads
its children's, or its parent's, finished row segment by segment after
that segment's flag, every round at once); the whole-payload ring, the
bidirectional ring (in each direction), the chunked ring, the
reduce-scatter and the table kernel fold and forward in one pass per
step, the chunked ring, the reduce-scatter, the allgather and the table
kernel in a wavefront over segments, one thread-block cluster per stripe
up to 8 ranks with their buffers in the reading rank's shared memory (in
L2 beyond); the scatter streams root's rows in pieces over nearly the
whole card, each piece counted on its receiver's flag; the gather
streams each rank's row in pieces by a pool of blocks of its own, onto
root's counted flags; recursive doubling exchanges its rounds through a
cluster's shared memory up to 8 ranks (global memory beyond).

Phases (any failure raises and exits non-zero):

1. The card's name and power limit, then a parallel build of every
   kernel from ``ompi_tpu_torch/csrc/`` (one ``nvcc`` per source, all
   started together) with the compiler's register and spill report.
2. Each kernel against its plain version (the protocol simulator), on
   the card, bitwise, at small and ragged sizes, every flag back at 0:
   the allreduce kernels for the reduction kernels' seven dtypes
   (``DTYPES``: int32, float32, bfloat16, float64, float16, int8, uint8;
   every loop below over a reduction kernel or a ``*_block`` wrapper
   runs all seven) x sum/max/min/prod, with an int8 and a uint8 SUM of
   100 at every rank that wraps (ring and chunked at n in {2, 3, 8},
   recursive doubling at n in {2, 8}, the bidirectional ring at n in
   {2, 3, 8},
   also at four (stripes, threads) plans, on halves that are not whole
   16-byte vectors and at 1 MiB per rank);
   reduce-scatter and tree reduce likewise at n in {2, 3, 8} (the trees
   at roots 0 and n-1; the tree reduce also over four of its segments,
   the last ragged; the reduce-scatter also at blocks of fewer segments
   than its n-1 steps and of many, ragged, and with one stripe over 41
   segments at n in {3, 8, 12}, its buffers in a cluster's shared memory
   and in L2); allgather, tree bcast (also over four
   segments, the last ragged), alltoall, gather and
   scatter for the seven dtypes (gather, scatter and bcast at roots 0
   and n-1; the allgather also with one stripe over 41 segments and with
   the plan's stripes at n in {3, 8}, its buffers in a cluster's shared
   memory and in L2, and at n = 12 in L2), the tree bcast for uint8,
   int8, float16 and float64 at odd row widths (n in {2, 3, 8}, roots 0
   and n-1), the chunked ring likewise (one
   stripe and the plan's over 41 segments, at n in {3, 8} in either
   memory and at n = 12 in L2, every op and dtype), and the three data
   movers and the allgather for float64, float16 and int8 at odd row
   widths (their element-sized copies), the scatter also with pieces of
   16 and 48 bytes on unaligned rows at n in {3, 8, 12} (the ragged head
   and tail copied byte by byte inside the kernel), the gather likewise,
   published one and three pieces at a time, at the plan's pools and at
   four blocks a SM; recursive doubling in both forms at n in {2, 4, 8,
   16} (the plan's, the L2 form forced, and the cluster form over
   stripes of four vectors), every op and dtype at 33 and 2500 elements
   per rank; ``sched_table`` on
   eight programs (ring, ring with a non-identity order, segmented
   ring at 2 and 4 segments, reduce-scatter, allgather, a 3-member
   ``fuse_schedules``, a ``fuse_window``) at n in {2, 3, 4, 8, 12},
   every op and dtype, ragged chunks, and with one stripe over fewer
   segments than a stage's rounds, as many and more (the last ragged) at
   n in {3, 8, 12}, its buffers in a cluster's shared memory and in L2
   (in L2 only at n = 12); ``selfdma_chunked`` at 1, 3 and 8
   segments in six dtypes; ``quant_allreduce`` (SUM) in its cluster
   form at n in {2, 3, 8} and its L2 form at n = 12, for float32 and
   bfloat16 inputs at two or three row counts each, ragged, with stripes
   that do not divide the rows, at the plan's segments (fewer than the
   2(n-1) steps) and at one-row segments (more), and on values whose
   quotients by their scales fall on ties (multiples of 0.5). Then
   ``ppermute_shift`` bitwise against its plain version and
   ``torch.roll`` in both forms (n = 2, 3, 8 in a cluster, with bulk
   copies and with the threads' copy; n = 3, 8, 12 with flags), float32,
   bfloat16 and int8, 13 values, the slice's 8 MiB KV block and 4 KiB
   per rank, shifts 1, -1, 3. Then, with
   ``torch.backends.cuda.matmul.allow_tf32 = False`` (printed):
   ``ring_attention``
   at Llama-2-7B's attention widths (32 heads of 128, multi-head; the
   4096-token context over n = 8 ranks, T = 512) in bfloat16 and float32,
   causal and not, against its plain version (the protocol simulator)
   and against softmax attention over the gathered sequence, to one
   bfloat16 ulp and the JAX package's 2e-4 for float32 (two bfloat16
   controls, p or the output accumulator rounded, must fail the bfloat16
   limit); and 20 launches at n = 8 and at
   n = 3 per dtype, bitwise equal to each other. Every flag back at 0
   after every launch. Ring attention also at the flagship model's
   folded shape (tp = 2 ranks, T = 1024, 256 heads of 128, bfloat16,
   causal) against its plain version to one bfloat16 ulp, which the two
   rounded controls must fail, timed beside its bound and SDPA.
3. The main path at full width, n = 8, through ``init(nranks=8)`` and
   two vtable routes: a ``world.dup()`` with
   ``coll_pallas_priority=100`` (PallasColl) and one with TunedColl and
   ``coll_tuned_<op>_algorithm`` forcing each kernel's name. It runs as
   thirteen paths (allreduce; bcast/reduce/reduce-scatter/allgather; the
   bidirectional ring; alltoall/gather/scatter; the schedule compiler;
   the quantized wire; ring attention; the ring hop; the surface;
   point-to-point and the nonblocking collectives; the training step;
   the flagship model; the dry run);
   the launch counters are zeroed just before each path and read just
   after it, every kernel of the path must have launched there, and
   every result must equal its plain version (the kernels line sums a
   kernel's launches over the paths).
   - ``comm.allreduce(x, "sum")``, float32, at 4 KiB (recursive
     doubling), 1 MiB (ring) and 1 GiB (chunked, an 8 GiB rank-major
     buffer) per rank; then TunedColl's default route at 4096 B or less
     in all, the host tier: float32 SUM at one element per rank (numpy's
     pairwise order), bfloat16 SUM and MAX, float32 PROD and an int32 SUM
     past 2**31, each bitwise an oracle computed apart on the CPU (a
     rank-order fold, bfloat16 rounded at every step, int32 wrapped), the
     repeat call through the dispatch memo; the p50 host wall time of a
     call at 512 B per rank (host) and 516 B per rank (the device route
     the decision takes), on a ``host_tier`` JSON line;
   - ``comm.bcast``, float32, root 3; ``comm.reduce``, int32 MAX, root
     5; ``comm.reduce_scatter_block``, float32 SUM, ``(8, 8, 32 Mi)``
     elements (1 GiB sent per rank); ``comm.allgather``, float32,
     128 MiB sent (1 GiB received) per rank; each also at 4 KiB per
     rank, the latency regime. Each result is also checked against a
     reduction PyTorch computes on its own (row copies, ``amax``,
     ``sum`` to 1e-5);
   - ``comm.allreduce`` with ``pallas_rsag`` (reduce-scatter then
     allgather) at 1 MiB per rank, bitwise equal to ``pallas_ring``, and
     at 1 GiB per rank, bitwise its halves' plain versions;
   - ``comm.allreduce(x, "sum")`` over the bidirectional ring, float32,
     1 MiB per rank: ``coll_pallas_bidir=1`` on PallasColl and
     ``pallas_bidir`` on TunedColl, checked against ``x.sum(0)`` to
     1e-5;
   - ``comm.alltoall``, float32, ``(8, 8, 32 Mi)`` elements (1 GiB sent
     per rank), ``comm.gather``, float32, 1 GiB per rank, root 3, and
     ``comm.scatter``, float32, root 5, root's buffer ``(8, 256 Mi)``;
     each also at 4 KiB per rank. TunedColl forces ``pallas_linear`` for
     gather and scatter; its alltoall takes the default route (the spmd
     pairwise exchange at 128 MiB per destination, no kernel), checked
     equal to the kernel's result. Each result is also checked against
     ``x.transpose(0, 1)``, ``x`` and root's buffer.
   - the schedule compiler through TunedColl: ``sched_pallas_ring`` at
     1 MiB and ``sched_pallas_ring_seg`` at 1 GiB per rank (allreduce),
     ``sched_pallas_rs`` at 1 GiB sent per rank
     (``reduce_scatter_block``), each bitwise its plain version;
     ``pallas_ring_chunked`` forced on a one-rank communicator
     (``world.split``) at 1 GiB, the one-rank kernel, equal to its input
     in a new tensor; ``sched_ring``, ``sched_rd``, ``sched_hier`` and
     the spmd ``ring`` at 1 MiB per rank, each bitwise the same call on a
     CPU communicator over a copy of the input;
   - the winner cache: a measure-mode ``autotune.tune`` on the card
     with ``include_pallas`` at 4 KiB, 1 MiB and 1 GiB per rank (every
     candidate must get a time; the cache goes to
     ``_archive/sched_cache``), its winners and times on one JSON
     line, then ``comm.allreduce`` with no forced name at each size:
     the decision must hit the cache (``sched_cache_hits``), take the
     winner and give the winner's bits called by name; last, the cache
     consult's host cost at 4 KiB per rank (``dispatch_cost``, with the
     dispatch memo off and, in one arm, on), on one JSON line;
   - the quantized wire through TunedColl, float32 SUM, the winner
     cache off (the priors decide): ``quant_pallas`` forced at 64 KiB
     (the gate's ``coll_quant_min_bytes``), 1 MiB and 1 GiB per rank,
     each bitwise its plain version, within ``analytic_error_bound`` of
     the float64 sum (computed in column chunks) with every rank's rows
     identical; ``comm.allreduce`` unforced with ``coll_quant_enable``
     at 1 GiB per rank must take ``quant_ring``, with the SPC ratio
     equal to ``compression_ratio()`` and ``coll_quant_bytes_on_wire``
     grown by ``wire_bytes``, and that route's p50 over five calls
     beside the p50 of the route the same call takes with
     ``coll_quant_enable`` off; MAX through the same communicator bitwise
     ``native``; a rules file with ``"allow_quant": false`` brings
     ``native`` back, bitwise; ``sched_quant`` forced at 1 MiB within
     the bound and bitwise ``allreduce_quant_ring``.
   - ring attention through ``parallel.sp.ring_attention(q, k, v,
     impl="pallas")`` for the four cases above: one kernel launch per
     call, the bits of the checked kernel; ``impl="xla"`` launches
     nothing and agrees to tolerance; head dim 132, which the gate
     refuses, takes the xla path with no launch and agrees with full
     attention;
   - the ring hop through ``ppermute_shift`` at 8 MiB and 4 KiB per
     rank, every shift, bitwise ``torch.roll``. The JAX package calls it
     only from tests and ring attention fuses its own hop, so this phase
     is its only main-path use.
   - the surface, on both routes: ``comm.scan`` and ``comm.exscan``
     (TunedColl's on both) with every algorithm forced and the default
     decision, sum/prod/max/min, float32/bfloat16/int32, at 1 MiB and
     4004 B per rank, each bitwise the same spmd function on a CPU copy
     of the input; allgatherv, gatherv, scatterv, alltoallv, alltoallw,
     reduce_scatter (int32) on ragged counts and the neighbor
     collectives on a periodic 2 x 4 cart and a periodic ring of two
     ranks (duplicate edges), each equal to a numpy oracle; every
     collective ``*_init`` at 1 MiB per rank on PallasColl, started
     twice, bitwise the blocking call, the operation's kernel +1 launch
     per start and no other (none for the eleven without a kernel);
     ``barrier`` and ``barrier_init`` on both, completing on CUDA
     events; ``allreduce_init`` at 1 GiB per rank on PallasColl (the
     chunked ring) started twice (the second waited with
     ``timeout=60``), rebound and started again, each bitwise the
     blocking call with ``ring_allreduce_chunked`` +1 per start; scan
     and exscan (native) at 1 GiB per rank on TunedColl, float32 SUM,
     column windows bitwise the CPU, within 1e-5 of sum |x| of a float64
     cumsum, temporaries under 40 GB; then a short IMB sweep
     (``ompi_tpu_torch.tools.imb.sweep``, every op, 4 B to 4 MiB, three
     iterations) on each route, one ``imb_short`` JSON line each. The
     one-rank communicator of the schedule compiler's path is made with
     ``coll_self_priority`` at 70, below tuned's 80, so that TunedColl
     and not SelfColl serves it and the forced name reaches the one-rank
     kernel.
   - point-to-point and the nonblocking collectives: the 15 ``i*``
     forms at 1 MiB per rank on both routes, each request holding a CUDA
     event after it starts and bitwise its blocking call, each
     kernel-backed form on PallasColl +1 launch of its kernel and the
     others none; p2p through TunedColl's communicator (ob1 over the
     ``ici`` and ``self`` BTLs): an eager ring at 4 KiB whose send
     buffers are written once the sends completed, self sends at 4 KiB
     and 1 GiB, ANY_SOURCE/ANY_TAG in arrival order, improbe/mrecv,
     persistent send/recv started twice and a 1 GiB rendezvous, each
     received tensor bitwise a CPU copy of what was sent and in storage
     of its own, the rendezvous timed in turns with ``x.clone()`` beside
     its bound (2 B over 3.35 TB/s); a 1 GiB-per-rank ``iallreduce`` on
     PallasColl with 16 eager p2p requests posted while it runs (one
     chunked-ring launch, bitwise the blocking call, every message
     bitwise), then timed in turns with the blocking call by CUDA
     events; every ``coll.nbc`` entry point at 64 MiB and 4 KiB per
     rank, bitwise the same schedule on a CPU copy of the input and its
     own second run (timed by the host's clock), a SUM within 1e-5 of
     sum |x| of the blocking call and every other op bitwise, and three
     schedules started together and completed out of order; its times
     on a ``p2p_nbc`` JSON line, its peak (reckoned ~26 GB) under 40 GB.
   - the training step: one decoder layer of Llama-2-7B at full width
     (``meta-llama/Llama-2-7b-hf``: the nine float32 gradient leaves of
     hidden 4096, intermediate 11008; 202 383 360 elements a rank), from
     a seed, on both routes: ``bucketer.allreduce_pytree`` on the
     default 4 MiB buckets (194; each leaf within 1e-5 of ``x.sum(0)``,
     three buckets bitwise the ring's plain version; on PallasColl also
     at 16 MiB buckets, the chunked ring), a ``DpOverlapSession`` with
     the default bucket and tile geometry for three steps and a
     ``dp.window_session(window=2)`` for two steps and ``flush()``, the
     marks replayed in the backward order ``grad_marker`` captured on the
     card over a chain of the leaf names, each result within rtol 1e-4,
     atol 1e-5 of ``x.sum(0)``, every stage and wire buffer and result on
     the card and no ``.cpu()``/``.numpy()`` of a CUDA tensor while the
     steps run; the session's fused table program (194 rings, 1552
     chunks of 512 KiB) and a window's boundary over four rs_ag buckets
     through ``sched_table``, bitwise its plain version; ``Psend_init``/
     ``Precv_init`` of rank 0's ``gate_proj`` gradient to rank 1 in 64
     partitions, ``Pready`` in a seeded random order with ``Parrived``
     polled, bitwise the sent tensor; a ``train_step`` JSON line (each
     item's host ms, the reports' ``overlap_pct`` and
     ``exposed_comm_ms``, the peak reckoned, 9 G = 58.3 GB, and
     measured, the card's name and power limit).
   - The flagship model (``models/transformer.build_forward``) at
     Mixtral-8x7B's widths (vocab 32000, d_model 4096, 32 heads of
     128, d_ff 14336, 8 experts of 14336; depth cut to 4 layers, context
     to 2048 tokens) over (dp, pp, tp) = (2, 2, 2), batch 8, bfloat16,
     with ``parallel_sp_impl=pallas``: exactly 6 ring-attention launches
     a forward (2 layers x 3 pipeline ticks), a finite loss and the
     last stage's hidden state (``build_hidden``) within
     ``MODEL_LOSS_RTOL`` and ``MODEL_HIDDEN_TOL`` of the same forward on
     the xla path, which two wrong models (attention without the other
     tp rank's KV block, every token routed to the next expert) must
     fail; its time and peak memory (a ``model`` JSON line).
   - ``graft_entry.dryrun_multichip(8)`` (two training steps at the tiny
     configuration, a vtable allreduce, the PallasColl allreduce through
     recursive doubling and the fused ring attention against the xla
     path) and ``entry()``'s forward.
   Each case frees its input, output and plain result before the next;
   ``max_memory_allocated`` is printed for each path and for the whole
   main path.
4. A ``kernels`` JSON line, one row per kernel at its main-path size
   (the reduction kernels' rows also carry their ``float64`` time):
   launches on the main path, max |kernel - plain|, p50 time of the
   kernel's wrapper over 20 launches (CUDA events, after warm-up), the
   plain version's time, the bytes bound over 3.35 TB/s (each input
   byte read once, each output byte written once) and the time of one
   PyTorch call computing the same function as a library yardstick the
   port never calls. The kernels of the rooted, half-ring and
   data-movement collectives also carry their p50 at 4 KiB per rank
   (``small_ms``), and so do the two of the schedule compiler.
   ``quant_allreduce``'s row is 1 GiB per rank with its p50 at 64 KiB
   per rank in ``small_ms``, its plan (``plan``: form, stripes, threads,
   segment rows) and in ``also`` its L2 form at n = 12 (about 1 GiB per
   rank) beside its bound and the exact sum; no single PyTorch call
   computes the int8
   wire's result, so its ``library_ms`` is null and the exact sum
   ``x.sum(0, keepdim=True).expand_as(x).contiguous()`` is timed beside
   it as ``exact_sum_ms``, for context, with the two TunedColl route
   p50s of the quant path (``quant_ring_ms``, ``exact_route_ms``).
   ``ring_allreduce_bidir``'s, ``ring_allreduce_chunked``'s,
   ``linear_scatter``'s, ``linear_gather``'s, ``ring_allreduce_rd``'s,
   ``sched_table``'s and ``selfdma_chunked``'s rows carry the plan their
   timed launches ran (``plan``: stripes, threads, and for the chunked
   ring and the table its segments and the buffers' memory; for the
   scatter its senders, receivers, threads and pieces; for the gather its
   blocks, pools, threads, pieces and pieces per publication; for
   recursive doubling its form; blocks and piece bytes), the
   reduce-scatter's and the allgather's its
   fields (stripes, threads, segment bytes, the buffers' memory and
   bytes). ``ring_allgather``'s ``also`` list holds its L2 form at n = 12
   (about 1 GiB received per rank) and ``allreduce_block_rsag`` at 1 GiB
   per rank, each beside its bound and library call;
   ``ring_allreduce_chunked``'s holds its L2 form at n = 12 (about 1 GiB
   per rank) and ``allreduce_block_rsag`` at 1 GiB per rank, the same
   function, timed beside it. ``sched_table``'s row is
   the segmented-ring program at 1 GiB per rank; its ``also`` list
   holds the ring program at 1 MiB (beside ``ring_allreduce``, the same
   protocol hard-coded) and the reduce-scatter program at 1 GiB sent
   per rank; ``selfdma_chunked``'s is n = 1 at 1 GiB.
   ``ring_allreduce``'s row also holds its host/device split from
   ``torch.profiler`` (``device_ms``, ``call_host_ms``,
   ``call_to_kernel_ms``, as ``ompi_tpu_torch/tools/ring_probe.py``
   reads them), ``ring_allreduce_rd``'s the same split, the form it ran
   (``form``) and the time of an empty kernel launched as that form is
   (``empty_launch_ms``, the floor the host sets), and ``tree_reduce``'s
   its block split
   (``blocks_per_relative_rank``, ``segment_cols``), each also printed
   on a line of its own.
   ``ppermute_shift``'s row is 8 MiB per rank (4 KiB in ``small_ms``),
   its library call ``torch.roll(x, 1, 0).contiguous()``, with its plan
   (``plan``), its device time from ``torch.profiler`` (``device_ms``),
   the time of an empty kernel launched as its form is
   (``empty_launch_ms``) and the device time of ``x.clone()``, a
   device-to-device memcpy of the same bytes (``memcpy_device_ms``), each
   also printed on a line of its own.
   ``ring_attention``'s row is bfloat16 causal, its other three cases and
   the model's folded shape in ``also``; its bound is the larger of the bytes (q, k, v, out once)
   over 3.35 TB/s and the operations (4 S^2 H Dh, causal 4 H Dh
   S(S+1)/2) over 989 TFLOP/s bfloat16 or 67 TFLOP/s float32, and its
   library call ``scaled_dot_product_attention`` on (1, H, S, Dh). Each
   of its four cases also carries ``n1_ms``, the kernel at n = 1 on the
   whole 4096-token sequence (every block on one rank: the same
   arithmetic with no ring, checked against its plain version), and the
   causal cases ``causal_over_noncausal``, their time over the
   non-causal case's.
5. The last line: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
KERNEL_REPS = 20
GIB, MIB, KIB = 1 << 30, 1 << 20, 1 << 10
N = 8
#: The reduction kernels' element types (``pallas_ring._DTYPE_CODES``):
#: every dtype loop of the kernel checks runs all seven.
DTYPES = ("int32", "float32", "bfloat16", "float64", "float16", "int8",
          "uint8")
#: The seven reduction kernels: each row also gives its float64 time at
#: the row's bytes per rank.
F64_KERNELS = ("ring_allreduce", "ring_allreduce_rd",
               "ring_allreduce_chunked", "ring_reduce_scatter",
               "tree_reduce", "ring_allreduce_bidir", "sched_table")
CARD = [""]  # nvidia-smi's "name, power limit", beside every time
MAIN_SIZES = {  # allreduce kernel -> bytes per rank on the main path
    "ring_allreduce_rd": 4 * KIB,
    "ring_allreduce": MIB,
    "ring_allreduce_chunked": GIB,
}
TUNED_NAMES = {
    "ring_allreduce_rd": "pallas_rd",
    "ring_allreduce": "pallas_ring",
    "ring_allreduce_chunked": "pallas_ring_chunked",
}
# Kernel of a rooted or half-ring collective -> (the tuned var, the
# name it forces).
COLL_CASES = {
    "tree_bcast": ("coll_tuned_bcast_algorithm", "pallas_binomial"),
    "tree_reduce": ("coll_tuned_reduce_algorithm", "pallas_tree"),
    "ring_reduce_scatter": ("coll_tuned_reduce_scatter_algorithm",
                            "pallas_ring"),
    "ring_allgather": ("coll_tuned_allgather_algorithm", "pallas_ring"),
}
# Kernel of a data-movement collective -> the tuned var forcing it (none:
# the alltoall kernel has no tuned name, tuned's default route runs).
MOVE_CASES = {
    "ring_alltoall": None,
    "linear_gather": ("coll_tuned_gather_algorithm", "pallas_linear"),
    "linear_scatter": ("coll_tuned_scatter_algorithm", "pallas_linear"),
}
COLL_SIZES = (GIB, 4 * KIB)  # main path, then the latency regime
BCAST_ROOT, REDUCE_ROOT = 3, 5
GATHER_ROOT, SCATTER_ROOT = 3, 5
BIDIR_BYTES = MIB
SOURCES = {
    "ring_allreduce": "ompi_tpu/coll/pallas_ring.py:219",
    "ring_allreduce_rd": "ompi_tpu/coll/pallas_ring.py:708",
    "ring_allreduce_chunked": "ompi_tpu/coll/pallas_ring.py:296",
    "ring_reduce_scatter": "ompi_tpu/coll/pallas_ring.py:167",
    "ring_allgather": "ompi_tpu/coll/pallas_ring.py:122",
    "tree_reduce": "ompi_tpu/coll/pallas_ring.py:784",
    "tree_bcast": "ompi_tpu/coll/pallas_ring.py:859",
    "ring_allreduce_bidir": "ompi_tpu/coll/pallas_ring.py:645",
    "ring_alltoall": "ompi_tpu/coll/pallas_ring.py:983",
    "linear_gather": "ompi_tpu/coll/pallas_ring.py:1042",
    "linear_scatter": "ompi_tpu/coll/pallas_ring.py:1122",
    "sched_table": "ompi_tpu/coll/sched/pallas_lower.py:439",
    "selfdma_chunked": "ompi_tpu/coll/pallas_ring.py:405",
    "quant_allreduce": "ompi_tpu/coll/quant.py:355",
    "ppermute_shift": "ompi_tpu/coll/pallas_ring.py:1209",
    "ring_attention": "ompi_tpu/coll/pallas_attn.py:39",
}
SCHED_KERNELS = ("sched_table", "selfdma_chunked")
# (stripes, threads) of the bidirectional ring's extra kernel-vs-plain
# cases: one block per rank and direction up to 2 x 8 x 8 blocks of up
# to 1024 threads, which 132 SMs hold at once.
BIDIR_PLANS = ((1, 128), (3, 256), (8, 512), (8, 1024))
# The sched path's forced names: allreduce at 1 MiB and 1 GiB per rank,
# reduce_scatter_block at 1 GiB sent per rank.
SCHED_FORCED = (("sched_pallas_ring", MIB), ("sched_pallas_ring_seg", GIB),
                ("sched_pallas_rs", GIB))
# Names checked bitwise against the same call on a CPU communicator.
CPU_NAMES = ("sched_ring", "sched_rd", "sched_hier", "ring")
TUNE_SIZES = (4 * KIB, MIB, GIB)
# The quantized wire's forced kernel sizes: the gate's 64 KiB minimum,
# 1 MiB and 1 GiB per rank.
QUANT_SIZES = (64 * KIB, MIB, GIB)
QUANT_SMALL = 64 * KIB
#: p50s of the unforced routes at 1 GiB per rank, set by the quant path
#: and written into the quant_allreduce row.
QUANT_ROUTE: dict = {}
QUANT_ROUTE_REPS = 5
PEAK = [0]  # the main path's peak device memory over its paths
# Rows per ring block of the quant kernel's checks: at n = 2 and n = 3
# the last count's stripes do not divide it; n = 12 takes the L2 form.
QUANT_ROWS = {2: (128, 384, 2176), 3: (128, 384, 1536), 8: (128, 384, 1152),
              12: (128, 384)}
# Ring attention at Llama-2-7B's attention widths (meta-llama/Llama-2-7b-hf
# config.json: num_attention_heads 32, hidden_size 4096, so head dim 128;
# max_position_embeddings 4096), multi-head, the 4096-token context
# sharded over N virtual ranks: T = 512 tokens per rank.
ATTN_HEADS, ATTN_HEAD_DIM, ATTN_SEQ = 32, 128, 4096
ATTN_T = ATTN_SEQ // N
# (atol, rtol): |got - want| <= atol + rtol |want| everywhere. float32:
# the JAX package's 2e-4. bfloat16: one bfloat16 ulp (2**-7 of |want|,
# and 1e-5 for outputs near 0). The kernel, its plain version and full
# attention all compute in float32 and round once to bfloat16, so they
# differ by at most one ulp; the JAX package's 3e-2, set at S <= 64, is
# as wide as a typical output at S = 4096 (about 0.026). Two controls
# that round p, or the output accumulator, to bfloat16 must fail it.
ATTN_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (1e-5, 2.0 ** -7)}
ATTN_CASES = tuple((dtype, causal) for dtype in ("bfloat16", "float32")
                   for causal in (True, False))
ATTN_MAIN = ("bfloat16", True)  # the kernels-line row; the rest in "also"
RACE_LAUNCHES = 20
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM data sheet
# The ring hop's sizes per rank: the slice's KV block (2T x H x Dh
# bfloat16, 8 MiB), then 4 KiB.
HOP_BYTES = 2 * ATTN_T * ATTN_HEADS * ATTN_HEAD_DIM * 2
HOP_SHIFTS = (1, -1, 3)
#: kernel outputs of the attention checks, (dtype, causal) -> tensor; the
#: main path's calls must give the same bits.
ATTN_OUT: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def bits(t):
    import torch

    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def max_abs_err(a, b) -> float:
    """max |a - b| in float64, one leading row at a time (a 1 GiB row is
    2 GiB in float64)."""
    rows = a.shape[0] if a.ndim > 1 else 1
    a, b = a.reshape(rows, -1), b.reshape(rows, -1)
    err = 0.0
    for i in range(a.shape[0]):
        if a[i].numel():
            err = max(err, float((a[i].double() - b[i].double()).abs().max()))
    return err


def random_rank_major(shape, dtype, gen):
    """Seeded inputs: int32 in [-100, 100), int8 and uint8 over their
    whole range (so SUM and PROD wrap), normal floats (float64 drawn in
    float64, the others in float32 and rounded)."""
    import torch

    if dtype in (torch.int8, torch.uint8):
        info = torch.iinfo(dtype)
        return torch.randint(info.min, info.max + 1, shape, generator=gen,
                             device="cuda", dtype=torch.int32).to(dtype)
    if not dtype.is_floating_point:
        return torch.randint(-100, 100, shape, generator=gen, device="cuda",
                             dtype=torch.int32).to(dtype)
    draw = torch.float64 if dtype == torch.float64 else torch.float32
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=draw).to(dtype)


def check_dtypes():
    """The reduction kernels' seven element types, as torch dtypes."""
    import torch

    return [getattr(torch, name) for name in DTYPES]


def check_sems(counter) -> None:
    left = int(counter.last_sems.abs().sum())
    if left:
        raise AssertionError(f"{counter.name}: semaphores not back at 0 "
                             f"({left} left)")


def equal_or_raise(got, want, what: str) -> float:
    """max |got - want|, after checking that the two are bitwise equal."""
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != plain "
                             f"{tuple(want.shape)}")
    err = max_abs_err(got, want)
    if not torch.equal(bits(got), bits(want)):
        raise AssertionError(f"{what}: kernel != plain (max err {err})")
    return err


def wrap_check(name: str, n: int, shape, run, root=None) -> int:
    """An int8 and a uint8 SUM of 100 on each of n ranks through
    ``run(x, plain)``: the kernel bitwise its plain version, every flag
    back at 0, and the reduced rows (row ``root`` alone for a rooted
    kernel) 100 n modulo 256, as the JAX package's int8 arithmetic
    wraps. Returns the cases checked."""
    import torch
    from ompi_tpu_torch.core.counters import KERNELS

    for dtype in (torch.int8, torch.uint8):
        x = torch.full(shape, 100, dtype=dtype, device="cuda")
        got = run(x, False)
        torch.cuda.synchronize()
        check_sems(KERNELS[name])
        equal_or_raise(got, run(x, True), f"{name} n={n} {dtype} SUM of "
                       f"100s")
        want = (100 * n) % 256
        if dtype == torch.int8 and want > 127:
            want -= 256
        rows = got if root is None else got[root]
        if not bool((rows == want).all()):
            raise AssertionError(f"{name} n={n} {dtype} SUM of 100s: not "
                                 f"{want} (wrapped) everywhere")
    return 2


def kernel_vs_plain(pr, gen) -> None:
    import torch

    seg_elems = MIB // 4
    sizes = (33, 1000, seg_elems - 1, seg_elems + 1)
    coll_sizes = (33, 1000, 70001)  # per block (RS) or per rank (others)
    # the trees also over four segments, the last ragged; the
    # reduce-scatter also at fewer segments than steps and at many (the
    # lane padding keeps the last segment ragged)
    rs_seg = pr.RS_SEG_BYTES // 4
    more_sizes = {
        "tree_reduce": (3 * pr.TREE_SEG_COLS + 5000,),
        "tree_bcast": (3 * pr.BCAST_SEG_BYTES // 4 + 5000,),
        "ring_reduce_scatter": (3 * rs_seg - 300, 40 * rs_seg + 77),
    }

    def plain_kw(plain, key, fn):
        return {key: fn} if plain else {}

    cases = [  # (kernel, ranks, shape of x, (x, op, root, plain) -> out)
        ("ring_allreduce", (2, 3, 8), lambda n, e: (n, e),
         lambda x, op, root, plain: pr.allreduce_block(
             x, op, **plain_kw(plain, "ring", pr.ring_allreduce_plain))),
        ("ring_allreduce_chunked", (2, 3, 8), lambda n, e: (n, e),
         lambda x, op, root, plain: pr.allreduce_block_chunked(
             x, op, MIB, **plain_kw(plain, "chunked",
                                    pr.ring_allreduce_chunked_plain))),
        ("ring_allreduce_rd", (2, 8), lambda n, e: (n, e),
         lambda x, op, root, plain: pr.allreduce_block_rd(
             x, op, **plain_kw(plain, "rd", pr.ring_allreduce_rd_plain))),
        ("ring_reduce_scatter", (2, 3, 8), lambda n, e: (n, n, e),
         lambda x, op, root, plain: pr.reduce_scatter_block(
             x, op, **plain_kw(plain, "rs", pr.ring_reduce_scatter_plain))),
        ("ring_allgather", (2, 3, 8), lambda n, e: (n, e),
         lambda x, op, root, plain: pr.allgather_block(
             x, **plain_kw(plain, "ag", pr.ring_allgather_plain))),
        ("tree_reduce", (2, 3, 8), lambda n, e: (n, e),
         lambda x, op, root, plain: pr.reduce_block(
             x, op, root, **plain_kw(plain, "tree", pr.tree_reduce_plain))),
        ("tree_bcast", (2, 3, 8), lambda n, e: (n, e),
         lambda x, op, root, plain: pr.bcast_block(
             x, root, **plain_kw(plain, "tree", pr.tree_bcast_plain))),
        ("ring_allreduce_bidir", (2, 3, 8), lambda n, e: (n, e),
         lambda x, op, root, plain: pr.allreduce_block_bidir(
             x, op, **plain_kw(plain, "bidir",
                               pr.ring_allreduce_bidir_plain))),
        ("ring_alltoall", (2, 3, 8), lambda n, e: (n, n, e),
         lambda x, op, root, plain: pr.alltoall_block(
             x, **plain_kw(plain, "a2a", pr.ring_alltoall_plain))),
        ("linear_gather", (2, 3, 8), lambda n, e: (n, e),
         lambda x, op, root, plain: pr.gather_block(
             x, root, **plain_kw(plain, "gather", pr.linear_gather_plain))),
        ("linear_scatter", (2, 3, 8), lambda n, e: (n, e),
         lambda x, op, root, plain: pr.scatter_block(
             x, root, **plain_kw(plain, "scatter",
                                 pr.linear_scatter_plain))),
    ]
    from ompi_tpu_torch.core.counters import KERNELS

    rooted = ("tree_reduce", "tree_bcast", "linear_gather", "linear_scatter")
    for name, ns, shape_of, fn in cases:
        t0 = time.time()
        checked = 0
        reduces = name not in ("ring_allgather", "tree_bcast") + tuple(
            MOVE_CASES)
        for n in ns:
            roots = (0, n - 1) if name in rooted else (0,)
            for dtype in check_dtypes():
                for op in ("sum", "max", "min", "prod") if reduces else (None,):
                    for elems in (sizes if name in MAIN_SIZES else
                                  coll_sizes + more_sizes.get(name, ())):
                        x = random_rank_major(shape_of(n, elems), dtype, gen)
                        for root in roots:
                            got = fn(x, op, root, False)
                            torch.cuda.synchronize()
                            check_sems(KERNELS[name])
                            equal_or_raise(
                                got, fn(x, op, root, True),
                                f"{name} n={n} {dtype} {op} root={root} "
                                f"elems={elems}")
                            checked += 1
            if reduces:
                root = n - 1 if name in rooted else None
                checked += wrap_check(name, n, shape_of(n, 1000), lambda x, p:
                                      fn(x, "sum", n - 1, p), root)
        log(f"[kernel-vs-plain] {name}: {checked} cases at "
            f"{', '.join(DTYPES)} bitwise equal, all semaphores 0"
            f"{', int8/uint8 sums of 100s wrapped' if reduces else ''} "
            f"({time.time() - t0:.1f} s)")

    # The reduce-scatter's wavefront with one stripe: 41 segments, more
    # than the n - 1 steps, on blocks that are not whole vectors; its
    # buffers in a cluster's shared memory (the plan's choice up to n = 8)
    # and in L2 (the plan's choice at n = 12).
    t0 = time.time()
    checked = 0
    for n, clusters in ((3, (True, False)), (8, (True, False)),
                        (12, (False,))):
        for dtype in check_dtypes():
            seg = pr.RS_SEG_BYTES // dtype.itemsize
            x = random_rank_major((n, n, 40 * seg + 77), dtype, gen)
            for op in ("sum", "max", "min", "prod"):
                for cluster in clusters:
                    got = pr._rs_launch(x, op, stripes=1, cluster=cluster)
                    torch.cuda.synchronize()
                    check_sems(KERNELS["ring_reduce_scatter"])
                    equal_or_raise(got, pr.ring_reduce_scatter_plain(x, op),
                                   f"ring_reduce_scatter one stripe n={n} "
                                   f"{dtype} {op} cluster={cluster}")
                    checked += 1
    log(f"[kernel-vs-plain] ring_reduce_scatter with one stripe over 41 "
        f"segments, buffers in shared memory and in L2: {checked} cases "
        f"bitwise equal, all semaphores 0 ({time.time() - t0:.1f} s)")

    # The allgather's wavefront likewise: one stripe over 41 segments,
    # blocks that are not whole vectors, its buffers in a cluster's shared
    # memory and in L2 up to n = 8 and in L2 at n = 12 (the plan's L2
    # form), also at the plan's stripes there.
    t0 = time.time()
    checked = 0
    for n, clusters in ((3, (True, False)), (8, (True, False)),
                        (12, (False,))):
        for dtype in check_dtypes():
            ag_seg = pr.AG_SEG_BYTES // dtype.itemsize
            x = random_rank_major((n, 40 * ag_seg + 77), dtype, gen)
            want = pr.ring_allgather_plain(x)
            for cluster in clusters:
                for stripes in (1, None):
                    got = pr._ag_launch(x, stripes=stripes, cluster=cluster)
                    torch.cuda.synchronize()
                    check_sems(KERNELS["ring_allgather"])
                    equal_or_raise(got, want, f"ring_allgather n={n} "
                                   f"{dtype} stripes={stripes} "
                                   f"cluster={cluster}")
                    checked += 1
    log(f"[kernel-vs-plain] ring_allgather with one stripe over 41 "
        f"segments and at n = 12, buffers in shared memory and in L2: "
        f"{checked} cases bitwise equal, all semaphores 0 "
        f"({time.time() - t0:.1f} s)")

    # The chunked ring's wavefront likewise: one stripe and the plan's
    # over 41 segments, blocks that are not whole vectors, its buffers in
    # a cluster's shared memory and in L2 up to n = 8 and in L2 at n = 12.
    t0 = time.time()
    checked = 0
    for n, clusters in ((3, (True, False)), (8, (True, False)),
                        (12, (False,))):
        for dtype in check_dtypes():
            W = 40 * (pr.CHUNKED_CLUSTER_SEG_BYTES // dtype.itemsize) + 77
            x = random_rank_major((n, n, W), dtype, gen)
            for op in ("sum", "max", "min", "prod"):
                want = pr.ring_allreduce_chunked_plain(x, op, W)
                for cluster in clusters:
                    for stripes in (1, None):
                        got = pr._chunked_launch(x, op, stripes=stripes,
                                                 cluster=cluster)
                        torch.cuda.synchronize()
                        check_sems(KERNELS["ring_allreduce_chunked"])
                        equal_or_raise(got, want, f"ring_allreduce_chunked "
                                       f"n={n} {dtype} {op} stripes={stripes}"
                                       f" cluster={cluster}")
                        checked += 1
    log(f"[kernel-vs-plain] ring_allreduce_chunked with one stripe and the "
        f"plan's over 41 segments and at n = 12, buffers in shared memory "
        f"and in L2: {checked} cases bitwise equal, all semaphores 0 "
        f"({time.time() - t0:.1f} s)")

    # The bidirectional ring at other plans (stripes x threads, as the
    # sweep takes them, the plan's among them) and on halves that are not
    # whole 16-byte vectors (35 columns), at the main path's 1 MiB too.
    t0 = time.time()
    checked = 0
    for n in (2, 3, 8):
        for dtype in check_dtypes():
            for cols in (70, 1280) + ((MIB // 4 // n,) if n == N else ()):
                if cols > 1280 and dtype != torch.float32:
                    continue
                x = random_rank_major((n, n, cols), dtype, gen)
                for op in ("sum", "max", "min", "prod"):
                    want = pr.ring_allreduce_bidir_plain(x, op)
                    for stripes, threads in BIDIR_PLANS:
                        got = pr._bidir_launch(x, op, stripes, threads)
                        torch.cuda.synchronize()
                        check_sems(KERNELS["ring_allreduce_bidir"])
                        equal_or_raise(got, want,
                                       f"ring_allreduce_bidir n={n} {dtype} "
                                       f"{op} cols={cols} {stripes} x "
                                       f"{threads}")
                        checked += 1
    log(f"[kernel-vs-plain] ring_allreduce_bidir at {len(BIDIR_PLANS)} plans "
        f"and ragged halves: {checked} cases bitwise equal, all semaphores "
        f"0 ({time.time() - t0:.1f} s)")

    # The data movers copy bytes: other element sizes, at odd row widths
    # (no lane padding: the wrappers directly), take the element-sized
    # copies instead of the 16-byte vectors.
    t0 = time.time()
    checked = 0
    for dtype in (torch.float64, torch.float16, torch.int8):
        for n, elems in ((3, 33), (8, 1001)):
            x = random_rank_major((n, n, elems), dtype, gen)
            flat = x[:, 0].contiguous()
            movers = [
                ("ring_alltoall", lambda p: (pr.ring_alltoall_plain if p
                                             else pr.ring_alltoall)(x)),
                ("ring_allgather", lambda p: (pr.ring_allgather_plain if p
                                              else pr.ring_allgather)(flat)),
                ("linear_gather", lambda p: (pr.linear_gather_plain if p
                                             else pr.linear_gather)(
                                                 flat, n - 1)),
                ("linear_scatter", lambda p: (pr.linear_scatter_plain if p
                                              else pr.linear_scatter)(
                                                  flat, 1)),
            ]
            for name, run in movers:
                got = run(False)
                torch.cuda.synchronize()
                check_sems(KERNELS[name])
                equal_or_raise(got, run(True),
                               f"{name} n={n} {dtype} elems={elems}")
                checked += 1
    log(f"[kernel-vs-plain] data movers (and the allgather) at other "
        f"element sizes: {checked} "
        f"cases bitwise equal, all semaphores 0 ({time.time() - t0:.1f} s)")

    # The tree bcast moves bytes too: its wrapper takes every element
    # size its plain version takes (the training step's merged broadcast
    # sends uint8), at odd row widths, roots 0 and n - 1.
    t0 = time.time()
    checked = 0
    for dtype in (torch.uint8, torch.int8, torch.float16, torch.float64):
        for n, elems in ((2, 33), (3, 1001), (8, 4099)):
            x = random_rank_major((n, elems), dtype, gen)
            for root in (0, n - 1):
                got = pr.tree_bcast(x, root)
                torch.cuda.synchronize()
                check_sems(KERNELS["tree_bcast"])
                equal_or_raise(got, pr.tree_bcast_plain(x, root),
                               f"tree_bcast n={n} {dtype} elems={elems} "
                               f"root={root}")
                checked += 1
    log(f"[kernel-vs-plain] tree_bcast for uint8, int8, float16 and "
        f"float64 at odd row widths: {checked} cases bitwise equal, all "
        f"semaphores 0 ({time.time() - t0:.1f} s)")

    # The scatter's pieces of 16 and 48 bytes on rows that are not whole
    # vectors and start off a row: the ragged head and tail of every
    # piece copied byte by byte inside the kernel.
    t0 = time.time()
    checked = 0
    for n in (3, 8, 12):
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            x = random_rank_major((n, 1002), dtype, gen)
            buf = x[:, 1:]
            want = pr.linear_scatter_plain(buf, n - 1)
            for piece in (16, 48):
                got = pr._scatter_launch(buf, n - 1, piece)
                torch.cuda.synchronize()
                check_sems(KERNELS["linear_scatter"])
                equal_or_raise(got, want, f"linear_scatter n={n} {dtype} "
                               f"pieces of {piece} B")
                checked += 1
    log(f"[kernel-vs-plain] linear_scatter with pieces of 16 and 48 bytes "
        f"on unaligned rows: {checked} cases bitwise equal, all semaphores "
        f"0 ({time.time() - t0:.1f} s)")

    # The gather's pools likewise: pieces of 16 and 48 bytes (published
    # one and three at a time) on rows that are not whole vectors and start
    # off a row, at the plan's pools and at four blocks a SM (other pool
    # sizes, unequal at n = 3, 8 and 12).
    t0 = time.time()
    checked = 0
    for n in (3, 8, 12):
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            x = random_rank_major((n, 1002), dtype, gen)
            flat = x[:, 1:]
            for root in (0, n - 1):
                want = pr.linear_gather_plain(flat, root)
                for piece, publish in ((16, 1), (48, 3)):
                    for per_sm in (None, 4):
                        got = pr._gather_launch(flat, root, piece,
                                                per_sm=per_sm,
                                                publish=publish)
                        torch.cuda.synchronize()
                        check_sems(KERNELS["linear_gather"])
                        equal_or_raise(got, want, f"linear_gather n={n} "
                                       f"{dtype} root={root} pieces of "
                                       f"{piece} B, {per_sm} blocks a SM")
                        checked += 1
    log(f"[kernel-vs-plain] linear_gather with pieces of 16 and 48 bytes "
        f"on unaligned rows, two pool sizes: {checked} cases bitwise equal, "
        f"all semaphores 0 ({time.time() - t0:.1f} s)")

    # Recursive doubling in every form: the plan's (a cluster's shared
    # memory up to 8 ranks, global memory at 16), the L2 form forced, and
    # the cluster form over stripes of four vectors.
    t0 = time.time()
    checked = 0
    for n in (2, 4, 8, 16):
        forms = ((None, None), (False, None)) + (
            ((True, 64),) if n <= pr.RS_CLUSTER_RANKS else ())
        for dtype in check_dtypes():
            for elems in (33, 2500):
                x = random_rank_major((n, elems), dtype, gen)
                for op in ("sum", "max", "min", "prod"):
                    want = pr.ring_allreduce_rd_plain(x, op)
                    for cluster, stripe in forms:
                        got = pr._rd_launch(x, op, cluster=cluster,
                                            stripe_bytes=stripe)
                        torch.cuda.synchronize()
                        check_sems(KERNELS["ring_allreduce_rd"])
                        equal_or_raise(got, want, f"ring_allreduce_rd n={n} "
                                       f"{dtype} {op} elems={elems} "
                                       f"{pr.RD.last_plan}")
                        checked += 1
    log(f"[kernel-vs-plain] ring_allreduce_rd in both forms: {checked} cases "
        f"bitwise equal, all semaphores 0 ({time.time() - t0:.1f} s)")


def table_programs(ir, pl, n):
    """The table kernel's eight programs at n ranks."""
    order = list(range(0, n, 2)) + list(range(1, n, 2))
    return {
        "ring": ir.ring(n),
        "ring+order": ir.ring(n, order=order),
        "seg2": ir.segmented_ring(n, 2),
        "seg4": ir.segmented_ring(n, 4),
        "rs": ir.reduce_scatter(n),
        "ag": ir.allgather(n),
        "fuse3": pl.fuse_schedules("fuse3", [ir.ring(n),
                                             ir.segmented_ring(n, 2),
                                             ir.ring(n, order=order)]),
        "window": pl.fuse_window(
            "window", [ir.allgather(n), ir.allgather(n, order=order)],
            [ir.reduce_scatter(n), ir.reduce_scatter(n, order=order)]),
    }


def sched_kernel_vs_plain(pr, gen) -> None:
    """sched_table on its programs and selfdma_chunked at several
    segment counts, each bitwise against its plain version."""
    import torch
    from ompi_tpu_torch.coll.sched import ir
    from ompi_tpu_torch.coll.sched import pallas_lower as pl
    from ompi_tpu_torch.core.counters import KERNELS

    t0 = time.time()
    checked = 0
    for n in (2, 3, 4, 8, 12):
        for name, sched in table_programs(ir, pl, n).items():
            prog = pl.analyze(sched)
            for dtype in check_dtypes():
                for op in ("sum", "max", "min", "prod") if name != "ag" \
                        else ("sum",):
                    # ragged chunks, alternating between a short and a
                    # long one
                    chunk = (33, 1000)[checked % 2]
                    data = random_rank_major((n, prog.nchunks, chunk),
                                             dtype, gen)
                    got = pl.sched_table(prog, data, op)
                    torch.cuda.synchronize()
                    check_sems(KERNELS["sched_table"])
                    equal_or_raise(got, pl.sched_table_plain(prog, data, op),
                                   f"sched_table {name} n={n} {dtype} {op} "
                                   f"chunk={chunk}")
                    checked += 1
            if name == "ring":
                checked += wrap_check(
                    "sched_table", n, (n, prog.nchunks, 1000),
                    lambda x, p: (pl.sched_table_plain if p
                                  else pl.sched_table)(prog, x, "sum"))
    log(f"[kernel-vs-plain] sched_table: {checked} cases at "
        f"{', '.join(DTYPES)} bitwise equal, all semaphores 0, int8/uint8 "
        f"sums of 100s wrapped ({time.time() - t0:.1f} s)")
    # One stripe over fewer segments than a stage's rounds, as many and
    # more (the last ragged), the buffers in a cluster's shared memory and
    # in L2 (beyond 8 ranks in L2 only).
    t0 = time.time()
    checked = 0
    for n in (3, 8, 12):
        for name, sched in table_programs(ir, pl, n).items():
            prog = pl.analyze(sched)
            rounds = max(length for _, length in pl._stages(prog))
            for dtype in check_dtypes():
                seg = 256 // dtype.itemsize
                for segs in (2, rounds, rounds + 3):
                    data = random_rank_major(
                        (n, prog.nchunks, seg * segs - 5), dtype, gen)
                    want = pl.sched_table_plain(prog, data, "max",
                                                seg_cols=seg)
                    for cluster in (True, False) if n <= 8 else (False,):
                        got = pl._table_launch(
                            prog, data, "max", stripes=1, threads=128,
                            seg_bytes=256, cluster=cluster)
                        torch.cuda.synchronize()
                        check_sems(KERNELS["sched_table"])
                        plan = KERNELS["sched_table"].last_plan
                        if plan["segments"] != segs:
                            raise AssertionError(f"sched_table: {plan}, "
                                                 f"not {segs} segments")
                        equal_or_raise(got, want,
                                       f"sched_table {name} n={n} {dtype} "
                                       f"one stripe, {segs} segments, "
                                       f"cluster={cluster}")
                        checked += 1
    log(f"[kernel-vs-plain] sched_table with one stripe over segments, "
        f"buffers in shared memory and in L2: {checked} cases bitwise "
        f"equal, all semaphores 0 ({time.time() - t0:.1f} s)")
    t0 = time.time()
    checked = 0
    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.float64,
                  torch.float16, torch.int8):
        for segs, seg_cols in ((1, 4096), (3, 1000), (8, 333)):
            x = random_rank_major((1, segs * seg_cols), dtype, gen)
            got = pr.selfdma_chunked(x, seg_cols)
            torch.cuda.synchronize()
            if got.data_ptr() == x.data_ptr() or not torch.equal(got, x):
                raise AssertionError(f"selfdma_chunked {dtype} {segs} "
                                     f"segments: not a copy of its input")
            equal_or_raise(got, pr.selfdma_chunked_plain(x, seg_cols),
                           f"selfdma_chunked {dtype} segments={segs}")
            checked += 1
    log(f"[kernel-vs-plain] selfdma_chunked: {checked} cases bitwise equal "
        f"({time.time() - t0:.1f} s)")


def quant_kernel_vs_plain(gen) -> None:
    """quant_allreduce against its plain version through
    ``allreduce_block_quant`` (SUM; float32 and bfloat16 inputs, ragged
    sizes padded to whole quanta), in the form its plan takes (a
    cluster's shared memory up to 8 ranks, L2 beyond), at the plan's
    segments and at one-row segments, and on tie-heavy values, bitwise,
    every flag back at 0."""
    import torch
    from ompi_tpu_torch.coll import quant
    from ompi_tpu_torch.core.counters import KERNELS

    t0 = time.time()
    checked = 0

    def check(x, what):
        nonlocal checked
        n = x.shape[0]
        want = quant.allreduce_block_quant(x, "sum",
                                           quant=quant.quant_allreduce_plain)
        for seg in (None, 1):
            got = quant.allreduce_block_quant(
                x, "sum", quant=lambda b: quant._quant_launch(b, seg_rows=seg))
            torch.cuda.synchronize()
            check_sems(KERNELS["quant_allreduce"])
            plan = KERNELS["quant_allreduce"].last_plan
            if plan["form"] != ("cluster" if n <= 8 else "l2"):
                raise AssertionError(f"quant_allreduce n={n}: form {plan}")
            equal_or_raise(got, want, f"quant_allreduce {what} {plan}")
            checked += 1

    for n, row_counts in QUANT_ROWS.items():
        for dtype in (torch.float32, torch.bfloat16):
            for rows in row_counts:
                x = random_rank_major((n, n * rows * 128 - 333), dtype, gen)
                check(x, f"n={n} {dtype} rows={rows}")
    # quotients by the scale on ties (multiples of 0.5 up to 127): the
    # kernel's reciprocal path must give way to the division there
    x = torch.randint(-254, 255, (N, N * 128 * 128), generator=gen,
                      device="cuda").float() * 0.5
    check(x, "ties")
    log(f"[kernel-vs-plain] quant_allreduce: {checked} cases bitwise equal, "
        f"all semaphores 0 ({time.time() - t0:.1f} s)")


def check_quant_bound(out, x, what: str) -> float:
    """Every rank's row of ``out`` identical, and row 0 within
    ``analytic_error_bound`` of the float64 sum of ``x``, computed over
    column chunks (whole 128-element scale blocks, so each chunk's bound
    is the whole one's); returns max |out - exact|."""
    import torch
    from ompi_tpu_torch.coll import quant

    n = x.shape[0]
    xf, of = x.reshape(n, -1), out.reshape(n, -1)
    chunk = 1 << 24
    worst = 0.0
    for c0 in range(0, xf.shape[1], chunk):
        xs, os_ = xf[:, c0:c0 + chunk], of[:, c0:c0 + chunk]
        if not bool((os_ == os_[:1]).all()):
            raise AssertionError(f"{what}: ranks disagree")
        err = (os_[0].double() - xs.double().sum(0)).abs()
        bound = quant.analytic_error_bound(xs).double()
        if not (bool(torch.isfinite(os_[0]).all())
                and bool((err <= bound).all())):
            raise AssertionError(f"{what}: outside the analytic error bound "
                                 f"(max err {float(err.max())})")
        worst = max(worst, float(err.max()))
    return worst


def allreduce_path(pcomm, tcomm, pr, config, counters, gen) -> dict:
    """The allreduce kernels through both routes; kernel -> max error."""
    import torch

    errs = {k: 0.0 for k in MAIN_SIZES}
    plain_of = {
        "ring_allreduce_rd": lambda x: pr.allreduce_block_rd(
            x, "sum", rd=pr.ring_allreduce_rd_plain),
        "ring_allreduce": lambda x: pr.allreduce_block(
            x, "sum", ring=pr.ring_allreduce_plain),
        "ring_allreduce_chunked": lambda x: pr.allreduce_block_chunked(
            x, "sum", chunked=pr.ring_allreduce_chunked_plain),
    }

    def run(comm, kernel, route):
        x = random_rank_major((N, MAIN_SIZES[kernel] // 4), torch.float32,
                              gen)
        t0 = time.time()
        out = comm.allreduce(x, "sum")
        torch.cuda.synchronize()
        dt = time.time() - t0
        check_sems(counters.KERNELS[kernel])
        if out.shape != x.shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{route} {kernel}: bad result "
                                 f"{tuple(out.shape)}")
        if not bool((out == out[:1]).all()):
            raise AssertionError(f"{route} {kernel}: ranks disagree")
        want = plain_of[kernel](x)
        errs[kernel] = max(errs[kernel],
                           equal_or_raise(out, want, f"{route} {kernel}"))
        log(f"[main] {route} {kernel}: {MAIN_SIZES[kernel]} B/rank x {N} "
            f"ranks, {dt * 1e3:.3f} ms host wall (first call), equal to "
            f"plain")
        del x, out, want
        torch.cuda.empty_cache()

    for kernel in MAIN_SIZES:
        run(pcomm, kernel, "PallasColl")
    for kernel, algo in TUNED_NAMES.items():
        config.VARS.set("coll_tuned_allreduce_algorithm", algo)
        run(tcomm, kernel, f"TunedColl[{algo}]")
    config.VARS.set("coll_tuned_allreduce_algorithm", "")
    host_tier(tcomm, gen)
    return errs


def host_oracle(x, op: str):
    """The host tier's result computed apart from it, on the CPU: float32
    and int32 in numpy, folded in rank order (one element per rank:
    numpy's pairwise order at n = 8), int32 wrapped; bfloat16 folded in
    rank order in float32, rounded to bfloat16 after every step."""
    import numpy as np
    import torch

    a = x.cpu()
    if a.dtype == torch.bfloat16:
        fn = {"sum": torch.add, "max": torch.maximum}[op]
        acc = a[0].float()
        for i in range(1, N):
            acc = fn(acc, a[i].float()).to(torch.bfloat16).float()
        return acc.to(torch.bfloat16)
    v = a.numpy().astype(np.int64 if a.dtype == torch.int32 else np.float32)
    fn = {"sum": np.add, "prod": np.multiply, "max": np.maximum}[op]
    if v.ndim == 1:  # pairwise: ((a0+a1)+(a2+a3))+((a4+a5)+(a6+a7))
        q = [fn(v[2 * i], v[2 * i + 1]) for i in range(N // 2)]
        acc = fn(fn(q[0], q[1]), fn(q[2], q[3]))
    else:
        acc = v[0]
        for i in range(1, N):
            acc = fn(acc, v[i])
    if a.dtype == torch.int32:
        acc = (np.asarray(acc) + 2**31) % 2**32 - 2**31
    return torch.from_numpy(np.array(acc, dtype=a.numpy().dtype))


def host_tier(tcomm, gen) -> None:
    """The default route at and just above ``coll_tuned_host_small_max_
    bytes`` (4096 B of the whole buffer): five cases reduced on the host
    (the SPC count ``coll_allreduce_algo_host`` rises once per shape,
    then the dispatch memo serves the repeat call), each bitwise its
    oracle; then the p50 host wall time of a call (launch to synchronize,
    100 calls) at 512 B per rank (the host tier) and 516 B per rank (the
    device route the decision takes there), on one JSON line."""
    import torch
    from ompi_tpu_torch.coll import tuned
    from ompi_tpu_torch.core.counters import SPC

    big = random_rank_major((N, 64), torch.float32, gen) * 1e3
    cases = (  # (input, op)
        (big[:, 0].contiguous(), "sum"),
        (random_rank_major((N, 64), torch.bfloat16, gen), "sum"),
        (random_rank_major((N, 64), torch.float32, gen), "prod"),
        (torch.randint(2**30, 2**31 - 1, (N, 16), generator=gen,
                       device="cuda", dtype=torch.int32), "sum"),
        (random_rank_major((N, 33), torch.bfloat16, gen), "max"),
    )
    for x, op in cases:
        before = SPC.read("coll_allreduce_algo_host")
        out = tcomm.allreduce(x, op)
        again = tcomm.allreduce(x, op)
        what = f"host tier {tuple(x.shape)} {x.dtype} {op}"
        if SPC.read("coll_allreduce_algo_host") != before + 1:
            raise AssertionError(f"{what}: not the host tier once")
        want = host_oracle(x, op).to(x.device).expand_as(x)
        if out.device != x.device:
            raise AssertionError(f"{what}: result on {out.device}")
        equal_or_raise(out, want, what)
        equal_or_raise(again, want, f"{what}, the memoized call")
    log(f"[main] TunedColl default route, {len(cases)} host-tier cases "
        f"({N} ranks, at most 4096 B in all): bitwise the oracle, the "
        f"repeat call through the dispatch memo")
    times = {}
    for per_rank in (512, 516):
        x = random_rank_major((N, per_rank // 4), torch.float32, gen)
        route = "host" if per_rank * N <= 4096 else tuned.decide_allreduce(
            tuned.op_lookup("sum"), per_rank, N, dtype=x.dtype)
        walls = []
        for _ in range(102):
            t0 = time.perf_counter()
            tcomm.allreduce(x, "sum")
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        times[per_rank] = {"route": route,
                           "p50_ms": statistics.median(walls[2:])}
    print(json.dumps({"host_tier": {f"{k}_bytes_per_rank": v
                                    for k, v in times.items()}}), flush=True)
    log(f"[main] TunedColl default route p50 (host wall, 100 calls): 512 "
        f"B/rank {times[512]['route']} {times[512]['p50_ms']:.5f} ms, 516 "
        f"B/rank {times[516]['route']} {times[516]['p50_ms']:.5f} ms")


def coll_input(kernel, nbytes, gen, dtype=None):
    """The main path's input of a rooted or half-ring collective at
    ``nbytes`` per rank (sent for reduce-scatter, received for
    allgather), in ``dtype`` (by default the tree reduce's int32, the
    others' float32)."""
    import torch

    dtype = dtype or (torch.int32 if kernel == "tree_reduce"
                      else torch.float32)
    elems = nbytes // dtype.itemsize
    if kernel == "ring_reduce_scatter":
        return random_rank_major((N, N, elems // N), dtype, gen)
    if kernel == "ring_allgather":
        return random_rank_major((N, elems // N), dtype, gen)
    return random_rank_major((N, elems), dtype, gen)


def coll_path(pcomm, tcomm, pr, config, counters, gen) -> dict:
    """bcast, reduce, reduce_scatter_block and allgather through both
    routes at 1 GiB and 4 KiB per rank; kernel -> max error."""
    import torch

    errs = {k: 0.0 for k in COLL_CASES}

    def call(comm, kernel, x):
        if kernel == "tree_bcast":
            return comm.bcast(x, BCAST_ROOT)
        if kernel == "tree_reduce":
            return comm.reduce(x, "max", REDUCE_ROOT)
        if kernel == "ring_reduce_scatter":
            return comm.reduce_scatter_block(x, "sum")
        return comm.allgather(x)

    def plain(kernel, x):
        if kernel == "tree_bcast":
            return pr.bcast_block(x, BCAST_ROOT, tree=pr.tree_bcast_plain)
        if kernel == "tree_reduce":
            return pr.reduce_block(x, "max", REDUCE_ROOT,
                                   tree=pr.tree_reduce_plain)[REDUCE_ROOT]
        if kernel == "ring_reduce_scatter":
            return pr.reduce_scatter_block(x, "sum",
                                           rs=pr.ring_reduce_scatter_plain)
        return pr.allgather_block(x, ag=pr.ring_allgather_plain)

    def independent_check(kernel, x, out, what):
        """The result against what PyTorch computes on its own."""
        if kernel == "tree_bcast":
            ok = out.shape == x.shape and all(
                torch.equal(out[i], x[BCAST_ROOT]) for i in range(N))
        elif kernel == "tree_reduce":
            ok = torch.equal(out, x.amax(0))
        elif kernel == "ring_reduce_scatter":
            # float32 sums in another order: a few ulps apart.
            ok = bool(torch.isfinite(out).all()) and torch.allclose(
                out, x.sum(0), rtol=1e-5, atol=1e-5)
        else:
            ok = out.shape == (N,) + tuple(x.shape) and all(
                torch.equal(out[i], x) for i in range(N))
        if not ok:
            raise AssertionError(f"{what}: wrong result")

    def run(comm, kernel, nbytes, route):
        x = coll_input(kernel, nbytes, gen)
        t0 = time.time()
        out = call(comm, kernel, x)
        torch.cuda.synchronize()
        dt = time.time() - t0
        check_sems(counters.KERNELS[kernel])
        what = f"{route} {kernel} {nbytes} B/rank"
        independent_check(kernel, x, out, what)
        want = plain(kernel, x)
        errs[kernel] = max(errs[kernel], equal_or_raise(out, want, what))
        log(f"[main] {what} x {N} ranks: {dt * 1e3:.3f} ms host wall "
            f"(first call), equal to plain and to the torch check")
        del x, out, want
        torch.cuda.empty_cache()

    for kernel in COLL_CASES:
        for nbytes in COLL_SIZES:
            run(pcomm, kernel, nbytes, "PallasColl")
    for kernel, (var, algo) in COLL_CASES.items():
        config.VARS.set(var, algo)
        for nbytes in COLL_SIZES:
            run(tcomm, kernel, nbytes, f"TunedColl[{algo}]")
        config.VARS.set(var, "")

    # pallas_rsag: the two halves one after the other fold every element
    # in the ring's order, so they equal pallas_ring bit for bit; at 1 GiB
    # per rank it equals its halves' plain versions.
    x = random_rank_major((N, MIB // 4), torch.float32, gen)
    config.VARS.set("coll_tuned_allreduce_algorithm", "pallas_rsag")
    got = tcomm.allreduce(x, "sum")
    config.VARS.set("coll_tuned_allreduce_algorithm", "pallas_ring")
    ring = tcomm.allreduce(x, "sum")
    config.VARS.set("coll_tuned_allreduce_algorithm", "")
    torch.cuda.synchronize()
    equal_or_raise(got, ring, "TunedColl[pallas_rsag] vs [pallas_ring]")
    log(f"[main] TunedColl[pallas_rsag] {MIB} B/rank x {N} ranks: bitwise "
        f"equal to TunedColl[pallas_ring]")
    del x, got, ring
    x = random_rank_major((N, GIB // 4), torch.float32, gen)
    config.VARS.set("coll_tuned_allreduce_algorithm", "pallas_rsag")
    t0 = time.time()
    got = tcomm.allreduce(x, "sum")
    torch.cuda.synchronize()
    dt = time.time() - t0
    config.VARS.set("coll_tuned_allreduce_algorithm", "")
    for kernel in ("ring_reduce_scatter", "ring_allgather"):
        check_sems(counters.KERNELS[kernel])
    want = pr.allreduce_block_rsag(x, "sum", rs=pr.ring_reduce_scatter_plain,
                                   ag=pr.ring_allgather_plain)
    errs["ring_allgather"] = max(errs["ring_allgather"], equal_or_raise(
        got, want, f"TunedColl[pallas_rsag] {GIB} B/rank"))
    log(f"[main] TunedColl[pallas_rsag] {GIB} B/rank x {N} ranks: "
        f"{dt * 1e3:.3f} ms host wall (first call), equal to its halves' "
        f"plain versions")
    del x, got, want
    torch.cuda.empty_cache()
    return errs


def bidir_path(pcomm, tcomm, pr, config, counters, gen) -> float:
    """The bidirectional ring allreduce through both routes; returns the
    max error against its plain version."""
    import torch

    err = 0.0
    x = random_rank_major((N, BIDIR_BYTES // 4), torch.float32, gen)
    want = pr.allreduce_block_bidir(x, "sum",
                                    bidir=pr.ring_allreduce_bidir_plain)
    for comm, route, var, value in (
            (pcomm, "PallasColl[coll_pallas_bidir=1]", "coll_pallas_bidir",
             True),
            (tcomm, "TunedColl[pallas_bidir]",
             "coll_tuned_allreduce_algorithm", "pallas_bidir")):
        config.VARS.set(var, value)
        t0 = time.time()
        out = comm.allreduce(x, "sum")
        torch.cuda.synchronize()
        dt = time.time() - t0
        config.VARS.set(var, False if var == "coll_pallas_bidir" else "")
        check_sems(counters.KERNELS["ring_allreduce_bidir"])
        # float32 sums in another order: a few ulps apart.
        if not (bool(torch.isfinite(out).all()) and torch.allclose(
                out, x.sum(0, keepdim=True).expand_as(x), rtol=1e-5,
                atol=1e-5)):
            raise AssertionError(f"{route}: wrong result")
        err = max(err, equal_or_raise(out, want, route))
        log(f"[main] {route} {BIDIR_BYTES} B/rank x {N} ranks: "
            f"{dt * 1e3:.3f} ms host wall (first call), equal to plain and "
            f"to the torch check")
    return err


def move_input(kernel, nbytes, gen):
    """The main path's input of a data-movement collective at ``nbytes``
    per rank (sent per rank for alltoall; root's buffer holds n rows of
    ``nbytes`` for scatter)."""
    import torch

    if kernel == "ring_alltoall":
        return random_rank_major((N, N, nbytes // 4 // N), torch.float32, gen)
    return random_rank_major((N, nbytes // 4), torch.float32, gen)


def move_path(pcomm, tcomm, pr, config, counters, gen) -> dict:
    """alltoall, gather and scatter through both routes at 1 GiB and
    4 KiB per rank; kernel -> max error."""
    import torch
    from ompi_tpu_torch.coll import tuned

    errs = {k: 0.0 for k in MOVE_CASES}

    def call(comm, kernel, x):
        if kernel == "ring_alltoall":
            return comm.alltoall(x)
        if kernel == "linear_gather":
            return comm.gather(x, GATHER_ROOT)
        return comm.scatter(x, SCATTER_ROOT)

    def plain(kernel, x):
        if kernel == "ring_alltoall":
            return pr.alltoall_block(x, a2a=pr.ring_alltoall_plain)
        if kernel == "linear_gather":
            return pr.gather_block(x, GATHER_ROOT,
                                   gather=pr.linear_gather_plain)
        return pr.scatter_block(x, SCATTER_ROOT,
                                scatter=pr.linear_scatter_plain)

    def independent_check(kernel, x, out, what):
        """The result against what PyTorch computes on its own."""
        want = x.transpose(0, 1) if kernel == "ring_alltoall" else x
        if out.shape != want.shape or not torch.equal(out, want):
            raise AssertionError(f"{what}: wrong result")

    def run(comm, kernel, nbytes, route):
        x = move_input(kernel, nbytes, gen)
        t0 = time.time()
        out = call(comm, kernel, x)
        torch.cuda.synchronize()
        dt = time.time() - t0
        what = f"{route} {kernel} {nbytes} B/rank"
        check_sems(counters.KERNELS[kernel])
        independent_check(kernel, x, out, what)
        want = plain(kernel, x)
        errs[kernel] = max(errs[kernel], equal_or_raise(out, want, what))
        del want
        torch.cuda.empty_cache()
        log(f"[main] {what} x {N} ranks: {dt * 1e3:.3f} ms host wall "
            f"(first call), equal to plain and to the torch check")
        if kernel == "ring_alltoall":
            # TunedColl's default route: the spmd algorithm the priors
            # pick (pairwise at 128 MiB per destination), no kernel.
            before = counters.KERNELS[kernel].launches
            algo = tuned.decide_alltoall(nbytes // N, N)
            t0 = time.time()
            default = tcomm.alltoall(x)
            torch.cuda.synchronize()
            dt = time.time() - t0
            if counters.KERNELS[kernel].launches != before:
                raise AssertionError("tuned's default alltoall launched the "
                                     "kernel")
            equal_or_raise(default, out,
                           f"TunedColl[{algo}] alltoall vs kernel")
            log(f"[main] TunedColl[{algo}] (default) alltoall {nbytes} "
                f"B/rank x {N} ranks: {dt * 1e3:.3f} ms host wall, equal to "
                f"the kernel's result")
            del default
        del x, out
        torch.cuda.empty_cache()

    for kernel in MOVE_CASES:
        for nbytes in COLL_SIZES:
            run(pcomm, kernel, nbytes, "PallasColl")
    for kernel, forced in MOVE_CASES.items():
        if forced is None:
            continue
        var, algo = forced
        config.VARS.set(var, algo)
        for nbytes in COLL_SIZES:
            run(tcomm, kernel, nbytes, f"TunedColl[{algo}]")
        config.VARS.set(var, "")
    return errs


def sched_plain(pl, sched_mod, algo: str):
    """The plain version of a ``sched_pallas_*`` name, on the layout its
    registered wrapper uses."""
    sched = sched_mod.build_schedule(algo, N)
    return pl._make_wrapper(pl.analyze(sched), sched.name,
                            table=pl.sched_table_plain)


def sched_path(world, tcomm, pr, config, counters, gen) -> dict:
    """The schedule compiler on the allreduce and reduce-scatter paths:
    the forced names through TunedColl, the one-rank chunked kernel,
    the interpreted schedules against the CPU, then the winner cache
    from a measure-mode sweep on the card; kernel -> max error."""
    import torch
    from ompi_tpu_torch.communicator import Communicator
    from ompi_tpu_torch.coll import sched as sched_mod
    from ompi_tpu_torch.coll import tuned
    from ompi_tpu_torch.coll.sched import autotune
    from ompi_tpu_torch.coll.sched import pallas_lower as pl
    from ompi_tpu_torch.core.counters import SPC
    from ompi_tpu_torch.group import Group
    from ompi_tpu_torch.runtime import mesh

    errs = {k: 0.0 for k in SCHED_KERNELS}
    force = "coll_tuned_allreduce_algorithm"
    for algo, nbytes in SCHED_FORCED:
        rs = algo == "sched_pallas_rs"
        var = "coll_tuned_reduce_scatter_algorithm" if rs else force
        shape = (N, N, nbytes // 4 // N) if rs else (N, nbytes // 4)
        x = random_rank_major(shape, torch.float32, gen)
        config.VARS.set(var, algo)
        t0 = time.time()
        out = tcomm.reduce_scatter_block(x, "sum") if rs \
            else tcomm.allreduce(x, "sum")
        torch.cuda.synchronize()
        dt = time.time() - t0
        config.VARS.set(var, "")
        check_sems(counters.KERNELS["sched_table"])
        what = f"TunedColl[{algo}] {nbytes} B/rank"
        if not (bool(torch.isfinite(out).all()) and torch.allclose(
                out, x.sum(0) if rs else x.sum(0, keepdim=True).expand_as(x),
                rtol=1e-5, atol=1e-5)):
            raise AssertionError(f"{what}: wrong result")
        want = sched_plain(pl, sched_mod, algo)(x, "sum")
        errs["sched_table"] = max(errs["sched_table"],
                                  equal_or_raise(out, want, what))
        log(f"[main] {what} x {N} ranks: {dt * 1e3:.3f} ms host wall (first "
            f"call), equal to plain and to the torch check")
        del x, out, want
        torch.cuda.empty_cache()

    # The one-rank kernel: a forced name runs on a one-rank communicator.
    # SelfColl (priority 100) takes every one-rank communicator; below
    # tuned's 80 it leaves this one to TunedColl and its forced name.
    config.VARS.set("coll_self_priority", 70)
    solo = world.split([0] + [-1] * (N - 1))[0]
    config.VARS.set("coll_self_priority", 100)
    if solo._coll["allreduce"][0].NAME != "tuned":
        raise AssertionError("one-rank communicator not on TunedColl")
    x = random_rank_major((1, GIB // 4), torch.float32, gen)
    config.VARS.set(force, "pallas_ring_chunked")
    before = counters.KERNELS["selfdma_chunked"].launches
    t0 = time.time()
    out = solo.allreduce(x, "sum")
    torch.cuda.synchronize()
    dt = time.time() - t0
    config.VARS.set(force, "")
    if counters.KERNELS["selfdma_chunked"].launches != before + 1:
        raise AssertionError("one-rank pallas_ring_chunked: the kernel did "
                             "not launch")
    if out.data_ptr() == x.data_ptr() or not torch.equal(out, x):
        raise AssertionError("one-rank pallas_ring_chunked: not a copy of "
                             "its input")
    want = pr.allreduce_block_chunked(x, "sum",
                                      selfdma=pr.selfdma_chunked_plain)
    errs["selfdma_chunked"] = equal_or_raise(out, want, "one-rank chunked")
    log(f"[main] TunedColl[pallas_ring_chunked] one-rank communicator, "
        f"{GIB} B: {dt * 1e3:.3f} ms host wall (first call), a new tensor "
        f"equal to its input and to plain")
    del x, out, want
    torch.cuda.empty_cache()

    # The interpreted schedules and the spmd ring: the same call on a
    # CPU communicator over a copy of the input.
    cpu = Communicator(Group(range(N)),
                       mesh.discover(N, torch.device("cpu")), name="CPU")
    x = random_rank_major((N, MIB // 4), torch.float32, gen)
    xc = x.cpu()
    for algo in CPU_NAMES:
        config.VARS.set(force, algo)
        out = tcomm.allreduce(x, "sum")
        ref = cpu.allreduce(xc, "sum")
        config.VARS.set(force, "")
        equal_or_raise(out.cpu(), ref, f"TunedColl[{algo}] card vs CPU")
        log(f"[main] TunedColl[{algo}] {MIB} B/rank x {N} ranks: bitwise "
            f"the same call on the CPU")
    cpu.free()
    del x, xc

    # The winner cache: a measure-mode sweep on the card, then the
    # unforced route at each size.
    cache_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "_archive", "sched_cache")
    config.VARS.set("coll_sched_cache_dir", cache_dir)
    t0 = time.time()
    res = autotune.tune(N, comm=tcomm, mode="measure", include_pallas=True,
                        sizes=TUNE_SIZES)
    dt = time.time() - t0
    allowed, _ = autotune.candidates("allreduce", N, include_pallas=True)
    for point, times in res["times"].items():
        if set(times) != set(allowed):
            raise AssertionError(f"autotune {point}: no time for "
                                 f"{sorted(set(allowed) - set(times))}")
    if len(res["times"]) != len(TUNE_SIZES):
        raise AssertionError(f"autotune timed {sorted(res['times'])}")
    print(json.dumps({"autotune": {
        "winners": res["winners"], "seconds": res["times"],
        "path": res["path"], "digest": res["digest"]}}), flush=True)
    log(f"[main] measure-mode autotune: {len(allowed)} candidates x "
        f"{len(TUNE_SIZES)} sizes, every candidate timed, {dt:.1f} s")
    torch.cuda.empty_cache()
    from ompi_tpu_torch.coll.sched import cache

    cache.CACHE.clear()  # the unforced route loads the saved file
    for nbytes in TUNE_SIZES:
        x = random_rank_major((N, nbytes // 4), torch.float32, gen)
        key = cache.cache_key("allreduce", nbytes, N, torch.float32,
                              autotune.fingerprint())
        winner = res["winners"][key]
        hits = SPC.read("sched_cache_hits")
        out = tcomm.allreduce(x, "sum")
        if SPC.read("sched_cache_hits") != hits + 1:
            raise AssertionError(f"{nbytes} B/rank: the decision did not "
                                 f"hit the winner cache")
        if tuned.decide_allreduce(tuned.op_lookup("sum"), nbytes, N,
                                  dtype=x.dtype) != winner:
            raise AssertionError(f"{nbytes} B/rank: decision is not the "
                                 f"cached winner {winner}")
        config.VARS.set(force, winner)
        named = tcomm.allreduce(x, "sum")
        config.VARS.set(force, "")
        torch.cuda.synchronize()
        equal_or_raise(out, named, f"cached {winner} vs forced")
        log(f"[main] TunedColl unforced {nbytes} B/rank: the cache's "
            f"{winner}, bitwise {winner} called by name")
        del x, out, named
        torch.cuda.empty_cache()
    dispatch_cost(tcomm, config, cache, cache_dir,
                  res["winners"][cache.cache_key(
                      "allreduce", 4 * KIB, N, torch.float32,
                      autotune.fingerprint())], gen)
    config.VARS.set("coll_sched_cache_dir", "")
    return errs


def dispatch_cost(tcomm, config, cache, cache_dir, winner, gen) -> None:
    """The winner-cache consult's host cost at 4 KiB per rank through
    TunedColl, in five arms interleaved in rounds: with the dispatch memo
    off, the saved cache loaded (a hit on ``winner``), ``winner`` forced
    (no consult), no cache (an untuned process: a miss, then the priors)
    and the consult off (the priors); and the first with the memo on
    (the decision made once, then skipped); ten rounds, each in another
    order. Hit against forced and untuned against off run the same
    algorithm, so each difference is the consult; memo against hit is
    what the memo saves. Per arm: the
    p50 host time of ``comm.allreduce`` from launch to synchronize, and
    the mean host time of ``decide_allreduce`` alone."""
    import torch
    from ompi_tpu_torch.coll import tuned
    from ompi_tpu_torch.core.counters import SPC

    x = random_rank_major((N, 4 * KIB // 4), torch.float32, gen)
    op = tuned.op_lookup("sum")
    empty = os.path.join(os.path.dirname(cache_dir), "sched_cache_empty")
    force = "coll_tuned_allreduce_algorithm"
    memo = "coll_tuned_fast_dispatch_cache"
    # The first four arms run the decision on every call (the dispatch
    # memo off); "memo" is "hit" with the memo on, as users get it.
    arms = {"hit": {"coll_sched_cache_dir": cache_dir, memo: False},
            "forced": {"coll_sched_cache_dir": cache_dir, force: winner,
                       memo: False},
            "untuned": {"coll_sched_cache_dir": empty, memo: False},
            "off": {"coll_sched_cache_enable": False, memo: False},
            "memo": {"coll_sched_cache_dir": cache_dir}}
    calls = {arm: [] for arm in arms}
    decides = {arm: [] for arm in arms}
    for rnd in range(10):
        k = rnd % len(arms)
        order = list(arms)[k:] + list(arms)[:k]
        for arm in order if rnd % 2 else order[::-1]:
            values = arms[arm]
            cache.CACHE.clear()
            for var, value in values.items():
                config.VARS.set(var, value)
            # the load attempt, once per arm; the memo's plan after it
            for _ in range(2):
                tcomm.allreduce(x, "sum")
            torch.cuda.synchronize()
            hits = SPC.read("sched_cache_hits")
            for _ in range(40):
                t0 = time.perf_counter()
                tcomm.allreduce(x, "sum")
                torch.cuda.synchronize()
                calls[arm].append((time.perf_counter() - t0) * 1e6)
            t0 = time.perf_counter()
            for _ in range(2000):
                tuned.decide_allreduce(op, 4 * KIB, N, dtype=x.dtype)
            decides[arm].append((time.perf_counter() - t0) / 2000 * 1e6)
            want = {"hit": 2040, "memo": 2000}.get(arm, 0)
            if SPC.read("sched_cache_hits") - hits != want:
                raise AssertionError(f"dispatch arm {arm}: wrong cache hits")
            config.VARS.set(force, "")
            config.VARS.set("coll_sched_cache_enable", True)
            config.VARS.set(memo, True)
    out = {"winner": winner,
           "allreduce_p50_us": {a: statistics.median(v)
                                for a, v in calls.items()},
           "decide_mean_us": {a: statistics.median(v)
                              for a, v in decides.items()}}
    print(json.dumps({"dispatch_4k": out}), flush=True)
    log(f"[main] TunedColl 4 KiB/rank host us: {out}")


def quant_path(tcomm, config, counters, gen) -> dict:
    """The quantized wire through TunedColl with the winner cache off
    (so the priors' quant gate decides): the forced kernel name at
    three sizes, the unforced gate, MAX, the rules-file veto and the
    schedule compiler's ``sched_quant``; kernel -> max error against
    its plain version."""
    import torch
    from ompi_tpu_torch.coll import quant, tuned
    from ompi_tpu_torch.coll.sched import cache  # noqa: F401 (its cvars)
    from ompi_tpu_torch.core.counters import SPC

    errs = {"quant_allreduce": 0.0}
    force = "coll_tuned_allreduce_algorithm"
    config.VARS.set("coll_sched_cache_enable", False)
    for nbytes in QUANT_SIZES:
        x = random_rank_major((N, nbytes // 4), torch.float32, gen)
        config.VARS.set(force, "quant_pallas")
        t0 = time.time()
        out = tcomm.allreduce(x, "sum")
        torch.cuda.synchronize()
        dt = time.time() - t0
        config.VARS.set(force, "")
        check_sems(counters.KERNELS["quant_allreduce"])
        what = f"TunedColl[quant_pallas] {nbytes} B/rank"
        exact_err = check_quant_bound(out, x, what)
        want = quant.allreduce_block_quant(x, "sum",
                                           quant=quant.quant_allreduce_plain)
        errs["quant_allreduce"] = max(errs["quant_allreduce"],
                                      equal_or_raise(out, want, what))
        log(f"[main] {what} x {N} ranks: {dt * 1e3:.3f} ms host wall (first "
            f"call), equal to plain, within the error bound (max |err| "
            f"{exact_err:.6g} against the float64 sum)")
        del x, out, want
        torch.cuda.empty_cache()

    # The unforced route: the gate picks quant_ring at 1 GiB per rank.
    x = random_rank_major((N, GIB // 4), torch.float32, gen)
    sum_ = tuned.op_lookup("sum")
    config.VARS.set("coll_quant_enable", True)
    if tuned.decide_allreduce(sum_, GIB, N, dtype=x.dtype) != "quant_ring":
        raise AssertionError("coll_quant_enable: the gate did not pick "
                             "quant_ring")
    picks = SPC.read("coll_allreduce_algo_quant_ring")
    wire0 = SPC.read("coll_quant_bytes_on_wire")
    t0 = time.time()
    out = tcomm.allreduce(x, "sum")
    torch.cuda.synchronize()
    dt = time.time() - t0
    if SPC.read("coll_allreduce_algo_quant_ring") != picks + 1:
        raise AssertionError("unforced allreduce did not run quant_ring")
    ratio = SPC.read("coll_quant_compression_ratio")
    if ratio != quant.compression_ratio():
        raise AssertionError(f"SPC compression ratio {ratio}")
    wire = SPC.read("coll_quant_bytes_on_wire") - wire0
    if wire != quant.wire_bytes(GIB, 4):
        raise AssertionError(f"SPC bytes on wire {wire}")
    exact_err = check_quant_bound(out, x, "unforced quant_ring")
    log(f"[main] TunedColl unforced, coll_quant_enable=true, {GIB} B/rank: "
        f"quant_ring, {dt * 1e3:.3f} ms host wall (first call), "
        f"{wire} B on the wire, ratio {ratio:.4f}, within the error bound "
        f"(max |err| {exact_err:.6g})")
    del out
    torch.cuda.empty_cache()
    # The route a user gets, timed against the route the same call takes
    # with the quantized wire off.
    QUANT_ROUTE["quant_ring_ms"] = p50_ms(
        lambda: tcomm.allreduce(x, "sum"), QUANT_ROUTE_REPS)
    config.VARS.set("coll_quant_enable", False)
    QUANT_ROUTE["exact_route"] = tuned.decide_allreduce(
        sum_, GIB, N, dtype=x.dtype)
    QUANT_ROUTE["exact_route_ms"] = p50_ms(
        lambda: tcomm.allreduce(x, "sum"), QUANT_ROUTE_REPS)
    config.VARS.set("coll_quant_enable", True)
    torch.cuda.empty_cache()
    picks = SPC.read("coll_allreduce_algo_quant_ring")
    log(f"[main] TunedColl {GIB} B/rank p50: quant_ring "
        f"{QUANT_ROUTE['quant_ring_ms']:.4f} ms, with coll_quant_enable "
        f"off {QUANT_ROUTE['exact_route']} "
        f"{QUANT_ROUTE['exact_route_ms']:.4f} ms")

    def native(op):
        config.VARS.set(force, "native")
        got = tcomm.allreduce(x, op)
        config.VARS.set(force, "")
        return got

    # MAX is refused by the gate and stays exact.
    got = tcomm.allreduce(x, "max")
    if SPC.read("coll_allreduce_algo_quant_ring") != picks:
        raise AssertionError("MAX went over the quantized wire")
    equal_or_raise(got, native("max"), "MAX under coll_quant_enable")
    del got
    torch.cuda.empty_cache()
    log("[main] TunedColl MAX under coll_quant_enable: bitwise native")

    # A rules file's veto brings the exact tier back.
    rules = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_archive", "quant_veto_rules.json")
    os.makedirs(os.path.dirname(rules), exist_ok=True)
    with open(rules, "w") as f:
        json.dump({"allreduce": [{"allow_quant": False}]}, f)
    config.VARS.set("coll_tuned_rules_file", rules)
    algo = tuned.decide_allreduce(sum_, GIB, N, dtype=x.dtype)
    got = tcomm.allreduce(x, "sum")
    config.VARS.set("coll_tuned_rules_file", "")
    if algo != "native" or SPC.read("coll_allreduce_algo_quant_ring") \
            != picks:
        raise AssertionError(f"the rules veto gave {algo}")
    equal_or_raise(got, native("sum"), "SUM under the rules veto")
    config.VARS.set("coll_quant_enable", False)
    del x, got
    torch.cuda.empty_cache()
    log("[main] TunedColl SUM with a rules file allow_quant=false: native, "
        "bitwise")

    # The schedule compiler's quantized-wire program.
    x = random_rank_major((N, MIB // 4), torch.float32, gen)
    config.VARS.set(force, "sched_quant")
    out = tcomm.allreduce(x, "sum")
    config.VARS.set(force, "")
    exact_err = check_quant_bound(out, x, "sched_quant")
    equal_or_raise(out, quant.allreduce_quant_ring(x, "sum"),
                   "sched_quant vs allreduce_quant_ring")
    log(f"[main] TunedColl[sched_quant] {MIB} B/rank: bitwise "
        f"allreduce_quant_ring, within the error bound (max |err| "
        f"{exact_err:.6g})")
    config.VARS.set("coll_sched_cache_enable", True)
    return errs


def attn_inputs(dtype: str, gen, n: int = 0, dh: int = 0):
    """Rank-major (n, T, H, dh) q, k, v from the seeded generator (n = N
    and dh = ATTN_HEAD_DIM unless given)."""
    import torch

    n, dh = n or N, dh or ATTN_HEAD_DIM
    return tuple(random_rank_major((n, ATTN_T, ATTN_HEADS, dh),
                                   getattr(torch, dtype), gen)
                 for _ in range(3))


def full_attention(q, k, v, causal: bool):
    """Softmax attention over the gathered (S, H, Dh) sequence in f32,
    one head at a time: the independent check of the ring."""
    import torch

    n, t, h, dh = q.shape
    s = n * t
    qs, ks, vs = (x.reshape(s, h, dh).float() for x in (q, k, v))
    out = torch.empty((s, h, dh), dtype=torch.float32, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    for head in range(h):
        scores = (qs[:, head] @ ks[:, head].T) / dh ** 0.5
        if causal:
            scores = scores.masked_fill(~mask, float("-inf"))
        out[:, head] = torch.softmax(scores, -1) @ vs[:, head]
    return out.reshape(n, t, h, dh)


def excess(got, want, limit):
    """(max |got - want|, max |got - want| / limit): ``limit`` is an
    (atol, rtol) pair, numpy's assert_allclose rule (atol + rtol |want|),
    or a tensor of limits."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if isinstance(limit, tuple):
        limit = limit[0] + limit[1] * want.abs()
    return float(err.max()), float((err / limit).max())


def within(got, want, limit, what: str):
    """``excess(got, want, limit)``, after checking |got - want| <= limit
    everywhere."""
    err, ratio = excess(got, want, limit)
    if ratio > 1.0:
        raise AssertionError(f"{what}: max err {err}, {ratio:.3g} times "
                             f"its limit")
    return err, ratio


def rounded_control(q, k, v, causal: bool, where: str):
    """The JAX kernel's fold, rank block by rank block over the gathered
    sequence, in float32 with one rounding to bfloat16 added: of p
    before p @ V (``where="p"``), or of the output accumulator after
    every block (``where="o"``). The bfloat16 tolerance must refuse
    both, or it could not tell a kernel that did either."""
    import torch

    n, t, h, dh = q.shape
    s = n * t
    qs, ks, vs = (x.reshape(s, h, dh).float() for x in (q, k, v))
    pos = torch.arange(s, device=q.device)
    out = torch.empty((s, h, dh), dtype=torch.float32, device=q.device)
    for head in range(h):
        m = torch.full((s,), -1e30, device=q.device)
        l = torch.zeros(s, device=q.device)
        o = torch.zeros((s, dh), device=q.device)
        for src in range(n):
            keys = slice(src * t, (src + 1) * t)
            scores = (qs[:, head] @ ks[keys, head].T) / dh ** 0.5
            if causal:
                scores = scores.masked_fill(
                    pos[:, None] < pos[None, keys], -1e30)
            m_new = torch.maximum(m, scores.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(scores - m_new[:, None])
            l = l * corr + p.sum(-1)
            if where == "p":
                p = p.bfloat16().float()
            o = o * corr[:, None] + p @ vs[keys, head]
            if where == "o":
                o = o.bfloat16().float()
            m = m_new
        out[:, head] = o / l.clamp(min=1e-30)[:, None]
    return out.reshape(n, t, h, dh).to(q.dtype)


def xla_reference(q, k, v, causal: bool):
    """The xla path's arithmetic without its ring: the JAX package's xla
    path takes its scores from an einsum in the input dtype, so they
    round to bfloat16 and no float32 oracle comes within an ulp of it
    at S = 4096. Here every ring step's scores come from that einsum on
    the same shapes (rank-major q against k rolled by the step), times
    1/sqrt(Dh) computed in the input dtype; then one float32 softmax
    over all n T keys on global positions and p @ V in float32, with no
    online fold and no ring shift. The xla path must come within one
    output ulp of it (ATTN_TOL)."""
    import torch

    n, t, h, dh = q.shape
    scale = 1.0 / torch.sqrt(torch.tensor(dh, dtype=q.dtype,
                                          device=q.device))
    steps = [torch.einsum("nqhd,nkhd->nhqk", q, torch.roll(k, step, 0))
             .float() * scale for step in range(n)]
    pos = torch.arange(n * t, device=q.device)
    vs = v.reshape(n * t, h, dh).float().transpose(0, 1)  # (H, S, Dh)
    out = torch.empty((n, h, t, dh), dtype=torch.float32, device=q.device)
    for me in range(n):
        # step s of rank me holds the keys of rank (me - s) mod n
        scores = torch.cat([steps[(me - src) % n][me] for src in range(n)],
                           -1)  # (H, T, S)
        if causal:
            mask = pos[me * t:(me + 1) * t, None] >= pos[None, :]
            scores = torch.where(mask, scores, -1e30)
        out[me] = torch.softmax(scores, -1) @ vs
    return out.transpose(1, 2).to(q.dtype)


def hop_kernel_vs_plain(gen) -> float:
    """ppermute_shift bitwise against its plain version and torch.roll in
    both forms: a cluster's barrier (n = 2, 3, 8) with bulk copies, as
    the plan takes it for rows of whole 16-byte vectors, and with the
    threads' copy; flags (forced at n = 3, 8; the plan's at n = 12).
    float32, bfloat16 and int8 (13 values a rank: the threads' copy in
    element units), the slice's 8 MiB KV block and 4 KiB per rank, every
    shift, every flag back at 0. Returns the max error."""
    import torch
    from ompi_tpu_torch.coll import pallas_ring as pr
    from ompi_tpu_torch.core.counters import KERNELS

    t0 = time.time()
    checked = 0
    hop_err = 0.0
    shapes = [((n, 13), dtype) for n in (2, 3, 8, 12)
              for dtype in (torch.float32, torch.bfloat16, torch.int8)]
    shapes += [((N, 2 * ATTN_T, ATTN_HEADS, ATTN_HEAD_DIM), torch.bfloat16),
               ((N, 4 * KIB // 2), torch.bfloat16),
               ((3, 4 * KIB // 4), torch.float32)]
    for shape, dtype in shapes:
        x = random_rank_major(shape, torch.int32, gen).to(dtype) \
            if dtype == torch.int8 else random_rank_major(shape, dtype, gen)
        n = shape[0]
        flat = x.reshape(n, -1)
        forms = [(None, None)]  # the plan's
        if n <= 8:
            forms += [(True, 0), (False, None)]
        for shift in HOP_SHIFTS:
            want = pr.ppermute_shift_plain(x, shift)
            for cluster, piece in forms:
                got = pr._hop_launch(flat, shift % n, cluster,
                                     piece=piece).reshape(x.shape)
                torch.cuda.synchronize()
                check_sems(KERNELS["ppermute_shift"])
                plan = KERNELS["ppermute_shift"].last_plan
                what = f"ppermute_shift {tuple(shape)} {dtype} shift={shift}"
                hop_err = max(hop_err, equal_or_raise(got, want,
                                                      f"{what} {plan}"))
                equal_or_raise(got, torch.roll(x, shift, 0), f"{what} roll")
                checked += 1
            got = pr.ppermute_shift(x, shift)  # the entry point
            torch.cuda.synchronize()
            equal_or_raise(got, want, f"ppermute_shift {tuple(shape)}")
    log(f"[kernel-vs-plain] ppermute_shift: {checked} cases bitwise equal "
        f"in both forms, all semaphores 0 ({time.time() - t0:.1f} s)")
    return hop_err


def attn_kernel_vs_plain(gen) -> dict:
    """ring_attention against its plain version and against full
    attention, to the JAX package's tolerances, and bitwise equal to
    itself over 20 launches at n = 8 and n = 3. Every flag back at 0
    after every launch. Returns kernel -> max error against the plain
    version."""
    import torch
    from ompi_tpu_torch.coll import pallas_attn as pa
    from ompi_tpu_torch.core.counters import KERNELS

    attn_err = 0.0
    for dtype, causal in ATTN_CASES:
        t0 = time.time()
        q, k, v = attn_inputs(dtype, gen)
        got = pa.ring_attention_block(q, k, v, causal)
        torch.cuda.synchronize()
        check_sems(KERNELS["ring_attention"])
        what = f"ring_attention {dtype} causal={causal}"
        if got.shape != q.shape or got.dtype != q.dtype \
                or not bool(got.isfinite().all()):
            raise AssertionError(f"{what}: bad output")
        tol = ATTN_TOL[dtype]
        plain = pa.ring_attention_block_plain(q, k, v, causal)
        err, err_ratio = within(got, plain, tol, f"{what} vs plain")
        full, full_ratio = within(got, full_attention(q, k, v, causal), tol,
                                  f"{what} vs full attention")
        attn_err = max(attn_err, err)
        ATTN_OUT[dtype, causal] = (q, k, v, got)
        controls = ""
        if dtype == "bfloat16":
            ratios = []
            for where in ("p", "o"):
                control = rounded_control(q, k, v, causal, where)
                ratios.append(excess(control, plain, tol)[1])
                if ratios[-1] <= 1.0:
                    raise AssertionError(
                        f"{what}: a fold that rounds {where} to bfloat16 "
                        f"passes the tolerance against plain")
            controls = (f"; controls rounding p / o to bfloat16 "
                        f"{ratios[0]:.3g} / {ratios[1]:.3g} times the "
                        f"limit, refused")
        log(f"[kernel-vs-plain] {what}: max err {err:.3g} vs plain, "
            f"{full:.3g} vs full attention ({err_ratio:.3g}, "
            f"{full_ratio:.3g} of the limit at atol, rtol {tol})"
            f"{controls} ({time.time() - t0:.1f} s)")

    for n in (N, 3):
        for dtype in ("bfloat16", "float32"):
            t0 = time.time()
            q, k, v = attn_inputs(dtype, gen, n=n)
            first = None
            for _ in range(RACE_LAUNCHES):
                got = pa.ring_attention_block(q, k, v, True)
                torch.cuda.synchronize()
                check_sems(KERNELS["ring_attention"])
                if first is None:
                    first = got
                elif not torch.equal(bits(got), bits(first)):
                    raise AssertionError(f"ring_attention n={n} {dtype}: "
                                         f"launches disagree")
            log(f"[races] ring_attention n={n} {dtype} causal: "
                f"{RACE_LAUNCHES} launches bitwise equal, all semaphores 0 "
                f"({time.time() - t0:.1f} s)")
    return {"ring_attention": attn_err}


def attention_path(config, counters, gen) -> dict:
    """``sp.ring_attention(q, k, v, impl="pallas")`` on the card at the
    slice's widths, bfloat16 and float32, causal and not: one kernel
    launch per call, the bits of the kernel's checks; ``impl="xla"`` and
    a shape the gate refuses launch nothing and agree to tolerance."""
    import torch
    from ompi_tpu_torch.coll import pallas_attn as pa
    from ompi_tpu_torch.parallel import sp

    errs = {}
    for dtype, causal in ATTN_CASES:
        q, k, v, want = ATTN_OUT[dtype, causal]
        before = pa.ATTN.launches
        got = sp.ring_attention(q, k, v, causal=causal, impl="pallas")
        torch.cuda.synchronize()
        if pa.ATTN.launches != before + 1:
            raise AssertionError("sp.ring_attention(impl='pallas') did not "
                                 "launch the kernel exactly once")
        check_sems(pa.ATTN)
        equal_or_raise(got, want, f"sp.ring_attention {dtype} {causal}")
        xla = sp.ring_attention(q, k, v, causal=causal, impl="xla")
        torch.cuda.synchronize()
        if pa.ATTN.launches != before + 1:
            raise AssertionError("impl='xla' launched the kernel")
        xla_err, xla_ratio = within(xla, xla_reference(q, k, v, causal),
                                    ATTN_TOL[dtype],
                                    f"xla path {dtype} {causal}")
        errs[dtype, causal] = float((got.float() - xla.float()).abs().max())
        log(f"[main] sp.ring_attention {dtype} causal={causal}: one launch, "
            f"bitwise the checked kernel; the xla path {xla_err:.3g} from "
            f"its arithmetic without the ring ({xla_ratio:.3g} of the "
            f"limit at atol, rtol {ATTN_TOL[dtype]}), max |pallas - xla| "
            f"{errs[dtype, causal]:.3g}")
    # Dh % 8 != 0: the gate refuses it and the xla path answers
    q, k, v = attn_inputs("bfloat16", gen, dh=ATTN_HEAD_DIM + 4)
    if pa.supported(q):
        raise AssertionError("the gate took Dh = 132")
    before = pa.ATTN.launches
    got = sp.ring_attention(q, k, v, impl="pallas")
    torch.cuda.synchronize()
    if pa.ATTN.launches != before:
        raise AssertionError("a refused shape reached the kernel")
    equal_or_raise(got, sp.ring_attention(q, k, v, impl="xla"),
                   "refused shape vs xla")
    within(got, xla_reference(q, k, v, True), ATTN_TOL["bfloat16"],
           "refused shape vs the xla path's arithmetic")
    log("[main] Dh = 132 (refused by the gate): the xla path, no launch, "
        "within an ulp of its arithmetic without the ring")
    return {}


def hop_path(counters, gen) -> dict:
    """The ring hop through its entry point ``ppermute_shift`` on the
    slice's KV block (8 MiB per rank, bfloat16) and at 4 KiB per rank,
    every shift, bitwise ``torch.roll``. The JAX package calls its
    ppermute_shift only from tests; ring attention's hop is fused into
    its own kernel, so this phase is the kernel's only main-path use."""
    import torch
    from ompi_tpu_torch.coll import pallas_ring as pr

    for nbytes in (HOP_BYTES, 4 * KIB):
        x = random_rank_major((N, nbytes // 2), torch.bfloat16, gen)
        for shift in HOP_SHIFTS:
            got = pr.ppermute_shift(x, shift)
            torch.cuda.synchronize()
            check_sems(pr.PPERMUTE)
            equal_or_raise(got, torch.roll(x, shift, 0),
                           f"ppermute_shift {nbytes} B shift={shift}")
    log(f"[main] ppermute_shift at {HOP_BYTES} and {4 * KIB} B per rank, "
        f"shifts {HOP_SHIFTS}: bitwise torch.roll")
    return {}


# The surface path: each PallasColl operation's kernel at 1 MiB per rank
# (1 MiB sent for the alltoall and the reduce-scatter).
PCOMM_KERNELS = {
    "allreduce": "ring_allreduce", "bcast": "tree_bcast",
    "reduce": "tree_reduce", "allgather": "ring_allgather",
    "reduce_scatter_block": "ring_reduce_scatter",
    "alltoall": "ring_alltoall", "gather": "linear_gather",
    "scatter": "linear_scatter",
}
SURFACE_KERNELS = tuple(PCOMM_KERNELS.values()) + ("ring_allreduce_chunked",)
PREFIX_ALGOS = ("native", "recursive_doubling", "linear_chain", "")
PREFIX_SIZES = (MIB, 4004)  # bytes per rank: 1 MiB, then ragged
SCAN_TEMP_LIMIT = 40e9  # bytes of temporaries of the 1 GiB scan
IMB_SHORT = (4, 4 * MIB, 3)  # min bytes, max bytes, iterations
PERSIST_TIMED = 10  # timed 1 GiB allreduces each, blocking and persistent


def surface_inputs(opname, gen):
    """(input, extra args) of one collective at 1 MiB per rank on the
    card (1 MiB sent for the alltoall and the reduce-scatter)."""
    import torch

    row = MIB // 4
    shape = (N, N, row // N) if opname in ("alltoall",
                                           "reduce_scatter_block") \
        else (N, row)
    x = random_rank_major(shape, torch.float32, gen)
    args = {"allreduce": ("sum",), "bcast": (BCAST_ROOT,),
            "reduce": ("max", REDUCE_ROOT), "allgather": (),
            "reduce_scatter_block": ("sum",), "alltoall": (),
            "gather": (GATHER_ROOT,), "scatter": (SCATTER_ROOT,)}[opname]
    return x, args


def ragged_inputs(gen):
    """Ragged blocks of the v-variants, as CUDA tensors: per-rank rows of
    ``(r * 2 + 1) % 4`` (some empty), ``blocks[s][d]`` of ``(s + d) % 3``
    rows, an int32 reduce-scatter over counts ``(r + 1) % 3``."""
    import torch

    cols = 1000
    vals = [random_rank_major(((r * 2 + 1) % 4 * 64, cols), torch.float32,
                              gen) for r in range(N)]
    blocks = [[random_rank_major(((s + d) % 3 * 32, cols), torch.float32,
                                 gen) for d in range(N)] for s in range(N)]
    wblocks = [[random_rank_major((1, s + 1), torch.int32 if (s + d) % 2
                                  else torch.float32, gen)
                for d in range(N)] for s in range(N)]
    counts = [(r + 1) % 3 * 50 for r in range(N)]
    rs_vals = [random_rank_major((sum(counts), cols), torch.int32, gen)
               for _ in range(N)]
    return vals, blocks, wblocks, counts, rs_vals


def same(got, want, what: str) -> None:
    """got equals want exactly: tensors bit for bit, lists and dicts leaf
    by leaf; raises otherwise."""
    import torch

    if isinstance(want, dict):
        if sorted(got) != sorted(want):
            raise AssertionError(f"{what}: keys {sorted(got)}")
        for k in want:
            same(got[k], want[k], f"{what}[{k}]")
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"{what}: {len(got)} != {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{what}[{i}]")
    elif want is None:
        if got is not None:
            raise AssertionError(f"{what}: not None")
    else:
        g = got.cpu() if got.is_cuda else got
        w = want.cpu() if want.is_cuda else want
        if g.shape != w.shape or g.dtype != w.dtype or \
                not torch.equal(bits(g), bits(w)):
            raise AssertionError(f"{what}: differs (max err "
                                 f"{max_abs_err(g.float(), w.float())})")


def prefix_checks(comm, route, tuned, config, gen) -> int:
    """Scan and exscan through ``comm``: every algorithm forced and the
    default decision, sum/prod/max/min, float32/bfloat16/int32, at 1 MiB
    and a ragged size per rank, each bitwise the same spmd function run
    on a CPU copy of the input. Returns the number of cases."""
    import torch

    cases = 0
    for which in ("scan", "exscan"):
        algos = tuned.SCAN_ALGOS if which == "scan" else tuned.EXSCAN_ALGOS
        decide = tuned.decide_scan if which == "scan" else \
            tuned.decide_exscan
        var = f"coll_tuned_{which}_algorithm"
        for algo in PREFIX_ALGOS:
            config.VARS.set(var, algo)
            for dtype in (torch.float32, torch.bfloat16, torch.int32):
                for nbytes in PREFIX_SIZES:
                    x = random_rank_major((N, nbytes // 4), dtype, gen)
                    xc = x.cpu()
                    for op in ("sum", "prod", "max", "min"):
                        out = getattr(comm, which)(x, op)
                        name = decide(tuned.op_lookup(op),
                                      nbytes // 4 * x.element_size(), N)
                        want = algos[name](xc, tuned.op_lookup(op))
                        same(out, want, f"{route} {which}[{algo or 'default'}"
                             f"->{name}] {op} {dtype} {nbytes} B/rank")
                        cases += 1
            config.VARS.set(var, "")
    return cases


def ragged_checks(comm, route, ttopo, gen) -> None:
    """The v-variants, reduce_scatter and the neighbor collectives
    through ``comm``, each equal to a numpy oracle."""
    import numpy as np
    import torch

    vals, blocks, wblocks, counts, rs_vals = ragged_inputs(gen)
    hv = [v.cpu().numpy() for v in vals]
    cat = np.concatenate(hv, 0)
    same(comm.allgatherv(vals), torch.from_numpy(cat), f"{route} allgatherv")
    same(comm.gatherv(vals, root=N - 1), torch.from_numpy(cat),
         f"{route} gatherv")
    same(comm.scatterv(vals, root=0), [torch.from_numpy(v) for v in hv],
         f"{route} scatterv")
    hb = [[b.cpu().numpy() for b in row] for row in blocks]
    same(comm.alltoallv(blocks),
         [torch.from_numpy(np.concatenate([hb[s][d] for s in range(N)], 0))
          for d in range(N)], f"{route} alltoallv")
    same(comm.alltoallw(wblocks),
         [[wblocks[s][d] for s in range(N)] for d in range(N)],
         f"{route} alltoallw")
    hr = np.stack([v.cpu().numpy() for v in rs_vals]).sum(0, dtype=np.int32)
    starts = np.cumsum([0] + counts)
    same(comm.reduce_scatter(rs_vals, counts, "sum"),
         [torch.from_numpy(hr[starts[r]:starts[r + 1]]) for r in range(N)],
         f"{route} reduce_scatter")
    # neighbors: a periodic 2 x 4 cart, and a periodic ring of two ranks
    # (each lists the other twice: duplicate edges, paired in order)
    two = comm.split([0, 0] + [-1] * (N - 2))[0]
    for cart in (ttopo.cart_create(comm, [2, 4], [True, True]),
                 ttopo.cart_create(two, [2], [True])):
        n = cart.size
        x = random_rank_major((n, 4096), torch.float32, gen)
        hx = x.cpu().numpy()
        nb = [cart.topo.neighbors(r) for r in range(n)]
        same(cart.neighbor_allgather(x),
             {r: torch.from_numpy(hx[nb[r]]) for r in range(n)},
             f"{route} neighbor_allgather {cart.topo.dims}")
        send = {r: random_rank_major((len(nb[r]), 512), torch.float32, gen)
                for r in range(n)}
        want = {}
        for r in range(n):
            got, used = [], {}
            for src in nb[r]:
                # the k-th time r lists src pairs with the k-th time src
                # lists r among its out-neighbors
                k = used.get(src, 0)
                used[src] = k + 1
                pos = [j for j, d in enumerate(nb[src]) if d == r][k]
                got.append(send[src][pos].cpu().numpy())
            want[r] = torch.from_numpy(np.stack(got))
        same(cart.neighbor_alltoall(send), want,
             f"{route} neighbor_alltoall {cart.topo.dims}")
    log(f"[main] {route}: allgatherv, gatherv, scatterv, alltoallv, "
        f"alltoallw, reduce_scatter and the neighbor collectives on a "
        f"periodic 2 x 4 cart and a periodic ring of 2 equal to numpy")


def event_ms(calls: dict, reps: int) -> dict:
    """name -> CUDA-event times (ms) of ``reps`` calls of each, taken in
    turns."""
    import torch

    ms = {name: [] for name in calls}
    for _ in range(reps):
        for name, call in calls.items():
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            call()
            e1.record()
            e1.synchronize()
            ms[name].append(e0.elapsed_time(e1))
    return ms


def persistent_checks(pcomm, tcomm, counters, gen) -> None:
    """Every collective ``*_init`` at 1 MiB per rank on PallasColl,
    started twice: bitwise the blocking call, each started kernel's
    launches +1 per start and no other kernel's; then barrier and
    barrier_init on both routes."""
    import torch
    from ompi_tpu_torch.topo import topology as ttopo

    def one_start(preq, kernel, what):
        before = counters.launches()
        preq.start()
        # Inputs on the card: the request completes on its CUDA event.
        if preq._event is None:
            raise AssertionError(f"{what}: no completion event")
        preq.wait()
        after = counters.launches()
        grew = {k: after[k] - before.get(k, 0) for k in after
                if after[k] != before.get(k, 0)}
        if grew != ({kernel: 1} if kernel else {}):
            raise AssertionError(f"{what}: launches grew by {grew}")
        return preq.result()

    for opname, kernel in PCOMM_KERNELS.items():
        x, args = surface_inputs(opname, gen)
        preq = getattr(pcomm, f"{opname}_init")(x, *args)
        for start in range(2):
            if start:
                x, _ = surface_inputs(opname, gen)
                preq.bind(x)
            got = one_start(preq, kernel, f"PallasColl {opname}_init")
            same(got, getattr(pcomm, opname)(x, *args),
                 f"PallasColl {opname}_init start {start}")
        log(f"[main] PallasColl {opname}_init at {MIB} B/rank: two starts, "
            f"{kernel} +1 launch each, bitwise the blocking call")
        del x, preq, got
    vals, blocks, wblocks, counts, rs_vals = ragged_inputs(gen)
    cart = ttopo.cart_create(pcomm, [2, 4], [True, True])
    cx, _ = surface_inputs("allreduce", gen)
    sendb = {r: random_rank_major((4, 512), torch.float32, gen)
             for r in range(N)}
    kernelless = {
        "scan": (pcomm, cx, ("sum",)), "exscan": (pcomm, cx, ("prod",)),
        "allgatherv": (pcomm, vals, ()), "gatherv": (pcomm, vals, (2,)),
        "scatterv": (pcomm, vals, (1,)), "alltoallv": (pcomm, blocks, ()),
        "alltoallw": (pcomm, wblocks, ()),
        "reduce_scatter": (pcomm, rs_vals, (counts, "sum")),
        "neighbor_allgather": (cart, cx, ()),
        "neighbor_alltoall": (cart, sendb, ()),
    }
    for opname, (comm, x, args) in kernelless.items():
        preq = getattr(comm, f"{opname}_init")(x, *args)
        for start in range(2):
            got = one_start(preq, None, f"PallasColl {opname}_init")
            same(got, getattr(comm, opname)(x, *args),
                 f"PallasColl {opname}_init start {start}")
    log(f"[main] PallasColl {', '.join(kernelless)} _init: two starts "
        f"each, no kernel launched, bitwise the blocking call")
    for comm, route in ((pcomm, "PallasColl"), (tcomm, "TunedColl")):
        before = counters.launches()
        comm.barrier()
        preq = comm.barrier_init()
        for _ in range(2):
            preq.start()
            if preq._event is None:
                raise AssertionError(f"{route} barrier_init: no event")
            preq.wait()
        if counters.launches() != before or not preq.done:
            raise AssertionError(f"{route} barrier: launched a kernel")
        log(f"[main] {route} barrier and barrier_init (two starts): "
            f"completed on their CUDA events")


def persistent_gib(pcomm, counters, gen) -> None:
    """The persistent allreduce at 1 GiB per rank on PallasColl (the
    chunked ring): started twice, rebound once and started again, each
    result bitwise the blocking call, ``ring_allreduce_chunked`` +1 per
    start; the second start waited for with a timeout. Then a start and
    wait timed beside the blocking call by CUDA events, alternating,
    ``PERSIST_TIMED`` times each (each drops its result, so its memory
    is reused)."""
    import torch

    kernel = counters.KERNELS["ring_allreduce_chunked"]
    x = random_rank_major((N, GIB // 4), torch.float32, gen)
    want = pcomm.allreduce(x, "sum")
    preq = pcomm.allreduce_init(x, "sum")
    times = []
    for start in range(3):
        if start == 2:
            del want
            y = random_rank_major((N, GIB // 4), torch.float32, gen)
            preq.bind(y)
            del x
            x = y
            del y
        before = kernel.launches
        t0 = time.time()
        preq.start()
        if start == 1:
            preq.wait(timeout=60)
        else:
            preq.wait()
        times.append((time.time() - t0) * 1e3)
        if preq._event is None:
            raise AssertionError(f"persistent 1 GiB start {start}: no "
                                 f"completion event")
        check_sems(kernel)
        if kernel.launches != before + 1:
            raise AssertionError(f"persistent 1 GiB start {start}: "
                                 f"{kernel.launches - before} launches")
        if start == 2:
            want = pcomm.allreduce(x, "sum")
        if not torch.equal(bits(preq.result()), bits(want)):
            raise AssertionError(f"persistent 1 GiB start {start}: not the "
                                 f"blocking call's bits")
    log(f"[main] PallasColl allreduce_init at {GIB} B/rank x {N} ranks: "
        f"three starts (rebound before the third; the second waited with "
        f"timeout=60), ring_allreduce_chunked +1 each, bitwise the "
        f"blocking call; {', '.join(f'{t:.3f}' for t in times)} ms host "
        f"wall per start and wait")
    del want
    ms = event_ms({"blocking": lambda: pcomm.allreduce(x, "sum"),
                   "persistent": lambda: preq.start().wait()}, PERSIST_TIMED)
    check_sems(kernel)
    log(f"[main] PallasColl allreduce at {GIB} B/rank x {N} ranks by CUDA "
        f"events, {PERSIST_TIMED} calls each: " + "; ".join(
            f"{name} p50 {statistics.median(v):.3f} ms, min {min(v):.3f}"
            for name, v in ms.items()))
    del x, preq
    torch.cuda.empty_cache()


def scan_gib(tcomm, tuned, gen) -> None:
    """Scan and exscan at 1 GiB per rank through TunedColl (native),
    float32 SUM: column windows bitwise the same spmd function on the
    CPU, the whole within 1e-5 relative of a float64 cumsum, and the
    call's temporaries under ``SCAN_TEMP_LIMIT`` bytes."""
    import torch

    x = random_rank_major((N, GIB // 4), torch.float32, gen)
    for which in ("scan", "exscan"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out = getattr(tcomm, which)(x, "sum")
        torch.cuda.synchronize()
        dt = time.time() - t0
        temps = torch.cuda.max_memory_allocated() - base - out.numel() * 4
        if temps > SCAN_TEMP_LIMIT:
            raise AssertionError(f"{which} 1 GiB: {temps} B of temporaries")
        if tuned.decide_scan(tuned.op_lookup("sum"), GIB, N) != "native":
            raise AssertionError("the 1 GiB scan is not native")
        fn = tuned.SCAN_ALGOS["native"] if which == "scan" else \
            tuned.EXSCAN_ALGOS["native"]
        for lo in (0, GIB // 8 - 1000, GIB // 4 - 4096):
            cols = slice(lo, lo + 4096)
            same(out[:, cols], fn(x[:, cols].cpu(), tuned.op_lookup("sum")),
                 f"TunedColl {which} 1 GiB columns {lo}")
        worst = 0.0
        for lo in range(0, GIB // 4, 1 << 24):
            cols = slice(lo, lo + (1 << 24))
            ref = torch.cumsum(x[:, cols].double(), 0)
            if which == "exscan":
                ref = torch.cat([torch.zeros_like(ref[:1]), ref[:-1]])
            err = (out[:, cols].double() - ref).abs()
            scale = x[:, cols].double().abs().cumsum(0)
            worst = max(worst, float((err / scale.clamp_min(1e-30)).max()))
            del ref, err, scale
        if worst > 1e-5 or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{which} 1 GiB: error {worst}")
        log(f"[main] TunedColl {which} (native) at {GIB} B/rank x {N} "
            f"ranks: {dt * 1e3:.3f} ms host wall (first call), temporaries "
            f"{temps} B, columns bitwise the CPU, max error / sum|x| "
            f"{worst:.3g} against a float64 cumsum")
        del out
        torch.cuda.empty_cache()
    del x
    torch.cuda.empty_cache()


def surface_path(world, pcomm, tcomm, config, counters, gen) -> dict:
    """The rest of the collective surface on the card: scan and exscan,
    the ragged and neighbor collectives, every persistent form, barrier,
    the 1 GiB persistent allreduce, scan and exscan at 1 GiB, and a
    short IMB sweep on both routes. Raises on any disagreement; the
    kernels' errors are their checks' (returns no new ones)."""
    from ompi_tpu_torch.coll import tuned
    from ompi_tpu_torch.tools import imb
    from ompi_tpu_torch.topo import topology as ttopo

    for comm, route in ((pcomm, "PallasColl"), (tcomm, "TunedColl")):
        if comm._coll["scan"][0].NAME != "tuned":
            raise AssertionError(f"{route}: scan not through TunedColl")
        t0 = time.time()
        cases = prefix_checks(comm, route, tuned, config, gen)
        log(f"[main] {route} scan/exscan: {cases} cases (every algorithm "
            f"forced and by default, 4 ops, 3 dtypes, {PREFIX_SIZES} "
            f"B/rank), each bitwise the spmd function on a CPU copy, "
            f"{time.time() - t0:.1f} s")
        ragged_checks(comm, route, ttopo, gen)
    persistent_checks(pcomm, tcomm, counters, gen)
    persistent_gib(pcomm, counters, gen)
    scan_gib(tcomm, tuned, gen)
    lo, hi, iters = IMB_SHORT
    for comm, route in ((pcomm, "PallasColl"), (tcomm, "TunedColl")):
        t0 = time.time()
        rows = imb.sweep(comm, imb.OPS, lo, hi, iters)
        print(json.dumps({"imb_short": {
            "route": route, "iters": iters,
            "rows": [r.__dict__ for r in rows]}}), flush=True)
        log(f"[main] {route} IMB sweep {lo}-{hi} B, {iters} iterations, "
            f"{len(rows)} rows, {time.time() - t0:.1f} s")
    return {}


# The p2p/nonblocking path: the 15 i* forms at 1 MiB per rank on both
# routes, a 1 GiB iallreduce on PallasColl with host p2p posted while it
# runs, point-to-point at 4 KiB (eager) and 1 GiB (rendezvous) per
# message, and every nbc.i* at 64 MiB and 4 KiB per rank.
P2P_EAGER = 4 * KIB
P2P_RNDV = GIB
NBC_SIZES = (64 * MIB, 4 * KIB)
P2P_TIMED = 10  # timed calls each, alternating
# Reckoned before the run: the 1 GiB iallreduce holds its input, the
# blocking call's result and its own (3 x 8 GiB), the rest far less.
P2P_PEAK_RECKONED, P2P_PEAK_LIMIT = 26e9, 40e9
NBC_CASES = {  # nbc entry point -> (the blocking operation, its args)
    "ibcast": ("bcast", (BCAST_ROOT,)),
    "iallreduce": ("allreduce", ("sum",)),
    "ireduce": ("reduce", ("max", REDUCE_ROOT)),
    "iallgather": ("allgather", ()),
    "ialltoall": ("alltoall", ()),
    "igather": ("gather", (GATHER_ROOT,)),
    "iscatter": ("scatter", (SCATTER_ROOT,)),
    "ireduce_scatter_block": ("reduce_scatter_block", ("sum",)),
    "iscan": ("scan", ("max",)),
    "iexscan": ("exscan", ("sum",)),
    "ibarrier": ("barrier", ()),
}
SUM_RTOL = 1e-5  # tests/test_nbc.py's, of sum |x| per element


def own_storage(got, *others, what: str) -> None:
    ptr = got.untyped_storage().data_ptr()
    if any(ptr == o.untyped_storage().data_ptr() for o in others):
        raise AssertionError(f"{what}: shares storage with a sender")


def icoll_checks(pcomm, tcomm, counters, gen) -> None:
    """The 15 ``i*`` forms at 1 MiB per rank on both routes: each request
    holds a CUDA event after it starts, each result is bitwise the
    blocking call, and on PallasColl each kernel-backed form launches its
    kernel once and the others none."""
    import torch
    from ompi_tpu_torch.topo import topology as ttopo

    vals, blocks, _, counts, rs_vals = ragged_inputs(gen)
    for comm, route in ((pcomm, "PallasColl"), (tcomm, "TunedColl")):
        cart = ttopo.cart_create(comm, [2, 4], [True, True])
        cx, _ = surface_inputs("allreduce", gen)
        sendb = {r: random_rank_major((4, 512), torch.float32, gen)
                 for r in range(N)}
        cases = {op: surface_inputs(op, gen) + (comm,)
                 for op in PCOMM_KERNELS}
        cases.update({
            "scan": (cx, ("sum",), comm), "barrier": (None, (), comm),
            "allgatherv": (vals, (), comm), "alltoallv": (blocks, (), comm),
            "reduce_scatter": (rs_vals, (counts, "sum"), comm),
            "neighbor_allgather": (cx, (), cart),
            "neighbor_alltoall": (sendb, (), cart)})
        for opname, (x, args, c) in cases.items():
            call = () if x is None else (x,)
            before = counters.launches()
            req = getattr(c, f"i{opname}")(*call, *args)
            if req._event is None:
                raise AssertionError(f"{route} i{opname}: no CUDA event")
            got = req.result()
            after = counters.launches()
            grew = {k: after[k] - before.get(k, 0) for k in after
                    if after[k] != before.get(k, 0)}
            kernel = PCOMM_KERNELS.get(opname)
            if route == "PallasColl" and grew != ({kernel: 1} if kernel
                                                  else {}):
                raise AssertionError(f"{route} i{opname}: launches {grew}")
            if opname != "barrier":
                same(got, getattr(c, opname)(*call, *args),
                     f"{route} i{opname}")
        log(f"[main] {route} the 15 i* forms at {MIB} B/rank: each held a "
            f"CUDA event, bitwise the blocking call"
            + (", each kernel-backed form +1 launch of its kernel, the "
               "others none" if route == "PallasColl" else ""))
        del cases, cart


def iallreduce_gib(pcomm, tcomm, counters, gen) -> dict:
    """A 1 GiB-per-rank ``iallreduce`` on PallasColl (the chunked ring):
    while it runs the host posts eager sends and receives around a ring
    of ranks; then the iallreduce is bitwise the blocking call with one
    launch, and each message bitwise its CPU copy. Then ``P2P_TIMED``
    nonblocking calls (start and wait) and blocking calls by CUDA events,
    in turns."""
    import torch

    kernel = counters.KERNELS["ring_allreduce_chunked"]
    x = random_rank_major((N, GIB // 4), torch.float32, gen)
    want = pcomm.allreduce(x, "sum")
    msgs = [random_rank_major((P2P_EAGER // 4,), torch.float32, gen)
            for _ in range(N)]
    hmsgs = [m.to("cpu", copy=True) for m in msgs]
    torch.cuda.synchronize()
    before = kernel.launches
    req = pcomm.iallreduce(x, "sum")
    if req._event is None:
        raise AssertionError("iallreduce 1 GiB: no CUDA event")
    t0 = time.perf_counter()
    rreqs = [tcomm.rank((r + 1) % N).irecv(source=r, tag=21)
             for r in range(N)]
    sreqs = [tcomm.rank(r).isend(msgs[r], dest=(r + 1) % N, tag=21)
             for r in range(N)]
    posted_ms = (time.perf_counter() - t0) * 1e3
    running = not req._event.query()
    if not all(r.done for r in rreqs + sreqs):
        raise AssertionError("host p2p beside the iallreduce: unmatched")
    req.wait()
    if kernel.launches != before + 1:
        raise AssertionError(f"iallreduce 1 GiB: "
                             f"{kernel.launches - before} launches")
    check_sems(kernel)
    if not torch.equal(bits(req.result()), bits(want)):
        raise AssertionError("iallreduce 1 GiB: not the blocking call's "
                             "bits")
    for r, rr in enumerate(rreqs):
        same(rr.result(), hmsgs[r], f"eager message {r} beside the "
                                    f"iallreduce")
    log(f"[main] PallasColl iallreduce at {GIB} B/rank x {N} ranks: a CUDA "
        f"event, ring_allreduce_chunked +1, bitwise the blocking call; "
        f"{2 * N} eager p2p requests posted in {posted_ms:.3f} ms host "
        f"while it ran (still running after: {running}), every message "
        f"bitwise its CPU copy")
    del want, req
    ms = event_ms({"blocking": lambda: pcomm.allreduce(x, "sum"),
                   "nonblocking": lambda: pcomm.iallreduce(x, "sum").wait()},
                  P2P_TIMED)
    check_sems(kernel)
    out = {f"{k}_allreduce_gib_ms": statistics.median(v)
           for k, v in ms.items()}
    log(f"[main] PallasColl allreduce at {GIB} B/rank by CUDA events, "
        f"{P2P_TIMED} calls each in turns: " + "; ".join(
            f"{k} p50 {statistics.median(v):.3f} ms, min {min(v):.3f}"
            for k, v in ms.items()))
    del x
    torch.cuda.empty_cache()
    return out


def p2p_checks(tcomm, gen) -> dict:
    """Point-to-point on the card, n = 8: an eager ring at 4 KiB (each
    sender's buffer written once its send completed), self sends at 4 KiB
    and 1 GiB, ANY_SOURCE/ANY_TAG arrival order, improbe/mrecv,
    persistent send/recv started twice, a 1 GiB rendezvous (its buffer
    written after the match); every received tensor bitwise a CPU copy of
    what was sent and in storage of its own. Then the 1 GiB rendezvous
    by CUDA events beside ``x.clone()``, in turns."""
    import torch
    from ompi_tpu_torch.communicator import start_all
    from ompi_tpu_torch.core.counters import SPC

    eps = [tcomm.rank(r) for r in range(N)]
    row = P2P_EAGER // 4
    eager0 = SPC.read("pml_eager_sends")
    xs = [random_rank_major((row,), torch.float32, gen) for _ in range(N)]
    hx = [x.to("cpu", copy=True) for x in xs]
    sreqs = [eps[r].isend(xs[r], dest=(r + 1) % N, tag=1) for r in range(N)]
    if not all(s.done for s in sreqs):
        raise AssertionError("an eager send did not complete at once")
    for x in xs:
        x.mul_(-1.0).add_(7.0)  # MPI lets the sender reuse its buffer now
    for r in range(N):
        got = eps[(r + 1) % N].recv(source=r, tag=1)
        same(got, hx[r], f"eager {r}->{(r + 1) % N}")
        own_storage(got, *xs, what=f"eager {r}->{(r + 1) % N}")
    if SPC.read("pml_eager_sends") != eager0 + N:
        raise AssertionError("eager ring: pml_eager_sends")
    for nbytes in (P2P_EAGER, P2P_RNDV):
        x = random_rank_major((nbytes // 4,), torch.float32, gen)
        hxs = x.to("cpu", copy=True)
        if not eps[3].isend(x, dest=3, tag=2).done:
            raise AssertionError("self send not complete at once")
        x.zero_()
        got = eps[3].recv(source=3, tag=2)
        same(got, hxs, f"self send {nbytes} B")
        own_storage(got, x, what=f"self send {nbytes} B")
        del x, got, hxs
    order = ((1, 9), (2, 3), (6, 7))
    for src, tag in order:
        eps[src].isend(xs[src], dest=4, tag=tag)
    for src, tag in order:
        req = eps[4].irecv(source=-1, tag=-1)
        st = req.wait()
        if (st.source, st.tag, st.count) != (src, tag, P2P_EAGER):
            raise AssertionError(f"ANY_SOURCE/ANY_TAG: {st}")
        same(req.result(), xs[src], f"ANY_SOURCE from {src}")
    eps[2].isend(xs[2], dest=7, tag=11)
    msg = tcomm.improbe(source=-1, tag=-1, dest=7)
    if msg is None or msg.status.source != 2 or \
            tcomm.iprobe(source=-1, tag=-1, dest=7) is not None:
        raise AssertionError("improbe did not take the message")
    same(msg.mrecv(), xs[2], "improbe/mrecv")
    psend = tcomm.send_init(xs[1], dest=6, tag=5, source=1)
    precv = tcomm.recv_init(source=1, tag=5, dest=6)
    for start in range(2):
        if start:
            psend.bind(xs[5])
        start_all([precv, psend])
        psend.wait()
        same(precv.result(), xs[5 if start else 1], f"persistent {start}")
        own_storage(precv.result(), *xs, what=f"persistent {start}")
    log(f"[main] p2p on the card: an eager ring at {P2P_EAGER} B (senders' "
        f"buffers written after completion), self sends at {P2P_EAGER} and "
        f"{P2P_RNDV} B, ANY_SOURCE/ANY_TAG in arrival order, improbe/mrecv, "
        f"persistent send/recv started twice: each bitwise its CPU copy, "
        f"in storage of its own")
    rndv0 = SPC.read("pml_rndv_sends")
    big = random_rank_major((P2P_RNDV // 4,), torch.float32, gen)
    hbig = big.to("cpu", copy=True)
    sreq = eps[0].isend(big, dest=5, tag=3)
    if sreq.done or SPC.read("pml_rndv_sends") != rndv0 + 1:
        raise AssertionError("1 GiB send did not take the rendezvous")
    got = eps[5].recv(source=0, tag=3)
    if not sreq.done:
        raise AssertionError("rendezvous send not complete at the match")
    big.neg_()
    same(got, hbig, "rendezvous 1 GiB")
    own_storage(got, big, what="rendezvous 1 GiB")
    del got, hbig
    def rendezvous():
        eps[0].isend(big, dest=5, tag=4)
        return eps[5].recv(source=0, tag=4)

    ms = event_ms({"rendezvous": rendezvous, "clone": big.clone}, P2P_TIMED)
    bound = 2 * P2P_RNDV / HBM_BYTES_PER_S * 1e3
    out = {"rendezvous_gib_ms": statistics.median(ms["rendezvous"]),
           "clone_gib_ms": statistics.median(ms["clone"]),
           "rendezvous_gib_bound_ms": bound}
    log(f"[main] p2p rendezvous at {P2P_RNDV} B (isend, recv and its "
        f"event) by CUDA events, {P2P_TIMED} in turns with x.clone(): "
        + "; ".join(f"{k} p50 {statistics.median(v):.4f} ms, min "
                    f"{min(v):.4f}" for k, v in ms.items())
        + f"; bound 2 B / 3.35 TB/s {bound:.4f} ms")
    del big
    torch.cuda.empty_cache()
    return out


def nbc_input(entry, nbytes, gen):
    import torch

    row = nbytes // 4
    shape = (N, N, row // N) if entry in ("ialltoall",
                                          "ireduce_scatter_block") \
        else (N, row)
    return random_rank_major(shape, torch.float32, gen)


def nbc_vs_blocking(entry, got, want, x) -> None:
    """A SUM within ``SUM_RTOL`` of sum |x| per element of the blocking
    call (the algorithms differ); every other op bitwise."""
    import torch

    if NBC_CASES[entry][1][:1] != ("sum",):
        same(got, want, f"nbc {entry} vs blocking")
        return
    if got.shape != want.shape:
        raise AssertionError(f"nbc {entry}: shape {tuple(got.shape)}")
    err = (got.double() - want.double()).abs()
    mag = x.abs().double()
    if entry == "iexscan":  # rank r sums ranks 0..r-1
        mag = mag.cumsum(0)
        scale = torch.cat([torch.zeros_like(mag[:1]), mag[:-1]])
    else:  # each result sums one block of every rank
        scale = mag.sum(0).expand_as(err)
    if bool((err > SUM_RTOL * scale).any()):
        raise AssertionError(f"nbc {entry}: SUM beyond {SUM_RTOL} of sum|x|")


def nbc_checks(tcomm, gen) -> dict:
    """Every ``nbc.i*`` at 64 MiB and 4 KiB per rank on the card: bitwise
    the same schedule run on a CPU copy of the input and its own second
    run (the one timed, host wall from start to result), and against the
    blocking call through TunedColl (a SUM to ``SUM_RTOL``, every other
    op bitwise); then three schedules started together and completed
    out of order, each bitwise its run alone."""
    import torch
    from ompi_tpu_torch.communicator import Communicator
    from ompi_tpu_torch.coll import nbc
    from ompi_tpu_torch.group import Group
    from ompi_tpu_torch.runtime import mesh

    cpu = Communicator(Group(range(N)),
                       mesh.discover(N, torch.device("cpu")), name="CPU")
    wall = {}
    for nbytes in NBC_SIZES:
        for entry, (blocking, args) in NBC_CASES.items():
            x = None if entry == "ibarrier" else nbc_input(entry, nbytes,
                                                           gen)
            call = () if x is None else (x,)
            got = getattr(nbc, entry)(tcomm, *call, *args).result()
            # timed warm: the first call also loads the op's CUDA code
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = getattr(nbc, entry)(tcomm, *call, *args).result()
            wall[f"{entry}_{nbytes}"] = (time.perf_counter() - t0) * 1e3
            same(again, got, f"nbc {entry} {nbytes} B/rank run twice")
            ref = getattr(nbc, entry)(cpu, *(v.cpu() for v in call),
                                      *args).result()
            same(got, ref, f"nbc {entry} {nbytes} B/rank vs the CPU")
            if entry == "ibarrier":
                tcomm.barrier()
            else:
                nbc_vs_blocking(entry, got, getattr(tcomm, blocking)(
                    x, *args), x)
            del x, got, again, ref
        log(f"[main] nbc at {nbytes} B/rank: every entry point bitwise the "
            f"CPU schedule and its own second run, SUM within {SUM_RTOL} of "
            f"sum|x| of the blocking call and every other op bitwise; host "
            f"ms start to result of the second run: "
            + ", ".join(f"{e} {wall[f'{e}_{nbytes}']:.1f}"
                        for e in NBC_CASES))
    xs = [nbc_input("iallreduce", NBC_SIZES[0], gen) for _ in range(3)]
    alone = [nbc.iallreduce(tcomm, xs[0], "sum").result(),
             nbc.ibcast(tcomm, xs[1], 2).result(),
             nbc.iallgather(tcomm, xs[2]).result()]
    reqs = [nbc.iallreduce(tcomm, xs[0], "sum"),
            nbc.ibcast(tcomm, xs[1], 2), nbc.iallgather(tcomm, xs[2])]
    for i in (2, 0, 1):
        reqs[i].wait()
    for i, req in enumerate(reqs):
        same(req.result(), alone[i], f"nbc started together {i}")
    log(f"[main] nbc iallreduce, ibcast and iallgather at {NBC_SIZES[0]} "
        f"B/rank started together, completed out of order (2, 0, 1): each "
        f"bitwise its run alone")
    cpu.free()
    del xs, alone, reqs
    torch.cuda.empty_cache()
    return {"nbc_host_ms": wall}


def p2p_path(pcomm, tcomm, counters, gen) -> dict:
    """The p2p/nonblocking path; prints its times on a ``p2p_nbc`` JSON
    line and checks its peak memory. Raises on any disagreement; returns
    no kernel errors (the kernels' are their checks')."""
    import torch

    log(f"[main] p2p/nonblocking path: peak device memory reckoned "
        f"{P2P_PEAK_RECKONED:.0f} B (limit {P2P_PEAK_LIMIT:.0f})")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    icoll_checks(pcomm, tcomm, counters, gen)
    times = p2p_checks(tcomm, gen)  # also the p2p stack's first use
    times.update(iallreduce_gib(pcomm, tcomm, counters, gen))
    times.update(nbc_checks(tcomm, gen))
    peak = torch.cuda.max_memory_allocated()
    print(json.dumps({"p2p_nbc": times}), flush=True)
    log(f"[main] p2p/nonblocking path {time.time() - t0:.1f} s, peak "
        f"device memory {peak} B")
    if peak > P2P_PEAK_LIMIT:
        raise AssertionError(f"p2p path peak {peak} B")
    return {}


# The training-step path: one decoder layer of Llama-2-7B at full width
# (meta-llama/Llama-2-7b-hf: hidden 4096, intermediate 11008, 32 heads of
# 128), its nine gradient leaves in float32 from a seed; the depth is cut
# to one layer because every rank's copy lives in the one card's memory.
TRAIN_LAYER = {  # leaf -> per-rank shape, in the layer's forward order
    "input_layernorm": (4096,),
    "q_proj": (4096, 4096), "k_proj": (4096, 4096),
    "v_proj": (4096, 4096), "o_proj": (4096, 4096),
    "post_attention_layernorm": (4096,),
    "gate_proj": (11008, 4096), "up_proj": (11008, 4096),
    "down_proj": (4096, 11008),
}
TRAIN_ELEMS = 202_383_360  # elements per rank
TRAIN_BUCKETS = 194  # 4 MiB buckets (parallel_dp_bucket_bytes)
TRAIN_STEPS = 3
TRAIN_CHECKED_BUCKETS = (0, TRAIN_BUCKETS // 2, TRAIN_BUCKETS - 1)
TRAIN_PARTITIONS = 64
TRAIN_RAISED_BUCKET = 16 * MIB  # above PallasColl's 4 MiB whole-payload tier
# Peak device memory in units of G, the rank-major gradients' bytes: the
# window session holds the gradients (1), the staging slabs (1), each of
# its two phases' peers' wire buffers, received payloads and reduced
# locals (2 x (7/8 + 7/8 + 1/8)), the open step's float64 accumulators
# (2/8), the first step's outputs (1) and the second tail's broadcast
# output and reassembled buckets (2); the session and the bucketer less.
TRAIN_PEAK_G = 1 + 1 + 2 * (7 / 8 + 7 / 8 + 1 / 8) + 2 / 8 + 1 + 2
TRAIN_PEAK_LIMIT = 76e9
TRAIN_KERNELS = ("tree_bcast", "ring_allreduce", "ring_allreduce_chunked",
                 "sched_table")


def no_host_copies():
    """A context in which a copy of a CUDA tensor to the host raises:
    ``.cpu()``, ``.numpy()``, ``.tolist()``, ``.item()``, ``float()``,
    ``int()``, ``bool()``, ``np.asarray``, ``.to()`` a CPU target and
    ``copy_`` into a CPU tensor. The training step's data path stays on
    the card."""
    import contextlib

    import torch

    def cpu_target(args, kwargs) -> bool:
        for a in list(args) + [kwargs.get("device")]:
            if isinstance(a, torch.Tensor):
                return a.device.type == "cpu"
            if isinstance(a, (str, torch.device)):
                return torch.device(a).type == "cpu"
        return False

    def refuse_cuda(self, *args, **kwargs) -> bool:
        return self.is_cuda

    refused = {
        "cpu": refuse_cuda, "numpy": refuse_cuda, "tolist": refuse_cuda,
        "item": refuse_cuda, "__float__": refuse_cuda,
        "__int__": refuse_cuda, "__index__": refuse_cuda,
        "__bool__": refuse_cuda, "__array__": refuse_cuda,
        "to": lambda self, *a, **k: self.is_cuda and cpu_target(a, k),
        "copy_": lambda self, src, *a, **k: (
            self.device.type == "cpu" and isinstance(src, torch.Tensor)
            and src.is_cuda),
    }

    @contextlib.contextmanager
    def guard():
        saved = {m: getattr(torch.Tensor, m) for m in refused}

        def wrap(name):
            def call(self, *args, **kwargs):
                if refused[name](self, *args, **kwargs):
                    raise AssertionError(f"host copy {name} of a CUDA "
                                         f"tensor on the step's data path")
                return saved[name](self, *args, **kwargs)
            return call

        for name in saved:
            setattr(torch.Tensor, name, wrap(name))
        try:
            yield
        finally:
            for name, fn in saved.items():
                setattr(torch.Tensor, name, fn)

    return guard()


def close_to_sum(out: dict, grads: dict, rtol: float, atol: float,
                 what: str) -> float:
    """Every leaf of ``out`` (rank-major, on the card) within rtol/atol of
    its gradients' sum over the ranks, in every rank's row; returns the
    largest |error|."""
    import torch

    worst = 0.0
    for name, g in grads.items():
        got = out[name]
        if not got.is_cuda or got.shape != g.shape:
            raise AssertionError(f"{what} {name}: {got.device} "
                                 f"{tuple(got.shape)}")
        ref = g.sum(0)
        for r in range(g.shape[0]):
            err = (got[r] - ref).abs()
            bad = err > atol + rtol * ref.abs()
            if bool(bad.any()) or not bool(torch.isfinite(got[r]).all()):
                raise AssertionError(f"{what} {name} rank {r}: max error "
                                     f"{float(err.max())}")
            worst = max(worst, float(err.max()))
    return worst


def train_session(comm, grads, order, window: int, steps: int,
                  what: str) -> dict:
    """``steps`` training steps through a DP overlap session (window 1:
    ``DpOverlapSession``; window 2: ``dp.window_session``, then
    ``flush``), marks replayed in the captured backward order; checks
    every result and where the session's tensors live."""
    import torch
    from ompi_tpu_torch.parallel import dp, overlap as ovl

    t0 = time.time()
    sess = (ovl.DpOverlapSession(comm, grads) if window == 1
            else dp.window_session(comm, grads, window=window))
    build_ms = (time.time() - t0) * 1e3
    if len(sess.plan.buckets) != TRAIN_BUCKETS:
        raise AssertionError(f"{what}: {len(sess.plan.buckets)} buckets")
    bufs = sess.buffers()
    if not all(b.is_cuda for b in bufs):
        raise AssertionError(f"{what}: a stage or wire buffer off the card")
    got = {"build_ms": build_ms, "step_ms": [], "overlap_pct": [],
           "exposed_comm_ms": [], "tiles": sess.compiled.nodes[0].tiles,
           "tile_bytes": sess.compiled.nodes[0].tile_bytes,
           "stage_wire_bytes": sum(b.numel() * b.element_size()
                                   for b in bufs)}
    results = []
    with no_host_copies():
        for _ in range(steps):
            t0 = time.time()
            sess.begin_step()
            for name in order:
                sess.mark_ready(f"['{name}']", grads[name])
            if window == 1:
                results.append(sess.finish())
                torch.cuda.synchronize()
                got["step_ms"].append((time.time() - t0) * 1e3)
            else:
                sess.step()
                got["step_ms"].append((time.time() - t0) * 1e3)
        if window > 1:
            t0 = time.time()
            results = sess.flush()
            torch.cuda.synchronize()
            got["flush_ms"] = (time.time() - t0) * 1e3
    for out, rep in results:
        close_to_sum(out, grads, 1e-4, 1e-5, what)
        got["overlap_pct"].append(rep.overlap_pct)
        got["exposed_comm_ms"].append(rep.exposed_comm_ms)
        if window > 1:
            got.setdefault("tail_ms", []).append(rep.tail_ms)
    got["fused"] = sess.compiled.fused
    del sess, results
    gc.collect()  # the session's buffers go before the next one's
    return got


def table_data(plan, leaves, members: int, chunk: int):
    """(n, 8 * members, chunk) float32 input of a fused ring program over
    the first ``members`` buckets: bucket b's payload, zero-padded to 8
    chunks, in chunks [8 b, 8 b + 8)."""
    import torch
    from ompi_tpu_torch.parallel import bucketer

    data = torch.zeros((N, N * members, chunk), device="cuda")
    for b in range(members):
        payload = bucketer.gather_bucket(leaves, plan[b % len(plan)])
        data[:, N * b:N * (b + 1)].view(N, -1)[:, :payload.shape[1]] = \
            payload
    return data


def train_tables(fused, plan, leaves, counters) -> dict:
    """The step's fused table programs and a window's boundary through
    ``sched_table`` at the path's bucket size, bitwise their plain
    version, every flag back at 0."""
    import torch
    from ompi_tpu_torch.coll.sched import pallas_lower as pl
    from ompi_tpu_torch.coll.sched import slipstream

    chunk = 4 * MIB // 4 // N
    times = {}
    programs = [(f"step.fused_{op}", sched) for op, sched in fused.items()]
    # rs_ag pairs with no consume deadlines: no allgather is elided, so
    # the tail's allgathers fuse with the next step's reduce-scatters
    window = slipstream.compile_window(
        N, [(b.elems, b.dtype) for b in plan[:4]], node_choices=["rs_ag"] * 4,
        ag_deadlines=[None] * 4)
    if window.boundary is None:
        raise AssertionError("window over rs_ag buckets has no boundary")
    programs.append(("window.boundary", window.boundary))
    for what, sched in programs:
        data = table_data(plan, leaves, sched.nchunks // N, chunk)
        # the program analyzed once on the host, its tables uploaded at
        # the first launch; a second launch timed by events
        t0 = time.time()
        prog = pl.analyze(sched)
        times[what + "_analyze_ms"] = (time.time() - t0) * 1e3
        got = pl.sched_table(prog, data, "sum")
        torch.cuda.synchronize()
        check_sems(counters.KERNELS["sched_table"])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        again = pl.sched_table(prog, data, "sum")
        end.record()
        torch.cuda.synchronize()
        times[what + "_ms"] = start.elapsed_time(end)
        check_sems(counters.KERNELS["sched_table"])
        equal_or_raise(again, got, f"sched_table {what} relaunched")
        del again
        t0 = time.time()
        want = pl.sched_table_plain(prog, data, "sum")
        equal_or_raise(got, want, f"sched_table {what} ({sched.nchunks} "
                       f"chunks of {chunk * 4} B)")
        log(f"[main] sched_table {what}: {sched.nchunks} chunks of "
            f"{chunk * 4} B x {N} ranks bitwise its plain version "
            f"({time.time() - t0:.1f} s plain); a launch "
            f"{times[what + '_ms']:.3f} ms by events, the program's "
            f"analysis {times[what + '_analyze_ms']:.1f} ms host")
        del data, got, want
        torch.cuda.empty_cache()
    return times


def train_partitioned(comm, grads) -> dict:
    """Psend_init/Precv_init of rank 0's gate_proj gradient to rank 1 in
    TRAIN_PARTITIONS partitions, Pready in a seeded random order with
    Parrived polled after each, the result bitwise the sent tensor."""
    import random

    import torch
    from ompi_tpu_torch.api import (Parrived, Pready, Precv_init,
                                    Psend_init)

    value = grads["gate_proj"][0].clone()
    t0 = time.time()
    sreq = Psend_init(comm, value, TRAIN_PARTITIONS, 1, 7, source=0)
    rreq = Precv_init(comm, TRAIN_PARTITIONS, 0, 7, dest=1, like=value)
    sreq.start()
    rreq.start()
    arrived = 0
    with no_host_copies():
        for p in random.Random(17).sample(range(TRAIN_PARTITIONS),
                                          TRAIN_PARTITIONS):
            Pready(sreq, p)
            arrived = sum(Parrived(rreq, q) for q in range(TRAIN_PARTITIONS))
        rreq.wait()
        sreq.wait()
    ms = (time.time() - t0) * 1e3
    got = rreq.result()
    if arrived != TRAIN_PARTITIONS or not got.is_cuda:
        raise AssertionError(f"partitioned: {arrived} partitions arrived")
    equal_or_raise(got, value, "Psend_init/Precv_init gate_proj")
    log(f"[main] Psend_init/Precv_init of {value.numel() * 4} B in "
        f"{TRAIN_PARTITIONS} partitions ({sreq._ntransfers} transfers), "
        f"Pready in a random order: bitwise the sent tensor, {ms:.1f} ms")
    return {"psend_precv_ms": ms, "transfers": sreq._ntransfers}


def train_step_path(pcomm, tcomm, pr, counters) -> dict:
    """The training-step path on both routes: the bucketer, the DP overlap
    session (three steps), the slipstream window (two steps, flushed),
    the fused table programs and a partitioned send of one gradient;
    prints a ``train_step`` JSON line. Raises on any disagreement."""
    import torch
    from ompi_tpu_torch.core import tree
    from ompi_tpu_torch.parallel import bucketer, overlap as ovl

    G = TRAIN_ELEMS * 4 * N
    log(f"[main] training-step path: one Llama-2-7B layer's gradients, "
        f"{TRAIN_ELEMS} float32 a rank, {G} B rank-major; peak device "
        f"memory reckoned {TRAIN_PEAK_G * G:.0f} B ({TRAIN_PEAK_G:.2f} G, "
        f"limit {TRAIN_PEAK_LIMIT:.0f})")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_path = time.time()
    gen = torch.Generator(device="cuda").manual_seed(23)
    grads = {name: torch.randn((N,) + shape, generator=gen, device="cuda")
             for name, shape in TRAIN_LAYER.items()}
    if sum(g.numel() for g in grads.values()) != TRAIN_ELEMS * N:
        raise AssertionError("layer size")
    # The backward order, captured on the card as bench.py captures it:
    # layer i's marker fires once layer i's gradients are formed.
    names = list(TRAIN_LAYER)
    ovl.reset_capture()
    ws = [torch.ones((), device="cuda", requires_grad=True) for _ in names]
    h = torch.ones(4, device="cuda", requires_grad=True)
    for i, name in enumerate(names):
        h = torch.tanh(ovl.grad_marker(h, name) * ws[i])
    h.sum().backward()
    order = [n for n in ovl.backward_order() if n in grads]
    if sorted(order) != sorted(names) or order[0] != names[-1]:
        raise AssertionError(f"captured backward order {order}")

    leaves, _ = tree.flatten(grads)
    plan = bucketer.plan_buckets([leaf[0] for leaf in leaves])
    if len(plan) != TRAIN_BUCKETS:
        raise AssertionError(f"{len(plan)} buckets")
    routes, fused = {}, None
    for route, comm in (("pallas", pcomm), ("tuned", tcomm)):
        got = {}
        t0 = time.time()
        with no_host_copies():
            out = bucketer.allreduce_pytree(comm, grads)
            torch.cuda.synchronize()
        got["allreduce_pytree_ms"] = (time.time() - t0) * 1e3
        got["allreduce_pytree_err"] = close_to_sum(
            out, grads, 1e-5, 1e-5, f"{route} allreduce_pytree")
        if route == "pallas":
            out_leaves, _ = tree.flatten(out)
            for b in TRAIN_CHECKED_BUCKETS:
                want = pr.allreduce_block(
                    bucketer.gather_bucket(leaves, plan[b]), "sum",
                    ring=pr.ring_allreduce_plain)
                equal_or_raise(bucketer.gather_bucket(out_leaves, plan[b]),
                               want, f"allreduce_pytree bucket {b} vs the "
                               f"ring's plain version")
            del out_leaves, want
        del out
        if route == "pallas":
            t0 = time.time()
            with no_host_copies():
                out = bucketer.allreduce_pytree(
                    comm, grads, bucket_bytes=TRAIN_RAISED_BUCKET)
                torch.cuda.synchronize()
            got["allreduce_pytree_16mib_ms"] = (time.time() - t0) * 1e3
            close_to_sum(out, grads, 1e-5, 1e-5, f"{route} 16 MiB buckets")
            del out
        sess = train_session(comm, grads, order, 1, TRAIN_STEPS,
                             f"{route} session")
        fused = sess.pop("fused")
        got["session"] = sess
        win = train_session(comm, grads, order, 2, 2, f"{route} window")
        win.pop("fused")
        got["window"] = win
        torch.cuda.empty_cache()
        routes[route] = got
        log(f"[main] {route}: allreduce_pytree "
            f"{got['allreduce_pytree_ms']:.1f} ms, session steps "
            f"{[round(t, 1) for t in sess['step_ms']]} ms (overlap "
            f"{[round(p, 1) for p in sess['overlap_pct']]} %, exposed "
            f"{[round(e, 1) for e in sess['exposed_comm_ms']]} ms), window "
            f"steps {[round(t, 1) for t in win['step_ms']]} ms + flush "
            f"{win['flush_ms']:.1f} ms")
    extra = train_tables(fused, plan, leaves, counters)
    extra.update(train_partitioned(tcomm, grads))
    for kernel in TRAIN_KERNELS:  # each kernel's last launch on the path
        check_sems(counters.KERNELS[kernel])
    peak = torch.cuda.max_memory_allocated()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(json.dumps({"train_step": {
        "card": smi.splitlines()[0], "layer": "Llama-2-7b-hf x 1 layer",
        "elems_per_rank": TRAIN_ELEMS, "ranks": N, "buckets": len(plan),
        "peak_bytes_reckoned": TRAIN_PEAK_G * G, "peak_bytes": peak,
        "routes": routes, **extra,
        "path_s": time.time() - t_path}}), flush=True)
    log(f"[main] training-step path {time.time() - t_path:.1f} s, peak "
        f"device memory {peak} B")
    if peak > TRAIN_PEAK_LIMIT:
        raise AssertionError(f"training-step path peak {peak} B")
    return {}


# ---------------------------------------------------------------------------
# The flagship model at Mixtral-8x7B's widths, and the dry run
# ---------------------------------------------------------------------------

# Mixtral-8x7B's widths (mistralai/Mixtral-8x7B-v0.1 config.json:
# vocab_size 32000, hidden_size 4096, num_attention_heads 32 (head dim
# 128), intermediate_size 14336, num_local_experts 8) on the JAX
# package's own architecture (multi-head attention, top-1 routing, a
# two-matrix gelu MLP, learned positions). Cut: depth 32 -> 4 layers
# (2 stages x 2), context 32768 -> 2048. 8 ranks as (dp, pp, tp) =
# (2, 2, 2), batch 2 M dp = 8, bfloat16.
MODEL_CFG = dict(vocab=32000, d_model=4096, n_heads=32, head_dim=128,
                 d_ff=14336, layers_per_stage=2, seq_len=2048, n_experts=8,
                 expert_ff=14336, moe_every=2, capacity_factor=1.25,
                 microbatches=2)
MODEL_BATCH = 8
# One ring attention per layer per tick: 2 layers x (M + P - 1) ticks.
MODEL_ATTN_LAUNCHES = 2 * (2 + 2 - 1)
# The fused path against the xla path on the same parameters and tokens
# (the xla path rounds its scores to bfloat16; the kernel does not): the
# loss, relative, and the last stage's final hidden state, |h - h_xla| /
# |h_xla| per token (norms over d_model). Two wrong models must fail
# both limits: attention that drops the other tp rank's KV block, and
# the MoE layers routing every token to the next expert. The loss limit
# sits between the readings (NVIDIA H100 80GB HBM3, 700 W): the fused
# path 2.57e-5, the controls 8.1e-4 and 3.7e-4. The hidden-state limit
# reads the 90th percentile over tokens, not the largest: a token whose
# top-1 router margin is below the paths' difference changes expert
# (the largest was 0.65 for the fused path, 1.26 and 0.96 for the
# controls), while each control changes at least half the tokens; at
# the 90th percentile the fused path read 0.0139, the controls 0.973
# and 0.741.
MODEL_LOSS_RTOL = 1e-4
MODEL_HIDDEN_TOL = 3e-2
MODEL_TIMED = 2  # forwards timed after the first
#: The attention at the model's folded shape: the kernels line's row 15
#: "also" entry, set before the main path.
MODEL_ATTN: dict = {}


@contextlib.contextmanager
def replaced(owner, attr: str, value):
    """``owner.attr`` is ``value`` inside the block, and what it was
    after."""
    old = getattr(owner, attr)
    setattr(owner, attr, value)
    try:
        yield
    finally:
        setattr(owner, attr, old)


@contextlib.contextmanager
def sp_impl(config, impl: str):
    """The cvar ``parallel_sp_impl`` is ``impl`` inside the block, and
    what it was after."""
    old = config.VARS.get("parallel_sp_impl")
    config.VARS.set("parallel_sp_impl", impl)
    try:
        yield
    finally:
        config.VARS.set("parallel_sp_impl", old)


def model_attention_check(gen) -> None:
    """ring_attention at the model's folded shape (tp = 2 ranks, T =
    1024, dp pp mb H = 256 heads of 128, bfloat16, causal), kernel
    against its plain version on the same q, k, v, to one bfloat16 ulp
    (ATTN_TOL), which the two rounded folds must fail; its time beside
    its bound and SDPA."""
    import torch
    import torch.nn.functional as F
    from ompi_tpu_torch.coll import pallas_attn as pa
    from ompi_tpu_torch.core.counters import KERNELS

    t0 = time.time()
    tp, dp, pp = 2, 2, 2
    seq = MODEL_CFG["seq_len"]
    t = seq // tp
    heads = dp * pp * (MODEL_BATCH // dp // MODEL_CFG["microbatches"]) * \
        MODEL_CFG["n_heads"]
    dh = MODEL_CFG["head_dim"]
    q, k, v = (random_rank_major((tp, t, heads, dh), torch.bfloat16, gen)
               for _ in range(3))
    got = pa.ring_attention_block(q, k, v, True)
    torch.cuda.synchronize()
    check_sems(KERNELS["ring_attention"])
    what = "ring_attention at the model's folded shape"
    tol = ATTN_TOL["bfloat16"]
    plain = pa.ring_attention_block_plain(q, k, v, True)
    err, ratio = within(got, plain, tol, what)
    controls = []
    for where in ("p", "o"):
        controls.append(excess(rounded_control(q, k, v, True, where), plain,
                               tol)[1])
        if controls[-1] <= 1.0:
            raise AssertionError(f"{what}: a fold that rounds {where} to "
                                 f"bfloat16 passes the tolerance")
    flops = 4 * heads * dh * seq * (seq + 1) / 2
    nbytes = 4 * q.numel() * q.element_size()
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
    lq, lk, lv = (x.reshape(seq, heads, dh).transpose(0, 1).unsqueeze(0)
                  .contiguous() for x in (q, k, v))
    MODEL_ATTN.update({
        "shape": "model", "nranks": tp, "tokens_per_rank": t,
        "heads": heads, "head_dim": dh, "dtype": "bfloat16",
        "causal": True, "max_abs_err": err,
        "ms": p50_ms(lambda: pa.ring_attention_block(q, k, v, True),
                     KERNEL_REPS),
        "plain_ms": p50_ms(
            lambda: pa.ring_attention_block_plain(q, k, v, True), 3),
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "operations" if op_ms >= byte_ms else "bytes",
        "library_ms": p50_ms(lambda: F.scaled_dot_product_attention(
            lq, lk, lv, is_causal=True), KERNEL_REPS),
        "flops": flops, "bytes": nbytes,
    })
    MODEL_ATTN["tflops_per_s"] = flops / MODEL_ATTN["ms"] / 1e9
    log(f"[model] {what} (tp={tp}, T={t}, H'={heads}, Dh={dh}, bf16 "
        f"causal): max err {err:.3g} vs plain ({ratio:.3g} of the limit at "
        f"atol, rtol {tol}); controls rounding p / o to bfloat16 "
        f"{controls[0]:.3g} / {controls[1]:.3g} times the limit, refused; "
        f"{MODEL_ATTN['ms']:.4f} ms p50 (bound {MODEL_ATTN['bound_ms']:.4f}"
        f" ms by {MODEL_ATTN['bound_by']}, plain "
        f"{MODEL_ATTN['plain_ms']:.3f} ms, SDPA "
        f"{MODEL_ATTN['library_ms']:.4f} ms, "
        f"{MODEL_ATTN['tflops_per_s']:.2f} TFLOP/s) [{CARD[0]}] "
        f"({time.time() - t0:.1f} s)")


def hidden_rel(got, want) -> dict:
    """|got - want| / |want| per token (norms over the last axis), in
    float32: its 90th percentile over tokens (what MODEL_HIDDEN_TOL
    reads), its largest, and the same over the whole tensor."""
    import torch

    got, want = got.float(), want.float()
    diff = got - want
    per = (diff.norm(dim=-1) / want.norm(dim=-1)).flatten()
    return {"p90": float(torch.quantile(per, 0.9)), "max": float(per.max()),
            "whole": float(diff.norm() / want.norm())}


def model_path(config) -> dict:
    """The flagship's forward at Mixtral-8x7B's widths over (dp, pp, tp)
    = (2, 2, 2) on the card with ``parallel_sp_impl=pallas``: a finite
    loss, exactly MODEL_ATTN_LAUNCHES ring-attention launches a forward,
    the loss within MODEL_LOSS_RTOL and the last stage's hidden state
    within MODEL_HIDDEN_TOL of the same forward on the xla path, which
    two wrong models (MODEL_HIDDEN_TOL's controls) fail; its time, peak
    memory and a ``model`` JSON line."""
    import torch
    from ompi_tpu_torch.coll import pallas_attn as pa
    from ompi_tpu_torch.core import tree
    from ompi_tpu_torch.models import transformer as T

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = T.ModelConfig(dtype=torch.bfloat16, **MODEL_CFG)
    mesh = T.demo_mesh(N)
    t0 = time.time()
    params = T.sharded_init(cfg, mesh, seed=0)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    nparams = sum(p.numel() for p in tree.leaves(params))
    tokens, targets = T.make_batch(cfg, batch=MODEL_BATCH)
    fwd = T.build_forward(cfg, mesh)
    hidden = T.build_hidden(cfg, mesh)
    last = T.last_stage(mesh)

    def run():
        before = pa.ATTN.launches
        start = time.time()
        loss = fwd(params, tokens, targets)
        torch.cuda.synchronize()
        took = time.time() - start
        if pa.ATTN.launches - before != MODEL_ATTN_LAUNCHES:
            raise AssertionError(
                f"model forward: {pa.ATTN.launches - before} ring-attention "
                f"launches, not {MODEL_ATTN_LAUNCHES}")
        check_sems(pa.ATTN)
        return loss, took

    with sp_impl(config, "pallas"):
        loss, first_s = run()
        times = [run()[1] for _ in range(MODEL_TIMED)]
        h_fused = hidden(params, tokens)[last]
    peak = torch.cuda.max_memory_allocated()
    with sp_impl(config, "xla"):
        start = time.time()
        loss_xla = fwd(params, tokens, targets)
        torch.cuda.synchronize()
        xla_s = time.time() - start
        h_xla = hidden(params, tokens)[last]
        ring_attention = T.sp_mod.ring_attention
        moe = T.ep_mod.moe_dispatch_combine

        def local_attention(q, k, v, causal=True, impl=None):
            tp, t, h, dh = q.shape

            def fold(x):  # each rank's block alone: the ranks into heads
                return x.permute(1, 0, 2, 3).reshape(1, t, tp * h, dh)

            out = ring_attention(fold(q), fold(k), fold(v), causal=causal)
            return out.reshape(t, tp, h, dh).permute(1, 0, 2, 3)

        controls = {}
        for name, owner, attr, wrong in (
                ("attention without the other ranks' KV blocks", T.sp_mod,
                 "ring_attention", local_attention),
                ("every token routed to the next expert", T.ep_mod,
                 "moe_dispatch_combine",
                 lambda x, logits, *a, **kw: moe(x, logits.roll(1, -1), *a,
                                                 **kw))):
            with replaced(owner, attr, wrong):
                h_wrong = hidden(params, tokens)[last]
                loss_wrong = float(fwd(params, tokens, targets))
            controls[name] = {"hidden_rel": hidden_rel(h_wrong, h_xla),
                              "loss_rel": abs(loss_wrong - float(loss_xla))
                              / abs(float(loss_xla))}
            h_wrong = None
    loss, loss_xla = float(loss), float(loss_xla)
    rel = abs(loss - loss_xla) / abs(loss_xla)
    h_rel = hidden_rel(h_fused, h_xla)
    out = {
        "config": "Mixtral-8x7B widths, 4 layers, 2048 tokens",
        "mesh": mesh.shape, "batch": MODEL_BATCH, "dtype": "bfloat16",
        "params_per_rank": nparams // N, "init_s": init_s,
        "loss": loss, "loss_xla": loss_xla, "rel_diff": rel,
        "hidden_rel": h_rel, "hidden_tol": MODEL_HIDDEN_TOL,
        "loss_rtol": MODEL_LOSS_RTOL, "controls": controls,
        "first_forward_s": first_s, "forward_s": times,
        "xla_forward_s": xla_s, "peak_bytes": peak,
        "attn_launches_per_forward": MODEL_ATTN_LAUNCHES,
        "card": CARD[0],
    }
    print(json.dumps({"model": out}), flush=True)
    log(f"[model] forward at Mixtral-8x7B widths (dp, pp, tp = 2, 2, 2; 4 "
        f"layers, 2048 tokens, batch {MODEL_BATCH}, bf16): loss {loss:.5f}, "
        f"xla path {loss_xla:.5f} ({rel:.3g} relative, limit "
        f"{MODEL_LOSS_RTOL}); last stage's hidden state from the xla "
        f"path's {h_rel['p90']:.3g} at the 90th percentile of tokens "
        f"(limit {MODEL_HIDDEN_TOL}; largest {h_rel['max']:.3g}, whole "
        f"{h_rel['whole']:.3g}); controls "
        + "; ".join(f"{name}: hidden {c['hidden_rel']['p90']:.3g} (largest "
                    f"{c['hidden_rel']['max']:.3g}), loss {c['loss_rel']:.3g}"
                    for name, c in controls.items())
        + f"; {MODEL_ATTN_LAUNCHES} ring-attention launches a forward; "
        f"forward {min(times):.3f} s (first {first_s:.3f} s, xla path "
        f"{xla_s:.3f} s), peak {peak} bytes, init {init_s:.1f} s "
        f"[{CARD[0]}]")
    if not (math.isfinite(loss) and math.isfinite(loss_xla)):
        raise AssertionError(f"model loss {loss} / xla {loss_xla}")
    if rel > MODEL_LOSS_RTOL:
        raise AssertionError(f"model loss {loss} vs the xla path's "
                             f"{loss_xla}: {rel:.3g} relative")
    if not h_rel["p90"] <= MODEL_HIDDEN_TOL:
        raise AssertionError(f"model hidden state {h_rel} from the xla "
                             f"path's")
    for name, c in controls.items():
        if not (c["hidden_rel"]["p90"] > MODEL_HIDDEN_TOL
                and c["loss_rel"] > MODEL_LOSS_RTOL):
            raise AssertionError(f"model control ({name}) passes a limit: "
                                 f"{c}")
    params = h_fused = h_xla = None
    gc.collect()
    torch.cuda.empty_cache()
    return {}


def dryrun_path() -> dict:
    """``graft_entry.dryrun_multichip(8)`` on the card (two training
    steps at the tiny configuration, a vtable allreduce, the kernel
    tier), then ``entry()``'s forward once."""
    import torch
    from ompi_tpu_torch import graft_entry

    t0 = time.time()
    line = graft_entry.dryrun_multichip(N)
    fn, args = graft_entry.entry()
    loss = float(fn(*args))
    torch.cuda.synchronize()
    if not math.isfinite(loss):
        raise AssertionError(f"entry() forward loss {loss}")
    log(f"[dryrun] {line}; entry() forward loss {loss:.5f} "
        f"({time.time() - t0:.1f} s)")
    return {}


def main_path(tt, pr, config) -> tuple[dict, dict]:
    """Both vtable routes at full size, path by path; returns (kernel ->
    max error, kernel -> launches on its path)."""
    import torch
    from ompi_tpu_torch.core import counters

    gen = torch.Generator(device="cuda").manual_seed(1)
    # The checks before grew the scratch the kernels reuse per stream (the
    # allgather's L2 form at n = 12 the most): the main path starts from
    # none and grows its own.
    pr._SCRATCH.clear()
    torch.cuda.empty_cache()
    world = tt.init(nranks=N)
    config.VARS.set("coll_pallas_priority", 100)
    pcomm = world.dup()
    config.VARS.set("coll_pallas_priority", 30)
    tcomm = world.dup()
    for opname in ("allreduce", "bcast", "reduce", "reduce_scatter_block",
                   "allgather", "alltoall", "gather", "scatter"):
        if pcomm._coll[opname][0].NAME != "pallas":
            raise AssertionError(f"pallas component not selected: {opname}")
        if tcomm._coll[opname][0].NAME != "tuned":
            raise AssertionError(f"tuned component not selected: {opname}")

    paths = (
        (tuple(MAIN_SIZES), lambda: allreduce_path(
            pcomm, tcomm, pr, config, counters, gen)),
        (tuple(COLL_CASES), lambda: coll_path(
            pcomm, tcomm, pr, config, counters, gen)),
        (("ring_allreduce_bidir",), lambda: {
            "ring_allreduce_bidir": bidir_path(pcomm, tcomm, pr, config,
                                               counters, gen)}),
        (tuple(MOVE_CASES), lambda: move_path(
            pcomm, tcomm, pr, config, counters, gen)),
        (SCHED_KERNELS, lambda: sched_path(world, tcomm, pr, config,
                                           counters, gen)),
        (("quant_allreduce",), lambda: quant_path(tcomm, config, counters,
                                                  gen)),
        (("ring_attention",), lambda: attention_path(config, counters,
                                                     gen)),
        (("ppermute_shift",), lambda: hop_path(counters, gen)),
        (SURFACE_KERNELS, lambda: surface_path(world, pcomm, tcomm, config,
                                               counters, gen)),
        (SURFACE_KERNELS, lambda: p2p_path(pcomm, tcomm, counters, gen)),
        (TRAIN_KERNELS, lambda: train_step_path(pcomm, tcomm, pr,
                                                counters)),
        (("ring_attention",), lambda: model_path(config)),
        (("ring_allreduce_rd", "ring_attention"), dryrun_path),
    )
    errs, launches = {}, {}
    for kernels, drive in paths:
        counters.reset_launches()
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        errs.update(drive())
        got = counters.launches()
        for kernel in kernels:
            if got.get(kernel, 0) < 1:
                raise AssertionError(f"main path never launched {kernel}")
            launches[kernel] = launches.get(kernel, 0) + got[kernel]
        log(f"[main] launches on this path: "
            f"{ {k: got[k] for k in kernels} }, peak device memory "
            f"{torch.cuda.max_memory_allocated()} bytes")
        PEAK[0] = max(peak, PEAK[0], torch.cuda.max_memory_allocated())
    if set(launches) != set(SOURCES):
        raise AssertionError(f"paths cover {sorted(launches)}")
    tt.finalize()
    return errs, launches


def p50_ms(fn, reps: int) -> float:
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sched_case(program: str, nbytes: int, gen, dtype=None):
    """(kernel call, plain call, library call, bound bytes) of the table
    kernel on ``program`` ("ring", "seg" or "rs", the programs behind
    sched_pallas_ring, _ring_seg and _rs) at ``nbytes`` per rank (sent,
    for the reduce-scatter), on its registered wrapper's layout, in
    ``dtype`` (float32 by default)."""
    import torch
    from ompi_tpu_torch.coll import sched as sched_mod
    from ompi_tpu_torch.coll.sched import pallas_lower as pl

    n = N
    algo = {"ring": "sched_pallas_ring", "seg": "sched_pallas_ring_seg",
            "rs": "sched_pallas_rs"}[program]
    prog = pl.analyze(sched_mod.build_schedule(algo, n))
    dtype = dtype or torch.float32
    elems = nbytes // dtype.itemsize
    if program == "rs":
        x = random_rank_major((n, n, elems // n), dtype, gen)
        data, library = x, lambda: x.sum(0)
        bound = (n + 1) * nbytes
    else:
        x = random_rank_major((n, elems), dtype, gen)
        # sizes are multiples of nchunks x 128 elements: no padding
        data = x.reshape(n, prog.nchunks, -1)
        library = lambda: x.sum(0, keepdim=True).expand_as(x).contiguous()  # noqa: E731
        bound = 2 * n * nbytes
    return (lambda: pl.sched_table(prog, data, "sum"),
            lambda: pl.sched_table_plain(prog, data, "sum"), library, bound)


def timed_case(pr, kernel, nbytes, gen, dtype=None):
    """(kernel call, plain call, library call, bound bytes, dtype, op) at
    ``nbytes`` per rank, on the kernel's own layout; a reduction kernel
    in ``dtype`` if one is given (its row's dtype by default)."""
    import torch
    import torch.nn.functional as F

    n = N
    name = str(dtype or torch.float32).removeprefix("torch.")
    if kernel == "quant_allreduce":
        from ompi_tpu_torch.coll import quant

        x = random_rank_major((n, nbytes // 4), torch.float32, gen)
        quantum = n * 128 * 128  # allreduce_block_quant's padding
        flat = F.pad(x, (0, (-x.shape[1]) % quantum))
        blocks = flat.reshape(n, n, -1, 128)
        # library: none computes the int8 wire's result; the exact sum
        # is timed beside it for context
        return (lambda: quant.quant_allreduce(blocks),
                lambda: quant.quant_allreduce_plain(blocks),
                lambda: x.sum(0, keepdim=True).expand_as(x).contiguous(),
                2 * n * nbytes, "float32", "sum")
    if kernel == "sched_table":
        # the main row: the segmented program (small sizes: the ring's)
        fn, plain, library, bound = sched_case(
            "seg" if nbytes >= GIB else "ring", nbytes, gen, dtype)
        return fn, plain, library, bound, name, "sum"
    if kernel == "selfdma_chunked":
        x = random_rank_major((1, nbytes // 4), torch.float32, gen)
        rows, seg_rows = pr._chunked_layout(nbytes // 4, 1, torch.float32,
                                            MIB)
        if rows * pr.LANES != x.shape[1]:
            raise AssertionError(f"{nbytes} B is not whole segments")
        seg = seg_rows * pr.LANES
        return (lambda: pr.selfdma_chunked(x, seg),
                lambda: pr.selfdma_chunked_plain(x, seg),
                lambda: x.clone(), 2 * nbytes, "float32", None)
    if kernel in MAIN_SIZES:
        dt = dtype or torch.float32
        x = random_rank_major((n, nbytes // dt.itemsize), dt, gen)
        if kernel == "ring_allreduce_rd":
            inp = x
            fn = lambda: pr.ring_allreduce_rd(inp, "sum")  # noqa: E731
            plain = lambda: pr.ring_allreduce_rd_plain(inp, "sum")  # noqa: E731
        elif kernel == "ring_allreduce":
            inp, _, _ = pr._split_ring(x)
            fn = lambda: pr.ring_allreduce(inp, "sum")  # noqa: E731
            plain = lambda: pr.ring_allreduce_plain(inp, "sum")  # noqa: E731
        else:
            rows_, seg_rows = pr._chunked_layout(x.shape[1], n, dt, MIB)
            inp = x.reshape(n, n, rows_ * pr.LANES)
            seg = seg_rows * pr.LANES
            fn = lambda: pr.ring_allreduce_chunked(inp, "sum", seg)  # noqa: E731
            plain = lambda: pr.ring_allreduce_chunked_plain(  # noqa: E731
                inp, "sum", seg)
        library = lambda: x.sum(0, keepdim=True).expand_as(x).contiguous()  # noqa: E731
        return fn, plain, library, 2 * n * nbytes, name, "sum"
    if kernel == "ring_allreduce_bidir":
        dt = dtype or torch.float32
        x = random_rank_major((n, nbytes // dt.itemsize), dt, gen)
        inp, _, _ = pr._split_ring(x)  # 1 MiB: blocks of 256-lane multiples
        return (lambda: pr.ring_allreduce_bidir(inp, "sum"),
                lambda: pr.ring_allreduce_bidir_plain(inp, "sum"),
                lambda: x.sum(0, keepdim=True).expand_as(x).contiguous(),
                2 * n * nbytes, name, "sum")
    if kernel in MOVE_CASES:
        x = move_input(kernel, nbytes, gen)  # multiples of 128 lanes
        if kernel == "ring_alltoall":
            return (lambda: pr.ring_alltoall(x),
                    lambda: pr.ring_alltoall_plain(x),
                    lambda: x.transpose(0, 1).contiguous(),
                    2 * n * nbytes, "float32", None)
        if kernel == "linear_gather":
            return (lambda: pr.linear_gather(x, GATHER_ROOT),
                    lambda: pr.linear_gather_plain(x, GATHER_ROOT),
                    lambda: x.clone(), 2 * n * nbytes, "float32", None)
        return (lambda: pr.linear_scatter(x, SCATTER_ROOT),
                lambda: pr.linear_scatter_plain(x, SCATTER_ROOT),
                lambda: x.clone(), 2 * n * nbytes, "float32", None)
    x = coll_input(kernel, nbytes, gen, dtype)  # multiples of 128 lanes
    if kernel == "tree_bcast":
        return (lambda: pr.tree_bcast(x, BCAST_ROOT),
                lambda: pr.tree_bcast_plain(x, BCAST_ROOT),
                lambda: x[BCAST_ROOT].expand_as(x).contiguous(),
                nbytes + n * nbytes, "float32", None)
    if kernel == "tree_reduce":
        return (lambda: pr.tree_reduce(x, "max", REDUCE_ROOT),
                lambda: pr.tree_reduce_plain(x, "max", REDUCE_ROOT),
                lambda: x.amax(0), n * nbytes + nbytes,
                str(x.dtype).removeprefix("torch."), "max")
    if kernel == "ring_reduce_scatter":
        return (lambda: pr.ring_reduce_scatter(x, "sum"),
                lambda: pr.ring_reduce_scatter_plain(x, "sum"),
                lambda: x.sum(0), n * nbytes + nbytes, name, "sum")
    return (lambda: pr.ring_allgather(x),
            lambda: pr.ring_allgather_plain(x),
            lambda: x.unsqueeze(0).expand((n,) + tuple(x.shape)).contiguous(),
            nbytes + n * nbytes, "float32", None)


def measure(pr, gen, errs, launches) -> list:
    import torch
    from ompi_tpu_torch.core.counters import KERNELS

    rows = []
    sizes = dict(MAIN_SIZES, **{k: GIB for k in COLL_CASES},
                 ring_allreduce_bidir=BIDIR_BYTES,
                 **{k: GIB for k in MOVE_CASES},
                 **{k: GIB for k in SCHED_KERNELS}, quant_allreduce=GIB)
    for kernel, nbytes in sizes.items():
        fn, plain, library, nbytes_moved, dtype, op = timed_case(
            pr, kernel, nbytes, gen)
        ms = p50_ms(fn, KERNEL_REPS)
        plan = KERNELS[kernel].last_plan  # as the timed launches ran
        plain_ms = p50_ms(plain, 3 if nbytes >= GIB else 10)
        library_ms = p50_ms(library, KERNEL_REPS)
        exact_sum_ms = None
        if kernel == "quant_allreduce":
            exact_sum_ms, library_ms = library_ms, None
        bound_ms = nbytes_moved / HBM_BYTES_PER_S * 1e3
        row = {
            "name": kernel, "route": "cuda",
            "source": f"ompi_tpu_torch/csrc/{kernel}.cu",
            "replaces": SOURCES[kernel], "launches": launches[kernel],
            "max_abs_err": errs[kernel], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms, "bytes_per_rank": nbytes,
            "nranks": 1 if kernel == "selfdma_chunked" else N,
            "dtype": dtype, "op": op,
        }
        del fn, plain, library
        torch.cuda.empty_cache()
        extra = ""
        if kernel in F64_KERNELS:
            fn, _, _, _, _, _ = timed_case(pr, kernel, nbytes, gen,
                                           torch.float64)
            row["float64"] = {"ms": p50_ms(fn, KERNEL_REPS),
                              "bytes_per_rank": nbytes}
            extra = f", float64 {row['float64']['ms']:.4f} ms"
            del fn
            torch.cuda.empty_cache()
        if kernel in COLL_CASES or kernel in MOVE_CASES \
                or kernel in SCHED_KERNELS or kernel == "quant_allreduce":
            small = QUANT_SMALL if kernel == "quant_allreduce" else 4 * KIB
            fn, _, _, small_moved, _, _ = timed_case(pr, kernel, small, gen)
            row["small_ms"] = p50_ms(fn, KERNEL_REPS)
            row["small_bytes_per_rank"] = small
            row["small_bound_ms"] = small_moved / HBM_BYTES_PER_S * 1e3
            extra += f", {row['small_ms']:.4f} ms at {small} B/rank"
            del fn
        if exact_sum_ms is not None:
            row["exact_sum_ms"] = exact_sum_ms
            row.update(QUANT_ROUTE)
            extra += (f"; no library call, the exact sum takes "
                      f"{exact_sum_ms:.4f} ms; TunedColl quant_ring "
                      f"{QUANT_ROUTE['quant_ring_ms']:.4f} ms, "
                      f"{QUANT_ROUTE['exact_route']} "
                      f"{QUANT_ROUTE['exact_route_ms']:.4f} ms")
        if kernel == "ring_allreduce":
            extra += ring_split(pr, gen, row)
        if kernel == "tree_reduce":
            row["blocks_per_relative_rank"] = plan["blocks_per_relative_rank"]
            row["segment_cols"] = plan["segment_cols"]
            log(f"[tree] tree_reduce at {nbytes} B/rank: blocks per relative "
                f"rank {plan['blocks_per_relative_rank']} of "
                f"{plan['threads']} threads, segments of "
                f"{plan['segment_cols']} columns")
        if kernel == "tree_bcast":
            row["blocks_per_rank"] = plan["blocks_per_rank"]
            row["segment_bytes"] = plan["segment_bytes"]
            log(f"[tree] tree_bcast at {nbytes} B/rank: "
                f"{plan['blocks_per_rank']} blocks of {plan['threads']} "
                f"threads per rank, {plan['segments']} segments of "
                f"{plan['segment_bytes']} B")
        if kernel in ("ring_reduce_scatter", "ring_allgather"):
            for key in ("stripes", "threads", "segment_bytes", "buffers",
                        "buffer_bytes"):
                row[key] = plan[key]
            log(f"[ring] {kernel} at {nbytes} B/rank: "
                f"{plan['stripes']} stripes x {plan['threads']} threads per "
                f"rank, segments of {plan['segment_bytes']} B, buffers "
                f"{plan['buffer_bytes']} B in {plan['buffers']}")
        if kernel == "ring_allgather":
            extra += ag_also(pr, gen, row)
        if kernel == "ring_allreduce_chunked":
            extra += chunked_also(pr, gen, row)
        if kernel == "selfdma_chunked":
            extra += selfdma_split(pr, gen, row)
        if kernel == "quant_allreduce":
            extra += quant_also(gen, row)
        if kernel in ("ring_allreduce_bidir", "ring_allreduce_chunked",
                      "linear_scatter", "sched_table", "selfdma_chunked",
                      "ring_allreduce_rd", "linear_gather",
                      "quant_allreduce"):
            row["plan"] = plan
            log(f"[plan] {kernel} at {nbytes} B/rank: {plan}")
        if kernel == "ring_allreduce_rd":
            extra += rd_split(pr, gen, row)
        if kernel == "sched_table":
            row["program"] = "segmented_ring(8, 2)"
            row["also"] = []
            for program, size in (("ring", MIB), ("rs", GIB)):
                fn, plain, library, bound = sched_case(program, size, gen)
                also = {"program": program, "bytes_per_rank": size,
                        "ms": p50_ms(fn, KERNEL_REPS),
                        "plan": KERNELS[kernel].last_plan,
                        "plain_ms": p50_ms(plain, 3 if size >= GIB else 10),
                        "bound_ms": bound / HBM_BYTES_PER_S * 1e3,
                        "bound_by": "bytes",
                        "library_ms": p50_ms(library, KERNEL_REPS)}
                row["also"].append(also)
                extra += (f"; {program} at {size} B/rank {also['ms']:.4f} ms"
                          f" (bound {also['bound_ms']:.4f}, plain "
                          f"{also['plain_ms']:.3f}, library "
                          f"{also['library_ms']:.4f})")
                del fn, plain, library
                torch.cuda.empty_cache()
        rows.append(row)
        lib = "null" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"[time] {kernel}: {ms:.4f} ms p50 at {nbytes} B/rank (bound "
            f"{bound_ms:.4f} ms, plain {plain_ms:.3f} ms, library "
            f"{lib}){extra}")
        torch.cuda.empty_cache()
    return rows


def ag_also(pr, gen, row) -> str:
    """The allgather's L2 form at n = 12 (about 1 GiB received per rank)
    beside its library call, and ``allreduce_block_rsag`` (the
    reduce-scatter, then the allgather) at 1 GiB per rank, n = 8, beside
    ``x.sum(0)`` broadcast: p50s into ``row["also"]``; returns the log
    text."""
    import torch

    n = 12
    x = random_rank_major((n, GIB // 4 // n // 128 * 128), torch.float32,
                          gen)
    l2 = {"nranks": n, "bytes_per_rank": n * x.shape[1] * 4,
          "ms": p50_ms(lambda: pr.ring_allgather(x), KERNEL_REPS),
          "plan": dict(pr.AG.last_plan),
          "bound_ms": (n + 1) * n * x.shape[1] * 4 / HBM_BYTES_PER_S * 1e3,
          "bound_by": "bytes",
          "library_ms": p50_ms(lambda: x.unsqueeze(0).expand(
              (n,) + tuple(x.shape)).contiguous(), KERNEL_REPS)}
    del x
    torch.cuda.empty_cache()
    x = random_rank_major((N, GIB // 4), torch.float32, gen)
    rsag = {"function": "allreduce_block_rsag", "nranks": N,
            "bytes_per_rank": GIB,
            "ms": p50_ms(lambda: pr.allreduce_block_rsag(x, "sum"), 5),
            "bound_ms": 2 * N * GIB / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": p50_ms(lambda: x.sum(0, keepdim=True).expand_as(
                x).contiguous(), 5)}
    del x
    torch.cuda.empty_cache()
    row["also"] = [l2, rsag]
    return (f"; n = 12 (L2) {l2['ms']:.4f} ms (bound {l2['bound_ms']:.4f}, "
            f"library {l2['library_ms']:.4f}); allreduce_block_rsag at "
            f"{GIB} B/rank {rsag['ms']:.4f} ms (library "
            f"{rsag['library_ms']:.4f})")


def chunked_also(pr, gen, row) -> str:
    """The chunked ring's L2 form at n = 12 (about 1 GiB per rank, whole
    1 MiB layout segments) beside its bound and library call, and
    ``allreduce_block_rsag`` (the reduce-scatter, then the allgather: the
    same function and bits) at 1 GiB per rank, n = 8: p50s into
    ``row["also"]``; returns the log text."""
    import torch

    n = 12
    size = GIB // (n * MIB) * n * MIB // 4  # float32 per rank
    rows, seg_rows = pr._chunked_layout(size, n, torch.float32, MIB)
    x = random_rank_major((n, size), torch.float32, gen)
    blocks = x.reshape(n, n, rows * pr.LANES)
    l2 = {"nranks": n, "bytes_per_rank": size * 4,
          "ms": p50_ms(lambda: pr.ring_allreduce_chunked(
              blocks, "sum", seg_rows * pr.LANES), KERNEL_REPS),
          "plan": dict(pr.CHUNKED.last_plan),
          "bound_ms": 2 * n * size * 4 / HBM_BYTES_PER_S * 1e3,
          "bound_by": "bytes",
          "library_ms": p50_ms(lambda: x.sum(0, keepdim=True).expand_as(
              x).contiguous(), KERNEL_REPS)}
    del x, blocks
    torch.cuda.empty_cache()
    x = random_rank_major((N, GIB // 4), torch.float32, gen)
    rsag = {"function": "allreduce_block_rsag", "nranks": N,
            "bytes_per_rank": GIB,
            "ms": p50_ms(lambda: pr.allreduce_block_rsag(x, "sum"), 5),
            "bound_ms": 2 * N * GIB / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}
    del x
    torch.cuda.empty_cache()
    row["also"] = [l2, rsag]
    return (f"; n = 12 (L2) {l2['ms']:.4f} ms (bound {l2['bound_ms']:.4f}, "
            f"library {l2['library_ms']:.4f}); allreduce_block_rsag at "
            f"{GIB} B/rank {rsag['ms']:.4f} ms")


def quant_also(gen, row) -> str:
    """The int8 ring's L2 form at n = 12 (about 1 GiB per rank, whole
    quanta) beside its bound and the exact sum: a p50 and its plan into
    ``row["also"]``; returns the log text."""
    import torch
    from ompi_tpu_torch.coll import quant

    n = 12
    quantum = n * 128 * 128
    size = GIB // 4 // quantum * quantum  # float32 per rank
    x = random_rank_major((n, size), torch.float32, gen)
    blocks = x.reshape(n, n, -1, 128)
    l2 = {"nranks": n, "bytes_per_rank": size * 4,
          "ms": p50_ms(lambda: quant.quant_allreduce(blocks), KERNEL_REPS),
          "plan": dict(quant.QUANT.last_plan),
          "bound_ms": 2 * n * size * 4 / HBM_BYTES_PER_S * 1e3,
          "bound_by": "bytes", "library_ms": None,
          "exact_sum_ms": p50_ms(lambda: x.sum(0, keepdim=True).expand_as(
              x).contiguous(), KERNEL_REPS)}
    if l2["plan"]["form"] != "l2":
        raise AssertionError(f"quant_allreduce n = 12: {l2['plan']}")
    check_sems(quant.QUANT)
    del x, blocks
    torch.cuda.empty_cache()
    row["also"] = [l2]
    return (f"; n = 12 (L2) {l2['ms']:.4f} ms (bound {l2['bound_ms']:.4f}, "
            f"exact sum {l2['exact_sum_ms']:.4f}), plan {l2['plan']}")


def device_ms(split: dict) -> float:
    """The device time of the one kernel a profiled call launched."""
    times = [v for k, v in split.items() if k.endswith(" device")]
    if len(times) != 1:
        raise AssertionError(f"not one kernel on the card: {split}")
    return times[0]


def selfdma_split(pr, gen, row) -> str:
    """The one-rank kernel's and ``x.clone()``'s device times at 1 GiB
    from ``torch.profiler`` (p50 of 20 calls, as ``tools/ring_probe.py``
    reads them), beside the host time of the kernel's launch call: the
    event times of the row hold each call's host work as well."""
    import torch
    from ompi_tpu_torch.tools.ring_probe import profile

    x = random_rank_major((1, GIB // 4), torch.float32, gen)
    seg = pr._chunked_layout(GIB // 4, 1, torch.float32, MIB)[1] * pr.LANES
    split = profile(lambda: pr.selfdma_chunked(x, seg),
                    kernel="selfdma_chunked")
    row["device_ms"] = device_ms(split)
    row["launch_call_host_ms"] = split["launch call host"]
    row["library_device_ms"] = device_ms(profile(lambda: x.clone(),
                                                 kernel="no such kernel"))
    del x
    torch.cuda.empty_cache()
    log(f"[time] selfdma_chunked device time (torch.profiler, p50 of 20 "
        f"calls): {row['device_ms']:.5f} ms, x.clone() "
        f"{row['library_device_ms']:.5f} ms; the launch call "
        f"{row['launch_call_host_ms']:.5f} ms on the host")
    return (f"; on the card {row['device_ms']:.5f} ms, clone "
            f"{row['library_device_ms']:.5f} ms")


def ring_split(pr, gen, row) -> str:
    """The ring's host/device split at its main-path size, from
    ``torch.profiler`` as ``tools/ring_probe.py`` reads it: the kernel's
    device time, the host time of one call and the gap from a call's
    start to the kernel's start, each a p50 over 20 calls (the card idle
    before each). Adds them to ``row``; returns the log text."""
    import torch
    from ompi_tpu_torch.tools.ring_probe import profile

    x = random_rank_major((N, MAIN_SIZES["ring_allreduce"] // 4),
                          torch.float32, gen)
    inp, _, _ = pr._split_ring(x)
    split = profile(lambda: pr.ring_allreduce(inp, "sum"))
    if "kernel device" not in split:
        raise AssertionError(f"ring_allreduce: the profiler saw no device "
                             f"time ({split})")
    row["device_ms"] = split["kernel device"]
    row["call_host_ms"] = split["call host"]
    row["call_to_kernel_ms"] = split["call start to kernel start"]
    log(f"[time] ring_allreduce host/device split (torch.profiler, p50 of "
        f"20 calls): kernel {row['device_ms']:.5f} ms on the card, call "
        f"{row['call_host_ms']:.5f} ms on the host, call start to kernel "
        f"start {row['call_to_kernel_ms']:.5f} ms")
    return (f"; kernel {row['device_ms']:.5f} ms on the card, call start to "
            f"kernel start {row['call_to_kernel_ms']:.5f} ms")


def rd_split(pr, gen, row) -> str:
    """Recursive doubling at its main-path size: the form its timed
    launches ran (``row["plan"]``), its host/device split from
    ``torch.profiler`` as ``ring_split`` reads it, and the floor that the
    host sets, an empty kernel launched as that form is
    (``tools/gather_rd_check.py``), timed as the row is. Adds them to
    ``row``; returns the log text."""
    import torch
    from ompi_tpu_torch.tools.gather_rd_check import empty_launch
    from ompi_tpu_torch.tools.ring_probe import profile

    x = random_rank_major((N, MAIN_SIZES["ring_allreduce_rd"] // 4),
                          torch.float32, gen)
    split = profile(lambda: pr.ring_allreduce_rd(x, "sum"),
                    kernel="ring_allreduce_rd")
    if "kernel device" not in split:
        raise AssertionError(f"ring_allreduce_rd: the profiler saw no device "
                             f"time ({split})")
    plan = row["plan"]
    row["form"] = plan["form"]
    row["device_ms"] = split["kernel device"]
    row["call_host_ms"] = split["call host"]
    row["call_to_kernel_ms"] = split["call start to kernel start"]
    cluster = plan["form"] == "cluster"
    sv = x.shape[1] * 4 // 16 // plan["stripes"]
    row["empty_launch_ms"] = p50_ms(empty_launch(
        x, cluster, plan["stripes"], plan["threads"],
        16 * (1 + 3 * sv) if cluster else 0), KERNEL_REPS)
    log(f"[time] ring_allreduce_rd in its {plan['form']} form "
        f"(torch.profiler, p50 of 20 calls): kernel {row['device_ms']:.5f} "
        f"ms on the card, call {row['call_host_ms']:.5f} ms on the host, "
        f"call start to kernel start {row['call_to_kernel_ms']:.5f} ms; an "
        f"empty launch of that form {row['empty_launch_ms']:.5f} ms")
    return (f"; {plan['form']} form, kernel {row['device_ms']:.5f} ms on the "
            f"card, empty launch {row['empty_launch_ms']:.5f} ms")


def hop_split(pr, x, row) -> None:
    """The ring hop at its main-path size: the plan its timed launches
    ran, its device time from ``torch.profiler`` beside that of
    ``x.clone()`` (a device-to-device memcpy of the same bytes), and an
    empty kernel launched as its form is (``tools/gather_rd_check.py``),
    timed as the row is. Adds them to ``row``, each printed on a line of
    its own."""
    from ompi_tpu_torch.tools.gather_rd_check import empty_launch
    from ompi_tpu_torch.tools.ring_probe import profile

    pr.ppermute_shift(x, 1)
    plan = row["plan"] = dict(pr.PPERMUTE.last_plan)
    split = profile(lambda: pr.ppermute_shift(x, 1), kernel="ppermute_shift")
    if "kernel device" not in split:
        raise AssertionError(f"ppermute_shift: the profiler saw no device "
                             f"time ({split})")
    row["device_ms"] = split["kernel device"]
    row["memcpy_device_ms"] = device_ms(profile(lambda: x.clone(),
                                                kernel="no such kernel"))
    cluster = plan["form"] == "cluster"
    smem = 128 + 4 * plan["piece_bytes"] if plan["piece_bytes"] else 0
    row["empty_launch_ms"] = p50_ms(empty_launch(
        x, cluster, plan["stripes"], plan["threads"], smem), KERNEL_REPS)
    log(f"[plan] ppermute_shift at {HOP_BYTES} B/rank: {plan}")
    log(f"[time] ppermute_shift device time (torch.profiler, p50 of 20 "
        f"calls): {row['device_ms']:.5f} ms")
    log(f"[time] ppermute_shift memcpy of the same bytes (x.clone(), "
        f"torch.profiler): {row['memcpy_device_ms']:.5f} ms on the card")
    log(f"[time] ppermute_shift empty launch of its form: "
        f"{row['empty_launch_ms']:.5f} ms")


def attn_flops(causal: bool) -> float:
    """Operations of attention over the whole sequence: 4 S^2 H Dh, or
    the causal half with its diagonal, 4 H Dh S(S+1)/2."""
    s, h, dh = ATTN_SEQ, ATTN_HEADS, ATTN_HEAD_DIM
    return 4 * h * dh * (s * (s + 1) / 2 if causal else s * s)


def attn_rows(gen, errs, launches) -> list:
    """The kernels-line rows of ppermute_shift (8 MiB per rank, shift 1;
    4 KiB in small_ms) and ring_attention (bfloat16 causal; the other
    three cases in "also"), with their bounds, plain and library times."""
    import torch
    import torch.nn.functional as F
    from ompi_tpu_torch.coll import pallas_attn as pa
    from ompi_tpu_torch.coll import pallas_ring as pr

    x = random_rank_major((N, HOP_BYTES // 2), torch.bfloat16, gen)
    small = random_rank_major((N, 2 * KIB), torch.bfloat16, gen)
    hop = {
        "name": "ppermute_shift", "route": "cuda",
        "source": "ompi_tpu_torch/csrc/ppermute_shift.cu",
        "replaces": SOURCES["ppermute_shift"],
        "launches": launches["ppermute_shift"],
        "launches_note": "its own phase: no other main-path call reaches it",
        "max_abs_err": errs["ppermute_shift"],
        "ms": p50_ms(lambda: pr.ppermute_shift(x, 1), KERNEL_REPS),
        "plain_ms": p50_ms(lambda: pr.ppermute_shift_plain(x, 1), 10),
        "bound_ms": 2 * N * HOP_BYTES / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": p50_ms(lambda: torch.roll(x, 1, 0).contiguous(),
                             KERNEL_REPS),
        "bytes_per_rank": HOP_BYTES, "nranks": N, "dtype": "bfloat16",
        "op": None,
        "small_ms": p50_ms(lambda: pr.ppermute_shift(small, 1), KERNEL_REPS),
        "small_bytes_per_rank": 4 * KIB,
        "small_bound_ms": 2 * N * 4 * KIB / HBM_BYTES_PER_S * 1e3,
    }
    log(f"[time] ppermute_shift: {hop['ms']:.4f} ms p50 at {HOP_BYTES} "
        f"B/rank (bound {hop['bound_ms']:.5f} ms, plain "
        f"{hop['plain_ms']:.3f} ms, library {hop['library_ms']:.4f} ms), "
        f"{hop['small_ms']:.4f} ms at {4 * KIB} B/rank")
    hop_split(pr, x, hop)
    del x, small

    cases = []
    for dtype, causal in ATTN_CASES:
        q, k, v, _ = ATTN_OUT[dtype, causal]
        # the same sequence on one rank: every block folds, no ring
        q1, k1, v1 = (t.reshape(1, ATTN_SEQ, ATTN_HEADS, ATTN_HEAD_DIM)
                      for t in (q, k, v))
        within(pa.ring_attention_block(q1, k1, v1, causal),
               pa.ring_attention_block_plain(q1, k1, v1, causal),
               ATTN_TOL[dtype], f"ring_attention n=1 {dtype} {causal}")
        itemsize = q.element_size()
        nbytes = 4 * q.numel() * itemsize  # q, k, v read, out written
        flops = attn_flops(causal)
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = flops / PEAK_FLOPS[dtype] * 1e3
        # the library yardstick on (1, H, S, Dh); the port never calls it
        lq, lk, lv = (t.reshape(ATTN_SEQ, ATTN_HEADS, ATTN_HEAD_DIM)
                      .transpose(0, 1).unsqueeze(0).contiguous()
                      for t in (q, k, v))
        case = {
            "dtype": dtype, "causal": causal,
            "ms": p50_ms(lambda: pa.ring_attention_block(q, k, v, causal),
                         KERNEL_REPS),
            "plain_ms": p50_ms(
                lambda: pa.ring_attention_block_plain(q, k, v, causal), 3),
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "operations" if op_ms >= byte_ms else "bytes",
            "library_ms": p50_ms(lambda: F.scaled_dot_product_attention(
                lq, lk, lv, is_causal=causal), KERNEL_REPS),
            "flops": flops, "bytes": nbytes,
            "n1_ms": p50_ms(lambda: pa.ring_attention_block(q1, k1, v1,
                                                            causal),
                            KERNEL_REPS),
        }
        case["tflops_per_s"] = flops / case["ms"] / 1e9
        cases.append(case)
        log(f"[time] ring_attention {dtype} causal={causal}: "
            f"{case['ms']:.4f} ms p50 (bound {case['bound_ms']:.4f} ms by "
            f"{case['bound_by']}, plain {case['plain_ms']:.3f} ms, SDPA "
            f"{case['library_ms']:.4f} ms, {case['tflops_per_s']:.2f} "
            f"TFLOP/s); n = 1 (no ring) {case['n1_ms']:.4f} ms")
        del lq, lk, lv, q1, k1, v1
    for case in cases:
        if case["causal"]:
            other = cases[ATTN_CASES.index((case["dtype"], False))]
            case["causal_over_noncausal"] = case["ms"] / other["ms"]
            log(f"[time] ring_attention {case['dtype']}: causal / "
                f"non-causal {case['causal_over_noncausal']:.4f}")
    main = cases[ATTN_CASES.index(ATTN_MAIN)]
    attn = {
        "name": "ring_attention", "route": "cuda",
        "source": "ompi_tpu_torch/csrc/ring_attention.cu",
        "replaces": SOURCES["ring_attention"],
        "launches": launches["ring_attention"],
        "max_abs_err": errs["ring_attention"],
        **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "n1_ms",
                                "causal_over_noncausal")},
        "nranks": N, "tokens_per_rank": ATTN_T, "heads": ATTN_HEADS,
        "head_dim": ATTN_HEAD_DIM, "dtype": ATTN_MAIN[0],
        "causal": ATTN_MAIN[1], "op": None,
        "tflops_per_s": main["tflops_per_s"],
        "also": [c for c in cases if c is not main],
    }
    return [hop, attn]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script runs only on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import ompi_tpu_torch as tt
    from ompi_tpu_torch.coll import pallas_ring as pr
    from ompi_tpu_torch.core import build, config

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    CARD[0] = smi.splitlines()[0]
    log(CARD[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.time()
    build.build(list(SOURCES))
    log(f"[build] {len(SOURCES)} kernels in {time.time() - t0:.1f} s "
        f"(parallel nvcc)")
    for name in SOURCES:
        # ptxas prints one "Used N registers" and one "spill" line per
        # instantiation (ops x dtypes): print each distinct one once.
        seen: dict[str, int] = {}
        for line in build.BUILD_LOGS[name].splitlines():
            text = line.replace("ptxas info    :", "").strip()
            if any(w in line for w in ("Used", "spill", "error", "warning")):
                seen[text] = seen.get(text, 0) + 1
        for text, count in seen.items():
            log(f"[build] {name}: {text} (x{count})")

    gen = torch.Generator(device="cuda").manual_seed(0)
    kernel_vs_plain(pr, gen)
    sched_kernel_vs_plain(pr, gen)
    quant_kernel_vs_plain(gen)
    hop_err = hop_kernel_vs_plain(gen)
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[attn] torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32} (the plain version's f32 "
        f"products in full f32)")
    attn_errs = attn_kernel_vs_plain(gen)
    attn_errs["ppermute_shift"] = hop_err
    model_attention_check(gen)
    torch.cuda.reset_peak_memory_stats()
    errs, launches = main_path(tt, pr, config)
    errs.update(attn_errs)
    log(f"[main] launches on the main path: {launches}")
    log(f"[memory] max_memory_allocated {PEAK[0]} bytes")
    rows = measure(pr, gen, errs, launches) + attn_rows(gen, errs, launches)
    for row in rows:
        if row["name"] == "ring_attention":
            row["also"].append(dict(MODEL_ATTN))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
