#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ompi_tpu_torch``) on one NVIDIA H100.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and the repository's ``ompi_tpu_torch`` package;
without a card, or without the package beside it, it exits non-zero
and prints no result.

The eleven kernels (``ompi_tpu_torch/csrc/``): ``ring_allreduce``,
``ring_allreduce_rd``, ``ring_allreduce_chunked``,
``ring_reduce_scatter``, ``ring_allgather``, ``tree_reduce``,
``tree_bcast``, ``ring_allreduce_bidir``, ``ring_alltoall``,
``linear_gather`` and ``linear_scatter``.

Phases (any failure raises and exits non-zero):

1. The card's name and power limit, then a parallel build of every
   kernel from ``ompi_tpu_torch/csrc/`` (one ``nvcc`` per source, all
   started together) with the compiler's register and spill report.
2. Each kernel against its plain version (the protocol simulator), on
   the card, bitwise, at small and ragged sizes, every flag back at 0:
   the allreduce kernels for int32/float32/bfloat16 x
   sum/max/min/prod (ring and chunked at n in {2, 3, 8}, recursive
   doubling at n in {2, 8}, the bidirectional ring at n in {2, 3, 8});
   reduce-scatter and tree reduce likewise at n in {2, 3, 8} (the trees
   at roots 0 and n-1); allgather, tree bcast, alltoall, gather and
   scatter for the three dtypes (gather, scatter and bcast at roots 0
   and n-1), and the three data movers for float64, float16 and int8
   at odd row widths (their element-sized copies).
3. The main path at full width, n = 8, through ``init(nranks=8)`` and
   two vtable routes: a ``world.dup()`` with
   ``coll_pallas_priority=100`` (PallasColl) and one with TunedColl and
   ``coll_tuned_<op>_algorithm`` forcing each kernel's name. Launch
   counters are zeroed just before and read just after; every kernel
   must have launched, and every result must equal its plain version.
   - ``comm.allreduce(x, "sum")``, float32, at 4 KiB (recursive
     doubling), 1 MiB (ring) and 1 GiB (chunked, an 8 GiB rank-major
     buffer) per rank;
   - ``comm.bcast``, float32, root 3; ``comm.reduce``, int32 MAX, root
     5; ``comm.reduce_scatter_block``, float32 SUM, ``(8, 8, 32 Mi)``
     elements (1 GiB sent per rank); ``comm.allgather``, float32,
     128 MiB sent (1 GiB received) per rank; each also at 4 KiB per
     rank, the latency regime. Each result is also checked against a
     reduction PyTorch computes on its own (row copies, ``amax``,
     ``sum`` to 1e-5);
   - ``comm.allreduce`` with ``pallas_rsag`` (reduce-scatter then
     allgather) at 1 MiB per rank, bitwise equal to ``pallas_ring``;
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
   Each case frees its input, output and plain result before the next;
   ``max_memory_allocated`` is printed.
4. A ``kernels`` JSON line, one row per kernel at its main-path size:
   launches on the main path, max |kernel - plain|, p50 time of the
   kernel's wrapper over 20 launches (CUDA events, after warm-up), the
   plain version's time, the bytes bound over 3.35 TB/s (each input
   byte read once, each output byte written once) and the time of one
   PyTorch call computing the same function as a library yardstick the
   port never calls. The kernels of the rooted, half-ring and
   data-movement collectives also carry their p50 at 4 KiB per rank
   (``small_ms``).
5. The last line: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
KERNEL_REPS = 20
GIB, MIB, KIB = 1 << 30, 1 << 20, 1 << 10
N = 8
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
}


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
    import torch

    if not dtype.is_floating_point:
        return torch.randint(-100, 100, shape, generator=gen, device="cuda",
                             dtype=torch.int32).to(dtype)
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


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


def kernel_vs_plain(pr, gen) -> None:
    import torch

    seg_elems = MIB // 4
    sizes = (33, 1000, seg_elems - 1, seg_elems + 1)
    coll_sizes = (33, 1000, 70001)  # per block (RS) or per rank (others)

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
            for dtype in (torch.int32, torch.float32, torch.bfloat16):
                for op in ("sum", "max", "min", "prod") if reduces else (None,):
                    for elems in (sizes if name in MAIN_SIZES
                                  else coll_sizes):
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
        log(f"[kernel-vs-plain] {name}: {checked} cases bitwise equal, "
            f"all semaphores 0 ({time.time() - t0:.1f} s)")

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
    log(f"[kernel-vs-plain] data movers at other element sizes: {checked} "
        f"cases bitwise equal, all semaphores 0 ({time.time() - t0:.1f} s)")


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
    return errs


def coll_input(kernel, nbytes, gen):
    """The main path's input of a rooted or half-ring collective at
    ``nbytes`` per rank (sent for reduce-scatter, received for
    allgather)."""
    import torch

    if kernel == "tree_reduce":
        return random_rank_major((N, nbytes // 4), torch.int32, gen)
    if kernel == "ring_reduce_scatter":
        return random_rank_major((N, N, nbytes // 4 // N), torch.float32, gen)
    if kernel == "ring_allgather":
        return random_rank_major((N, nbytes // 4 // N), torch.float32, gen)
    return random_rank_major((N, nbytes // 4), torch.float32, gen)


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
    # in the ring's order, so they equal pallas_ring bit for bit.
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


def main_path(tt, pr, config) -> tuple[dict, dict]:
    """Both vtable routes at full size; returns (kernel -> max error,
    kernel -> launches on the main path)."""
    import torch
    from ompi_tpu_torch.core import counters

    gen = torch.Generator(device="cuda").manual_seed(1)
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

    counters.reset_launches()
    errs = allreduce_path(pcomm, tcomm, pr, config, counters, gen)
    errs.update(coll_path(pcomm, tcomm, pr, config, counters, gen))
    errs["ring_allreduce_bidir"] = bidir_path(pcomm, tcomm, pr, config,
                                              counters, gen)
    errs.update(move_path(pcomm, tcomm, pr, config, counters, gen))
    launches = counters.launches()
    for kernel in SOURCES:
        if launches.get(kernel, 0) < 1:
            raise AssertionError(f"main path never launched {kernel}")
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


def timed_case(pr, kernel, nbytes, gen):
    """(kernel call, plain call, library call, bound bytes, dtype, op) at
    ``nbytes`` per rank, on the kernel's own layout."""
    import torch

    n = N
    if kernel in MAIN_SIZES:
        x = random_rank_major((n, nbytes // 4), torch.float32, gen)
        if kernel == "ring_allreduce_rd":
            inp = x
            fn = lambda: pr.ring_allreduce_rd(inp, "sum")  # noqa: E731
            plain = lambda: pr.ring_allreduce_rd_plain(inp, "sum")  # noqa: E731
        elif kernel == "ring_allreduce":
            inp, _, _ = pr._split_ring(x)
            fn = lambda: pr.ring_allreduce(inp, "sum")  # noqa: E731
            plain = lambda: pr.ring_allreduce_plain(inp, "sum")  # noqa: E731
        else:
            rows_, seg_rows = pr._chunked_layout(nbytes // 4, n,
                                                 torch.float32, MIB)
            inp = x.reshape(n, n, rows_ * pr.LANES)
            seg = seg_rows * pr.LANES
            fn = lambda: pr.ring_allreduce_chunked(inp, "sum", seg)  # noqa: E731
            plain = lambda: pr.ring_allreduce_chunked_plain(  # noqa: E731
                inp, "sum", seg)
        library = lambda: x.sum(0, keepdim=True).expand_as(x).contiguous()  # noqa: E731
        return fn, plain, library, 2 * n * nbytes, "float32", "sum"
    if kernel == "ring_allreduce_bidir":
        x = random_rank_major((n, nbytes // 4), torch.float32, gen)
        inp, _, _ = pr._split_ring(x)  # 1 MiB: blocks of 256-lane multiples
        return (lambda: pr.ring_allreduce_bidir(inp, "sum"),
                lambda: pr.ring_allreduce_bidir_plain(inp, "sum"),
                lambda: x.sum(0, keepdim=True).expand_as(x).contiguous(),
                2 * n * nbytes, "float32", "sum")
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
    x = coll_input(kernel, nbytes, gen)  # sizes are multiples of 128 lanes
    if kernel == "tree_bcast":
        return (lambda: pr.tree_bcast(x, BCAST_ROOT),
                lambda: pr.tree_bcast_plain(x, BCAST_ROOT),
                lambda: x[BCAST_ROOT].expand_as(x).contiguous(),
                nbytes + n * nbytes, "float32", None)
    if kernel == "tree_reduce":
        return (lambda: pr.tree_reduce(x, "max", REDUCE_ROOT),
                lambda: pr.tree_reduce_plain(x, "max", REDUCE_ROOT),
                lambda: x.amax(0), n * nbytes + nbytes, "int32", "max")
    if kernel == "ring_reduce_scatter":
        return (lambda: pr.ring_reduce_scatter(x, "sum"),
                lambda: pr.ring_reduce_scatter_plain(x, "sum"),
                lambda: x.sum(0), n * nbytes + nbytes, "float32", "sum")
    return (lambda: pr.ring_allgather(x),
            lambda: pr.ring_allgather_plain(x),
            lambda: x.unsqueeze(0).expand((n,) + tuple(x.shape)).contiguous(),
            nbytes + n * nbytes, "float32", None)


def measure(pr, gen, errs, launches) -> list:
    import torch

    rows = []
    sizes = dict(MAIN_SIZES, **{k: GIB for k in COLL_CASES},
                 ring_allreduce_bidir=BIDIR_BYTES,
                 **{k: GIB for k in MOVE_CASES})
    for kernel, nbytes in sizes.items():
        fn, plain, library, nbytes_moved, dtype, op = timed_case(
            pr, kernel, nbytes, gen)
        ms = p50_ms(fn, KERNEL_REPS)
        plain_ms = p50_ms(plain, 3 if nbytes >= GIB else 10)
        library_ms = p50_ms(library, KERNEL_REPS)
        bound_ms = nbytes_moved / HBM_BYTES_PER_S * 1e3
        row = {
            "name": kernel, "route": "cuda",
            "source": f"ompi_tpu_torch/csrc/{kernel}.cu",
            "replaces": SOURCES[kernel], "launches": launches[kernel],
            "max_abs_err": errs[kernel], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms, "bytes_per_rank": nbytes,
            "nranks": N, "dtype": dtype, "op": op,
        }
        del fn, plain, library
        torch.cuda.empty_cache()
        extra = ""
        if kernel in COLL_CASES or kernel in MOVE_CASES:
            fn, _, _, _, _, _ = timed_case(pr, kernel, 4 * KIB, gen)
            row["small_ms"] = p50_ms(fn, KERNEL_REPS)
            extra = f", {row['small_ms']:.4f} ms at 4 KiB/rank"
            del fn
        rows.append(row)
        log(f"[time] {kernel}: {ms:.4f} ms p50 at {nbytes} B/rank (bound "
            f"{bound_ms:.4f} ms, plain {plain_ms:.3f} ms, library "
            f"{library_ms:.4f} ms){extra}")
        torch.cuda.empty_cache()
    return rows


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
    log(smi.splitlines()[0])
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
    torch.cuda.reset_peak_memory_stats()
    errs, launches = main_path(tt, pr, config)
    log(f"[main] launches on the main path: {launches}")
    log(f"[memory] max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes")
    rows = measure(pr, gen, errs, launches)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
