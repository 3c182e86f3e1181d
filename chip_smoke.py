#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ompi_tpu_torch``) on one NVIDIA H100.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and the repository's ``ompi_tpu_torch`` package;
without a card, or without the package beside it, it exits non-zero
and prints no result.

Phases (any failure raises and exits non-zero):

1. The card's name and power limit, then a parallel build of every
   kernel of the allreduce path from ``ompi_tpu_torch/csrc/`` with the
   compiler's register and shared-memory report.
2. Each kernel against its plain version (the protocol simulator), on
   the card, bitwise, for int32/float32/bfloat16 x sum/max/min/prod at
   small and ragged sizes: ring and chunked at n in {2, 3, 8},
   recursive doubling at n in {2, 8}. Every semaphore must end at 0.
3. The main path at full size: ``init(nranks=8)`` -> ``world.dup()``
   with ``coll_pallas_priority=100`` -> ``comm.allreduce(x, "sum")`` on
   float32 at 4 KiB (recursive doubling), 1 MiB (ring) and 1 GiB
   (chunked, an 8 GiB rank-major buffer) per rank, then the same three
   sizes through ``TunedColl`` with ``coll_tuned_allreduce_algorithm``
   forcing each kernel's name. Launch counters are zeroed just before
   and read just after; each result must equal the plain version.
4. A ``kernels`` JSON line: launches, max |kernel - plain|, p50 time of
   the kernel over 20 launches (CUDA events, after warm-up), the plain
   version's time, the bound (2 * n * bytes per rank over 3.35 TB/s:
   each input byte read once, each output byte written once) and the
   time of ``x.sum(0, keepdim=True).expand_as(x).contiguous()`` as a
   library yardstick the port never calls.
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
MAIN_SIZES = {  # kernel -> bytes per rank on the main path
    "ring_allreduce_rd": 4 << 10,
    "ring_allreduce": 1 << 20,
    "ring_allreduce_chunked": 1 << 30,
}
TUNED_NAMES = {
    "ring_allreduce_rd": "pallas_rd",
    "ring_allreduce": "pallas_ring",
    "ring_allreduce_chunked": "pallas_ring_chunked",
}
SOURCES = {
    "ring_allreduce": "ompi_tpu/coll/pallas_ring.py:219",
    "ring_allreduce_rd": "ompi_tpu/coll/pallas_ring.py:708",
    "ring_allreduce_chunked": "ompi_tpu/coll/pallas_ring.py:296",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def bits(t):
    import torch

    return t.view({torch.bfloat16: torch.int16}.get(t.dtype, torch.int32)) \
        if t.is_floating_point() else t


def max_abs_err(a, b) -> float:
    """max |a - b| in float64, one rank row at a time (a 1 GiB row is
    2 GiB in float64)."""
    err = 0.0
    for i in range(a.shape[0]):
        if a[i].numel():
            err = max(err, float((a[i].double() - b[i].double()).abs().max()))
    return err


def random_rank_major(n, elems, dtype, gen):
    import torch

    if dtype == torch.int32:
        return torch.randint(-1000, 1000, (n, elems), generator=gen,
                             device="cuda", dtype=torch.int32)
    return torch.randn((n, elems), generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def check_sems(counter) -> None:
    left = int(counter.last_sems.abs().sum())
    if left:
        raise AssertionError(f"{counter.name}: semaphores not back at 0 "
                             f"({left} left)")


def kernel_vs_plain(pr, gen) -> None:
    import torch

    seg_elems = (1 << 20) // 4
    sizes = (33, 1000, seg_elems - 1, seg_elems + 1)
    cases = [
        ("ring_allreduce", (2, 3, 8), lambda x, op, plain: pr.allreduce_block(
            x, op, **({"ring": pr.ring_allreduce_plain} if plain else {}))),
        ("ring_allreduce_chunked", (2, 3, 8),
         lambda x, op, plain: pr.allreduce_block_chunked(
             x, op, 1 << 20, **({"chunked": pr.ring_allreduce_chunked_plain}
                                if plain else {}))),
        ("ring_allreduce_rd", (2, 8), lambda x, op, plain:
         pr.allreduce_block_rd(
             x, op, **({"rd": pr.ring_allreduce_rd_plain} if plain else {}))),
    ]
    from ompi_tpu_torch.core.counters import KERNELS

    for name, ns, fn in cases:
        t0 = time.time()
        checked = 0
        for n in ns:
            for dtype in (torch.int32, torch.float32, torch.bfloat16):
                for op in ("sum", "max", "min", "prod"):
                    for elems in sizes:
                        x = random_rank_major(n, elems, dtype, gen)
                        got = fn(x, op, False)
                        torch.cuda.synchronize()
                        check_sems(KERNELS[name])
                        want = fn(x, op, True)
                        if not torch.equal(bits(got), bits(want)):
                            raise AssertionError(
                                f"{name} n={n} {dtype} {op} elems={elems}: "
                                f"kernel != plain (max err "
                                f"{max_abs_err(got, want)})")
                        checked += 1
        log(f"[kernel-vs-plain] {name}: {checked} cases bitwise equal, "
            f"all semaphores 0 ({time.time() - t0:.1f} s)")


def main_path(tt, pr, config, gen) -> tuple[dict, dict]:
    """Both vtable routes at full size; returns (kernel -> max error,
    kernel -> launches on the main path)."""
    import torch
    from ompi_tpu_torch.core import counters

    world = tt.init(nranks=8)
    n = world.size
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
        elems = MAIN_SIZES[kernel] // 4
        x = random_rank_major(n, elems, torch.float32, gen)
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
        err = max_abs_err(out, want)
        if not torch.equal(bits(out), bits(want)):
            raise AssertionError(f"{route} {kernel}: kernel != plain "
                                 f"(max err {err})")
        errs[kernel] = max(errs[kernel], err)
        log(f"[main] {route} {kernel}: {MAIN_SIZES[kernel]} B/rank x {n} "
            f"ranks, {dt * 1e3:.3f} ms host wall (first call), equal to "
            f"plain")
        del x, out, want
        torch.cuda.empty_cache()

    config.VARS.set("coll_pallas_priority", 100)
    pcomm = world.dup()
    if pcomm._coll["allreduce"][0].NAME != "pallas":
        raise AssertionError("pallas component not selected")
    config.VARS.set("coll_pallas_priority", 30)
    tcomm = world.dup()
    if tcomm._coll["allreduce"][0].NAME != "tuned":
        raise AssertionError("tuned component not selected")

    counters.reset_launches()
    for kernel in MAIN_SIZES:
        run(pcomm, kernel, "PallasColl")
    for kernel, algo in TUNED_NAMES.items():
        config.VARS.set("coll_tuned_allreduce_algorithm", algo)
        run(tcomm, kernel, f"TunedColl[{algo}]")
    config.VARS.set("coll_tuned_allreduce_algorithm", "")
    launches = counters.launches()
    for kernel in MAIN_SIZES:
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


def measure(pr, gen, errs, launches) -> list:
    import torch

    rows = []
    n = 8
    for kernel, nbytes in MAIN_SIZES.items():
        x = random_rank_major(n, nbytes // 4, torch.float32, gen)
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
                                                 torch.float32, 1 << 20)
            inp = x.reshape(n, n, rows_ * pr.LANES)
            seg = seg_rows * pr.LANES
            fn = lambda: pr.ring_allreduce_chunked(inp, "sum", seg)  # noqa: E731
            plain = lambda: pr.ring_allreduce_chunked_plain(  # noqa: E731
                inp, "sum", seg)
        ms = p50_ms(fn, KERNEL_REPS)
        plain_ms = p50_ms(plain, 3 if nbytes >= (1 << 30) else 10)
        library_ms = p50_ms(
            lambda: x.sum(0, keepdim=True).expand_as(x).contiguous(),
            KERNEL_REPS)
        bound_ms = 2 * n * nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({
            "name": kernel, "route": "cuda",
            "source": f"ompi_tpu_torch/csrc/{kernel}.cu",
            "replaces": SOURCES[kernel], "launches": launches[kernel],
            "max_abs_err": errs[kernel], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms, "bytes_per_rank": nbytes,
            "nranks": n, "dtype": "float32", "op": "sum",
        })
        log(f"[time] {kernel}: {ms:.4f} ms p50 (bound {bound_ms:.4f} ms, "
            f"plain {plain_ms:.3f} ms, library {library_ms:.4f} ms)")
        del x, inp
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
        # instantiation (4 ops x 3 dtypes): print each distinct one once.
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
    errs, launches = main_path(tt, pr, config, gen)
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
