"""Time the bidirectional ring's and the table kernel's kernels on a CUDA
card at the main path's sizes, see where their blocks wait, and sweep
their launch shapes. Their correctness is held by ``chip_smoke.py`` and
the card tests of ``tests/test_torch_kernels.py``; this tool checks only
that what it times gives the right bits.

Run from the repository root on a machine with a card and ``nvcc``:
``python3 -m ompi_tpu_torch.tools.bidir_table_check``. Prints the
compiler's register and spill lines; then at n = 8, float32 SUM: the
bidirectional ring at 1 MiB per rank (``_split_ring``'s blocks), checked
against its plain version, the p50 of 20 launches (CUDA events), the
plan it launched, the library call's p50 and the 2nB bound, its
``torch.profiler`` split (as ``ring_probe.py`` reads it) and, from a
probe build (``-DOMPI_RING_PROBE``), the median block's span and the
share of it spent waiting before its steps; the table kernel on the
registered programs behind ``sched_pallas_ring_seg`` at 1 GiB per rank,
``sched_pallas_rs`` at 1 GiB sent per rank and ``sched_pallas_ring`` at
1 MiB per rank, checked against its plain version, its p50 with its
buffers in a cluster's shared memory and in L2, the library call and
the bound, the plan and how many clusters fit, and from a probe build
the median block's span and its time held at flags (the 1 MiB ring
also with its ``torch.profiler`` split); a line ``bad N``.

``--sweep`` adds, configurations taken in turns over three rounds, the
median of rounds (ms): the bidirectional ring at 1 MiB over stripes x
threads; the segmented program at 1 GiB over the buffers' memory x
(threads, blocks per SM) x segment bytes, with the plan's stripes at
that many blocks per SM (or as many clusters as fit) and the buffers'
bytes beside each; the ring program at 1 MiB over the buffers' memory x
stripes.
"""

import statistics
import subprocess
import sys
import time

import torch

from ompi_tpu_torch.coll import pallas_ring as pr
from ompi_tpu_torch.coll import sched as sched_mod
from ompi_tpu_torch.coll.sched import pallas_lower as pl
from ompi_tpu_torch.core import build
from ompi_tpu_torch.core.errors import KernelError
from ompi_tpu_torch.tools.ring_probe import PROBE, profile
from ompi_tpu_torch.tools.tree_check import data, p50

GIB, MIB, KIB = 1 << 30, 1 << 20, 1 << 10
HBM = 3.35e12  # bytes/s, H100 SXM data sheet
N = 8


def flags_left(counter) -> int:
    return int(counter.last_sems.abs().sum())


def stamps(name: str, launch, blocks: int) -> torch.Tensor:
    """Launch ``launch(defines)`` once from the probe build of
    csrc/<name>.cu and return its (blocks, 64) stamps in ns."""
    lib = build.library(name, PROBE)
    lib.ompi_probe_set.argtypes = [pr.ctypes.c_void_p]
    buf = torch.zeros((blocks, 64), dtype=torch.int64, device="cuda")
    lib.ompi_probe_set(buf.data_ptr())
    launch(PROBE)
    torch.cuda.synchronize()
    lib.ompi_probe_set(None)
    return buf.cpu().double()


def in_turns(configs: dict, rounds: int = 3) -> None:
    """p50 (ms) of each named call, taken in turns over ``rounds``
    rounds; prints each one's median of rounds."""
    times: dict = {}
    for _ in range(rounds):
        for name, run in configs.items():
            try:
                times.setdefault(name, []).append(p50(run, 10))
            except KernelError as e:  # a grid that stopped fitting
                print(f"sweep {name}: failed ({e})", flush=True)
    for name, t in times.items():
        print(f"sweep {name}: {statistics.median(t):.4f} ms (rounds "
              f"{[round(v, 4) for v in t]})", flush=True)


def program(algo: str, nbytes: int, gen):
    """(program, data) of a registered table program at nbytes per rank
    (sent, for the reduce-scatter), on its wrapper's layout."""
    prog = pl.analyze(sched_mod.build_schedule(algo, N))
    if algo == "sched_pallas_rs":
        return prog, data((N, N, nbytes // 4 // N), torch.float32, gen)
    x = data((N, nbytes // 4), torch.float32, gen)
    return prog, x.reshape(N, prog.nchunks, -1)


def bidir(gen) -> int:
    x = data((N, MIB // 4), torch.float32, gen)
    blocks, _, _ = pr._split_ring(x)
    got = pr.ring_allreduce_bidir(blocks, "sum")
    torch.cuda.synchronize()
    ok = torch.equal(got, pr.ring_allreduce_bidir_plain(blocks, "sum"))
    ok = ok and flags_left(pr.BIDIR) == 0
    ms = p50(lambda: pr.ring_allreduce_bidir(blocks, "sum"))
    plan = pr.BIDIR.last_plan
    lib = p50(lambda: x.sum(0, keepdim=True).expand_as(x).contiguous())
    print(f"bidir 1 MiB/rank f32 sum: equal {ok}; p50 {ms:.5f} ms; library "
          f"{lib:.5f} ms; bound 2nB {2 * N * MIB / HBM * 1e3:.6f} ms; plan "
          f"{plan}", flush=True)
    for k, v in profile(lambda: pr.ring_allreduce_bidir(blocks, "sum"),
                        "ring_allreduce_bidir",
                        "_archive/traces/bidir_trace.json").items():
        print(f"bidir 1 MiB profiler {k}: {v:.5f} ms", flush=True)
    # stamps 0 at entry, 1 + 2k before step k's pass, 2 + 2k after it
    t = stamps("ring_allreduce_bidir",
               lambda d: pr._bidir_launch(blocks, "sum", defines=d),
               plan["blocks"])
    steps = 2 * (N - 1)
    span = (t[:, 2 * steps] - t[:, 0]) / 1e6
    waits = sum(t[:, 1 + 2 * k] - t[:, 2 * k] for k in range(steps)) / 1e6
    print(f"probe bidir: median block span {float(span.median()):.5f} ms, "
          f"waiting {float(waits.median()):.5f} ms "
          f"({100 * float((waits / span).median()):.0f}%)", flush=True)
    return 0 if ok else 1


def table_case(algo: str, nbytes: int, gen) -> int:
    prog, d = program(algo, nbytes, gen)
    got = pl.sched_table(prog, d, "sum")
    torch.cuda.synchronize()
    ok = torch.equal(got, pl.sched_table_plain(prog, d, "sum"))
    ok = ok and flags_left(pl.SCHED_TABLE) == 0
    del got
    if algo == "sched_pallas_rs":
        lib = p50(lambda: d.sum(0))
        bound = (N + 1) * nbytes / HBM * 1e3
    else:
        flat = d.reshape(N, -1)
        lib = p50(lambda: flat.sum(0, keepdim=True).expand_as(flat)
                  .contiguous())
        bound = 2 * N * nbytes / HBM * 1e3
    if nbytes <= MIB:
        for k, v in profile(lambda: pl.sched_table(prog, d, "sum"),
                            "sched_table",
                            "_archive/traces/table_trace.json").items():
            print(f"table {algo} {nbytes} B/rank profiler {k}: {v:.5f} ms",
                  flush=True)
    for cluster in (True, False):
        run = lambda: pl._table_launch(prog, d, "sum", cluster=cluster)  # noqa: E731
        ms = p50(run)
        plan = pl.SCHED_TABLE.last_plan
        fits = ""
        if cluster:
            chained = max(length for _, length in pl._stages(prog)) - 1
            clusters = pl._table_clusters(N, plan["threads"],
                                          plan["segment_bytes"], chained, 0)
            fits = f" ({clusters} clusters fit)"
        print(f"table {algo} {nbytes} B/rank, buffers in {plan['buffers']}:"
              f" equal {ok}; p50 {ms:.5f} ms; library {lib:.5f} ms; bound "
              f"{bound:.5f} ms; plan {plan}{fits}", flush=True)
        # stamps 0 at entry, 1 at exit, 2 the ns held at flags
        t = stamps("sched_table",
                   lambda d_: pl._table_launch(prog, d, "sum",
                                               cluster=cluster, defines=d_),
                   N * plan["stripes"])
        span = (t[:, 1] - t[:, 0]) / 1e6
        wait = t[:, 2] / 1e6
        print(f"probe table {algo} in {plan['buffers']}: median block span "
              f"{float(span.median()):.5f} ms, waiting "
              f"{float(wait.median()):.5f} ms "
              f"({100 * float((wait / span).median()):.0f}%)", flush=True)
    return 0 if ok else 1


def checked(configs: dict, name: str, run, want) -> None:
    """Add ``run`` to the sweep if it launches (a grid that cannot be
    resident, or clusters that do not fit, are skipped) and gives
    ``want``'s bits."""
    try:
        got = run()
    except KernelError as e:
        print(f"sweep {name}: skipped ({e})", flush=True)
        return
    if not torch.equal(got, want):
        raise AssertionError(f"sweep {name}: wrong bits")
    configs[name] = run


def sweep(gen) -> None:
    x = data((N, MIB // 4), torch.float32, gen)
    blocks, _, _ = pr._split_ring(x)
    want = pr.ring_allreduce_bidir(blocks, "sum")
    configs: dict = {}
    for stripes in (2, 4, 6, 8, 12, 16):
        for threads in (128, 256, 512, 1024):
            checked(configs, f"bidir 1MiB stripes {stripes} threads "
                    f"{threads}", lambda stripes=stripes, threads=threads:
                    pr._bidir_launch(blocks, "sum", stripes, threads), want)
    in_turns(configs)

    sm = torch.cuda.get_device_properties(0).multi_processor_count
    prog, d = program("sched_pallas_ring_seg", GIB, gen)
    chained = max(length for _, length in pl._stages(prog)) - 1
    c_bytes = d.shape[2] * 4
    want = pl.sched_table(prog, d, "sum")
    configs = {}
    for cluster in (True, False):
        for threads, per_sm in ((512, 1), (256, 2), (128, 3), (128, 4)):
            for seg in (KIB, 2 * KIB, 4 * KIB, 8 * KIB):
                if seg > 16 * threads:  # a vector per thread and pass
                    continue
                stripes = pr._stripes(N, c_bytes, per_sm * sm, seg)
                buffers = N * stripes * pl.TABLE_BUFS * chained * seg
                if cluster:
                    if pl.TABLE_BUFS * chained * seg > 224 * KIB // per_sm:
                        continue
                    try:
                        stripes = min(stripes, pl._table_clusters(
                            N, threads, seg, chained, 0))
                    except KernelError as e:
                        print(f"sweep seg {threads} {seg}: no cluster fits "
                              f"({e})", flush=True)
                        continue
                    buffers = N * stripes * pl.TABLE_BUFS * chained * seg
                elif buffers > 64 * MIB:
                    continue
                where = "shared memory" if cluster else "L2"
                checked(configs, f"seg 1GiB {where} stripes {stripes} "
                        f"threads {threads} seg {seg} (buffers {buffers} B)",
                        lambda stripes=stripes, threads=threads, seg=seg,
                        cluster=cluster: pl._table_launch(
                            prog, d, "sum", stripes, threads, seg, cluster),
                        want)
    in_turns(configs)
    del d, want
    torch.cuda.empty_cache()
    prog, d = program("sched_pallas_ring", MIB, gen)
    want = pl.sched_table(prog, d, "sum")
    configs = {}
    for cluster in (True, False):
        for stripes in (4, 8, 16, 32, 64):
            where = "shared memory" if cluster else "L2"
            checked(configs, f"ring 1MiB {where} stripes {stripes}",
                    lambda stripes=stripes, cluster=cluster: pl._table_launch(
                        prog, d, "sum", stripes, cluster=cluster), want)
    in_turns(configs)


def main() -> int:
    if not torch.cuda.is_available():
        print("bidir_table_check: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    t0 = time.time()
    names = ["ring_allreduce_bidir", "sched_table"]
    build.build(names)
    print(f"build {time.time() - t0:.1f} s")
    for name in names:
        for line in build.BUILD_LOGS[name].splitlines():
            if any(w in line for w in ("Used", "spill", "error", "warning")):
                print(f"{name}: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = bidir(gen)
    for algo, nbytes in (("sched_pallas_ring_seg", GIB),
                         ("sched_pallas_rs", GIB),
                         ("sched_pallas_ring", MIB)):
        bad += table_case(algo, nbytes, gen)
        torch.cuda.empty_cache()
    if "--sweep" in sys.argv:
        sweep(gen)
    print(f"bad {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
