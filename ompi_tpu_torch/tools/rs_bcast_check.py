"""Time the tree bcast's and the ring reduce-scatter's kernels on a CUDA
card at the main path's sizes, see where their blocks wait, and sweep
their launch shapes. Their correctness is held by ``chip_smoke.py`` and
the card tests of ``tests/test_torch_kernels.py``; this tool checks only
that what it times gives the right bits.

Run from the repository root on a machine with a card and ``nvcc``:
``python3 -m ompi_tpu_torch.tools.rs_bcast_check``. Prints the
compiler's register and spill lines; then at n = 8: the bcast at 1 GiB
per rank, float32, root 3, every row checked, the p50 of 20 launches
(CUDA events), its launch plan,
``x[root].expand_as(x).contiguous()``'s p50, the (n+1)B bound and the
extra peak device memory of one launch; the reduce-scatter at 1 GiB sent
per rank, float32 SUM, checked against its plain version, its p50 with
its buffers in shared memory and in L2, ``x.sum(0)``'s p50, the bound,
the plan it launched and how many clusters fit; both at 4 KiB
per rank with their ``torch.profiler`` split (as ``ring_probe.py`` reads
it), the reduce-scatter also at 1 MiB; from a probe build
(``-DOMPI_RING_PROBE``) of each at 1 GiB, the median block's span and
its time waiting at flags (the bcast per relative rank, the
reduce-scatter over all blocks, in either memory); a line ``bad N``.

``--sweep`` adds, configurations taken in turns over three rounds, the
median of rounds (ms): the bcast at 1 GiB per rank over segment bytes x
(threads per block, blocks per SM); the reduce-scatter at 1 GiB sent
over the buffers' memory (a cluster's shared memory, or L2) x
(threads, blocks per SM) x segment bytes
with the plan's stripes at that many blocks per SM (or as many clusters
as fit), the buffers' bytes beside each (in L2, above ``RS_SLOT_BYTES``
they no longer fit), and at 1 MiB and 4 KiB sent over the buffers'
memory x stripes x threads.
"""

import statistics
import subprocess
import sys
import time

import torch

from ompi_tpu_torch.coll import pallas_ring as pr
from ompi_tpu_torch.core import build
from ompi_tpu_torch.tools.ring_probe import PROBE, profile
from ompi_tpu_torch.tools.tree_check import data, p50

GIB, MIB, KIB = 1 << 30, 1 << 20, 1 << 10
HBM = 3.35e12  # bytes/s, H100 SXM data sheet
N, ROOT = 8, 3


def flags_left(counter) -> int:
    return int(counter.last_sems.abs().sum())


def probe(name: str, launch, groups: dict) -> None:
    """Launch ``launch(defines)`` once from the probe build of csrc/<name>.cu
    and print, per group of blocks (name -> block range), the median
    block's span (first stamp to last, ms) and its wait at flags (ms)."""
    lib = build.library(name, PROBE)
    lib.ompi_probe_set.argtypes = [pr.ctypes.c_void_p]
    blocks = max(b for _, b in groups.values())
    buf = torch.zeros((blocks, 64), dtype=torch.int64, device="cuda")
    lib.ompi_probe_set(buf.data_ptr())
    launch(PROBE)
    torch.cuda.synchronize()
    lib.ompi_probe_set(None)
    t = buf.cpu().double()
    for group, (a, b) in groups.items():
        span = float((t[a:b, 1] - t[a:b, 0]).median()) / 1e6
        wait = float(t[a:b, 2].median()) / 1e6
        print(f"probe {name} {group}: span {span:.4f} ms, waiting "
              f"{wait:.4f} ms ({100 * wait / span:.0f}%)", flush=True)


def in_turns(configs: dict, rounds: int = 3) -> None:
    """p50 (ms) of each named call, taken in turns over ``rounds``
    rounds; prints each one's median of rounds."""
    times: dict = {}
    for _ in range(rounds):
        for name, run in configs.items():
            times.setdefault(name, []).append(p50(run, 10))
    for name, t in times.items():
        print(f"sweep {name}: {statistics.median(t):.4f} ms (rounds "
              f"{[round(v, 4) for v in t]})", flush=True)


def sweep(x, blocks, small) -> None:
    want = pr.tree_bcast(x, ROOT)
    configs = {}
    for seg in (16 * KIB, 32 * KIB, 64 * KIB, 128 * KIB, 256 * KIB):
        for threads, per_sm in ((512, 2), (1024, 1), (256, 4), (512, 1)):
            run = (lambda seg=seg, threads=threads, per_sm=per_sm:
                   pr._bcast_launch(x, ROOT, seg, threads, per_sm))
            if not torch.equal(run(), want):
                raise AssertionError(f"bcast sweep {seg} {threads} {per_sm}")
            configs[f"bcast seg {seg} threads {threads} x {per_sm}/SM"] = run
    in_turns(configs)

    n, C = blocks.shape[0], blocks.shape[-1]
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    want = pr.ring_reduce_scatter(blocks, "sum")
    configs = {}
    for cluster in (True, False):
        for threads, per_sm in ((512, 1), (256, 2), (128, 4)):
            for seg in (2 * KIB, 4 * KIB, 8 * KIB, 16 * KIB):
                stripes = pr._stripes(n, C * 4, per_sm * sm, seg)
                if cluster:  # within shared memory, as many as fit
                    if (n - 2) * pr.RS_BUFS * seg > pr.RS_SMEM_BYTES:
                        continue
                    stripes = min(stripes, pr._clusters(
                        "ring_reduce_scatter", n, threads, seg, 0))
                run = (lambda stripes=stripes, threads=threads, seg=seg,
                       cluster=cluster: pr._rs_launch(
                           blocks, "sum", stripes, threads, seg, cluster))
                if not torch.equal(run(), want):
                    raise AssertionError(f"rs sweep {stripes} {threads} "
                                         f"{seg} {cluster}")
                slots = pr.RS.last_plan["buffer_bytes"]
                where = "shared memory" if cluster else "L2"
                configs[f"rs 1GiB {where} stripes {stripes} threads "
                        f"{threads} seg {seg} (buffers {slots} B)"] = run
    in_turns(configs)
    for sent, y in small.items():
        want = pr.ring_reduce_scatter(y, "sum")
        configs = {}
        for cluster in (True, False):
            for stripes in (1, 4, 8, 16):
                for threads in (256, 512):
                    run = (lambda y=y, stripes=stripes, threads=threads,
                           cluster=cluster: pr._rs_launch(
                               y, "sum", stripes, threads, cluster=cluster))
                    if not torch.equal(run(), want):
                        raise AssertionError(f"rs sweep {sent} {stripes}")
                    where = "shared memory" if cluster else "L2"
                    configs[f"rs {sent} {where} stripes {stripes} threads "
                            f"{threads}"] = run
        in_turns(configs)


def main() -> int:
    if not torch.cuda.is_available():
        print("rs_bcast_check: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    t0 = time.time()
    build.build(["tree_bcast", "ring_reduce_scatter"])
    print(f"build {time.time() - t0:.1f} s")
    for name in ("tree_bcast", "ring_reduce_scatter"):
        for line in build.BUILD_LOGS[name].splitlines():
            if any(w in line for w in ("Used", "spill", "error", "warning")):
                print(f"{name}: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    L = GIB // 4
    x = data((N, L), torch.float32, gen)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = pr.tree_bcast(x, ROOT)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ok = all(torch.equal(got[r], x[ROOT]) for r in range(N))
    ok = ok and flags_left(pr.TREE_BCAST) == 0
    bad += not ok
    del got
    ms = p50(lambda: pr.tree_bcast(x, ROOT))
    plan = pr.TREE_BCAST.last_plan
    per_rank = plan["blocks_per_rank"]
    lib = p50(lambda: x[ROOT].expand_as(x).contiguous())
    print(f"bcast 1 GiB/rank f32 root {ROOT}: rows equal {ok}; p50 {ms:.4f} "
          f"ms; library {lib:.4f} ms; bound (n+1)B "
          f"{(N + 1) * GIB / HBM * 1e3:.4f} ms, 2nB {2 * N * GIB / HBM * 1e3:.4f}"
          f" ms; plan {plan}; extra peak memory {peak} bytes", flush=True)
    probe("tree_bcast", lambda d: pr._bcast_launch(x, ROOT, defines=d),
          {f"rel {rel}": (rel * per_rank, (rel + 1) * per_rank)
           for rel in range(N)})
    del x
    torch.cuda.empty_cache()

    C = GIB // 4 // N
    blocks = data((N, N, C), torch.float32, gen)
    got = pr.ring_reduce_scatter(blocks, "sum")
    torch.cuda.synchronize()
    ok = torch.equal(got, pr.ring_reduce_scatter_plain(blocks, "sum"))
    ok = ok and flags_left(pr.RS) == 0
    bad += not ok
    del got
    for cluster in (True, False):
        run = lambda: pr._rs_launch(blocks, "sum", cluster=cluster)  # noqa: E731
        ms = p50(run)
        plan = pr.RS.last_plan
        fits = ""
        if cluster:  # the launch takes as many stripes as clusters fit
            clusters = pr._clusters("ring_reduce_scatter", N,
                                    plan["threads"], plan["segment_bytes"], 0)
            fits = f" ({clusters} clusters fit)"
        lib = p50(lambda: blocks.sum(0))
        where = "shared memory" if cluster else "L2"
        print(f"rs 1 GiB sent/rank f32 sum, buffers in {where}: equal {ok}; "
              f"p50 {ms:.4f} ms; x.sum(0) {lib:.4f} ms; bound (n+1)B "
              f"{(N + 1) * GIB / HBM * 1e3:.4f} ms; plan {plan}{fits}",
              flush=True)
        probe("ring_reduce_scatter",
              lambda d: pr._rs_launch(blocks, "sum", cluster=cluster,
                                      defines=d),
              {f"{where}, all blocks": (0, N * plan["stripes"])})

    small = {"1MiB": data((N, N, MIB // 4 // N), torch.float32, gen),
             "4KiB": data((N, N, KIB // N), torch.float32, gen)}
    for sent, y in small.items():
        ms = p50(lambda: pr.ring_reduce_scatter(y, "sum"))
        print(f"rs {sent} sent/rank p50 {ms:.5f} ms; x.sum(0) "
              f"{p50(lambda: y.sum(0)):.5f} ms; plan {pr.RS.last_plan}",
              flush=True)
    xs = data((N, KIB), torch.float32, gen)
    print(f"bcast 4 KiB/rank p50 "
          f"{p50(lambda: pr.tree_bcast(xs, ROOT)):.5f} ms", flush=True)
    for name, run in (("tree_bcast", lambda: pr.tree_bcast(xs, ROOT)),
                      ("ring_reduce_scatter",
                       lambda: pr.ring_reduce_scatter(small["4KiB"], "sum"))):
        for k, v in profile(run, name,
                            f"_archive/traces/{name}_trace.json").items():
            print(f"{name} 4 KiB profiler {k}: {v:.5f} ms", flush=True)
    if "--sweep" in sys.argv:
        x = data((N, L), torch.float32, gen)
        sweep(x, blocks, small)
    print(f"bad {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
