"""Build the tree reduce's kernel and hold it against its plain version
on a CUDA card, then time it at the main path's size.

Run from the repository root on a machine with a card and ``nvcc``:
``python3 -m ompi_tpu_torch.tools.tree_check``. Prints the compiler's
register and spill lines; the small cases (n in {2, 3, 8}, roots 0 and
n - 1, every op and dtype, at 5000 columns and at four segments with a
ragged tail), each bitwise against the plain version with every flag at
0; 50 back-to-back launches at n = 8, bitwise equal; then at 1 GiB per
rank, int32 MAX, root 5, n = 8 (``chip_smoke.py``'s reduce): the block
split, every row bitwise against ``tree_rows`` (the reference's fold
over whole rows), the p50 of 20 launches (CUDA events), ``x.amax(0)``'s
p50, the achieved bandwidth against the 2 n B floor of writing every
row, and the peak device memory of one launch; then, from a probe build
(``-DOMPI_RING_PROBE``), each relative rank's median block finish time
after the kernel's first block started and its median time waiting for
children; last the p50 at 4 KiB per rank with its profiler split (as
``ring_probe.py`` reads it) and a line ``bad N``.

``--sweep`` adds, at 1 GiB per rank, the p50 at segments of 8 Ki and
16 Ki columns under five block shapes (threads per block x blocks per
SM: 512 x 2, 256 x 4, 1024 x 1, 256 x 2, 512 x 1), the grid split by
bytes (2 + children rows per relative rank); configurations taken in
turns over three rounds, the median of rounds.
"""

import statistics
import subprocess
import sys
import time

import torch

from ompi_tpu_torch.coll import pallas_ring as pr
from ompi_tpu_torch.core import build
from ompi_tpu_torch.tools.ring_probe import PROBE, profile


GIB, KIB = 1 << 30, 1 << 10
HBM = 3.35e12  # bytes/s, H100 SXM data sheet
OPS = ("sum", "max", "min", "prod")
DTYPES = (torch.int32, torch.float32, torch.bfloat16)


def p50(fn, reps=20):
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


def tree_rows(x, op, root):
    """Every row of the tree reduce's output, whole rows at a time: rank
    me's row is x[me] folded with its children's rows, in round order."""
    op = pr.op_lookup(op)
    n = x.shape[0]
    out = torch.empty_like(x)
    for rel in reversed(range(n)):
        me = (rel + root) % n
        acc = x[me]
        for c in pr.tree_children(rel, n):
            acc = op.combine(acc, out[(c + root) % n])
        out[me] = acc
    return out


def data(shape, dtype, gen):
    if dtype == torch.int32:
        return torch.randint(-1000, 1000, shape, generator=gen,
                             device="cuda", dtype=torch.int32)
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def small_cases(gen) -> int:
    bad = 0
    cols = (5000, 3 * pr.TREE_SEG_COLS + 5000)  # the second: 4 segments
    for n in (2, 3, 8):
        for dtype in DTYPES:
            for L in cols:
                x = data((n, L), dtype, gen)
                for root in (0, n - 1):
                    for op in OPS:
                        got = pr.tree_reduce(x, op, root)
                        torch.cuda.synchronize()
                        left = int(pr.TREE_REDUCE.last_sems.abs().sum())
                        want = pr.tree_reduce_plain(x, op, root)
                        ok = torch.equal(got, want) and left == 0
                        if not ok:
                            bad += 1
                            print(f"BAD n={n} {dtype} L={L} root={root} "
                                  f"{op}: flags {left}", flush=True)
        print(f"small cases n={n} done", flush=True)
    x = data((8, 3 * pr.TREE_SEG_COLS + 5000), torch.float32, gen)
    first = pr.tree_reduce(x, "sum", 3)
    same = all(torch.equal(pr.tree_reduce(x, "sum", 3), first)
               for _ in range(50))
    print(f"50 launches bitwise equal: {same}", flush=True)
    return bad + (not same)


def probe(x, root) -> None:
    """Per relative rank: median block finish (ms after the first start)
    and median wait for children (ms), from the probe build."""
    lib = build.library("tree_reduce", PROBE)
    lib.ompi_probe_set.argtypes = [pr.ctypes.c_void_p]
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    buf = torch.zeros((pr.TREE_BLOCKS_PER_SM * sm, 64), dtype=torch.int64,
                      device="cuda")  # one row per block
    lib.ompi_probe_set(buf.data_ptr())
    n = x.shape[0]
    n_segs = -(-x.shape[1] // pr.TREE_SEG_COLS)
    counts = pr.tree_blocks(n, pr.TREE_BLOCKS_PER_SM * sm, n_segs)
    pr._tree_launch(x, "max", root, defines=PROBE)
    torch.cuda.synchronize()
    lib.ompi_probe_set(None)
    t = buf[:sum(counts)].cpu().double()
    t0 = t[:, 0].min()
    first = 0
    for rel, g in enumerate(counts):
        rows = t[first:first + g]
        first += g
        print(f"probe rel {rel} ({len(pr.tree_children(rel, n))} children, "
              f"{g} blocks): finish {float((rows[:, 1] - t0).median()) / 1e6:.4f}"
              f" ms (last {float((rows[:, 1] - t0).max()) / 1e6:.4f}), wait "
              f"{float(rows[:, 2].median()) / 1e6:.4f} ms", flush=True)


def sweep(x, root) -> None:
    """p50 (ms) per configuration (segment columns, threads per block,
    blocks per SM), the split by bytes, the configurations taken in turns
    over three rounds; prints each one's median of rounds."""
    n, L = x.shape
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    want = pr.tree_reduce(x, "max", root)
    configs = [(seg, threads, per_sm) for seg in (1 << 13, 1 << 14)
               for threads, per_sm in ((512, 2), (256, 4), (1024, 1),
                                       (256, 2), (512, 1))]
    times: dict = {}
    for _ in range(3):
        for seg, threads, per_sm in configs:
            counts = pr.tree_blocks(n, per_sm * sm, -(-L // seg))
            run = lambda: pr._tree_launch(  # noqa: E731
                x, "max", root, seg, counts, threads, per_sm)
            if not torch.equal(run(), want):
                raise AssertionError(f"sweep {seg} {threads} {per_sm}: wrong")
            times.setdefault((seg, threads, per_sm), []).append(p50(run, 10))
    for (seg, threads, per_sm), t in times.items():
        print(f"sweep seg {seg} threads {threads} x {per_sm} per SM: "
              f"{statistics.median(t):.4f} ms (rounds {t})", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("tree_check: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    t0 = time.time()
    build.build(["tree_reduce"])
    print(f"build {time.time() - t0:.1f} s")
    for line in build.BUILD_LOGS["tree_reduce"].splitlines():
        if any(w in line for w in ("Used", "spill", "error", "warning")):
            print(line.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = small_cases(gen)

    n, root, L = 8, 5, GIB // 4
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    n_segs = -(-L // pr.TREE_SEG_COLS)
    counts = pr.tree_blocks(n, pr.TREE_BLOCKS_PER_SM * sm, n_segs)
    print(f"split at n={n}: blocks per relative rank {counts} "
          f"(sum {sum(counts)}, {n_segs} segments)", flush=True)
    x = data((n, L), torch.int32, gen)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = pr.tree_reduce(x, "max", root)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ok = torch.equal(got, tree_rows(x, "max", root))
    ok = ok and torch.equal(got[root], x.amax(0))
    ok = ok and int(pr.TREE_REDUCE.last_sems.abs().sum()) == 0
    bad += not ok
    del got
    probe(x, root)
    ms = p50(lambda: pr.tree_reduce(x, "max", root))
    lib = p50(lambda: x.amax(0))
    floor = 2 * n * L * 4
    print(f"1 GiB/rank int32 max root {root}: rows equal {ok}; p50 "
          f"{ms:.4f} ms; x.amax(0) {lib:.4f} ms; bound (n+1)B "
          f"{(n + 1) * L * 4 / HBM * 1e3:.4f} ms; floor 2nB "
          f"{floor / HBM * 1e3:.4f} ms; {floor / ms / 1e6:.1f} GB/s of "
          f"the 2nB bytes; extra peak memory {peak} bytes", flush=True)
    if "--sweep" in sys.argv:
        sweep(x, root)
    del x
    torch.cuda.empty_cache()
    xs = data((n, KIB), torch.int32, gen)
    small = lambda: pr.tree_reduce(xs, "max", root)  # noqa: E731
    print(f"4 KiB/rank p50 {p50(small):.5f} ms", flush=True)
    for k, v in profile(small, "tree_reduce",
                        "_archive/traces/tree_probe_trace.json").items():
        print(f"4 KiB profiler {k}: {v:.5f} ms", flush=True)
    print(f"bad {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
