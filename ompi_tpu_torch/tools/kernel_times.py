"""Time the ring allreduce, the trees, the ring reduce-scatter and three
other rows through their wrappers, as ``chip_smoke.py`` times them, on a
CUDA card.

Run from the root of a checkout on a machine with a card and ``nvcc``:
``python3 -m ompi_tpu_torch.tools.kernel_times``. It uses only wrappers
the port has had since its early slices (``ring_allreduce``,
``tree_reduce``, ``tree_bcast``, ``ring_reduce_scatter``,
``_split_ring``, ``ring_allreduce_rd``, ``ppermute_shift``,
``linear_scatter``), so a copy of this file dropped
into an older checkout times that checkout's kernels: run the parent and
the change in turns (parent, change, change, parent) in one machine to
compare them. Prints one JSON line: the card's name, its power limit and
the p50 (ms, 20 launches between CUDA events, after two warm-ups) of
``ring_allreduce`` at 1 MiB per rank (float32 SUM), ``tree_reduce`` at
4 KiB and 1 GiB per rank (int32 MAX, root 5), ``tree_bcast`` at 4 KiB
and 1 GiB per rank (float32, root 3), ``ring_reduce_scatter`` at 4 KiB,
1 MiB and 1 GiB sent per rank (float32 SUM), ``ring_allreduce_rd`` at
4 KiB per rank (float32 SUM; timed first, and again after the 1 GiB
tree), ``ppermute_shift`` at 8 MiB per rank
(bfloat16, shift 1) and ``linear_scatter`` at 1 GiB per rank (root 5;
timed first, and again last), n = 8.
"""

import json
import statistics
import subprocess
import sys

import torch

from ompi_tpu_torch.coll import pallas_ring as pr

N, KIB, MIB, GIB = 8, 1 << 10, 1 << 20, 1 << 30


def p50(fn, reps=20):
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


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = torch.randn((N, GIB // 4), generator=gen, device="cuda")
    scatter_first = p50(lambda: pr.linear_scatter(rows, 5))
    del rows
    torch.cuda.empty_cache()
    small = torch.randn((N, KIB), generator=gen, device="cuda")
    rd_first = p50(lambda: pr.ring_allreduce_rd(small, "sum"))
    x = torch.randn((N, MIB // 4), generator=gen, device="cuda")
    blocks, _, _ = pr._split_ring(x)
    out = {"card": smi,
           "ring_allreduce_1MiB_ms": p50(
               lambda: pr.ring_allreduce(blocks, "sum"))}
    y = torch.randn((N, N, MIB // 4 // N), generator=gen, device="cuda")
    out["ring_reduce_scatter_1MiB_ms"] = p50(
        lambda: pr.ring_reduce_scatter(y, "sum"))
    for name, nbytes in (("4KiB", 4 * KIB), ("1GiB", GIB)):
        y = torch.randint(-100, 100, (N, nbytes // 4), generator=gen,
                          device="cuda", dtype=torch.int32)
        out[f"tree_reduce_{name}_ms"] = p50(
            lambda: pr.tree_reduce(y, "max", 5))
        del y
        y = torch.randn((N, nbytes // 4), generator=gen, device="cuda")
        out[f"tree_bcast_{name}_ms"] = p50(lambda: pr.tree_bcast(y, 3))
        y = y.reshape(N, N, -1)
        out[f"ring_reduce_scatter_{name}_ms"] = p50(
            lambda: pr.ring_reduce_scatter(y, "sum"))
        del y
        torch.cuda.empty_cache()
    out["ring_allreduce_rd_4KiB_ms"] = rd_first
    out["ring_allreduce_rd_4KiB_after_tree_ms"] = p50(
        lambda: pr.ring_allreduce_rd(small, "sum"))
    hop = torch.randn((N, 4 * MIB), generator=gen, device="cuda").to(
        torch.bfloat16)
    out["ppermute_shift_8MiB_ms"] = p50(lambda: pr.ppermute_shift(hop, 1))
    del hop
    rows = torch.randn((N, GIB // 4), generator=gen, device="cuda")
    out["linear_scatter_1GiB_first_ms"] = scatter_first
    out["linear_scatter_1GiB_ms"] = p50(lambda: pr.linear_scatter(rows, 5))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
