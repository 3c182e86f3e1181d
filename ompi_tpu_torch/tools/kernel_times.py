"""Time every kernel of the port through its wrapper, as ``chip_smoke.py``
times it, on a CUDA card.

Run from the root of a checkout on a machine with a card and ``nvcc``:
``python3 -m ompi_tpu_torch.tools.kernel_times``. It uses only wrappers
the port has had since its early slices (``pallas_ring``'s kernel
wrappers and ``_split_ring``/``_chunked_layout``,
``pallas_lower.sched_table`` with ``sched.build_schedule``,
``quant.quant_allreduce``, ``pallas_attn.ring_attention_block``), so a
copy of this file dropped into an older checkout times that checkout's
kernels: run the parent and the change in turns (parent, change, change,
parent) in one machine to compare them. Prints one JSON line: the
card's name, its power limit and the p50 (ms, 20 launches between CUDA
events, after two warm-ups) of, at n = 8:

- ``linear_scatter`` at 1 GiB per rank (root 5) and ``x.clone()`` of
  root's buffer beside it, its library call (each timed first, and again
  last), and ``ring_allreduce_rd`` at 4 KiB per rank (float32 SUM; timed
  first, and again after the 1 GiB trees);
- ``ring_allreduce`` and ``ring_allreduce_bidir`` at 1 MiB per rank
  (float32 SUM, ``_split_ring``'s blocks);
- ``ring_reduce_scatter`` at 4 KiB, 1 MiB and 1 GiB sent per rank
  (float32 SUM), ``tree_reduce`` at 4 KiB and 1 GiB per rank (int32 MAX,
  root 5), ``tree_bcast`` at 4 KiB and 1 GiB per rank (float32, root 3);
- ``sched_table`` on ``sched_pallas_ring`` at 1 MiB per rank,
  ``sched_pallas_ring_seg`` at 1 GiB per rank and ``sched_pallas_rs`` at
  1 GiB sent per rank (float32 SUM);
- ``ring_allreduce_chunked`` at 1 GiB per rank (float32 SUM, 1 MiB
  segments), ``selfdma_chunked`` at 1 GiB and 4 KiB on one rank,
  ``ring_allgather`` at 128 MiB and 512 B sent per rank (1 GiB and 4 KiB
  received), ``ring_alltoall`` at 1 GiB sent per rank, ``linear_gather``
  at 1 GiB per rank (root 3) and ``x.clone()`` of its input beside it,
  ``quant_allreduce`` at 1 GiB and 64 KiB per rank and at n = 12 (about
  1 GiB per rank; float32 SUM), ``allreduce_block_rsag`` (the reduce-scatter, then the
  allgather) at 1 GiB per rank (float32 SUM, 5 launches);
- ``ppermute_shift`` at 8 MiB and 4 KiB per rank (bfloat16, shift 1),
  also its device time from ``torch.profiler`` (``*_device_ms``) beside
  that of ``x.clone()``'s memcpy of the same 8 MiB a rank,
  ``ring_alltoall`` at 4 KiB sent per rank and ``ring_attention_block``
  at 32 heads of 128, T = 512 per rank, bfloat16, causal.

Where a wrapper records the plan of its last launch
(``KernelCounter.last_plan``), the 1 GiB quant ring's and the 8 MiB
hop's are printed beside their times (``*_plan``; null where the
checkout's wrapper records none).
"""

import json
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

from ompi_tpu_torch.coll import pallas_ring as pr
from ompi_tpu_torch.coll import sched as sched_mod
from ompi_tpu_torch.coll.sched import pallas_lower as pl
from ompi_tpu_torch.tools.ring_probe import profile

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


def table(algo: str, nbytes: int, gen) -> float:
    """p50 of the table kernel on a registered program's layout: nbytes
    per rank (sent, for the reduce-scatter)."""
    prog = pl.analyze(sched_mod.build_schedule(algo, N))
    if algo == "sched_pallas_rs":
        data = torch.randn((N, N, nbytes // 4 // N), generator=gen,
                           device="cuda")
    else:
        data = torch.randn((N, nbytes // 4), generator=gen,
                           device="cuda").reshape(N, prog.nchunks, -1)
    ms = p50(lambda: pl.sched_table(prog, data, "sum"))
    del data
    torch.cuda.empty_cache()
    return ms


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
    clone_first = p50(lambda: rows.clone())
    del rows
    torch.cuda.empty_cache()
    small = torch.randn((N, KIB), generator=gen, device="cuda")
    rd_first = p50(lambda: pr.ring_allreduce_rd(small, "sum"))
    x = torch.randn((N, MIB // 4), generator=gen, device="cuda")
    blocks, _, _ = pr._split_ring(x)
    out = {"card": smi,
           "ring_allreduce_1MiB_ms": p50(
               lambda: pr.ring_allreduce(blocks, "sum")),
           "ring_allreduce_bidir_1MiB_ms": p50(
               lambda: pr.ring_allreduce_bidir(blocks, "sum"))}
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
    out["sched_table_ring_1MiB_ms"] = table("sched_pallas_ring", MIB, gen)
    out["sched_table_seg_1GiB_ms"] = table("sched_pallas_ring_seg", GIB, gen)
    out["sched_table_rs_1GiB_ms"] = table("sched_pallas_rs", GIB, gen)

    x = torch.randn((N, GIB // 4), generator=gen, device="cuda")
    rows_, seg_rows = pr._chunked_layout(GIB // 4, N, torch.float32, MIB)
    seg = seg_rows * pr.LANES
    inp = x.reshape(N, N, rows_ * pr.LANES)
    out["ring_allreduce_chunked_1GiB_ms"] = p50(
        lambda: pr.ring_allreduce_chunked(inp, "sum", seg))
    out["linear_gather_1GiB_ms"] = p50(lambda: pr.linear_gather(x, 3))
    out["gather_clone_1GiB_ms"] = p50(lambda: x.clone())
    out["allreduce_block_rsag_1GiB_ms"] = p50(
        lambda: pr.allreduce_block_rsag(x, "sum"), 5)
    from ompi_tpu_torch.coll import quant

    quantum = N * 128 * 128  # allreduce_block_quant's padding
    qblocks = F.pad(x, (0, (-x.shape[1]) % quantum)).reshape(N, N, -1, 128)
    out["quant_allreduce_1GiB_ms"] = p50(
        lambda: quant.quant_allreduce(qblocks))
    out["quant_allreduce_plan"] = quant.QUANT.last_plan
    del qblocks, inp
    one = x[:1].contiguous()
    rows_, seg_rows = pr._chunked_layout(GIB // 4, 1, torch.float32, MIB)
    out["selfdma_chunked_1GiB_ms"] = p50(
        lambda: pr.selfdma_chunked(one, seg_rows * pr.LANES))
    del one
    x = x.reshape(N, N, -1)
    out["ring_alltoall_1GiB_ms"] = p50(lambda: pr.ring_alltoall(x))
    ag = x[:, 0].contiguous()
    del x
    torch.cuda.empty_cache()
    out["ring_allgather_128MiB_ms"] = p50(lambda: pr.ring_allgather(ag))
    del ag
    torch.cuda.empty_cache()
    ag = torch.randn((N, 4 * KIB // 4 // N), generator=gen, device="cuda")
    out["ring_allgather_512B_ms"] = p50(lambda: pr.ring_allgather(ag))
    one = torch.randn((1, 4 * KIB // 4), generator=gen, device="cuda")
    out["selfdma_chunked_4KiB_ms"] = p50(
        lambda: pr.selfdma_chunked(one, 4 * KIB // 4))

    hop = torch.randn((N, 4 * MIB), generator=gen, device="cuda").to(
        torch.bfloat16)
    out["ppermute_shift_8MiB_ms"] = p50(lambda: pr.ppermute_shift(hop, 1))
    out["ppermute_shift_plan"] = pr.PPERMUTE.last_plan
    out["ppermute_shift_8MiB_device_ms"] = profile(
        lambda: pr.ppermute_shift(hop, 1), "ppermute_shift").get(
            "kernel device")
    out["clone_8MiB_device_ms"] = profile(
        lambda: hop.clone(), "no such kernel").get(
        "Memcpy DtoD (Device -> Device) device")
    hop = hop[:, :2 * KIB].contiguous()
    out["ppermute_shift_4KiB_ms"] = p50(lambda: pr.ppermute_shift(hop, 1))
    out["ppermute_shift_4KiB_device_ms"] = profile(
        lambda: pr.ppermute_shift(hop, 1), "ppermute_shift").get(
            "kernel device")
    del hop
    qsmall = F.pad(torch.randn((N, 16 * KIB), generator=gen, device="cuda"),
                   (0, N * 128 * 128 - 16 * KIB)).reshape(N, N, -1, 128)
    out["quant_allreduce_64KiB_ms"] = p50(
        lambda: quant.quant_allreduce(qsmall))
    a2a = torch.randn((N, N, KIB // N), generator=gen, device="cuda")
    out["ring_alltoall_4KiB_ms"] = p50(lambda: pr.ring_alltoall(a2a))
    del qsmall, a2a
    from ompi_tpu_torch.coll import pallas_attn as pa

    q, k, v = (torch.randn((N, 512, 32, 128), generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    out["ring_attention_bf16_causal_ms"] = p50(
        lambda: pa.ring_attention_block(q, k, v, True))
    del q, k, v
    torch.cuda.empty_cache()
    rows = torch.randn((N, GIB // 4), generator=gen, device="cuda")
    out["linear_scatter_1GiB_first_ms"] = scatter_first
    out["linear_scatter_1GiB_ms"] = p50(lambda: pr.linear_scatter(rows, 5))
    out["scatter_clone_1GiB_first_ms"] = clone_first
    out["scatter_clone_1GiB_ms"] = p50(lambda: rows.clone())
    del rows
    torch.cuda.empty_cache()
    n, quantum = 12, 12 * 128 * 128
    x = torch.randn((n, GIB // 4 // quantum * quantum), generator=gen,
                    device="cuda")
    qblocks = x.reshape(n, n, -1, 128)
    out["quant_allreduce_n12_ms"] = p50(
        lambda: quant.quant_allreduce(qblocks), 10)
    out["quant_allreduce_n12_plan"] = quant.QUANT.last_plan
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
