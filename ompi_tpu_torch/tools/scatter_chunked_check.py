"""Check and time the linear scatter's and the chunked ring allreduce's
kernels on a CUDA card, see where their blocks wait, and sweep both
kernels' launch shapes.

Run from the repository root on a machine with a card and ``nvcc``:
``python3 -m ompi_tpu_torch.tools.scatter_chunked_check``. Prints the
compiler's register and spill lines; then small cases bitwise against
the plain versions, every flag back at 0: the scatter at n in {2, 3, 8,
12} over five dtypes, four widths and three roots, also on unaligned
views and with pieces of 16 and 48 bytes (ragged tails inside the
kernel); the chunked ring at n in {2, 3, 8, 12} for three dtypes and
four ops at three widths, with the plan's stripes and one, its buffers
where the plan puts them and in L2. Then at n = 8: the scatter at 1 GiB
per rank (root 5) checked against root's buffer, its p50 (20 launches,
CUDA events) with its plan, ``x.clone()`` and the 2nB bound, the two in
turns over three rounds, at 4 KiB per rank with its ``torch.profiler``
split, and from a probe build (``-DOMPI_RING_PROBE``) when each
receiver's row had landed against the senders' span; the chunked ring at
1 GiB per rank (float32 SUM) checked bitwise against
``allreduce_block_rsag`` (the same steps and fold order), its p50 in
either memory with its plan and how many clusters fit, beside
``x.sum(0, keepdim=True).expand_as(x)`` and ``allreduce_block_rsag`` in
turns, at n = 12 (L2), and from a probe build the median block's span
and the shares of it spent waiting at flags, in passes and publishing; a
line ``bad N``.

``--sweep`` adds, configurations taken in turns over three rounds, the
median of rounds (ms): the scatter at 1 GiB per rank over piece bytes x
(threads, blocks per SM) beside ``x.clone()``; the chunked ring at 1 GiB
per rank over (segment bytes, threads, blocks per SM) with its buffers in
a cluster's shared memory (as many clusters as fit) and in L2.
"""

import sys

import torch

from ompi_tpu_torch.coll import pallas_ring as pr
from ompi_tpu_torch.core import build
from ompi_tpu_torch.tools.ag_selfdma_check import data
from ompi_tpu_torch.tools.rs_bcast_check import in_turns
from ompi_tpu_torch.tools.ring_probe import PROBE, profile
from ompi_tpu_torch.tools.tree_check import p50

GIB, MIB, KIB = 1 << 30, 1 << 20, 1 << 10
HBM = 3.35e12  # bytes/s, H100 SXM data sheet
N, ROOT = 8, 5
DTYPES = (torch.float32, torch.bfloat16, torch.int32, torch.float64,
          torch.int8)
RING_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
OPS = ("sum", "max", "min", "prod")


def flags_left(counter) -> int:
    return int(counter.last_sems.abs().sum())


def small_cases(gen) -> int:
    bad = 0
    for n in (2, 3, 8, 12):
        for dtype in DTYPES:
            for cols in (1, 33, 1000, 70001):
                x = data((n, cols + 1), dtype, gen)
                for view in (x[:, :cols], x[:, 1:]):  # (mostly) unaligned
                    want = pr.linear_scatter_plain(view, n - 1)
                    for root in sorted({0, 1, n - 1}):
                        for piece in (None, 16, 48):
                            got = pr._scatter_launch(view, root, piece)
                            torch.cuda.synchronize()
                            if (flags_left(pr.SCATTER) or
                                    not torch.equal(got, view) or
                                    not torch.equal(got, want)):
                                bad += 1
                                print(f"BAD scatter n={n} {dtype} cols={cols}"
                                      f" root={root} piece={piece}",
                                      flush=True)
    print(f"scatter small cases: {bad} bad", flush=True)
    seg = pr.CHUNKED_CLUSTER_SEG_BYTES // 4
    for n in (2, 3, 8, 12):
        for dtype in RING_DTYPES:
            for W in (128, 3 * seg - 40, 40 * seg + 77):
                x = data((n, n, W), dtype, gen)
                for op in OPS:
                    want = pr.ring_allreduce_chunked_plain(x, op, W)
                    for stripes in (None, 1):
                        for cluster in (None, False) if n <= 8 else (None,):
                            got = pr._chunked_launch(x, op, stripes=stripes,
                                                     cluster=cluster)
                            torch.cuda.synchronize()
                            if flags_left(pr.CHUNKED) or not torch.equal(
                                    got, want):
                                bad += 1
                                print(f"BAD chunked n={n} {dtype} W={W} {op}"
                                      f" stripes={stripes} cluster={cluster}",
                                      flush=True)
    print(f"small cases: {bad} bad", flush=True)
    return bad


def scatter_probe(x) -> None:
    """One launch of the scatter's probe build at ``x``: the senders'
    median span, and when each receiver's row had wholly landed (ms
    after the first sender's start)."""
    lib = build.library("linear_scatter", PROBE)
    lib.ompi_probe_set.argtypes = [pr.ctypes.c_void_p]
    pr._scatter_launch(x, ROOT, defines=PROBE)
    plan = pr.SCATTER.last_plan
    blocks = plan["senders"] + plan["receivers"]
    buf = torch.zeros((blocks, 64), dtype=torch.int64, device="cuda")
    lib.ompi_probe_set(buf.data_ptr())
    pr._scatter_launch(x, ROOT, defines=PROBE)
    torch.cuda.synchronize()
    lib.ompi_probe_set(None)
    t = buf.cpu().double()
    s = plan["senders"]
    start = float(t[:s, 0].min())
    span = float((t[:s, 1] - t[:s, 0]).median()) / 1e6
    last = float(t[:s, 1].max() - start) / 1e6
    landed = [round(float(v - start) / 1e6, 4) for v in t[s:, 1]]
    print(f"probe linear_scatter {plan}: senders' median span {span:.4f} ms"
          f", last sender done {last:.4f} ms; receivers' rows landed at "
          f"{landed} ms", flush=True)


def scatter_sizes(gen) -> int:
    bad = 0
    x = data((N, GIB // 4), torch.float32, gen)
    got = pr.linear_scatter(x, ROOT)
    if not torch.equal(got, x) or flags_left(pr.SCATTER):
        bad += 1
        print("BAD scatter 1 GiB", flush=True)
    del got
    ms = p50(lambda: pr.linear_scatter(x, ROOT))
    print(f"scatter 1 GiB/rank n={N} root {ROOT}: {ms:.4f} ms, plan "
          f"{pr.SCATTER.last_plan}; clone {p50(lambda: x.clone()):.4f} ms, "
          f"bound {2 * N * GIB / HBM * 1e3:.4f} ms", flush=True)
    in_turns({"scatter 1 GiB": lambda: pr.linear_scatter(x, ROOT),
              "clone 1 GiB": lambda: x.clone()})
    scatter_probe(x)
    del x
    torch.cuda.empty_cache()
    x = data((N, 4 * KIB // 4), torch.float32, gen)
    ms = p50(lambda: pr.linear_scatter(x, ROOT))
    split = profile(lambda: pr.linear_scatter(x, ROOT), "linear_scatter")
    print(f"scatter 4 KiB/rank: {ms:.5f} ms, plan {pr.SCATTER.last_plan}, "
          f"clone {p50(lambda: x.clone()):.5f} ms, profiler {split}",
          flush=True)
    return bad


def chunked_probe(blocks) -> None:
    """One launch of the chunked ring's probe build on ``blocks``: the
    median block's span and the share of it its thread 0 spent waiting at
    flags, in its passes and publishing (the fence and the raises)."""
    lib = build.library("ring_allreduce_chunked", PROBE)
    lib.ompi_probe_set.argtypes = [pr.ctypes.c_void_p]
    pr._chunked_launch(blocks, "sum", defines=PROBE)
    plan = pr.CHUNKED.last_plan
    buf = torch.zeros((blocks.shape[0] * plan["stripes"], 64),
                      dtype=torch.int64, device="cuda")
    lib.ompi_probe_set(buf.data_ptr())
    pr._chunked_launch(blocks, "sum", defines=PROBE)
    torch.cuda.synchronize()
    lib.ompi_probe_set(None)
    t = buf.cpu().double()
    span = float((t[:, 1] - t[:, 0]).median()) / 1e6
    parts = {name: float(t[:, i].median()) / 1e6
             for name, i in (("waiting", 2), ("passes", 3),
                             ("publishing", 4))}
    print(f"probe ring_allreduce_chunked {plan}: span {span:.4f} ms; " +
          ", ".join(f"{k} {v:.4f} ms ({100 * v / span:.0f}%)"
                    for k, v in parts.items()), flush=True)


def chunked_input(n, nbytes, gen):
    """(x, the chunked layout's (n, n, W) blocks of x, its segment) at
    ``nbytes`` float32 per rank with 1 MiB layout segments."""
    x = data((n, nbytes // 4), torch.float32, gen)
    rows, seg_rows = pr._chunked_layout(nbytes // 4, n, torch.float32, MIB)
    if n * rows * pr.LANES != x.shape[1]:
        raise AssertionError(f"{nbytes} B is not whole segments at n={n}")
    return x, x.reshape(n, n, rows * pr.LANES), seg_rows * pr.LANES


def chunked_sizes(gen) -> int:
    bad = 0
    x, blocks, seg = chunked_input(N, GIB, gen)
    want = pr.allreduce_block_rsag(x, "sum").reshape(blocks.shape)
    for cluster in (True, False):
        got = pr._chunked_launch(blocks, "sum", cluster=cluster)
        if not torch.equal(got, want) or flags_left(pr.CHUNKED):
            bad += 1
            print(f"BAD chunked 1 GiB cluster={cluster}", flush=True)
        del got
        ms = p50(lambda: pr._chunked_launch(blocks, "sum", cluster=cluster))
        plan = pr.CHUNKED.last_plan
        fits = ""
        if cluster:
            fit = pr._clusters("ring_allreduce_chunked", N, plan["threads"],
                               plan["segment_bytes"], 0)
            fits = f" ({fit} clusters fit)"
        print(f"chunked 1 GiB/rank n={N} buffers in {plan['buffers']}: "
              f"{ms:.4f} ms, plan {plan}{fits}", flush=True)
    del want
    torch.cuda.empty_cache()
    print(f"chunked bound {2 * N * GIB / HBM * 1e3:.4f} ms", flush=True)
    in_turns({
        "chunked 1 GiB": lambda: pr.ring_allreduce_chunked(blocks, "sum",
                                                           seg),
        "allreduce_block_rsag 1 GiB": lambda: pr.allreduce_block_rsag(
            x, "sum"),
        "library 1 GiB": lambda: x.sum(0, keepdim=True).expand_as(
            x).contiguous()})
    chunked_probe(blocks)
    del x, blocks
    torch.cuda.empty_cache()

    n12 = 12
    x, blocks, seg = chunked_input(n12, GIB // (n12 * MIB) * n12 * MIB, gen)
    got = pr.ring_allreduce_chunked(blocks, "sum", seg)
    if not torch.equal(got.reshape(x.shape), pr.allreduce_block_rsag(
            x, "sum")) or flags_left(pr.CHUNKED):
        bad += 1
        print("BAD chunked n=12", flush=True)
    del got
    ms = p50(lambda: pr.ring_allreduce_chunked(blocks, "sum", seg))
    print(f"chunked {x.shape[1] * 4} B/rank n=12: {ms:.4f} ms, plan "
          f"{pr.CHUNKED.last_plan}; library "
          f"{p50(lambda: x.sum(0, keepdim=True).expand_as(x).contiguous()):.4f}"
          f" ms", flush=True)
    del x, blocks
    torch.cuda.empty_cache()
    return bad


def sweep(gen) -> None:
    x = data((N, GIB // 4), torch.float32, gen)
    configs = {"clone": lambda: x.clone()}
    for piece in (16 * KIB, 64 * KIB, 256 * KIB):
        for threads, per_sm in ((512, 2), (1024, 1), (256, 2)):
            run = (lambda piece=piece, threads=threads, per_sm=per_sm:
                   pr._scatter_launch(x, ROOT, piece, threads, per_sm))
            if not torch.equal(run(), x):
                raise AssertionError(f"scatter sweep {piece} {threads}")
            configs[f"scatter piece {piece} threads {threads} x "
                    f"{per_sm}/SM"] = run
    in_turns(configs)
    del x, configs
    torch.cuda.empty_cache()

    x, blocks, _ = chunked_input(N, GIB, gen)
    want = pr._chunked_launch(blocks, "sum")
    W = blocks.shape[-1]
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    configs = {}
    for cluster, shapes in (
            (True, ((2 * KIB, 128, 4), (1 * KIB, 128, 4), (2 * KIB, 256, 2),
                    (4 * KIB, 256, 2), (4 * KIB, 512, 1), (2 * KIB, 512, 1),
                    (1 * KIB, 256, 2))),
            (False, ((4 * KIB, 256, 2), (2 * KIB, 128, 4), (8 * KIB, 512, 1),
                     (4 * KIB, 512, 1)))):
        for seg, threads, per_sm in shapes:
            if cluster and per_sm * ((2 * N - 3) * 2 * seg + 2 * KIB) > \
                    228 * KIB:
                continue
            stripes = pr._stripes(N, W * 4, per_sm * sm, seg)
            if cluster:  # as many as fit
                stripes = min(stripes, pr._clusters(
                    "ring_allreduce_chunked", N, threads, seg, 0))
            run = (lambda stripes=stripes, threads=threads, seg=seg,
                   cluster=cluster: pr._chunked_launch(
                       blocks, "sum", stripes, threads, seg, cluster))
            if not torch.equal(run(), want):
                raise AssertionError(f"chunked sweep {cluster} {threads} "
                                     f"{per_sm} {seg}")
            where = "smem" if cluster else "L2"
            configs[f"chunked {where} seg {seg} threads {threads} x "
                    f"{per_sm}/SM ({stripes} stripes)"] = run
    in_turns(configs)


def main() -> int:
    names = ("linear_scatter", "ring_allreduce_chunked",
             "ring_reduce_scatter", "ring_allgather")
    build.build(names)
    build.build(("linear_scatter", "ring_allreduce_chunked"), PROBE)
    for name in names[:2]:
        for line in build.BUILD_LOGS[name].splitlines():
            if any(w in line for w in ("Used", "spill", "error", "warning")):
                print(f"[build] {name}: {line.strip()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = small_cases(gen)
    bad += scatter_sizes(gen)
    bad += chunked_sizes(gen)
    if "--sweep" in sys.argv[1:]:
        sweep(gen)
    print(f"bad {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
