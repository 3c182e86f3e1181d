"""Check and time the ring allgather's and the one-rank chunked
identity's kernels on a CUDA card, see where the allgather's blocks wait,
and sweep both kernels' launch shapes.

Run from the repository root on a machine with a card and ``nvcc``:
``python3 -m ompi_tpu_torch.tools.ag_selfdma_check``. Prints the
compiler's register and spill lines; then small cases bitwise: the
allgather at n in {2, 3, 8, 12} over five dtypes and three widths (the
plan's buffers, and at n <= 8 also in L2), with one stripe over many
segments, every flag back at 0; ``selfdma_chunked`` over five dtypes,
aligned and unaligned. Then at n = 8: the allgather at 1 GiB received
per rank (128 MiB sent, float32), every row checked, the p50 of 20
launches (CUDA events), its plan and how many clusters fit, with its
buffers in shared memory and in L2, and at n = 12 (L2);
``x.unsqueeze(0).expand(...).contiguous()``'s p50 and the (n+1)B bound;
at 4 KiB per rank with its ``torch.profiler`` split (as
``ring_probe.py`` reads it); ``allreduce_block_rsag`` (the
reduce-scatter, then the allgather) at 1 GiB per rank; from a probe build
(``-DOMPI_RING_PROBE``) at 1 GiB, the median block's span and its wait
at flags; ``selfdma_chunked`` at 1 GiB and 4 KiB beside ``x.clone()``
and the 2B bound, with its plan, the two in turns and their device
times from ``torch.profiler``, and from a probe build the share of its
blocks' span their issuing thread waits for each stage; a line ``bad
N``.

``--sweep`` adds, configurations taken in turns over three rounds, the
median of rounds (ms): the allgather at 1 GiB received over (segment
bytes, threads, blocks per SM) with its buffers in a cluster's shared
memory (as many clusters as fit) and in L2, near its plans;
``selfdma_chunked`` at 1 GiB over piece bytes x blocks per SM beside
``x.clone()``.
"""

import sys

import torch

from ompi_tpu_torch.coll import pallas_ring as pr
from ompi_tpu_torch.core import build
from ompi_tpu_torch.tools.rs_bcast_check import in_turns, probe
from ompi_tpu_torch.tools.ring_probe import PROBE, profile
from ompi_tpu_torch.tools.tree_check import p50

GIB, MIB, KIB = 1 << 30, 1 << 20, 1 << 10
HBM = 3.35e12  # bytes/s, H100 SXM data sheet
N = 8
DTYPES = (torch.float32, torch.bfloat16, torch.int32, torch.float64,
          torch.int8)


def data(shape, dtype, gen):
    """Random values of any dtype, made in int32 or float32 on the card."""
    if dtype.is_floating_point:
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return torch.randint(-100, 100, shape, generator=gen, device="cuda",
                         dtype=torch.int32).to(dtype)


def gathered(x):
    n = x.shape[0]
    return x.unsqueeze(0).expand((n,) + tuple(x.shape)).contiguous()


def small_cases(gen) -> int:
    bad = 0
    for n in (2, 3, 8, 12):
        for dtype in DTYPES:
            for cols in (33, 1000, 70001):
                x = data((n, cols), dtype, gen)
                want = gathered(x)
                plain = pr.ring_allgather_plain(x)
                for cluster in (None, False) if n <= 8 else (None,):
                    got = pr._ag_launch(x, cluster=cluster)
                    torch.cuda.synchronize()
                    if (int(pr.AG.last_sems.abs().sum()) or
                            not torch.equal(got, want) or
                            not torch.equal(got, plain)):
                        bad += 1
                        print(f"BAD allgather n={n} {dtype} cols={cols} "
                              f"cluster={cluster}", flush=True)
    # one stripe over many segments, the last ragged
    for n in (3, 8, 12):
        x = data((n, 41 * pr.AG_SEG_BYTES // 4 + 77), torch.float32, gen)
        for cluster in (True, False) if n <= 8 else (False,):
            got = pr._ag_launch(x, stripes=1, cluster=cluster)
            torch.cuda.synchronize()
            if int(pr.AG.last_sems.abs().sum()) or not torch.equal(
                    got, gathered(x)):
                bad += 1
                print(f"BAD allgather one stripe n={n} cluster={cluster}",
                      flush=True)
    for dtype in DTYPES:
        for cols in (1, 33, 4096, 3 * 4096 + 7, 1 << 20):
            x = data((1, cols), dtype, gen)
            for view in (x, x[:, 1:]):  # aligned, and (mostly) not
                got = pr._selfdma_launch(view)
                torch.cuda.synchronize()
                if not torch.equal(got, view):
                    bad += 1
                    print(f"BAD selfdma {dtype} cols={view.shape[1]}",
                          flush=True)
    print(f"small cases: {bad} bad", flush=True)
    return bad


def main_sizes(gen) -> int:
    bad = 0
    x = data((N, GIB // 4 // N), torch.float32, gen)
    want = gathered(x)
    lib = p50(lambda: gathered(x))
    bound = (N + 1) * GIB / HBM * 1e3
    for cluster in (True, False):
        got = pr._ag_launch(x, cluster=cluster)
        if not torch.equal(got, want) or int(pr.AG.last_sems.abs().sum()):
            bad += 1
            print(f"BAD allgather 1 GiB cluster={cluster}", flush=True)
        del got
        ms = p50(lambda: pr._ag_launch(x, cluster=cluster))
        plan = pr.AG.last_plan
        fits = ""
        if cluster:
            fit = pr._clusters("ring_allgather", N, plan["threads"],
                               plan["segment_bytes"], 0)
            fits = f" ({fit} clusters fit)"
        print(f"allgather 1 GiB received n={N} buffers in "
              f"{plan['buffers']}: {ms:.4f} ms, plan {plan}{fits}; library "
              f"{lib:.4f} ms, bound {bound:.4f} ms", flush=True)
    del want
    torch.cuda.empty_cache()
    probe("ring_allgather", lambda d: pr._ag_launch(x, defines=d),
          {"all blocks": (0, N * pr.AG.last_plan["stripes"])})
    del x
    torch.cuda.empty_cache()

    n12 = 12
    x = data((n12, GIB // 4 // n12 // 128 * 128), torch.float32, gen)
    got = pr._ag_launch(x)
    if not torch.equal(got, gathered(x)):
        bad += 1
        print("BAD allgather n=12", flush=True)
    del got
    ms = p50(lambda: pr._ag_launch(x))
    print(f"allgather ~1 GiB received n=12: {ms:.4f} ms, plan "
          f"{pr.AG.last_plan}; library {p50(lambda: gathered(x)):.4f} ms",
          flush=True)
    del x
    torch.cuda.empty_cache()

    x = data((N, 4 * KIB // 4), torch.float32, gen)
    ms = p50(lambda: pr.ring_allgather(x))
    split = profile(lambda: pr.ring_allgather(x))
    print(f"allgather 4 KiB/rank: {ms:.5f} ms, plan {pr.AG.last_plan}, "
          f"library {p50(lambda: gathered(x)):.5f} ms, profiler {split}",
          flush=True)

    x = data((N, GIB // 4), torch.float32, gen)
    ring = pr.allreduce_block_rsag(x, "sum")
    ok = torch.allclose(ring, x.sum(0, keepdim=True).expand_as(x), rtol=1e-4,
                        atol=1e-3)
    del ring
    ms = p50(lambda: pr.allreduce_block_rsag(x, "sum"), 5)
    print(f"allreduce_block_rsag 1 GiB/rank n={N}: {ms:.4f} ms "
          f"(close to x.sum(0): {ok})", flush=True)
    bad += not ok
    del x
    torch.cuda.empty_cache()

    one = data((1, GIB // 4), torch.float32, gen)
    got = pr.selfdma_chunked(one, MIB // 4)
    if not torch.equal(got, one):
        bad += 1
        print("BAD selfdma 1 GiB", flush=True)
    del got
    ms = p50(lambda: pr.selfdma_chunked(one, MIB // 4))
    print(f"selfdma_chunked 1 GiB: {ms:.4f} ms, plan "
          f"{pr.SELFDMA.last_plan}; clone {p50(lambda: one.clone()):.4f} "
          f"ms, bound {2 * GIB / HBM * 1e3:.4f} ms", flush=True)
    in_turns({"selfdma_chunked 1 GiB": lambda: pr.selfdma_chunked(
                 one, MIB // 4), "clone 1 GiB": lambda: one.clone()})
    print(f"selfdma_chunked 1 GiB profiler "
          f"{profile(lambda: pr.selfdma_chunked(one, MIB // 4), 'selfdma')}"
          f"; clone {profile(lambda: one.clone(), 'copy')}", flush=True)
    selfdma_probe(one)
    del one
    torch.cuda.empty_cache()
    small = data((1, 4 * KIB // 4), torch.float32, gen)
    ms = p50(lambda: pr.selfdma_chunked(small, 4 * KIB // 4))
    split = profile(lambda: pr.selfdma_chunked(small, 4 * KIB // 4))
    print(f"selfdma_chunked 4 KiB: {ms:.5f} ms, clone "
          f"{p50(lambda: small.clone()):.5f} ms, profiler {split}",
          flush=True)
    return bad


def selfdma_probe(one) -> None:
    """One launch of selfdma_chunked's probe build on ``one``: the median
    block's span and the share of it its issuing thread waited for IN
    (the load of a piece), RDMA (the copy into the second slot) and OUT
    (a slot's store to be read out)."""
    lib = build.library("selfdma_chunked", PROBE)
    lib.ompi_probe_set.argtypes = [pr.ctypes.c_void_p]
    pr._selfdma_launch(one, defines=PROBE)
    blocks = pr.SELFDMA.last_plan["blocks"]
    buf = torch.zeros((blocks, 64), dtype=torch.int64, device="cuda")
    lib.ompi_probe_set(buf.data_ptr())
    pr._selfdma_launch(one, defines=PROBE)
    torch.cuda.synchronize()
    lib.ompi_probe_set(None)
    t = buf.cpu().double()
    span = float((t[:, 1] - t[:, 0]).median()) / 1e6
    waits = {name: float(t[:, i].median()) / 1e6
             for name, i in (("IN", 2), ("RDMA", 3), ("OUT", 4))}
    print(f"probe selfdma_chunked {pr.SELFDMA.last_plan}: span {span:.4f} "
          f"ms, waiting " + ", ".join(
              f"{k} {v:.4f} ms ({100 * v / span:.0f}%)"
              for k, v in waits.items()), flush=True)


def sweep(gen) -> None:
    x = data((N, GIB // 4 // N), torch.float32, gen)
    want = gathered(x)
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    configs = {}
    for cluster, shapes in (
            (True, ((2 * KIB, 128, 4), (4 * KIB, 256, 4), (2 * KIB, 128, 8),
                    (4 * KIB, 128, 8), (8 * KIB, 256, 4), (4 * KIB, 512, 2))),
            (False, ((4 * KIB, 256, 2), (2 * KIB, 128, 4), (8 * KIB, 512, 1),
                     (4 * KIB, 256, 4)))):
        for seg, threads, per_sm in shapes:
            stripes = pr._stripes(N, x.shape[1] * 4, per_sm * sm, seg)
            if cluster:  # as many as fit
                stripes = min(stripes, pr._clusters(
                    "ring_allgather", N, threads, seg, 0))
            run = (lambda stripes=stripes, threads=threads, seg=seg,
                   cluster=cluster: pr._ag_launch(
                       x, stripes, threads, seg, cluster))
            if not torch.equal(run(), want):
                raise AssertionError(f"allgather sweep {cluster} "
                                     f"{threads} {per_sm} {seg}")
            where = "smem" if cluster else "L2"
            configs[f"allgather {where} seg {seg} threads {threads} x "
                    f"{per_sm}/SM ({stripes} stripes)"] = run
    in_turns(configs)
    del x, want, configs
    torch.cuda.empty_cache()
    one = data((1, GIB // 4), torch.float32, gen)
    configs = {"clone": lambda: one.clone()}
    for piece in (4 * KIB, 8 * KIB, 16 * KIB, 32 * KIB):
        for per_sm in (1, 2, 3, 4, 6, 8):
            if per_sm * (4 * piece + 128) > 220 * KIB:
                continue
            run = (lambda piece=piece, per_sm=per_sm:
                   pr._selfdma_launch(one, piece, per_sm))
            if not torch.equal(run(), one):
                raise AssertionError(f"selfdma sweep {piece} {per_sm}")
            configs[f"selfdma piece {piece} x {per_sm}/SM"] = run
    in_turns(configs)


def main() -> int:
    names = ("ring_allgather", "selfdma_chunked", "ring_reduce_scatter")
    build.build(names)
    build.build(("ring_allgather", "selfdma_chunked"), PROBE)
    for name in names:
        for line in build.BUILD_LOGS[name].splitlines():
            if any(w in line for w in ("Used", "spill", "error", "warning")):
                print(f"[build] {name}: {line.strip()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = small_cases(gen)
    bad += main_sizes(gen)
    if "--sweep" in sys.argv[1:]:
        sweep(gen)
    print(f"bad {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
