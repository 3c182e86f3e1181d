"""Check and time the int8-wire ring allreduce and the ring hop on a CUDA
card against their yardsticks, and sweep their launch shapes.

Run from the repository root on a machine with a card and ``nvcc``:
``python3 -m ompi_tpu_torch.tools.quant_hop_check [--sweep] [--turns
PARENT]``. It prints the card's name and power limit and the compiler's
register and spill lines; then:

- small cases, bitwise their plain versions with every flag back at 0:
  ``quant_allreduce`` through ``allreduce_block_quant`` (float32 and
  bfloat16, ragged sizes) in its cluster form at n = 2, 3, 8, in its L2
  form forced at n = 3, 8 and at n = 12, with one-row segments (more
  segments than steps) and the plan's (fewer); ``ppermute_shift`` in
  both forms at n = 2, 3, 8 (the flags form also at 12), float32,
  bfloat16 and int8, shifts 1, -1, 3; ``ring_alltoall`` at n = 8;
- at n = 8, ``quant_allreduce`` at 1 GiB per rank (float32 SUM): its p50
  (20 launches between CUDA events) with its plan, beside the chunked
  ring (``ring_allreduce_chunked``, the same ring on the float32 wire)
  and the exact sum ``x.sum(0, keepdim=True).expand_as(x)``, the three in
  turns over three rounds, and its device time from ``torch.profiler``;
  the L2 form forced at n = 8 and the L2 form at n = 12 (about 1 GiB per
  rank); at 64 KiB per rank (one 128-row quantum a ring block) its p50
  and ``torch.profiler`` split;
- ``ppermute_shift`` at 8 MiB of bfloat16 per rank and at 4 KiB, in
  both forms: p50s and device times beside ``x.clone()`` (a
  device-to-device memcpy of the same bytes), an empty kernel launched
  as the cluster form is, and each call's host time, in turns.

``--sweep`` adds, configurations in turns over three rounds: the quant
ring at 1 GiB per rank over segment rows x (threads, blocks per SM) in
either form, and the hop at 8 MiB per rank over its bulk copies' pieces
x stripes per SM and its threads' copy over (threads, stripes per SM),
each also with its device time. ``--turns PARENT`` then runs this
checkout's ``tools/kernel_times.py`` on PARENT's package (a checkout of
the parent commit) and on this checkout's in turns, parent / change /
change / parent, each in its own process, and prints each run's JSON
line.
"""

import os
import subprocess
import sys

import torch
import torch.nn.functional as F

from ompi_tpu_torch.coll import pallas_ring as pr
from ompi_tpu_torch.coll import quant
from ompi_tpu_torch.core import build
from ompi_tpu_torch.tools.ag_selfdma_check import data
from ompi_tpu_torch.tools.gather_rd_check import empty_launch, host_ms, \
    split_text
from ompi_tpu_torch.tools.ring_probe import profile
from ompi_tpu_torch.tools.rs_bcast_check import in_turns
from ompi_tpu_torch.tools.tree_check import p50

GIB, MIB, KIB = 1 << 30, 1 << 20, 1 << 10
HBM = 3.35e12  # bytes/s, H100 SXM data sheet
N = 8
HOP_BYTES = 8 * MIB


def flags_left(counter) -> int:
    return int(counter.last_sems.abs().sum())


def quant_blocks(n: int, nbytes: int, gen):
    """(n, n, rows, 128) float32 ring blocks of about ``nbytes`` per rank
    (whole 128-row quanta), and the flat (n, L) input they pad."""
    x = data((n, nbytes // 4), torch.float32, gen)
    quantum = n * 128 * 128  # allreduce_block_quant's padding
    flat = F.pad(x, (0, (-x.shape[1]) % quantum))
    return flat.reshape(n, n, -1, 128), x


def small_cases(gen) -> int:
    bad = 0
    for n, cases in ((2, ((None, None), (None, 1))),
                     (3, ((None, None), (False, None), (None, 1))),
                     (8, ((None, None), (False, None), (True, 1))),
                     (12, ((None, None), (None, 1)))):
        for dtype in (torch.float32, torch.bfloat16):
            for rows in (128, 384):
                x = data((n, n * rows * 128 - 333), dtype, gen)
                want = quant.allreduce_block_quant(
                    x, "sum", quant=quant.quant_allreduce_plain)
                for cluster, seg in cases:
                    got = quant.allreduce_block_quant(
                        x, "sum", quant=lambda b: quant._quant_launch(
                            b, cluster, seg))
                    torch.cuda.synchronize()
                    plan = quant.QUANT.last_plan
                    if not torch.equal(got, want) or \
                            flags_left(quant.QUANT):
                        bad += 1
                        print(f"BAD quant n={n} {dtype} rows={rows} {plan}",
                              flush=True)
    print(f"quant small cases done, last plan {quant.QUANT.last_plan}",
          flush=True)
    for n in (2, 3, 8, 12):
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            x = data((n, 4 * KIB + 7), torch.float32, gen).to(dtype)
            for shift in (1, -1, 3):
                want = torch.roll(x, shift, 0)
                for cluster in ((None, False) if n <= 8 else (None,)):
                    got = pr._hop_launch(x, shift % n, cluster)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want) or flags_left(pr.PPERMUTE):
                        bad += 1
                        print(f"BAD hop n={n} {dtype} shift={shift} "
                              f"{pr.PPERMUTE.last_plan}", flush=True)
    x = data((N, N, 1000), torch.float32, gen)
    got = pr.ring_alltoall(x)
    torch.cuda.synchronize()
    if not torch.equal(got, pr.ring_alltoall_plain(x)) or \
            flags_left(pr.ALLTOALL):
        bad += 1
        print("BAD alltoall", flush=True)
    print(f"small cases: {bad} bad", flush=True)
    return bad


def quant_sizes(gen) -> int:
    bad = 0
    blocks, x = quant_blocks(N, GIB, gen)
    got = quant.quant_allreduce(blocks)
    torch.cuda.synchronize()
    if flags_left(quant.QUANT) or not bool(
            (got == got[:1].expand_as(got)).all()):
        bad += 1
        print("BAD quant 1 GiB", flush=True)
    del got
    rows_, seg_rows = pr._chunked_layout(GIB // 4, N, torch.float32, MIB)
    ch = x.reshape(N, N, rows_ * pr.LANES)
    seg = seg_rows * pr.LANES
    runs = {"quant 1 GiB": lambda: quant.quant_allreduce(blocks),
            "chunked 1 GiB": lambda: pr.ring_allreduce_chunked(ch, "sum",
                                                               seg),
            "exact sum 1 GiB": lambda: x.sum(0, keepdim=True).expand_as(
                x).contiguous()}
    ms = p50(runs["quant 1 GiB"])
    split = profile(runs["quant 1 GiB"], "quant_allreduce")
    print(f"quant 1 GiB/rank n={N}: {ms:.4f} ms, plan "
          f"{quant.QUANT.last_plan}; bound {2 * N * GIB / HBM * 1e3:.4f} "
          f"ms; profiler {split_text(split)}", flush=True)
    l2 = lambda: quant._quant_launch(blocks, cluster=False)  # noqa: E731
    if not torch.equal(l2(), quant.quant_allreduce(blocks)):
        bad += 1
        print("BAD quant 1 GiB L2 != cluster", flush=True)
    print(f"quant 1 GiB/rank n={N} L2 form: {p50(l2):.4f} ms, plan "
          f"{quant.QUANT.last_plan}", flush=True)
    in_turns(runs)
    del blocks, x, ch, runs
    torch.cuda.empty_cache()
    n = 12
    blocks, x = quant_blocks(n, GIB // (n * 128 * 128 * 4) * n * 128 * 128
                             * 4, gen)
    ms = p50(lambda: quant.quant_allreduce(blocks))
    print(f"quant n={n} ({x.shape[1] * 4} B/rank): {ms:.4f} ms, plan "
          f"{quant.QUANT.last_plan}, flags left {flags_left(quant.QUANT)}; "
          f"bound {2 * n * x.shape[1] * 4 / HBM * 1e3:.4f} ms; exact sum "
          f"{p50(lambda: x.sum(0, keepdim=True).expand_as(x).contiguous()):.4f}"
          f" ms", flush=True)
    del blocks, x
    torch.cuda.empty_cache()
    blocks, x = quant_blocks(N, 64 * KIB, gen)
    run = lambda: quant.quant_allreduce(blocks)  # noqa: E731
    split = profile(run, "quant_allreduce")
    print(f"quant 64 KiB/rank: {p50(run):.5f} ms, plan "
          f"{quant.QUANT.last_plan}, host {host_ms(run):.5f} ms/call; "
          f"profiler {split_text(split)}", flush=True)
    return bad


def hop_sizes(gen) -> int:
    bad = 0
    for nbytes in (HOP_BYTES, 4 * KIB):
        x = data((N, nbytes // 2), torch.bfloat16, gen)
        want = torch.roll(x, 1, 0)
        runs = {}
        for form, cluster in (("cluster", None), ("flags", False)):
            run = (lambda cluster=cluster: pr._hop_launch(x, 1, cluster))
            got = run()
            torch.cuda.synchronize()
            if not torch.equal(got, want) or flags_left(pr.PPERMUTE):
                bad += 1
                print(f"BAD hop {nbytes} {form}", flush=True)
            plan = pr.PPERMUTE.last_plan
            split = profile(run, "ppermute_shift")
            print(f"hop {nbytes} B/rank {form}: {p50(run):.5f} ms, plan "
                  f"{plan}, host {host_ms(run):.5f} ms/call; profiler "
                  f"{split_text(split)}", flush=True)
            runs[f"hop {form} {nbytes} B"] = run
            if form == "cluster":
                empty = empty_launch(x, True, plan["stripes"],
                                     plan["threads"])
        clone = lambda: x.clone()  # noqa: E731
        split = profile(clone, "no such kernel")
        print(f"clone {nbytes} B/rank: {p50(clone):.5f} ms, host "
              f"{host_ms(clone):.5f} ms/call; profiler {split}", flush=True)
        print(f"empty cluster launch of the plan's shape: "
              f"{p50(empty):.5f} ms, host {host_ms(empty):.5f} ms/call",
              flush=True)
        runs[f"clone {nbytes} B"] = clone
        runs[f"empty cluster launch {nbytes} B"] = empty
        in_turns(runs)
    return bad


def sweep(gen) -> None:
    blocks, _ = quant_blocks(N, GIB, gen)
    want = quant.quant_allreduce(blocks)
    configs = {}
    for cluster, shapes in (
            (True, ((256, 4, 16), (256, 4, 12), (256, 4, 8), (256, 3, 24),
                    (256, 3, 16), (256, 2, 32), (128, 8, 7), (128, 12, 4))),
            (False, ((256, 4, 16), (256, 3, 16), (256, 2, 16),
                     (256, 4, 8)))):
        for threads, per_sm, seg in shapes:
            run = (lambda c=cluster, t=threads, p=per_sm, s=seg:
                   quant._quant_launch(blocks, c, s, t, p))
            if not torch.equal(run(), want):
                raise AssertionError(f"quant sweep {cluster} {threads}")
            plan = quant.QUANT.last_plan
            configs[f"quant {plan['form']} {threads} x {per_sm}/SM seg "
                    f"{plan['segment_rows']} rows, {plan['stripes']} "
                    f"stripes"] = run
    in_turns(configs)
    del blocks, want, configs
    torch.cuda.empty_cache()
    x = data((N, HOP_BYTES // 2), torch.bfloat16, gen)
    want = torch.roll(x, 1, 0)
    configs = {"clone": lambda: x.clone()}
    for piece in (4 * KIB, 8 * KIB, 16 * KIB):
        for per_sm in (2, 4, 8):
            run = (lambda c=piece, p=per_sm:
                   pr._hop_launch(x, 1, None, 2 * c, None, p, c))
            configs[f"hop bulk pieces {piece} x {per_sm} stripes/SM"] = run
    for threads, per_sm in ((512, 2), (1024, 1), (256, 4), (512, 4)):
        run = (lambda t=threads, p=per_sm:
               pr._hop_launch(x, 1, None, None, t, p, 0))
        configs[f"hop threads {threads} x {per_sm} stripes/SM"] = run
    for name, run in list(configs.items())[1:]:
        if not torch.equal(run(), want):
            raise AssertionError(f"hop sweep {name}")
        print(f"{name}: plan {pr.PPERMUTE.last_plan}, on the card "
              f"{profile(run, 'ppermute_shift').get('kernel device')} ms",
              flush=True)
    in_turns(configs)


def turns(parent: str) -> None:
    """This checkout's kernel_times in the parent's checkout and in this
    one, parent / change / change / parent, each tree's kernels built
    first, so that both trees are timed on the same keys."""
    here = os.getcwd()
    script = os.path.join(here, "ompi_tpu_torch", "tools", "kernel_times.py")
    trees = (parent, here, here, parent)
    for tree in (parent, here):
        subprocess.run([sys.executable, "-c",
                        "from ompi_tpu_torch.core import build; "
                        "from chip_smoke import SOURCES; "
                        "build.build(list(SOURCES))"],
                       cwd=tree, check=True, env=dict(os.environ,
                                                      PYTHONPATH=tree))
    for i, tree in enumerate(trees):
        name = "change" if tree == here else "parent"
        got = subprocess.run(
            [sys.executable, "-c", f"import runpy; runpy.run_path("
             f"{script!r}, run_name='__main__')"],
            cwd=tree, check=True, capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=tree)).stdout.strip()
        print(f"turn {i + 1} {name}: {got.splitlines()[-1]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("quant_hop_check: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    names = ("quant_allreduce", "ppermute_shift", "ring_alltoall",
             "ring_allreduce_chunked", "ring_allreduce_rd")
    build.build(names)
    for name in names:
        for line in build.BUILD_LOGS[name].splitlines():
            if any(w in line for w in ("Used", "spill", "error", "warning")):
                print(f"[build] {name}: {line.strip()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = small_cases(gen)
    bad += hop_sizes(gen)
    bad += quant_sizes(gen)
    args = sys.argv[1:]
    if "--sweep" in args:
        sweep(gen)
    if "--turns" in args:
        turns(args[args.index("--turns") + 1])
    print(f"bad {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
