"""Time the linear gather and the recursive-doubling allreduce on a CUDA
card against their yardsticks, see where the gather's blocks end, time
the host's floor under a launch, and sweep the gather's launch shapes.

Run from the repository root on a machine with a card and ``nvcc``:
``python3 -m ompi_tpu_torch.tools.gather_rd_check [--sweep]``. Their
correctness is ``chip_smoke.py``'s and the card tests'; here each timed
call is checked once. It prints the card's name and power limit and the
compiler's register and spill lines; then at n = 8:

- the gather at 1 GiB per rank (root 3): its p50 (20 launches between
  CUDA events) with its plan, ``x.clone()``, its plain version and the
  2nB bound; the gather, ``x.clone()`` and the plain version in turns
  over three rounds (each the median of rounds); from a probe build
  (``-DOMPI_RING_PROBE``) the blocks' finishing times, beside the
  gather's and ``x.clone()``'s device times from ``torch.profiler``: the first and the
  last block to finish its pieces, over all and in each pool, and when
  root's waits ended; at 4 KiB per rank its p50 beside
  ``x.clone()``, with its ``torch.profiler`` split;
- recursive doubling (float32 SUM) at 512 B, 4 KiB and 8 KiB per rank in
  each form (the cluster's shared memory and L2) beside the library call
  ``x.sum(0, keepdim=True).expand_as(x).contiguous()``, in turns, with
  each one's ``torch.profiler`` split (device time, the call's host time,
  the gap from the call's start to the kernel's start);
- the floor the host sets: an empty kernel launched as each form is (a
  cooperative launch of 8 blocks; a cluster launch of one cluster of 8
  with the 4 KiB plan's shared memory, its shared-memory limit set on
  every call, as cluster launches did before, or once), timed the same
  way, each with its host time per call.

``--sweep`` adds, configurations in turns over three rounds: the gather
at 1 GiB per rank over piece bytes x (threads, blocks per SM), and over
the pieces a sender publishes at once, beside ``x.clone()``; recursive doubling at 4 KiB per rank over the cluster
form's stripe bytes beside the L2 form.
"""

import ctypes
import subprocess
import sys
import time

import torch

from ompi_tpu_torch.coll import pallas_ring as pr
from ompi_tpu_torch.core import build
from ompi_tpu_torch.tools.ag_selfdma_check import data
from ompi_tpu_torch.tools.ring_probe import PROBE, profile
from ompi_tpu_torch.tools.rs_bcast_check import in_turns
from ompi_tpu_torch.tools.tree_check import p50

GIB, MIB, KIB = 1 << 30, 1 << 20, 1 << 10
HBM = 3.35e12  # bytes/s, H100 SXM data sheet
N, ROOT = 8, 3
RD_SIZES = (512, 4 * KIB, 8 * KIB)


def host_ms(fn, reps: int = 200) -> float:
    """Mean host time (ms) of one call that only enqueues, the card idle
    before the loop."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e3


def split_text(split: dict) -> str:
    keys = ("kernel device", "call host", "call start to kernel start")
    return ", ".join(f"{k} {split[k]:.5f}" for k in keys if k in split)


def gather_probe(x) -> None:
    """One launch of the gather's probe build at ``x``: when each block
    finished its pieces (ms after the first block's start): the first and
    the last finisher over all and in each pool (root's pool, which
    publishes nothing, among them), and when root's last wait ended."""
    lib = build.library("linear_gather", PROBE)
    lib.ompi_probe_set.argtypes = [ctypes.c_void_p]
    pr._gather_launch(x, ROOT, defines=PROBE)
    plan = pr.GATHER.last_plan
    buf = torch.zeros((plan["blocks"], 64), dtype=torch.int64, device="cuda")
    lib.ompi_probe_set(buf.data_ptr())
    got = pr._gather_launch(x, ROOT, defines=PROBE)
    torch.cuda.synchronize()
    lib.ompi_probe_set(None)
    if not torch.equal(got, x):
        raise AssertionError("gather probe build != its input")
    t = buf.cpu().double()
    start = float(t[:, 0].min())
    done = (t[:, 1] - start) / 1e6
    pool, extra = plan["pool_blocks"], plan["pools_with_one_more"]
    spans, b = [], 0
    for q in range(N):
        size = pool + (q < extra)
        d = done[b:b + size]
        spans.append((round(float(d.min()), 4), round(float(d.max()), 4)))
        b += size
    root0 = sum(pool + (q < extra) for q in range(ROOT))
    root_waits = t[root0:root0 + pool + (ROOT < extra), 2]
    print(f"probe linear_gather {plan}: blocks finished {float(done.min()):.4f}"
          f"-{float(done.max()):.4f} ms (gap {float(done.max() - done.min()):.4f}"
          f"), median {float(done.median()):.4f}; per pool (first, last) "
          f"{spans} ms; "
          f"root's waits ended by {float(root_waits.max() - start) / 1e6:.4f}"
          f" ms", flush=True)


def gather_sizes(gen) -> int:
    bad = 0
    x = data((N, GIB // 4), torch.float32, gen)
    got = pr.linear_gather(x, ROOT)
    torch.cuda.synchronize()
    if not torch.equal(got, x) or int(pr.GATHER.last_sems.abs().sum()):
        bad += 1
        print("BAD gather 1 GiB", flush=True)
    del got
    ms = p50(lambda: pr.linear_gather(x, ROOT))
    print(f"gather 1 GiB/rank n={N} root {ROOT}: {ms:.4f} ms, plan "
          f"{pr.GATHER.last_plan}; clone {p50(lambda: x.clone()):.4f} ms, "
          f"plain {p50(lambda: pr.linear_gather_plain(x, ROOT), 5):.4f} ms, "
          f"bound {2 * N * GIB / HBM * 1e3:.4f} ms", flush=True)
    in_turns({"gather 1 GiB": lambda: pr.linear_gather(x, ROOT),
              "clone 1 GiB": lambda: x.clone(),
              "gather plain 1 GiB": lambda: pr.linear_gather_plain(x, ROOT)})
    split = profile(lambda: pr.linear_gather(x, ROOT), "linear_gather")
    clone = profile(lambda: x.clone(), "no such kernel")
    print(f"gather 1 GiB/rank on the card (torch.profiler): "
          f"{split_text(split)}; clone {clone}", flush=True)
    gather_probe(x)
    del x
    torch.cuda.empty_cache()
    x = data((N, 4 * KIB // 4), torch.float32, gen)
    ms = p50(lambda: pr.linear_gather(x, ROOT))
    split = profile(lambda: pr.linear_gather(x, ROOT), "linear_gather")
    print(f"gather 4 KiB/rank: {ms:.5f} ms, plan {pr.GATHER.last_plan}, "
          f"clone {p50(lambda: x.clone()):.5f} ms, host "
          f"{host_ms(lambda: pr.linear_gather(x, ROOT)):.5f} ms/call; "
          f"profiler {split_text(split)}", flush=True)
    return bad


def rd_sizes(gen) -> int:
    bad = 0
    for nbytes in RD_SIZES:
        x = data((N, nbytes // 4), torch.float32, gen)
        library = lambda: x.sum(0, keepdim=True).expand_as(x).contiguous()  # noqa: E731
        want = pr.ring_allreduce_rd_plain(x, "sum")
        runs = {}
        for form, cluster in (("cluster", None), ("l2", False)):
            run = (lambda cluster=cluster: pr._rd_launch(x, "sum",
                                                         cluster=cluster))
            got = run()
            torch.cuda.synchronize()
            if not torch.equal(got, want) or \
                    int(pr.RD.last_sems.abs().sum()):
                bad += 1
                print(f"BAD rd {nbytes} B {form}", flush=True)
            runs[f"rd {form} {nbytes} B"] = run
            split = profile(run, "ring_allreduce_rd")
            print(f"rd {nbytes} B/rank {form}: {p50(run):.5f} ms, plan "
                  f"{pr.RD.last_plan}, host {host_ms(run):.5f} ms/call; "
                  f"profiler {split_text(split)}", flush=True)
        runs[f"library {nbytes} B"] = library
        split = profile(library, "no such kernel")
        print(f"library {nbytes} B/rank: {p50(library):.5f} ms, host "
              f"{host_ms(library):.5f} ms/call; profiler "
              f"{split_text(split)}; {split}", flush=True)
        in_turns(runs)
    return bad


def empty_launch(x, cluster: bool, stripes: int, threads: int,
                 smem: int = 0, set_each: bool = False):
    """A call that launches an empty kernel on x's card and stream as a
    form of recursive doubling is launched: n * stripes blocks of
    ``threads``, cooperative, or in clusters of n with ``smem`` bytes of
    dynamic shared memory (its limit set on every call with
    ``set_each``)."""
    lib = build.library("ring_allreduce_rd")
    fn = lib.ompi_ring_allreduce_rd_empty
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n, dev = x.shape[0], x.device.index or 0

    def run():
        err = fn(int(cluster), n, stripes, threads, smem, int(set_each), dev,
                 pr._raw_stream(x))
        if err:
            raise RuntimeError(f"empty launch failed: CUDA error {err}")
    return run


def empty_launches(gen) -> None:
    """The host's floor: an empty kernel launched as each rd form is at
    4 KiB per rank."""
    x = data((N, KIB), torch.float32, gen)
    stripes, threads, _ = pr._rd_plan(N, KIB, 4, 132)
    l2_stripes, l2_threads, _ = pr._rd_plan(N, KIB, 4, 132, False)
    smem = 16 * (1 + 3 * (KIB * 4 // 16 // stripes))  # the 4 KiB plan's
    runs = {
        "empty cooperative": empty_launch(x, False, l2_stripes, l2_threads),
        "empty cluster, limit set once": empty_launch(x, True, stripes,
                                                      threads, smem),
        "empty cluster, limit set every call": empty_launch(
            x, True, stripes, threads, smem, True)}
    for name, run in runs.items():
        print(f"{name}: {p50(run):.5f} ms, host {host_ms(run):.5f} ms/call",
              flush=True)
    in_turns(runs)


def sweep(gen) -> None:
    x = data((N, GIB // 4), torch.float32, gen)
    configs = {"clone": lambda: x.clone()}
    for piece in (16 * KIB, 64 * KIB, 256 * KIB):
        for threads, per_sm in ((256, 2), (512, 2), (1024, 1), (256, 4),
                                (512, 1)):
            run = (lambda piece=piece, threads=threads, per_sm=per_sm:
                   pr._gather_launch(x, ROOT, piece, threads, per_sm))
            if not torch.equal(run(), x):
                raise AssertionError(f"gather sweep {piece} {threads}")
            configs[f"gather piece {piece} threads {threads} x "
                    f"{per_sm}/SM"] = run
    in_turns(configs)
    configs = {"clone": lambda: x.clone()}
    for publish in (1, 2, 4, 8, 16, 64):
        for piece, per_sm in ((64 * KIB, 2), (16 * KIB, 4)):
            run = (lambda piece=piece, per_sm=per_sm, publish=publish:
                   pr._gather_launch(x, ROOT, piece, 256, per_sm, publish))
            if not torch.equal(run(), x):
                raise AssertionError(f"gather sweep publish {publish}")
            configs[f"gather piece {piece} x {per_sm}/SM publishing every "
                    f"{publish}"] = run
    in_turns(configs)
    del x, configs
    torch.cuda.empty_cache()
    x = data((N, KIB), torch.float32, gen)
    want = pr.ring_allreduce_rd_plain(x, "sum")
    configs = {"rd l2": lambda: pr._rd_launch(x, "sum", cluster=False)}
    for stripe in (256, 1 * KIB, 2 * KIB, 4 * KIB):
        run = (lambda stripe=stripe: pr._rd_launch(x, "sum",
                                                   stripe_bytes=stripe))
        if not torch.equal(run(), want):
            raise AssertionError(f"rd sweep {stripe}")
        configs[f"rd cluster stripe {stripe} B"] = run
    in_turns(configs)


def main() -> int:
    if not torch.cuda.is_available():
        print("gather_rd_check: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    names = ("linear_gather", "ring_allreduce_rd")
    build.build(names)
    build.build(("linear_gather",), PROBE)
    for name in names:
        for line in build.BUILD_LOGS[name].splitlines():
            if any(w in line for w in ("Used", "spill", "error", "warning")):
                print(f"[build] {name}: {line.strip()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = rd_sizes(gen)
    empty_launches(gen)
    bad += gather_sizes(gen)
    if "--sweep" in sys.argv[1:]:
        sweep(gen)
    print(f"bad {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
