"""Split the whole-payload ring allreduce's time on a CUDA card into host
work, launch and device time, and the device time into its steps.

Run from the repository root on a machine with a card and ``nvcc``:
``python3 -m ompi_tpu_torch.tools.ring_probe [--sweep]``. At 1 MiB per
rank over 8 ranks, float32 SUM (the ring's size on ``chip_smoke.py``'s
main path), on the wrapper's own layout, it prints:

- the card's name and power limit;
- ``window``: the p50 of 20 calls of ``pallas_ring.ring_allreduce``
  between two CUDA events, as ``chip_smoke.py`` times a kernel;
- ``host``: the p50 host time of one call (the card idle, so the call
  only enqueues);
- from ``torch.profiler`` over 20 calls, each p50: the ring kernel's
  device time, the other kernels a call launches, the launch call's host
  time, the gap from the call's start to the kernel's start and from the
  launch call to the kernel's start;
- from a probe build (``-DOMPI_RING_PROBE``: thread 0 of every block
  stamps ``%globaltimer`` after each step's waits and after its pass),
  p50 over 5 launches: the span from the first block's start to the last
  block's end, each block's first step, and per later step the time
  waiting (from the previous pass's end to the arrival) and the pass.

- ``host piece``: the mean host time of each piece of the wrapper's
  work, over 2000 repeats (the card idle).

``--sweep`` adds the p50 of 20 launches at every stripes x threads pair
(stripes 1, 2, 4, 8, 16; threads 256, 512, 1024) at 64 KiB, 1 MiB and
4 MiB per rank, each checked bitwise against the default launch, the
pairs taken in turns over five rounds (the median of rounds). The
profiler's trace goes to ``_archive/traces/ring_probe_trace.json``.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import torch

from ompi_tpu_torch.coll import pallas_ring as pr
from ompi_tpu_torch.core import build

N, BYTES, REPS = 8, 1 << 20, 20
PROBE = ("OMPI_RING_PROBE",)
TRACE = os.path.join("_archive", "traces", "ring_probe_trace.json")


def p50_window(fn, reps=REPS) -> float:
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


def p50_host_ms(fn, reps=REPS) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


PROFILE_TRIES = 3


def profile(fn, kernel: str = "ring_allreduce", trace: str = TRACE) -> dict:
    """p50s (ms) of one call's pieces, read from the profiler's trace:
    the device time of each kernel (or device-to-device copy, as
    ``x.clone()`` makes one) the call launches (the one whose name holds
    ``kernel`` as "kernel device"), the host time of its launch call, and
    the gaps from the call's start and from the launch call to that
    kernel's start."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx, \
        record_function

    fn()
    torch.cuda.synchronize()
    # On the card's machine a profiling session now and then records no
    # device activity at all (the session before and after do): such a
    # session is profiled again, up to PROFILE_TRIES times.
    for _ in range(PROFILE_TRIES):
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                with record_function("probe_call"):
                    fn()
                torch.cuda.synchronize()
        os.makedirs(os.path.dirname(trace), exist_ok=True)
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy")]
        if kernels:
            break
    else:
        return {"device_events": 0}
    calls = [e for e in events if e.get("name") == "probe_call"
             and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "cuda_runtime" and "correlation" in
               e.get("args", {})}
    pieces: dict = {}
    for call in calls:
        t0, t1 = call["ts"], call["ts"] + call["dur"]
        for k in kernels:
            api = runtime.get(k["args"].get("correlation"))
            if api is None or not t0 <= api["ts"] <= t1:
                continue
            ring = kernel in k["name"]
            name = "kernel" if ring else k["name"][:60]
            pieces.setdefault(f"{name} device", []).append(k["dur"])
            if ring:
                pieces.setdefault("launch call host", []).append(api["dur"])
                pieces.setdefault("call start to kernel start", []).append(
                    k["ts"] - t0)
                pieces.setdefault("launch call to kernel start", []).append(
                    k["ts"] - api["ts"])
        pieces.setdefault("call host", []).append(call["dur"])
    return {k: statistics.median(v) / 1e3 for k, v in pieces.items()}


def stamps(inp) -> dict:
    """p50s (ms) of the probe build's step times over 5 launches."""
    lib = build.library("ring_allreduce", PROBE)
    lib.ompi_probe_set.argtypes = [pr.ctypes.c_void_p]
    lib.ompi_probe_set.restype = pr.ctypes.c_int
    cap = torch.cuda.get_device_properties(0).multi_processor_count
    buf = torch.zeros((cap, 64), dtype=torch.int64, device="cuda")
    if lib.ompi_probe_set(buf.data_ptr()):
        raise RuntimeError("ompi_probe_set failed")
    want = pr.ring_allreduce(inp, "sum")
    runs = []
    for _ in range(5):
        buf.zero_()
        got = pr._ring_launch(inp, "sum", defines=PROBE)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError("probe build != kernel")
        t = buf.cpu()
        used = t[t[:, 0] != 0]
        nst = int((used[0] != 0).sum()) - 1  # stamps after the start
        steps = nst // 2
        start = used[:, 0]
        wait = [used[:, 1 + 2 * k] - used[:, 2 * k] for k in range(steps)]
        pas = [used[:, 2 + 2 * k] - used[:, 1 + 2 * k] for k in range(steps)]
        runs.append({
            "blocks": used.shape[0], "steps": steps,
            "span": float(used[:, 2 * steps].max() - start.min()),
            "start spread": float(start.max() - start.min()),
            "step 0": float((wait[0] + pas[0]).double().median()),
            "later step": float(torch.stack(
                [w + p for w, p in zip(wait[1:], pas[1:])]).double()
                .median()) if steps > 1 else 0.0,
            "later wait": float(torch.stack(wait[1:]).double().median())
            if steps > 1 else 0.0,
            "later pass": float(torch.stack(pas[1:]).double().median())
            if steps > 1 else 0.0,
        })
    lib.ompi_probe_set(None)
    out = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    return {k: (v if k in ("blocks", "steps") else v / 1e6)
            for k, v in out.items()}


def host_pieces(inp) -> dict:
    """Mean host µs of each piece of the ring wrapper's work."""
    dev = inp.device
    fn = pr._entry("ring_allreduce")
    pieces = {
        "op_lookup": lambda: pr.op_lookup("sum"),
        "require_kernel_device": lambda: pr.require_kernel_device(inp),
        "empty_like (output)": lambda: torch.empty_like(inp),
        "zeros (flags)": lambda: torch.zeros(256, dtype=torch.int32,
                                             device=dev),
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw stream": lambda: pr._raw_stream(inp),
        "data_ptr x4": lambda: (inp.data_ptr(), inp.data_ptr(),
                                inp.data_ptr(), inp.data_ptr()),
        "ctypes entry lookup": lambda: pr._entry("ring_allreduce"),
        "ctypes call, invalid threads (no launch)": lambda: fn(
            0, 0, 0, 0, 8, 1, 0, 0, 0, 0, 0, None),
        "whole wrapper": lambda: pr.ring_allreduce(inp, "sum"),
    }
    out = {}
    for name, piece in pieces.items():
        piece()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            piece()
        out[name] = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    return out


def sweep(gen) -> None:
    """Per size, each stripes x threads pair's p50 (ms), the pairs taken
    in turns over five rounds: the median of rounds."""
    for nbytes in (64 << 10, BYTES, 4 << 20):
        x = torch.randn((N, nbytes // 4), generator=gen, device="cuda")
        inp, _, _ = pr._split_ring(x)
        want = pr.ring_allreduce(inp, "sum")
        times: dict = {}
        for _ in range(5):
            times.setdefault("default", []).append(
                p50_window(lambda: pr.ring_allreduce(inp, "sum")))
            for stripes in (1, 2, 4, 8, 16):
                for threads in (256, 512, 1024):
                    run = lambda: pr._ring_launch(  # noqa: E731
                        inp, "sum", stripes, threads)
                    if not torch.equal(run(), want):
                        raise AssertionError(f"{stripes} x {threads}: wrong")
                    times.setdefault((stripes, threads), []).append(
                        p50_window(run))
        for key, t in times.items():
            print(f"sweep {nbytes} B/rank {key}: {statistics.median(t):.5f}"
                  f" ms", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("ring_probe: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.time()
    build.build(["ring_allreduce"])
    build.build(["ring_allreduce"], PROBE)
    print(f"build {time.time() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((N, BYTES // 4), generator=gen, device="cuda")
    inp, _, _ = pr._split_ring(x)
    fn = lambda: pr.ring_allreduce(inp, "sum")  # noqa: E731
    want = pr.ring_allreduce_plain(inp, "sum")
    if not torch.equal(fn(), want):
        raise AssertionError("kernel != plain")
    print(f"window p50 {p50_window(fn):.5f} ms; host p50 "
          f"{p50_host_ms(fn):.5f} ms", flush=True)
    for k, v in profile(fn).items():
        print(f"profiler {k}: {v:.5f} ms", flush=True)
    for k, v in stamps(inp).items():
        print(f"stamps {k}: {v:.5f}" + ("" if k in ("blocks", "steps")
                                         else " ms"), flush=True)
    for k, v in host_pieces(inp).items():
        print(f"host piece {k}: {v:.2f} us", flush=True)
    if "--sweep" in sys.argv:
        sweep(gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
