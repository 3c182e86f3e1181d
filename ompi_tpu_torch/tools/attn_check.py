"""Build ring attention's kernel and hold it against its plain version
on a CUDA card, then time it at the slice's shape.

Run from the repository root on a machine with a card and ``nvcc``:
``python3 -m ompi_tpu_torch.tools.attn_check [dtype]`` (``bfloat16``,
``float16`` or ``float32`` to check one dtype). Prints the compiler's
register and spill lines, one line per small shape (error over its
limit, flags left, launch-to-launch equality, block split), then the
p50 of 10 launches at 32 heads of 128 over S = 4096 on 8 ranks and on
one rank (the same sequence with no ring), causal and not, and a last
line ``bad N``. Exits 3 after a launch failure.
"""

import statistics
import sys
import time
import traceback

import torch

from ompi_tpu_torch.coll import pallas_attn as pa
from ompi_tpu_torch.core import build

TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (1e-5, 2.0 ** -7),
       torch.float16: (1e-5, 2.0 ** -10)}
SHAPES = [(4, 8, 2, 128), (3, 100, 3, 24), (1, 70, 2, 64), (8, 64, 4, 256),
          (8, 512, 2, 128)]


def p50(fn, reps=10):
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


def blocks(shape, dtype, causal):
    return pa._plan(*shape, pa._DTYPE_CODES[dtype], causal, 0)[0]


def check(shape, dtype, causal) -> bool:
    gen = torch.Generator(device="cuda").manual_seed(shape[0] * shape[1])
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    got = pa.ring_attention_block(q, k, v, causal)
    torch.cuda.synchronize()
    left = int(pa.ATTN.last_sems.abs().sum())
    want = pa.ring_attention_block_plain(q, k, v, causal)
    atol, rtol = TOL[dtype]
    err = (got.float() - want.float()).abs()
    ratio = float((err / (atol + rtol * want.float().abs())).max())
    same = torch.equal(pa.ring_attention_block(q, k, v, causal), got)
    ok = (ratio <= 1 and left == 0 and same
          and bool(got.isfinite().all()))
    print(f"{'OK ' if ok else 'BAD'} {shape} {str(dtype)[6:]} "
          f"causal={causal}: ratio {ratio:.3g} max err "
          f"{float(err.max()):.3g} sems {left} repeat {same} blocks "
          f"{blocks(shape, dtype, causal)}", flush=True)
    return ok


def main() -> int:
    only = sys.argv[1] if len(sys.argv) > 1 else ""
    dtypes = [d for d in TOL if only in str(d)]
    t0 = time.time()
    build.build(["ring_attention"])
    print(f"build {time.time() - t0:.1f} s")
    for line in build.BUILD_LOGS["ring_attention"].splitlines():
        if any(w in line for w in ("Used", "spill", "error", "warning")):
            print(line.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    bad = 0
    for shape in SHAPES:
        for dtype in dtypes:
            for causal in (True, False):
                try:
                    bad += not check(shape, dtype, causal)
                except Exception:  # a launch failure ends the run
                    traceback.print_exc()
                    return 3
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in dtypes:
        if dtype == torch.float16:
            continue
        q, k, v = (torch.randn((8, 512, 32, 128), generator=gen,
                               device="cuda").to(dtype) for _ in range(3))
        q1, k1, v1 = (x.reshape(1, 4096, 32, 128) for x in (q, k, v))
        for causal in (True, False):
            ms1 = p50(lambda: pa.ring_attention_block(q1, k1, v1, causal))
            print(f"n=1 S=4096 {str(dtype)[6:]} causal={causal}: "
                  f"{ms1:.4f} ms p50", flush=True)
            ms = p50(lambda: pa.ring_attention_block(q, k, v, causal))
            print(f"n=8 {str(dtype)[6:]} causal={causal}: {ms:.4f} ms p50, "
                  f"blocks {blocks((8, 512, 32, 128), dtype, causal)}",
                  flush=True)
    print("bad", bad)
    return 0


if __name__ == "__main__":
    sys.exit(main())
