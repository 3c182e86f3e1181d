"""Time ring attention's causal kernel under explicit block splits.

Run from the repository root on a machine with a card and ``nvcc``:
``python3 -m ompi_tpu_torch.tools.attn_splits [a,b,...] ...``, each
argument one split of the grid over the 8 ranks (blocks per rank);
with none, a set of splits around ``pallas_attn.split_blocks``' own.
At 32 heads of 128 over S = 4096 on 8 ranks, bfloat16: the p50 of 10
launches per split, the error over one bfloat16 ulp against the plain
version and launch-to-launch equality (the split moves no arithmetic),
then the non-causal p50 under the equal split.
"""

import statistics
import sys

import torch

from ompi_tpu_torch.coll import pallas_attn as pa

SPLITS = [None, [9, 11, 13, 15, 16, 19, 22, 26],
          [8, 11, 13, 13, 16, 19, 22, 26], [8, 10, 11, 13, 16, 22, 26, 26],
          [10, 12, 14, 15, 16, 17, 22, 26], [4, 6, 10, 14, 18, 23, 26, 31],
          [17, 17, 17, 17, 16, 16, 16, 16]]


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


def main() -> int:
    splits = ([[int(x) for x in arg.split(",")] for arg in sys.argv[1:]]
              or SPLITS)
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((8, 512, 32, 128), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    want = pa.ring_attention_block_plain(q, k, v, True).float()
    limit = 1e-5 + 2.0 ** -7 * want.abs()
    own = pa.split_blocks
    for split in splits:
        if split is not None:
            pa.split_blocks = (lambda n, total, causal, floor=1, items=0,
                               s=split: s if causal
                               else own(n, total, causal, floor, items))
        pa._plan.cache_clear()
        ms = p50(lambda: pa.ring_attention_block(q, k, v, True))
        got = pa.ring_attention_block(q, k, v, True)
        same = torch.equal(got, pa.ring_attention_block(q, k, v, True))
        ratio = float(((got.float() - want).abs() / limit).max())
        counts = pa._plan(8, 512, 32, 128, 1, True, 0)[0]
        print(f"split {counts}: causal {ms:.4f} ms, ratio {ratio:.3g}, "
              f"repeat {same}", flush=True)
        pa.split_blocks = own
    pa._plan.cache_clear()
    ms = p50(lambda: pa.ring_attention_block(q, k, v, False))
    print(f"non-causal {ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
