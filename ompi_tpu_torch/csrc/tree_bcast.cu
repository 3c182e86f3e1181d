// tree_bcast: the binomial-tree broadcast from a root on Hopper, as a
// segmented "get" tree with every round at once.
//
// Replaces ompi_tpu/coll/pallas_ring.py:_tree_bcast_kernel (wrapper
// tree_bcast, used by PallasColl.bcast through bcast_block). Ranks are
// numbered relative to the root, rel = (r - root) mod n. In the
// reference, round k has every rel < 2^k with rel + 2^k < n store its
// row into rel + 2^k's row; after ceil(log2 n) rounds every row holds
// the root's. So rel's parent is rel - highbit(rel) and its children
// are rel + 2^k for every 2^k > rel with rel + 2^k < n
// (pallas_ring.bcast_children).
//
// Bound: bytes. The root's row is read once and n rows are written:
// (n + 1) * B for B bytes per rank, 2.885 ms at 1 GiB per rank and n = 8
// on an H100 (3.35 TB/s); 2 n * B = 5.128 ms if every child read its
// parent's row from HBM. The first port ran the rounds one after another
// on 16 blocks per rank (a round sent a whole row), moved 4 bytes per
// thread, and had every rank copy its own input into its output first
// (the reference's out_ref[:] = x_ref[:]), 7 GiB of traffic that the
// rounds then overwrote.
//
// What this design does about it:
// - Get: the root copies x[root] into out[root]; every other rank reads
//   its parent's finished row of out and writes its own. No rank writes
//   another rank's row, so the reference's "ready" handshake, which
//   guarded the receiver's initial self-copy, goes, and so does the
//   self-copy: every non-root row is overwritten with the root's bits
//   anyway, so the output is bitwise the reference's.
// - Segments: rows are cut into segments of `seg` bytes (whole 16-byte
//   vectors). A rank's blocks take its segments round-robin; after
//   writing a segment a block raises one flag per child of its rank for
//   that segment, and each child waits for its flag before copying. So
//   all rounds run at once, each flag is awaited exactly once and ends
//   at 0 (block_publish / raise_flag / acquire_flag).
// - One pass in 16-byte vectors: every rank reads one row and writes
//   one. A row a child still has to read is stored evict-last and read
//   evict-first (l2_policy), so a parent's segment is read from L2 while
//   the child keeps pace; x[root] is read and the leaves' rows written
//   as streams.
// - Blocks: an equal split of the resident grid over the ranks (every
//   rank moves the same two rows), passed as `per_rank`; segments, threads
//   and blocks per SM from a sweep (pallas_ring.BCAST_*).
// The launch is cooperative (every block resident, so a spin cannot
// starve the block it waits for), and a wait of 30 s traps. On an H100
// (PERF.md, rs_bcast_check.py) it takes 3.9-4.2 ms at 1 GiB per rank and
// n = 8 (the first port 31.5; x[root].expand_as(x) 6.8), 2.3-2.5 TB/s of
// the (n + 1) B bytes, and 0.020-0.024 ms at 4 KiB.
#include "ring_common.cuh"

namespace ompi_ring {

constexpr int kBcastUnroll = 4;

__global__ void __launch_bounds__(kThreads)
    tree_bcast_kernel(const uint4* __restrict__ x, uint4* out, int* sems,
                      int n, int per_rank, long long row_v, long long seg_v,
                      int n_segs, int root) {
  const int rel = blockIdx.x / per_rank;
  const int j = blockIdx.x % per_rank;
  const int me = (rel + root) % n;
  // Highest set bit of rel; children start at the next power of two.
  const int high = rel ? 1 << (31 - __clz(rel)) : 0;
  const int first = rel ? 2 * high : 1;
  const bool parent_of_some = rel + first < n;
  const uint4* src = rel ? out + (long long)((rel - high + root) % n) * row_v
                         : x + (long long)me * row_v;
  uint4* o = out + (long long)me * row_v;
  const unsigned long long read_once = l2_policy(false);
  const unsigned long long keep = l2_policy(true);
#ifdef OMPI_RING_PROBE
  unsigned long long waited = 0;  // probe: ns thread 0 spent waiting
#endif
  OMPI_PROBE(0);

  for (int s = j; s < n_segs; s += per_rank) {
    const long long v0 = (long long)s * seg_v;
    const long long vn = (v0 + seg_v < row_v ? v0 + seg_v : row_v) - v0;
    if (rel) {
      if (threadIdx.x == 0) {
#ifdef OMPI_RING_PROBE
        const unsigned long long w0 = global_ns();
#endif
        acquire_flag(sems + (long long)(rel - 1) * n_segs + s);
#ifdef OMPI_RING_PROBE
        waited += global_ns() - w0;
#endif
      }
      __syncthreads();
    }
    for (long long i = threadIdx.x; i < vn;
         i += (long long)kBcastUnroll * blockDim.x) {
      uint4 v[kBcastUnroll];
#pragma unroll
      for (int u = 0; u < kBcastUnroll; ++u) {
        const long long k = i + (long long)u * blockDim.x;
        if (k < vn)
          v[u] = rel ? ld_child(src + v0 + k, read_once) : __ldcs(src + v0 + k);
      }
#pragma unroll
      for (int u = 0; u < kBcastUnroll; ++u) {
        const long long k = i + (long long)u * blockDim.x;
        if (k >= vn) continue;
        if (parent_of_some)
          st_child(o + v0 + k, v[u], keep);  // children read it
        else
          __stcs(o + v0 + k, v[u]);  // a leaf's row: never read here
      }
    }
    if (parent_of_some) {
      block_publish();
      if (threadIdx.x == 0)
        for (int bit = first; rel + bit < n; bit <<= 1)
          raise_flag(sems + (long long)(rel + bit - 1) * n_segs + s);
    }
  }
  __syncthreads();
  OMPI_PROBE(1);
  OMPI_PROBE_AT(2, waited);
}

}  // namespace ompi_ring

// x, out: (n, row) rank-major, `row` bytes per rank, a whole number of
// 16-byte vectors, both 16-byte aligned; seg: bytes per segment, a
// multiple of 16; sems: (n - 1, n_segs) int32, all 0 at entry and left
// at 0; per_rank blocks of `threads` threads (at most 1024) per rank,
// the grid resident. Moves bytes, so it takes any dtype. Returns the
// CUDA error of the launch (0 on success).
extern "C" int ompi_tree_bcast(const void* x, void* out, void* sems, int n,
                               int per_rank, int threads, long long row,
                               long long seg, int n_segs, int root,
                               int device, void* stream) {
  using namespace ompi_ring;
  if (n < 1 || per_rank < 1 || threads < 32 || threads > kThreads ||
      (row | seg) & 15)
    return (int)cudaErrorInvalidValue;
  long long row_v = row / 16, seg_v = seg / 16;
  void* args[] = {(void*)&x, &out,  &sems,   &n,   &per_rank,
                  &row_v,    &seg_v, &n_segs, &root};
  return launch_cooperative((const void*)tree_bcast_kernel, n * per_rank,
                            threads, args, device, stream);
}
