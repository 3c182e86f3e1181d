// tree_reduce: the binomial-tree reduce to a root on Hopper, as a
// segmented, rate-balanced "get" tree.
//
// Replaces ompi_tpu/coll/pallas_ring.py:_tree_reduce_kernel (wrapper
// tree_reduce, used by PallasColl.reduce through reduce_block). Ranks
// are numbered relative to the root, rel = (r - root) mod n. In round k
// a rank whose rel has lowest set bit 2^k sends its accumulator to
// rel - 2^k and leaves; its parent folds combine(acc, arrival), the
// accumulator on the left, children in ascending round order. Row root
// of out ends with the reduction, every other row with that rank's
// partial accumulator, as in the reference.
//
// Bound: bytes. The function needs each input read once and the root's
// row written once, (n + 1) * B for B bytes per rank; writing all n rows,
// as the reference's contract does, makes the floor 2 n * B. The first
// port striped each rank over equal blocks and sent a whole row per
// round: the rounds ran one after another (a child signalled only after
// its whole row), a child copied its row into a comm slot and the parent
// folded it in a second pass, and most SMs sat idle after their round.
//
// What this design does about it:
// - Segments: each row is cut into segments of `seg` columns (whole
//   16-byte vectors). A rank's blocks take its segments round-robin and
//   raise one flag per (sender, segment) as each is done, so a parent
//   folds segment i while its children work on later ones: every round
//   runs at once.
// - Get: a parent reads a child's finished row of out straight from
//   HBM (ld.cg, after the flag's acquire), so there is no comm scratch
//   (7 GiB at 1 GiB per rank and n = 8). A child never writes its row
//   again after raising a segment's flag.
// - One pass: out[me] = fold(x[me], child_1, child_2, ...) in registers,
//   16-byte vectors, one store: every input read once, every row written
//   once, every non-root row read once by its parent (from L2 when the
//   parent keeps pace).
// - Blocks in proportion to bytes: relative rank rel moves (2 + its
//   children) rows, and the host splits the grid by those weights
//   (pallas_ring.tree_blocks), passed here as per-rank block counts.
// - L2 policies keep the child rows not yet read in L2 (l2_policy).
// The launch is cooperative (every block resident, so a spin cannot
// starve the block it waits for), every flag ends at 0, and a wait of
// 30 s traps. On an H100 (PERF.md, tree_check.py) it takes 7.6-8.8 ms at 1 GiB
// per rank and n = 8 (the first port 56 ms), about 2 TB/s of the 2 n B
// bytes, at every segment size from 8 Ki to 32 Ki columns and every
// block shape tried; the parents wait for their children 30-50% of it.
#include "ring_common.cuh"

namespace ompi_ring {

constexpr int kTreeMaxRanks = 512;
constexpr int kTreeUnroll = 4;

// Blocks [first[rel], first[rel + 1]) of the grid play relative rank rel.
struct TreeSplit {
  int first[kTreeMaxRanks + 1];
};

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads, 1)
    tree_reduce_kernel(const T* __restrict__ x, T* out, int* sems,
                       const TreeSplit split, int n, long long L,
                       long long seg, int n_segs, int root) {
  int rel = 0;
  while ((int)blockIdx.x >= split.first[rel + 1]) ++rel;
  const int j = blockIdx.x - split.first[rel];
  const int g = split.first[rel + 1] - split.first[rel];
  const int me = (rel + root) % n;
  // Children: rel + bit for every bit below rel's lowest set bit (every
  // bit, for the root) while rel + bit < n, in ascending round order.
  const int low = rel ? (rel & -rel) : n;
  constexpr long long E = 16 / sizeof(T);  // elements per vector
  const long long row_v = L / E, seg_v = seg / E;
  const uint4* xr = reinterpret_cast<const uint4*>(x) + me * row_v;
  uint4* o = reinterpret_cast<uint4*>(out) + me * row_v;
  const uint4* rows = reinterpret_cast<const uint4*>(out);
  const unsigned long long read_once = l2_policy(false);
  const unsigned long long keep = l2_policy(true);
#ifdef OMPI_RING_PROBE
  unsigned long long waited = 0;  // probe: ns thread 0 spent waiting
#endif
  OMPI_PROBE(0);

  for (int s = j; s < n_segs; s += g) {
    const long long v0 = (long long)s * seg_v;
    const long long vn = (v0 + seg_v < row_v ? v0 + seg_v : row_v) - v0;
    if (threadIdx.x == 0) {
#ifdef OMPI_RING_PROBE
      const unsigned long long t = global_ns();
#endif
      for (int bit = 1; bit < low && rel + bit < n; bit <<= 1)
        acquire_flag(sems + (long long)(rel + bit - 1) * n_segs + s);
#ifdef OMPI_RING_PROBE
      waited += global_ns() - t;
#endif
    }
    __syncthreads();
    for (long long i = threadIdx.x; i < vn;
         i += (long long)kTreeUnroll * blockDim.x) {
      uint4 acc[kTreeUnroll];
#pragma unroll
      for (int u = 0; u < kTreeUnroll; ++u) {
        const long long k = i + (long long)u * blockDim.x;
        if (k < vn) acc[u] = __ldcs(xr + v0 + k);  // read once
      }
      for (int bit = 1; bit < low && rel + bit < n; bit <<= 1) {
        const uint4* c = rows + (long long)((rel + bit + root) % n) * row_v +
                         v0;
        uint4 b[kTreeUnroll];
#pragma unroll
        for (int u = 0; u < kTreeUnroll; ++u) {
          const long long k = i + (long long)u * blockDim.x;
          if (k < vn) b[u] = ld_child(c + k, read_once);
        }
#pragma unroll
        for (int u = 0; u < kTreeUnroll; ++u) {
          const long long k = i + (long long)u * blockDim.x;
          if (k < vn) acc[u] = combine_vec<T, OP>(acc[u], b[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kTreeUnroll; ++u) {
        const long long k = i + (long long)u * blockDim.x;
        if (k >= vn) continue;
        if (rel)
          st_child(o + v0 + k, acc[u], keep);  // the parent reads it
        else
          __stcs(o + v0 + k, acc[u]);  // the result: never read here
      }
    }
    if (rel) {
      block_publish();
      if (threadIdx.x == 0)
        raise_flag(sems + (long long)(rel - 1) * n_segs + s);
    }
  }
  __syncthreads();
  OMPI_PROBE(1);
  OMPI_PROBE_AT(2, waited);
}

}  // namespace ompi_ring

// x, out: (n, L) rank-major, L a whole number of 16-byte vectors and
// seg a multiple of the vector; sems: (n - 1, n_segs) int32, all 0 at
// entry and left at 0; counts: blocks per relative rank (host memory),
// at least one each, of `threads` threads (at most 1024; the grid must
// be resident). Returns the CUDA error of the launch (0 on success).
extern "C" int ompi_tree_reduce(const void* x, void* out, void* sems,
                                const int* counts, int n, int threads,
                                long long L, long long seg, int n_segs,
                                int root, int op, int dtype, int device,
                                void* stream) {
  using namespace ompi_ring;
  if (n < 1 || n > kTreeMaxRanks || threads < 32 || threads > kThreads)
    return (int)cudaErrorInvalidValue;
  TreeSplit split;
  split.first[0] = 0;
  for (int r = 0; r < kTreeMaxRanks; ++r)
    split.first[r + 1] = split.first[r] + (r < n ? counts[r] : 0);
  void* args[] = {(void*)&x, &out, &sems, &split, &n,
                  &L,        &seg, &n_segs, &root};
  return launch_cooperative(OMPI_RING_PICK(tree_reduce_kernel)(op, dtype),
                            split.first[n], threads, args, device, stream);
}
