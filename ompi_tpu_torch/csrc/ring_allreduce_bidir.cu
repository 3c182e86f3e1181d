// ring_allreduce_bidir: the bidirectional ring allreduce on Hopper, one
// pass per step in each direction (fold, then forward).
//
// Replaces ompi_tpu/coll/pallas_ring.py:_allreduce_bidir_kernel (wrapper
// ring_allreduce_bidir, used by allreduce_block_bidir): every ring block
// of W columns splits at half = W/2; columns [0, half) run the ring to
// the right (rank r sends to r+1, as ring_allreduce), columns [half, W)
// to the left (r sends to r-1, blocks folded in the mirrored order,
// blk = r - d(step+2)), 2(n-1) steps each, at the same time.
//
// Bound: bytes, as the ring: 2 n B for B bytes per rank (1 MiB over 8
// ranks: 0.005 ms at 3.35 TB/s). On a TPU the two directions use both
// directions of each link; on one card both share one HBM, so at the
// sizes it runs what sets the time is, as for ring_allreduce, the chain
// of 2(n-1) dependent handovers and the host work around one launch. The
// first port ran a two-pass ring schedule (since removed) in each
// direction (a copy into the neighbour's slot, then the fold; a seed
// copy; a fence on every thread; sleeping waits), and its wrapper
// allocated and zeroed new flags and comm on every call.
//
// Design: the two directions are two groups of n x stripes thread blocks
// of one cooperative launch, each running ring_common.cuh's ring_fused
// (ring_allreduce's one-pass body) with its `dir` on its half of the
// columns, with its own comm slots and its own flags. The reference
// drives both directions from one core, step by step; here neither ever
// waits on the other. At n = 2 both directions signal the same
// neighbour, so a shared flag array would let one direction's signal
// satisfy the other's wait: the flags are two arrays. Credits are
// ring_allreduce's (after the pass that read the slot; no post-seed
// credit): the reference's post-seed credit and credit after filling,
// pallas_ring.py:664-668 and :700-705, race as the ring's do (ROADMAP
// Queue 3). The wrapper reuses zeroed flags and comm per stream and
// passes the raw stream (pallas_ring._bidir_launch); stripes and threads
// come from a sweep (pallas_ring._bidir_plan).
#include "ring_common.cuh"

namespace ompi_ring {

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    ring_allreduce_bidir_kernel(const T* __restrict__ x, T* __restrict__ out,
                                T* comm, int* sems, int n, int stripes,
                                long long W, long long half) {
  constexpr long long E = 16 / sizeof(T);
  const int d = blockIdx.x / (n * stripes);  // 0: rightward, 1: leftward
  const long long hv = half / E;              // vectors per half
  const long long sv = (hv + stripes - 1) / stripes;
  ring_fused<T, OP>(reinterpret_cast<const uint4*>(x) + d * hv,
                    reinterpret_cast<uint4*>(out) + d * hv,
                    reinterpret_cast<uint4*>(comm) +
                        (long long)d * n * stripes * 2 * sv,
                    sems + d * n * stripes * kRingFlags, n, stripes, W / E,
                    hv, d ? -1 : 1, blockIdx.x % (n * stripes));
}

}  // namespace ompi_ring

// x, out: (n, n, W) rank-major ring blocks, W = 2 * half, half a whole
// number of 16-byte vectors; comm: (2, n, stripes, 2, sv) vectors, sv =
// ceil(half / 16 B per vector / stripes); sems: (2, n, stripes, 4)
// int32, all 0 at entry and left at 0. Launches 2 x n x stripes blocks
// of `threads` (at most 1024). Returns the CUDA error of the launch (0
// on success).
extern "C" int ompi_ring_allreduce_bidir(const void* x, void* out,
                                         void* comm, void* sems, int n,
                                         int stripes, int threads,
                                         long long W, long long half, int op,
                                         int dtype, int device,
                                         void* stream) {
  using namespace ompi_ring;
  if (threads < 32 || threads > kThreads || W != 2 * half)
    return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&x, &out, &comm, &sems, &n, &stripes, &W, &half};
  return launch_cooperative(
      OMPI_RING_PICK(ring_allreduce_bidir_kernel)(op, dtype),
      2 * n * stripes, threads, args, device, stream);
}
