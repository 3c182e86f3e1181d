// ring_allreduce_bidir: the bidirectional ring allreduce on Hopper.
//
// Replaces ompi_tpu/coll/pallas_ring.py:_allreduce_bidir_kernel (wrapper
// ring_allreduce_bidir, used by allreduce_block_bidir): every ring block
// of W columns splits at half = W/2; columns [0, half) run the ring to
// the right (rank r sends to r+1, as ring_allreduce), columns [half, W)
// to the left (r sends to r-1, blocks folded in the mirrored order), 2(n-1)
// steps each, at the same time.
//
// Design: the two directions are two groups of n x stripes thread blocks
// of one cooperative launch, each running ring_common.cuh's
// ring_schedule with its `dir` on its half of the columns, with its own
// comm slots and its own flags. The reference drives both directions
// from one core, step by step; here neither ever waits on the other. At
// n = 2 both directions signal the same neighbour, so a shared flag
// array would let one direction's signal satisfy the other's wait: the
// flags are two arrays. Credits are the port's send-then-credit
// placement in each direction (the reference's post-seed credit and
// credit after filling, pallas_ring.py:664-668 and :700-705, race as
// the ring's do; ROADMAP Queue 3).
//
// Bound: bytes, as the ring: 2 n B for B bytes per rank. On a TPU the
// two directions use both directions of each link; on one card both
// share one HBM, so the bytes and the bound are the ring's. What the
// design does about it: the same striping, with twice as many blocks of
// half the width, so n x stripes x 2 <= SM count.
#include "ring_common.cuh"

namespace ompi_ring {

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    ring_allreduce_bidir_kernel(const T* __restrict__ x, T* __restrict__ out,
                                T* comm, int* sems, int n, int stripes,
                                long long W, long long half) {
  const int d = blockIdx.x / (n * stripes);  // 0: rightward, 1: leftward
  const long long sw = (half + stripes - 1) / stripes;
  const long long col0 = d ? half : 0;
  ring_schedule<T, OP, false, PH_BOTH>(
      x + col0, out + col0, comm + (long long)d * n * stripes * 2 * sw,
      sems + d * n * stripes * RING_NSEM, n, stripes, W, half, 1,
      d ? -1 : 1);
}

}  // namespace ompi_ring

// x, out: (n, n, W) rank-major ring blocks, W = 2 * half; comm: (2, n,
// stripes, 2, sw); sems: (2, n, stripes, 5) int32, zeroed by the caller.
// Launches 2 x n x stripes blocks. Returns the CUDA error of the launch
// (0 on success).
extern "C" int ompi_ring_allreduce_bidir(const void* x, void* out,
                                         void* comm, void* sems, int n,
                                         int stripes, long long W,
                                         long long half, int op, int dtype,
                                         int device, void* stream) {
  void* args[] = {(void*)&x, &out, &comm, &sems, &n, &stripes, &W, &half};
  return ompi_ring::launch_cooperative(
      OMPI_RING_PICK(ompi_ring::ring_allreduce_bidir_kernel)(op, dtype),
      2 * n * stripes, args, device, stream);
}
