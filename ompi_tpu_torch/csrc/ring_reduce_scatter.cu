// ring_reduce_scatter: the ring reduce-scatter on Hopper.
//
// Replaces ompi_tpu/coll/pallas_ring.py:_reduce_scatter_kernel (wrapper
// ring_reduce_scatter, used by PallasColl.reduce_scatter_block and by
// allreduce_block_rsag): n-1 steps over a two-slot comm buffer per rank.
// Block b starts at rank b+1 as that rank's partial and travels right,
// each rank folding its own contribution onto the arrival (arrival on
// the left), so rank b ends with block b reduced over all ranks in the
// same order as the first half of ring_allreduce. It is the PH_RS half
// of ring_common.cuh's schedule, with its credits (after the send from a
// slot, no post-seed credit), not the reference's.
//
// Bound: bytes. Every rank's n blocks are read once and one block per
// rank is written, (n + 1) * B bytes for B bytes sent per rank; one
// combine per element is far below the operation rate. What the design
// does about it: each rank is striped over n x stripes <= SM count
// resident thread blocks, each streaming its own column stripe with
// coalesced accesses and its own flags, so stripes never wait on each
// other. The copy into the peer's slot and the fold on arrival are still
// two passes (fusing them is later work).
#include "ring_common.cuh"

namespace ompi_ring {

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    ring_reduce_scatter_kernel(const T* __restrict__ x, T* __restrict__ out,
                               T* comm, int* sems, int n, int stripes,
                               long long W) {
  ring_schedule<T, OP, false, PH_RS>(x, out, comm, sems, n, stripes, W, W,
                                     1);
}

}  // namespace ompi_ring

// x: (n, n, W) rank-major blocks; out: (n, W), rank r's reduced block r;
// comm: (n, stripes, 2, sw); sems: (n, stripes, 5) int32, zeroed by the
// caller. Returns the CUDA error of the launch (0 on success).
extern "C" int ompi_ring_reduce_scatter(const void* x, void* out, void* comm,
                                        void* sems, int n, int stripes,
                                        long long W, int op, int dtype,
                                        int device, void* stream) {
  void* args[] = {(void*)&x, &out, &comm, &sems, &n, &stripes, &W};
  return ompi_ring::launch_cooperative(
      OMPI_RING_PICK(ompi_ring::ring_reduce_scatter_kernel)(op, dtype),
      n * stripes, args, device, stream);
}
