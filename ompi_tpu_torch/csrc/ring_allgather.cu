// ring_allgather: the ring allgather on Hopper.
//
// Replaces ompi_tpu/coll/pallas_ring.py:_allgather_kernel (wrapper
// ring_allgather, used by PallasColl.allgather and by
// allreduce_block_rsag): each rank seeds slot 0 with its own block and
// stores it as its own output row; in n-1 steps every block travels once
// round the ring, and at step s the block of rank (r - s - 1) arrives and
// is stored. It is the PH_AG half of ring_common.cuh's schedule, with its
// credits (after the send from a slot, no post-seed credit), not the
// reference's.
//
// Bound: bytes. Each rank's block is read once and written n times, one
// per rank: (1 + n) * B bytes for B bytes received per rank. What the
// design does about it: the same striping over resident thread blocks as
// the ring allreduce, coalesced accesses, one set of flags per stripe.
#include "ring_common.cuh"

namespace ompi_ring {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ring_allgather_kernel(const T* __restrict__ x, T* __restrict__ out,
                          T* comm, int* sems, int n, int stripes,
                          long long W) {
  // The op is never applied on this half of the schedule.
  ring_schedule<T, OP_SUM, false, PH_AG>(x, out, comm, sems, n, stripes, W,
                                         W, 1);
}

}  // namespace ompi_ring

// x: (n, W) rank-major; out: (n, n, W), row r holding every rank's block;
// comm: (n, stripes, 2, sw); sems: (n, stripes, 5) int32, zeroed by the
// caller. Returns the CUDA error of the launch (0 on success).
extern "C" int ompi_ring_allgather(const void* x, void* out, void* comm,
                                   void* sems, int n, int stripes,
                                   long long W, int dtype, int device,
                                   void* stream) {
  void* args[] = {(void*)&x, &out, &comm, &sems, &n, &stripes, &W};
  return ompi_ring::launch_cooperative(
      OMPI_DTYPE_PICK(ompi_ring::ring_allgather_kernel)(dtype),
      n * stripes, args, device, stream);
}
