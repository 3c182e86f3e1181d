// ring_allreduce: the whole-payload ring allreduce on Hopper.
//
// Replaces ompi_tpu/coll/pallas_ring.py:_allreduce_kernel (wrapper
// ring_allreduce, used by allreduce_block): 2(n-1) steps, n-1 of
// reduce-scatter then n-1 of allgather, over a two-slot comm buffer per
// rank with a credit per slot.
//
// Bound: memory. Each step moves one ring block per rank and does one
// combine per element, far below the card's operation rate, so time is
// bytes over HBM bandwidth plus the per-step flag round trips. What the
// design does about it: each rank is striped over several thread blocks
// (n x stripes <= SM count, all resident under a cooperative launch) so
// every SM streams its own column stripe with coalesced accesses, and
// each stripe runs its own flags, so stripes never wait on each other.
// Comm slots live in HBM (they stand for the reference's VMEM scratch).
// This first version copies a block into the peer's slot and then
// combines it in a second pass; fusing the two is later work.
#include "ring_common.cuh"

namespace ompi_ring {

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    ring_allreduce_kernel(const T* __restrict__ x, T* __restrict__ out,
                          T* comm, int* sems, int n, int stripes,
                          long long W, long long seg, int n_segs) {
  ring_schedule<T, OP, false, PH_BOTH>(x, out, comm, sems, n, stripes, W,
                                       seg, n_segs);
}

}  // namespace ompi_ring

// x, out: (n, n, W) rank-major ring blocks; comm: (n, stripes, 2, sw);
// sems: (n, stripes, 5) int32, zeroed by the caller. Returns the CUDA
// error of the launch (0 on success).
extern "C" int ompi_ring_allreduce(const void* x, void* out, void* comm,
                                   void* sems, int n, int stripes,
                                   long long W, long long seg, int n_segs,
                                   int op, int dtype, int device,
                                   void* stream) {
  void* args[] = {(void*)&x, &out, &comm, &sems, &n, &stripes,
                  &W, &seg, &n_segs};
  return ompi_ring::launch_cooperative(
      OMPI_RING_PICK(ompi_ring::ring_allreduce_kernel)(op, dtype),
      n * stripes, args, device, stream);
}
