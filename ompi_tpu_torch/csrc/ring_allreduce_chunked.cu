// ring_allreduce_chunked: the segmented streaming ring allreduce on
// Hopper.
//
// Replaces ompi_tpu/coll/pallas_ring.py:_allreduce_chunked_kernel
// (wrapper ring_allreduce_chunked, used by allreduce_block_chunked): the
// ring of _allreduce_kernel run segment by segment over the (n, rows,
// 128) layout, with a per-segment credit primed once at start, granted
// after each segment and drained at exit.
//
// Bound: memory, as the whole-payload ring: one combine per element and
// per step, bytes over HBM bandwidth. What the design does about it:
// the same striping over resident thread blocks as ring_allreduce, and
// comm scratch bounded at n * 2 * segment bytes however large the
// message, which is why this kernel exists on a card whose "VMEM" is
// HBM: a 1 GiB-per-rank allreduce needs 16 MiB of comm slots at 1 MiB
// segments instead of 16 GiB. The reference's double-buffered HBM<->VMEM
// prefetch has no counterpart: blocks read their inputs and write their
// outputs in HBM directly.
#include "ring_common.cuh"

namespace ompi_ring {

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    ring_allreduce_chunked_kernel(const T* __restrict__ x,
                                  T* __restrict__ out, T* comm, int* sems,
                                  int n, int stripes, long long W,
                                  long long seg, int n_segs) {
  ring_schedule<T, OP, true>(x, out, comm, sems, n, stripes, W,
                                      seg, n_segs);
}

}  // namespace ompi_ring

// x, out: (n, n, W) rank-major blocks, W = n_segs * seg; comm: (n,
// stripes, 2, sw) over one segment; sems: (n, stripes, 5) int32, zeroed
// by the caller. Returns the CUDA error of the launch (0 on success).
extern "C" int ompi_ring_allreduce_chunked(const void* x, void* out,
                                           void* comm, void* sems, int n,
                                           int stripes, long long W,
                                           long long seg, int n_segs,
                                           int op, int dtype, int device,
                                           void* stream) {
  void* args[] = {(void*)&x, &out, &comm, &sems, &n, &stripes,
                  &W, &seg, &n_segs};
  return ompi_ring::launch_cooperative(
      OMPI_RING_PICK(ompi_ring::ring_allreduce_chunked_kernel)(op, dtype),
      n * stripes, args, device, stream);
}
