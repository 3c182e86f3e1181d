// ring_allreduce: the whole-payload ring allreduce on Hopper, one pass
// per step (fold, then forward).
//
// Replaces ompi_tpu/coll/pallas_ring.py:_allreduce_kernel (wrapper
// ring_allreduce, used by allreduce_block): 2(n-1) steps, n-1 of
// reduce-scatter then n-1 of allgather, over a two-slot comm buffer per
// rank with a credit per slot.
//
// Bound: at the sizes it runs (up to the 4 MiB chunk threshold per rank)
// not bytes (1 MiB per rank over 8 ranks moves 16 MiB: 0.005 ms at 3.35
// TB/s) but the chain of 2(n-1) dependent handovers between
// neighbouring ranks, each a flag round trip through L2 plus a pass over
// a stripe, and the host work around one launch. The first port copied
// a block into the neighbour's slot and then folded the arrival in a
// second pass, and every step ran publish() (a fence on each of 1024
// threads) and two wait()s that slept between polls.
//
// What this design does about it:
// - One pass per step (ring_common.cuh's ring_fused, which the
//   bidirectional ring runs in each direction): a rank waits for the
//   arrival in its slot, computes combine(arrival, x[blk]) (the
//   reference's operands in its
//   order, pallas_ring.py:253, so the bits stay), and stores the result
//   straight into the right neighbour's next slot; at the last
//   reduce-scatter step also into out[me][me]. An allgather step stores
//   the arrival to out[blk] and forwards it, but for the last step.
// - Step 0's arrival is the left neighbour's block me-2 of its input,
//   read from x directly (x never changes): no seed copy and one
//   handover fewer, 2n-3 in all.
// - A slot is credited back to the left neighbour after the pass that
//   read it (arrivals 1 .. 2n-5: the ones whose slot the left fills
//   again); every flag ends at 0.
// - Handover: a block barrier, then one thread's gpu-scope release fence
//   and relaxed flag increments (block_publish/raise_flag); waits poll
//   with acquire loads, without sleeping for the first polls
//   (acquire_flag). This step's x block is loaded before the waits.
// - 16-byte vectors; each rank is striped over `stripes` blocks of
//   `blockDim` threads, both chosen on the host by the size
//   (pallas_ring._ring_plan, from a sweep), every block resident under
//   a cooperative launch.
// On an H100 (PERF.md, ring_probe.py) the kernel takes about 0.030 ms at 1 MiB
// per rank and n = 8 (the first port 0.071): 14 steps of 2.5 us, of
// which 1.2 us waiting for the arrival.
#include "ring_common.cuh"

namespace ompi_ring {

// One ring of ring_common.cuh's fold-then-forward body over whole ring
// blocks of C elements.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    ring_allreduce_kernel(const T* __restrict__ x, T* __restrict__ out,
                          T* comm, int* sems, int n, int stripes,
                          long long C) {
  constexpr long long E = 16 / sizeof(T);
  ring_fused<T, OP>(reinterpret_cast<const uint4*>(x),
                    reinterpret_cast<uint4*>(out),
                    reinterpret_cast<uint4*>(comm), sems, n, stripes, C / E,
                    C / E, 1, blockIdx.x);
}

}  // namespace ompi_ring

// x, out: (n, n, C) rank-major ring blocks, C a whole number of 16-byte
// vectors; comm: (n, stripes, 2, ceil(C / stripes) rounded up to whole
// vectors); sems: (n, stripes, 4) int32, all 0 at entry and left at 0.
// `threads` per block, at most 1024. Returns the CUDA error of the
// launch (0 on success).
extern "C" int ompi_ring_allreduce(const void* x, void* out, void* comm,
                                   void* sems, int n, int stripes,
                                   int threads, long long C, int op,
                                   int dtype, int device, void* stream) {
  using namespace ompi_ring;
  if (threads < 32 || threads > kThreads) return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&x, &out, &comm, &sems, &n, &stripes, &C};
  return launch_cooperative(OMPI_RING_PICK(ring_allreduce_kernel)(op, dtype),
                            n * stripes, threads, args, device, stream);
}
