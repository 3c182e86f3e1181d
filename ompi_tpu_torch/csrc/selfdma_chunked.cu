// selfdma_chunked: the one-rank case of the chunked ring allreduce on
// Hopper.
//
// Replaces ompi_tpu/coll/pallas_ring.py:_selfdma_chunked_kernel (the
// n == 1 branch of ring_allreduce_chunked): the degenerate one-member
// ring, an identity that still runs the chunked pipeline. For each
// segment si of seg_bytes bytes it copies the input segment into comm
// slot si%2 (the reference's HBM->VMEM prefetch and self-targeted
// remote copy) and then that slot into the output (the write-back). It
// moves bytes only, so it takes every dtype and is exact.
//
// Bound: bytes. The function reads its input once and writes its output
// once, 2 B for B bytes; the comm slots add another 2 B of traffic that
// mostly stays in the 50 MB L2 at 1 MiB segments. What the design does
// about it: one block per SM, each copying its own 16-byte-aligned
// stripe of every segment in 16-byte vectors where the buffers are
// aligned (element-sized units otherwise). A block reads back only the
// slot stripe it wrote, so a barrier between the two copies of a
// segment is all the ordering it needs; the blocks never wait on each
// other.
#include "ring_common.cuh"

namespace ompi_ring {

__global__ void __launch_bounds__(kThreads)
    selfdma_chunked_kernel(const char* __restrict__ x,
                           char* __restrict__ out, char* comm,
                           long long seg_bytes, int n_segs, int elem) {
  const ByteStripe st = byte_stripe(seg_bytes, blockIdx.x, gridDim.x);
  for (int si = 0; si < n_segs; ++si) {
    const long long off = (long long)si * seg_bytes + st.c0;
    char* slot = comm + (long long)(si & 1) * seg_bytes + st.c0;
    copy_bytes(slot, x + off, st.cw, elem);
    __syncthreads();
    copy_bytes(out + off, slot, st.cw, elem);
  }
}

}  // namespace ompi_ring

// x, out: n_segs * seg_bytes bytes, elements of `elem` bytes; comm: two
// segments. Launches `blocks` blocks (one per SM). Returns the CUDA
// error of the launch (0 on success).
extern "C" int ompi_selfdma_chunked(const void* x, void* out, void* comm,
                                    int blocks, long long seg_bytes,
                                    int n_segs, int elem, int device,
                                    void* stream) {
  void* args[] = {(void*)&x, &out, &comm, &seg_bytes, &n_segs, &elem};
  return ompi_ring::launch_cooperative(
      (const void*)ompi_ring::selfdma_chunked_kernel, blocks, args, device,
      stream);
}
