// ppermute_shift: one ring hop on Hopper.
//
// Replaces ompi_tpu/coll/pallas_ring.py:ppermute_shift's inner kernel
// (one remote DMA of the rank's block to rank me+shift, started and
// awaited). Block (r, s) of the grid stores byte stripe s of rank r's
// row into row (r + shift) mod n of the output, publishes and
// release-increments that receiver's flag for the stripe; then it
// acquires its own rank's flag, which the sender r - shift raises, and
// resets it to 0. One flag per (receiver, stripe): every receiver has
// exactly one sender, so no credit and no comm scratch; every store
// lands in its final row.
//
// The JAX kernel pads each block to 128 lanes; this one moves the rows
// as they are. It moves bytes only and takes every dtype: rows are
// copied in 16-byte vectors where aligned, else in units of the element
// size.
//
// Bound: bytes. Every input byte is read once and every output byte
// written once: 2 n B for B bytes per rank, 0.04006 ms at n = 8 and
// 8 MiB per rank over 3.35 TB/s. What the design does about it: each
// rank is striped over n x stripes <= SM count resident thread blocks,
// each a coalesced stream with four 16-byte loads in flight per thread,
// and all ranks copy at once.
#include "ring_common.cuh"

namespace ompi_ring {

__global__ void __launch_bounds__(kThreads)
    ppermute_shift_kernel(const char* __restrict__ x, char* __restrict__ out,
                          void* /*comm*/, int* sems, int n, int stripes,
                          long long L, int shift, int elem) {
  const int r = blockIdx.x / stripes;
  const int s = blockIdx.x % stripes;
  const long long row = L * elem;
  const ByteStripe st = byte_stripe(row, s, stripes);
  // sems is (n, stripes): one flag per receiver and stripe.
  auto flag = [&](int rank) { return sems + (long long)rank * stripes + s; };

  const int dst = (r + shift) % n;
  copy_bytes(out + (long long)dst * row + st.c0,
             x + (long long)r * row + st.c0, st.cw, elem);
  publish();
  if (threadIdx.x == 0) signal(flag(dst), 1);
  wait(flag(r), 1);
}

}  // namespace ompi_ring

// x, out: (n, L) rank-major, elements of `elem` bytes; comm: unused;
// sems: (n, stripes) int32, zeroed by the caller; shift in [0, n).
// Returns the CUDA error of the launch (0 on success).
extern "C" int ompi_ppermute_shift(const void* x, void* out, void* comm,
                                   void* sems, int n, int stripes,
                                   long long L, int shift, int elem,
                                   int device, void* stream) {
  void* args[] = {(void*)&x, &out, &comm, &sems, &n, &stripes, &L, &shift,
                  &elem};
  return ompi_ring::launch_cooperative(
      (const void*)ompi_ring::ppermute_shift_kernel, n * stripes, args,
      device, stream);
}
