// ring_alltoall: the pairwise-exchange alltoall on Hopper.
//
// Replaces ompi_tpu/coll/pallas_ring.py:_alltoall_kernel (wrapper
// ring_alltoall, used by PallasColl.alltoall through alltoall_block).
// Rank r copies its own block x[r][r] to out[r][r]; then at step
// s = 1..n-1 it stores its block for rank d = r+s straight into d's row
// out[d][r], publishes, signals d's step-s flag and waits for its own
// step-s flag, which rank r-s signals after storing out[r][r-s].
//
// One flag per step per receiver, not a two-slot rotation: the writer
// of rank r's row differs at every step and nothing orders the writers,
// so a rotation would let a later step's store satisfy an earlier
// step's wait (the reference's docstring, pallas_ring.py:988-993). No
// slot is written twice, so there is no credit; no comm scratch: every
// store lands in its final row.
//
// The kernel moves bytes only, so it takes every dtype: rows are copied
// in 16-byte vectors where aligned, else in units of the element size.
//
// Bound: bytes. Every input byte is read once and every output byte
// written once: 2 n B for B bytes sent per rank. What the design does
// about it: each rank is striped over n x stripes <= SM count resident
// thread blocks, each stripe with its own flags; every step of every
// rank is a coalesced stream with four 16-byte loads in flight per
// thread, and all ranks copy at once, so every SM is busy every step.
#include "ring_common.cuh"

namespace ompi_ring {

__global__ void __launch_bounds__(kThreads)
    ring_alltoall_kernel(const char* __restrict__ x, char* __restrict__ out,
                         void* /*comm*/, int* sems, int n, int stripes,
                         long long W, int elem) {
  const int r = blockIdx.x / stripes;
  const int s = blockIdx.x % stripes;
  const long long row = W * elem;
  const ByteStripe st = byte_stripe(row, s, stripes);
  // sems is (n, stripes, n - 1): one flag per receiver, stripe and step.
  auto flag = [&](int rank, int step) {
    return sems + ((long long)rank * stripes + s) * (n - 1) + step - 1;
  };
  auto at = [&](auto* base, int rank, int blk) {
    return base + ((long long)rank * n + blk) * row + st.c0;
  };

  copy_bytes(at(out, r, r), at(x, r, r), st.cw, elem);
  for (int step = 1; step < n; ++step) {
    const int dst = (r + step) % n;
    copy_bytes(at(out, dst, r), at(x, r, dst), st.cw, elem);
    publish();
    if (threadIdx.x == 0) signal(flag(dst, step), 1);
    wait(flag(r, step), 1);
  }
}

}  // namespace ompi_ring

// x, out: (n, n, W) rank-major, elements of `elem` bytes; comm: unused;
// sems: (n, stripes, n - 1) int32, zeroed by the caller. Returns the
// CUDA error of the launch (0 on success).
extern "C" int ompi_ring_alltoall(const void* x, void* out, void* comm,
                                  void* sems, int n, int stripes,
                                  long long W, int elem, int device,
                                  void* stream) {
  void* args[] = {(void*)&x, &out, &comm, &sems, &n, &stripes, &W, &elem};
  return ompi_ring::launch_cooperative(
      (const void*)ompi_ring::ring_alltoall_kernel, n * stripes, args,
      device, stream);
}
