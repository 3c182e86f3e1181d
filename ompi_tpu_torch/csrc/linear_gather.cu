// linear_gather: the linear gather to a root on Hopper.
//
// Replaces ompi_tpu/coll/pallas_ring.py:_gather_kernel (wrapper
// linear_gather, used by PallasColl.gather through gather_block). Root
// copies its own block into its row of the output, then grants every
// sender a "ready" credit and waits on one flag per sender; a sender
// waits for its credit, stores its block into root's row out[r],
// publishes and signals its flag.
//
// One flag per sender: the senders are unordered peers, so a shared
// flag would let a fast sender satisfy root's wait for another (the
// reference's docstring, pallas_ring.py:1042-1051). Each flag is
// signalled once, so no credit is needed beyond the ready one, which
// keeps the reference's order: nothing lands in root's rows before root
// has started.
//
// Only root's rows are defined, so the output is root's (n, L) alone:
// the reference's kernel has a rank-major (n, n, L) output of which
// PallasColl keeps root's, 8 GiB here instead of 64 GiB at 1 GiB per
// rank and n = 8. The kernel moves bytes only and takes every dtype.
//
// Bound: bytes. Every input byte is read once and root's n rows written
// once: 2 n B for B bytes per rank. What the design does about it: the
// n - 1 senders store at once, each striped over its resident thread
// blocks, in 16-byte vectors with four loads in flight per thread, so
// all SMs stream at once.
#include "ring_common.cuh"

namespace ompi_ring {

__global__ void __launch_bounds__(kThreads)
    linear_gather_kernel(const char* __restrict__ x, char* __restrict__ out,
                         void* /*comm*/, int* sems, int n, int stripes,
                         long long L, int root, int elem) {
  const int r = blockIdx.x / stripes;
  const int s = blockIdx.x % stripes;
  const long long row = L * elem;
  const ByteStripe st = byte_stripe(row, s, stripes);
  // sems is (n, stripes, 2): rank q's ready credit, and root's flag for
  // sender q.
  constexpr int kReady = 0, kRecv = 1;
  auto flag = [&](int rank, int k) {
    return sems + ((long long)rank * stripes + s) * 2 + k;
  };
  const long long off = (long long)r * row + st.c0;

  if (r == root) {
    copy_bytes(out + off, x + off, st.cw, elem);
    if (threadIdx.x == 0)
      for (int q = 1; q < n; ++q) signal(flag((root + q) % n, kReady), 1);
    for (int q = 1; q < n; ++q) wait(flag((root + q) % n, kRecv), 1);
  } else {
    wait(flag(r, kReady), 1);
    copy_bytes(out + off, x + off, st.cw, elem);
    publish();
    if (threadIdx.x == 0) signal(flag(r, kRecv), 1);
  }
}

}  // namespace ompi_ring

// x: (n, L) rank-major, elements of `elem` bytes; out: root's (n, L)
// rows; comm: unused; sems: (n, stripes, 2) int32, zeroed by the
// caller. Returns the CUDA error of the launch (0 on success).
extern "C" int ompi_linear_gather(const void* x, void* out, void* comm,
                                  void* sems, int n, int stripes,
                                  long long L, int root, int elem,
                                  int device, void* stream) {
  void* args[] = {(void*)&x, &out, &comm, &sems, &n, &stripes, &L, &root,
                  &elem};
  return ompi_ring::launch_cooperative(
      (const void*)ompi_ring::linear_gather_kernel, n * stripes, args,
      device, stream);
}
