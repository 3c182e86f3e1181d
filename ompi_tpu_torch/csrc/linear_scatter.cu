// linear_scatter: the linear scatter from a root on Hopper.
//
// Replaces ompi_tpu/coll/pallas_ring.py:_scatter_kernel (wrapper
// linear_scatter, used by PallasColl.scatter through scatter_block).
// Root copies row root of its buffer into its own output row, then for
// s = 1..n-1 stores row d = root+s into rank d's output row, publishes
// and signals d's flag; every other rank waits for its flag. No
// handshake: a receiver never writes its own row, so a store that lands
// before the receiver starts is harmless (the reference's docstring,
// pallas_ring.py:1122-1128). One flag per receiver: on one card all
// ranks' flags share one memory, and a shared one would let root's
// signal to one receiver satisfy another's wait.
//
// The reference stages root's buffer on every rank, (n, n, L), and reads
// root's copy alone; this kernel takes root's (n, L) buffer. It moves
// bytes only and takes every dtype.
//
// Bound: bytes. Root's buffer is read once and every output row written
// once: 2 n B for B bytes per rank. What the design does about it: root's
// stores are coalesced 16-byte streams with four loads in flight per
// thread over its stripes, and each row is signalled as soon as it is
// stored. Only root's n x stripes <= SM count share of the blocks copies
// (the reference's DMA engines run root's n - 1 copies at once); the
// receivers' blocks only wait, so the kernel uses 1/n of the SMs.
#include "ring_common.cuh"

namespace ompi_ring {

__global__ void __launch_bounds__(kThreads)
    linear_scatter_kernel(const char* __restrict__ buf,
                          char* __restrict__ out, void* /*comm*/, int* sems,
                          int n, int stripes, long long L, int root,
                          int elem) {
  const int r = blockIdx.x / stripes;
  const int s = blockIdx.x % stripes;
  const long long row = L * elem;
  const ByteStripe st = byte_stripe(row, s, stripes);
  // sems is (n, stripes): one flag per receiver and stripe.
  auto flag = [&](int rank) { return sems + (long long)rank * stripes + s; };

  if (r == root) {
    for (int q = 0; q < n; ++q) {
      const int dst = (root + q) % n;
      const long long off = (long long)dst * row + st.c0;
      copy_bytes(out + off, buf + off, st.cw, elem);
      if (q) {
        publish();
        if (threadIdx.x == 0) signal(flag(dst), 1);
      }
    }
  } else {
    wait(flag(r), 1);
  }
}

}  // namespace ompi_ring

// buf: root's (n, L) buffer, elements of `elem` bytes; out: (n, L)
// rank-major; comm: unused; sems: (n, stripes) int32, zeroed by the
// caller. Returns the CUDA error of the launch (0 on success).
extern "C" int ompi_linear_scatter(const void* buf, void* out, void* comm,
                                   void* sems, int n, int stripes,
                                   long long L, int root, int elem,
                                   int device, void* stream) {
  void* args[] = {(void*)&buf, &out, &comm, &sems, &n, &stripes, &L, &root,
                  &elem};
  return ompi_ring::launch_cooperative(
      (const void*)ompi_ring::linear_scatter_kernel, n * stripes, args,
      device, stream);
}
