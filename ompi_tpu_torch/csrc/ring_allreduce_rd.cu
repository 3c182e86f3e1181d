// ring_allreduce_rd: recursive-doubling allreduce on Hopper.
//
// Replaces ompi_tpu/coll/pallas_ring.py:_allreduce_rd_kernel (wrapper
// ring_allreduce_rd, used by allreduce_block_rd): log2 n rounds, round k
// exchanging the whole buffer with rank me ^ 2^k into that round's own
// comm slot and flag, then combining in rank order (the lower rank's
// value on the left) so every rank ends with the same bits.
//
// Bound: memory, and at the sizes this tier serves (below 10 000 B per
// rank) in practice latency: a round is one flag round trip between
// two SMs plus a few kilobytes of traffic. What the design does about
// it: one cooperative launch for all rounds, one thread block per rank
// for small buffers (more stripes only for large ones), flags spun on by
// one thread with acquire loads and published with one release add.
// Per-round slots and flags let a fast pair run rounds ahead without its
// early data satisfying an earlier round's wait.
#include "ring_common.cuh"

namespace ompi_ring {

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    ring_allreduce_rd_kernel(const T* __restrict__ x, T* __restrict__ out,
                             T* comm, int* sems, int n, int stripes,
                             long long L, int rounds) {
  const int r = blockIdx.x / stripes;
  const int s = blockIdx.x % stripes;
  const long long sw = (L + stripes - 1) / stripes;
  const long long c0 = (long long)s * sw;
  const long long cw = c0 < L ? (L - c0 < sw ? L - c0 : sw) : 0;
  const T* xr = x + (long long)r * L + c0;
  T* o = out + (long long)r * L + c0;

  for (long long j = threadIdx.x; j < cw; j += blockDim.x) o[j] = xr[j];
  for (int k = 0; k < rounds; ++k) {
    const int partner = r ^ (1 << k);
    // comm is (n, stripes, rounds, sw); sems is (n, stripes, rounds).
    T* dst = comm + (((long long)partner * stripes + s) * rounds + k) * sw;
    T* mine = comm + (((long long)r * stripes + s) * rounds + k) * sw;
    for (long long j = threadIdx.x; j < cw; j += blockDim.x)
      st_cg(dst + j, o[j]);
    publish();
    if (threadIdx.x == 0)
      signal(sems + (partner * stripes + s) * rounds + k, 1);
    wait(sems + (r * stripes + s) * rounds + k, 1);
    for (long long j = threadIdx.x; j < cw; j += blockDim.x) {
      const T got = ld_cg(mine + j);
      o[j] = partner < r ? Combine<T, OP>::apply(got, o[j])
                         : Combine<T, OP>::apply(o[j], got);
    }
  }
}

}  // namespace ompi_ring

// x, out: (n, L) rank-major; comm: (n, stripes, rounds, sw); sems: (n,
// stripes, rounds) int32, zeroed by the caller. Returns the CUDA error of
// the launch (0 on success).
extern "C" int ompi_ring_allreduce_rd(const void* x, void* out, void* comm,
                                      void* sems, int n, int stripes,
                                      long long L, int rounds, int op,
                                      int dtype, int device, void* stream) {
  void* args[] = {(void*)&x, &out, &comm, &sems, &n, &stripes, &L,
                  &rounds};
  return ompi_ring::launch_cooperative(
      OMPI_RING_PICK(ompi_ring::ring_allreduce_rd_kernel)(op, dtype),
      n * stripes, args, device, stream);
}
