// tree_reduce: the binomial-tree reduce to a root on Hopper.
//
// Replaces ompi_tpu/coll/pallas_ring.py:_tree_reduce_kernel (wrapper
// tree_reduce, used by PallasColl.reduce through reduce_block). Ranks
// are numbered relative to the root, rel = (r - root) mod n. In round k
// (k < ceil(log2 n)) a rank whose rel has lowest set bit 2^k sends its
// accumulator to rel - 2^k and leaves; a rank whose low k+1 bits are 0
// and with rel + 2^k < n waits for that child's accumulator and folds
// out = combine(out, arrival), the accumulator on the left, as the
// reference does. The root ends with the full reduction; the other rows
// of out hold partial accumulators, as in the reference.
//
// Each non-root rank sends exactly once, so the comm scratch is one slot
// per sender, n - 1 in all (slot rel - 1), each with one flag, instead
// of the reference's rounds x n VMEM slots: 7 GiB instead of 24 GiB at
// 1 GiB per rank and n = 8. A slot is written once per launch, so it
// needs no credit.
//
// Bound: bytes. Every rank's input is read once and the root's result
// written once: (n + 1) * B bytes for B bytes per rank. What the design
// does about it: each rank is striped over n x stripes <= SM count
// resident thread blocks, each stripe with its own flags, and every pass
// is a coalesced stream. The rounds are a dependency chain, so senders
// sit idle after their round; under a cooperative launch that is safe.
#include "ring_common.cuh"

namespace ompi_ring {

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    tree_reduce_kernel(const T* __restrict__ x, T* __restrict__ out,
                       T* comm, int* sems, int n, int stripes, long long L,
                       int root) {
  const int r = blockIdx.x / stripes;
  const int s = blockIdx.x % stripes;
  const long long sw = (L + stripes - 1) / stripes;
  const long long c0 = (long long)s * sw;
  const long long cw = c0 < L ? (L - c0 < sw ? L - c0 : sw) : 0;
  const int rel = (r - root + n) % n;
  const T* xr = x + (long long)r * L + c0;
  T* o = out + (long long)r * L + c0;
  // comm is (n - 1, stripes, sw) and sems (n - 1, stripes), both indexed
  // by the sender's relative rank minus one.
  auto slot = [&](int sender_rel) {
    return comm + ((long long)(sender_rel - 1) * stripes + s) * sw;
  };
  auto flag = [&](int sender_rel) {
    return sems + (sender_rel - 1) * stripes + s;
  };

  for (long long j = threadIdx.x; j < cw; j += blockDim.x) o[j] = xr[j];
  for (int bit = 1; bit < n; bit <<= 1) {
    const int low = rel & (2 * bit - 1);
    if (low == bit) {
      // Send the accumulator to the parent's slot for this rank; leave.
      T* dst = slot(rel);
      for (long long j = threadIdx.x; j < cw; j += blockDim.x)
        st_cg(dst + j, o[j]);
      publish();
      if (threadIdx.x == 0) signal(flag(rel), 1);
      return;
    }
    if (low == 0 && rel + bit < n) {
      wait(flag(rel + bit), 1);
      const T* src = slot(rel + bit);
      for (long long j = threadIdx.x; j < cw; j += blockDim.x)
        o[j] = Combine<T, OP>::apply(o[j], ld_cg(src + j));
    }
  }
}

}  // namespace ompi_ring

// x, out: (n, L) rank-major; comm: (n - 1, stripes, sw); sems: (n - 1,
// stripes) int32, zeroed by the caller. Returns the CUDA error of the
// launch (0 on success).
extern "C" int ompi_tree_reduce(const void* x, void* out, void* comm,
                                void* sems, int n, int stripes, long long L,
                                int root, int op, int dtype, int device,
                                void* stream) {
  void* args[] = {(void*)&x, &out, &comm, &sems, &n, &stripes, &L, &root};
  return ompi_ring::launch_cooperative(
      OMPI_RING_PICK(ompi_ring::tree_reduce_kernel)(op, dtype),
      n * stripes, args, device, stream);
}
