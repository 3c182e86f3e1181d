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
// - One pass per step: a rank waits for the arrival in its slot,
//   computes combine(arrival, x[blk]) (the reference's operands in its
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

constexpr int kRingUnroll = 4;
// Flags per (rank, stripe): recv[2] (an arrival in slot 0/1), cap[2]
// (the right neighbour's credit on its slot 0/1).
constexpr int kRingFlags = 4;

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    ring_allreduce_kernel(const T* __restrict__ x, T* __restrict__ out,
                          T* comm, int* sems, int n, int stripes,
                          long long C) {
  constexpr long long E = 16 / sizeof(T);
  const int r = blockIdx.x / stripes;
  const int s = blockIdx.x % stripes;
  const int left = (r - 1 + n) % n, right = (r + 1) % n;
  const long long cv = C / E;                       // vectors per block
  const long long sv = (cv + stripes - 1) / stripes;  // per stripe
  const long long v0 = (long long)s * sv;
  const long long vn = v0 < cv ? (cv - v0 < sv ? cv - v0 : sv) : 0;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out) + (long long)r * n * cv + v0;
  uint4* cm = reinterpret_cast<uint4*>(comm);
  auto slot = [&](int rank, int k) {
    return cm + (((long long)rank * stripes + s) * 2 + (k & 1)) * sv;
  };
  auto xblk = [&](int rank, int blk) {
    return xv + ((long long)rank * n + blk) * cv + v0;
  };
  int* mine = sems + (r * stripes + s) * kRingFlags;
  int* to_right = sems + (right * stripes + s) * kRingFlags;
  int* to_left = sems + (left * stripes + s) * kRingFlags;
  const int nsteps = 2 * (n - 1);
  const long long stride = (long long)kRingUnroll * blockDim.x;

  OMPI_PROBE(0);
  for (int k = 0; k < nsteps; ++k) {
    const bool rs = k < n - 1;
    const bool send = k < nsteps - 1;
    const int blk = rs ? ((r - k - 2) % n + n) % n
                       : ((r - (k - n + 1) - 1) % n + 2 * n) % n;
    const uint4* own = xblk(r, blk);
    // This step's x block, loaded before the waits.
    uint4 xr[kRingUnroll];
    if (rs) {
#pragma unroll
      for (int u = 0; u < kRingUnroll; ++u) {
        const long long j = threadIdx.x + (long long)u * blockDim.x;
        if (j < vn) xr[u] = own[j];
      }
    }
    if (threadIdx.x == 0) {
      if (k) acquire_flag(mine + (k & 1));
      if (send && k >= 2) acquire_flag(mine + 2 + ((k + 1) & 1));
    }
    __syncthreads();
    OMPI_PROBE(1 + 2 * k);
    const uint4* src = k ? slot(r, k) : xblk(left, (r - 2 + 2 * n) % n);
    uint4* dst = send ? slot(right, k + 1) : nullptr;
    uint4* o = rs ? (k == n - 2 ? ov + (long long)r * cv : nullptr)
                  : ov + (long long)blk * cv;
    for (long long i = threadIdx.x; i < vn; i += stride) {
      uint4 v[kRingUnroll];
#pragma unroll
      for (int u = 0; u < kRingUnroll; ++u) {
        const long long j = i + (long long)u * blockDim.x;
        if (j < vn) v[u] = k ? __ldcg(src + j) : src[j];
      }
      if (rs) {
#pragma unroll
        for (int u = 0; u < kRingUnroll; ++u) {
          const long long j = i + (long long)u * blockDim.x;
          if (j >= vn) continue;
          if (i != threadIdx.x) xr[u] = own[j];
          v[u] = combine_vec<T, OP>(v[u], xr[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kRingUnroll; ++u) {
        const long long j = i + (long long)u * blockDim.x;
        if (j >= vn) continue;
        if (o) o[j] = v[u];
        if (dst) __stcg(dst + j, v[u]);
      }
    }
    block_publish();
    if (threadIdx.x == 0) {
      if (send) raise_flag(to_right + ((k + 1) & 1));
      if (k >= 1 && k <= nsteps - 3) raise_flag(to_left + 2 + (k & 1));
    }
    OMPI_PROBE(2 + 2 * k);
  }
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
