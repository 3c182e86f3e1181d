// ring_allreduce_rd: recursive-doubling allreduce on Hopper, the rounds
// exchanged through a thread-block cluster's shared memory.
//
// Replaces ompi_tpu/coll/pallas_ring.py:_allreduce_rd_kernel (wrapper
// ring_allreduce_rd, used by allreduce_block_rd): log2 n rounds, round k
// exchanging the whole buffer with rank me ^ 2^k into that round's own
// comm slot and flag, then combining in rank order (the lower rank's
// value on the left) so every rank ends with the same bits. Per-round
// slots and flags let a fast pair run rounds ahead without its early
// data satisfying an earlier round's wait (the reference's docstring,
// pallas_ring.py:711-720).
//
// Bound: bytes, 2 n B for B bytes per rank, 20 ns at 4 KiB and n = 8 on
// an H100; at the sizes this tier serves (below 10 000 B per rank)
// latency in practice: a round is one flag round trip between two SMs
// and a few kilobytes. The first port held each rank's value in global
// memory, stored each round into the partner's slot in global memory,
// fenced at GPU scope on every thread, slept between polls and reloaded
// the arrival through L2, behind a wrapper that zeroed its flags with a
// second launch and allocated its comm on every call: 0.041 ms at 4 KiB
// (PERF.md), against 0.040 for two PyTorch calls.
//
// What this design does about it:
// - CLUSTER (up to 8 ranks, the portable cluster size): the n ranks'
//   blocks of a column stripe form one cluster. Each thread holds one
//   16-byte vector of its rank's running value in registers. Round k's
//   slot and its arrival flag live in the receiving rank's shared memory:
//   a rank stores its value into the partner's slot over the SM-to-SM
//   network (st_peer), publishes once (block_publish) and raises the
//   partner's flag (raise_peer); thread 0 polls its own flag hot
//   (acquire_local, which takes it back to 0) and the block combines the
//   arrival from its own shared memory. Nothing goes through L2 but x and
//   out. The flags are zeroed by their block at its start, before a
//   cluster barrier that precedes every peer store; a second barrier
//   keeps every block alive until no peer can still write into it. So
//   the launch needs no global flag, no zero-fill and no comm. The
//   flags' ends (0) are copied to sems for the host's check.
// - Beyond 8 ranks, the first port's form over comm slots in global
//   memory, its flags taken back to 0 by their waiters, both reused by
//   the wrapper per stream (no zero-fill either).
// - The wrapper sets the cluster launch's shared-memory limit once per
//   kernel (smem_limit), not on every call.
#include "ring_common.cuh"

namespace ompi_ring {

// Rounds of a cluster of at most 8 ranks; their flags fill the first
// 16-byte vector of a block's shared memory, its slots follow.
constexpr int kRdMaxRounds = 3;

// The L2 form: comm is (n, stripes, rounds, sw) elements; sems (n,
// stripes, rounds), each flag raised once and taken back to 0 by its
// waiter.
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

// The cluster form: block b is rank b % n of stripe b / n; x and out are
// (n, cv) 16-byte vectors, a stripe sv of them (sv <= blockDim.x, one a
// thread); sems receives each block's kRdMaxRounds flag ends.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    ring_allreduce_rd_cluster(const uint4* __restrict__ x,
                              uint4* __restrict__ out, int* sems, int n,
                              long long cv, long long sv, int rounds) {
  extern __shared__ uint4 rd_smem[];
  int* const flags = reinterpret_cast<int*>(rd_smem);
  uint4* const slots = rd_smem + 1;
  const int r = blockIdx.x % n;
  const int s = blockIdx.x / n;
  const long long j = (long long)s * sv + threadIdx.x;
  const bool holds = threadIdx.x < sv && j < cv;
  if (threadIdx.x < kRdMaxRounds) flags[threadIdx.x] = 0;
  uint4 v = make_uint4(0, 0, 0, 0);
  if (holds) v = x[(long long)r * cv + j];
  // Every block of the cluster runs, its flags at 0, before any store
  // into its shared memory.
  cluster_sync();
  for (int k = 0; k < rounds; ++k) {
    const int partner = r ^ (1 << k);
    uint4* const slot = slots + (long long)k * sv + threadIdx.x;
    if (holds) st_peer(peer_addr(cta_addr(slot), partner), v);
    block_publish();
    if (threadIdx.x == 0) {
      raise_peer(peer_addr(cta_addr(flags + k), partner));
      acquire_local(cta_addr(flags + k));
    }
    __syncthreads();
    if (holds) {
      const uint4 got = *slot;
      v = partner < r ? combine_vec<T, OP>(got, v) : combine_vec<T, OP>(v, got);
    }
  }
  if (holds) out[(long long)r * cv + j] = v;
  // No block leaves while a peer may still reach its shared memory.
  cluster_sync();
  if (threadIdx.x < kRdMaxRounds)
    sems[(long long)blockIdx.x * kRdMaxRounds + threadIdx.x] =
        flags[threadIdx.x];
}

// The kernels of the floor measurement: an empty launch of each kind.
__global__ void rd_empty_kernel() {}

inline const void* rd_kernel(int op, int dtype, bool cluster) {
  return cluster ? OMPI_RING_PICK(ring_allreduce_rd_cluster)(op, dtype)
                 : OMPI_RING_PICK(ring_allreduce_rd_kernel)(op, dtype);
}

// Dynamic shared memory of a cluster block: the flags, then the rounds'
// slots of sv vectors.
inline size_t rd_cluster_smem(int rounds, long long sv) {
  return (1 + (size_t)rounds * sv) * 16;
}

}  // namespace ompi_ring

// x, out: (n, L) rank-major, L elements per rank, both 16-byte aligned;
// n a power of two, rounds = log2 n. Without clusters: comm (n, stripes,
// rounds, ceil(L / stripes)) elements; sems (n, stripes, rounds) int32,
// all 0 at entry and left at 0; n * stripes blocks of `threads`, all
// resident (cooperative). With clusters (n at most 8, rows of whole
// 16-byte vectors): comm unused; sems n * stripes * 3 int32 that receive
// the flags' ends (0); one cluster of the n ranks' blocks per stripe of
// ceil(vectors / stripes) <= threads vectors. Returns the CUDA error of
// the launch (0 on success).
extern "C" int ompi_ring_allreduce_rd(const void* x, void* out, void* comm,
                                      void* sems, int n, int stripes,
                                      int threads, long long L, int rounds,
                                      int cluster, int op, int dtype,
                                      int device, void* stream) {
  using namespace ompi_ring;
  if (n < 2 || n & (n - 1) || (1 << rounds) != n || stripes < 1 ||
      threads < 32 || threads > kThreads || L < 1)
    return (int)cudaErrorInvalidValue;
  const void* fn = rd_kernel(op, dtype, cluster != 0);
  if (!cluster) {
    void* args[] = {(void*)&x, &out, &comm, &sems, &n, &stripes, &L,
                    &rounds};
    return launch_cooperative(fn, n * stripes, threads, args, device,
                              stream);
  }
  const long long bytes = L * dtype_size(dtype);
  long long cv = bytes / 16;
  long long sv = (cv + stripes - 1) / stripes;
  if (n > 8 || bytes & 15 || sv > threads) return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&x, &out, &sems, &n, &cv, &sv, &rounds};
  return launch_clusters(fn, n, threads, rd_cluster_smem(rounds, sv),
                         n * stripes, args, device, stream);
}

// How many clusters of the n <= 8 ranks' blocks (`threads` each, stripes
// of sv vectors) the card holds at once, or minus the CUDA error.
extern "C" int ompi_ring_allreduce_rd_clusters(int n, int threads,
                                               long long sv, int device) {
  using namespace ompi_ring;
  int rounds = 0;
  while ((1 << rounds) < n) ++rounds;
  return max_clusters(rd_kernel(OP_SUM, DT_F32, true), n, threads,
                      rd_cluster_smem(rounds, sv), device);
}

// The floor that the host sets: an empty kernel launched as the kernel
// is, n * stripes blocks of `threads`, cooperative (cluster 0) or in
// clusters of n with `smem` bytes of dynamic shared memory, whose limit
// is set on every call with set_each (as every cluster launch did before
// smem_limit) or once. Returns the CUDA error (0 on success).
extern "C" int ompi_ring_allreduce_rd_empty(int cluster, int n, int stripes,
                                            int threads, long long smem,
                                            int set_each, int device,
                                            void* stream) {
  using namespace ompi_ring;
  const void* fn = (const void*)rd_empty_kernel;
  if (!cluster)
    return launch_cooperative(fn, n * stripes, threads, nullptr, device,
                              stream);
  if (set_each) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return launch_clusters(fn, n, threads, (size_t)smem, n * stripes, nullptr,
                         device, stream);
}
