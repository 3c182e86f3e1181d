// ring_reduce_scatter: the ring reduce-scatter on Hopper, fold-then-
// forward in a wavefront over segments, the partials handed over in a
// thread-block cluster's shared memory (or, beyond 8 ranks, in L2).
//
// Replaces ompi_tpu/coll/pallas_ring.py:_reduce_scatter_kernel (wrapper
// ring_reduce_scatter, used by PallasColl.reduce_scatter_block and by
// allreduce_block_rsag): n-1 steps; block b starts at rank b+1 as that
// rank's partial and travels right, each rank folding
// combine(arrival, x[me][b]) (the arrival on the left, bf16 computed in
// f32 and rounded once per step), so rank b ends with block b reduced
// in the order of the first half of ring_allreduce.
//
// Bound: bytes. Every rank's n blocks are read once and one block per
// rank is written, (n + 1) * B for B bytes sent per rank: 2.885 ms at
// 1 GiB and n = 8 on an H100 (3.35 TB/s); one combine per element is far
// below the operation rate. The first port (a two-pass ring
// schedule, since removed) made two passes a step over whole 128 MiB stripes (a
// copy into the neighbour's slot, then the fold), after a seed copy: 37
// units of 128 MiB per rank, all through HBM, with a fence on every
// thread and sleeping waits.
//
// What this design does about it:
// - One pass per step, as ring_allreduce.cu: a rank folds the arrival
//   with its own x block and stores the result straight into the right
//   neighbour's buffer, or, at the last step, into out[me]. Step 0's
//   arrival is the left rank's x[left][me-2], read from x (no seed copy).
// - Segments: each rank is striped over `stripes` blocks; a block cuts
//   its stripe of the ring block into n_segs segments of `seg` vectors,
//   and a buffer holds one segment.
// - Wavefront: (rank r, segment i, step k) needs only (r-1, i, k-1). In
//   time slot t a block makes the passes of step k on segment t - k for
//   every k in 0 .. n-2 that has one, so the arrivals it reads were made
//   in the left rank's slot t - 1, and one flag round trip serves up to
//   n-1 passes. Each step has two buffers per (rank, stripe), taken by
//   the parity of t: the arrival read in slot t sits in buffer t mod 2.
//   Before slot t a block waits for the left's recv flag of that buffer
//   and, before it forwards into the buffer the right read in slot t - 1,
//   for the right's credit (cap); after its passes it publishes once
//   (block_publish), raises the right's recv flag and credits the buffer
//   it read to the left. Each wait and raise is made only in the slots
//   where the other side has its counterpart (rs_forwards), so every
//   flag ends at 0. The fill and the drain have fewer passes; n_segs <
//   n-1 never fills the wavefront; n = 2 has one step, no buffer and no
//   flag. Waits poll hot. (A lag of two slots between a step and the
//   next, with four buffers, gives each flag a slot of slack; it was
//   slower in either memory, PERF.md.)
// - Where the partials go: every hop writes and reads each partial, 12
//   GiB at 1 GiB sent and n = 8. In HBM buffers kept within the 50 MB L2
//   (pallas_ring.RS_SLOT_BYTES) that is 21 GiB through L2 with x and out,
//   and the kernel took 6.0-6.9 ms with its blocks waiting 23-24% of the
//   time. With CLUSTER (n up to 8) the n ranks' blocks of a stripe form
//   one thread-block cluster, each rank's buffers and flags live in its
//   own shared memory, and the left rank stores into them over the
//   SM-to-SM network (mapa / st.shared::cluster, the flags raised with
//   red.shared::cluster and polled with cluster-scope acquire loads): only
//   x and out touch L2, clusters are independent of each other, and the
//   blocks wait 12%.
// - Loads in flight: a pass alone waits for its loads before the next
//   pass can issue its own, so a slot of n-1 passes cost n-1 memory round
//   trips (the first build: 7.69 ms at 1 GiB, 1.2 TB/s). A thread issues
//   the loads of up to kRsBatch passes of the slot together, then folds
//   and stores them; the first batch's x vectors are loaded before the
//   waits. The passes' pointers are set once per slot in shared memory.
//   16-byte vectors; x read and out written as streams.
// On an H100 (PERF.md, rs_bcast_check.py) the cluster form takes 5.2-5.5
// ms at 1 GiB sent per rank and n = 8 with 2 KiB segments and four blocks
// of 128 threads per SM (the first port 20.05; x.sum(0) 5.5-5.7).
#include "ring_common.cuh"

namespace ompi_ring {

// Threads per block at most (the batch below takes up to 128 registers).
constexpr int kRsThreads = 512;
// Passes of one time slot whose loads are in flight together.
constexpr int kRsBatch = 8;
// Passes per time slot at most: n - 1 for n ranks.
constexpr int kRsMaxPasses = 127;
// Buffers per step of each (rank, stripe): one for each parity of t.
constexpr int kRsBufs = 2;
// Whether time slot p has a pass that forwards into the right
// neighbour's buffers: a step k in 0 .. n-3 whose segment p - k is in
// 0 .. n_segs-1 (pallas_ring._rs_forwards).
__device__ __forceinline__ bool rs_forwards(int p, int n, int n_segs) {
  return p >= 0 && n > 2 && p - n_segs + 1 <= n - 3;
}

// The kernel's flags and buffers: in comm and sems (HBM, through L2),
// or, with CLUSTER, in the shared memory of the rank that reads them.
template <typename T, int OP, bool CLUSTER = false>
__global__ void __launch_bounds__(kRsThreads)
    ring_reduce_scatter_kernel(const uint4* __restrict__ x,
                               uint4* __restrict__ out, uint4* comm,
                               int* sems, int n, int stripes, long long cv,
                               long long seg_v, int n_segs) {
  // This time slot's passes: arrival, own x block, destination (with
  // CLUSTER, a peer's buffer as its shared::cluster address), length.
  __shared__ const uint4* p_src[kRsMaxPasses];
  __shared__ const uint4* p_own[kRsMaxPasses];
  __shared__ uint4* p_dst[kRsMaxPasses];
  __shared__ unsigned p_peer[kRsMaxPasses];
  __shared__ long long p_len[kRsMaxPasses];
  // CLUSTER: this rank's 2 kRsBufs flags, then its (n-2) x kRsBufs
  // buffers.
  extern __shared__ uint4 cluster_smem[];
  // A cluster holds the n ranks of one stripe, block rank r = rank r.
  const int r = CLUSTER ? blockIdx.x % n : blockIdx.x / stripes;
  const int s = CLUSTER ? blockIdx.x / n : blockIdx.x % stripes;
  const int left = (r - 1 + n) % n, right = (r + 1) % n;
  const long long sv = (cv + stripes - 1) / stripes;  // vectors per stripe
  const long long c0 = (long long)s * sv;
  const long long cw = c0 < cv ? (cv - c0 < sv ? cv - c0 : sv) : 0;
  auto xblk = [&](int rank, int blk) {
    return x + ((long long)rank * n + blk) * cv + c0;
  };
  int* const local_flags = reinterpret_cast<int*>(cluster_smem);
  uint4* const local_bufs = cluster_smem + (2 * kRsBufs + 3) / 4;
  // Buffer (k, b) of a rank's stripe s: the arrival of step k >= 1 that
  // the rank reads in time slots t of parity b. With CLUSTER the reader's
  // own are local_bufs, a peer's are reached by peer_addr.
  auto buf_at = [&](int k, int b) {
    return ((long long)(k - 1) * kRsBufs + b) * seg_v;
  };
  auto slot = [&](int rank, int k, int b) -> uint4* {
    // CLUSTER: every rank's buffers sit at the same offsets, so this is
    // the reader's own one, or the pattern that peer_addr maps to rank's.
    if (CLUSTER) return local_bufs + buf_at(k, b);
    return comm + ((long long)rank * stripes + s) * (n - 2) * kRsBufs * seg_v +
           buf_at(k, b);
  };
  // Flags per (rank, stripe): recv[2] (arrivals in buffers b), then
  // cap[2] (the right neighbour's credit on its buffers b).
  int* const global_flags = sems + (r * stripes + s) * 2 * kRsBufs;
  auto wait_flag = [&](int i) {
    if (CLUSTER)
      acquire_local(cta_addr(local_flags + i));
    else
      acquire_flag(global_flags + i);
  };
  auto raise_at = [&](int rank, int i) {
    if (CLUSTER)
      raise_peer(peer_addr(cta_addr(local_flags + i), rank));
    else
      raise_flag(sems + (rank * stripes + s) * 2 * kRsBufs + i);
  };
  auto fwd = [&](int p) { return rs_forwards(p, n, n_segs); };
  const int slots = n_segs + n - 2;
  const unsigned long long keep = l2_policy(true);
#ifdef OMPI_RING_PROBE
  unsigned long long waited = 0;  // probe: ns thread 0 spent waiting
#endif
  if (CLUSTER) {
    // Every rank of the cluster runs, its flags at 0, before any store
    // into its shared memory.
    for (int i = threadIdx.x; i < 2 * kRsBufs; i += blockDim.x)
      local_flags[i] = 0;
    cluster_sync();
  }
  OMPI_PROBE(0);

  for (int t = 0; t < slots; ++t) {
    // Passes k_lo .. k_hi (at least one), step k on segment t - k; pass
    // q is k_lo + q.
    const int k_lo = t - n_segs + 1 > 0 ? t - n_segs + 1 : 0;
    const int k_hi = n - 2 < t ? n - 2 : t;
    const int m = k_hi - k_lo + 1;
    for (int q = threadIdx.x; q < m; q += blockDim.x) {
      const int k = k_lo + q;
      const long long a = (long long)(t - k) * seg_v;
      p_len[q] = a < cw ? (cw - a < seg_v ? cw - a : seg_v) : 0;
      p_own[q] = xblk(r, ((r - k - 2) % n + n) % n) + a;
      p_src[q] = k ? slot(r, k, t & 1) : xblk(left, (r - 2 + 2 * n) % n) + a;
      p_dst[q] = k == n - 2 ? out + (long long)r * cv + c0 + a
                            : slot(right, k + 1, (t + 1) & 1);
      if (CLUSTER && k < n - 2)
        p_peer[q] = peer_addr(cta_addr(p_dst[q]), right);
    }
    __syncthreads();
    // The first batch's x vectors, loaded before the waits.
    uint4 b[kRsBatch];
#pragma unroll
    for (int q = 0; q < kRsBatch; ++q)
      if (q < m && threadIdx.x < p_len[q])
        b[q] = __ldcs(p_own[q] + threadIdx.x);
    if (threadIdx.x == 0) {
#ifdef OMPI_RING_PROBE
      const unsigned long long w0 = global_ns();
#endif
      if (fwd(t - 1)) wait_flag(t & 1);
      if (fwd(t) && fwd(t - 2)) wait_flag(kRsBufs + ((t + 1) & 1));
#ifdef OMPI_RING_PROBE
      waited += global_ns() - w0;
#endif
    }
    __syncthreads();
    for (int q0 = 0; q0 < m; q0 += kRsBatch) {
      for (long long i = threadIdx.x; i < seg_v; i += blockDim.x) {
        const bool fetched = q0 == 0 && i == threadIdx.x;
        uint4 a[kRsBatch];
#pragma unroll
        for (int u = 0; u < kRsBatch; ++u) {
          const int q = q0 + u;
          if (q >= m || i >= p_len[q]) continue;
          if (k_lo + q == 0)
            a[u] = __ldcs(p_src[q] + i);  // the left's x: read once
          else if (CLUSTER)
            a[u] = p_src[q][i];  // this rank's shared memory
          else
            a[u] = __ldcg(p_src[q] + i);
          if (!fetched) b[u] = __ldcs(p_own[q] + i);
        }
#pragma unroll
        for (int u = 0; u < kRsBatch; ++u) {
          const int q = q0 + u;
          if (q >= m || i >= p_len[q]) continue;
          const uint4 v = combine_vec<T, OP>(a[u], b[u]);
          if (k_lo + q == n - 2)
            __stcs(p_dst[q] + i, v);  // out[me]: never read here
          else if (CLUSTER)
            st_peer(p_peer[q] + 16 * (unsigned)i, v);  // the right rank's
          else
            st_child(p_dst[q] + i, v, keep);  // the right rank's buffer
        }
      }
    }
    block_publish();
    if (threadIdx.x == 0) {
      if (fwd(t)) raise_at(right, (t + 1) & 1);
      if (fwd(t - 1) && fwd(t + 1)) raise_at(left, kRsBufs + (t & 1));
    }
  }
  OMPI_PROBE(1);
  OMPI_PROBE_AT(2, waited);
  if (CLUSTER) {
    // No rank leaves while another may still reach its shared memory;
    // then the flags' ends go to sems, where the host checks them.
    cluster_sync();
    for (int i = threadIdx.x; i < 2 * kRsBufs; i += blockDim.x)
      global_flags[i] = local_flags[i];
  }
}

// The cluster form as a two-parameter template, for OMPI_RING_PICK.
template <typename T, int OP>
constexpr auto ring_reduce_scatter_cluster =
    &ring_reduce_scatter_kernel<T, OP, true>;

}  // namespace ompi_ring

namespace ompi_ring {

// Instantiate the kernel for the (op, dtype) codes, with or without
// clusters (nullptr for an unknown pair).
inline const void* rs_kernel(int op, int dtype, bool cluster) {
  return cluster
             ? OMPI_RING_PICK(ring_reduce_scatter_cluster)(op, dtype)
             : OMPI_RING_PICK(ring_reduce_scatter_kernel)(op, dtype);
}

// Dynamic shared memory of a cluster launch: the flags, then the
// (n-2) x kRsBufs buffers of seg vectors.
inline size_t rs_cluster_smem(int n, long long seg) {
  return ((size_t)(2 * kRsBufs + 3) / 4 + (size_t)(n - 2) * kRsBufs * seg) *
         16;
}

}  // namespace ompi_ring

// x: (n, n, C) rank-major ring blocks, out: (n, C), rank r's reduced
// block r, C a whole number of 16-byte vectors (c_bytes its bytes), both
// 16-byte aligned; comm: (n, stripes, n - 2, 2, seg) 16-byte vectors
// (nothing at n = 2, or with clusters); sems: (n, stripes, 2, 2) int32,
// all 0 at entry and left at 0 (with clusters the flags live in shared
// memory and their ends are copied there); seg: vectors per segment,
// n_segs segments per stripe (n_segs * seg >= ceil(C / 16 / stripes));
// `threads` per block, at most 512; n at most 128, or 8 with clusters. Without clusters the grid is one cooperative launch
// of resident blocks; with them, one cluster of the n ranks' blocks per
// stripe, each cluster on its own. Returns the CUDA error of the launch
// (0 on success).
extern "C" int ompi_ring_reduce_scatter(const void* x, void* out, void* comm,
                                        void* sems, int n, int stripes,
                                        int threads, long long c_bytes,
                                        long long seg, int n_segs,
                                        int cluster, int op, int dtype,
                                        int device, void* stream) {
  using namespace ompi_ring;
  if (n < 2 || n - 1 > kRsMaxPasses || stripes < 1 || threads < 32 ||
      threads > kRsThreads || seg < 1 || n_segs < 1 || c_bytes & 15 ||
      (cluster && n > 8))
    return (int)cudaErrorInvalidValue;
  long long cv = c_bytes / 16;
  void* args[] = {(void*)&x, &out, &comm, &sems,  &n,
                  &stripes,  &cv,  &seg,  &n_segs};
  const void* fn = rs_kernel(op, dtype, cluster != 0);
  if (!cluster)
    return launch_cooperative(fn, n * stripes, threads, args, device,
                              stream);
  return launch_clusters(fn, n, threads, rs_cluster_smem(n, seg),
                         n * stripes, args, device, stream);
}

// How many clusters of the n <= 8 ranks' blocks (`threads` each,
// seg-vector buffers) the card holds at once, or minus the CUDA error.
extern "C" int ompi_ring_reduce_scatter_clusters(int n, int threads,
                                                 long long seg, int device) {
  using namespace ompi_ring;
  return max_clusters(rs_kernel(OP_SUM, DT_F32, true), n, threads,
                      rs_cluster_smem(n, seg), device);
}
