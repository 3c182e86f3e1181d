// ring_allgather: the ring allgather on Hopper, one pass per step in a
// wavefront over segments, the arrivals handed over in a thread-block
// cluster's shared memory (or, beyond 8 ranks, in L2).
//
// Replaces ompi_tpu/coll/pallas_ring.py:_allgather_kernel (wrapper
// ring_allgather, used by PallasColl.allgather and by
// allreduce_block_rsag): n-1 steps; at step k rank me receives block
// me-k-1 from its left neighbour, stores it as out[me][me-k-1] and, but
// at the last step, passes it on to its right neighbour; out[me][me] is
// its own block. It moves bytes, so it takes any dtype.
//
// Bound: bytes. Every rank's block is read once and written once per
// rank, (n + 1) * B for B bytes received per rank: 2.885 ms at 1 GiB and
// n = 8 on an H100 (3.35 TB/s). The first port (a two-pass ring schedule, since
// removed) copied a seed into a comm slot, then made two passes a
// step over whole 16 MiB stripes (slot -> the neighbour's slot, then the
// arrival -> out) in scalar loads and stores, each with a fence on every
// thread and a sleeping wait: each block crossed HBM about four times a
// hop (18.40 ms).
//
// What this design does about it (ring_reduce_scatter.cu's design, minus
// the combine):
// - One pass per step: a rank loads the arrival once and stores it both
//   into out[me] and straight into the right neighbour's buffer. Step 0's
//   arrival is x[left], read from x (no seed copy); out[me][me] = x[me] is
//   copied segment by segment beside the steps, before the slot's waits.
// - Wavefront: (rank r, segment i, step k) needs only (r-1, i, k-1). In
//   time slot t a block makes step k on segment t - k for every k in
//   0 .. n-2 that has one, and its own copy of segment t, so the arrivals
//   it reads were made in the left rank's slot t - 1 and one flag round
//   trip serves up to n passes. Each step has two buffers per (rank,
//   stripe), taken by the parity of t. Before slot t a block waits for the
//   left's recv flag of that buffer and, before it forwards into the
//   buffer the right read in slot t - 1, for the right's credit (cap);
//   after its passes it publishes once (block_publish), raises the
//   right's recv flag and credits the buffer it read to the left. Each
//   wait and raise is made only in the slots where the other side has its
//   counterpart (ag_forwards), so every flag ends at 0. n = 2 has one
//   step, no buffer and no flag. Waits poll hot and trap after 30 s.
// - Where the arrivals go: with CLUSTER (n up to 8) the n ranks' blocks of
//   a stripe form one thread-block cluster; each rank's buffers and flags
//   live in its own shared memory, and the left rank stores into them
//   over the SM-to-SM network (mapa / st.shared::cluster, the flags raised
//   with red.shared::cluster and polled with cluster-scope acquire
//   loads). Beyond 8 ranks the buffers are in HBM scratch kept within the
//   50 MB L2 (pallas_ring.RS_SLOT_BYTES) under a cooperative launch. Either
//   way only x and out touch HBM: x is read by its own rank and by its
//   right neighbour in the same slot (the second read from L2), and out is
//   written once, as a stream.
// - Loads in flight: a thread issues the loads of up to kAgBatch passes of
//   the slot together, then stores them. The passes' pointers are set
//   once per slot in shared memory. 16-byte vectors.
#include "ring_common.cuh"

namespace ompi_ring {

// Threads per block at most.
constexpr int kAgThreads = 512;
// Passes of one time slot whose loads are in flight together.
constexpr int kAgBatch = 8;
// Passes per time slot at most: n - 1 for n ranks.
constexpr int kAgMaxPasses = 127;
// Buffers per step of each (rank, stripe): one for each parity of t.
constexpr int kAgBufs = 2;
// Whether time slot p has a pass that forwards into the right
// neighbour's buffers: a step k in 0 .. n-3 whose segment p - k is in
// 0 .. n_segs-1 (pallas_ring._rs_forwards).
__device__ __forceinline__ bool ag_forwards(int p, int n, int n_segs) {
  return p >= 0 && n > 2 && p - n_segs + 1 <= n - 3;
}

// The kernel's flags and buffers: in comm and sems (HBM, through L2),
// or, with CLUSTER, in the shared memory of the rank that reads them.
template <bool CLUSTER>
__global__ void __launch_bounds__(kAgThreads)
    ring_allgather_kernel(const uint4* __restrict__ x,
                          uint4* __restrict__ out, uint4* comm, int* sems,
                          int n, int stripes, long long cv, long long seg_v,
                          int n_segs) {
  // This time slot's passes: arrival, its out row, its forward (with
  // CLUSTER, a peer's buffer as its shared::cluster address), length.
  __shared__ const uint4* p_src[kAgMaxPasses];
  __shared__ uint4* p_out[kAgMaxPasses];
  __shared__ uint4* p_dst[kAgMaxPasses];
  __shared__ unsigned p_peer[kAgMaxPasses];
  __shared__ long long p_len[kAgMaxPasses];
  // CLUSTER: this rank's 2 kAgBufs flags, then its (n-2) x kAgBufs
  // buffers.
  extern __shared__ uint4 cluster_smem[];
  // A cluster holds the n ranks of one stripe, block rank r = rank r.
  const int r = CLUSTER ? blockIdx.x % n : blockIdx.x / stripes;
  const int s = CLUSTER ? blockIdx.x / n : blockIdx.x % stripes;
  const int left = (r - 1 + n) % n, right = (r + 1) % n;
  const long long sv = (cv + stripes - 1) / stripes;  // vectors per stripe
  const long long c0 = (long long)s * sv;
  const long long cw = c0 < cv ? (cv - c0 < sv ? cv - c0 : sv) : 0;
  auto xrow = [&](int rank) { return x + (long long)rank * cv + c0; };
  auto orow = [&](int blk) {
    return out + ((long long)r * n + blk) * cv + c0;
  };
  int* const local_flags = reinterpret_cast<int*>(cluster_smem);
  uint4* const local_bufs = cluster_smem + (2 * kAgBufs + 3) / 4;
  // Buffer (k, b) of a rank's stripe s: the arrival of step k >= 1 that
  // the rank reads in time slots t of parity b.
  auto buf_at = [&](int k, int b) {
    return ((long long)(k - 1) * kAgBufs + b) * seg_v;
  };
  auto slot = [&](int rank, int k, int b) -> uint4* {
    // CLUSTER: every rank's buffers sit at the same offsets, so this is
    // the reader's own one, or the pattern that peer_addr maps to rank's.
    if (CLUSTER) return local_bufs + buf_at(k, b);
    return comm + ((long long)rank * stripes + s) * (n - 2) * kAgBufs * seg_v +
           buf_at(k, b);
  };
  // Flags per (rank, stripe): recv[2] (arrivals in buffers b), then
  // cap[2] (the right neighbour's credit on its buffers b).
  int* const global_flags = sems + (r * stripes + s) * 2 * kAgBufs;
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
      raise_flag(sems + (rank * stripes + s) * 2 * kAgBufs + i);
  };
  auto fwd = [&](int p) { return ag_forwards(p, n, n_segs); };
  const int slots = n_segs + n - 2;
  const unsigned long long keep = l2_policy(true);
#ifdef OMPI_RING_PROBE
  unsigned long long waited = 0;  // probe: ns thread 0 spent waiting
#endif
  if (CLUSTER) {
    // Every rank of the cluster runs, its flags at 0, before any store
    // into its shared memory.
    for (int i = threadIdx.x; i < 2 * kAgBufs; i += blockDim.x)
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
      p_src[q] = k ? slot(r, k, t & 1) : xrow(left) + a;
      p_out[q] = orow(((r - k - 1) % n + n) % n) + a;
      p_dst[q] = k < n - 2 ? slot(right, k + 1, (t + 1) & 1) : nullptr;
      if (CLUSTER && k < n - 2)
        p_peer[q] = peer_addr(cta_addr(p_dst[q]), right);
    }
    // This rank's own block, segment t: no wait.
    if (t < n_segs) {
      const long long a = (long long)t * seg_v;
      const long long len = a < cw ? (cw - a < seg_v ? cw - a : seg_v) : 0;
      for (long long i = threadIdx.x; i < len; i += blockDim.x)
        __stcs(orow(r) + a + i, __ldcg(xrow(r) + a + i));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
#ifdef OMPI_RING_PROBE
      const unsigned long long w0 = global_ns();
#endif
      if (fwd(t - 1)) wait_flag(t & 1);
      if (fwd(t) && fwd(t - 2)) wait_flag(kAgBufs + ((t + 1) & 1));
#ifdef OMPI_RING_PROBE
      waited += global_ns() - w0;
#endif
    }
    __syncthreads();
    for (int q0 = 0; q0 < m; q0 += kAgBatch) {
      for (long long i = threadIdx.x; i < seg_v; i += blockDim.x) {
        uint4 a[kAgBatch];
#pragma unroll
        for (int u = 0; u < kAgBatch; ++u) {
          const int q = q0 + u;
          if (q >= m || i >= p_len[q]) continue;
          if (k_lo + q == 0)
            a[u] = __ldcg(p_src[q] + i);  // the left's x
          else if (CLUSTER)
            a[u] = p_src[q][i];  // this rank's shared memory
          else
            a[u] = __ldcg(p_src[q] + i);
        }
#pragma unroll
        for (int u = 0; u < kAgBatch; ++u) {
          const int q = q0 + u;
          if (q >= m || i >= p_len[q]) continue;
          __stcs(p_out[q] + i, a[u]);  // out[me]: never read here
          if (k_lo + q == n - 2) continue;
          if (CLUSTER)
            st_peer(p_peer[q] + 16 * (unsigned)i, a[u]);  // the right's
          else
            st_child(p_dst[q] + i, a[u], keep);  // the right rank's buffer
        }
      }
    }
    block_publish();
    if (threadIdx.x == 0) {
      if (fwd(t)) raise_at(right, (t + 1) & 1);
      if (fwd(t - 1) && fwd(t + 1)) raise_at(left, kAgBufs + (t & 1));
    }
  }
  OMPI_PROBE(1);
  OMPI_PROBE_AT(2, waited);
  if (CLUSTER) {
    // No rank leaves while another may still reach its shared memory;
    // then the flags' ends go to sems, where the host checks them.
    cluster_sync();
    for (int i = threadIdx.x; i < 2 * kAgBufs; i += blockDim.x)
      global_flags[i] = local_flags[i];
  }
}

inline const void* ag_kernel(bool cluster) {
  return cluster ? (const void*)ring_allgather_kernel<true>
                 : (const void*)ring_allgather_kernel<false>;
}

// Dynamic shared memory of a cluster launch: the flags, then the
// (n-2) x kAgBufs buffers of seg vectors.
inline size_t ag_cluster_smem(int n, long long seg) {
  return ((size_t)(2 * kAgBufs + 3) / 4 + (size_t)(n - 2) * kAgBufs * seg) *
         16;
}

}  // namespace ompi_ring

// x: (n, C) rank-major own blocks, out: (n, n, C), row r holding every
// rank's block, C a whole number of 16-byte vectors (c_bytes its bytes),
// both 16-byte aligned; comm: (n, stripes, n - 2, 2, seg) 16-byte vectors
// (nothing at n = 2, or with clusters); sems: (n, stripes, 2, 2) int32,
// all 0 at entry and left at 0 (with clusters the flags live in shared
// memory and their ends are copied there); seg: vectors per segment,
// n_segs segments per stripe (n_segs * seg >= ceil(C / 16 / stripes));
// `threads` per block, at most 512; n at most 128, or 8 with clusters.
// Without clusters the grid is one cooperative launch of resident blocks;
// with them, one cluster of the n ranks' blocks per stripe, each cluster
// on its own. Returns the CUDA error of the launch (0 on success).
extern "C" int ompi_ring_allgather(const void* x, void* out, void* comm,
                                   void* sems, int n, int stripes,
                                   int threads, long long c_bytes,
                                   long long seg, int n_segs, int cluster,
                                   int device, void* stream) {
  using namespace ompi_ring;
  if (n < 2 || n - 1 > kAgMaxPasses || stripes < 1 || threads < 32 ||
      threads > kAgThreads || seg < 1 || n_segs < 1 || c_bytes & 15 ||
      (cluster && n > 8))
    return (int)cudaErrorInvalidValue;
  long long cv = c_bytes / 16;
  void* args[] = {(void*)&x, &out, &comm, &sems,  &n,
                  &stripes,  &cv,  &seg,  &n_segs};
  const void* fn = ag_kernel(cluster != 0);
  if (!cluster)
    return launch_cooperative(fn, n * stripes, threads, args, device,
                              stream);
  return launch_clusters(fn, n, threads, ag_cluster_smem(n, seg),
                         n * stripes, args, device, stream);
}

// How many clusters of the n <= 8 ranks' blocks (`threads` each,
// seg-vector buffers) the card holds at once, or minus the CUDA error.
extern "C" int ompi_ring_allgather_clusters(int n, int threads, long long seg,
                                            int device) {
  using namespace ompi_ring;
  return max_clusters(ag_kernel(true), n, threads, ag_cluster_smem(n, seg),
                      device);
}
