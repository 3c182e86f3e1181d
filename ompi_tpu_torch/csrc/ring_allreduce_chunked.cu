// ring_allreduce_chunked: the segmented streaming ring allreduce on
// Hopper, one pass per step in a wavefront over segments, the values
// handed over in a thread-block cluster's shared memory (or, beyond 8
// ranks, in L2).
//
// Replaces ompi_tpu/coll/pallas_ring.py:_allreduce_chunked_kernel
// (wrapper ring_allreduce_chunked, used by allreduce_block_chunked): the
// ring of _allreduce_kernel, 2(n-1) steps, run segment by segment over
// the (n, rows, 128) layout, with a per-segment credit that keeps comm
// scratch at n * 2 * segment bytes however large the message.
//
// Bound: bytes. Every rank's n ring blocks are read once and its n
// output blocks written once: 2 n B for B bytes per rank, 5.128 ms at 1
// GiB and n = 8 on an H100 (3.35 TB/s); one combine per element and step
// is far below the operation rate. The first port ran the two-pass ring
// (a seed copy into a comm slot per segment, then per step a copy into
// the neighbour's slot and a second pass over the arrival, in scalar
// loads, with a fence on every thread and sleeping waits) one segment
// after another: each byte crossed the memory system about four times a
// hop (23.48 ms).
//
// What this design does about it (ring_reduce_scatter.cu's and
// ring_allgather.cu's design, joined into one launch):
// - One pass per step, as ring_allreduce.cu: at a reduce-scatter step k
//   < n-1 a rank folds combine(arrival, x[me][me-k-2]) (the reference's
//   operands in its order, bf16 computed in f32 and rounded once a step),
//   storing the finished block to out[me][me] at k = n-2; at an
//   allgather step it stores the arrival to out[me][blk]. Either way it
//   stores the value straight into the right neighbour's buffer, but at
//   the last step. Step 0's arrival is x[left][me-2], read from x (no
//   seed copy). So the bits are ring_allreduce's and the JAX package's.
// - Wavefront: (rank r, segment i, step k) needs only (r-1, i, k-1). In
//   time slot t a block makes step k on segment t - k for every k in
//   0 .. 2n-3 that has one, so the arrivals it reads were made in the
//   left rank's slot t - 1 and one flag round trip serves up to 2n-2
//   passes. Each forwarded step has two buffers per (rank, stripe), taken
//   by the parity of t. Before slot t a block waits for the left's recv
//   flag of that parity and, before it forwards into the buffers the
//   right read in slot t - 1, for the right's credit (cap); after its
//   passes it publishes once (block_publish), raises the right's recv
//   flag and credits the parity it read to the left. Each wait and raise
//   is made only in the slots where the other side has its counterpart
//   (ch_forwards), so every flag ends at 0. Waits poll hot and trap after
//   30 s.
// - Where the values go: with CLUSTER (n up to 8) the n ranks' blocks of
//   a stripe form one thread-block cluster; each rank's buffers and flags
//   live in its own shared memory, and the left rank stores into them
//   over the SM-to-SM network (mapa / st.shared::cluster, the flags
//   raised with red.shared::cluster and polled with cluster-scope acquire
//   loads). Beyond 8 ranks the buffers are in HBM scratch kept within
//   the 50 MB L2 (pallas_ring.RS_SLOT_BYTES) under a cooperative launch.
//   Either way only x and out touch HBM, 2 n B, and the scratch stays
//   bounded however large the message: the reason this kernel exists.
// - Loads in flight: a thread issues the loads of up to kChBatch passes
//   of the slot together (the arrival, and x for a fold), then folds and
//   stores them; the first batch's x vectors (and step 0's arrival,
//   which is x) are loaded before the waits. Each thread finds its
//   passes' addresses itself, from a table of each step's block set once
//   per block (the first build set them once per slot in shared memory,
//   behind a barrier: 16% of a block's span with the other per-slot
//   work, PERF.md). 16-byte vectors; x read and out written as streams.
#include "ring_common.cuh"

namespace ompi_ring {

// Threads per block at most (the batch below takes up to 128 registers).
constexpr int kChThreads = 512;
// Passes of one time slot whose loads are in flight together.
constexpr int kChBatch = 8;
// Ranks at most: a slot has up to 2n - 2 passes.
constexpr int kChMaxRanks = 64;
constexpr int kChClusterRanks = 8;
// Buffers per forwarded step of each (rank, stripe): one for each parity
// of t.
constexpr int kChBufs = 2;

// The kernel's flags and buffers: in comm and sems (HBM, through L2),
// or, with CLUSTER, in the shared memory of the rank that reads them.
template <typename T, int OP, bool CLUSTER = false>
__global__ void __launch_bounds__(kChThreads)
    ring_allreduce_chunked_kernel(const uint4* __restrict__ x,
                                  uint4* __restrict__ out, uint4* comm,
                                  int* sems, int n, int stripes,
                                  long long cv, long long seg_v,
                                  int n_segs) {
  // The ring block step k folds (k < n-1: x[me][blk]) or stores (k >=
  // n-2: out[me][blk]), set once: no division in the passes.
  __shared__ int k_blk[2 * (CLUSTER ? kChClusterRanks : kChMaxRanks) - 2];
  // CLUSTER: this rank's 2 kChBufs flags, then its (2n-3) x kChBufs
  // buffers.
  extern __shared__ uint4 cluster_smem[];
  // A cluster holds the n ranks of one stripe, block rank r = rank r.
  const int r = CLUSTER ? blockIdx.x % n : blockIdx.x / stripes;
  const int s = CLUSTER ? blockIdx.x / n : blockIdx.x % stripes;
  const int left = (r - 1 + n) % n, right = (r + 1) % n;
  const int nsteps = 2 * (n - 1);
  const long long sv = (cv + stripes - 1) / stripes;  // vectors per stripe
  const long long c0 = (long long)s * sv;
  const long long cw = c0 < cv ? (cv - c0 < sv ? cv - c0 : sv) : 0;
  auto xblk = [&](int rank, int blk) {
    return x + ((long long)rank * n + blk) * cv + c0;
  };
  auto oblk = [&](int blk) {
    return out + ((long long)r * n + blk) * cv + c0;
  };
  // Vectors of segment i in this stripe (0 past its end).
  auto seg_len = [&](long long a) {
    return a < cw ? (cw - a < seg_v ? cw - a : seg_v) : 0;
  };
  for (int k = threadIdx.x; k < nsteps; k += blockDim.x)
    k_blk[k] = ((k < n - 1 ? r - k - 2 : r - k + n - 2) % n + n) % n;
  // Step 0's arrival: the left rank's x block me-2.
  const uint4* const x_left = xblk(left, ((r - 2) % n + n) % n);
  int* const local_flags = reinterpret_cast<int*>(cluster_smem);
  uint4* const local_bufs = cluster_smem + (2 * kChBufs + 3) / 4;
  // Buffer (k, b) of a rank's stripe s: the arrival of step k >= 1 that
  // the rank reads in time slots t of parity b, at this offset in its
  // buffers (in comm at rank_bufs(rank), with CLUSTER in its shared
  // memory, the right rank's reached at right_bufs).
  auto buf_at = [&](int k, int b) {
    return ((long long)(k - 1) * kChBufs + b) * seg_v;
  };
  auto rank_bufs = [&](int rank) {
    return comm + ((long long)rank * stripes + s) * (nsteps - 1) * kChBufs *
                      seg_v;
  };
  uint4* const my_bufs = CLUSTER ? local_bufs : rank_bufs(r);
  uint4* const right_global = CLUSTER ? nullptr : rank_bufs(right);
  const unsigned right_bufs =
      CLUSTER ? peer_addr(cta_addr(local_bufs), right) : 0;
  // Flags per (rank, stripe): recv[2] (arrivals in buffers b), then
  // cap[2] (the right neighbour's credit on its buffers b).
  int* const global_flags = sems + (r * stripes + s) * 2 * kChBufs;
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
      raise_flag(sems + (rank * stripes + s) * 2 * kChBufs + i);
  };
  auto fwd = [&](int p) { return ch_forwards(p, n, n_segs); };
  const int slots = n_segs + nsteps - 1;
  const unsigned long long keep = l2_policy(true);
#ifdef OMPI_RING_PROBE
  // probe: ns thread 0 spent waiting, in its passes, and publishing
  unsigned long long waited = 0, passing = 0, publishing = 0;
#endif
  if (CLUSTER) {
    // Every rank of the cluster runs, its flags at 0, before any store
    // into its shared memory.
    for (int i = threadIdx.x; i < 2 * kChBufs; i += blockDim.x)
      local_flags[i] = 0;
    cluster_sync();
  } else {
    __syncthreads();
  }
  OMPI_PROBE(0);

  for (int t = 0; t < slots; ++t) {
    // Passes k_lo .. k_hi (at least one), step k on segment t - k; pass
    // q is k_lo + q.
    const int k_lo = t - n_segs + 1 > 0 ? t - n_segs + 1 : 0;
    const int k_hi = nsteps - 1 < t ? nsteps - 1 : t;
    const int m = k_hi - k_lo + 1;
    // The first batch's x vectors (a fold's own block, step 0's left
    // block), loaded before the waits.
    uint4 b[kChBatch], a0;
#pragma unroll
    for (int q = 0; q < kChBatch; ++q) {
      const int k = k_lo + q;
      const long long a = (long long)(t - k) * seg_v;
      if (q < m && k < n - 1 && threadIdx.x < seg_len(a))
        b[q] = __ldcs(xblk(r, k_blk[k]) + a + threadIdx.x);
    }
    if (k_lo == 0 && threadIdx.x < seg_len((long long)t * seg_v))
      a0 = __ldcs(x_left + (long long)t * seg_v + threadIdx.x);
    if (threadIdx.x == 0) {
#ifdef OMPI_RING_PROBE
      const unsigned long long w0 = global_ns();
#endif
      if (fwd(t - 1)) wait_flag(t & 1);
      if (fwd(t) && fwd(t - 2)) wait_flag(kChBufs + ((t + 1) & 1));
#ifdef OMPI_RING_PROBE
      waited += global_ns() - w0;
#endif
    }
    __syncthreads();
#ifdef OMPI_RING_PROBE
    const unsigned long long p0 = global_ns();
#endif
    for (int q0 = 0; q0 < m; q0 += kChBatch) {
      for (long long i = threadIdx.x; i < seg_v; i += blockDim.x) {
        const bool fetched = q0 == 0 && i == threadIdx.x;
        uint4 a[kChBatch];
#pragma unroll
        for (int u = 0; u < kChBatch; ++u) {
          const int k = k_lo + q0 + u;
          const long long off = (long long)(t - k) * seg_v;
          if (q0 + u >= m || i >= seg_len(off)) continue;
          if (k == 0)  // the left's x: read once
            a[u] = fetched ? a0 : __ldcs(x_left + off + i);
          else if (CLUSTER)
            a[u] = my_bufs[buf_at(k, t & 1) + i];  // this rank's smem
          else
            a[u] = __ldcg(my_bufs + buf_at(k, t & 1) + i);
          if (k < n - 1 && !fetched)
            b[u] = __ldcs(xblk(r, k_blk[k]) + off + i);
        }
#pragma unroll
        for (int u = 0; u < kChBatch; ++u) {
          const int k = k_lo + q0 + u;
          const long long off = (long long)(t - k) * seg_v;
          if (q0 + u >= m || i >= seg_len(off)) continue;
          const uint4 v = k < n - 1 ? combine_vec<T, OP>(a[u], b[u]) : a[u];
          if (k >= n - 2)  // out[me]: never read here
            __stcs(oblk(k_blk[k]) + off + i, v);
          if (k == nsteps - 1) continue;
          const long long to = buf_at(k + 1, (t + 1) & 1) + i;
          if (CLUSTER)
            st_peer(right_bufs + 16 * (unsigned)to, v);  // the right's smem
          else
            st_child(right_global + to, v, keep);  // the right's buffer
        }
      }
    }
#ifdef OMPI_RING_PROBE
    const unsigned long long p1 = global_ns();
    passing += p1 - p0;
#endif
    block_publish();
    if (threadIdx.x == 0) {
      if (fwd(t)) raise_at(right, (t + 1) & 1);
      if (fwd(t - 1) && fwd(t + 1)) raise_at(left, kChBufs + (t & 1));
    }
#ifdef OMPI_RING_PROBE
    publishing += global_ns() - p1;
#endif
  }
  OMPI_PROBE(1);
  OMPI_PROBE_AT(2, waited);
  OMPI_PROBE_AT(3, passing);
  OMPI_PROBE_AT(4, publishing);
  if (CLUSTER) {
    // No rank leaves while another may still reach its shared memory;
    // then the flags' ends go to sems, where the host checks them.
    cluster_sync();
    for (int i = threadIdx.x; i < 2 * kChBufs; i += blockDim.x)
      global_flags[i] = local_flags[i];
  }
}

// The cluster form as a two-parameter template, for OMPI_RING_PICK.
template <typename T, int OP>
constexpr auto ring_allreduce_chunked_cluster =
    &ring_allreduce_chunked_kernel<T, OP, true>;

// Instantiate the kernel for the (op, dtype) codes, with or without
// clusters (nullptr for an unknown pair).
inline const void* ch_kernel(int op, int dtype, bool cluster) {
  return cluster
             ? OMPI_RING_PICK(ring_allreduce_chunked_cluster)(op, dtype)
             : OMPI_RING_PICK(ring_allreduce_chunked_kernel)(op, dtype);
}

// Dynamic shared memory of a cluster launch: the flags, then the
// (2n-3) x kChBufs buffers of seg vectors.
inline size_t ch_cluster_smem(int n, long long seg) {
  return ((size_t)(2 * kChBufs + 3) / 4 +
          (size_t)(2 * n - 3) * kChBufs * seg) *
         16;
}

}  // namespace ompi_ring

// x, out: (n, n, C) rank-major ring blocks, C a whole number of 16-byte
// vectors (c_bytes its bytes), both 16-byte aligned; comm: (n, stripes,
// 2n - 3, 2, seg) 16-byte vectors (nothing with clusters); sems: (n,
// stripes, 2, 2) int32, all 0 at entry and left at 0 (with clusters the
// flags live in shared memory and their ends are copied there); seg:
// vectors per segment, n_segs segments per stripe (n_segs * seg >=
// ceil(C / 16 / stripes)); `threads` per block, at most 512; n from 2 to
// 64, or to 8 with clusters. Without clusters the grid is one
// cooperative launch of resident blocks; with them, one cluster of the n
// ranks' blocks per stripe, each cluster on its own. Returns the CUDA
// error of the launch (0 on success).
extern "C" int ompi_ring_allreduce_chunked(const void* x, void* out,
                                           void* comm, void* sems, int n,
                                           int stripes, int threads,
                                           long long c_bytes, long long seg,
                                           int n_segs, int cluster, int op,
                                           int dtype, int device,
                                           void* stream) {
  using namespace ompi_ring;
  if (n < 2 || n > kChMaxRanks || stripes < 1 || threads < 32 ||
      threads > kChThreads || seg < 1 || n_segs < 1 || c_bytes & 15 ||
      (cluster && n > kChClusterRanks))
    return (int)cudaErrorInvalidValue;
  long long cv = c_bytes / 16;
  void* args[] = {(void*)&x, &out, &comm, &sems,  &n,
                  &stripes,  &cv,  &seg,  &n_segs};
  const void* fn = ch_kernel(op, dtype, cluster != 0);
  if (!cluster)
    return launch_cooperative(fn, n * stripes, threads, args, device,
                              stream);
  return launch_clusters(fn, n, threads, ch_cluster_smem(n, seg),
                         n * stripes, args, device, stream);
}

// How many clusters of the n <= 8 ranks' blocks (`threads` each,
// seg-vector buffers) the card holds at once, or minus the CUDA error.
extern "C" int ompi_ring_allreduce_chunked_clusters(int n, int threads,
                                                    long long seg,
                                                    int device) {
  using namespace ompi_ring;
  return max_clusters(ch_kernel(OP_SUM, DT_F32, true), n, threads,
                      ch_cluster_smem(n, seg), device);
}
