// sched_table: any schedule-compiler program that passes
// pallas_lower.analyze, on Hopper: fold-then-forward in a wavefront over
// segments, the partials handed over in a thread-block cluster's shared
// memory (or, beyond 8 ranks, in L2).
//
// Replaces ompi_tpu/coll/sched/pallas_lower.py:_kernel (wrapper
// _pallas_call, used by compile_schedule for sched_pallas_ring,
// sched_pallas_ring_seg, sched_pallas_rs and fused programs). Four
// (rounds, n) int32 tables name, per round and rank, the peer it sends
// to (dst), the peer it receives from (src), the chunk it sends and the
// chunk it receives into; a per-round info word holds the receive mode
// (1 reduce, 2 copy), `last` (this receive is the chunk's final value),
// `brk` (a stage round: the chain restarts from the input) and the
// links between stages that the flags need (below). The tables live in
// device memory and the kernel loops over the rounds at run time, so a
// fused program of hundreds of rounds is one launch of one compiled
// kernel.
//
// Bound: bytes, those of the collective the program computes (2 n B for
// an allreduce of B bytes per rank, (n + 1) B for a reduce-scatter of B
// sent); one combine per element is far below the operation rate. The
// first port copied every round's chunk into the peer's slot and folded
// it in a second pass, through HBM: at 1 GiB per rank and n = 8 the
// segmented program's slots took 1 GiB and each round about 4.5 passes
// of 64 MiB per rank, 35.84 ms against 5.128, with a fence on every
// thread and sleeping waits.
//
// What this design does about it:
// - One pass per round. A stage is a stage round (round 0 and every brk
//   round) and the chained rounds after it. At round k of a stage a rank
//   folds combine(arrival, x[me][t_rchunk]) (the reference's operands in
//   its order, so the bits stay; bf16 computed in f32 and rounded once a
//   round), or takes the arrival as it is for a copy round, writes the
//   value where the reference writes it (an allgather or a window's copy
//   segment its own chunk at the stage round; a reduce-scatter its last
//   value; a window's reduce segment its segment-final value; otherwise
//   every `last` receive), and, when round k+1 is chained, stores it
//   straight into the buffer of t_dst[k+1][me]. A stage round has no
//   handover: its receiver reads the sender's chunk
//   x[t_src][t_schunk[t_src]] from x, which never changes.
// - A wavefront per stage: each block cuts its stripe of a chunk into
//   n_segs segments; in time slot t it makes round k of the stage on
//   segment t - k for every k that has one, so one flag round trip
//   serves up to L - 1 passes for a stage of L rounds. Each (rank,
//   stripe) has two buffers per chained round of a stage, taken by the
//   parity of t: the arrival of round k on segment i is read in slot
//   i + k from buffer (k, (i + k) % 2). Stages run one after another and
//   reuse the buffers.
// - Flags with changing peers: a round's peers may change from stage to
//   stage (a fused program, a window, members with other ring orders),
//   so a flag never belongs to a slot alone. An arrival flag belongs to
//   (round of the stage, parity) at the receiver; a credit flag to
//   (receiver, round of the stage, parity) at the sender. After reading
//   buffer (k, p) a rank credits the next rank that writes it: the same
//   sender two slots later in the stage, or the sender of round k of the
//   next stage that has one (the `nxt` link); a sender waits for a
//   credit before every write into a buffer that was written before (an
//   earlier slot of the stage, or an earlier stage with a round k: the
//   `prv` link). Every wait meets exactly one raise and every flag ends
//   at 0; the credit that a later stage's receiver grants early cannot
//   satisfy a wait for another receiver.
// - Where the partials go: up to 8 ranks the n ranks' blocks of a stripe
//   form one thread-block cluster (cluster rank = table rank); each
//   rank's buffers and flags sit in its own shared memory and the sender
//   stores into them over the SM-to-SM network, so only x and out touch
//   L2 and HBM. Beyond 8 ranks the buffers are in HBM, all blocks'
//   within the L2 (pallas_lower._table_plan), under a cooperative
//   launch.
// - Loads in flight: a thread issues the loads of up to kTableBatch
//   passes of a slot together, then folds and stores them; the first
//   batch's x vectors are loaded before the waits. The passes' pointers
//   are set once per slot in shared memory; the waits of a slot run on
//   one lane each (one per pass), as do its raises, each after its own
//   release fence. 16-byte vectors; x read and out written as streams;
//   waits poll hot.
#include "ring_common.cuh"

namespace ompi_ring {

enum SchedKind { SK_ALLREDUCE = 0, SK_RS = 1, SK_AG = 2, SK_WINDOW = 3 };
// The per-round info word: the mode in bits 0-1, last, brk, prv (an
// earlier stage has a round at this round's place in its stage), and
// from bit kNextShift up nxt + 1 (nxt: the round at this place of the
// next stage that has one; 0 for none).
constexpr int kModeMask = 3, kLast = 4, kBrk = 8, kPrv = 16, kNextShift = 8;
// Threads per block at most (the batch below takes up to 128 registers).
constexpr int kTableThreads = 512;
// Passes of one time slot whose loads are in flight together.
constexpr int kTableBatch = 8;
// Passes per time slot at most: the rounds of a stage, and the own
// chunk's copy at the stage round.
constexpr int kTableMaxPasses = 64;
// Buffers per chained round of a stage of each (rank, stripe): one for
// each parity of the time slot.
constexpr int kTableBufs = 2;

// Flags per (rank, stripe) for n ranks and K chained rounds per stage at
// most: recv[K][2], then cap[n][K][2].
__host__ __device__ __forceinline__ int table_flags(int n, int K) {
  return kTableBufs * K * (n + 1);
}

// The kernel's flags and buffers: in comm and sems (HBM, through L2), or,
// with CLUSTER, in the shared memory of the rank that reads (buffers,
// arrival flags) or waits (credit flags).
template <typename T, int OP, bool CLUSTER = false>
__global__ void __launch_bounds__(kTableThreads)
    sched_table_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                       uint4* comm, int* sems, int n, int stripes,
                       const int* __restrict__ tables,
                       const int* __restrict__ info, int rounds, int nchunks,
                       long long cv, long long seg_v, int n_segs, int K,
                       int kind) {
  // This time slot's passes: arrival (x, or this rank's buffer), own x
  // chunk (a reduce), output, forward (with CLUSTER, the receiver's
  // buffer as its shared::cluster address), length.
  __shared__ const uint4* p_src[kTableMaxPasses];
  __shared__ const uint4* p_own[kTableMaxPasses];
  __shared__ uint4* p_out[kTableMaxPasses];
  __shared__ uint4* p_fwd[kTableMaxPasses];
  __shared__ unsigned p_peer[kTableMaxPasses];
  __shared__ long long p_len[kTableMaxPasses];
  __shared__ bool p_from_x[kTableMaxPasses];
  // CLUSTER: this rank's flags, then its 2K buffers of seg_v vectors.
  extern __shared__ uint4 table_smem[];
  // A cluster holds the n ranks of one stripe, block rank r = rank r.
  const int r = CLUSTER ? blockIdx.x % n : blockIdx.x / stripes;
  const int s = CLUSTER ? blockIdx.x / n : blockIdx.x % stripes;
  const long long sv = (cv + stripes - 1) / stripes;  // vectors per stripe
  const long long c0 = (long long)s * sv;
  const long long cw = c0 < cv ? (cv - c0 < sv ? cv - c0 : sv) : 0;
  const long long plane = (long long)rounds * n;
  // tables is (4, rounds, n): dst, src, send chunk, recv chunk.
  auto tab = [&](int which, int rd, int rank) {
    return tables[which * plane + (long long)rd * n + rank];
  };
  auto xchunk = [&](int rank, int c) {
    return x + ((long long)rank * nchunks + c) * cv + c0;
  };
  uint4* const outr =
      out + (long long)r * (kind == SK_RS ? 1 : nchunks) * cv + c0;
  const int nflags = table_flags(n, K);
  int* const local_flags = reinterpret_cast<int*>(table_smem);
  uint4* const local_bufs = table_smem + (nflags + 3) / 4;
  int* const global_flags = sems + (long long)(r * stripes + s) * nflags;
  // Buffer (j, p) of a rank's stripe: the arrival of round j >= 1 of a
  // stage that the rank reads in time slots of parity p. With CLUSTER the
  // reader's own are local_bufs, a peer's are reached by peer_addr.
  auto buf = [&](int rank, int j, int p) -> uint4* {
    const long long off = ((long long)(j - 1) * kTableBufs + p) * seg_v;
    if (CLUSTER) return local_bufs + off;
    return comm + ((long long)rank * stripes + s) * kTableBufs * K * seg_v +
           off;
  };
  auto recv_flag = [&](int j, int p) { return (j - 1) * kTableBufs + p; };
  auto cap_flag = [&](int receiver, int j, int p) {
    return kTableBufs * K + (receiver * K + j - 1) * kTableBufs + p;
  };
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
      raise_flag(sems + (long long)(rank * stripes + s) * nflags + i);
  };
  const unsigned long long keep = l2_policy(true);
#ifdef OMPI_RING_PROBE
  unsigned long long waited = 0;  // probe: ns the block spent waiting
#endif
  if (CLUSTER) {
    // Every rank of the cluster runs, its flags at 0, before any store
    // into its shared memory.
    for (int i = threadIdx.x; i < nflags; i += blockDim.x)
      local_flags[i] = 0;
    cluster_sync();
  }
  OMPI_PROBE(0);

  for (int b0 = 0; b0 < rounds;) {
    int L = 1;  // the stage's rounds
    while (b0 + L < rounds && !(info[b0 + L] & kBrk)) ++L;
    // The own chunk never travels: final at its stage round (copy
    // segments only).
    const bool own_copy =
        kind == SK_AG || (kind == SK_WINDOW && (info[b0] & kModeMask) == 2);
    for (int t = 0; t < n_segs + L - 1; ++t) {
      // Passes k_lo .. k_hi, round k on segment t - k; pass q is round
      // k_lo + q, and the own copy (with k_lo = 0) comes last.
      const int k_lo = t - n_segs + 1 > 0 ? t - n_segs + 1 : 0;
      const int k_hi = L - 1 < t ? L - 1 : t;
      const int rounds_here = k_hi - k_lo + 1;
      const int m = rounds_here + (own_copy && k_lo == 0);
      for (int q = threadIdx.x; q < m; q += blockDim.x) {
        const int k = q < rounds_here ? k_lo + q : 0;
        const int rd = b0 + k;
        const long long a = (long long)(t - k) * seg_v;
        p_len[q] = a < cw ? (cw - a < seg_v ? cw - a : seg_v) : 0;
        p_fwd[q] = nullptr;
        if (q == rounds_here) {  // the own chunk's copy
          const int sc = tab(2, b0, r);
          p_src[q] = xchunk(r, sc) + a;
          p_from_x[q] = true;
          p_own[q] = nullptr;
          p_out[q] = outr + (long long)sc * cv + a;
          continue;
        }
        const int inf = info[rd];
        const int mode = inf & kModeMask;
        if (k == 0) {
          const int src = tab(1, rd, r);
          p_src[q] = xchunk(src, tab(2, rd, src)) + a;
        } else {
          p_src[q] = buf(r, k, t & 1);
        }
        p_from_x[q] = k == 0;
        const int rc = tab(3, rd, r);
        p_own[q] = mode == 1 ? xchunk(r, rc) + a : nullptr;
        const bool final_round =
            rd == rounds - 1 || (info[rd + 1] & kBrk) != 0;
        bool write = (inf & kLast) != 0;
        if (kind == SK_RS) write = rd == rounds - 1;
        if (kind == SK_WINDOW && mode == 1) write = final_round;
        uint4* const dest = kind == SK_RS ? outr : outr + (long long)rc * cv;
        p_out[q] = write ? dest + a : nullptr;
        if (k < L - 1) {
          const int dst = tab(0, rd + 1, r);
          p_fwd[q] = buf(dst, k + 1, (t + 1) & 1);
          if (CLUSTER) p_peer[q] = peer_addr(cta_addr(p_fwd[q]), dst);
        }
      }
      __syncthreads();
      // The first batch's x vectors, loaded before the waits.
      uint4 bv[kTableBatch];
#pragma unroll
      for (int u = 0; u < kTableBatch; ++u)
        if (u < m && p_own[u] && threadIdx.x < p_len[u])
          bv[u] = __ldcs(p_own[u] + threadIdx.x);
      // Lane q waits for round k_lo + q's arrival and for the credit on
      // the buffer it forwards into.
#ifdef OMPI_RING_PROBE
      const unsigned long long w0 = global_ns();
#endif
      if (threadIdx.x < rounds_here) {
        const int k = k_lo + threadIdx.x, rd = b0 + k;
        if (k >= 1) wait_flag(recv_flag(k, t & 1));
        if (k < L - 1 && (t - 1 >= k + 1 || (info[rd + 1] & kPrv)))
          wait_flag(cap_flag(tab(0, rd + 1, r), k + 1, (t + 1) & 1));
      }
      __syncthreads();
#ifdef OMPI_RING_PROBE
      waited += global_ns() - w0;
#endif
      for (int q0 = 0; q0 < m; q0 += kTableBatch) {
        for (long long i = threadIdx.x; i < seg_v; i += blockDim.x) {
          const bool fetched = q0 == 0 && i == threadIdx.x;
          uint4 av[kTableBatch];
#pragma unroll
          for (int u = 0; u < kTableBatch; ++u) {
            const int q = q0 + u;
            if (q >= m || i >= p_len[q]) continue;
            if (p_from_x[q])
              av[u] = __ldcs(p_src[q] + i);  // x: read once
            else if (CLUSTER)
              av[u] = p_src[q][i];  // this rank's shared memory
            else
              av[u] = __ldcg(p_src[q] + i);
            if (!fetched && p_own[q]) bv[u] = __ldcs(p_own[q] + i);
          }
#pragma unroll
          for (int u = 0; u < kTableBatch; ++u) {
            const int q = q0 + u;
            if (q >= m || i >= p_len[q]) continue;
            const uint4 v =
                p_own[q] ? combine_vec<T, OP>(av[u], bv[u]) : av[u];
            if (p_out[q]) __stcs(p_out[q] + i, v);  // never read here
            if (!p_fwd[q]) continue;
            if (CLUSTER)
              st_peer(p_peer[q] + 16 * (unsigned)i, v);  // the receiver's
            else
              st_child(p_fwd[q] + i, v, keep);  // the receiver's buffer
          }
        }
      }
      // Lane q raises the receiver's arrival flag of what it forwarded
      // and credits the buffer it read to the rank that writes it next.
      __syncthreads();
      if (threadIdx.x < rounds_here) {
        cuda::atomic_thread_fence(cuda::memory_order_release,
                                  cuda::thread_scope_device);
        const int k = k_lo + threadIdx.x, rd = b0 + k;
        if (k < L - 1)
          raise_at(tab(0, rd + 1, r), recv_flag(k + 1, (t + 1) & 1));
        if (k >= 1) {
          const int next = t + 2 <= k + n_segs - 1
                               ? rd
                               : (info[rd] >> kNextShift) - 1;
          if (next >= 0) raise_at(tab(1, next, r), cap_flag(r, k, t & 1));
        }
      }
    }
    b0 += L;
  }
  OMPI_PROBE(1);
  OMPI_PROBE_AT(2, waited);
  if (CLUSTER) {
    // No rank leaves while another may still reach its shared memory;
    // then what is left on the block's flags (the sum of their
    // magnitudes) goes to one word of sems, where the host checks it.
    cluster_sync();
    if (threadIdx.x == 0) {
      int left = 0;
      for (int i = 0; i < nflags; ++i)
        left += local_flags[i] < 0 ? -local_flags[i] : local_flags[i];
      sems[r * stripes + s] = left;
    }
  }
}

// The cluster form as a two-parameter template, for OMPI_RING_PICK.
template <typename T, int OP>
constexpr auto sched_table_cluster = &sched_table_kernel<T, OP, true>;

// Instantiate the kernel for the (op, dtype) codes, with or without
// clusters (nullptr for an unknown pair).
inline const void* table_kernel(int op, int dtype, bool cluster) {
  return cluster ? OMPI_RING_PICK(sched_table_cluster)(op, dtype)
                 : OMPI_RING_PICK(sched_table_kernel)(op, dtype);
}

// Dynamic shared memory of a cluster launch: the flags, then the 2K
// buffers of seg vectors.
inline size_t table_cluster_smem(int n, int K, long long seg) {
  return ((size_t)(table_flags(n, K) + 3) / 4 +
          (size_t)kTableBufs * K * seg) *
         16;
}

}  // namespace ompi_ring

// x: (n, nchunks, C) rank-major, C a whole number of 16-byte vectors
// (c_bytes its bytes); out: the same, or (n, C) for a reduce-scatter (for
// a window, pre-filled with x by the caller), both 16-byte aligned; comm:
// (n, stripes, K, 2, seg) 16-byte vectors (nothing with clusters); sems:
// (n, stripes, 2K(n+1)) int32, all 0 at entry and left at 0 (with
// clusters the flags live in shared memory and sems is (n, stripes):
// each block leaves there the sum of its flags' magnitudes at exit);
// tables: (4, rounds, n) int32; info: (rounds,) int32 (the info word
// above); seg: vectors per segment, n_segs segments per stripe (n_segs *
// seg >= ceil(C / 16 / stripes)); K: the chained rounds of the longest
// stage (a stage has at most kTableMaxPasses - 1 rounds); kind: 0
// allreduce, 1 reduce_scatter, 2 allgather, 3 window; `threads` per
// block, 64 to 512 (a lane per pass); n at most 8 with clusters. Without
// clusters the grid is one cooperative launch of resident blocks; with
// them, one cluster of the n ranks' blocks per stripe, each cluster on
// its own. Returns the CUDA error of the launch (0 on success).
extern "C" int ompi_sched_table(const void* x, void* out, void* comm,
                                void* sems, int n, int stripes, int threads,
                                const void* tables, const void* info,
                                int rounds, int nchunks, long long c_bytes,
                                long long seg, int n_segs, int K, int cluster,
                                int kind, int op, int dtype, int device,
                                void* stream) {
  using namespace ompi_ring;
  if (n < 2 || stripes < 1 || threads < kTableMaxPasses ||
      threads > kTableThreads ||
      seg < 1 || n_segs < 1 || K < 0 || K + 2 > kTableMaxPasses ||
      c_bytes & 15 || (cluster && n > 8))
    return (int)cudaErrorInvalidValue;
  long long cv = c_bytes / 16;
  void* args[] = {(void*)&x, &out,    &comm,  &sems,   &n,
                  &stripes,  (void*)&tables, (void*)&info, &rounds,
                  &nchunks,  &cv,     &seg,   &n_segs, &K,
                  &kind};
  const void* fn = table_kernel(op, dtype, cluster != 0);
  if (!cluster)
    return launch_cooperative(fn, n * stripes, threads, args, device,
                              stream);
  return launch_clusters(fn, n, threads, table_cluster_smem(n, K, seg),
                         n * stripes, args, device, stream);
}

// How many clusters of the n <= 8 ranks' blocks (`threads` each, 2K
// buffers of seg vectors) the card holds at once, or minus the CUDA
// error.
extern "C" int ompi_sched_table_clusters(int n, int threads, long long seg,
                                         int K, int device) {
  using namespace ompi_ring;
  return max_clusters(table_kernel(OP_SUM, DT_F32, true), n, threads,
                      table_cluster_smem(n, K, seg), device);
}
