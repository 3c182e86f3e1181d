// quant_allreduce: the int8-wire ring allreduce on Hopper, one pass per
// step in a wavefront over segments of rows, the wire handed over in a
// thread-block cluster's shared memory (or, beyond 8 ranks, in L2).
//
// Replaces ompi_tpu/coll/quant.py:_quant_allreduce_kernel (wrapper
// quant_allreduce, used by allreduce_block_quant): a SUM ring over
// 2(n-1) steps whose wire is int8 rows of 128 values plus one f32 scale
// per row (scale = max|row| / 127, 1 for an all-zero row). The seed is
// the wire image of block r-1; a reduce-scatter step dequantizes the
// arrival, adds this rank's block and requantizes (the last one also
// writes the block's dequantized image, so every rank reconstructs the
// same values); an allgather step writes the dequantized arrival and
// forwards its bytes unchanged.
//
// Bound: bytes. Every rank's n ring blocks are read once and its n
// output blocks written once: 2 n B for B bytes per rank, 5.128 ms at 1
// GiB and n = 8 on an H100 (3.35 TB/s). The arithmetic (an IEEE division
// per quantized value, a product and a sum per dequantized one) is
// about 1.5-2.5 ms of the card's issue rate at that size, so it has to
// run under the loads. The first port ran each stripe in lock-step
// through HBM comm slots: a send pass copying a slot into the right
// neighbour's, then, after the flag, a fold pass reading the arrival and
// x and writing the slot back: about 3.5 GiB of HBM traffic a rank at n
// = 8 against the bound's 2 GiB (13.63 ms).
//
// What this design does about it (ring_allreduce_chunked.cu's, carried
// over to the quantized wire):
// - One pass per step. At a reduce-scatter step k < n-1 a rank reads the
//   arrival (an int8 row and its scale) and stores
//   requant(dequant(arrival) + x[me][me-k-2]) straight into the right
//   neighbour's buffer for step k+1, and at k = n-2 also the dequantized
//   image into out[me][me]; at an allgather step it stores
//   dequant(arrival) into out and forwards the same bytes and scale (but
//   at the last step). Step 0's arrival is the left rank's seed,
//   quant(x[left][me-2]), which the block computes itself from x (no
//   seed pass, no handover): quantization is deterministic, so the bits
//   are the first port's and the JAX schedule's.
// - Segments of whole rows (a scale covers one row), one warp per row,
//   four floats a lane as one 16-byte load, the row's max|x| by
//   shuffles, four int8 values as one 4-byte store. Wavefront: (rank r,
//   segment i, step k) needs only (r-1, i, k-1); in time slot t a block
//   makes step k on segment t - k for every k that has one, so one flag
//   round trip serves up to 2n-2 passes. Each forwarded step has two
//   buffers per (rank, stripe), taken by the parity of t; the flags and
//   their placement are the chunked ring's (ch_forwards): a buffer is
//   credited to the left only after the passes that read it, and every
//   flag ends at 0. Waits poll hot and trap after 30 s.
// - Where the wire goes: with CLUSTER (n up to 8) the n ranks' blocks of
//   a stripe form one cluster; each rank's buffers and flags live in its
//   own shared memory, stored into over the SM-to-SM network. Its flags
//   are zeroed by the block before a cluster barrier that precedes every
//   peer store, and a second barrier keeps it alive while peers may
//   still store into it. Beyond 8 ranks the buffers are in HBM scratch
//   kept within L2 (pallas_ring.RS_SLOT_BYTES) under a cooperative
//   launch. Either way only x and out touch HBM, 2 n B. The int8 wire is
//   a quarter of the f32 ring's bytes, so a buffer holds four times the
//   values of the chunked ring's.
// - Many warps: a pass is a chain of dependent operations (shuffles for
//   the row's max, divisions), so latency, not the issue rate, set the
//   pace of the first build (12.4 ms with 4 blocks of 128 threads a SM
//   and the loads of 8 passes in flight a warp). Four blocks of 256
//   threads a SM (64 registers a thread), the loads of kQBatch = 2 passes
//   in flight a warp, 8.0 ms (PERF.md, tools/quant_hop_check.py). The
//   first batch's x rows (and step 0's left row) are loaded before the
//   waits. Where |v / scale| lies more than 0.0002 from a tie, rint of the
//   product with the reciprocal is rint of the quotient (q_rint), so most
//   values skip the division (1.5-3.5% faster).
//
// Bits: the arithmetic is the JAX package's, operation by operation:
// IEEE divisions (m / 127, and x / scale, whose rint q_rint gives),
// rintf (half to even, as jnp.round), a clip to +-127 before the int8
// cast, and the dequantize-accumulate as a rounded product then a
// rounded sum (__fmul_rn, __fadd_rn: nvcc would otherwise contract it
// into an FMA).
#include "ring_common.cuh"

namespace ompi_ring {

constexpr int kLanes = 128;  // values per row
constexpr float kLevels = 127.0f;
// Threads per block at most, and blocks of them an SM holds: the passes
// are chains of dependent operations (shuffles, divisions), so the
// kernel wants many warps a SM more than loads in flight a warp; four
// blocks of 256 cap a thread at 64 registers.
constexpr int kQThreads = 256;
constexpr int kQMinBlocks = 4;
// Passes of one time slot whose loads are in flight together.
constexpr int kQBatch = 2;
constexpr int kQMaxRanks = 64;
constexpr int kQClusterRanks = 8;
// Buffers per forwarded step of each (rank, stripe): one per parity of t.
constexpr int kQBufs = 2;

// Whole warp, one row: lane l holds values 4l..4l+3. Returns the row's
// scale on every lane.
__device__ __forceinline__ float row_scale(const float4& v) {
  float m = fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                  fmaxf(fabsf(v.z), fabsf(v.w)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m > 0.0f ? __fdiv_rn(m, kLevels) : 1.0f;
}

// rint(v / scale), the quotient correctly rounded, without the division
// where it cannot matter: v times the correctly rounded reciprocal is
// within 2e-5 of v / scale wherever |v / scale| <= 128 (it is: scale >=
// max|row| / 127), and rounding the quotient moves it by at most 8e-6,
// so where the product lies more than 0.0002 from a tie both round to
// the same integer. Near a tie, or where the reciprocal overflows (the
// product is then not finite), the IEEE division.
__device__ __forceinline__ float q_rint(float v, float scale, float rcp) {
  const float a = __fmul_rn(v, rcp);
  const float r = rintf(a);
  if (fabsf(a - r) < 0.4998f) return r;
  return rintf(__fdiv_rn(v, scale));
}

__device__ __forceinline__ unsigned quant_one(float v, float scale,
                                              float rcp) {
  const float q = fminf(fmaxf(q_rint(v, scale, rcp), -kLevels), kLevels);
  return (unsigned)(unsigned char)(signed char)(int)q;
}

// Four int8 values as one 32-bit word (a char4, value 4l in the low
// byte).
__device__ __forceinline__ unsigned quant4(const float4& v, float scale) {
  const float rcp = __frcp_rn(scale);
  return quant_one(v.x, scale, rcp) | quant_one(v.y, scale, rcp) << 8 |
         quant_one(v.z, scale, rcp) << 16 | quant_one(v.w, scale, rcp) << 24;
}

__device__ __forceinline__ float q_at(unsigned packed, int k) {
  return (float)(signed char)(packed >> (8 * k));
}

__device__ __forceinline__ float4 dequant4(unsigned packed, float scale) {
  return make_float4(__fmul_rn(q_at(packed, 0), scale),
                     __fmul_rn(q_at(packed, 1), scale),
                     __fmul_rn(q_at(packed, 2), scale),
                     __fmul_rn(q_at(packed, 3), scale));
}

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// Bytes of one buffer: seg_rows int8 rows of 128 values, then their
// seg_rows f32 scales, rounded up to whole 16-byte vectors.
__host__ __device__ inline long long q_buf_bytes(long long seg_rows) {
  return seg_rows * kLanes + (seg_rows * 4 + 15) / 16 * 16;
}

// Block (r, s) plays rank r on rows [s*sr, s*sr + cr) of every ring
// block, in n_segs segments of seg_rows rows. x and out are (n ranks, n
// blocks, rows, 128) f32. Without CLUSTER, comm holds per (rank, stripe)
// the (2n-3) x kQBufs buffers of q_buf_bytes(seg_rows) and sems the
// flags; with it, both live in the reading rank's shared memory.
template <bool CLUSTER>
__global__ void __launch_bounds__(kQThreads, kQMinBlocks)
    quant_allreduce_kernel(const float* __restrict__ x,
                           float* __restrict__ out, char* comm, int* sems,
                           int n, int stripes, long long rows, int seg_rows,
                           int n_segs) {
  // The ring block step k folds (k < n-1: x[me][blk]) or stores (k >=
  // n-2: out[me][blk]), set once: no division in the passes.
  __shared__ int k_blk[2 * (CLUSTER ? kQClusterRanks : kQMaxRanks) - 2];
  // CLUSTER: this rank's 2 kQBufs flags in the first 16 bytes, then its
  // (2n-3) x kQBufs buffers.
  extern __shared__ uint4 cluster_smem[];
  // A cluster holds the n ranks of one stripe, block rank r = rank r.
  const int r = CLUSTER ? blockIdx.x % n : blockIdx.x / stripes;
  const int s = CLUSTER ? blockIdx.x / n : blockIdx.x % stripes;
  const int left = (r - 1 + n) % n, right = (r + 1) % n;
  const int nsteps = 2 * (n - 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const long long sr = (rows + stripes - 1) / stripes;  // rows per stripe
  const long long r0 = (long long)s * sr;
  const long long cr = r0 < rows ? (rows - r0 < sr ? rows - r0 : sr) : 0;
  // Lane's four values of row i (of this stripe) of a ring block.
  auto xrow = [&](int rank, int blk, long long i) {
    return reinterpret_cast<const float4*>(
               x + (((long long)rank * n + blk) * rows + r0 + i) * kLanes) +
           lane;
  };
  auto orow = [&](int blk, long long i) {
    return reinterpret_cast<float4*>(
               out + (((long long)r * n + blk) * rows + r0 + i) * kLanes) +
           lane;
  };
  // Rows of the segment that starts at row a of this stripe (0 past its
  // end).
  auto seg_len = [&](long long a) {
    return a < cr ? (cr - a < seg_rows ? cr - a : seg_rows) : 0;
  };
  for (int k = threadIdx.x; k < nsteps; k += blockDim.x)
    k_blk[k] = ((k < n - 1 ? r - k - 2 : r - k + n - 2) % n + n) % n;
  const int seed_blk = ((r - 2) % n + n) % n;  // the left's x block
  const long long buf_bytes = q_buf_bytes(seg_rows);
  // Buffer (k, b): the arrival of step k >= 1 that a rank reads in time
  // slots t of parity b, at this byte offset in its buffers; within it
  // row i's int8 values at i * 128, its scale at seg_rows * 128 + 4 i.
  auto buf_at = [&](int k, int b) {
    return ((long long)(k - 1) * kQBufs + b) * buf_bytes;
  };
  const long long scales_at = (long long)seg_rows * kLanes;
  auto rank_bufs = [&](int rank) {
    return comm + ((long long)rank * stripes + s) * (nsteps - 1) * kQBufs *
                      buf_bytes;
  };
  int* const local_flags = reinterpret_cast<int*>(cluster_smem);
  char* const local_bufs = reinterpret_cast<char*>(cluster_smem + 1);
  const char* const my_bufs = CLUSTER ? local_bufs : rank_bufs(r);
  char* const right_global = CLUSTER ? nullptr : rank_bufs(right);
  const unsigned right_bufs =
      CLUSTER ? peer_addr(cta_addr(local_bufs), right) : 0;
  // Flags per (rank, stripe): recv[2] (arrivals in buffers b), then
  // cap[2] (the right neighbour's credit on its buffers b).
  int* const global_flags = sems + (r * stripes + s) * 2 * kQBufs;
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
      raise_flag(sems + (rank * stripes + s) * 2 * kQBufs + i);
  };
  auto fwd = [&](int p) { return ch_forwards(p, n, n_segs); };
  const int slots = n_segs + nsteps - 1;
  if (CLUSTER) {
    // Every rank of the cluster runs, its flags at 0, before any store
    // into its shared memory.
    for (int i = threadIdx.x; i < 2 * kQBufs; i += blockDim.x)
      local_flags[i] = 0;
    cluster_sync();
  } else {
    __syncthreads();
  }

  for (int t = 0; t < slots; ++t) {
    // Passes k_lo .. k_hi (at least one), step k on segment t - k; pass
    // q is k_lo + q.
    const int k_lo = t - n_segs + 1 > 0 ? t - n_segs + 1 : 0;
    const int k_hi = nsteps - 1 < t ? nsteps - 1 : t;
    const int m = k_hi - k_lo + 1;
    // The first batch's x rows of this warp's first row (a fold's own
    // block; step 0's left block), loaded before the waits.
    float4 b[kQBatch], a0;
#pragma unroll
    for (int q = 0; q < kQBatch; ++q) {
      const int k = k_lo + q;
      const long long a = (long long)(t - k) * seg_rows;
      if (q < m && k < n - 1 && warp < seg_len(a))
        b[q] = __ldcs(xrow(r, k_blk[k], a + warp));
    }
    if (k_lo == 0 && warp < seg_len((long long)t * seg_rows))
      a0 = __ldcs(xrow(left, seed_blk, (long long)t * seg_rows + warp));
    if (threadIdx.x == 0) {
      if (fwd(t - 1)) wait_flag(t & 1);
      if (fwd(t) && fwd(t - 2)) wait_flag(kQBufs + ((t + 1) & 1));
    }
    __syncthreads();
    for (int q0 = 0; q0 < m; q0 += kQBatch) {
      for (int i = warp; i < seg_rows; i += warps) {
        const bool fetched = q0 == 0 && i == warp;
        unsigned aq[kQBatch];
        float as[kQBatch];
        float4 seed;
#pragma unroll
        for (int u = 0; u < kQBatch; ++u) {
          const int k = k_lo + q0 + u;
          const long long off = (long long)(t - k) * seg_rows;
          if (q0 + u >= m || i >= seg_len(off)) continue;
          if (k == 0) {  // the left's x row, quantized below
            seed = fetched ? a0 : __ldcs(xrow(left, seed_blk, off + i));
          } else {
            const char* buf = my_bufs + buf_at(k, t & 1);
            const unsigned* q =
                reinterpret_cast<const unsigned*>(buf + (long long)i * kLanes);
            const float* sc =
                reinterpret_cast<const float*>(buf + scales_at) + i;
            if (CLUSTER) {  // this rank's shared memory
              aq[u] = q[lane];
              as[u] = *sc;
            } else {
              aq[u] = __ldcg(q + lane);
              as[u] = __ldcg(sc);
            }
          }
          if (k < n - 1 && !fetched)
            b[u] = __ldcs(xrow(r, k_blk[k], off + i));
        }
#pragma unroll
        for (int u = 0; u < kQBatch; ++u) {
          const int k = k_lo + q0 + u;
          const long long off = (long long)(t - k) * seg_rows;
          if (q0 + u >= m || i >= seg_len(off)) continue;
          unsigned pk;
          float sc;
          if (k == 0) {
            sc = row_scale(seed);
            pk = quant4(seed, sc);
          } else {
            pk = aq[u];
            sc = as[u];
          }
          if (k < n - 1) {
            const float4 v = add4(dequant4(pk, sc), b[u]);
            sc = row_scale(v);
            pk = quant4(v, sc);
            if (k == n - 2)  // out[me][me]: the finished block's image
              __stcs(orow(k_blk[k], off + i), dequant4(pk, sc));
          } else {
            __stcs(orow(k_blk[k], off + i), dequant4(pk, sc));
          }
          if (k == nsteps - 1) continue;
          // Into the right's buffer for step k + 1.
          const long long to = buf_at(k + 1, (t + 1) & 1);
          const long long qo = to + (long long)i * kLanes + 4 * lane;
          const long long so = to + scales_at + 4 * (long long)i;
          if (CLUSTER) {
            st_peer(right_bufs + (unsigned)qo, pk);
            if (lane == 0) st_peer(right_bufs + (unsigned)so, __float_as_uint(sc));
          } else {
            __stcg(reinterpret_cast<unsigned*>(right_global + qo), pk);
            if (lane == 0) __stcg(reinterpret_cast<float*>(right_global + so), sc);
          }
        }
      }
    }
    block_publish();
    if (threadIdx.x == 0) {
      if (fwd(t)) raise_at(right, (t + 1) & 1);
      if (fwd(t - 1) && fwd(t + 1)) raise_at(left, kQBufs + (t & 1));
    }
  }
  if (CLUSTER) {
    // No rank leaves while another may still reach its shared memory;
    // then the flags' ends go to sems, where the host checks them.
    cluster_sync();
    for (int i = threadIdx.x; i < 2 * kQBufs; i += blockDim.x)
      global_flags[i] = local_flags[i];
  }
}

inline const void* quant_kernel(bool cluster) {
  return cluster ? (const void*)quant_allreduce_kernel<true>
                 : (const void*)quant_allreduce_kernel<false>;
}

// Dynamic shared memory of a cluster launch: the flags, then the
// (2n-3) x kQBufs buffers of seg_rows rows.
inline size_t quant_cluster_smem(int n, long long seg_rows) {
  return 16 + (size_t)(2 * n - 3) * kQBufs * q_buf_bytes(seg_rows);
}

}  // namespace ompi_ring

// x, out: (n, n, rows, 128) f32 rank-major ring blocks, 16-byte aligned;
// comm: (n, stripes, 2n - 3, 2) buffers of q_buf_bytes(seg_rows) bytes
// (nothing with clusters); sems: (n, stripes, 2, 2) int32, all 0 at
// entry and left at 0 (with clusters the flags live in shared memory
// and their ends are copied there); n_segs segments of seg_rows rows per
// stripe (n_segs * seg_rows >= ceil(rows / stripes)); `threads` per
// block, a multiple of 32 up to 256; n from 2 to 64, or to 8 with
// clusters. Without clusters the grid is one cooperative launch of
// resident blocks; with them, one cluster of the n ranks' blocks per
// stripe. Returns the CUDA error of the launch (0 on success).
extern "C" int ompi_quant_allreduce(const void* x, void* out, void* comm,
                                    void* sems, int n, int stripes,
                                    int threads, long long rows,
                                    int seg_rows, int n_segs, int cluster,
                                    int device, void* stream) {
  using namespace ompi_ring;
  if (n < 2 || n > kQMaxRanks || stripes < 1 || threads < 32 ||
      threads > kQThreads || threads % 32 || rows < 1 || seg_rows < 1 ||
      n_segs < 1 || (cluster && n > kQClusterRanks))
    return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&x, &out, &comm, &sems, &n,
                  &stripes,  &rows, &seg_rows, &n_segs};
  const void* fn = quant_kernel(cluster != 0);
  if (!cluster)
    return launch_cooperative(fn, n * stripes, threads, args, device,
                              stream);
  return launch_clusters(fn, n, threads, quant_cluster_smem(n, seg_rows),
                         n * stripes, args, device, stream);
}

// How many clusters of the n <= 8 ranks' blocks (`threads` each,
// segments of seg_rows rows) the card holds at once, or minus the CUDA
// error.
extern "C" int ompi_quant_allreduce_clusters(int n, int threads,
                                             long long seg_rows,
                                             int device) {
  using namespace ompi_ring;
  return max_clusters(quant_kernel(true), n, threads,
                      quant_cluster_smem(n, seg_rows), device);
}
