// ring_attention: exact attention over the ring on Hopper, the KV blocks
// circulating on a two-slot credit ring; half-precision products on the
// tensor cores (wgmma), fully masked work skipped, the causal ring's
// thread blocks balanced.
//
// Replaces ompi_tpu/coll/pallas_attn.py:_ring_attn_kernel (wrapper
// ring_attention_block, reached from parallel/sp.ring_attention with
// impl="pallas"). For every rank me, head h and query row i: softmax
// attention over all n*T keys of the ring, scores (q . k) * scale with
// scale = 1/sqrt(Dh) as a float32, the causal mask on global positions
// (me*T + i >= src*T + j, masked scores set to -1e30), f32 running max,
// denominator and output, and o / max(l, 1e-30) in the input dtype.
//
// Ranks on one card: q, k, v, out are rank-major (n, T, H, Dh). Each
// rank has two KV slots in device memory, slots (n, 2, 2T, H, Dh), K
// stacked over V. The grid is one persistent cooperative launch of
// `total` blocks (every block resident; how many fit comes from the
// occupancy of this kernel at its real shared memory and registers,
// ompi_ring_attention_blocks). Rank r owns blocks [offs[r], offs[r+1]):
// an equal split without the causal mask; under it a split by fold work
// (pallas_attn.split_blocks, see "Skipping" below), floored at the
// blocks its share of the forward copy needs. A block is 320 threads: two
// consumer warpgroups that fold, a ring warp and a copy warp.
//
// Protocol, the JAX kernel's, at every step s (slot = s % 2) of every
// block:
//   1. the ring warp, s > 0: wait until the current slot has arrived
//      from the left; hand it to the copy warp (an mbarrier) and, where
//      this rank folds step s, to the consumers (named barrier READY).
//   2. the copy warp, s < n-1: wait for the right neighbour's credit on
//      slot^1; store this block's share of the current block into the
//      right neighbour's slot^1 (bulk copies through shared memory, while
//      the consumers fold); publish; signal the right neighbour's
//      arrivals.
//   3. 1 <= s < n-2: credit the slot to the left neighbour once it has
//      been both computed on and forwarded: whichever of the consumers
//      and the copy warp is done with it last (a count in shared memory)
//      credits it; the copy warp alone where the causal mask skips the
//      fold.
// Step 0's current block is the rank's own k and v, read straight from
// the inputs (the JAX kernel first copies them into slot 0), so both
// slots start free: a post-seed credit for each (slot 0's takes the place
// of the JAX kernel's credit after step 0). No warp waits for another's
// work on a step it does not need: a fold does not wait for the forward
// copy, nor the copy for the fold, so a KV block travels the ring at the
// pace of the copies and of each reader's fold of the slot it
// overwrites.
//
// Counting. Every block reads the whole slot, so a slot has arrived only
// when every share of the sending rank's forward copy has landed, and is
// free only when every block of the reading rank is done computing on it
// and forwarding its share. Flags are one per receiving block, ({recv,
// cap}, 2 slots, total): each block on the other side adds one to each
// of them; an arrival wait counts to the sending (left) rank's blocks, a
// credit wait to the reading (right) rank's, and subtracts as much, so
// every flag ends the launch at 0. Slot data is never read through L1:
// the consumers stage it with cp.async.cg and the forward copy with bulk
// (TMA) copies, both L2 only; a slot holds a new block every other step.
//
// Skipping, exact. Under the causal mask, at step s rank me folds the
// block of rank src = me - s (mod n). When src > me every key of it lies
// after every query of me, and the fold is skipped (the block is still
// forwarded and credited); on step 0 (src == me) every key tile wholly
// above the diagonal of a query tile is skipped. The result is the same
// bit for bit: step 0 is the rank's own block, and its first key tile
// holds key 0, which every row may see, so the running max m is finite
// from then on; a wholly masked tile then gives p = exp(-1e30 - m) = 0
// and a correction exp(m - max(m, -1e30)) = exp(0) = 1, so m, l and o
// come out unchanged. Rank me folds me + 1/2 blocks' worth, and the last
// folded step (src == 0) writes the output. With an equal split the last
// rank would set the pace (7.5 folds of 8 at n = 8); the split gives rank
// me blocks in proportion to max(2 me + 1, me + n/2 + 1): its work, but
// no fewer than the light ranks need so that their early folds (which
// the two-slot ring makes the heavier ranks wait for) keep pace.
//
// Tensor cores (bf16, f16). Each consumer warpgroup folds one 64-row
// query tile; the block's two warpgroups take two tiles of one head (an
// item), so they share the 64-key K and V tiles, double-buffered in
// shared memory and filled with cp.async. The Q tile is staged once per
// (item, step); Dh is padded with zeros to DP = 32, 64, 128 or 256 in
// shared memory (exact). S = Q.K^T is wgmma m64n64k16 (both operands from
// shared memory, f32 accumulators in registers); the online softmax runs
// on the accumulator registers; O += P.V is wgmma m64nDPk16 with P from
// registers. P in bf16 alone would miss one output ulp (about 2^-9 of
// each weight), so P is split: p_hi = bf16(p), p_lo = bf16(p - p_hi), two
// products into the same f32 accumulator (residual about 2^-18 p); f16
// likewise in f16 (its p_lo runs into f16's subnormals below p = 2^-3,
// an absolute error of at most 2^-25 per weight, within one f16 ulp of
// the output at the slice's shape: tests/test_torch_attn.py).
// A product of two bf16 (or f16) values is exact in f32, so Q.K^T
// differs from a f32 product only in its order of summation.
//
// float32 stays on the CUDA cores: a 64 x 32 score tile per step of the
// 256 consumer threads, each a 2 x 4 micro-tile of scores and a 2 x Dh/8
// strip of the output, products and sums in f32 (no TF32), key tiles of
// 32 in order with an online softmax inside each step.
//
// Numerics. Padding keys past T score -inf (no weight), masked keys
// -1e30, as in the JAX kernel; the masks are applied only on the tiles
// that hold such keys (the diagonal one, the ragged last one). exp is
// expf on the f32 path and ex2.approx of x log2(e) on the tensor-core
// path (relative error about 2^-22; exact at 0 and -inf), whose threads
// also keep their own share of each row's denominator, summed over the
// row's four threads when the output is written. The online softmax over
// key tiles rounds differently from the JAX kernel's whole-block fold per
// step: the result agrees to tolerance, not bitwise (2e-4 for f32; one
// output ulp for bf16 and f16, since the f32 result is rounded once). No
// atomics enter the arithmetic: two launches on the same inputs give the
// same bits, and so does any split of the grid.
//
// Bound: operations. 4 S^2 H Dh flops non-causal (4 H Dh S(S+1)/2
// causal) for S = n T, over 989 TFLOP/s bf16 or 67 TFLOP/s f32; the split
// P adds half again to P.V. Bytes: q, k, v, out once each, far below
// that; but the ring moves more. Each step every rank forwards its 2T H
// Dh block, and the f32 accumulators of the rank's tiles go through
// device memory between folded steps, T H Dh 4 bytes each way (2T H Dh
// 4 per rank-step): at T = 512, H = 32, Dh = 128 and 64 rank-steps about
// 1.07 GB, at least 0.32 ms at 3.35 TB/s. That traffic is the next limit
// (the causal skip removes the trips of skipped and last steps). The
// accumulators are stored in 16-byte vectors, in the registers' order.
// PERF.md has the kernel's times beside the same sequence at n = 1 (every
// block on one rank, no ring): the ring's share of the time.
#include "ring_common.cuh"

#include <cuda_fp16.h>
#include <math.h>
#include <type_traits>

namespace ompi_attn {

using ompi_ring::Flag;
using ompi_ring::global_ns;
using ompi_ring::kDeadlockNs;

constexpr int kConsumers = 256;                // two warpgroups
constexpr int kThreads = kConsumers + 64;      // a ring and a copy warp
constexpr int kBQ = 64;    // query rows per tile
constexpr int kBKT = 64;   // keys per tensor-core tile
constexpr int kBK = 32;    // keys per f32 tile
constexpr int kMaxDh = 256;
constexpr int kMaxCols = kMaxDh / 8;  // f32: output columns per thread/row
constexpr float kNeg = -1e30f;
constexpr int kHdr = 128;  // shared memory: mbarriers and counts
enum { RECV = 0, CAP = 1 };
// Named barriers: READY + s % 2 (the ring warp to the consumers: step s's
// block has arrived), CONS (the consumers among themselves).
enum { BAR_READY = 1, BAR_CONS = 3 };

struct Shape {
  int n, total, T, H, Dh, causal;
  float scale;
  int fwd_chunk, fwd_bufs;  // the forward copy's staging buffers
};

// ---- types ------------------------------------------------------------------

template <typename T> __device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// Two floats as one 32-bit pair of T (a first, in the low half), and the
// same pair back as the floats it holds.
__device__ __forceinline__ uint32_t pack2(float a, float b, __nv_bfloat16) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack2(float a, float b, __half) {
  __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ float2 unpack2(uint32_t u, __nv_bfloat16) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&u);
  return make_float2(__low2float(h), __high2float(h));
}
__device__ __forceinline__ float2 unpack2(uint32_t u, __half) {
  __half2 h = *reinterpret_cast<__half2*>(&u);
  return make_float2(__low2float(h), __high2float(h));
}

// exp(x) as 2^(x log2 e) on the special-function unit: relative error
// about 2^-22 (ex2.approx; exp(0) = 1 and exp(-inf) = 0 exactly), far
// inside one output ulp of bf16 or f16.
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// The sum over the four threads of a quad (one row of wgmma's layout).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- PTX --------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Named barriers: `count` threads (whole warps) meet at barrier `id`.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void cons_sync() {
  bar_sync(BAR_CONS, kConsumers);
}

// cp.async of 16 bytes, L2 only; src_bytes 0 fills the 16 bytes with 0.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Shared-memory writes of this thread become visible to wgmma (which
// reads shared memory through the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma's shared-memory matrix descriptor, no swizzle: 8 x 16-byte core
// matrices, `lbo` bytes apart along the reduction (K) dimension, `sbo`
// bytes apart along M or N.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// The accumulators are written by the asynchronous product: keep the
// compiler from moving their uses across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// mbarriers and bulk (TMA) copies, for the forward copy.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const unsigned long long t0 = global_ns();
  for (;;) {
    uint32_t ok;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
    if (ok) return;
    if (global_ns() - t0 > kDeadlockNs) __trap();
  }
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Every bulk store but the newest `pending` (1 or 2) has read its shared
// memory.
__device__ __forceinline__ void bulk_wait_read(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.bulk.wait_group.read 2;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}
// Every bulk store has written device memory; order it before the
// generic-proxy stores and atomics that follow.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
// Device memory read next by bulk copies (the async proxy) sees what was
// ordered before this thread's acquire.
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}


// ---- wgmma, one wrapper per product shape and input type -------------------

#define ATTN_WGMMA_SS_N64(TY, CT)                                              \
  __device__ __forceinline__ void wgmma_ss_n64(                                \
      float(&d)[32], uint64_t da, uint64_t db, int scale_d, CT) {              \
    asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                             \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." #TY "." #TY " "            \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "      \
      "%28, %29, %30, %31}, "                                                  \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                          \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
        "+f"(d[30]), "+f"(d[31])                                               \
      : "l"(da), "l"(db), "r"(scale_d));                                       \
  }

#define ATTN_WGMMA_RS_N32(TY, CT)                                              \
  __device__ __forceinline__ void wgmma_rs_n32(                                \
      float(&d)[16], const uint32_t(&a)[4], uint64_t db, CT) {                 \
    asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                             \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." #TY "." #TY " "            \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15}, "                                                                 \
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                            \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
        "+f"(d[15])                                                            \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));          \
  }

#define ATTN_WGMMA_RS_N64(TY, CT)                                              \
  __device__ __forceinline__ void wgmma_rs_n64(                                \
      float(&d)[32], const uint32_t(&a)[4], uint64_t db, CT) {                 \
    asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                             \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." #TY "." #TY " "            \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "      \
      "%28, %29, %30, %31}, "                                                  \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                            \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
        "+f"(d[30]), "+f"(d[31])                                               \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));          \
  }

#define ATTN_WGMMA_RS_N128(TY, CT)                                             \
  __device__ __forceinline__ void wgmma_rs_n128(                               \
      float(&d)[64], const uint32_t(&a)[4], uint64_t db, CT) {                 \
    asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                             \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." #TY "." #TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "      \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "      \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "      \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                    \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                            \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),       \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),       \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),       \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),       \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),       \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),       \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                     \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));          \
  }

#define ATTN_WGMMA_RS_N256(TY, CT)                                             \
  __device__ __forceinline__ void wgmma_rs_n256(                               \
      float(&d)[128], const uint32_t(&a)[4], uint64_t db, CT) {                \
    asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." #TY "." #TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "      \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "      \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "      \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "      \
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "      \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "      \
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "      \
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "     \
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "     \
      "%127}, "                                                                \
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),       \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),       \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),       \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),       \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),       \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),       \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),       \
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),       \
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),       \
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),       \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),       \
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),       \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),       \
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),       \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),                \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),                \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),                \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),                \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),                \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),                \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])                 \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));          \
  }

#define ATTN_WGMMA_ALL(TY, CT)                                                   \
  ATTN_WGMMA_SS_N64(TY, CT)                                                      \
  ATTN_WGMMA_RS_N32(TY, CT)                                                      \
  ATTN_WGMMA_RS_N64(TY, CT)                                                      \
  ATTN_WGMMA_RS_N128(TY, CT)                                                     \
  ATTN_WGMMA_RS_N256(TY, CT)
ATTN_WGMMA_ALL(bf16, __nv_bfloat16)
ATTN_WGMMA_ALL(f16, __half)

// ---- float32: the fold on the CUDA cores ------------------------------------

// Dynamic shared memory of the f32 fold, in floats.
__host__ __device__ constexpr int f32_floats(int dh) {
  return kBQ * (dh + 1) + kBK * (dh + 1) + kBK * dh + kBQ * (kBK + 1);
}

// Consumers: rows [0, rows) of a tile into shared memory with row
// stride ld; source row r at src + r * stride (elements), Dh elements
// each, in 16-byte vectors (Dh % 8 == 0); rows >= valid are 0.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long long stride, int rows,
                                          int valid, int dh) {
  const int vpr = dh / 4;
  for (int idx = threadIdx.x; idx < rows * vpr; idx += kConsumers) {
    const int r = idx / vpr, c = idx % vpr;
    float* d = dst + r * ld + c * 4;
    const float4 u =
        r < valid
            ? __ldcg(reinterpret_cast<const float4*>(src + r * stride) + c)
            : make_float4(0.f, 0.f, 0.f, 0.f);
    d[0] = u.x;
    d[1] = u.y;
    d[2] = u.z;
    d[3] = u.w;
  }
}

// Fold the current KV block (rank src's, K rows at kcur and V rows at
// vcur, (T, H, Dh)) into item (h, q0) of rank me. On the diagonal step
// the key tiles past the tile's last row are skipped.
__device__ void fold_f32(const Shape& sh, int me, int src, int step,
                         bool last, int h, int q0, const float* q,
                         const float* kcur, const float* vcur, float* out,
                         float* acc_o, float* acc_ml, float* smem) {
  const int dh = sh.Dh, t = sh.T;
  float* sQ = smem;                       // kBQ x (dh + 1)
  float* sK = sQ + kBQ * (dh + 1);        // kBK x (dh + 1)
  float* sV = sK + kBK * (dh + 1);        // kBK x dh
  float* sP = sV + kBK * dh;              // kBQ x (kBK + 1)
  const int rg = threadIdx.x >> 3;        // rows rg, rg + 32
  const int kg = threadIdx.x & 7;         // keys kg + 8j, columns kg + 8j
  const int ncols = dh / 8;
  const long long row_stride = (long long)sh.H * dh;
  const int qvalid = min(kBQ, t - q0);
  const int kend = sh.causal && src == me ? q0 + qvalid : t;

  cons_sync();  // the previous item is done with the tiles
  load_tile(sQ, dh + 1, q + ((long long)me * t + q0) * row_stride + h * dh,
            row_stride, kBQ, qvalid, dh);

  float m[2], l[2], o[2][kMaxCols];
  const long long ml_m = ((long long)(me * 2 + 0) * sh.H + h) * t + q0;
  const long long ml_l = ((long long)(me * 2 + 1) * sh.H + h) * t + q0;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int r = rg + 32 * a;
    const bool live = step > 0 && r < qvalid;
    m[a] = live ? __ldcg(acc_ml + ml_m + r) : kNeg;
    l[a] = live ? __ldcg(acc_ml + ml_l + r) : 0.0f;
    const float* orow =
        acc_o + (((long long)me * sh.H + h) * t + q0 + r) * dh;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j)
      if (j < ncols) o[a][j] = live ? __ldcg(orow + kg + 8 * j) : 0.0f;
  }

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    const int kvalid = min(kBK, t - k0);
    cons_sync();  // the previous tile's products are done
    load_tile(sK, dh + 1, kcur + (long long)k0 * row_stride + h * dh,
              row_stride, kBK, kvalid, dh);
    load_tile(sV, dh, vcur + (long long)k0 * row_stride + h * dh,
              row_stride, kBK, kvalid, dh);
    cons_sync();

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const float* qa = sQ + rg * (dh + 1);
    const float* qb = sQ + (rg + 32) * (dh + 1);
    const float* kb = sK + kg * (dh + 1);
    for (int d = 0; d < dh; ++d) {
      const float a0 = qa[d], a1 = qb[d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = kb[8 * j * (dh + 1) + d];
        s[0][j] += a0 * b;
        s[1][j] += a1 * b;
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int qpos = me * t + q0 + rg + 32 * a;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kg + 8 * j;
        float sc = s[a][j] * sh.scale;
        if (sh.causal && !(qpos >= src * t + k0 + key)) sc = kNeg;
        if (key >= kvalid) sc = -INFINITY;  // padding: no weight
        s[a][j] = sc;
        tmax = fmaxf(tmax, sc);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[a], tmax);
      const float corr = expf(m[a] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[a][j] - m_new);
        sP[(rg + 32 * a) * (kBK + 1) + kg + 8 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[a] = l[a] * corr + psum;
      m[a] = m_new;
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j)
        if (j < ncols) o[a][j] *= corr;
    }
    cons_sync();
    const float* pa = sP + rg * (kBK + 1);
    const float* pb = sP + (rg + 32) * (kBK + 1);
    for (int key = 0; key < kBK; ++key) {
      const float p0 = pa[key], p1 = pb[key];
      const float* vrow = sV + key * dh + kg;
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) {
        if (j < ncols) {
          const float vv = vrow[8 * j];
          o[0][j] += p0 * vv;
          o[1][j] += p1 * vv;
        }
      }
    }
  }

  // Keep the accumulators for the next step, or write the output.
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int r = rg + 32 * a;
    if (r >= qvalid) continue;
    if (last) {
      const float den = fmaxf(l[a], 1e-30f);
      float* orow = out + ((long long)me * t + q0 + r) * row_stride + h * dh;
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j)
        if (j < ncols) orow[kg + 8 * j] = o[a][j] / den;
    } else {
      float* orow = acc_o + (((long long)me * sh.H + h) * t + q0 + r) * dh;
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j)
        if (j < ncols) __stcg(orow + kg + 8 * j, o[a][j]);
      if (kg == 0) {
        __stcg(acc_ml + ml_m + r, m[a]);
        __stcg(acc_ml + ml_l + r, l[a]);
      }
    }
  }
}

// ---- bf16, f16: the fold on the tensor cores --------------------------------

// Bytes of one 64-row tile of DP columns of a 2-byte type.
template <int DP>
__host__ __device__ constexpr int tile_bytes() {
  return kBQ * DP * 2;
}

// Byte offset of element (r, c) in a tile of 8 x 16-byte core matrices,
// CG of them to a row of cores: core (r/8, c/8) at ((r/8) CG + c/8) 128
// bytes, its row r%8 at 16 (r%8). The K-major operands (Q and K, the
// reduction over c) step 128 bytes along K and 128 CG bytes along M/N;
// V (rows r = keys are the reduction) the other way round.
__device__ __forceinline__ uint32_t core_off(int r, int c, int cg) {
  return (uint32_t)((((r >> 3) * cg + (c >> 3)) << 7) + ((r & 7) << 4) +
                    ((c & 7) << 1));
}
template <int DP>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return make_desc(addr, 128, DP / 8 * 128);
}
template <int DP>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return make_desc(addr, DP / 8 * 128, 128);
}

// `threads` threads from `tid`: rows [0, rows) x columns [0, DP) of a
// tile into shared memory at dst, source row r at src + r * stride
// elements; rows >= valid and columns >= dh are 0. One 16-byte cp.async
// per (row, 8 columns), the row within a core matrix fastest.
template <typename T, int DP>
__device__ __forceinline__ void stage_tile(uint32_t dst, const T* src,
                                           long long stride, int rows,
                                           int valid, int dh, int tid,
                                           int threads) {
  constexpr int CG = DP / 8;
  for (int i = tid; i < rows * CG; i += threads) {
    const int rest = i >> 3, cg = rest % CG;
    const int r = (rest / CG) * 8 + (i & 7), c = cg * 8;
    const bool ok = r < valid && c < dh;
    cp_async16(dst + core_off(r, c, CG), ok ? src + r * stride + c : src,
               ok ? 16 : 0);
  }
}

// O (64 x DP) += P (64 x 16, registers) . V (16 x DP, shared memory).
template <int DP, typename T>
__device__ __forceinline__ void pv_product(float (&o)[DP / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t dv) {
  if constexpr (DP == 32) wgmma_rs_n32(o, a, dv, T());
  if constexpr (DP == 64) wgmma_rs_n64(o, a, dv, T());
  if constexpr (DP == 128) wgmma_rs_n128(o, a, dv, T());
  if constexpr (DP == 256) wgmma_rs_n256(o, a, dv, T());
}

// Fold the current KV block (rank src's) into every item of this block
// (items g, g + G, ...: item i is query tiles 2 (i % npairs) and
// 2 (i % npairs) + 1 of head i / npairs, one per warpgroup).
//
// Registers, per warpgroup (wgmma's accumulator layout): warp w holds
// rows 16 w + lane/4 (a = 0) and + 8 (a = 1); of each 8 columns j, the
// thread holds columns 8 j + 2 (lane % 4) and + 1, at d[4 j + 2 a] and
// d[4 j + 2 a + 1]. Read as P, the scores of keys 16 kk .. 16 kk + 15
// are the A operand of one m64nDPk16 product, its register r the pair
// d[8 kk + 2 r], d[8 kk + 2 r + 1].
template <typename T, int DP>
__device__ void fold_tc(const Shape& sh, int me, int src, int step,
                        bool last, int g, int G, const T* q, const T* kcur,
                        const T* vcur, T* out, float* acc_o, float* acc_ml,
                        char* cons) {
  constexpr int CG = DP / 8, TB = tile_bytes<DP>();
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, gq = (tid & 31) >> 2, tq = tid & 3;
  const int t = sh.T, dh = sh.Dh;
  const long long stride = (long long)sh.H * dh;
  const int ntiles = (t + kBQ - 1) / kBQ, npairs = (ntiles + 1) / 2;
  const bool diag = sh.causal && src == me;
  const uint32_t base = smem_u32(cons);
  const uint32_t sQ = base + wg * TB;  // then K, V of stage 0, of stage 1
  auto sK = [&](int st) { return base + (2 + 2 * st) * TB; };
  auto sV = [&](int st) { return base + (3 + 2 * st) * TB; };

  for (int item = g; item < sh.H * npairs; item += G) {
    const int h = item / npairs, pair = item % npairs;
    const int qt = 2 * pair + wg, q0 = qt * kBQ;
    const int qvalid = max(0, min(kBQ, t - q0));
    // key tiles of the item (both warpgroups') and of this warpgroup:
    // on the diagonal step, none past the query tile's own
    const int nk_item = diag ? min(ntiles, 2 * pair + 2) : ntiles;
    const int nk_mine = qvalid == 0 ? 0 : diag ? qt + 1 : ntiles;
    auto stage_kv = [&](int kt, int st) {
      const long long off = (long long)kt * kBKT * stride + h * dh;
      const int kvalid = min(kBKT, t - kt * kBKT);
      stage_tile<T, DP>(sK(st), kcur + off, stride, kBKT, kvalid, dh, tid,
                        kConsumers);
      stage_tile<T, DP>(sV(st), vcur + off, stride, kBKT, kvalid, dh, tid,
                        kConsumers);
    };
    stage_tile<T, DP>(sQ, q + ((long long)me * t + q0) * stride + h * dh,
                      stride, kBQ, qvalid, dh, wt, 128);
    stage_kv(0, 0);
    cp_async_commit();

    float o[DP / 2], m[2], l[2];
    const long long tile = ((long long)me * sh.H + h) * ntiles + qt;
    const float4* o4 = reinterpret_cast<const float4*>(acc_o) + tile * CG * 128;
    if (step > 0 && qvalid > 0) {
      const float4 ml =
          __ldcg(reinterpret_cast<const float4*>(acc_ml) + tile * 128 + wt);
      m[0] = ml.x;
      m[1] = ml.y;
      l[0] = ml.z;
      l[1] = ml.w;
#pragma unroll
      for (int j = 0; j < CG; ++j) {
        const float4 x = __ldcg(o4 + j * 128 + wt);
        o[4 * j] = x.x;
        o[4 * j + 1] = x.y;
        o[4 * j + 2] = x.z;
        o[4 * j + 3] = x.w;
      }
    } else {
      m[0] = m[1] = kNeg;
      l[0] = l[1] = 0.0f;
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
    }

    for (int kt = 0; kt < nk_item; ++kt) {
      const int st = kt & 1;
      cp_async_wait<0>();
      fence_async_smem();
      // Tile kt (and Q) landed, for both warpgroups; both are done with
      // tile kt - 1, so its stage takes tile kt + 1.
      cons_sync();
      if (kt + 1 < nk_item) {
        stage_kv(kt + 1, st ^ 1);
        cp_async_commit();
      }
      if (kt < nk_mine) {
        // S = Q . K^T
        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.0f;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss_n64(s, kmajor_desc<DP>(sQ + kk * 256),
                       kmajor_desc<DP>(sK(st) + kk * 256), kk > 0 ? 1 : 0,
                       T());
        wg_commit();
        wg_wait0();
        fence_regs(s);

        // scale, mask (only the diagonal tile and the ragged last one
        // have masked or padding keys); the online softmax over this
        // tile's 64 keys
        const int k0 = kt * kBKT;
        const bool edge = (diag && kt == qt) || k0 + kBKT > t;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int qpos = me * t + q0 + warp * 16 + gq + 8 * a;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = 8 * j + 2 * tq + e;
              float sc = s[4 * j + 2 * a + e] * sh.scale;
              if (edge) {
                if (sh.causal && !(qpos >= src * t + k0 + key)) sc = kNeg;
                if (k0 + key >= t) sc = -INFINITY;  // padding: no weight
              }
              s[4 * j + 2 * a + e] = sc;
              mx[a] = fmaxf(mx[a], sc);
            }
          }
        }
        float corr[2];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          mx[a] = fmaxf(mx[a], __shfl_xor_sync(0xffffffffu, mx[a], 1));
          mx[a] = fmaxf(mx[a], __shfl_xor_sync(0xffffffffu, mx[a], 2));
          const float m_new = fmaxf(m[a], mx[a]);
          corr[a] = exp_approx(m[a] - m_new);
          m[a] = m_new;
          l[a] *= corr[a];
        }
        // l: this thread's share of the row sum (the quad's four are
        // added when the output is written)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int a = i >> 1;
            const float p = exp_approx(s[4 * j + i] - m[a]);
            s[4 * j + i] = p;
            l[a] += p;
          }
        }
#pragma unroll
        for (int j = 0; j < CG; ++j) {
          o[4 * j] *= corr[0];
          o[4 * j + 1] *= corr[0];
          o[4 * j + 2] *= corr[1];
          o[4 * j + 3] *= corr[1];
        }

        // P = p_hi + p_lo in T; O += P_hi . V + P_lo . V
        uint32_t hi[4][4], lo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float x0 = s[8 * kk + 2 * r], x1 = s[8 * kk + 2 * r + 1];
            hi[kk][r] = pack2(x0, x1, T());
            const float2 h2 = unpack2(hi[kk][r], T());
            lo[kk][r] = pack2(x0 - h2.x, x1 - h2.y, T());
          }
        }
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dv = mnmajor_desc<DP>(sV(st) + kk * 2 * CG * 128);
          pv_product<DP, T>(o, hi[kk], dv);
          pv_product<DP, T>(o, lo[kk], dv);
        }
        wg_commit();
        wg_wait0();
        fence_regs(o);
      }
    }
    cons_sync();  // both warpgroups are done with the item's tiles and Q

    // Keep the accumulators for the next step, or write the output.
    if (qvalid == 0) continue;
    if (last) {
      // every lane of the warp takes part in the quads' sums
      const float den[2] = {fmaxf(quad_sum(l[0]), 1e-30f),
                            fmaxf(quad_sum(l[1]), 1e-30f)};
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int r = warp * 16 + gq + 8 * a;
        if (r >= qvalid) continue;
        T* orow = out + ((long long)me * t + q0 + r) * stride + h * dh;
#pragma unroll
        for (int j = 0; j < CG; ++j) {
          const int c = 8 * j + 2 * tq;
          if (c < dh) {
            orow[c] = from_f<T>(o[4 * j + 2 * a] / den[a]);
            orow[c + 1] = from_f<T>(o[4 * j + 2 * a + 1] / den[a]);
          }
        }
      }
    } else {
      __stcg(reinterpret_cast<float4*>(acc_ml) + tile * 128 + wt,
             make_float4(m[0], m[1], l[0], l[1]));
      float4* w4 = reinterpret_cast<float4*>(acc_o) + tile * CG * 128;
#pragma unroll
      for (int j = 0; j < CG; ++j)
        __stcg(w4 + j * 128 + wt, make_float4(o[4 * j], o[4 * j + 1],
                                              o[4 * j + 2], o[4 * j + 3]));
    }
  }
}

// ---- the ring ---------------------------------------------------------------

// Whether rank me folds step s: not under the causal mask when the block
// comes from a later rank. Rank me folds steps 0 .. me, or all n.
__device__ __forceinline__ bool folds(const Shape& sh, int me, int step) {
  return !(sh.causal && (me - step + sh.n) % sh.n > me);
}

// This block's place in the ring: its rank, its neighbours, the first
// block and the block count of each, and its own index g in its rank.
struct Ring {
  int* sems;
  int total, me, left, right, g;
  int off_me, off_left, off_right, G_me, G_left, G_right;
  // Flag (kind, slot) of block b of the rank whose first block is off.
  __device__ int* flag(int kind, int slot, int off, int b) const {
    return sems + (kind * 2 + slot) * total + off + b;
  }
};

// Shared memory's header: the forward copy's staging mbarriers, then one
// mbarrier per slot (the ring warp to the copy warp: the slot's block has
// arrived) and one count per slot of the parties done with it.
constexpr int kArrivedBar = 64, kDoneCount = 80;

// A warp: lane 0 waits until the flag reaches v and consumes v.
__device__ __forceinline__ void wait_flag(int* f, int v) {
  if ((threadIdx.x & 31) == 0) {
    Flag fl(*f);
    const unsigned long long t0 = global_ns();
    while (fl.load(cuda::memory_order_acquire) < v) {
      __nanosleep(64);
      if (global_ns() - t0 > kDeadlockNs) __trap();
    }
    fl.fetch_sub(v, cuda::memory_order_relaxed);
    __threadfence();
  }
  __syncwarp();
}

// A warp, after lane 0's stores: one to each of `count` flags from f,
// with release.
__device__ __forceinline__ void signal_flags(int* f, int count) {
  __syncwarp();
  for (int b = threadIdx.x & 31; b < count; b += 32)
    Flag(f[b]).fetch_add(1, cuda::memory_order_release);
}

// A warp: one of the `parties` (the fold and the forward copy, or the
// copy alone where the fold is skipped) is done with the slot of this
// step; the last one credits it to the left neighbour.
__device__ __forceinline__ void slot_done(const Ring& rg, char* smem,
                                          int slot, int parties) {
  int last = parties == 1;
  if (!last && (threadIdx.x & 31) == 0) {
    cuda::atomic_ref<int, cuda::thread_scope_block> done(
        *reinterpret_cast<int*>(smem + kDoneCount + 4 * slot));
    last = done.fetch_add(1, cuda::memory_order_acq_rel) == parties - 1;
    if (last) done.store(0, cuda::memory_order_relaxed);
  }
  if (__shfl_sync(0xffffffffu, last, 0))
    signal_flags(rg.flag(CAP, slot, rg.off_left, 0), rg.G_left);
}

// The ring warp: every step's arrival from the left, handed to the copy
// warp (mbarrier) and, where this rank folds the step, to the consumers
// (named barrier READY), so that neither waits for the other.
__device__ void ring_warp(const Shape& sh, const Ring& rg, char* smem) {
  for (int step = 1; step < sh.n; ++step) {
    const int slot = step & 1;
    wait_flag(rg.flag(RECV, slot, rg.off_me, rg.g), rg.G_left);
    if ((threadIdx.x & 31) == 0 && step < sh.n - 1)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                       smem_u32(smem + kArrivedBar + 8 * slot))
                   : "memory");
    __syncwarp();
    if (folds(sh, rg.me, step)) bar_arrive(BAR_READY + slot, kConsumers + 32);
  }
}

// The copy warp: the post-seed credits, then every step's forward copy of
// this block's share of the current block into the right neighbour's
// other slot, staged through fwd_bufs shared buffers of fwd_chunk bytes
// by bulk copies (lane 0 issues them: half the buffers loading, half
// being stored), and the credits where it is done with a slot last.
template <typename T>
__device__ void copy_warp(const Shape& sh, const Ring& rg, const T* k,
                          const T* v, T* slots, char* smem) {
  const int lane = threadIdx.x & 31, n = sh.n;
  const long long thd = (long long)sh.T * sh.H * sh.Dh;  // one of K or V
  const long long kvec = thd * (long long)sizeof(T) / 16;  // 16-byte units
  const long long per = (2 * kvec + rg.G_me - 1) / rg.G_me;
  const long long v0 = min(2 * kvec, rg.g * per), v1 = min(2 * kvec, v0 + per);
  const int nb = sh.fwd_bufs, ahead = nb / 2;  // loads in flight
  const long long cv = sh.fwd_chunk / 16;
  const uint32_t bars = smem_u32(smem), bufs = bars + kHdr;
  // The share's chunks, none across the K | V boundary.
  const long long a0 = v0, a1 = min(v1, kvec), b0 = max(v0, kvec), b1 = v1;
  const long long nka = a1 > a0 ? (a1 - a0 + cv - 1) / cv : 0;
  const long long nch = nka + (b1 > b0 ? (b1 - b0 + cv - 1) / cv : 0);
  auto slot_ptr = [&](int rank, int slot) {
    return reinterpret_cast<char*>(slots +
                                   ((long long)rank * 2 + slot) * 2 * thd);
  };
  long long used = 0;  // chunks staged before this step (buffer order)

  // Post-seed: both slots are free (step 0 reads the inputs; slot 1 is
  // first written at the left's step 0, slot 0 at its step 1).
  if (n > 1) signal_flags(rg.flag(CAP, 1, rg.off_left, 0), rg.G_left);
  if (n > 2) signal_flags(rg.flag(CAP, 0, rg.off_left, 0), rg.G_left);
  for (int step = 0; step < n - 1; ++step) {
    const int slot = step & 1, nslot = slot ^ 1;
    if (step > 0 && lane == 0)  // the ring warp saw it arrive
      mbar_wait(smem_u32(smem + kArrivedBar + 8 * slot),
                (uint32_t)(((step - 1) >> 1) & 1));
    wait_flag(rg.flag(CAP, nslot, rg.off_me, rg.g), rg.G_right);
    if (lane == 0) {
      fence_async_global();
      const char* kcur =
          step == 0 ? reinterpret_cast<const char*>(k + rg.me * thd)
                    : slot_ptr(rg.me, slot);
      const char* vcur =
          step == 0 ? reinterpret_cast<const char*>(v + rg.me * thd)
                    : kcur + kvec * 16;
      char* dst = slot_ptr(rg.right, nslot);
      auto load = [&](long long c) {
        const long long lo = c < nka ? a0 + c * cv : b0 + (c - nka) * cv;
        const long long hi = min(c < nka ? a1 : b1, lo + cv);
        const char* from = c < nka ? kcur + lo * 16 : vcur + (lo - kvec) * 16;
        const int b = (int)((used + c) % nb);
        bulk_load(bufs + b * sh.fwd_chunk, from, (int)((hi - lo) * 16),
                  bars + 8 * b);
      };
      for (long long c = 0; c < min((long long)ahead, nch); ++c) load(c);
      for (long long c = 0; c < nch; ++c) {
        const long long u = used + c;
        const int b = (int)(u % nb);
        mbar_wait(bars + 8 * b, (uint32_t)((u / nb) & 1));
        const long long lo = c < nka ? a0 + c * cv : b0 + (c - nka) * cv;
        const long long hi = min(c < nka ? a1 : b1, lo + cv);
        bulk_store(dst + lo * 16, bufs + b * sh.fwd_chunk,
                   (int)((hi - lo) * 16));
        if (c + ahead < nch) {
          // chunk c + ahead's buffer held chunk c + ahead - nb
          bulk_wait_read(nb - ahead);
          load(c + ahead);
        }
      }
      used += nch;
      bulk_wait_all();
      __threadfence();
    }
    signal_flags(rg.flag(RECV, nslot, rg.off_right, 0), rg.G_right);
    if (step >= 1 && step < n - 2)
      slot_done(rg, smem, slot, folds(sh, rg.me, step) ? 2 : 1);
  }
}

// The consumer warpgroups: the fold of every step up to the last one the
// causal mask leaves (steps 0 .. me, or all n), which writes the output.
template <typename T, int DP>
__device__ void consumers(const Shape& sh, const Ring& rg, const T* q,
                          const T* k, const T* v, T* out, T* slots,
                          float* acc_o, float* acc_ml, char* smem) {
  const int n = sh.n, me = rg.me;
  const long long thd = (long long)sh.T * sh.H * sh.Dh;
  char* cons = smem + kHdr + sh.fwd_bufs * sh.fwd_chunk;
  for (int step = 0; step < n && folds(sh, me, step); ++step) {
    const int src = (me - step + n) % n, slot = step & 1;
    const bool last = step == n - 1 || !folds(sh, me, step + 1);
    const T* kcur = slots + ((long long)me * 2 + slot) * 2 * thd;
    const T* vcur = kcur + thd;
    if (step == 0) {  // the rank's own block, from the inputs
      kcur = k + me * thd;
      vcur = v + me * thd;
    } else {
      bar_sync(BAR_READY + slot, kConsumers + 32);
    }
    if constexpr (std::is_same<T, float>::value) {
      const int ntiles = (sh.T + kBQ - 1) / kBQ;
      for (int item = rg.g; item < sh.H * ntiles; item += rg.G_me)
        fold_f32(sh, me, src, step, last, item / ntiles,
                 (item % ntiles) * kBQ, q, kcur, vcur, out, acc_o, acc_ml,
                 reinterpret_cast<float*>(cons));
    } else {
      fold_tc<T, DP>(sh, me, src, step, last, rg.g, rg.G_me, q, kcur, vcur,
                     out, acc_o, acc_ml, cons);
    }
    if (step >= 1 && step < n - 2) {
      cons_sync();  // every consumer is done reading the slot
      if (threadIdx.x < 32) slot_done(rg, smem, slot, 2);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
    ring_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ out,
                          T* slots, float* acc_o, float* acc_ml, int* sems,
                          const int* __restrict__ offs, Shape sh) {
  extern __shared__ __align__(128) char smem[];
  Ring rg;
  rg.sems = sems;
  rg.total = sh.total;
  int me = 0;  // this block's rank: offs[me] <= blockIdx.x < offs[me + 1]
  while (offs[me + 1] <= (int)blockIdx.x) ++me;
  rg.me = me;
  rg.left = (me + sh.n - 1) % sh.n;
  rg.right = (me + 1) % sh.n;
  rg.off_me = offs[me];
  rg.off_left = offs[rg.left];
  rg.off_right = offs[rg.right];
  rg.G_me = offs[me + 1] - rg.off_me;
  rg.G_left = offs[rg.left + 1] - rg.off_left;
  rg.G_right = offs[rg.right + 1] - rg.off_right;
  rg.g = (int)blockIdx.x - rg.off_me;
  if (threadIdx.x == 0) {
    for (int b = 0; b < sh.fwd_bufs; ++b) mbar_init(smem_u32(smem) + 8 * b);
    mbar_init(smem_u32(smem + kArrivedBar));
    mbar_init(smem_u32(smem + kArrivedBar + 8));
    reinterpret_cast<int*>(smem + kDoneCount)[0] = 0;
    reinterpret_cast<int*>(smem + kDoneCount)[1] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;
  if (warp < kConsumers / 32)
    consumers<T, DP>(sh, rg, q, k, v, out, slots, acc_o, acc_ml, smem);
  else if (warp == kConsumers / 32)
    ring_warp(sh, rg, smem);
  else
    copy_warp<T>(sh, rg, k, v, slots, smem);
}

// The head dim of the half-precision tiles: Dh padded to 32, 64, 128 or
// 256 (pallas_attn.padded_head_dim).
int padded_dh(int dh) {
  return dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 128 ? 128 : 256;
}

// The kernel of this dtype at this head dim, or nullptr.
const void* pick(int dtype, int dh) {
  if (dtype == 0) return (const void*)ring_attention_kernel<float, 0>;
  const int dp = padded_dh(dh);
#define ATTN_PICK(DP)                                                   \
  if (dp == DP)                                                         \
    return dtype == 1                                                   \
               ? (const void*)ring_attention_kernel<__nv_bfloat16, DP>  \
               : (const void*)ring_attention_kernel<__half, DP>;
  ATTN_PICK(32)
  ATTN_PICK(64)
  ATTN_PICK(128)
  ATTN_PICK(256)
#undef ATTN_PICK
  return nullptr;
}

// Shared memory of the consumers at this head dim, in bytes.
int cons_bytes(int dtype, int dh) {
  if (dtype == 0) return f32_floats(dh) * (int)sizeof(float);
  // Q of two warpgroups, K and V of two stages
  return 6 * kBQ * padded_dh(dh) * 2;
}

// The forward copy's staging, the most bytes that fit: 4 or 2 buffers of
// 32, 16 or 8 KiB; and the block's whole dynamic shared memory.
int plan_smem(int dtype, int dh, int* chunk, int* bufs) {
  constexpr int kMaxSmem = 232448;  // 227 KB a block may use on sm_90
  const int cons = cons_bytes(dtype, dh);
  for (int bytes = 131072; bytes >= 16384; bytes /= 2) {
    for (*bufs = 4; *bufs >= 2; *bufs -= 2) {
      *chunk = bytes / *bufs;
      if (*chunk <= 32768 && kHdr + bytes + cons <= kMaxSmem)
        return kHdr + bytes + cons;
    }
  }
  return -1;
}

// The kernel of this dtype and head dim and its dynamic shared memory,
// on the given device, or an error.
cudaError_t pick_on(int dtype, int dh, int device, const void** fn,
                    int* smem, int* chunk, int* bufs) {
  *fn = dtype >= 0 && dtype <= 2 ? pick(dtype, dh) : nullptr;
  if (*fn == nullptr || dh % 8 != 0 || dh <= 0 || dh > kMaxDh)
    return cudaErrorInvalidValue;
  *smem = plan_smem(dtype, dh, chunk, bufs);
  if (*smem < 0) return cudaErrorInvalidValue;
  return cudaSetDevice(device);
}

}  // namespace ompi_attn

// Thread blocks of a resident grid at this shape: the SM count times the
// blocks per SM at this kernel's real shared memory and registers. It
// also allows the kernel of this dtype the dynamic shared memory of the
// largest head dim it takes on this device, which ompi_ring_attention
// relies on: the caller asks once per shape and device, before the first
// launch. Returns -(CUDA error) on failure.
extern "C" int ompi_ring_attention_blocks(int T, int H, int Dh, int dtype,
                                          int device) {
  const void* fn;
  int smem, chunk, bufs;
  cudaError_t err =
      ompi_attn::pick_on(dtype, Dh, device, &fn, &smem, &chunk, &bufs);
  if (err != cudaSuccess || T < 1 || H < 1)
    return -(int)(err != cudaSuccess ? err : cudaErrorInvalidValue);
  // the f32 kernel serves every head dim; each half-precision one a range
  const int most = ompi_attn::plan_smem(
      dtype, dtype == 0 ? ompi_attn::kMaxDh : Dh, &chunk, &bufs);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most);
  if (err != cudaSuccess) return -(int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fn, ompi_attn::kThreads, smem);
  if (err != cudaSuccess) return -(int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int)err;
  return per_sm * sms;
}

// q, k, v, out: (n, T, H, Dh) rank-major; slots: (n, 2, 2T, H, Dh) of the
// same dtype; acc_o: n * H * ceil(T/64) * 64 * DP f32 and acc_ml: n * H
// * ceil(T/64) * 512 f32 (DP: Dh padded as the kernel does; both unused
// at n == 1); sems: 4 * blocks int32, zeroed by the caller; offs: n + 1
// int32 on the card, rank r's blocks [offs[r], offs[r+1]), offs[n] =
// blocks, no more than ompi_ring_attention_blocks allows. Returns the
// CUDA error of the launch (0 on success).
extern "C" int ompi_ring_attention(const void* q, const void* k,
                                   const void* v, void* out, void* slots,
                                   void* acc_o, void* acc_ml, void* sems,
                                   const void* offs, int n, int blocks, int T,
                                   int H, int Dh, int causal, float scale,
                                   int dtype, int device, void* stream) {
  const void* fn;
  int smem, chunk, bufs;
  cudaError_t err =
      ompi_attn::pick_on(dtype, Dh, device, &fn, &smem, &chunk, &bufs);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || blocks < n) return (int)cudaErrorInvalidValue;
  ompi_attn::Shape sh{n, blocks, T, H, Dh, causal, scale, chunk, bufs};
  void* args[] = {(void*)&q, (void*)&k,  (void*)&v,    &out, &slots,
                  &acc_o,    &acc_ml,    &sems,        (void*)&offs, &sh};
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks),
                                    dim3(ompi_attn::kThreads), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
