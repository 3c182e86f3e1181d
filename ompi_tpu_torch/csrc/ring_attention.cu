// ring_attention: exact attention over the ring on Hopper, the KV blocks
// circulating on a two-slot credit ring.
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
// stacked over V. Each rank is played by G thread blocks of a persistent
// cooperative grid of n x G blocks (every block resident; G comes from
// the occupancy of this kernel at its real shared memory and registers,
// ompi_ring_attention_blocks). Block g of a rank owns the work items
// (head, 64-row query tile) g, g+G, ... and keeps their f32 accumulators
// in device-memory scratch between steps (acc_o (n, H, T, Dh), acc_ml
// (n, 2, H, T)).
//
// Protocol, the JAX kernel's, at every step s (slot = s % 2):
//   1. s < n-1: wait for the right neighbour's credit on slot^1; store
//      this block's share of the current block into the right
//      neighbour's slot^1; publish; signal the right neighbour's
//      arrival flags.
//   2. fold the current block into the accumulators of every owned item.
//   3. s < n-2: credit the slot to the left neighbour (it has been both
//      computed on and forwarded).
//   4. s < n-1: wait until slot^1 has arrived from the left.
// Step 0's current block is the rank's own k and v, read straight from
// the inputs (the JAX kernel first copies them into slot 0); slot 0 is
// first written by the left neighbour's step 1. A post-seed credit for
// slot 1 opens the ring.
//
// Counting to G. Every block reads the whole slot, so a slot has arrived
// only when all G shares of the forward copy have landed, and is free
// only when all G blocks of its rank are done computing on it and
// forwarding their share. Flags are one per receiving block, (n,
// {recv, cap}, 2 slots, G): each of the G blocks on the other side adds
// one to each of them, and each wait counts to G and subtracts G, so
// every flag ends the launch at 0. Slot data is read and forwarded with
// L1-bypassing loads (ld.global.cg) and stored with st.global.cg: a slot
// holds a new block every other step, and a plain load could be served
// from an L1 line of the old one.
//
// Numerics. Products and sums in f32 on the CUDA cores, for every input
// dtype (inputs converted to f32 through the intrinsics), so f32 inputs
// see no TF32 rounding. Key tiles of 32 are folded in increasing order
// with an online softmax inside each step, so the result rounds
// differently from the JAX kernel's whole-block fold per step: it agrees
// to tolerance, not bitwise (2e-4 for f32; one output ulp for bf16 and
// f16, since both round one f32 result once). exp is expf (full
// precision, no fast-math). Padding keys past T are -inf (no weight);
// masked keys are -1e30, as in the JAX kernel.
//
// Bound: operations. 4 S^2 H Dh flops non-causal (4 H Dh S(S+1)/2
// causal) for S = n T, over 67 TFLOP/s f32 or 989 TFLOP/s bf16; the
// bytes (q, k, v, out once each) are far below that. What the design
// does about it: a 64 x 32 score tile per step of 256 threads, each
// thread a 2 x 4 micro-tile of scores and a 2 x Dh/8 strip of the
// output, all operands in shared memory with conflict-free strides, the
// row max and sum by shuffles inside 8-lane groups. It does not use the
// tensor cores (wgmma), TMA, or skip fully masked tiles: later work.
#include "ring_common.cuh"

#include <cuda_fp16.h>
#include <math.h>

namespace ompi_attn {

using ompi_ring::publish;
using ompi_ring::signal;
using ompi_ring::wait;

constexpr int kThreads = 256;
constexpr int kBQ = 64;   // query rows per item
constexpr int kBK = 32;   // keys per tile
constexpr int kMaxDh = 256;
constexpr int kMaxCols = kMaxDh / 8;  // output columns per thread and row
constexpr float kNeg = -1e30f;
enum { RECV = 0, CAP = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// Whole block: rows [0, rows) of a tile into shared memory as f32 with
// row stride ld; source row r at src + r * stride (elements), Dh
// elements each, in 16-byte vectors (Dh % 8 == 0); rows >= valid are 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long stride, int rows,
                                          int valid, int dh) {
  constexpr int kPer = 16 / sizeof(T);
  const int vpr = dh / kPer;
  for (int idx = threadIdx.x; idx < rows * vpr; idx += blockDim.x) {
    const int r = idx / vpr, c = idx % vpr;
    float* d = dst + r * ld + c * kPer;
    if (r < valid) {
      const uint4 u =
          __ldcg(reinterpret_cast<const uint4*>(src + r * stride) + c);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < kPer; ++i) d[i] = to_f(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i) d[i] = 0.0f;
    }
  }
}

// Whole block: copy `count` 16-byte vectors, L2 only at both ends.
__device__ __forceinline__ void copy_cg(uint4* dst, const uint4* src,
                                        long long count) {
  for (long long j = threadIdx.x; j < count; j += blockDim.x)
    __stcg(dst + j, __ldcg(src + j));
}

struct Shape {
  int n, G, T, H, Dh, causal;
  float scale;
};

// Dynamic shared memory of one block, in floats.
__host__ __device__ constexpr int smem_floats(int dh) {
  return kBQ * (dh + 1) + kBK * (dh + 1) + kBK * dh + kBQ * (kBK + 1);
}

// Fold the current KV block (rank src's, K rows at kcur and V rows at
// vcur, (T, H, Dh)) into item (h, q0) of rank me.
template <typename T>
__device__ void fold_item(const Shape& sh, int me, int src, int step,
                          int h, int q0, const T* q, const T* kcur,
                          const T* vcur, T* out, float* acc_o,
                          float* acc_ml, float* smem) {
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
  const bool last = step == sh.n - 1;

  __syncthreads();  // the previous item is done with the tiles
  load_tile(sQ, dh + 1, q + ((long long)me * t + q0) * row_stride + h * dh,
            row_stride, kBQ, qvalid, dh);

  float m[2], l[2], o[2][kMaxCols];
  const long long ml_m = ((long long)(me * 2 + 0) * sh.H + h) * t + q0;
  const long long ml_l = ((long long)(me * 2 + 1) * sh.H + h) * t + q0;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int r = rg + 32 * a;
    const bool live = step > 0 && r < qvalid;
    m[a] = live ? acc_ml[ml_m + r] : kNeg;
    l[a] = live ? acc_ml[ml_l + r] : 0.0f;
    const float* orow =
        acc_o + (((long long)me * sh.H + h) * t + q0 + r) * dh;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j)
      if (j < ncols) o[a][j] = live ? orow[kg + 8 * j] : 0.0f;
  }

  for (int k0 = 0; k0 < t; k0 += kBK) {
    const int kvalid = min(kBK, t - k0);
    __syncthreads();  // the previous tile's products are done
    load_tile(sK, dh + 1, kcur + (long long)k0 * row_stride + h * dh,
              row_stride, kBK, kvalid, dh);
    load_tile(sV, dh, vcur + (long long)k0 * row_stride + h * dh,
              row_stride, kBK, kvalid, dh);
    __syncthreads();

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
    __syncthreads();
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
      T* orow = out + ((long long)me * t + q0 + r) * row_stride + h * dh;
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j)
        if (j < ncols) orow[kg + 8 * j] = from_f<T>(o[a][j] / den);
    } else {
      float* orow = acc_o + (((long long)me * sh.H + h) * t + q0 + r) * dh;
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j)
        if (j < ncols) orow[kg + 8 * j] = o[a][j];
      if (kg == 0) {
        acc_ml[ml_m + r] = m[a];
        acc_ml[ml_l + r] = l[a];
      }
    }
  }
}

// Flag (rank, kind, slot, block) of the (n, 2, 2, G) flags.
__device__ __forceinline__ int* flag(int* sems, int G, int rank, int kind,
                                     int slot, int b) {
  return sems + ((rank * 2 + kind) * 2 + slot) * G + b;
}

// After publish(): one to each of `rank`'s G flags of (kind, slot).
__device__ __forceinline__ void signal_all(int* sems, int G, int rank,
                                           int kind, int slot) {
  for (int b = threadIdx.x; b < G; b += blockDim.x)
    signal(flag(sems, G, rank, kind, slot, b), 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ring_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ out,
                          T* slots, float* acc_o, float* acc_ml, int* sems,
                          Shape sh) {
  extern __shared__ float smem[];
  const int n = sh.n, G = sh.G;
  const int me = blockIdx.x / G, g = blockIdx.x % G;
  const int right = (me + 1) % n, left = (me + n - 1) % n;
  const long long thd = (long long)sh.T * sh.H * sh.Dh;  // one of K or V
  const int ntiles = (sh.T + kBQ - 1) / kBQ;
  const int items = sh.H * ntiles;
  // This block's share of a slot's 2 * thd elements, in whole 16-byte
  // vectors (thd is a multiple of 8 elements, 16 bytes for 2-byte types).
  constexpr int kPer = 16 / sizeof(T);
  const long long nvec = 2 * thd / kPer;
  const long long per = (nvec + G - 1) / G;
  const long long v0 = min(nvec, (long long)g * per);
  const long long v1 = min(nvec, v0 + per);
  const long long kvec = thd / kPer;  // vectors of the K half
  auto slot_ptr = [&](int rank, int slot) {
    return slots + ((long long)rank * 2 + slot) * 2 * thd;
  };

  if (n > 1) signal_all(sems, G, left, CAP, 1);  // post-seed: slot 1 free
  for (int step = 0; step < n; ++step) {
    const int slot = step & 1, nslot = slot ^ 1;
    const int src = (me - step + n) % n;
    const T* kcur = step == 0 ? k + (long long)me * thd : slot_ptr(me, slot);
    const T* vcur = step == 0 ? v + (long long)me * thd : kcur + thd;
    if (step < n - 1) {
      wait(flag(sems, G, me, CAP, nslot, g), G);
      uint4* dst = reinterpret_cast<uint4*>(slot_ptr(right, nslot));
      // The K half of the share, then the V half.
      if (v0 < kvec)
        copy_cg(dst + v0, reinterpret_cast<const uint4*>(kcur) + v0,
                min(v1, kvec) - v0);
      if (v1 > kvec) {
        const long long a = max(v0, kvec);
        copy_cg(dst + a, reinterpret_cast<const uint4*>(vcur) + (a - kvec),
                v1 - a);
      }
      publish();
      signal_all(sems, G, right, RECV, nslot);
    }
    for (int item = g; item < items; item += G)
      fold_item<T>(sh, me, src, step, item / ntiles, (item % ntiles) * kBQ,
                   q, kcur, vcur, out, acc_o, acc_ml, smem);
    if (step < n - 2) {
      __syncthreads();  // every thread is done reading the slot
      signal_all(sems, G, left, CAP, slot);
    }
    if (step < n - 1) wait(flag(sems, G, me, RECV, nslot, g), G);
  }
}

const void* pick(int dtype) {
  switch (dtype) {
    case 0: return (const void*)ring_attention_kernel<float>;
    case 1: return (const void*)ring_attention_kernel<__nv_bfloat16>;
    case 2: return (const void*)ring_attention_kernel<__half>;
    default: return nullptr;
  }
}

// The kernel of this dtype and its dynamic shared memory at this head
// dim, on the given device, or an error.
cudaError_t pick_on(int dtype, int dh, int device, const void** fn,
                    int* smem) {
  *fn = pick(dtype);
  if (*fn == nullptr || dh % 8 != 0 || dh <= 0 || dh > kMaxDh)
    return cudaErrorInvalidValue;
  *smem = smem_floats(dh) * (int)sizeof(float);
  return cudaSetDevice(device);
}

}  // namespace ompi_attn

// Thread blocks per rank for a resident grid of n x G blocks: the SM
// count times the blocks per SM at this kernel's real shared memory and
// registers, over n, at most the number of work items. It also allows
// the kernel of this dtype the dynamic shared memory of the largest head
// dim on this device, which ompi_ring_attention relies on: the caller
// asks once per shape and device, before the first launch. Returns
// -(CUDA error), or -(cudaErrorCooperativeLaunchTooLarge) when not even
// one block per rank fits.
extern "C" int ompi_ring_attention_blocks(int n, int T, int H, int Dh,
                                          int dtype, int device) {
  const void* fn;
  int smem;
  cudaError_t err = ompi_attn::pick_on(dtype, Dh, device, &fn, &smem);
  if (err != cudaSuccess) return -(int)err;
  err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      ompi_attn::smem_floats(ompi_attn::kMaxDh) * (int)sizeof(float));
  if (err != cudaSuccess) return -(int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fn, ompi_attn::kThreads, smem);
  if (err != cudaSuccess) return -(int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int)err;
  const int resident = per_sm * sms;
  if (n < 1 || n > resident) return -(int)cudaErrorCooperativeLaunchTooLarge;
  const int items = H * ((T + ompi_attn::kBQ - 1) / ompi_attn::kBQ);
  const int G = resident / n;
  return G < items ? G : (items > 0 ? items : 1);
}

// q, k, v, out: (n, T, H, Dh) rank-major; slots: (n, 2, 2T, H, Dh) of
// the same dtype; acc_o: (n, H, T, Dh) f32; acc_ml: (n, 2, H, T) f32
// (both unused at n == 1); sems: (n, 2, 2, G) int32, zeroed by the
// caller; G from ompi_ring_attention_blocks. Returns the CUDA error of
// the launch (0 on success).
extern "C" int ompi_ring_attention(const void* q, const void* k,
                                   const void* v, void* out, void* slots,
                                   void* acc_o, void* acc_ml, void* sems,
                                   int n, int G, int T, int H, int Dh,
                                   int causal, float scale, int dtype,
                                   int device, void* stream) {
  const void* fn;
  int smem;
  cudaError_t err = ompi_attn::pick_on(dtype, Dh, device, &fn, &smem);
  if (err != cudaSuccess) return (int)err;
  ompi_attn::Shape sh{n, G, T, H, Dh, causal, scale};
  void* args[] = {(void*)&q, (void*)&k, (void*)&v, &out, &slots,
                  &acc_o, &acc_ml, &sems, &sh};
  err = cudaLaunchCooperativeKernel(fn, dim3(n * G),
                                    dim3(ompi_attn::kThreads), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
