// Shared pieces of the ring allreduce kernels: the combine ops, the
// flag primitives that stand for the Pallas semaphores, L1-bypassing
// loads/stores for comm slots, and the ring schedule itself.
//
// Ranks on one card. A rank-major buffer holds n virtual ranks in one
// HBM; each rank is played by its own thread blocks (one per column
// stripe). A Pallas remote DMA becomes stores into the peer rank's comm
// slot followed by a release-increment of the peer's flag; a semaphore
// wait becomes an acquire spin on the rank's own flag. Every launch is
// cooperative, so all blocks are resident and a spin cannot starve the
// block it waits for; a grid that cannot be resident fails to launch.
#pragma once

#include <cuda/atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ompi_ring {

constexpr int kThreads = 1024;

enum OpCode { OP_SUM = 0, OP_PROD = 1, OP_MAX = 2, OP_MIN = 3 };
enum DtypeCode { DT_F32 = 0, DT_BF16 = 1, DT_I32 = 2 };

// ---- combine -------------------------------------------------------------

template <int OP>
__device__ __forceinline__ float combine_f32(float a, float b) {
  if (OP == OP_SUM) return a + b;
  if (OP == OP_PROD) return a * b;
  // NaN propagates, as jnp.maximum / jnp.minimum do (fmaxf would drop it).
  if (a != a) return a;
  if (b != b) return b;
  if (OP == OP_MAX) return a > b ? a : b;
  return a < b ? a : b;
}

template <int OP>
__device__ __forceinline__ int combine_i32(int a, int b) {
  // SUM/PROD wrap in two's complement, as XLA's and torch's int32 do.
  if (OP == OP_SUM) return (int)((unsigned)a + (unsigned)b);
  if (OP == OP_PROD) return (int)((unsigned)a * (unsigned)b);
  if (OP == OP_MAX) return a > b ? a : b;
  return a < b ? a : b;
}

template <typename T, int OP> struct Combine;

template <int OP> struct Combine<float, OP> {
  __device__ __forceinline__ static float apply(float a, float b) {
    return combine_f32<OP>(a, b);
  }
};

// bf16: compute in f32 and round once to bf16 per step, as XLA does.
template <int OP> struct Combine<__nv_bfloat16, OP> {
  __device__ __forceinline__ static __nv_bfloat16 apply(__nv_bfloat16 a,
                                                        __nv_bfloat16 b) {
    return __float2bfloat16_rn(
        combine_f32<OP>(__bfloat162float(a), __bfloat162float(b)));
  }
};

template <int OP> struct Combine<int, OP> {
  __device__ __forceinline__ static int apply(int a, int b) {
    return combine_i32<OP>(a, b);
  }
};

// ---- comm-slot access: global loads/stores that bypass L1, so a value
// another SM stored is never served from a stale L1 line. ----------------

template <typename T> __device__ __forceinline__ T ld_cg(const T* p);
template <> __device__ __forceinline__ float ld_cg(const float* p) {
  return __ldcg(p);
}
template <> __device__ __forceinline__ int ld_cg(const int* p) {
  return __ldcg(p);
}
template <>
__device__ __forceinline__ __nv_bfloat16 ld_cg(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
}

template <typename T> __device__ __forceinline__ void st_cg(T* p, T v);
template <> __device__ __forceinline__ void st_cg(float* p, float v) {
  __stcg(p, v);
}
template <> __device__ __forceinline__ void st_cg(int* p, int v) {
  __stcg(p, v);
}
template <>
__device__ __forceinline__ void st_cg(__nv_bfloat16* p, __nv_bfloat16 v) {
  __stcg(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(v));
}

// ---- flags (the semaphores) ------------------------------------------------

using Flag = cuda::atomic_ref<int, cuda::thread_scope_device>;

// Every thread's stores of this block are done and visible device-wide
// before the caller's thread 0 signals.
__device__ __forceinline__ void publish() {
  __threadfence();
  __syncthreads();
}

// Thread 0 only, after publish(): release-increment a flag.
__device__ __forceinline__ void signal(int* flag, int v) {
  Flag(*flag).fetch_add(v, cuda::memory_order_release);
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A wait this long is a protocol deadlock: trap, so the launch fails
// loudly (the next synchronize raises) instead of hanging the card.
constexpr unsigned long long kDeadlockNs = 30ull * 1000 * 1000 * 1000;

// Whole block: wait until the flag reaches v, consume v.
__device__ __forceinline__ void wait(int* flag, int v) {
  if (threadIdx.x == 0) {
    Flag f(*flag);
    const unsigned long long t0 = global_ns();
    while (f.load(cuda::memory_order_acquire) < v) {
      __nanosleep(64);
      if (global_ns() - t0 > kDeadlockNs) __trap();
    }
    f.fetch_sub(v, cuda::memory_order_relaxed);
    __threadfence();
  }
  __syncthreads();
}

// ---- the ring schedule -----------------------------------------------------

// Flag slots per (rank, stripe).
enum RingFlag { F_RECV = 0, F_CAP = 2, F_SEG = 4, RING_NSEM = 5 };

// Block (r, s) of the grid plays rank r on column stripe s of every ring
// block. x/out are rank-major (n ranks, n blocks, W columns); comm is
// (n, stripes, 2, sw); sems is (n, stripes, RING_NSEM). The ring runs
// segment by segment over `seg` columns; with SEGMENTED a per-segment
// credit keeps a rank from starting segment i+1 into its right
// neighbour's slots before that neighbour has drained segment i.
//
// Credits: a rank credits slot `slot` to its left neighbour right after
// the send FROM that slot (steps 0..2n-4), not after filling it as the
// reference does; the left neighbour spends the credit writing that slot
// one step later. There is no post-seed credit.
template <typename T, int OP, bool SEGMENTED>
__device__ __forceinline__ void ring_schedule(const T* __restrict__ x,
                                              T* __restrict__ out, T* comm,
                                              int* sems, int n, int stripes,
                                              long long W, long long seg,
                                              int n_segs) {
  const int r = blockIdx.x / stripes;
  const int s = blockIdx.x % stripes;
  const int left = (r + n - 1) % n;
  const int right = (r + 1) % n;
  const long long sw = (seg + stripes - 1) / stripes;
  const long long c0 = (long long)s * sw;
  const long long cw = c0 < seg ? (seg - c0 < sw ? seg - c0 : sw) : 0;
  const int nsteps = 2 * (n - 1);

  T* my_comm = comm + ((long long)r * stripes + s) * 2 * sw;
  T* right_comm = comm + ((long long)right * stripes + s) * 2 * sw;
  int* my_sem = sems + (r * stripes + s) * RING_NSEM;
  int* left_sem = sems + (left * stripes + s) * RING_NSEM;
  int* right_sem = sems + (right * stripes + s) * RING_NSEM;
  const T* xr = x + (long long)r * n * W;
  T* outr = out + (long long)r * n * W;

  if (SEGMENTED && threadIdx.x == 0) signal(left_sem + F_SEG, 1);  // prime
  for (int si = 0; si < n_segs; ++si) {
    const long long off = (long long)si * seg + c0;
    if (SEGMENTED) wait(my_sem + F_SEG, 1);
    // Seed: slot 0 holds this rank's partial of block (r - 1).
    const T* seed = xr + (long long)left * W + off;
    for (long long j = threadIdx.x; j < cw; j += blockDim.x)
      st_cg(my_comm + j, seed[j]);
    for (int step = 0; step < nsteps; ++step) {
      const int slot = step & 1, nslot = slot ^ 1;
      if (step >= 1) wait(my_sem + F_CAP + nslot, 1);
      // Send: my slot -> right neighbour's other slot.
      const T* src = my_comm + slot * sw;
      T* dst = right_comm + nslot * sw;
      for (long long j = threadIdx.x; j < cw; j += blockDim.x)
        st_cg(dst + j, ld_cg(src + j));
      publish();
      if (threadIdx.x == 0) {
        signal(right_sem + F_RECV + nslot, 1);
        if (step < nsteps - 1) signal(left_sem + F_CAP + slot, 1);
      }
      wait(my_sem + F_RECV + nslot, 1);
      T* arrived = my_comm + nslot * sw;
      if (step < n - 1) {
        // Reduce-scatter: fold this rank's block into the arrival.
        const int blk = (r - step - 2 + 2 * n) % n;
        const T* xb = xr + (long long)blk * W + off;
        T* ob = outr + (long long)blk * W + off;
        const bool last = step == n - 2;  // blk == r: first finished block
        for (long long j = threadIdx.x; j < cw; j += blockDim.x) {
          const T v = Combine<T, OP>::apply(ld_cg(arrived + j), xb[j]);
          st_cg(arrived + j, v);
          if (last) ob[j] = v;
        }
      } else {
        // Allgather: store the finished block that arrived.
        const int blk = (r - (step - (n - 1)) - 1 + 2 * n) % n;
        T* ob = outr + (long long)blk * W + off;
        for (long long j = threadIdx.x; j < cw; j += blockDim.x)
          ob[j] = ld_cg(arrived + j);
      }
    }
    if (SEGMENTED) {
      // Drained every send from the left: grant its next segment.
      publish();
      if (threadIdx.x == 0) signal(left_sem + F_SEG, 1);
    }
  }
  if (SEGMENTED) wait(my_sem + F_SEG, 1);  // residual credit
}

}  // namespace ompi_ring

// Instantiate KERNEL<T, OP> for the (op, dtype) codes and return it as a
// launchable pointer (nullptr for an unknown pair).
#define OMPI_RING_PICK(KERNEL)                                        \
  [](int op, int dt) -> const void* {                                 \
    using namespace ompi_ring;                                        \
    switch (dt * 4 + op) {                                            \
      case 0: return (const void*)KERNEL<float, OP_SUM>;              \
      case 1: return (const void*)KERNEL<float, OP_PROD>;             \
      case 2: return (const void*)KERNEL<float, OP_MAX>;              \
      case 3: return (const void*)KERNEL<float, OP_MIN>;              \
      case 4: return (const void*)KERNEL<__nv_bfloat16, OP_SUM>;      \
      case 5: return (const void*)KERNEL<__nv_bfloat16, OP_PROD>;     \
      case 6: return (const void*)KERNEL<__nv_bfloat16, OP_MAX>;      \
      case 7: return (const void*)KERNEL<__nv_bfloat16, OP_MIN>;      \
      case 8: return (const void*)KERNEL<int, OP_SUM>;                \
      case 9: return (const void*)KERNEL<int, OP_PROD>;               \
      case 10: return (const void*)KERNEL<int, OP_MAX>;               \
      case 11: return (const void*)KERNEL<int, OP_MIN>;               \
      default: return nullptr;                                        \
    }                                                                 \
  }
