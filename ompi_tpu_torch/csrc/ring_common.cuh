// Shared pieces of the collective kernels: the combine ops, the flag
// primitives that stand for the Pallas semaphores, L1-bypassing
// loads/stores for comm slots, a thread-block cluster's shared memory
// (its addresses, stores, flags and launch), 16-byte vector combines, L2
// cache policies for data another block reads after a flag, the
// fold-then-forward ring (either ring direction), the byte copies of the
// data-movement kernels and the cooperative launch. Every ring of the
// port makes one pass per step: the whole-payload rings here
// (ring_fused), the reduce-scatter, the allgather, the chunked ring and
// the table kernel in their own wavefronts.
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
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace ompi_ring {

constexpr int kThreads = 1024;

enum OpCode { OP_SUM = 0, OP_PROD = 1, OP_MAX = 2, OP_MIN = 3 };
// The reduction kernels' element types, in pallas_ring._DTYPE_CODES's
// order.
enum DtypeCode {
  DT_F32 = 0,
  DT_BF16 = 1,
  DT_I32 = 2,
  DT_F64 = 3,
  DT_F16 = 4,
  DT_I8 = 5,
  DT_U8 = 6
};

// Bytes of one element of a dtype code (0 for an unknown code).
__host__ __device__ inline int dtype_size(int dt) {
  switch (dt) {
    case DT_F32: case DT_I32: return 4;
    case DT_F64: return 8;
    case DT_BF16: case DT_F16: return 2;
    case DT_I8: case DT_U8: return 1;
    default: return 0;
  }
}

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
__device__ __forceinline__ double combine_f64(double a, double b) {
  if (OP == OP_SUM) return a + b;
  if (OP == OP_PROD) return a * b;
  if (a != a) return a;
  if (b != b) return b;
  if (OP == OP_MAX) return a > b ? a : b;
  return a < b ? a : b;
}

// int8/uint8: SUM/PROD wrap modulo 256 (as XLA's and torch's do), MAX/MIN
// compare signed for int8 and unsigned for uint8 (I's own order).
template <typename I, int OP>
__device__ __forceinline__ I combine_i8(I a, I b) {
  if (OP == OP_SUM) return (I)(unsigned char)((unsigned)a + (unsigned)b);
  if (OP == OP_PROD) return (I)(unsigned char)((unsigned)a * (unsigned)b);
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

template <int OP> struct Combine<double, OP> {
  __device__ __forceinline__ static double apply(double a, double b) {
    return combine_f64<OP>(a, b);
  }
};

// f16: compute in f32 and round once to f16 per step. One f16 sum or
// product rounded from f32 equals the f16 operation itself (f32's 24
// bits >= 2 * 11 + 2, so the double rounding is innocuous).
template <int OP> struct Combine<__half, OP> {
  __device__ __forceinline__ static __half apply(__half a, __half b) {
    return __float2half_rn(
        combine_f32<OP>(__half2float(a), __half2float(b)));
  }
};

template <int OP> struct Combine<int8_t, OP> {
  __device__ __forceinline__ static int8_t apply(int8_t a, int8_t b) {
    return combine_i8<int8_t, OP>(a, b);
  }
};

template <int OP> struct Combine<uint8_t, OP> {
  __device__ __forceinline__ static uint8_t apply(uint8_t a, uint8_t b) {
    return combine_i8<uint8_t, OP>(a, b);
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
template <> __device__ __forceinline__ double ld_cg(const double* p) {
  return __ldcg(p);
}
template <> __device__ __forceinline__ __half ld_cg(const __half* p) {
  return __ushort_as_half(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}
template <> __device__ __forceinline__ int8_t ld_cg(const int8_t* p) {
  return __ldcg(p);
}
template <> __device__ __forceinline__ uint8_t ld_cg(const uint8_t* p) {
  return __ldcg(p);
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
template <> __device__ __forceinline__ void st_cg(double* p, double v) {
  __stcg(p, v);
}
template <> __device__ __forceinline__ void st_cg(__half* p, __half v) {
  __stcg(reinterpret_cast<unsigned short*>(p), __half_as_ushort(v));
}
template <> __device__ __forceinline__ void st_cg(int8_t* p, int8_t v) {
  __stcg(p, v);
}
template <> __device__ __forceinline__ void st_cg(uint8_t* p, uint8_t v) {
  __stcg(p, v);
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

// Probe builds (-DOMPI_RING_PROBE, the measurement tools only): thread
// 0 of block b writes v into probe_stamps[b * kProbeSlots + i] at
// OMPI_PROBE_AT(i, v), and %globaltimer at OMPI_PROBE(i);
// ompi_probe_set names the buffer (null: off). Other builds compile
// both to nothing.
constexpr int kProbeSlots = 64;
#ifdef OMPI_RING_PROBE
__device__ unsigned long long* probe_stamps;
#define OMPI_PROBE_AT(i, v)                                             \
  do {                                                                  \
    if (threadIdx.x == 0 && ompi_ring::probe_stamps && (i) < kProbeSlots) \
      ompi_ring::probe_stamps[(long long)blockIdx.x * kProbeSlots + (i)] = \
          (v);                                                          \
  } while (0)
#define OMPI_PROBE(i) OMPI_PROBE_AT(i, ompi_ring::global_ns())
extern "C" int ompi_probe_set(void* stamps) {
  return (int)cudaMemcpyToSymbol(probe_stamps, &stamps, sizeof(stamps));
}
#else
#define OMPI_PROBE_AT(i, v) \
  do {                      \
  } while (0)
#define OMPI_PROBE(i) OMPI_PROBE_AT(i, 0)
#endif

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

// ---- block handovers with one fence (the redesigned kernels) ---------------
//
// publish()/wait() above fence on every thread and sleep between polls.
// These hand over with one cumulative fence on one thread, the pattern of
// cooperative groups' grid sync: a block barrier orders every thread's
// stores before thread 0's gpu-scope release fence, and the flag that
// thread 0 then raises carries them all to the acquirer.

// Whole block: the block's stores so far become visible device-wide
// before any flag thread 0 raises next (raise_flag).
__device__ __forceinline__ void block_publish() {
  __syncthreads();
  if (threadIdx.x == 0)
    cuda::atomic_thread_fence(cuda::memory_order_release,
                              cuda::thread_scope_device);
}

// Thread 0 only, after block_publish(): add v to a flag.
__device__ __forceinline__ void raise_flag(int* flag, int v = 1) {
  Flag(*flag).fetch_add(v, cuda::memory_order_relaxed);
}

// Polls of a flag before the waiter starts to sleep between polls.
constexpr int kHotPolls = 256;

// Thread 0 only: spin with acquire loads until the flag reaches v, and
// leave it as it is (a credit that several blocks read). The first
// kHotPolls polls do not sleep; a wait longer than kDeadlockNs traps.
__device__ __forceinline__ void await_flag(int* flag, int v = 1) {
  Flag f(*flag);
  int polls = 0;
  unsigned long long t0 = 0;
  while (f.load(cuda::memory_order_acquire) < v) {
    if (++polls <= kHotPolls) continue;
    if (t0 == 0) t0 = global_ns();
    __nanosleep(32);
    if (global_ns() - t0 > kDeadlockNs) __trap();
  }
}

// Thread 0 only: await_flag, then take v off the flag.
__device__ __forceinline__ void acquire_flag(int* flag, int v = 1) {
  await_flag(flag, v);
  Flag(*flag).fetch_sub(v, cuda::memory_order_relaxed);
}

// ---- a thread-block cluster's shared memory: buffers and flags that the
// cluster's blocks reach over the SM-to-SM network, by 32-bit
// shared-memory addresses (ring_reduce_scatter.cu, sched_table.cu). NVVM
// refused cooperative groups' map_shared_rank on a flag pointer, so PTX. -----

__device__ __forceinline__ unsigned cta_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// The same shared-memory word in the cluster's block `rank`.
__device__ __forceinline__ unsigned peer_addr(unsigned a, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_peer(unsigned a, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};"
               :
               : "r"(a), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
// After a release fence (block_publish): add 1 to a peer block's flag.
__device__ __forceinline__ void raise_peer(unsigned a) {
  asm volatile("red.relaxed.cluster.shared::cluster.add.u32 [%0], 1;"
               :
               : "r"(a)
               : "memory");
}
// acquire_flag on this block's own shared flag (v = 1).
__device__ __forceinline__ void acquire_local(unsigned a) {
  int polls = 0;
  unsigned long long t0 = 0;
  for (;;) {
    unsigned v;
    asm volatile("ld.acquire.cluster.shared::cta.u32 %0, [%1];"
                 : "=r"(v)
                 : "r"(a)
                 : "memory");
    if ((int)v >= 1) break;
    if (++polls <= kHotPolls) continue;
    if (t0 == 0) t0 = global_ns();
    __nanosleep(32);
    if (global_ns() - t0 > kDeadlockNs) __trap();
  }
  asm volatile("red.relaxed.cluster.shared::cta.add.u32 [%0], %1;"
               :
               : "r"(a), "r"(0xffffffffu)
               : "memory");
}
// The same for a 32-bit word.
__device__ __forceinline__ void st_peer(unsigned a, unsigned v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;"
               :
               : "r"(a), "r"(v)
               : "memory");
}
// Whole block, every block of the cluster: a barrier whose arrival
// releases and whose wait acquires.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::
          : "memory");
}

// Raise a kernel's dynamic shared-memory limit to at least `smem` bytes
// on `device`, once: cudaFuncSetAttribute costs host time on every call
// (tools/gather_rd_check.py), and a limit once raised holds for every
// later launch of the kernel in this process.
inline cudaError_t smem_limit(const void* fn, int device, size_t smem) {
  struct Set {
    const void* fn;
    int device;
    size_t smem;
  };
  static std::mutex mu;
  static std::vector<Set> done;
  std::lock_guard<std::mutex> lock(mu);
  for (const Set& s : done)
    if (s.fn == fn && s.device == device && s.smem >= smem)
      return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) done.push_back({fn, device, smem});
  return err;
}

// A launch of clusters of `size` <= 8 blocks (the portable cluster size)
// of `threads`, on `stream`.
inline void cluster_config(int size, int threads, size_t smem, int blocks,
                           void* stream, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = size;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = (cudaStream_t)stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Launch `blocks` blocks in clusters of `size` (see cluster_config), the
// kernel's shared-memory limit raised first (smem_limit). Returns the
// CUDA error (0 on success).
inline int launch_clusters(const void* fn, int size, int threads,
                           size_t smem, int blocks, void** args, int device,
                           void* stream) {
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = smem_limit(fn, device, smem);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(size, threads, smem, blocks, stream, &cfg, &attr);
  if (err == cudaSuccess) err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of `size` blocks (`threads` each, `smem` bytes of
// dynamic shared memory) the card holds at once, or minus the CUDA error.
inline int max_clusters(const void* fn, int size, int threads, size_t smem,
                        int device) {
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = smem_limit(fn, device, smem);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(size, threads, smem, size, nullptr, &cfg, &attr);
  int clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}

// ---- the wavefront rings (ring_allreduce_chunked, quant_allreduce) ----------

// Whether time slot p of a 2(n-1)-step wavefront over n_segs segments
// has a pass that forwards into the right neighbour's buffers: a step k
// in 0 .. 2n-4 whose segment p - k is in 0 .. n_segs-1
// (pallas_ring._ch_forwards).
__device__ __forceinline__ bool ch_forwards(int p, int n, int n_segs) {
  return p >= 0 && p - n_segs + 1 <= 2 * n - 4;
}

// ---- bulk (TMA) copies completing on mbarriers (selfdma_chunked,
// ppermute_shift): one thread issues them; a copy into shared memory
// needs a cluster launch (else CUDA error 715). ----------------------------

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}
// The issuing thread's arrival, expecting `bytes` of bulk copies.
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
// Wait for the phase of the given parity to complete; trap after 30 s.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned long long t0 = 0;
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0)
      t0 = global_ns();
    else if (global_ns() - t0 > kDeadlockNs)
      __trap();
  }
}
__device__ __forceinline__ void bulk_in(unsigned dst, const char* src,
                                        unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// Shared memory to the block's own shared memory by its shared::cluster
// address: the self-targeted copy.
__device__ __forceinline__ void bulk_self(unsigned dst, unsigned src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
      "bytes [%0], [%1], %2, [%3];" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_out(char* dst, unsigned src,
                                         unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n\t"
      "cp.async.bulk.commit_group;" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
}

// ---- 16-byte vectors -------------------------------------------------------

// One 32-bit word of a vector: its elements combined pairwise (the
// 2-byte types two halves a word, the 1-byte types four lanes).
template <typename T, int OP> struct WordCombine;
template <int OP> struct WordCombine<float, OP> {
  __device__ __forceinline__ static unsigned apply(unsigned a, unsigned b) {
    return __float_as_uint(combine_f32<OP>(__uint_as_float(a),
                                           __uint_as_float(b)));
  }
};
template <int OP> struct WordCombine<int, OP> {
  __device__ __forceinline__ static unsigned apply(unsigned a, unsigned b) {
    return (unsigned)combine_i32<OP>((int)a, (int)b);
  }
};
template <int OP> struct WordCombine<__nv_bfloat16, OP> {
  __device__ __forceinline__ static unsigned half(unsigned a, unsigned b) {
    return __bfloat16_as_ushort(Combine<__nv_bfloat16, OP>::apply(
        __ushort_as_bfloat16((unsigned short)a),
        __ushort_as_bfloat16((unsigned short)b)));
  }
  __device__ __forceinline__ static unsigned apply(unsigned a, unsigned b) {
    return half(a & 0xffffu, b & 0xffffu) | (half(a >> 16, b >> 16) << 16);
  }
};
template <int OP> struct WordCombine<__half, OP> {
  __device__ __forceinline__ static unsigned half(unsigned a, unsigned b) {
    return __half_as_ushort(Combine<__half, OP>::apply(
        __ushort_as_half((unsigned short)a),
        __ushort_as_half((unsigned short)b)));
  }
  __device__ __forceinline__ static unsigned apply(unsigned a, unsigned b) {
    return half(a & 0xffffu, b & 0xffffu) | (half(a >> 16, b >> 16) << 16);
  }
};
// Four byte lanes: the SIMD video instructions for SUM (a lane's sum
// wraps, no carry into the next), MAX and MIN; PROD lane by lane (the
// low byte of a product depends on the factors' low bytes alone).
template <int OP> struct WordCombine<int8_t, OP> {
  __device__ __forceinline__ static unsigned apply(unsigned a, unsigned b) {
    if (OP == OP_SUM) return __vadd4(a, b);
    if (OP == OP_MAX) return __vmaxs4(a, b);
    if (OP == OP_MIN) return __vmins4(a, b);
    unsigned r = 0;
#pragma unroll
    for (int i = 0; i < 32; i += 8) r |= (((a >> i) * (b >> i)) & 0xffu) << i;
    return r;
  }
};
template <int OP> struct WordCombine<uint8_t, OP> {
  __device__ __forceinline__ static unsigned apply(unsigned a, unsigned b) {
    if (OP == OP_SUM) return __vadd4(a, b);
    if (OP == OP_MAX) return __vmaxu4(a, b);
    if (OP == OP_MIN) return __vminu4(a, b);
    unsigned r = 0;
#pragma unroll
    for (int i = 0; i < 32; i += 8) r |= (((a >> i) * (b >> i)) & 0xffu) << i;
    return r;
  }
};

// Elementwise combine(a, b) of two 16-byte vectors of T: four 32-bit
// words, or for an 8-byte T two elements that each span two words.
template <typename T, int OP>
__device__ __forceinline__ uint4 combine_vec(uint4 a, uint4 b) {
  if constexpr (sizeof(T) == 8) {
    const double lo = Combine<T, OP>::apply(
        __hiloint2double((int)a.y, (int)a.x),
        __hiloint2double((int)b.y, (int)b.x));
    const double hi = Combine<T, OP>::apply(
        __hiloint2double((int)a.w, (int)a.z),
        __hiloint2double((int)b.w, (int)b.z));
    return make_uint4((unsigned)__double2loint(lo),
                      (unsigned)__double2hiint(lo),
                      (unsigned)__double2loint(hi),
                      (unsigned)__double2hiint(hi));
  } else {
    using W = WordCombine<T, OP>;
    return make_uint4(W::apply(a.x, b.x), W::apply(a.y, b.y),
                      W::apply(a.z, b.z), W::apply(a.w, b.w));
  }
}

// ---- L2 cache policies -----------------------------------------------------
//
// For rows or slots that another block reads after a flag: the writer
// stores evict-last and the reader reads evict-first, so data not yet
// read outlasts data already read (the tree reduce: 2-4% at 1 GiB per
// rank on an H100, PERF.md). Neither touches L1: another SM wrote it.
__device__ __forceinline__ unsigned long long l2_policy(bool last) {
  unsigned long long p;
  if (last)
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  else
    asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint4 ld_child(const uint4* p,
                                          unsigned long long policy) {
  uint4 v;
  asm volatile(
      "ld.global.L1::no_allocate.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, "
      "[%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy)
      : "memory");
  return v;
}
__device__ __forceinline__ void st_child(uint4* p, uint4 v,
                                         unsigned long long policy) {
  asm volatile(
      "st.global.L1::no_allocate.L2::cache_hint.v4.u32 [%0], {%1, %2, %3, "
      "%4}, %5;"
      :
      : "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "l"(policy)
      : "memory");
}

// ---- the fold-then-forward ring (ring_allreduce, ring_allreduce_bidir) ----
//
// One ring of 2(n-1) steps, one pass per step: at a reduce-scatter step k
// (k < n-1) a rank folds combine(arrival, x[me][blk]) (the reference's
// operands in its order, so the bits stay), writing out[me][me] at the
// last one; at an allgather step it stores the arrival to out[me][blk].
// Either way it stores the value straight into the next rank's slot
// (k+1) % 2 (every step but the last). Step 0's arrival is the previous
// rank's block me-2 of its input, read from x (x never changes): no seed
// copy. A slot is credited back to the previous rank after the pass that
// read it (arrivals 1 .. 2n-5, the ones whose slot it fills again);
// every flag ends at 0. Handover: a block barrier, one thread's release
// fence and relaxed increments (block_publish/raise_flag); waits poll hot
// (acquire_flag); the step's x block is loaded before the waits.

constexpr int kRingUnroll = 4;
// Flags per (rank, stripe) of one ring: recv[2] (an arrival in slot
// 0/1), cap[2] (the next rank's credit on its slot 0/1).
constexpr int kRingFlags = 4;

// Block b of the ring's n x stripes blocks plays rank r = b / stripes on
// column stripe s = b % stripes. x and out are rank-major (n, n, row)
// 16-byte vectors, offset to the ring's first column; the ring covers
// `width` vectors of each ring block. `dir` 1 sends to rank r+1, -1 to
// rank r-1, with the block indices mirrored (blk = r - dir(k+2), as the
// reference's bidirectional kernel). comm: (n, stripes, 2, sv) vectors,
// sv = ceil(width / stripes); sems: (n, stripes, kRingFlags).
template <typename T, int OP>
__device__ __forceinline__ void ring_fused(const uint4* __restrict__ x,
                                           uint4* __restrict__ out,
                                           uint4* comm, int* sems, int n,
                                           int stripes, long long row,
                                           long long width, int dir, int b) {
  const int r = b / stripes;
  const int s = b % stripes;
  const int left = (r - dir + n) % n, right = (r + dir + n) % n;
  const long long sv = (width + stripes - 1) / stripes;  // per stripe
  const long long v0 = (long long)s * sv;
  const long long vn = v0 < width ? (width - v0 < sv ? width - v0 : sv) : 0;
  // Block index r - dir * k modulo n, for k >= 0.
  auto ring_blk = [&](int k) { return ((r - dir * k) % n + n) % n; };
  uint4* ov = out + (long long)r * n * row + v0;
  auto slot = [&](int rank, int k) {
    return comm + (((long long)rank * stripes + s) * 2 + (k & 1)) * sv;
  };
  auto xblk = [&](int rank, int blk) {
    return x + ((long long)rank * n + blk) * row + v0;
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
    const int blk = rs ? ring_blk(k + 2) : ring_blk(k - n + 2);
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
    const uint4* src = k ? slot(r, k) : xblk(left, ring_blk(2));
    uint4* dst = send ? slot(right, k + 1) : nullptr;
    uint4* o = rs ? (k == n - 2 ? ov + (long long)r * row : nullptr)
                  : ov + (long long)blk * row;
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

// ---- data movement --------------------------------------------------------

template <typename U>
__device__ __forceinline__ void copy_units(char* dst, const char* src,
                                           long long bytes) {
  const U* s = reinterpret_cast<const U*>(src);
  U* d = reinterpret_cast<U*>(dst);
  const long long count = bytes / (long long)sizeof(U);
  for (long long j = threadIdx.x; j < count; j += blockDim.x) d[j] = s[j];
}

// Whole block: copy `bytes` bytes from src to dst, any alignment. Where
// dst and src sit at the same offset from a 16-byte boundary: the bytes
// up to the first boundary one by one, then 16-byte vectors with four
// loads in flight per thread, then the ragged tail one by one; otherwise
// byte by byte throughout.
__device__ __forceinline__ void copy_span(char* dst, const char* src,
                                          long long bytes) {
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  long long head = (long long)((16 - (d & 15)) & 15);
  if (((d ^ reinterpret_cast<uintptr_t>(src)) & 15) != 0) head = bytes;
  if (head > bytes) head = bytes;
  const long long nv = (bytes - head) >> 4;
  const long long tail = head + nv * 16;
  for (long long j = threadIdx.x; j < head; j += blockDim.x) dst[j] = src[j];
  const uint4* s = reinterpret_cast<const uint4*>(src + head);
  uint4* v_dst = reinterpret_cast<uint4*>(dst + head);
  constexpr int kUnroll = 4;
  for (long long j0 = threadIdx.x; j0 < nv;
       j0 += (long long)kUnroll * blockDim.x) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = j0 + (long long)u * blockDim.x;
      if (j < nv) v[u] = s[j];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = j0 + (long long)u * blockDim.x;
      if (j < nv) v_dst[j] = v[u];
    }
  }
  for (long long j = tail + threadIdx.x; j < bytes; j += blockDim.x)
    dst[j] = src[j];
}

// Whole block: copy `bytes` bytes from src to dst: copy_span's 16-byte
// vectors where both ends and the length are 16-byte aligned; otherwise
// in units of the element size `elem` (1, 2, 4 or 8 bytes; anything else
// byte by byte).
__device__ __forceinline__ void copy_bytes(char* dst, const char* src,
                                           long long bytes, int elem) {
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) |
        (uintptr_t)bytes) & 15) == 0) {
    copy_span(dst, src, bytes);
    return;
  }
  switch (elem) {
    case 8: copy_units<unsigned long long>(dst, src, bytes); break;
    case 4: copy_units<unsigned int>(dst, src, bytes); break;
    case 2: copy_units<unsigned short>(dst, src, bytes); break;
    default: copy_units<unsigned char>(dst, src, bytes); break;
  }
}

// The bytes [c0, c0 + cw) of a `row`-byte row that stripe s of
// `stripes` moves. Stripe starts are 16-byte multiples, so a row that
// starts aligned is copied in vectors by every stripe.
struct ByteStripe {
  long long c0, cw;
};
__device__ __forceinline__ ByteStripe byte_stripe(long long row, int s,
                                                  int stripes) {
  long long sw = (row + stripes - 1) / stripes;
  sw = (sw + 15) & ~15LL;
  const long long c0 = (long long)s * sw;
  return {c0, c0 < row ? (row - c0 < sw ? row - c0 : sw) : 0};
}

// Cooperative launch of `blocks` blocks of `threads` on `stream`: every
// block resident, or the launch fails. Returns the CUDA error (0 on
// success); a null kernel (unknown op or dtype code) is an invalid value.
inline int launch_cooperative(const void* fn, int blocks, int threads,
                              void** args, int device, void* stream) {
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(threads), args,
                                    0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The same, with blocks of kThreads.
inline int launch_cooperative(const void* fn, int blocks, void** args,
                              int device, void* stream) {
  return launch_cooperative(fn, blocks, kThreads, args, device, stream);
}

}  // namespace ompi_ring

// Instantiate KERNEL<T, OP> for the (op, dtype) codes (DtypeCode x
// OpCode: 7 x 4) and return it as a launchable pointer (nullptr for an
// unknown pair).
#define OMPI_RING_PICK_DT(KERNEL, T, base)                            \
  case base + 0: return (const void*)KERNEL<T, OP_SUM>;               \
  case base + 1: return (const void*)KERNEL<T, OP_PROD>;              \
  case base + 2: return (const void*)KERNEL<T, OP_MAX>;               \
  case base + 3: return (const void*)KERNEL<T, OP_MIN>;
#define OMPI_RING_PICK(KERNEL)                                        \
  [](int op, int dt) -> const void* {                                 \
    using namespace ompi_ring;                                        \
    if (op < 0 || op > 3) return nullptr;                             \
    switch (dt * 4 + op) {                                            \
      OMPI_RING_PICK_DT(KERNEL, float, 0)                             \
      OMPI_RING_PICK_DT(KERNEL, __nv_bfloat16, 4)                     \
      OMPI_RING_PICK_DT(KERNEL, int, 8)                               \
      OMPI_RING_PICK_DT(KERNEL, double, 12)                           \
      OMPI_RING_PICK_DT(KERNEL, __half, 16)                           \
      OMPI_RING_PICK_DT(KERNEL, int8_t, 20)                           \
      OMPI_RING_PICK_DT(KERNEL, uint8_t, 24)                          \
      default: return nullptr;                                        \
    }                                                                 \
  }
