// quant_allreduce: the quantized-wire ring allreduce on Hopper.
//
// Replaces ompi_tpu/coll/quant.py:_quant_allreduce_kernel (wrapper
// quant_allreduce, used by allreduce_block_quant): a SUM ring over
// 2(n-1) steps whose wire is int8 rows of 128 values plus one f32 scale
// per row (scale = max|row| / 127, 1 for an all-zero row). The seed is
// the wire image of block r-1; a reduce-scatter step dequantizes the
// arrival, adds this rank's block and requantizes into the slot (the
// last one also writes the block's dequantized image, so every rank
// reconstructs the same values); an allgather step writes the
// dequantized arrival.
//
// Bound: memory. A step moves a quarter of the f32 bytes over the wire
// and does a few operations per element (a division, a rounding, a
// product and a sum), far below the card's rate, so time is bytes over
// HBM bandwidth plus the per-step flag round trips. What the design does
// about it: each rank is striped over thread blocks by rows (n x stripes
// <= SM count, one cooperative launch, every block resident), each
// stripe with its own two slots and flags; inside a block one warp
// takes one 128-value row at a time, four floats per lane as one
// 16-byte load, the row's max|x| by shuffles and four int8 values as
// one 4-byte store; the send copies a slot's int8 rows in 16-byte
// vectors. The JAX kernel's two semaphore sets (values and scales)
// become one flag per (receiver, stripe, slot), raised after both
// stores, because each slot has one writer. Later speed work: requantize
// straight into the right neighbour's slot (no separate send pass).
//
// Credits: a slot is credited to the left neighbour right after the
// send FROM it (every step but the last), and there is no post-seed
// credit (ring_common.cuh's placement); the JAX kernel credits right
// after filling a slot it still has to send from. Every flag ends at 0.
//
// Bits: the arithmetic is the JAX package's, operation by operation:
// IEEE divisions (x / scale, m / 127), rintf (half to even, as
// jnp.round), a clip to +-127 before the int8 cast, and the
// dequantize-accumulate as a rounded product then a rounded sum
// (__fmul_rn, __fadd_rn: nvcc would otherwise contract it into an FMA).
#include "ring_common.cuh"

namespace ompi_ring {

constexpr int kLanes = 128;                 // values per row
constexpr int kWarps = kThreads / 32;
constexpr float kLevels = 127.0f;
enum QuantFlag { Q_RECV = 0, Q_CAP = 2, QUANT_NSEM = 4 };

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

__device__ __forceinline__ unsigned quant_one(float v, float scale) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -kLevels), kLevels);
  return (unsigned)(unsigned char)(signed char)(int)q;
}

// Four int8 values as one 32-bit word (a char4, value 4l in the low
// byte).
__device__ __forceinline__ int quant4(const float4& v, float scale) {
  return (int)(quant_one(v.x, scale) | quant_one(v.y, scale) << 8 |
               quant_one(v.z, scale) << 16 | quant_one(v.w, scale) << 24);
}

__device__ __forceinline__ float q_at(int packed, int k) {
  return (float)(signed char)((unsigned)packed >> (8 * k));
}

__device__ __forceinline__ float4 dequant4(int packed, float scale) {
  return make_float4(__fmul_rn(q_at(packed, 0), scale),
                     __fmul_rn(q_at(packed, 1), scale),
                     __fmul_rn(q_at(packed, 2), scale),
                     __fmul_rn(q_at(packed, 3), scale));
}

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// Block (r, s) of the grid plays rank r on rows [s*sr, s*sr + cr) of
// every ring block. x and out are (n ranks, n blocks, rows, 128) f32.
// comm holds, per (rank, stripe, slot), sr4 int8 rows then sr4 f32
// scales (sr rounded up to 4, so every slot starts 16-byte aligned);
// sems is (n, stripes, QUANT_NSEM).
__global__ void __launch_bounds__(kThreads)
    quant_allreduce_kernel(const float* __restrict__ x, float* __restrict__ out,
                           float* comm, int* sems, int n, int stripes,
                           long long rows) {
  const int r = blockIdx.x / stripes;
  const int s = blockIdx.x % stripes;
  const int left = (r - 1 + n) % n;
  const int right = (r + 1) % n;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long sw = (rows * kLanes + stripes - 1) / stripes;
  const long long sr = (sw + kLanes - 1) / kLanes;
  const long long sr4 = (sr + 3) / 4 * 4;
  const long long slot_words = sr4 * (kLanes / 4 + 1);
  const long long r0 = (long long)s * sr;
  const long long cr = r0 < rows ? (rows - r0 < sr ? rows - r0 : sr) : 0;
  const long long blk_elems = rows * kLanes;

  auto slot_base = [&](int rank, int k) {
    return comm + ((long long)(rank * stripes + s) * 2 + k) * slot_words;
  };
  auto slot_q = [&](int rank, int k) {
    return reinterpret_cast<int*>(slot_base(rank, k));  // char4 words
  };
  auto slot_s = [&](int rank, int k) {
    return slot_base(rank, k) + sr4 * (kLanes / 4);
  };
  int* my_sem = sems + (r * stripes + s) * QUANT_NSEM;
  int* left_sem = sems + (left * stripes + s) * QUANT_NSEM;
  int* right_sem = sems + (right * stripes + s) * QUANT_NSEM;
  const float* xr = x + (long long)r * n * blk_elems + r0 * kLanes;
  float* outr = out + (long long)r * n * blk_elems + r0 * kLanes;

  // Seed: slot 0 holds the wire image of block r - 1.
  {
    const float* xb = xr + (long long)left * blk_elems;
    int* q = slot_q(r, 0);
    float* sc = slot_s(r, 0);
    for (long long i = warp; i < cr; i += kWarps) {
      const float4 v =
          *reinterpret_cast<const float4*>(xb + i * kLanes + 4 * lane);
      const float scale = row_scale(v);
      __stcg(q + i * (kLanes / 4) + lane, quant4(v, scale));
      if (lane == 0) __stcg(sc + i, scale);
    }
  }
  __syncthreads();  // the send below reads the seed in another mapping

  const int nsteps = 2 * (n - 1);
  for (int step = 0; step < nsteps; ++step) {
    const int slot = step & 1, nslot = slot ^ 1;
    if (step >= 1) wait(my_sem + Q_CAP + nslot, 1);
    // Send: my slot -> right neighbour's other slot, values then scales.
    {
      const int4* src = reinterpret_cast<const int4*>(slot_q(r, slot));
      int4* dst = reinterpret_cast<int4*>(slot_q(right, nslot));
      const long long nv = cr * (kLanes / 16);
      for (long long j = threadIdx.x; j < nv; j += blockDim.x)
        __stcg(dst + j, __ldcg(src + j));
      const float* ss = slot_s(r, slot);
      float* ds = slot_s(right, nslot);
      for (long long j = threadIdx.x; j < cr; j += blockDim.x)
        __stcg(ds + j, __ldcg(ss + j));
    }
    publish();
    if (threadIdx.x == 0) {
      signal(right_sem + Q_RECV + nslot, 1);
      if (step < nsteps - 1) signal(left_sem + Q_CAP + slot, 1);
    }
    wait(my_sem + Q_RECV + nslot, 1);
    int* aq = slot_q(r, nslot);
    float* as = slot_s(r, nslot);
    if (step < n - 1) {
      // Reduce-scatter: requant(dequant(arrival) + x[blk]) into the slot.
      const int blk = ((r - step - 2) % n + n) % n;
      const float* xb = xr + (long long)blk * blk_elems;
      float* ob = outr + (long long)blk * blk_elems;
      const bool last = step == n - 2;  // blk == r: own block finished
      for (long long i = warp; i < cr; i += kWarps) {
        const int packed = __ldcg(aq + i * (kLanes / 4) + lane);
        const float scale_in = __ldcg(as + i);
        const float4 v = add4(
            dequant4(packed, scale_in),
            *reinterpret_cast<const float4*>(xb + i * kLanes + 4 * lane));
        const float scale = row_scale(v);  // every lane has read the slot
        const int q = quant4(v, scale);
        __stcg(aq + i * (kLanes / 4) + lane, q);
        if (lane == 0) __stcg(as + i, scale);
        if (last)
          *reinterpret_cast<float4*>(ob + i * kLanes + 4 * lane) =
              dequant4(q, scale);
      }
    } else {
      // Allgather: the finished block that arrived, dequantized.
      const int blk = ((r - (step - (n - 1)) - 1) % n + n) % n;
      float* ob = outr + (long long)blk * blk_elems;
      for (long long i = warp; i < cr; i += kWarps)
        *reinterpret_cast<float4*>(ob + i * kLanes + 4 * lane) =
            dequant4(__ldcg(aq + i * (kLanes / 4) + lane), __ldcg(as + i));
    }
  }
}

}  // namespace ompi_ring

// x, out: (n, n, rows, 128) f32 rank-major ring blocks, rows % 128 == 0,
// 16-byte aligned; comm: (n, stripes, 2) slots as the kernel lays them
// out; sems: (n, stripes, 4) int32, zeroed by the caller. Returns the
// CUDA error of the launch (0 on success).
extern "C" int ompi_quant_allreduce(const void* x, void* out, void* comm,
                                    void* sems, int n, int stripes,
                                    long long rows, int device,
                                    void* stream) {
  void* args[] = {(void*)&x, &out, &comm, &sems, &n, &stripes, &rows};
  return ompi_ring::launch_cooperative(
      (const void*)ompi_ring::quant_allreduce_kernel, n * stripes, args,
      device, stream);
}
