// selfdma_chunked: the one-rank case of the chunked ring allreduce on
// Hopper, as a three-stage pipeline of bulk (TMA) copies.
//
// Replaces ompi_tpu/coll/pallas_ring.py:_selfdma_chunked_kernel (the
// n == 1 branch of ring_allreduce_chunked): the degenerate one-member
// ring, an identity that still runs the chunked pipeline. The reference
// streams each segment HBM -> VMEM x_buf[si%2] (IN), x_buf -> comm_buf
// [si%2] by a remote DMA to itself (RDMA), comm_buf -> HBM (OUT), with
// IN(si+1), RDMA(si) and OUT(si-1) in flight together. It moves bytes
// only, so it takes every dtype and is exact.
//
// Bound: bytes. The function reads its input once and writes its output
// once, 2 B for B bytes: 0.641 ms at 1 GiB on an H100 (3.35 TB/s). The
// first port gave each of 132 blocks about 8 KiB of every 1 MiB segment,
// copied it into a comm slot in HBM, synchronised and copied it out: each
// segment made two dependent round trips with little in flight, and every
// byte moved four times through the memory system (1.491 ms; clone 0.719).
//
// What this design does about it:
// - The reference's stages, run by the bulk copy unit: IN is
//   cp.async.bulk global -> shared x_buf[i%2], completing on an mbarrier;
//   RDMA is cp.async.bulk from x_buf[i%2] to comm_buf[i%2] of the block's
//   own shared memory, through its shared::cluster address (the copy to
//   device_id == me), completing on a second mbarrier; OUT is
//   cp.async.bulk shared -> global, in a bulk group per piece. Only x and
//   out touch HBM: 2 B, the bound.
// - Pieces: the buffer is cut into pieces of `piece` bytes (the
//   reference's segments cut finer, whole 16-byte vectors); block b takes
//   pieces b, b + blocks, ... and pipelines them. One thread issues every
//   copy; it is the only one that waits.
// - Slot hazards, the reference's: RDMA(i) overwrites comm_buf[i%2], so
//   OUT(i-2) must have read it (cp.async.bulk.wait_group.read); IN(i+1)
//   overwrites x_buf[(i+1)%2], so RDMA(i-1) must be complete (its
//   mbarrier); OUT(i) reads comm_buf[i%2] after RDMA(i)'s mbarrier. Each
//   wait traps after 30 s.
// - A tail of fewer than 16 bytes, or buffers that are not 16-byte
//   aligned, are copied by the threads in element-sized units.
#include "ring_common.cuh"

namespace ompi_ring {

// Threads per block: one warp; its first thread issues the bulk copies.
constexpr int kSelfdmaThreads = 32;
// Bytes before the buffers in dynamic shared memory: the four mbarriers
// (in[2], mid[2]), padded.
constexpr int kSelfdmaHeader = 128;

// Probe builds (-DOMPI_RING_PROBE): add the ns a wait took to `total`.
#ifdef OMPI_RING_PROBE
#define PROBE_WAIT(total, wait)                          \
  do {                                                   \
    const unsigned long long w0 = ompi_ring::global_ns(); \
    wait;                                                \
    total += ompi_ring::global_ns() - w0;                \
  } while (0)
#else
#define PROBE_WAIT(total, wait) \
  do {                          \
    wait;                       \
  } while (0)
#endif

__global__ void __launch_bounds__(kSelfdmaThreads)
    selfdma_chunked_kernel(const char* __restrict__ x,
                           char* __restrict__ out, long long bytes,
                           long long piece, int elem) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
       15) != 0) {
    // Not 16-byte aligned: no bulk copy; element-sized units.
    const ByteStripe st = byte_stripe(bytes, blockIdx.x, gridDim.x);
    copy_bytes(out + st.c0, x + st.c0, st.cw, elem);
    return;
  }
  const long long aligned = bytes & ~15LL;
  if (blockIdx.x == 0)  // the tail of fewer than 16 bytes
    copy_bytes(out + aligned, x + aligned, bytes - aligned, elem);
  const unsigned base = cta_addr(smem);
  const unsigned in_bar = base, mid_bar = base + 16;  // two mbarriers each
  const unsigned x_buf = base + kSelfdmaHeader;
  const unsigned comm_buf = x_buf + 2 * (unsigned)piece;
  if (threadIdx.x != 0) return;
  for (int b = 0; b < 2; ++b) {
    mbar_init(in_bar + 8 * b);
    mbar_init(mid_bar + 8 * b);
  }
  asm volatile(
      "fence.mbarrier_init.release.cluster;\n\t"
      "fence.proxy.async.shared::cta;" ::
          : "memory");

  const long long pieces = (aligned + piece - 1) / piece;
  const long long mine =
      blockIdx.x < pieces ? (pieces - blockIdx.x + gridDim.x - 1) / gridDim.x
                          : 0;
  // Piece i of this block: its offset and length.
  auto off = [&](long long i) { return (blockIdx.x + i * gridDim.x) * piece; };
  auto len = [&](long long i) {
    const long long o = off(i);
    return (unsigned)(aligned - o < piece ? aligned - o : piece);
  };
  auto stage_in = [&](long long i) {
    const unsigned b = i & 1;
    mbar_expect(in_bar + 8 * b, len(i));
    bulk_in(x_buf + b * piece, x + off(i), len(i), in_bar + 8 * b);
  };
  // The self-targeted copy's destination and barrier, as this block's
  // shared::cluster addresses (the launch is a cluster of one block).
  const unsigned rank = 0;
  const unsigned comm_c = peer_addr(comm_buf, rank);
  const unsigned mid_c = peer_addr(mid_bar, rank);
  auto stage_self = [&](long long i) {
    const unsigned b = i & 1;
    mbar_expect(mid_bar + 8 * b, len(i));
    bulk_self(comm_c + b * piece, x_buf + b * piece, len(i), mid_c + 8 * b);
  };
#ifdef OMPI_RING_PROBE
  // ns the issuing thread waited for IN, RDMA and OUT.
  unsigned long long waited_in = 0, waited_mid = 0, waited_out = 0;
#endif
  auto stage_out = [&](long long i) {
    const unsigned b = i & 1;
    PROBE_WAIT(waited_mid, mbar_wait(mid_bar + 8 * b, (i >> 1) & 1));
    bulk_out(out + off(i), comm_buf + b * piece, len(i));
  };

  OMPI_PROBE(0);
  if (mine > 0) stage_in(0);
  if (mine > 1) stage_in(1);
  for (long long i = 0; i < mine; ++i) {
    PROBE_WAIT(waited_in, mbar_wait(in_bar + 8 * (i & 1), (i >> 1) & 1));
    // comm_buf[i%2] is free once OUT(i-2) has read it.
    if (i >= 2)
      PROBE_WAIT(waited_out, asm volatile(
                                 "cp.async.bulk.wait_group.read 0;" ::
                                     : "memory"));
    stage_self(i);
    if (i >= 1) {
      stage_out(i - 1);  // after RDMA(i-1), which also frees x_buf
      if (i + 1 < mine) stage_in(i + 1);
    }
  }
  if (mine > 0) stage_out(mine - 1);
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  OMPI_PROBE(1);
  OMPI_PROBE_AT(2, waited_in);
  OMPI_PROBE_AT(3, waited_mid);
  OMPI_PROBE_AT(4, waited_out);
}

}  // namespace ompi_ring

// x, out: `bytes` bytes, elements of `elem` bytes. Launches `blocks`
// blocks, each pipelining pieces of `piece` bytes (a multiple of 16)
// through 4 * piece bytes of shared memory. Returns the CUDA error of the
// launch (0 on success).
extern "C" int ompi_selfdma_chunked(const void* x, void* out, int blocks,
                                    long long piece, long long bytes,
                                    int elem, int device, void* stream) {
  using namespace ompi_ring;
  if (blocks < 1 || piece < 16 || piece & 15 || bytes < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = kSelfdmaHeader + 4 * (size_t)piece;
  void* args[] = {(void*)&x, &out, &bytes, &piece, &elem};
  // Clusters of one block: the self-targeted bulk copy addresses the
  // block's shared memory through the cluster's window.
  return launch_clusters((const void*)selfdma_chunked_kernel, 1,
                         kSelfdmaThreads, smem, blocks, args, device, stream);
}
