// ppermute_shift: one ring hop on Hopper, its receive certified by a
// thread-block cluster's barrier (or, beyond 8 ranks, by flags).
//
// Replaces ompi_tpu/coll/pallas_ring.py:ppermute_shift's inner kernel
// (one remote DMA of the rank's block to rank me+shift, started and
// awaited). Block (r, s) of the grid copies byte stripe s of rank r's
// row into row (r + shift) mod n of the output; every store lands in its
// final row, so there is no comm scratch, and every receiver has exactly
// one sender, so no credit. The JAX kernel pads each block to 128 lanes;
// this one moves the rows as they are. It moves bytes only and takes
// every dtype: rows are copied in 16-byte vectors where aligned, else in
// units of the element size.
//
// Bound: bytes. Every input byte is read once and every output byte
// written once: 2 n B for B bytes per rank, 0.04006 ms at n = 8 and
// 8 MiB per rank over 3.35 TB/s. The first port's wrapper zeroed a fresh
// flags tensor on every call (a second launch) and asked PyTorch for a
// Stream object, and its kernel was a cooperative launch whose blocks
// fenced on every thread and slept between polls of global flags.
//
// What this design does about it:
// - CLUSTER (up to 8 ranks, the portable cluster size): stripe s of all
//   n ranks forms one cluster. After its copy each block arrives at a
//   cluster barrier with release semantics and waits on it with acquire:
//   that stands for the receive flag the sender r - shift raises, since
//   it waits for every sender of the stripe, that one included. No
//   global flag, no zero-fill and no cooperative launch; the grid may
//   hold more blocks than the card does at once.
// - Beyond 8 ranks: one flag per (receiver, stripe) in global memory,
//   raised after one block barrier and one release fence (block_publish)
//   and polled hot, each taken back to 0 by its waiter, so the wrapper
//   reuses its flags per stream (no zero-fill either); a cooperative
//   launch of resident blocks.
// - The copy: the threads' copy (copy_bytes: coalesced 16-byte vectors,
//   four loads in flight a thread) ran 11-20% behind a device-to-device
//   memcpy of the same bytes on the card at every shape swept (8 MiB per
//   rank, n = 8: 0.0515 ms against 0.0453; PERF.md,
//   tools/quant_hop_check.py). So in the cluster form, where rows are
//   whole 16-byte vectors, one thread of each block streams its stripe
//   through four shared-memory slots by bulk (TMA) copies, global ->
//   shared completing on the slot's mbarrier, shared -> global in a bulk
//   group: 0.0484-0.0501 ms, 7-11% behind the memcpy. Other rows, and
//   the flags form, copy with the threads.
//
// Why the receive is still certified on one card: nothing in the kernel
// reads `out`, and the kernel's end orders every copy before any later
// reader on the stream. The barrier (or the flags) keeps the reference's
// protocol, a receive awaited inside the kernel, so that the kernel runs
// the schedule that simulate_ppermute checks; its cost has not been
// measured apart from the launch and the tail.
#include "ring_common.cuh"

namespace ompi_ring {

// The flags form: sems is (n, stripes), one flag per receiver and
// stripe.
__global__ void __launch_bounds__(kThreads)
    ppermute_shift_kernel(const char* __restrict__ x, char* __restrict__ out,
                          int* sems, int n, int stripes, long long L,
                          int shift, int elem) {
  const int r = blockIdx.x / stripes;
  const int s = blockIdx.x % stripes;
  const long long row = L * elem;
  const ByteStripe st = byte_stripe(row, s, stripes);
  const int dst = (r + shift) % n;
  copy_bytes(out + (long long)dst * row + st.c0,
             x + (long long)r * row + st.c0, st.cw, elem);
  block_publish();
  if (threadIdx.x == 0) {
    raise_flag(sems + (long long)dst * stripes + s);
    acquire_flag(sems + (long long)r * stripes + s);
  }
  __syncthreads();
}

// Pieces in flight per block of the bulk copy, and the bytes before
// their slots in dynamic shared memory (one mbarrier a slot, padded).
constexpr int kHopSlots = 4;
constexpr int kHopHeader = 128;

// The cluster form: block b is rank b % n of stripe b / n. With `piece`
// > 0 and 16-byte aligned rows its first thread streams the stripe in
// pieces of `piece` bytes through kHopSlots slots of shared memory, by
// bulk copies (global -> shared on the slot's mbarrier, shared -> global
// in a bulk group); otherwise every thread copies (copy_bytes).
__global__ void __launch_bounds__(kThreads)
    ppermute_shift_cluster(const char* __restrict__ x, char* __restrict__ out,
                           int n, int stripes, long long L, int shift,
                           int elem, long long piece) {
  extern __shared__ __align__(128) unsigned char hop_smem[];
  const int r = blockIdx.x % n;
  const int s = blockIdx.x / n;
  const long long row = L * elem;
  const ByteStripe st = byte_stripe(row, s, stripes);
  const int dst = (r + shift) % n;
  const char* from = x + (long long)r * row + st.c0;
  char* to = out + (long long)dst * row + st.c0;
  if (piece <= 0 || ((reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(out) | (uintptr_t)row) &
                     15) != 0) {
    copy_bytes(to, from, st.cw, elem);
  } else if (threadIdx.x == 0) {
    const unsigned bars = cta_addr(hop_smem);
    const unsigned slots = bars + kHopHeader;
    for (int b = 0; b < kHopSlots; ++b) mbar_init(bars + 8 * b);
    asm volatile(
        "fence.mbarrier_init.release.cluster;\n\t"
        "fence.proxy.async.shared::cta;" ::
            : "memory");
    const long long pieces = (st.cw + piece - 1) / piece;
    auto len = [&](long long i) {
      return (unsigned)(st.cw - i * piece < piece ? st.cw - i * piece
                                                  : piece);
    };
    auto stage_in = [&](long long i) {
      const unsigned b = (unsigned)(i % kHopSlots);
      mbar_expect(bars + 8 * b, len(i));
      bulk_in(slots + b * (unsigned)piece, from + i * piece, len(i),
              bars + 8 * b);
    };
    for (long long i = 0; i < pieces && i < kHopSlots; ++i) stage_in(i);
    for (long long i = 0; i < pieces; ++i) {
      const unsigned b = (unsigned)(i % kHopSlots);
      mbar_wait(bars + 8 * b, (unsigned)((i / kHopSlots) & 1));
      bulk_out(to + i * piece, slots + b * (unsigned)piece, len(i));
      if (i + kHopSlots < pieces) {
        // The slot is free once this piece's store has read it.
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        stage_in(i + kHopSlots);
      }
    }
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
  // The receive: every sender of this stripe has stored its bytes.
  cluster_sync();
}

}  // namespace ompi_ring

// x, out: (n, L) rank-major, elements of `elem` bytes; shift in [0, n);
// `threads` per block up to 1024. Without clusters: sems (n, stripes)
// int32, all 0 at entry and left at 0; n * stripes resident blocks, one
// cooperative launch. With clusters (n at most 8): sems unused; one
// cluster of the n ranks' blocks per stripe. Returns the CUDA error of
// the launch (0 on success).
extern "C" int ompi_ppermute_shift(const void* x, void* out, void* sems,
                                   int n, int stripes, int threads,
                                   long long L, int shift, int elem,
                                   int cluster, long long piece, int device,
                                   void* stream) {
  using namespace ompi_ring;
  if (n < 2 || stripes < 1 || threads < 32 || threads > kThreads ||
      shift < 0 || shift >= n || elem < 1 || L < 0 || piece < 0 ||
      piece & 15 || (cluster && n > 8) || (piece && !cluster))
    return (int)cudaErrorInvalidValue;
  if (!cluster) {
    void* args[] = {(void*)&x, &out, &sems, &n, &stripes, &L, &shift,
                    &elem};
    return launch_cooperative((const void*)ppermute_shift_kernel,
                              n * stripes, threads, args, device, stream);
  }
  void* args[] = {(void*)&x, &out, &n, &stripes, &L, &shift, &elem, &piece};
  const size_t smem = piece ? kHopHeader + kHopSlots * (size_t)piece : 0;
  return launch_clusters((const void*)ppermute_shift_cluster, n, threads,
                         smem, n * stripes, args, device, stream);
}
