// linear_scatter: the linear scatter from a root on Hopper, root's rows
// streamed in pieces over nearly the whole card.
//
// Replaces ompi_tpu/coll/pallas_ring.py:_scatter_kernel (wrapper
// linear_scatter, used by PallasColl.scatter through scatter_block).
// There root pushes row root+s of its buffer into rank root+s's output
// with n - 1 remote DMAs in flight at once, and each receiver only waits
// on its recv semaphore. No handshake: a receiver never writes its own
// row, so a store that lands before the receiver starts is harmless (the
// reference's docstring, pallas_ring.py:1122-1128). The reference stages
// root's buffer on every rank, (n, n, L), and reads root's copy alone;
// this kernel takes root's (n, L) buffer. It moves bytes only and takes
// every dtype.
//
// Bound: bytes. Root's buffer is read once and every output row written
// once: 2 n B for B bytes per rank, 5.128 ms at 1 GiB and n = 8 on an
// H100 (3.35 TB/s). The first port gave every rank an equal share of the
// grid, so root's share alone copied and the receivers' blocks only
// waited: 1/n of the SMs moved 16 GiB (11.22 ms).
//
// What this design does about it: the work is all root's, so root gets
// the card.
// - Roles: the first `senders` blocks are root's, nearly the whole
//   resident grid; each of the n - 1 receivers is one block that only
//   waits.
// - Pieces: every row is cut into pieces of `piece` bytes (the last
//   ragged), numbered so that piece p is row root + p % n, chunk p / n,
//   so all n rows stream at once, as the reference's DMA engines do.
//   Root's blocks draw the pieces in that order from a ticket counter,
//   each drawing its next ticket while it copies a piece, so a block
//   that streams faster takes more pieces and all finish together (a
//   fixed share each left the slowest block 5% behind the median). The
//   last sender to finish (a second counter) takes both back to 0.
// - Copies: 16-byte vectors with four loads in flight per thread, the
//   bytes before the first 16-byte boundary and after the last one byte
//   by byte inside the kernel (copy_span), so any row width and dtype
//   copies exactly.
// - Flags: after storing a piece for receiver d a block publishes once
//   (block_publish) and raises d's flag by one (raise_flag); receiver d's
//   block acquires its flag until it has counted all of its row's pieces
//   and takes it back to 0 (acquire_flag: hot polls, the 30 s trap). One
//   flag per receiver: on one card all ranks' flags share one memory,
//   and a shared flag would let one receiver's pieces satisfy another's
//   wait. Root's own row is pieces too, with no flag.
#include "ring_common.cuh"

namespace ompi_ring {

// sems: a flag per rank (the receivers'), then the senders' ticket
// counter and their count of finished senders.
__global__ void __launch_bounds__(kThreads)
    linear_scatter_kernel(const char* __restrict__ buf,
                          char* __restrict__ out, int* sems, int n,
                          long long row, int root, long long piece,
                          int pieces, int senders) {
  const int b = blockIdx.x;
  OMPI_PROBE(0);
  if (b >= senders) {  // receiver d: its row's pieces counted, flag to 0
    const int d = (root + 1 + (b - senders)) % n;
    if (threadIdx.x == 0) acquire_flag(sems + d, pieces);
    OMPI_PROBE(1);  // probe: when the receiver's row had wholly landed
    return;
  }
  Flag tickets(sems[n]);
  const int total = n * pieces;
  // The tickets of this piece and the next, by the parity of the loop:
  // thread 0 draws the next while the block copies this one, and the
  // barrier that publishes this one makes it visible to the block.
  __shared__ int next[2];
  if (threadIdx.x == 0)
    next[0] = tickets.fetch_add(1, cuda::memory_order_relaxed);
  __syncthreads();
  for (int i = 0, p = next[0]; p < total; p = next[++i & 1]) {
    const int q = p % n;
    const long long c0 = (long long)(p / n) * piece;
    const int d = (root + q) % n;
    const long long off = (long long)d * row + c0;
    if (threadIdx.x == 0)
      next[(i + 1) & 1] = tickets.fetch_add(1, cuda::memory_order_relaxed);
    copy_span(out + off, buf + off, row - c0 < piece ? row - c0 : piece);
    if (q) {
      block_publish();
      if (threadIdx.x == 0) raise_flag(sems + d);
    } else {
      __syncthreads();
    }
  }
  // Every sender has drawn its last ticket before it counts itself done
  // (release); the last one (acquire) takes both counters back to 0.
  if (threadIdx.x == 0 &&
      Flag(sems[n + 1]).fetch_add(1, cuda::memory_order_acq_rel) ==
          senders - 1) {
    tickets.store(0, cuda::memory_order_relaxed);
    Flag(sems[n + 1]).store(0, cuda::memory_order_relaxed);
  }
  OMPI_PROBE(1);
}

}  // namespace ompi_ring

// buf: root's (n, row) buffer of `row` bytes per rank, out: (n, row)
// rank-major, both 16-byte aligned; sems: (n + 2) int32, all 0 at entry
// and left at 0 (root's flag is never raised); piece: bytes per piece, a
// multiple of 16, `pieces` per row (pieces * piece >= row, n * pieces
// below 2^31 - senders); `senders` blocks of root and n - 1 receiver
// blocks of `threads` each, all resident (cooperative). Returns the CUDA
// error of the launch (0 on success).
extern "C" int ompi_linear_scatter(const void* buf, void* out, void* sems,
                                   int n, long long row, int root,
                                   long long piece, int pieces, int senders,
                                   int threads, int device, void* stream) {
  using namespace ompi_ring;
  if (n < 2 || root < 0 || root >= n || piece < 16 || piece & 15 ||
      pieces < 1 || (long long)pieces * piece < row || senders < 1 ||
      (long long)n * pieces + senders > 0x7fffffffLL ||
      threads < 32 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&buf, &out,   &sems,   &n,      &row,
                  &root,       &piece, &pieces, &senders};
  return launch_cooperative((const void*)linear_scatter_kernel,
                            senders + n - 1, threads, args, device, stream);
}
