// linear_gather: the linear gather to a root on Hopper, every rank's row
// streamed in pieces by a pool of blocks of its own, onto root's counted
// flags.
//
// Replaces ompi_tpu/coll/pallas_ring.py:_gather_kernel (wrapper
// linear_gather, used by PallasColl.gather through gather_block). There
// root copies its own block into its row of the output, grants every
// sender a "ready" credit (its output is live) and waits on one recv
// semaphore per sender; a sender waits for its credit and remote-DMAs
// its block into root's row out[me]. One flag per sender: the senders
// are unordered peers, so a shared flag would let a fast sender satisfy
// root's wait for another (the reference's docstring, pallas_ring.py:
// 1042-1051).
//
// Only root's rows are defined, so the output is root's (n, L) alone:
// the reference's kernel has a rank-major (n, n, L) output of which
// PallasColl keeps root's, 8 GiB here instead of 64 GiB at 1 GiB per
// rank and n = 8. The kernel moves bytes only and takes every dtype.
//
// Bound: bytes. Every input byte is read once and root's n rows written
// once: 2 n B for B bytes per rank, 5.128 ms at 1 GiB and n = 8 on an
// H100 (3.35 TB/s). The first port gave each rank n x 16 blocks of 1024
// threads, each copying a fixed 1/16 of its rank's row after a flag wait,
// so the slowest block set the pace (6.72 ms, PERF.md).
//
// What this design does about it, as the scatter's (linear_scatter.cu):
// - Pools: the grid fills the card's resident slots with n pools of
//   blocks, one per rank, `pool` blocks each and one more in the first
//   `extra` pools (never more blocks than the row has pieces). Each
//   rank's role still runs in its own blocks.
// - Pieces: every row is cut into pieces of `piece` bytes (the last
//   ragged). A pool's blocks draw its row's pieces from that rank's
//   ticket counter, each drawing its next ticket while it copies a piece,
//   so a block that streams faster takes more pieces and a pool's blocks
//   finish together. A piece is copied x[q] -> out[q] in 16-byte vectors
//   with four loads in flight per thread, the bytes before the first
//   16-byte boundary and after the last one byte by byte inside the
//   kernel (copy_span), so any row width and dtype copies exactly.
// - Credit: root's first block grants every sender its ready credit as
//   it starts, so nothing lands in root's rows before root has started
//   (the reference's order), and no sender waits for root's own row to
//   be copied. Every block of a sender's pool reads the credit (it is
//   not taken) before its first store.
// - Flags: a sender's block publishes (a block barrier, then one
//   gpu-scope release fence on thread 0) every `publish` pieces and after
//   its last one, and raises root's flag for that sender by the pieces it
//   published; root's block j, once its pieces of root's own row are
//   copied, waits for senders j + 1, j + 1 + pool, ... until each one's
//   flag counts all of its row's pieces, and takes it back to 0
//   (acquire_flag). A fence a piece left every sender pool 8% behind
//   root's, which has none.
// - The last block of a pool to finish (a count of finished blocks,
//   release / acquire) takes its pool's ticket, count and credit back to
//   0, so every word ends the launch at 0 and the scratch is reused.
#include "ring_common.cuh"

namespace ompi_ring {

// Words of rank q's group in sems, one 32-byte sector per rank: root's
// flag for sender q, q's ready credit, q's pool's ticket counter and its
// count of finished blocks.
constexpr int kGatherWords = 8;
enum GatherWord { kRecv = 0, kReady = 1, kTicket = 2, kDone = 3 };

__global__ void __launch_bounds__(kThreads)
    linear_gather_kernel(const char* __restrict__ x, char* __restrict__ out,
                         int* sems, int n, long long row, int root,
                         long long piece, int pieces, int pool, int extra,
                         int publish) {
  // Block b -> rank q, its index j in q's pool and the pool's size.
  const int b = blockIdx.x, big = extra * (pool + 1);
  const int q = b < big ? b / (pool + 1) : extra + (b - big) / pool;
  const int j = b < big ? b % (pool + 1) : (b - big) % pool;
  const int size = pool + (q < extra ? 1 : 0);
  int* const mine = sems + q * kGatherWords;
  auto word = [&](int rank, int w) { return sems + rank * kGatherWords + w; };
  OMPI_PROBE(0);
  if (threadIdx.x == 0) {
    if (q == root) {
      if (j == 0)  // root has started: every sender may store
        for (int d = 1; d < n; ++d)
          Flag(*word((root + d) % n, kReady))
              .fetch_add(1, cuda::memory_order_release);
    } else {
      await_flag(mine + kReady);
    }
  }
  Flag tickets(mine[kTicket]);
  // The tickets of this piece and the next, by the parity of the loop:
  // thread 0 draws the next while the block copies this one, and the
  // barrier after the piece makes it visible to the block.
  __shared__ int next[2];
  if (threadIdx.x == 0)
    next[0] = tickets.fetch_add(1, cuda::memory_order_relaxed);
  __syncthreads();
  const long long base = (long long)q * row;
  int held = 0;  // pieces copied since the block last published
  for (int i = 0, p = next[0]; p < pieces; p = next[++i & 1]) {
    const long long c0 = (long long)p * piece;
    if (threadIdx.x == 0)
      next[(i + 1) & 1] = tickets.fetch_add(1, cuda::memory_order_relaxed);
    copy_span(out + base + c0, x + base + c0,
              row - c0 < piece ? row - c0 : piece);
    __syncthreads();
    // A sender publishes every `publish` pieces and after its last one:
    // one gpu-scope fence for them all, then root's flag raised by their
    // count (a fence a piece held its blocks 8% behind root's, PERF.md).
    if (q != root && (++held == publish || next[(i + 1) & 1] >= pieces)) {
      if (threadIdx.x == 0) {
        cuda::atomic_thread_fence(cuda::memory_order_release,
                                  cuda::thread_scope_device);
        raise_flag(mine + kRecv, held);
      }
      held = 0;
    }
  }
  OMPI_PROBE(1);
  if (threadIdx.x != 0) return;
  // Every block has drawn its last ticket (and read the credit) before
  // it counts itself done (release); the last one (acquire) takes the
  // pool's words back to 0.
  if (Flag(mine[kDone]).fetch_add(1, cuda::memory_order_acq_rel) ==
      size - 1) {
    tickets.store(0, cuda::memory_order_relaxed);
    Flag(mine[kDone]).store(0, cuda::memory_order_relaxed);
    Flag(mine[kReady]).store(0, cuda::memory_order_relaxed);
  }
  if (q == root)
    for (int d = j + 1; d < n; d += size)
      acquire_flag(word((root + d) % n, kRecv), pieces);
  OMPI_PROBE(2);  // probe: root's block j has seen its senders' rows
}

}  // namespace ompi_ring

// x: (n, row) rank-major, root's out: (n, row), `row` bytes per rank,
// both 16-byte aligned; sems: n x 8 int32, all 0 at entry and left at 0;
// piece: bytes per piece, a multiple of 16, `pieces` per row (pieces *
// piece >= row); n pools of `pool` blocks, the first `extra` with one
// more (extra < n, pool + 1 <= pieces where extra > 0), `threads` each,
// all resident (cooperative); a sender's block publishes every `publish`
// pieces. Returns the CUDA error of the launch (0 on success).
extern "C" int ompi_linear_gather(const void* x, void* out, void* sems,
                                  int n, long long row, int root,
                                  long long piece, int pieces, int pool,
                                  int extra, int publish, int threads,
                                  int device, void* stream) {
  using namespace ompi_ring;
  if (n < 2 || root < 0 || root >= n || piece < 16 || piece & 15 ||
      pieces < 1 || (long long)pieces * piece < row || pool < 1 ||
      pool > pieces || extra < 0 || extra >= n ||
      (extra > 0 && pool + 1 > pieces) ||
      (long long)pieces + pool + 1 > 0x7fffffffLL ||
      (long long)n * pool + extra > 0x7fffffffLL || publish < 1 ||
      threads < 32 || threads > kThreads)
    return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&x, &out,   &sems,   &n,    &row,   &root,
                  &piece,    &pieces, &pool, &extra, &publish};
  return launch_cooperative((const void*)linear_gather_kernel,
                            n * pool + extra, threads, args, device, stream);
}
