// tree_bcast: the binomial-tree broadcast from a root on Hopper.
//
// Replaces ompi_tpu/coll/pallas_ring.py:_tree_bcast_kernel (wrapper
// tree_bcast, used by PallasColl.bcast through bcast_block). Every rank
// first copies its input into its output row. Ranks are numbered
// relative to the root, rel = (r - root) mod n. In round k a receiver
// (2^k <= rel < 2^(k+1)) signals "ready" to its sender rel - 2^k and then
// waits; a sender (rel < 2^k, rel + 2^k < n) waits for "ready", stores
// its row into the receiver's output row, publishes and signals. After
// ceil(log2 n) rounds every row holds the root's.
//
// The handshake is what makes the store safe: it lands in the row the
// receiver initialises at start, so the receiver announces that its own
// copy is done (and visible) before anyone writes there. Each round has
// its own flag pair (the reference rotates two, k % 2, to save VMEM), so
// no round's signal can satisfy another round's wait. There is no comm
// scratch: a sender stores straight into the receiver's row.
//
// Bound: bytes. The root's row is read once and n rows are written:
// (1 + n) * B bytes for B bytes per rank. What the design does about it:
// each rank is striped over n x stripes <= SM count resident thread
// blocks with their own flags, and every copy is a coalesced stream.
// Round k has 2^k senders, so early rounds leave most of the card idle;
// every rank's initial copy is extra traffic the reference has too.
#include "ring_common.cuh"

namespace ompi_ring {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tree_bcast_kernel(const T* __restrict__ x, T* out, T* /*comm*/,
                      int* sems, int n, int stripes, long long L,
                      int root) {
  const int r = blockIdx.x / stripes;
  const int s = blockIdx.x % stripes;
  const long long sw = (L + stripes - 1) / stripes;
  const long long c0 = (long long)s * sw;
  const long long cw = c0 < L ? (L - c0 < sw ? L - c0 : sw) : 0;
  const int rel = (r - root + n) % n;
  int rounds = 0;
  while ((1 << rounds) < n) ++rounds;
  // sems is (n, stripes, rounds, 2): a ready and a recv flag per round.
  auto flags = [&](int rank, int k) {
    return sems + ((rank * stripes + s) * rounds + k) * 2;
  };
  constexpr int kReady = 0, kRecv = 1;
  T* o = out + (long long)r * L + c0;

  // Rows are read by other blocks later: store them past L1.
  const T* xr = x + (long long)r * L + c0;
  for (long long j = threadIdx.x; j < cw; j += blockDim.x)
    st_cg(o + j, xr[j]);
  for (int k = 0; k < rounds; ++k) {
    const int bit = 1 << k;
    if (rel >= bit && rel < 2 * bit) {
      // My row is initialised: tell my sender it may write it.
      publish();
      if (threadIdx.x == 0) signal(flags((r - bit + n) % n, k) + kReady, 1);
      wait(flags(r, k) + kRecv, 1);
    } else if (rel < bit && rel + bit < n) {
      const int dst_rank = (r + bit) % n;
      wait(flags(r, k) + kReady, 1);
      T* dst = out + (long long)dst_rank * L + c0;
      for (long long j = threadIdx.x; j < cw; j += blockDim.x)
        st_cg(dst + j, ld_cg(o + j));
      publish();
      if (threadIdx.x == 0) signal(flags(dst_rank, k) + kRecv, 1);
    }
  }
}

}  // namespace ompi_ring

// x, out: (n, L) rank-major; comm: unused (no scratch); sems: (n,
// stripes, rounds, 2) int32, zeroed by the caller. Returns the CUDA
// error of the launch (0 on success).
extern "C" int ompi_tree_bcast(const void* x, void* out, void* comm,
                               void* sems, int n, int stripes, long long L,
                               int root, int dtype, int device,
                               void* stream) {
  void* args[] = {(void*)&x, &out, &comm, &sems, &n, &stripes, &L, &root};
  return ompi_ring::launch_cooperative(
      OMPI_DTYPE_PICK(ompi_ring::tree_bcast_kernel)(dtype),
      n * stripes, args, device, stream);
}
