// sched_table: any schedule-compiler program that passes
// pallas_lower.analyze, on Hopper.
//
// Replaces ompi_tpu/coll/sched/pallas_lower.py:_kernel (wrapper
// _pallas_call, used by compile_schedule for sched_pallas_ring,
// sched_pallas_ring_seg, sched_pallas_rs and fused programs). Four
// (rounds, n) int32 tables name, per round and rank, the peer it sends
// to (dst), the peer it receives from (src), the chunk it sends and the
// chunk it receives into; a per-round info word holds the receive mode
// (1 reduce, 2 copy), `last` (this receive is the chunk's final value)
// and `brk` (a stage round: the chain restarts from the input). The
// tables live in device memory and the kernel loops over the rounds at
// run time, so a fused program of hundreds of rounds is one launch of
// one compiled kernel.
//
// Round r sends from slot r%2 into the receiver's slot (r+1)%2, as the
// reference does. A stage round (round 0 and every brk round) sends its
// chunk straight from the input: the reference first stores it in the
// rank's own slot, which nothing reads again before the next arrival
// overwrites it. A reduce folds op(arrival, own input chunk) and keeps
// the result in the slot only when the next round forwards it
// (reference :490-497). Outputs follow the reference (:472-479,
// :498-507): an allgather (or a window's copy segment) writes its own
// chunk at the stage round; a reduce-scatter writes its last round's
// value; a window's reduce segment its segment-final value; otherwise
// every `last` receive is written.
//
// Credits: after round r's send from slot r%2 (r = 0..rounds-2) a rank
// credits that slot to t_src[r+1][me], the rank that writes it at round
// r+1; before its own store of round r >= 1 into t_dst[r][me]'s slot
// (r+1)%2 it waits for that receiver's credit. No post-seed credit.
// Every wait meets exactly one credit, so every flag ends at 0. The
// reference's placement (post-seed credit, credit right after filling)
// lets a fast upstream overwrite a partial not yet forwarded (ROADMAP
// Queue 3). A sender counts its credits on one flag per (receiver,
// slot), where the reference has one per slot: in a program whose peers
// change between rounds (a fused window, members with different ring
// orders) a later round's receiver could otherwise satisfy an earlier
// round's wait. Each slot has its own flags: at n = 2, t_src and t_dst
// name the same peer.
//
// Bound: memory. Each round moves one chunk per rank and does one
// combine per element; time is bytes over HBM bandwidth plus one flag
// round trip per round. What the design does about it: each rank is
// striped over several thread blocks (n x stripes <= SM count, all
// resident under a cooperative launch), each stripe with its own slots
// and flags, so stripes never wait on each other and every access is
// coalesced. Like ring_allreduce, it copies a chunk into the peer's
// slot and combines it in a second pass; fusing the two is later work.
#include "ring_common.cuh"

namespace ompi_ring {

enum SchedKind { SK_ALLREDUCE = 0, SK_RS = 1, SK_AG = 2, SK_WINDOW = 3 };
// Flags per (rank, stripe): recv[2], then cap[receiver][2]; 2 + 2n in
// all.
enum SchedFlag { SF_RECV = 0, SF_CAP = 2 };
// The per-round info word.
constexpr int kModeMask = 3, kLast = 4, kBrk = 8;

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    sched_table_kernel(const T* __restrict__ x, T* __restrict__ out,
                       T* comm, int* sems, int n, int stripes,
                       const int* __restrict__ tables,
                       const int* __restrict__ info, int rounds,
                       int nchunks, long long chunk, int kind) {
  const int r = blockIdx.x / stripes;
  const int s = blockIdx.x % stripes;
  const long long sw = (chunk + stripes - 1) / stripes;
  const long long c0 = (long long)s * sw;
  const long long cw = c0 < chunk ? (chunk - c0 < sw ? chunk - c0 : sw) : 0;
  const long long plane = (long long)rounds * n;
  // tables is (4, rounds, n): dst, src, send chunk, recv chunk.
  auto tab = [&](int which, int rd) {
    return tables[which * plane + (long long)rd * n + r];
  };
  auto comm_of = [&](int rank) {
    return comm + ((long long)rank * stripes + s) * 2 * sw;
  };
  const int nsem = 2 + 2 * n;
  auto sem_of = [&](int rank) {
    return sems + (long long)(rank * stripes + s) * nsem;
  };
  T* my = comm_of(r);
  int* my_sem = sem_of(r);
  // This rank's input chunks, and its output (one chunk for a
  // reduce-scatter), at this block's column stripe.
  const T* xr = x + (long long)r * nchunks * chunk + c0;
  T* outr = out + (long long)r * (kind == SK_RS ? 1 : nchunks) * chunk + c0;

  for (int rd = 0; rd < rounds; ++rd) {
    const int slot = rd & 1, nslot = slot ^ 1;
    const int inf = info[rd];
    const int mode = inf & kModeMask;
    const bool brk = (inf & kBrk) != 0;
    const bool next_brk = rd + 1 < rounds && (info[rd + 1] & kBrk) != 0;
    const T* src = my + slot * sw;
    if (brk) {
      src = xr + (long long)tab(2, rd) * chunk;
      if (kind == SK_AG || (kind == SK_WINDOW && mode == 2)) {
        // The own chunk never travels: it is final at its stage round.
        T* os = outr + (long long)tab(2, rd) * chunk;
        for (long long j = threadIdx.x; j < cw; j += blockDim.x)
          os[j] = src[j];
      }
    }
    const int peer = tab(0, rd);
    if (rd >= 1) wait(my_sem + SF_CAP + 2 * peer + nslot, 1);
    T* dst = comm_of(peer) + nslot * sw;
    for (long long j = threadIdx.x; j < cw; j += blockDim.x)
      st_cg(dst + j, ld_cg(src + j));
    publish();
    if (threadIdx.x == 0) {
      signal(sem_of(peer) + SF_RECV + nslot, 1);
      if (rd <= rounds - 2)
        signal(sem_of(tab(1, rd + 1)) + SF_CAP + 2 * r + slot, 1);
    }
    wait(my_sem + SF_RECV + nslot, 1);

    T* arrived = my + nslot * sw;
    const long long rc = tab(3, rd);
    // Where this round's value goes, if anywhere.
    T* dest = nullptr;
    if (kind == SK_RS) {
      if (rd == rounds - 1) dest = outr;
    } else if (kind == SK_WINDOW && mode == 1) {
      if (rd == rounds - 1 || next_brk) dest = outr + rc * chunk;
    } else if (inf & kLast) {
      dest = outr + rc * chunk;
    }
    if (mode == 1) {
      // Only the next round's send reads the combined value back.
      const bool keep = rd + 1 < rounds && !next_brk;
      const T* xb = xr + rc * chunk;
      for (long long j = threadIdx.x; j < cw; j += blockDim.x) {
        const T v = Combine<T, OP>::apply(ld_cg(arrived + j), xb[j]);
        if (keep) st_cg(arrived + j, v);
        if (dest) dest[j] = v;
      }
    } else if (dest) {
      for (long long j = threadIdx.x; j < cw; j += blockDim.x)
        dest[j] = ld_cg(arrived + j);
    }
  }
}

}  // namespace ompi_ring

// x: (n, nchunks, chunk) rank-major; out: the same, or (n, chunk) for a
// reduce-scatter (for a window, pre-filled with x by the caller); comm:
// (n, stripes, 2, sw); sems: (n, stripes, 2 + 2n) int32, zeroed by the
// caller; tables: (4, rounds, n) int32; info: (rounds,) int32; kind:
// 0 allreduce, 1 reduce_scatter, 2 allgather, 3 window. Returns the
// CUDA error of the launch (0 on success).
extern "C" int ompi_sched_table(const void* x, void* out, void* comm,
                                void* sems, int n, int stripes,
                                const void* tables, const void* info,
                                int rounds, int nchunks, long long chunk,
                                int kind, int op, int dtype, int device,
                                void* stream) {
  void* args[] = {(void*)&x, &out,    &comm,   &sems,  &n,    &stripes,
                  (void*)&tables, (void*)&info, &rounds, &nchunks, &chunk,
                  &kind};
  return ompi_ring::launch_cooperative(
      OMPI_RING_PICK(ompi_ring::sched_table_kernel)(op, dtype),
      n * stripes, args, device, stream);
}
