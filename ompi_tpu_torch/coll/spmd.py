"""Native collectives over the rank axis (part of the port of
``ompi_tpu/coll/spmd.py``).

The JAX package writes each algorithm inside ``shard_map`` over a named
mesh axis. In the port an algorithm receives the whole rank-major
``(n, ...)`` tensor and returns the rank-major result. Ported so far:
the native allreduce, bcast, reduce, allgather, reduce-scatter,
alltoall, gather and scatter; the rank-ordered gather-reduce that the
non-commutative guard routes to; the allreduce algorithms (recursive
doubling with the non-power-of-two fold, ring, segmented ring,
Rabenseifner, nonoverlapping) and the binomial reduce; and the alltoall
(pairwise, bruck), gather and scatter (binomial) algorithms the priors
pick.

The round-based algorithms keep the JAX package's rounds and fold
order: a ``ppermute`` there becomes a roll or an index over the rank
axis here, one round at a time (a rank the permutation does not reach
receives zeros, as from ``lax.ppermute``), and a ``jnp.where`` over
the rank index a ``torch.where`` over a rank mask. Elementwise combines
in the same order give the JAX package's bits.

Two conventions differ from the JAX package, where an algorithm returns
every rank's view: a gather algorithm returns root's gathered ``(n,
...)`` rows alone (the only rows MPI defines), and a scatter algorithm
takes root's ``(n, ...)`` buffer alone (the JAX package stages it on
every rank, and reads only root's copy).
"""

from __future__ import annotations

from typing import Any

import torch

from ..core.errors import ArgumentError
from ..ops import Op


def _ranks_mask(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-rank (n,) bool mask shaped to broadcast over x's rows."""
    return mask.view((-1,) + (1,) * (x.ndim - 1))


def _permute(x: torch.Tensor, perm) -> torch.Tensor:
    """``lax.ppermute`` over the rank axis: row d of the result is row s
    of x for each (s, d) pair of ``perm``; rows no pair reaches are
    zeros."""
    out = torch.zeros_like(x)
    if perm:
        src, dst = zip(*perm)
        out[list(dst)] = x[list(src)]
    return out


def _broadcast_ranks(red: torch.Tensor, n: int) -> torch.Tensor:
    return red.unsqueeze(0).expand((n,) + tuple(red.shape)).contiguous()


def _reduce_ranks(x: torch.Tensor, op: Op) -> torch.Tensor:
    """x reduced over its leading rank axis: PyTorch's own reduction
    where the op has one (SUM/MAX/MIN), else the rank-ordered tree."""
    if op.native_reduce is None:
        return _tree_reduce_ranks(x, x.shape[0], op)
    if op.native_reduce == "sum":
        return torch.sum(x, 0, dtype=x.dtype)
    return getattr(torch, op.native_reduce)(x, 0)


def allreduce_native(x: torch.Tensor, op: Op) -> torch.Tensor:
    """PyTorch's own reduction over the rank axis where the op has one
    (SUM/MAX/MIN), else the rank-ordered gather-reduce. The JAX package
    leaves this to XLA's psum/pmax/pmin; its summation order is XLA's,
    and this one is PyTorch's."""
    if op.native_reduce is None:
        return _allreduce_gather_reduce(x, op)  # tensor or joint pair
    return _broadcast_ranks(_reduce_ranks(x, op), x.shape[0])


def bcast_native(x: Any, root: int = 0) -> Any:
    """Every rank gets root's row (of each leaf). The JAX package masks
    the other ranks to zero and sums, so a root ``-0.0`` arrives there as
    ``+0.0``; here root's row is copied as it is."""
    if isinstance(x, (tuple, list)):
        return type(x)(bcast_native(leaf, root) for leaf in x)
    return _broadcast_ranks(x[root], x.shape[0])


def reduce_native(x: torch.Tensor, op: Op, root: int = 0) -> torch.Tensor:
    """Reduce via the native allreduce (every rank computes; root
    reads)."""
    del root
    return allreduce_native(x, op)


def allgather_native(x: torch.Tensor) -> torch.Tensor:
    """(n, ...) -> (n, n, ...): every rank gets every rank's block."""
    return _broadcast_ranks(x, x.shape[0])


def reduce_scatter_native(x: torch.Tensor, op: Op) -> torch.Tensor:
    """(n, n, ...) -> (n, ...): rank r gets block r reduced over the
    ranks, by the same reduction as ``allreduce_native``."""
    return _reduce_ranks(x, op)


def _allreduce_gather_reduce(x: Any, op: Op) -> Any:
    """Gather every rank's block, then a rank-order-preserving tree
    reduce (valid for non-commutative and joint ops)."""
    if isinstance(x, (tuple, list)):
        n = x[0].shape[0]
        red = _tree_reduce_ranks(x, n, op)
        return type(x)(_broadcast_ranks(r, n) for r in red)
    n = x.shape[0]
    return _broadcast_ranks(_tree_reduce_ranks(x, n, op), n)


def _flatten_pad(x: torch.Tensor, n: int) -> tuple[torch.Tensor, int]:
    """Each rank's row raveled and zero-padded so its element count
    divides n: (ranks, padded) and the unpadded per-rank count."""
    flat = x.reshape(x.shape[0], -1)
    total = flat.shape[1]
    padded = ((total + n - 1) // n) * n
    if padded != total:
        flat = torch.nn.functional.pad(flat, (0, padded - total))
    return flat, total


def _unflatten(flat: torch.Tensor, total: int, like: torch.Tensor
               ) -> torch.Tensor:
    return flat.reshape(flat.shape[0], -1)[:, :total].reshape(
        like.shape).contiguous()


def allreduce_recursive_doubling(x: torch.Tensor, op: Op) -> torch.Tensor:
    """Butterfly exchange, log2(n) rounds of full-buffer exchanges
    (reference: coll_base_allreduce.c:130). Non-power-of-two rank
    counts fold the first 2·rem ranks pairwise before the butterfly and
    unfold after it. Non-commutative and joint ops take the ordered
    gather-reduce."""
    n = x.shape[0]
    if n == 1:
        return x
    if not op.commutative or op.joint:
        return _allreduce_gather_reduce(x, op)
    pof2 = 1 << (n.bit_length() - 1)
    rem = n - pof2
    rank = torch.arange(n, device=x.device)
    if rem > 0:
        # Fold: even ranks among the first 2*rem send to rank+1, which
        # combines. Ranks >= 2*rem are unaffected.
        recv = _permute(x, [(2 * i, 2 * i + 1) for i in range(rem)])
        is_odd_low = (rank < 2 * rem) & (rank % 2 == 1)
        x = torch.where(_ranks_mask(is_odd_low, x), op.combine(recv, x), x)
        # Active ranks: odd ranks < 2*rem (relabeled i//2) and ranks
        # >= 2*rem (relabeled rank - rem).
        active = _ranks_mask(is_odd_low | (rank >= 2 * rem), x)

        def phys(newrank: int) -> int:
            return 2 * newrank + 1 if newrank < rem else newrank + rem

        for k in range(pof2.bit_length() - 1):
            dist = 1 << k
            recv = _permute(x, [(phys(nr), phys(nr ^ dist))
                                for nr in range(pof2)])
            x = torch.where(active, op.combine(x, recv), x)
        # Unfold: odd low ranks send the result back to rank-1.
        recv = _permute(x, [(2 * i + 1, 2 * i) for i in range(rem)])
        is_even_low = (rank < 2 * rem) & (rank % 2 == 0)
        return torch.where(_ranks_mask(is_even_low, x), recv, x)
    for k in range(n.bit_length() - 1):
        x = op.combine(x, x[rank ^ (1 << k)])
    return x


def allreduce_ring(x: torch.Tensor, op: Op) -> torch.Tensor:
    """Bandwidth-optimal ring: n-1 reduce-scatter steps, then n-1
    allgather steps, each moving a 1/n block one rank to the right
    (reference: coll_base_allreduce.c:341). After the first phase rank
    i holds the full reduction of block (i+1) mod n."""
    n = x.shape[0]
    if n == 1:
        return x
    rank = torch.arange(n, device=x.device)
    flat, total = _flatten_pad(x, n)
    blocks = flat.reshape(n, n, -1)
    carry = blocks[rank, rank]
    for k in range(n - 1):
        # ppermute i -> i+1: rank i receives rank i-1's carry
        carry = op.combine(torch.roll(carry, 1, 0),
                           blocks[rank, (rank - k - 1) % n])
    out = torch.zeros_like(blocks)
    out[rank, (rank + 1) % n] = carry
    cur = carry
    for k in range(n - 1):
        cur = torch.roll(cur, 1, 0)
        out[rank, (rank - k) % n] = cur
    return _unflatten(out, total, x)


def allreduce_ring_segmented(x: torch.Tensor, op: Op,
                             segment_elems: int = 0) -> torch.Tensor:
    """Segmented ring: each rank's buffer is cut into segments of
    ``segment_elems`` that go round the ring one after another
    (reference: coll_base_allreduce.c:618). With ``segment_elems`` 0, or
    a buffer no larger, it is the ring."""
    n = x.shape[0]
    if n == 1:
        return x
    flat = x.reshape(n, -1)
    total = flat.shape[1]
    if segment_elems <= 0 or total <= segment_elems:
        return allreduce_ring(x, op)
    pieces = [allreduce_ring(flat[:, s:s + segment_elems], op)
              for s in range(0, total, segment_elems)]
    return torch.cat(pieces, 1).reshape(x.shape)


def allreduce_reduce_scatter_allgather(x: torch.Tensor, op: Op
                                       ) -> torch.Tensor:
    """Rabenseifner: recursive-halving reduce-scatter, then a
    recursive-doubling allgather (reference: coll_base_allreduce.c:970).
    Power-of-two rank counts; the ring otherwise, as in the JAX
    package."""
    n = x.shape[0]
    if n == 1:
        return x
    if n & (n - 1):
        return allreduce_ring(x, op)
    rank = torch.arange(n, device=x.device)
    flat, total = _flatten_pad(x, n)
    cur = flat.reshape(n, n, -1)  # each rank's partials of its range
    cnt = n
    while cnt > 1:
        # Keep the half holding my own block index; trade partials for
        # the other half with partner rank ^ half.
        half = cnt // 2
        upper = _ranks_mask((rank & half) != 0, cur)
        lo, hi = cur[:, :half], cur[:, half:]
        send = torch.where(upper, lo, hi)
        cur = op.combine(torch.where(upper, hi, lo), send[rank ^ half])
        cnt = half
    have = cur  # (n, 1, m): the reduced block whose index is the rank
    k = 1
    while k < n:
        # Ranges merge back: an upper partner's range goes first.
        recv = have[rank ^ k]
        upper = _ranks_mask((rank & k) != 0, have)
        have = torch.where(upper, torch.cat([recv, have], 1),
                           torch.cat([have, recv], 1))
        k *= 2
    return _unflatten(have, total, x)


def allreduce_nonoverlapping(x: torch.Tensor, op: Op, root: int = 0
                             ) -> torch.Tensor:
    """Reduce to root, then broadcast (reference:
    coll_base_allreduce.c:53). The broadcast masks the other ranks to
    zero and sums over the rank axis, as the JAX package's
    ``bcast_native`` does, so a ``-0.0`` at root arrives as ``+0.0``."""
    red = reduce_binomial(x, op, root=root)
    n = red.shape[0]
    is_root = torch.arange(n, device=red.device) == root
    contrib = torch.where(_ranks_mask(is_root, red), red,
                          torch.zeros((), dtype=red.dtype, device=red.device))
    return _broadcast_ranks(torch.sum(contrib, 0, dtype=red.dtype), n)


def reduce_binomial(x: torch.Tensor, op: Op, root: int = 0
                    ) -> torch.Tensor:
    """Binomial-tree reduction to root (reference: coll_base_reduce.c,
    ompi_coll_base_reduce_intra_binomial): in round k the root-relative
    ranks that are odd multiples of 2^k send their accumulated subtree
    to vrank-2^k, which folds ``combine(own, arrival)``. Row ``root``
    is the reduction; the other rows hold partials. Non-commutative and
    joint ops take the ordered gather-reduce."""
    n = x.shape[0]
    if n == 1:
        return x
    if not op.commutative or op.joint:
        return _allreduce_gather_reduce(x, op)
    vrank = (torch.arange(n, device=x.device) - root) % n
    for k in range((n - 1).bit_length()):
        mask = 1 << k
        recv = _permute(x, [((vr + mask + root) % n, (vr + root) % n)
                            for vr in range(0, n, 2 * mask)
                            if vr + mask < n])
        receives = (vrank % (2 * mask) == 0) & (vrank + mask < n)
        x = torch.where(_ranks_mask(receives, x), op.combine(x, recv), x)
    return x


def _tree_reduce_ranks(gathered: Any, n: int, op: Op) -> Any:
    """Reduce a leading rank axis with a balanced tree that preserves
    rank order: pairs (0,1), (2,3), ... then pairs of pairs."""
    if isinstance(gathered, (tuple, list)):
        parts = [type(gathered)(g[i] for g in gathered) for i in range(n)]
    else:
        parts = [gathered[i] for i in range(n)]
    while len(parts) > 1:
        nxt = [op.combine(parts[i], parts[i + 1])
               for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


# ---------------------------------------------------------------------------
# alltoall / gather / scatter
# ---------------------------------------------------------------------------

def _alltoall_check(x: torch.Tensor) -> int:
    n = x.shape[0]
    if x.ndim < 2 or x.shape[1] != n:
        raise ArgumentError(
            f"alltoall input must be (ranks, ranks, ...), got "
            f"{tuple(x.shape)}")
    return n


def alltoall_native(x: torch.Tensor) -> torch.Tensor:
    """(n, n, ...) -> (n, n, ...): rank r's row s is rank s's block for
    rank r (the JAX package's ``lax.all_to_all``)."""
    _alltoall_check(x)
    return x.transpose(0, 1).contiguous()


def alltoall_pairwise(x: torch.Tensor) -> torch.Tensor:
    """Pairwise-exchange alltoall: n-1 rounds, in round k every rank
    sends its block for rank+k straight there — the large-message
    algorithm (reference: coll_base_alltoall.c, ..._intra_pairwise)."""
    n = _alltoall_check(x)
    ranks = torch.arange(n, device=x.device)
    out = torch.zeros_like(x)
    out[ranks, ranks] = x[ranks, ranks]
    for k in range(1, n):
        payload = x[ranks, (ranks + k) % n]
        # the round's ppermute i -> i+k: rank i receives from rank i-k
        out[ranks, (ranks - k) % n] = torch.roll(payload, k, 0)
    return out


def alltoall_bruck(x: torch.Tensor) -> torch.Tensor:
    """Bruck alltoall: a local rotation, ceil(log2 n) rounds of
    bit-indexed block exchanges with rank+2^k, and the inverse rotation
    — the small-message algorithm (reference: coll_base_alltoall.c,
    ..._intra_bruck)."""
    n = _alltoall_check(x)
    ranks = torch.arange(n, device=x.device)
    r, j = ranks[:, None], ranks[None, :]
    # Phase 1: rank r's block j is its block for rank r + j.
    cur = x[r, (r + j) % n]
    k = 1
    while k < n:
        # Phase 2: blocks whose index has bit k set go to rank + k.
        mask = ((ranks & k) != 0).view((1, n) + (1,) * (x.ndim - 2))
        cur = torch.where(mask, torch.roll(cur, k, 0), cur)
        k *= 2
    # Phase 3: rank r's block s came from rank r - s.
    return cur[r, (r - j) % n]


def gather_native(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """Root's rows of the gather. The JAX package runs an allgather and
    root reads its copy; every rank's copy of the allgather is x, so
    only root's is built here (1/n of the allgather's memory)."""
    del root
    return x.clone()


def scatter_native(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """Root's (n, ...) buffer -> rank-major (n, ...): rank r takes row r.
    The JAX package broadcasts root's staged copy by a root-masked psum
    first (a root ``-0.0`` arrives there as ``+0.0``); here each row is
    copied as it is."""
    del root
    return x.clone()


def _pow2_rows(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else 1


def gather_binomial(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """Binomial-tree gather to root: in round k the root-relative ranks
    that are odd multiples of 2^k forward their accumulated 2^k-row
    subtree slab to vrank-2^k (reference: coll_base_gather.c,
    ompi_coll_base_gather_intra_binomial). Every rank keeps its own
    accumulator, padded to a power of two of rows as in the JAX
    package; returns root's, in rank order."""
    n = x.shape[0]
    if n == 1:
        return x.clone()
    ranks = torch.arange(n, device=x.device)
    vrank = (ranks - root) % n
    acc = x.new_zeros((n, _pow2_rows(n)) + tuple(x.shape[1:]))
    acc[ranks, vrank] = x
    for k in range((n - 1).bit_length()):
        blk = 1 << k
        for vr in range(blk, n, 2 * blk):
            # the round's ppermute: vrank vr -> vr - blk, slab [vr, vr+blk)
            src, dst = (vr + root) % n, (vr - blk + root) % n
            acc[dst, vr:vr + blk] = acc[src, vr:vr + blk]
    return acc[root, vrank]


def scatter_binomial(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """Binomial-tree scatter from root, the gather tree in reverse: from
    the widest slab down, in round k every holder of a 2^(k+1)-row slab
    forwards its upper 2^k rows to vrank+2^k (reference:
    coll_base_scatter.c, ompi_coll_base_scatter_intra_binomial). Takes
    root's (n, ...) buffer; every rank's buffer is rotated into vrank
    space and padded to a power of two of rows, as in the JAX package.
    Returns rank-major (n, ...), rank r holding row r."""
    n = x.shape[0]
    if n == 1:
        return x.clone()
    ranks = torch.arange(n, device=x.device)
    vrank = (ranks - root) % n
    np2 = _pow2_rows(n)
    buf = x.new_zeros((n, np2) + tuple(x.shape[1:]))
    # only root's staged copy is ever read
    buf[root] = x[(torch.arange(np2, device=x.device) + root) % n]
    for k in reversed(range((n - 1).bit_length())):
        blk = 1 << k
        for vr in range(0, n - blk, 2 * blk):
            # the round's ppermute: vrank vr -> vr + blk, its upper slab
            src, dst = (vr + root) % n, (vr + blk + root) % n
            buf[dst, vr + blk:vr + 2 * blk] = buf[src, vr + blk:vr + 2 * blk]
    return buf[ranks, vrank]
