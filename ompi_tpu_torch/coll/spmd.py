"""Native collectives over the rank axis (part of the port of
``ompi_tpu/coll/spmd.py``).

The JAX package writes each algorithm inside ``shard_map`` over a named
mesh axis. In the port an algorithm receives the whole rank-major
``(n, ...)`` tensor and returns the rank-major result. Ported so far:
the native allreduce, bcast, reduce, allgather, reduce-scatter,
alltoall, gather and scatter; the rank-ordered gather-reduce that the
non-commutative guard routes to; the allreduce algorithms (recursive
doubling with the non-power-of-two fold, ring, segmented ring,
Rabenseifner, nonoverlapping); the bcast (binomial, chain, pipelined,
binary), reduce (binomial, pipelined), allgather (ring, bruck) and
reduce-scatter (ring, recursive halving) algorithms; the alltoall
(pairwise, bruck), gather and scatter (binomial) algorithms the priors
pick; the prefix reductions (scan and exscan: native, recursive
doubling, linear chain) and the barrier; and the ring shift and
sendrecv that ring attention is built on.

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

from typing import Any, Optional, Sequence

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


def allgather_ring(x: torch.Tensor) -> torch.Tensor:
    """Ring allgather: n-1 single-hop forwards to the right (reference:
    coll_base_allgather.c, ..._intra_ring). (n, ...) -> (n, n, ...)."""
    n = x.shape[0]
    ranks = torch.arange(n, device=x.device)
    out = x.new_zeros((n,) + tuple(x.shape))
    out[ranks, ranks] = x
    cur = x
    for k in range(n - 1):
        cur = torch.roll(cur, 1, 0)
        out[ranks, (ranks - k - 1) % n] = cur
    return out


def allgather_bruck(x: torch.Tensor) -> torch.Tensor:
    """Bruck allgather: ceil(log2 n) rounds of doubling exchanges with
    rank-k, then a rotation into rank order (reference:
    coll_base_allgather.c, ..._intra_bruck). (n, ...) -> (n, n, ...)."""
    n = x.shape[0]
    ranks = torch.arange(n, device=x.device)
    have = x[:, None]  # rank r's row j: block (r + j) mod n
    k = 1
    while k < n:
        # the round's ppermute i -> i-k: rank r receives from rank r+k
        recv = torch.roll(have[:, :min(k, n - k)], -k, 0)
        have = torch.cat([have, recv], 1)[:, :n]
        k *= 2
    return have[ranks[:, None], (ranks[None, :] - ranks[:, None]) % n]


def _reduce_scatter_check(x: torch.Tensor) -> int:
    """n of a rank-major (n, n, ...) reduce-scatter input; the JAX
    package's refusal of a per-rank leading dim other than n."""
    n = x.shape[0]
    if x.ndim < 2 or x.shape[1] != n:
        raise ArgumentError(
            f"reduce_scatter input leading dim "
            f"{x.shape[1] if x.ndim > 1 else None} != ranks {n}")
    return n


def reduce_scatter_ring(x: torch.Tensor, op: Op) -> torch.Tensor:
    """Ring reduce-scatter, the first phase of the ring allreduce: the
    partial of block b starts at rank b+1 and travels n-1 hops to the
    right, folding ``combine(arrival, own block)`` at each rank
    (reference: coll_base_reduce_scatter.c, ..._intra_ring).
    (n, n, ...) -> (n, ...)."""
    n = _reduce_scatter_check(x)
    if n == 1:
        return x[:, 0]
    ranks = torch.arange(n, device=x.device)
    carry = x[ranks, (ranks - 1) % n]
    for k in range(n - 1):
        carry = op.combine(torch.roll(carry, 1, 0),
                           x[ranks, (ranks - k - 2) % n])
    return carry


def reduce_scatter_recursive_halving(x: torch.Tensor, op: Op
                                     ) -> torch.Tensor:
    """Recursive-halving reduce-scatter (power-of-two n, commutative
    op): log2 n rounds, round k trades half the active window with rank
    ^ n/2^(k+1) and folds ``combine(kept, received)`` (reference:
    coll_base_reduce_scatter.c, ..._intra_basic_recursivehalving).
    Other rank counts and ordered ops take the ring."""
    n = _reduce_scatter_check(x)
    if n == 1:
        return x[:, 0]
    if n & (n - 1) or not op.commutative or op.joint:
        return reduce_scatter_ring(x, op)
    ranks = torch.arange(n, device=x.device)
    buf = x.clone()
    lo = torch.zeros(n, dtype=torch.long, device=x.device)
    half = n // 2
    while half >= 1:
        keep_upper = (ranks & half) != 0
        send_lo = torch.where(keep_upper, lo, lo + half)
        keep_lo = torch.where(keep_upper, lo + half, lo)
        cols = torch.arange(half, device=x.device)
        rows = ranks[:, None]
        payload = buf[rows, send_lo[:, None] + cols]
        kept = buf[rows, keep_lo[:, None] + cols]
        buf[rows, keep_lo[:, None] + cols] = op.combine(
            kept, payload[ranks ^ half])
        lo = keep_lo
        half //= 2
    return buf[ranks, lo]


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


def _tree_map(fn, x: Any, *rest: Any) -> Any:
    """``jax.tree.map`` over a tensor or a tuple/list of tensors."""
    if isinstance(x, (tuple, list)):
        return type(x)(fn(*leaves) for leaves in zip(x, *rest))
    return fn(x, *rest)


def _leaves(x: Any) -> list:
    return list(x) if isinstance(x, (tuple, list)) else [x]


def bcast_binomial(x: Any, root: int = 0) -> Any:
    """Binomial-tree broadcast: log2(n) rounds, in round k the first 2^k
    (root-relative) ranks send to rank+2^k (reference: coll_base_bcast.c,
    ompi_coll_base_bcast_intra_binomial)."""
    n = _leaves(x)[0].shape[0]
    if n == 1:
        return x
    vrank = (torch.arange(n, device=_leaves(x)[0].device) - root) % n
    for k in range((n - 1).bit_length()):
        dist = 1 << k
        perm = [((v + root) % n, (v + dist + root) % n)
                for v in range(min(dist, n - dist))]
        takes = (vrank >= dist) & (vrank < 2 * dist)
        x = _tree_map(lambda leaf: torch.where(
            _ranks_mask(takes, leaf), _permute(leaf, perm), leaf), x)
    return x


def _chain_hops(v: torch.Tensor, vrank: torch.Tensor, perm) -> torch.Tensor:
    """n-1 single hops down the chain ``perm``: after hop h the rank at
    chain position h+1 holds what position 0 held."""
    for h in range(v.shape[0] - 1):
        v = torch.where(_ranks_mask(vrank == h + 1, v), _permute(v, perm), v)
    return v


def _chain_perm(n: int, root: int) -> list:
    return [((root + i) % n, (root + i + 1) % n) for i in range(n - 1)]


def bcast_chain(x: Any, root: int = 0) -> Any:
    """Chain broadcast: the payload hops rank to rank down the
    (root-relative) chain, n-1 single-hop rounds (reference:
    coll_base_bcast.c, ..._intra_chain with fanout 1)."""
    n = _leaves(x)[0].shape[0]
    if n == 1:
        return x
    vrank = (torch.arange(n, device=_leaves(x)[0].device) - root) % n
    perm = _chain_perm(n, root)
    return _tree_map(lambda leaf: _chain_hops(leaf, vrank, perm), x)


def _segment_leaf(leaf: torch.Tensor, segments: int):
    """Each rank's row of ``leaf`` flattened and cut at the JAX
    package's static bounds (``numpy.linspace`` over the per-rank
    element count, empty chunks dropped), plus the restore function."""
    import numpy as np

    flat = leaf.reshape(leaf.shape[0], -1)
    bounds = np.linspace(0, flat.shape[1], segments + 1).astype(int)
    chunks = [flat[:, int(a):int(b)] for a, b in zip(bounds, bounds[1:])
              if b > a]

    def restore(parts):
        return torch.cat(parts, 1).reshape(leaf.shape)

    return chunks, restore


def _auto_segments(x: Any, target_bytes: int = 64 * 1024, cap: int = 8
                   ) -> int:
    """Segments for ``x``'s bytes per rank: one per ``target_bytes``,
    between 1 and ``cap``."""
    total = sum((leaf.numel() // max(leaf.shape[0], 1)) * leaf.element_size()
                for leaf in _leaves(x))
    return int(max(1, min(cap, total // max(target_bytes, 1))))


def bcast_pipelined(x: Any, root: int = 0,
                    segments: Optional[int] = None) -> Any:
    """Pipelined (segmented-chain) broadcast: the payload splits into
    static segments, each going down the chain on its own (reference:
    coll_base_bcast.c, ..._intra_pipeline). One segment is the chain."""
    n = _leaves(x)[0].shape[0]
    if n == 1:
        return x
    segs = segments if segments else _auto_segments(x)
    if segs <= 1:
        return bcast_chain(x, root)
    vrank = (torch.arange(n, device=_leaves(x)[0].device) - root) % n
    perm = _chain_perm(n, root)

    def pipe_one(leaf):
        chunks, restore = _segment_leaf(leaf, segs)
        return restore([_chain_hops(c, vrank, perm) for c in chunks])

    return _tree_map(pipe_one, x)


def bcast_binary(x: Any, root: int = 0) -> Any:
    """Binary-tree broadcast: (root-relative) node v forwards to children
    2v+1 and 2v+2, one round per level and child side (reference:
    coll_base_bcast.c, ..._intra_bintree)."""
    n = _leaves(x)[0].shape[0]
    if n == 1:
        return x
    vrank = (torch.arange(n, device=_leaves(x)[0].device) - root) % n

    def phys(v: int) -> int:
        return (v + root) % n

    def tree_one(v):
        level_start, width = 0, 1  # first vrank and size of the level
        while level_start + width - 1 < n - 1:
            for side in (1, 2):
                perm = [(phys(s), phys(2 * s + side))
                        for s in range(level_start,
                                       min(level_start + width, n))
                        if 2 * s + side < n]
                if not perm:
                    continue
                takes_lo = 2 * level_start + 1
                takes_hi = 2 * (level_start + width - 1) + 2
                takes = ((vrank >= takes_lo) & (vrank <= takes_hi)
                         & (vrank % 2 == side % 2))
                v = torch.where(_ranks_mask(takes, v), _permute(v, perm), v)
            level_start = 2 * level_start + 1
            width = 2 * width
        return v

    return _tree_map(tree_one, x)


def reduce_pipelined(x: Any, op: Op, root: int = 0,
                     segments: Optional[int] = None) -> Any:
    """Pipelined chain reduction toward root: partials flow down the
    reverse chain, combining at every hop, in static segments. Root's
    row is x_root + (x_root+1 + (...)), rank order when root is 0, so a
    non-commutative op runs the chain there and the ordered
    gather-reduce elsewhere; a joint op always takes the gather-reduce
    (reference: coll_base_reduce.c, ..._intra_pipeline). Only root's row
    is the reduction; the others hold suffix partials."""
    n = _leaves(x)[0].shape[0]
    if n == 1:
        return x
    if op.joint or (not op.commutative and root != 0):
        return _allreduce_gather_reduce(x, op)
    vrank = (torch.arange(n, device=_leaves(x)[0].device) - root) % n
    segs = segments if segments else _auto_segments(x)
    rev = [((root + i + 1) % n, (root + i) % n) for i in range(n - 1)]

    def chain_reduce(v):
        for h in range(n - 1):
            combines = _ranks_mask(vrank == n - 2 - h, v)
            v = torch.where(combines, op.combine(v, _permute(v, rev)), v)
        return v

    def pipe_one(leaf):
        if segs <= 1:
            return chain_reduce(leaf)
        chunks, restore = _segment_leaf(leaf, segs)
        return restore([chain_reduce(c) for c in chunks])

    return _tree_map(pipe_one, x)


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


# ---------------------------------------------------------------------------
# scan / exscan / barrier
# ---------------------------------------------------------------------------

def _rows(x: Any, sl: slice) -> Any:
    """Rows ``sl`` of every leaf (views)."""
    return _tree_map(lambda leaf: leaf[sl], x)


def _associative_scan(x: Any, op: Op, out: Any = None) -> Any:
    """Inclusive prefix of x's rows in ``lax.associative_scan``'s
    combine tree, not a left fold: adjacent pairs (0,1), (2,3), ... are
    combined, the halved sequence is scanned recursively (the odd
    prefixes), and each even prefix is an odd one combined with the next
    row. The same operands meet in the same order as in the JAX
    package's scan, so the bits are its bits. A row's prefix depends on
    the rows before it alone, so the scan of x's first k rows is the
    first k rows of x's scan. ``out``, if given, receives the result."""
    n = _leaves(x)[0].shape[0]
    if n < 2:
        if out is None:
            return x
        _tree_map(lambda o, leaf: o.copy_(leaf), out, x)
        return out
    reduced = op.combine(_rows(x, slice(0, n - 1, 2)),
                         _rows(x, slice(1, None, 2)))
    odd = _associative_scan(reduced, op)
    del reduced
    last = slice(0, -1) if n % 2 == 0 else slice(None)
    even = op.combine(_rows(odd, last), _rows(x, slice(2, None, 2)))
    if out is None:
        out = _tree_map(torch.empty_like, x)

    def interleave(o, leaf, e, d):
        o[0] = leaf[0]
        o[2::2] = e
        o[1::2] = d
        return o

    _tree_map(interleave, out, x, even, odd)
    return out


def _exscan_identity(row: Any, op: Op) -> Any:
    """Rank 0's exscan block: the op's identity, or zeros when the op
    has none (MPI leaves it undefined)."""
    if op.has_identity:
        return _tree_map(op.identity_like, row)
    return _tree_map(torch.zeros_like, row)


def scan_native(x: Any, op: Op) -> Any:
    """Inclusive prefix reduction over ranks (reference: coll_base_scan.c).
    The JAX package gathers every rank's block and runs
    ``lax.associative_scan`` over the gathered rows; the rank-major
    tensor is those rows already, so the port scans it in place of the
    ``(n, n, ...)`` gather."""
    return _associative_scan(x, op)


def exscan_native(x: Any, op: Op) -> Any:
    """Exclusive prefix reduction: rank r gets row r-1 of the native
    scan, rank 0 the op's identity (zeros when it has none)."""
    n = _leaves(x)[0].shape[0]
    out = _tree_map(torch.empty_like, x)
    _tree_map(lambda o, i: o[0].copy_(i), out,
              _exscan_identity(_tree_map(lambda leaf: leaf[0], x), op))
    if n > 1:
        _associative_scan(_rows(x, slice(0, n - 1)), op,
                          out=_rows(out, slice(1, None)))
    return out


def scan_recursive_doubling(x: Any, op: Op) -> Any:
    """Inclusive prefix via recursive doubling: log2(n) rounds, round k
    combining the prefix from rank r-2^k into rank r's (associative
    order preserved, so non-commutative ops are safe). Ranks below 2^k
    keep theirs, as the ``jnp.where`` of the JAX package's round does.

    Reference: the scan recursion of coll_base_scan.c restructured to
    the log-depth doubling exchange."""

    def one(leaf):
        n = leaf.shape[0]
        acc = leaf
        k = 1
        while k < n:
            nxt = acc.clone()
            nxt[k:] = op.combine(acc[:n - k], acc[k:])
            acc = nxt
            k <<= 1
        return acc

    return _tree_map(one, x)


def scan_linear_chain(x: Any, op: Op) -> Any:
    """Inclusive prefix via the linear chain: the running prefix flows
    rank to rank, each rank folding in its own block (the reference's
    own recursion shape, coll_base_scan.c), n-1 hops."""

    def one(leaf):
        acc = leaf.clone()
        for r in range(1, leaf.shape[0]):
            acc[r] = op.combine(acc[r - 1], leaf[r])
        return acc

    return _tree_map(one, x)


def _exscan_from_inclusive(inc: Any, x: Any, op: Op) -> Any:
    """Shift an inclusive scan down one rank; rank 0 gets the op's
    identity (exscan semantics)."""
    out = _tree_map(torch.empty_like, inc)
    _tree_map(lambda o, i: o[0].copy_(i), out,
              _exscan_identity(_tree_map(lambda leaf: leaf[0], x), op))
    _tree_map(lambda o, leaf: o[1:].copy_(leaf[:-1]), out, inc)
    return out


def exscan_recursive_doubling(x: Any, op: Op) -> Any:
    """Exclusive prefix: recursive-doubling inclusive scan + one-hop
    shift (reference: coll_base_exscan.c semantics)."""
    return _exscan_from_inclusive(scan_recursive_doubling(x, op), x, op)


def exscan_linear_chain(x: Any, op: Op) -> Any:
    """Exclusive prefix via the linear chain + one-hop shift."""
    return _exscan_from_inclusive(scan_linear_chain(x, op), x, op)


def barrier(token: torch.Tensor) -> torch.Tensor:
    """The fabric barrier: a one-int32-per-rank sum over the ranks (the
    JAX package's ``lax.psum`` of a one), every rank receiving n."""
    return _broadcast_ranks(token.sum(0, dtype=token.dtype), token.shape[0])


# ---------------------------------------------------------------------------
# sendrecv / ring-shift building blocks
# ---------------------------------------------------------------------------

def ring_shift(x: Any, shift: int = 1) -> Any:
    """Every rank's row (of each leaf) moves ``shift`` ranks round the
    ring: rank r receives rank r-shift's (the ring-attention hop;
    ``lax.ppermute`` over ``(i, i+shift)`` in the JAX package)."""
    return _tree_map(lambda leaf: torch.roll(leaf, shift, 0), x)


def sendrecv(x: Any, perm: Sequence[tuple[int, int]]) -> Any:
    """Explicit (src, dst) permutation exchange of every leaf's rows; a
    rank no pair reaches receives zeros."""
    return _tree_map(lambda leaf: _permute(leaf, list(perm)), x)
