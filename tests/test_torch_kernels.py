"""The port's sixteen CUDA kernels on a card, each against its plain
version: ring_allreduce, ring_allreduce_rd, ring_allreduce_chunked,
ring_reduce_scatter, ring_allgather, tree_reduce, tree_bcast,
ring_allreduce_bidir, ring_alltoall, linear_gather, linear_scatter,
sched_table (the schedule compiler's table-driven kernel, on ring,
segmented, reduce-scatter, allgather, fused and window programs),
selfdma_chunked (the one-rank chunked identity), quant_allreduce
(the ring over the int8 wire), ppermute_shift (one ring hop) and
ring_attention (exact attention over the ring).

Marked ``gpu``: without a CUDA card every test here skips with a reason
(the kernels have no CPU mode; their plain versions are tested on the
CPU in test_torch_pallas_ring.py and test_torch_colls.py). This file
imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Tolerance: bitwise. The kernels run the same schedule as the plain
versions, combining in the same order. Each launch adds exactly one to
its kernel's count and leaves every flag at 0. ring_attention alone
folds its keys in tiles with an online softmax inside each step, where
the plain version folds each step's block whole: it is held to the JAX
package's 2e-4 for float32 (TF32 off) and to one output ulp for
bfloat16 and float16 (both round one float32 result once), and is
bitwise equal to itself from launch to launch.
"""

import numpy as np
import pytest
import torch

from ompi_tpu_torch.coll import pallas_attn as pa
from ompi_tpu_torch.coll import pallas_ring as pr
from ompi_tpu_torch.coll import quant
from ompi_tpu_torch.coll.sched import ir
from ompi_tpu_torch.coll.sched import pallas_lower as pl
from ompi_tpu_torch.core.errors import ArgumentError

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "int32": torch.int32}
# The reduction kernels' seven element types (pallas_ring._DTYPE_CODES).
RDT = dict(TDT, float64=torch.float64, float16=torch.float16,
           int8=torch.int8, uint8=torch.uint8)
OPS = ("sum", "max", "min", "prod")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _input(n, elems, dtype, device):
    """Seeded inputs: int32 in [-1000, 1000), int8 and uint8 over their
    whole range (SUM and PROD wrap), normal floats (float64 drawn in
    float64, the others in float32 and rounded)."""
    rng = np.random.default_rng(9)
    if dtype in ("int8", "uint8"):
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max + 1, (n, elems)).astype(dtype)
    elif dtype == "int32":
        x = rng.integers(-1000, 1000, (n, elems)).astype(np.int32)
    elif dtype == "float64":
        x = rng.standard_normal((n, elems))
    else:
        x = rng.standard_normal((n, elems)).astype(np.float32)
    return torch.from_numpy(x).to(RDT[dtype]).to(device)


def _bits(t):
    """Floats as the integers of their bits: equal means bitwise equal."""
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


TIERS = {
    "ring": (pr.allreduce_block, {"ring": pr.ring_allreduce_plain}, pr.RING),
    "chunked": (lambda b, op, **kw: pr.allreduce_block_chunked(
        b, op, 4096, **kw), {"chunked": pr.ring_allreduce_chunked_plain},
        pr.CHUNKED),
    "rd": (pr.allreduce_block_rd, {"rd": pr.ring_allreduce_rd_plain}, pr.RD),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(RDT))
@pytest.mark.parametrize("tier,n", [("ring", 3), ("chunked", 3), ("rd", 8),
                                    ("ring", 8), ("chunked", 2)])
def test_kernel_matches_plain_on_card(cuda, tier, n, dtype):
    x = _input(n, 5000, dtype, cuda)
    fn, plain_kw, counter = TIERS[tier]
    for op in ("sum", "max", "min", "prod"):
        before = counter.launches
        got = fn(x, op)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        assert int(counter.last_sems.abs().sum()) == 0
        want = fn(x, op, **plain_kw)
        assert torch.equal(_bits(got), _bits(want)), (tier, n, dtype, op)


def _launched_once(counter, run):
    """run() on the card: one launch of the counter's kernel, flags 0."""
    before = counter.launches
    got = run()
    torch.cuda.synchronize()
    assert counter.launches == before + 1, counter.name
    assert int(counter.last_sems.abs().sum()) == 0, counter.name
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(RDT))
@pytest.mark.parametrize("n", [2, 3, 8])
def test_ring_halves_match_plain_on_card(cuda, n, dtype):
    x = _input(n, n * 700, dtype, cuda).reshape(n, n, 700)  # ragged lanes
    for op in OPS:
        got = _launched_once(pr.RS, lambda: pr.reduce_scatter_block(x, op))
        want = pr.reduce_scatter_block(x, op, rs=pr.ring_reduce_scatter_plain)
        assert torch.equal(_bits(got), _bits(want)), (n, dtype, op)
    own = x[:, 0]
    got = _launched_once(pr.AG, lambda: pr.allgather_block(own))
    want = pr.allgather_block(own, ag=pr.ring_allgather_plain)
    assert torch.equal(_bits(got), _bits(want)) and torch.equal(got[n - 1], own)
    flat = x.reshape(n, -1)
    for op in OPS:
        # the two halves fold every element in the ring's order
        assert torch.equal(_bits(pr.allreduce_block_rsag(flat, op)),
                           _bits(pr.allreduce_block(flat, op))), (n, op)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(RDT))
@pytest.mark.parametrize("n", [2, 3, 8])
def test_trees_match_plain_on_card(cuda, n, dtype):
    x = _input(n, 5000, dtype, cuda)
    for root in (0, n - 1):
        for op in OPS:
            got = _launched_once(pr.TREE_REDUCE,
                                 lambda: pr.reduce_block(x, op, root))
            want = pr.reduce_block(x, op, root, tree=pr.tree_reduce_plain)
            assert torch.equal(_bits(got), _bits(want)), (n, dtype, op, root)
        got = _launched_once(pr.TREE_BCAST, lambda: pr.bcast_block(x, root))
        assert torch.equal(_bits(got), _bits(x[root].expand_as(x)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(RDT))
@pytest.mark.parametrize("n", [2, 3, 8])
def test_redesigned_kernels_match_plain_at_several_segments(cuda, n, dtype):
    """The fold-then-forward ring over several stripes, the last ragged,
    and on blocks that are not whole 16-byte vectors; the segmented tree
    over four segments, the last ragged: bitwise their plain versions."""
    x = _input(n, n * (3 * pr.STRIPE_COLS + 1000) + 7, dtype, cuda)
    blocks = _input(n, n * 1001, dtype, cuda).reshape(n, n, 1001)
    y = _input(n, 3 * pr.TREE_SEG_COLS + 5000, dtype, cuda)
    for op in OPS:
        got = _launched_once(pr.RING, lambda: pr.allreduce_block(x, op))
        want = pr.allreduce_block(x, op, ring=pr.ring_allreduce_plain)
        assert torch.equal(_bits(got), _bits(want)), (n, dtype, op)
        got = _launched_once(pr.RING, lambda: pr.ring_allreduce(blocks, op))
        want = pr.ring_allreduce_plain(blocks, op)
        assert torch.equal(_bits(got), _bits(want)), (n, dtype, op, 1001)
        for root in (0, n - 1):
            got = _launched_once(pr.TREE_REDUCE,
                                 lambda: pr.reduce_block(y, op, root))
            want = pr.reduce_block(y, op, root, tree=pr.tree_reduce_plain)
            assert torch.equal(_bits(got), _bits(want)), (n, dtype, op, root)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(RDT))
@pytest.mark.parametrize("n", [2, 3, 8, 12])
def test_bcast_and_reduce_scatter_match_plain_at_several_segments(cuda, n,
                                                                  dtype):
    """The segmented bcast over four segments, the last ragged, at roots
    0 and n - 1; the reduce-scatter wavefront at ragged blocks of fewer
    segments than its n - 1 steps and of many, with the plan's stripes
    and with three, its buffers where the plan puts them (a cluster's
    shared memory up to n = 8, L2 at n = 12) and in L2: bitwise their
    plain versions, every flag at 0."""
    elem = RDT[dtype].itemsize
    y = _input(n, 3 * pr.BCAST_SEG_BYTES // elem + 5000, dtype, cuda)
    for root in (0, n - 1):
        got = _launched_once(pr.TREE_BCAST, lambda: pr.tree_bcast(y, root))
        assert torch.equal(_bits(got), _bits(y[root].expand_as(y)))
        assert torch.equal(_bits(got), _bits(pr.tree_bcast_plain(y, root)))
    seg = pr.RS_SEG_BYTES // elem
    for C in (3 * seg - 100, 40 * seg + 77):
        x = _input(n, n * C, dtype, cuda).reshape(n, n, C)
        for op in OPS:
            want = pr.ring_reduce_scatter_plain(x, op)
            for stripes in (None, 3):
                for cluster in (None, False):
                    got = _launched_once(pr.RS, lambda: pr._rs_launch(
                        x, op, stripes=stripes, cluster=cluster))
                    assert torch.equal(_bits(got), _bits(want)), \
                        (n, C, op, stripes, cluster)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(RDT))
@pytest.mark.parametrize("n", [2, 3, 8, 12])
def test_allgather_matches_plain_at_several_segments(cuda, n, dtype):
    """The allgather's wavefront at ragged blocks of fewer segments than
    its n - 1 steps and of many, with the plan's stripes and with one,
    its buffers where the plan puts them (a cluster's shared memory up to
    n = 8, L2 at n = 12) and in L2: bitwise its plain version and every
    rank's block, every flag at 0. It copies bytes: any dtype."""
    elem = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    seg = pr.AG_SEG_BYTES // elem
    for C in (3 * seg - 100, 40 * seg + 77):
        x = _input(n, C, "int32", cuda).to(getattr(torch, dtype))
        want = pr.ring_allgather_plain(x)
        assert torch.equal(want, x.unsqueeze(0).expand(n, n, C))
        for stripes in (None, 1):
            for cluster in (None, False):
                got = _launched_once(pr.AG, lambda: pr._ag_launch(
                    x, stripes=stripes, cluster=cluster))
                assert pr.AG.last_plan["buffers"] == (
                    "cluster shared memory" if n <= 8 and cluster is None
                    else "L2")
                assert torch.equal(got, want), (n, C, stripes, cluster)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(RDT))
@pytest.mark.parametrize("n", [2, 3, 8, 12])
def test_chunked_matches_plain_at_several_plans(cuda, n, dtype):
    """The chunked ring's wavefront at ragged blocks of fewer segments
    than its 2(n-1) steps and of many, with the plan's stripes and with
    one, its buffers where the plan puts them (a cluster's shared memory
    up to n = 8, L2 at n = 12) and in L2: bitwise its plain version,
    every flag at 0."""
    seg = pr.CHUNKED_CLUSTER_SEG_BYTES // RDT[dtype].itemsize
    for W in (3 * seg - 40, 40 * seg + 77):
        x = _input(n, n * W, dtype, cuda).reshape(n, n, W)
        for op in OPS:
            want = pr.ring_allreduce_chunked_plain(x, op, W)
            for stripes in (None, 1):
                for cluster in (None, False):
                    got = _launched_once(pr.CHUNKED, lambda: pr._chunked_launch(
                        x, op, stripes=stripes, cluster=cluster))
                    assert pr.CHUNKED.last_plan["buffers"] == (
                        "cluster shared memory" if n <= 8 and cluster is None
                        else "L2")
                    assert torch.equal(_bits(got), _bits(want)), \
                        (n, W, op, stripes, cluster)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(RDT))
@pytest.mark.parametrize("n", [2, 3, 8, 12])
def test_scatter_matches_plain_at_several_plans(cuda, n, dtype):
    """The scatter's pieces at rows that are not whole 16-byte vectors
    (the ragged head and tail copied byte by byte inside the kernel), at
    the plan's pieces and at 16 and 48 bytes, on a view that does not
    start at a row: bitwise its plain version and root's buffer, every
    flag at 0. It copies bytes: any dtype."""
    for cols in (333, 70001):
        x = _input(n, cols + 1, "int32", cuda).to(getattr(torch, dtype))
        for buf in (x[:, :cols], x[:, 1:]):
            want = pr.linear_scatter_plain(buf, 0)
            assert torch.equal(want, buf)
            for root in (0, n - 1):
                for piece in (None, 16, 48):
                    got = _launched_once(pr.SCATTER, lambda: pr._scatter_launch(
                        buf, root, piece))
                    assert pr.SCATTER.last_plan["receivers"] == n - 1
                    assert torch.equal(got, want), (cols, root, piece)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(RDT))
@pytest.mark.parametrize("n", [2, 3, 8, 12])
def test_gather_matches_plain_at_several_plans(cuda, n, dtype):
    """The gather's pools at rows that are not whole 16-byte vectors (the
    ragged head and tail copied byte by byte inside the kernel), at the
    plan's pieces and pools, at 16- and 48-byte pieces, and at one and
    four blocks a SM (pools of other sizes, unequal at n = 3 and 8 over
    132 SMs), publishing every piece, every third and the plan's, on a
    view that does not start at a row: bitwise its plain
    version and the input rows, every flag at 0. It copies bytes: any
    dtype."""
    plans = ((None, None, None), (16, None, 1), (48, 1, 3), (4096, 4, None))
    for cols in (333, 70001):
        x = _input(n, cols + 1, "int32", cuda).to(getattr(torch, dtype))
        for flat in (x[:, :cols], x[:, 1:]):
            for root in (0, n - 1):
                want = pr.linear_gather_plain(flat, root)
                assert torch.equal(want, flat)
                for piece, per_sm, publish in plans:
                    got = _launched_once(pr.GATHER, lambda: pr._gather_launch(
                        flat, root, piece, per_sm=per_sm, publish=publish))
                    plan = pr.GATHER.last_plan
                    assert plan["blocks"] >= n and plan["pool_blocks"] >= 1
                    assert torch.equal(got, want), (cols, root, piece, per_sm)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(RDT))
@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_rd_forms_match_plain_on_card(cuda, n, dtype):
    """Recursive doubling in the plan's form (a cluster's shared memory
    up to 8 ranks, global memory beyond), at other stripes of the cluster
    form, and in the L2 form forced, at rows the 16-byte vectors pad and
    at the tier's sizes: bitwise the plain version, every flag at 0."""
    for elems in (33, 1000, 2500, 70001):
        x = _input(n, elems, dtype, cuda)
        for op in OPS:
            want = pr.ring_allreduce_rd_plain(x, op)
            forms = [(None, None), (False, None)]
            if n <= pr.RS_CLUSTER_RANKS:
                forms += [(True, 64), (True, 4096)]
            for cluster, stripe in forms:
                got = _launched_once(pr.RD, lambda: pr._rd_launch(
                    x, op, cluster=cluster, stripe_bytes=stripe))
                form = pr.RD.last_plan["form"]
                assert form == ("cluster" if cluster is not False
                                and n <= pr.RS_CLUSTER_RANKS else "l2")
                assert torch.equal(_bits(got), _bits(want)), (elems, op,
                                                              cluster, stripe)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["ring", "tree", "bcast", "rs", "rs-l2",
                                    "ag", "ag-l2", "chunked", "chunked-l2",
                                    "scatter", "gather", "rd", "rd-l2",
                                    "quant", "quant-l2", "hop", "hop-flags",
                                    "alltoall"])
def test_redesigned_kernels_give_the_same_bits_over_50_launches(cuda,
                                                                kernel):
    """50 back-to-back launches at n = 8 give the same bits, every flag
    back at 0 after each: a race on a slot or a segment flag would
    show."""
    if kernel == "ring":
        x = _input(8, 8 * 8 * pr.STRIPE_COLS, "float32", cuda)
        run, counter = (lambda: pr.allreduce_block(x, "sum")), pr.RING
    elif kernel == "tree":
        x = _input(8, 3 * pr.TREE_SEG_COLS + 5000, "float32", cuda)
        run, counter = (lambda: pr.reduce_block(x, "sum", 3)), \
            pr.TREE_REDUCE
    elif kernel == "bcast":
        x = _input(8, 3 * pr.BCAST_SEG_BYTES // 4 + 5000, "float32", cuda)
        run, counter = (lambda: pr.tree_bcast(x, 3)), pr.TREE_BCAST
    elif kernel.startswith("chunked"):  # in shared memory, or in L2
        W = 40 * pr.CHUNKED_CLUSTER_SEG_BYTES // 4 + 77
        x = _input(8, 8 * W, "float32", cuda).reshape(8, 8, W)
        cluster = kernel == "chunked"
        run, counter = (lambda: pr._chunked_launch(x, "sum",
                                                   cluster=cluster)), \
            pr.CHUNKED
    elif kernel == "scatter":  # several pieces a row, a ragged tail
        x = _input(8, 3 * pr.SCATTER_PIECE_BYTES // 4 + 77, "float32", cuda)
        run, counter = (lambda: pr.linear_scatter(x, 5)), pr.SCATTER
    elif kernel == "gather":  # several pieces a row, a ragged tail
        x = _input(8, 3 * pr.GATHER_PIECE_BYTES // 4 + 77, "float32", cuda)
        run, counter = (lambda: pr.linear_gather(x, 3)), pr.GATHER
    elif kernel.startswith("rd"):  # in a cluster's shared memory, or L2
        x = _input(8, 1000, "float32", cuda)
        cluster = None if kernel == "rd" else False
        run, counter = (lambda: pr._rd_launch(x, "sum", cluster=cluster)), \
            pr.RD
    elif kernel.startswith("quant"):  # in shared memory, or in L2
        x = _input(8, 8 * 256 * 128, "float32", cuda).reshape(8, 8, 256, 128)
        cluster = None if kernel == "quant" else False
        run, counter = (lambda: quant._quant_launch(x, cluster, 4)), \
            quant.QUANT
    elif kernel.startswith("hop"):  # a cluster's barrier, or flags
        x = _input(8, 3 * 4096 + 64, "float32", cuda)
        cluster = None if kernel == "hop" else False
        run, counter = (lambda: pr._hop_launch(x, 3, cluster)), pr.PPERMUTE
    elif kernel == "alltoall":
        x = _input(8, 8 * 5000, "float32", cuda).reshape(8, 8, 5000)
        run, counter = (lambda: pr.ring_alltoall(x)), pr.ALLTOALL
    elif kernel.startswith("ag"):  # its buffers in shared memory, or L2
        x = _input(8, 40 * pr.AG_SEG_BYTES // 4 + 77, "float32", cuda)
        cluster = kernel == "ag"
        run, counter = (lambda: pr._ag_launch(x, cluster=cluster)), pr.AG
    else:  # the reduce-scatter's buffers in shared memory, or in L2
        C = 40 * pr.RS_SEG_BYTES // 4 + 77
        x = _input(8, 8 * C, "float32", cuda).reshape(8, 8, C)
        cluster = kernel == "rs"
        run, counter = (lambda: pr._rs_launch(x, "sum", cluster=cluster)), \
            pr.RS
    first = _launched_once(counter, run)
    for _ in range(50):
        assert torch.equal(_launched_once(counter, run), first)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(RDT))
@pytest.mark.parametrize("n", [2, 3, 8])
def test_bidir_matches_plain_on_card(cuda, n, dtype):
    x = _input(n, 5000, dtype, cuda)  # ring blocks padded to 256 lanes
    for op in OPS:
        got = _launched_once(pr.BIDIR, lambda: pr.allreduce_block_bidir(x, op))
        want = pr.allreduce_block_bidir(x, op,
                                        bidir=pr.ring_allreduce_bidir_plain)
        assert torch.equal(_bits(got), _bits(want)), (n, dtype, op)
    # other plans (stripes x threads, as the sweep takes them), and halves
    # that are not whole 16-byte vectors (35 columns each)
    for cols in (1280, 70):
        blocks = _input(n, n * cols, dtype, cuda).reshape(n, n, cols)
        want = pr.ring_allreduce_bidir_plain(blocks, "sum")
        for stripes, threads in ((1, 128), (3, 256), (8, 512), (8, 1024)):
            got = _launched_once(pr.BIDIR, lambda: pr._bidir_launch(
                blocks, "sum", stripes, threads))
            assert pr.BIDIR.last_plan["stripes"] == stripes
            assert torch.equal(_bits(got), _bits(want)), (cols, stripes)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(TDT) + ["float64", "int8"])
@pytest.mark.parametrize("n", [2, 3, 8])
def test_data_movers_match_plain_on_card(cuda, n, dtype):
    if dtype in TDT:
        x = _input(n, n * 700, dtype, cuda).reshape(n, n, 700)
    else:  # the byte copies at other element sizes and an odd width
        x = _input(n, n * 333, "int32", cuda).reshape(n, n, 333).to(
            getattr(torch, dtype))
    got = _launched_once(pr.ALLTOALL, lambda: pr.ring_alltoall(x))
    assert torch.equal(got, pr.ring_alltoall_plain(x))
    assert torch.equal(got, x.transpose(0, 1))
    flat = x[:, 1].contiguous()
    for root in (0, n - 1):
        got = _launched_once(pr.GATHER, lambda: pr.linear_gather(flat, root))
        assert torch.equal(got, pr.linear_gather_plain(flat, root))
        assert torch.equal(got, flat)
        got = _launched_once(pr.SCATTER, lambda: pr.linear_scatter(flat, root))
        assert torch.equal(got, pr.linear_scatter_plain(flat, root))
        assert torch.equal(got, flat)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.ones(2, 2, 128, dtype=torch.int16, device=cuda)
    with pytest.raises(ArgumentError):
        pr.ring_allreduce(x, "sum")  # no int16 kernel, and no fallback
    with pytest.raises(ArgumentError):
        pr.ring_allreduce(x.float(), "land")
    with pytest.raises(ArgumentError):
        pr.ring_allgather(x)  # (n, n, C): not one block per rank
    with pytest.raises(ArgumentError):
        pr.tree_bcast(x[:, 0].float(), root=2)
    with pytest.raises(ArgumentError):
        pr.ring_allreduce_bidir(x.float()[..., :127], "sum")  # odd blocks
    with pytest.raises(ArgumentError):
        pr.ring_alltoall(x[:, :1])
    with pytest.raises(ArgumentError):
        pr.linear_scatter(x[:, 0], root=2)
    with pytest.raises(ArgumentError):
        pr.linear_gather(x[:, 0], root=2)
    with pytest.raises(ArgumentError):
        pr._gather_launch(x[:, 0], 0, piece=24)  # not a 16-byte multiple
    with pytest.raises(ArgumentError):
        pr.ring_allreduce_rd(x[:, 0], "sum")  # no int16 kernel
    with pytest.raises(ArgumentError):
        pr.ring_allreduce_rd(torch.ones(6, 128, device=cuda), "sum")
    with pytest.raises(ArgumentError):  # clusters hold at most 8 ranks
        pr._rd_launch(torch.ones(16, 128, device=cuda), "sum", cluster=True)


#: The seven reduction kernels' SUM on (n, n, C) blocks (recursive
#: doubling and the tree reduce, to root 1, on one block a rank).
SUMS = {
    "ring_allreduce": (pr.RING, lambda b: pr.ring_allreduce(b, "sum")),
    "ring_allreduce_chunked": (pr.CHUNKED, lambda b: pr.ring_allreduce_chunked(
        b, "sum", b.shape[-1])),
    "ring_allreduce_rd": (pr.RD, lambda b: pr.ring_allreduce_rd(b[:, 0],
                                                                "sum")),
    "ring_reduce_scatter": (pr.RS, lambda b: pr.ring_reduce_scatter(b, "sum")),
    "tree_reduce": (pr.TREE_REDUCE, lambda b: pr.tree_reduce(b[:, 0], "sum",
                                                             1)[1]),
    "ring_allreduce_bidir": (pr.BIDIR, lambda b: pr.ring_allreduce_bidir(
        b, "sum")),
    "sched_table": (pl.SCHED_TABLE, lambda b: pl.sched_table(
        pl.analyze(ir.ring(b.shape[0])), b, "sum")),
}


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", sorted(SUMS))
@pytest.mark.parametrize("dtype", ["int8", "uint8"])
@pytest.mark.parametrize("n", [4, 8])  # recursive doubling: powers of two
def test_int_sums_wrap_on_card(cuda, kernel, dtype, n):
    """An int8/uint8 SUM of 100 on every rank gives 100 n modulo 256
    (in the dtype's range), as the JAX package's int8 arithmetic wraps."""
    counter, run = SUMS[kernel]
    x = torch.full((n, n, 1234), 100, dtype=RDT[dtype], device=cuda)
    got = _launched_once(counter, lambda: run(x))
    want = torch.tensor((100 * n) % 256, dtype=torch.int32).to(RDT[dtype])
    assert bool((got == want.to(cuda)).all()), (kernel, dtype, n)


def _programs(n):
    """The table kernel's programs: ring, ring with an order, segmented
    ring at 2 and 4 segments, reduce-scatter, allgather, a 3-member
    fused program and a window."""
    order = list(range(0, n, 2)) + list(range(1, n, 2))
    return {
        "ring": ir.ring(n),
        "ring+order": ir.ring(n, order=order),
        "seg2": ir.segmented_ring(n, 2),
        "seg4": ir.segmented_ring(n, 4),
        "rs": ir.reduce_scatter(n),
        "ag": ir.allgather(n),
        "fuse3": pl.fuse_schedules("fuse3", [ir.ring(n),
                                             ir.segmented_ring(n, 2),
                                             ir.ring(n, order=order)]),
        "window": pl.fuse_window(
            "window", [ir.allgather(n), ir.allgather(n, order=order)],
            [ir.reduce_scatter(n), ir.reduce_scatter(n, order=order)]),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(RDT))
@pytest.mark.parametrize("n", [2, 3, 4, 8, 12])
def test_sched_table_matches_plain_on_card(cuda, n, dtype):
    """Every program at the plan's launch (clusters up to 8 ranks, L2
    beyond), then with one stripe over many segments (fewer than a
    stage's rounds, as many and more) in either memory."""
    for name, sched in _programs(n).items():
        prog = pl.analyze(sched)
        data = _input(n, prog.nchunks * 333, dtype, cuda).reshape(
            n, prog.nchunks, 333)  # a ragged chunk
        for op in OPS if name != "ag" else ("sum",):
            got = _launched_once(pl.SCHED_TABLE,
                                 lambda: pl.sched_table(prog, data, op))
            want = pl.sched_table_plain(prog, data, op)
            assert torch.equal(_bits(got), _bits(want)), (name, n, op)
        rounds = max(length for _, length in pl._stages(prog))
        for segs in (2, rounds, rounds + 3):
            data = _input(n, prog.nchunks * 64 * segs, dtype, cuda).reshape(
                n, prog.nchunks, 64 * segs)[..., :64 * segs - 5]
            want = pl.sched_table_plain(prog, data, "max", seg_cols=64)
            for cluster in (True, False) if n <= 8 else (False,):
                got = _launched_once(pl.SCHED_TABLE, lambda: pl._table_launch(
                    prog, data, "max", stripes=1, threads=128,
                    seg_bytes=64 * data.element_size(), cluster=cluster))
                assert pl.SCHED_TABLE.last_plan["segments"] == segs
                assert torch.equal(_bits(got), _bits(want)), (name, segs,
                                                              cluster)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [3, 8])
def test_sched_wrappers_match_plain_on_card(cuda, n):
    """The registered names' layout (chunks rounded up to 128 elements,
    reduce-scatter rows padded to 128) around kernel and plain version."""
    x = _input(n, 5000, "float32", cuda)
    for sched in (ir.with_lowering(ir.ring(n), "pallas"),
                  ir.with_lowering(ir.segmented_ring(n, 2), "pallas")):
        prog = pl.analyze(sched)
        fn = pl._make_wrapper(prog, sched.name)
        plain = pl._make_wrapper(prog, sched.name,
                                 table=pl.sched_table_plain)
        got = _launched_once(pl.SCHED_TABLE, lambda: fn(x, "sum"))
        assert torch.equal(got, plain(x, "sum"))
        assert torch.allclose(got, x.sum(0).expand_as(x), rtol=1e-5,
                              atol=1e-5)
    rs = pl.analyze(ir.reduce_scatter(n))
    y = x[:, :n * 333].reshape(n, n, 333)
    got = _launched_once(pl.SCHED_TABLE,
                         lambda: pl._make_wrapper(rs, "rs")(y, "max"))
    want = pl._make_wrapper(rs, "rs", table=pl.sched_table_plain)(y, "max")
    assert torch.equal(got, want) and torch.equal(got, y.amax(0))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64", "int8"])
def test_selfdma_chunked_matches_plain_on_card(cuda, dtype):
    for segs, seg_cols in ((1, 4096), (3, 1024), (8, 384)):
        x = _input(1, segs * seg_cols, "int32", cuda).to(getattr(torch, dtype))
        got = _launched_once(pr.SELFDMA, lambda: pr.selfdma_chunked(
            x, seg_cols))
        assert got.data_ptr() != x.data_ptr()
        assert torch.equal(got, pr.selfdma_chunked_plain(x, seg_cols))
        assert torch.equal(got, x)
    y = _input(1, 5000, "float32", cuda)  # ragged: the layout pads it
    got = _launched_once(pr.SELFDMA, lambda: pr.allreduce_block_chunked(
        y, "sum", 4096))
    assert torch.equal(got, y) and got.data_ptr() != y.data_ptr()


@pytest.mark.gpu
def test_selfdma_bulk_pipeline_at_several_plans(cuda):
    """The bulk-copy pipeline with pieces of 16 B to 48 KiB and one or
    two blocks per SM (one piece per block, many, a last short piece),
    a tail of fewer than 16 bytes, and a buffer that is not 16-byte
    aligned (the threads' element copies): each a new tensor equal to its
    input."""
    x = _input(1, 3 * 49152 + 1001, "int32", cuda).to(torch.int8)
    for piece in (16, 4096, 16384, 49152):
        for per_sm in (1, 2):
            for view in (x[:, :4096], x, x[:, 3:]):
                got = _launched_once(pr.SELFDMA, lambda: pr._selfdma_launch(
                    view, piece, per_sm))
                assert pr.SELFDMA.last_plan["piece_bytes"] == piece
                assert torch.equal(got, view), (piece, per_sm, view.shape)


# Rows per ring block for the quant kernel: rows % 128 == 0, and at n = 2
# and n = 3 a count whose stripes do not divide it.
QUANT_ROWS = {2: (128, 384, 2176), 3: (128, 1536), 8: (128, 1152),
              12: (128, 384)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [2, 3, 8, 12])
def test_quant_allreduce_matches_plain_on_card(cuda, n, dtype):
    """The plan's form (a cluster's shared memory up to 8 ranks, L2
    beyond), the L2 form forced, and one-row segments (more segments than
    steps), bitwise the plain version with every flag at 0."""
    forms = [(None, None), (None, 1)]
    if n <= pr.RS_CLUSTER_RANKS:
        forms.append((False, None))
    for rows in QUANT_ROWS[n]:
        x = _input(n, n * rows * 128 - 333, dtype, cuda)  # ragged: padded
        got = _launched_once(quant.QUANT,
                             lambda: quant.allreduce_block_quant(x, "sum"))
        assert quant.QUANT.last_plan["form"] == (
            "cluster" if n <= pr.RS_CLUSTER_RANKS else "l2")
        want = quant.allreduce_block_quant(
            x, "sum", quant=quant.quant_allreduce_plain)
        assert got.dtype == x.dtype and got.shape == x.shape
        assert torch.equal(_bits(got), _bits(want)), (n, dtype, rows)
        assert torch.equal(got, got[:1].expand_as(got))  # ranks agree
        for cluster, seg in forms:
            got = _launched_once(quant.QUANT, lambda: quant.allreduce_block_quant(
                x, "sum", quant=lambda b: quant._quant_launch(b, cluster,
                                                              seg)))
            assert torch.equal(_bits(got), _bits(want)), (rows, cluster, seg)


@pytest.mark.gpu
def test_quant_allreduce_on_ties_matches_plain_on_card(cuda):
    """Values whose quotients by their row's scale fall on ties
    (multiples of 0.5): the kernel's reciprocal path must give way to
    the division there."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    for n in (3, 8):
        x = torch.randint(-254, 255, (n, n * 128 * 128), generator=gen,
                          device=cuda).float() * 0.5
        got = _launched_once(quant.QUANT,
                             lambda: quant.allreduce_block_quant(x, "sum"))
        want = quant.allreduce_block_quant(
            x, "sum", quant=quant.quant_allreduce_plain)
        assert torch.equal(got, want), n


@pytest.mark.gpu
def test_quant_allreduce_refuses_what_it_does_not_take(cuda):
    with pytest.raises(ArgumentError):
        quant.quant_allreduce(torch.ones(2, 2, 64, 128, device=cuda))
    with pytest.raises(ArgumentError):
        quant.quant_allreduce(torch.ones(2, 2, 128, 128, device=cuda,
                                         dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        quant.allreduce_block_quant(torch.ones(2, 100, device=cuda), "max")
    # a contiguous view one float past an aligned start: the wrapper
    # copies it, since the kernel loads rows as 16-byte vectors
    buf = _input(1, 2 * 2 * 128 * 128 + 1, "float32", cuda).reshape(-1)
    blocks = buf[1:].view(2, 2, 128, 128)
    assert blocks.data_ptr() % 16
    got = _launched_once(quant.QUANT, lambda: quant.quant_allreduce(blocks))
    assert torch.equal(got, quant.quant_allreduce_plain(blocks))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8",
                                   "float64"])
@pytest.mark.parametrize("n", [2, 3, 8, 12])
def test_ppermute_shift_matches_plain_on_card(cuda, n, dtype):
    """The plan's form (a cluster's barrier up to 8 ranks, flags beyond),
    in the cluster form both the bulk copies (rows of whole 16-byte
    vectors) and the threads' copy, and the flags form forced: bitwise the
    plain version with every flag at 0."""
    for elems in (13 * 9, 4096 + 64):
        x = _input(n, elems, "int32", cuda).to(getattr(torch, dtype))
        forms = [(None, None)]
        if n <= pr.RS_CLUSTER_RANKS:
            forms += [(True, 0), (False, None)]
        for shift in (1, -1, 3):
            want = pr.ppermute_shift_plain(x, shift)
            assert torch.equal(want, torch.roll(x, shift, 0))
            got = _launched_once(pr.PPERMUTE,
                                 lambda: pr.ppermute_shift(x, shift))
            assert torch.equal(got, want)
            for cluster, piece in forms:
                got = _launched_once(pr.PPERMUTE, lambda: pr._hop_launch(
                    x, shift % n, cluster, piece=piece))
                plan = pr.PPERMUTE.last_plan
                assert plan["form"] == ("flags" if cluster is False
                                        or n > pr.RS_CLUSTER_RANKS
                                        else "cluster")
                assert torch.equal(got, want), (elems, shift, plan)
    one = x[:1]
    before = pr.PPERMUTE.launches
    assert pr.ppermute_shift(one, 1) is one  # n == 1: no launch
    assert pr.PPERMUTE.launches == before


# (atol, rtol). float32: the JAX package's 2e-4. bfloat16 and float16:
# one ulp of the output (2**-7, 2**-10 of |want|; 1e-5 near 0): the
# kernel and its plain version both compute in float32 and round once.
ATTN_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (1e-5, 2.0 ** -7),
            torch.float16: (1e-5, 2.0 ** -10)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(ATTN_TOL, key=str))
@pytest.mark.parametrize("n,t,h,dh", [(4, 8, 2, 128), (3, 100, 3, 24),
                                      (1, 70, 2, 64), (8, 64, 4, 256),
                                      (8, 512, 2, 128)])
def test_ring_attention_matches_plain_on_card(cuda, n, t, h, dh, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(n * t)
    q, k, v = (torch.randn((n, t, h, dh), generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    atol, rtol = ATTN_TOL[dtype]
    for causal in (True, False):
        got = _launched_once(
            pa.ATTN, lambda: pa.ring_attention_block(q, k, v, causal))
        want = pa.ring_attention_block_plain(q, k, v, causal)
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
        again = _launched_once(
            pa.ATTN, lambda: pa.ring_attention_block(q, k, v, causal))
        assert torch.equal(again, got)


@pytest.mark.gpu
def test_ring_attention_refuses_what_it_does_not_take(cuda):
    x = torch.ones(2, 8, 2, 12, device=cuda)
    with pytest.raises(ArgumentError):
        pa.ring_attention_block(x, x, x)  # Dh % 8 != 0
    y = torch.ones(2, 8, 2, 16, device=cuda, dtype=torch.float64)
    with pytest.raises(ArgumentError):
        pa.ring_attention_block(y, y, y)
