"""The port's ring attention and ring hop against the JAX package's, on
the CPU.

- ``ppermute_shift``: the port's wrapper (its plain version, the
  protocol simulator, on a CPU tensor) against the JAX package's
  ``ppermute_shift`` run in interpret mode on the 8-device CPU mesh, on
  the JAX test's shape (n = 8, 13 float32 values per rank, shifts 1, -1
  and 3): bitwise, since it only moves data. At n = 1 both return the
  input.
- ``sp.ring_attention``: the port's ``xla`` and ``pallas`` paths
  against the JAX package's under ``shard_map`` (its ``xla`` path and
  its Pallas kernel in interpret mode) on the JAX tests' shapes and
  tolerances (tests/test_parallel_model.py): float32 to 2e-4, causal
  and not, at n in {4, 5, 8}, T = 8, H = 2, Dh = 128; bfloat16 to 3e-2
  at n = 4, T = 16; both paths against a numpy full-attention oracle;
  Dh = 24, which the port's kernel takes and the JAX one does not; and
  a shape the port's gate refuses (Dh % 8 != 0), which answers through
  the ``xla`` path without reaching the kernel's wrapper. The tolerances
  cover float32 products summed in another order (and bfloat16 rounding
  of the output).
- ``simulate_ring_attention`` (the kernel's plain version) exact against
  its own lock-step run, with every flag back at 0, under 200 seeded
  random interleavings at n in {3, 4, 8} with G in {1, 2} thread blocks
  per rank, and with the causal ring's uneven split (fewer blocks on the
  ranks that fold less) at n in {3, 4, 8}; with one credit per slot
  (from block 0 alone, awaited as 1) instead of one per receiving block
  counted to G, an interleaving corrupts a block at n in {4, 8}, and
  with arrivals awaited as the receiving rank's own block count instead
  of the sending rank's, an uneven split ends with a fault or a
  deadlock. Skipping the causal mask's hidden folds is exact: bitwise
  the fold of every step. ``split_blocks``: the counts sum to the grid,
  keep the floor and follow the fold work.
- The kernel's split-P arithmetic, emulated on the CPU at the slice's
  sequence (S = 4096 over 8 ranks, 2 heads of 128): p = p_hi + p_lo in
  bfloat16 (float16), products and sums in float32, within one output
  ulp of the float32 whole-block fold; p rounded once must fail that
  limit.

The kernels themselves, on a card, are tested in test_torch_kernels.py
(which imports no JAX, so it runs where only PyTorch is installed).
"""

import random

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from ompi_tpu.coll import pallas_ring as jpr
from ompi_tpu.parallel import sp as jsp
from ompi_tpu_torch.coll import pallas_attn as tpa
from ompi_tpu_torch.coll import pallas_ring as tpr
from ompi_tpu_torch.core import config as tconfig
from ompi_tpu_torch.core.errors import ArgumentError
from ompi_tpu_torch.parallel import sp as tsp

F32_TOL = 2e-4
BF16_TOL = 3e-2


def spmd_run(fn, n, *arrays, check_vma=True):
    """fn on each rank's slice of rank-major numpy arrays, under
    shard_map over n CPU devices; the rank-major result as numpy."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))

    def wrapped(*blocks):
        return fn(*[b[0] for b in blocks])[None]

    return np.asarray(jax.jit(jax.shard_map(
        wrapped, mesh=mesh, in_specs=tuple(P("x") for _ in arrays),
        out_specs=P("x"), check_vma=check_vma))(*arrays))


def jax_ring_attention(arrays, causal, impl):
    n = arrays[0].shape[0]
    return spmd_run(
        lambda a, b, c: jsp.ring_attention(a, b, c, "x", causal=causal,
                                           impl=impl),
        n, *arrays, check_vma=impl == "xla")


def qkv(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32).astype(dtype)
            for _ in range(3)]


def to_torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(np.asarray(a, np.float32)).to(dtype)
            for a in arrays]


def assert_close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# The ring hop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shift", [1, -1, 3])
def test_ppermute_shift_matches_jax_package(shift):
    data = np.random.default_rng(3).standard_normal((8, 13)).astype(
        np.float32)
    want = spmd_run(
        lambda x: jpr.ppermute_shift(x, "x", shift), 8, data,
        check_vma=False)
    before = tpr.PPERMUTE.launches
    got = tpr.ppermute_shift(torch.from_numpy(data), shift)
    assert tpr.PPERMUTE.launches == before  # a CPU tensor: the plain version
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.roll(data, shift, axis=0))


def test_ppermute_shift_one_rank_and_every_dtype():
    data = np.random.default_rng(4).standard_normal((1, 13)).astype(
        np.float32)
    assert np.array_equal(
        spmd_run(lambda x: jpr.ppermute_shift(x, "x", 1), 1, data,
                 check_vma=False), data)
    x = torch.from_numpy(data)
    assert tpr.ppermute_shift(x, 1) is x
    for dtype in (torch.bfloat16, torch.int8, torch.float64):
        y = torch.arange(5 * 3 * 7).reshape(5, 3, 7).to(dtype)
        for shift in (2, -3, 5):
            assert torch.equal(tpr.ppermute_shift(y, shift),
                               torch.roll(y, shift, 0))


@pytest.mark.parametrize("n", [2, 3, 8])
def test_ppermute_protocol_exact_under_random_interleavings(n):
    x = torch.arange(n * 6, dtype=torch.float32).reshape(n, 6)
    for seed in range(50):
        out, residue = tpr.simulate_ppermute(x, 1, rng=random.Random(seed))
        assert not residue
        assert torch.equal(out, torch.roll(x, 1, 0))


# ---------------------------------------------------------------------------
# Ring attention against the JAX package
# ---------------------------------------------------------------------------

_JAX_OUT: dict = {}


def _jax_f32(n, causal, impl):
    key = (n, causal, impl)
    if key not in _JAX_OUT:
        _JAX_OUT[key] = jax_ring_attention(qkv((n, 8, 2, 128), 7), causal,
                                           impl)
    return _JAX_OUT[key]


@pytest.mark.parametrize("port_impl", ["xla", "pallas"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n", [4, 5, 8])
def test_ring_attention_matches_jax_package_f32(n, causal, port_impl):
    got = tsp.ring_attention(*to_torch(qkv((n, 8, 2, 128), 7)),
                             causal=causal, impl=port_impl)
    assert got.shape == (n, 8, 2, 128) and got.dtype == torch.float32
    for jax_impl in ("xla", "pallas"):
        assert_close(got.numpy(), _jax_f32(n, causal, jax_impl), F32_TOL)


@pytest.mark.parametrize("port_impl", ["xla", "pallas"])
def test_ring_attention_matches_jax_package_bf16(port_impl):
    arrays = qkv((4, 16, 2, 128), 5, ml_dtypes.bfloat16)
    got = tsp.ring_attention(*to_torch(arrays, torch.bfloat16),
                             impl=port_impl)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    for jax_impl in ("xla", "pallas"):
        key = ("bf16", jax_impl)
        if key not in _JAX_OUT:
            _JAX_OUT[key] = jax_ring_attention(
                [jnp.asarray(a) for a in arrays], True, jax_impl)
        assert_close(got, _JAX_OUT[key], BF16_TOL)


def full_attention(q, k, v, causal):
    """numpy oracle on the gathered (S, H, Dh) sequence."""
    dh = q.shape[-1]
    scores = np.einsum("qhd,khd->hqk", q, k).astype(np.float64) / np.sqrt(dh)
    if causal:
        mask = np.tril(np.ones(scores.shape[1:], bool))
        scores = np.where(mask[None], scores, -1e30)
    w = np.exp(scores - scores.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    return np.einsum("hqk,khd->qhd", w, v)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_full_attention(causal, impl):
    n, t, h, dh = 4, 6, 2, 8
    arrays = qkv((n, t, h, dh), 0)
    got = tsp.ring_attention(*to_torch(arrays), causal=causal, impl=impl)
    want = full_attention(*[a.reshape(n * t, h, dh) for a in arrays], causal)
    assert_close(got.numpy().reshape(n * t, h, dh), want, F32_TOL)


def test_ring_attention_head_dim_24_through_the_kernel():
    """Dh = 24: the port's kernel takes it (Dh % 8 == 0); the JAX
    package's falls back to its xla path."""
    arrays = qkv((4, 8, 2, 24), 8)
    assert tpa.supported(to_torch(arrays)[0])
    got = tsp.ring_attention(*to_torch(arrays), impl="pallas")
    assert_close(got.numpy(), jax_ring_attention(arrays, True, "pallas"),
                 F32_TOL)


def test_refused_shape_answers_through_xla(monkeypatch):
    arrays = qkv((4, 8, 2, 12), 9)  # Dh % 8 != 0
    tq = to_torch(arrays)
    assert not tpa.supported(tq[0])
    assert not tpa.supported(tq[0].double())

    def refused(*args, **kwargs):
        raise AssertionError("the gate let a refused shape reach the kernel")

    monkeypatch.setattr(tpa, "ring_attention_block", refused)
    got = tsp.ring_attention(*tq, impl="pallas")
    assert torch.equal(got, tsp.ring_attention(*tq, impl="xla"))
    assert_close(got.numpy(), jax_ring_attention(arrays, True, "pallas"),
                 F32_TOL)


def test_impl_cvar_and_unknown_impl():
    tq = to_torch(qkv((2, 4, 1, 8), 1))
    assert tconfig.get("parallel_sp_impl") == "xla"
    with pytest.raises(ArgumentError):
        tsp.ring_attention(*tq, impl="bogus")
    tconfig.set("parallel_sp_impl", "pallas")
    try:
        got = tsp.ring_attention(*tq)
    finally:
        tconfig.set("parallel_sp_impl", "xla")
    assert torch.equal(got, tpa.ring_attention_block(*tq))
    with pytest.raises(ArgumentError):
        tpa.ring_attention_block(*[t.double() for t in tq])
    with pytest.raises(ArgumentError):
        tpa.ring_attention_block(tq[0], tq[1][:, :2], tq[2])


def test_shard_sequence():
    x = torch.arange(10 * 3).reshape(10, 3)
    got = tsp.shard_sequence(x, 3)
    assert got.shape == (3, 3, 3)
    assert torch.equal(got.reshape(9, 3), x[:9])


# ---------------------------------------------------------------------------
# The kernel's protocol under random interleavings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("blocks", [1, 2])
@pytest.mark.parametrize("n", [3, 4, 8])
def test_attention_protocol_exact_under_random_interleavings(n, blocks):
    q, k, v = to_torch(qkv((n, 4, 2, 8), n))
    want, residue = tpa.simulate_ring_attention(q, k, v, True)
    assert not residue
    for seed in range(200):
        out, residue = tpa.simulate_ring_attention(
            q, k, v, True, blocks=blocks, rng=random.Random(seed))
        assert not residue, (seed, residue)
        assert torch.equal(out, want), seed


@pytest.mark.parametrize("n", [4, 8])
def test_attention_credits_must_count_every_block(n):
    """One credit per slot, from block 0 alone, lets the left neighbour
    overwrite a slot that block 1 still reads. (At n = 3 no slot is
    written twice: step 0 reads the inputs, and the two sends fill slot
    1, then slot 0, once each.)"""
    q, k, v = to_torch(qkv((n, 4, 2, 8), n))
    want, _ = tpa.simulate_ring_attention(q, k, v, True)
    for seed in range(200):
        out, residue = tpa.simulate_ring_attention(
            q, k, v, True, blocks=2, count="one", rng=random.Random(seed))
        if residue and not torch.equal(out, want):
            return
    pytest.fail("a credit counted to 1 never corrupted a block")


def test_split_blocks_follows_the_fold_work():
    assert tpa.split_blocks(8, 132, False) == [17] * 4 + [16] * 4
    for n, total, floor, items in ((8, 132, 8, 128), (8, 132, 8, 256),
                                   (8, 132, 4, 0), (3, 6, 1, 0),
                                   (4, 8, 1, 2), (8, 20, 1, 0),
                                   (8, 8, 4, 0), (1, 5, 3, 4)):
        counts = tpa.split_blocks(n, total, True, floor, items)
        assert len(counts) == n and sum(counts) == total
        assert min(counts) >= min(floor, total // n)
        assert counts[-1] == max(counts)  # the last rank folds the most
        if items:  # items per block never grow with the rank
            per = [-(-items // g) for g in counts]
            assert per == sorted(per, reverse=True)
    # the slice's shape: 32 heads x 4 tile pairs per rank, floor 8
    assert tpa.split_blocks(8, 132, True, 8, 128) == [10, 11, 13, 15, 16,
                                                      19, 22, 26]
    with pytest.raises(ArgumentError):
        tpa.split_blocks(4, 3, True)


UNEVEN = {3: [1, 2, 3], 4: [1, 1, 2, 4], 8: tpa.split_blocks(8, 20, True)}


@pytest.mark.parametrize("n", [3, 4, 8])
def test_attention_protocol_uneven_causal_split(n):
    """The causal ring's split: each rank's blocks in proportion to its
    fold work, so the arrival and credit counts differ from rank to
    rank (an arrival wait counts the sender's blocks, a credit wait the
    reader's)."""
    q, k, v = to_torch(qkv((n, 4, 2, 8), n + 10))
    want, residue = tpa.simulate_ring_attention(q, k, v, True)
    assert not residue
    for seed in range(200):
        out, residue = tpa.simulate_ring_attention(
            q, k, v, True, blocks=UNEVEN[n], rng=random.Random(seed))
        assert not residue, (seed, residue)
        assert torch.equal(out, want), seed


@pytest.mark.parametrize("n", [3, 4, 8])
def test_attention_arrivals_must_count_the_senders_blocks(n):
    """Arrivals awaited as the receiver's own block count: where the
    sender has more blocks the receiver reads a slot before every share
    has landed, where it has fewer the receiver never wakes."""
    q, k, v = to_torch(qkv((n, 4, 2, 8), n + 10))
    want, _ = tpa.simulate_ring_attention(q, k, v, True)
    for seed in range(200):
        try:
            out, residue = tpa.simulate_ring_attention(
                q, k, v, True, blocks=UNEVEN[n], count="recv",
                rng=random.Random(seed))
        except RuntimeError:  # deadlock
            return
        if residue or not torch.equal(out, want):
            return
    pytest.fail("arrivals counted to the receiver's blocks were never caught")


def test_causal_skip_is_exact():
    """The simulator skips every fold of a block from a later rank, as
    the kernel does: bitwise the fold of every step."""
    n, t, nh, dh = 4, 8, 2, 16
    q, k, v = to_torch(qkv((n, t, nh, dh), 21))
    got, _ = tpa.simulate_ring_attention(q, k, v, True)
    m = torch.full((n, nh, t), -1e30)
    l = torch.zeros((n, nh, t))
    o = torch.zeros((n, nh, t, dh))
    for me in range(n):
        for step in range(n):
            src = (me - step) % n
            for h in range(nh):
                tpa._fold(q, k[src], v[src], me, src, h, True, tpa._scale(dh),
                          m, l, o)
    want = (o / l.clamp(min=1e-30)[..., None]).transpose(1, 2)
    assert torch.equal(got, want)


# (atol, rtol): one output ulp, the card tests' limit (ATTN_TOL).
ULP = {torch.bfloat16: (1e-5, 2.0 ** -7), torch.float16: (1e-5, 2.0 ** -10)}


def split_p_fold(q, k, v, dtype, split):
    """The kernel's tensor-core fold of 64-key tiles over the gathered
    causal sequence, emulated: scores and the online softmax in float32,
    p as p_hi + p_lo in ``dtype`` (``split``) or p_hi alone, each
    product exact in float32 and summed in float32."""
    n, t, nh, dh = q.shape
    s = n * t
    qs, ks, vs = (x.reshape(s, nh, dh).float().transpose(0, 1)
                  for x in (q, k, v))
    pos = torch.arange(s)
    m = torch.full((nh, s), -1e30)
    l = torch.zeros((nh, s))
    o = torch.zeros((nh, s, dh))
    for k0 in range(0, s, 64):
        keys = slice(k0, k0 + 64)
        scores = (qs @ ks[:, keys].transpose(1, 2)) * tpa._scale(dh)
        scores = torch.where(pos[:, None] >= pos[None, keys], scores,
                             torch.tensor(-1e30))
        m_new = torch.maximum(m, scores.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * corr + p.sum(-1)
        hi = p.to(dtype).float()
        pv = hi @ vs[:, keys]
        if split:
            pv = pv + (p - hi).to(dtype).float() @ vs[:, keys]
        o = o * corr[..., None] + pv
        m = m_new
    out = o / l.clamp(min=1e-30)[..., None]
    return out.transpose(0, 1).reshape(n, t, nh, dh).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=str)
def test_split_p_within_one_ulp_at_the_slice_sequence(dtype):
    arrays = qkv((8, 512, 2, 128), 11)
    q, k, v = to_torch(arrays, dtype)
    want = tpa.ring_attention_block_plain(q, k, v, True).float()
    atol, rtol = ULP[dtype]
    limit = atol + rtol * want.abs()
    split = split_p_fold(q, k, v, dtype, True).float()
    assert float(((split - want).abs() / limit).max()) <= 1.0
    single = split_p_fold(q, k, v, dtype, False).float()
    assert float(((single - want).abs() / limit).max()) > 1.0
