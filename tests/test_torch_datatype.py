"""The port's datatype engine (``ompi_tpu_torch.datatype``) against the
JAX package's, on the CPU (mirrors ``tests/test_datatype.py``).

- Every constructor, from ``contiguous`` to ``darray`` (and ``resized``,
  ``dup``, ``from_numpy`` of a structured dtype): ``size``, ``extent``,
  ``lb``, ``ub``, the true bounds, ``segments``, the element count,
  ``is_contiguous``, the name and the envelope's kind equal the JAX
  package's.
- ``pack`` bytes equal the JAX package's (its native tier; the port
  walks the segment table in Python), whole and in chunks from seeked
  positions; ``unpack`` of those bytes rebuilds the same buffer;
  external32 bytes and round trip; twenty seeded random types.
- ``pack_device``/``unpack_device`` on tensors equal the JAX package's
  on arrays, through a self send as ``to_self.c`` does; the port's
  device plan holds int64 indices (the JAX package's int32 would wrap
  past 2**31 elements).
- The errors: the same classes for a short buffer, an unpack overflow,
  an unknown name, a subarray out of bounds and a mixed-primitive
  device pack.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ompi_tpu
import ompi_tpu_torch
from ompi_tpu import datatype as jdt
from ompi_tpu_torch import datatype as tdt
from ompi_tpu_torch.core.errors import TruncationError
from ompi_tpu_torch.datatype import convertor as tconvertor

# name -> (builder(dt module) -> Datatype, element dtype of the buffer)
TYPES = {
    "contiguous": (lambda d: d.contiguous(6, d.FLOAT32), np.float32),
    "vector": (lambda d: d.vector(4, 3, 5, d.INT32), np.int32),
    "vector_f64": (lambda d: d.vector(5, 2, 8, d.FLOAT64), np.float64),
    "hvector": (lambda d: d.hvector(3, 2, 20, d.INT32), np.int32),
    "indexed": (lambda d: d.indexed([2, 3, 1], [0, 10, 25], d.INT32),
                np.int32),
    "hindexed": (lambda d: d.hindexed([2, 1], [4, 40], d.INT32), np.int32),
    "indexed_block": (lambda d: d.indexed_block(2, [0, 8, 16], d.INT32),
                      np.int32),
    "struct": (lambda d: d.struct([1, 2], [0, 20], [d.FLOAT32, d.FLOAT32]),
               np.float32),
    "struct_mixed": (lambda d: d.struct([1, 2], [0, 8],
                                        [d.INT32, d.FLOAT32]), np.int32),
    "subarray": (lambda d: d.subarray([6, 8], [2, 3], [1, 4], d.FLOAT32),
                 np.float32),
    "subarray_f": (lambda d: d.subarray([2, 3, 4], [1, 1, 2], [0, 1, 1],
                                        d.INT32, order=d.ORDER_FORTRAN),
                   np.int32),
    "darray_block": (lambda d: d.darray(
        4, 3, [8, 6], [d.DISTRIBUTE_BLOCK, d.DISTRIBUTE_BLOCK],
        [d.DISTRIBUTE_DFLT_DARG] * 2, [2, 2], d.INT32), np.int32),
    "darray_cyclic": (lambda d: d.darray(
        2, 1, [7, 4], [d.DISTRIBUTE_CYCLIC, d.DISTRIBUTE_NONE], [2, 1],
        [2, 1], d.FLOAT32, order=d.ORDER_FORTRAN), np.float32),
    "resized": (lambda d: d.vector(3, 2, 5, d.INT32).resized(0, 100),
                np.int32),
    "dup": (lambda d: d.vector(2, 1, 3, d.FLOAT32).dup(), np.float32),
    "structured": (lambda d: d.from_numpy(np.dtype(
        [("a", np.int32), ("b", np.float64)], align=True)), np.int32),
    "named": (lambda d: d.lookup("int16"), np.int16),
}


def _describe(t):
    return (t.size, t.extent, t.lb, t.ub, t.true_lb, t.true_extent,
            t.segments, t.num_elements, t.is_contiguous, t.name,
            t.envelope[0])


def _buffer(t, count, elem, seed):
    n = (t.lb + t.extent * count + t.true_extent) // np.dtype(elem).itemsize
    rng = np.random.default_rng(seed)
    return rng.integers(-1000, 1000, n + 4).astype(elem)


@pytest.mark.parametrize("name", sorted(TYPES))
def test_constructor_and_pack_match_jax(name):
    build, elem = TYPES[name]
    j, t = build(jdt), build(tdt)
    assert _describe(t.commit()) == _describe(j.commit())
    for count in (1, 3):
        buf = _buffer(t, count, elem, count)
        packed = tdt.pack(buf, t, count)
        assert packed == jdt.pack(buf, j, count)
        # in chunks from seeked positions
        conv = tdt.Convertor(t, count).prepare_for_send(buf)
        for pos in range(0, len(packed), 7):
            conv.set_position(pos)
            assert conv.pack(11) == packed[pos:pos + 11], (count, pos)
        tout, jout = np.zeros_like(buf), np.zeros_like(buf)
        tdt.unpack(packed, tout, t, count)
        jdt.unpack(packed, jout, j, count)
        assert tout.tobytes() == jout.tobytes()
        assert tdt.pack(tout, t, count) == packed


def test_random_types_roundtrip_like_jax():
    """The ddt_test.c battery of ``tests/test_datatype.py``: random
    derived types and chunkings, the same bytes in both packages."""
    rng = np.random.RandomState(11)
    for trial in range(20):
        kind = trial % 4
        if kind == 0:
            bl = int(rng.randint(1, 4))
            args = (int(rng.randint(1, 5)), bl, bl + int(rng.randint(0, 4)))
            make = lambda d, a=args: d.vector(*a, d.INT32)  # noqa: E731
        elif kind == 1:
            n = int(rng.randint(1, 5))
            disps = sorted(rng.choice(np.arange(0, 20), size=n,
                                      replace=False).tolist())
            bls = [int(rng.randint(1, 3)) for _ in range(n)]
            make = lambda d, b=bls, p=disps: d.indexed(  # noqa: E731
                b, p, d.FLOAT32)
        elif kind == 2:
            sub = (int(rng.randint(1, 6)), int(rng.randint(1, 8)))
            make = lambda d, s=sub: d.subarray(  # noqa: E731
                (6, 8), s, (0, 0), d.FLOAT64)
        else:
            make = lambda d: d.struct(  # noqa: E731
                [1, 2], [0, 8], [d.INT32, d.FLOAT32])
        count = int(rng.randint(1, 3))
        t, j = make(tdt), make(jdt)
        arr = rng.standard_normal(
            (t.extent * count + t.size) // 4 + 16).astype(np.float32)
        chunks = [int(rng.randint(1, 40)) for _ in range(3)]
        conv = tdt.Convertor(t, count).prepare_for_send(arr)
        parts, i = [], 0
        while conv.remaining:
            parts.append(conv.pack(chunks[i % 3]))
            i += 1
        packed = b"".join(parts)
        assert packed == jdt.pack(arr, j, count), trial
        out = np.zeros_like(arr)
        rconv = tdt.Convertor(t, count).prepare_for_recv(out)
        for k in range(0, len(packed), 13):
            rconv.set_position(k)
            assert rconv.unpack(packed[k:k + 13]) == len(packed[k:k + 13])
        jout = np.zeros_like(arr)
        jdt.unpack(packed, jout, j, count)
        assert out.tobytes() == jout.tobytes(), trial


@pytest.mark.parametrize("elem", [np.int32, np.float64, np.int16])
def test_external32_matches_jax(elem):
    arr = np.arange(10, dtype=elem) * 3 - 7
    t, j = tdt.vector(3, 2, 3, elem), jdt.vector(3, 2, 3, elem)
    packed = tdt.pack_external32(arr, t, 1)
    assert packed == jdt.pack_external32(arr, j, 1)
    out = np.zeros_like(arr)
    tdt.unpack_external32(packed, out, t, 1)
    assert tdt.pack(out, t, 1) == tdt.pack(arr, t, 1)


DEVICE_TYPES = ("contiguous", "vector", "indexed", "hindexed", "subarray",
                "darray_block", "resized")


@pytest.mark.parametrize("name", DEVICE_TYPES)
def test_pack_unpack_device_match_jax(name):
    build, elem = TYPES[name]
    t, j = build(tdt), build(jdt)
    for count in (1, 2):
        buf = _buffer(t, count, elem, 7)
        tpacked = tdt.pack_device(torch.from_numpy(buf), t, count)
        jpacked = jdt.pack_device(jnp.asarray(buf), j, count)
        assert tpacked.numpy().tobytes() == np.asarray(jpacked).tobytes()
        assert tpacked.numpy().tobytes() == tdt.pack(buf, t, count)
        tmpl = np.full_like(buf, 5)
        tt = torch.from_numpy(tmpl.copy())
        tout = tdt.unpack_device(tpacked, tt, t, count)
        jout = jdt.unpack_device(jpacked, jnp.asarray(tmpl), j, count)
        assert tout.numpy().tobytes() == np.asarray(jout).tobytes()
        assert torch.equal(tt, torch.from_numpy(tmpl))  # template kept


def test_device_plan_holds_int64_indices():
    t = tdt.vector(4, 2, 6, tdt.FLOAT32)
    x = torch.arange(48, dtype=torch.float32)
    tdt.pack_device(x, t, 2)
    tdt.unpack_device(torch.zeros(16), x, t, 2)
    plans = [idx for k, idx in tconvertor._device_plan_cache.items()
             if k[:3] == (tconvertor._structural_key(t), 2, 4)]
    assert len(plans) == 1 and plans[0].dtype == torch.int64
    # two bytes 3 GiB apart: an element index past 2**31
    far = tdt.hvector(2, 1, 3 << 30, tdt.INT8)
    idx = tconvertor._element_indices(far, 1, 1)
    assert idx.dtype == np.int64 and idx.tolist() == [0, 3 << 30]


def test_device_pack_of_a_short_tensor_raises():
    """A tensor shorter than the layout spans raises, as a short host
    buffer does, before any index could reach past its end."""
    t = tdt.vector(4, 2, 6, tdt.FLOAT32)  # spans 20 floats
    with pytest.raises(TruncationError):
        tdt.pack_device(torch.zeros(19), t, 1)
    with pytest.raises(TruncationError):
        tdt.unpack_device(torch.zeros(8), torch.zeros(19), t, 1)
    assert tdt.pack_device(torch.zeros(20), t, 1).shape == (8,)


def test_to_self_noncontiguous_through_p2p():
    """The reference's to_self.c: a non-contiguous layout travels the
    full send path (pack -> transfer -> unpack) rank 0 -> rank 0, in
    both packages."""
    arr = np.arange(30, dtype=np.float32)
    jw, tw = ompi_tpu.init(), ompi_tpu_torch.init(device="cpu")
    try:
        outs = []
        for d, w, put in ((jdt, jw, jnp.asarray), (tdt, tw, torch.as_tensor)):
            v = d.vector(3, 2, 10, d.FLOAT32)
            r0 = w.rank(0)
            r0.send(r0.put(np.asarray(d.pack_device(put(arr), v, 1))),
                    dest=0, tag=42)
            got = r0.recv(source=0, tag=42)
            outs.append(np.asarray(d.unpack_device(
                got, put(np.zeros(30, np.float32)), v, 1)))
    finally:
        ompi_tpu_torch.finalize()
    expected = np.zeros(30, np.float32)
    expected.reshape(3, 10)[:, :2] = arr.reshape(3, 10)[:, :2]
    assert outs[1].tobytes() == outs[0].tobytes() == expected.tobytes()


def _error(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - compared across packages
        return type(exc).__name__
    return None


ERRORS = {
    "short_buffer": lambda d: d.Convertor(
        d.vector(4, 2, 4, d.INT32), 1).prepare_for_send(
            np.zeros(3, np.int32)),
    "unpack_overflow": lambda d: d.Convertor(d.INT32, 2).prepare_for_recv(
        np.zeros(2, np.int32)).unpack(b"\x00" * 12),
    "unknown_name": lambda d: d.lookup("float128x"),
    "subarray_oob": lambda d: d.subarray([4, 4], [2, 2], [3, 0], d.INT32),
    "position_range": lambda d: d.Convertor(d.INT32, 4).set_position(999),
    "mixed_device_pack": lambda d: d.pack_device(
        (torch.zeros(8, dtype=torch.int32) if d is tdt
         else jnp.zeros(8, jnp.int32)),
        d.struct([1, 1], [0, 4], [d.INT32, d.FLOAT32]), 1),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_match_jax(case):
    got = _error(lambda: ERRORS[case](tdt))
    assert got is not None and got == _error(lambda: ERRORS[case](jdt))
