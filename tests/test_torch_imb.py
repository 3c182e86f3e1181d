"""The port's IMB-style harness (``ompi_tpu_torch.tools.imb``) on the
CPU, mirroring the first four tests of ``tests/test_imb_scaling.py``:
the sweep's rows, the alltoall buffer's shape, the rooted and prefix
operations, and the CLI refusing an unknown op. The tool keeps the JAX
package's OPS, traffic model and flags."""

import pytest
import torch

import ompi_tpu_torch
from ompi_tpu.tools import imb as jimb
from ompi_tpu_torch.tools import imb


@pytest.fixture(scope="module")
def world():
    comm = ompi_tpu_torch.init(device="cpu")
    try:
        yield comm
    finally:
        ompi_tpu_torch.finalize()


def test_imb_sweep_rows(world):
    rows = imb.sweep(world, ["allreduce", "barrier"], min_bytes=64,
                     max_bytes=1024, iters=2)
    ars = [r for r in rows if r.op == "allreduce"]
    assert [r.nbytes for r in ars] == [64, 256, 1024]
    for r in ars:
        assert r.min_us > 0 and r.p50_us >= r.min_us
        assert r.gbps > 0
    bar = [r for r in rows if r.op == "barrier"]
    assert len(bar) == 1 and bar[0].gbps == 0.0
    text = imb.render(rows)
    assert "allreduce" in text and "GB/s" in text


def test_imb_alltoall_buffer_shape(world):
    buf = imb._buffer(world, "alltoall", 4096)
    assert buf.shape == (8, 8, 128) and buf.dtype == torch.float32
    assert buf.device == world.device
    assert imb._buffer(world, "reduce_scatter_block", 4).shape == (8, 8, 1)
    assert imb._buffer(world, "allreduce", 4096).shape == (8, 1024)
    row = imb.run_one(world, "alltoall", 4096, iters=1)
    assert row.op == "alltoall" and row.min_us > 0


def test_imb_rooted_and_prefix_ops(world):
    """The sweep covers the whole comm surface: rooted (gather/scatter)
    and prefix (scan/exscan) operations produce timed rows too, with the
    JAX package's traffic model."""
    assert imb.OPS == jimb.OPS
    for op in ("gather", "scatter", "scan", "exscan"):
        row = imb.run_one(world, op, 512, iters=1)
        assert row.op == op and row.min_us > 0, row
    for op in imb.OPS:
        for nbytes in (0, 4, 1 << 20):
            assert imb._traffic_bytes(op, nbytes, 8) == \
                jimb._traffic_bytes(op, nbytes, 8)


def test_imb_cli_rejects_bad_op():
    with pytest.raises(SystemExit, match="frobnicate"):
        imb.main(["--ops", "frobnicate"])
