"""IMB-MPI1-style benchmark harness for the port.

Port of ``ompi_tpu/tools/imb.py`` (the Intel MPI Benchmarks' sweep:
BASELINE.md's target metric is "IMB-MPI1 Allreduce GB/s + p50 latency
vs message size 4B-1GB"): sweep message sizes per collective, report
p50/min latency and effective bandwidth.

    python -m ompi_tpu_torch.tools.imb --ops allreduce,bcast --max-bytes 4194304

The route is the communicator's coll selection: TunedColl by default;
PallasColl (the hand-written kernels) with
``OMPITPU_MCA_coll_pallas_priority=100`` in the environment.

Timing notes: each (op, size) is run ``--iters`` times after a warmup
call that builds its plan (and kernels); latency includes the whole
framework dispatch (what a user sees per call), and on the card each
call is waited for with ``torch.cuda.synchronize()``. Buffers are made
on the device, ones in float32.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass

import numpy as np
import torch

OPS = ("allreduce", "bcast", "reduce", "allgather",
       "reduce_scatter_block", "alltoall", "barrier",
       "gather", "scatter", "scan", "exscan")


@dataclass
class Row:
    op: str
    nbytes: int
    p50_us: float
    min_us: float
    gbps: float


def _buffer(comm, op: str, nbytes: int) -> torch.Tensor:
    n = comm.size
    elems = max(1, nbytes // 4)
    if op in ("alltoall", "reduce_scatter_block"):
        shape = (n, n, max(1, elems // n))
    else:
        shape = (n, elems)
    return torch.ones(shape, dtype=torch.float32, device=comm.device)


def _traffic_bytes(op: str, nbytes: int, n: int) -> float:
    """Algorithmic bus bytes per rank (IMB conventions)."""
    if op == "allreduce":
        return 2 * (n - 1) / n * nbytes
    if op in ("bcast", "reduce"):
        return nbytes
    if op in ("allgather", "alltoall"):
        return (n - 1) / n * nbytes
    if op == "reduce_scatter_block":
        return (n - 1) / n * nbytes
    if op in ("gather", "scatter", "scan", "exscan"):
        return nbytes
    return 0.0


def _settle(comm) -> None:
    """Wait for the device work of a call (nothing to wait for on the
    CPU, where a call returns finished)."""
    if comm.device.type == "cuda":
        torch.cuda.synchronize()


def run_one(comm, op: str, nbytes: int, iters: int) -> Row:
    x = None if op == "barrier" else _buffer(comm, op, nbytes)

    def call():
        if op == "barrier":
            comm.barrier()
            return None
        if op in ("gather", "scatter"):
            return getattr(comm, op)(x, root=0)
        return getattr(comm, op)(x)

    out = call()  # warmup: plan and kernel build
    _settle(comm)
    del out
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = call()
        _settle(comm)
        times.append(time.perf_counter() - t0)
        del out
    p50 = float(np.median(times))
    tmin = float(np.min(times))
    traffic = _traffic_bytes(op, nbytes, comm.size)
    gbps = traffic / tmin / 1e9 if traffic else 0.0
    return Row(op, nbytes, p50 * 1e6, tmin * 1e6, gbps)


def sweep(comm, ops, min_bytes: int, max_bytes: int, iters: int
          ) -> list[Row]:
    rows = []
    for op in ops:
        if op == "barrier":
            rows.append(run_one(comm, op, 0, iters))
            continue
        size = min_bytes
        while size <= max_bytes:
            rows.append(run_one(comm, op, size, iters))
            size *= 4
    return rows


def render(rows: list[Row]) -> str:
    lines = [
        f"{'op':>22} {'bytes':>12} {'p50 us':>10} {'min us':>10} "
        f"{'GB/s':>8}"
    ]
    for r in rows:
        lines.append(
            f"{r.op:>22} {r.nbytes:>12} {r.p50_us:>10.1f} "
            f"{r.min_us:>10.1f} {r.gbps:>8.2f}"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ompi_tpu_torch.tools.imb")
    ap.add_argument("--ops", default="allreduce,bcast,alltoall,barrier")
    ap.add_argument("--min-bytes", type=int, default=4)
    ap.add_argument("--max-bytes", type=int, default=1 << 22)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    ops = [o.strip() for o in args.ops.split(",") if o.strip()]
    bad = [o for o in ops if o not in OPS]
    if bad:
        raise SystemExit(f"unknown ops {bad}; known: {OPS}")

    import ompi_tpu_torch

    comm = ompi_tpu_torch.init()
    rows = sweep(comm, ops, args.min_bytes, args.max_bytes, args.iters)
    if args.json:
        print(json.dumps([r.__dict__ for r in rows]))
    else:
        print(f"# ompi_tpu_torch IMB-style sweep, {comm.size} ranks on "
              f"{comm.device}, allreduce through coll/"
              f"{comm._coll['allreduce'][0].NAME}")
        print(render(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
