"""Schedule autotuner: sweep candidates, persist winners (port of
``ompi_tpu/coll/sched/autotune.py``, the allreduce sweep).

Per (op, size-bucket, dtype, nranks, topology-fingerprint) key the
tuner scores every candidate and records the winner in the on-disk
cache (sched/cache.py). Two scoring modes (``coll_sched_autotune_mode``):

``model``
    Deterministic alpha-beta cost model: cost = alpha·steps +
    beta·wire-bytes with per-algorithm step/wire counts and a
    seed-keyed deterministic tie-break. No device needed; same-seed
    runs give byte-identical cache digests — in this package and in
    the JAX package alike, since ``_TIER_COEFF`` is the JAX package's.

``measure``
    Wall-clock sweep on a live communicator: each candidate runs on
    the communicator's device, with a synchronize before and after
    every timed run, and the best of ``iters`` runs is kept. Winners
    are machine-specific; the digest still excludes the timings.

Candidates whose transport tier the health ledger quarantines are
never timed (``health.ledger`` is a seam in the port: nothing is
quarantined yet). Not ported yet: ``program_*``, ``tune_step`` and
``tune_residency``, the training-step choices (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

import time
import zlib
from functools import partial
from math import ceil, log2
from typing import Optional, Sequence

import torch

from ...core import config
from ...core.counters import SPC
from ...core.errors import ArgumentError
from ...core.logging import get_logger
from . import cache as _cache
from . import lattice

logger = get_logger("coll.sched")

_V = partial(config.register, "coll", "sched")
_mode_var = _V(
    "autotune_mode", type=str, default="model",
    description="'model' = deterministic alpha-beta cost model "
                "(reproducible digests, no devices); 'measure' = "
                "wall-clock sweep on a live communicator",
)
_seed_var = _V(
    "autotune_seed", type=int, default=0,
    description="Deterministic tie-break seed for model-mode scoring "
                "(same seed => byte-identical cache digest on every "
                "controller)",
)
_iters_var = _V(
    "autotune_iters", type=int, default=3,
    description="Timed repetitions per candidate in measure mode "
                "(best-of)",
)

#: 4 B .. 1 GiB bytes-per-rank sweep points (tune() buckets them with
#: cache.size_bucket).
DEFAULT_SIZES = (4, 64, 1 << 10, 16 << 10, 256 << 10, 4 << 20,
                 64 << 20, 1 << 30)

#: Candidate allreduce schedules. Quant tiers join only when the user
#: opted into the lossy wire (coll_quant_enable), mirroring the prior's
#: consent gate; the quantized ring kernel (``quant_pallas``) is never a
#: candidate, as in the JAX package. The hand-kernel tiers join only on
#: request (``include_pallas``).
_EXACT_CANDIDATES = (
    "native", "recursive_doubling", "ring", "ring_segmented",
    "rabenseifner", "sched_ring", "sched_rd", "sched_ring_seg",
    "sched_hier", "gather_reduce",
)
_PALLAS_CANDIDATES = ("pallas_ring", "pallas_bidir", "pallas_rd",
                      "sched_pallas_ring", "sched_pallas_ring_seg")
_QUANT_CANDIDATES = ("quant_ring", "sched_quant")


def candidates(opname: str, nranks: int, dtype=None, op=None, *,
               scope: Optional[str] = None,
               include_pallas: bool = False
               ) -> tuple[list[str], list[str]]:
    """(allowed, skipped_quarantined) candidate algorithm names for the
    sweep. Quarantined transport tiers are never timed."""
    if opname != "allreduce":
        return [], []
    from ...health import ledger as health
    from .. import quant

    pool = list(_EXACT_CANDIDATES)
    if include_pallas:
        pool += list(_PALLAS_CANDIDATES)
    if quant._enable_var.value and quant.supports(op or "sum", dtype):
        pool += list(_QUANT_CANDIDATES)
    pof2 = nranks & (nranks - 1) == 0
    if not pof2:
        # rd-family generators need a power-of-two ring; the guarded
        # wrappers would silently re-time the ring, so drop them.
        pool = [a for a in pool
                if a not in ("rabenseifner", "sched_rd", "pallas_rd")]
    allowed, skipped = [], []
    for algo in pool:
        if health.LEDGER.is_denied(lattice.tier_of(algo), scope):
            skipped.append(algo)
            SPC.record("sched_tune_skipped_quarantined")
        else:
            allowed.append(algo)
    return allowed, skipped


# ---------------------------------------------------------------------------
# model mode: deterministic alpha-beta scoring
# ---------------------------------------------------------------------------

#: (alpha per step, beta per wire byte) by transport tier — relative
#: units; only the ordering of costs matters. These are the JAX
#: package's, set for the TPU (device_pallas there: one fused kernel,
#: its DMA overlapping the combine), kept so that model mode gives the
#: same winners and digest in both packages. Coefficients fitted on the
#: card are later work (ROADMAP Queue 1 item 1).
_TIER_COEFF = {"device_pallas": (0.8, 0.9e-4),
               "device": (1.0, 1.0e-4), "host": (30.0, 8.0e-4)}


def _steps_and_wire(algo: str, nbytes: int, nranks: int) -> tuple:
    """(rounds, bytes-on-wire-per-rank) for the cost model."""
    n = max(2, nranks)
    logn = max(1, ceil(log2(n)))
    ring_wire = 2.0 * nbytes * (n - 1) / n
    if algo in ("native",):
        # fused fabric schedule: bandwidth-optimal wire, fewer
        # exposed steps than the explicit ring
        return logn, ring_wire * 0.85
    if algo in ("recursive_doubling", "sched_rd"):
        return logn, float(nbytes) * logn
    if algo in ("ring", "sched_ring", "pallas_ring", "pallas_bidir",
                "sched_pallas_ring"):
        return 2 * (n - 1), ring_wire
    if algo in ("ring_segmented", "sched_ring_seg",
                "sched_pallas_ring_seg"):
        # segmentation overlaps combine with DMA on large payloads and
        # only adds round overhead on small ones
        factor = 0.92 if nbytes > (1 << 20) else 1.1
        return 2 * (n - 1) + 2, ring_wire * factor
    if algo in ("rabenseifner", "pallas_rsag"):
        return 2 * logn, ring_wire
    if algo in ("quant_ring", "sched_quant", "quant_pallas"):
        from .. import quant

        ratio = max(1.0, quant.compression_ratio())
        # codec cost: one dequant-accumulate-requant pass per hop
        return 2 * (n - 1), ring_wire / ratio + nbytes * 2.0e-1 * 1e-3
    if algo == "sched_hier":
        return n + 2, float(nbytes) * (logn + 1)
    if algo == "gather_reduce":
        return logn, float(nbytes) * n
    return 2 * (n - 1), ring_wire  # unknown: ring-like


def model_cost(algo: str, nbytes: int, nranks: int, seed: int) -> float:
    """Deterministic relative cost; the seed perturbs only the
    tie-break epsilon (crc32 — stable across processes, unlike
    hash())."""
    steps, wire = _steps_and_wire(algo, nbytes, nranks)
    alpha, beta = _TIER_COEFF.get(lattice.tier_of(algo),
                                  _TIER_COEFF["device"])
    jitter = zlib.crc32(f"{seed}:{algo}".encode()) % 997 * 1e-9
    return alpha * steps + beta * wire + jitter


# ---------------------------------------------------------------------------
# measure mode
# ---------------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_cost(comm, algo: str, nbytes: int, dtype, op,
                 iters: int) -> Optional[float]:
    """Best-of wall seconds for one candidate on a live comm's device,
    synchronizing before and after each run, or None when the
    candidate refuses this shape (an ``ArgumentError``). The JAX
    package returns None on any exception; here a kernel that fails to
    build or launch, or a CUDA error, raises, so that a broken
    candidate cannot drop out of the sweep unseen."""
    from .. import tuned
    from ..framework import compile_plan

    fn = tuned._resolve_algo("allreduce", algo)
    if fn is None:
        return None
    dt = getattr(torch, _cache.dtype_name(dtype))
    elems = max(1, nbytes // max(1, dt.itemsize))
    x = torch.ones((comm.size, elems), dtype=dt, device=comm.device)
    key = ("sched.tune", algo, op.cache_key, tuple(x.shape), str(x.dtype))
    try:
        plan = compile_plan(comm, key, lambda b: fn(b, op))
        plan(x)  # warm-up (kernel builds, first launches)
        _sync(comm.device)
        best = float("inf")
        for _ in range(max(1, iters)):
            t0 = time.perf_counter()
            plan(x)
            _sync(comm.device)
            best = min(best, time.perf_counter() - t0)
        return best
    except ArgumentError as exc:
        logger.info("sched: %s skipped at %d B: %s", algo, nbytes, exc)
        return None


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def tune(nranks: int, *, comm=None, opname: str = "allreduce",
         sizes: Sequence[int] = DEFAULT_SIZES,
         dtypes: Sequence = ("float32",),
         mode: Optional[str] = None, seed: Optional[int] = None,
         topo_fp: Optional[str] = None, save: bool = True,
         include_pallas: bool = False) -> dict:
    """Sweep the candidate space and persist winners.

    Returns {"winners": {key: algo}, "skipped": [...], "path": ...,
    "digest": ..., "tune_ms": ..., "times": {...}} — ``times`` carries
    the per-candidate scores (model) or best seconds (measure) of every
    sweep point, keyed ``"<dtype>|b<bucket>"``.
    """
    from ...ops import lookup as op_lookup
    from ...trace import span as tspan
    from ..tuned import _algo_space

    mode = mode or _mode_var.value
    seed = _seed_var.value if seed is None else seed
    if mode == "measure" and comm is None:
        raise ValueError("measure mode needs a live communicator")
    if topo_fp is None:
        topo_fp = fingerprint()
    op = op_lookup("sum")
    t0 = time.perf_counter()
    winners: dict[str, str] = {}
    all_times: dict[str, dict[str, float]] = {}
    skipped_all: list[str] = []
    known = _algo_space(opname)
    for dtype in dtypes:
        allowed, skipped = candidates(
            opname, nranks, dtype=dtype, op=op,
            include_pallas=include_pallas,
        )
        skipped_all.extend(a for a in skipped if a not in skipped_all)
        allowed = [a for a in allowed if a in known]
        if not allowed:
            continue
        seen_buckets: set[int] = set()
        for size in sizes:
            bucket = _cache.size_bucket(size)
            if bucket in seen_buckets:
                continue
            seen_buckets.add(bucket)
            times: dict[str, float] = {}
            for algo in allowed:
                if mode == "measure":
                    got = measure_cost(comm, algo, size, dtype, op,
                                       _iters_var.value)
                    if got is not None:
                        times[algo] = got
                else:
                    times[algo] = model_cost(algo, size, nranks, seed)
            if not times:
                continue
            best = min(times, key=times.get)
            key = _cache.cache_key(opname, size, nranks, dtype, topo_fp)
            _cache.CACHE.put(
                key, best, schedule=_schedule_id(best, nranks),
                source=mode,
                score=times[best] if mode == "model" else None,
                tune_ms=(times[best] * 1e3 if mode == "measure"
                         else None),
            )
            winners[key] = best
            tspan.instant("sched.tune_winner", cat="sched", key=key,
                          algo=best, mode=mode,
                          candidates=len(times))
            all_times[f"{_cache.dtype_name(dtype)}|b{bucket}"] = times
    tune_ms = (time.perf_counter() - t0) * 1e3
    SPC.record("sched_tune_ms", tune_ms)
    out = {
        "winners": winners,
        "skipped": skipped_all,
        "mode": mode,
        "seed": seed,
        "topo_fp": topo_fp,
        "digest": _cache.CACHE.digest(),
        "tune_ms": tune_ms,
        "times": all_times,
        "path": None,
    }
    if save and winners:
        out["path"] = _cache.CACHE.save(
            _cache.default_path(topo_fp, nranks))
    logger.info("sched: tuned %d key(s) in %.1f ms (mode=%s, "
                "skipped=%s)", len(winners), tune_ms, mode,
                skipped_all or "none")
    return out


#: sched_* algorithm name -> ir generator name.
SCHED_GENERATOR = {
    "sched_ring": "ring",
    "sched_rd": "recursive_doubling",
    "sched_ring_seg": "segmented_ring",
    "sched_hier": "hierarchical",
    "sched_quant": "quantized_wire",
    # the pallas-compiled names share their base generator's digest:
    # the step program is identical, only the lowering differs.
    "sched_pallas_ring": "ring",
    "sched_pallas_ring_seg": "segmented_ring",
}


def _schedule_id(algo: str, nranks: int) -> str:
    """The IR digest backing a sched_* winner ('' for primitive
    tiers) — recorded in the cache entry so a dumped cache names the
    exact step program version it selected."""
    gen = SCHED_GENERATOR.get(algo)
    if gen is None:
        return ""
    from . import ir

    try:
        return ir.generate(gen, nranks).digest()
    except ir.ScheduleError:
        return ""


_fp_cache: Optional[str] = None


def fingerprint() -> str:
    """The current process's topology fingerprint (cached)."""
    global _fp_cache
    if _fp_cache is None:
        from ...topo import hardware_fingerprint

        _fp_cache = hardware_fingerprint()
    return _fp_cache


def reset_fingerprint() -> None:
    global _fp_cache
    _fp_cache = None


__all__ = [
    "DEFAULT_SIZES", "SCHED_GENERATOR", "candidates", "fingerprint",
    "measure_cost", "model_cost", "reset_fingerprint", "tune",
]
