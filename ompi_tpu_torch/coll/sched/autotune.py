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
quarantined yet). The program tier (``program_tile_bytes``,
``ag_elision_wins``, ``program_node_choice``, ``program_choices``,
``tune_step``, ``tune_residency``) makes the training step's choices:
per-bucket tile geometry, allreduce vs RS/AG vs shard residency, and
the interleave, by the JAX package's coefficients, so both packages
compile the same step program.
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


# ---------------------------------------------------------------------------
# program-level choices (the step as the compilation unit)
# ---------------------------------------------------------------------------

SPC.counter(
    "sched_program_tile_overrides_total",
    "bucket tile geometries taken from the winner cache instead of "
    "the static default when compiling a step program",
)
SPC.counter(
    "sched_program_compiles_total",
    "whole-step comm programs compiled",
)
SPC.counter(
    "sched_window_spans_total",
    "step-boundary window spans armed: a step's merged broadcast tail "
    "dispatched past its own finish into the next step's window "
    "(slipstream)",
)
SPC.counter(
    "sched_ag_elided_total",
    "allgather program nodes elided by shard residency (rs_resident): "
    "the owner shard stays resident on the optimizer path and the next "
    "forward reads it directly",
)
SPC.counter(
    "sched_tail_overlap_ms",
    "milliseconds of merged-broadcast tail execution hidden under the "
    "next step's backward (slipstream window overlap)",
    unit="ms",
)

#: Power-of-two tile-size sweep for the per-bucket geometry model.
PROGRAM_TILE_CANDIDATES = (64 << 10, 128 << 10, 256 << 10, 512 << 10,
                           1 << 20)

#: The JAX package's coefficients, kept so that both packages compile
#: the same step program and digest (fitting them on the card is later
#: work, ROADMAP Queue 1 item 1).
#: Per-tile dispatch cost vs per-byte tail-exposure cost (relative
#: units, host transport): every tile pays a stage + Pready burst +
#: drain sweep, while a larger final tile only lengthens the exposed
#: tail — so the model leans toward few large tiles and the overlap
#: granularity stays bucket-level.
_PROG_TILE_A = 6000.0   # per tile
_PROG_TILE_B = 0.02     # per byte of tile exposure

#: RS/AG-vs-allreduce decision: gather-to-root pays one persistent
#: pair per peer and the full bucket through the root's wire; the
#: ZeRO-style split pays n× the pair setup but 1/n of the per-root
#: wire. Crossover ~ _PROG_PAIR_GAMMA·n/_PROG_WIRE_BETA bytes.
_PROG_PAIR_GAMMA = 4000.0  # per persistent pair armed per step
_PROG_WIRE_BETA = 1e-3     # per bucket byte through one root

#: Shard-residency (rs_resident) decision: eliding the allgather saves
#: its full wire share, but the next forward must read the reduced
#: shard from the resident owner (a host-local replication, _ETA per
#: byte) and params consumed early in the forward can't hide that
#: deferred read — _URGENCY decays with the consuming layer's distance
#: (the node's ag_deadline).
_PROG_RESIDENT_ETA = 2e-4      # per byte read from the resident owner
_PROG_RESIDENT_URGENCY = 2000.0  # first-layer penalty, ~1/(1+deadline)


def program_tile_bytes(nbytes: int, nranks: int, seed: int) -> int:
    """Deterministic model winner for one bucket's tile size: argmin
    over the power-of-two sweep of per-tile dispatch cost plus tail
    exposure, seed-jittered for stable tie-breaks (crc32, not hash())."""
    best, best_cost = PROGRAM_TILE_CANDIDATES[0], float("inf")
    for t in PROGRAM_TILE_CANDIDATES:
        tiles = max(1, -(-int(nbytes) // t))
        cost = (_PROG_TILE_A * tiles + _PROG_TILE_B * min(t, nbytes)
                + zlib.crc32(f"{seed}:tile:{t}".encode()) % 997 * 1e-9)
        if cost < best_cost:
            best, best_cost = t, cost
    return best


def ag_elision_wins(nbytes: int, nranks: int, seed: int,
                    ag_deadline: int) -> bool:
    """Shard-residency decision for one RS/AG pair: elide the allgather
    when its wire share beats the resident-owner read plus the
    consume-urgency penalty (seed-jittered tie-break, crc32 never
    hash())."""
    n = max(2, nranks)
    ag_wire = _PROG_WIRE_BETA * nbytes * (n - 1) / n
    read = _PROG_RESIDENT_ETA * nbytes
    urgency = _PROG_RESIDENT_URGENCY / (1.0 + max(0, int(ag_deadline)))
    jitter = (zlib.crc32(f"{seed}:res:{int(ag_deadline)}".encode())
              % 997 * 1e-9)
    return ag_wire > read + urgency + jitter


def program_node_choice(nbytes: int, nranks: int, seed: int, *,
                        ag_deadline: Optional[int] = None,
                        resident: Optional[bool] = None) -> str:
    """'allreduce' (gather-to-root + merged bcast) vs 'rs_ag' (ZeRO-
    style reduce-scatter + allgather pair) for one bucket, by the
    pair-setup/root-wire cost model.

    With an ``ag_deadline`` (the step-N+1 forward layer that first
    consumes this bucket) the pair choice may deepen into
    'rs_resident': the allgather node is elided entirely and the next
    forward reads the reduced shard from the resident owner (ZeRO-2/3).
    ``resident`` pins a cache-learned residency decision (True forces
    the elision, False forbids it, None lets the model decide)."""
    n = max(2, nranks)
    cost_ar = (_PROG_PAIR_GAMMA * (n - 1)
               + _PROG_WIRE_BETA * nbytes * (n - 1)
               + zlib.crc32(f"{seed}:ar".encode()) % 997 * 1e-9)
    cost_rs = (_PROG_PAIR_GAMMA * n * (n - 1)
               + _PROG_WIRE_BETA * nbytes * (n - 1) / n
               + zlib.crc32(f"{seed}:rs".encode()) % 997 * 1e-9)
    base = "allreduce" if cost_ar <= cost_rs else "rs_ag"
    if nranks < 2:
        return base
    if resident is not None:
        return "rs_resident" if resident else base
    if (base == "rs_ag" and ag_deadline is not None
            and ag_elision_wins(nbytes, nranks, seed, ag_deadline)):
        return "rs_resident"
    return base


def program_choices(bucket_nbytes: Sequence[int], nranks: int, *,
                    dtypes: Optional[Sequence] = None,
                    seed: Optional[int] = None,
                    topo_fp: Optional[str] = None,
                    tile_bytes=None,
                    node_choices: Optional[Sequence] = None,
                    ag_deadlines: Optional[Sequence] = None) -> list:
    """Program-level search for one training step: per bucket, the
    tile geometry (caller > winner cache > model, in that precedence),
    the RS/AG-vs-allreduce schedule decision, and the cross-bucket
    interleave rank. Deterministic for a fixed (buckets, nranks, seed,
    cache state) — these choices feed the program digest, so same-seed
    controllers must compute byte-identical answers.

    ``ag_deadlines`` (per bucket, None entries allowed) names the
    step-N+1 forward layer that first consumes each bucket; with a
    deadline known the pair choice may deepen into 'rs_resident' (AG
    node elided, owner shard stays resident). Deadline and residency
    follow the same precedence as tile geometry: caller > winner cache
    (``ag_deadline`` / ``resident`` entry fields, carried through
    bump/rollback like tile_bytes) > model. A caller-pinned 'rs_ag'
    with a deadline still consults the residency model — pin
    'rs_resident' or 'allreduce' to fix the choice outright.

    Returns one dict per bucket: {"choice", "tile_bytes",
    "tile_source", "interleave", "ag_deadline"} where interleave is the
    bucket's arm position (biggest buckets first — their wire time is
    the hardest to hide, so they enter the fabric earliest).
    """
    seed = _seed_var.value if seed is None else seed
    if topo_fp is None:
        topo_fp = fingerprint()
    sizes = [int(b) for b in bucket_nbytes]
    out: list[dict] = []
    for i, nbytes in enumerate(sizes):
        dtype = (dtypes[i] if dtypes is not None else "float32")
        ent = _cache.CACHE.get(_cache.cache_key(
            "allreduce", nbytes, nranks, dtype, topo_fp)) or {}
        if tile_bytes is not None:
            tb = (tile_bytes[i] if isinstance(tile_bytes, (list, tuple))
                  else tile_bytes)
            tb, src = int(tb), "caller"
        elif ent.get("tile_bytes"):
            tb, src = int(ent["tile_bytes"]), "cache"
            SPC.record("sched_program_tile_overrides_total")
        else:
            tb, src = program_tile_bytes(nbytes, nranks, seed), "model"
        dl = ag_deadlines[i] if ag_deadlines is not None else None
        if dl is None and ent.get("ag_deadline") is not None:
            dl = int(ent["ag_deadline"])
        resident = ent.get("resident")
        if resident is not None:
            resident = bool(resident)
        if node_choices is not None and node_choices[i]:
            choice = str(node_choices[i])
            if choice == "rs_ag" and nranks >= 2:
                if resident is True:
                    choice = "rs_resident"
                elif (resident is None and dl is not None
                        and ag_elision_wins(nbytes, nranks, seed, dl)):
                    choice = "rs_resident"
        else:
            choice = program_node_choice(nbytes, nranks, seed,
                                         ag_deadline=dl,
                                         resident=resident)
        out.append({"choice": choice, "tile_bytes": tb,
                    "tile_source": src, "interleave": i,
                    "ag_deadline": None if dl is None else int(dl)})
    # Cross-bucket interleave: arm biggest-first, index as tie-break
    # (stable and seed-independent so the order never fights the
    # digest contract).
    order = sorted(range(len(sizes)), key=lambda i: (-sizes[i], i))
    for pos, i in enumerate(order):
        out[i]["interleave"] = pos
    return out


def tune_step(nranks: int, bucket_nbytes: Sequence[int], *,
              dtype="float32", seed: Optional[int] = None,
              topo_fp: Optional[str] = None, save: bool = False) -> dict:
    """Persist model-mode tile-geometry winners for a step's bucket
    sizes into the winner cache (the program-level analog of tune()):
    later compile_step calls on any same-seed controller pick these
    entries up as 'cache'-sourced overrides. Existing algorithm
    winners on a key are preserved (tile_bytes rides the entry)."""
    from ...trace import span as tspan

    seed = _seed_var.value if seed is None else seed
    if topo_fp is None:
        topo_fp = fingerprint()
    keys = []
    for nbytes in {int(b) for b in bucket_nbytes}:
        key = _cache.cache_key("allreduce", nbytes, nranks, dtype,
                               topo_fp)
        tb = program_tile_bytes(nbytes, nranks, seed)
        ent = _cache.CACHE.get(key)
        if ent is None:
            _cache.CACHE.put(key, "native", source="model",
                             tile_bytes=tb)
        else:
            _cache.CACHE.put(
                key, ent["algorithm"],
                schedule=ent.get("schedule", ""),
                source=ent.get("source", "model"),
                tile_bytes=tb)
        tspan.instant("sched.tune_step_tile", cat="sched", key=key,
                      tile_bytes=tb, seed=seed)
        keys.append(key)
    out = {"keys": sorted(keys), "seed": seed, "topo_fp": topo_fp,
           "digest": _cache.CACHE.digest(), "path": None}
    if save and keys:
        out["path"] = _cache.CACHE.save(
            _cache.default_path(topo_fp, nranks))
    return out


def tune_residency(nranks: int, bucket_nbytes: Sequence[int],
                   ag_deadlines: Sequence[int], *, dtype="float32",
                   seed: Optional[int] = None,
                   topo_fp: Optional[str] = None,
                   save: bool = False) -> dict:
    """Persist learned shard-residency decisions into the winner cache
    (the slipstream analog of tune_step): for each bucket size, the
    forward-consume deadline and the model's elide-the-AG verdict ride
    the cache entry (``ag_deadline`` / ``resident``), so later
    compile_step/compile_window calls on any same-seed controller
    recover the same residency plan even when the caller passes no
    deadlines. Existing algorithm winners and tile geometry on a key
    are preserved."""
    from ...trace import span as tspan

    seed = _seed_var.value if seed is None else seed
    if topo_fp is None:
        topo_fp = fingerprint()
    keys = []
    for nbytes, dl in zip(bucket_nbytes, ag_deadlines):
        nbytes, dl = int(nbytes), int(dl)
        key = _cache.cache_key("allreduce", nbytes, nranks, dtype,
                               topo_fp)
        resident = (program_node_choice(nbytes, nranks, seed,
                                        ag_deadline=dl)
                    == "rs_resident")
        ent = _cache.CACHE.get(key)
        if ent is None:
            _cache.CACHE.put(key, "native", source="model",
                             ag_deadline=dl, resident=resident)
        else:
            _cache.CACHE.put(
                key, ent["algorithm"],
                schedule=ent.get("schedule", ""),
                source=ent.get("source", "model"),
                tile_bytes=ent.get("tile_bytes"),
                ag_deadline=dl, resident=resident)
        tspan.instant("sched.tune_residency", cat="sched", key=key,
                      ag_deadline=dl, resident=resident, seed=seed)
        keys.append(key)
    out = {"keys": sorted(keys), "seed": seed, "topo_fp": topo_fp,
           "digest": _cache.CACHE.digest(), "path": None}
    if save and keys:
        out["path"] = _cache.CACHE.save(
            _cache.default_path(topo_fp, nranks))
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
    "DEFAULT_SIZES", "PROGRAM_TILE_CANDIDATES", "SCHED_GENERATOR",
    "ag_elision_wins", "candidates", "fingerprint", "measure_cost",
    "model_cost", "program_choices", "program_node_choice",
    "program_tile_bytes", "reset_fingerprint", "tune", "tune_residency",
    "tune_step",
]
