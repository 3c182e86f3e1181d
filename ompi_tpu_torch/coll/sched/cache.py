"""Versioned on-disk schedule cache (port of
``ompi_tpu/coll/sched/cache.py``: the same key grammar, JSON format and
digest). Its directory is the port's own: a cache tuned on a TPU must
never route the port, so the default is ``~/.cache/ompi_tpu_torch/sched``
(or ``$OMPI_TPU_TORCH_SCHED_CACHE``), never the JAX package's.

The autotuner's winners persist as JSON keyed by
``op|size-bucket|dtype|nranks|topology-fingerprint`` so a fleet warms
once: the first controller (or an offline ``tools/sched warm`` run)
sweeps and writes the cache; every later process loads it and
dispatches winners with zero first-call tune cost. Size buckets are
log2 of the **bytes-per-rank** payload — the same convention
Rules._matches and decide_* use (DESIGN.md §18), so a rules band and a
cache entry keyed from the same payload always agree on the byte
count.

Determinism contract: ``digest()`` is the sha256 of the canonical JSON
of {version, entries → {algorithm, schedule}} — wall-clock timings and
scores are stored alongside for inspection but EXCLUDED, so a
same-seed autotune run produces a byte-identical digest on every
controller (the same reproducibility contract the health ledger's
transition digest carries). A version-mismatched file is ignored (and
counted), never migrated: stale schedules must lose to a fresh sweep,
not be reinterpreted.

An entry may carry the training step's fields, as the JAX package
writes them: ``tile_bytes`` (``autotune.tune_step``), ``ag_deadline``
and ``resident`` (``autotune.tune_residency``); they join the digest
only when present. Not written yet: the retune plane's version bumps
and rollbacks and the watchtower's baselines (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from functools import partial
from typing import Optional

from ...core import config
from ...core.logging import get_logger

logger = get_logger("coll.sched")

#: Bump when the entry format or the key grammar changes.
VERSION = 1

_V = partial(config.register, "coll", "sched")
_enable_var = _V(
    "cache_enable", type=bool, default=True,
    description="Consult the compiled-schedule cache in decide_* "
                "(static priors remain the cold-start fallback)",
)
_dir_var = _V(
    "cache_dir", type=str, default="",
    description="Directory for the persisted schedule cache "
                "(default: $OMPI_TPU_TORCH_SCHED_CACHE or "
                "~/.cache/ompi_tpu_torch/sched)",
)


def cache_dir() -> str:
    d = _dir_var.value
    if d:
        return d
    env = os.environ.get("OMPI_TPU_TORCH_SCHED_CACHE", "")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "ompi_tpu_torch", "sched")


def size_bucket(nbytes_per_rank: int) -> int:
    """log2 bucket of a bytes-per-rank payload (0 for <=1 byte)."""
    return max(0, int(nbytes_per_rank).bit_length() - 1)


def bucket_bytes(bucket: int) -> int:
    """Representative bytes-per-rank for a bucket (its lower edge)."""
    return 1 << bucket


def dtype_name(dtype) -> str:
    """The JAX package's name of a dtype: ``torch.float32`` and
    ``"float32"`` are both ``float32``, so a key tuned from a name and
    one built from a tensor's dtype agree."""
    return str(dtype).removeprefix("torch.")


def cache_key(opname: str, nbytes_per_rank: int, nranks: int,
              dtype=None, topo_fp: str = "") -> str:
    dt = dtype_name(dtype) if dtype is not None else "any"
    return (f"{opname}|b{size_bucket(nbytes_per_rank)}|{dt}"
            f"|r{nranks}|{topo_fp or 'none'}")


def default_path(topo_fp: str, nranks: int) -> str:
    return os.path.join(
        cache_dir(),
        f"sched_v{VERSION}_r{nranks}_{(topo_fp or 'none')[:16]}.json",
    )


class ScheduleCache:
    """In-memory view of the persisted winner table."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._entries: dict[str, dict] = {}
        # (config generation, topo_fp, nranks) stamps whose default-path
        # load was already attempted (hit or miss): the dispatch path
        # pays one set lookup per consult, and a config mutation
        # (cache_dir change, test reset) re-arms the attempt.
        self._load_attempted: set = set()
        self._load_gen = -1
        # bumped on every content change; memoized dispatch plans
        # (tuned._fast_allreduce) stamp it so a warm or a tune
        # invalidates them.
        self._generation = 0

    # -- entries -------------------------------------------------------

    def put(self, key: str, algorithm: str, *, schedule: str = "",
            source: str = "autotune", tune_ms: Optional[float] = None,
            score: Optional[float] = None,
            tile_bytes: Optional[int] = None,
            ag_deadline: Optional[int] = None,
            resident: Optional[bool] = None) -> None:
        ent = {"algorithm": algorithm, "schedule": schedule,
               "source": source, "version": 1}
        if tile_bytes is not None:
            ent["tile_bytes"] = int(tile_bytes)
        if ag_deadline is not None:
            ent["ag_deadline"] = int(ag_deadline)
        if resident is not None:
            ent["resident"] = bool(resident)
        if tune_ms is not None:
            ent["tune_ms"] = round(float(tune_ms), 3)
        if score is not None:
            ent["score"] = float(score)
        with self._mu:
            self._entries[key] = ent
            self._generation += 1

    def get(self, key: str) -> Optional[dict]:
        return self._entries.get(key)

    def entries(self) -> dict[str, dict]:
        with self._mu:
            return dict(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        with self._mu:
            self._entries.clear()
            self._load_attempted.clear()
            self._generation += 1

    def generation(self) -> int:
        """Content-change counter (see __init__)."""
        return self._generation

    # -- digest / persistence ------------------------------------------

    def digest(self) -> str:
        """sha256 over the semantic content only (version + winners);
        timings/scores excluded — the byte-identical-across-controllers
        contract."""
        with self._mu:
            canon = {
                "version": VERSION,
                "entries": {
                    k: {"algorithm": e["algorithm"],
                        "schedule": e.get("schedule", ""),
                        "version": int(e.get("version", 1)),
                        # the training step's tile geometry and shard
                        # residency change what executes: they join the
                        # digest, only when present (so a cache without
                        # them keeps its digest)
                        **({"tile_bytes": int(e["tile_bytes"])}
                           if "tile_bytes" in e else {}),
                        **({"ag_deadline": int(e["ag_deadline"])}
                           if "ag_deadline" in e else {}),
                        **({"resident": bool(e["resident"])}
                           if "resident" in e else {})}
                    for k, e in sorted(self._entries.items())
                },
            }
        blob = json.dumps(canon, sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()

    def save(self, path: str) -> str:
        doc = {
            "version": VERSION,
            "digest": self.digest(),
            "entries": self.entries(),
        }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)  # atomic: readers never see a torn file
        logger.info("sched: saved %d schedule(s) to %s", len(self), path)
        return path

    def load(self, path: str) -> int:
        """Merge entries from ``path``; returns the number loaded.
        Version mismatches and unreadable files load nothing."""
        from ...core.counters import SPC

        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return 0
        if doc.get("version") != VERSION:
            SPC.record("sched_cache_version_mismatch")
            logger.warning(
                "sched: cache %s has version %r (want %d); ignored",
                path, doc.get("version"), VERSION,
            )
            return 0
        entries = doc.get("entries")
        if not isinstance(entries, dict):
            return 0
        loaded = 0
        with self._mu:
            for k, e in entries.items():
                if isinstance(e, dict) and e.get("algorithm"):
                    self._entries[k] = e
                    loaded += 1
            if loaded:
                self._generation += 1
        return loaded

    def ensure_loaded(self, topo_fp: str, nranks: int) -> None:
        """Attempt the default-path disk load once per (config
        generation, topo_fp, nranks)."""
        stamp = (config.generation(), topo_fp, nranks)
        if stamp in self._load_attempted:
            return
        with self._mu:
            if stamp[0] != self._load_gen:
                self._load_attempted.clear()
                self._load_gen = stamp[0]
            if stamp in self._load_attempted:
                return
            self._load_attempted.add(stamp)
        path = default_path(topo_fp, nranks)
        n = self.load(path)
        if n:
            logger.info("sched: warmed %d schedule(s) from %s", n, path)

    def active(self) -> bool:
        """True once any entry exists — the gate for counting misses
        (an unconfigured process should not drown monitoring in
        sched_cache_misses)."""
        return bool(self._entries)


CACHE = ScheduleCache()

__all__ = [
    "CACHE", "VERSION", "ScheduleCache", "bucket_bytes", "cache_dir",
    "cache_key", "default_path", "dtype_name", "size_bucket",
]
