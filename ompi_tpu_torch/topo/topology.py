"""The hardware fingerprint (port of
``ompi_tpu/topo/topology.py:hardware_fingerprint``; the rest of topo is
not ported yet, ROADMAP Queue 1 item 6)."""

from __future__ import annotations

import hashlib
import json


def hardware_fingerprint(procs=None) -> str:
    """Stable digest of the hardware topology a schedule was tuned on.

    Canonicalizes what changes a collective schedule's cost surface —
    rank count, the host-group and slice-group partition shapes, and
    the device kinds (the platform: ``gpu`` or ``cpu``) — with the JAX
    package's canonical JSON and hash, so the tuned schedule cache is
    keyed to "machines shaped like this": a cache warmed on the card is
    never replayed on the CPU, nor one warmed on a TPU on the card.
    """
    from ..runtime import mesh

    if procs is None:
        procs = mesh.live_procs()
    canon = {
        "nranks": len(procs),
        "hosts": sorted(len(g) for g in mesh.hosts_of(procs).values()),
        "slices": sorted(len(g) for g in mesh.slices_of(procs).values()),
        "kinds": sorted({p.platform for p in procs}),
    }
    blob = json.dumps(canon, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]
