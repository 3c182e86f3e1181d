"""coll/quant — block-scaled quantized allreduce wire tier (port of
``ompi_tpu/coll/quant.py``).

Large allreduces are wire-bound: the bytes each ring hop carries bound
the achievable bandwidth, so halving (bf16) or quartering (int8) them
raises effective bandwidth by the same factor at a small, bounded
accuracy cost for gradient-style sums (EQuARX, arxiv 2506.17615).

Wire formats
  * ``int8``  — block-scaled: the flattened payload is cut into blocks
    of ``coll_quant_block`` elements (default 128); each block ships as
    int8 values plus ONE f32 scale ``max|x|_block / 127``. Wire bytes
    per f32 element: ``1 + 4/block`` → 3.88x compression at block=128.
  * ``bf16``  — plain downcast, no scales, 2x compression.

``allreduce_quant_ring`` is the JAX package's XLA ring over the rank
axis of a rank-major ``(n, ...)`` tensor: the carried partial stays in
wire format between hops (dequantize the arriving block, add the local
one in f32, requantize), a ring shift is a roll over the rank axis, and
the allgather phase circulates the final wire image, which every rank
dequantizes once at the end.

``allreduce_block_quant`` runs the same dequant-accumulate-requant ring
on the hand-written kernel ``csrc/quant_allreduce.cu`` (the JAX
package's ``_quant_allreduce_kernel``): int8 only, 128-element rows,
one f32 scale per row, whatever ``coll_quant_wire`` and
``coll_quant_block`` say, as in the JAX package. Its wrapper
``quant_allreduce`` launches the kernel for a CUDA tensor and runs the
plain version, the flag-level protocol simulator
``simulate_quant_ring``, for a CPU one. The kernel makes one pass per
step in a wavefront over segments of rows, each pass requantizing
straight into the right neighbour's buffer (a cluster's shared memory
up to 8 ranks, L2 beyond), and credits a buffer only after the passes
that read it; the JAX kernel credits after filling the slot it still
has to send from (``quant.py:375-377``, ``:416-421``), which loses
partials when ranks truly run at once.
``simulate_quant_ring(credit="reference")`` shows it on the first
port's lock-step schedule (``form="lockstep"``).

Exactness rules: only SUM on floating-point payloads goes over the
quantized wire. Order statistics (MAX/MIN), non-commutative ops, joint
ops (MAXLOC) and integer dtypes are refused (``supports`` returns
False) and take the exact tier, so ``allreduce(max)`` through a
quant-enabled communicator stays bit-exact. ``coll/tuned`` enforces
this, the byte cutoff and the rules-file veto.

Error feedback (opt-in): the residual ``e_t = (x + e_{t-1}) -
roundtrip(x + e_{t-1})`` is carried across calls (:class:`ErrorFeedback`).

The arithmetic is the JAX package's, operation by operation: IEEE
divisions by a tensor (never by a Python scalar, which PyTorch's CUDA
division turns into a multiplication by the reciprocal), ``torch.round``
(half to even, as ``jnp.round``), a clip to ±127 before the int8 cast,
scale 1 for an all-zero block, and the dequantize-accumulate as a
rounded product then a rounded sum.
"""

from __future__ import annotations

import collections
import functools
import random
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core import config
from ..core.counters import SPC, KernelCounter
from ..core.device import require_kernel_device
from ..core.errors import ArgumentError, KernelError
from ..ops import Op, lookup as op_lookup
from .pallas_ring import (CHUNKED_SMEM_BYTES, LANES, RS_BUFS, _PAUSE,
                          _ch_forwards, _checked, _clusters, _drive, _entry,
                          _plain_seg, _raw_stream, _residue, _scratch,
                          _wave_plan)

__all__ = [
    "supports", "quantize_block_scaled", "dequantize_block_scaled",
    "allreduce_quant_ring", "allreduce_block_quant", "wire_bytes",
    "compression_ratio", "analytic_error_bound", "ErrorFeedback",
    "allreduce_error_feedback", "quant_allreduce", "quant_allreduce_plain",
    "simulate_quant_ring",
]

_V = functools.partial(config.register, "coll", "quant")
_enable_var = _V(
    "enable", type=bool, default=False,
    description="Let coll/tuned pick the quantized wire for large "
                "floating-point SUM allreduces",
)
_wire_var = _V(
    "wire", type=str, default="int8",
    description="Quantized wire format: int8 (block-scaled) or bf16 "
                "(downcast)",
)
_block_var = _V(
    "block", type=int, default=128,
    description="Elements per int8 scale block (one f32 scale each)",
)
_min_bytes_var = _V(
    "min_bytes", type=int, default=64 << 10,
    description="Per-rank payload bytes below which quant is refused "
                "(quant trades FLOPs for wire bytes; small messages "
                "are dispatch-bound, not wire-bound)",
)

_ef_var = _V(
    "error_feedback", type=bool, default=False,
    description="Carry the quantization residual across calls "
                "(opt-in; host-side state, see quant.ErrorFeedback)",
)

_INT8_LEVELS = 127.0

QUANT = KernelCounter("quant_allreduce")


def _dtype_of(dtype: Any) -> Optional[torch.dtype]:
    """A torch dtype from a torch dtype or its name ("float32")."""
    if isinstance(dtype, torch.dtype):
        return dtype
    got = getattr(torch, str(dtype), None)
    return got if isinstance(got, torch.dtype) else None


def supports(op: Op | str | None, dtype: Any | None) -> bool:
    """True when (op, dtype) may take the quantized wire: a commutative
    non-joint accumulation with a native sum over a floating payload.
    MAX/MIN are order statistics — any representable-value change
    alters the result, so they are refused and stay exact."""
    if op is None or dtype is None:
        return False
    op = op_lookup(op)
    if not op.commutative or op.joint:
        return False
    if op.native_reduce != "sum":
        return False
    dt = _dtype_of(dtype)
    return dt is not None and dt.is_floating_point


def wire_bytes(logical_bytes: int, itemsize: int = 4,
               wire: str | None = None, block: int | None = None) -> int:
    """Bytes on the wire for a logical payload of ``logical_bytes``."""
    wire = wire or _wire_var.value
    block = block or _block_var.value
    elems = max(1, logical_bytes // max(1, itemsize))
    if wire == "bf16":
        return elems * 2
    nblocks = -(-elems // block)
    return elems + 4 * nblocks


def compression_ratio(itemsize: int = 4, wire: str | None = None,
                      block: int | None = None) -> float:
    """Logical/wire ratio for the configured format (analytic)."""
    logical = 1 << 20
    return logical * itemsize / wire_bytes(logical * itemsize, itemsize,
                                           wire, block)


def record_wire_stats(logical_bytes: int, itemsize: int,
                      wire: str | None = None,
                      block: int | None = None) -> None:
    """SPC pvars for one quantized dispatch (host-side, at plan time):
    ``coll_quant_bytes_on_wire`` and ``coll_quant_bytes_logical`` count
    the bytes shipped and the bytes the same payloads would have
    shipped; the gauge ``coll_quant_compression_ratio`` holds the most
    recent dispatch's ratio."""
    wb = wire_bytes(logical_bytes, itemsize, wire, block)
    SPC.record("coll_quant_bytes_on_wire", wb)
    SPC.record("coll_quant_bytes_logical", logical_bytes)
    SPC.set("coll_quant_compression_ratio", logical_bytes / max(1, wb))
    from ..trace import span as tspan

    tspan.instant("quant.wire", cat="coll", logical=logical_bytes,
                  wire=wb, ratio=round(logical_bytes / max(1, wb), 3))


# ---------------------------------------------------------------------------
# Block-scaled codec (the XLA ring, the error-feedback residual; the
# kernel and its plain version use the same math on (rows, 128) tiles).
# ---------------------------------------------------------------------------

def _levels(like: torch.Tensor) -> torch.Tensor:
    """127 as a tensor on ``like``'s device: dividing by it is an IEEE
    division on every device. Filled on the device, so no host copy
    stalls the host."""
    return torch.full((), _INT8_LEVELS, dtype=torch.float32,
                      device=like.device)


def _quantize(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., block) f32 -> ((..., block) int8, (..., 1) f32 scales)."""
    m = v.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(m > 0, m / _levels(m), torch.ones_like(m))
    q = torch.clamp(torch.round(v / scale), -_INT8_LEVELS, _INT8_LEVELS)
    return q.to(torch.int8), scale


def quantize_block_scaled(x: torch.Tensor, block: int | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat f32/bf16 ``(m,)`` payload (m % block == 0) -> (int8 ``(m,)``
    values, f32 ``(m/block,)`` scales). scale = max|x|_block / 127;
    all-zero blocks get scale 1 so the roundtrip stays exact."""
    block = block or _block_var.value
    q, scale = _quantize(x.to(torch.float32).reshape(-1, block))
    return q.reshape(-1), scale.reshape(-1)


def dequantize_block_scaled(q: torch.Tensor, scales: torch.Tensor,
                            block: int | None = None) -> torch.Tensor:
    """Inverse of :func:`quantize_block_scaled` (f32 result)."""
    block = block or _block_var.value
    v = q.to(torch.float32).reshape(-1, block)
    return (v * scales.reshape(-1, 1)).reshape(-1)


def quant_roundtrip(x: torch.Tensor, wire: str | None = None,
                    block: int | None = None) -> torch.Tensor:
    """What the far side reconstructs from x's wire image (any shape)."""
    wire = wire or _wire_var.value
    if wire == "bf16":
        return x.to(torch.bfloat16).to(torch.float32).reshape(x.shape)
    block = block or _block_var.value
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    q, s = quantize_block_scaled(flat, block)
    out = dequantize_block_scaled(q, s, block)
    if pad:
        out = out[:-pad]
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# The XLA ring of the JAX package, over the rank axis.
# ---------------------------------------------------------------------------

def _flatten_pad_quant(x: torch.Tensor, n: int, block: int
                       ) -> tuple[torch.Tensor, int]:
    """Ravel each rank's row and zero-pad it so each of the n ring
    blocks is a whole number of scale blocks (element count divides
    n*block): (ranks, padded) and the unpadded per-rank count."""
    flat = x.reshape(x.shape[0], -1)
    total = flat.shape[1]
    quantum = n * block
    padded = -(-total // quantum) * quantum
    if padded != total:
        flat = F.pad(flat, (0, padded - total))
    return flat, total


def allreduce_quant_ring(x: torch.Tensor, op: Any = "sum",
                         wire: str | None = None,
                         block: int | None = None) -> torch.Tensor:
    """Quantized-wire ring allreduce of the rank-major contributions
    ``x`` (n, ...). Callers (coll/tuned) gate on :func:`supports`;
    calling this with an unsupported op raises ``ValueError``."""
    op = op_lookup(op)
    wire = wire or _wire_var.value
    block = block or _block_var.value
    n = x.shape[0]
    if n == 1:
        return x
    if op.native_reduce != "sum":
        raise ValueError(
            f"quant wire supports SUM only, got {op.name!r} "
            f"(tuned must refuse this op)"
        )
    rank = torch.arange(n, device=x.device)
    flat, total = _flatten_pad_quant(x, n, block)
    blocks = flat.to(torch.float32).reshape(n, n, -1)  # [rank, blk, m]
    m = blocks.shape[2]

    def roll(t):  # ppermute i -> i+1: rank i receives rank i-1's value
        return torch.roll(t, 1, 0)

    if wire == "bf16":
        # Reduce-scatter: carry travels as bf16, accumulate in f32.
        carry = blocks[rank, rank].to(torch.bfloat16)
        for k in range(n - 1):
            acc = roll(carry).to(torch.float32) + blocks[rank, (rank - k - 1) % n]
            carry = acc.to(torch.bfloat16)
        # Allgather: circulate the finished bf16 block.
        out = torch.zeros((n, n, m), dtype=torch.bfloat16, device=x.device)
        out[rank, (rank + 1) % n] = carry
        cur = carry
        for k in range(n - 1):
            cur = roll(cur)
            out[rank, (rank - k) % n] = cur
        deq = out.to(torch.float32)
    else:
        def quant(v):  # (n, m) -> ((n, m) int8, (n, m/block) scales)
            q, s = _quantize(v.reshape(n, -1, block))
            return q.reshape(n, m), s.reshape(n, -1)

        def dequant(q, s):
            v = q.to(torch.float32).reshape(q.shape[:-1] + (-1, block))
            return (v * s.unsqueeze(-1)).reshape(q.shape)

        q, s = quant(blocks[rank, rank])
        for k in range(n - 1):
            q, s = roll(q), roll(s)
            q, s = quant(dequant(q, s) + blocks[rank, (rank - k - 1) % n])
        out_q = torch.zeros((n, n, m), dtype=torch.int8, device=x.device)
        out_s = torch.zeros((n, n, m // block), dtype=torch.float32,
                            device=x.device)
        out_q[rank, (rank + 1) % n] = q
        out_s[rank, (rank + 1) % n] = s
        for k in range(n - 1):
            q, s = roll(q), roll(s)
            out_q[rank, (rank - k) % n] = q
            out_s[rank, (rank - k) % n] = s
        deq = dequant(out_q, out_s)

    return deq.reshape(n, -1)[:, :total].reshape(x.shape).to(x.dtype)


def analytic_error_bound(per_rank: Any, axis_elems: int | None = None,
                         wire: str | None = None,
                         block: int | None = None) -> torch.Tensor:
    """Worst-case per-element |error| of the quantized-wire ring
    allreduce, from the GLOBAL ``(n, ...)`` stack of per-rank inputs.

    An element passes through at most n quantization events (the seed
    quantize + n-2 reduce-scatter requants + the final requant whose
    image the allgather circulates), each contributing at most half an
    int8 step of the then-current block scale. Partial sums (and the
    errors already absorbed into them) are bounded by
    S_b = sum_r max|x_r|_block, so

        |err| <= 2 * n * S_b / 254          (int8; factor 2 absorbs the
                                             error-growth compounding)
        |err| <= 2 * n * S_b * 2**-9        (bf16 half-ulp)

    Returns the bound with the input's trailing shape.
    """
    wire = wire or _wire_var.value
    block = block or _block_var.value
    stack = torch.as_tensor(per_rank).to(torch.float32)
    n = stack.shape[0]
    flat = stack.reshape(n, -1)
    pad = (-flat.shape[1]) % (n * block)
    if pad:
        flat = F.pad(flat, (0, pad))
    nb = flat.shape[1] // block
    per_block_max = flat.abs().reshape(n, nb, block).amax(dim=2)
    s = per_block_max.sum(dim=0)                              # (nb,)
    step = (1.0 / (2 * _INT8_LEVELS)) if wire != "bf16" else 2.0 ** -9
    bound = torch.repeat_interleave(2.0 * n * s * step, block)
    if pad:
        bound = bound[:-pad]
    return bound.reshape(stack.shape[1:])


# ---------------------------------------------------------------------------
# The kernel's arithmetic on (rows, 128) tiles, one f32 scale per row.
# ---------------------------------------------------------------------------

def _quant_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, 128) f32 -> ((rows, 128) int8, (rows/128, 128) f32)."""
    q, scale = _quantize(x)
    return q, scale.reshape(-1, LANES)


def _dequant_rows(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * s.reshape(-1, 1)


# ---------------------------------------------------------------------------
# The kernel's plain version: its buffer and flag protocol, rank by rank.
# ---------------------------------------------------------------------------

def _quant_blocks(blocks: torch.Tensor) -> tuple[int, int]:
    """(n, rows) of the kernel's (n ranks, n blocks, rows, 128) f32
    input, rows a multiple of 128."""
    n = blocks.shape[0]
    if blocks.ndim != 4 or blocks.shape[1] != n \
            or blocks.shape[3] != LANES or blocks.shape[2] % LANES:
        raise ArgumentError(
            f"quant ring input must be (n, n, rows, 128) with rows a "
            f"multiple of 128, got {tuple(blocks.shape)}")
    if blocks.dtype != torch.float32:
        raise ArgumentError(f"quant ring input must be float32, got "
                            f"{blocks.dtype}")
    return n, blocks.shape[2]


def _dequantize(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(rows, 128) int8 and (rows, 1) f32 scales -> (rows, 128) f32."""
    return q.to(torch.float32) * s


def _np_quantize(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``_quantize`` on a float32 numpy array, in the same IEEE
    operations (a division, rounding half to even, the clip)."""
    m = np.abs(v).max(axis=-1, keepdims=True)
    scale = np.where(m > 0, m / np.float32(_INT8_LEVELS), np.float32(1))
    q = np.clip(np.rint(v / scale), -_INT8_LEVELS, _INT8_LEVELS)
    return q.astype(np.int8), scale


def _np_dequantize(q: np.ndarray, s: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * s


def simulate_quant_ring(blocks: torch.Tensor, *, form: str = "wavefront",
                        credit: str = "port",
                        seg_rows: Optional[int] = None, stripes: int = 1,
                        rng: Optional[random.Random] = None):
    """Run the quantized ring's buffer and flag schedule on ``blocks``
    (n, n, rows, 128) f32, rank by rank (``pallas_ring._drive``); returns
    (out, residue): residue maps every flag not back at 0 to its count.

    ``form`` "wavefront" is the kernel's: the rows are cut into
    ``stripes`` stripes, each a thread block of every rank with its own
    buffers and flags (one program per (rank, stripe)), and each stripe
    into segments of ``seg_rows`` rows (the last ragged; default one).
    Step k of segment i at rank me: a reduce-scatter step (k < n-1)
    stores ``requant(dequant(arrival) + x[me][me-k-2])`` into the right's
    buffer for step k+1 (at k = n-2 also its dequantized image into
    out[me][me]); an allgather step stores ``dequant(arrival)`` into
    out[me][me-(k-n+2)] and forwards the arrival's bytes and scales (but
    at the last step). Step 0's arrival is the left's seed,
    ``quant(x[left][me-2])``, computed from x. In time slot t rank me
    makes step k of segment t - k for every k that has one, reading
    buffers (k, t mod 2); waits and raises are
    ``pallas_ring.simulate_ring_chunked``'s (``_ch_forwards``), so every
    flag ends at 0. ``credit`` "port" credits a buffer to the left after
    the passes that read it; "before_read" before them, the negative
    control.

    ``form`` "lockstep" is the first port's schedule, one stripe: 2(n-1)
    steps over two comm slots per rank; a step waits for the credit of
    the right neighbour's slot (from step 1), stores the pair into it,
    signals its one receive flag, waits for its own, then folds the
    arrival back into the slot (at the last reduce-scatter step also its
    image into out) or, in the allgather, writes it to out. ``credit``
    "port" credits a slot right after the send from it; "reference" (in
    either form: it runs the lock-step schedule) is the JAX kernel's, a
    post-seed credit, then one right after filling the slot."""
    if credit not in ("port", "before_read", "reference"):
        raise ArgumentError(f"unknown credit placement {credit!r}")
    if form not in ("wavefront", "lockstep"):
        raise ArgumentError(f"unknown quant ring form {form!r}")
    if credit == "reference" or form == "lockstep":
        if credit == "before_read":
            raise ArgumentError("the before_read credit is the wavefront's")
        return _simulate_quant_lockstep(blocks, credit, rng)
    n, rows = _quant_blocks(blocks)
    if stripes < 1:
        raise ArgumentError(f"bad stripe count {stripes}")
    sr = -(-rows // stripes)
    seg = sr if seg_rows is None else seg_rows
    if seg <= 0:
        raise ArgumentError(f"bad wavefront segment {seg}")
    n_segs = max(1, -(-sr // seg))
    nsteps = 2 * (n - 1)
    out = torch.empty_like(blocks)
    buf_q = torch.empty((n, stripes, nsteps - 1, RS_BUFS, seg, LANES),
                        dtype=torch.int8, device=blocks.device)
    buf_s = blocks.new_empty((n, stripes, nsteps - 1, RS_BUFS, seg, 1))
    x, o, quant, dequant = blocks, out, _quantize, _dequantize
    if blocks.device.type == "cpu":  # numpy views: faster slices
        x, o, buf_q, buf_s = (t.numpy() for t in (blocks, out, buf_q, buf_s))
        quant, dequant = _np_quantize, _np_dequantize
    sems: dict = collections.defaultdict(int)

    def fwd(p):
        return _ch_forwards(p, n, n_segs)

    def rank(me, s):
        left, right = (me - 1) % n, (me + 1) % n
        r0, r1 = min(rows, s * sr), min(rows, (s + 1) * sr)

        def span(i):
            return slice(min(r1, r0 + i * seg), min(r1, r0 + (i + 1) * seg))

        for t in range(n_segs + nsteps - 1):
            if fwd(t - 1):
                yield (me, s, "recv", t % 2), 1
            if fwd(t) and fwd(t - 2):
                yield (me, s, "cap", (t + 1) % 2), 1
            credit_slot = fwd(t - 1) and fwd(t + 1)
            if credit == "before_read" and credit_slot:
                sems[left, s, "cap", t % 2] += 1
                yield _PAUSE
            for k in range(max(0, t - n_segs + 1), min(nsteps - 1, t) + 1):
                c = span(t - k)
                w = c.stop - c.start
                if k == 0:
                    q, sc = quant(x[left, (me - 2) % n, c])
                else:
                    q, sc = buf_q[me, s, k - 1, t % 2, :w], \
                        buf_s[me, s, k - 1, t % 2, :w]
                if k < n - 1:
                    q, sc = quant(dequant(q, sc) + x[me, (me - k - 2) % n, c])
                    if k == n - 2:
                        o[me, me, c] = dequant(q, sc)
                else:
                    o[me, (me - k + n - 2) % n, c] = dequant(q, sc)
                if k < nsteps - 1:
                    buf_q[right, s, k, (t + 1) % 2, :w] = q
                    buf_s[right, s, k, (t + 1) % 2, :w] = sc
            if fwd(t):
                sems[right, s, "recv", (t + 1) % 2] += 1
            if credit == "port" and credit_slot:
                sems[left, s, "cap", t % 2] += 1

    _drive([rank(r, s) for s in range(stripes) for r in range(n)], sems, rng)
    return out, _residue(sems)


def _simulate_quant_lockstep(blocks: torch.Tensor, credit: str,
                             rng: Optional[random.Random]):
    """``simulate_quant_ring``'s "lockstep" form."""
    n, rows = _quant_blocks(blocks)
    out = torch.empty_like(blocks)
    slot_q = torch.empty((n, 2, rows, LANES), dtype=torch.int8,
                         device=blocks.device)
    slot_s = blocks.new_empty((n, 2, rows // LANES, LANES))
    sems: dict = collections.defaultdict(int)
    nsteps = 2 * (n - 1)

    def rank(me):
        left, right = (me - 1) % n, (me + 1) % n
        x = blocks[me]
        slot_q[me, 0], slot_s[me, 0] = _quant_rows(x[left])
        if credit == "reference":
            sems[left, "cap", 0] += 1
        yield _PAUSE
        for step in range(nsteps):
            slot, nslot = step % 2, (step + 1) % 2
            if step >= 1:
                yield (me, "cap", nslot), 1
            slot_q[right, nslot] = slot_q[me, slot]
            slot_s[right, nslot] = slot_s[me, slot]
            sems[right, "recv", nslot] += 1
            if credit == "port" and step < nsteps - 1:
                sems[left, "cap", slot] += 1
            yield (me, "recv", nslot), 1
            if step < n - 1:
                blk = (me - step - 2) % n
                acc = _dequant_rows(slot_q[me, nslot], slot_s[me, nslot]) \
                    + x[blk]
                slot_q[me, nslot], slot_s[me, nslot] = _quant_rows(acc)
                if step == n - 2:
                    # The first finished block: its wire image is what
                    # the allgather circulates, so every rank
                    # reconstructs the same values.
                    out[me, blk] = _dequant_rows(slot_q[me, nslot],
                                                 slot_s[me, nslot])
            else:
                blk = (me - (step - (n - 1)) - 1) % n
                out[me, blk] = _dequant_rows(slot_q[me, nslot],
                                             slot_s[me, nslot])
            if credit == "reference" and step < nsteps - 2:
                sems[left, "cap", nslot] += 1

    _drive([rank(r) for r in range(n)], sems, rng)
    return out, _residue(sems)


def quant_allreduce_plain(blocks: torch.Tensor) -> torch.Tensor:
    """The kernel's wavefront on one stripe, in segments of the cluster
    plan's rows (or longer, so that at most ``PLAIN_SEGS`` segments);
    no bit depends on the segment."""
    _, rows = _quant_blocks(blocks)
    seg = _plain_seg(rows, QUANT_CLUSTER_SEG_ROWS)
    return _checked(simulate_quant_ring(blocks, seg_rows=seg))


# ---------------------------------------------------------------------------
# The kernel: its plan and its wrapper.
# ---------------------------------------------------------------------------

#: The int8 ring's plans (csrc/quant_allreduce.cu, ``_quant_plan``): rows
#: of a segment, threads per block and blocks per SM, in the chunked
#: ring's two forms. Up to ``RS_CLUSTER_RANKS`` ranks one cluster of the n
#: ranks' blocks per stripe, a block's (2n-3) x RS_BUFS buffers within
#: its share of ``CHUNKED_SMEM_BYTES``; beyond, the buffers in HBM, all
#: blocks' within ``RS_SLOT_BYTES`` so that they stay in the 50 MB L2.
#: The sweeps at 1 GiB per rank, n = 8, on an NVIDIA H100 (PERF.md,
#: tools/quant_hop_check.py), the kernel built for 4 blocks of 256 threads
#: a SM: in shared memory 16-row segments with 256 threads x 4 blocks a SM
#: 8.02-8.03 ms, 128 x 8 with 7 rows 8.57, 128 x 12 with 4 rows 8.51, 256
#: x 6 with 10 rows 10.5, 256 x 3 with 16 rows 9.7; the first build's 128
#: x 4 with 16 rows 12.4. In L2 256 x 4 with 8 rows 10.1, with 13 rows
#: 11.3, x 3 11.4, x 2 14.2; at n = 12 (about 1 GiB per rank) x 4 with 8
#: rows 16.4, x 3 22.7, x 2 23.4.
QUANT_CLUSTER_SEG_ROWS, QUANT_CLUSTER_THREADS, \
    QUANT_CLUSTER_BLOCKS_PER_SM = 16, 256, 4
QUANT_SEG_ROWS, QUANT_THREADS, QUANT_BLOCKS_PER_SM = 8, 256, 4


def _buf_bytes(seg_rows: int) -> int:
    """Bytes of one wavefront buffer: ``seg_rows`` int8 rows of 128
    values, then their f32 scales, rounded up to 16 bytes."""
    return seg_rows * LANES + -(-seg_rows * 4 // 16) * 16


@functools.lru_cache(maxsize=256)
def _quant_plan(n: int, rows: int, sm_count: int,
                cluster: Optional[bool] = None,
                seg_rows: Optional[int] = None,
                threads: Optional[int] = None,
                per_sm: Optional[int] = None
                ) -> tuple[int, int, int, bool]:
    """``_wave_plan`` of ``quant_allreduce`` in rows: (stripes, threads
    per block, rows per segment, cluster) for n ranks of ring blocks of
    ``rows`` rows, each form's segment, threads and blocks per SM (or the
    ones given: the measurement tools' sweep); stripes of at least a row
    per warp (so a small message spreads over more blocks, each warp on
    fewer rows a step); (2n-3) x RS_BUFS buffers a block of at most
    ``_buf_bytes``' 132 bytes a row plus 12, within its share of
    ``CHUNKED_SMEM_BYTES`` in the cluster form."""
    return _wave_plan(n, rows, sm_count, cluster, (
        (seg_rows or QUANT_CLUSTER_SEG_ROWS, threads or QUANT_CLUSTER_THREADS,
         per_sm or QUANT_CLUSTER_BLOCKS_PER_SM),
        (seg_rows or QUANT_SEG_ROWS, threads or QUANT_THREADS,
         per_sm or QUANT_BLOCKS_PER_SM)),
        bufs=2 * n - 3,
        smem=CHUNKED_SMEM_BYTES // (per_sm or QUANT_CLUSTER_BLOCKS_PER_SM),
        quantum=1, unit_bytes=LANES + 4, slack=12, per_warp=True)


def quant_allreduce(blocks: torch.Tensor) -> torch.Tensor:
    """(n, n, rows, 128) f32 ring blocks, rows a multiple of 128 ->
    (n, n, rows, 128): every rank's every block holds the quantized-wire
    sum of that block over all ranks. The kernel for a CUDA tensor, the
    plain version for a CPU one."""
    _quant_blocks(blocks)
    if not blocks.is_cuda:
        return quant_allreduce_plain(blocks)
    return _quant_launch(blocks)


def _quant_launch(blocks: torch.Tensor, cluster: Optional[bool] = None,
                  seg_rows: Optional[int] = None,
                  threads: Optional[int] = None,
                  per_sm: Optional[int] = None) -> torch.Tensor:
    """Launch csrc/quant_allreduce.cu on (n, n, rows, 128) CUDA blocks
    with the plan's stripes, threads, segment and buffer memory (a
    cluster's shared memory, or L2), or the ones given (the tests' and
    the measurement tools' choices). ``QUANT.last_plan`` records what was
    launched."""
    n, rows = _quant_blocks(blocks)
    cap = require_kernel_device(blocks)
    x = blocks.contiguous()
    if x.data_ptr() % 16:  # the kernel loads rows as 16-byte vectors
        x = x.clone()
    stripes, threads, seg, cluster = _quant_plan(
        n, rows, cap.sm_count, cluster, seg_rows, threads, per_sm)
    dev = x.device.index or 0
    if cluster:  # the segment in 16-byte units is its rows
        stripes = min(stripes, _clusters("quant_allreduce", n, threads,
                                          16 * seg, dev))
    n_segs = -(-(-(-rows // stripes)) // seg)
    out = torch.empty_like(x)
    stream = _raw_stream(x)
    buffer_bytes = n * stripes * RS_BUFS * (2 * n - 3) * _buf_bytes(seg)
    comm = _scratch(x, stream, "comm", 0 if cluster else buffer_bytes)
    sems = _scratch(x, stream, "flags", n * stripes * 2 * RS_BUFS)
    err = _entry("quant_allreduce")(
        x.data_ptr(), out.data_ptr(), comm.data_ptr(), sems.data_ptr(), n,
        stripes, threads, rows, seg, n_segs, int(cluster), dev, stream)
    if err:
        raise KernelError(f"quant_allreduce launch failed: CUDA error {err}")
    QUANT.launched(sems, {
        "form": "cluster" if cluster else "l2", "stripes": stripes,
        "threads": threads, "segment_rows": seg, "segments": n_segs,
        "buffer_bytes": buffer_bytes})
    return out


def allreduce_block_quant(b: torch.Tensor, op: Any = "sum", *,
                          quant=quant_allreduce) -> torch.Tensor:
    """Rank-major contributions -> rank-major fully reduced buffer over
    the quantized ring kernel (int8 wire, one scale per 128-element
    row). ``quant`` lets a caller run the plain version on the same
    layout."""
    op = op_lookup(op)
    if op.native_reduce != "sum":
        raise ValueError(f"quant pallas ring supports SUM only, "
                         f"got {op.name!r}")
    n = b.shape[0]
    if n == 1:
        return b
    flat = b.to(torch.float32).reshape(n, -1)
    # Each ring block: (rows, 128) with rows % 128 == 0 (the JAX
    # package's scale tiles); the quantum fixes which ring block, and so
    # which fold order, each element gets.
    quantum = n * LANES * LANES
    pad = (-flat.shape[1]) % quantum
    if pad:
        flat = F.pad(flat, (0, pad))
    rows = flat.shape[1] // (n * LANES)
    out = quant(flat.reshape(n, n, rows, LANES)).reshape(n, -1)
    if pad:
        out = out[:, :out.shape[1] - pad]
    return out.reshape(b.shape).to(b.dtype)


# ---------------------------------------------------------------------------
# Error feedback (opt-in, host-side state across calls).
# ---------------------------------------------------------------------------

class ErrorFeedback:
    """Carries the quantization residual across repeated allreduces of
    the same logical tensor (gradient steps): each call compensates the
    input with the previous residual, transmits the wire image of the
    compensated value, and keeps the new residual

        e_t = (x_t + e_{t-1}) - roundtrip(x_t + e_{t-1}).

    Telescoping gives sum_t transmitted = sum_t x_t + e_{-1} - e_T with
    ``e_T`` bounded by one quantization step — the time-averaged
    transmitted signal converges to the exact one at O(1/t). State is
    per-instance and lives beside the collective plans, which stay
    pure."""

    def __init__(self, wire: str | None = None,
                 block: int | None = None) -> None:
        self.wire = wire
        self.block = block
        self.residual = None

    @staticmethod
    def enabled_by_config() -> bool:
        return bool(_ef_var.value)

    def compensate(self, x: torch.Tensor) -> torch.Tensor:
        """Return the value to transmit for ``x`` (the wire roundtrip
        of the residual-compensated input) and update the residual."""
        x = torch.as_tensor(x)
        xc = x.to(torch.float32)
        if self.residual is not None:
            xc = xc + self.residual
        sent = quant_roundtrip(xc, self.wire, self.block)
        self.residual = xc - sent
        return sent.to(x.dtype)

    def residual_norm(self) -> float:
        if self.residual is None:
            return 0.0
        return float(torch.linalg.norm(self.residual.reshape(-1)))


def allreduce_error_feedback(comm, x, state: ErrorFeedback,
                             op: Any = "sum"):
    """Vtable allreduce of the EF-compensated wire image of ``x`` (a
    rank-major ``(size, ...)`` buffer; the residual is elementwise, so
    one state instance covers all rank rows)."""
    return comm.allreduce(state.compensate(x), op)
