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
``simulate_quant_ring``, for a CPU one. The kernel credits a slot right
after the send from it and has no post-seed credit; the JAX kernel
credits after filling the slot it still has to send from
(``quant.py:375-377``, ``:416-421``), which loses partials when ranks
truly run at once. ``simulate_quant_ring(credit="reference")`` shows it.

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

import torch
import torch.nn.functional as F

from ..core import config
from ..core.counters import SPC, KernelCounter
from ..core.errors import ArgumentError
from ..ops import Op, lookup as op_lookup
from .pallas_ring import (LANES, _PAUSE, _check_credit, _checked, _drive,
                          _launch, _residue)

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
# The kernel's plain version: its slot and flag protocol, rank by rank.
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


def simulate_quant_ring(blocks: torch.Tensor, *, credit: str = "port",
                        rng: Optional[random.Random] = None):
    """Run the quantized ring's slot and flag schedule on ``blocks``
    (n, n, rows, 128) f32, rank by rank (``pallas_ring._drive``):
    2(n-1) steps over two comm slots per rank, each holding int8 rows
    and one f32 scale per row. A step waits for the credit of the
    right neighbour's slot (from step 1), stores the pair into it,
    signals its one receive flag, waits for its own, then folds: at a
    reduce-scatter step ``requant(dequant(arrival) + x[blk])`` back into
    the slot (at the last one also its dequantized image into out), at
    an allgather step ``dequant(arrival)`` into out. ``credit`` "port"
    credits a slot to the left neighbour right after the send from it
    (every step but the last), the kernel's placement; "reference" is
    the JAX kernel's (a post-seed credit, then one right after filling
    the slot). Returns (out, residue): residue maps every flag not back
    at 0 to its count."""
    _check_credit(credit)
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
    return _checked(simulate_quant_ring(blocks))


#: Flags per (rank, stripe) of the kernel: recv[2], cap[2].
QUANT_NSEM = 4


def _slot_elems(sw: int) -> int:
    """f32 words of one comm slot of a stripe ``sw`` elements wide:
    its rows (rounded up to 4, so every slot starts 16-byte aligned) of
    128 int8 values (32 words) and one f32 scale each."""
    rows = -(-sw // LANES)
    return (-(-rows // 4) * 4) * (LANES // 4 + 1)


def quant_allreduce(blocks: torch.Tensor) -> torch.Tensor:
    """(n, n, rows, 128) f32 ring blocks, rows a multiple of 128 ->
    (n, n, rows, 128): every rank's every block holds the quantized-wire
    sum of that block over all ranks. The kernel for a CUDA tensor, the
    plain version for a CPU one."""
    n, rows = _quant_blocks(blocks)
    if not blocks.is_cuda:
        return quant_allreduce_plain(blocks)
    if blocks.data_ptr() % 16:  # the kernel loads rows as 16-byte vectors
        blocks = blocks.clone()
    return _launch("quant_allreduce", QUANT, blocks, blocks.shape,
                   rows * LANES, 2 * n, QUANT_NSEM, (rows,), (),
                   slot_elems=_slot_elems)


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
