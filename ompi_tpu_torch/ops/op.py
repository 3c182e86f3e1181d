"""Reduction operators on torch tensors.

Port of ``ompi_tpu/ops/op.py``: the same ``Op`` surface (name, combine,
commutativity, identity, cache key), the same ``PREDEFINED`` table and
``lookup``, with torch combines. Semantics follow the JAX package's:

- MAX/MIN propagate NaN as ``jnp.maximum``/``jnp.minimum`` do
  (``torch.maximum``/``torch.minimum`` do too; CUDA's ``fmaxf`` does
  not, so the kernels test for NaN themselves).
- bfloat16 SUM/PROD compute in float32 and round once to bfloat16, as
  XLA does; torch does the same for a bfloat16 ``+``/``*``.
- int32 SUM/PROD wrap in two's complement.
- BAND/BOR/BXOR are undefined on floating types and raise ``OpError``.

``native_reduce`` names the torch reduction over the rank axis that
computes the op directly (the JAX package's ``xla_reduce``: psum, pmax,
pmin), or None.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..core.errors import OpError

Combine = Callable[[Any, Any], Any]


class Op:
    """A reduction operator."""

    def __init__(
        self,
        name: str,
        combine: Combine,
        *,
        commutative: bool = True,
        identity: Optional[Callable[[Any], Any]] = None,
        native_reduce: Optional[str] = None,
        predefined: bool = False,
        joint: bool = False,
    ) -> None:
        self.name = name
        self._combine = combine
        self.commutative = commutative
        self._identity = identity
        self.native_reduce = native_reduce
        self.predefined = predefined
        # Joint ops (MAXLOC/MINLOC) combine a (value, index) pair at once.
        self.joint = joint

    @property
    def cache_key(self) -> str:
        """Plan-cache key component: predefined ops by name, user ops by
        object identity (two user ops may share a name)."""
        if self.predefined:
            return self.name
        return f"{self.name}#{id(self)}"

    def combine(self, a: Any, b: Any) -> Any:
        """Elementwise combine of two tensors (or, for a joint op, of two
        (value, index) pairs)."""
        if self.joint or not isinstance(a, (tuple, list)):
            return self._combine(a, b)
        return type(a)(self._combine(x, y) for x, y in zip(a, b))

    def identity_like(self, x: torch.Tensor) -> torch.Tensor:
        if self._identity is None:
            raise OpError(f"op {self.name} has no identity element")
        return self._identity(x)

    @property
    def has_identity(self) -> bool:
        return self._identity is not None

    def __call__(self, a: Any, b: Any) -> Any:
        return self.combine(a, b)

    def __repr__(self) -> str:
        return f"Op({self.name}, commutative={self.commutative})"


def _logical(fn):
    def wrapped(a, b):
        return fn(a != 0, b != 0).to(a.dtype)

    return wrapped


def _int_only(name, fn):
    def wrapped(a, b):
        if a.is_floating_point():
            raise OpError(f"op {name} is undefined on floating types")
        return fn(a, b)

    return wrapped


def _dtype_min(x: torch.Tensor):
    if x.is_floating_point():
        return float("-inf")
    if x.dtype == torch.bool:
        return False
    return torch.iinfo(x.dtype).min


def _dtype_max(x: torch.Tensor):
    if x.is_floating_point():
        return float("inf")
    if x.dtype == torch.bool:
        return True
    return torch.iinfo(x.dtype).max


SUM = Op("sum", lambda a, b: a + b, identity=torch.zeros_like,
         native_reduce="sum", predefined=True)
PROD = Op("prod", lambda a, b: a * b, identity=torch.ones_like,
          predefined=True)
MAX = Op("max", torch.maximum,
         identity=lambda x: torch.full_like(x, _dtype_min(x)),
         native_reduce="amax", predefined=True)
MIN = Op("min", torch.minimum,
         identity=lambda x: torch.full_like(x, _dtype_max(x)),
         native_reduce="amin", predefined=True)
LAND = Op("land", _logical(torch.logical_and), identity=torch.ones_like,
          predefined=True)
LOR = Op("lor", _logical(torch.logical_or), identity=torch.zeros_like,
         predefined=True)
LXOR = Op("lxor", _logical(torch.logical_xor), identity=torch.zeros_like,
          predefined=True)
BAND = Op("band", _int_only("band", lambda a, b: a & b),
          identity=lambda x: torch.full_like(x, -1), predefined=True)
BOR = Op("bor", _int_only("bor", lambda a, b: a | b),
         identity=torch.zeros_like, predefined=True)
BXOR = Op("bxor", _int_only("bxor", lambda a, b: a ^ b),
          identity=torch.zeros_like, predefined=True)


def _maxloc_combine(a, b):
    av, ai = a
    bv, bi = b
    # MPI MAXLOC: larger value wins; ties take the smaller index.
    take_a = (av > bv) | ((av == bv) & (ai <= bi))
    return torch.where(take_a, av, bv), torch.where(take_a, ai, bi)


def _minloc_combine(a, b):
    av, ai = a
    bv, bi = b
    take_a = (av < bv) | ((av == bv) & (ai <= bi))
    return torch.where(take_a, av, bv), torch.where(take_a, ai, bi)


MAXLOC = Op("maxloc", _maxloc_combine, predefined=True, joint=True)
MINLOC = Op("minloc", _minloc_combine, predefined=True, joint=True)

# RMA accumulate ops (osc): REPLACE overwrites, NO_OP reads.
REPLACE = Op("replace", lambda a, b: b, commutative=False, predefined=True)
NO_OP = Op("no_op", lambda a, b: a, commutative=False, predefined=True)

PREDEFINED: dict[str, Op] = {
    op.name: op
    for op in (
        SUM, PROD, MAX, MIN, LAND, LOR, LXOR, BAND, BOR, BXOR,
        MAXLOC, MINLOC, REPLACE, NO_OP,
    )
}


def create_op(
    fn: Combine,
    *,
    commutative: bool,
    name: str = "user",
    identity: Optional[Callable[[Any], Any]] = None,
) -> Op:
    """MPI_Op_create equivalent: wrap a binary combine on tensors."""
    return Op(name, fn, commutative=commutative, identity=identity)


def lookup(op: "Op | str") -> Op:
    if isinstance(op, Op):
        return op
    got = PREDEFINED.get(str(op).lower())
    if got is None:
        raise OpError(f"unknown op {op!r}; known: {sorted(PREDEFINED)}")
    return got
