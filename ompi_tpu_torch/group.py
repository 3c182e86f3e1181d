"""Process groups: ordered sets of world ranks.

TPU-native equivalent of ompi/group (reference: ompi/group/group.c,
group_init.c). The reference keeps four representations (dense plist,
sporadic, strided, bitmap — ompi/group/group_{plist,sporadic,strided,
bitmap}.c) to save memory at scale; a Python tuple covers all of them here
(ranks are device indices, bounded by slice size, not 10^6 hosts).

Set operations and rank translation match the MPI semantics: union keeps
first-group order then appends, intersection/difference keep group-1 order.

The PyTorch port's own copy of ``ompi_tpu/group.py``.
"""

from __future__ import annotations

from typing import Iterable, Sequence

from .core.errors import GroupError, RankError

UNDEFINED = -32766  # MPI_UNDEFINED

# Comparison results (MPI_IDENT/SIMILAR/UNEQUAL)
IDENT = 0
SIMILAR = 1
UNEQUAL = 2


class Group:
    """An immutable ordered set of world ranks."""

    __slots__ = ("_ranks", "_index")

    def __init__(self, world_ranks: Iterable[int]) -> None:
        ranks = tuple(int(r) for r in world_ranks)
        if len(set(ranks)) != len(ranks):
            raise GroupError(f"duplicate ranks in group: {ranks}")
        self._ranks = ranks
        self._index = {r: i for i, r in enumerate(ranks)}

    # -- accessors --------------------------------------------------------

    @property
    def size(self) -> int:
        return len(self._ranks)

    @property
    def world_ranks(self) -> tuple[int, ...]:
        return self._ranks

    def world_rank(self, group_rank: int) -> int:
        if not 0 <= group_rank < len(self._ranks):
            raise RankError(
                f"group rank {group_rank} out of range (size {self.size})"
            )
        return self._ranks[group_rank]

    def rank_of_world(self, world_rank: int) -> int:
        """Group rank of a world rank, or UNDEFINED."""
        return self._index.get(world_rank, UNDEFINED)

    def __contains__(self, world_rank: int) -> bool:
        return world_rank in self._index

    def __iter__(self):
        return iter(self._ranks)

    def __len__(self) -> int:
        return len(self._ranks)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Group) and self._ranks == other._ranks

    def __hash__(self) -> int:
        return hash(self._ranks)

    def __repr__(self) -> str:
        return f"Group{self._ranks}"

    # -- MPI group operations ---------------------------------------------

    def compare(self, other: "Group") -> int:
        if self._ranks == other._ranks:
            return IDENT
        if set(self._ranks) == set(other._ranks):
            return SIMILAR
        return UNEQUAL

    def union(self, other: "Group") -> "Group":
        extra = [r for r in other._ranks if r not in self._index]
        return Group(self._ranks + tuple(extra))

    def intersection(self, other: "Group") -> "Group":
        return Group(r for r in self._ranks if r in other._index)

    def difference(self, other: "Group") -> "Group":
        return Group(r for r in self._ranks if r not in other._index)

    def incl(self, group_ranks: Sequence[int]) -> "Group":
        return Group(self.world_rank(r) for r in group_ranks)

    def excl(self, group_ranks: Sequence[int]) -> "Group":
        banned = set(group_ranks)
        for r in banned:
            if not 0 <= r < self.size:
                raise RankError(f"excl rank {r} out of range")
        return Group(
            wr for i, wr in enumerate(self._ranks) if i not in banned
        )

    @staticmethod
    def _expand_ranges(
        ranges: Sequence[tuple[int, int, int]],
    ) -> list[int]:
        out: list[int] = []
        for first, last, stride in ranges:
            if stride == 0:
                raise GroupError("range stride must be nonzero")
            r = first
            if stride > 0:
                while r <= last:
                    out.append(r)
                    r += stride
            else:
                while r >= last:
                    out.append(r)
                    r += stride
        return out

    def range_incl(self, ranges: Sequence[tuple[int, int, int]]) -> "Group":
        return self.incl(self._expand_ranges(ranges))

    def range_excl(self, ranges: Sequence[tuple[int, int, int]]) -> "Group":
        return self.excl(self._expand_ranges(ranges))

    def translate_ranks(
        self, group_ranks: Sequence[int], other: "Group"
    ) -> list[int]:
        """For each of my group ranks, its rank in `other` (or UNDEFINED)."""
        return [
            other.rank_of_world(self.world_rank(r)) for r in group_ranks
        ]


EMPTY = Group(())
