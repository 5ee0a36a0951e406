"""Schedulable-unit identifiers.

A schedulable unit is either a single job or a *packed* pair of jobs
space-sharing one accelerator (Gavel-style packing). This provides the same
capability surface as the reference's ``JobIdPair``
(reference: scheduler/job_id_pair.py:4-91) as one immutable value type:
canonical ordering of the pair, set-like overlap queries, and a total order
in which all singletons sort before all pairs of the same leading id.
"""

from __future__ import annotations

import functools
from typing import Iterator, Optional, Tuple


@functools.total_ordering
class JobId:
    """Identifier for a single job or a packed job pair.

    ``JobId(3)`` is the single job 3; ``JobId(3, 7)`` is jobs 3 and 7
    packed together (the pair is stored in canonical sorted order).
    """

    __slots__ = ("_ids", "_hash")

    def __init__(self, first: int, second: Optional[int] = None):
        if first is None:
            raise ValueError("JobId requires at least one integer id")
        if second is None:
            self._ids: Tuple[int, ...] = (int(first),)
            # A single JobId hashes like its integer so {JobId(3), 3}
            # collide, mirroring the reference's int-compatible equality.
            self._hash = hash(self._ids[0])
        else:
            a, b = int(first), int(second)
            self._ids = (a, b) if a <= b else (b, a)
            self._hash = hash(self._ids)

    # -- identity ----------------------------------------------------------
    @property
    def is_pair(self) -> bool:
        return len(self._ids) == 2

    def singletons(self) -> Tuple["JobId", ...]:
        if self.is_pair:
            return (JobId(self._ids[0]), JobId(self._ids[1]))
        return (self,)

    def overlaps_with(self, other: "JobId") -> bool:
        """True if this *single* job is one of ``other``'s members."""
        if self.is_pair:
            raise ValueError("overlaps_with is only defined for single ids")
        return self._ids[0] in other._ids

    @property
    def integer(self) -> int:
        """The underlying integer id; only valid for single jobs."""
        if self.is_pair:
            raise ValueError("integer id undefined for a packed pair")
        return self._ids[0]

    def as_tuple(self) -> Tuple[int, ...]:
        return self._ids

    def __getitem__(self, i: int) -> Optional[int]:
        if i == 0:
            return self._ids[0]
        if i == 1:
            return self._ids[1] if self.is_pair else None
        raise IndexError(i)

    def __iter__(self) -> Iterator[int]:
        return iter(self._ids)

    # -- ordering / hashing ------------------------------------------------
    def _sort_key(self) -> Tuple[int, int, int]:
        # Every singleton orders before every pair
        # (matches reference JobIdPair.__lt__, job_id_pair.py:53-61).
        if self.is_pair:
            return (1, self._ids[0], self._ids[1])
        return (0, self._ids[0], -1)

    def __lt__(self, other: "JobId") -> bool:
        return self._sort_key() < other._sort_key()

    def __eq__(self, other: object) -> bool:
        if isinstance(other, int):
            return not self.is_pair and self._ids[0] == other
        if isinstance(other, JobId):
            return self._ids == other._ids
        return NotImplemented

    def __hash__(self) -> int:
        return self._hash

    def __setstate__(self, state):
        # Pickles written before the cached-hash slot existed carry only
        # _ids; rebuild the hash on load so old checkpoints still work.
        slots = state[1] if isinstance(state, tuple) else state
        self._ids = tuple(slots["_ids"])
        self._hash = (
            hash(self._ids[0]) if len(self._ids) == 1 else hash(self._ids)
        )

    def __repr__(self) -> str:
        if self.is_pair:
            return "(%d, %d)" % self._ids
        return "%d" % self._ids[0]
