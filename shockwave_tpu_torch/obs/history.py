"""Fixed-memory campaign telemetry: ring-buffer history + exemplars.

Two small primitives the scale-proof metrics registry composes:

:class:`RingHistory` — a multi-resolution time-series ring. The RAW
ring keeps the last ``raw_len`` samples at full resolution; every
``per_coarse`` raw appends also fold into one COARSE point
(min/max/mean/last) in a second ring of ``coarse_len`` slots, so a
100k-round campaign retains both "the last few hundred rounds exactly"
and "the whole campaign's shape" in O(raw_len + coarse_len) floats —
no external Prometheus needed for ``report_run.py``'s "what did p99 do
over the campaign" block.

:class:`ExemplarReservoir` — a bounded top-k "worst offenders" table.
Rollups erase identity by design (that is what makes them O(cells)
instead of O(jobs)); the reservoir keeps the forensic pointer alive by
retaining the k entries with the LARGEST score together with their
real ids (``job_id``, worker, …). Offering is O(k) with a cheap
min-threshold early-out, so a million cheap observations cost a
million float compares, not a million dict churns.

Both are lock-free on purpose: the metrics registry mutates them under
its own lock, exactly like every other series state.
"""

from __future__ import annotations

from typing import Dict, List, Optional

DEFAULT_RAW_LEN = 256
DEFAULT_COARSE_LEN = 256
DEFAULT_PER_COARSE = 8


class RingHistory:
    """Two-resolution ring of (t, value) samples with O(1) append."""

    __slots__ = (
        "raw_len", "coarse_len", "per_coarse",
        "_raw", "_raw_pos", "_coarse", "_coarse_pos",
        "_pending", "_appended",
    )

    def __init__(
        self,
        raw_len: int = DEFAULT_RAW_LEN,
        coarse_len: int = DEFAULT_COARSE_LEN,
        per_coarse: int = DEFAULT_PER_COARSE,
    ):
        self.raw_len = max(4, int(raw_len))
        self.coarse_len = max(4, int(coarse_len))
        self.per_coarse = max(2, int(per_coarse))
        self._raw: List[Optional[tuple]] = [None] * self.raw_len
        self._raw_pos = 0
        self._coarse: List[Optional[tuple]] = [None] * self.coarse_len
        self._coarse_pos = 0
        # accumulator for the in-progress coarse point:
        # [n, t_last, v_min, v_max, v_sum]
        self._pending: Optional[list] = None
        self._appended = 0

    def append(self, t: float, value: float) -> None:
        t, value = float(t), float(value)
        self._raw[self._raw_pos % self.raw_len] = (t, value)
        self._raw_pos += 1
        self._appended += 1
        pend = self._pending
        if pend is None:
            self._pending = [1, t, value, value, value]
        else:
            pend[0] += 1
            pend[1] = t
            if value < pend[2]:
                pend[2] = value
            if value > pend[3]:
                pend[3] = value
            pend[4] += value
        pend = self._pending
        if pend[0] >= self.per_coarse:
            self._coarse[self._coarse_pos % self.coarse_len] = (
                pend[1], pend[2], pend[3], pend[4] / pend[0]
            )
            self._coarse_pos += 1
            self._pending = None

    def _ring_items(self, ring: list, pos: int) -> list:
        if pos <= len(ring):
            return [x for x in ring[:pos] if x is not None]
        start = pos % len(ring)
        return [x for x in ring[start:] + ring[:start] if x is not None]

    def snapshot(self) -> dict:
        """JSON-safe: ``raw`` is [[t, v], ...] oldest-first; ``coarse``
        is [[t_last, min, max, mean], ...] oldest-first."""
        return {
            "samples": self._appended,
            "raw": [list(x) for x in self._ring_items(self._raw, self._raw_pos)],
            "coarse": [
                list(x)
                for x in self._ring_items(self._coarse, self._coarse_pos)
            ],
        }


class ExemplarReservoir:
    """Top-k entries by score, keeping their real identities."""

    __slots__ = ("k", "_entries", "offered")

    def __init__(self, k: int = 10):
        self.k = max(1, int(k))
        # id -> (score, detail dict)
        self._entries: Dict[str, tuple] = {}
        self.offered = 0

    def _floor(self) -> float:
        return min(s for s, _ in self._entries.values())

    def offer(self, entry_id, score: float, **detail) -> bool:
        """Consider one (id, score): kept when the reservoir has room,
        the id is already present (score refreshes — an id's newest
        score wins), or the score beats the current worst survivor.
        Returns whether the entry is (now) in the reservoir."""
        self.offered += 1
        entry_id = str(entry_id)
        score = float(score)
        if entry_id in self._entries or len(self._entries) < self.k:
            self._entries[entry_id] = (score, detail)
            return True
        if score <= self._floor():
            return False
        worst = min(self._entries, key=lambda i: self._entries[i][0])
        del self._entries[worst]
        self._entries[entry_id] = (score, detail)
        return True

    def remove(self, entry_id) -> None:
        self._entries.pop(str(entry_id), None)

    def evicted_by(self, entry_id, score: float) -> Optional[str]:
        """The id :meth:`offer` would displace (callers that must
        un-publish the loser's gauges check before offering)."""
        entry_id = str(entry_id)
        if entry_id in self._entries or len(self._entries) < self.k:
            return None
        if float(score) <= self._floor():
            return None
        return min(self._entries, key=lambda i: self._entries[i][0])

    def __contains__(self, entry_id) -> bool:
        return str(entry_id) in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def entries(self) -> list:
        """[(id, score, detail)] sorted worst-first (largest score)."""
        return sorted(
            (
                (entry_id, score, detail)
                for entry_id, (score, detail) in self._entries.items()
            ),
            key=lambda item: (-item[1], item[0]),
        )

    def snapshot(self) -> dict:
        return {
            "k": self.k,
            "offered": self.offered,
            "entries": [
                {"id": entry_id, "score": score, **detail}
                for entry_id, score, detail in self.entries()
            ],
        }
