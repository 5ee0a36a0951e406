"""The control plane's write-ahead journal: checkpoints and a WAL tail.

The port of the JAX package's ``shockwave_tpu/ha/journal.py``. It rides
the flight recorder's JSON codec (``obs/recorder.py::encode`` /
``decode``), so the whole control plane is durable, not just the planner:

* **Checkpoints**: periodic compacted snapshots of the full scheduler
  state (jobs and progress, planner, admission-token ledger, tenant
  quotas, worker registry, lease state, round cursor), written
  atomically as ``checkpoint-<seq>.json``.
* **WAL segments**: between checkpoints, every state-changing event
  (accepted submission batch, admission, dispatch, Done report, worker
  register or retire, round advance) appends one JSONL line to
  ``wal-<seq>.jsonl`` in a single ``O_APPEND`` write, stamped with a
  rising LSN and the writer's fenced epoch.
* **Replay**: a restarted or standby scheduler loads the newest valid
  checkpoint and re-applies its WAL tail in LSN order. A truncated final
  line (an append the crash cut) is skipped; a corrupt line before the
  last raises, since that is data loss, not a crash artifact.

A new journal has no checkpoint: segment 0's WAL alone rebuilds the run
from an empty scheduler, so the journal is complete from its first
append. The schema string is the JAX package's, and each package replays
the other's journal.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import List, Optional

from shockwave_tpu_torch import obs
from shockwave_tpu_torch.analysis import sanitize
from shockwave_tpu_torch.obs.recorder import decode, encode
from shockwave_tpu_torch.utils.fileio import (
    atomic_append_text,
    atomic_write_json,
)

SCHEMA = "shockwave-ha-journal-v1"

_CKPT_RE = re.compile(r"^checkpoint-(\d{8})\.json$")
_WAL_RE = re.compile(r"^wal-(\d{8})\.jsonl$")


@dataclass
class JournalSnapshot:
    """What :meth:`ControlPlaneJournal.replay` hands a successor."""

    # Decoded checkpoint state, or None (a cold start from LSN 0).
    checkpoint: Optional[dict]
    # Decoded WAL entries after the checkpoint, in LSN order.
    entries: List[dict] = field(default_factory=list)
    seq: int = 0
    # Highest LSN seen (the checkpoint's or the last entry's); the
    # successor continues from last_lsn + 1.
    last_lsn: int = -1
    # Highest writer epoch seen anywhere in the journal.
    last_epoch: int = 0


class ControlPlaneJournal:
    """Append-only journal under one directory: one writer (the leader;
    fencing makes sure there is one) and any number of readers."""

    def __init__(self, journal_dir: str, retain: int = 2):
        self.dir = str(journal_dir)
        self.retain = max(1, int(retain))
        os.makedirs(self.dir, exist_ok=True)
        self._lock = sanitize.make_lock("ha.journal.ControlPlaneJournal._lock")
        seq, last_lsn = self._discover()
        self._seq = seq
        self._lsn = last_lsn + 1
        self.entries_appended = 0
        self.checkpoints_written = 0

    # -- discovery -------------------------------------------------------
    def _segments(self):
        ckpts, wals = {}, {}
        for name in os.listdir(self.dir):
            m = _CKPT_RE.match(name)
            if m:
                ckpts[int(m.group(1))] = os.path.join(self.dir, name)
            m = _WAL_RE.match(name)
            if m:
                wals[int(m.group(1))] = os.path.join(self.dir, name)
        return ckpts, wals

    def _discover(self):
        """Where a writer reopening a journal resumes: the newest segment,
        and the highest LSN in ANY retained generation. Scanning them all
        matters when the newest checkpoint is damaged and its WAL empty:
        resuming below an older generation's LSNs would mint entries that
        a fallback replay filters out as compacted history."""
        ckpts, wals = self._segments()
        if not ckpts and not wals:
            return 0, -1
        seq = max(list(ckpts) + list(wals))
        last_lsn = -1
        for ckpt_path in ckpts.values():
            header = self._read_checkpoint_header(ckpt_path)
            if header is not None:
                last_lsn = max(last_lsn, int(header.get("lsn", -1)))
        for wal_path in wals.values():
            for entry in self._iter_wal(wal_path):
                last_lsn = max(last_lsn, int(entry.get("lsn", -1)))
        return seq, last_lsn

    @staticmethod
    def _read_checkpoint_header(path: str) -> Optional[dict]:
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            # atomic_write_json cannot tear a checkpoint; an unreadable
            # one is damage, and replay falls back a generation.
            return None

    @staticmethod
    def _iter_wal(path: Optional[str]):
        if path is None or not os.path.exists(path):
            return
        with open(path) as f:
            lines = f.readlines()
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    return  # the append a crash cut
                raise ValueError(
                    f"{path}:{i + 1}: corrupt WAL record (not the final "
                    "line, so not a truncated append)"
                )

    # -- writer side -----------------------------------------------------
    def _wal_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"wal-{seq:08d}.jsonl")

    def _ckpt_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"checkpoint-{seq:08d}.json")

    def append(self, kind: str, payload: dict, epoch: int = 0) -> int:
        """Durably log one control-plane delta; returns its LSN."""
        with self._lock:
            lsn = self._lsn
            self._lsn += 1
            record = {
                "lsn": lsn,
                "epoch": int(epoch),
                "kind": str(kind),
                "payload": encode(payload),
            }
            atomic_append_text(
                self._wal_path(self._seq),
                json.dumps(record, separators=(",", ":")) + "\n",
            )
            self.entries_appended += 1
        obs.counter(
            "ha_journal_entries_total", "control-plane WAL entries appended"
        ).inc(kind=kind)
        return lsn

    def begin_checkpoint(self) -> tuple:
        """Reserve the next segment and the checkpoint's LSN; later
        appends go to the new segment's WAL. The caller holds the lock
        that makes its state capture atomic with this reservation (the
        physical scheduler's ``_cv``), so every entry logged under that
        lock sorts strictly before or after the checkpoint. Returns
        ``(seq, lsn)`` for :meth:`commit_checkpoint`. A crash between the
        two leaves a segment with no checkpoint: replay falls back a
        generation and re-applies both WAL segments."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            lsn = self._lsn
            self._lsn += 1
            return seq, lsn

    def commit_checkpoint(
        self, seq: int, lsn: int, encoded_state, epoch: int = 0
    ) -> int:
        """Write the checkpoint :meth:`begin_checkpoint` reserved.
        ``encoded_state`` is already recorder-encoded: the encode is the
        deep snapshot and runs under the caller's lock; the JSON dump and
        the write here need not."""
        atomic_write_json(
            self._ckpt_path(seq),
            {
                "event": "checkpoint",
                "schema": SCHEMA,
                "seq": seq,
                "lsn": lsn,
                "epoch": int(epoch),
                "state": encoded_state,
            },
            indent=None,
        )
        with self._lock:
            self.checkpoints_written += 1
            self._gc_locked(seq)
        obs.counter(
            "ha_journal_checkpoints_total",
            "compacted control-plane checkpoints written",
        ).inc()
        return seq

    def checkpoint(self, state: dict, epoch: int = 0) -> int:
        """Reserve, encode and write in one call, for a state nothing
        mutates meanwhile (tests, offline tools)."""
        seq, lsn = self.begin_checkpoint()
        return self.commit_checkpoint(seq, lsn, encode(state), epoch=epoch)

    def _gc_locked(self, current_seq: int) -> None:
        """Caller holds the lock. Drop the generations older than the
        last ``retain`` (the current one counted)."""
        floor = current_seq - self.retain + 1
        ckpts, wals = self._segments()
        for seq, path in list(ckpts.items()) + list(wals.items()):
            if seq < floor:
                try:
                    os.remove(path)
                except OSError:
                    pass  # a concurrent reader on some systems; next gc

    # -- reader side -----------------------------------------------------
    @classmethod
    def replay(cls, journal_dir: str) -> JournalSnapshot:
        """Load the newest readable checkpoint and its WAL tail; past a
        damaged newest checkpoint, its predecessor plus both WAL segments
        replay the same history."""
        journal_dir = str(journal_dir)
        snapshot = JournalSnapshot(checkpoint=None)
        if not os.path.isdir(journal_dir):
            return snapshot
        probe = cls.__new__(cls)
        probe.dir = journal_dir
        ckpts, wals = probe._segments()
        if not ckpts and not wals:
            return snapshot
        top = max(list(ckpts) + list(wals))
        base_seq = 0
        header = None
        for seq in sorted(ckpts, reverse=True):
            header = cls._read_checkpoint_header(ckpts[seq])
            if header is not None:
                base_seq = seq
                break
        if header is not None:
            snapshot.checkpoint = decode(header["state"])
            snapshot.seq = base_seq
            snapshot.last_lsn = int(header.get("lsn", -1))
            snapshot.last_epoch = int(header.get("epoch", 0))
        entries: List[dict] = []
        for seq in range(base_seq, top + 1):
            for raw in cls._iter_wal(wals.get(seq)):
                lsn = int(raw.get("lsn", -1))
                if lsn <= snapshot.last_lsn:
                    continue  # compacted into the checkpoint
                entries.append(
                    {
                        "lsn": lsn,
                        "epoch": int(raw.get("epoch", 0)),
                        "kind": raw.get("kind"),
                        "payload": decode(raw.get("payload")),
                    }
                )
        entries.sort(key=lambda e: e["lsn"])
        # One writer lock mints an epoch's LSNs and fencing serializes
        # epochs, so a duplicate LSN is damage.
        for prev, cur in zip(entries, entries[1:]):
            if cur["lsn"] == prev["lsn"]:
                raise ValueError(
                    f"{journal_dir}: duplicate WAL LSN {cur['lsn']}"
                )
        snapshot.entries = entries
        if entries:
            snapshot.last_lsn = entries[-1]["lsn"]
            snapshot.last_epoch = max(
                snapshot.last_epoch, max(e["epoch"] for e in entries)
            )
        snapshot.seq = max(snapshot.seq, top)
        return snapshot

    @classmethod
    def summarize(cls, journal_dir: str) -> dict:
        """Entry kinds, segment and LSN span: for smoke runs and triage."""
        snapshot = cls.replay(journal_dir)
        kinds: dict = {}
        for entry in snapshot.entries:
            kinds[entry["kind"]] = kinds.get(entry["kind"], 0) + 1
        return {
            "has_checkpoint": snapshot.checkpoint is not None,
            "seq": snapshot.seq,
            "last_lsn": snapshot.last_lsn,
            "last_epoch": snapshot.last_epoch,
            "tail_entries": len(snapshot.entries),
            "tail_kinds": kinds,
        }
