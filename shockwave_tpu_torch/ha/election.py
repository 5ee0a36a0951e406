"""Leader election by lease, with fenced epochs that only rise.

The port of the JAX package's ``shockwave_tpu/ha/election.py``. One small
durable lease record decides who the scheduler is. A node takes the lead
by a compare-and-swap on that record: if the lease is free or expired it
installs itself with ``epoch = prev + 1``. An epoch is minted once per
change of leader and never reused, so it is a fencing token: workers
reject RunJob/KillJob stamped with an epoch below the highest they have
seen, and a deposed leader cannot dispatch work it no longer owns.

The lease record is also the **front-door map**: it carries the leader's
scheduler address and the admission shards' ports, so workers
re-attaching after a scheduler's death and submitters following a
failover find the current leader in one place that changes with the
epoch.

The store is a file (an ``flock`` around the read-modify-write, a
temporary file renamed into place), right for the localhost and NFS
clusters the physical plane drives. An etcd or ZooKeeper store would keep
the same contract (CAS, TTL, rising epoch); nothing outside this module
knows how the lease is stored.
"""

from __future__ import annotations

import fcntl
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from shockwave_tpu_torch import obs
from shockwave_tpu_torch.analysis import sanitize
from shockwave_tpu_torch.utils.fileio import atomic_write_json

LEASE_FILE = "lease.json"
LOCK_FILE = "lease.lock"

# Renewal runs at TTL/3, so two failed renewals in a row still leave a
# third of the TTL before a standby can take the lease.
DEFAULT_TTL_S = 10.0


class LeaseLost(RuntimeError):
    """A renew or release found the lease held by a newer epoch: the
    caller was deposed and must fence itself."""


@dataclass(frozen=True)
class Lease:
    """One term of leadership. ``epoch`` is the fencing token."""

    epoch: int
    holder: str
    expires_at: float
    sched_addr: str = ""
    sched_port: int = 0
    # The front-door map: admission shard label -> port on sched_addr.
    admission_ports: Dict[str, int] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "holder": self.holder,
            "expires_at": self.expires_at,
            "sched_addr": self.sched_addr,
            "sched_port": self.sched_port,
            "admission_ports": dict(self.admission_ports),
        }

    @classmethod
    def from_dict(cls, raw: dict) -> "Lease":
        return cls(
            epoch=int(raw.get("epoch", 0)),
            holder=str(raw.get("holder", "")),
            expires_at=float(raw.get("expires_at", 0.0)),
            sched_addr=str(raw.get("sched_addr", "")),
            sched_port=int(raw.get("sched_port", 0)),
            admission_ports={
                str(k): int(v)
                for k, v in (raw.get("admission_ports") or {}).items()
            },
        )

    def replace(self, **changes) -> "Lease":
        fields = self.to_dict()
        fields.update(changes)
        return Lease(**fields)


class LeaseStore:
    """A lease record in a file, changed by compare-and-swap.

    Every change runs under an ``flock`` on a lock file beside it (the
    lease file is replaced by rename, so the lock needs an inode of its
    own) and publishes the new record by rename: a reader never sees a
    torn lease, with or without the lock.
    """

    def __init__(
        self,
        ha_dir: str,
        ttl_s: float = DEFAULT_TTL_S,
        clock: Callable[[], float] = time.time,
    ):
        self.ha_dir = str(ha_dir)
        self.ttl_s = float(ttl_s)
        self._clock = clock
        os.makedirs(self.ha_dir, exist_ok=True)
        self._lease_path = os.path.join(self.ha_dir, LEASE_FILE)
        self._lock_path = os.path.join(self.ha_dir, LOCK_FILE)

    # -- readers (no lock: the rename publishes atomically) -------------
    def read(self) -> Optional[Lease]:
        try:
            with open(self._lease_path) as f:
                return Lease.from_dict(json.load(f))
        except FileNotFoundError:
            return None
        except (json.JSONDecodeError, ValueError):
            # The rename cannot leave a half-written record; an
            # unparseable one is an operator's damage, read as no lease
            # rather than wedging every node.
            return None

    def leader(self) -> Optional[Lease]:
        """The current unexpired lease, or None."""
        lease = self.read()
        if lease is None or lease.expires_at <= self._clock():
            return None
        return lease

    # -- compare-and-swap changes ----------------------------------------
    def _with_flock(self, fn):
        fd = os.open(self._lock_path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            return fn()
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    def try_acquire(
        self,
        holder: str,
        sched_addr: str = "",
        sched_port: int = 0,
        admission_ports: Optional[Dict[str, int]] = None,
    ) -> Optional[Lease]:
        """Take the lead if the lease is free, expired or already ours;
        returns the new lease (its epoch raised unless it was ours and
        unexpired), or None while another holder is alive."""

        def cas():
            now = self._clock()
            current = self.read()
            if (
                current is not None
                and current.expires_at > now
                and current.holder != holder
            ):
                return None
            prev_epoch = current.epoch if current is not None else 0
            same_term = (
                current is not None
                and current.holder == holder
                and current.expires_at > now
            )
            lease = Lease(
                epoch=prev_epoch if same_term else prev_epoch + 1,
                holder=holder,
                expires_at=now + self.ttl_s,
                sched_addr=sched_addr,
                sched_port=int(sched_port),
                admission_ports=dict(admission_ports or {}),
            )
            atomic_write_json(self._lease_path, lease.to_dict())
            return lease

        lease = self._with_flock(cas)
        if lease is not None:
            obs.counter(
                "ha_lease_acquisitions_total",
                "leadership terms started (epoch mints + same-term "
                "re-acquires)",
            ).inc()
            obs.gauge(
                "ha_leader_epoch", "this process's current fenced epoch"
            ).set(float(lease.epoch))
        return lease

    def renew(self, lease: Lease) -> Lease:
        """Extend ``lease``; raises :class:`LeaseLost` if a newer epoch
        or another holder owns the record."""

        def cas():
            current = self.read()
            if (
                current is None
                or current.epoch != lease.epoch
                or current.holder != lease.holder
            ):
                raise LeaseLost(
                    f"lease epoch {lease.epoch} (holder {lease.holder!r}) "
                    f"superseded by "
                    f"{current.epoch if current else '<none>'} "
                    f"(holder {current.holder if current else '<none>'!r})"
                )
            if current.expires_at == 0.0:
                # release() stamps exactly 0.0: the holder stepped down,
                # and its own renewal thread racing the release must not
                # bring the term back while a successor acquires. A TTL
                # that merely ran out stays renewable (a store hiccup).
                raise LeaseLost(
                    f"lease epoch {lease.epoch} was released by "
                    f"{lease.holder!r}; the term is over"
                )
            renewed = lease.replace(expires_at=self._clock() + self.ttl_s)
            atomic_write_json(self._lease_path, renewed.to_dict())
            return renewed

        return self._with_flock(cas)

    def release(self, lease: Lease) -> None:
        """Expire our own lease now, so a standby takes over without
        waiting out the TTL. A lost lease is left alone: the successor
        owns the record."""

        def cas():
            current = self.read()
            if (
                current is None
                or current.epoch != lease.epoch
                or current.holder != lease.holder
            ):
                return
            atomic_write_json(
                self._lease_path, lease.replace(expires_at=0.0).to_dict()
            )

        self._with_flock(cas)


class LeaderElection:
    """One node's side of the election: acquire (a standby blocks),
    renew on a daemon thread, fence on loss.

    ``on_lost`` (given to :meth:`start_renewal`) is called at most once,
    from the renewal thread, when a renewal finds a newer epoch; the
    owner must stop dispatching at once.
    """

    def __init__(
        self,
        store: LeaseStore,
        holder: str,
        renew_interval_s: Optional[float] = None,
    ):
        self.store = store
        self.holder = str(holder)
        self._renew_interval = (
            float(renew_interval_s)
            if renew_interval_s is not None
            else store.ttl_s / 3.0
        )
        self._lock = sanitize.make_lock("ha.election.LeaderElection._lock")
        self._lease: Optional[Lease] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._on_lost: Optional[Callable[[], None]] = None
        self._lost_fired = False

    @property
    def lease(self) -> Optional[Lease]:
        with self._lock:
            return self._lease

    @property
    def epoch(self) -> int:
        lease = self.lease
        return lease.epoch if lease is not None else 0

    def is_leader(self) -> bool:
        lease = self.lease
        return lease is not None and lease.expires_at > self.store._clock()

    def acquire(
        self,
        sched_addr: str = "",
        sched_port: int = 0,
        admission_ports: Optional[Dict[str, int]] = None,
        block: bool = True,
        poll_s: float = 0.5,
        timeout_s: Optional[float] = None,
    ) -> Optional[Lease]:
        """Take (or wait for) the lead. A standby blocks here until the
        incumbent's lease expires or is released, then wins the CAS with
        the next epoch."""
        deadline = (
            time.monotonic() + timeout_s if timeout_s is not None else None
        )
        while True:
            lease = self.store.try_acquire(
                self.holder,
                sched_addr=sched_addr,
                sched_port=sched_port,
                admission_ports=admission_ports,
            )
            if lease is not None:
                with self._lock:
                    self._lease = lease
                    self._lost_fired = False
                return lease
            if not block:
                return None
            if deadline is not None and time.monotonic() > deadline:
                return None
            time.sleep(poll_s)

    def publish(
        self,
        sched_addr: Optional[str] = None,
        sched_port: Optional[int] = None,
        admission_ports: Optional[Dict[str, int]] = None,
    ) -> Lease:
        """Set the front-door map of our own lease (the same epoch: the
        map follows the leader, it does not re-elect)."""
        with self._lock:
            lease = self._lease
        if lease is None:
            raise LeaseLost("cannot publish a map without a lease")
        changes = {}
        if sched_addr is not None:
            changes["sched_addr"] = str(sched_addr)
        if sched_port is not None:
            changes["sched_port"] = int(sched_port)
        if admission_ports is not None:
            changes["admission_ports"] = dict(admission_ports)
        renewed = self.store.renew(lease.replace(**changes))
        with self._lock:
            self._lease = renewed
        return renewed

    def start_renewal(
        self, on_lost: Optional[Callable[[], None]] = None
    ) -> None:
        with self._lock:
            self._on_lost = on_lost
            if self._thread is not None:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._renew_loop, daemon=True, name="ha-lease-renew"
            )
            self._thread.start()

    def stop(self, release: bool = True) -> None:
        self._stop.set()
        with self._lock:
            thread, self._thread = self._thread, None
            lease = self._lease
        if thread is not None and thread is not threading.current_thread():
            # The renewal thread itself gets here when its on_lost
            # callback shuts the scheduler down; it exits right after.
            thread.join(timeout=self._renew_interval * 2 + 1.0)
        if release and lease is not None:
            try:
                self.store.release(lease)
            except OSError:
                pass  # the store's directory may be gone at teardown

    def _renew_loop(self) -> None:
        while not self._stop.wait(self._renew_interval):
            with self._lock:
                lease = self._lease
            if lease is None:
                continue
            try:
                renewed = self.store.renew(lease)
            except LeaseLost:
                self._fence()
                return
            except OSError:
                # The store is briefly unreachable: the lease is ours
                # until its TTL, and the next tick retries. Once our own
                # record's TTL has passed unrenewed we can no longer claim
                # it (a standby may be taking epoch + 1), so fence.
                obs.counter(
                    "ha_lease_renew_errors_total",
                    "lease renewals that failed on store I/O",
                ).inc()
                if self.store._clock() >= lease.expires_at:
                    self._fence()
                    return
                continue
            with self._lock:
                self._lease = renewed

    def _fence(self) -> None:
        """Deposed: drop the lease and fire ``on_lost`` once."""
        with self._lock:
            self._lease = None
            fire = not self._lost_fired and self._on_lost is not None
            self._lost_fired = True
            callback = self._on_lost
        obs.counter(
            "ha_lease_lost_total",
            "leadership terms ended by a newer epoch (deposed)",
        ).inc()
        if fire and callback is not None:
            callback()
