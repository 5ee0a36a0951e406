"""A socket of its own for each admission shard, behind the front-door
map that follows the leader's epoch.

The port of the JAX package's ``shockwave_tpu/ha/frontdoor.py`` on the
port's socket transport (``runtime/rpc/wiring.py``). The cells market
shards the admission queue (one slice a cell); here each slice gets its
own AdmissionToScheduler listener, and all of them funnel into the same
:meth:`PhysicalScheduler.submit_batch` (validation, token ledger, WAL
journaling, the round loop's wake-up), so one hot submitter filling its
shard's socket cannot starve its siblings' accept queues.

The shard-to-port map is published in the leader's lease
(:attr:`shockwave_tpu_torch.ha.election.Lease.admission_ports`), so it
follows the epoch: a failover replaces the whole map at once, and
submitters that route on their side (crc32 of the token mod the shard
count, the hash the sharded queue routes by, so a retried token meets its
own ledger) reach the successor's sockets when they next read the lease.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Tuple

from shockwave_tpu_torch import obs
from shockwave_tpu_torch.runtime.rpc import wiring


class AdmissionFrontDoor:
    """One AdmissionToScheduler server per admission shard."""

    def __init__(
        self,
        scheduler,
        ports: Optional[List[int]] = None,
        max_workers_per_shard: int = 8,
    ):
        from shockwave_tpu_torch.runtime.rpc.scheduler_server import (
            _admission_deserializers,
            _admission_handlers,
        )

        queue = scheduler._admission
        num_shards = int(getattr(queue, "num_shards", 1) or 1)
        self._servers: List[wiring.Server] = []
        self.ports: Dict[str, int] = {}
        handlers = _admission_handlers(
            {"submit_jobs": scheduler._submit_jobs_rpc}
        )
        for i in range(num_shards):
            # Port 0: the listener binds a free port and reports it.
            port = int(ports[i]) if ports is not None and i < len(ports) else 0
            server = wiring.serve(
                port,
                {"AdmissionToScheduler": (
                    handlers, _admission_deserializers(),
                )},
                max_workers_per_shard,
            )
            self._servers.append(server)
            self.ports[f"s{i:02d}"] = server.port
        obs.gauge(
            "ha_frontdoor_shards",
            "admission shard sockets served by this leader",
        ).set(float(num_shards))

    def stop(self, grace: float = 1.0) -> None:
        for server in self._servers:
            server.stop(grace=grace)


def shard_port_for_token(
    admission_ports: Dict[str, int], token: str
) -> Optional[int]:
    """The submitter's shard routing: the crc32 hash the sharded queue
    routes by, so a retried token reaches the shard that holds its
    ledger entry whichever generation of sockets it crossed."""
    if not admission_ports:
        return None
    ordered = [admission_ports[k] for k in sorted(admission_ports)]
    return ordered[zlib.crc32(str(token).encode("utf-8")) % len(ordered)]


def resolve_submit_target(
    ha_dir: str, token: str = ""
) -> Optional[Tuple[str, int, int]]:
    """``(addr, port, epoch)`` of the current leader's admission socket
    for ``token``: the submitter's half of the front-door map. None while
    no unexpired leader has published its address."""
    from shockwave_tpu_torch.ha.election import LeaseStore

    lease = LeaseStore(ha_dir).leader()
    if lease is None or not lease.sched_addr:
        return None
    port = shard_port_for_token(lease.admission_ports, token)
    return (
        lease.sched_addr,
        int(port if port else lease.sched_port),
        lease.epoch,
    )
