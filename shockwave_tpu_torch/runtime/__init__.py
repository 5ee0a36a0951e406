"""Physical-cluster runtime of the port: the control plane's RPC on a
socket transport (``rpc/``, ``protobuf/``), the worker agent and its
dispatcher, the lease-aware training iterator, streaming admission, the
retry discipline and seeded fault injection (reference:
scheduler/runtime/, scheduler/worker.py, scheduler/gavel_iterator.py,
scheduler/lease.py; the JAX package's ``runtime/``)."""

from shockwave_tpu_torch.runtime.lease import INFINITY, Lease

__all__ = ["Lease", "INFINITY"]
