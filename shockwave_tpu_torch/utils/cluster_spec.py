"""Cluster-spec string parsing, shared by the command-line entry points.

Two forms:
  * the reference's positional ``v100:p100:k80`` counts (the ``-c``
    vocabulary of its trace simulation script), and
  * named ``type=count[,type=count...]`` pairs for arbitrary worker
    types (e.g. ``tpu_v5e=8`` against a measured oracle).
"""

from __future__ import annotations

REFERENCE_WORKER_TYPES = ("v100", "p100", "k80")


def parse_cluster_spec(spec: str) -> dict:
    """``"v100:p100:k80"`` counts or ``"type=count,..."`` pairs ->
    {worker_type: count}, zero-count types dropped."""
    spec = spec.strip()
    if "=" in spec:
        out = {}
        for token in spec.split(","):
            token = token.strip()
            if not token:
                continue
            parts = token.split("=")
            if len(parts) != 2 or not parts[0].strip():
                raise ValueError(
                    f"bad cluster spec token {token!r} "
                    "(expected type=count)"
                )
            name, count = parts[0].strip(), int(parts[1])
            if count > 0:
                out[name] = count
        return out
    counts = [int(x) for x in spec.split(":")]
    return {
        wt: n for wt, n in zip(REFERENCE_WORKER_TYPES, counts) if n > 0
    }
