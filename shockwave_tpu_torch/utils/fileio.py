"""Atomic file writes: a temporary file in the target directory, then a
rename (the port's copy of the JAX package's
``shockwave_tpu/utils/fileio.py``). A run killed mid-write leaves either
the previous complete file or the new one, never a prefix."""

from __future__ import annotations

import json
import os
import tempfile


def atomic_write_text(path: str, text: str) -> None:
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp_path = tempfile.mkstemp(
        dir=directory, prefix=os.path.basename(path) + ".", suffix=".tmp"
    )
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_path, path)
    except BaseException:
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        raise


def atomic_write_json(path: str, obj, indent: int = 2) -> None:
    """Serialize ``obj`` as JSON and atomically replace ``path``."""
    atomic_write_text(path, json.dumps(obj, indent=indent) + "\n")
