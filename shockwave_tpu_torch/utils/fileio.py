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


def read_json_arg(value: str, flag: str):
    """CLI convention for JSON-valued flags: ``value`` is either a path
    to a JSON file or a JSON literal. Raises SystemExit with a one-line
    message naming ``flag`` when it is neither."""
    if os.path.exists(value):
        with open(value) as f:
            return json.load(f)
    try:
        return json.loads(value)
    except json.JSONDecodeError:
        raise SystemExit(
            f"{flag} {value!r} is neither an existing file nor a JSON "
            "literal"
        ) from None


def atomic_append_text(path: str, text: str) -> None:
    """Append ``text`` to ``path`` in a single O_APPEND write (the flight
    recorder's grow-only log): a crash mid-call can only lose or truncate
    the final record, which readers skip."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        view = memoryview(text.encode("utf-8"))
        while view:
            # os.write may write fewer bytes than asked.
            written = os.write(fd, view)
            view = view[written:]
    finally:
        os.close(fd)
