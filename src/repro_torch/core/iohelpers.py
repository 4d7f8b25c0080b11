"""Filesystem helpers for the port's on-disk JSON caches.

The port's own copy of the reference's ``core/iohelpers.py``: one
durable-write idiom for a JSON document several processes may write (the
calibration-scale cache): a unique temp file in the target directory
(``mkstemp``), fsynced, then ``os.replace``\\ d over the target in one
atomic rename, so readers only ever see a complete document and the last
writer wins.
"""

from __future__ import annotations

import json
import os
import tempfile


def atomic_write_json(path: str, obj, *, indent: int = 1,
                      sort_keys: bool = True) -> str:
    """Atomically serialize ``obj`` as JSON to ``path``, creating the
    parent directory if needed.  On any failure the temp file is removed
    and an existing ``path`` is untouched.  Returns ``path``."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=indent, sort_keys=sort_keys)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def read_json(path: str):
    """Load a JSON document, or ``None`` for a missing or torn file."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None
