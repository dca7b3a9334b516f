"""Atomic file writes: tmp + fsync + rename.

Checkpoint persistence (Deli snapshots, service state) must never leave
a HALF-written file where the old checkpoint used to be — a crash mid-
write would otherwise destroy the only recovery anchor. POSIX rename is
atomic within a filesystem, so: write to a sibling tmp file, fsync,
rename over the target. A crash before the rename leaves the previous
checkpoint intact (plus a stray ``.tmp`` that the next write replaces).

The ``checkpoint.mid_write`` fault point sits between the tmp write and
the rename — exactly the window a chaos drill kills to prove the old
file survives.
"""

from __future__ import annotations

import json
import os
import tempfile

from .faultpoints import SITE_CHECKPOINT_MID_WRITE, fault_point


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` atomically (all-or-nothing)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        fault_point(SITE_CHECKPOINT_MID_WRITE, path=path, tmp=tmp)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: str, obj) -> None:
    atomic_write_bytes(path, json.dumps(obj).encode())


def read_json(path: str):
    with open(path, "rb") as f:
        return json.loads(f.read())
