"""Build the native host components (g++ → shared libraries for ctypes):
the sequencer (``libdeli.so``), the durable op log (``liboplog.so``) and
the columnar front door's frame decode (``libingress.so``).

``ensure_built()`` compiles a target into the package's git-ignored build
directory at first use. The compile writes a temporary file and then
``os.replace``s it into place, so parallel test workers that build at the
same moment never load a half-written library. A failed build raises:
no caller falls back to another implementation.

Usage: ``python -m fluidframework_tpu_torch.native.build``.
"""

from __future__ import annotations

import os
import subprocess
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(HERE), "_build")

TARGETS = {"libdeli.so": ["sequencer.cpp"],
           "liboplog.so": ["oplog.cpp"],
           "libingress.so": ["ingress.cpp"]}


def ensure_built(target: str = "libdeli.so") -> str:
    """Path to the built library; compiles it when missing or stale."""
    out = os.path.join(BUILD_DIR, target)
    srcs = [os.path.join(HERE, s) for s in TARGETS[target]]
    if os.path.exists(out) and all(
            os.path.getmtime(out) >= os.path.getmtime(s) for s in srcs):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", tmp, *srcs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot build {target}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed building {target}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    for t in TARGETS:
        print(f"{t}: built at {ensure_built(t)}")
