"""Build the port's hand-written CUDA kernels into plain-C shared libraries.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into
its own ``lib<name>.so`` in the package's git-ignored ``_build/``
directory, bound with ctypes by its wrapper module. The first wrapper that
needs a kernel builds them all at once: one ``nvcc`` per source, all
started together, with the native sequencer's ``g++`` build beside them,
so a process pays for the slowest compile and not for the sum. Each
library is written under a temporary name and then ``os.replace``d into
place, so concurrent builds never load a half-written file. A failed
compile raises.

Usage: ``python -m fluidframework_tpu_torch.ops.cuda_build`` (on a machine
with the CUDA toolkit).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
import time

from ..native.build import TARGETS as NATIVE_TARGETS, ensure_built

PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_ROOT, "csrc")
BUILD_DIR = os.path.join(PKG_ROOT, "_build")
#: kernel name → source file under ``csrc/``
SOURCES = {"string_apply": "string_apply.cu", "map_apply": "map_apply.cu",
           "cell_merge": "cell_merge.cu", "axis_apply": "axis_apply.cu",
           "tree_apply": "tree_apply.cu",
           "megadoc_apply": "megadoc_apply.cu"}
# -split-compile=0: a source's template instantiations compile in parallel
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-split-compile=0", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

#: per kernel name: {"seconds": its nvcc wall, "ptxas": the -Xptxas -v
#: report}; "libdeli.so" / "liboplog.so" / "libingress.so": {"seconds"}
#: for the native sequencer, durable log and frame decode built beside
#: them
build_info: dict = {}
_paths: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def build_all() -> None:
    """Compile every kernel source not yet built by this process (one
    ``nvcc`` each, all at once) and the native sequencer, durable log and
    frame decode beside them (one ``g++`` each)."""
    with _lock:
        todo = [n for n in SOURCES if n not in _paths]
        if not todo:
            return
        os.makedirs(BUILD_DIR, exist_ok=True)
        errors = []

        def compile_one(name):
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            src = os.path.join(CSRC, SOURCES[name])
            t0 = time.perf_counter()
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                errors.append(f"nvcc failed building {src}:\n{proc.stderr}")
                return
            out = os.path.join(BUILD_DIR, f"lib{name}.so")
            os.replace(tmp, out)
            build_info[name] = {"seconds": time.perf_counter() - t0,
                                "ptxas": proc.stderr}
            _paths[name] = out

        def build_native(target):
            t0 = time.perf_counter()
            try:
                ensure_built(target)
            except RuntimeError as e:
                errors.append(str(e))
                return
            build_info[target] = {"seconds": time.perf_counter() - t0}

        threads = [threading.Thread(target=compile_one, args=(n,))
                   for n in todo] + [
            threading.Thread(target=build_native, args=(t,))
            for t in NATIVE_TARGETS]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise RuntimeError("\n".join(errors))


def libraries() -> dict:
    """{kernel name: library path} of the kernels this process built."""
    with _lock:
        return dict(_paths)


def adopt(paths: dict) -> None:
    """Take kernel libraries this checkout already built in another
    process (``libraries()`` of a parent) instead of building them again:
    a child process of a run starts without an ``nvcc`` pass."""
    with _lock:
        _paths.update(paths)


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel ``name``'s library (builds at first
    use)."""
    build_all()
    return ctypes.CDLL(_paths[name])


if __name__ == "__main__":
    build_all()
    for n, info in sorted(build_info.items()):
        print(f"{n}: {info['seconds']:.1f} s")
