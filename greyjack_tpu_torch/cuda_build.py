"""Build and load the port's CUDA kernels.

Each kernel source under `csrc/` exports a plain C function. It is compiled
with nvcc for Hopper (`sm_90a`) into a shared library under `_build/`, named
by a hash of the sources and flags, and loaded with ctypes. A library that
already exists for the same hash is reused, so a checkout builds each
kernel once, at first use. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> {"seconds": build seconds (0.0 when reused), "log": nvcc output}
BUILD_INFO = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels build only where the CUDA "
                           "toolkit is installed")
    return path


def library_path(name, sources):
    h = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def load_library(name, sources):
    """Compile `sources` into `_build/lib<name>_<hash>.so` unless present,
    then load it. Raises with nvcc's output when the build fails."""
    path = library_path(name, sources)
    if not os.path.exists(path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}"
                                   f"\n{proc.stderr}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                            "log": proc.stdout + proc.stderr}
    else:
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": ""})
    return ctypes.CDLL(path)
