"""ctypes binding for the native instance reader `native/gjio.cpp`
(counterpart of `greyjack_tpu/native/gjio.py`).

The C++ tokenizer is built with g++ at first use into
`greyjack_tpu_torch/_build/libgjio_<hash>.so`, named by a hash of the
source and the flags (as `cuda_build.py` names the CUDA kernels), so an
edited source builds anew and nothing is written beside the source. When
the source or a compiler is missing, or the build fails, `parse_instance`
returns None and the readers scan the file in Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "gjio.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_state = {"lib": None, "failed": False}


def library_path():
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"libgjio_{h.hexdigest()[:16]}.so")


def _build(path):
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, _SRC, "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _declare(lib):
    lib.gj_parse_instance.restype = ctypes.c_void_p
    lib.gj_parse_instance.argtypes = [ctypes.c_char_p]
    lib.gj_free.restype = None
    lib.gj_free.argtypes = [ctypes.c_void_p]
    for name in ("gj_error", "gj_name", "gj_edge_weight_type"):
        getattr(lib, name).restype = ctypes.c_char_p
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    for name in ("gj_capacity", "gj_vehicles_count", "gj_n_nodes",
                 "gj_demand_stride", "gj_n_demand_rows", "gj_n_depots",
                 "gj_matrix_rows"):
        getattr(lib, name).restype = ctypes.c_int64
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    for name, typ in (
            ("gj_node_ids", ctypes.c_int64), ("gj_node_xs", ctypes.c_double),
            ("gj_node_ys", ctypes.c_double),
            ("gj_demand_rows", ctypes.c_int64),
            ("gj_depot_ids", ctypes.c_int64), ("gj_matrix", ctypes.c_double)):
        getattr(lib, name).restype = ctypes.POINTER(typ)
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    return lib


def load_native():
    """The loaded library, built first if needed; None when it cannot be
    built or loaded (then it is not tried again in this process)."""
    with _lock:
        if _state["lib"] is not None or _state["failed"]:
            return _state["lib"]
        try:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                # a library left by another machine's build: build anew
                _build(path)
                lib = ctypes.CDLL(path)
            _state["lib"] = _declare(lib)
        except (OSError, subprocess.CalledProcessError):
            _state["failed"] = True
        return _state["lib"]


def native_available() -> bool:
    return load_native() is not None


def _arr(ptr, n, dtype):
    if n == 0:
        return np.zeros(0, dtype=dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def parse_instance(path: str):
    """Parse a .tsp / .vrp file natively: a dict of name, edge_weight_type,
    capacity, vehicles_count, ids, xs, ys, demand_rows [n, stride],
    depot_ids and matrix [rows, n] (or None), as numpy arrays. None when
    the native library is unavailable; raises IOError on a parse error."""
    lib = load_native()
    if lib is None:
        return None
    h = lib.gj_parse_instance(os.fsencode(path))
    try:
        err = lib.gj_error(h)
        if err:
            raise IOError(err.decode())
        n = lib.gj_n_nodes(h)
        stride = lib.gj_demand_stride(h)
        n_dem = lib.gj_n_demand_rows(h)
        mat_rows = lib.gj_matrix_rows(h)
        return {
            "name": lib.gj_name(h).decode(),
            "edge_weight_type": lib.gj_edge_weight_type(h).decode(),
            "capacity": int(lib.gj_capacity(h)),
            "vehicles_count": int(lib.gj_vehicles_count(h)),
            "ids": _arr(lib.gj_node_ids(h), n, np.int64),
            "xs": _arr(lib.gj_node_xs(h), n, np.float64),
            "ys": _arr(lib.gj_node_ys(h), n, np.float64),
            "demand_rows": (
                _arr(lib.gj_demand_rows(h), n_dem * stride, np.int64)
                .reshape(n_dem, stride) if stride
                else np.zeros((0, 0), np.int64)),
            "depot_ids": _arr(lib.gj_depot_ids(h), lib.gj_n_depots(h),
                              np.int64),
            "matrix": (_arr(lib.gj_matrix(h), mat_rows * n, np.float64)
                       .reshape(mat_rows, n) if mat_rows else None),
        }
    finally:
        lib.gj_free(h)
