"""ctypes bindings for the native (C++) scene-build runtime.

Loads csrc/libraytracer2_native.so, (re)building it from
csrc/cluster_builder.cpp first when it is missing or older than its source,
so a library built elsewhere never outlives its source. The build uses
portable flags (no -march=native): the library may be loaded on another
host than the one that built it. Falls back cleanly when no C++ compiler is
present — callers check `available()`.
"""

from __future__ import annotations

import ctypes
import logging
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_CSRC = Path(__file__).resolve().parent.parent.parent / "csrc"
_SRC_PATH = _CSRC / "cluster_builder.cpp"
_LIB_PATH = _CSRC / "libraytracer2_native.so"
_lib = None
_tried = False


def _stale() -> bool:
    return (not _LIB_PATH.exists()
            or _LIB_PATH.stat().st_mtime < _SRC_PATH.stat().st_mtime)


def _build() -> None:
    """Compile into a private file, then rename over the library, so
    processes that build at once never load a half-written file."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
    tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, "-O3", "-fPIC", "-std=c++17", "-Wall",
                        "-shared", "-o", str(tmp), str(_SRC_PATH)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, _LIB_PATH)
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if _stale():
        try:
            _build()
        except Exception as e:  # toolchain missing — fall back
            logger.warning("native SAH builder unavailable: %s", e)
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.rt2_native_abi_version.restype = ctypes.c_int
        if lib.rt2_native_abi_version() != 1:
            logger.warning("native ABI mismatch; ignoring %s", _LIB_PATH)
            return None
        lib.rt2_build_sah_clusters.restype = ctypes.c_int
        lib.rt2_build_sah_clusters.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        _lib = lib
    except OSError as e:
        logger.warning("native library load failed: %s", e)
    return _lib


def available() -> bool:
    return _load() is not None


def build_sah_clusters(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                       cluster_size: int
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Binned-SAH clustering. Returns (order [n], offsets [c], counts [c])
    or None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = int(v0.shape[0])
    if n == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.int32))
    v0 = np.ascontiguousarray(v0, np.float32)
    e1 = np.ascontiguousarray(e1, np.float32)
    e2 = np.ascontiguousarray(e2, np.float32)
    order = np.empty(n, np.int32)
    max_clusters = 2 * (n // max(cluster_size, 1) + 2)
    offsets = np.empty(max_clusters, np.int32)
    counts = np.empty(max_clusters, np.int32)

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    c = lib.rt2_build_sah_clusters(
        v0.ctypes.data_as(fp), e1.ctypes.data_as(fp), e2.ctypes.data_as(fp),
        n, cluster_size, order.ctypes.data_as(ip),
        offsets.ctypes.data_as(ip), counts.ctypes.data_as(ip), max_clusters)
    if c < 0:
        logger.warning("native cluster build overflow; falling back")
        return None
    return order, offsets[:c], counts[:c]
