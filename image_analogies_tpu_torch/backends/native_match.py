"""Brute-force L2 argmin for the CPU matcher, with an optional native core
(the port's copy of the JAX package's ``backends/native_match.py``).

With ``use_ann`` off the CPU matcher's approximate match is a brute-force
argmin: the C++ OpenMP kernel of ``native/match.cpp`` where a host
compiler is found, else a NumPy fallback.  The JAX package loads a library
built by ``make -C native``; the port builds the same source with the
Makefile's flags at first use, into its own library directory
(``ops/_build.py build_dir()``, the directory of the kernel libraries)
under a name keyed by the source's hash, and writes nothing under
``native/``.  Where no compiler is found, or the build fails, the NumPy
fallback runs, as in the JAX package.  ``set_native(False)`` forces the
fallback (the JAX package's path wherever its library is not built).

Both forms return the lowest index on ties; they sum in different orders,
so a near-tie can resolve apart.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from image_analogies_tpu_torch.ops import _build

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "match.cpp")
# native/Makefile's CXXFLAGS
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-shared", "-Wall")

_LIB: Optional[ctypes.CDLL] = None
_TRIED_DIR: Optional[str] = None
_ENABLED = True
_LOCK = threading.Lock()


def set_native(enabled: bool) -> None:
    """Use the native core where it builds (True, the default) or always
    the NumPy fallback (False)."""
    global _ENABLED
    _ENABLED = bool(enabled)


def library_path() -> Optional[str]:
    """The native library's path in the library directory in effect (None
    where the source is missing)."""
    try:
        with open(SOURCE, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:12]
    except OSError:
        return None
    return os.path.join(_build.build_dir(), f"libia_match-{digest}.so")


def _compile(out: str) -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        return False
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, timeout=300)
        if proc.returncode != 0:
            return False
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    """The native library, built at first use; None where it cannot be
    built or loaded (tried once per library directory)."""
    global _LIB, _TRIED_DIR
    if not _ENABLED:
        return None
    if _TRIED_DIR == _build.build_dir():
        return _LIB
    with _LOCK:
        if _TRIED_DIR == _build.build_dir():
            return _LIB
        lib = None
        path = library_path()
        if path is not None and (os.path.exists(path) or _compile(path)):
            try:
                lib = ctypes.CDLL(path)
                lib.ia_brute_argmin.restype = None
                lib.ia_brute_argmin.argtypes = [
                    ctypes.POINTER(ctypes.c_float),  # db (n, f)
                    ctypes.c_int64,  # n
                    ctypes.c_int64,  # f
                    ctypes.POINTER(ctypes.c_float),  # queries (m, f)
                    ctypes.c_int64,  # m
                    ctypes.POINTER(ctypes.c_int64),  # out idx (m,)
                    ctypes.POINTER(ctypes.c_float),  # out dist (m,)
                ]
            except OSError:
                lib = None
        _LIB, _TRIED_DIR = lib, _build.build_dir()
    return _LIB


def have_native() -> bool:
    return _load() is not None


def brute_argmin_batch(db: np.ndarray, queries: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact L2 argmin of each query row against the DB.

    Returns (idx (m,) int64, squared_dist (m,) float32); ties -> lowest
    index."""
    db = np.ascontiguousarray(db, dtype=np.float32)
    queries = np.ascontiguousarray(queries, dtype=np.float32)
    n, f = db.shape
    m = queries.shape[0]
    lib = _load()
    if lib is not None:
        idx = np.empty(m, dtype=np.int64)
        dist = np.empty(m, dtype=np.float32)
        lib.ia_brute_argmin(
            db.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, f,
            queries.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), m,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            dist.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return idx, dist
    # NumPy fallback: ||a-b||^2 = ||a||^2 - 2ab + ||b||^2, blocked over
    # queries
    dbn = (db * db).sum(axis=1)
    idx = np.empty(m, dtype=np.int64)
    dist = np.empty(m, dtype=np.float32)
    step = max(1, int(2e7 // max(n, 1)))
    for s0 in range(0, m, step):
        q = queries[s0 : s0 + step]
        d = dbn[None, :] - 2.0 * (q @ db.T)
        k = np.argmin(d, axis=1)
        idx[s0 : s0 + step] = k
        qn = (q * q).sum(axis=1)
        dist[s0 : s0 + step] = d[np.arange(len(k)), k] + qn
    np.maximum(dist, 0.0, out=dist)
    return idx, dist


def brute_argmin(db: np.ndarray, query: np.ndarray) -> Tuple[int, float]:
    idx, dist = brute_argmin_batch(db, query[None, :])
    return int(idx[0]), float(dist[0])
