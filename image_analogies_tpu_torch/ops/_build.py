"""Build and load the port's hand-written CUDA kernels.

Each ``ops/csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes`` (no PyTorch
headers: a file that includes them takes minutes to compile, a plain one
seconds).  Libraries are built at first use, from the sources in this
checkout only, into ``image_analogies_tpu_torch/_build/`` (listed in
``.gitignore``) under a name keyed by the source's hash, so an edited source
rebuilds.  A missing ``nvcc`` or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
KERNEL_SOURCES = ("argmin_l2", "packed_best")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_VOIDP, _INT = ctypes.c_void_p, ctypes.c_int
# C signatures: every pointer and the stream as void*, sizes as int
_SIGNATURES = {
    "argmin_l2": {
        # (q, m, ldq, db, n, lddb, f, dbn, n_chunks, part_val, part_idx,
        #  out_idx, out_val, device, stream)
        "ia_argmin_l2": [_VOIDP, _INT, _INT, _VOIDP, _INT, _INT, _INT,
                         _VOIDP, _INT, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
                         _INT, _VOIDP],
    },
    "packed_best": {
        # (qa, m, wk, n, k, k_used, n_chunks, part_val, part_idx, out_idx,
        #  out_val, device, stream)
        "ia_packed_best": [_VOIDP, _INT, _VOIDP, _INT, _INT, _INT, _INT,
                           _VOIDP, _VOIDP, _VOIDP, _VOIDP, _INT, _VOIDP],
    },
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME
    (default /usr/local/cuda).  Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA kernels "
        "are built from source at first use and have no fallback")


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(names: Iterable[str] = KERNEL_SOURCES, ptxas_info: bool = False
          ) -> Dict[str, Tuple[float, str]]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together.  Returns {name: (seconds, compiler
    diagnostics)}; with ``ptxas_info`` the diagnostics include each
    kernel's registers, shared memory and spills.  Raises on any failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out) and not ptxas_info:
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_info else []),
               "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    done = {}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        done[name] = (secs, log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name`` (built if needed)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            path = library_path(name)
            if not os.path.exists(path):
                build([name])
            lib = ctypes.CDLL(path)
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.ia_error_string.argtypes = [ctypes.c_int]
            lib.ia_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return _LIBS[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error (cudaGetLastError != 0)."""
    if err != 0:
        raise RuntimeError(
            f"{what}: CUDA error {err} "
            f"({lib.ia_error_string(err).decode(errors='replace')})")
