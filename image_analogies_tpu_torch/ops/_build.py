"""Build and load the port's hand-written CUDA kernels.

Each ``ops/csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes`` (no PyTorch
headers: a file that includes them takes minutes to compile, a plain one
seconds).  Libraries are built at first use, from the sources in this
checkout only, into ``image_analogies_tpu_torch/_build/`` (listed in
``.gitignore``) under a name keyed by the hash of the source and of the
shared headers (``csrc/*.cuh``), so an edited source or header rebuilds.
A missing ``nvcc`` or a failed build raises: there is no fallback.
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
# the four superseded packed forms have a source each (32 instances a
# form), so that no one nvcc runs far longer than the others
PACKED_FORMS = ("packed2_best", "packed1w_best", "packed2wn_best",
                "packed1wn_best")
KERNEL_SOURCES = ("argmin_l2", "argmin_bf16", "packed2k_best",
                  "packed2kw_best", "packed3_best", "packed3w_best",
                  *PACKED_FORMS, "tile_champions", "argmin2",
                  "pertile_champions")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_VOIDP, _INT = ctypes.c_void_p, ctypes.c_int
# (q, w1, w2, dbnh, m, n, k, k_used, consumers, bm, stages, tiles_per_chunk,
#  smem, n_chunks, part_val, part_idx, out_idx, out_val, device, stream):
# the global-champion packed scans but packed2k
_BEST = [_VOIDP] * 4 + [_INT] * 10 + [_VOIDP] * 4 + [_INT, _VOIDP]
# (q, w1, w2, dbnh, m, n, k, k_used, fold, tile_n, consumers, bm, stages,
#  tiles_per_chunk, smem, n_chunks, out_val, out_idx, device, stream): the
# per-tile champions of the packed passes
_TILES = [_VOIDP] * 4 + [_INT] * 12 + [_VOIDP] * 2 + [_INT, _VOIDP]
# C signatures: every pointer and the stream as void*, sizes as int
_SIGNATURES = {
    "argmin_l2": {
        # (q, m, ldq, db, n, lddb, f, dbn, nq, q_chunks, n_chunks,
        #  tiles_per_chunk, keys, ticket, out_idx, out_val, device, stream)
        "ia_argmin_l2": [_VOIDP, _INT, _INT, _VOIDP, _INT, _INT, _INT,
                         _VOIDP] + [_INT] * 4 + [_VOIDP] * 4
                        + [_INT, _VOIDP],
    },
    "argmin_bf16": {
        # (q, qf32, qk, db, dbn, m, n, k, k_used, consumers, bm, stages,
        #  tiles_per_chunk, smem, n_chunks, part_val, part_idx, out_idx,
        #  out_val, device, stream)
        "ia_argmin_l2_bf16": [_VOIDP, _INT] + [_VOIDP] * 3 + [_INT] * 10
                             + [_VOIDP] * 4 + [_INT, _VOIDP],
    },
    # (qa, wk, m, n, k, k_used, consumers, bm, stages, tiles_per_chunk,
    #  smem, n_chunks, part_val, part_idx, out_idx, out_val, device,
    #  stream): packed2k, and past 512 lanes its wide instance
    **{name: {f"ia_{name}": [_VOIDP] * 2 + [_INT] * 10 + [_VOIDP] * 4
                            + [_INT, _VOIDP]}
       for name in ("packed2k_best", "packed2kw_best")},
    "packed3_best": {"ia_packed3_best": _BEST},
    # packed3 past 256 lanes, and its per-tile champions
    "packed3w_best": {"ia_packed3w_best": _BEST,
                      "ia_packed3w_champions": _TILES},
    **{form: {f"ia_{form}": _BEST} for form in PACKED_FORMS},
    "tile_champions": {"ia_tile_champions": _TILES},
    "pertile_champions": {
        # (q, qf32, qk, db, dbnh, m, n, k, k_used, q_split, tile_n,
        #  consumers, bm, stages, tiles_per_chunk, smem, n_chunks, parts,
        #  part_val, part_idx, out_val, out_idx, device, stream)
        "ia_pertile_champions": [_VOIDP, _INT] + [_VOIDP] * 3 + [_INT] * 13
                                + [_VOIDP] * 4 + [_INT, _VOIDP],
    },
    "argmin2": {
        # (q, db, dbn, m, n, k, k_used, q_split, consumers, bm, stages,
        #  tiles_per_chunk, smem, n_chunks, part_v1, part_i1, part_v2,
        #  part_i2, i1, v1, i2, v2, device, stream)
        "ia_argmin2": [_VOIDP] * 3 + [_INT] * 11 + [_VOIDP] * 8
                      + [_INT, _VOIDP],
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
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(names: Iterable[str] = KERNEL_SOURCES, ptxas_info: bool = False
          ) -> Dict[str, Tuple[float, str]]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together.  Returns {name: (seconds from the
    common start to that source's end, compiler diagnostics)}; with
    ``ptxas_info`` the diagnostics include each kernel's registers, shared
    memory and spills.  Raises on any failure."""
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
        # the diagnostics go to a file, so that a process is never held up
        # by a full pipe while the others are awaited
        log = open(f"{tmp}.log", "w+")
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       log, tmp, out)
    t0 = time.perf_counter()
    done = {}
    failed = []
    while procs:
        for name, (proc, log, tmp, out) in list(procs.items()):
            if proc.poll() is None:
                continue
            secs = time.perf_counter() - t0
            del procs[name]
            log.seek(0)
            text = log.read()
            log.close()
            os.remove(log.name)
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{text}")
                continue
            os.replace(tmp, out)
            done[name] = (secs, text)
        time.sleep(0.05)
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
