"""Build and load the port's hand-written CUDA kernels.

Each ``ops/csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes`` (no PyTorch
headers: a file that includes them takes minutes to compile, a plain one
seconds).  Libraries are built at first use, from the sources in this
checkout only, into the library directory under a name keyed by the hash
of the source and of the shared headers (``csrc/*.cuh``), so an edited
source or header rebuilds.  A missing ``nvcc`` or a failed build raises:
there is no fallback.

The library directory is the port's compile cache: ``IA_COMPILE_CACHE_DIR``
over ``AnalogyParams.compile_cache_dir`` (``set_build_dir``, which
``tune/warmup.py apply_runtime_config`` calls at the start of each run)
over ``image_analogies_tpu_torch/_build/`` (listed in ``.gitignore``).  A
library is loaded only from the directory in effect: one built in
another directory is never used.  Inside a metrics run each library
``nvcc`` builds counts in ``compile.count`` / ``compile.ms`` and each one
found already built in ``compile.cache_hits`` (``obs/device.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

from image_analogies_tpu_torch.obs import device as _obs_device

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
    #  stream): packed2k
    "packed2k_best": {"ia_packed2k_best": [_VOIDP] * 2 + [_INT] * 10
                                          + [_VOIDP] * 4 + [_INT, _VOIDP]},
    # the same with reg_ksteps after k_used: packed2k past 512 lanes
    "packed2kw_best": {"ia_packed2kw_best": [_VOIDP] * 2 + [_INT] * 11
                                            + [_VOIDP] * 4 + [_INT, _VOIDP]},
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

COMPILE_CACHE_ENV = "IA_COMPILE_CACHE_DIR"

_LOCK = threading.Lock()
# name -> (the directory it was loaded from, the library)
_LIBS: Dict[str, Tuple[str, ctypes.CDLL]] = {}
_BUILT: set = set()  # library paths nvcc built in this process
_HASHES: Dict[str, str] = {}  # name -> hash of its source and the headers


def _env_dir() -> Optional[str]:
    return os.environ.get(COMPILE_CACHE_ENV, "").strip() or None


_DIR = os.path.abspath(_env_dir() or BUILD_DIR)  # the directory in effect


def set_build_dir(directory: Optional[str] = None) -> str:
    """Make the library directory ``IA_COMPILE_CACHE_DIR``, else
    ``directory``, else the default ``BUILD_DIR``; returns it."""
    global _DIR
    new = os.path.abspath(_env_dir() or directory or BUILD_DIR)
    if new != _DIR:
        _DIR = new
    return _DIR


def build_dir() -> str:
    """The library directory in effect."""
    return _DIR


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
    """The library of source ``name`` in the directory in effect (the
    sources are hashed once a process)."""
    digest = _HASHES.get(name)
    if digest is None:
        h = hashlib.sha256()
        headers = sorted(f for f in os.listdir(CSRC_DIR)
                         if f.endswith(".cuh"))
        for fname in [f"{name}.cu", *headers]:
            with open(os.path.join(CSRC_DIR, fname), "rb") as f:
                h.update(f.read())
        digest = _HASHES[name] = h.hexdigest()[:12]
    return os.path.join(_DIR, f"lib{name}-{digest}.so")


def build(names: Iterable[str] = KERNEL_SOURCES, ptxas_info: bool = False
          ) -> Dict[str, Tuple[float, str]]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together.  Returns {name: (seconds from the
    common start to that source's end, compiler diagnostics)}; with
    ``ptxas_info`` the diagnostics include each kernel's registers, shared
    memory and spills.  Raises on any failure."""
    os.makedirs(_DIR, exist_ok=True)
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
            _BUILT.add(out)
            _obs_device.note_compile(name, secs * 1e3)
            done[name] = (secs, text)
        time.sleep(0.05)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name`` from the directory in
    effect (built there if needed)."""
    got = _LIBS.get(name)
    if got is not None and got[0] == _DIR:
        return got[1]
    with _LOCK:
        got = _LIBS.get(name)
        if got is None or got[0] != _DIR:
            path = library_path(name)
            if not os.path.exists(path):
                build([name])
            elif path not in _BUILT:
                _obs_device.note_cache_hit(name)
            lib = ctypes.CDLL(path)
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.ia_error_string.argtypes = [ctypes.c_int]
            lib.ia_error_string.restype = ctypes.c_char_p
            _LIBS[name] = (_DIR, lib)
    return _LIBS[name][1]


def preload(names: Iterable[str]) -> None:
    """Load every named library now, building the missing ones together
    first (one ``nvcc`` each): what a caller does before work that must not
    wait on a first-use build, such as a level under a watchdog."""
    names = list(names)
    with _LOCK:
        missing = [n for n in names
                   if _LIBS.get(n, ("",))[0] != _DIR
                   and not os.path.exists(library_path(n))]
        if missing:
            build(missing)
    for name in names:
        load(name)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error (cudaGetLastError != 0)."""
    if err != 0:
        raise RuntimeError(
            f"{what}: CUDA error {err} "
            f"({lib.ia_error_string(err).decode(errors='replace')})")
