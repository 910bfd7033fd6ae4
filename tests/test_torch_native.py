"""The port's native CPU core against the JAX package's native path.

``native/match.cpp`` is the one C++ source of both packages' brute-force
argmin (``backend="cpu"``, ``use_ann=False``).  The JAX package loads the
library ``make -C native`` builds; the port builds the same source with
the Makefile's flags at first use, into its own library directory.  Here
the JAX library is built with the Makefile's flags into ``tmp_path`` and
handed to the unedited JAX module through its ``_LIB`` / ``_TRIED``
globals; the port builds its own into another temporary directory.
Nothing is written under ``native/``.  Inputs are seeded with numpy and
hold exact duplicate rows, so the lowest-index rule decides ties; the
comparison is bit for bit (tolerance 0: one source, one compiler, one
summation order).
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest

from image_analogies_tpu.backends import native_match as jnm
from image_analogies_tpu.config import AnalogyParams as JParams
from image_analogies_tpu.models.analogy import create_image_analogy as jrun
from image_analogies_tpu_torch import create_image_analogy
from image_analogies_tpu_torch.backends import native_match as tnm
from image_analogies_tpu_torch.config import AnalogyParams
from image_analogies_tpu_torch.ops import _build
from tests.conftest import make_pair

NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
CXX = shutil.which("g++")
pytestmark = pytest.mark.skipif(
    CXX is None, reason="no g++: native/match.cpp cannot be built here")


def makefile_flags():
    """``native/Makefile``'s CXXFLAGS."""
    with open(os.path.join(NATIVE, "Makefile")) as f:
        m = re.search(r"^CXXFLAGS\s*\?=\s*(.+)$", f.read(), re.M)
    return m.group(1).split()


class _Counting:
    """A loaded native library whose ``ia_brute_argmin`` calls are
    counted (to show that a run went through the native core)."""

    def __init__(self, lib):
        self.lib = lib
        self.calls = 0

    def ia_brute_argmin(self, *args):
        self.calls += 1
        return self.lib.ia_brute_argmin(*args)


@pytest.fixture
def natives(tmp_path, monkeypatch):
    """(JAX library, port library), both counting their calls: the JAX
    one built by the Makefile's flags into tmp_path and loaded with the
    JAX module's argtypes, the port's built by the port into another
    directory of tmp_path."""
    before = sorted(os.listdir(NATIVE))
    out = tmp_path / "jax" / "libia_match.so"
    out.parent.mkdir()
    subprocess.run([CXX, *makefile_flags(), "-o", str(out),
                    os.path.join(NATIVE, "match.cpp")], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
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
    jlib = _Counting(lib)
    monkeypatch.setattr(jnm, "_LIB", jlib)
    monkeypatch.setattr(jnm, "_TRIED", True)
    assert jnm.have_native()

    # the run's library directory resolves through the environment first
    # (``_build.set_build_dir``, at every run's start)
    monkeypatch.setenv(_build.COMPILE_CACHE_ENV, str(tmp_path / "port"))
    monkeypatch.setattr(_build, "_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(tnm, "_ENABLED", True)
    monkeypatch.setattr(tnm, "_LIB", None)
    monkeypatch.setattr(tnm, "_TRIED_DIR", None)
    assert tnm.have_native(), "g++ found but the port's build failed"
    assert os.path.dirname(tnm.library_path()) == str(tmp_path / "port")
    tlib = _Counting(tnm._LIB)
    monkeypatch.setattr(tnm, "_LIB", tlib)
    yield jlib, tlib
    assert sorted(os.listdir(NATIVE)) == before


def test_makefile_flags_are_the_ports():
    assert tuple(makefile_flags()) == tnm.CXX_FLAGS


def _duplicated(rng, n, f, m, dups):
    """A (n, f) DB whose rows ``dups`` copy earlier rows, and m queries:
    each duplicated row itself, then random rows."""
    db = rng.random((n, f), dtype=np.float32)
    for src, dst in dups:
        db[dst] = db[src]
    queries = np.concatenate([db[[d for _, d in dups]],
                              rng.random((m, f), dtype=np.float32)])
    return db, queries


@pytest.mark.parametrize("n,f,m,seed", [
    (257, 19, 40, 0),      # the matcher tests' shape
    (1000, 68, 33, 1),     # npr's feature width
    (4099, 112, 17, 2),    # super_resolution's, past a power of two
    (64, 3, 200, 3),       # many queries, few lanes: exact ties abound
])
def test_brute_argmin_batch_native_equals_jax_native(natives, n, f, m,
                                                     seed):
    """The port's brute_argmin_batch on its native core against the JAX
    one on the JAX native library: the same indices and the same
    distance bits, and every duplicated row resolves to its lowest
    copy."""
    jlib, tlib = natives
    rng = np.random.default_rng(seed)
    dups = [(5, n - 1), (5, n // 2), (n // 3, n - 2)]
    db, queries = _duplicated(rng, n, f, m, dups)
    ji, jd = jnm.brute_argmin_batch(db, queries)
    ti, td = tnm.brute_argmin_batch(db, queries)
    assert jlib.calls == 1 and tlib.calls == 1
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td.view(np.uint32), jd.view(np.uint32))
    assert list(ti[:len(dups)]) == [5, 5, n // 3]
    # a quantized DB: many rows tie for many queries
    db = np.round(db * 2) / 2
    ji, _ = jnm.brute_argmin_batch(db, queries)
    ti, _ = tnm.brute_argmin_batch(db, queries)
    np.testing.assert_array_equal(ti, ji)
    first = {tuple(r): i for i, r in reversed(list(enumerate(db)))}
    for i in ti:
        assert first[tuple(db[i])] == i


def _synthesis_inputs(kind):
    if kind == "gray":
        return make_pair(24, 24, seed=3), {}
    if kind == "rgb_source":
        a, _, b = make_pair(24, 22, seed=4, channels=3)
        ap = np.clip(a * 0.9 + 0.05, 0, 1).astype(np.float32)
        return (a, ap, b), dict(color_mode="source_rgb",
                                remap_luminance=False)
    # a posterized exemplar: exact duplicate DB rows at every level
    a, ap, b = make_pair(24, 24, seed=5)
    return (np.round(a * 4) / 4, np.round(ap * 4) / 4, b), dict(kappa=0.0)


@pytest.mark.parametrize("kind", ["gray", "rgb_source", "posterized"])
@pytest.mark.parametrize("levels", [1, 2])
def test_no_ann_synthesis_native_equals_jax_native(natives, kind, levels):
    """A whole ``backend="cpu", use_ann=False`` synthesis at 24^2, each
    package on its native library: equal source maps and B' bits."""
    jlib, tlib = natives
    (a, ap, b), kw = _synthesis_inputs(kind)
    jr = jrun(a, ap, b, JParams(backend="cpu", use_ann=False, levels=levels,
                                **kw))
    tr = create_image_analogy(a, ap, b, AnalogyParams(
        backend="cpu", use_ann=False, levels=levels, **kw))
    assert jlib.calls > 0 and tlib.calls == jlib.calls
    np.testing.assert_array_equal(tr.source_map, np.asarray(jr.source_map))
    np.testing.assert_array_equal(tr.bp, np.asarray(jr.bp))
