"""The port's host oracle, ``backend="cpu"`` (``backends/cpu.py``,
``backends/native_match.py``), held against the JAX package's CPU backend.

Inputs are seeded with numpy.  Every comparison with the JAX package is
bit for bit (tolerance 0: the two run the same NumPy and cKDTree code on
the same float32 planes); with ``use_ann`` off both sides run the NumPy
brute force (the JAX package's native library is not built in this tree),
and the port's native core is then held against the NumPy form under the
lowest-index rule.  The catalog tests are the synthesis forms of
``tests/test_catalog.py`` on the port's driver.
"""

import os
import shutil

import numpy as np
import pytest

from image_analogies_tpu.config import AnalogyParams as JParams
from image_analogies_tpu.models.analogy import create_image_analogy as jrun
from image_analogies_tpu_torch import create_image_analogy
from image_analogies_tpu_torch.backends import get_backend, native_match
from image_analogies_tpu_torch.backends.cpu import CpuMatcher
from image_analogies_tpu_torch.batch.engine import (
    BatchIncompatible,
    create_image_analogy_batch,
)
from image_analogies_tpu_torch.catalog import build as catalog_build
from image_analogies_tpu_torch.catalog import store as catalog_store
from image_analogies_tpu_torch.catalog import tiers
from image_analogies_tpu_torch.config import AnalogyParams
from image_analogies_tpu_torch.obs import trace as obs_trace
from tests.conftest import make_pair


@pytest.fixture(autouse=True)
def _numpy_brute_force_and_clean_catalog():
    """The JAX side's brute force is its NumPy fallback here; the port's
    is forced to the same form unless a test asks for the native core.
    The catalog's memory tiers are module-global: never leak them."""
    native_match.set_native(False)
    tiers.clear()
    tiers.configure(None)
    yield
    native_match.set_native(True)
    tiers.clear()
    tiers.configure(None)


def _both(a, ap, b, **kw):
    kw.setdefault("levels", 2)
    jr = jrun(a, ap, b, JParams(backend="cpu", **kw))
    tr = create_image_analogy(a, ap, b, AnalogyParams(backend="cpu", **kw))
    return jr, tr


# ------------------------------------------------- against the JAX oracle


@pytest.mark.parametrize("use_ann", [True, False])
@pytest.mark.parametrize("kind", ["gray", "rgb_source"])
def test_cpu_backend_bit_equal_to_the_jax_cpu_backend(use_ann, kind):
    if kind == "gray":
        a, ap, b = make_pair(14, 13, seed=3)
        kw = {}
    else:
        a, ap, b = make_pair(12, 12, seed=4, channels=3)
        ap = np.clip(a * 0.9 + 0.05, 0, 1).astype(np.float32)
        kw = dict(color_mode="source_rgb", remap_luminance=False)
    jr, tr = _both(a, ap, b, use_ann=use_ann, **kw)
    np.testing.assert_array_equal(tr.bp, np.asarray(jr.bp))
    np.testing.assert_array_equal(tr.source_map, np.asarray(jr.source_map))
    assert [s["coherence_ratio"] for s in tr.stats] == \
        [s["coherence_ratio"] for s in jr.stats]
    assert all(s["backend"] == "cpu" for s in tr.stats)


@pytest.mark.parametrize("levels,kappa", [(1, 0.0), (3, 5.0)])
def test_cpu_backend_bit_equal_across_levels_and_kappa(levels, kappa):
    a, ap, b = make_pair(16, 16, seed=11)
    jr, tr = _both(a, ap, b, levels=levels, kappa=kappa)
    np.testing.assert_array_equal(tr.bp_y, np.asarray(jr.bp_y))
    np.testing.assert_array_equal(tr.source_map, np.asarray(jr.source_map))


def test_a_side_memo_gives_the_same_bits_and_builds_once(monkeypatch):
    """One matcher shared by two requests with one exemplar (what a serve
    batch does) builds each level's A-side once and gives each request
    its fresh matcher's bits."""
    from image_analogies_tpu_torch.backends import cpu as cpu_mod

    a, ap, b1 = make_pair(12, 12, seed=5)
    b2 = make_pair(12, 12, seed=6)[2]
    p = AnalogyParams(backend="cpu", levels=2, remap_luminance=False)
    fresh = [create_image_analogy(a, ap, b, p) for b in (b1, b2)]
    builds = []
    real = cpu_mod.build_features_np

    def counting(spec, src, filt, *args, **kw):
        if filt is not None:  # the A-side build (queries pass None)
            builds.append(1)
        return real(spec, src, filt, *args, **kw)

    monkeypatch.setattr(cpu_mod, "build_features_np", counting)
    shared = CpuMatcher(p)
    memo = [create_image_analogy(a, ap, b, p, backend=shared)
            for b in (b1, b2)]
    assert len(builds) == 2  # two levels, once each
    assert len(shared._a_memo) == 2
    for m, f in zip(memo, fresh):
        np.testing.assert_array_equal(m.bp, f.bp)
        np.testing.assert_array_equal(m.source_map, f.source_map)


def test_get_backend_picks_the_matcher():
    assert isinstance(get_backend(AnalogyParams(backend="cpu")), CpuMatcher)
    m = get_backend(AnalogyParams(), device="cpu")
    assert type(m).__name__ == "CudaMatcher" and str(m.device) == "cpu"


# ------------------------------------------------------- brute force


def test_native_core_follows_the_lowest_index_rule():
    """The native core against the NumPy form: exact duplicate rows tie,
    and both return the lowest index; random queries agree."""
    native_match.set_native(True)
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler: the native core cannot build")
    assert native_match.have_native(), "g++ found but the build failed"
    rng = np.random.default_rng(0)
    db = rng.random((257, 19), dtype=np.float32)
    db[200] = db[17]  # a duplicate of an earlier row: 17 must win
    db[230] = db[17]
    queries = np.concatenate([db[[17, 200, 230]],
                              rng.random((40, 19), dtype=np.float32)])
    idx_n, d_n = native_match.brute_argmin_batch(db, queries)
    native_match.set_native(False)
    idx_p, d_p = native_match.brute_argmin_batch(db, queries)
    assert list(idx_n[:3]) == [17, 17, 17] == list(idx_p[:3])
    np.testing.assert_array_equal(idx_n, idx_p)
    # the two sum in different orders: distances agree to fp32 rounding
    np.testing.assert_allclose(d_n, d_p, rtol=1e-5, atol=1e-5)


def test_native_core_builds_outside_the_native_directory(tmp_path,
                                                         monkeypatch):
    """The port builds native/match.cpp into its library directory and
    writes nothing under native/."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native core cannot build")
    from image_analogies_tpu_torch.ops import _build

    native = os.path.join(os.path.dirname(native_match.SOURCE))
    before = sorted(os.listdir(native))
    monkeypatch.setattr(_build, "_DIR", str(tmp_path))
    native_match.set_native(True)
    assert native_match.have_native()
    assert os.path.exists(native_match.library_path())
    assert os.path.dirname(native_match.library_path()) == str(tmp_path)
    assert sorted(os.listdir(native)) == before


def test_no_ann_cpu_run_through_the_native_core_matches_numpy():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native core cannot build")
    a, ap, b = make_pair(12, 12, seed=8)
    p = AnalogyParams(backend="cpu", levels=2, use_ann=False)
    ref = create_image_analogy(a, ap, b, p)
    native_match.set_native(True)
    out = create_image_analogy(a, ap, b, p)
    # the same picks unless a near-tie sums apart: the planes agree
    # wherever the picks do, and the picks agree on all but a handful
    same = out.source_map == ref.source_map
    assert same.mean() >= 0.95
    np.testing.assert_array_equal(out.bp_y[same], ref.bp_y[same])


# --------------------------------------------- the lane engine, the config


def test_lane_engine_refuses_the_cpu_backend():
    a, ap, b = make_pair(10, 10, seed=9)
    p = AnalogyParams(backend="cpu", levels=1, remap_luminance=False)
    with pytest.raises(BatchIncompatible) as ei:
        create_image_analogy_batch(a, ap, [b, b], p)
    assert ei.value.reason == "cpu_backend"
    # a batch of one is the singleton run
    (one,) = create_image_analogy_batch(a, ap, [b], p)
    np.testing.assert_array_equal(one.bp, create_image_analogy(a, ap, b,
                                                               p).bp)


@pytest.mark.parametrize("kw,match", [
    (dict(backend="tpu"), "unknown backend"),
    (dict(backend="cpu", bf16_scoring=True), "bf16_scoring"),
    (dict(backend="cpu", ann_prefilter=True), "ann_prefilter"),
])
def test_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        AnalogyParams(**kw)


def test_config_defaults_and_digest():
    from image_analogies_tpu_torch.utils import checkpoint as ckpt

    p = AnalogyParams()
    assert p.backend == "cuda" and p.use_ann is True
    d = ckpt.run_digest(p, (8, 8), (8, 8))
    assert ckpt.run_digest(p.replace(use_ann=False), (8, 8), (8, 8)) != d
    assert ckpt.run_digest(p.replace(backend="cpu"), (8, 8), (8, 8)) != d


def test_cli_backend_cpu_no_ann_run(tmp_path):
    """``run --backend cpu --no-ann`` needs no card and gives the library
    call's bits."""
    from image_analogies_tpu_torch.cli import main
    from image_analogies_tpu_torch.config import PRESETS
    from image_analogies_tpu_torch.utils.imageio import load_image

    a, ap, b = make_pair(12, 12, seed=10)
    paths = {}
    for name, arr in (("a", a), ("ap", ap), ("b", b)):
        paths[name] = str(tmp_path / f"{name}.npy")
        np.save(paths[name], arr)
    out = str(tmp_path / "out.npy")
    rc = main(["run", "--a", paths["a"], "--ap", paths["ap"], "--b",
               paths["b"], "--out", out, "--levels", "2", "--backend",
               "cpu", "--no-ann"])
    assert rc == 0
    p = PRESETS["oil_filter"].replace(levels=2, backend="cpu", use_ann=False)
    np.testing.assert_array_equal(load_image(out),
                                  create_image_analogy(a, ap, b, p).bp)


# ------------------------------------------------- the catalog's tiers


def _inputs(size=16, seed=7):
    rng = np.random.RandomState(seed)
    return (rng.rand(size, size).astype(np.float32),
            rng.rand(size, size).astype(np.float32),
            rng.rand(size, size).astype(np.float32))


def _cat_params(catalog_dir=None):
    return AnalogyParams(backend="cpu", levels=2, patch_size=3,
                         coarse_patch_size=3, catalog_dir=catalog_dir,
                         metrics=True)


def _run(a, ap, b, p):
    """One synthesis; returns (bp plane, catalog.* counters)."""
    with obs_trace.run_scope(p) as ctx:
        out = create_image_analogy(a, ap, b, p).bp
    counters = ctx.registry.snapshot()["counters"]
    return out, {k: v for k, v in counters.items()
                 if k.startswith("catalog.")}


def test_every_tier_serves_bit_identical(tmp_path):
    a, ap, b = _inputs()
    ref = create_image_analogy(a, ap, b, _cat_params()).bp
    p = _cat_params(str(tmp_path))
    out, c = _run(a, ap, b, p)  # cold: every tier misses, builds, seals
    np.testing.assert_array_equal(out, ref)
    assert c["catalog.builds"] == 2 and c["catalog.disk.misses"] == 2
    out, c = _run(a, ap, b, p)  # the resident tier
    np.testing.assert_array_equal(out, ref)
    assert c == {"catalog.hbm.hits": 2}
    with tiers._LOCK:
        tiers._resident.clear()
    out, c = _run(a, ap, b, p)  # the host tier
    np.testing.assert_array_equal(out, ref)
    assert c["catalog.host.hits"] == 2 and "catalog.builds" not in c
    tiers.clear()
    out, c = _run(a, ap, b, p)  # the disk tier (a fresh process)
    np.testing.assert_array_equal(out, ref)
    assert c["catalog.disk.hits"] == 2 and "catalog.builds" not in c


def test_second_request_skips_feature_build_and_equals_jax(tmp_path):
    a, ap, b = _inputs()
    p = _cat_params(str(tmp_path))
    out1, c1 = _run(a, ap, b, p)
    out2, c2 = _run(a, ap, b, p)
    assert c1["catalog.builds"] == 2
    assert "catalog.builds" not in c2 and c2["catalog.hbm.hits"] == 2
    ref = jrun(a, ap, b, JParams(backend="cpu", levels=2, patch_size=3,
                                 coarse_patch_size=3)).bp
    np.testing.assert_array_equal(out2, np.asarray(ref))


def test_prebuilt_style_serves_without_any_build(tmp_path):
    a, ap, b = _inputs()
    p = _cat_params(str(tmp_path))
    ref = create_image_analogy(a, ap, b, _cat_params()).bp
    rep = catalog_build.build_style(a, ap, p, root_dir=str(tmp_path),
                                    target=b)
    assert rep["levels"] == 2 and len(rep["entries"]) == 2
    tiers.clear()
    out, c = _run(a, ap, b, p)
    np.testing.assert_array_equal(out, ref)
    assert "catalog.builds" not in c and c["catalog.disk.hits"] == 2


@pytest.mark.parametrize("damage", ["flipped_byte", "torn_tail"])
def test_damaged_entry_quarantines_and_rebuilds_bit_identical(tmp_path,
                                                              damage):
    a, ap, b = _inputs()
    p = _cat_params(str(tmp_path))
    ref = create_image_analogy(a, ap, b, _cat_params()).bp
    _run(a, ap, b, p)
    style = tiers.style_key(a, ap)
    entries = catalog_store.list_entries(str(tmp_path), style)
    assert len(entries) == 2
    victim = catalog_store.entry_path(str(tmp_path), style, entries[0][0])
    blob = bytearray(open(victim, "rb").read())
    if damage == "flipped_byte":
        blob[len(blob) // 2] ^= 0xFF
    else:
        blob = blob[: len(blob) // 2]
    with open(victim, "wb") as f:
        f.write(blob)
    tiers.clear()
    out, c = _run(a, ap, b, p)
    np.testing.assert_array_equal(out, ref)
    assert c["catalog.quarantined"] == 1
    assert os.path.exists(victim + ".corrupt") and os.path.exists(victim)
    assert c["catalog.builds"] == 1 and c["catalog.disk.hits"] == 1


def test_device_backend_ignores_the_feature_tiers(tmp_path):
    """As in the JAX driver: only the host oracle consults the tiers."""
    a, ap, b = _inputs()
    p = _cat_params(str(tmp_path)).replace(backend="cuda", device="cpu")
    _, c = _run(a, ap, b, p)
    assert not any(k.startswith(("catalog.builds", "catalog.hbm",
                                 "catalog.disk")) for k in c)


def test_native_source_is_the_repo_one():
    """The port compiles the repo's native/match.cpp, with the Makefile's
    flags."""
    assert os.path.exists(native_match.SOURCE)
    with open(os.path.join(os.path.dirname(native_match.SOURCE),
                           "Makefile")) as f:
        flags = [ln for ln in f if ln.startswith("CXXFLAGS")][0]
    assert flags.split("?=")[1].split() == list(native_match.CXX_FLAGS)


@pytest.mark.parametrize("scheme", ["sequential", "two_phase"])
def test_video_on_the_cpu_backend_equals_the_jax_one(scheme):
    """A two-frame clip with the temporal term through the host oracle
    gives the JAX CPU backend's frames (tolerance 0)."""
    from image_analogies_tpu.models.video import video_analogy as jvideo
    from image_analogies_tpu_torch.models.video import video_analogy

    a, ap, b = make_pair(10, 10, seed=1)
    frames = [b, np.clip(b + 0.05, 0, 1).astype(np.float32)]
    kw = dict(levels=2, temporal_weight=1.0)
    jr = jvideo(a, ap, frames, JParams(backend="cpu", **kw), scheme=scheme)
    tr = video_analogy(a, ap, frames, AnalogyParams(backend="cpu", **kw),
                       scheme=scheme)
    assert len(tr.frames) == 2
    for t, j in zip(tr.frames, jr.frames):
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
