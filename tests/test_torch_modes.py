"""The port's application modes (``models/modes.py``), its golden gallery
and its asset generators against the JAX package, on the CPU.

Inputs are NumPy arrays made from a seed (or the committed golden inputs,
rebuilt by the port's ``utils/assets.py``) and handed to both packages.
The JAX side runs ``backend="tpu"`` on the JAX CPU platform (its exact
fp32 wavefront scan); the port runs ``device="cpu"`` (every kernel's plain
version).  Source maps are held by the JAX package's tie-audit: 0
unexplained mismatches, the first divergence a tie.
"""

import functools
import os

import numpy as np
import pytest

from examples.make_golden import golden_configs
from image_analogies_tpu.config import PRESETS as JPRESETS
from image_analogies_tpu.models import modes as jmodes
from image_analogies_tpu.models.analogy import (
    create_image_analogy as j_create,
)
from image_analogies_tpu.utils.imageio import load_image as j_load_image
from image_analogies_tpu.utils.parity import audit_source_map_mismatches
from image_analogies_tpu.utils.ssim import ssim
from image_analogies_tpu_torch import PRESETS, modes, video_analogy
from image_analogies_tpu_torch.models import analogy as tanalogy
from image_analogies_tpu_torch.utils import assets as tassets
from image_analogies_tpu_torch.utils.imageio import load_image, save_image
from tests.conftest import make_pair
from tests.test_torch_wavefront import one_torch_thread  # noqa: F401

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "golden")
GOLDEN_INPUTS = ("filter_a", "filter_ap", "filter_b", "tbn_labels_a",
                 "tbn_texture", "tbn_labels_b", "sr_sharp", "sr_low",
                 "texture", "video_f0", "video_f1", "video_f2", "video_f3",
                 "video_filter_a", "video_filter_ap")
# (config, output keys): tests/test_golden.py's CONFIGS, with its floors
# (0.98 vs the committed golden PNG, 0.99 vs the JAX run)
GOLDEN = [("tbn", ["out"]), ("oil", ["out"]), ("superres", ["out"]),
          ("npr", ["out"]), ("video", ["f0", "f1", "f2"])]
GOLDEN_FLOOR, JAX_FLOOR = 0.98, 0.99


def port_golden_configs(assets):
    """The port's run of each of ``examples/make_golden.py``'s five configs
    on the CPU, through the entry points a user calls."""
    cpu = lambda name, **kw: PRESETS[name].replace(device="cpu", **kw)

    def tbn():
        return {"out": modes.texture_by_numbers(
            assets["tbn_labels_a"], assets["tbn_texture"],
            assets["tbn_labels_b"], cpu("texture_by_numbers")).bp}

    def oil():
        return {"out": modes.artistic_filter(
            assets["filter_a"], assets["filter_ap"], assets["filter_b"],
            cpu("oil_filter")).bp}

    def superres():
        return {"out": modes.super_resolution(
            assets["sr_sharp"], assets["sr_low"],
            cpu("super_resolution")).bp}

    def npr():
        return {"out": modes.artistic_filter(
            assets["filter_a"], assets["filter_ap"], assets["filter_b"],
            cpu("npr_1024")).bp}

    def video():
        res = video_analogy(
            assets["video_filter_a"], assets["video_filter_ap"],
            [assets[f"video_f{t}"] for t in range(3)],
            cpu("video", levels=2), scheme="two_phase")
        return {f"f{t}": res.frames[t] for t in range(3)}

    return dict(tbn=tbn, oil=oil, superres=superres, npr=npr, video=video)


@pytest.fixture(scope="module")
def golden_assets():
    return tassets.make_golden_assets()


@pytest.fixture(scope="module")
def golden_runs(golden_assets):
    """Both packages' outputs of each golden config, computed once."""
    jax_cfgs = dict(golden_configs(golden_assets))
    port_cfgs = port_golden_configs(golden_assets)
    return {name: (functools.lru_cache(None)(jax_cfgs[name]),
                   functools.lru_cache(None)(port_cfgs[name]))
            for name, _ in GOLDEN}


@pytest.mark.parametrize("name", GOLDEN_INPUTS)
def test_port_assets_are_the_committed_golden_inputs(name, golden_assets):
    """The port's generators, after the 8-bit PNG round trip, rebuild each
    committed golden input bit for bit (no PIL needed on the card)."""
    committed = j_load_image(os.path.join(GOLDEN_DIR, f"in_{name}.png"))
    assert np.array_equal(golden_assets[name], committed), name


def test_make_all_is_the_example_generator(tmp_path):
    """``utils/assets.make_all`` draws what ``examples/make_assets.py
    make_all`` writes, before quantization: its PNGs equal the port's
    arrays after ``png_round_trip``."""
    from examples.make_assets import make_all

    make_all(str(tmp_path), size=24, seed=3)
    port = tassets.make_all(24, 3)
    assert len(port) == 13
    for name, arr in port.items():
        png = j_load_image(str(tmp_path / f"{name}.png"))
        assert np.array_equal(tassets.png_round_trip(arr), png), name


@pytest.mark.golden
@pytest.mark.parametrize("name,keys", GOLDEN)
def test_port_golden_config(name, keys, golden_runs):
    """Each golden config through the port's entry points: SSIM >= 0.98
    against the committed golden PNG and >= 0.99 against the JAX run."""
    jax_fn, port_fn = golden_runs[name]
    jx, pt = jax_fn("tpu"), port_fn()
    for key in keys:
        golden = j_load_image(os.path.join(GOLDEN_DIR,
                                           f"golden_{name}_{key}.png"))
        got = np.clip(np.asarray(pt[key], np.float32), 0, 1)
        assert got.shape == golden.shape
        assert ssim(got, golden) >= GOLDEN_FLOOR, (name, key)
        assert ssim(np.asarray(pt[key], np.float32),
                    np.asarray(jx[key], np.float32)) >= JAX_FLOOR, (name, key)


@pytest.mark.golden
def test_port_video_golden_frames_one_and_two_are_bit_equal(golden_runs):
    """The golden video's attractor on the port: frames 1 and 2 come out
    bit-equal, as on the JAX package's oracle
    (``test_video_golden_tracks_oracle_exactly``), and each frame equals
    its committed golden within the PNG's quantization."""
    out = golden_runs["video"][1]()
    np.testing.assert_array_equal(out["f1"], out["f2"])
    for key in ("f0", "f1", "f2"):
        golden = j_load_image(os.path.join(GOLDEN_DIR,
                                           f"golden_video_{key}.png"))
        np.testing.assert_allclose(golden, np.clip(out[key], 0, 1),
                                   atol=1.5 / 255)


# ------------------------------------------------- each mode vs the JAX run


def _recording(create, calls):
    """``create`` (one package's create_image_analogy) with keep_levels,
    recording the (a, ap, b, params, result) of each call."""
    def call(a, ap, b, params, *args, **kwargs):
        res = create(a, ap, b, params, *args, keep_levels=True, **kwargs)
        calls.append((a, ap, b, params, res))
        return res
    return call


def _mode_inputs(mode):
    """Seeded inputs of each mode: (a call of the mode given a package's
    ``modes`` module and params, the preset, preset overrides)."""
    a, ap, b = make_pair(26, 24, seed=7)
    if mode == "artistic_filter":
        return lambda m, p: m.artistic_filter(a, ap, b, p), "oil_filter", {}
    if mode == "texture_by_numbers":
        rng = np.random.default_rng(5)
        lab_a = np.zeros((24, 22, 3), np.float32)
        lab_a[..., 0] = rng.uniform(0, 1, (24, 22)) > 0.5
        lab_a[..., 1] = 1 - lab_a[..., 0]
        tex = rng.uniform(0, 1, (24, 22)).astype(np.float32)
        lab_b = np.ascontiguousarray(lab_a[::-1])
        return (lambda m, p: m.texture_by_numbers(lab_a, tex, lab_b, p),
                "texture_by_numbers", {})
    if mode == "super_resolution":
        return (lambda m, p: m.super_resolution(ap, b, p, blur_passes=2),
                "super_resolution", {})
    tex = np.random.default_rng(9).uniform(0, 1, (20, 22)).astype(np.float32)
    seed = None if mode == "texture_synthesis" else 3
    return (lambda m, p: m.texture_synthesis(tex, (18, 20), p, seed=seed),
            "texture_synthesis", {"levels": 2})


@pytest.mark.parametrize("mode", ["artistic_filter", "texture_by_numbers",
                                  "super_resolution", "texture_synthesis",
                                  "texture_synthesis_seeded"])
def test_mode_matches_jax(mode, monkeypatch):
    """Each ``modes.*`` function on the port's CPU run against the JAX
    package's CPU run of the same function, on the same seeded inputs:
    the same analogy inputs and params reach the engine, and the JAX
    tie-audit leaves no mismatch unexplained."""
    run, preset, kw = _mode_inputs(mode)
    j_calls, t_calls = [], []
    monkeypatch.setattr(jmodes, "create_image_analogy",
                        _recording(j_create, j_calls))
    monkeypatch.setattr(modes, "create_image_analogy",
                        _recording(tanalogy.create_image_analogy, t_calls))
    jres = run(jmodes, JPRESETS[preset].replace(backend="tpu", **kw))
    tres = run(modes, PRESETS[preset].replace(device="cpu", **kw))
    (ja, jap, jb, jp, _), = j_calls
    (ta, tap, tb, tp, tlev), = t_calls
    for x, y in ((ja, ta), (jap, tap), (jb, tb)):
        assert np.array_equal(x, y)
    for field in ("levels", "patch_size", "kappa", "src_weight",
                  "remap_luminance", "color_mode"):
        assert getattr(jp, field) == getattr(tp, field), field
    assert tres.bp.shape == jres.bp.shape
    audit = audit_source_map_mismatches(ja, jap, jb, jp, tlev.levels,
                                        j_calls[0][4].levels)
    assert audit["unexplained"] == 0, audit
    assert audit["first_divergence_is_tie"] in (True, None), audit
    assert ssim(tres.bp_y, jres.bp_y) >= 0.99


def test_texture_synthesis_forms():
    """``seed=None``: src_weight 0 whatever the params say, an all-zero A
    (every DB row tied on its source lanes, the lowest index decides),
    deterministic, every pixel copied from the exemplar.  Seeded: the same
    seed reproduces, another differs, ``src_weight`` is ``seed_weight``
    unless overridden."""
    tex = np.random.default_rng(2).uniform(0, 1, (16, 18)).astype(np.float32)
    p = PRESETS["texture_synthesis"].replace(levels=1, device="cpu",
                                             src_weight=0.7)
    calls = []
    orig = modes.create_image_analogy
    try:
        modes.create_image_analogy = _recording(orig, calls)
        r0 = modes.texture_synthesis(tex, (12, 14), p)
        r0b = modes.texture_synthesis(tex, (12, 14), p)
        r1 = modes.texture_synthesis(tex, (12, 14), p, seed=1)
        r1b = modes.texture_synthesis(tex, (12, 14), p, seed=1)
        r2 = modes.texture_synthesis(tex, (12, 14), p, seed=2)
        modes.texture_synthesis(tex, (12, 14), p, seed=1, src_weight=0.3)
    finally:
        modes.create_image_analogy = orig
    a0, _, b0, p0, _ = calls[0]
    assert p0.src_weight == 0.0 and not a0.any() and not b0.any()
    assert r0.bp.shape == (12, 14)
    np.testing.assert_array_equal(r0.source_map, r0b.source_map)
    assert np.isin(r0.bp.ravel(), tex.ravel()).all()
    assert calls[2][3].src_weight == 0.1 and calls[5][3].src_weight == 0.3
    np.testing.assert_array_equal(r1.bp, r1b.bp)
    assert (r1.bp != r2.bp).any()
    assert np.isin(r1.bp.ravel(), tex.ravel()).all()
    # the seeded noise planes are the JAX package's draws
    rng = np.random.default_rng(1)
    vals = tex.reshape(-1)
    np.testing.assert_array_equal(calls[2][0], rng.choice(vals, size=(16, 18))
                                  .astype(np.float32))
    np.testing.assert_array_equal(calls[2][2], rng.choice(vals, size=(12, 14))
                                  .astype(np.float32))


@pytest.mark.parametrize("passes", [0, 1, 2, 3])
def test_blur_for_superres_is_the_jax_degradation(passes):
    img = np.random.default_rng(passes).uniform(0, 1, (13, 17, 3))
    np.testing.assert_array_equal(modes.blur_for_superres(img, passes),
                                  jmodes.blur_for_superres(img, passes))


def test_params_replace_and_overrides():
    """``AnalogyParams.replace`` (the JAX package's) validates again, and a
    mode's overrides reach its params, the device among them."""
    p = PRESETS["oil_filter"].replace(levels=2, device="cpu")
    assert (p.levels, p.device, p.kappa) == (2, "cpu", 5.0)
    assert PRESETS["oil_filter"].levels == 3
    with pytest.raises(ValueError):
        p.replace(patch_size=4)
    a, ap, b = make_pair(14, 12, seed=1)
    res = modes.artistic_filter(a, ap, b, levels=1, device="cpu")
    assert [st["level"] for st in res.stats] == [0]
    assert res.stats[0]["backend"] == "cpu"


def test_modes_run_on_the_card_by_default(monkeypatch):
    """A mode with no device override runs on the card, and without one it
    raises rather than run on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, ap, b = make_pair(14, 12, seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        modes.artistic_filter(a, ap, b, levels=1)


@pytest.mark.parametrize("color_mode", ["yiq_transfer", "source_rgb"])
def test_remap_anchor_matches_jax(color_mode):
    """``remap_anchor`` pins the luminance remap to another image's stats,
    as in the JAX package: the planes equal the JAX ``_prep_planes``'s,
    they differ from the unanchored remap, and anchoring on B itself
    changes nothing."""
    from image_analogies_tpu.config import AnalogyParams as JParams
    from image_analogies_tpu.models.analogy import _prep_planes as j_prep

    from image_analogies_tpu_torch import AnalogyParams as TParams

    a, ap, b = make_pair(18, 16, seed=4)
    anchor = np.clip(b * 0.5 + 0.3, 0, 1).astype(np.float32)
    jp, tp = JParams(color_mode=color_mode), TParams(color_mode=color_mode)
    for anc in (None, anchor, b):
        got = tanalogy._prep_planes(a, ap, b, tp, remap_anchor=anc)
        want = j_prep(a, ap, b, jp, remap_anchor=anc)
        for x, y in zip(got, want):
            if x is None:
                assert y is None
            else:
                assert np.array_equal(x, y)
    plain = tanalogy._prep_planes(a, ap, b, tp)
    anchored = tanalogy._prep_planes(a, ap, b, tp, remap_anchor=anchor)
    on_b = tanalogy._prep_planes(a, ap, b, tp, remap_anchor=b)
    assert not np.array_equal(plain[0], anchored[0])
    assert np.array_equal(plain[0], on_b[0])
    # end to end the anchored remap changes the synthesis
    kw = dict(levels=1, device="cpu", color_mode=color_mode)
    r_plain = tanalogy.create_image_analogy(a, ap, b, TParams(**kw))
    r_anch = tanalogy.create_image_analogy(a, ap, b, TParams(**kw),
                                           remap_anchor=anchor)
    j_anch = j_create(a, ap, b, JParams(backend="tpu", levels=1,
                                        color_mode=color_mode),
                      remap_anchor=anchor)
    assert not np.array_equal(r_plain.bp_y, r_anch.bp_y)
    np.testing.assert_array_equal(r_anch.source_map, j_anch.source_map)


@pytest.mark.parametrize("suffix", [".npy", ".png"])
def test_imageio_round_trip(tmp_path, suffix):
    """``save_image`` / ``load_image`` as the JAX package's: ``.npy`` keeps
    the float planes, PNG their 8-bit quantization; RGBA loads as RGB."""
    img = np.random.default_rng(0).uniform(-0.1, 1.1, (9, 7, 3)).astype(
        np.float32)
    path = str(tmp_path / "sub" / f"img{suffix}")
    save_image(path, img)
    got = load_image(path)
    assert np.array_equal(got, j_load_image(path))
    want = np.clip(img, 0, 1)
    if suffix == ".png":
        want = tassets.png_round_trip(img)
    assert np.array_equal(got, want)
    if suffix == ".png":
        from PIL import Image

        rgba = (np.random.default_rng(1).uniform(0, 1, (5, 4, 4)) * 255
                ).astype(np.uint8)
        Image.fromarray(rgba, "RGBA").save(str(tmp_path / "a.png"))
        got = load_image(str(tmp_path / "a.png"))
        assert got.shape == (5, 4, 3)
        assert np.array_equal(got, rgba[..., :3].astype(np.float32) / 255)
