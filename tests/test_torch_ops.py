"""The PyTorch port's host and feature layers against the JAX package.

Inputs are made with NumPy from a seed and handed to both packages; every
layer here is elementwise or a copy, so the two must agree BIT for bit.
"""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_analogies_tpu import config as jcfg
from image_analogies_tpu.ops import color as jcolor
from image_analogies_tpu.ops import features as jfeat
from image_analogies_tpu.ops import pyramid as jpyr
from image_analogies_tpu_torch import config as tcfg
from image_analogies_tpu_torch.ops import color as tcolor
from image_analogies_tpu_torch.ops import features as tfeat
from image_analogies_tpu_torch.ops import pyramid as tpyr
from image_analogies_tpu_torch.utils import assets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits_equal(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return (x.shape == y.shape and x.dtype == y.dtype
            and np.array_equal(np.ascontiguousarray(x).view(np.uint8),
                               np.ascontiguousarray(y).view(np.uint8)))


def test_color_ops_bit_equal():
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0, 1, (9, 11, 3)).astype(np.float32)
    assert _bits_equal(tcolor.rgb2yiq(rgb), jcolor.rgb2yiq(rgb))
    yiq = jcolor.rgb2yiq(rgb)
    assert _bits_equal(tcolor.yiq2rgb(yiq), jcolor.yiq2rgb(yiq))
    assert _bits_equal(tcolor.luminance(rgb), jcolor.luminance(rgb))
    u8 = rng.integers(0, 256, (5, 6, 3), dtype=np.uint8)
    assert _bits_equal(tcolor.as_float(u8), jcolor.as_float(u8))
    ya, yap, yb = (rng.uniform(0, 1, (8, 8)).astype(np.float32)
                   for _ in range(3))
    for got, want in zip(tcolor.remap_pair(ya, yap, yb),
                         jcolor.remap_pair(ya, yap, yb)):
        assert _bits_equal(got, want)
    flat = np.full((4, 4), 0.5, np.float32)  # sigma_A ~ 0 branch
    assert _bits_equal(tcolor.remap_pair(flat, None, yb)[0],
                       jcolor.remap_pair(flat, None, yb)[0])


@pytest.mark.parametrize("shape,levels", [((37, 29), 3), ((16, 16, 3), 2)])
def test_pyramid_np_bit_equal(shape, levels):
    img = np.random.default_rng(1).uniform(0, 1, shape).astype(np.float32)
    for got, want in zip(tpyr.build_pyramid_np(img, levels),
                         jpyr.build_pyramid_np(img, levels)):
        assert _bits_equal(got, want)
    for lv, p in ((5, 5), (9, 7), (2, 3)):
        assert (tpyr.num_feasible_levels(shape, lv, p)
                == jpyr.num_feasible_levels(shape, lv, p))


@pytest.mark.parametrize("p,c,coarse,ch,gauss", [
    (5, 3, True, 1, True), (5, 3, False, 1, True), (7, 3, True, 1, True),
    (5, 3, True, 3, False)])
def test_feature_spec_matches(p, c, coarse, ch, gauss):
    kw = dict(fine_size=p, coarse_size=c, has_coarse=coarse, src_channels=ch,
              gaussian=gauss)
    t, j = tfeat.FeatureSpec(**kw), jfeat.FeatureSpec(**kw)
    assert t.total == j.total and t.slices() == j.slices()
    assert t.fine_filt_slice == j.fine_filt_slice
    assert _bits_equal(t.sqrt_weights(), j.sqrt_weights())
    assert _bits_equal(t.weight_vector(), j.weight_vector())
    assert np.array_equal(t.query_live_mask(), j.query_live_mask())
    assert _bits_equal(tfeat.window_offsets(p), jfeat.window_offsets(p))
    assert _bits_equal(tfeat.causal_mask(p), jfeat.causal_mask(p))
    assert _bits_equal(tfeat.gaussian_window(p), jfeat.gaussian_window(p))
    tp = tcfg.AnalogyParams(patch_size=p, coarse_patch_size=c)
    jp = jcfg.AnalogyParams(patch_size=p, coarse_patch_size=c)
    assert (tfeat.spec_for_level(tp, 0, 3, ch).total
            == jfeat.spec_for_level(jp, 0, 3, ch).total)


@pytest.mark.parametrize("coarse,channels", [(True, 1), (False, 1),
                                             (True, 3)])
def test_build_features_torch_bit_equal_to_jax(coarse, channels):
    rng = np.random.default_rng(7)
    h, w = 13, 11
    shp = (h, w, channels) if channels > 1 else (h, w)
    cshp = (7, 6, channels) if channels > 1 else (7, 6)
    src = rng.uniform(-0.5, 1, shp).astype(np.float32)
    filt = rng.uniform(-0.5, 1, (h, w)).astype(np.float32)
    src_c = rng.uniform(0, 1, cshp).astype(np.float32) if coarse else None
    filt_c = rng.uniform(0, 1, (7, 6)).astype(np.float32) if coarse else None
    kw = dict(fine_size=5, coarse_size=3, has_coarse=coarse,
              src_channels=channels)
    jspec, tspec = jfeat.FeatureSpec(**kw), tfeat.FeatureSpec(**kw)
    tt = lambda x: None if x is None else torch.from_numpy(x)
    jj = lambda x: None if x is None else jnp.asarray(x)
    for f_in in (filt, None):  # DB side (A') and query side (B' zero)
        want = np.asarray(jfeat.build_features_jax(
            jspec, jj(src), jj(f_in), jj(src_c), jj(filt_c)))
        got = tfeat.build_features_torch(
            tspec, tt(src), tt(f_in), tt(src_c), tt(filt_c)).numpy()
        assert _bits_equal(got, want)
        assert _bits_equal(
            tfeat.build_features_np(tspec, src, f_in, src_c, filt_c),
            jfeat.build_features_np(jspec, src, f_in, src_c, filt_c))


def test_fine_gather_maps_match():
    for got, want in zip(tfeat.fine_gather_maps(9, 7, 5),
                         jfeat.fine_gather_maps(9, 7, 5)):
        assert _bits_equal(got, want)


def test_make_structured_reproduces_oracle_inputs():
    from examples.make_assets import make_structured as j_make

    for got, want in zip(assets.make_structured(40, 7), j_make(40, 7)):
        assert _bits_equal(got, want)
    import json

    with open(os.path.join(REPO, "bench_cache",
                           "oracle_1024_seed7.json")) as f:
        digest = json.load(f)["input_digest"]
    assert digest == "8512fc90ebcc2781"
    assert assets.input_digest(*assets.make_structured(1024, 7)) == digest


def test_params_presets_and_unported_surface(monkeypatch):
    assert set(tcfg.PRESETS) == set(jcfg.PRESETS)
    for name, tp in tcfg.PRESETS.items():
        jp = jcfg.PRESETS[name]
        for fld in ("levels", "patch_size", "coarse_patch_size", "kappa",
                    "remap_luminance", "src_weight", "color_mode",
                    "temporal_weight", "strategy", "match_mode",
                    "bf16_scoring", "refine_passes"):
            assert getattr(tp, fld) == getattr(jp, fld), (name, fld)
        assert tp.device == "cuda"
        assert tp.kappa_factor(2) == jp.kappa_factor(2)
    # every JAX strategy is ported and validated as in the JAX package
    for strategy in ("auto", "wavefront", "exact", "rowwise", "batched"):
        assert tcfg.AnalogyParams(strategy=strategy).strategy == strategy
        jcfg.AnalogyParams(strategy=strategy)
    assert tcfg.AnalogyParams(refine_passes=0).refine_passes == 0
    for bad in (dict(refine_passes=-1), dict(strategy="batched",
                                             bf16_scoring=True)):
        with pytest.raises(ValueError):
            jcfg.AnalogyParams(**bad)
        with pytest.raises(ValueError):
            tcfg.AnalogyParams(**bad)
    # every JAX match mode is ported; the probe modes stay gated
    monkeypatch.delenv("IA_EXPERIMENTAL", raising=False)
    assert tcfg.AnalogyParams(match_mode="exact_hi2").match_mode == \
        "exact_hi2"
    for bad in (dict(levels=0), dict(patch_size=4), dict(kappa=-1.0),
                dict(color_mode="rgb"), dict(strategy="nope"),
                dict(device="tpu"), dict(match_mode="two_pass"),
                dict(match_mode="nope")):
        with pytest.raises(ValueError):
            tcfg.AnalogyParams(**bad)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax_or_the_jax_package():
    """Grep-lock: the port and chip_smoke.py stand alone."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    root = os.path.join(REPO, "image_analogies_tpu_torch")
    for d, subdirs, names in os.walk(root):
        subdirs[:] = [s for s in subdirs if s != "_build"]  # build outputs
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 12
    for sub in ("parallel", "serve", "soak", "chaos"):
        assert any(os.sep + sub + os.sep in f for f in files), sub
    # the fleet's modules, the subprocess worker's entry included, the
    # chaos plane's, the soak harness's and the run-log readers
    for mod in ("serve/router.py", "serve/transport.py", "serve/fleet.py",
                "serve/control.py", "serve/worker_main.py", "obs/fleet.py",
                "chaos/__init__.py", "chaos/faults.py", "chaos/plan.py",
                "chaos/inject.py", "chaos/drills.py", "chaos/runner.py",
                "soak/__init__.py", "soak/trace.py", "soak/driver.py",
                "soak/invariants.py", "obs/report.py", "obs/export.py",
                "obs/recorder.py", "serve/loadgen.py", "cli.py"):
        assert os.path.join(root, *mod.split("/")) in files, mod
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "image_analogies_tpu",
                               "examples", "ml_dtypes"), (path, mod)
        with open(path) as f:
            text = f.read()
        assert "import jax" not in text and "from jax" not in text, path


def test_entry_point_runs_on_the_card_or_raises():
    from image_analogies_tpu_torch import create_image_analogy

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (12, 12)).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_image_analogy(a, a, a, tcfg.AnalogyParams(levels=1))
