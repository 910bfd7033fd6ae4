"""The port's tune store and geometry funnel (``image_analogies_tpu_torch/
tune/``), held against today's launch plans and against the JAX package's
``tune/`` where the two share semantics:

- an empty store and no environment give every launch plan the port ran
  before the funnel existed (literal expectations below);
- the environment is read at call time, a bad value warns once; env beats
  store, store exact beats wildcard, store beats the packaged table;
- ``wavefront_max_rows`` clamps to 2^24 and the wavefront scan reads it;
- store files load across the two packages, and a merge by either keeps
  the other's entries;
- every candidate plan of the tuner covers the DB exactly;
- the DB side of shape buckets: the bucketed CPU run against the JAX
  package's bucketed run and against the port's unbucketed one;
- ``ia tune`` and ``ia warmup`` through the CLI.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from image_analogies_tpu.config import AnalogyParams as JParams
from image_analogies_tpu.models.analogy import create_image_analogy as j_create
from image_analogies_tpu.tune import buckets as jbuckets
from image_analogies_tpu.tune import resolve as jtune
from image_analogies_tpu.tune import store as jstore
from image_analogies_tpu.utils.parity import audit_source_map_mismatches
from image_analogies_tpu_torch import AnalogyParams as TParams
from image_analogies_tpu_torch import create_image_analogy as t_create
from image_analogies_tpu_torch import cli as tcli
from image_analogies_tpu_torch.backends import cuda as tcuda
from image_analogies_tpu_torch.ops import _build
from image_analogies_tpu_torch.ops import match
from image_analogies_tpu_torch.tune import autotune, buckets, geometry
from image_analogies_tpu_torch.tune import resolve as tune
from image_analogies_tpu_torch.tune import store as tstore
from image_analogies_tpu_torch.tune import tables, warmup
from tests.conftest import make_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "image_analogies_tpu_torch")
SMS = 132  # an H100 SXM's SMs
H100 = "NVIDIA H100 80GB HBM3"
_ENV = ("IA_CHUNKS_PER_SM", "IA_RING_STAGES", "IA_SCAN_TILE_CAP",
        "IA_WAVEFRONT_ROWS", "IA_BATCH_PAD_WASTE", "IA_SHAPE_BUCKETS",
        "IA_COMPILE_CACHE_DIR", "IA_TILE_ROWS", "IA_PACKED_TILE",
        "IA_PACKED_VMEM")


@pytest.fixture(autouse=True)
def _clean_tune_env(monkeypatch, tmp_path):
    """Every test starts from no environment and an empty store."""
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("IA_TUNE_STORE", str(tmp_path / "no_store.json"))
    monkeypatch.setattr(tune, "_ENV_WARNED", set())
    for st in (tstore, jstore):
        st.invalidate_cache()
    tune.reset_provenance()
    yield
    for st in (tstore, jstore):
        st.invalidate_cache()
    tune.reset_provenance()
    _build.set_build_dir(None)


# today's launch plans at 132 SMs (captured from the plan functions before
# the funnel existed): family -> [args..., plan fields]
TODAYS_PLANS = {
    "argmin": [
        (1, 1000, 68, (1, 128, 1, 8, 1)),
        (1, 1000, 300, (1, 128, 1, 8, 1)),
        (1, 65536, 68, (1, 128, 4, 128, 1)),
        (1, 65536, 300, (1, 128, 4, 128, 1)),
        (1, 1048576, 68, (1, 128, 63, 131, 1)),
        (1, 1048576, 300, (1, 128, 63, 131, 1)),
        (88, 1000, 68, (11, 128, 1, 8, 1)),
        (88, 1000, 300, (11, 128, 1, 8, 1)),
        (88, 65536, 68, (11, 128, 4, 128, 1)),
        (88, 65536, 300, (11, 128, 4, 128, 1)),
        (88, 1048576, 68, (11, 128, 63, 131, 1)),
        (88, 1048576, 300, (11, 128, 63, 131, 1)),
        (352, 1000, 68, (15, 128, 1, 8, 3)),
        (352, 1000, 300, (15, 128, 1, 8, 3)),
        (352, 65536, 68, (15, 128, 12, 43, 3)),
        (352, 65536, 300, (15, 128, 12, 43, 3)),
        (352, 1048576, 68, (15, 128, 187, 44, 3)),
        (352, 1048576, 300, (15, 128, 187, 44, 3)),
        (1024, 1000, 68, (16, 128, 1, 8, 8)),
        (1024, 1000, 300, (16, 128, 1, 8, 8)),
        (1024, 65536, 68, (16, 128, 32, 16, 8)),
        (1024, 65536, 300, (16, 128, 32, 16, 8)),
        (1024, 1048576, 68, (16, 128, 512, 16, 8)),
        (1024, 1048576, 300, (16, 128, 512, 16, 8)),
    ],
    "packed2k": [
        (1, 1000, 112, (3, 1, 8, 1, 16, 1, 181248)),
        (1, 1000, 224, (3, 1, 5, 1, 16, 1, 230400)),
        (1, 1000, 512, (2, 1, 1, 1, 16, 1, 197632)),
        (1, 65536, 112, (3, 1, 8, 8, 128, 1, 181248)),
        (1, 65536, 224, (3, 1, 5, 8, 128, 1, 230400)),
        (1, 65536, 512, (2, 1, 1, 8, 128, 1, 197632)),
        (1, 1048576, 112, (3, 1, 8, 125, 132, 1, 181248)),
        (1, 1048576, 224, (3, 1, 5, 125, 132, 1, 230400)),
        (1, 1048576, 512, (2, 1, 1, 125, 132, 1, 197632)),
        (88, 1000, 112, (3, 88, 8, 1, 16, 1, 181248)),
        (88, 1000, 224, (3, 88, 5, 1, 16, 1, 230400)),
        (88, 1000, 512, (2, 88, 1, 1, 16, 1, 197632)),
        (88, 65536, 112, (3, 88, 8, 8, 128, 1, 181248)),
        (88, 65536, 224, (3, 88, 5, 8, 128, 1, 230400)),
        (88, 65536, 512, (2, 88, 1, 8, 128, 1, 197632)),
        (88, 1048576, 112, (3, 88, 8, 125, 132, 1, 181248)),
        (88, 1048576, 224, (3, 88, 5, 125, 132, 1, 230400)),
        (88, 1048576, 512, (2, 88, 1, 125, 132, 1, 197632)),
        (352, 1000, 112, (3, 176, 8, 1, 16, 2, 181248)),
        (352, 1000, 224, (3, 176, 5, 1, 16, 2, 230400)),
        (352, 1000, 512, (2, 118, 1, 1, 16, 3, 197632)),
        (352, 65536, 112, (3, 176, 8, 16, 64, 2, 181248)),
        (352, 65536, 224, (3, 176, 5, 16, 64, 2, 230400)),
        (352, 65536, 512, (2, 118, 1, 24, 43, 3, 197632)),
        (352, 1048576, 112, (3, 176, 8, 249, 66, 2, 181248)),
        (352, 1048576, 224, (3, 176, 5, 249, 66, 2, 230400)),
        (352, 1048576, 512, (2, 118, 1, 373, 44, 3, 197632)),
        (1024, 1000, 112, (3, 171, 8, 1, 16, 6, 181248)),
        (1024, 1000, 224, (3, 171, 5, 1, 16, 6, 230400)),
        (1024, 1000, 512, (2, 128, 1, 1, 16, 8, 197632)),
        (1024, 65536, 112, (3, 171, 8, 47, 22, 6, 181248)),
        (1024, 65536, 224, (3, 171, 5, 47, 22, 6, 230400)),
        (1024, 65536, 512, (2, 128, 1, 64, 16, 8, 197632)),
        (1024, 1048576, 112, (3, 171, 8, 745, 22, 6, 181248)),
        (1024, 1048576, 224, (3, 171, 5, 745, 22, 6, 230400)),
        (1024, 1048576, 512, (2, 128, 1, 1024, 16, 8, 197632)),
    ],
    "packed2kw": [
        (1, 1000, 608, (2, 1, 3, 1, 32, 1, 224256, 32, 12)),
        (1, 1000, 1040, (2, 1, 2, 1, 32, 1, 226304, 32, 43)),
        (1, 65536, 608, (2, 1, 3, 16, 128, 1, 224256, 32, 12)),
        (1, 65536, 1040, (2, 1, 2, 16, 128, 1, 226304, 32, 43)),
        (1, 1048576, 608, (2, 1, 3, 249, 132, 1, 224256, 32, 12)),
        (1, 1048576, 1040, (2, 1, 2, 249, 132, 1, 226304, 32, 43)),
        (88, 1000, 608, (2, 88, 3, 1, 32, 1, 224256, 32, 12)),
        (88, 1000, 1040, (2, 88, 2, 1, 32, 1, 226304, 32, 43)),
        (88, 65536, 608, (2, 88, 3, 16, 128, 1, 224256, 32, 12)),
        (88, 65536, 1040, (2, 88, 2, 16, 128, 1, 226304, 32, 43)),
        (88, 1048576, 608, (2, 88, 3, 249, 132, 1, 224256, 32, 12)),
        (88, 1048576, 1040, (2, 88, 2, 249, 132, 1, 226304, 32, 43)),
        (352, 1000, 608, (2, 118, 3, 1, 32, 3, 224256, 32, 12)),
        (352, 1000, 1040, (2, 118, 2, 1, 32, 3, 226304, 32, 43)),
        (352, 65536, 608, (2, 118, 3, 47, 44, 3, 224256, 32, 12)),
        (352, 65536, 1040, (2, 118, 2, 47, 44, 3, 226304, 32, 43)),
        (352, 1048576, 608, (2, 118, 3, 745, 44, 3, 224256, 32, 12)),
        (352, 1048576, 1040, (2, 118, 2, 745, 44, 3, 226304, 32, 43)),
        (1024, 1000, 608, (2, 128, 3, 2, 16, 8, 224256, 32, 12)),
        (1024, 1000, 1040, (2, 128, 2, 2, 16, 8, 226304, 32, 43)),
        (1024, 65536, 608, (2, 128, 3, 128, 16, 8, 224256, 32, 12)),
        (1024, 65536, 1040, (2, 128, 2, 128, 16, 8, 226304, 32, 43)),
        (1024, 1048576, 608, (2, 128, 3, 2048, 16, 8, 224256, 32, 12)),
        (1024, 1048576, 1040, (2, 128, 2, 2048, 16, 8, 226304, 32, 43)),
    ],
    "argmin2": [
        (1, 1000, 128, 0, (3, 1, 5, 1, 8, 1, 216576)),
        (1, 1000, 128, 1, (3, 1, 3, 1, 8, 1, 199168)),
        (1, 1000, 512, 0, (1, 1, 2, 1, 16, 1, 198144)),
        (1, 1000, 512, 1, (1, 1, 1, 1, 16, 1, 197888)),
        (1, 65536, 128, 0, (3, 1, 5, 4, 128, 1, 216576)),
        (1, 65536, 128, 1, (3, 1, 3, 4, 128, 1, 199168)),
        (1, 65536, 512, 0, (1, 1, 2, 8, 128, 1, 198144)),
        (1, 65536, 512, 1, (1, 1, 1, 8, 128, 1, 197888)),
        (1, 1048576, 128, 0, (3, 1, 5, 63, 131, 1, 216576)),
        (1, 1048576, 128, 1, (3, 1, 3, 63, 131, 1, 199168)),
        (1, 1048576, 512, 0, (1, 1, 2, 125, 132, 1, 198144)),
        (1, 1048576, 512, 1, (1, 1, 1, 125, 132, 1, 197888)),
        (88, 1000, 128, 0, (3, 88, 5, 1, 8, 1, 216576)),
        (88, 1000, 128, 1, (3, 88, 3, 1, 8, 1, 199168)),
        (88, 1000, 512, 0, (1, 44, 2, 1, 16, 2, 198144)),
        (88, 1000, 512, 1, (1, 44, 1, 1, 16, 2, 197888)),
        (88, 65536, 128, 0, (3, 88, 5, 4, 128, 1, 216576)),
        (88, 65536, 128, 1, (3, 88, 3, 4, 128, 1, 199168)),
        (88, 65536, 512, 0, (1, 44, 2, 16, 64, 2, 198144)),
        (88, 65536, 512, 1, (1, 44, 1, 16, 64, 2, 197888)),
        (88, 1048576, 128, 0, (3, 88, 5, 63, 131, 1, 216576)),
        (88, 1048576, 128, 1, (3, 88, 3, 63, 131, 1, 199168)),
        (88, 1048576, 512, 0, (1, 44, 2, 249, 66, 2, 198144)),
        (88, 1048576, 512, 1, (1, 44, 1, 249, 66, 2, 197888)),
        (352, 1000, 128, 0, (3, 176, 5, 1, 8, 2, 216576)),
        (352, 1000, 128, 1, (3, 176, 3, 1, 8, 2, 199168)),
        (352, 1000, 512, 0, (1, 59, 2, 1, 16, 6, 198144)),
        (352, 1000, 512, 1, (1, 59, 1, 1, 16, 6, 197888)),
        (352, 65536, 128, 0, (3, 176, 5, 8, 64, 2, 216576)),
        (352, 65536, 128, 1, (3, 176, 3, 8, 64, 2, 199168)),
        (352, 65536, 512, 0, (1, 59, 2, 47, 22, 6, 198144)),
        (352, 65536, 512, 1, (1, 59, 1, 47, 22, 6, 197888)),
        (352, 1048576, 128, 0, (3, 176, 5, 125, 66, 2, 216576)),
        (352, 1048576, 128, 1, (3, 176, 3, 125, 66, 2, 199168)),
        (352, 1048576, 512, 0, (1, 59, 2, 745, 22, 6, 198144)),
        (352, 1048576, 512, 1, (1, 59, 1, 745, 22, 6, 197888)),
        (1024, 1000, 128, 0, (3, 171, 5, 1, 8, 6, 216576)),
        (1024, 1000, 128, 1, (3, 171, 3, 1, 8, 6, 199168)),
        (1024, 1000, 512, 0, (1, 64, 2, 2, 8, 16, 198144)),
        (1024, 1000, 512, 1, (1, 64, 1, 2, 8, 16, 197888)),
        (1024, 65536, 128, 0, (3, 171, 5, 24, 22, 6, 216576)),
        (1024, 65536, 128, 1, (3, 171, 3, 24, 22, 6, 199168)),
        (1024, 65536, 512, 0, (1, 64, 2, 128, 8, 16, 198144)),
        (1024, 65536, 512, 1, (1, 64, 1, 128, 8, 16, 197888)),
        (1024, 1048576, 128, 0, (3, 171, 5, 373, 22, 6, 216576)),
        (1024, 1048576, 128, 1, (3, 171, 3, 373, 22, 6, 199168)),
        (1024, 1048576, 512, 0, (1, 64, 2, 2048, 8, 16, 198144)),
        (1024, 1048576, 512, 1, (1, 64, 1, 2048, 8, 16, 197888)),
    ],
    "pertile": [
        (1, 65536, 128, 0, 2048, (3, 1, 5, 4, 128, 1, 216576, 128, 4)),
        (1, 65536, 128, 1, 2048, (3, 1, 3, 4, 128, 1, 199168, 128, 4)),
        (1, 65536, 256, 0, 2048, (3, 1, 2, 4, 128, 1, 231424, 128, 4)),
        (1, 65536, 256, 1, 2048, (1, 1, 2, 4, 128, 1, 198656, 128, 4)),
        (1, 1048576, 128, 0, 4096, (3, 1, 5, 64, 128, 1, 216576, 128, 1)),
        (1, 1048576, 128, 1, 4096, (3, 1, 3, 64, 128, 1, 199168, 128, 1)),
        (1, 1048576, 256, 0, 4096, (3, 1, 2, 64, 128, 1, 231424, 128, 1)),
        (1, 1048576, 256, 1, 4096, (1, 1, 2, 64, 128, 1, 198656, 128, 1)),
        (88, 65536, 128, 0, 2048, (3, 88, 5, 4, 128, 1, 216576, 128, 4)),
        (88, 65536, 128, 1, 2048, (3, 88, 3, 4, 128, 1, 199168, 128, 4)),
        (88, 65536, 256, 0, 2048, (3, 88, 2, 4, 128, 1, 231424, 128, 4)),
        (88, 65536, 256, 1, 2048, (1, 44, 2, 8, 64, 2, 198656, 128, 2)),
        (88, 1048576, 128, 0, 4096, (3, 88, 5, 64, 128, 1, 216576, 128, 1)),
        (88, 1048576, 128, 1, 4096, (3, 88, 3, 64, 128, 1, 199168, 128, 1)),
        (88, 1048576, 256, 0, 4096, (3, 88, 2, 64, 128, 1, 231424, 128, 1)),
        (88, 1048576, 256, 1, 4096, (1, 44, 2, 128, 64, 2, 198656, 128, 1)),
        (352, 65536, 128, 0, 2048, (3, 176, 5, 8, 64, 2, 216576, 128, 2)),
        (352, 65536, 128, 1, 2048, (3, 176, 3, 8, 64, 2, 199168, 128, 2)),
        (352, 65536, 256, 0, 2048, (3, 176, 2, 8, 64, 2, 231424, 128, 2)),
        (352, 65536, 256, 1, 2048, (1, 59, 2, 32, 16, 6, 198656, 128, 1)),
        (352, 1048576, 128, 0, 4096, (3, 176, 5, 128, 64, 2, 216576, 128, 1)),
        (352, 1048576, 128, 1, 4096, (3, 176, 3, 128, 64, 2, 199168, 128, 1)),
        (352, 1048576, 256, 0, 4096, (3, 176, 2, 128, 64, 2, 231424, 128, 1)),
        (352, 1048576, 256, 1, 4096, (1, 59, 2, 384, 22, 6, 198656, 128, 1)),
        (1024, 65536, 128, 0, 2048, (3, 171, 5, 32, 16, 6, 216576, 128, 1)),
        (1024, 65536, 128, 1, 2048, (3, 171, 3, 32, 16, 6, 199168, 128, 1)),
        (1024, 65536, 256, 0, 2048, (3, 171, 2, 32, 16, 6, 231424, 128, 1)),
        (1024, 65536, 256, 1, 2048, (1, 64, 2, 64, 8, 16, 198656, 128, 1)),
        (1024, 1048576, 128, 0, 4096, (3, 171, 5, 384, 22, 6, 216576, 128, 1)),
        (1024, 1048576, 128, 1, 4096, (3, 171, 3, 384, 22, 6, 199168, 128, 1)),
        (1024, 1048576, 256, 0, 4096, (3, 171, 2, 384, 22, 6, 231424, 128, 1)),
        (1024, 1048576, 256, 1, 4096, (1, 64, 2, 1024, 8, 16, 198656, 128, 1)),
    ],
}


# ------------------------------------------------------------- defaults


def _knobs(dtype, fp, n):
    return tune.resolve(strategy="wavefront", dtype=dtype, fp=fp, n_rows=n)


@pytest.mark.parametrize("family", sorted(TODAYS_PLANS))
def test_empty_store_gives_todays_plans(family):
    """With no store and no environment every plan is today's, at 132 SMs;
    the main path's two plans take the resolved knobs (all default)."""
    for case in TODAYS_PLANS[family]:
        *args, want = case
        if family == "argmin":
            m, n, f = args
            cfg = _knobs("f32", 128, n)
            got = match._argmin_plan(m, n, SMS, f, cfg.chunks_per_sm)
        elif family == "packed2k":
            m, n, k = args
            cfg = _knobs("packed2", k, n)
            got = match._packed2k_plan(m, n, SMS, k, cfg.chunks_per_sm,
                                       cfg.ring_stages)
            assert got == match._packed2k_plan(m, n, SMS, k)
        elif family == "packed2kw":
            got = match._packed2kw_plan(*args[:2], SMS, args[2])
        elif family == "argmin2":
            m, n, k, fold = args
            got = match._argmin2_plan(m, n, SMS, k, bool(fold))
        else:
            m, n, k, fold, tile = args
            got = match._pertile_plan(m, n, SMS, k, bool(fold), tile)
        assert tuple(got) == want, (family, args)
    cfg = _knobs("packed2", 256, 1 << 20)
    assert (cfg.chunks_per_sm, cfg.ring_stages, cfg.scan_tile_cap) == (
        geometry.DEFAULT_CHUNKS_PER_SM, geometry.DEFAULT_RING_STAGES,
        geometry.SCAN_TILE_CAP) == (1, 0, 4096)
    assert all(o == "default" for _, o in cfg.origin)


@pytest.mark.parametrize("npad", [256, 1024, 1792, 4096, 65536, 262144,
                                  1048576, 1 << 21])
def test_scan_tile_default_is_todays_and_the_jax_tiling(npad):
    """The scan tile with the default cap: the port's rule before the
    funnel, and the JAX package's tiling at F <= 128."""
    p2 = npad & -npad
    tile = min(4096, p2, npad)
    while npad // tile < 16 and tile >= 256:
        tile //= 2
    assert tcuda.scan_tile_rows(npad) == tune.scan_tile(npad) == tile
    assert tile == jtune.scan_tile(npad, 128)
    assert geometry.scan_tile_rows(npad, 4096) == tile


# ------------------------------------------------------ env, store, tables


@pytest.mark.parametrize("knob,var", sorted(tune._ENV_VARS.items()))
def test_env_read_at_call_time_bad_value_warns_once(knob, var, monkeypatch,
                                                    caplog):
    assert getattr(_knobs("f32", 128, 0), knob) == tune._DEFAULTS[knob]
    monkeypatch.setenv(var, "3")
    cfg = _knobs("f32", 128, 0)
    assert getattr(cfg, knob) == 3 and cfg.origin_of(knob) == "env"
    for bad in ("junk", "0", "-2"):
        monkeypatch.setenv(var, bad)
        with caplog.at_level("WARNING", logger="image_analogies_tpu_torch"):
            assert getattr(_knobs("f32", 128, 0), knob) == \
                tune._DEFAULTS[knob]
    assert len([r for r in caplog.records if var in r.getMessage()]) == 1
    monkeypatch.delenv(var)
    assert getattr(_knobs("f32", 128, 0), knob) == tune._DEFAULTS[knob]


def _store_with(tmp_path, entries, monkeypatch):
    path = str(tmp_path / "store.json")
    tstore.save_entries(entries, path)
    monkeypatch.setenv("IA_TUNE_STORE", path)
    return path


def test_precedence_env_store_exact_wildcard_packaged(tmp_path, monkeypatch):
    """env > store exact > store wildcard > packaged > default, knob by
    knob, keyed by the card's name once CUDA is up."""
    monkeypatch.setattr(tune, "device_kind", lambda: H100)
    monkeypatch.setitem(tables.TABLES, "h100", {
        "*": {"chunks_per_sm": 8, "ring_stages": 6, "scan_tile_cap": 1024}})
    exact = tune.make_key(H100, "wavefront", "packed2", 256, 1 << 20)
    wild = tune.make_key(H100, "wavefront", "packed2", 256, "*")
    _store_with(tmp_path, {exact: {"chunks_per_sm": 2},
                           wild: {"chunks_per_sm": 4, "ring_stages": 3}},
                monkeypatch)
    cfg = _knobs("packed2", 224, 1000000)  # fp 256, bucket 2^20
    assert cfg.key == exact
    assert (cfg.chunks_per_sm, cfg.ring_stages, cfg.scan_tile_cap) == (
        2, 3, 1024)
    assert [cfg.origin_of(k) for k in ("chunks_per_sm", "ring_stages",
                                       "scan_tile_cap", "wavefront_max_rows")
            ] == ["store", "store_wildcard", "packaged", "default"]
    monkeypatch.setenv("IA_CHUNKS_PER_SM", "1")
    assert _knobs("packed2", 224, 1000000).chunks_per_sm == 1
    other = _knobs("packed2", 224, 5000)  # another bucket: the wildcard
    assert (other.chunks_per_sm, other.ring_stages) == (1, 3)
    monkeypatch.delenv("IA_CHUNKS_PER_SM")
    assert _knobs("packed2", 224, 5000).chunks_per_sm == 4


def test_wavefront_max_rows_clamps_and_guards_the_scan(tmp_path,
                                                       monkeypatch):
    assert tune.wavefront_max_rows() == 1 << 24
    monkeypatch.setenv("IA_WAVEFRONT_ROWS", str(1 << 30))
    cfg = _knobs("f32", 128, 0)
    assert cfg.wavefront_max_rows == geometry.WAVEFRONT_MAX_ROWS_CEILING
    assert cfg.origin_of("wavefront_max_rows") == "env"
    monkeypatch.setenv("IA_WAVEFRONT_ROWS", "100")
    a, ap, b = make_pair(12, 12, seed=1)
    with pytest.raises(ValueError, match="caps exemplars at 100 A rows"):
        t_create(a, ap, b, TParams(levels=1), device="cpu")
    monkeypatch.delenv("IA_WAVEFRONT_ROWS")
    key = tune.make_key("any", "wavefront", "f32", 128, "*")
    _store_with(tmp_path, {key: {"wavefront_max_rows": 100}}, monkeypatch)
    with pytest.raises(ValueError, match="caps exemplars at 100 A rows"):
        t_create(a, ap, b, TParams(levels=1), device="cpu")


@pytest.mark.parametrize("entry,ok", [
    ({"chunks_per_sm": 2}, True), ({"ring_stages": 4, "note": "x"}, True),
    ({"tile_rows": 8192}, True),  # the JAX package's knob: passed through
    ({"chunks_per_sm": 0}, False), ({"ring_stages": -1}, False),
    ({"scan_tile_cap": "4096"}, False), ({"wavefront_max_rows": True}, False),
    ({"batch_pad_waste_pct": 2.5}, False), ("not a dict", False)])
def test_store_schema_validation(entry, ok):
    assert tstore.validate_entry(entry) is ok


@pytest.mark.parametrize("content", ["{not json", json.dumps([1, 2]),
                                     json.dumps({"version": 2,
                                                 "entries": {}}),
                                     json.dumps({"version": 1,
                                                 "entries": {"k": {
                                                     "chunks_per_sm": -1}}})])
def test_corrupt_store_warns_once_and_resolves_empty(content, tmp_path,
                                                     monkeypatch, caplog):
    path = tmp_path / "bad.json"
    path.write_text(content)
    monkeypatch.setenv("IA_TUNE_STORE", str(path))
    with caplog.at_level("WARNING", logger="image_analogies_tpu_torch"):
        for _ in range(3):
            cfg = _knobs("f32", 128, 0)
            assert cfg.chunks_per_sm == 1
    assert len([r for r in caplog.records
                if "tune store" in r.getMessage()]) == 1


def test_override_nests_and_restores():
    with tune.override(chunks_per_sm=2):
        assert _knobs("f32", 128, 0).chunks_per_sm == 2
        with tune.override(ring_stages=3):
            cfg = _knobs("f32", 128, 0)
            assert (cfg.chunks_per_sm, cfg.ring_stages) == (2, 3)
            assert cfg.origin_of("ring_stages") == "override"
        assert _knobs("f32", 128, 0).ring_stages == 0
    assert _knobs("f32", 128, 0).chunks_per_sm == 1
    with pytest.raises(ValueError, match="unknown tune knobs"):
        with tune.override(tile_rows=4):
            pass


def test_pin_scope_consults_the_store_once_per_key(monkeypatch):
    calls = []
    real = tstore.load_entries
    monkeypatch.setattr(tstore, "load_entries",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with tune.pin_scope():
        first = _knobs("packed2", 256, 1 << 20)
        for _ in range(5):
            assert _knobs("packed2", 256, 1 << 20) is first
        with tune.pin_scope():  # reentrant: joins the outer cache
            assert _knobs("packed2", 256, 1 << 20) is first
        _knobs("f32", 128, 65536)
    assert len(calls) == 2
    _knobs("packed2", 256, 1 << 20)
    assert len(calls) == 3  # outside the scope: consulted again


@pytest.mark.parametrize("name,cls", [
    ("NVIDIA H100 80GB HBM3", "h100"), ("NVIDIA H100 PCIe", "h100"),
    ("NVIDIA H100 NVL", "h100"), ("nvidia h100 sxm5 80gb", "h100"),
    ("NVIDIA A100-SXM4-80GB", None), ("any", None), ("cpu", None),
    ("TPU v4", None), ("", None)])
def test_device_class_maps_the_h100_names(name, cls):
    assert tables.device_class(name) == cls
    if cls is None:
        assert tables.lookup(name, "wavefront", "packed2") == {}


def test_no_call_site_reads_geometry_constants_past_the_funnel():
    """Grep-lock: SCAN_TILE_CAP and the wavefront row bound are read only
    inside tune/ (the funnel); every other module asks tune.resolve."""
    pat = re.compile(r"\b(SCAN_TILE_CAP|MAX_A_ROWS|WAVEFRONT_MAX_ROWS_CEILING"
                     r"|DEFAULT_WAVEFRONT_MAX_ROWS|DEFAULT_BATCH_PAD_WASTE)\b")
    hits = []
    for d, subdirs, names in os.walk(PKG):
        subdirs[:] = [s for s in subdirs if s not in ("_build", "tune")]
        for n in names:
            if n.endswith(".py"):
                path = os.path.join(d, n)
                with open(path) as f:
                    for i, line in enumerate(f, 1):
                        if pat.search(line):
                            hits.append(f"{path}:{i}")
    assert hits == []


def test_grep_lock_covers_every_tune_and_obs_module():
    """The port's import grep-lock walks tune/ and obs/ too: no module there
    imports jax or the JAX package."""
    from tests.test_torch_ops import _imports

    for sub in ("tune", "obs"):
        names = [n for n in os.listdir(os.path.join(PKG, sub))
                 if n.endswith(".py")]
        assert len(names) >= (8 if sub == "tune" else 6)
        for n in names:
            for mod in _imports(os.path.join(PKG, sub, n)):
                assert mod.split(".")[0] not in ("jax", "jaxlib",
                                                 "image_analogies_tpu"), n


# ------------------------------------------------------------ the plans


@pytest.mark.parametrize("n", [1, 63, 64, 65, 100, 131, 1000, 8447, 65573,
                               1 << 20, (1 << 20) + 37])
@pytest.mark.parametrize("m", [1, 88, 352])
def test_every_candidate_plan_covers_n_exactly(m, n):
    """Every chunks_per_sm and ring_stages the tuner may try gives plans the
    C entries accept: whole tiles, no empty chunk, the ring within the
    default plan's depth and its shared memory."""
    for chunks in (1, 2, 3, 4, 8):
        a = match._argmin_plan(m, n, SMS, 68, chunks)
        tiles = -(-n // a.rows)
        assert a.tiles_per_chunk >= 1
        assert (a.n_chunks - 1) * a.tiles_per_chunk < tiles <= (
            a.n_chunks * a.tiles_per_chunk)
        deepest = match._packed2k_plan(m, n, SMS, 224).stages
        for stages in range(0, deepest + 2):
            p = match._packed2k_plan(m, n, SMS, 224, chunks, stages)
            tiles = -(-n // 64)
            assert p.tiles_per_chunk >= 1 and p.n_chunks <= 65535
            assert (p.n_chunks - 1) * p.tiles_per_chunk < tiles <= (
                p.n_chunks * p.tiles_per_chunk)
            assert p.stages == (min(stages, deepest) if stages else deepest)
            assert p.smem == match._hopper_smem(224, p.stages, p.consumers)
            assert p.smem <= match._P2K_SMEM
    with pytest.raises(ValueError):
        match._argmin_plan(m, n, SMS, 68, 0)
    with pytest.raises(ValueError):
        match._packed2k_plan(m, n, SMS, 224, 1, -1)


def test_plans_are_memoized():
    assert match._packed2k_plan(352, 1 << 20, SMS, 224, 2, 3) is \
        match._packed2k_plan(352, 1 << 20, SMS, 224, 2, 3)
    assert match._argmin_plan(88, 65536, SMS, 68, 2) is \
        match._argmin_plan(88, 65536, SMS, 68, 2)


def test_snap_tile_to_divisor_equals_jax():
    for tile in (1, 7, 256, 1000, 4096, 5000):
        for npad in (1, 256, 1000, 1792, 4096, 65536, 65573):
            assert tune.snap_tile_to_divisor(tile, npad) == \
                jtune.snap_tile_to_divisor(tile, npad)


# -------------------------------------------------------- across packages


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_store_files_load_across_packages_and_merges_keep_both(writer,
                                                               tmp_path):
    path = str(tmp_path / "shared.json")
    port_key = tune.make_key(H100, "wavefront", "packed2", 256, "*")
    jax_key = jtune.make_key("TPU v4", "wavefront", "packed2", 256, "*")
    entries = {port_key: {"chunks_per_sm": 2, "source": "ia tune"},
               jax_key: {"tile_rows": 8192, "packed_tile_cap": 16384}}
    (tstore if writer == "port" else jstore).save_entries(entries, path)
    for st in (tstore, jstore):
        st.invalidate_cache()
        assert st.load_entries(path) == entries
    # a merge by either keeps the other's entry
    tstore.merge_entries({port_key: {"chunks_per_sm": 4}}, path)
    jstore.invalidate_cache()
    assert jstore.load_entries(path)[jax_key] == entries[jax_key]
    jstore.merge_entries({jax_key: {"tile_rows": 4096}}, path)
    tstore.invalidate_cache()
    got = tstore.load_entries(path)
    assert got[port_key] == {"chunks_per_sm": 4}
    assert got[jax_key] == {"tile_rows": 4096}


def test_bucket_functions_equal_jax(monkeypatch):
    for n in list(range(0, 5000, 7)) + [2 ** k + d for k in range(9, 25)
                                        for d in (-1, 0, 1)]:
        assert buckets.bucket_rows(n) == jbuckets.bucket_rows(n)
    for env in ("", "1", "0", "off", "yes"):
        monkeypatch.setenv("IA_SHAPE_BUCKETS", env)
        for flag in (False, True):
            assert buckets.buckets_enabled(TParams(shape_buckets=flag)) == \
                jbuckets.buckets_enabled(JParams(shape_buckets=flag))


# ----------------------------------------------------- DB-side buckets


def _db_rows(monkeypatch):
    """Record the DB rows every anchor kernel sees."""
    seen = []
    for name in ("argmin_l2", "packed_best"):
        real = getattr(tcuda, name)

        def call(*args, _real=real, **kw):
            seen.append(int(args[1].shape[0]))
            return _real(*args, **kw)
        monkeypatch.setattr(tcuda, name, call)
    return seen


@pytest.mark.parametrize("mode", ["auto", "exact_hi2_2p"])
def test_bucketed_run_equals_unbucketed_and_jax_bucketed(mode, monkeypatch):
    """The DB side of shape buckets on the CPU, 40x44 exemplar, 2 levels:
    the scan copies grow to the buckets (2048 and 512 rows), the bits stay
    the unbucketed run's, and the run against the JAX package's bucketed
    run (its exact scan) is tie-explained."""
    a, ap, b = make_pair(40, 44, seed=6)
    base = dict(levels=2, kappa=2.0)
    plain = t_create(a, ap, b, TParams(match_mode=mode, **base),
                     device="cpu", keep_levels=True)
    seen = _db_rows(monkeypatch)
    bucketed = t_create(a, ap, b, TParams(match_mode=mode, shape_buckets=True,
                                          **base),
                        device="cpu", keep_levels=True)
    assert set(seen) == {512, 2048}
    for (bp0, s0), (bp1, s1) in zip(plain.levels, bucketed.levels):
        assert np.array_equal(bp0.view(np.int32), bp1.view(np.int32))
        assert np.array_equal(s0, s1)
    ref = j_create(a, ap, b, JParams(backend="tpu", strategy="wavefront",
                                     shape_buckets=True, **base),
                   keep_levels=True)
    audit = audit_source_map_mismatches(a, ap, b, JParams(**base),
                                        bucketed.levels, ref.levels)
    assert audit["unexplained"] == 0, audit
    assert audit["first_divergence_is_tie"] in (True, None), audit


def test_bucketed_batched_pads_its_bf16_copy(monkeypatch):
    """Batched with the card's bf16 copy (``bf16_approx``): the copy grows
    to the DB bucket and the bits stay the unbucketed run's."""
    a, ap, b = make_pair(40, 44, seed=6)
    params = TParams(levels=2, kappa=2.0, strategy="batched")
    runs = []
    rows = []
    real = tcuda.prepare_level_arrays

    def spy(*args, **kw):
        out = real(*args, **kw)
        rows.append(int(out["db_pad"].shape[0]))
        return out
    monkeypatch.setattr(tcuda, "prepare_level_arrays", spy)
    for flag in (False, True):
        p = params.replace(shape_buckets=flag)
        backend = tcuda.CudaMatcher(p, torch.device("cpu"), bf16_approx=True)
        rows = []
        runs.append((t_create(a, ap, b, p, backend=backend), rows))
    (r0, rows0), (r1, rows1) = runs
    assert rows0 == [512, 1792] and rows1 == [512, 2048]
    assert np.array_equal(r0.bp_y.view(np.int32), r1.bp_y.view(np.int32))
    assert np.array_equal(r0.source_map, r1.source_map)


def test_buckets_off_is_bit_identical_with_the_env(monkeypatch):
    a, ap, b = make_pair(24, 26, seed=2)
    p = TParams(levels=2)
    ref = t_create(a, ap, b, p, device="cpu")
    monkeypatch.setenv("IA_SHAPE_BUCKETS", "0")
    off = t_create(a, ap, b, p.replace(shape_buckets=True), device="cpu")
    assert np.array_equal(ref.bp_y.view(np.int32), off.bp_y.view(np.int32))
    assert np.array_equal(ref.source_map, off.source_map)


# ----------------------------------------------- the library directory


def test_compile_cache_dir_precedence(tmp_path, monkeypatch):
    """IA_COMPILE_CACHE_DIR over params.compile_cache_dir over the default;
    each library's path is in the directory in effect."""
    assert warmup.apply_runtime_config(TParams()) == _build.BUILD_DIR
    assert os.path.dirname(_build.library_path("argmin_l2")) == \
        _build.BUILD_DIR
    mine = str(tmp_path / "mine")
    assert warmup.apply_runtime_config(
        TParams(compile_cache_dir=mine)) == mine
    assert os.path.dirname(_build.library_path("argmin_l2")) == mine
    env = str(tmp_path / "env")
    monkeypatch.setenv("IA_COMPILE_CACHE_DIR", env)
    assert warmup.compile_cache_dir(TParams(compile_cache_dir=mine)) == env
    assert warmup.apply_runtime_config(
        TParams(compile_cache_dir=mine)) == env
    monkeypatch.delenv("IA_COMPILE_CACHE_DIR")
    assert warmup.apply_runtime_config(TParams()) == _build.BUILD_DIR


def test_a_library_of_another_directory_is_not_used(tmp_path, monkeypatch):
    """A library loaded from one directory is loaded again (built there if
    missing) once another directory is in effect."""
    class Lib:
        def __getattr__(self, name):
            return type("F", (), {})()

    loaded = []
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: loaded.append(path) or Lib())
    built = []
    monkeypatch.setattr(_build, "build", lambda names: built.append(
        list(names)) or open(_build.library_path(names[0]), "w").close())
    monkeypatch.setattr(_build, "_LIBS", {})
    for d in ("one", "two", "one"):
        os.makedirs(tmp_path / d, exist_ok=True)
        _build.set_build_dir(str(tmp_path / d))
        _build.load("argmin_l2")
        _build.load("argmin_l2")
    assert [os.path.basename(os.path.dirname(p)) for p in loaded] == [
        "one", "two", "one"]
    assert built == [["argmin_l2"], ["argmin_l2"]]


# ------------------------------------------------------------- the CLI


def _jax_cli(argv, capsys):
    from image_analogies_tpu import cli as jcli

    assert jcli.main(argv) == 0
    return json.loads(capsys.readouterr().out)


def test_cli_tune_dry_run_has_the_jax_plan_keys(capsys):
    assert tcli.main(["tune", "--dry-run"]) == 0
    plan = json.loads(capsys.readouterr().out)
    want = _jax_cli(["tune", "--dry-run", "--rows", "4096"], capsys)
    assert set(want) <= set(plan)
    assert set(want["sweeps"][0]) - {"knob"} <= set(plan["sweeps"][0])
    assert [(sw["kernel"], len(sw["candidates"])) for sw in
            plan["sweeps"]] == [("packed2k_best", 12), ("argmin_l2", 3)]
    packed, argmin = plan["sweeps"]
    assert packed["shape"]["n"] == 1 << 20 and packed["shape"]["m"] == 352
    assert packed["shape"]["width"] == 223
    assert argmin["shape"] == dict(m=88, n=65536, f=68, fp=128)
    assert not torch.cuda.is_initialized()


def test_cli_tune_stages_and_candidates(capsys):
    assert tcli.main(["tune", "--dry-run", "--knob", "stages",
                      "--candidates", "2,3"]) == 0
    plan = json.loads(capsys.readouterr().out)
    assert [sw["kernel"] for sw in plan["sweeps"]] == ["packed2k_best"]
    assert plan["sweeps"][0]["candidates"] == [{"ring_stages": 2},
                                               {"ring_stages": 3}]
    with pytest.raises(ValueError, match="one knob"):
        autotune.build_plan(knob="all", candidates=(1, 2))


def test_cli_warmup_cpu_has_the_jax_keys(capsys):
    assert tcli.main(["warmup", "--device", "cpu", "--size", "24x24",
                      "--levels", "1"]) == 0
    got = json.loads(capsys.readouterr().out)
    want = _jax_cli(["warmup", "--size", "24x24", "--levels", "1"], capsys)
    assert set(got) == set(want)
    assert (got["compile_count"], got["compile_cache_hits"]) == (0, 0)
    assert got["exemplar"] == [24, 24] and got["levels"] == 1


def test_run_plan_on_the_cpu_persists_to_a_tmp_store(tmp_path):
    store = str(tmp_path / "tuned.json")
    plan = autotune.build_plan(device="cpu", rows=4096, reps=1, store=store)
    res = autotune.run_plan(plan)
    assert res["all_verified"] and res["persisted"] == store
    entries = tstore.load_entries(store)
    assert set(entries) == {sw["store_key"] for sw in plan["sweeps"]}
    for sw in res["sweeps"]:
        assert all(r["same_bits"] for r in sw["results"])
        assert entries[sw["store_key"]]["source"] == "ia tune"
        for k, v in sw["winner"].items():
            assert entries[sw["store_key"]][k] == v
    assert "default_ms" in res["sweeps"][0]


def test_cli_tune_on_the_cpu_no_persist(tmp_path, capsys):
    store = tmp_path / "s.json"
    assert tcli.main(["tune", "--device", "cpu", "--rows", "2048", "--reps",
                      "1", "--knob", "chunks", "--store", str(store),
                      "--no-persist"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["persisted"] is None and not store.exists()
    assert [len(sw["results"]) for sw in res["sweeps"]] == [3, 3]


def test_cli_engine_flags_reach_params():
    args = tcli.build_parser().parse_args(
        ["run", "--ap", "x.png", "--out", "y.png", "--metrics",
         "--shape-buckets", "--compile-cache-dir", "libs"])
    p = tcli._params_from_args(args, TParams())
    assert (p.metrics, p.shape_buckets, p.compile_cache_dir) == (
        True, True, "libs")


def test_cli_tune_without_a_card_exits_2():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "-m",
                           "image_analogies_tpu_torch.cli", "tune"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 2 and "CUDA is not available" in proc.stderr


def test_bucketed_scan_rescue_equals_jax_bucketed(monkeypatch):
    """scan_rescue's tile depends on the padded DB rows, so bucketing may
    change its rescue set: its bucketed run is held to the JAX package's
    bucketed run (the TPU's pads and tiles, the bf16 kernel in interpret
    mode), not to the port's unbucketed run."""
    import functools

    from image_analogies_tpu.backends import tpu as jtpu
    from image_analogies_tpu.ops import pallas_match as pm
    from tests.test_torch_anchor_modes import _TpuPlatformJax

    monkeypatch.setenv("IA_EXPERIMENTAL", "1")
    monkeypatch.setattr(jtpu, "jax", _TpuPlatformJax())
    monkeypatch.setattr(jtpu, "pertile_champions_queries", functools.partial(
        pm.pertile_champions_queries, interpret=True))
    seen = _db_rows_of(monkeypatch, "pertile_champions_queries")
    a, ap, b = make_pair(40, 44, seed=6)
    base = dict(levels=2, kappa=0.5, match_mode="scan_rescue",
                shape_buckets=True)
    ref = j_create(a, ap, b, JParams(backend="tpu", strategy="wavefront",
                                     **base), keep_levels=True)
    port = t_create(a, ap, b, TParams(**base), device="cpu",
                    keep_levels=True)
    assert set(seen) == {512, 2048}
    for (bp_t, s_t), (bp_j, s_j) in zip(port.levels, ref.levels):
        np.testing.assert_array_equal(s_t, s_j)
        np.testing.assert_allclose(bp_t, bp_j, rtol=0, atol=1e-6)


def _db_rows_of(monkeypatch, name):
    seen = []
    real = getattr(tcuda, name)

    def call(*args, **kw):
        seen.append(int(args[1].shape[0]))
        return real(*args, **kw)
    monkeypatch.setattr(tcuda, name, call)
    return seen
