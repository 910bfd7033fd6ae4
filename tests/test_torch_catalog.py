"""The port's exemplar catalog (``image_analogies_tpu_torch/catalog/``) on
the CPU, held against the JAX package's on seeded NumPy inputs.

- cross-package: the port's ``build_style`` and the JAX package's give the
  same style key, entry keys, stored arrays, seals and ANN bases (bit for
  bit) on the same inputs, and each package's loaders read the other's
  store;
- every tier (resident, host, disk) serves the bytes of the cold build;
- damage never serves: a flipped byte, a torn tail and a key mismatch each
  quarantine (``.corrupt``, ``catalog.quarantined`` / ``ann.quarantined``);
- ``gc`` clears litter and enforces its budget; the host tier's LRU budget
  holds; the configuration's precedence (env > params > default);
- ``warm`` and ``warm_for_fleet`` with a stub router;
- the catalog knobs do not split the checkpoint run digest;
- the ``catalog`` CLI round trip;
- ``catalog/`` imports neither torch nor jax at module scope.
"""

import json
import os
import re

import numpy as np
import pytest

from image_analogies_tpu.catalog import ann as j_ann
from image_analogies_tpu.catalog import build as j_build
from image_analogies_tpu.catalog import store as j_store
from image_analogies_tpu.catalog import tiers as j_tiers
from image_analogies_tpu.config import AnalogyParams as JParams
from image_analogies_tpu.ops.features import spec_for_level as j_spec
from image_analogies_tpu.serve.batcher import exemplar_digest as j_digest
from image_analogies_tpu_torch import AnalogyParams as TParams
from image_analogies_tpu_torch import cli as tcli
from image_analogies_tpu_torch.catalog import ann as catalog_ann
from image_analogies_tpu_torch.catalog import build as catalog_build
from image_analogies_tpu_torch.catalog import store as catalog_store
from image_analogies_tpu_torch.catalog import tiers
from image_analogies_tpu_torch.obs import trace as obs_trace
from image_analogies_tpu_torch.ops.features import spec_for_level
from image_analogies_tpu_torch.utils import checkpoint as ckpt
from image_analogies_tpu_torch.utils.imageio import save_image


@pytest.fixture(autouse=True)
def _clean_catalog_state(monkeypatch):
    """The memory tiers and the configured root are module-global by
    design (warmth across requests): no test leaks them."""
    for var in ("IA_CATALOG_DIR", "IA_CATALOG_HOST_BYTES", "IA_ANN_PROJ_DIMS"):
        monkeypatch.delenv(var, raising=False)
    for mod in (tiers, j_tiers):
        mod.clear()
        mod.configure(None)
    yield
    for mod in (tiers, j_tiers):
        mod.clear()
        mod.configure(None)


def _inputs(size=20, seed=7):
    rng = np.random.RandomState(seed)
    return (rng.rand(size, size).astype(np.float32),
            rng.rand(size, size).astype(np.float32),
            rng.rand(size, size).astype(np.float32))


_KW = dict(levels=2, patch_size=3, coarse_patch_size=3)


def _scope(**kw):
    """A metrics run to read the counters of."""
    return obs_trace.run_scope(TParams(metrics=True, **kw))


# ------------------------------------------------------- cross-package


@pytest.mark.parametrize("remap,target", [(True, True), (True, False),
                                          (False, True)])
def test_build_style_equals_jax_bit_for_bit(tmp_path, remap, target):
    a, ap, b = _inputs()
    troot, jroot = str(tmp_path / "t"), str(tmp_path / "j")
    t = catalog_build.build_style(
        a, ap, TParams(remap_luminance=remap, **_KW), root_dir=troot,
        target=b if target else None)
    j = j_build.build_style(
        a, ap, JParams(remap_luminance=remap, **_KW), root_dir=jroot,
        target=b if target else None)
    assert t["style"] == j["style"] == j_digest(a, ap)
    assert [(e["level"], e["key"], e["rows"], e["ann_dims"])
            for e in t["entries"]] == [
        (e["level"], e["key"], e["rows"], e["ann_dims"])
        for e in j["entries"]]
    for e in t["entries"]:
        with np.load(catalog_store.entry_path(troot, t["style"],
                                              e["key"])) as zt, \
                np.load(j_store.entry_path(jroot, j["style"],
                                           e["key"])) as zj:
            for name in ("db", "a_filt_flat", "key", "checksum"):
                assert zt[name].tobytes() == zj[name].tobytes(), name
        with np.load(catalog_ann.artifact_path(troot, e["key"])) as zt, \
                np.load(j_ann.artifact_path(jroot, e["key"])) as zj:
            for name in ("mean", "proj", "key", "checksum"):
                assert zt[name].tobytes() == zj[name].tobytes(), name


def test_each_package_reads_the_others_store(tmp_path):
    a, ap, b = _inputs(seed=3)
    troot, jroot = str(tmp_path / "t"), str(tmp_path / "j")
    t = catalog_build.build_style(a, ap, TParams(**_KW), root_dir=troot,
                                  target=b)
    j_build.build_style(a, ap, JParams(**_KW), root_dir=jroot, target=b)
    style = t["style"]
    for e in t["entries"]:
        key = e["key"]
        mine = catalog_store.load_entry(jroot, style, key)
        theirs = j_store.load_entry(troot, style, key)
        assert mine is not None and theirs is not None
        for x, y in zip(mine, theirs):
            assert x.tobytes() == y.tobytes()
        mine = catalog_ann.load_artifact(jroot, key)
        theirs = j_ann.load_artifact(troot, key)
        for x, y in zip(mine, theirs):
            assert x.tobytes() == y.tobytes()
    assert catalog_store.stats(jroot)["entries"] == \
        j_store.stats(troot)["entries"] == 2


def test_keys_equal_jax_for_every_spec():
    """``feature_key`` hashes ``repr(spec)``: both packages' FeatureSpecs
    have the same fields in the same order."""
    rng = np.random.RandomState(1)
    planes = [rng.rand(8, 8).astype(np.float32) for _ in range(2)] + [
        rng.rand(4, 4).astype(np.float32) for _ in range(2)]
    for kw in (dict(), dict(patch_size=7, src_weight=0.5),
               dict(gaussian_weights=False, temporal_weight=1.0)):
        for level, temporal in ((0, False), (0, True), (1, False)):
            ts = spec_for_level(TParams(**kw), level, 2, 1, temporal)
            js = j_spec(JParams(**kw), level, 2, 1, temporal)
            assert repr(ts) == repr(js)
            assert tiers.feature_key(ts, *planes) == \
                j_tiers.feature_key(js, *planes)
    assert tiers.style_key(planes[0], planes[1]) == \
        j_tiers.style_key(planes[0], planes[1])


def test_build_projection_equals_jax_and_is_deterministic(tmp_path):
    rng = np.random.RandomState(0)
    db = rng.rand(200, 37).astype(np.float32)
    m1, p1 = catalog_ann.build_projection(db, 8)
    m2, p2 = catalog_ann.build_projection(db, 8)
    jm, jp = j_ann.build_projection(db, 8)
    assert m1.tobytes() == m2.tobytes() == jm.tobytes()
    assert p1.tobytes() == p2.tobytes() == jp.tobytes()
    assert m1.shape == (37,) and p1.shape == (37, 8)
    path = catalog_ann.save_artifact(str(tmp_path), "feedcafe", m1, p1)
    assert path == catalog_ann.artifact_path(str(tmp_path), "feedcafe")
    got = catalog_ann.load_artifact(str(tmp_path), "feedcafe")
    assert got[0].tobytes() == m1.tobytes()
    assert got[1].tobytes() == p1.tobytes()
    assert catalog_ann.build_projection(db[:5], 64)[1].shape[1] == 5


# ------------------------------------------------------------ tiers


def test_every_tier_serves_the_cold_builds_bytes(tmp_path):
    """Resident hit, host hit and disk load each give the cold build's
    bytes, tier by tier (the tiers drained between resolutions)."""
    from image_analogies_tpu_torch.ops.features import build_features_np

    root = str(tmp_path)
    tiers.configure(root_dir=root)
    rng = np.random.RandomState(2)
    spec = spec_for_level(TParams(**_KW), 0, 1, 1)
    a_src = rng.rand(12, 12).astype(np.float32)
    a_filt = rng.rand(12, 12).astype(np.float32)
    db = build_features_np(spec, a_src, a_filt, None, None)
    aff = a_filt.reshape(-1)
    key = tiers.feature_key(spec, a_src, a_filt)
    with _scope() as ctx:
        assert tiers.resolve("s", key) is None  # every tier misses
        tiers.record_build("s", key, db, aff, build_ms=1.0)
        c = ctx.registry.snapshot()["counters"]
    assert c["catalog.builds"] == 1 and c["catalog.disk.misses"] == 1
    assert c["catalog.disk.write_bytes"] > 0

    def served(counter):
        with _scope() as ctx:
            ent = tiers.resolve("s", key)
            c = ctx.registry.snapshot()["counters"]
        assert c[counter] == 1, c
        assert ent.db.tobytes() == db.tobytes()
        assert ent.a_filt_flat.tobytes() == aff.tobytes()
        return c

    served("catalog.hbm.hits")
    with tiers._LOCK:
        tiers._resident.clear()
    served("catalog.host.hits")
    tiers.clear()
    c = served("catalog.disk.hits")
    assert c["catalog.disk.read_bytes"] == db.nbytes + aff.nbytes
    assert tiers.evict(key) and not tiers.evict("absent")


def _sealed(tmp_path):
    a, ap, b = _inputs()
    root = str(tmp_path)
    rep = catalog_build.build_style(a, ap, TParams(**_KW), root_dir=root,
                                    target=b)
    return root, rep["style"], [e["key"] for e in rep["entries"]]


def _flip(path):
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(blob)


def _tear(path):
    whole = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(whole[: len(whole) // 2])


def _rename(path, root, style):
    """Bytes filed under another entry's key: the seal binds the key."""
    other = catalog_store.entry_path(root, style, "0" * 24)
    os.replace(path, other)
    return other


@pytest.mark.parametrize("damage", ["flip", "tear", "key"])
def test_damaged_entry_quarantines(tmp_path, damage):
    root, style, keys = _sealed(tmp_path)
    path = catalog_store.entry_path(root, style, keys[0])
    key = keys[0]
    if damage == "flip":
        _flip(path)
    elif damage == "tear":
        _tear(path)
    else:
        path, key = _rename(path, root, style), "0" * 24
    with _scope() as ctx:
        assert catalog_store.load_entry(root, style, key) is None
        c = ctx.registry.snapshot()["counters"]
    assert c["catalog.quarantined"] == 1
    assert os.path.exists(path + ".corrupt") and not os.path.exists(path)
    assert catalog_store.load_entry(root, style, key) is None  # clean miss
    assert catalog_store.stats(root)["corrupt"] == 1
    # the intact sibling still loads
    assert catalog_store.load_entry(root, style, keys[1]) is not None


@pytest.mark.parametrize("damage", ["flip", "tear", "key"])
def test_damaged_basis_quarantines(tmp_path, damage):
    root, _, keys = _sealed(tmp_path)
    path = catalog_ann.artifact_path(root, keys[0])
    key = keys[0]
    if damage == "flip":
        catalog_ann.damage_artifact(path, seed=3)
    elif damage == "tear":
        _tear(path)
    else:
        key = "1" * 24
        os.replace(path, catalog_ann.artifact_path(root, key))
        path = catalog_ann.artifact_path(root, key)
    with _scope() as ctx:
        assert catalog_ann.load_artifact(root, key) is None
        c = ctx.registry.snapshot()["counters"]
    assert c["ann.quarantined"] == 1
    assert os.path.exists(path + ".corrupt") and not os.path.exists(path)
    catalog_ann.damage_artifact(catalog_ann.artifact_path(root, "nope"))


def test_gc_clears_litter_and_enforces_its_budget(tmp_path):
    root, style, _ = _sealed(tmp_path)
    d = catalog_store.style_dir(root, style)
    open(os.path.join(d, "torn.tmp.npz"), "wb").close()
    open(os.path.join(d, "old.npz.corrupt"), "wb").close()
    assert catalog_store.list_styles(root) == [style]  # _ann is no style
    rep = catalog_store.gc(root)  # default: tmp litter only
    assert rep["removed_entries"] == 1
    assert os.path.exists(os.path.join(d, "old.npz.corrupt"))
    catalog_store.gc(root, keep=[style], max_bytes=0, purge_corrupt=True)
    assert not os.path.exists(os.path.join(d, "old.npz.corrupt"))
    assert len(catalog_store.list_entries(root, style)) == 2
    rep = catalog_store.gc(root, max_bytes=0)
    assert rep["removed_styles"] == [style]
    assert catalog_store.list_styles(root) == []


def test_host_tier_budget_evicts_lru(monkeypatch):
    monkeypatch.setenv("IA_CATALOG_HOST_BYTES", "4096")
    with _scope() as ctx:
        for i in range(4):  # 4 x ~2 KiB entries > a 4 KiB budget
            db = np.full((16, 32), float(i), np.float32)
            tiers.record_build("style", f"key{i}", db,
                               np.zeros(16, np.float32))
        snap = ctx.registry.snapshot()
    c, g = snap["counters"], snap["gauges"]
    assert c["catalog.host.evictions"] >= 1
    assert c["catalog.host.evicted_bytes"] >= 2048
    assert g["catalog.host.bytes"] == tiers.snapshot()["host_bytes"] <= 4096
    with tiers._LOCK:
        assert "key3" in tiers._host and "key0" not in tiers._host


def test_configuration_precedence(monkeypatch, tmp_path):
    from image_analogies_tpu_torch.tune import warmup as tune_warmup

    assert not tiers.active()
    tune_warmup.apply_runtime_config(
        TParams(catalog_dir=str(tmp_path), catalog_host_bytes=123))
    assert tiers.root() == str(tmp_path)
    assert tiers.host_budget() == 123
    monkeypatch.setenv("IA_CATALOG_DIR", "/elsewhere")
    monkeypatch.setenv("IA_CATALOG_HOST_BYTES", "456")
    assert tiers.root() == "/elsewhere" and tiers.host_budget() == 456
    monkeypatch.setenv("IA_CATALOG_HOST_BYTES", "bogus")
    assert tiers.host_budget() == 123  # a bad env value is ignored
    monkeypatch.delenv("IA_CATALOG_DIR")
    monkeypatch.delenv("IA_CATALOG_HOST_BYTES")
    tune_warmup.apply_runtime_config(TParams())  # a catalog-free run clears
    assert not tiers.active()
    assert tiers.host_budget() == tiers._DEFAULT_HOST_BYTES


class _RingRouter:
    """Stub with the one method ``warm_for_fleet`` consults."""

    def __init__(self, home):
        self._home = home
        self.asked = []

    def home_for_style(self, style):
        self.asked.append(style)
        return self._home


def test_warm_and_warm_for_fleet(tmp_path):
    root, style, _ = _sealed(tmp_path)
    tiers.clear()
    rep = tiers.warm(style, root_dir=root)
    assert rep["entries"] == 2 and rep["bytes"] > 0
    assert tiers.warm(style, root_dir=root)["entries"] == 0  # already warm
    tiers.clear()
    router = _RingRouter("w1")
    rep = tiers.warm_for_fleet(router, root_dir=root)
    assert router.asked == [style]
    assert rep["placements"] == {style: "w1"}
    assert rep["styles"] == 1 and rep["entries"] == 2
    assert tiers.snapshot()["host_entries"] == 2
    tiers.clear()
    rep = tiers.warm_for_fleet(_RingRouter("w1"), root_dir=root,
                               only_worker="w0")
    assert rep["styles"] == 0 and tiers.snapshot()["host_entries"] == 0
    # a router without home_for_style places nowhere, still warms
    assert tiers.warm_for_fleet(object(), root_dir=root)["entries"] == 2


def test_catalog_knobs_do_not_split_the_run_digest(tmp_path):
    base = TParams()
    tiered = TParams(catalog_dir=str(tmp_path), catalog_host_bytes=1 << 20)
    shapes = ((20, 20), (20, 20))
    assert ckpt.run_digest(base, *shapes) == ckpt.run_digest(tiered, *shapes)
    # the matcher is part of the result: it stays in the digest
    assert ckpt.run_digest(base, *shapes) != ckpt.run_digest(
        TParams(ann_prefilter=True), *shapes)


def test_catalog_cli_round_trip(tmp_path, capsys):
    a, ap, b = _inputs()
    for name, img in (("a", a), ("ap", ap), ("b", b)):
        save_image(str(tmp_path / f"{name}.png"), img)
    root = str(tmp_path / "cat")
    assert tcli.main(["catalog", "build", "--a", str(tmp_path / "a.png"),
                      "--ap", str(tmp_path / "ap.png"),
                      "--b", str(tmp_path / "b.png"), "--dir", root,
                      "--levels", "2", "--patch-size", "3",
                      "--coarse-patch-size", "3"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["levels"] == 2 and len(rep["entries"]) == 2
    assert len(os.listdir(os.path.join(root, catalog_ann.ANN_DIR))) == 2
    assert tcli.main(["catalog", "inspect", root, "--json"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["entries"] == 2 and info["corrupt"] == 0
    assert tcli.main(["catalog", "inspect", root]) == 0
    assert "1 style(s), 2 entries" in capsys.readouterr().out
    tiers.clear()
    assert tcli.main(["catalog", "warm", root, "--style", rep["style"]]) == 0
    assert json.loads(capsys.readouterr().out)["entries"] == 2
    assert tiers.snapshot()["host_entries"] == 2
    assert tcli.main(["catalog", "gc", root, "--max-bytes", "0"]) == 0
    assert json.loads(capsys.readouterr().out)["removed_entries"] == 2
    assert tcli.main(["catalog", "inspect", root, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["entries"] == 0
    assert tcli.main(["catalog", "inspect", str(tmp_path / "nope")]) == 2
    assert "no such directory" in capsys.readouterr().err


def test_catalog_imports_numpy_only_at_module_scope():
    """catalog/ is host-side: no module-scope torch or jax (the engine and
    ops imports of ``build`` stay inside its function)."""
    import image_analogies_tpu_torch.catalog as pkg

    root = os.path.dirname(pkg.__file__)
    top = re.compile(r"^(import|from)\s+(torch|jax)\b", re.MULTILINE)
    scanned = set()
    for name in sorted(os.listdir(root)):
        if name.endswith(".py"):
            scanned.add(name)
            with open(os.path.join(root, name)) as f:
                src = f.read()
            assert not top.findall(src), name
            assert "image_analogies_tpu." not in src, name
    assert {"__init__.py", "ann.py", "build.py", "store.py",
            "tiers.py"} <= scanned
