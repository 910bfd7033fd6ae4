"""The port's remaining anchor modes against the JAX package, on the CPU:
the "bf16" and "packed" level builds, each new branch of ``make_anchor_fn``,
the whole exact_hi2 scan, the whole scan of each probe mode, the config
surface and the bf16 parity gate.

The JAX anchors run their Pallas kernels in interpret mode: the test
rebinds, for its own duration only, the kernel names that
``backends/tpu.py`` (and ``pallas_match.prepadded_argmin2_queries``) call
to ``interpret=True`` partials.  Inputs are NumPy arrays made from a seed
and handed to both packages.
"""

import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_analogies_tpu.backends import tpu as jtpu
from image_analogies_tpu.backends.base import LevelJob as JLevelJob
from image_analogies_tpu.config import AnalogyParams as JParams
from image_analogies_tpu.models.analogy import (
    create_image_analogy as j_create,
)
from image_analogies_tpu.ops import features as jfeat
from image_analogies_tpu.ops import pallas_match as pm
from image_analogies_tpu.tune import resolve as jtune
from image_analogies_tpu.utils.parity import audit_source_map_mismatches
from image_analogies_tpu.utils.ssim import ssim
from image_analogies_tpu_torch import AnalogyParams as TParams
from image_analogies_tpu_torch import config as tcfg
from image_analogies_tpu_torch import create_image_analogy as t_create
from image_analogies_tpu_torch.backends import cuda as tcuda
from image_analogies_tpu_torch.backends import gate
from image_analogies_tpu_torch.ops import features as tfeat
from image_analogies_tpu_torch.utils.assets import make_structured
from image_analogies_tpu_torch.utils.state import level_db_from_numpy
from tests.conftest import make_pair
from tests.test_torch_wavefront import (  # noqa: F401
    _bits, _jax_level, _level_inputs, one_torch_thread)

CPU = torch.device("cpu")
KW = dict(fine_size=5, coarse_size=3, has_coarse=True, src_channels=1)
NEW_MODES = ("exact_hi2", "scan_rescue", "scan_rescue_1p", "two_pass",
             "two_pass_1p")


@pytest.fixture
def experimental(monkeypatch):
    monkeypatch.setenv("IA_EXPERIMENTAL", "1")


@pytest.fixture
def interpret_kernels(monkeypatch):
    """The JAX anchors' Pallas kernels in interpret mode (this test only)."""
    monkeypatch.setattr(jtpu, "packed3_best", functools.partial(
        pm.packed3_best, interpret=True))
    monkeypatch.setattr(jtpu, "pertile_champions_queries", functools.partial(
        pm.pertile_champions_queries, interpret=True))
    monkeypatch.setattr(pm, "pallas_argmin2_l2_prepadded", functools.partial(
        pm.pallas_argmin2_l2_prepadded, interpret=True))


def _torch_level(planes, pad_mode):
    t = {k: torch.from_numpy(v) for k, v in planes.items()}
    return tcuda.prepare_level_arrays(
        tfeat.FeatureSpec(**KW), t["a_src"], t["a_filt"], t["a_src_coarse"],
        t["a_filt_coarse"], t["b_src"], t["b_src_coarse"],
        t["b_filt_coarse"], pad_mode=pad_mode)


# ------------------------------------------------------------ level build


def test_prepare_level_arrays_bf16_matches_jax():
    planes = _level_inputs()
    want = _jax_level(jfeat.FeatureSpec(**KW), planes, "bf16")
    got = _torch_level(planes, "bf16")
    n, f = want["db"].shape
    assert got["db_pad"].dtype == torch.bfloat16
    assert got["db_pad"].shape == want["db_pad"].shape
    assert got["db_live"] is None and want["db_live"] is None
    assert got["db_pad2"] is None and want["db_pad2"] is None
    # the mean of ALL columns (a reduction: summation order differs)
    np.testing.assert_allclose(got["feat_mean"].numpy(), want["feat_mean"],
                               rtol=1e-6, atol=1e-7)
    for name in ("dbn_pad", "dbnh_pad"):
        w = want[name].reshape(-1)
        np.testing.assert_allclose(got[name][:n].numpy(), w[:n], rtol=1e-5)
        assert np.isinf(w[n:]).all() and torch.isinf(got[name][n:]).all()
    # the pad ROUNDS the centered rows to bf16.  The jitted JAX build
    # recomputes the mean inside its fusions (as for the packed pads), so
    # a few elements near zero round from a centered value an ulp away:
    # the rest is bit-equal, and every element agrees to bf16 resolution
    g = got["db_pad"][:n, :f]
    w = np.asarray(want["db_pad"])[:n, :f]
    assert (g.view(torch.int16).numpy() != w.view(np.int16)).mean() < 1e-3
    np.testing.assert_allclose(g.float().numpy(), w.astype(np.float32),
                               rtol=2 ** -7, atol=1e-6)
    own = (torch.from_numpy(want["db"]) - got["feat_mean"][:f]).to(
        torch.bfloat16)
    assert torch.equal(g.view(torch.int16), own.view(torch.int16))
    assert not got["db_pad"][n:].float().any()
    assert not got["db_pad"][:, f:].float().any()


def test_prepare_level_arrays_packed_matches_jax():
    planes = _level_inputs(seed=6)
    jspec = jfeat.FeatureSpec(**KW)
    want = _jax_level(jspec, planes, "packed")
    got = _torch_level(planes, "packed")
    live = want["live_idx"]
    lw, n = live.size, want["db"].shape[0]
    assert np.array_equal(got["live_idx"].numpy(), live)
    assert got["db_pad"].shape == want["db_pad"].shape == (256 * 3, 128)
    assert got["db_pad2"].shape == want["db_pad2"].shape
    np.testing.assert_allclose(got["feat_mean"].numpy(), want["feat_mean"],
                               rtol=1e-6, atol=1e-7)
    dbnh = want["dbnh_pad"].reshape(-1)
    np.testing.assert_allclose(got["dbnh_pad"][:n].numpy(), dbnh[:n],
                               rtol=1e-6)
    assert torch.isinf(got["dbnh_pad"][n:]).all()
    # what the lanes encode: W1 = [d1|d2], W2 = [d3|d1]
    centered = want["db"][:, live] - want["feat_mean"][live]
    for w1, w2 in ((got["db_pad"].float().numpy(),
                    got["db_pad2"].float().numpy()),
                   (want["db_pad"].astype(np.float32),
                    want["db_pad2"].astype(np.float32))):
        np.testing.assert_array_equal(w1[:n, :lw], w2[:n, lw:2 * lw])
        np.testing.assert_allclose(
            w1[:n, :lw] + w1[:n, lw:2 * lw] + w2[:n, :lw], centered,
            rtol=1e-5, atol=1e-6)
        assert not w1[n:].any() and not w2[:, 2 * lw:].any()
    # the elementwise half bit for bit, given JAX's own eager reductions
    w1_e, w2_e, dbnh_e, shift_e, _ = jtpu._packed_weight_arrays(
        jnp.asarray(want["db"]), jspec, 768, mode2p=False)
    f = want["db"].shape[1]
    w1, w2, dbnh_t = tcuda.pack_w12(
        torch.from_numpy(want["db"].copy()),
        torch.from_numpy(np.asarray(shift_e)[:f].copy()),
        torch.from_numpy(np.asarray(dbnh_e)[:n].copy()),
        torch.from_numpy(live).long(), 768)
    for a, b in ((w1, w1_e), (w2, w2_e)):
        assert np.array_equal(a.view(torch.int16).numpy(),
                              np.asarray(b).view(np.int16))
    assert np.array_equal(_bits(dbnh_t.numpy()), _bits(dbnh_e))
    assert np.array_equal(_bits(got["db_live"].numpy()[:, :lw]),
                          _bits(want["db_live"][:, :lw]))


# --------------------------------------------------------------- anchors


def _both_states(mode, seed=4, ha=26, wa=24, hb=22, wb=20):
    """One level's state from the JAX build: the JAX ``TpuLevelDB`` and the
    port's ``LevelDB`` made from the same arrays (scan tile = JAX's)."""
    planes = _level_inputs(seed=seed, ha=ha, wa=wa, hb=hb, wb=wb)
    jspec = jfeat.FeatureSpec(**KW)
    pad_mode = tcuda.PAD_MODES[mode]
    arrs = _jax_level(jspec, planes, pad_mode)
    jparams = JParams(backend="tpu", strategy="wavefront", match_mode=mode)
    jjob = JLevelJob(level=0, spec=jspec, kappa_mult=4.0, **planes)
    tmpl = jtpu.make_level_template(jparams, jjob, "wavefront", mode)
    jdb = dataclasses.replace(tmpl, **{
        k: (None if v is None else jnp.asarray(v)) for k, v in arrs.items()})
    npad, fp = arrs["db_pad"].shape
    arrs.update(diag=[np.asarray(s) for s in tmpl.diag],
                off=np.asarray(tmpl.off),
                fine_sqrtw=np.asarray(tmpl.fine_sqrtw))
    meta = dict(ha=ha, wa=wa, hb=hb, wb=wb, fine_start=tmpl.fine_start,
                match_mode=mode,
                scan_tile=jtune.scan_tile(npad, fp, strategy="wavefront",
                                          dtype="bf16"))
    return jdb, level_db_from_numpy(arrs, meta, CPU), arrs


def _queries(arrs, m=37, seed=1):
    """Anchor inputs: static B rows with a random causal block, plus one
    query equal to a DB row (a duplicate-free exact hit)."""
    rng = np.random.default_rng(seed)
    q = arrs["static_q"][rng.integers(0, arrs["static_q"].shape[0], m)]
    q = q + rng.uniform(0, 0.05, q.shape).astype(np.float32)
    q[0] = arrs["db"][17]
    return q.astype(np.float32)


@pytest.mark.parametrize("mode", NEW_MODES)
def test_anchor_matches_jax(mode, experimental, interpret_kernels):
    jdb, tdb, arrs = _both_states(mode)
    q = _queries(arrs)
    jp, jd = jtpu.make_anchor_fn(jdb)(jnp.asarray(q))
    tp, td = tcuda.make_anchor_fn(tdb)(torch.from_numpy(q))
    assert tp.dtype == torch.int64
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert int(tp[0]) == 17 and int(tp.max()) < 26 * 24
    if mode == "exact_hi2":
        assert td is None  # re-score deferred to the coherence gather
    else:
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("npad", [256, 768, 9216, 65536, 262144, 1048576])
def test_port_scan_tile_is_the_jax_tiling(npad):
    """The tile decides the rescue set; the port's own cap reproduces the
    tiling the JAX package resolves for Fp = 128 without a tune store."""
    assert tcuda.scan_tile_rows(npad) == jtune.scan_tile(
        npad, 128, strategy="wavefront", dtype="bf16")
    assert npad % tcuda.scan_tile_rows(npad) == 0


# ------------------------------------------------------------ whole scans


def test_exact_hi2_matches_jax_exact_scan():
    """exact_hi2 on the port (the six-product packed set) against the JAX
    package's exact fp32 scan: the first divergence is a tie and the rest
    is explained."""
    a, ap, b = make_structured(64, 7)
    base = dict(levels=3, kappa=5.0)
    ref = j_create(a, ap, b, JParams(backend="tpu", strategy="wavefront",
                                     **base), keep_levels=True)
    port = t_create(a, ap, b, TParams(match_mode="exact_hi2", **base),
                    device="cpu", keep_levels=True)
    assert {st["match_mode"] for st in port.stats} == {"exact_hi2"}
    audit = audit_source_map_mismatches(a, ap, b, JParams(**base),
                                        port.levels, ref.levels)
    assert audit["first_divergence_is_tie"] in (True, None), audit
    assert audit["unexplained"] / max(audit["mismatches"], 1) <= 1e-4
    assert ssim(port.bp_y, ref.bp_y) >= 0.99


class _TpuPlatformJax:
    """``jax`` as ``backends/tpu.py`` sees it, reporting a TPU platform, so
    the JAX level build pads the DB for the bf16 anchors as it does on the
    chip (on the CPU platform it builds no pads and runs the exact scan).
    The anchors' kernels run in interpret mode (``interpret_kernels``)."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


@pytest.mark.parametrize("mode", ["scan_rescue", "scan_rescue_1p",
                                  "two_pass", "two_pass_1p"])
def test_probe_mode_whole_scan_matches_jax(mode, experimental,
                                           interpret_kernels, monkeypatch):
    """Each probe mode end to end, two levels, on the port and on the JAX
    package with its bf16 anchor kernel in interpret mode: the same padded
    DB rows and rescue tiles at every level, and the same source maps and
    outputs, so the wiring between anchor and step (tile choice, top-T
    rescue, d_app feeding the kappa rule) is the JAX package's.  kappa =
    0.5 at 48x44 makes the picks move if the rescue depth or d_app does."""
    monkeypatch.setattr(jtpu, "jax", _TpuPlatformJax())
    kernel = ("pertile_champions_queries" if mode.startswith("scan_rescue")
              else "prepadded_argmin2_queries")
    seen = {"jax": set(), "port": set()}

    def recording(side, inner):
        def call(*args, **kwargs):
            tile = kwargs.get("tile_n", args[3] if len(args) > 3 else None)
            if kernel.startswith("prepadded"):
                tile = None  # the JAX tile only blocks its kernel there
            seen[side].add((int(args[1].shape[0]), tile))
            return inner(*args, **kwargs)
        return call

    monkeypatch.setattr(jtpu, kernel, recording("jax", getattr(jtpu, kernel)))
    monkeypatch.setattr(tcuda, kernel, recording("port",
                                                 getattr(tcuda, kernel)))
    (a, ap, b), base = make_pair(48, 44, seed=3), dict(levels=2, kappa=0.5)
    ref = j_create(a, ap, b, JParams(backend="tpu", strategy="wavefront",
                                     match_mode=mode, **base),
                   keep_levels=True)
    port = t_create(a, ap, b, TParams(match_mode=mode, **base),
                    device="cpu", keep_levels=True)
    assert len(seen["jax"]) == 2, "the JAX anchor never reached its kernel"
    assert seen["port"] == seen["jax"]
    assert {st["match_mode"] for st in port.stats} == {mode}
    assert len(port.levels) == len(ref.levels) == 2
    for (bp_t, s_t), (bp_j, s_j) in zip(port.levels, ref.levels):
        np.testing.assert_array_equal(s_t, s_j)
        np.testing.assert_allclose(bp_t, bp_j, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(port.source_map, ref.source_map)


@pytest.mark.parametrize("mode", ["scan_rescue", "two_pass"])
def test_probe_modes_run_end_to_end(mode, experimental):
    """The probe modes are not parity modes (the JAX package measured them
    drifting from the oracle); end to end they must still be finite,
    deterministic and close to the exact scan."""
    (a, ap, b), base = make_pair(26, 24, seed=3), dict(levels=2, kappa=5.0)
    runs = [t_create(a, ap, b, TParams(match_mode=mode, **base),
                     device="cpu") for _ in range(2)]
    exact = t_create(a, ap, b, TParams(**base), device="cpu")
    assert np.array_equal(runs[0].source_map, runs[1].source_map)
    assert np.isfinite(runs[0].bp_y).all()
    assert {st["match_mode"] for st in runs[0].stats} == {mode}
    assert ssim(runs[0].bp_y, exact.bp_y) >= 0.9


# ----------------------------------------------------- config and the gate


def test_match_mode_surface_and_experimental_gate(monkeypatch):
    monkeypatch.delenv("IA_EXPERIMENTAL", raising=False)
    for mode in tcfg.PARITY_MATCH_MODES:
        assert TParams(match_mode=mode).match_mode == mode
    for mode in tcfg.EXPERIMENTAL_MATCH_MODES:
        with pytest.raises(ValueError, match="IA_EXPERIMENTAL=1"):
            TParams(match_mode=mode)
    for falsy in ("0", "no", "disabled", " "):
        monkeypatch.setenv("IA_EXPERIMENTAL", falsy)
        assert not tcfg.experimental_enabled()
    monkeypatch.setenv("IA_EXPERIMENTAL", " Yes ")
    for mode in tcfg.EXPERIMENTAL_MATCH_MODES:
        assert TParams(match_mode=mode).match_mode == mode
    assert set(tcfg.PARITY_MATCH_MODES) | set(tcfg.EXPERIMENTAL_MATCH_MODES) \
        == set(tcuda.PAD_MODES) | {"auto"}
    with pytest.raises(ValueError, match="unknown match_mode"):
        TParams(match_mode="exact_hi3")


def test_bf16_scoring_config_validation():
    with pytest.raises(ValueError, match="bf16_scoring"):
        TParams(strategy="batched", bf16_scoring=True)
    assert TParams().bf16_scoring is False  # off by default
    assert TParams(strategy="wavefront", bf16_scoring=True).bf16_scoring


def test_bf16_gate_probe_allows_on_parity():
    """On the CPU the probe's bf16 run is the plain per-tile scan: its
    audit against the exact run comes back fully explained, so the gate
    opens, caches the verdict under "cpu", and the levels run scan_rescue.
    """
    gate.reset_bf16_gate()
    a, ap, b = make_pair(20, 22, seed=9)
    fast = t_create(a, ap, b, TParams(levels=2, bf16_scoring=True),
                    device="cpu")
    verdict = gate.bf16_gate_verdict("cpu")
    assert verdict == {"ok": True, "mismatches": verdict["mismatches"],
                       "unexplained": 0,
                       "first_divergence_is_tie": verdict[
                           "first_divergence_is_tie"]}
    assert verdict["first_divergence_is_tie"] is not False
    assert {st["match_mode"] for st in fast.stats} == {"scan_rescue"}
    assert gate.bf16_gate_allows(TParams(bf16_scoring=True), "cpu")
    gate.reset_bf16_gate()
    assert gate.bf16_gate_verdict("cpu") is None


def test_bf16_gate_refuses_unexplained_mismatch(monkeypatch):
    """An audit with unexplained mismatches disables the mode for the
    process (cached: no second probe) without failing the synthesis, which
    silently keeps the exact scan."""
    gate.reset_bf16_gate()
    calls = []

    def refuse(params, device):
        calls.append(device)
        return {"ok": False, "mismatches": 3, "unexplained": 3,
                "first_divergence_is_tie": False}

    monkeypatch.setattr(gate, "_bf16_probe_verdict", refuse)
    p = TParams(levels=2, bf16_scoring=True, device="cpu")
    assert gate.bf16_gate_allows(p, "cpu") is False
    assert gate.bf16_gate_allows(p, "cpu") is False
    assert len(calls) == 1
    a, ap, b = make_pair(16, 16, seed=10)
    res = t_create(a, ap, b, p)
    exact = t_create(a, ap, b, dataclasses.replace(p, bf16_scoring=False))
    np.testing.assert_array_equal(exact.bp_y, res.bp_y)
    assert {st["match_mode"] for st in res.stats} == {"exact_hi"}
    assert gate.bf16_gate_verdict(CPU)["unexplained"] == 3
    gate.reset_bf16_gate()


def test_bf16_gate_probe_run_does_not_recurse(monkeypatch):
    gate.reset_bf16_gate()
    monkeypatch.setattr(gate, "_bf16_probe_verdict", lambda *a: 1 / 0)
    gate._BF16_TLS.probing = True
    try:
        assert gate.bf16_gate_allows(TParams(bf16_scoring=True), "cpu")
    finally:
        gate._BF16_TLS.probing = False
    assert gate.bf16_gate_verdict("cpu") is None


def test_bf16_gate_is_one_verdict_under_threads(monkeypatch):
    """Concurrent first uses settle on ONE cached verdict per device: the
    first probe to finish wins, every caller reads the same answer."""
    import sys

    gate.reset_bf16_gate()
    n = 0
    lock = threading.Lock()

    def probe(params, device):
        nonlocal n
        with lock:
            n += 1
            k = n
        return {"ok": k % 2 == 1, "mismatches": k, "unexplained": 0,
                "first_divergence_is_tie": None}

    monkeypatch.setattr(gate, "_bf16_probe_verdict", probe)
    answers = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: answers.append(
            gate.bf16_gate_allows(TParams(bf16_scoring=True), "cpu")))
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    verdict = gate.bf16_gate_verdict("cpu")
    assert len(answers) == 16 and set(answers) == {verdict["ok"]}
    gate.reset_bf16_gate()
