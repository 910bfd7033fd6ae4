"""The port's chaos plane (``image_analogies_tpu_torch/chaos/``, ``ia
chaos``) on the CPU, held to the JAX package's ``chaos/``.

The port's side mirrors ``tests/test_chaos.py``:

- one canonical drill per drill kind passes end to end on
  ``device="cpu"`` (the kernels' plain versions under the faults):
  bit-identical recovery, no lost or hung request, and the injection
  counters reconciled against the recovery counters they caused.  The
  kinds are the JAX package's, ``flash_crowd`` (loadgen's
  ``arrival_schedule`` surge against an autoscaling fleet) included;
- same seed, same fault schedule; a disarmed site touches nothing;
  ``max_faults`` caps a rule; an unplanned site passes through;
  ``plan_scope`` disarms on error;
- plans round-trip through JSON (the lognormal latency fields too) and
  validate as the JAX ones do;
- ``ia chaos`` on the CPU: a selftest subset, a plan file, and no mode.

The JAX test ``test_chaos_telemetry_in_report_and_trace`` reads the
chaos section of ``ia report`` and the chaos track of the exported trace;
its mirror, on the port's ``obs/report.py`` and ``obs/export.py``, is
here too.

Across the two packages:

- the same ``ChaosPlan`` fires at the same visits over 1,000
  probabilistic visits, with equal lognormal draws, and every canonical
  plan serializes to the same dict;
- ``corrupt_file`` flips the same bytes;
- each image, serve, batch, catalog, ANN and archive drill's report has
  the JAX drill's ``ok``, ``injected``, per-site snapshot and reconciled
  recovery counters, the port's image and serve drills on the host
  oracle (``backend="cpu"``, the JAX drills' matcher) and the rest on
  ``device="cpu"``.  One difference is written where it is made: the
  serve drill's ``serve.dispatch`` visits count the batches its two
  workers happened to form, which thread timing decides in either
  package, so only that site's injections are compared.

The ``flash_crowd`` drill is held to the JAX one on its injections,
plan, bits and final fleet size, and on every non-viral request answered
(its quota throttles and scale events follow thread timing in either
package); the port's drill is ``ok``, the JAX one ``ok`` but for its
settle race, which the port's drill repairs (``_settled_at_floor``).  The subprocess fleet drill is held to the JAX
one on its ``ok``,
injections, per-site snapshot, router counters and the home journal's
states; it spawns ``worker_main`` children in each package (about 25 s
for the JAX one).  Every comparison is exact.
"""

import json
import os
import re
import tempfile

import numpy as np
import pytest

from image_analogies_tpu_torch import chaos
from image_analogies_tpu_torch.chaos import faults, inject, runner
from image_analogies_tpu_torch.chaos.plan import ChaosPlan, SiteRule
from image_analogies_tpu_torch.serve import transport

# the recovery counters runner._reconcile reads (and the ANN chain's)
RECOVERY = ("level_retry", "watchdog.timeouts", "ckpt.quarantined",
            "serve.worker_crashes", "serve.process_deaths",
            "router.hop_faults", "batch.lane_faults",
            "catalog.chaos_evictions", "obs.archive.quarantined",
            "obs.archive.append_errors", "ann.quarantined",
            "ann.fallback_exact", "ann.artifacts_rebuilt")
# image and serve drills: the JAX drills run the host oracle
HOST_ORACLE_KINDS = ("transient", "oom", "latency", "corrupt", "crash",
                     "process_death", "fleet_death")
CROSS_KINDS = HOST_ORACLE_KINDS + ("batch_partial", "devcache_tier",
                                   "ann_corrupt", "archive_torn")


@pytest.fixture(autouse=True)
def _disarm_and_reap():
    """The port's plan and fault injector are process-global: reset both
    after every test (the repo conftest resets the JAX package's), and
    SIGKILL any worker_main child a failed test left behind."""
    yield
    from image_analogies_tpu_torch.utils import failure

    failure.inject_failures(0)
    chaos.disarm()
    transport.reap_orphans()


@pytest.fixture(scope="module", autouse=True)
def _own_stores():
    """The serve cost prior reads the tune store: the module's own; no
    catalog or archive root leaks in from the environment."""
    with tempfile.TemporaryDirectory() as tmp, \
            pytest.MonkeyPatch.context() as mp:
        mp.setenv("IA_TUNE_STORE", os.path.join(tmp, "tune.json"))
        mp.delenv("IA_CATALOG_DIR", raising=False)
        mp.delenv("IA_ARCHIVE_DIR", raising=False)
        yield


_REPORTS = {}


def port_report(kind, backend="cuda"):
    """The port's drill report of ``kind`` at seed 0 on the CPU, run once
    per (kind, backend) for the module."""
    key = (kind, backend)
    if key not in _REPORTS:
        kw = {"device": "cpu"}
        if kind in HOST_ORACLE_KINDS:
            kw["backend"] = backend
        _REPORTS[key] = runner.run_drill(runner.plan_for_kind(kind, 0),
                                         **kw)
    return _REPORTS[key]


# ------------------------------------------------- drills (per kind)


@pytest.mark.parametrize("kind", runner.DRILL_KINDS)
def test_drill_recovers_per_fault_kind(kind):
    """``ia chaos --selftest``'s drills, one per kind, on the device
    matcher on the CPU, each asserting full recovery."""
    report = port_report(kind)
    assert report["ok"], report["problems"]
    assert report["injected"] >= 1
    assert report["identical"] is True
    if kind == "fleet_death_subprocess":
        assert transport.live_workers() == []
        assert transport.reap_orphans() == 0


def test_drill_kinds_cover_fault_kinds():
    """DRILL_KINDS is FAULT_KINDS plus the composite drills: the JAX
    tuple, flash_crowd included."""
    from image_analogies_tpu import chaos as jchaos
    from image_analogies_tpu.chaos import runner as jrunner

    assert set(chaos.FAULT_KINDS) <= set(runner.DRILL_KINDS)
    assert "fleet_death" in runner.DRILL_KINDS
    assert chaos.FAULT_KINDS == jchaos.FAULT_KINDS
    assert runner.DRILL_KINDS == jrunner.DRILL_KINDS
    assert "flash_crowd" in runner.DRILL_KINDS
    assert chaos.KNOWN_SITES == jchaos.KNOWN_SITES
    assert len(chaos.KNOWN_SITES) == 13


def test_same_seed_same_schedule():
    det = runner.check_determinism(seed=3)
    assert det["ok"], det["problems"]
    assert det["injected"] > 0


# ------------------------------------------------- the injection plane


def test_disarmed_site_is_inert(monkeypatch):
    """Disarmed = production: a site visit must not touch metrics, the
    run log, or return a directive."""
    from image_analogies_tpu_torch.obs import metrics as obs_metrics
    from image_analogies_tpu_torch.obs import trace as obs_trace

    assert not chaos.armed()

    def touched(*a, **k):
        raise AssertionError("chaos site touched obs while disarmed")

    monkeypatch.setattr(obs_metrics, "inc", touched)
    monkeypatch.setattr(obs_trace, "emit_record", touched)
    assert chaos.site("level.dispatch", level=0) is None
    assert chaos.site("ckpt.save") is None
    assert chaos.snapshot() == {}
    assert chaos.injected_total() == 0
    assert chaos.plan_seed() is None


def test_max_faults_caps_probabilistic_rule():
    plan = ChaosPlan(seed=1, sites=(
        ("level.dispatch", SiteRule(kind="latency", p=1.0, latency_ms=0.0,
                                    max_faults=2)),))
    with inject.plan_scope(plan):
        for _ in range(10):
            inject.site("level.dispatch")
        snap = inject.snapshot()
    assert snap["level.dispatch"] == {"visits": 10, "injected": 2}


def test_unplanned_site_passes_through():
    plan = ChaosPlan(seed=1, sites=(
        ("ckpt.save", SiteRule(kind="corrupt", schedule=(0,))),))
    with inject.plan_scope(plan):
        assert inject.site("level.dispatch") is None  # no rule -> no-op
        assert inject.site("ckpt.save") == "corrupt"  # directive returned
        assert inject.site("ckpt.save") is None       # schedule spent


def test_plan_scope_disarms_even_on_error():
    plan = runner.plan_for_kind("transient")
    with pytest.raises(RuntimeError):
        with inject.plan_scope(plan):
            assert chaos.armed()
            raise RuntimeError("drill body died")
    assert not chaos.armed()
    assert chaos.plan_seed() is None


@pytest.mark.parametrize("kind,cls", [
    ("transient", faults.ChaosTransient), ("oom", faults.ChaosOutOfMemory),
    ("crash", faults.WorkerCrash), ("process_death", faults.ProcessDeath)])
def test_raising_kinds_take_the_real_classification(kind, cls):
    """transient and oom are retried by the port's classifier (oom as a
    ``torch.cuda.OutOfMemoryError``), crash and process_death are not;
    the oom message is the JAX fault's."""
    import torch

    from image_analogies_tpu_torch.utils import failure

    plan = ChaosPlan(seed=0, sites=(("x", SiteRule(kind=kind,
                                                   schedule=(0,))),))
    with inject.plan_scope(plan):
        with pytest.raises(cls) as info:
            inject.site("x")
    assert failure._is_transient(info.value) is (kind in ("transient",
                                                          "oom"))
    if kind == "oom":
        assert isinstance(info.value, torch.cuda.OutOfMemoryError)
        assert str(info.value).startswith("RESOURCE_EXHAUSTED: chaos oom")
    assert issubclass(faults.ProcessDeath, BaseException)
    assert not issubclass(faults.ProcessDeath, Exception)


# ------------------------------------------------------ plan format


def test_plan_json_roundtrip():
    plan = ChaosPlan(seed=42, name="rt", sites=(
        ("level.dispatch", SiteRule(kind="transient", p=0.5, max_faults=2)),
        ("ckpt.save", SiteRule(kind="corrupt", schedule=(0, 3))),
        ("serve.dispatch", SiteRule(kind="latency", latency_ms=10.0,
                                    hang=True, schedule=(1,))),
    ))
    assert ChaosPlan.from_json(json.dumps(plan.to_dict())) == plan


def test_plan_validation():
    with pytest.raises(ValueError):
        SiteRule(kind="meteor")
    with pytest.raises(ValueError):
        SiteRule(kind="transient", p=1.5)
    with pytest.raises(ValueError):
        ChaosPlan.from_dict({"sites": {"x": {"p": 0.5}}})  # no kind
    with pytest.raises(ValueError):
        ChaosPlan.from_dict([])  # not an object
    # lognormal latency spec: both percentiles or neither, and ordered
    with pytest.raises(ValueError):
        SiteRule(kind="latency", latency_p50_ms=10.0)
    with pytest.raises(ValueError):
        SiteRule(kind="latency", latency_p99_ms=10.0)
    with pytest.raises(ValueError):
        SiteRule(kind="latency", latency_p50_ms=10.0, latency_p99_ms=5.0)
    with pytest.raises(ValueError):
        SiteRule(kind="latency", latency_p50_ms=-1.0, latency_p99_ms=5.0)


def test_plan_json_roundtrip_lognormal_latency():
    plan = ChaosPlan(seed=3, sites=(
        ("level.dispatch", SiteRule(kind="latency", p=1.0,
                                    latency_p50_ms=2.0,
                                    latency_p99_ms=20.0)),))
    again = ChaosPlan.from_json(json.dumps(plan.to_dict()))
    assert again == plan
    # inert zero defaults stay out of the serialized form
    flat = json.dumps(ChaosPlan(seed=3, sites=(
        ("x", SiteRule(kind="latency")),)).to_dict())
    assert "latency_p50_ms" not in flat


def test_lognormal_latency_draws_are_plan_deterministic():
    """Same (seed, site) -> same tail-latency draws; the p50/p99 spec
    shapes them (median near p50, spread reaching toward p99)."""
    rule = SiteRule(kind="latency", p=1.0, latency_p50_ms=5.0,
                    latency_p99_ms=50.0)
    plan = ChaosPlan(seed=11, sites=(("level.dispatch", rule),))

    def draws(n=64):
        inject.arm(plan)
        try:
            return [inject._latency_s("level.dispatch", rule)
                    for _ in range(n)]
        finally:
            inject.disarm()

    first, second = draws(), draws()
    assert first == second                      # replayable tail
    assert all(d > 0 for d in first)
    med = sorted(first)[len(first) // 2]
    assert 0.001 < med < 0.025                  # median ~5ms, not 50ms
    assert max(first) > med * 2                 # a tail actually exists
    # a different seed reshuffles the draws
    inject.arm(ChaosPlan(seed=12, sites=(("level.dispatch", rule),)))
    try:
        other = [inject._latency_s("level.dispatch", rule)
                 for _ in range(64)]
    finally:
        inject.disarm()
    assert other != first


def test_fixed_latency_rule_ignores_lognormal_path():
    rule = SiteRule(kind="latency", p=1.0, latency_ms=7.0)
    plan = ChaosPlan(seed=11, sites=(("level.dispatch", rule),))
    inject.arm(plan)
    try:
        assert inject._latency_s("level.dispatch", rule) == 0.007
    finally:
        inject.disarm()


# ------------------------------------------------------------- CLI


def test_cli_chaos_selftest_smoke(capsys):
    from image_analogies_tpu_torch.cli import main

    rc = main(["chaos", "--selftest", "--kinds", "transient", "--seed", "1",
               "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "PASS" in out and "determinism" in out


def test_cli_chaos_plan_file(tmp_path, capsys):
    from image_analogies_tpu_torch.cli import main

    path = str(tmp_path / "plan.json")
    with open(path, "w") as f:
        json.dump(runner.plan_for_kind("oom", seed=2).to_dict(), f)
    rc = main(["chaos", "--plan", path, "--device", "cpu", "--json"])
    captured = capsys.readouterr()
    assert rc == 0, captured.out
    assert "PASS" in captured.out
    doc = json.loads(captured.err.strip().splitlines()[-1])
    assert doc["ok"] and doc["reports"][0]["injected"] == 1


def test_cli_chaos_requires_plan_or_selftest(capsys):
    from image_analogies_tpu_torch.cli import main

    assert main(["chaos", "--device", "cpu"]) == 2
    assert "pass --plan FILE or --selftest" in capsys.readouterr().err


def test_cli_chaos_refuses_unknown_site_and_needs_a_device(tmp_path,
                                                          capsys):
    """A plan file naming an unknown site exits 2 before any drill; with
    no card and no ``--device cpu`` the command exits 2 too."""
    import torch

    from image_analogies_tpu_torch.cli import main

    path = str(tmp_path / "typo.json")
    with open(path, "w") as f:
        json.dump({"seed": 1, "sites": {"level.dispatchh": {
            "kind": "transient", "schedule": [0]}}}, f)
    assert main(["chaos", "--plan", path, "--device", "cpu"]) == 2
    assert "unknown injection site(s)" in capsys.readouterr().err
    if not torch.cuda.is_available():
        assert main(["chaos", "--selftest"]) == 2
        assert "CUDA is not available" in capsys.readouterr().err


# ------------------------------------------------- against the JAX plane


def _fires(inj, plan, n):
    """Per site, the visits of ``n`` at which ``plan``'s rule fires, and
    the lognormal draws of its latency rule, through one package's
    injection plane."""
    fired, drawn = {}, {}
    inj.arm(plan)
    try:
        for name, rule in plan.sites:
            fired[name] = [v for v in (inj._decide(name, rule)
                                       for _ in range(n)) if v is not None]
            if rule.latency_p50_ms:
                drawn[name] = [inj._latency_s(name, rule)
                               for _ in range(n)]
        snap = inj.snapshot()
    finally:
        inj.disarm()
    return fired, drawn, snap


def test_same_plan_fires_at_the_same_visits_as_the_jax_plane():
    """1,000 probabilistic visits a site: the same visits fire, the caps
    hold alike, and the lognormal draws are equal floats."""
    from image_analogies_tpu.chaos import inject as jinject
    from image_analogies_tpu.chaos.plan import ChaosPlan as JPlan

    doc = {"seed": 20261018, "name": "cross", "sites": {
        "level.dispatch": {"kind": "transient", "p": 0.3},
        "devcache.upload": {"kind": "latency", "p": 0.7,
                            "latency_p50_ms": 3.0, "latency_p99_ms": 40.0},
        "serve.dispatch": {"kind": "crash", "p": 0.5, "max_faults": 17},
        "ckpt.save": {"kind": "corrupt", "schedule": [0, 5, 999]}}}
    ours = _fires(inject, ChaosPlan.from_dict(doc), 1000)
    theirs = _fires(jinject, JPlan.from_dict(doc), 1000)
    assert ours == theirs
    fired = ours[0]
    assert 200 < len(fired["level.dispatch"]) < 400
    assert len(fired["serve.dispatch"]) == 17
    assert fired["ckpt.save"] == [0, 5, 999]
    assert len(ours[1]["devcache.upload"]) == 1000


def test_plan_files_load_equal_in_both_packages(tmp_path):
    """Every canonical plan, and a lognormal one, written by either
    package loads in the other to an equal dict."""
    from image_analogies_tpu.chaos import runner as jrunner
    from image_analogies_tpu.chaos.plan import ChaosPlan as JPlan

    plans = [(runner.plan_for_kind(k, 5), jrunner.plan_for_kind(k, 5))
             for k in runner.DRILL_KINDS]
    lognormal = {"seed": 3, "name": "tail", "sites": {"level.dispatch": {
        "kind": "latency", "p": 1.0, "latency_p50_ms": 2.0,
        "latency_p99_ms": 20.0}}}
    plans.append((ChaosPlan.from_dict(lognormal), JPlan.from_dict(lognormal)))
    for i, (ours, theirs) in enumerate(plans):
        assert ours.to_dict() == theirs.to_dict()
        for j, plan in enumerate((ours, theirs)):
            path = str(tmp_path / f"plan{i}_{j}.json")
            with open(path, "w") as f:
                json.dump(plan.to_dict(), f)
            assert ChaosPlan.load(path).to_dict() == theirs.to_dict()
            assert JPlan.load(path).to_dict() == ours.to_dict()


def test_corrupt_file_flips_the_same_bytes_as_the_jax_fault(tmp_path):
    from image_analogies_tpu.chaos import faults as jfaults

    payload = np.random.RandomState(9).bytes(4099)
    for seed, flips in ((0, 16), (41, 1), (7, 5000)):
        got = []
        for pkg, mod in (("port", faults), ("jax", jfaults)):
            d = tmp_path / f"{pkg}{seed}"
            d.mkdir()
            path = str(d / "level_01.npz")  # the seed reads the basename
            with open(path, "wb") as f:
                f.write(payload)
            n = mod.corrupt_file(path, seed, n_flips=flips)
            with open(path, "rb") as f:
                got.append((n, f.read()))
        assert got[0] == got[1]
        assert got[0][1] != payload
    assert faults.corrupt_file(str(tmp_path / "missing"), 1) == 0
    assert faults.stream_seed(1, "a", 2) == jfaults.stream_seed(1, "a", 2)


def _recovery(report):
    c = report.get("counters", {})
    return {k: v for k, v in c.items()
            if k in RECOVERY or k.startswith("chaos.")}


@pytest.mark.parametrize("kind", CROSS_KINDS)
def test_drill_report_matches_the_jax_drill(kind):
    """The port's drill against the JAX drill of the same kind and seed:
    ok, injected, per-site snapshot, reconciled recovery counters."""
    from image_analogies_tpu.chaos import runner as jrunner

    theirs = jrunner.run_drill(jrunner.plan_for_kind(kind, 0))
    ours = port_report(kind, backend="cpu")
    assert theirs["ok"], theirs["problems"]
    assert ours["ok"] == theirs["ok"], ours["problems"]
    assert ours["injected"] == theirs["injected"]
    assert ours["identical"] == theirs["identical"]
    assert ours["plan"] == theirs["plan"]
    if kind == "crash":
        # serve.dispatch visits = the batches two workers formed: thread
        # timing, in either package; the injections are the plan's
        assert ({s: v["injected"] for s, v in ours["sites"].items()}
                == {s: v["injected"] for s, v in theirs["sites"].items()})
    else:
        assert ours["sites"] == theirs["sites"]
    assert _recovery(ours) == _recovery(theirs)
    assert runner._reconcile(runner.plan_for_kind(kind, 0),
                             ours["counters"]) == []


def test_subprocess_fleet_drill_matches_the_jax_drill():
    """The real-SIGKILL fleet drill: the same ok, injections, per-site
    snapshot and reconciled router counters as the JAX drill; no
    worker_main child is left in either package."""
    from image_analogies_tpu.chaos import runner as jrunner
    from image_analogies_tpu.serve import transport as jtransport

    theirs = jrunner.run_drill(
        jrunner.plan_for_kind("fleet_death_subprocess", 0))
    ours = port_report("fleet_death_subprocess")
    assert ours["ok"] == theirs["ok"] is True, ours["problems"]
    assert ours["injected"] == theirs["injected"] == 1
    assert ours["sites"] == theirs["sites"]
    want = ("router.deaths", "router.handoffs", "router.spills",
            "router.resubmitted", "router.hop_disconnects",
            "router.hop_faults")
    assert ({k: ours["counters"].get(k) for k in want}
            == {k: theirs["counters"].get(k) for k in want})
    assert _recovery(ours) == _recovery(theirs)
    assert ours["disk"]["home"]["states"] == theirs["disk"]["home"]["states"]
    assert jtransport.reap_orphans() == 0
    assert transport.live_workers() == [] and transport.reap_orphans() == 0


def test_chaos_telemetry_in_report_and_trace(tmp_path):
    """An injection under an observed run surfaces in the port's ``ia
    report`` chaos section and on its trace's chaos track."""
    from image_analogies_tpu_torch.config import AnalogyParams
    from image_analogies_tpu_torch.obs import export as obs_export
    from image_analogies_tpu_torch.obs import report as obs_report
    from image_analogies_tpu_torch.obs import trace as obs_trace

    log = str(tmp_path / "run.jsonl")
    params = AnalogyParams(backend="cpu", device="cpu", metrics=True,
                           log_path=log)
    plan = ChaosPlan(seed=0, sites=(
        ("level.dispatch", SiteRule(kind="latency", p=1.0,
                                    latency_ms=0.0)),))
    with obs_trace.run_scope(params):
        with inject.plan_scope(plan):
            inject.site("level.dispatch", level=0)

    an = obs_report.analyze(obs_report.load_records(log))
    assert an["chaos"]["injected"] == 1
    assert an["chaos"]["by_site"] == {"level.dispatch": 1}
    assert an["chaos"]["by_kind"] == {"latency": 1}
    assert "chaos:" in obs_report.report(log)
    out = str(tmp_path / "trace.json")
    obs_export.export_trace(log, out)
    with open(out) as f:
        trace = json.load(f)
    hits = [e for e in trace["traceEvents"]
            if e.get("tid") == obs_export.CHAOS_TID and e["ph"] == "i"]
    assert [e["name"] for e in hits] == ["inject latency @level.dispatch"]


def test_flash_crowd_drill_matches_the_jax_drill():
    """The elastic-fleet surge on the host oracle in both packages: one
    injected transient, the same plan, every answer its clean run's bits,
    the fleet back at its floor, only the viral style throttled, a worker
    killed and handed off; the port's drill ok."""
    from image_analogies_tpu.chaos import runner as jrunner

    theirs = jrunner.run_drill(jrunner.plan_for_kind("flash_crowd", 0))
    ours = runner.run_drill(runner.plan_for_kind("flash_crowd", 0),
                            device="cpu", backend="cpu")
    assert ours["ok"], ours["problems"]
    # the JAX drill's one known flake, its settle race (ROADMAP Queue 3,
    # "Observed in the reference"), is all it may report
    race = re.compile(r"control\.scale_down=\d+ != \d+ events")
    assert all(race.fullmatch(p) for p in theirs["problems"]), \
        theirs["problems"]
    for rep in (ours, theirs):
        assert rep["killed"] is not None and rep["handoffs"]
        assert list(rep["outcomes"]["quota_throttled"]) == ["s0"]
    assert ours["plan"] == theirs["plan"]
    assert ours["injected"] == theirs["injected"] == 1
    assert ({s: v["injected"] for s, v in ours["sites"].items()}
            == {s: v["injected"] for s, v in theirs["sites"].items()})
    assert ours["identical"] is theirs["identical"] is True
    assert ours["final_size"] == theirs["final_size"] == 1
    chaos_counters = [{k: v for k, v in rep["counters"].items()
                       if k.startswith("chaos.")} for rep in (ours, theirs)]
    assert chaos_counters[0] == chaos_counters[1]


_UP, _DOWN = "scale_up", "scale_down"


@pytest.mark.parametrize("sizes,settled", [
    ([], False),
    ([(_UP, 2), (_UP, 3), (_DOWN, 2)], False),
    ([(_UP, 2), (_UP, 3), (_DOWN, 2), (_DOWN, 1)], True),
    ([(_UP, 2), (_DOWN, 1), (_UP, 2)], False),  # the JAX wait: True
    ([(_UP, 2), (_DOWN, 1), (_UP, 2), (_DOWN, 1)], True),
])
def test_flash_crowd_settles_on_the_last_retirement(sizes, settled):
    """The drill snapshots its scale events once the last verdict is the
    retirement that reached the floor, not an earlier one."""
    events = [{"verdict": v, "size": n, "worker": f"w{n}"} for v, n in sizes]
    assert runner._settled_at_floor(events, 1) is settled


SITE_MODULES = {
    "level.dispatch": "models/analogy.py",
    "devcache.upload": "utils/devcache.py",
    "devcache.tier": "catalog/tiers.py",
    "match.prefilter": "backends/cuda.py",
    "ckpt.save": "utils/checkpoint.py",
    "ckpt.load": "utils/checkpoint.py",
    "serve.admit": "serve/queue.py",
    "serve.dispatch": "serve/worker.py",
    "serve.journal": "serve/journal.py",
    "engine.batch": "batch/engine.py",
    "mesh.step": "parallel/step.py",
    "router.forward": "serve/router.py",
    "archive.append": "obs/archive.py",
}


def test_every_known_site_is_wired_where_the_jax_package_has_it():
    """Each of the thirteen sites is called once in the port, in the
    module that is the counterpart of the JAX call's, and nowhere else."""
    import image_analogies_tpu as jpkg
    import image_analogies_tpu_torch as pkg

    assert set(SITE_MODULES) == set(chaos.KNOWN_SITES)
    calls = {}
    for root_pkg in (pkg, jpkg):
        root = os.path.dirname(root_pkg.__file__)
        for d, _, names in os.walk(root):
            for n in names:
                if n.endswith(".py") and os.sep + "chaos" not in d:
                    rel = os.path.relpath(os.path.join(d, n), root)
                    with open(os.path.join(d, n)) as f:
                        for name in re.findall(
                                r"chaos\.site\(\s*\"([a-z._]+)\"",
                                f.read()):
                            calls.setdefault((root_pkg.__name__, name),
                                             []).append(rel)
    for name, mod in SITE_MODULES.items():
        ours = calls.get(("image_analogies_tpu_torch", name))
        theirs = calls.get(("image_analogies_tpu", name))
        assert ours == [mod], (name, ours)
        assert theirs and len(theirs) == 1, (name, theirs)


def test_chaos_package_grep_lock():
    """chaos/ imports neither jax nor the JAX package (the engine is
    reached through lazy imports inside the drills)."""
    import image_analogies_tpu_torch.chaos as pkg

    root = os.path.dirname(pkg.__file__)
    names = sorted(n for n in os.listdir(root) if n.endswith(".py"))
    assert names == ["__init__.py", "drills.py", "faults.py", "inject.py",
                     "plan.py", "runner.py"]
    bad = re.compile(r"^\s*(import jax|from jax|import image_analogies_tpu\b"
                     r"|from image_analogies_tpu[ .])", re.MULTILINE)
    for name in names:
        with open(os.path.join(root, name)) as f:
            assert not bad.findall(f.read()), name
