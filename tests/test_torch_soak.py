"""The port's soak harness (``soak/``, ``serve/loadgen.arrival_schedule``,
``ia soak``) on the CPU, held to the JAX package's ``soak/``.

Against the JAX package, exactly (tolerance 0):

- ``arrival_schedule`` gives the JAX function's offsets, and the pinned
  offsets of ``tests/test_soak.py``;
- ``TraceSpec`` round-trips; ``smoke_spec``, ``full_spec`` and a hand-made
  spec serialize to the JAX dicts, replay to the JAX arrivals and stream
  digests;
- ``audit_indices`` and ``default_plan(seed).to_dict()`` are the JAX ones;
- ``evaluate`` and ``render`` on the same synthetic fact documents give
  equal verdict lists and equal text, case by case (the facts of
  ``tests/test_soak.py`` and more, one invariant reddened each).

The port's own runs, on ``device="cpu"`` (the soak serves on the host
oracle in either package, so no kernel runs on any device):

- the smoke soak is green twice with identical verdicts, kills one worker
  twice, autocompacts its corpse, and runs no kernel;
- a hostile plan reddens the gate with a loss and a culprit that
  ``journal.reconstruct`` (``ia why``) finds in the kept workdir;
- ``ia soak`` exits 0 on a green gate and 2 on a bad or missing spec;
- the kill schedule's repair (``soak/driver.py _kill``): the same worker
  dies at every kill and the driver waits for its handoff, whatever the
  live size (a stub fleet of 1, 2 and 3 workers), and the smoke soak
  stays green with the fleet held at 2 and at 3 workers.  The JAX
  driver's rule (``victims[len(kills) % len(victims)]``, no wait) fails
  both.

Every test runs under a hard SIGALRM budget (the ``tests/test_soak.py``
idiom) that reaps any worker child on the way out.
"""

import json
import signal
import threading
import time

import pytest

from image_analogies_tpu_torch.chaos.plan import ChaosPlan, SiteRule
from image_analogies_tpu_torch.serve import transport
from image_analogies_tpu_torch.soak import driver as soak_driver
from image_analogies_tpu_torch.soak import invariants as soak_invariants
from image_analogies_tpu_torch.soak.trace import (TraceSpec, full_spec,
                                                  smoke_spec)

BUDGET_S = 180


@pytest.fixture(autouse=True)
def _hard_timeout(tmp_path, monkeypatch):
    """Per-test wall-clock ceiling; a wedged fleet raises here instead of
    hanging the suite.  Each test reads a tune store of its own."""
    monkeypatch.setenv("IA_TUNE_STORE", str(tmp_path / "own_tune.json"))
    monkeypatch.delenv("IA_CATALOG_DIR", raising=False)
    monkeypatch.delenv("IA_ARCHIVE_DIR", raising=False)

    def _boom(signum, frame):  # noqa: ARG001 - signal API
        transport.reap_orphans()
        raise TimeoutError(f"soak test exceeded its {BUDGET_S} s budget")

    old = signal.signal(signal.SIGALRM, _boom)
    signal.alarm(BUDGET_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)
    transport.reap_orphans()


def _jax():
    from image_analogies_tpu.serve import loadgen as jloadgen
    from image_analogies_tpu.soak import driver as jdriver
    from image_analogies_tpu.soak import invariants as jinvariants
    from image_analogies_tpu.soak import trace as jtrace

    return jloadgen, jtrace, jdriver, jinvariants


# ------------------------------------------------------- traffic model


def test_arrival_schedule_delegates_and_matches_the_jax_function():
    from image_analogies_tpu_torch.serve import loadgen

    jloadgen = _jax()[0]
    sched = loadgen.arrival_schedule(50, t0=0.2, duration=1.0, mult=20.0,
                                     base_rps=30.0, seed=7)
    assert [round(t, 6) for t in sched[:3]] == [0.00164, 0.054923,
                                                0.058585]
    assert sched == TraceSpec(seed=7, requests=50, base_rps=30.0,
                              flash_crowds=((0.2, 1.0, 20.0),)).arrivals()
    for kw in (dict(n=50, t0=0.2, duration=1.0, mult=20.0, base_rps=30.0,
                    seed=7),
               dict(n=38, t0=0.2, duration=1.0, mult=20.0, base_rps=30.0,
                    seed=0),
               dict(n=200, t0=0.0, duration=3.5, mult=1.0, seed=123),
               dict(n=0, t0=1.0, duration=1.0, mult=4.0)):
        n = kw.pop("n")
        assert loadgen.arrival_schedule(n, **kw) \
            == jloadgen.arrival_schedule(n, **kw)


def test_trace_spec_roundtrip_and_rejection(tmp_path):
    spec = smoke_spec(seed=11)
    again = TraceSpec.from_dict(json.loads(json.dumps(spec.to_dict())))
    assert again == spec
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec.to_dict()))
    assert TraceSpec.load(str(path)) == spec

    with pytest.raises(ValueError, match="unknown trace spec field"):
        TraceSpec.from_dict({"requests": 4, "warp_factor": 9})
    with pytest.raises(ValueError, match="unknown session kind"):
        TraceSpec(sessions=(("streaming", 1.0),))
    with pytest.raises(ValueError, match="flash crowd"):
        TraceSpec(flash_crowds=((0.0, 1.0, 0.5),))


SPECS = {
    "smoke7": lambda m: m.smoke_spec(seed=7),
    "smoke8": lambda m: m.smoke_spec(seed=8),
    "full7": lambda m: m.full_spec(seed=7),
    "full13": lambda m: m.full_spec(seed=13),
    "hand": lambda m: m.TraceSpec(
        name="hand", seed=3, requests=40, shapes=((12, 12), (16, 16)),
        zipf=0.8, styles=4, base_rps=25.0, flash_crowds=((0.5, 1.0, 4.0),),
        diurnal_period_s=2.0, diurnal_amplitude=0.5,
        sessions=(("oneshot", 2.0), ("batch", 1.0)), kill_every=7,
        audit=5),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_arrivals_digest_audit_and_plan_equal_the_jax_ones(name):
    """The same spec: the same dict, arrivals, stream digest (content,
    sessions, priorities, deadlines), audit subset and default plan."""
    from image_analogies_tpu_torch.soak import trace

    _, jtrace, jdriver, _ = _jax()
    ours, theirs = SPECS[name](trace), SPECS[name](jtrace)
    assert ours.to_dict() == theirs.to_dict()
    assert TraceSpec.from_dict(theirs.to_dict()) == ours
    assert ours.arrivals() == theirs.arrivals()
    assert ours.stream_digest() == theirs.stream_digest()
    assert soak_driver.audit_indices(ours) == jdriver.audit_indices(theirs)
    assert soak_driver.default_plan(ours.seed).to_dict() \
        == jdriver.default_plan(theirs.seed).to_dict()


def test_stream_digest_replayable_and_seed_sensitive():
    a, b = smoke_spec(seed=7), smoke_spec(seed=7)
    assert a.arrivals() == b.arrivals()
    assert a.stream_digest() == b.stream_digest()
    assert a.stream_digest() != smoke_spec(seed=8).stream_digest()
    assert a.rate_at(0.3) > a.rate_at(0.0) * 2


def test_soak_spec_inline_chaos_is_validated():
    spec = TraceSpec(requests=2, chaos={
        "seed": 1, "sites": {"no.such.site": {"kind": "transient",
                                              "p": 1.0}}})
    with pytest.raises(ValueError, match="no.such.site"):
        soak_driver.run(spec, device="cpu")


# ------------------------------------------------ invariant pure functions


def _facts(**kw):
    base = {"submitted": 4, "answered": 4, "rejected": {}, "errors": {},
            "journals": {}, "audit": {}, "resubmits": 1,
            "resubmit_identical": True, "kills": [], "handoffs": [],
            "sites": {}, "archive": {"quarantined": 0},
            "latencies_ms": [5.0, 6.0, 7.0, 8.0], "counters": {},
            "wall_s": 1.25}
    base.update(kw)
    return base


_KILLS = [{"worker": "w0", "at": 9}, {"worker": "w0", "at": 18}]
FACTS = {
    "clean": _facts(),
    "shed": _facts(answered=2, rejected={"queue_full": 2}),
    "hard_and_errors": _facts(answered=2, rejected={"poison": 1},
                              errors={3: "TimeoutError"}),
    "error_culprit": _facts(answered=3, errors={2: "TimeoutError"}),
    "poisoned": _facts(journals={"w0": {"poisoned": ["syn-3-1"],
                                        "segments": 1, "compacted": {}}}),
    "ceiling": _facts(counters={"obs.ceiling.alarms": 1,
                                "obs.ceiling.proc.rss_bytes": 1}),
    "fat_journal": _facts(journals={"w0": {"poisoned": [], "segments": 3,
                                           "compacted": {}}}),
    "compact_error": _facts(journals={"w1": {
        "poisoned": [], "segments": 1,
        "compacted": {"error": "journal active"}}}),
    "audit_mismatch": _facts(audit={0: "ok", 1: "mismatch",
                                    2: "degraded", 3: "unanswered"}),
    "empty": _facts(latencies_ms=[], answered=0, submitted=0),
    "over_bound": _facts(latencies_ms=[5.0, 6.0, 90_000.0]),
    "resubmit_differs": _facts(resubmit_identical=False, resubmits=2),
    "repeat_kill_no_compact": _facts(
        kills=_KILLS, handoffs=[{}, {}],
        counters={"serve.journal.autocompact_skipped": 2}),
    "repeat_kill_compacted": _facts(
        kills=_KILLS, handoffs=[{}, {}],
        counters={"serve.journal.autocompact": 1,
                  "serve.journal.autocompact_skipped": 1}),
    "kills_without_handoff": _facts(
        kills=_KILLS, handoffs=[{}],
        counters={"serve.journal.autocompact": 1,
                  "serve.journal.autocompact_skipped": 1}),
    "silent_required_site": _facts(sites={
        "level.dispatch": {"injected": 2, "visits": 9}}),
    "unreconciled": _facts(
        sites={"devcache.tier": {"injected": 3},
               "archive.append": {"injected": 1},
               "level.dispatch": {"injected": 4}},
        counters={"catalog.chaos_evictions": 2, "catalog.disk.hits": 1,
                  "level_retry": 3}),
    "reconciled": _facts(
        sites={"devcache.tier": {"injected": 3},
               "archive.append": {"injected": 1},
               "level.dispatch": {"injected": 4},
               "router.forward": {"injected": 2}},
        archive={"quarantined": 1},
        counters={"catalog.chaos_evictions": 3, "catalog.disk.hits": 2,
                  "catalog.builds": 1, "level_retry": 4}),
}


@pytest.mark.parametrize("case", sorted(FACTS))
def test_evaluate_and_render_equal_the_jax_gate(case):
    """Each synthetic fact document through both gates: equal verdict
    lists (names, oks, details, culprits), p99.9, loss, and report text."""
    _, jtrace, jdriver, jinvariants = _jax()
    spec = TraceSpec(name="syn", seed=3, requests=4, audit=0, kill_every=9)
    jspec = jtrace.TraceSpec(name="syn", seed=3, requests=4, audit=0,
                             kill_every=9)
    facts = FACTS[case]
    ours = soak_invariants.evaluate(spec, soak_driver.default_plan(3),
                                    facts)
    theirs = jinvariants.evaluate(jspec, jdriver.default_plan(3), facts)
    assert ours == theirs
    assert soak_invariants.p999_ms(facts) == jinvariants.p999_ms(facts)
    assert soak_invariants.lost(facts) == jinvariants.lost(facts)
    result = {"ok": all(v["ok"] for v in ours), "facts": facts,
              "verdicts": ours, "p999_ms": soak_invariants.p999_ms(facts),
              "loss": soak_invariants.lost(facts)}
    assert soak_invariants.render(result) == jinvariants.render(result)


def test_invariants_on_synthetic_facts():
    """The verdicts ``tests/test_soak.py`` pins, on the port's gate."""
    spec = TraceSpec(name="syn", seed=3, requests=4, audit=0)
    plan = soak_driver.default_plan(3)

    def by_name(facts):
        return {v["name"]: v for v in
                soak_invariants.evaluate(spec, plan, facts)}

    assert soak_invariants.lost(FACTS["shed"]) == 0
    assert soak_invariants.lost(FACTS["hard_and_errors"]) == 2
    v = by_name(FACTS["error_culprit"])
    assert not v["zero_loss"]["ok"]
    assert v["zero_loss"]["culprit"] == "syn-3-2"
    v = by_name(FACTS["poisoned"])
    assert not v["no_poison"]["ok"] and \
        v["no_poison"]["culprit"] == "syn-3-1"
    assert not by_name(FACTS["ceiling"])["no_ceiling_alarms"]["ok"]
    assert not by_name(FACTS["fat_journal"])["journal_bounded"]["ok"]
    v = by_name(FACTS["audit_mismatch"])
    assert not v["bit_identity"]["ok"]
    assert v["bit_identity"]["culprit"] == "syn-3-1"
    assert not by_name(FACTS["empty"])["p999_bound"]["ok"]
    assert not by_name(FACTS["clean"])["chaos_armed"]["ok"]  # no injection
    assert all(v["ok"] for v in by_name(FACTS["reconciled"]).values())


# ----------------------------------------------- the kill schedule repair


class _StubHandle:
    def __init__(self, on_kill):
        self.dead = False
        self._on_kill = on_kill

    def kill(self):
        self.dead = True
        self._on_kill()


class _StubFleet:
    """``live`` workers; a killed worker is handed off to a replacement
    (same wid, a new handle) ``delay_s`` later, as the health loop does."""

    def __init__(self, live, delay_s=0.15):
        self.handoffs = []
        self.workers = {}
        self._delay_s = delay_s
        for i in range(live):
            self._spawn(f"w{i}")

    def _spawn(self, wid):
        self.workers[wid] = _StubHandle(lambda: self._died(wid))

    def _died(self, wid):
        def replace():
            time.sleep(self._delay_s)
            self._spawn(wid)
            self.handoffs.append({"worker": wid})

        threading.Thread(target=replace, daemon=True).start()


@pytest.mark.parametrize("live", [1, 2, 3])
def test_kill_schedule_does_not_read_the_live_size(live):
    """Two kills, whatever the live size: the same worker dies both times
    (a repeat kill leaves a multi-segment corpse to autocompact), and each
    kill returns only once its replacement serves (the next submit finds
    a live worker).  The JAX rule kills another worker at 2 and 3 live
    workers and returns before the handoff at any size."""
    fl = _StubFleet(live)
    kills = []
    for at in (9, 18):
        old = dict(fl.workers)
        wid = soak_driver._kill(fl, kills, at)
        assert old[wid].dead
        assert len(fl.handoffs) == len(kills)
        assert not any(h.dead for h in fl.workers.values())
        assert sorted(fl.workers) == sorted(old)
    assert [k["worker"] for k in kills] == ["w0", "w0"]
    assert [k["at"] for k in kills] == [9, 18]


# --------------------------------------------------------- live soak gate


def _assert_green(res):
    report = soak_invariants.render(res)
    assert res["ok"], report
    return report


def _launches(counters):
    return {k: v for k, v in counters.items() if k.startswith("launch.")}


def test_smoke_soak_gate_passes_and_replays_identically():
    """The tier-1 soak on the CPU: chaos armed throughout, two seeded
    kills of one worker, every invariant green, twice, with identical
    verdicts; no kernel launched."""
    first = soak_driver.run(smoke_spec(), device="cpu")
    assert "PASS" in _assert_green(first)
    facts = first["facts"]
    assert len(facts["kills"]) >= 2
    assert len({k["worker"] for k in facts["kills"]}) == 1
    assert len(facts["handoffs"]) >= len(facts["kills"])
    for site in soak_driver.REQUIRED_SITES:
        assert facts["sites"].get(site, {}).get("injected", 0) >= 1, \
            facts["sites"]
    assert facts["archive"]["quarantined"] >= 1
    assert first["loss"] == 0 and first["p999_ms"] is not None
    counters = facts["counters"]
    autoc = counters.get("serve.journal.autocompact", 0)
    skipped = counters.get("serve.journal.autocompact_skipped", 0)
    assert autoc >= 1 and autoc + skipped >= len(facts["kills"])
    assert all(doc["segments"] <= 1 for doc in facts["journals"].values())
    # the engine's counters reach the facts (the level retries the
    # injected transients caused), and no kernel ran
    assert counters.get("level_retry", 0) >= 1
    assert _launches(counters) == {}

    second = soak_driver.run(smoke_spec(), device="cpu")
    _assert_green(second)
    assert [(v["name"], v["ok"]) for v in first["verdicts"]] \
        == [(v["name"], v["ok"]) for v in second["verdicts"]]
    # the same kill points, each run's on one worker (which one the
    # autoscaler's retirements decide: w0, or w1 where w0 was retired)
    kills2 = second["facts"]["kills"]
    assert [k["at"] for k in kills2] == [k["at"] for k in facts["kills"]]
    assert len({k["worker"] for k in kills2}) == 1


@pytest.mark.parametrize("live", [2, 3])
def test_smoke_soak_is_green_at_a_held_fleet_size(live, monkeypatch):
    """The fleet held at ``live`` workers (policy floor = ceiling): the
    kills still land on one worker, its corpse is autocompacted, nothing
    is lost.  Under the JAX rule the second kill hits w1."""
    from image_analogies_tpu_torch.serve import policy as serve_policy

    real = serve_policy.ControlPolicy

    def held(**kw):
        return real(**dict(kw, min_workers=live, max_workers=live))

    monkeypatch.setattr(serve_policy, "ControlPolicy", held)
    res = soak_driver.run(smoke_spec(), device="cpu")
    _assert_green(res)
    facts = res["facts"]
    assert [k["worker"] for k in facts["kills"]] == ["w0", "w0"]
    assert facts["final_size"] == live
    assert res["loss"] == 0
    assert facts["counters"].get("serve.journal.autocompact", 0) >= 1


def test_soak_gate_fails_loudly_with_why_linkable_culprit(tmp_path):
    """Every dispatch crashes: the gate is red, work is lost, and the
    culprit reconstructs from the kept workdir."""
    from image_analogies_tpu_torch.serve import journal as serve_journal

    spec = TraceSpec(name="hostile", seed=3, requests=6, shapes=((12, 12),),
                     base_rps=200.0, sessions=(("oneshot", 1.0),), audit=2)
    plan = ChaosPlan(seed=3, sites=(
        ("serve.dispatch", SiteRule(kind="crash", p=1.0)),),
        name="hostile").validate_sites()
    workdir = tmp_path / "run"
    res = soak_driver.run(spec, workdir=str(workdir), plan=plan,
                          device="cpu")
    assert not res["ok"]
    assert res["loss"] > 0
    culprits = [v["culprit"] for v in res["verdicts"] if v.get("culprit")]
    assert culprits and all(c.startswith("hostile-3-") for c in culprits)
    root = res["facts"]["journal_root"]
    assert root and root.startswith(str(workdir))
    why = serve_journal.reconstruct(culprits[0], root)
    assert why["found"] and why["workers"]
    assert f"ia why {culprits[0]}" in soak_invariants.render(res)


def test_cli_soak_exit_codes(tmp_path, capsys):
    from image_analogies_tpu_torch.cli import main

    rc = main(["soak", "--seed", "7", "--json", "--device", "cpu"])
    captured = capsys.readouterr()
    assert rc == 0, captured.out
    assert "ia soak: PASS" in captured.out
    doc = json.loads(captured.err)
    assert doc["ok"] and doc["workload"] == "soak" and doc["loss"] == 0

    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"requests": 4, "warp_factor": 9}))
    assert main(["soak", "--spec", str(bad), "--device", "cpu"]) == 2
    assert main(["soak", "--spec", str(tmp_path / "missing.json"),
                 "--device", "cpu"]) == 2
    assert "bad spec" in capsys.readouterr().err


def test_chip_smoke_soak_side_times_its_runs_before_its_card_part(
        monkeypatch, tmp_path):
    """``chip_smoke.py``'s soak side runs its three timed soaks at once
    (the script starts it before the other side phases fill the host),
    and its card part (the logged npr_1024 runs for ``ia report``) and
    the readers only once ``card_after`` exists (the script creates it
    when the other side phases start)."""
    import tempfile

    import chip_smoke

    window = tmp_path / "open"
    order = []

    def soak_run(label, args, tmp):
        order.append((label, window.exists()))
        if label == "full":  # the window opens later
            threading.Timer(0.3, window.touch).start()
        return {"verdicts": [], "p999_ms": 1.0,
                "facts": {"spec": {"p999_bound_ms": 2.0}}}

    monkeypatch.setattr(chip_smoke, "soak_run", soak_run)
    for name in ("soak_reports", "soak_archive_top", "soak_blackbox"):
        monkeypatch.setattr(
            chip_smoke, name,
            lambda *a, name=name: order.append((name, window.exists())))
    monkeypatch.setattr(chip_smoke, "nvidia_smi", lambda: "cpu")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    chip_smoke.phase_soak(None, None, None, str(window))
    assert order == [("smoke_1", False), ("smoke_2", False),
                     ("full", False), ("soak_reports", True),
                     ("soak_archive_top", True), ("soak_archive_top", True),
                     ("soak_blackbox", True)]


def test_chip_smoke_counts_only_its_own_groups_worker_mains():
    """``chip_smoke.py``'s serve and chaos sides check that no
    ``worker_main`` is left once their fleets have ended, while the other
    side phases run beside them, each in a process group of its own: a
    side counts the ``worker_main`` processes of its own group (a fleet's
    children keep it), not another side's live fleet; main counts the
    whole machine once every side has exited."""
    import subprocess
    import sys

    import chip_smoke

    sleeper = [sys.executable, "-c", "import time; time.sleep(60)",
               chip_smoke.WORKER_MAIN]
    mine = subprocess.Popen(sleeper)
    other = subprocess.Popen(sleeper, process_group=0)
    try:
        deadline = time.monotonic() + 30
        while not {mine.pid, other.pid} <= set(
                chip_smoke.worker_main_pids(own_group=False)):
            assert time.monotonic() < deadline, "the sleepers never started"
            time.sleep(0.05)
        own = chip_smoke.worker_main_pids()
        assert mine.pid in own and other.pid not in own
    finally:
        for proc in (mine, other):
            proc.kill()
            proc.wait(timeout=30)
    assert not {mine.pid, other.pid} & set(
        chip_smoke.worker_main_pids(own_group=False))
