"""Drill runner — ``ia chaos``: run workloads under fault plans and
assert the resilience invariants (the port's copy of the JAX package's
``chaos/runner.py``).

Every drill takes the ``device`` (``"cuda"`` unless the caller asks for
the CPU) and runs the device matcher there (``chaos/drills.py`` maps the
JAX drills' backends); the image and serve drills also take ``backend``
(``"cpu"``: the host oracle, where a report is held to the JAX drill's).

A drill is: clean reference run (disarmed) → chaos run (armed plan) →
invariant checks.  The invariants are the PR's acceptance criteria, not
soft goals:

- **bit-identical output** — recovery must reproduce the clean run's
  planes exactly (the engine is deterministic on one device, so equality
  is the right assertion);
- **nothing lost** — every serve submit resolves to exactly one of
  ok / degraded / timeout / rejected, the queue drains, worker threads
  survive;
- **counters reconcile** — every injection is visible in the recovery
  counters it caused (retries, watchdog timeouts, quarantines, worker
  crashes).  An injection that no counter accounts for means a fault
  path silently swallowed something.

``selftest`` runs one canonical drill per fault kind plus a
schedule-determinism check (same seed ⇒ same fault schedule).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from image_analogies_tpu_torch.chaos import drills, inject
from image_analogies_tpu_torch.chaos.plan import ChaosPlan, SiteRule

# Fault kind -> canonical drill plan.  Schedules (not probabilities) so
# each selftest drill injects exactly once at a known visit.
_KIND_NOTES = {
    "transient": "level retry absorbs an injected transient",
    "oom": "a torch.cuda.OutOfMemoryError classifies transient via the "
           "real path",
    "latency": "watchdog converts a wedged dispatch into a retry",
    "corrupt": "checksum catches damaged checkpoint; quarantine+recompute",
    "crash": "worker crash containment requeues the batch",
    "process_death": "journal replay answers every admitted request "
                     "exactly once after kill+restart",
    "fleet_death": "router hands a dead worker's journal to its "
                   "replacement; spillover + dedupe answer exactly once",
    "fleet_death_subprocess": "REAL SIGKILL of a subprocess worker "
                              "mid-batch; replacement sweeps the foreign "
                              "stale lock, replays, and every request "
                              "answers exactly once",
    "batch_partial": "one lane faults mid-batch; the other lanes resolve "
                     "bit-identically",
    "devcache_tier": "mid-request catalog tier eviction falls through to "
                     "disk/rebuild bit-identically",
    "ann_corrupt": "sealed ANN basis damaged mid-request; quarantine + "
                   "exact fallback + rebuild, bit-identically",
    "archive_torn": "torn sealed archive segment quarantined at read, "
                    "valid prefix survives; disk-full drops counted, "
                    "never raised",
    "flash_crowd": "Zipf surge scales the fleet up under policy, a "
                   "worker dies mid-surge, the idle fleet shrinks back; "
                   "exactly-once, viral tenant throttles itself",
}

# What `selftest` (and the tests' parametrization) iterates: every raw
# fault kind plus the composite drills — fleet_death arms TWO sites
# (process_death at serve.journal, transient at router.forward) and
# batch_partial targets the lane engine's per-lane boundary — which are
# drill names rather than members of FAULT_KINDS.
def _drill_kinds():
    from image_analogies_tpu_torch.chaos import FAULT_KINDS
    return tuple(FAULT_KINDS) + ("fleet_death", "fleet_death_subprocess",
                                 "batch_partial", "devcache_tier",
                                 "ann_corrupt", "archive_torn",
                                 "flash_crowd")


DRILL_KINDS = _drill_kinds()


def plan_for_kind(kind: str, seed: int = 0) -> ChaosPlan:
    if kind == "transient":
        sites = (("level.dispatch", SiteRule(kind="transient",
                                             schedule=(0,))),)
    elif kind == "oom":
        sites = (("level.dispatch", SiteRule(kind="oom", schedule=(1,))),)
    elif kind == "latency":
        # 2s hang vs the drill's 0.5s watchdog: the margin must be wide
        # in BOTH directions — the hang well above the watchdog so it
        # always trips, and the watchdog well above a legitimate tiny
        # dispatch so a loaded CI box can't trip it spuriously (a
        # spurious timeout exhausts the retry budget and flakes the
        # drill; seen at 200ms/50ms).
        sites = (("level.dispatch", SiteRule(kind="latency", schedule=(0,),
                                             latency_ms=2000.0, hang=True)),)
    elif kind == "corrupt":
        sites = (("ckpt.save", SiteRule(kind="corrupt", schedule=(0,))),)
    elif kind == "crash":
        sites = (("serve.dispatch", SiteRule(kind="crash", schedule=(0,))),)
    elif kind == "process_death":
        # Kill-restart drill geometry (one worker, max_batch == n == 4,
        # WAL-before-queue): journal visits 0..3 are the four admits,
        # then the worker alternates dispatched/done appends — 4=disp r0,
        # 5=done r0, 6=disp r1, 7=done r1.  Dying at visit 7 leaves one
        # request fully done (dedupe path), one computed but UNRECORDED
        # mid-done (the exactly-once edge: replay must re-run it to the
        # same bytes), and two admitted-only (plain replay).
        sites = (("serve.journal", SiteRule(kind="process_death",
                                            schedule=(7,))),)
    elif kind == "fleet_death":
        # Fleet drill geometry (2 workers, one shared exemplar so all 4
        # requests hash to ONE home worker; max_batch == n == 4): the
        # serve.journal schedule reuses the kill-restart placement —
        # visit 7 is "done r1" on the home worker, leaving one request
        # done, one computed-but-unrecorded, two admitted-only.  The
        # router.forward schedule fires on visit 4: visits 0..3 are the
        # four original routed submits, so the FIRST post-handoff
        # resubmit eats a transient hop fault and must spill to the
        # ring successor (which computes fresh, bit-identically).
        sites = (("serve.journal", SiteRule(kind="process_death",
                                            schedule=(7,))),
                 ("router.forward", SiteRule(kind="transient",
                                             schedule=(4,))))
    elif kind == "fleet_death_subprocess":
        # Subprocess fleet drill geometry: the death is a REAL SIGKILL
        # delivered by the drill itself (no serve.journal site — chaos
        # is armed only in the ROUTER process; the child never sees a
        # plan, which is itself the disarmed-zero-cost contract at
        # work).  router.forward visits 0..3 are the four original
        # routed submits; the post-handoff resubmits start at visit 4,
        # so the FIRST resubmit eats a transient hop fault and must
        # spill to the ring successor (which computes fresh,
        # bit-identically, in its own journal).
        sites = (("router.forward", SiteRule(kind="transient",
                                             schedule=(4,))),)
    elif kind == "devcache_tier":
        # Catalog-tier drill geometry (2 levels, warmed catalog): the
        # devcache.tier site is visited once per level's tier
        # resolution, coarsest level first — firing at BOTH visits
        # evicts each level's warmed entry from the memory tiers the
        # instant the request asks for it, so every level of the armed
        # run must recover through the sealed disk artifact (or a full
        # rebuild) and still produce the clean run's exact bytes.
        sites = (("devcache.tier", SiteRule(kind="corrupt",
                                            schedule=(0, 1))),)
    elif kind == "ann_corrupt":
        # ANN-artifact drill geometry (2 levels, sealed artifacts built
        # ahead of time): the match.prefilter site is visited once per
        # level's projection resolution — and, on a cold parity gate,
        # extra times by the gate's own probe syntheses, whose
        # probe-plane keys have no artifact (the damage helper no-ops on
        # absent paths).  p=1.0 rather than a schedule so EVERY visit of
        # the armed run corrupts regardless of how many probe visits
        # precede it: each level's artifact is damaged the instant the
        # request resolves it, so every level must quarantine, answer on
        # the exact path bit-identically, and re-seal a rebuilt basis.
        sites = (("match.prefilter", SiteRule(kind="corrupt", p=1.0)),)
    elif kind == "archive_torn":
        # Archive drill geometry (per-record segments): archive.append
        # is visited once per sealed record; the corrupt directive at
        # visit 1 tears record 1's segment AFTER a successful-looking
        # write — the torn-tail shape a power cut leaves on disk.  The
        # drill itself arms a second, raising rule at the same site for
        # the disk-full leg (one site carries one rule per plan).
        sites = (("archive.append", SiteRule(kind="corrupt",
                                             schedule=(1,))),)
    elif kind == "flash_crowd":
        # Elastic-fleet drill geometry: the surge, the mid-surge worker
        # kill, and the cool-down retire are all delivered by the drill
        # itself (loadgen arrival schedule + handle.kill + the control
        # plane's own policy).  The one armed site is a transient at a
        # level dispatch mid-surge — absorbed by the engine's level
        # retry — proving local fault recovery still holds while the
        # fleet is actively scaling around it.
        sites = (("level.dispatch", SiteRule(kind="transient",
                                             schedule=(2,))),)
    elif kind == "batch_partial":
        # Batched-engine drill geometry (k=3 lanes, 2 levels): the
        # engine.batch site is visited once per (level, lane), coarsest
        # level first — visits 0..2 are the coarse level's lanes 0..2.
        # Firing at visit 1 kills lane 1 at the COARSEST level, so the
        # drill proves a first-level fault stays contained for the whole
        # remaining coarse-to-fine run, not just the last launch.
        sites = (("engine.batch", SiteRule(kind="transient",
                                           schedule=(1,))),)
    else:
        raise ValueError(f"unknown fault kind {kind!r}")
    return ChaosPlan(seed=seed, sites=sites, name=f"selftest-{kind}")


def _wants_serve(plan: ChaosPlan) -> bool:
    return any(name.startswith("serve.") for name, _ in plan.sites)


def _counters(ctx) -> Dict[str, float]:
    return dict(ctx.registry.snapshot()["counters"]) if ctx else {}


def _reconcile(plan: ChaosPlan, counters: Dict[str, float]) -> List[str]:
    """Per-kind accounting: every injection must be matched by the
    recovery counter it should have caused.  Returns failure strings."""
    problems = []

    def want(name: str, expected: float) -> None:
        got = counters.get(name, 0)
        if got != expected:
            problems.append(f"{name}={got} != expected {expected}")

    by_kind: Dict[str, float] = {}
    for key, val in counters.items():
        if key.startswith("chaos.injected."):
            by_kind[key.split(".", 2)[2]] = val
    injected = counters.get("chaos.injected", 0)
    if sum(by_kind.values()) != injected:
        problems.append("per-kind chaos counters do not sum to total")
    # Expectations come from the PLAN (per-site injection counters x each
    # site's rule), because the same kind recovers differently by
    # placement: transient/oom under the level retry wrapper retry; a
    # hang surfaces as a watchdog timeout first, THEN retries; a plain
    # (non-hang) latency spike recovers by itself; corruption surfaces at
    # load as a quarantine; a crash as a contained worker crash.  A
    # raising kind at a serve batch boundary is contained as a crash
    # regardless of its class — the containment layer can't tell.
    retries = watchdogs = quarantines = crashes = deaths = 0.0
    hop_faults = lane_faults = tier_evictions = ann_faults = 0.0
    archive_faults = 0.0
    for name, rule in plan.sites:
        n = counters.get(f"chaos.site.{name}", 0)
        if not n:
            continue
        if name == "serve.admit":
            continue  # surfaces synchronously to the client; no recovery
        if name == "engine.batch":
            # a faulted lane is ISOLATED, not retried — the lane engine
            # marks the member failed and finishes the other lanes; the
            # only matching evidence is its lane-fault counter
            lane_faults += n
        elif name == "devcache.tier":
            # the "corrupt" directive here is applied as a mid-request
            # memory-tier eviction (NOT file damage): recovery is the
            # tier fall-through, evidenced by the catalog's eviction
            # counter — must be matched before the generic corrupt →
            # ckpt.quarantined accounting below
            tier_evictions += n
        elif name == "archive.append":
            # the corrupt directive tears the sealed segment AFTER a
            # successful-looking write (recovery is the READER's
            # quarantine) and raising kinds model disk-full (recovery
            # is the counted drop); both are the archive's own
            # accounting, checked jointly below — must be matched
            # before the generic corrupt → ckpt.quarantined branch
            archive_faults += n
        elif name == "match.prefilter":
            # the corrupt directive here damages the sealed ANN artifact
            # — but only when one exists at the resolved key (gate-probe
            # visits resolve probe-plane keys with no artifact, where the
            # damage helper no-ops), so the evidence is the quarantine →
            # exact-fallback → rebuild chain checked loosely below, not
            # an equality against the visit count
            ann_faults += n
        elif rule.kind == "process_death":
            # not contained: the worker thread dies; the only matching
            # evidence is the death counter (recovery is the journal's)
            deaths += n
        elif name == "router.forward" and rule.kind in (
                "transient", "oom", "crash"):
            # a raising fault on the hop is absorbed by the router's
            # spillover walk, not a level retry
            hop_faults += n
        elif name in ("serve.dispatch",) and rule.kind in (
                "transient", "oom", "crash"):
            crashes += n
        elif rule.kind in ("transient", "oom"):
            retries += n
        elif rule.kind == "latency" and rule.hang:
            watchdogs += n
            retries += n
        elif rule.kind == "corrupt":
            quarantines += n
        elif rule.kind == "crash":
            crashes += n
    if retries:
        want("level_retry", retries)
    if watchdogs:
        want("watchdog.timeouts", watchdogs)
    if quarantines:
        want("ckpt.quarantined", quarantines)
    if crashes:
        want("serve.worker_crashes", crashes)
    if deaths:
        want("serve.process_deaths", deaths)
    if hop_faults:
        want("router.hop_faults", hop_faults)
    if lane_faults:
        want("batch.lane_faults", lane_faults)
    if tier_evictions:
        want("catalog.chaos_evictions", tier_evictions)
    if archive_faults:
        accounted = (counters.get("obs.archive.quarantined", 0)
                     + counters.get("obs.archive.append_errors", 0))
        if accounted != archive_faults:
            problems.append(
                f"archive.append injected {archive_faults} faults but "
                f"quarantines+drops account for {accounted}")
    if ann_faults:
        quarantined = counters.get("ann.quarantined", 0)
        if not quarantined:
            problems.append(
                "match.prefilter fired but nothing was quarantined")
        if counters.get("ann.fallback_exact", 0) < quarantined:
            problems.append(
                f"{quarantined} ANN quarantines but only "
                f"{counters.get('ann.fallback_exact', 0)} exact fallbacks")
        if counters.get("ann.artifacts_rebuilt", 0) < quarantined:
            problems.append(
                f"{quarantined} ANN quarantines but only "
                f"{counters.get('ann.artifacts_rebuilt', 0)} rebuilds")
    return problems


def drill_image(plan: ChaosPlan, *, seed: int = 7,
                size=(20, 20), workdir: Optional[str] = None,
                device: str = "cuda", backend: str = "cuda"
                ) -> Dict[str, Any]:
    """Single-image drill: clean run, chaos run (and for checkpoint
    corruption a third resume run hitting the quarantine path), then the
    invariants."""
    from image_analogies_tpu_torch.obs import trace as obs_trace

    a, ap, b = drills.make_inputs(size, seed)
    corrupting = any(r.kind == "corrupt" for _, r in plan.sites)
    hanging = any(r.kind == "latency" and r.hang for _, r in plan.sites)

    clean = drills.run_image(a, ap, b, drills.image_params(
        retries=0, device=device, backend=backend))

    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        params = drills.image_params(
            retries=3, device=device, backend=backend,
            checkpoint_dir=os.path.join(tmp, "ckpt"),
            # a hang only recovers when something bounds the wait; give
            # the watchdog a deadline well under the injected latency
            # but far above an honest dispatch (see plan_for_kind)
            dispatch_timeout_s=0.5 if hanging else 0.0)
        with obs_trace.run_scope(params) as ctx:
            with inject.plan_scope(plan):
                chaos_bp = drills.run_image(a, ap, b, params)
                snap = inject.snapshot()
            resumed_bp = None
            if corrupting:
                # resume run (disarmed): hits the damaged file, must
                # quarantine + recompute to the identical result
                resumed_bp = drills.run_image(
                    a, ap, b, params.replace(resume_from_level=0))
            counters = _counters(ctx)

    identical = bool(np.array_equal(clean, chaos_bp))
    if resumed_bp is not None:
        identical = identical and bool(np.array_equal(clean, resumed_bp))
    problems = [] if identical else ["output differs from clean run"]
    problems += _reconcile(plan, counters)
    injected = sum(st["injected"] for st in snap.values())
    if injected == 0:
        problems.append("plan injected nothing (dead drill)")
    return {
        "workload": "image",
        "plan": plan.to_dict(),
        "injected": injected,
        "sites": snap,
        "counters": {k: v for k, v in counters.items()
                     if k.startswith(("chaos.", "level_retry", "retry.",
                                      "watchdog.", "ckpt."))},
        "identical": identical,
        "ok": not problems,
        "problems": problems,
    }


def drill_catalog_tier(plan: ChaosPlan, *, seed: int = 7,
                       size=(20, 20), workdir: Optional[str] = None,
                       device: str = "cuda") -> Dict[str, Any]:
    """Catalog-tier eviction drill: clean run (no catalog) → warm run
    (disarmed, populates every tier + the sealed disk artifacts) →
    armed run whose ``devcache.tier`` directives evict the warmed
    entries MID-REQUEST.  Invariants: the armed run falls through the
    remaining tiers (disk hit or full rebuild) and produces the clean
    run's exact bytes, and every injection reconciles against
    ``catalog.chaos_evictions``.  Every run is the host oracle's
    (``drills.catalog_params``: the only matcher the level loop hands the
    feature tiers to), whatever ``device``."""
    from image_analogies_tpu_torch.catalog import tiers as catalog_tiers
    from image_analogies_tpu_torch.obs import trace as obs_trace

    a, ap, b = drills.make_inputs(size, seed)
    clean = drills.run_image(a, ap, b, drills.image_params(
        retries=0, device=device, backend="cpu"))

    catalog_tiers.clear()
    try:
        with tempfile.TemporaryDirectory(dir=workdir) as tmp:
            params = drills.catalog_params(os.path.join(tmp, "catalog"),
                                           device=device)
            with obs_trace.run_scope(params) as ctx:
                warm_bp = drills.run_image(a, ap, b, params)
                with inject.plan_scope(plan):
                    chaos_bp = drills.run_image(a, ap, b, params)
                    snap = inject.snapshot()
                counters = _counters(ctx)
    finally:
        catalog_tiers.clear()
        catalog_tiers.configure(None)

    identical = bool(np.array_equal(clean, warm_bp)
                     and np.array_equal(clean, chaos_bp))
    problems = [] if identical else ["output differs from clean run"]
    problems += _reconcile(plan, counters)
    if not counters.get("catalog.builds", 0):
        problems.append("warm run recorded no catalog builds")
    evicted = counters.get("catalog.chaos_evictions", 0)
    recovered = (counters.get("catalog.disk.hits", 0)
                 + counters.get("catalog.builds", 0))
    if evicted and recovered < evicted:
        problems.append(
            f"{evicted} evictions but only {recovered} disk-hit/rebuild "
            "recoveries (a hit survived the eviction it should not have)")
    injected = sum(st["injected"] for st in snap.values())
    if injected == 0:
        problems.append("plan injected nothing (dead drill)")
    return {
        "workload": "catalog_tier",
        "plan": plan.to_dict(),
        "injected": injected,
        "sites": snap,
        "counters": {k: v for k, v in counters.items()
                     if k.startswith(("chaos.", "catalog."))},
        "identical": identical,
        "ok": not problems,
        "problems": problems,
    }


def drill_ann_corrupt(plan: ChaosPlan, *, seed: int = 7,
                      size=(20, 20), workdir: Optional[str] = None,
                      device: str = "cuda") -> Dict[str, Any]:
    """ANN-artifact corruption drill: exact reference run → AOT catalog
    build (seals the per-level PCA artifacts) → warm two-stage run
    (disarmed; pays the parity-gate probe and proves the artifacts load)
    → armed run whose ``match.prefilter`` directives flip a byte of each
    level's sealed artifact the instant the request resolves it.
    Invariants: every damaged artifact quarantines (``.corrupt``), every
    quarantined level answers on the exact path — the armed run's output
    is bit-identical to the exact reference — and each quarantine is
    matched by a rebuilt, re-sealed artifact."""
    from image_analogies_tpu_torch.catalog import build as catalog_build
    from image_analogies_tpu_torch.catalog import tiers as catalog_tiers
    from image_analogies_tpu_torch.obs import trace as obs_trace

    a, ap, b = drills.make_inputs(size, seed)
    catalog_tiers.clear()
    try:
        with tempfile.TemporaryDirectory(dir=workdir) as tmp:
            root = os.path.join(tmp, "catalog")
            params = drills.ann_params(root, device=device)
            exact_bp = drills.run_image(
                a, ap, b, params.replace(ann_prefilter=False))
            catalog_build.build_style(a, ap, params, root_dir=root,
                                      target=b)
            with obs_trace.run_scope(params) as ctx:
                # warm two-stage run: output is the gate-audited
                # approximate path, so only its counters are asserted
                drills.run_image(a, ap, b, params)
                with inject.plan_scope(plan):
                    chaos_bp = drills.run_image(a, ap, b, params)
                    snap = inject.snapshot()
                counters = _counters(ctx)
    finally:
        catalog_tiers.clear()
        catalog_tiers.configure(None)

    identical = bool(np.array_equal(exact_bp, chaos_bp))
    problems = [] if identical else ["output differs from exact run"]
    problems += _reconcile(plan, counters)
    if not counters.get("ann.artifact_hits", 0):
        problems.append("warm run never loaded a sealed ANN artifact")
    if not counters.get("ann.quarantined", 0):
        problems.append("armed run quarantined no damaged artifact")
    injected = sum(st["injected"] for st in snap.values())
    if injected == 0:
        problems.append("plan injected nothing (dead drill)")
    return {
        "workload": "ann_corrupt",
        "plan": plan.to_dict(),
        "injected": injected,
        "sites": snap,
        "counters": {k: v for k, v in counters.items()
                     if k.startswith(("chaos.", "ann."))},
        "identical": identical,
        "ok": not problems,
        "problems": problems,
    }


def drill_serve(plan: ChaosPlan, *, n: int = 6, seed: int = 7,
                device: str = "cuda", backend: str = "cuda"
                ) -> Dict[str, Any]:
    """Serve drill: burst-submit n requests under the plan; every future
    must resolve to exactly one known outcome, outputs must match direct
    engine runs, the queue must drain, and counters must reconcile."""
    from image_analogies_tpu_torch.obs import trace as obs_trace
    from image_analogies_tpu_torch.serve.server import Server
    from image_analogies_tpu_torch.serve.types import (DeadlineExceeded,
                                                       Rejected)

    cfg = drills.serve_config(device=device, backend=backend)
    load = drills.make_serve_load(n, seed=seed)
    baseline = {item["index"]: drills.run_image(
        item["a"], item["ap"], item["b"], cfg.params)
        for item in load}

    outcomes: Dict[int, str] = {}
    responses: Dict[int, Any] = {}
    unknown_errors: Dict[int, str] = {}
    with obs_trace.run_scope(cfg.params) as ctx:
        with inject.plan_scope(plan):
            with Server(cfg) as srv:
                futures = {}
                for item in load:
                    try:
                        futures[item["index"]] = srv.submit(
                            item["a"], item["ap"], item["b"])
                    except Exception as exc:  # noqa: BLE001 - admission faults
                        # injected admission faults surface synchronously,
                        # like any admission refusal
                        outcomes[item["index"]] = (
                            "rejected" if isinstance(exc, Rejected)
                            else "submit_fault")
                for idx, fut in futures.items():
                    try:
                        responses[idx] = fut.result(timeout=120)
                        outcomes[idx] = responses[idx].status
                    except Rejected:
                        outcomes[idx] = "rejected"
                    except DeadlineExceeded:
                        outcomes[idx] = "timeout"
                    except BaseException as exc:  # noqa: BLE001 - audited
                        outcomes[idx] = "error"
                        unknown_errors[idx] = repr(exc)
                drained = srv.queue_depth == 0
            snap = inject.snapshot()
        counters = _counters(ctx)

    problems = []
    if len(outcomes) != n:
        problems.append(f"{n - len(outcomes)} requests never resolved")
    if unknown_errors:
        problems.append(f"unexpected errors: {unknown_errors}")
    if not drained:
        problems.append("queue did not drain")
    identical = all(
        np.array_equal(responses[i].bp, baseline[i])
        for i in responses if responses[i].degraded is None)
    if not identical:
        problems.append("served output differs from direct engine run")
    problems += _reconcile(plan, counters)
    injected = sum(st["injected"] for st in snap.values())
    if injected == 0:
        problems.append("plan injected nothing (dead drill)")
    tally: Dict[str, int] = {}
    for o in outcomes.values():
        tally[o] = tally.get(o, 0) + 1
    return {
        "workload": "serve",
        "plan": plan.to_dict(),
        "injected": injected,
        "sites": snap,
        "outcomes": tally,
        "counters": {k: v for k, v in counters.items()
                     if k.startswith(("chaos.", "serve.", "level_retry",
                                      "retry.", "watchdog."))},
        "identical": identical,
        "ok": not problems,
        "problems": problems,
    }


def drill_kill_restart(plan: ChaosPlan, *, n: int = 4, seed: int = 7,
                       device: str = "cuda", backend: str = "cuda"
                       ) -> Dict[str, Any]:
    """Process-death drill: a journaled single-worker server takes a full
    batch; the injected :class:`~chaos.faults.ProcessDeath` kills the
    worker mid-journal-append; the server is torn down NON-gracefully
    (queued and in-flight clients dropped, exactly as a real death drops
    them); a second server on the same journal replays.  Invariants:
    every admitted request is answered exactly once — pre-death responses
    and post-restart resubmissions alike bit-identical to direct engine
    runs — and the journal/replay counters reconcile."""
    from image_analogies_tpu_torch.obs import trace as obs_trace
    from image_analogies_tpu_torch.serve.server import Server

    with tempfile.TemporaryDirectory() as tmp:
        jdir = os.path.join(tmp, "journal")
        # Wide batch window in incarnation 1: the worker must coalesce
        # ALL n submits into one batch for the plan's visit schedule to
        # mean what the geometry comment in plan_for_kind says it means.
        cfg = drills.serve_config(workers=1, max_batch=n,
                                  batch_window_ms=2000.0, journal_dir=jdir,
                                  device=device, backend=backend)
        # Restart pops a < max_batch replay batch; a small window keeps
        # the drill from idling out the full coalescing wait.
        cfg2 = drills.serve_config(workers=1, max_batch=n,
                                   batch_window_ms=50.0, journal_dir=jdir,
                                   device=device, backend=backend)
        load = drills.make_serve_load(n, seed=seed)
        baseline = {item["index"]: drills.run_image(
            item["a"], item["ap"], item["b"], cfg.params)
            for item in load}
        ikey = "kill-restart-{}".format

        problems: List[str] = []
        with obs_trace.run_scope(cfg.params) as ctx:
            # -- incarnation 1: full batch, death mid-append ------------
            inject.arm(plan)
            try:
                srv = Server(cfg).start()
                futures = {}
                for item in load:
                    futures[item["index"]] = srv.submit(
                        item["a"], item["ap"], item["b"],
                        idempotency_key=ikey(item["index"]))
                end = time.monotonic() + 60.0
                while (inject.injected_total() < 1
                       and time.monotonic() < end):
                    time.sleep(0.01)
                srv.kill()
                snap = inject.snapshot()
            finally:
                inject.disarm()
            pre_done = {i: f.result(timeout=0) for i, f in futures.items()
                        if f.done() and f.exception() is None}
            unresolved = [i for i, f in futures.items() if not f.done()]
            if not pre_done:
                problems.append("no request finished before the death")
            if not unresolved:
                problems.append("death left nothing unresolved (dead drill)")

            # -- incarnation 2: same journal, disarmed replay -----------
            srv2 = Server(cfg2).start()
            stats = dict(srv2.recovery_stats or {})
            recovered = srv2.wait_recovered(timeout=120)
            # resubmit EVERY original request under its original key:
            # each must dedupe against the journal's recorded response
            replies = {}
            for item in load:
                replies[item["index"]] = srv2.submit(
                    item["a"], item["ap"], item["b"],
                    idempotency_key=ikey(item["index"])).result(timeout=120)
            srv2.shutdown()
            counters = _counters(ctx)

        bad = {k: v for k, v in recovered.items() if v != "ok"}
        if bad:
            problems.append(f"replayed work did not finish ok: {bad}")
        if stats.get("replayed", 0) != len(unresolved):
            problems.append(
                f"replayed {stats.get('replayed', 0)} entries "
                f"!= {len(unresolved)} unresolved at death")
        identical = all(
            np.array_equal(replies[i].bp, baseline[i]) for i in replies)
        identical = identical and all(
            np.array_equal(resp.bp, baseline[i])
            for i, resp in pre_done.items())
        if not identical:
            problems.append("recovered output differs from clean run")
        # exactly-once ledger: one done record per request, every
        # resubmission answered from it, no request re-admitted
        for name, expect in (("serve.journal.done", n),
                             ("serve.journal.deduped", n),
                             ("serve.journal.admitted", n)):
            got = counters.get(name, 0)
            if got != expect:
                problems.append(f"{name}={got} != expected {expect}")
        problems += _reconcile(plan, counters)
        injected = sum(st["injected"] for st in snap.values())
        if injected == 0:
            problems.append("plan injected nothing (dead drill)")
        return {
            "workload": "kill_restart",
            "plan": plan.to_dict(),
            "injected": injected,
            "sites": snap,
            "recovery": stats,
            "outcomes": {
                "pre_death_ok": len(pre_done),
                "replayed": stats.get("replayed", 0),
                "deduped": int(counters.get("serve.journal.deduped", 0)),
            },
            "counters": {k: v for k, v in counters.items()
                         if k.startswith(("chaos.", "serve."))},
            "identical": identical,
            "ok": not problems,
            "problems": problems,
        }


def drill_fleet(plan: ChaosPlan, *, n: int = 4, seed: int = 7,
                device: str = "cuda", backend: str = "cuda"
                ) -> Dict[str, Any]:
    """Fleet kill-restart drill: 2 routed workers, one shared exemplar so
    all n requests hash to ONE home worker.  The injected
    :class:`~chaos.faults.ProcessDeath` kills the home worker mid-batch;
    the fleet health loop declares it dead, hands its journal directory
    to a replacement (same wid, same ring slot), whose ``recover()``
    replays the incomplete entries while the router re-chains the
    stranded in-flight futures by idempotency key.  Every original
    request must still be answered exactly once, bit-identical to direct
    engine runs.  Then every request is RESUBMITTED under its original
    key: the first resubmit eats a scheduled transient at the new
    ``router.forward`` site and must spill to the ring successor (which
    computes fresh, bit-identically, in its own journal); the rest
    dedupe instantly against the home journal's done records."""
    from image_analogies_tpu_torch.obs import trace as obs_trace
    from image_analogies_tpu_torch.serve.fleet import Fleet
    from image_analogies_tpu_torch.serve.types import FleetConfig

    with tempfile.TemporaryDirectory() as tmp:
        # Wide batch window: the home worker must coalesce all n submits
        # into one batch for the serve.journal visit schedule to mean
        # what plan_for_kind's geometry comment says (same reasoning as
        # drill_kill_restart; one template serves both incarnations, so
        # the replacement's replay batch idles out one window).
        cfg = drills.serve_config(workers=1, max_batch=n,
                                  batch_window_ms=1000.0, device=device,
                                  backend=backend)
        fcfg = FleetConfig(serve=cfg, size=2, vnodes=16,
                           journal_root=os.path.join(tmp, "journals"),
                           health_interval_s=0.05, death_checks=2,
                           backoff_s=0.01, backoff_cap_s=0.05)
        load = drills.make_serve_load(n, seed=seed)
        baseline = {item["index"]: drills.run_image(
            item["a"], item["ap"], item["b"], cfg.params)
            for item in load}
        ikey = "fleet-kill-{}".format

        problems: List[str] = []
        with obs_trace.run_scope(cfg.params) as ctx:
            inject.arm(plan)
            try:
                with Fleet(fcfg) as fl:
                    futures = {}
                    for item in load:
                        futures[item["index"]] = fl.submit(
                            item["a"], item["ap"], item["b"],
                            idempotency_key=ikey(item["index"]))
                    # the scheduled death fires mid-batch on the home
                    # worker; the health loop replaces it
                    end = time.monotonic() + 60.0
                    while not fl.handoffs and time.monotonic() < end:
                        time.sleep(0.01)
                    handoffs = list(fl.handoffs)
                    # every ORIGINAL future must still answer (rechained
                    # onto the replacement's recovery futures)
                    originals = {i: f.result(timeout=120)
                                 for i, f in futures.items()}
                    # resubmit EVERY request under its original key: the
                    # router.forward schedule makes the first one spill
                    # to the ring successor; the rest dedupe
                    replies = {}
                    for item in load:
                        replies[item["index"]] = fl.submit(
                            item["a"], item["ap"], item["b"],
                            idempotency_key=ikey(item["index"])
                        ).result(timeout=120)
                    fleet_health = fl.health()
                    snap = inject.snapshot()
            finally:
                inject.disarm()
            counters = _counters(ctx)

        if not handoffs:
            problems.append("no journal handoff happened (dead drill)")
        else:
            rec = handoffs[0].get("recovered", {})
            if rec.get("entries") != n:
                problems.append(
                    f"handoff recovered {rec.get('entries')} entries "
                    f"!= {n} admitted")
            if rec.get("poisoned"):
                problems.append(
                    f"handoff poisoned {rec.get('poisoned')} entries")
        # flight recorder: the ProcessDeath must have sealed a blackbox
        # dump into the DEAD worker's journal dir (the one the handoff
        # names), its seal must verify, and it must hold the death the
        # drill injected (the JAX drill reads that off ``ia blackbox``'s
        # render, which comes with the port's reports: the dump's reason
        # and its serve_process_death record are what the render shows).
        blackbox: Dict[str, Any] = {}
        if handoffs:
            from image_analogies_tpu_torch.obs import recorder as obs_recorder

            dead_dir = os.path.join(fcfg.journal_root,
                                    handoffs[0]["worker"])
            dumps = obs_recorder.list_dumps(dead_dir)
            if not dumps:
                problems.append("no flight-recorder dump in dead "
                                "worker's journal dir")
            else:
                try:
                    doc = obs_recorder.load_dump(dumps[-1])
                except ValueError as exc:
                    problems.append(f"blackbox seal broken: {exc}")
                else:
                    events = [r.get("event")
                              for r in doc.get("records") or []]
                    if (doc.get("reason") != "process_death"
                            or "serve_process_death" not in events):
                        problems.append("blackbox dump does not show "
                                        "the process death")
                    if not doc.get("records"):
                        problems.append("blackbox dump has no records")
                    blackbox = {
                        "file": os.path.basename(dumps[-1]),
                        "reason": doc.get("reason"),
                        "scope": doc.get("scope"),
                        "records": len(doc.get("records") or []),
                    }
        identical = all(
            np.array_equal(originals[i].bp, baseline[i])
            for i in originals)
        identical = identical and all(
            np.array_equal(replies[i].bp, baseline[i]) for i in replies)
        if not identical:
            problems.append("fleet output differs from clean run")
        # exactly-once ledger across the handoff: the home journal holds
        # one done per original request; the spilled resubmit adds one
        # admit+done in the SUCCESSOR's journal; the other resubmits
        # dedupe against the home journal's records.
        for name, expect in (("serve.journal.admitted", n + 1),
                             ("serve.journal.done", n + 1),
                             ("serve.journal.deduped", n - 1),
                             ("router.deaths", 1),
                             ("router.handoffs", 1),
                             ("router.spills", 1)):
            got = counters.get(name, 0)
            if got != expect:
                problems.append(f"{name}={got} != expected {expect}")
        problems += _reconcile(plan, counters)
        injected = sum(st["injected"] for st in snap.values())
        if injected < 2:
            problems.append(
                f"expected both sites to inject, got {injected}")
        return {
            "workload": "fleet",
            "plan": plan.to_dict(),
            "injected": injected,
            "sites": snap,
            "handoffs": handoffs,
            "blackbox": blackbox,
            "fleet": {"pending": fleet_health.get("pending"),
                      "ring": fleet_health.get("ring")},
            "outcomes": {
                "answered": len(originals),
                "resubmitted": len(replies),
                "rechained": int(counters.get("router.rechained", 0)),
                "deduped": int(counters.get("serve.journal.deduped", 0)),
            },
            "counters": {k: v for k, v in counters.items()
                         if k.startswith(("chaos.", "serve.", "router."))},
            "identical": identical,
            "ok": not problems,
            "problems": problems,
        }


def drill_fleet_subprocess(plan: ChaosPlan, *, n: int = 4, seed: int = 7,
                           device: str = "cuda", backend: str = "cuda"
                           ) -> Dict[str, Any]:
    """Fleet death drill against REAL subprocess workers.

    Same exactly-once bar as :func:`drill_fleet`, but the death is a
    real ``SIGKILL`` delivered to a child pid — no fault plane inside
    the worker, no python-level unwinding, the kernel just takes it.
    What that buys over the in-process drill:

    - the journal's advisory lock holds a FOREIGN pid, so the
      replacement exercises the true stale-lock sweep (dead-pid probe,
      ``serve.journal.stale_lock_swept``) instead of the same-process
      shortcut;
    - the router's in-flight hops die as socket disconnects
      (``router.hop_disconnects``), leaving futures unresolved for the
      handoff to re-answer — the wire-level version of the stranded
      future the in-process drill stages;
    - recovery replays in a fresh interpreter: bit-identity across the
      handoff is proven across a process boundary, not a scope swap.

    Flow: wave 1 routes one request to the home worker and waits for
    its ``done`` record (so the replacement must dedupe against a prior
    incarnation's segment).  Wave 2 routes n-1 more, waits until the
    home child's journal shows them admitted (mid-coalesce, wide batch
    window), then SIGKILLs the home pid.  The health loop declares
    death, re-spawns generation 1 on the SAME journal dir; recovery
    sweeps the foreign lock, advances the segment, replays the
    incomplete entries, and the router's re-forwards join-replay onto
    them.  Then every request is resubmitted under its original key:
    the first eats the scheduled ``router.forward`` transient and
    spills to the ring successor (fresh compute, own journal); the
    rest dedupe against the replacement's journal.  Ground truth is
    read twice: live via /healthz (lock pid, segment, sweep counter)
    and offline via ``RequestJournal.inspect()`` after shutdown.

    One honest difference from the in-process drill: SIGKILL runs no
    death hook, so there is NO flight-recorder blackbox to assert — the
    corpse's journal directory is the only evidence, which is exactly
    the point."""
    from image_analogies_tpu_torch.obs import trace as obs_trace
    from image_analogies_tpu_torch.serve import journal as serve_journal
    from image_analogies_tpu_torch.serve.fleet import Fleet
    from image_analogies_tpu_torch.serve.types import FleetConfig

    with tempfile.TemporaryDirectory() as tmp:
        # Wide batch window: wave 2 must still be coalescing when the
        # SIGKILL lands, so its entries are admitted-not-done and the
        # replacement has real replay work.
        cfg = drills.serve_config(workers=1, max_batch=n,
                                  batch_window_ms=2000.0, device=device,
                                  backend=backend)
        fcfg = FleetConfig(serve=cfg, size=2, vnodes=16,
                           journal_root=os.path.join(tmp, "journals"),
                           transport="subprocess",
                           health_interval_s=0.1, death_checks=2,
                           backoff_s=0.01, backoff_cap_s=0.05)
        load = drills.make_serve_load(n, seed=seed)
        baseline = {item["index"]: drills.run_image(
            item["a"], item["ap"], item["b"], cfg.params)
            for item in load}
        ikey = "fleet-kill-{}".format

        problems: List[str] = []
        with obs_trace.run_scope(cfg.params) as ctx:
            # Armed in the ROUTER process only: spawned children never
            # see the plan (nothing propagates a ChaosPlan over the
            # spawn handshake) — the disarmed-zero-cost contract holds
            # in every worker while the parent schedules hop faults.
            inject.arm(plan)
            try:
                with Fleet(fcfg) as fl:
                    futures = {}
                    # wave 1: one request, answered and journaled done
                    # before the death (forward visit 0)
                    item0 = load[0]
                    futures[item0["index"]] = fl.submit(
                        item0["a"], item0["ap"], item0["b"],
                        idempotency_key=ikey(item0["index"]))
                    futures[item0["index"]].result(timeout=180)

                    def _journal(wid):
                        w = fl.health()["workers"].get(wid, {})
                        return w.get("journal") or {}

                    home = next(
                        (wid for wid in fl.workers
                         if _journal(wid).get("done", 0) >= 1), None)
                    if home is None:
                        raise RuntimeError(
                            "no worker journaled wave-1 done")
                    victim_pid = fl.workers[home].pid

                    # wave 2: n-1 requests coalescing in the home
                    # child's batch window (forward visits 1..n-1)
                    for item in load[1:]:
                        futures[item["index"]] = fl.submit(
                            item["a"], item["ap"], item["b"],
                            idempotency_key=ikey(item["index"]))
                    end = time.monotonic() + 60.0
                    while (_journal(home).get("admitted", 0) < n - 1
                           and time.monotonic() < end):
                        time.sleep(0.02)
                    if _journal(home).get("admitted", 0) < n - 1:
                        raise RuntimeError(
                            "wave-2 requests never admitted")

                    # the real death: kernel-level, mid-coalesce
                    os.kill(victim_pid, signal.SIGKILL)

                    end = time.monotonic() + 120.0
                    while not fl.handoffs and time.monotonic() < end:
                        time.sleep(0.02)
                    handoffs = list(fl.handoffs)
                    # every ORIGINAL future must still answer — the
                    # handoff re-forwards join-replay onto the
                    # replacement's recovery
                    originals = {i: f.result(timeout=180)
                                 for i, f in futures.items()}
                    # resubmit EVERY request under its original key:
                    # visit n faults -> the first resubmit spills to
                    # the ring successor; the rest dedupe
                    replies = {}
                    for item in load:
                        replies[item["index"]] = fl.submit(
                            item["a"], item["ap"], item["b"],
                            idempotency_key=ikey(item["index"])
                        ).result(timeout=180)
                    fleet_health = fl.health()
                    replacement = fleet_health["workers"].get(home, {})
                    snap = inject.snapshot()
            finally:
                inject.disarm()
            counters = _counters(ctx)

        if not handoffs:
            problems.append("no journal handoff happened (dead drill)")
        else:
            rec = handoffs[0].get("recovered", {})
            if handoffs[0].get("worker") != home:
                problems.append("handoff names wrong worker")
            if rec.get("entries") != n:
                problems.append(
                    f"handoff recovered {rec.get('entries')} entries "
                    f"!= {n} admitted")
            if rec.get("poisoned"):
                problems.append(
                    f"handoff poisoned {rec.get('poisoned')} entries")
        # The replacement is a NEW process on the OLD journal dir: its
        # lock must hold its own (fresh) pid, the dead child's lock
        # must have been swept as a foreign stale pid, and the segment
        # must have advanced past the corpse's.
        rep_pid = replacement.get("pid")
        rep_journal = replacement.get("journal") or {}
        if replacement.get("generation") != 1:
            problems.append(
                f"replacement generation {replacement.get('generation')}"
                " != 1")
        if rep_pid in (None, victim_pid, os.getpid()):
            problems.append(
                f"replacement pid {rep_pid} is not a fresh child "
                f"(victim {victim_pid}, parent {os.getpid()})")
        if rep_journal.get("lock_pid") != rep_pid:
            problems.append(
                f"journal lock_pid {rep_journal.get('lock_pid')} != "
                f"replacement pid {rep_pid}")
        if rep_journal.get("segment") != 2:
            problems.append(
                f"journal segment {rep_journal.get('segment')} != 2 "
                "(did not advance past the corpse's)")
        if rep_journal.get("stale_lock_swept", 0) < 1:
            problems.append("foreign stale lock was not swept")
        identical = all(
            np.array_equal(originals[i].bp, baseline[i])
            for i in originals)
        identical = identical and all(
            np.array_equal(replies[i].bp, baseline[i]) for i in replies)
        if not identical:
            problems.append("fleet output differs from clean run")
        # Router-side ledger (journal counters live in the CHILDREN —
        # asserted via /healthz above and disk below, not here).
        for name, expect in (("router.deaths", 1),
                             ("router.handoffs", 1),
                             ("router.spills", 1),
                             ("router.resubmitted", n - 1),
                             ("router.hop_disconnects", n - 1),
                             ("router.crash_loops", 0)):
            got = counters.get(name, 0)
            if got != expect:
                problems.append(f"{name}={got} != expected {expect}")
        problems += _reconcile(plan, counters)
        injected = sum(st["injected"] for st in snap.values())
        if injected != 1:
            problems.append(
                f"expected exactly the hop transient, got {injected}")
        # Offline ground truth: both children are gone (SIGTERM drain on
        # fleet exit), so read the journals straight off disk.
        home_dir = os.path.join(fcfg.journal_root, home)
        disk = serve_journal.RequestJournal(home_dir).inspect()
        if disk.get("requests") != n:
            problems.append(
                f"home journal holds {disk.get('requests')} requests "
                f"!= {n}")
        if disk.get("states", {}).get("done", 0) != n:
            problems.append(
                f"home journal done states {disk.get('states')} != "
                f"all-{n}-done")
        if disk.get("segments") != 2:
            problems.append(
                f"home journal has {disk.get('segments')} segments "
                "!= 2 (one per incarnation)")
        if disk.get("incomplete") or disk.get("poisoned"):
            problems.append("home journal left incomplete/poisoned work")
        succ = next((w for w in fleet_health["workers"] if w != home),
                    None)
        sdisk = (serve_journal.RequestJournal(
            os.path.join(fcfg.journal_root, succ)).inspect()
            if succ else {})
        if sdisk.get("states", {}).get("done", 0) != 1:
            problems.append(
                f"successor journal {sdisk.get('states')} != exactly "
                "the one spilled request done")
        return {
            "workload": "fleet_subprocess",
            "plan": plan.to_dict(),
            "injected": injected,
            "sites": snap,
            "handoffs": handoffs,
            "victim_pid": victim_pid,
            "replacement": {"pid": rep_pid,
                            "generation": replacement.get("generation"),
                            "journal": rep_journal},
            "disk": {"home": disk, "successor": sdisk},
            "fleet": {"pending": fleet_health.get("pending"),
                      "ring": fleet_health.get("ring"),
                      "transport": fleet_health.get("transport")},
            "outcomes": {
                "answered": len(originals),
                "resubmitted": int(counters.get("router.resubmitted", 0)),
                "hop_disconnects": int(
                    counters.get("router.hop_disconnects", 0)),
                "stale_lock_swept": int(
                    rep_journal.get("stale_lock_swept", 0)),
            },
            "counters": {k: v for k, v in counters.items()
                         if k.startswith(("chaos.", "serve.", "router."))},
            "identical": identical,
            "ok": not problems,
            "problems": problems,
        }


def drill_batch_partial(plan: ChaosPlan, *, k: int = 3, seed: int = 7,
                        device: str = "cuda") -> Dict[str, Any]:
    """Batched-engine lane-fault drill: k targets dispatch as ONE engine
    launch; the plan faults one lane's dispatch mid-batch.  Invariants:
    exactly the faulted member comes back as its Exception, every other
    member resolves bit-identical to its sequential singleton run, and
    the injection reconciles against ``batch.lane_faults``."""
    from image_analogies_tpu_torch.obs import trace as obs_trace

    a, ap, targets = drills.make_batch_load(k, seed=seed)
    params = drills.batch_params(device=device)

    # clean reference: each member's SEQUENTIAL singleton run — the bit-
    # identity bar the surviving lanes are held to
    baseline = [drills.run_image(a, ap, b, params) for b in targets]

    with obs_trace.run_scope(params) as ctx:
        with inject.plan_scope(plan):
            from image_analogies_tpu_torch.batch import (
                create_image_analogy_batch)

            results = create_image_analogy_batch(a, ap, targets, params)
            snap = inject.snapshot()
        counters = _counters(ctx)

    problems = []
    faulted = [i for i, r in enumerate(results) if isinstance(r, Exception)]
    survived = [i for i, r in enumerate(results)
                if not isinstance(r, Exception)]
    injected = sum(st["injected"] for st in snap.values())
    if injected == 0:
        problems.append("plan injected nothing (dead drill)")
    if len(faulted) != injected:
        problems.append(
            f"{injected} injections but {len(faulted)} faulted members "
            "(isolation leaked or swallowed)")
    if len(survived) != k - len(faulted):
        problems.append("member count does not reconcile")
    identical = all(
        np.array_equal(np.asarray(results[i].bp), baseline[i])
        for i in survived)
    if not identical:
        problems.append("surviving lanes differ from sequential runs")
    problems += _reconcile(plan, counters)
    return {
        "workload": "batch_partial",
        "plan": plan.to_dict(),
        "injected": injected,
        "sites": snap,
        "outcomes": {"lanes": k, "faulted": len(faulted),
                     "survived": len(survived)},
        "counters": {key: v for key, v in counters.items()
                     if key.startswith(("chaos.", "batch."))},
        "identical": identical,
        "ok": not problems,
        "problems": problems,
    }


def drill_archive_torn(plan: ChaosPlan, *, seed: int = 7,
                       workdir: Optional[str] = None,
                       device: str = "cuda") -> Dict[str, Any]:
    """Torn-segment + disk-full drill for the durable telemetry archive
    (obs/archive.py).  Clean reference archive (disarmed) → chaos
    archive: the plan's corrupt directive tears ONE sealed segment
    AFTER a successful-looking write (per-record segments, so exactly
    one record is at stake) → offline replay: the reader must
    quarantine exactly the torn segment, keep every undamaged record,
    and reconstruct the same final timeline document as the clean
    archive.  A second, self-armed plan then models disk-full: a
    raising rule at the same site must surface as a counted drop
    (``obs.archive.append_errors``), never as an exception on the
    producer path — the archive is a witness, not a dependency."""
    from image_analogies_tpu_torch.obs import archive as obs_archive
    from image_analogies_tpu_torch.obs import trace as obs_trace

    n_records = 8
    docs = [{"armed": True, "now": float(i), "idx": i,
             "series": {"w0|serve.qps": [[float(i), float(i + seed)]]}}
            for i in range(n_records)]

    problems: List[str] = []
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        clean = obs_archive.TelemetryArchive(
            os.path.join(tmp, "clean"), max_segment_bytes=1)
        for i, doc in enumerate(docs):
            clean.append("timeline", doc, now=float(i))
        clean_rep = clean.replay()

        # the params only open the metrics run: no engine work here
        params = drills.image_params(retries=0, device=device)
        with obs_trace.run_scope(params) as ctx:
            torn = obs_archive.TelemetryArchive(
                os.path.join(tmp, "torn"), max_segment_bytes=1)
            with inject.plan_scope(plan):
                appended = [torn.append("timeline", doc, now=float(i))
                            for i, doc in enumerate(docs)]
                snap = inject.snapshot()
            if not all(appended):
                problems.append(
                    "corrupt directive must not drop the write itself")
            rep = torn.replay()  # the reader quarantines the torn tail
            full_plan = ChaosPlan(
                seed=plan.seed,
                sites=(("archive.append",
                        SiteRule(kind="transient", schedule=(0,))),),
                name=f"{plan.name}-diskfull")
            with inject.plan_scope(full_plan):
                dropped_ok = torn.append("timeline", docs[-1],
                                         now=float(n_records))
                recovered_ok = torn.append("timeline", docs[-1],
                                           now=float(n_records + 1))
            counters = _counters(ctx)
        if dropped_ok:
            problems.append("disk-full append did not report the drop")
        if not recovered_ok:
            problems.append("append after disk-full did not recover")
        corrupt_files = [n for n in os.listdir(os.path.join(tmp, "torn"))
                         if n.endswith(".corrupt")]

    torn_total = sum(1 for _, r in plan.sites if r.kind == "corrupt")
    if len(corrupt_files) != torn_total:
        problems.append(f"{len(corrupt_files)} quarantined file(s) on "
                        f"disk, expected {torn_total}")
    identical = rep["timeline"] == clean_rep["timeline"]
    if not identical:
        problems.append("replayed final timeline document differs from "
                        "the clean archive's")
    survived = rep["kinds"].get("timeline", 0)
    if survived != n_records - torn_total:
        problems.append(f"{survived} records survived replay, expected "
                        f"{n_records - torn_total} (valid prefix lost?)")
    problems += _reconcile(plan, counters)
    injected = sum(st["injected"] for st in snap.values())
    if injected == 0:
        problems.append("plan injected nothing (dead drill)")
    return {
        "workload": "archive_torn",
        "plan": plan.to_dict(),
        "injected": injected,
        "sites": snap,
        "outcomes": {"records": n_records, "survived": survived,
                     "quarantined": len(corrupt_files),
                     "diskfull_drops":
                         int(counters.get("obs.archive.append_errors", 0))},
        "counters": {k: v for k, v in counters.items()
                     if k.startswith(("chaos.", "obs.archive."))},
        "identical": identical,
        "ok": not problems,
        "problems": problems,
    }


def _settled_at_floor(events: Sequence[Dict[str, Any]], floor: int) -> bool:
    """The LAST scale verdict is a retirement that reached ``floor``.  The
    JAX drill waits for any such event, which an earlier retirement can
    satisfy (the fleet shrank to the floor mid-surge and grew again): it
    then snapshots the events before the final retirement's record, and
    ``control.scale_down`` counts one more than the snapshot."""
    return (bool(events) and events[-1]["verdict"] == "scale_down"
            and events[-1]["size"] <= floor)


def drill_flash_crowd(plan: ChaosPlan, *, seed: int = 7,
                      device: str = "cuda", backend: str = "cuda"
                      ) -> Dict[str, Any]:
    """Elastic-fleet flash-crowd drill: a Zipf-skewed surge against an
    autoscaling fleet under a declarative ControlPolicy + per-tenant QoS.

    The composite shape: paced submits follow the shared loadgen
    arrival schedule (base rate, then a surge multiplier); queue
    pressure drives the control plane past its hysteresis so it spawns
    workers mid-load; one worker is killed mid-surge (the health daemon
    hands its journal to a replacement, exactly as the fleet_death
    drills prove); once the crowd passes, the idle fleet retires back
    to ``min_workers``.  One armed transient at ``level.dispatch``
    proves local retry recovery still holds while all of that happens.

    Invariants: every answered request is bit-identical to a direct
    engine run; every submit resolves to exactly one outcome (answer or
    quota refusal — zero loss); ALL quota throttles land on the viral
    style while non-viral tenants complete untouched with a bounded
    p95; every scale verdict is reconstructable through the decision
    plane (``ia why ctl-scale_up-<wid>``) and reconciles against the
    ``control.*`` / ``serve.decision.*`` counters."""
    from image_analogies_tpu_torch.obs import trace as obs_trace
    from image_analogies_tpu_torch.serve import journal as serve_journal
    from image_analogies_tpu_torch.serve import loadgen
    from image_analogies_tpu_torch.serve import policy as serve_policy
    from image_analogies_tpu_torch.serve.fleet import Fleet
    from image_analogies_tpu_torch.serve.types import FleetConfig, Rejected

    # Zipf-in-spirit heavy hitter, with EXACT per-style counts so the
    # quota geometry is deterministic: style 0 is viral (30 requests,
    # far past any reachable token allowance), styles 1..2 are the long
    # tail (4 each, under the burst — they must never throttle).
    rng = np.random.RandomState(seed)
    shape = (12, 12)
    styles = [(rng.rand(*shape).astype(np.float32),
               rng.rand(*shape).astype(np.float32)) for _ in range(3)]
    picks = [0] * 30 + [1] * 4 + [2] * 4
    rng.shuffle(picks)
    n = len(picks)
    load = []
    for i, s in enumerate(picks):
        a, ap = styles[s]
        load.append({"index": i, "style": s, "a": a, "ap": ap,
                     "b": rng.rand(*shape).astype(np.float32)})
    # The drill and `ia bench` share ONE traffic model: the loadgen
    # flash-crowd schedule.  A short base-rate preamble, then a hard
    # surge that outruns a single worker.
    sched = loadgen.arrival_schedule(n, t0=0.2, duration=1.0, mult=20.0,
                                     base_rps=30.0, seed=seed)

    with tempfile.TemporaryDirectory() as tmp:
        cfg = drills.serve_config(workers=1, max_batch=4, device=device,
                                  backend=backend)
        # level retries absorb the armed transient; the tiny quota
        # (burst 5, negligible refill) is what the viral style's 30
        # requests must exceed even across every bucket incarnation a
        # scale-up / kill-replacement can mint (max_workers + spill
        # targets: 4 buckets x 5 tokens < 30).
        cfg = dataclasses.replace(
            cfg,
            params=cfg.params.replace(level_retries=3),
            qos=serve_policy.QosPolicy(quota_rps=0.01, quota_burst=5.0))
        policy = serve_policy.ControlPolicy(
            min_workers=1, max_workers=3, queue_high=2.0, queue_low=0.5,
            scale_up_windows=1, scale_down_windows=2,
            scale_up_cooldown_s=0.1, scale_down_cooldown_s=0.1)
        fcfg = FleetConfig(serve=cfg, size=3, vnodes=16,
                           journal_root=os.path.join(tmp, "journals"),
                           health_interval_s=0.03, death_checks=2,
                           backoff_s=0.01, backoff_cap_s=0.05,
                           policy=policy)
        baseline = {item["index"]: drills.run_image(
            item["a"], item["ap"], item["b"], cfg.params)
            for item in load}

        problems: List[str] = []
        throttles: Dict[int, int] = {}
        rejected_other: List[str] = []
        errors: Dict[int, BaseException] = {}
        originals: Dict[int, Any] = {}
        with obs_trace.run_scope(cfg.params) as ctx:
            inject.arm(plan)
            try:
                with Fleet(fcfg) as fl:
                    futures = {}
                    killed = None
                    t0 = time.perf_counter()
                    for item in load:
                        delay = sched[item["index"]] - (time.perf_counter()
                                                        - t0)
                        if delay > 0:
                            time.sleep(delay)
                        if (killed is None and item["index"] >= n // 2
                                and len(fl.workers) >= 2):
                            # mid-surge death: the health daemon must
                            # hand the journal to a replacement while
                            # the control plane keeps scaling
                            killed = sorted(fl.workers)[0]
                            fl.workers[killed].kill()
                        try:
                            futures[item["index"]] = fl.submit(
                                item["a"], item["ap"], item["b"],
                                idempotency_key="fc-{}".format(
                                    item["index"]),
                                priority=(serve_policy.PRIORITY_INTERACTIVE
                                          if item["style"] else
                                          serve_policy.PRIORITY_STANDARD))
                        except Rejected as exc:
                            if exc.reason == "quota":
                                throttles[item["style"]] = \
                                    throttles.get(item["style"], 0) + 1
                            else:
                                rejected_other.append(exc.reason)
                    if killed is None:
                        # surge drained before the kill window — wait
                        # for the scale-up and deliver the death anyway
                        end = time.monotonic() + 30.0
                        while len(fl.workers) < 2 \
                                and time.monotonic() < end:
                            time.sleep(0.01)
                        if len(fl.workers) >= 2:
                            killed = sorted(fl.workers)[0]
                            fl.workers[killed].kill()
                    for idx, fut in futures.items():
                        try:
                            originals[idx] = fut.result(timeout=120)
                        except BaseException as exc:  # noqa: BLE001
                            errors[idx] = exc
                    # cool-down: the idle fleet must shrink back to the
                    # policy floor on its own
                    end = time.monotonic() + 60.0
                    while (len(fl.workers) > policy.min_workers
                           and time.monotonic() < end):
                        time.sleep(0.02)
                    # The retirement's decision record lands AFTER the
                    # worker leaves the map (scale_down pops first so a
                    # racing forward spills to a live successor), so
                    # settle until the floor-reaching event is visible
                    # before snapshotting — else the counter read after
                    # scope exit can outrun the event list.
                    end = time.monotonic() + 10.0
                    while (not _settled_at_floor(fl.control.events,
                                                 policy.min_workers)
                           and time.monotonic() < end):
                        time.sleep(0.01)
                    final_size = len(fl.workers)
                    events = list(fl.control.events)
                    handoffs = list(fl.handoffs)
                    snap = inject.snapshot()
            finally:
                inject.disarm()
            counters = _counters(ctx)

        if killed is None:
            problems.append("fleet never scaled up; no worker to kill")
        up_events = [e for e in events if e["verdict"] == "scale_up"]
        down_events = [e for e in events if e["verdict"] == "scale_down"]
        if not up_events:
            problems.append("control plane never recorded a scale_up")
        if not down_events:
            problems.append("control plane never recorded a scale_down")
        if final_size != policy.min_workers:
            problems.append(
                f"fleet ended at {final_size} workers, policy floor is "
                f"{policy.min_workers}")
        if not handoffs:
            problems.append("mid-surge kill produced no journal handoff")
        # zero-loss accounting: every submit resolved to exactly one of
        # answer / quota refusal; nothing else
        if errors:
            problems.append(f"{len(errors)} futures errored: "
                            f"{sorted(type(e).__name__ for e in errors.values())}")
        if rejected_other:
            problems.append(f"non-quota rejections: {rejected_other}")
        if len(originals) + len(errors) + sum(throttles.values()) \
                + len(rejected_other) != n:
            problems.append("outcome accounting does not sum to n")
        # QoS: the viral style absorbs ALL throttles; the long tail
        # completes untouched with a bounded p95
        if not throttles.get(0):
            problems.append("viral style was never quota-throttled")
        if any(s for s in throttles if s != 0):
            problems.append(f"non-viral styles throttled: {throttles}")
        lat_tail = [originals[i].total_ms for i in originals if picks[i]]
        tail_p95 = loadgen.percentile(lat_tail, 95)
        if len(lat_tail) != 8:
            problems.append(
                f"only {len(lat_tail)}/8 non-viral requests answered")
        if tail_p95 > 30_000:
            problems.append(f"non-viral p95 {tail_p95}ms exceeds bound")
        identical = all(
            np.array_equal(originals[i].bp, baseline[i])
            for i in originals if originals[i].degraded is None)
        if not identical:
            problems.append("answered output differs from clean run")
        # decision plane: counters reconcile and `ia why` reconstructs
        # each scale verdict from the sealed log
        for name in ("control.scale_up", "control.scale_down"):
            got = counters.get(name, 0)
            want_n = len(up_events if name.endswith("up") else down_events)
            if got != want_n:
                problems.append(f"{name}={got} != {want_n} events")
            mirrored = counters.get(
                "serve.decision." + name.split(".", 1)[1], 0)
            if mirrored != got:
                problems.append(
                    f"serve.decision mirror {mirrored} != {name}={got}")
        for ev in up_events[:1] + down_events[:1]:
            idem = "ctl-{}-{}".format(ev["verdict"], ev["worker"])
            why = serve_journal.reconstruct(idem, fcfg.journal_root)
            if not why.get("found"):
                problems.append(f"ia why found no evidence for {idem}")
        problems += _reconcile(plan, counters)
        injected = sum(st["injected"] for st in snap.values())
        if injected < 1:
            problems.append("the armed transient never fired")
        return {
            "workload": "flash_crowd",
            "plan": plan.to_dict(),
            "injected": injected,
            "sites": snap,
            "handoffs": handoffs,
            "scale_events": events,
            "killed": killed,
            "final_size": final_size,
            "outcomes": {
                "answered": len(originals),
                "quota_throttled": {f"s{k}": v
                                    for k, v in sorted(throttles.items())},
                "tail_p95_ms": round(tail_p95, 2),
            },
            "counters": {k: v for k, v in counters.items()
                         if k.startswith(("chaos.", "serve.", "router.",
                                          "control."))},
            "identical": identical,
            "ok": not problems,
            "problems": problems,
        }


def run_drill(plan: ChaosPlan, **kw) -> Dict[str, Any]:
    """Dispatch a plan to the workload its sites target."""
    if "flash_crowd" in (plan.name or ""):
        return drill_flash_crowd(plan, **kw)
    if any(name == "archive.append" for name, _ in plan.sites):
        return drill_archive_torn(plan, **kw)
    if any(name == "match.prefilter" for name, _ in plan.sites):
        return drill_ann_corrupt(plan, **kw)
    if any(name == "devcache.tier" for name, _ in plan.sites):
        return drill_catalog_tier(plan, **kw)
    if any(name == "engine.batch" for name, _ in plan.sites):
        return drill_batch_partial(plan, **kw)
    if any(name == "router.forward" for name, _ in plan.sites):
        if "subprocess" in (plan.name or ""):
            return drill_fleet_subprocess(plan, **kw)
        return drill_fleet(plan, **kw)
    if any(name == "serve.journal" for name, _ in plan.sites):
        return drill_kill_restart(plan, **kw)
    if _wants_serve(plan):
        return drill_serve(plan, **kw)
    return drill_image(plan, **kw)


def check_determinism(seed: int = 0) -> Dict[str, Any]:
    """Same seed ⇒ same fault schedule: run a probabilistic plan's
    decision stream twice (no workload needed — the stream is a pure
    function of (plan, visit sequence)) and compare."""
    plan = ChaosPlan(seed=seed, sites=(
        ("level.dispatch", SiteRule(kind="latency", p=0.5, latency_ms=0.0)),
        ("devcache.upload", SiteRule(kind="latency", p=0.3,
                                     latency_ms=0.0)),
    ), name="determinism")
    runs = []
    for _ in range(2):
        with inject.plan_scope(plan):
            for _visit in range(64):
                inject.site("level.dispatch")
                inject.site("devcache.upload")
            runs.append(inject.snapshot())
    ok = runs[0] == runs[1]
    return {"workload": "determinism", "plan": plan.to_dict(),
            "injected": sum(st["injected"] for st in runs[0].values()),
            "ok": ok,
            "problems": [] if ok else [f"schedules differ: {runs}"]}


def selftest(seed: int = 0, kinds: Optional[Sequence[str]] = None,
             device: str = "cuda") -> Dict[str, Any]:
    """One canonical drill per drill kind + the determinism check, each on
    ``device``."""
    reports = []
    for kind in (kinds or DRILL_KINDS):
        plan = plan_for_kind(kind, seed)
        report = run_drill(plan, device=device)
        report["kind"] = kind
        report["note"] = _KIND_NOTES.get(kind, "")
        reports.append(report)
    det = check_determinism(seed)
    det["kind"] = "determinism"
    det["note"] = "same seed, same schedule"
    reports.append(det)
    return {"seed": seed, "ok": all(r["ok"] for r in reports),
            "reports": reports}


def render(result: Dict[str, Any]) -> str:
    lines = [f"chaos selftest (seed {result['seed']}): "
             f"{'PASS' if result['ok'] else 'FAIL'}"]
    for r in result["reports"]:
        status = "ok " if r["ok"] else "FAIL"
        line = (f"  [{status}] {r.get('kind', r['plan'].get('name', '?')):12s}"
                f" injected={r.get('injected', 0)}")
        if "outcomes" in r:
            line += f" outcomes={r['outcomes']}"
        if r.get("note"):
            line += f"  ({r['note']})"
        lines.append(line)
        for p in r.get("problems", []):
            lines.append(f"         ! {p}")
    return "\n".join(lines)
