"""The soak driver: one :class:`TraceSpec` against a live fleet, chaos
armed the entire run (the port's copy of the JAX package's
``soak/driver.py``, with one repair: the kill schedule, :func:`_kill`).

Where a chaos drill proves ONE recovery path in seconds, the soak
replays a whole traffic trace — Zipf tenant skew, diurnal ripple,
flash crowds, mixed sessions and priorities — against an autoscaling
fleet while the fault plane stays armed throughout: periodic worker
kills (journal handoffs + autocompaction), catalog tier evictions
mid-request, torn telemetry archive segments, injected hop latency,
and transient dispatch faults the level retries must keep absorbing.
The witnesses (timeline, ceilings trend watchdogs, durable
archive) sample the whole time via the fleet health loop.

The fleet serves on the host oracle (``drills.catalog_params``:
``backend="cpu"``, the only matcher the level loop hands the catalog's
feature tiers to), so a soak launches no kernel on any ``device``.

The driver only *collects facts*; the verdicts live in
:mod:`soak.invariants` so the gate is a pure function a test can feed
synthetic facts.  Everything here is seeded — two runs of the same
spec submit byte-identical streams and reach the same verdicts.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np

from image_analogies_tpu_torch.chaos import drills, inject
from image_analogies_tpu_torch.chaos.plan import ChaosPlan, SiteRule
from image_analogies_tpu_torch.soak import invariants as soak_invariants
from image_analogies_tpu_torch.soak.trace import TraceSpec

AUDIT_SALT = 0xA0D1  # seeded audit-subset draw; disjoint from trace salts

# Sites every default soak must observe firing (the acceptance gate's
# "chaos armed throughout" witness list).  Worker kills are driver-side
# SIGKILLs, counted separately via journal handoffs.
REQUIRED_SITES = ("devcache.tier", "archive.append")

# Trend-watchdog thresholds for a soak (bytes/sec slope over a full
# window).  The fleet defaults are tuned for long-lived processes; a
# soak front-loads a legitimate ramp (jax init, catalog builds, journal
# payload spills at surge rate) that would trip them in the first
# seconds.  These still catch pathological runaway growth, and the
# ABSOLUTE journal bound is invariant 7's job (compacts to one
# segment), not the trend watchdog's.
SOAK_THRESHOLDS = {
    "proc.rss_bytes": 256 << 20,
    "devcache.bytes": 64 << 20,
    "journal.bytes": 16 << 20,
    "archive.bytes": 16 << 20,
}


# How long a seeded kill waits for its journal handoff before the driver
# submits the next request (the end-of-run wait's bound).
HANDOFF_WAIT_S = 60.0


def default_plan(seed: int) -> ChaosPlan:
    """The standing soak fault shape: every injection must be one the
    fleet recovers from WITHOUT changing answered bytes.

    - ``level.dispatch`` transients — absorbed by level retries.
    - ``devcache.tier`` corrupt — mid-request catalog eviction; the
      directive never raises, recovery is the tier fall-through.
    - ``archive.append`` corrupt — tears a sealed telemetry segment
      after a successful-looking write; the offline reader quarantines.
    - ``router.forward`` latency — injected hop delay, self-recovering.
    """
    return ChaosPlan(
        seed=seed,
        sites=(
            ("level.dispatch", SiteRule(kind="transient", p=0.05,
                                        max_faults=6)),
            ("devcache.tier", SiteRule(kind="corrupt",
                                       schedule=(1, 5, 11))),
            ("archive.append", SiteRule(kind="corrupt", schedule=(0,))),
            ("router.forward", SiteRule(kind="latency", p=0.1,
                                        latency_ms=15.0, max_faults=8)),
        ),
        name=f"soak-default-{seed}").validate_sites()


def audit_indices(spec: TraceSpec) -> List[int]:
    """The seeded bit-identity audit subset: ``spec.audit`` request
    indices drawn from the spec's own seed (disjoint salt), so replays
    audit the same requests."""
    if spec.requests == 0 or spec.audit == 0:
        return []
    rng = np.random.RandomState((int(spec.seed) + AUDIT_SALT) & 0x7FFFFFFF)
    k = min(spec.audit, spec.requests)
    return sorted(int(i) for i in
                  rng.choice(spec.requests, size=k, replace=False))


@contextlib.contextmanager
def _rundir(workdir: Optional[str]):
    """The run's scratch root.  An explicit ``workdir`` PERSISTS (so a
    red gate's journals/archive stay on disk for ``ia why`` /
    ``ia archive diff``); without one, a tempdir is swept."""
    if workdir:
        path = os.path.abspath(workdir)
        os.makedirs(path, exist_ok=True)
        yield path
    else:
        with tempfile.TemporaryDirectory() as tmp:
            yield tmp


def _serve_config(params, device: str = "cuda"):
    """Soak per-worker config: the drill template with a deeper crash
    budget (driver kills land mid-flight; requeues must absorb every
    seeded kill without poisoning a key)."""
    cfg = drills.serve_config(workers=1, max_batch=4, crash_requeues=3,
                              device=device)
    return dataclasses.replace(cfg, params=params, request_retries=3)


def _kill(fl, kills: List[Dict[str, Any]], at: int) -> str:
    """One seeded kill before request ``at``: the worker the previous kill
    hit (the lowest-named live worker at the first) dies, and the driver
    goes on only once the health loop has handed its journal to a
    replacement.

    The JAX driver kills ``sorted(fl.workers)[len(kills) % len(fl.workers)]``
    and submits on at once, so the outcome follows the autoscaler's timing:
    with one live worker the next submit finds only the corpse and is
    refused (``shutting_down`` or ``fleet_saturated``: a lost request);
    with two or more the second kill hits another worker, so no worker is
    killed twice and no multi-segment corpse is left to autocompact.  Here
    neither the victim nor the next submit depends on the live count."""
    from image_analogies_tpu_torch.obs import archive as obs_archive
    from image_analogies_tpu_torch.obs import trace as obs_trace

    prev = kills[-1]["worker"] if kills else None
    wid = prev if prev in fl.workers else sorted(fl.workers)[0]
    fl.workers[wid].kill()
    kills.append({"worker": wid, "at": at})
    obs_trace.emit_record({"event": "soak_kill", "worker": wid,
                           "request": at})
    # witness tick at the fault: the armed archive seals a timeline doc
    obs_archive.sample(force=True)
    _await_handoffs(fl, len(kills))
    return wid


def _await_handoffs(fl, n: int, wait_s: float = HANDOFF_WAIT_S) -> None:
    """Block until ``fl`` has made ``n`` journal handoffs (or ``wait_s``
    passed)."""
    end = time.monotonic() + wait_s
    while len(fl.handoffs) < n and time.monotonic() < end:
        time.sleep(0.005)


def run(spec: TraceSpec, *, workdir: Optional[str] = None,
        plan: Optional[ChaosPlan] = None, device: str = "cuda"
        ) -> Dict[str, Any]:
    """Execute one soak on ``device``; returns ``{"facts", "verdicts",
    "ok", ...}``.

    ``plan`` overrides the fault shape (tests use hostile plans to
    prove the gate fails loudly); otherwise ``spec.chaos`` (validated)
    or :func:`default_plan`.
    """
    from image_analogies_tpu_torch.catalog import tiers as catalog_tiers
    from image_analogies_tpu_torch.obs import archive as obs_archive
    from image_analogies_tpu_torch.obs import ceilings as obs_ceilings
    from image_analogies_tpu_torch.obs import trace as obs_trace
    from image_analogies_tpu_torch.serve import journal as serve_journal
    from image_analogies_tpu_torch.serve import policy as serve_policy
    from image_analogies_tpu_torch.serve.fleet import Fleet
    from image_analogies_tpu_torch.serve.types import FleetConfig, Rejected

    if plan is None:
        if spec.chaos is not None:
            plan = ChaosPlan.from_dict(spec.chaos).validate_sites()
        else:
            plan = default_plan(spec.seed)

    load = spec.build_load()
    sched = spec.arrivals()
    audit = audit_indices(spec)
    t_start = time.perf_counter()

    catalog_tiers.clear()
    old_archive_env = os.environ.get("IA_ARCHIVE_DIR")
    # Pre-arm the ceilings plane with soak thresholds; the fleet's own
    # arm() joins this monitor instead of installing the fleet-default
    # one, so the health loop trends against soak-scale slopes.
    obs_ceilings.arm(monitor=obs_ceilings.CeilingMonitor(
        thresholds=SOAK_THRESHOLDS))
    try:
        with _rundir(workdir) as tmp:
            archive_root = os.path.join(tmp, "archive")
            journal_root = os.path.join(tmp, "journals")
            params = drills.catalog_params(
                os.path.join(tmp, "catalog"),
                device=device).replace(level_retries=3)
            cfg = _serve_config(params, device)
            policy = serve_policy.ControlPolicy(
                min_workers=1, max_workers=3, queue_high=2.0,
                queue_low=0.5, scale_up_windows=1, scale_down_windows=2,
                scale_up_cooldown_s=0.1, scale_down_cooldown_s=0.1)
            fcfg = FleetConfig(
                serve=cfg, size=3, vnodes=16, journal_root=journal_root,
                health_interval_s=0.03, death_checks=2,
                backoff_s=0.01, backoff_cap_s=0.05,
                crash_loop_threshold=0,  # seeded kills always respawn
                policy=policy)
            os.environ["IA_ARCHIVE_DIR"] = archive_root

            answered: Dict[int, Any] = {}
            rejected: Dict[str, int] = {}
            errors: Dict[int, str] = {}
            resubmit_hits = 0
            resubmit_identical = True
            kills: List[Dict[str, Any]] = []
            with obs_trace.run_scope(cfg.params) as ctx:
                # Sequential baseline for the audit subset BEFORE chaos
                # arms — this also seals the catalog tiers the armed
                # run's evictions will fall through.
                baseline = {i: drills.run_image(
                    load[i]["a"], load[i]["ap"], load[i]["b"], cfg.params)
                    for i in audit}
                inject.arm(plan)
                try:
                    with Fleet(fcfg) as fl:
                        futures: Dict[int, Any] = {}
                        t0 = time.perf_counter()
                        for item in load:
                            i = item["index"]
                            # batch sessions coalesce: no pacing wait,
                            # they pile onto the worker's batch lanes
                            if item["session"] != "batch":
                                delay = sched[i] - (time.perf_counter()
                                                    - t0)
                                if delay > 0:
                                    time.sleep(delay)
                            if (spec.kill_every
                                    and i and i % spec.kill_every == 0):
                                _kill(fl, kills, i)
                            try:
                                futures[i] = fl.submit(
                                    item["a"], item["ap"], item["b"],
                                    deadline_s=item["deadline_s"],
                                    idempotency_key=item["idem"],
                                    priority=serve_policy.PRIORITY_CLASSES[
                                        item["priority"]])
                            except Rejected as exc:
                                rejected[exc.reason] = \
                                    rejected.get(exc.reason, 0) + 1
                        for i, fut in sorted(futures.items()):
                            try:
                                answered[i] = fut.result(timeout=120)
                            except Rejected as exc:
                                rejected[exc.reason] = \
                                    rejected.get(exc.reason, 0) + 1
                            except BaseException as exc:  # noqa: BLE001
                                errors[i] = type(exc).__name__
                        # journaled resubmits: the dedupe plane must
                        # answer each resubmitted key from its journal,
                        # byte-identical to the first answer
                        for item in load:
                            i = item["index"]
                            if item["session"] != "resubmit" \
                                    or i not in answered:
                                continue
                            try:
                                again = fl.submit(
                                    item["a"], item["ap"], item["b"],
                                    idempotency_key=item["idem"],
                                    priority=serve_policy.PRIORITY_CLASSES[
                                        item["priority"]]).result(
                                            timeout=120)
                            except BaseException:  # noqa: BLE001
                                resubmit_identical = False
                                continue
                            resubmit_hits += 1
                            if not np.array_equal(again.bp,
                                                  answered[i].bp):
                                resubmit_identical = False
                        # every seeded kill must resolve to a handoff
                        # before the fleet retires
                        _await_handoffs(fl, len(kills))
                        obs_archive.sample(force=True)
                        handoffs = list(fl.handoffs)
                        scale_events = list(fl.control.events)
                        final_size = len(fl.workers)
                        snap = inject.snapshot()
                finally:
                    inject.disarm()
                # Post-mortem, still inside the obs scope so recovery
                # counters land in ctx: the archive reader quarantines
                # torn segments; each worker journal must compact
                # offline to one bounded segment.
                archive = obs_archive.TelemetryArchive(archive_root)
                archive_replay = archive.replay()
                archive_stats = archive.stats()
                journals: Dict[str, Dict[str, Any]] = {}
                if os.path.isdir(journal_root):
                    for wid in sorted(os.listdir(journal_root)):
                        jdir = os.path.join(journal_root, wid)
                        if not os.path.isdir(jdir) or wid == "payloads":
                            continue
                        j = serve_journal.RequestJournal(jdir)
                        try:
                            compacted: Optional[Dict[str, Any]] = \
                                j.compact()
                        except (RuntimeError, OSError) as exc:
                            compacted = {"error": str(exc)}
                        doc = j.inspect()
                        doc["compacted"] = compacted
                        journals[wid] = doc
                counters = dict(ctx.registry.snapshot()["counters"])

            facts = {
                "spec": spec.to_dict(),
                "plan": plan.to_dict(),
                "submitted": spec.requests,
                "answered": len(answered),
                "rejected": dict(sorted(rejected.items())),
                "errors": errors,
                "degraded": sum(1 for r in answered.values()
                                if r.degraded is not None),
                "resubmits": resubmit_hits,
                "resubmit_identical": resubmit_identical,
                "kills": kills,
                "handoffs": handoffs,
                "scale_events": len(scale_events),
                "final_size": final_size,
                # per-index audit status: only a byte mismatch on a
                # full-fidelity answer is a violation — degraded or
                # unanswered (rejected/lost) indices are judged by the
                # accounting invariants, not this one
                "audit": {
                    i: ("unanswered" if i not in answered
                        else "degraded"
                        if answered[i].degraded is not None
                        else "ok"
                        if np.array_equal(answered[i].bp, baseline[i])
                        else "mismatch")
                    for i in audit},
                "latencies_ms": sorted(
                    round(float(r.total_ms), 3)
                    for r in answered.values()),
                "sites": snap,
                "archive": {
                    "kinds": dict(archive_replay.get("kinds") or {}),
                    "quarantined": int(
                        archive_stats.get("quarantined", 0)),
                    "bytes": int(archive_stats.get("bytes", 0)),
                },
                "journals": journals,
                "journal_root": journal_root if workdir else None,
                "archive_root": archive_root if workdir else None,
                "counters": counters,
                "wall_s": round(time.perf_counter() - t_start, 3),
            }
    finally:
        obs_ceilings.disarm()
        if old_archive_env is None:
            os.environ.pop("IA_ARCHIVE_DIR", None)
        else:
            os.environ["IA_ARCHIVE_DIR"] = old_archive_env
        catalog_tiers.clear()
        catalog_tiers.configure(None)

    verdicts = soak_invariants.evaluate(spec, plan, facts)
    return {
        "workload": "soak",
        "facts": facts,
        "verdicts": verdicts,
        "ok": all(v["ok"] for v in verdicts),
        "p999_ms": soak_invariants.p999_ms(facts),
        "loss": soak_invariants.lost(facts),
    }
