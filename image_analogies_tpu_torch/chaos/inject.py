"""The injection plane: named sites at every layer boundary (the port's
copy of the JAX package's ``chaos/inject.py``).

Engine layers call ``site("name", **ctx)`` at their boundaries:

    level.dispatch    models/analogy.py   — per-level device dispatch,
                                            inside the watchdogged body
    devcache.upload   utils/devcache.py   — host→device upload (miss path)
    devcache.tier     catalog/tiers.py    — per-level catalog tier
                                            resolution ("corrupt" =
                                            evict the key mid-request)
    match.prefilter   backends/cuda.py    — per-level ANN projection
                                            resolution ("corrupt" =
                                            damage the sealed artifact)
    ckpt.save         utils/checkpoint.py — checkpoint write
    ckpt.load         utils/checkpoint.py — checkpoint read
    serve.admit       serve/queue.py      — request admission
    serve.dispatch    serve/worker.py     — batch dispatch
    serve.journal     serve/journal.py    — journal append
    engine.batch      batch/engine.py     — per-lane batched dispatch
    mesh.step         parallel/step.py    — multichip level step
    router.forward    serve/router.py     — fleet hop forward
    archive.append    obs/archive.py      — sealed telemetry append

Disarmed (the production default), ``site()`` is one module-bool check
and an immediate ``return None`` — no lock, no metric, no allocation
(locked by tests/test_torch_chaos.py's zero-activity test, matching the
obs/ off-path contract).  Armed, the site consults the plan: raising kinds
throw, ``latency`` sleeps, and ``corrupt`` returns a directive string
the call site applies itself.

Determinism: each site draws from its own stably-seeded per-(seed, name)
``random.Random`` stream and keeps its own visit counter, so a plan's
fault schedule is a pure function of (plan, per-site call sequence) —
re-running the same drill replays the same faults, and the JAX plane,
seeded alike, replays them too.  Visit counters are taken under one lock
(serve drills are multi-threaded); which *thread* sees visit k may vary,
but the k-th visit faulting or not never does — and the drill invariants
(bit-identical output, nothing lost) hold regardless of which request a
fault lands on.
"""

from __future__ import annotations

import contextlib
import math
import random
import threading
import time
from typing import Any, Dict, Optional

from image_analogies_tpu_torch.chaos import faults as _faults
from image_analogies_tpu_torch.chaos.plan import ChaosPlan, SiteRule
from image_analogies_tpu_torch.obs import metrics as _metrics
from image_analogies_tpu_torch.obs import trace as _trace

# Disarmed fast path: ONE module bool guards everything below.
_ARMED = False
_PLAN: Optional[ChaosPlan] = None
_LOCK = threading.Lock()
_STATE: Dict[str, Dict[str, Any]] = {}  # site -> {visits, injected, rng}


def armed() -> bool:
    return _ARMED


def arm(plan: ChaosPlan) -> None:
    """Install ``plan`` and reset all site streams/counters."""
    global _ARMED, _PLAN
    with _LOCK:
        _PLAN = plan
        _STATE.clear()
        for name, _rule in plan.sites:
            _STATE[name] = {"visits": 0, "injected": 0,
                            "rng": random.Random(
                                _faults.stream_seed(plan.seed, name))}
        _ARMED = True


def disarm() -> None:
    global _ARMED, _PLAN
    with _LOCK:
        _ARMED = False
        _PLAN = None
        _STATE.clear()


@contextlib.contextmanager
def plan_scope(plan: ChaosPlan):
    """Arm ``plan`` for a with-block; always disarms on exit (drills must
    never leak armed state into the suite — the tests' disarming fixture
    is the second belt)."""
    arm(plan)
    try:
        yield
    finally:
        disarm()


def snapshot() -> Dict[str, Dict[str, int]]:
    """Per-site {visits, injected} tallies of the armed (or last) plan."""
    with _LOCK:
        return {name: {"visits": st["visits"], "injected": st["injected"]}
                for name, st in _STATE.items()}


def injected_total() -> int:
    with _LOCK:
        return sum(st["injected"] for st in _STATE.values())


def plan_seed() -> Optional[int]:
    """Seed of the armed plan (None when disarmed) — call sites applying
    a ``corrupt`` directive use it so the damage is plan-deterministic."""
    plan = _PLAN
    return plan.seed if plan is not None else None


# z-score of the 99th percentile of the standard normal: with
# sigma = ln(p99/p50) / Z99, lognormal(ln(p50), sigma) has exactly the
# requested median and 99th percentile.
_Z99 = 2.3263478740408408


def _latency_s(name: str, rule: SiteRule) -> float:
    """Sleep length for a firing latency rule, in seconds.

    Fixed ``latency_ms`` by default; when the rule carries a lognormal
    spec (p50/p99 both set) the delay is drawn from the site's seeded
    stream — deterministic per (plan seed, site, visit sequence), so a
    replayed drill sleeps the same tail."""
    if not rule.latency_p50_ms:
        return rule.latency_ms / 1e3
    sigma = math.log(rule.latency_p99_ms / rule.latency_p50_ms) / _Z99
    with _LOCK:
        st = _STATE.get(name)
        if st is None:
            return rule.latency_ms / 1e3
        return st["rng"].lognormvariate(
            math.log(rule.latency_p50_ms), sigma) / 1e3


def _decide(name: str, rule: SiteRule) -> Optional[int]:
    """Take one visit at ``name``; returns the visit index when the rule
    fires, else None.  Single lock section: counter bump + draw."""
    with _LOCK:
        st = _STATE.get(name)
        if st is None:  # site visited but not in _STATE (plan replaced)
            return None
        visit = st["visits"]
        st["visits"] += 1
        if rule.max_faults and st["injected"] >= rule.max_faults:
            return None
        if rule.schedule:
            fire = visit in rule.schedule
        else:
            fire = rule.p > 0 and st["rng"].random() < rule.p
        if not fire:
            return None
        st["injected"] += 1
        return visit


def site(name: str, **ctx: Any) -> Optional[str]:
    """Injection site: no-op returning None when chaos is disarmed.

    Armed, consults the plan's rule for ``name``; when a fault fires it
    either raises (transient/oom/crash), sleeps (latency; with
    ``hang=True`` the sleep ends in a transient raise — a wedge that
    never completes), or returns a directive string (``"corrupt"``) the
    call site applies itself.  Every injection bumps ``chaos.injected``
    (+ per-site/kind counters) and emits a ``chaos_inject`` record into
    the active run log, so drills reconcile injections against the
    recovery counters they caused.
    """
    if not _ARMED:
        return None
    plan = _PLAN
    rule = plan.rule_for(name) if plan is not None else None
    if rule is None:
        return None
    visit = _decide(name, rule)
    if visit is None:
        return None
    _metrics.inc("chaos.injected")
    _metrics.inc(f"chaos.injected.{rule.kind}")
    _metrics.inc(f"chaos.site.{name}")
    _trace.emit_record({"event": "chaos_inject", "site": name,
                        "kind": rule.kind, "visit": visit,
                        **{k: v for k, v in ctx.items()
                           if isinstance(v, (str, int, float, bool))}})
    if rule.kind == "transient":
        raise _faults.ChaosTransient(
            f"chaos transient at {name} (visit {visit})")
    if rule.kind == "oom":
        raise _faults.oom_error(name, visit)
    if rule.kind == "latency":
        time.sleep(_latency_s(name, rule))
        if rule.hang:
            # the wedged op never completes: by the time this raise
            # unwinds, a watchdogged caller has already timed out and
            # moved on — the abandoned thread's error is swallowed there
            raise _faults.ChaosTransient(
                f"chaos hang released at {name} (visit {visit})")
        return None
    if rule.kind == "crash":
        raise _faults.WorkerCrash(
            f"chaos worker crash at {name} (visit {visit})")
    if rule.kind == "process_death":
        raise _faults.ProcessDeath(
            f"chaos process death at {name} (visit {visit})")
    return rule.kind  # "corrupt": directive for the call site
