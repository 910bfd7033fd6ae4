"""The end-of-run soak gate: what only duration proves (the port's copy
of the JAX package's ``soak/invariants.py``).

Each invariant is a pure function of the driver's fact document, so a
test can feed synthetic facts and the CLI can re-render a stored run.
Every failing verdict carries a ``culprit`` wherever one exists — an
idempotency key ``ia why <idem> --journal-root <dir>`` can reconstruct,
so a red gate is the START of a debugging session, not the end of one.

The gate is deliberately inequality-based where the drill runner's
reconciliation is strict: a soak overlaps recoveries (a crash requeue
re-visits the same sites), so exact per-site equalities that hold in a
three-second drill are replaced by "at least the injected evidence"
bounds that stay deterministic across schedulers.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from image_analogies_tpu_torch.chaos.plan import ChaosPlan
from image_analogies_tpu_torch.soak.trace import TraceSpec

# Rejection reasons that are VERDICTS about a request (admission control
# doing its job) rather than lost work: they complete the accounting.
_SHED_REASONS = ("quota", "queue_full", "breaker_open", "circuit_open")


def p999_ms(facts: Dict[str, Any]) -> Optional[float]:
    """The DDSketch p99.9 of answered-request latency (None when
    nothing answered) — the honest tail the bench headline records."""
    from image_analogies_tpu_torch.obs import quantiles as obs_quantiles

    lats = facts.get("latencies_ms") or []
    if not lats:
        return None
    sk = obs_quantiles.QuantileSketch()
    for v in lats:
        sk.observe(float(v))
    return round(float(sk.quantile(0.999)), 3)


def lost(facts: Dict[str, Any]) -> int:
    """Submitted requests that neither answered nor shed cleanly — the
    ``soak_loss`` headline.  Hard rejections (poison, worker_crash,
    crash_loop), raw future errors, and silently vanished submits all
    count: lost work is lost however it was labelled."""
    rejected = facts.get("rejected") or {}
    shed = sum(n for r, n in rejected.items() if r in _SHED_REASONS)
    return max(0, facts.get("submitted", 0)
               - facts.get("answered", 0) - shed)


def _verdict(name: str, ok: bool, detail: str,
             culprit: Optional[str] = None) -> Dict[str, Any]:
    v = {"name": name, "ok": bool(ok), "detail": detail}
    if culprit:
        v["culprit"] = culprit
    return v


def evaluate(spec: TraceSpec, plan: ChaosPlan,
             facts: Dict[str, Any]) -> List[Dict[str, Any]]:
    """All gate verdicts, in reporting order."""
    out: List[Dict[str, Any]] = []
    counters = facts.get("counters") or {}
    rejected = facts.get("rejected") or {}
    errors = facts.get("errors") or {}
    journals = facts.get("journals") or {}
    sites = {name: st.get("injected", 0)
             for name, st in (facts.get("sites") or {}).items()}

    # 1. zero-loss accounting: every submit resolved to exactly one
    # outcome; hard rejections (poison, worker_crash, crash_loop) and
    # raw future errors are lost work even though they "resolved".
    shed = sum(n for r, n in rejected.items() if r in _SHED_REASONS)
    hard = {r: n for r, n in rejected.items() if r not in _SHED_REASONS}
    total = facts.get("answered", 0) + shed + sum(hard.values()) \
        + len(errors)
    culprit = None
    if errors:
        culprit = spec.idem_for(sorted(errors, key=int)[0])
    out.append(_verdict(
        "zero_loss",
        total == facts.get("submitted", 0) and not hard and not errors,
        f"answered={facts.get('answered', 0)} shed={shed} "
        f"hard={hard or 0} errors={len(errors)} "
        f"of submitted={facts.get('submitted', 0)}",
        culprit))

    # 2. no poisoned keys, reconciled across handoffs against every
    # worker journal (the culprit reconstructs via `ia why`).
    poisoned = sorted({idem for doc in journals.values()
                       for idem in doc.get("poisoned") or []})
    out.append(_verdict(
        "no_poison", not poisoned,
        f"{len(poisoned)} poisoned key(s) across "
        f"{len(journals)} worker journal(s)",
        poisoned[0] if poisoned else None))

    # 3. bit-identity of the seeded audit subset vs the sequential
    # baseline (degraded answers are valid; mismatches are not).
    audit = facts.get("audit") or {}
    mism = sorted(int(i) for i, st in audit.items() if st == "mismatch")
    checked = sum(1 for st in audit.values() if st == "ok")
    out.append(_verdict(
        "bit_identity", not mism,
        f"{checked}/{len(audit)} audited answers bit-identical "
        f"({len(mism)} mismatched)",
        spec.idem_for(mism[0]) if mism else None))

    # 4. journaled resubmits dedupe to the first answer's exact bytes.
    out.append(_verdict(
        "resubmit_dedupe", bool(facts.get("resubmit_identical", True)),
        f"{facts.get('resubmits', 0)} resubmit(s) answered from the "
        "journal"))

    # 5. DDSketch p99.9 latency bound.
    p999 = p999_ms(facts)
    out.append(_verdict(
        "p999_bound",
        p999 is not None and p999 <= spec.p999_bound_ms,
        f"p99.9={p999}ms bound={spec.p999_bound_ms}ms "
        f"({len(facts.get('latencies_ms') or [])} samples)"))

    # 6. the run ended with ZERO resource-ceiling alarms.
    alarms = {k: v for k, v in counters.items()
              if k.startswith("obs.ceiling.")}
    out.append(_verdict(
        "no_ceiling_alarms", not alarms,
        f"ceiling counters: {alarms or 'none'}"))

    # 7. journals bounded under compaction: every seeded kill's replace
    # ran the autocompact decision (multi-segment corpses compacted,
    # already-bounded corpses skipped), a worker killed more than once
    # demonstrably compacted at least once, and each journal compacts
    # offline to a single segment at end of run.
    kills = facts.get("kills") or []
    repeat = (len(kills)
              - len({k.get("worker") for k in kills})) if kills else 0
    autoc = counters.get("serve.journal.autocompact", 0)
    skipped = counters.get("serve.journal.autocompact_skipped", 0)
    fat = {wid: doc.get("segments") for wid, doc in journals.items()
           if doc.get("segments", 0) > 1}
    failed_compact = {wid: doc["compacted"]["error"]
                      for wid, doc in journals.items()
                      if isinstance(doc.get("compacted"), dict)
                      and "error" in doc["compacted"]}
    out.append(_verdict(
        "journal_bounded",
        autoc + skipped >= len(kills)
        and (autoc >= 1 if repeat else True)
        and not fat and not failed_compact,
        f"autocompact={autoc} skipped={skipped} kills={len(kills)} "
        f"(repeat={repeat}) post-run segments>1: {fat or 'none'} "
        f"compact errors: {failed_compact or 'none'}"))

    # 8. chaos stayed armed the whole run: every planned required site
    # observed at least one injection, and every driver kill resolved
    # to a journal handoff.
    from image_analogies_tpu_torch.soak import driver as soak_driver

    planned = {name for name, _ in plan.sites}
    required = [s for s in soak_driver.REQUIRED_SITES if s in planned]
    silent = [s for s in required if not sites.get(s)]
    want_kills = bool(spec.kill_every
                      and spec.requests > spec.kill_every)
    handoffs = facts.get("handoffs") or []
    out.append(_verdict(
        "chaos_armed",
        not silent and sum(sites.values()) >= 1
        and (not want_kills or (kills and len(handoffs) >= len(kills))),
        f"injections={sites} kills={len(kills)} "
        f"handoffs={len(handoffs)} silent_sites={silent or 'none'}"))

    # 9. every injection reconciles against its recovery evidence
    # (inequalities — overlapping recoveries re-visit sites).
    recon: List[str] = []
    tier = sites.get("devcache.tier", 0)
    if tier:
        evicted = counters.get("catalog.chaos_evictions", 0)
        refilled = (counters.get("catalog.disk.hits", 0)
                    + counters.get("catalog.builds", 0))
        if evicted != tier:
            recon.append(f"catalog.chaos_evictions={evicted} != "
                         f"{tier} injected")
        if refilled < evicted:
            recon.append(f"{evicted} evictions but only {refilled} "
                         "disk-hit/rebuild recoveries")
    if sites.get("archive.append", 0):
        q = facts.get("archive", {}).get("quarantined", 0) \
            + counters.get("obs.archive.append_errors", 0)
        if q < 1:
            recon.append("archive.append fired but the reader "
                         "quarantined nothing")
    lvl = sites.get("level.dispatch", 0)
    if lvl and counters.get("level_retry", 0) < lvl:
        recon.append(f"level_retry={counters.get('level_retry', 0)} < "
                     f"{lvl} injected transients")
    out.append(_verdict(
        "chaos_reconciled", not recon,
        "; ".join(recon) or "all injections matched by recovery "
        "evidence"))
    return out


def render(result: Dict[str, Any]) -> str:
    """Human gate report for ``ia soak`` (one line per invariant)."""
    lines = ["ia soak: {} ({} requests, wall {}s)".format(
        "PASS" if result.get("ok") else "FAIL",
        result.get("facts", {}).get("submitted", 0),
        result.get("facts", {}).get("wall_s", "?"))]
    for v in result.get("verdicts", []):
        mark = "ok " if v["ok"] else "FAIL"
        line = f"  [{mark}] {v['name']}: {v['detail']}"
        if v.get("culprit"):
            line += f"  (culprit: ia why {v['culprit']})"
        lines.append(line)
    lines.append(f"  p999_ms={result.get('p999_ms')} "
                 f"loss={result.get('loss')}")
    return "\n".join(lines) + "\n"
