"""`ia report` — turn a run-log JSONL into an answer (the port's copy of
the JAX package's ``obs/report.py``).

Reads the records ``utils.logging.emit`` wrote (level stats, spans,
manifest, run_end metrics snapshot) and prints, per run:

- the run manifest (config hash, backend, strategy, mesh, device, git rev)
- a per-level timing breakdown: wall (from ``span`` records) vs device
  (the level stat's ``ms`` / ``enqueue_ms``) vs host (wall - device)
- counter totals: devcache hit rate + upload bytes, retries, psum-gather
  bytes, and the kappa coherence-vs-approx pick ratio
- the slowest spans
- the compile/cost section: the port counts its kernels' own work as
  ``kernel.flops`` / ``kernel.bytes`` (``obs/device.py note_launch``) and
  its ``nvcc`` builds as compiles; a log the JAX package wrote carries
  XLA's cost estimate as ``xla.flops`` / ``xla.bytes`` and renders as the
  JAX report renders it

Works on both solo-run logs (``create_image_analogy``: one stat record
per level with device timing) and sharded-run logs (``_sharded_phase``:
per-frame records with no timing — wall comes from the mesh level spans,
coherence from the phase-end ``coherence_ratios`` summary).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple


def load_records(path: str) -> List[Dict[str, Any]]:
    recs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # tolerate truncated tail lines (preempted run)
            if isinstance(rec, dict):
                recs.append(rec)
    return recs


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} GiB"


def _is_level_stat(rec: Dict[str, Any]) -> bool:
    return ("level" in rec and "event" not in rec
            and ("db_rows" in rec or "pixels" in rec))


def _cost_source(counters: Dict[str, float]) -> str:
    """``kernel`` where the run counted its kernels' work (a port log),
    else ``xla`` (a JAX log's cost estimate)."""
    return ("kernel" if any(k.startswith("kernel.") for k in counters)
            else "xla")


def analyze(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate one run's records (already filtered to a single run_id)."""
    manifest = next((r for r in records if r.get("event") == "run_manifest"),
                    None)
    run_end = next((r for r in records if r.get("event") == "run_end"), None)
    spans = [r for r in records if r.get("event") == "span"]
    stats = [r for r in records if _is_level_stat(r)]
    retries = [r for r in records if r.get("event") == "level_retry"]
    tune_resolved = [r for r in records if r.get("event") == "tune_resolved"]
    tune_errors = [r for r in records if r.get("event") in
                   ("tune_store_error", "tune_env_error")]
    coh_summaries = [r for r in records
                     if r.get("event") == "coherence_ratios"]

    # --- per-(phase, level) rows -----------------------------------------
    levels: Dict[Tuple[Optional[str], int], Dict[str, Any]] = {}

    def row(phase, level):
        key = (phase, level)
        if key not in levels:
            levels[key] = {"phase": phase, "level": level, "frames": 0,
                           "wall_ms": 0.0, "device_ms": 0.0, "pixels": 0,
                           "db_rows": 0, "coh_px": 0.0, "coh_known_px": 0}
        return levels[key]

    for st in stats:
        r = row(st.get("phase"), int(st["level"]))
        r["frames"] += 1
        r["pixels"] += int(st.get("pixels", 0))
        r["db_rows"] = max(r["db_rows"], int(st.get("db_rows", 0)))
        # device time: real compute under level_sync, enqueue otherwise
        r["device_ms"] += float(st.get("ms", st.get("enqueue_ms", 0.0)))
        if "total_ms" in st:
            r["wall_ms"] += float(st["total_ms"])
        if "coherence_ratio" in st and st.get("pixels"):
            r["coh_px"] += float(st["coherence_ratio"]) * int(st["pixels"])
            r["coh_known_px"] += int(st["pixels"])

    # sharded phase-end summaries carry the deferred coherence ratios the
    # streamed per-frame records omitted; join on (phase, level, frame)
    px_by_plf = {(st.get("phase"), int(st["level"]), st.get("frame")):
                 int(st.get("pixels", 0)) for st in stats}
    for summ in coh_summaries:
        phase = summ.get("phase")
        for key, ratio in (summ.get("ratios") or {}).items():
            try:
                lv_s, fr_s = key.split("_")
                lv, fr = int(lv_s[1:]), int(fr_s[1:])
            except (ValueError, IndexError):
                continue
            px = px_by_plf.get((phase, lv, fr))
            if px:
                r = row(phase, lv)
                r["coh_px"] += float(ratio) * px
                r["coh_known_px"] += px

    # level spans override the stat-side wall: they bracket the full host
    # iteration (features + scan + checkpoint io), and on the sharded path
    # they are the ONLY timing signal
    span_wall: Dict[Tuple[Optional[str], int], float] = {}
    for sp in spans:
        if sp.get("name") == "level" and "level" in sp:
            k = (sp.get("phase"), int(sp["level"]))
            span_wall[k] = span_wall.get(k, 0.0) + float(sp.get("wall_ms", 0))
    for k, wall in span_wall.items():
        row(k[0], k[1])["wall_ms"] = wall

    for r in levels.values():
        r["host_ms"] = max(r["wall_ms"] - r["device_ms"], 0.0) \
            if r["wall_ms"] else 0.0
        r["coherence_ratio"] = (r["coh_px"] / r["coh_known_px"]
                                if r["coh_known_px"] else None)

    # --- counters ---------------------------------------------------------
    counters: Dict[str, float] = {}
    if run_end:
        counters.update((run_end.get("metrics") or {}).get("counters", {}))
    # retries are visible even without the metrics toggle (failure.py
    # always emits the level_retry event)
    counters.setdefault("level_retry", 0)
    counters["level_retry"] = max(counters["level_retry"], len(retries))

    total_coh_px = sum(r["coh_px"] for r in levels.values())
    total_known_px = sum(r["coh_known_px"] for r in levels.values())

    hits = counters.get("devcache.hits", 0)
    misses = counters.get("devcache.misses", 0)

    # --- compile / kernel or XLA cost (obs.device) ------------------------
    compiles = [r for r in records if r.get("event") == "compile"]
    compile_info: Optional[Dict[str, Any]] = None
    cost = _cost_source(counters)
    if compiles or counters.get("compile.count") or cost == "kernel":
        level_flops: Dict[int, float] = {}
        for cr in compiles:
            if "level" in cr and cr.get("flops"):
                lv = int(cr["level"])
                level_flops[lv] = level_flops.get(lv, 0) + float(cr["flops"])
        compile_info = {
            "count": int(counters.get("compile.count", len(compiles))),
            "cache_hits": int(counters.get("compile.cache_hits", 0)),
            "total_ms": float(counters.get(
                "compile.ms",
                sum(float(c.get("ms", 0.0)) for c in compiles))),
            "flops": float(counters.get(f"{cost}.flops", 0.0)),
            "bytes": float(counters.get(f"{cost}.bytes", 0.0)),
            "programs": [{k: c[k] for k in ("name", "ms", "flops", "bytes",
                                            "level", "phase", "ok")
                          if k in c} for c in compiles],
            "level_flops": level_flops,
        }

    # --- tuned-geometry provenance (tune/resolve.py records) --------------
    tune_info: Optional[Dict[str, Any]] = None
    if (tune_resolved or tune_errors
            or any(k.startswith("tune.") for k in counters)
            or (manifest and "tune_store" in manifest)):
        tune_info = {
            "store": (manifest or {}).get("tune_store"),
            "store_entries": (manifest or {}).get("tune_entries"),
            "store_hits": int(counters.get("tune.store_hits", 0)),
            "packaged": int(counters.get("tune.packaged", 0)),
            "fallbacks": int(counters.get("tune.fallbacks", 0)),
            "env_overrides": int(counters.get("tune.env_overrides", 0)),
            "errors": len(tune_errors),
            # the JAX package's TPU tile knobs, or the port's launch
            # geometry (tune/resolve.py)
            "configs": [{k: r[k] for k in
                         ("key", "tile_rows", "packed_tile_cap",
                          "packed_vmem_limit", "chunks_per_sm",
                          "ring_stages", "scan_tile_cap", "origin")
                         if k in r}
                        for r in tune_resolved],
        }

    # --- serving section (serve_request records + serve.* counters) -------
    serve_reqs = [r for r in records if r.get("event") == "serve_request"]
    serve_info: Optional[Dict[str, Any]] = None
    if serve_reqs or any(k.startswith("serve.") for k in counters):
        done = [r for r in serve_reqs
                if r.get("status") in ("ok", "degraded")]
        lat = sorted(float(r.get("total_ms", 0.0)) for r in done)

        def pct(q):
            if not lat:
                return None
            return lat[min(len(lat) - 1,
                           int(round(q / 100.0 * (len(lat) - 1))))]

        batch_hist: Dict[int, int] = {}
        for r in done:
            bs = int(r.get("batch_size", 1))
            batch_hist[bs] = batch_hist.get(bs, 0) + 1
        accepted = int(counters.get("serve.accepted", len(serve_reqs)))
        rejected = int(counters.get("serve.rejected", 0))
        offered = accepted + rejected
        serve_info = {
            "accepted": accepted,
            "rejected": rejected,
            "reject_rate": (rejected / offered) if offered else 0.0,
            "completed": int(counters.get("serve.completed", len(done))),
            "degraded": int(counters.get(
                "serve.degraded",
                sum(1 for r in done if r.get("status") == "degraded"))),
            "timeouts": int(counters.get(
                "serve.timeouts",
                sum(1 for r in serve_reqs
                    if r.get("status") == "timeout"))),
            "errors": int(counters.get("serve.errors", 0)),
            "p50_ms": pct(50),
            "p95_ms": pct(95),
            "batch_size_hist": {str(k): v
                                for k, v in sorted(batch_hist.items())},
        }

    # --- tenant metering section (serve_cost records) ---------------------
    # One row per tenant (style == batcher exemplar sha1): request count,
    # dispatch-cost share, degrade/retry burden.  Built from the streamed
    # cost vectors so it works post-hoc on any journal-less run log.
    cost_recs = [r for r in records if r.get("event") == "serve_cost"]
    tenants_info: Optional[Dict[str, Any]] = None
    if cost_recs:
        by_tenant: Dict[str, Dict[str, Any]] = {}
        for cr in cost_recs:
            t = str(cr.get("tenant") or "?")
            row_t = by_tenant.setdefault(t, {
                "tenant": t, "requests": 0, "dispatch_ms": 0.0,
                "queue_ms": 0.0, "degraded": 0, "retries": 0,
                "wire_bytes": 0})
            row_t["requests"] += 1
            row_t["dispatch_ms"] += float(cr.get("dispatch_ms") or 0.0)
            row_t["queue_ms"] += float(cr.get("queue_ms") or 0.0)
            row_t["degraded"] += 1 if cr.get("degrade_levels") else 0
            row_t["retries"] += int(cr.get("retries") or 0)
            row_t["wire_bytes"] += int(cr.get("wire_bytes") or 0)
        total_cost_ms = sum(r["dispatch_ms"]
                            for r in by_tenant.values()) or 0.0
        rows_t = sorted(by_tenant.values(),
                        key=lambda r: (-r["dispatch_ms"], r["tenant"]))
        for r in rows_t:
            r["cost_share"] = (r["dispatch_ms"] / total_cost_ms
                               if total_cost_ms else 0.0)
        tenants_info = {"vectors": len(cost_recs),
                        "tenants": rows_t}

    # --- decision-attribution section (serve_decision + counters) ---------
    decision_recs = [r for r in records
                     if r.get("event") == "serve_decision"]
    decisions_info: Optional[Dict[str, Any]] = None
    if decision_recs or any(k.startswith("serve.decision.")
                            for k in counters):
        by_sv: Dict[str, int] = {}
        for dr in decision_recs:
            key = (f"{dr.get('site', '?')}:{dr.get('verdict', '?')}"
                   + (f"({dr['cause']})" if dr.get("cause") else ""))
            by_sv[key] = by_sv.get(key, 0) + 1
        by_verdict = {k.split("serve.decision.", 1)[1]: int(v)
                      for k, v in counters.items()
                      if k.startswith("serve.decision.")}
        decisions_info = {"records": len(decision_recs),
                          "by_site_verdict": by_sv,
                          "by_verdict": by_verdict}

    # --- catalog section (catalog.* counters + prefetch records) ----------
    # The exemplar catalog's tier ledger: per-tier hit/miss funnel
    # (HBM -> host -> disk -> cold build), quarantine + chaos-eviction
    # accounting, and the ring-placement prefetch summary.
    prefetch_recs = [r for r in records
                     if r.get("event") == "catalog_prefetch"]
    hists: Dict[str, Any] = {}
    if run_end:
        hists.update((run_end.get("metrics") or {}).get("histograms", {}))
    catalog_info: Optional[Dict[str, Any]] = None
    if prefetch_recs or any(k.startswith("catalog.") for k in counters):
        def _tier(name):
            h = int(counters.get(f"catalog.{name}.hits", 0))
            m = int(counters.get(f"catalog.{name}.misses", 0))
            return {"hits": h, "misses": m,
                    "hit_rate": (h / (h + m)) if (h + m) else None}

        cold = hists.get("catalog.cold_start_ms") or {}
        catalog_info = {
            "hbm": _tier("hbm"),
            "host": _tier("host"),
            "disk": _tier("disk"),
            "builds": int(counters.get("catalog.builds", 0)),
            "build_ms": {k: cold[k] for k in
                         ("count", "min", "max", "mean") if k in cold},
            "quarantined": int(counters.get("catalog.quarantined", 0)),
            "chaos_evictions": int(counters.get("catalog.chaos_evictions",
                                                0)),
            "host_evictions": int(counters.get("catalog.host.evictions",
                                               0)),
            "host_evicted_bytes": int(counters.get(
                "catalog.host.evicted_bytes", 0)),
            "disk_read_bytes": int(counters.get("catalog.disk.read_bytes",
                                                0)),
            "disk_write_bytes": int(counters.get("catalog.disk.write_bytes",
                                                 0)),
            "warmed": int(counters.get("catalog.warmed", 0)),
            "prefetch_styles": int(counters.get("catalog.prefetch.styles",
                                                0)),
            "prefetch_bytes": int(counters.get("catalog.prefetch.bytes",
                                               0)),
            "host_bytes": float(((run_end or {}).get("metrics") or {})
                                .get("gauges", {})
                                .get("catalog.host.bytes", 0.0)),
            # each fleet-join prefetch placement, in order
            "prefetch_events": [
                {k: r[k] for k in ("style", "worker", "entries", "bytes")
                 if k in r} for r in prefetch_recs],
        }

    # --- fleet section (router.* counters + router_* records) -------------
    handoff_recs = [r for r in records
                    if r.get("event") == "router_handoff"]
    router_info: Optional[Dict[str, Any]] = None
    if handoff_recs or any(k.startswith("router.") for k in counters):
        routed = {k.split("router.routed.", 1)[1]: int(v)
                  for k, v in counters.items()
                  if k.startswith("router.routed.")}
        codecs = {k.split("router.wire.", 1)[1]: int(v)
                  for k, v in counters.items()
                  if k.startswith("router.wire.")}
        router_info = {
            "requests": int(counters.get("router.requests", 0)),
            "routed": routed,
            "spills": int(counters.get("router.spills", 0)),
            "hop_faults": int(counters.get("router.hop_faults", 0)),
            "rejected": int(counters.get("router.rejected", 0)),
            "deaths": int(counters.get("router.deaths", 0)),
            "handoffs": int(counters.get("router.handoffs", 0)),
            "rechained": int(counters.get("router.rechained", 0)),
            "resubmitted": int(counters.get("router.resubmitted", 0)),
            "wire_bytes": int(counters.get("router.wire_bytes", 0)),
            "codecs": codecs,
            # each journal handoff, in order
            "handoff_events": [
                {k: r[k] for k in ("worker", "generation", "recovered")
                 if k in r} for r in handoff_recs],
        }

    # --- chaos section (chaos_inject records + chaos.* counters) ----------
    # The reconciliation ledger: injections on the left, the recovery
    # counters they caused on the right.  A drill (or an operator reading
    # a run log) checks the two sides account for each other.
    chaos_injects = [r for r in records if r.get("event") == "chaos_inject"]
    chaos_info: Optional[Dict[str, Any]] = None
    if chaos_injects or any(k.startswith("chaos.") for k in counters):
        by_site: Dict[str, int] = {}
        by_kind: Dict[str, int] = {}
        for name, v in counters.items():
            if name.startswith("chaos.site."):
                by_site[name.split("chaos.site.", 1)[1]] = int(v)
            elif name.startswith("chaos.injected."):
                by_kind[name.split("chaos.injected.", 1)[1]] = int(v)
        for cr in chaos_injects:  # records fill in when counters are off
            by_site.setdefault(str(cr.get("site")), 0)
            by_kind.setdefault(str(cr.get("kind")), 0)
        chaos_info = {
            "injected": int(counters.get("chaos.injected",
                                         len(chaos_injects))),
            "by_site": by_site,
            "by_kind": by_kind,
            "recovery": {
                "level_retry": int(counters.get("level_retry", 0)),
                "retry_exhausted": int(counters.get("retry.exhausted", 0)),
                "watchdog_timeouts": int(counters.get("watchdog.timeouts",
                                                      0)),
                "ckpt_quarantined": int(counters.get("ckpt.quarantined", 0)),
                "worker_crashes": int(counters.get("serve.worker_crashes",
                                                   0)),
                "requeued": int(counters.get("serve.requeued", 0)),
                "breaker_trips": int(counters.get("serve.breaker.trips", 0)),
            },
        }

    # --- soak section (soak/driver.py "soak_kill" records + the
    # in-replace autocompact counter): which workers the harness shot,
    # at which request, and how many corpse journals got offline-
    # compacted before their replacements opened them.
    soak_kills = [r for r in records if r.get("event") == "soak_kill"]
    soak_info: Optional[Dict[str, Any]] = None
    if soak_kills or counters.get("serve.journal.autocompact") \
            or counters.get("serve.journal.autocompact_refused"):
        soak_info = {
            "kills": [{k: r[k] for k in ("worker", "request") if k in r}
                      for r in soak_kills],
            "autocompacted": int(
                counters.get("serve.journal.autocompact", 0)),
            "autocompact_skipped": int(
                counters.get("serve.journal.autocompact_skipped", 0)),
            "autocompact_refused": int(
                counters.get("serve.journal.autocompact_refused", 0)),
        }

    # --- durability section (serve.journal.* counters + recovery records) -
    recoveries = [r for r in records if r.get("event") == "serve_recovery"]
    journal_info: Optional[Dict[str, Any]] = None
    if recoveries or any(k.startswith("serve.journal.") for k in counters):
        journal_info = {
            "admitted": int(counters.get("serve.journal.admitted", 0)),
            "dispatched": int(counters.get("serve.journal.dispatched", 0)),
            "done": int(counters.get("serve.journal.done", 0)),
            "rejected": int(counters.get("serve.journal.rejected", 0)),
            "poisoned": int(counters.get("serve.journal.poisoned", 0)),
            "replayed": int(counters.get("serve.journal.replayed", 0)),
            "deduped": int(counters.get("serve.journal.deduped", 0)),
            "quarantined": int(counters.get("serve.journal.quarantined", 0)),
            "poison_sheds": int(counters.get("serve.poisoned", 0)),
            "process_deaths": int(counters.get("serve.process_deaths", 0)),
            # flight-recorder seals (obs/recorder.py): how many black
            # boxes the death paths dumped during this run
            "blackbox_dumps": int(counters.get("obs.blackbox.dumps", 0)),
            # each restart's replay summary, in order
            "recoveries": [{k: r[k] for k in
                            ("entries", "replayed", "poisoned", "done",
                             "unrecoverable", "quarantined") if k in r}
                           for r in recoveries],
        }

    # --- per-device HBM peaks (run_end gauges + streamed hbm records) -----
    gauges: Dict[str, float] = {}
    if run_end:
        gauges.update((run_end.get("metrics") or {}).get("gauges", {}))
    hbm: Dict[str, float] = {
        name.split("hbm.peak_bytes.", 1)[1]: float(v)
        for name, v in gauges.items() if name.startswith("hbm.peak_bytes.")}
    for hr in (r for r in records if r.get("event") == "hbm"):
        for dev, v in (hr.get("peaks") or {}).items():
            hbm[dev] = max(hbm.get(dev, 0.0), float(v))

    # --- resource-ceiling section (obs/ceilings.py trend watchdogs) -------
    # Each ceiling_alarm record carries the robust (Theil-Sen) slope that
    # crossed its per-series growth threshold; the frozen run_end gauges
    # show where the process's vitals ended up.
    ceiling_recs = [r for r in records if r.get("event") == "ceiling_alarm"]
    ceilings_info: Optional[Dict[str, Any]] = None
    if ceiling_recs or any(k.startswith("obs.ceiling.") for k in counters):
        by_series = {k.split("obs.ceiling.", 1)[1]: int(v)
                     for k, v in counters.items()
                     if k.startswith("obs.ceiling.")
                     and k != "obs.ceiling.alarms"}
        ceilings_info = {
            "alarms": int(counters.get("obs.ceiling.alarms",
                                       len(ceiling_recs))),
            "by_series": by_series,
            "vitals": {k: gauges[k] for k in
                       ("proc.rss_bytes", "proc.open_fds", "proc.threads")
                       if gauges.get(k) is not None},
            # each alarm, in order
            "events": [{k: r[k] for k in
                        ("series", "slope_per_s", "threshold_per_s",
                         "value") if k in r} for r in ceiling_recs],
        }

    # --- pipeline-overlap section (driver pipeline.* gauges/counters) -----
    pipeline_info: Optional[Dict[str, Any]] = None
    if ("pipeline.host_gap_ms" in gauges
            or any(k.startswith("pipeline.") for k in counters)):
        gap = gauges.get("pipeline.host_gap_ms")
        prep = gauges.get("pipeline.prep_ms")
        hidden = gauges.get("pipeline.host_hidden_ms")
        pipeline_info = {
            # host time between successive level dispatches — the window
            # prefetch tries to hide; recorded even on sequential runs
            "host_gap_ms": gap,
            "prep_ms": prep,
            "wait_ms": gauges.get("pipeline.wait_ms"),
            "host_hidden_ms": hidden,
            "levels_prepped": int(counters.get("pipeline.levels_prepped",
                                               0)),
            "donated_levels": int(counters.get("pipeline.donated_levels",
                                               0)),
            "prefetch_errors": int(counters.get("pipeline.prefetch_errors",
                                                0)),
            # fraction of the prefetch worker's host time that the device
            # program absorbed (1.0 = fully overlapped)
            "hidden_fraction": (hidden / prep
                                if hidden is not None and prep else None),
        }

    # --- SLO section (obs/slo.py counters + run_end gauges) ---------------
    slo_info: Optional[Dict[str, Any]] = None
    if "slo.deadlined" in counters or "slo.target" in gauges:
        deadlined = int(counters.get("slo.deadlined", 0))
        violations = int(counters.get("slo.violations", 0))
        slo_info = {
            "target": gauges.get("slo.target"),
            "deadlined": deadlined,
            "violations": violations,
            # lifetime attainment from counters; the rolling-window view
            # lives in the gauges below (frozen at run_end)
            "attainment": ((deadlined - violations) / deadlined
                           if deadlined else None),
            "burn_rate_fast": gauges.get("slo.burn_rate.fast"),
            "burn_rate_slow": gauges.get("slo.burn_rate.slow"),
        }

    # --- batched-engine section (batch.* counters + lane records) ---------
    lane_recs = [r for r in records if r.get("event") == "serve_batch_lane"]
    batch_info: Optional[Dict[str, Any]] = None
    if lane_recs or any(k.startswith("batch.") for k in counters):
        fallbacks = {k.split("batch.fallback_sequential.", 1)[1]: int(v)
                     for k, v in counters.items()
                     if k.startswith("batch.fallback_sequential.")}
        batch_info = {
            "launches": int(counters.get("batch.launches", 0)),
            "lanes": int(counters.get("batch.lanes", 0)),
            "lane_faults": int(counters.get("batch.lane_faults", 0)),
            # finest-level dead-row fraction of the last admitted launch
            # (frozen at run_end); 0 when every member filled its bucket
            "pad_waste_frac": gauges.get("batch.pad_waste_frac"),
            "fallbacks": fallbacks,
        }

    # --- ANN section (ann.* counters + gate/prefilter records) ------------
    # The two-stage matcher's ledger: the parity gate's verdicts, each
    # level's prefilter engagement with its basis source, sealed-artifact
    # integrity (quarantines + rebuilds), and the exact-fallback count
    # that accounts for every request the matcher declined.
    gate_recs = [r for r in records if r.get("event") == "ann_gate"]
    engage_recs = [r for r in records if r.get("event") == "ann_prefilter"]
    ann_info: Optional[Dict[str, Any]] = None
    if (gate_recs or engage_recs
            or any(k.startswith("ann.") for k in counters)):
        ann_info = {
            "prefilter_used": int(counters.get("ann.prefilter_used", 0)),
            "fallback_exact": int(counters.get("ann.fallback_exact", 0)),
            "gate_ok": int(counters.get("ann.gate_ok", 0)),
            "disabled_unexplained": int(counters.get(
                "ann.disabled_unexplained", 0)),
            "artifact_hits": int(counters.get("ann.artifact_hits", 0)),
            "artifacts_built": int(counters.get("ann.artifacts_built", 0)),
            "artifacts_rebuilt": int(counters.get(
                "ann.artifacts_rebuilt", 0)),
            "projection_built": int(counters.get(
                "ann.projection_built", 0)),
            "quarantined": int(counters.get("ann.quarantined", 0)),
            "chaos_corruptions": int(counters.get(
                "ann.chaos_corruptions", 0)),
            "artifact_write_bytes": int(counters.get(
                "ann.artifact_write_bytes", 0)),
            "top_m": gauges.get("ann.top_m"),
            "proj_dims": gauges.get("ann.proj_dims"),
            # each gate verdict, in order (one per device class+strategy)
            "gates": [{k: r[k] for k in
                       ("device", "strategy", "ok", "mismatches",
                        "unexplained") if k in r} for r in gate_recs],
            # each level's prefilter engagement, in order
            "engagements": [{k: r[k] for k in
                             ("level", "strategy", "source", "top_m",
                              "proj_dims", "db_rows") if k in r}
                            for r in engage_recs],
        }

    # --- cross-hop trace section (ambient trace ids on records) -----------
    # Every record stamped inside a request_context carries the trace id
    # the HTTP hop adopted (or the router minted); grouping by it shows
    # each request's whole journey — http -> router -> worker -> engine —
    # even when the hops wrote to two isolated worker registries.
    traced = [r for r in records if isinstance(r.get("trace"), str)
              and r.get("trace")]
    traces_info: Optional[List[Dict[str, Any]]] = None
    if traced:
        by_trace: Dict[str, List[Dict[str, Any]]] = {}
        for r in traced:
            by_trace.setdefault(r["trace"], []).append(r)
        traces_info = []
        for tid in by_trace:  # insertion order == first-seen order
            recs = by_trace[tid]
            traces_info.append({
                "trace": tid,
                "records": len(recs),
                "spans": sum(1 for r in recs if r.get("event") == "span"),
                "events": sorted({str(r.get("event") or r.get("name")
                                      or "record") for r in recs}),
                "workers": sorted({str(r["worker"]) for r in recs
                                   if r.get("worker")}),
                "requests": sorted({str(r["request"]) for r in recs
                                    if r.get("request")}),
            })

    return {
        "manifest": manifest,
        "run_end": run_end,
        "levels": [levels[k] for k in sorted(
            levels, key=lambda k: (str(k[0] or ""), -k[1]))],
        "counters": counters,
        "retries": len(retries),
        "kappa_pick_ratio": (total_coh_px / total_known_px
                             if total_known_px else None),
        "devcache_hit_rate": (hits / (hits + misses)
                              if (hits + misses) else None),
        "compile": compile_info,
        "tune": tune_info,
        "pipeline": pipeline_info,
        "serve": serve_info,
        "tenants": tenants_info,
        "decisions": decisions_info,
        "batch": batch_info,
        "ann": ann_info,
        "catalog": catalog_info,
        "router": router_info,
        "slo": slo_info,
        "ceilings": ceilings_info,
        "traces": traces_info,
        "journal": journal_info,
        "chaos": chaos_info,
        "soak": soak_info,
        "hbm": hbm or None,
        "spans": spans,
        "n_records": len(records),
    }


def render(an: Dict[str, Any], run_id: Optional[str] = None) -> str:
    out: List[str] = []
    w = out.append

    w(f"run {run_id or '(unstamped)'} — {an['n_records']} records")
    man = an["manifest"]
    if man:
        keys = ("config_hash", "backend", "strategy", "mesh", "levels",
                "device_kind", "device_count", "platform", "git_rev",
                "jax_version", "torch_version", "power_limit", "metrics")
        w("  manifest:")
        for k in keys:
            if k in man and man[k] is not None:
                w(f"    {k:<13} {man[k]}")

    if an["levels"]:
        w("  per-level timing (ms):")
        w(f"    {'phase':<8} {'lvl':>3} {'frames':>6} {'wall':>10} "
          f"{'device':>10} {'host':>10} {'pixels':>10} {'coh%':>6}")
        tot_wall = tot_dev = 0.0
        for r in an["levels"]:
            coh = (f"{100 * r['coherence_ratio']:.1f}"
                   if r["coherence_ratio"] is not None else "-")
            w(f"    {str(r['phase'] or '-'):<8} {r['level']:>3} "
              f"{r['frames']:>6} {r['wall_ms']:>10.1f} "
              f"{r['device_ms']:>10.1f} {r['host_ms']:>10.1f} "
              f"{r['pixels']:>10} {coh:>6}")
            tot_wall += r["wall_ms"]
            tot_dev += r["device_ms"]
        w(f"    {'total':<8} {'':>3} {'':>6} {tot_wall:>10.1f} "
          f"{tot_dev:>10.1f} {max(tot_wall - tot_dev, 0.0):>10.1f}")

    w("  counters:")
    c = an["counters"]
    if an["devcache_hit_rate"] is not None:
        w(f"    devcache      {int(c.get('devcache.hits', 0))} hits / "
          f"{int(c.get('devcache.misses', 0))} misses "
          f"(hit rate {100 * an['devcache_hit_rate']:.1f}%), "
          f"uploaded {_fmt_bytes(c.get('devcache.upload_bytes', 0))}")
    w(f"    retries       {an['retries']}")
    if an["kappa_pick_ratio"] is not None:
        w(f"    kappa picks   {100 * an['kappa_pick_ratio']:.1f}% coherence "
          f"/ {100 * (1 - an['kappa_pick_ratio']):.1f}% approx")
    if c.get("mesh.level_steps"):
        w(f"    mesh steps    {int(c['mesh.level_steps'])}, "
          f"psum-gather ~{_fmt_bytes(c.get('mesh.psum_gather_bytes', 0))}")
    if c.get("fetch.bytes"):
        w(f"    fetched       {_fmt_bytes(c['fetch.bytes'])}")
    shown = {"devcache.hits", "devcache.misses", "devcache.upload_bytes",
             "level_retry", "mesh.level_steps", "mesh.psum_gather_bytes",
             "fetch.bytes", "kappa.coherence_px", "kappa.total_px",
             "compile.count", "compile.ms", "compile.cache_hits",
             "xla.flops", "xla.bytes", "kernel.flops", "kernel.bytes",
             "tune.store_hits", "tune.fallbacks",
             "tune.env_overrides", "tune.packaged"}
    # serve.*/chaos.* and the recovery counters render in their own
    # serving/chaos sections below
    rest = {k: v for k, v in c.items()
            if k not in shown and v
            and not k.startswith(("serve.", "chaos.", "watchdog.",
                                  "ckpt.", "retry.", "pipeline.",
                                  "router.", "batch.", "catalog.",
                                  "ann.", "obs.ceiling."))}
    for k in sorted(rest):
        w(f"    {k:<13} {rest[k]:g}")

    comp = an.get("compile")
    if comp:
        w("  compile:")
        w(f"    programs      {comp['count']} compiled / "
          f"{comp['cache_hits']} cache hits, total {comp['total_ms']:.1f} ms")
        if comp["flops"] or comp["bytes"]:
            label = f"{_cost_source(an['counters'])} cost"
            w(f"    {label:<13} {comp['flops']:.4g} flops executed, "
              f"{_fmt_bytes(comp['bytes'])} accessed")
        # achieved TFLOPs where BOTH a cost estimate and a device time
        # exist for the level (compile events carry one execution's flops;
        # the solo path runs each level program once per frame)
        dev_ms = {r["level"]: r["device_ms"] for r in an["levels"]
                  if r.get("device_ms")}
        for lv in sorted(comp["level_flops"], reverse=True):
            ms = dev_ms.get(lv)
            if ms:
                tf = comp["level_flops"][lv] / (ms * 1e9)
                w(f"    L{lv} achieved   ~{tf:.4g} TFLOP/s "
                  f"({comp['level_flops'][lv]:.3g} flops est / "
                  f"{ms:.1f} ms device)")

    tune = an.get("tune")
    if tune:
        w("  tune:")
        if tune.get("store"):
            w(f"    store         {tune['store']} "
              f"({tune.get('store_entries', 0)} entries)")
        w(f"    resolutions   {tune['store_hits']} store / "
          f"{tune.get('packaged', 0)} packaged / "
          f"{tune['fallbacks']} default / {tune['env_overrides']} env")
        if tune["errors"]:
            w(f"    errors        {tune['errors']} "
              "(corrupt store / bad env — defaults used)")
        for cfg in tune["configs"]:
            origins = ",".join(sorted(set(
                (cfg.get("origin") or {}).values())))
            if "chunks_per_sm" in cfg and "tile_rows" not in cfg:
                knobs = (f"chunks={cfg.get('chunks_per_sm')} "
                         f"stages={cfg.get('ring_stages')} "
                         f"cap={cfg.get('scan_tile_cap')}")
            else:
                knobs = (f"tile_rows={cfg.get('tile_rows')} "
                         f"cap={cfg.get('packed_tile_cap')}")
            w(f"    {cfg.get('key', '?'):<36} {knobs} [{origins}]")

    pl = an.get("pipeline")
    if pl:
        w("  pipeline:")
        gap = pl.get("host_gap_ms")
        if gap is not None:
            w(f"    host gap      {gap:.1f} ms between level dispatches")
        if pl.get("prep_ms") is not None:
            hid = pl.get("host_hidden_ms") or 0.0
            frac = pl.get("hidden_fraction")
            w(f"    overlap       {pl['levels_prepped']} levels prepped, "
              f"{pl['prep_ms']:.1f} ms prep / {hid:.1f} ms hidden under "
              f"device"
              + (f" ({100 * frac:.0f}%)" if frac is not None else ""))
            w(f"    join wait     {pl.get('wait_ms', 0.0):.1f} ms")
        if pl.get("donated_levels"):
            w(f"    donation      {pl['donated_levels']} levels donated "
              "their chained B' buffer")
        if pl.get("prefetch_errors"):
            w(f"    prefetch errs {pl['prefetch_errors']} (swallowed — "
              "main path rebuilt cold)")

    srv = an.get("serve")
    if srv:
        w("  serving:")
        w(f"    admission     {srv['accepted']} accepted / "
          f"{srv['rejected']} rejected "
          f"(reject rate {100 * srv['reject_rate']:.1f}%)")
        w(f"    outcomes      {srv['completed']} completed, "
          f"{srv['degraded']} degraded, {srv['timeouts']} timeout, "
          f"{srv['errors']} error")
        if srv["p50_ms"] is not None:
            w(f"    latency       p50 {srv['p50_ms']:.1f} ms / "
              f"p95 {srv['p95_ms']:.1f} ms")
        if srv["batch_size_hist"]:
            hist = ", ".join(f"{k}x{v}" for k, v in
                             srv["batch_size_hist"].items())
            w(f"    batch sizes   {hist}  (size x count)")

    tn = an.get("tenants")
    if tn:
        w("  tenants:")
        w(f"    cost vectors  {tn['vectors']} recorded")
        for r in tn["tenants"][:12]:
            w(f"    {str(r['tenant'])[:12]:<13} {r['requests']:>5} reqs  "
              f"{100 * r['cost_share']:>5.1f}% cost  "
              f"{r['dispatch_ms']:>8.1f} ms dispatch  "
              f"{r['degraded']} degraded / {r['retries']} retries")
        if len(tn["tenants"]) > 12:
            w(f"    ... {len(tn['tenants']) - 12} more tenants")

    dec = an.get("decisions")
    if dec:
        w("  decisions:")
        verdicts = ", ".join(f"{k}x{v}" for k, v in
                             sorted(dec["by_verdict"].items()))
        w(f"    verdicts      {verdicts or '-'}  (verdict x count)")
        for key in sorted(dec["by_site_verdict"]):
            w(f"    {key:<36} {dec['by_site_verdict'][key]}")

    be = an.get("batch")
    if be:
        w("  batched engine:")
        launches, lanes = be["launches"], be["lanes"]
        w(f"    launches      {launches} device launches / {lanes} lanes"
          + (f" (mean {lanes / launches:.1f} lanes/launch)"
             if launches else ""))
        if be["pad_waste_frac"] is not None:
            w(f"    pad waste     {100 * be['pad_waste_frac']:.1f}% dead "
              "rows at the finest level")
        if be["lane_faults"]:
            w(f"    lane faults   {be['lane_faults']} isolated "
              "(surviving lanes completed)")
        if be["fallbacks"]:
            fb = ", ".join(f"{k}x{v}" for k, v in
                           sorted(be["fallbacks"].items()))
            w(f"    fallbacks     {fb}  (reason x count)")

    cat = an.get("catalog")
    if cat:
        w("  catalog:")

        def _tier_line(label, t):
            rate = (f" (hit rate {100 * t['hit_rate']:.1f}%)"
                    if t["hit_rate"] is not None else "")
            w(f"    {label:<13} {t['hits']} hits / {t['misses']} misses"
              + rate)

        _tier_line("hbm tier", cat["hbm"])
        _tier_line("host tier", cat["host"])
        _tier_line("disk tier", cat["disk"])
        bm = cat["build_ms"]
        w(f"    cold builds   {cat['builds']}"
          + (f" ({bm['mean']:.1f} ms mean / {bm['max']:.1f} ms max)"
             if bm.get("count") else ""))
        if cat["host_bytes"] or cat["host_evictions"]:
            w(f"    host tier     {_fmt_bytes(cat['host_bytes'])} resident, "
              f"{cat['host_evictions']} evictions "
              f"({_fmt_bytes(cat['host_evicted_bytes'])})")
        if cat["disk_read_bytes"] or cat["disk_write_bytes"]:
            w(f"    disk io       {_fmt_bytes(cat['disk_read_bytes'])} "
              f"read / {_fmt_bytes(cat['disk_write_bytes'])} written")
        if cat["quarantined"] or cat["chaos_evictions"]:
            w(f"    integrity     {cat['quarantined']} entries quarantined, "
              f"{cat['chaos_evictions']} chaos tier evictions")
        if cat["warmed"] or cat["prefetch_styles"]:
            w(f"    prefetch      {cat['warmed']} entries warmed, "
              f"{cat['prefetch_styles']} styles placed "
              f"({_fmt_bytes(cat['prefetch_bytes'])})")
        for pf in cat["prefetch_events"]:
            w(f"    placed        {pf.get('style', '?')} -> "
              f"{pf.get('worker', '?')} ({pf.get('entries', 0)} entries, "
              f"{_fmt_bytes(pf.get('bytes', 0))})")

    ann = an.get("ann")
    if ann:
        w("  ann matcher:")
        knobs = ""
        if ann["top_m"] is not None:
            knobs = (f" (top_m={int(ann['top_m'])}, "
                     f"proj_dims={int(ann['proj_dims'] or 0)})")
        w(f"    two-stage     {ann['prefilter_used']} levels prefiltered "
          f"/ {ann['fallback_exact']} exact fallbacks{knobs}")
        if ann["gate_ok"] or ann["disabled_unexplained"]:
            w(f"    parity gate   {ann['gate_ok']} ok / "
              f"{ann['disabled_unexplained']} refused "
              "(unexplained divergence)")
        sealed = ann["artifacts_built"] + ann["artifacts_rebuilt"]
        w(f"    bases         {ann['artifact_hits']} artifact hits / "
          f"{ann['projection_built']} device builds / {sealed} sealed "
          f"({_fmt_bytes(ann['artifact_write_bytes'])})")
        if ann["quarantined"] or ann["chaos_corruptions"]:
            w(f"    integrity     {ann['quarantined']} artifacts "
              f"quarantined, {ann['chaos_corruptions']} chaos corruptions")
        for g in ann["gates"]:
            w(f"    gate          {g.get('device', '?')} "
              f"{'ok' if g.get('ok') else 'REFUSED'} "
              f"(mismatches={g.get('mismatches', '?')}, "
              f"unexplained={g.get('unexplained', '?')})")

    rt = an.get("router")
    if rt:
        w("  fleet:")
        routed = ", ".join(f"{k}x{v}" for k, v in
                           sorted(rt["routed"].items()))
        w(f"    routing       {rt['requests']} requests -> "
          f"{routed or '-'}  (worker x count)")
        w(f"    resilience    {rt['spills']} spills, "
          f"{rt['hop_faults']} hop faults, {rt['rejected']} rejected")
        if rt["deaths"] or rt["handoffs"]:
            w(f"    handoff       {rt['deaths']} deaths -> "
              f"{rt['handoffs']} journal handoffs, "
              f"{rt['rechained']} futures rechained, "
              f"{rt['resubmitted']} resubmitted")
        for i, ho in enumerate(rt["handoff_events"]):
            rcv = ho.get("recovered") or {}
            w(f"    handoff {i:<5} {ho.get('worker', '?')} "
              f"gen {ho.get('generation', '?')}: "
              f"entries={rcv.get('entries', 0)} "
              f"replayed={rcv.get('replayed', 0)} "
              f"done={rcv.get('done', 0)} "
              f"poisoned={rcv.get('poisoned', 0)}")
        if rt["codecs"]:
            codecs = ", ".join(f"{k}x{v}" for k, v in
                               sorted(rt["codecs"].items()))
            w(f"    wire          {codecs} "
              f"({_fmt_bytes(rt['wire_bytes'])} framed)")

    slo = an.get("slo")
    if slo:
        w("  slo:")
        target = slo.get("target")
        attain = slo.get("attainment")
        if target is not None:
            w(f"    target        {100 * target:.2f}%")
        w(f"    deadlined     {slo['deadlined']} requests, "
          f"{slo['violations']} violations"
          + (f" (attainment {100 * attain:.2f}%)"
             if attain is not None else ""))
        bf, bs = slo.get("burn_rate_fast"), slo.get("burn_rate_slow")
        if bf is not None or bs is not None:
            w(f"    burn rate     fast {bf if bf is not None else '-'} / "
              f"slow {bs if bs is not None else '-'}  "
              "(1.0 = exactly on budget)")

    ce = an.get("ceilings")
    if ce:
        w("  ceilings:")
        series = ", ".join(f"{k}x{v}" for k, v in
                           sorted(ce["by_series"].items()))
        w(f"    alarms        {ce['alarms']}  ({series or '-'})")
        vit = ce["vitals"]
        if vit:
            parts = []
            if vit.get("proc.rss_bytes") is not None:
                parts.append(f"rss {_fmt_bytes(vit['proc.rss_bytes'])}")
            if vit.get("proc.open_fds") is not None:
                parts.append(f"{int(vit['proc.open_fds'])} fds")
            if vit.get("proc.threads") is not None:
                parts.append(f"{int(vit['proc.threads'])} threads")
            w(f"    vitals        {', '.join(parts)}")
        for ev in ce["events"]:
            w(f"    alarm         {ev.get('series', '?')}: "
              f"+{_fmt_bytes(ev.get('slope_per_s', 0))}/s over the "
              f"{_fmt_bytes(ev.get('threshold_per_s', 0))}/s ceiling "
              f"(at {_fmt_bytes(ev.get('value', 0))})")

    trs = an.get("traces")
    if trs:
        w("  traces:")
        for t in trs:
            w(f"    {t['trace']:<16} {t['records']} records / "
              f"{t['spans']} spans"
              f"  workers={','.join(t['workers']) or '-'}"
              f"  requests={','.join(t['requests']) or '-'}")

    jn = an.get("journal")
    if jn:
        w("  durability:")
        w(f"    journal       {jn['admitted']} admitted -> "
          f"{jn['done']} done, {jn['rejected']} rejected, "
          f"{jn['poisoned']} poisoned "
          f"({jn['dispatched']} dispatch attempts)")
        w(f"    exactly-once  {jn['deduped']} duplicate submissions "
          f"answered from the journal, {jn['poison_sheds']} poison sheds")
        if (jn["replayed"] or jn["process_deaths"] or jn["quarantined"]
                or jn["recoveries"]):
            w(f"    recovery      {jn['replayed']} replayed across "
              f"{len(jn['recoveries'])} restart(s), "
              f"{jn['process_deaths']} process deaths, "
              f"{jn['quarantined']} journal files quarantined")
        if jn.get("blackbox_dumps"):
            w(f"    blackbox      {jn['blackbox_dumps']} flight-recorder "
              f"dump(s) sealed (ia blackbox <journal-dir>)")
        for i, rcv in enumerate(jn["recoveries"]):
            w(f"    restart {i:<5} entries={rcv.get('entries', 0)} "
              f"replayed={rcv.get('replayed', 0)} "
              f"done={rcv.get('done', 0)} "
              f"poisoned={rcv.get('poisoned', 0)} "
              f"unrecoverable={rcv.get('unrecoverable', 0)}")

    cha = an.get("chaos")
    if cha:
        w("  chaos:")
        kinds = ", ".join(f"{k}x{v}" for k, v in
                          sorted(cha["by_kind"].items()))
        sites = ", ".join(f"{k}x{v}" for k, v in
                          sorted(cha["by_site"].items()))
        w(f"    injected      {cha['injected']}  ({kinds or '-'})")
        if sites:
            w(f"    sites         {sites}")
        rec = cha["recovery"]
        w(f"    recovery      {rec['level_retry']} retries "
          f"({rec['retry_exhausted']} exhausted), "
          f"{rec['watchdog_timeouts']} watchdog timeouts, "
          f"{rec['ckpt_quarantined']} ckpt quarantined")
        if rec["worker_crashes"] or rec["requeued"] or rec["breaker_trips"]:
            w(f"    containment   {rec['worker_crashes']} worker crashes, "
              f"{rec['requeued']} requeued, "
              f"{rec['breaker_trips']} breaker trips")

    soak = an.get("soak")
    if soak:
        w("  soak:")
        shots = ", ".join(
            f"{k.get('worker', '?')}@{k.get('request', '?')}"
            for k in soak["kills"])
        w(f"    kills         {len(soak['kills'])}  ({shots or '-'})")
        w(f"    autocompact   {soak['autocompacted']} corpse journal(s) "
          f"compacted in-replace, "
          f"{soak.get('autocompact_skipped', 0)} skipped "
          f"(single-segment), {soak['autocompact_refused']} refused")

    hbm = an.get("hbm")
    if hbm:
        w("  hbm peak:")
        for dev in sorted(hbm):
            w(f"    {dev:<13} {_fmt_bytes(hbm[dev])}")

    other = [sp for sp in an["spans"] if sp.get("name") != "level"]
    if other:
        agg: Dict[str, List[float]] = {}
        for sp in other:
            agg.setdefault(sp["name"], []).append(
                float(sp.get("wall_ms", 0)))
        w("  spans:")
        for name in sorted(agg, key=lambda n: -sum(agg[n])):
            v = agg[name]
            w(f"    {name:<20} n={len(v):<4} total {sum(v):>9.1f} ms")
    return "\n".join(out)


def _by_run(records: List[Dict[str, Any]]) \
        -> Dict[Optional[str], List[Dict[str, Any]]]:
    by_run: Dict[Optional[str], List[Dict[str, Any]]] = {}
    for rec in records:
        by_run.setdefault(rec.get("run_id"), []).append(rec)
    return by_run


def report(path: str) -> str:
    """Analyze a run-log JSONL; one section per run_id found in it."""
    records = load_records(path)
    if not records:
        return f"{path}: no records"
    sections = []
    by_run = _by_run(records)
    for run_id in by_run:  # insertion order == file order
        sections.append(render(analyze(by_run[run_id]), run_id))
    return "\n\n".join(sections)


def report_json(path: str) -> str:
    """Machine-readable `ia report --json`: the analyze() dict per run
    (manifest, levels, counters, compile/HBM sections), so bench/CI can
    diff runs without scraping the text renderer."""
    records = load_records(path)
    runs = []
    by_run = _by_run(records)
    for run_id in by_run:
        an = analyze(by_run[run_id])
        an["run_id"] = run_id
        runs.append(an)
    return json.dumps({"path": path, "runs": runs}, indent=2,
                      sort_keys=True, default=str)
