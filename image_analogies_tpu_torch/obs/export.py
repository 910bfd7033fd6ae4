"""`ia trace` — run-log JSONL to Chrome/Perfetto trace.json (the port's
copy of the JAX package's ``obs/export.py``).

Maps the run log's record kinds onto the Chrome Trace Event Format so a
north-star run can be opened in ``chrome://tracing`` / Perfetto:

- ``span`` records become ``ph=X`` complete events on the HOST track.
  Spans are emitted at exit carrying ``wall_ms`` and an exit ``ts``, so
  the event start is ``ts - wall_ms/1e3``; nesting falls out of the
  interval containment (a child span closes before its parent).
- level stat records (``ms`` / ``enqueue_ms``) become ``ph=X`` events on
  the DEVICE track — real device compute under level_sync, enqueue cost
  otherwise (the record says which by field name).
- ``compile`` records (obs.device) become ``ph=X`` events on the
  COMPILE track: the port's ``nvcc`` library builds (a JAX log's
  records carry the XLA cost estimate in args).
- everything else (manifest, run_end, retries, run_join, hbm, coherence
  summaries) becomes a ``ph=i`` instant on the host track.

One Chrome ``pid`` per run_id; tids 1/2/3 = host/device/compile, named
via ``ph=M`` metadata events (which carry ``ts``/``dur`` 0 so every
event in the file uniformly has ph/ts/pid/tid and dur-or-instant).
Timestamps are microseconds relative to the earliest event start.

Cross-hop traces: a record carrying a ``trace`` attr (stamped by the
ambient request context — HTTP front end, router, worker, engine spans
all share one id via X-IA-Trace / the IAT1 wire frame) is re-homed onto
a per-trace track (tids from 16 up, named ``trace <id>``), so one
request's whole journey — even across two isolated worker registries —
renders as a single horizontal track instead of being scattered over
the host/serve/device lanes.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from image_analogies_tpu_torch.obs.report import _is_level_stat, load_records

HOST_TID = 1
DEVICE_TID = 2
COMPILE_TID = 3
SERVE_TID = 4
CHAOS_TID = 5

_TID_NAMES = {HOST_TID: "host", DEVICE_TID: "device", COMPILE_TID: "compile",
              SERVE_TID: "serve", CHAOS_TID: "chaos"}

# Records stamped with a trace id get their own per-trace track; the
# base leaves room below for future fixed lanes without renumbering.
TRACE_TID_BASE = 16

# bookkeeping fields that don't belong in an event's args payload
_DROP_ARGS = ("ts",)


def _classify(rec: Dict[str, Any]) -> Tuple[str, int, str, Optional[float]]:
    """(ph, tid, name, dur_ms) of one record."""
    ev = rec.get("event")
    if ev == "span":
        tid = (SERVE_TID if rec.get("name") in ("serve_batch",
                                                "serve_dispatch",
                                                "serve_warmup")
               else HOST_TID)
        return "X", tid, str(rec.get("name", "span")), \
            float(rec.get("wall_ms", 0.0))
    if ev == "compile":
        return "X", COMPILE_TID, f"compile {rec.get('name', '?')}", \
            float(rec.get("ms", 0.0))
    if ev == "serve_request":
        # emitted at completion with total_ms = enqueue->done, so the
        # ph=X interval spans the request's whole lifetime on the serve
        # track; queue_ms/dispatch_ms ride in args for inspection
        return ("X", SERVE_TID,
                f"req {rec.get('request', '?')} "
                f"{rec.get('status', '?')}",
                float(rec.get("total_ms", 0.0)))
    if ev in ("serve_admit", "serve_degrade_decision"):
        # request-chain instants on the serve track: together with the
        # queue_ms/dispatch_ms-bearing serve_request interval these make
        # one request's critical path readable end to end (admit ->
        # queue wait -> batch -> dispatch -> degrade decision), all
        # joined by the shared `request` id in args.
        verb = "admit" if ev == "serve_admit" else "degrade"
        return "i", SERVE_TID, f"{verb} r{rec.get('request', '?')}", None
    if ev == "serve_batch_lane":
        # batched-engine lane instants on the serve track: which lane of
        # the shared launch answered (or faulted) which request
        return ("i", SERVE_TID,
                f"lane {rec.get('lane', '?')} r{rec.get('request', '?')} "
                f"{rec.get('status', '?')}", None)
    if ev in ("serve_replay", "serve_recovery", "serve_dedupe"):
        # durability-plane instants on the serve track: journal replay
        # actions, the recovery summary, and dedupe short-circuits sit
        # next to the request intervals they stand in for
        if ev == "serve_replay":
            name = f"replay {rec.get('action', '?')} {rec.get('idem', '?')}"
        elif ev == "serve_dedupe":
            name = f"dedupe {rec.get('idem', '?')}"
        else:
            name = (f"recovery replayed={rec.get('replayed', 0)} "
                    f"done={rec.get('done', 0)}")
        return "i", SERVE_TID, name, None
    if ev == "serve_decision":
        # decision-attribution instants on the serve track: every
        # control-plane verdict (degrade, shed, spill, poison, dedupe,
        # re-chain) that shaped a request's fate, with site + cause in
        # args.  Trace-stamped ones re-home to their per-trace track, so
        # a request's verdicts line up under its own request chain.
        name = (f"{rec.get('site', '?')} {rec.get('verdict', '?')}"
                + (f" ({rec['cause']})" if rec.get("cause") else ""))
        return "i", SERVE_TID, name, None
    if ev == "serve_cost":
        # cost-vector instants close each request's chain on the serve
        # track: tenant + queue/dispatch split + lanes in args
        return ("i", SERVE_TID,
                f"cost {str(rec.get('tenant', '?'))[:8]} "
                f"{rec.get('dispatch_ms', 0)}ms", None)
    if ev in ("router_route", "router_spill", "router_rechain",
              "router_resubmit"):
        # routing-plane instants share the serve track: a request's hop
        # (or spillover walk) sits next to the serve interval it fed
        if ev == "router_route":
            name = f"route {rec.get('idem', '?')} -> {rec.get('worker', '?')}"
        elif ev == "router_spill":
            name = (f"spill {rec.get('idem', '?')} "
                    f"{rec.get('home', '?')} -> {rec.get('to', '?')}")
        else:
            verb = "rechain" if ev == "router_rechain" else "resubmit"
            name = f"{verb} {rec.get('idem', '?')}"
        return "i", SERVE_TID, name, None
    if ev in ("router_death", "router_handoff"):
        # fleet lifecycle instants on the fault track, next to the
        # process death that caused them
        if ev == "router_death":
            name = f"worker death {rec.get('worker', '?')}"
        else:
            name = (f"journal handoff {rec.get('worker', '?')} "
                    f"gen {rec.get('generation', '?')}")
        return "i", CHAOS_TID, name, None
    if ev in ("ann_gate", "ann_prefilter"):
        # two-stage matcher instants on the host track: the parity
        # gate's verdict and each level's prefilter engagement (with its
        # basis source and slab size in args)
        if ev == "ann_gate":
            name = (f"ann gate {'ok' if rec.get('ok') else 'refused'} "
                    f"{rec.get('device', '?')}")
        else:
            name = (f"ann prefilter L{rec.get('level', '?')} "
                    f"{rec.get('source', '?')} m={rec.get('top_m', '?')}")
        return "i", HOST_TID, name, None
    if ev in ("chaos_inject", "ckpt_quarantined", "journal_quarantined",
              "ann_quarantined", "watchdog_timeout",
              "retry_exhausted", "serve_worker_crash", "serve_process_death",
              "breaker_open",
              "breaker_half_open", "breaker_closed", "blackbox_dump"):
        # fault-plane instants on their own track: injections line up
        # visually against the retries/quarantines/crashes they caused
        if ev == "chaos_inject":
            name = f"inject {rec.get('kind', '?')} @{rec.get('site', '?')}"
        elif ev == "blackbox_dump":
            # the flight-recorder seal sits NEXT to the fault that
            # triggered it on the same track
            name = f"blackbox {rec.get('reason', '?')}"
        else:
            name = str(ev)
        return "i", CHAOS_TID, name, None
    if ev is None and _is_level_stat(rec):
        dur = rec.get("ms", rec.get("enqueue_ms", 0.0))
        name = f"L{rec['level']}"
        if "frame" in rec:
            name += f" f{rec['frame']}"
        name += " device" if "ms" in rec else " enqueue"
        return "X", DEVICE_TID, name, float(dur)
    return "i", HOST_TID, str(ev or "record"), None


def to_chrome_trace(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Convert run-log records into a Chrome trace dict."""
    pids: Dict[Optional[str], int] = {}

    def pid_of(rec: Dict[str, Any]) -> int:
        rid = rec.get("run_id")
        if rid not in pids:
            pids[rid] = len(pids) + 1
        return pids[rid]

    # pass 1: classify + find the earliest start so ts stays small
    trace_tids: Dict[str, int] = {}
    rows = []
    base = None
    for rec in records:
        ts = rec.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        ph, tid, name, dur_ms = _classify(rec)
        trace_id = rec.get("trace")
        if isinstance(trace_id, str) and trace_id:
            # a traced record leaves its kind-lane for the request's own
            # track — the whole hop chain reads as one horizontal story
            if trace_id not in trace_tids:
                trace_tids[trace_id] = TRACE_TID_BASE + len(trace_tids)
            tid = trace_tids[trace_id]
        start_s = float(ts) - (dur_ms or 0.0) / 1e3 if ph == "X" \
            else float(ts)
        if base is None or start_s < base:
            base = start_s
        rows.append((rec, ph, tid, name, dur_ms, start_s))
    base = base or 0.0

    events: List[Dict[str, Any]] = []
    trace_tracks = set()  # (pid, tid, trace_id) needing thread_name meta
    for rec, ph, tid, name, dur_ms, start_s in rows:
        args = {k: v for k, v in rec.items() if k not in _DROP_ARGS}
        pid = pid_of(rec)
        if tid >= TRACE_TID_BASE:
            trace_tracks.add((pid, tid, str(rec.get("trace"))))
        event: Dict[str, Any] = {
            "ph": ph,
            "ts": round((start_s - base) * 1e6, 1),  # µs
            "pid": pid,
            "tid": tid,
            "name": name,
            "args": args,
        }
        if ph == "X":
            event["dur"] = round((dur_ms or 0.0) * 1e3, 1)  # µs
        else:
            event["s"] = "t"  # thread-scoped instant
        events.append(event)

    events.sort(key=lambda e: (e["pid"], e["ts"]))

    meta: List[Dict[str, Any]] = []
    for rid, pid in pids.items():
        meta.append({"ph": "M", "name": "process_name", "ts": 0, "dur": 0,
                     "pid": pid, "tid": 0,
                     "args": {"name": f"run {rid or '(unstamped)'}"}})
        for tid, tname in _TID_NAMES.items():
            meta.append({"ph": "M", "name": "thread_name", "ts": 0,
                         "dur": 0, "pid": pid, "tid": tid,
                         "args": {"name": tname}})
    for pid, tid, trace_id in sorted(trace_tracks):
        meta.append({"ph": "M", "name": "thread_name", "ts": 0, "dur": 0,
                     "pid": pid, "tid": tid,
                     "args": {"name": f"trace {trace_id}"}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def export_trace(log_path: str, out_path: str) -> Dict[str, int]:
    """Read a run-log JSONL, write Chrome trace JSON, return counts."""
    records = load_records(log_path)
    trace = to_chrome_trace(records)
    with open(out_path, "w") as f:
        json.dump(trace, f)
    return {"records": len(records), "events": len(trace["traceEvents"])}
