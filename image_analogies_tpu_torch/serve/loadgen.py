"""Synthetic load generator — ``ia serve --selftest N`` and ``ia fleet
--selftest N`` (the port's copy of the JAX package's ``serve/loadgen.py``).

Replays N requests with mixed target shapes (a few exemplar classes, so
both coalescing and singleton fallback paths exercise), optionally with
deadlines, against (1) a sequential one-at-a-time baseline calling the
engine directly and (2) the serving scheduler.  Prints a latency /
throughput / degradation summary and verifies batched responses are
bit-identical to singleton dispatch for the same request — the serving
layer must never change pixels.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from image_analogies_tpu_torch.serve.server import Server
from image_analogies_tpu_torch.serve.types import Rejected, ServeConfig

DEFAULT_SHAPES: Tuple[Tuple[int, int], ...] = ((20, 20), (24, 24), (16, 16))


def percentile(values: Sequence[float], q: float) -> float:
    if not values:
        return 0.0
    xs = sorted(values)
    idx = min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1))))
    return xs[idx]


def make_load(n: int, shapes: Sequence[Tuple[int, int]], seed: int, *,
              zipf: Optional[float] = None, styles: int = 0
              ) -> List[Dict[str, Any]]:
    """N requests cycling through shape classes.  Exemplars are shared
    per class (the realistic serving pattern: one style, many targets)
    so same-class requests are batch-compatible; targets differ per
    request.

    With ``zipf=S`` the load is drawn over ``styles`` synthetic styles
    (distinct exemplar pairs == distinct tenants) with Zipf-skewed
    frequency: style of rank r is picked with probability proportional
    to ``r**-S``.  S=0 is uniform; S~1 is the classic heavy-hitter
    shape where one viral style dominates — the load the tenant
    metering plane (obs/ledger.py) exists to attribute.  Deterministic
    for a given (n, shapes, seed, zipf, styles)."""
    rng = np.random.RandomState(seed)
    if zipf is not None:
        n_styles = max(1, int(styles) or 8)
        ranks = np.arange(1, n_styles + 1, dtype=np.float64)
        probs = ranks ** -float(zipf)
        probs /= probs.sum()
        style_shapes = [shapes[s % len(shapes)] for s in range(n_styles)]
        exemplars_z = [(rng.rand(h, w).astype(np.float32),
                        rng.rand(h, w).astype(np.float32))
                       for h, w in style_shapes]
        picks = rng.choice(n_styles, size=n, p=probs)
        load = []
        for i in range(n):
            s = int(picks[i])
            h, w = style_shapes[s]
            a, ap = exemplars_z[s]
            load.append({"index": i, "style": s, "a": a, "ap": ap,
                         "b": rng.rand(h, w).astype(np.float32)})
        return load
    exemplars = {}
    for h, w in shapes:
        exemplars[(h, w)] = (rng.rand(h, w).astype(np.float32),
                             rng.rand(h, w).astype(np.float32))
    load = []
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        a, ap = exemplars[(h, w)]
        load.append({"index": i, "a": a, "ap": ap,
                     "b": rng.rand(h, w).astype(np.float32)})
    return load


def parse_flash_crowd(spec: str) -> Dict[str, float]:
    """Parse ``--flash-crowd T0,DURATION,MULT``: at T0 seconds into the
    run the arrival rate multiplies by MULT for DURATION seconds, then
    falls back to the base rate — the canonical flash-crowd shape the
    autoscaling drill and ``ia bench`` share."""
    parts = [p.strip() for p in str(spec).split(",")]
    if len(parts) != 3:
        raise ValueError("--flash-crowd expects T0,DURATION,MULT "
                         "(e.g. 0.5,2.0,8)")
    t0, duration, mult = (float(p) for p in parts)
    if t0 < 0:
        raise ValueError("flash-crowd T0 must be >= 0")
    if duration <= 0:
        raise ValueError("flash-crowd DURATION must be > 0")
    if mult < 1:
        raise ValueError("flash-crowd MULT must be >= 1")
    return {"t0": t0, "duration": duration, "mult": mult}


def arrival_schedule(n: int, *, t0: float, duration: float, mult: float,
                     base_rps: float = 50.0, seed: int = 0) -> List[float]:
    """Deterministic arrival offsets (seconds from run start) for a
    flash-crowd load: Poisson arrivals at ``base_rps``, multiplied by
    ``mult`` inside the ``[t0, t0+duration)`` surge window.  One seed
    fixes the whole schedule, so the chaos drill and a soak replay the
    exact same traffic.  Delegates to the soak TraceSpec — the single
    arrival model selftests, drills, and soaks share."""
    from image_analogies_tpu_torch.soak.trace import TraceSpec

    return TraceSpec(seed=int(seed), requests=max(0, int(n)),
                     base_rps=base_rps,
                     flash_crowds=((t0, duration, mult),)).arrivals()


def _pace(sched: Optional[List[float]], idx: int, t_start: float) -> None:
    """Sleep until request ``idx``'s scheduled arrival (no-op without a
    schedule)."""
    if sched is None:
        return
    delay = sched[idx] - (time.perf_counter() - t_start)
    if delay > 0:
        time.sleep(delay)


def style_hist(load: List[Dict[str, Any]]) -> Optional[Dict[str, int]]:
    """Per-style request counts of a zipf load (None for classic loads)."""
    if not load or "style" not in load[0]:
        return None
    hist: Dict[str, int] = {}
    for item in load:
        k = f"s{item['style']}"
        hist[k] = hist.get(k, 0) + 1
    return dict(sorted(hist.items(), key=lambda kv: (-kv[1], kv[0])))


def selftest(cfg: ServeConfig, n: int, *, seed: int = 0,
             deadline_ms: Optional[Any] = None,
             shapes: Sequence[Tuple[int, int]] = DEFAULT_SHAPES,
             zipf: Optional[float] = None, styles: int = 0,
             flash_crowd: Optional[Dict[str, float]] = None,
             baselines: Optional[Dict[int, Any]] = None
             ) -> Dict[str, Any]:
    """Run the synthetic load end-to-end; returns the summary dict.

    ``deadline_ms`` may be a scalar (every request gets it) or a sequence
    cycled per request — a MIXED-deadline load (e.g. ``(300, None)``)
    interleaves tight-deadline traffic with undeadlined bulk, which is
    what the queue's EDF ordering exists for: the summary's timeout count
    under such a load is the thing deadline ordering lowers.

    With ``cfg.journal_dir`` set, every completed request is submitted
    again under its derived content key and must be answered from the
    journal (``journal.resubmit_deduped``).  ``baselines``, when given, is
    filled with each request's sequential run (index -> result)."""
    from image_analogies_tpu_torch.models.analogy import create_image_analogy
    from image_analogies_tpu_torch.obs import metrics as obs_metrics
    from image_analogies_tpu_torch.soak.trace import trace_plan

    load, sched, deadline_s = trace_plan(
        n, shapes, seed, zipf=zipf, styles=styles,
        flash_crowd=flash_crowd, deadline_ms=deadline_ms)

    # Sequential baseline: one-at-a-time engine calls, fresh backend each
    # (exactly what N independent `ia run` invocations would pay).
    seq_params = cfg.params.replace(metrics=False, log_path=None)
    baseline = {}
    t0 = time.perf_counter()
    for item in load:
        res = create_image_analogy(item["a"], item["ap"], item["b"],
                                   seq_params)
        baseline[item["index"]] = res.bp
        if baselines is not None:
            baselines[item["index"]] = res
    seq_s = time.perf_counter() - t0

    # Served run: burst-submit everything, then gather.
    responses: Dict[int, Any] = {}
    errors: Dict[int, BaseException] = {}
    rejected = 0
    journal_stats: Optional[Dict[str, int]] = None
    with Server(cfg) as srv:
        t0 = time.perf_counter()
        futures = {}
        for item in load:
            _pace(sched, item["index"], t0)
            try:
                futures[item["index"]] = srv.submit(
                    item["a"], item["ap"], item["b"],
                    deadline_s=deadline_s(item["index"]))
            except Rejected:
                rejected += 1
        for idx, fut in futures.items():
            try:
                responses[idx] = fut.result(timeout=600)
            except BaseException as exc:  # noqa: BLE001 - summarized
                errors[idx] = exc
        srv_s = time.perf_counter() - t0
        # Batched-engine ledger (read inside the server's run scope):
        # launches vs completions is the compression the lane axis buys —
        # with batching engaged, completed requests strictly exceed
        # engine launches; fallback reasons say why it didn't engage.
        snap = obs_metrics.snapshot() or {}
        counters = snap.get("counters", {})
        batch_ledger = {
            "launches": int(counters.get("batch.launches", 0)),
            "lanes": int(counters.get("batch.lanes", 0)),
            "lane_faults": int(counters.get("batch.lane_faults", 0)),
            "completed": int(counters.get("serve.completed", 0)),
            "fallbacks": {
                k.split("batch.fallback_sequential.", 1)[1]: int(v)
                for k, v in sorted(counters.items())
                if k.startswith("batch.fallback_sequential.")},
        }
        cost_rate = srv.cost_model.rate
        cost_prior = srv.cost_prior_source
        if cfg.journal_dir:
            # journaled smoke: every completed request resubmitted under
            # its derived content key must dedupe, not recompute
            deduped = 0
            for idx in sorted(responses):
                item = load[idx]
                try:
                    again = srv.submit(item["a"], item["ap"],
                                       item["b"]).result(timeout=600)
                    if (again.request_id == responses[idx].request_id
                            and np.array_equal(again.bp,
                                               responses[idx].bp)):
                        deduped += 1
                except BaseException:  # noqa: BLE001 - counted below
                    pass
            journal_stats = dict(srv.health()["journal"] or {})
            journal_stats["resubmit_deduped"] = deduped

    ok = [r for r in responses.values() if r.degraded is None]
    degraded = [r for r in responses.values() if r.degraded is not None]
    # Bit-identity: full-fidelity served outputs must equal the singleton
    # baseline exactly (degraded responses legitimately differ).
    identical = all(
        np.array_equal(responses[idx].bp, baseline[idx])
        for idx in responses if responses[idx].degraded is None)
    latencies = [r.total_ms for r in responses.values()]
    queue_ms = [r.queue_ms for r in responses.values()]
    dispatch_ms = [r.dispatch_ms for r in responses.values()]
    batch_hist: Dict[int, int] = {}
    for r in responses.values():
        batch_hist[r.batch_size] = batch_hist.get(r.batch_size, 0) + 1

    return {
        "n": n,
        "shapes": [list(s) for s in shapes],
        "sequential_s": round(seq_s, 3),
        "served_s": round(srv_s, 3),
        "sequential_rps": round(n / seq_s, 3) if seq_s else 0.0,
        "served_rps": round(len(responses) / srv_s, 3) if srv_s else 0.0,
        "speedup": round(seq_s / srv_s, 3) if srv_s else 0.0,
        "p50_ms": round(percentile(latencies, 50), 2),
        "p95_ms": round(percentile(latencies, 95), 2),
        "p99_ms": round(percentile(latencies, 99), 2),
        "queue_ms": {"p50": round(percentile(queue_ms, 50), 2),
                     "p99": round(percentile(queue_ms, 99), 2)},
        "dispatch_ms": {"p50": round(percentile(dispatch_ms, 50), 2),
                        "p99": round(percentile(dispatch_ms, 99), 2)},
        # the degrade cost model's EWMA rate after the run (s per
        # pixel*level*patch^2 unit) and where its prior came from
        "cost_rate": cost_rate,
        "cost_prior": cost_prior,
        "completed": len(ok),
        "degraded": len(degraded),
        "timeouts": sum(1 for e in errors.values()
                        if type(e).__name__ == "DeadlineExceeded"),
        "errors": sum(1 for e in errors.values()
                      if type(e).__name__ != "DeadlineExceeded"),
        "rejected": rejected,
        "batch_size_hist": {str(k): v for k, v in sorted(batch_hist.items())},
        "batch_engine": batch_ledger,
        "bit_identical": bool(identical),
        "zipf": zipf,
        "style_hist": style_hist(load),
        "flash_crowd": flash_crowd,
        "journal": journal_stats,
    }


def fleet_selftest(fcfg: "Any", n: int, *, seed: int = 0,
                   deadline_ms: Optional[Any] = None,
                   shapes: Sequence[Tuple[int, int]] = DEFAULT_SHAPES,
                   zipf: Optional[float] = None, styles: int = 0,
                   flash_crowd: Optional[Dict[str, float]] = None
                   ) -> Dict[str, Any]:
    """``ia fleet --selftest N``: the synthetic load routed through the
    consistent-hash Router over a worker fleet, against the same
    sequential baseline.  On top of the single-server gates it verifies
    ring affinity did something (per-worker routed counts), reports the
    negotiated wire codec (the ``--wire`` flag exercises IAF2 vs JSON),
    and counts spills/handoffs — all under the same bit-identity bar."""
    from image_analogies_tpu_torch.models.analogy import create_image_analogy
    from image_analogies_tpu_torch.obs import metrics as obs_metrics
    from image_analogies_tpu_torch.serve.fleet import Fleet
    from image_analogies_tpu_torch.soak.trace import trace_plan

    load, sched, deadline_s = trace_plan(
        n, shapes, seed, zipf=zipf, styles=styles,
        flash_crowd=flash_crowd, deadline_ms=deadline_ms)

    seq_params = fcfg.serve.params.replace(metrics=False, log_path=None)
    baseline = {}
    t0 = time.perf_counter()
    for item in load:
        baseline[item["index"]] = create_image_analogy(
            item["a"], item["ap"], item["b"], seq_params).bp
    seq_s = time.perf_counter() - t0

    responses: Dict[int, Any] = {}
    errors: Dict[int, BaseException] = {}
    rejected = 0
    with Fleet(fcfg) as fl:
        t0 = time.perf_counter()
        futures = {}
        for item in load:
            _pace(sched, item["index"], t0)
            try:
                futures[item["index"]] = fl.submit(
                    item["a"], item["ap"], item["b"],
                    deadline_s=deadline_s(item["index"]))
            except Rejected:
                rejected += 1
        for idx, fut in futures.items():
            try:
                responses[idx] = fut.result(timeout=600)
            except BaseException as exc:  # noqa: BLE001 - summarized
                errors[idx] = exc
        srv_s = time.perf_counter() - t0
        health = fl.health()
        snap = obs_metrics.snapshot() or {}
        counters = snap.get("counters", {})

    ok = [r for r in responses.values() if r.degraded is None]
    degraded = [r for r in responses.values() if r.degraded is not None]
    identical = all(
        np.array_equal(responses[idx].bp, baseline[idx])
        for idx in responses if responses[idx].degraded is None)
    latencies = [r.total_ms for r in responses.values()]
    routed = {k.split("router.routed.", 1)[1]: int(v)
              for k, v in counters.items()
              if k.startswith("router.routed.")}
    codecs = {k.split("router.wire.", 1)[1]: int(v)
              for k, v in counters.items()
              if k.startswith("router.wire.")}

    return {
        "n": n,
        "fleet_size": fcfg.size,
        "wire": fcfg.wire,
        "transport": getattr(fcfg, "transport", "inproc"),
        "shapes": [list(s) for s in shapes],
        "sequential_s": round(seq_s, 3),
        "served_s": round(srv_s, 3),
        "sequential_rps": round(n / seq_s, 3) if seq_s else 0.0,
        "served_rps": round(len(responses) / srv_s, 3) if srv_s else 0.0,
        "speedup": round(seq_s / srv_s, 3) if srv_s else 0.0,
        "p50_ms": round(percentile(latencies, 50), 2),
        "p95_ms": round(percentile(latencies, 95), 2),
        "completed": len(ok),
        "degraded": len(degraded),
        "timeouts": sum(1 for e in errors.values()
                        if type(e).__name__ == "DeadlineExceeded"),
        "errors": sum(1 for e in errors.values()
                      if type(e).__name__ != "DeadlineExceeded"),
        "rejected": rejected,
        "routed": routed,
        "codecs": codecs,
        "wire_bytes": int(counters.get("router.wire_bytes", 0)),
        "spills": int(counters.get("router.spills", 0)),
        "hop_faults": int(counters.get("router.hop_faults", 0)),
        "handoffs": health.get("handoffs", 0),
        "ring": health.get("ring", {}),
        "bit_identical": bool(identical),
        "zipf": zipf,
        "style_hist": style_hist(load),
        "flash_crowd": flash_crowd,
        "control": health.get("control"),
    }


def render_fleet(summary: Dict[str, Any]) -> str:
    lines = [
        f"fleet selftest: {summary['n']} requests over "
        f"{summary['fleet_size']} workers (wire={summary['wire']}, "
        f"transport={summary.get('transport', 'inproc')})",
        f"  sequential: {summary['sequential_s']}s "
        f"({summary['sequential_rps']} req/s)",
        f"  routed:     {summary['served_s']}s "
        f"({summary['served_rps']} req/s, speedup x{summary['speedup']})",
        f"  latency:    p50 {summary['p50_ms']}ms  p95 {summary['p95_ms']}ms",
        f"  outcomes:   {summary['completed']} ok, "
        f"{summary['degraded']} degraded, {summary['timeouts']} timeout, "
        f"{summary['rejected']} rejected, {summary['errors']} error",
        f"  affinity:   routed {summary['routed']} "
        f"(ring members {summary['ring'].get('members', [])})",
        f"  wire:       {summary['codecs']} "
        f"({summary['wire_bytes']} frame bytes)",
        f"  resilience: {summary['spills']} spills, "
        f"{summary['hop_faults']} hop faults, "
        f"{summary['handoffs']} handoffs",
        f"  bit-identical to singleton dispatch: "
        f"{summary['bit_identical']}",
    ]
    if summary.get("style_hist"):
        lines.insert(-1, f"  styles:     zipf S={summary['zipf']} -> "
                     f"{summary['style_hist']}")
    if summary.get("flash_crowd"):
        fc = summary["flash_crowd"]
        lines.insert(-1, f"  flash crowd: x{fc['mult']} surge at "
                     f"t0={fc['t0']}s for {fc['duration']}s")
    ctl = summary.get("control")
    if ctl and ctl.get("autoscale"):
        lines.insert(-1, f"  autoscale:  fleet size {ctl.get('size')}"
                     f" (last verdict: {ctl.get('last_verdict')})")
    return "\n".join(lines)


def render(summary: Dict[str, Any]) -> str:
    lines = [
        f"selftest: {summary['n']} requests over shapes "
        f"{summary['shapes']}",
        f"  sequential: {summary['sequential_s']}s "
        f"({summary['sequential_rps']} req/s)",
        f"  served:     {summary['served_s']}s "
        f"({summary['served_rps']} req/s, speedup x{summary['speedup']})",
        f"  latency:    p50 {summary['p50_ms']}ms  p95 {summary['p95_ms']}ms"
        f"  p99 {summary['p99_ms']}ms",
        f"  queue:      p50 {summary['queue_ms']['p50']}ms  "
        f"dispatch: p50 {summary['dispatch_ms']['p50']}ms  "
        f"cost rate {summary['cost_rate']:.3e} s/unit "
        f"({summary['cost_prior']} prior)",
        f"  outcomes:   {summary['completed']} ok, "
        f"{summary['degraded']} degraded, {summary['timeouts']} timeout, "
        f"{summary['rejected']} rejected, {summary['errors']} error",
        f"  batches:    sizes {summary['batch_size_hist']}",
        f"  bit-identical to singleton dispatch: "
        f"{summary['bit_identical']}",
    ]
    be = summary.get("batch_engine")
    if be:
        lines.insert(-1,
                     f"  batch eng:  {be['launches']} launches / "
                     f"{be['lanes']} lanes for {be['completed']} "
                     f"completions, {be['lane_faults']} lane faults"
                     + (f", fallbacks {be['fallbacks']}"
                        if be["fallbacks"] else ""))
    if summary.get("style_hist"):
        lines.insert(-1, f"  styles:     zipf S={summary['zipf']} -> "
                     f"{summary['style_hist']}")
    jn = summary.get("journal")
    if jn:
        lines.append(
            f"  journal:    {jn.get('admitted', 0)} admitted, "
            f"{jn.get('done', 0)} done, "
            f"{jn.get('deduped', 0)} deduped "
            f"({jn.get('resubmit_deduped', 0)} resubmissions answered "
            "from the journal)")
    return "\n".join(lines)
