"""Live telemetry plane: scrapeable /metrics + /healthz (the port's copy of
the JAX package's ``obs/live.py``).

Everything obs/ records is otherwise post-hoc (run-scoped JSONL read by
``ia report`` / ``ia trace`` after the run).  This module is the *live*
view: a lock-protected snapshot API over the in-process metrics registry
rendered as Prometheus text exposition (format 0.0.4), plus a tiny
loopback-only HTTP server exposing ``/metrics`` and ``/healthz``.

Three consumers share it:

- ``serve/http.py`` — the serving front end's ``GET /metrics`` and the
  enriched ``GET /healthz`` (queue depth, per-backend breaker state,
  worker liveness, inflight, uptime, devcache/HBM gauges, SLO burn).
- ``ia run/video/sweep --metrics-port N`` — the same exposition bound
  for the duration of a non-serve engine run (scrape the live registry
  mid-run instead of waiting for ``run_end``).
- ``ia metrics LOG [--port N]`` — post-hoc/sidecar mode: render the
  latest ``run_end`` snapshot of a run-log JSONL, once to stdout or
  re-read per scrape.

Contract (same as the rest of obs/): stdlib only, no torch, and a
zero-cost disarmed path — with no active run, :func:`snapshot_or_none` is
one module-global read returning ``None``, allocating nothing.  Run logs
are read through ``obs/report.py``'s ``load_records``, as in the JAX
module.
"""

from __future__ import annotations

import json
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from image_analogies_tpu_torch.obs import metrics as _metrics

# Prometheus text exposition content type (format version 0.0.4).
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_T0 = time.monotonic()  # process-level uptime anchor for default healthz

_EMPTY_SNAPSHOT: Dict[str, dict] = {"counters": {}, "gauges": {},
                                    "histograms": {}}


def snapshot_or_none() -> Optional[Dict[str, dict]]:
    """Lock-protected snapshot of the active registry, or ``None`` when
    observability is off.  The disabled path is one module-global read +
    branch — no dict, no lock, no allocation."""
    reg = _metrics.registry()
    if reg is None:
        return None
    return reg.snapshot()


# --- Prometheus text rendering ---------------------------------------------

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def prom_name(name: str) -> str:
    """Registry name -> valid Prometheus metric name.  Dots and other
    invalid characters become underscores; everything is namespaced under
    ``ia_`` so scraped metrics never collide with host exporters."""
    return "ia_" + _NAME_BAD.sub("_", name)


def _fmt(v: Any) -> str:
    f = float(v)
    if f != f or f in (float("inf"), float("-inf")):
        # never emit NaN/Inf samples: a single bad sample poisons the
        # whole scrape in strict parsers.  Empty-histogram min/max are
        # already normalized by Histogram.summary(); this is belt and
        # braces for any future gauge.
        return "0"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(snap: Optional[Dict[str, dict]]) -> str:
    """Render a registry snapshot (or ``None``) as Prometheus text
    exposition.  Output is deterministic: sections in counter / gauge /
    histogram order, names sorted within each, one HELP + TYPE pair per
    metric.  The HELP line carries the original dotted registry name so
    operators (and the acceptance tests) can grep for ``serve.queue_depth``
    verbatim."""
    if snap is None:
        snap = _EMPTY_SNAPSHOT
    lines: List[str] = []

    for name in sorted(snap.get("counters", {})):
        pn = prom_name(name) + "_total"
        lines.append(f"# HELP {pn} counter {name}")
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {_fmt(snap['counters'][name])}")

    for name in sorted(snap.get("gauges", {})):
        pn = prom_name(name)
        lines.append(f"# HELP {pn} gauge {name}")
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {_fmt(snap['gauges'][name])}")

    for name in sorted(snap.get("histograms", {})):
        summ = snap["histograms"][name]
        pn = prom_name(name)
        lines.append(f"# HELP {pn} histogram {name}")
        lines.append(f"# TYPE {pn} histogram")
        cum = 0
        # base-2 exponential buckets: key k holds values in [2^(k-1), 2^k)
        # (k=0 also absorbs v <= 0), so the bucket's le edge is 2^k.
        # An empty or single-sample histogram is well-defined here by
        # construction: no buckets -> just the +Inf line, _sum 0, _count 0.
        for k in sorted(int(x) for x in (summ.get("buckets") or {})):
            cum += int(summ["buckets"][str(k)])
            lines.append(f'{pn}_bucket{{le="{_fmt(float(2 ** k))}"}} {cum}')
        count = int(summ.get("count", 0))
        lines.append(f'{pn}_bucket{{le="+Inf"}} {count}')
        lines.append(f"{pn}_sum {_fmt(summ.get('sum', 0.0))}")
        lines.append(f"{pn}_count {count}")

    for name in sorted(snap.get("sketches") or {}):
        lines.extend(sketch_lines(name, snap["sketches"][name]))

    if not lines:
        lines.append("# no active run (observability disabled)")
    return "\n".join(lines) + "\n"


def sketch_lines(name: str, summ: Dict[str, Any],
                 label: str = "") -> List[str]:
    """Prometheus ``summary``-type exposition of one quantile-sketch
    summary: ``{quantile="0.999"}``-labeled samples plus _sum/_count.
    The ``_q`` suffix keeps the family distinct from the base-2
    histogram riding on the same registry name.  ``label`` (e.g.
    ``worker="w0"``) composes with the quantile label for the fleet
    view."""
    from image_analogies_tpu_torch.obs import quantiles as _quantiles

    sk = _quantiles.QuantileSketch.from_summary(summ)
    pn = prom_name(name) + "_q"
    sep = "," if label else ""
    out: List[str] = []
    if not label:
        out.append(f"# HELP {pn} quantile sketch {name} "
                   f"(relative error {summ.get('alpha', '?')})")
        out.append(f"# TYPE {pn} summary")
    for q in _quantiles.EXPORT_QUANTILES:
        out.append(f'{pn}{{quantile="{_fmt(q)}"{sep}{label}}} '
                   f"{_fmt(sk.quantile(q))}")
    suffix = "{" + label + "}" if label else ""
    out.append(f"{pn}_sum{suffix} {_fmt(summ.get('sum', 0.0))}")
    out.append(f"{pn}_count{suffix} {int(summ.get('count', 0))}")
    return out


def metrics_text() -> str:
    """One-call convenience: exposition of the live registry."""
    return render_prometheus(snapshot_or_none())


# --- default healthz (non-serve runs) --------------------------------------


def default_health() -> Dict[str, Any]:
    """Generic liveness payload for non-serve expositions: is a run
    active, which run, how long has this process been up.  The serving
    front end replaces this with :meth:`serve.server.Server.health`."""
    from image_analogies_tpu_torch.obs import ceilings as _ceilings
    from image_analogies_tpu_torch.obs import trace as _trace

    return {
        "ok": True,
        "active_run": _metrics.registry() is not None,
        "run_id": _trace.current_run_id(),
        "uptime_s": round(time.monotonic() - _T0, 3),
        "vitals": _ceilings.read_proc_vitals(),
    }


# --- run-log (post-hoc / sidecar) snapshots --------------------------------


def snapshot_from_log(path: str) -> Optional[Dict[str, dict]]:
    """Latest ``run_end`` metrics snapshot found in a run-log JSONL, or
    ``None`` when no run has ended yet.  Re-read per scrape so a sidecar
    ``ia metrics --port`` serves fresh numbers as runs complete."""
    from image_analogies_tpu_torch.obs import report as _report

    snap = None
    for rec in _report.load_records(path):
        if rec.get("event") == "run_end" and isinstance(rec.get("metrics"),
                                                        dict):
            snap = rec["metrics"]
    return snap


def health_from_log(path: str) -> Dict[str, Any]:
    from image_analogies_tpu_torch.obs import report as _report

    records = _report.load_records(path)
    run_ids = []
    ended = set()
    for rec in records:
        rid = rec.get("run_id")
        if rid and rid not in run_ids:
            run_ids.append(rid)
        if rec.get("event") == "run_end" and rid:
            ended.add(rid)
    last = run_ids[-1] if run_ids else None
    return {
        "ok": bool(records),
        "records": len(records),
        "runs": len(run_ids),
        "last_run_id": last,
        "last_run_complete": last in ended if last else False,
    }


# --- loopback HTTP exposition ----------------------------------------------


def start_http_server(port: int,
                      snapshot_fn: Optional[Callable[[], Optional[dict]]]
                      = None,
                      health_fn: Optional[Callable[[], dict]] = None):
    """Bind a loopback-only exposition server on ``port`` (0 = ephemeral)
    and run it on a daemon thread.  Returns the ``ThreadingHTTPServer``;
    read the bound port from ``httpd.server_address[1]`` and stop it with
    :func:`stop_http_server`.

    The HTTP plumbing is imported lazily so importing ``obs.live`` stays
    cheap for callers that only render text."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    snap_fn = snapshot_fn or snapshot_or_none
    hz_fn = health_fn or default_health

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: A003 - silence stderr
            pass

        def _reply(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 - stdlib API
            import urllib.parse

            parts = urllib.parse.urlsplit(self.path)
            if parts.path == "/metrics":
                t0 = time.perf_counter()
                _metrics.inc("obs.scrape.metrics.total")
                try:
                    self._reply(200, render_prometheus(snap_fn()).encode(),
                                CONTENT_TYPE)
                except Exception:  # noqa: BLE001 - counted, then raised
                    _metrics.inc("obs.scrape.errors")
                    _metrics.inc("obs.scrape.metrics.errors")
                    raise
                finally:
                    _metrics.observe("obs.scrape.metrics.duration_ms",
                                     (time.perf_counter() - t0) * 1e3)
            elif parts.path == "/timeline":
                from image_analogies_tpu_torch.obs import timeline as _timeline

                t0 = time.perf_counter()
                _metrics.inc("obs.scrape.timeline.total")
                try:
                    query = urllib.parse.parse_qs(parts.query)
                    window = (query.get("window") or [None])[0]
                    doc = _timeline.snapshot_json(
                        float(window) if window is not None else None)
                    self._reply(200, json.dumps(doc).encode(),
                                "application/json")
                except (KeyError, ValueError) as exc:
                    _metrics.inc("obs.scrape.errors")
                    _metrics.inc("obs.scrape.timeline.errors")
                    self._reply(400, json.dumps(
                        {"error": "bad_window",
                         "detail": str(exc)}).encode(),
                        "application/json")
                finally:
                    _metrics.observe("obs.scrape.timeline.duration_ms",
                                     (time.perf_counter() - t0) * 1e3)
            elif parts.path == "/tenants":
                from image_analogies_tpu_torch.obs import ledger as _ledger

                t0 = time.perf_counter()
                _metrics.inc("obs.scrape.tenants.total")
                try:
                    self._reply(200,
                                json.dumps(_ledger.tenants_doc()).encode(),
                                "application/json")
                except Exception:  # noqa: BLE001 - counted, then raised
                    _metrics.inc("obs.scrape.errors")
                    _metrics.inc("obs.scrape.tenants.errors")
                    raise
                finally:
                    _metrics.observe("obs.scrape.tenants.duration_ms",
                                     (time.perf_counter() - t0) * 1e3)
            elif parts.path == "/archive/stats":
                from image_analogies_tpu_torch.obs import archive as _archive

                t0 = time.perf_counter()
                _metrics.inc("obs.scrape.archive.total")
                try:
                    self._reply(200,
                                json.dumps(_archive.stats_doc()).encode(),
                                "application/json")
                except Exception:  # noqa: BLE001 - counted, then raised
                    _metrics.inc("obs.scrape.errors")
                    _metrics.inc("obs.scrape.archive.errors")
                    raise
                finally:
                    _metrics.observe("obs.scrape.archive.duration_ms",
                                     (time.perf_counter() - t0) * 1e3)
            elif parts.path == "/healthz":
                self._reply(200, json.dumps(hz_fn()).encode(),
                            "application/json")
            else:
                self._reply(404, b'{"error": "not_found"}',
                            "application/json")

    httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    thread = threading.Thread(target=httpd.serve_forever,
                              name="ia-metrics-http", daemon=True)
    thread.start()
    httpd._ia_thread = thread  # kept for stop_http_server's join
    return httpd


def stop_http_server(httpd) -> None:
    httpd.shutdown()
    httpd.server_close()
    thread = getattr(httpd, "_ia_thread", None)
    if thread is not None:
        thread.join(timeout=5)
