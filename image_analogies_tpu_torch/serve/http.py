"""Optional loopback HTTP front end (stdlib ``http.server`` only; the
port's copy of the JAX package's ``serve/http.py``).

Strictly a thin transport over :class:`serve.server.Server` (or a
:class:`serve.fleet.Fleet`, :func:`serve_fleet_http`) — no logic
lives here; binding is loopback-only by construction.

API:
  GET  /healthz      -> Server.health(): ok, accepting, uptime_s,
                        queue_depth, inflight, breakers{backend: state},
                        workers{total, alive, threads}, devcache_bytes,
                        hbm_peak_bytes, slo{target, burn rates, ...}
  GET  /metrics      -> Prometheus text exposition (obs/live.py) of the
                        server's live metrics registry
  GET  /timeline     -> windowed time-series JSON (obs/timeline.py)
                        when the process timeline is armed
                        (?window=10 selects a downsampling tier);
                        both scrape endpoints self-report duration and
                        errors under obs.scrape.*
  GET  /archive/stats -> the telemetry archive's stats (obs/archive.py;
                        {"armed": false, ...} when it is off)
  GET  /tenants      -> per-tenant heavy-hitter document
                        (obs/ledger.py): top-K styles by request count
                        with cost share, p95, degrade/retry tallies;
                        {"armed": false, "tenants": []} when the
                        metering plane is off
  POST /v1/analogy   -> body {"a": [[...]], "ap": [[...]], "b": [[...]],
                        "deadline_ms": optional float,
                        "idempotency_key": optional str (journal dedupe;
                        must match [A-Za-z0-9_-]{1,64} — keys name spill
                        files, so anything else answers 400),
                        "params": optional AnalogyParams document (the
                        JAX format: run on the server's device),
                        "priority": optional class name or weight}
                        reply {"request", "status", "bp", "timings", ...}

Content negotiation (serve/wire.py): JSON is the DEFAULT both ways.  A
request with ``Content-Type: application/x-ia-f32`` ships the three
planes as one length-prefixed raw-f32 frame (order a, a', b) with
``deadline_ms`` / ``idempotency_key`` moved to the ``X-IA-Deadline-Ms``
/ ``X-IA-Idempotency-Key`` headers; a request with that type in its
``Accept`` header gets B' back as a single-array frame, the JSON
metadata fields relocated to ``X-IA-Request``/``X-IA-Status``/
``X-IA-Degraded``/``X-IA-Batch-Size``/``X-IA-Timings`` response
headers.  The two directions negotiate independently (binary in / JSON
out and vice versa both work); errors are always JSON.

Trace propagation: every POST reads ``X-IA-Trace``
(``trace_id/parent_span/request_id``, ``-`` for absent fields) and
adopts the caller's trace context — or mints one — before submitting,
so client, router, worker, and engine spans share one trace id; the
header is echoed on every response (success and error alike).

The fleet's front (:func:`serve_fleet_http`) answers the same API over
the router: ``/healthz`` is the fleet view, ``/metrics`` the federated
exposition (``?worker=<wid>`` one worker's isolated registry).  A
router->worker hop (``X-IA-Worker-Hop: 1``, a subprocess worker's
``worker_main``) gets the full Response back: both planes (bp, bp_y) in
the frame, or ``bp_y`` / ``stats`` / ``degraded`` in the JSON, and the
stats and degraded detail as ``X-IA-Stats`` / ``X-IA-Degraded-Detail``
headers beside a frame.
"""

from __future__ import annotations

import json
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np

from image_analogies_tpu_torch.obs import live as obs_live
from image_analogies_tpu_torch.obs import metrics as obs_metrics
from image_analogies_tpu_torch.obs import timeline as obs_timeline
from image_analogies_tpu_torch.obs import trace as obs_trace
from image_analogies_tpu_torch.serve import journal as serve_journal
from image_analogies_tpu_torch.serve import policy as serve_policy
from image_analogies_tpu_torch.serve import wire
from image_analogies_tpu_torch.serve.server import Server
from image_analogies_tpu_torch.serve.types import DeadlineExceeded, Rejected


def _make_handler(server: Server):
    return _make_handler_from(server.health, server.submit,
                              server.refresh_gauges,
                              tenants_fn=server.tenants_doc,
                              device=server.cfg.params.device)


def _make_handler_from(health_fn, submit_fn, refresh_fn, metrics_fn=None,
                       timeline_fn=None, snapshot_fn=None,
                       tenants_fn=None, device="cuda"):
    # metrics_fn(worker: Optional[str]) -> Optional[str]: override for
    # the /metrics exposition (the fleet's federated view, with
    # ?worker=<wid> selecting one worker's isolated registry).  None
    # keeps the default ambient-scope exposition.
    # timeline_fn(window_s: Optional[float]) -> dict: override for the
    # /timeline document; None uses the armed process timeline.
    # snapshot_fn() -> dict: when set, GET /metrics.json answers the raw
    # registry snapshot (subprocess workers export it so the fleet can
    # federate their isolated registries without scope chaining).
    # device: where a request's own params document (X-IA-Params / the
    # JSON "params") runs — the server's device, never one named by the
    # caller.
    class Handler(BaseHTTPRequestHandler):
        # Silence per-request stderr chatter; obs records cover it.
        def log_message(self, fmt, *args):  # noqa: A003
            pass

        def _reply(self, code: int, payload: Dict[str, Any],
                   headers: Optional[Dict[str, str]] = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _reply_text(self, code: int, text: str, ctype: str) -> None:
            body = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 - stdlib API
            parts = urllib.parse.urlsplit(self.path)
            if parts.path == "/healthz":
                self._reply(200, health_fn())
            elif parts.path == "/metrics":
                self._scrape("metrics", self._get_metrics, parts)
            elif parts.path == "/metrics.json":
                if snapshot_fn is None:
                    self._reply(404, {"error": "not_found"})
                else:
                    self._scrape("metrics", self._get_metrics_json, parts)
            elif parts.path == "/timeline":
                self._scrape("timeline", self._get_timeline, parts)
            elif parts.path == "/tenants":
                self._scrape("tenants", self._get_tenants, parts)
            elif parts.path == "/archive/stats":
                self._scrape("archive", self._get_archive_stats, parts)
            else:
                self._reply(404, {"error": "not_found"})

        def _scrape(self, endpoint: str, fn, parts) -> None:
            """Meta-observability wrapper: every scrape endpoint counts
            itself and times itself (obs.scrape.*), so a slow or failing
            collector is visible in the very plane it collects.  The
            total is bumped BEFORE rendering (this scrape sees itself);
            the duration lands after (the next scrape exports it)."""
            t0 = time.perf_counter()
            obs_metrics.inc(f"obs.scrape.{endpoint}.total")
            try:
                fn(parts)
            except Exception as exc:  # noqa: BLE001 - counted + surfaced
                obs_metrics.inc("obs.scrape.errors")
                obs_metrics.inc(f"obs.scrape.{endpoint}.errors")
                self._reply(500, {"error": "scrape_failed",
                                  "detail": str(exc)})
            finally:
                obs_metrics.observe(f"obs.scrape.{endpoint}.duration_ms",
                                    (time.perf_counter() - t0) * 1e3)

        def _get_metrics(self, parts) -> None:
            refresh_fn()
            if metrics_fn is not None:
                query = urllib.parse.parse_qs(parts.query)
                worker = (query.get("worker") or [None])[0]
                text = metrics_fn(worker)
                if text is None:
                    self._reply(404, {"error": "unknown_worker",
                                      "worker": worker})
                    return
                self._reply_text(200, text, obs_live.CONTENT_TYPE)
                return
            self._reply_text(
                200,
                obs_live.render_prometheus(obs_live.snapshot_or_none()),
                obs_live.CONTENT_TYPE)

        def _get_metrics_json(self, parts) -> None:
            refresh_fn()
            self._reply(200, snapshot_fn())

        def _get_tenants(self, parts) -> None:
            if tenants_fn is not None:
                self._reply(200, tenants_fn())
                return
            from image_analogies_tpu_torch.obs import ledger as obs_ledger
            self._reply(200, obs_ledger.tenants_doc())

        def _get_archive_stats(self, parts) -> None:
            from image_analogies_tpu_torch.obs import archive as obs_archive
            self._reply(200, obs_archive.stats_doc())

        def _get_timeline(self, parts) -> None:
            query = urllib.parse.parse_qs(parts.query)
            window = (query.get("window") or [None])[0]
            try:
                window_s = float(window) if window is not None else None
            except ValueError:
                self._reply(400, {"error": "bad_window", "window": window})
                return
            fn = timeline_fn or obs_timeline.snapshot_json
            try:
                doc = fn(window_s)
            except KeyError as exc:
                self._reply(404, {"error": "unknown_window",
                                  "detail": str(exc)})
                return
            self._reply(200, doc)

        def do_POST(self):  # noqa: N802 - stdlib API
            if self.path != "/v1/analogy":
                self._reply(404, {"error": "not_found"})
                return
            ctype = (self.headers.get("Content-Type") or "").split(";")[0]
            binary_in = ctype.strip().lower() == wire.CONTENT_TYPE
            # A router->worker hop (serve/transport.py SubprocessHandle)
            # flags itself so the reply carries the full Response —
            # both planes plus stats/degraded detail — instead of the
            # client-facing single-plane shape.
            worker_hop = self.headers.get("X-IA-Worker-Hop") == "1"
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(length)
                if binary_in:
                    planes = wire.decode_planes(body)
                    if len(planes) != 3:
                        raise wire.WireError(
                            f"expected 3 planes (a, a', b), got "
                            f"{len(planes)}")
                    a, ap, b = planes
                    deadline_ms = self.headers.get("X-IA-Deadline-Ms")
                    if deadline_ms is not None:
                        deadline_ms = float(deadline_ms)
                    idem = self.headers.get("X-IA-Idempotency-Key")
                    params_doc = self.headers.get("X-IA-Params")
                    params_doc = json.loads(params_doc) \
                        if params_doc else None
                    priority = self.headers.get("X-IA-Priority")
                else:
                    req = json.loads(body or b"{}")
                    a = np.asarray(req["a"], dtype=np.float32)
                    ap = np.asarray(req["ap"], dtype=np.float32)
                    b = np.asarray(req["b"], dtype=np.float32)
                    deadline_ms = req.get("deadline_ms")
                    idem = req.get("idempotency_key")
                    params_doc = req.get("params")
                    priority = req.get("priority")
                # Priority class: an int weight or a class name
                # ("interactive"); absent/garbage degrades to standard
                # rather than erroring — priority is advisory.
                if isinstance(priority, str) and \
                        priority in serve_policy.PRIORITY_CLASSES:
                    priority = serve_policy.PRIORITY_CLASSES[priority]
                try:
                    priority = max(1, int(priority)) \
                        if priority is not None \
                        else serve_policy.PRIORITY_STANDARD
                except (TypeError, ValueError):
                    priority = serve_policy.PRIORITY_STANDARD
                params = None
                if params_doc is not None:
                    params = serve_journal.params_from_doc(params_doc,
                                                           device)
            except (KeyError, TypeError, ValueError,
                    json.JSONDecodeError) as exc:
                self._reply(400, {"error": "bad_request", "detail": str(exc)})
                return
            if idem is not None:
                idem = str(idem)
                if not serve_journal.valid_idem(idem):
                    self._reply(400, {
                        "error": "bad_request",
                        "detail": "idempotency_key must match "
                                  "[A-Za-z0-9_-]{1,64}"})
                    return
            # Cross-process trace adoption: an inbound X-IA-Trace header
            # (trace/parent_span/request; malformed degrades to None,
            # never an error) joins the caller's trace; without one this
            # hop mints the trace id.  Either way every downstream span
            # — router, worker, engine — stitches to it, and the id is
            # echoed back so the client can correlate.
            ctx = obs_trace.parse_trace_header(
                self.headers.get(obs_trace.TRACE_HEADER)) or {}
            if "trace" not in ctx:
                ctx["trace"] = obs_trace.mint_trace_id()
            ctx["parent_span"] = "http"
            trace_hdr = obs_trace.format_trace_header(ctx)
            trace_headers = {obs_trace.TRACE_HEADER: trace_hdr} \
                if trace_hdr else None
            try:
                with obs_trace.request_context(**ctx):
                    resp = submit_fn(
                        a, ap, b, params=params,
                        deadline_s=None if deadline_ms is None
                        else float(deadline_ms) / 1e3,
                        idempotency_key=idem,
                        wire_bytes=len(body),
                        priority=priority).result()
            except Rejected as exc:
                self._reply(429, {"error": "rejected", "reason": exc.reason},
                            headers=trace_headers)
                return
            except DeadlineExceeded:
                self._reply(504, {"error": "deadline_exceeded"},
                            headers=trace_headers)
                return
            except Exception as exc:  # noqa: BLE001 - surfaced to caller
                self._reply(500, {"error": "dispatch_failed",
                                  "detail": str(exc)},
                            headers=trace_headers)
                return
            timings = {"queue_ms": round(resp.queue_ms, 3),
                       "dispatch_ms": round(resp.dispatch_ms, 3),
                       "total_ms": round(resp.total_ms, 3)}
            accept = (self.headers.get("Accept") or "")
            if wire.CONTENT_TYPE in accept.lower():
                out_planes = [np.asarray(resp.bp, np.float32)]
                if worker_hop:
                    out_planes.append(np.asarray(resp.bp_y, np.float32))
                frame = wire.encode_planes(out_planes)
                self.send_response(200)
                self.send_header("Content-Type", wire.CONTENT_TYPE)
                self.send_header("Content-Length", str(len(frame)))
                self.send_header("X-IA-Request", resp.request_id)
                self.send_header("X-IA-Status", resp.status)
                self.send_header("X-IA-Degraded",
                                 "1" if resp.degraded else "0")
                self.send_header("X-IA-Batch-Size", str(resp.batch_size))
                self.send_header("X-IA-Timings", json.dumps(timings))
                if worker_hop:
                    self.send_header(
                        "X-IA-Stats", json.dumps(resp.stats, default=str))
                    self.send_header(
                        "X-IA-Degraded-Detail",
                        json.dumps(resp.degraded, default=str))
                if trace_hdr:
                    self.send_header(obs_trace.TRACE_HEADER, trace_hdr)
                self.end_headers()
                self.wfile.write(frame)
                return
            doc = {
                "request": resp.request_id,
                "status": resp.status,
                "degraded": resp.degraded,
                "batch_size": resp.batch_size,
                "timings": timings,
                "trace": ctx["trace"],
                "bp": resp.bp.tolist(),
            }
            if worker_hop:
                doc["bp_y"] = np.asarray(resp.bp_y,
                                         np.float32).tolist()
                doc["stats"] = json.loads(
                    json.dumps(resp.stats, default=str))
                doc["degraded"] = json.loads(
                    json.dumps(resp.degraded, default=str))
            self._reply(200, doc, headers=trace_headers)

    return Handler


def serve_http(server: Server, port: int) -> ThreadingHTTPServer:
    """Bind a loopback-only HTTP server; caller runs serve_forever()."""
    return ThreadingHTTPServer(("127.0.0.1", port), _make_handler(server))


def serve_fleet_http(fleet, port: int) -> ThreadingHTTPServer:
    """Fleet front end: same transport, but /healthz is the FLEET view
    (per-worker liveness, ring membership, gates, journal ownership,
    per-worker obs scope identity), POST /v1/analogy routes through the
    consistent-hash Router, and GET /metrics is the FEDERATED exposition
    (obs/fleet.py): merged samples plus ``worker="<wid>"`` labeled
    series, with ``?worker=<wid>`` selecting one worker's isolated
    registry (unknown wid -> 404).  A request's params document runs on
    the fleet's device."""

    def _refresh():
        for handle in list(fleet.workers.values()):
            try:
                handle.refresh_gauges()
            except Exception:  # noqa: BLE001 - a dying worker is fine
                pass

    return ThreadingHTTPServer(
        ("127.0.0.1", port),
        _make_handler_from(fleet.health, fleet.submit, _refresh,
                           metrics_fn=fleet.metrics_text,
                           tenants_fn=fleet.tenants_doc,
                           device=fleet.cfg.serve.params.device))
