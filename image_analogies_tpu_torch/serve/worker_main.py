"""Subprocess worker entry: ``python -m
image_analogies_tpu_torch.serve.worker_main`` (the port's copy of the JAX
package's ``serve/worker_main.py``).

One fleet slot as a real OS process (spawned by
:class:`serve.transport.SubprocessTransport`).  The contract:

- Config arrives as ONE JSON document on stdin
  (``{"serve": <ServeConfig>, "wid", "generation", "port"}`` — see
  :func:`serve.transport.config_from_json`); nothing else is read.
- The worker opens its journal dir (the advisory lock now holds a REAL
  foreign pid from the fleet's point of view), replays recovery, binds
  a loopback-only HTTP socket (``port`` 0 = ephemeral), and only THEN
  reports ``{"pid", "port", "wid"}`` on the ``--ready-fd`` pipe —
  readiness means "answering", not "forked".
- Serves the standard surface: ``GET /healthz`` (liveness + readiness),
  ``GET /metrics`` (Prometheus) and ``/metrics.json`` (the registry
  snapshot the fleet federates), ``GET /tenants`` (the per-style cost
  document the fleet merges), ``POST /v1/analogy`` (IAF2 or JSON,
  ``X-IA-Trace`` adopted per hop).
- The child runs on the device its spawn document's params name (the
  card by default): ``Server.start`` refuses a card that is not there,
  so such a child exits before ready and never serves on the CPU.
- SIGTERM drains and exits 0 (graceful replace); SIGKILL is the death
  the fleet drills — journal lock left on disk, swept by the
  replacement.

Host-side only at module scope: nothing here touches the card (the serve
lock test scans this file).  The engine loads inside Server.start().
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
from http.server import ThreadingHTTPServer
from typing import Optional

from image_analogies_tpu_torch.obs import ceilings as obs_ceilings
from image_analogies_tpu_torch.obs import metrics as obs_metrics
from image_analogies_tpu_torch.obs import timeline as obs_timeline
from image_analogies_tpu_torch.obs import trace as obs_trace
from image_analogies_tpu_torch.serve import http as serve_http
from image_analogies_tpu_torch.serve import transport as serve_transport
from image_analogies_tpu_torch.serve.server import Server


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="worker_main",
        description="fleet subprocess worker (config on stdin)")
    ap.add_argument("--ready-fd", type=int, default=None,
                    help="fd to write the {pid, port} ready line to")
    args = ap.parse_args(argv)

    doc = json.loads(sys.stdin.read() or "{}")
    cfg = serve_transport.config_from_json(doc["serve"])
    wid = str(doc.get("wid", "w?"))
    generation = int(doc.get("generation", 0))
    port = int(doc.get("port", 0))

    # The child's ambient run scope IS its isolated worker registry —
    # per-process isolation replaces the in-process ObsScope chaining;
    # the fleet federates via /metrics.json instead of a parent scope.
    with obs_trace.run_scope(
            cfg.params.replace(metrics=True),
            manifest_extra={"worker": {"wid": wid,
                                       "generation": generation,
                                       "pid": os.getpid()}}):
        server = Server(cfg).start()

        # Per-process temporal plane: the child samples its own registry
        # (the fleet cannot reach across the process boundary to do it)
        # so GET /timeline answers live windows, and the ceilings
        # watchdog trends this worker's own RSS — a leaking child emits
        # its own obs.ceiling.* alarms and decision records.
        tl = obs_timeline.arm()
        obs_ceilings.arm()
        tl.start_sampler(interval_s=1.0)

        def _snapshot():
            return obs_metrics.snapshot() or {}

        handler = serve_http._make_handler_from(
            server.health, server.submit, server.refresh_gauges,
            snapshot_fn=_snapshot, tenants_fn=server.tenants_doc,
            device=cfg.params.device)
        httpd = ThreadingHTTPServer(("127.0.0.1", port), handler)
        bound_port = httpd.server_address[1]

        stop = threading.Event()

        def _on_term(signum, frame):  # noqa: ARG001 - signal API
            stop.set()

        signal.signal(signal.SIGTERM, _on_term)
        signal.signal(signal.SIGINT, _on_term)

        http_thread = threading.Thread(
            target=httpd.serve_forever,
            name="{}-http".format(wid), daemon=True)
        http_thread.start()

        if args.ready_fd is not None:
            line = json.dumps({"pid": os.getpid(), "port": bound_port,
                               "wid": wid, "generation": generation})
            os.write(args.ready_fd, (line + "\n").encode())
            os.close(args.ready_fd)

        stop.wait()
        httpd.shutdown()
        obs_ceilings.disarm()
        obs_timeline.disarm()
        server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
