"""Worker transport seam: how the fleet reaches a worker (the port's copy
of the JAX package's ``serve/transport.py``).

The fleet/router layer (serve/fleet.py,
serve/router.py) never talks to a :class:`serve.server.Server` directly
any more — it talks to a *handle* obtained from a :class:`Transport`:

- :class:`InProcessTransport` — the default, bit-for-bit: each
  worker is an in-process Server with its own chained obs scope; the
  router->worker hop round-trips planes and trace context through the
  negotiated codec exactly as before.
- :class:`SubprocessTransport` — each worker is a real child process
  (``python -m image_analogies_tpu_torch.serve.worker_main``) on its own
  loopback HTTP port, speaking the SAME wire: IAF2 plane frames,
  ``X-IA-Trace`` context, ``X-IA-*`` metadata headers.  kill() is a
  real SIGKILL, so the per-worker journal lock holds a real foreign
  pid and the replacement's stale-lock sweep / recovery replay is
  proven against an actual process corpse.

The spawn handshake: config travels as one JSON document on the child's
stdin; the child reports ``{"pid", "port"}`` on a dedicated ready pipe
(``--ready-fd``) only AFTER ``Server.start()`` finished journal
recovery and the HTTP socket is bound — so "spawn returned" means
"worker is answering", with :attr:`FleetConfig.spawn_timeout_s`
bounding the wait (torch import, the card's context and warmup happen
before ready).  The spawn document carries the params' ``device``: a
child runs where its parent says, the card by default, and a child
asked for the card on a machine without one refuses in
``Server.start`` (the parent sees "exited before ready"); it never
serves on the CPU instead.  Before the first spawn of a fleet on the
card the parent builds every missing kernel library once
(``tune.warmup.fleet_libraries``, the build ``ia warmup`` runs) and
names the directory to each child (``IA_COMPILE_CACHE_DIR``), so no
child compiles inside its readiness window.

:class:`CrashLoopSupervisor` is the respawn governor the health daemon
consults on every death: deaths within ``crash_loop_window_s`` of their
own spawn are RAPID, rapid streaks back off (capped jittered,
:func:`utils.failure.backoff_delay`, jitter seeded from the wid so the
schedule is deterministic per slot), and ``crash_loop_threshold``
consecutive rapid deaths gate the slot instead of respawning forever.

Host-side only: nothing here launches a kernel (the serve lock test
scans this file).  The ENGINE runs inside each worker, wherever that is.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json as _json
import os
import select
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np

from image_analogies_tpu_torch.config import AnalogyParams
from image_analogies_tpu_torch.obs import metrics as obs_metrics
from image_analogies_tpu_torch.obs import trace as obs_trace
from image_analogies_tpu_torch.serve import wire
from image_analogies_tpu_torch.serve.server import Server
from image_analogies_tpu_torch.serve.policy import QosPolicy
from image_analogies_tpu_torch.serve.types import (
    DeadlineExceeded, Rejected, Response, ServeConfig)
from image_analogies_tpu_torch.tune import warmup as tune_warmup
from image_analogies_tpu_torch.utils import failure


# ---------------------------------------------------------------------------
# wire codec helpers (shared by both transports)


def _roundtrip_iaf2(arrays: List[np.ndarray]) -> List[np.ndarray]:
    return wire.decode_planes(wire.encode_planes(arrays))


def _roundtrip_json(arrays: List[np.ndarray]) -> List[np.ndarray]:
    # Exact for f32: tolist() yields doubles holding each f32 exactly;
    # JSON repr round-trips doubles; nearest-f32 of that double is the
    # original value.  The bit-identity gates re-verify, not assume.
    return [np.asarray(_json.loads(_json.dumps(
        np.asarray(a, np.float32).tolist())), dtype=np.float32)
        for a in arrays]


def _wrap_response(src: "Future[Response]", codec: str
                   ) -> "Future[Response]":
    """Chain a worker future through the response-side wire codec."""
    out: "Future[Response]" = Future()

    def _done(f: "Future[Response]") -> None:
        if out.done():
            return
        exc = f.exception()
        if exc is not None:
            out.set_exception(exc)
            return
        resp = f.result()
        try:
            if codec == "iaf2":
                frame = wire.encode_planes(
                    [np.asarray(resp.bp, np.float32),
                     np.asarray(resp.bp_y, np.float32)])
                obs_metrics.inc("router.wire_bytes", len(frame))
                bp, bp_y = wire.decode_planes(frame)
            else:
                bp, bp_y = _roundtrip_json([resp.bp, resp.bp_y])
            out.set_result(dataclasses.replace(resp, bp=bp, bp_y=bp_y))
        except Exception as wexc:  # noqa: BLE001 - protocol error
            out.set_exception(wexc)

    src.add_done_callback(_done)
    return out


# ---------------------------------------------------------------------------
# ServeConfig / AnalogyParams JSON codec (the spawn-protocol payload —
# same asdict/ctor roundtrip the journal already proves exact)


def params_to_json(params: AnalogyParams) -> Dict[str, Any]:
    return dataclasses.asdict(params)


def params_from_json(doc: Dict[str, Any]) -> AnalogyParams:
    return AnalogyParams(**doc)


def config_to_json(cfg: ServeConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def config_from_json(doc: Dict[str, Any]) -> ServeConfig:
    doc = dict(doc)
    params = params_from_json(doc.pop("params"))
    doc["warmup_sizes"] = tuple(
        tuple(int(d) for d in s) for s in doc.get("warmup_sizes") or ())
    if doc.get("qos") is not None:
        doc["qos"] = QosPolicy.from_json(doc["qos"])
    return ServeConfig(params=params, **doc)


# ---------------------------------------------------------------------------
# crash-loop supervision (pure bookkeeping — the health daemon acts)


class CrashLoopSupervisor:
    """Respawn governor: classifies each worker death by uptime and
    answers (rapid streak, respawn delay, gate verdict).

    A death with ``uptime_s < window_s`` extends the slot's RAPID
    streak; a death after a healthy run resets it.  Rapid respawns back
    off with the fleet's capped jittered schedule; ``threshold``
    consecutive rapid deaths (0 disables) return ``gate=True`` — the
    slot is parked instead of burning spawns forever."""

    def __init__(self, window_s: float, threshold: int,
                 backoff_s: float, backoff_cap_s: float):
        self.window_s = float(window_s)
        self.threshold = int(threshold)
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self._rapid: Dict[str, int] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _seed(wid: str) -> int:
        # sha256, never hash(): the jitter schedule must be the same
        # schedule in every process (the Ring makes the same argument).
        return int.from_bytes(
            hashlib.sha256(wid.encode()).digest()[:4], "big") & 0x7FFFFFFF

    def on_death(self, wid: str, uptime_s: float) -> Dict[str, Any]:
        with self._lock:
            rapid = self._rapid.get(wid, 0) + 1 \
                if uptime_s < self.window_s else 0
            self._rapid[wid] = rapid
        gate = bool(self.threshold and rapid >= self.threshold)
        delay = 0.0
        if rapid and not gate:
            delay = failure.backoff_delay(
                rapid, backoff_s=self.backoff_s,
                backoff_cap_s=self.backoff_cap_s,
                jitter_seed=self._seed(wid))
        return {"rapid": rapid, "delay_s": delay, "gate": gate}

    def reset(self, wid: str) -> None:
        with self._lock:
            self._rapid.pop(wid, None)


# ---------------------------------------------------------------------------
# in-process transport


class WorkerHandle:
    """One fleet slot: stable wid + the current in-process Server
    incarnation (the InProcessTransport handle)."""

    # What a worker advertises to codec negotiation.  In-process
    # workers always speak both; a remote worker would advertise its
    # own set here.
    wire_formats = ("iaf2", "json")

    def __init__(self, wid: str, server: Server, generation: int,
                 codec: str,
                 scope: Optional[obs_metrics.ObsScope] = None):
        self.wid = wid
        self.server = server
        self.generation = generation
        self.codec = codec
        self.scope = scope
        self.pid = os.getpid()
        self.spawned_at = time.monotonic()

    @property
    def scope_id(self) -> Optional[str]:
        return self.scope.scope_id if self.scope is not None else None

    # -- control plane -----------------------------------------------

    def health(self) -> Dict[str, Any]:
        return self.server.health()

    def snapshot(self) -> Optional[Dict[str, dict]]:
        """The worker's ISOLATED registry snapshot (None when the
        worker has no scope of its own)."""
        if self.scope is None:
            return None
        return self.scope.registry.snapshot()

    def refresh_gauges(self) -> None:
        self.server.refresh_gauges()

    def tenants(self) -> None:
        # In-process workers share the module ledger plane — the fleet
        # reads it once locally; per-handle reads would K-count it.
        return None

    def recovery_stats(self) -> Dict[str, Any]:
        return self.server.recovery_stats or {}

    def recovery_future(self, idem: str) -> Optional["Future[Response]"]:
        """The replay future recover() registered for ``idem`` (already
        codec-wrapped), or None if the journal had no incomplete entry."""
        src = self.server.recovery.get(idem)
        if src is None:
            return None
        return _wrap_response(src, self.codec)

    def kill(self) -> None:
        self.server.kill()

    def shutdown(self) -> None:
        self.server.shutdown()

    # -- data plane ----------------------------------------------------

    def forward(self, a, ap, b, params, deadline_s: Optional[float],
                idem: Optional[str], priority: int = 2
                ) -> "Future[Response]":
        """One router->worker hop: request planes AND the trace context
        through the negotiated codec, submit, response planes back
        through the codec."""
        ctx = obs_trace.capture_trace()
        hop_bytes = 0
        if self.codec == "iaf2":
            planes = [np.asarray(x, np.float32) for x in (a, ap, b)]
            frame = wire.encode_planes(planes)
            obs_metrics.inc("router.wire_bytes", len(frame))
            hop_bytes = len(frame)
            a, ap, b = wire.decode_planes(frame)
            if ctx:
                # The IAT1 side frame rides next to the plane frame; the
                # roundtrip is the same process-boundary rehearsal the
                # planes get.
                cframe = wire.encode_context(ctx)
                obs_metrics.inc("router.wire_bytes", len(cframe))
                hop_bytes += len(cframe)
                ctx = wire.decode_context(cframe)
        else:
            a, ap, b = _roundtrip_json([a, ap, b])
            if ctx:
                ctx = _json.loads(_json.dumps(ctx))
        obs_metrics.inc("router.wire.{}".format(self.codec))
        # Submit under the DECODED context: the worker-side Request
        # carries exactly what survived the wire, so the stitched trace
        # proves cross-codec propagation, not thread-local leakage.
        with obs_trace.request_context(**ctx) if ctx \
                else contextlib.nullcontext():
            src = self.server.submit(a, ap, b, params=params,
                                     deadline_s=deadline_s,
                                     idempotency_key=idem,
                                     wire_bytes=hop_bytes,
                                     priority=priority)
        return _wrap_response(src, self.codec)


class Transport:
    """Factory seam: how the fleet spawns and reaches workers."""

    name = "?"
    handle_cls: Any = WorkerHandle

    def spawn(self, wid: str, generation: int, cfg: ServeConfig,
              codec: str, *,
              scope_parent: Optional[obs_metrics.ObsScope] = None,
              spawn_timeout_s: float = 120.0):
        raise NotImplementedError


class InProcessTransport(Transport):
    """The default: workers are in-process Servers with chained
    per-worker obs scopes, sharing this process's card and stream."""

    name = "inproc"
    handle_cls = WorkerHandle

    def spawn(self, wid: str, generation: int, cfg: ServeConfig,
              codec: str, *,
              scope_parent: Optional[obs_metrics.ObsScope] = None,
              spawn_timeout_s: float = 120.0) -> WorkerHandle:
        # Per-worker obs scope: the worker's counters/spans land in its
        # OWN registry (isolated view for /metrics?worker=) and chain to
        # the fleet scope, so fleet-wide snapshots keep summing.
        scope = obs_metrics.ObsScope(
            scope_id="{}.g{}".format(wid, generation), parent=scope_parent)
        server = Server(cfg, obs_scope=scope).start()
        return WorkerHandle(wid, server, generation, codec, scope=scope)


# ---------------------------------------------------------------------------
# subprocess transport


# Live worker_main children spawned by THIS process — the port's tests
# sweep it after every test so that a failed subprocess test never leaks
# a child holding the card.
_LIVE: "set[subprocess.Popen]" = set()


def live_workers() -> List[subprocess.Popen]:
    return [p for p in _LIVE if p.poll() is None]


def reap_orphans() -> int:
    """SIGKILL every still-live child this process ever spawned.
    Returns how many needed killing (0 on a clean run)."""
    reaped = 0
    for proc in list(_LIVE):
        if proc.poll() is None:
            try:
                proc.kill()
                proc.wait(timeout=5.0)
                reaped += 1
            except Exception:  # noqa: BLE001 - best-effort sweep
                pass
        _LIVE.discard(proc)
    return reaped


def _read_ready(rfd: int, proc: subprocess.Popen,
                timeout_s: float) -> Dict[str, Any]:
    """Block until the child writes its ready line (newline-terminated
    JSON) on the startup pipe, the child exits, or the deadline passes."""
    deadline = time.monotonic() + timeout_s
    buf = b""
    while b"\n" not in buf:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError(
                "worker_main not ready within {:.1f}s".format(timeout_s))
        if proc.poll() is not None:
            raise RuntimeError(
                "worker_main exited rc={} before ready".format(
                    proc.returncode))
        readable, _, _ = select.select([rfd], [], [], min(left, 0.25))
        if not readable:
            continue
        chunk = os.read(rfd, 4096)
        if not chunk:
            # write end closed without a full line: the child is dying;
            # the poll() check above reports it next pass.
            time.sleep(0.02)
            continue
        buf += chunk
    return _json.loads(buf.split(b"\n", 1)[0].decode())


class SubprocessHandle:
    """One fleet slot backed by a real child process reached over
    loopback HTTP.  Same negotiated wire the in-process hop rehearses —
    IAF2 plane frames, X-IA-Trace context — but now it actually crosses
    a process boundary."""

    wire_formats = ("iaf2", "json")
    server = None  # no in-process Server: the child owns it
    scope = None   # no in-process scope: the child's registry is remote

    def __init__(self, wid: str, generation: int, codec: str,
                 proc: subprocess.Popen, port: int):
        self.wid = wid
        self.generation = generation
        self.codec = codec
        self.proc = proc
        self.pid = proc.pid
        self.port = int(port)
        self.base_url = "http://127.0.0.1:{}".format(self.port)
        self.spawned_at = time.monotonic()
        # Hop pool: blocking HTTP POSTs run here so forward() keeps the
        # in-process contract (returns a Future immediately).  Pool
        # threads have no TLS obs scope, so their counters resolve to
        # the process-default run scope — the fleet registry.
        self._pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="hop-{}".format(wid))

    @property
    def scope_id(self) -> str:
        # The child's registry is identified by slot, generation AND
        # real pid — /healthz shows at a glance which process answers.
        return "{}.g{}.pid{}".format(self.wid, self.generation, self.pid)

    # -- control plane -----------------------------------------------

    def _get_json(self, path: str, timeout: float = 5.0) -> Dict[str, Any]:
        import urllib.request

        with urllib.request.urlopen(self.base_url + path,
                                    timeout=timeout) as resp:
            return _json.loads(resp.read().decode())

    def health(self) -> Dict[str, Any]:
        return self._get_json("/healthz")

    def snapshot(self) -> Optional[Dict[str, dict]]:
        """The child's isolated registry via GET /metrics.json (the
        JSON twin of its Prometheus exposition).  None when the child
        is unreachable — a corpse has no fresh snapshot."""
        try:
            return self._get_json("/metrics.json")
        except Exception:  # noqa: BLE001 - dead/dying child
            return None

    def refresh_gauges(self) -> None:
        # The child refreshes its own gauges on every /metrics scrape;
        # nothing to do parent-side.
        pass

    def tenants(self) -> Optional[Dict[str, Any]]:
        """The child's /tenants document (its own armed ledger plane);
        None when the child is unreachable."""
        try:
            return self._get_json("/tenants")
        except Exception:  # noqa: BLE001 - dead/dying child
            return None

    def recovery_stats(self) -> Dict[str, Any]:
        try:
            return self.health().get("recovery") or {}
        except Exception:  # noqa: BLE001 - report empty, not raise
            return {}

    def recovery_future(self, idem: str) -> None:
        # Cross-process recovery has no in-process future to re-chain.
        # The router re-forwards stranded keys instead; the child's
        # join-replay/done-dedupe (server.submit) answers exactly-once.
        return None

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        """Real SIGKILL.  The corpse leaves its journal lock on disk
        holding a real foreign pid — the replacement's open() sweeps it
        (journal.active_pid) exactly like any crashed operator process."""
        try:
            os.kill(self.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        try:
            self.proc.wait(timeout=10.0)
        except Exception:  # noqa: BLE001 - reaped later by the fixture
            pass
        _LIVE.discard(self.proc)
        self._pool.shutdown(wait=False)

    def shutdown(self) -> None:
        """Graceful SIGTERM (the child drains + closes its journal),
        escalating to SIGKILL if it does not exit."""
        try:
            self.proc.terminate()
        except (ProcessLookupError, PermissionError):
            pass
        try:
            self.proc.wait(timeout=15.0)
        except Exception:  # noqa: BLE001 - escalate
            try:
                self.proc.kill()
                self.proc.wait(timeout=5.0)
            except Exception:  # noqa: BLE001 - reaped by the fixture
                pass
        _LIVE.discard(self.proc)
        self._pool.shutdown(wait=False)

    # -- data plane ----------------------------------------------------

    def forward(self, a, ap, b, params, deadline_s: Optional[float],
                idem: Optional[str], priority: int = 2
                ) -> "Future[Response]":
        """One router->worker hop over real HTTP.  Encoding and wire
        accounting happen on the CALLER thread (deterministic counters);
        the blocking POST + decode run on the hop pool.

        A transport-level disconnect (child SIGKILLed mid-request)
        leaves the future UNRESOLVED on purpose: the router's pending
        entry survives, and the handoff path re-answers it by idem key
        — the same hang-until-handoff contract the in-process transport
        has when a worker dies holding a request."""
        ctx = obs_trace.capture_trace()
        if self.codec == "iaf2":
            planes = [np.asarray(x, np.float32) for x in (a, ap, b)]
            body = wire.encode_planes(planes)
            obs_metrics.inc("router.wire_bytes", len(body))
            headers = {"Content-Type": wire.CONTENT_TYPE,
                       "Accept": wire.CONTENT_TYPE}
            if deadline_s is not None:
                headers["X-IA-Deadline-Ms"] = repr(float(deadline_s) * 1e3)
            if idem:
                headers["X-IA-Idempotency-Key"] = idem
            if params is not None:
                headers["X-IA-Params"] = _json.dumps(params_to_json(params))
        else:
            doc: Dict[str, Any] = {
                "a": np.asarray(a, np.float32).tolist(),
                "ap": np.asarray(ap, np.float32).tolist(),
                "b": np.asarray(b, np.float32).tolist(),
            }
            if deadline_s is not None:
                doc["deadline_ms"] = float(deadline_s) * 1e3
            if idem:
                doc["idempotency_key"] = idem
            if params is not None:
                doc["params"] = params_to_json(params)
            body = _json.dumps(doc).encode()
            obs_metrics.inc("router.wire_bytes", len(body))
            headers = {"Content-Type": "application/json"}
        headers["X-IA-Worker-Hop"] = "1"
        if priority != 2:
            headers["X-IA-Priority"] = str(int(priority))
        if ctx:
            hdr = obs_trace.format_trace_header(ctx)
            if hdr:
                headers[obs_trace.TRACE_HEADER] = hdr
        obs_metrics.inc("router.wire.{}".format(self.codec))
        fut: "Future[Response]" = Future()
        self._pool.submit(self._post, fut, body, headers)
        return fut

    def _post(self, fut: "Future[Response]", body: bytes,
              headers: Dict[str, str]) -> None:
        import urllib.error
        import urllib.request

        try:
            req = urllib.request.Request(
                self.base_url + "/v1/analogy", data=body,
                headers=headers, method="POST")
            with urllib.request.urlopen(req, timeout=600.0) as resp:
                data = resp.read()
                hdrs = resp.headers
        except urllib.error.HTTPError as exc:
            data = exc.read()
            try:
                doc = _json.loads(data.decode() or "{}")
            except Exception:  # noqa: BLE001 - non-JSON error body
                doc = {}
            if exc.code == 429:
                fut.set_exception(Rejected(doc.get("reason", "rejected")))
            elif exc.code == 504:
                fut.set_exception(DeadlineExceeded(-1, 0.0))
            else:
                fut.set_exception(RuntimeError(
                    "worker {} answered {}: {}".format(
                        self.wid, exc.code,
                        doc.get("detail") or doc.get("error") or "?")))
            return
        except Exception:  # noqa: BLE001 - transport-level disconnect
            # Child died (or socket reset) mid-request: leave the future
            # unresolved so the router's pending entry survives for the
            # handoff to re-answer.  Counted, never silent.
            obs_metrics.inc("router.hop_disconnects")
            obs_trace.emit_record({"event": "router_hop_disconnect",
                                   "worker": self.wid})
            return
        try:
            fut.set_result(self._decode(data, hdrs))
        except Exception as exc:  # noqa: BLE001 - protocol error
            fut.set_exception(exc)

    def _decode(self, data: bytes, hdrs) -> Response:
        ctype = (hdrs.get("Content-Type") or "").split(";")[0].strip()
        obs_metrics.inc("router.wire_bytes", len(data))
        if ctype.lower() == wire.CONTENT_TYPE:
            planes = wire.decode_planes(data)
            if len(planes) != 2:
                raise wire.WireError(
                    "hop reply expected 2 planes (bp, bp_y), got {}".format(
                        len(planes)))
            bp, bp_y = planes
            timings = _json.loads(hdrs.get("X-IA-Timings") or "{}")
            stats = _json.loads(hdrs.get("X-IA-Stats") or "{}")
            degraded = _json.loads(hdrs.get("X-IA-Degraded-Detail") or "null")
            return Response(
                request_id=int(hdrs.get("X-IA-Request") or 0),
                bp=bp, bp_y=bp_y, stats=stats,
                batch_size=int(hdrs.get("X-IA-Batch-Size") or 1),
                queue_ms=float(timings.get("queue_ms", 0.0)),
                dispatch_ms=float(timings.get("dispatch_ms", 0.0)),
                total_ms=float(timings.get("total_ms", 0.0)),
                degraded=degraded)
        doc = _json.loads(data.decode())
        timings = doc.get("timings") or {}
        return Response(
            request_id=int(doc.get("request", 0)),
            bp=np.asarray(doc["bp"], dtype=np.float32),
            bp_y=np.asarray(doc["bp_y"], dtype=np.float32),
            stats=doc.get("stats") or {},
            batch_size=int(doc.get("batch_size", 1)),
            queue_ms=float(timings.get("queue_ms", 0.0)),
            dispatch_ms=float(timings.get("dispatch_ms", 0.0)),
            total_ms=float(timings.get("total_ms", 0.0)),
            degraded=doc.get("degraded"))


class SubprocessTransport(Transport):
    """Spawn each worker as a worker_main child on its own loopback
    port.  spawn() returns only after the readiness handshake — the
    child has opened its journal (REAL pid in the lock), finished
    recovery replay, and bound its HTTP socket."""

    name = "subprocess"
    handle_cls = SubprocessHandle

    def __init__(self):
        # {IA_COMPILE_CACHE_DIR: dir} once the parent has made sure the
        # kernel libraries exist (first spawn of a fleet on the card)
        self._lib_env: Optional[Dict[str, str]] = None

    def spawn(self, wid: str, generation: int, cfg: ServeConfig,
              codec: str, *,
              scope_parent: Optional[obs_metrics.ObsScope] = None,
              spawn_timeout_s: float = 120.0) -> SubprocessHandle:
        doc = {"serve": config_to_json(cfg), "wid": wid,
               "generation": generation, "port": 0}
        rfd, wfd = os.pipe()
        os.set_inheritable(wfd, True)
        # Child stdout/stderr land in the worker's journal dir (the one
        # per-slot directory that survives the process) or /dev/null.
        if cfg.journal_dir:
            os.makedirs(cfg.journal_dir, exist_ok=True)
            log_fh = open(os.path.join(cfg.journal_dir, "worker.log"), "ab")
        else:
            log_fh = open(os.devnull, "wb")
        if self._lib_env is None:
            self._lib_env = tune_warmup.fleet_libraries(cfg.params)
        env = dict(os.environ)
        env.update(self._lib_env)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m",
                 "image_analogies_tpu_torch.serve.worker_main",
                 "--ready-fd", str(wfd)],
                stdin=subprocess.PIPE, stdout=log_fh,
                stderr=subprocess.STDOUT, pass_fds=(wfd,), env=env)
        finally:
            log_fh.close()
            os.close(wfd)
        _LIVE.add(proc)
        try:
            proc.stdin.write(_json.dumps(doc).encode())
            proc.stdin.close()
            ready = _read_ready(rfd, proc, spawn_timeout_s)
        except BaseException:
            try:
                proc.kill()
                proc.wait(timeout=5.0)
            except Exception:  # noqa: BLE001 - reaped by the fixture
                pass
            _LIVE.discard(proc)
            raise
        finally:
            os.close(rfd)
        return SubprocessHandle(wid, generation, codec, proc,
                                int(ready["port"]))


def make_transport(name: str) -> Transport:
    if name == "inproc":
        return InProcessTransport()
    if name == "subprocess":
        return SubprocessTransport()
    raise ValueError("unknown transport: {!r}".format(name))
