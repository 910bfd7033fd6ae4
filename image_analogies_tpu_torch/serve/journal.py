"""Write-ahead request journal — the serving plane's durability log (the
port's copy of the JAX package's ``serve/journal.py``).

Every admitted request is recorded BEFORE it enters the queue, then each
state transition is appended as it happens:

    admitted -> dispatched -> done(response digest)
                           -> rejected(reason)
                           -> poisoned

so a process death at any instant leaves a journal from which
:meth:`Server.recover` can reconstruct exactly what was owed to whom:

- ``done`` entries short-circuit duplicate submissions with the recorded
  response (exactly-once from the client's view — the response planes
  are spilled alongside the log);
- incomplete entries are re-enqueued in original admit order;
- entries whose ``dispatched`` count exhausted ``crash_requeues`` are
  marked ``poisoned`` and permanently shed with ``Rejected("poison")``
  so a poison request cannot crash the fleet twice.

Format: JSONL *segments* (``segment-%06d.jsonl``) where every line
carries a ``seal`` — sha256 over the canonical JSON of the rest of the
record — reusing ``utils/checkpoint.py``'s seal/quarantine pattern: a
torn tail or flipped bit fails the seal, the valid prefix is kept, and
the damaged segment is quarantined as ``.corrupt`` (evidence, never
deleted) instead of poisoning replay.  Appends are fsync'd by default
(``journal_fsync=False`` trades the sync for speed in tests).

Payload planes are spilled next to the log as checksummed ``.npz``
(``payloads/<idem>.npz`` inputs, ``payloads/<idem>.resp.npz`` the
recorded response), so the journal lines stay small and replay can both
re-run an incomplete request and answer a duplicate of a finished one.

Idempotency key: client-supplied, or ``sha1(batch key x payload
digest)`` — deterministic across processes, so a client retry after a
restart dedupes with no client-side cooperation.  Keys name files under
the journal directory, so client-supplied keys are confined to
``[A-Za-z0-9_-]{1,64}`` (:func:`valid_idem`), enforced at the HTTP and
``Server.submit`` boundaries and again by every path builder here —
a traversal-shaped key can never become a filesystem path.

Zero-cost when disabled: the server holds ``journal=None`` unless
``ServeConfig.journal_dir`` is set; no call site touches this module on
the disabled path (locked by tests/test_torch_journal.py).

The seal, the line layout, the spill ``.npz`` layout and the quarantine
rules are the JAX package's, byte for byte: a journal directory written
by either package replays in the other.  The payload spill's ``params``
is the JAX ``AnalogyParams`` document: the port's ``device`` field is
left out (a recovered request runs on the device of the server that
recovers it, never on one named in a file) and the device matcher is
named ``"tpu"`` there, as the JAX format names it (``"cuda"`` here).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import threading
import time
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from image_analogies_tpu_torch import chaos
from image_analogies_tpu_torch.config import AnalogyParams
from image_analogies_tpu_torch.obs import metrics as obs_metrics
from image_analogies_tpu_torch.obs import trace as obs_trace
from image_analogies_tpu_torch.utils import checkpoint as ckpt

_SEGMENT_FMT = "segment-%06d.jsonl"
_LOCK_NAME = "journal.lock"
# State transitions (folded by replay) plus two attribution ops that
# ride alongside without shaping replay: ``cost`` (the per-request cost
# vector from obs/ledger.py) and ``decision`` (a control-plane verdict —
# degrade, shed, spill, poison, dedupe...).  `ia why` merges all of them
# into one causal chain.
_OPS = ("admitted", "dispatched", "done", "rejected", "poisoned",
        "cost", "decision")
_IDEM_RE = re.compile(r"[A-Za-z0-9_-]{1,64}\Z")


class JournalLocked(RuntimeError):
    """The journal directory is owned by a LIVE foreign process.  Raised
    by :meth:`RequestJournal.open` so two live workers can never append
    to one journal — the single-writer invariant every replay guarantee
    rests on.  A dead owner's lock is swept, never raises."""

    def __init__(self, path: str, pid: int):
        super().__init__(
            f"journal at {path} is owned by live pid {pid}")
        self.path = path
        self.pid = pid


def valid_idem(idem: str) -> bool:
    """True when *idem* is safe to embed in journal lines and spill
    filenames.  Keys name files under the journal directory, so
    anything outside ``[A-Za-z0-9_-]{1,64}`` (path separators, dots,
    NULs, over-long strings) is refused at the submit/HTTP boundary —
    derived keys (sha1 hex) match by construction."""
    return isinstance(idem, str) and bool(_IDEM_RE.fullmatch(idem))


def idem_key(key_str: str, b: np.ndarray) -> str:
    """Idempotency key for a request: sha1 over the batch key (params
    digest x shape buckets x exemplar content) and the target plane's
    content.  Deterministic across processes — the property that makes a
    client retry after a server restart dedupe by construction."""
    b = np.ascontiguousarray(b)
    h = hashlib.sha1()
    h.update(key_str.encode())
    h.update(repr((b.shape, str(b.dtype))).encode())
    h.update(b.tobytes())
    return h.hexdigest()[:16]


def params_doc(params: AnalogyParams) -> Dict[str, Any]:
    """The JAX ``AnalogyParams`` document of ``params``: every field but
    ``device``, the device matcher named ``"tpu"``."""
    doc = dataclasses.asdict(params)
    doc.pop("device", None)
    if doc.get("backend") == "cuda":
        doc["backend"] = "tpu"
    return doc


def params_from_doc(doc: Dict[str, Any], device: str) -> AnalogyParams:
    """Inverse of :func:`params_doc` on ``device`` (a ``device`` key in
    the document is ignored)."""
    doc = dict(doc)
    doc.pop("device", None)
    if doc.get("backend") == "tpu":
        doc["backend"] = "cuda"
    return AnalogyParams(**doc, device=device)


def _seal(record: Dict[str, Any]) -> str:
    canonical = json.dumps(record, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canonical.encode()).hexdigest()[:32]


def _plane_checksum(*arrays: np.ndarray) -> str:
    """Same recipe as checkpoint._payload_checksum: shape + dtype + bytes
    under one sha256, stored inside the npz, checked on load."""
    h = hashlib.sha256()
    for arr in arrays:
        arr = np.ascontiguousarray(arr)
        h.update(repr((arr.shape, str(arr.dtype))).encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:32]


def response_digest(bp: np.ndarray, bp_y: np.ndarray) -> str:
    """Content digest of a response's output planes — what the ``done``
    journal line records, so an operator can audit that a replayed run
    reproduced the same bytes."""
    return _plane_checksum(bp, bp_y)


@dataclasses.dataclass
class JournalEntry:
    """Replay-time view of one idempotency key's transition history."""

    idem: str
    admit: Dict[str, Any]
    dispatched: int = 0
    done: Optional[Dict[str, Any]] = None
    rejected: Optional[str] = None
    poisoned: bool = False

    @property
    def complete(self) -> bool:
        return self.done is not None or self.rejected is not None \
            or self.poisoned


@dataclasses.dataclass
class Replay:
    """Result of :meth:`RequestJournal.replay`."""

    entries: Dict[str, JournalEntry]      # idem -> history
    order: List[str]                      # idems in original admit order
    quarantined: int = 0                  # segments moved to .corrupt
    lines: int = 0                        # valid sealed lines read
    # cost/decision attribution lines per idem — not state, but compact
    # preserves them for still-incomplete work so `ia why` survives it.
    aux: Dict[str, List[Dict[str, Any]]] = dataclasses.field(
        default_factory=dict)

    @property
    def incomplete(self) -> List[JournalEntry]:
        return [self.entries[i] for i in self.order
                if not self.entries[i].complete]


class RequestJournal:
    """One directory of sealed JSONL segments + spilled payloads.

    Thread-safe: appends from the admission thread and every worker
    serialize on one lock (a request journal is an ordering witness —
    interleaved partial lines would defeat it)."""

    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        self._lock = threading.Lock()
        self._fh = None
        self._segment = 0
        self._bytes = 0  # segment bytes on disk (the journal.bytes gauge)
        # In-memory dedupe state, rebuilt by replay() and kept current by
        # record_done/record_poisoned during the process lifetime.
        self._done: Dict[str, Any] = {}       # idem -> Response | None(lazy)
        self._poisoned: set = set()
        os.makedirs(self._payload_dir, exist_ok=True)

    # -- paths -------------------------------------------------------------

    @property
    def _payload_dir(self) -> str:
        return os.path.join(self.path, "payloads")

    def _segment_path(self, index: int) -> str:
        return os.path.join(self.path, _SEGMENT_FMT % index)

    def _segments(self) -> List[str]:
        try:
            names = sorted(n for n in os.listdir(self.path)
                           if n.startswith("segment-")
                           and n.endswith(".jsonl"))
        except OSError:
            return []
        return [os.path.join(self.path, n) for n in names]

    @property
    def _lock_path(self) -> str:
        return os.path.join(self.path, _LOCK_NAME)

    def payload_path(self, idem: str) -> str:
        # Backstop behind the boundary validation in Server.submit /
        # http.py: an unvalidated key must fail loudly here, never
        # become a path outside the payload dir.
        if not valid_idem(idem):
            raise ValueError(f"unsafe idempotency key: {idem!r}")
        return os.path.join(self._payload_dir, f"{idem}.npz")

    def response_path(self, idem: str) -> str:
        if not valid_idem(idem):
            raise ValueError(f"unsafe idempotency key: {idem!r}")
        return os.path.join(self._payload_dir, f"{idem}.resp.npz")

    @staticmethod
    def _spill_tmp(final_path: str) -> str:
        """Per-writer temp name for a spill headed to *final_path* (the
        .npz suffix keeps np.savez from appending its own)."""
        return (f"{final_path}.{os.getpid()}"
                f".{threading.get_ident()}.tmp.npz")

    # -- append side -------------------------------------------------------

    def open(self) -> "RequestJournal":
        """Open a fresh segment for appends (one per server incarnation —
        a restart never appends into a segment a dead process may have
        torn)."""
        with self._lock:
            if self._fh is not None:
                return self
            # Single-writer gate: a lock held by a LIVE foreign process
            # refuses this opener (two appenders would tear the replay
            # history); a dead owner's lock is stale and active_pid()
            # sweeps it — the real-SIGKILL handoff path, where the
            # replacement inherits the corpse's directory.
            owner = self.active_pid()
            if owner is not None and owner != os.getpid():
                raise JournalLocked(self.path, owner)
            segs = self._segments()
            last = int(os.path.basename(segs[-1])[8:-6]) if segs else 0
            self._segment = last + 1
            self._fh = open(self._segment_path(self._segment), "a")
            self._bytes = sum(os.path.getsize(p) for p in segs)
            # Advisory single-writer lock: marks the journal active so
            # compact() refuses to delete segments out from under a
            # live appender.  Released by close(); a crash leaves it
            # behind, so readers liveness-check the recorded pid.
            with open(self._lock_path, "w") as lf:
                lf.write(str(os.getpid()))
            # Sweep spill temp files orphaned by a crashed incarnation
            # (each writer uses a unique temp name, so these can only
            # be dead — the atomic os.replace either happened or not).
            try:
                for name in os.listdir(self._payload_dir):
                    if name.endswith(".tmp.npz"):
                        try:
                            os.remove(os.path.join(self._payload_dir,
                                                   name))
                        except OSError:
                            pass
            except OSError:
                pass
        return self

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                finally:
                    self._fh = None
                try:
                    os.remove(self._lock_path)
                except OSError:
                    pass

    def active_pid(self) -> Optional[int]:
        """PID of a process currently appending to this journal, or
        None.  A lock file whose owner is dead is stale — removed here
        so a crashed incarnation doesn't block compaction forever."""
        if self._fh is not None:
            return os.getpid()
        try:
            with open(self._lock_path) as f:
                pid = int(f.read().strip() or "0")
        except (OSError, ValueError):
            return None
        if pid <= 0:
            return None
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            # Stale: the recorded owner is a corpse.  Sweep the lock
            # (counted — the subprocess handoff drill reconciles this
            # against the real SIGKILL it delivered).
            try:
                os.remove(self._lock_path)
                obs_metrics.inc("serve.journal.stale_lock_swept")
            except OSError:
                pass
            return None
        except PermissionError:
            pass  # exists, owned by another user: still alive
        return pid

    def _append(self, record: Dict[str, Any]) -> None:
        # The chaos plane's process-death site: a ProcessDeath raised
        # here models the process dying with this transition unrecorded —
        # exactly the torn-history case replay must absorb.
        chaos.site("serve.journal", op=record.get("op", "?"))
        # Wall-clock stamp on every line so `ia why` can merge-order
        # events across worker journals and the router's DecisionLog
        # (pre-stamp journals sort by file order, which is still causal
        # within one journal).
        record.setdefault("ts", round(time.time(), 6))
        line = json.dumps({"seal": _seal(record), **record},
                          sort_keys=True, separators=(",", ":"))
        with self._lock:
            if self._fh is None:  # journal closed (shutdown race): drop
                return
            self._fh.write(line + "\n")
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
            self._bytes += len(line) + 1
            nbytes = self._bytes
        obs_metrics.inc(f"serve.journal.{record['op']}")
        # the ceilings watchdog's journal.bytes series (obs/ceilings.py)
        obs_metrics.set_gauge("journal.bytes", nbytes)

    def record_admit(self, idem: str, request_id: int, a: np.ndarray,
                     ap: np.ndarray, b: np.ndarray, params: AnalogyParams,
                     deadline_s: Optional[float], key: str) -> None:
        """WAL step: spill the payload, then the admit line.  Runs BEFORE
        the queue sees the request — an admitted request with no journal
        line cannot exist, only the harmless converse."""
        ppath = self.payload_path(idem)
        if not os.path.exists(ppath):  # client retries reuse the spill
            # Unique temp per writer: a retry racing the original (both
            # past the exists check) must not interleave np.savez into
            # one file — each writes its own, os.replace is atomic,
            # last-one-wins lands a self-consistent spill either way.
            tmp = self._spill_tmp(ppath)
            np.savez(tmp, a=a, ap=ap, b=b,
                     params=json.dumps(params_doc(params), sort_keys=True),
                     checksum=_plane_checksum(a, ap, b))
            os.replace(tmp, ppath)
        self._append({"op": "admitted", "idem": idem, "rid": request_id,
                      "key": key, "deadline_s": deadline_s})

    def record_dispatched(self, idem: str) -> None:
        self._append({"op": "dispatched", "idem": idem})

    def record_done(self, idem: str, resp: Any) -> None:
        """Spill the response, then the done line, then remember it for
        in-process dedupe.  Callers sequence this BEFORE resolving the
        client future: once a client can observe an answer, the journal
        already guarantees every future duplicate gets the same one."""
        rpath = self.response_path(idem)
        if not os.path.exists(rpath):
            tmp = self._spill_tmp(rpath)
            np.savez(tmp, bp=resp.bp, bp_y=resp.bp_y,
                     stats=json.dumps(resp.stats, default=str),
                     degraded=json.dumps(resp.degraded),
                     request_id=resp.request_id,
                     checksum=_plane_checksum(resp.bp, resp.bp_y))
            os.replace(tmp, rpath)
        self._append({"op": "done", "idem": idem,
                      "rid": resp.request_id,
                      "response_digest": response_digest(resp.bp,
                                                         resp.bp_y)})
        with self._lock:
            self._done[idem] = resp

    def record_rejected(self, idem: str, reason: str) -> None:
        self._append({"op": "rejected", "idem": idem, "reason": reason})

    def record_poisoned(self, idem: str) -> None:
        self._append({"op": "poisoned", "idem": idem})
        with self._lock:
            self._poisoned.add(idem)

    def record_cost(self, idem: str, vec: Dict[str, Any]) -> None:
        """Persist the per-request cost vector (obs/ledger.py) beside
        the request's own transitions — `ia why`'s timing evidence."""
        self._append({"op": "cost", "idem": idem, "vec": vec})

    def record_decision(self, idem: str, site: str, verdict: str,
                        cause: Optional[str] = None,
                        **extra: Any) -> None:
        """Persist one control-plane verdict for this key.  Callers
        pair this with obs/ledger.emit_decision (counters + trace);
        this line is the durable half `ia why` replays."""
        rec = {"op": "decision", "idem": idem, "site": site,
               "verdict": verdict}
        if cause is not None:
            rec["cause"] = cause
        if extra:
            rec.update(extra)
        self._append(rec)

    # -- dedupe / poison lookups (request path) ----------------------------

    def is_poisoned(self, idem: str) -> bool:
        with self._lock:
            return idem in self._poisoned

    def lookup_done(self, idem: str) -> Optional[Any]:
        """Recorded Response for a finished key, or None.  A replayed
        ``done`` is loaded lazily from its spill on first hit; a spill
        that fails its checksum is quarantined and the key degrades to
        not-done (the engine is deterministic, so a re-run still answers
        with the same bytes — exactly-once is preserved)."""
        with self._lock:
            if idem not in self._done:
                return None
            resp = self._done[idem]
        if resp is not None:
            return resp
        resp = self._load_response(idem)
        with self._lock:
            if resp is None:
                self._done.pop(idem, None)
            else:
                self._done[idem] = resp
        return resp

    def _load_response(self, idem: str) -> Optional[Any]:
        from image_analogies_tpu_torch.serve.types import Response

        rpath = self.response_path(idem)
        if not os.path.exists(rpath):
            return None
        try:
            with np.load(rpath) as z:
                bp = z["bp"].astype(np.float32)
                bp_y = z["bp_y"].astype(np.float32)
                want = str(z["checksum"])
                if want != _plane_checksum(z["bp"], z["bp_y"]):
                    raise ValueError(
                        f"response payload checksum mismatch at {rpath}")
                stats = json.loads(str(z["stats"]))
                degraded = json.loads(str(z["degraded"]))
                rid = int(z["request_id"])
        except (zipfile.BadZipFile, OSError, ValueError, KeyError,
                EOFError):
            ckpt.quarantine(rpath, counter="serve.journal.quarantined",
                            event="journal_quarantined")
            return None
        return Response(request_id=rid, bp=bp, bp_y=bp_y, stats=stats,
                        batch_size=1, queue_ms=0.0, dispatch_ms=0.0,
                        total_ms=0.0, degraded=degraded)

    def load_payload(self, idem: str, device: str = "cuda"):
        """(a, ap, b, params) for replay, or None when the spill is
        missing/damaged (quarantined — the request cannot be re-run, only
        reported).  ``params`` runs on ``device``: the recovering
        server's, never a device named in the file."""
        ppath = self.payload_path(idem)
        if not os.path.exists(ppath):
            return None
        try:
            with np.load(ppath) as z:
                a = z["a"].astype(np.float32)
                ap = z["ap"].astype(np.float32)
                b = z["b"].astype(np.float32)
                want = str(z["checksum"])
                if want != _plane_checksum(z["a"], z["ap"], z["b"]):
                    raise ValueError(
                        f"journal payload checksum mismatch at {ppath}")
                params = params_from_doc(json.loads(str(z["params"])),
                                         device)
        except (zipfile.BadZipFile, OSError, ValueError, KeyError,
                EOFError, TypeError):
            ckpt.quarantine(ppath, counter="serve.journal.quarantined",
                            event="journal_quarantined")
            return None
        return a, ap, b, params

    # -- replay side -------------------------------------------------------

    def _read_segment(self, path: str) -> List[Dict[str, Any]]:
        """Sealed lines of one segment.  On the first unparseable or
        seal-failing line the valid prefix is kept, the damaged file is
        quarantined as ``.corrupt``, and the prefix is rewritten in its
        place so the next restart replays cleanly (the quarantined bytes
        stay as evidence, same contract as checkpoint quarantine)."""
        records: List[Dict[str, Any]] = []
        good_lines: List[str] = []
        damaged = False
        with open(path) as f:
            for line in f:
                stripped = line.strip()
                if not stripped:
                    continue
                try:
                    rec = json.loads(stripped)
                    seal = rec.pop("seal")
                    if seal != _seal(rec) or rec.get("op") not in _OPS:
                        raise ValueError("bad seal")
                except (json.JSONDecodeError, KeyError, ValueError,
                        AttributeError, TypeError):
                    damaged = True
                    break
                records.append(rec)
                good_lines.append(stripped)
        if damaged:
            ckpt.quarantine(path, counter="serve.journal.quarantined",
                            event="journal_quarantined")
            with open(path + ".tmp", "w") as f:
                for rec_line in good_lines:
                    f.write(rec_line + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(path + ".tmp", path)
        return records

    def replay(self) -> Replay:
        """Fold every segment's transitions into per-key histories.

        Duplicate transitions are idempotent folds (two ``done`` lines
        for one key — e.g. a retry that raced a death — count once); the
        admit ORDER is the original EDF submission order and is what
        recovery re-enqueues by."""
        entries: Dict[str, JournalEntry] = {}
        order: List[str] = []
        aux: Dict[str, List[Dict[str, Any]]] = {}
        quarantined_before = _corrupt_count(self.path)
        lines = 0
        for seg in self._segments():
            for rec in self._read_segment(seg):
                lines += 1
                idem = str(rec.get("idem"))
                if not valid_idem(idem):
                    # Journal lines only ever carry boundary-validated
                    # keys; an unsafe idem means a handcrafted file —
                    # skip it so replay never turns it into a path.
                    continue
                op = rec["op"]
                if op in ("cost", "decision"):
                    # Attribution, not state: collected for compact but
                    # never folded — a cost line alone must not
                    # synthesize a replayable entry.
                    aux.setdefault(idem, []).append(rec)
                    continue
                if op == "admitted":
                    if idem not in entries:
                        entries[idem] = JournalEntry(idem=idem, admit=rec)
                        order.append(idem)
                    continue
                ent = entries.get(idem)
                if ent is None:
                    # transition without an admit (its admit line was in
                    # a torn prefix): synthesize so done/poisoned dedupe
                    # still works; it can never be re-enqueued (no
                    # payload reference is trusted without an admit).
                    ent = JournalEntry(idem=idem, admit={},
                                       rejected="orphaned")
                    entries[idem] = ent
                if op == "dispatched":
                    ent.dispatched += 1
                elif op == "done":
                    ent.done = rec
                elif op == "rejected":
                    ent.rejected = str(rec.get("reason", "rejected"))
                elif op == "poisoned":
                    ent.poisoned = True
        with self._lock:
            for ent in entries.values():
                if ent.done is not None:
                    self._done.setdefault(ent.idem, None)  # lazy load
                if ent.poisoned:
                    self._poisoned.add(ent.idem)
        return Replay(entries=entries, order=order,
                      quarantined=_corrupt_count(self.path)
                      - quarantined_before,
                      lines=lines, aux=aux)

    def history(self, idem: str) -> List[Dict[str, Any]]:
        """Every sealed line for *idem* (all ops, including cost and
        decision attribution) in file order — `ia why`'s raw evidence
        from one journal."""
        out: List[Dict[str, Any]] = []
        for seg in self._segments():
            for rec in self._read_segment(seg):
                if str(rec.get("idem")) == idem:
                    out.append(rec)
        return out

    # -- tooling (`ia journal`) --------------------------------------------

    def inspect(self) -> Dict[str, Any]:
        """Read-only summary for ``ia journal inspect``."""
        rep = self.replay()
        states: Dict[str, int] = {}
        for ent in rep.entries.values():
            if ent.poisoned:
                st = "poisoned"
            elif ent.done is not None:
                st = "done"
            elif ent.rejected is not None:
                st = "rejected"
            elif ent.dispatched:
                st = "dispatched"
            else:
                st = "admitted"
            states[st] = states.get(st, 0) + 1
        return {
            "path": self.path,
            "segments": len(self._segments()),
            "corrupt_segments": _corrupt_count(self.path),
            "lines": rep.lines,
            "requests": len(rep.entries),
            "states": states,
            "incomplete": [e.idem for e in rep.incomplete],
            "poisoned": sorted(e.idem for e in rep.entries.values()
                               if e.poisoned),
        }

    def compact(self) -> Dict[str, Any]:
        """Rewrite the journal to its minimal equivalent: one fresh
        segment holding each key's FINAL state (admit lines only for
        still-incomplete work), dropping intermediate transitions and the
        input spills of finished requests.  Response spills are kept —
        they are what dedupe answers with.  ``.corrupt`` files are never
        touched.

        Refuses while the journal is active (``journal.lock`` held by a
        live pid): a live appender holds the newest segment open, so
        deleting it would send its fsync'd appends to an unlinked file
        and silently lose every transition after the compaction."""
        owner = self.active_pid()
        if owner is not None:
            raise RuntimeError(
                f"journal at {self.path} is active (pid {owner}); "
                "stop the server before compacting")
        rep = self.replay()
        before = {"segments": len(self._segments()), "lines": rep.lines}
        tmp = os.path.join(self.path, "compact.tmp")
        kept = 0
        with open(tmp, "w") as f:
            def put(rec: Dict[str, Any]) -> None:
                nonlocal kept
                f.write(json.dumps({"seal": _seal(rec), **rec},
                                   sort_keys=True,
                                   separators=(",", ":")) + "\n")
                kept += 1

            for idem in rep.order:
                ent = rep.entries[idem]
                if not ent.complete:
                    put(ent.admit)
                    for _ in range(ent.dispatched):
                        put({"op": "dispatched", "idem": idem})
                    # Keep attribution for still-open work so a post-
                    # compact `ia why` sees the partial chain; finished
                    # keys drop theirs with the other intermediates.
                    for rec in rep.aux.get(idem, ()):
                        put(rec)
            for idem, ent in sorted(rep.entries.items()):
                if ent.poisoned:
                    put({"op": "poisoned", "idem": idem})
                elif ent.done is not None:
                    put(ent.done)
            f.flush()
            os.fsync(f.fileno())
        segs = self._segments()
        last = int(os.path.basename(segs[-1])[8:-6]) if segs else 0
        os.replace(tmp, self._segment_path(last + 1))
        for seg in segs:
            os.remove(seg)
        for ent in rep.entries.values():
            if ent.complete:
                try:
                    os.remove(self.payload_path(ent.idem))
                except OSError:
                    pass
        return {**before, "after": {"segments": 1, "lines": kept},
                "dropped_lines": rep.lines - kept}

    def stats(self) -> Dict[str, int]:
        """Live journal counters (from the active obs registry) — what
        /healthz and the selftest summary surface."""
        snap = obs_metrics.snapshot() or {}
        counters = snap.get("counters", {})
        return {k.split("serve.journal.", 1)[1]: int(v)
                for k, v in counters.items()
                if k.startswith("serve.journal.")}

    def info(self) -> Dict[str, Any]:
        """Ownership facts for /healthz: which pid holds the advisory
        lock and which segment this incarnation appends to — what a
        router (or operator) checks before handing the directory to a
        replacement worker."""
        return {"lock_pid": self.active_pid(), "segment": self._segment}


def autocompact(path: str, min_segments: int = 2
                ) -> Optional[Dict[str, Any]]:
    """Offline compaction of a DEAD worker's journal dir, called by
    ``Fleet._replace`` between the corpse and the replacement's
    ``open()`` — the one window in a worker slot's life when nobody
    holds the directory, so multi-hour soaks don't grow segments
    unboundedly (live ``compact()`` refuses by design).

    A corpse with fewer than ``min_segments`` segments is already
    bounded and is SKIPPED without touching the directory — the gate
    is a bare listdir, so a first-kill handoff keeps its historic
    evidence intact: the stale foreign lock is still there for the
    replacement's ``open()`` to sweep, and segment numbering stays
    contiguous past the corpse's.

    Refusal-safe: if the journal turns out to be held by a live owner
    (or the rewrite hits an I/O error), the replacement simply
    inherits the uncompacted journal — recovery replay does not depend
    on compaction.  Returns the compaction summary, or None when
    skipped/refused; counters ``serve.journal.autocompact`` /
    ``.autocompact_skipped`` / ``.autocompact_refused`` make every
    outcome visible."""
    if not os.path.isdir(path):
        return None
    try:
        segments = [n for n in os.listdir(path)
                    if n.startswith("segment-") and n.endswith(".jsonl")]
    except OSError:
        return None
    if len(segments) < min_segments:
        obs_metrics.inc("serve.journal.autocompact_skipped")
        return None
    try:
        out = RequestJournal(path).compact()
    except (RuntimeError, OSError):
        obs_metrics.inc("serve.journal.autocompact_refused")
        return None
    obs_metrics.inc("serve.journal.autocompact")
    return out


class DecisionLog:
    """Sealed JSONL decision trail for verdicts rendered OUTSIDE any
    worker journal — the router/fleet control plane (spill off home,
    death, crash-loop gate, handoff re-chain).  Worker journals are
    single-writer per process, so cross-process verdicts land here
    instead, at the fleet journal root, and `ia why` merges both.

    Unlike :meth:`RequestJournal.record_decision` (persist-only, paired
    with obs/ledger.emit_decision by the caller), :meth:`record` is the
    whole funnel for its sites: counter + trace record + sealed line."""

    NAME = "decisions.jsonl"

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self._lock = threading.Lock()
        self._fh = None

    def record(self, idem: Optional[str], site: str, verdict: str,
               cause: Optional[str] = None, **extra: Any) -> None:
        rec: Dict[str, Any] = {"op": "decision", "site": site,
                               "verdict": verdict,
                               "ts": round(time.time(), 6)}
        if idem is not None:
            rec["idem"] = idem
        if cause is not None:
            rec["cause"] = cause
        if extra:
            rec.update(extra)
        line = json.dumps({"seal": _seal(rec), **rec},
                          sort_keys=True, separators=(",", ":"))
        with self._lock:
            if self._fh is None:
                os.makedirs(os.path.dirname(self.path) or ".",
                            exist_ok=True)
                self._fh = open(self.path, "a")
            self._fh.write(line + "\n")
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
        obs_metrics.inc(f"serve.decision.{verdict}")
        trace_rec = {"event": "serve_decision", "site": site,
                     "verdict": verdict}
        if cause is not None:
            trace_rec["cause"] = cause
        if idem is not None:
            trace_rec["idem"] = idem
        obs_trace.emit_record(trace_rec)

    def read(self, idem: Optional[str] = None) -> List[Dict[str, Any]]:
        """Sealed decision lines in file order; a torn tail or flipped
        bit drops that line only (evidence log, not replay state)."""
        out: List[Dict[str, Any]] = []
        try:
            with open(self.path) as f:
                lines = f.readlines()
        except OSError:
            return out
        for line in lines:
            stripped = line.strip()
            if not stripped:
                continue
            try:
                rec = json.loads(stripped)
                seal = rec.pop("seal")
                if seal != _seal(rec) or rec.get("op") != "decision":
                    raise ValueError("bad seal")
            except (json.JSONDecodeError, KeyError, ValueError,
                    AttributeError, TypeError):
                obs_metrics.inc("serve.decision_log.skipped")
                continue
            if idem is None or rec.get("idem") == idem:
                out.append(rec)
        return out

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                finally:
                    self._fh = None


# -- request forensics (`ia why`) ---------------------------------------------

def _journal_dirs(root: str) -> List[Tuple[str, str]]:
    """``(label, path)`` of every journal under *root*: either *root*
    itself (single-server layout, segments at top level) or each child
    directory holding segments (fleet layout, one subdir per worker)."""

    def has_segments(path: str) -> bool:
        try:
            return any(n.startswith("segment-") and n.endswith(".jsonl")
                       for n in os.listdir(path))
        except OSError:
            return False

    if has_segments(root):
        return [(os.path.basename(os.path.normpath(root)) or "journal",
                 root)]
    out: List[Tuple[str, str]] = []
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return out
    for name in names:
        sub = os.path.join(root, name)
        if os.path.isdir(sub) and has_segments(sub):
            out.append((name, sub))
    return out


def _chain_step(e: Dict[str, Any]) -> str:
    op = e.get("op")
    if op == "admitted":
        return f"admitted[{e.get('worker', '?')}]"
    if op == "dispatched":
        return "dispatched"
    if op == "done":
        return "done"
    if op == "poisoned":
        return "poisoned"
    if op == "rejected":
        return f"rejected({e.get('reason', '?')})"
    if op == "cost":
        vec = e.get("vec") or {}
        q = float(vec.get("queue_ms") or 0.0)
        d = float(vec.get("dispatch_ms") or 0.0)
        step = f"queued {q:.0f}ms, ran {d:.0f}ms"
        lanes = int(vec.get("lanes") or 1)
        if lanes > 1:
            step += f" ({lanes} lanes)"
        retries = int(vec.get("retries") or 0)
        if retries:
            step += f", {retries} retries"
        return step
    if op == "decision":
        details = []
        if e.get("cause"):
            details.append(str(e["cause"]))
        for key in ("levels", "home", "to", "worker_id", "pid"):
            if e.get(key) is not None:
                details.append(f"{key}={e[key]}")
        verdict = e.get("verdict", "?")
        return f"{verdict}({', '.join(details)})" if details else verdict
    return str(op)


def reconstruct(idem: str, root: str) -> Dict[str, Any]:
    """Replay journal + ledger + decision evidence for one idempotency
    key into a single ordered causal chain — the `ia why` engine.

    *root* is either one journal directory (segments at top level) or a
    fleet journal root (per-worker subdirectories plus the router's
    ``decisions.jsonl``).  Events merge across sources ordered by their
    ``ts`` stamp (stable on ties; stamp-less legacy lines keep file
    order at the front)."""
    events: List[Dict[str, Any]] = []
    workers: List[str] = []
    for wid, jdir in _journal_dirs(root):
        jr = RequestJournal(jdir)
        hist = jr.history(idem)
        if hist:
            workers.append(wid)
        for rec in hist:
            events.append(dict(rec, worker=wid))
    dpath = os.path.join(root, DecisionLog.NAME)
    if os.path.exists(dpath):
        for rec in DecisionLog(dpath).read(idem):
            events.append(dict(rec, worker=str(rec.get("site",
                                                       "router"))))
    for i, e in enumerate(events):
        e["_seq"] = i
    events.sort(key=lambda e: (
        float(e["ts"]) if isinstance(e.get("ts"), (int, float))
        else float("-inf"), e["_seq"]))
    for e in events:
        e.pop("_seq", None)
    tenant = None
    traces = []
    for e in events:
        vec = e.get("vec") if e.get("op") == "cost" else None
        if tenant is None and isinstance(vec, dict) and vec.get("tenant"):
            tenant = vec["tenant"]
        for t in (e.get("trace"),
                  (vec or {}).get("trace") if isinstance(vec, dict)
                  else None):
            if t and t not in traces:
                traces.append(t)
    return {"idem": idem, "found": bool(events), "root": root,
            "workers": workers, "tenant": tenant, "traces": traces,
            "events": events,
            "chain": [_chain_step(e) for e in events]}


def render_why(doc: Dict[str, Any]) -> str:
    """Human-readable rendering of :func:`reconstruct`'s document."""
    idem = doc.get("idem", "?")
    if not doc.get("found"):
        return (f"ia why {idem}: no journal, ledger, or decision "
                f"records under {doc.get('root', '?')}\n")
    lines = [f"ia why {idem}"]
    if doc.get("tenant"):
        lines.append(f"  tenant: {doc['tenant']}")
    if doc.get("traces"):
        lines.append(f"  traces: {', '.join(doc['traces'])}")
    if doc.get("workers"):
        lines.append(f"  journals: {', '.join(doc['workers'])}")
    t0 = None
    for e in doc.get("events", []):
        ts = e.get("ts")
        if isinstance(ts, (int, float)):
            if t0 is None:
                t0 = ts
            stamp = f"+{ts - t0:8.3f}s"
        else:
            stamp = " " * 10
        lines.append(f"  {stamp} [{e.get('worker', '?'):>10}] "
                     f"{_chain_step(e)}")
    lines.append("  chain: " + " → ".join(doc.get("chain", [])))
    return "\n".join(lines) + "\n"


def _corrupt_count(path: str) -> int:
    try:
        names = os.listdir(path) + os.listdir(os.path.join(path,
                                                           "payloads"))
    except OSError:
        return 0
    return sum(1 for n in names if n.endswith(".corrupt"))


def emit_replay_record(event: str, **fields: Any) -> None:
    """Recovery instants for the serve trace track (`ia trace`)."""
    obs_trace.emit_record({"event": event, **fields})
