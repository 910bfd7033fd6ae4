"""`TraceSpec` — the replayable traffic model behind ``ia soak`` (the
port's copy of the JAX package's ``soak/trace.py``).

One JSON artifact fixes an entire request stream: Zipf style popularity
(tenant skew), diurnal + flash-crowd arrival shapes on top of Poisson
pacing, a mixed session population (one-shot, batch lanes, resubmits)
and priority classes.  Everything is a pure function of the spec — same
spec ⇒ byte-identical request stream, locked by :meth:`stream_digest`.

The arrival model here is the one arrival model: the ``--selftest`` load
(``trace_plan``) and ``loadgen.arrival_schedule`` (the flash-crowd
drill's pacing) delegate to it, so selftests, drills and soaks never
drift onto parallel traffic generators.

Serve-free at module scope (content generation borrows
``loadgen.make_load`` lazily) and torch-free.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

SESSION_KINDS = ("oneshot", "resubmit", "batch")
PRIORITY_NAMES = ("interactive", "standard", "background")

# Seed-stream offsets: content (make_load), pacing, and population draws
# must never share bytes — each derived stream gets its own salt.
PACE_SALT = 0x9E37       # shared with loadgen.arrival_schedule
POPULATION_SALT = 0x51ED


def _pairs(raw: Any, what: str) -> Tuple[Tuple[str, float], ...]:
    out = []
    for entry in raw:
        name, weight = entry[0], float(entry[1])
        if weight <= 0:
            raise ValueError(f"{what} weight for {name!r} must be > 0")
        out.append((str(name), weight))
    if not out:
        raise ValueError(f"{what} mix must not be empty")
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """One soak's traffic, bounds, and fault shape — all from one seed.

    ``flash_crowds`` is a tuple of ``(t0, duration, mult)`` surge
    windows; ``diurnal_period_s``/``diurnal_amplitude`` superimpose a
    sinusoidal day-shape on the base rate (amplitude 0 = flat).
    ``sessions`` / ``priorities`` are weighted mixes drawn per request
    from the spec's own seeded stream.  ``deadline_ms`` is cycled per
    request (``None`` entries = undeadlined bulk).  The ``chaos`` dict
    is an inline :class:`~image_analogies_tpu_torch.chaos.plan.ChaosPlan`
    document armed for the whole run (``None`` = the driver's default
    plan); ``kill_every`` delivers a driver-side worker SIGKILL after
    every N-th submitted request.  ``p999_bound_ms`` and ``audit`` are
    the invariant-gate knobs: the DDSketch p99.9 latency ceiling and
    the size of the seeded bit-identity audit subset.
    """

    name: str = "soak"
    seed: int = 0
    requests: int = 40
    shapes: Tuple[Tuple[int, int], ...] = ((12, 12),)
    zipf: Optional[float] = 1.1
    styles: int = 3
    base_rps: float = 30.0
    flash_crowds: Tuple[Tuple[float, float, float], ...] = ()
    diurnal_period_s: float = 0.0
    diurnal_amplitude: float = 0.0
    deadline_ms: Tuple[Optional[float], ...] = ()
    sessions: Tuple[Tuple[str, float], ...] = (
        ("oneshot", 0.7), ("resubmit", 0.2), ("batch", 0.1))
    priorities: Tuple[Tuple[str, float], ...] = (
        ("interactive", 0.3), ("standard", 0.6), ("background", 0.1))
    chaos: Optional[Dict[str, Any]] = None
    kill_every: int = 0
    p999_bound_ms: float = 60_000.0
    audit: int = 8

    def __post_init__(self):
        if self.requests < 0:
            raise ValueError("requests must be >= 0")
        if not self.shapes:
            raise ValueError("shapes must not be empty")
        if self.zipf is not None and self.zipf < 0:
            raise ValueError("zipf skew must be >= 0")
        if self.styles < 0:
            raise ValueError("styles must be >= 0")
        if self.base_rps <= 0:
            raise ValueError("base_rps must be > 0")
        for t0, duration, mult in self.flash_crowds:
            if t0 < 0 or duration <= 0 or mult < 1:
                raise ValueError(
                    "flash crowd needs t0 >= 0, duration > 0, mult >= 1")
        if self.diurnal_period_s < 0:
            raise ValueError("diurnal_period_s must be >= 0")
        if not 0.0 <= self.diurnal_amplitude < 1.0:
            raise ValueError("diurnal_amplitude must be in [0, 1)")
        for kind, _w in _pairs(self.sessions, "session"):
            if kind not in SESSION_KINDS:
                raise ValueError(f"unknown session kind {kind!r}; "
                                 f"expected one of {SESSION_KINDS}")
        for pri, _w in _pairs(self.priorities, "priority"):
            if pri not in PRIORITY_NAMES:
                raise ValueError(f"unknown priority {pri!r}; "
                                 f"expected one of {PRIORITY_NAMES}")
        if self.kill_every < 0 or self.audit < 0:
            raise ValueError("kill_every/audit must be >= 0")
        if self.p999_bound_ms <= 0:
            raise ValueError("p999_bound_ms must be > 0")

    # ------------------------------------------------------------ codec

    def to_dict(self) -> Dict[str, Any]:
        doc = dataclasses.asdict(self)
        doc["shapes"] = [list(s) for s in self.shapes]
        doc["flash_crowds"] = [list(fc) for fc in self.flash_crowds]
        doc["deadline_ms"] = list(self.deadline_ms)
        doc["sessions"] = [list(kv) for kv in self.sessions]
        doc["priorities"] = [list(kv) for kv in self.priorities]
        return doc

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "TraceSpec":
        if not isinstance(d, dict):
            raise ValueError("trace spec must be a JSON object")
        kw = dict(d)
        unknown = set(kw) - {f.name for f in dataclasses.fields(TraceSpec)}
        if unknown:
            raise ValueError(f"unknown trace spec field(s) "
                             f"{sorted(unknown)}")
        if "shapes" in kw:
            kw["shapes"] = tuple((int(h), int(w)) for h, w in kw["shapes"])
        if "flash_crowds" in kw:
            kw["flash_crowds"] = tuple(
                (float(t0), float(du), float(m))
                for t0, du, m in kw["flash_crowds"])
        if "deadline_ms" in kw:
            kw["deadline_ms"] = tuple(
                None if v is None else float(v) for v in kw["deadline_ms"])
        if "sessions" in kw:
            kw["sessions"] = _pairs(kw["sessions"], "session")
        if "priorities" in kw:
            kw["priorities"] = _pairs(kw["priorities"], "priority")
        return TraceSpec(**kw)

    @staticmethod
    def from_json(blob: str) -> "TraceSpec":
        return TraceSpec.from_dict(json.loads(blob))

    @staticmethod
    def load(path: str) -> "TraceSpec":
        with open(path) as f:
            return TraceSpec.from_dict(json.load(f))

    @staticmethod
    def from_flags(n: int, seed: int, *,
                   shapes: Sequence[Tuple[int, int]],
                   zipf: Optional[float] = None, styles: int = 0,
                   flash_crowd: Optional[Dict[str, float]] = None,
                   deadline_ms: Optional[Any] = None,
                   base_rps: float = 50.0) -> "TraceSpec":
        """The `--selftest` flag surface as a spec — the one arrival
        model selftests and soaks share (`--zipf/--styles`,
        `--flash-crowd T0,DUR,MULT`, scalar-or-cycled `--deadline-ms`)."""
        if deadline_ms is None:
            deadlines: Tuple[Optional[float], ...] = ()
        elif isinstance(deadline_ms, (int, float)):
            deadlines = (float(deadline_ms),)
        else:
            deadlines = tuple(None if v is None else float(v)
                              for v in deadline_ms)
        crowds = ()
        if flash_crowd:
            crowds = ((float(flash_crowd["t0"]),
                       float(flash_crowd["duration"]),
                       float(flash_crowd["mult"])),)
        return TraceSpec(
            name="flags", seed=int(seed), requests=max(0, int(n)),
            shapes=tuple((int(h), int(w)) for h, w in shapes),
            zipf=None if zipf is None else float(zipf),
            styles=int(styles), base_rps=float(base_rps),
            flash_crowds=crowds, deadline_ms=deadlines)

    # --------------------------------------------------------- arrivals

    def rate_at(self, t: float) -> float:
        """Instantaneous arrival rate (req/s) at run-offset ``t``: the
        base rate, shaped by the diurnal sinusoid, multiplied by every
        surge window covering ``t``."""
        rate = self.base_rps
        if self.diurnal_period_s > 0:
            rate *= 1.0 + self.diurnal_amplitude * math.sin(
                2.0 * math.pi * t / self.diurnal_period_s)
        for t0, duration, mult in self.flash_crowds:
            if t0 <= t < t0 + duration:
                rate *= mult
        return max(rate, 1e-9)

    def arrivals(self) -> List[float]:
        """Deterministic Poisson arrival offsets (seconds from run
        start) under the shaped rate.  One seed fixes the whole
        schedule — drills, selftests, and soaks replay the exact same
        traffic."""
        rng = np.random.RandomState(
            (int(self.seed) + PACE_SALT) & 0x7FFFFFFF)
        t = 0.0
        out: List[float] = []
        for _ in range(self.requests):
            t += float(rng.exponential(1.0 / self.rate_at(t)))
            out.append(t)
        return out

    # ------------------------------------------------------ population

    def deadline_for(self, i: int) -> Optional[float]:
        """Request ``i``'s deadline in SECONDS (None = undeadlined) —
        the cycled mixed-deadline load EDF ordering exists for."""
        if not self.deadline_ms:
            return None
        v = self.deadline_ms[i % len(self.deadline_ms)]
        return None if v is None else v / 1e3

    def idem_for(self, i: int) -> str:
        """Stable idempotency key: the handle journals, resubmits, and
        ``ia why`` agree on."""
        return f"{self.name or 'soak'}-{self.seed}-{i}"

    def build_load(self) -> List[Dict[str, Any]]:
        """The full request population: content planes from the shared
        ``loadgen.make_load`` draw (Zipf over styles when armed),
        decorated with the per-request session kind, priority class,
        deadline, and idempotency key — all from the spec's own seeded
        streams."""
        from image_analogies_tpu_torch.serve import loadgen

        load = loadgen.make_load(self.requests, self.shapes, self.seed,
                                 zipf=self.zipf, styles=self.styles)
        rng = np.random.RandomState(
            (int(self.seed) + POPULATION_SALT) & 0x7FFFFFFF)
        s_names = [k for k, _ in self.sessions]
        s_probs = np.array([w for _, w in self.sessions], dtype=np.float64)
        s_probs /= s_probs.sum()
        p_names = [k for k, _ in self.priorities]
        p_probs = np.array([w for _, w in self.priorities],
                           dtype=np.float64)
        p_probs /= p_probs.sum()
        s_picks = rng.choice(len(s_names), size=max(self.requests, 1),
                             p=s_probs)
        p_picks = rng.choice(len(p_names), size=max(self.requests, 1),
                             p=p_probs)
        for item in load:
            i = item["index"]
            item["session"] = s_names[int(s_picks[i])]
            item["priority"] = p_names[int(p_picks[i])]
            item["deadline_s"] = self.deadline_for(i)
            item["idem"] = self.idem_for(i)
        return load

    # ----------------------------------------------------------- digest

    def stream_digest(self) -> str:
        """sha256 over the complete request stream — every content
        byte, every population label, every arrival offset.  Two specs
        produce the same digest iff they produce the same traffic;
        the determinism test locks replays to this."""
        h = hashlib.sha256()
        h.update(json.dumps(self.to_dict(), sort_keys=True,
                            default=str).encode())
        sched = self.arrivals()
        for item, t in zip(self.build_load(), sched):
            head = (f"{item['index']}|{item.get('style', '')}"
                    f"|{item['session']}|{item['priority']}"
                    f"|{item['deadline_s']}|{item['idem']}"
                    f"|{float(t).hex()}|")
            h.update(head.encode())
            for key in ("a", "ap", "b"):
                arr = np.ascontiguousarray(item[key])
                h.update(str(arr.shape).encode())
                h.update(arr.tobytes())
        return h.hexdigest()


def trace_plan(n: int, shapes: Sequence[Tuple[int, int]], seed: int, *,
               zipf: Optional[float] = None, styles: int = 0,
               flash_crowd: Optional[Dict[str, float]] = None,
               deadline_ms: Optional[Any] = None
               ) -> Tuple[List[Dict[str, Any]], Optional[List[float]],
                          Callable[[int], Optional[float]]]:
    """(load, schedule, deadline_fn) for the `--selftest` flag surface —
    the single entry both ``loadgen.selftest`` paths consume, so the
    selftests and the soak share ONE arrival model."""
    spec = TraceSpec.from_flags(n, seed, shapes=shapes, zipf=zipf,
                                styles=styles, flash_crowd=flash_crowd,
                                deadline_ms=deadline_ms)
    sched = spec.arrivals() if flash_crowd else None
    return spec.build_load(), sched, spec.deadline_for


def smoke_spec(seed: int = 7) -> TraceSpec:
    """The built-in tier-1 smoke: small but complete — Zipf tenant skew,
    a diurnal ripple under one flash crowd, every session kind, mixed
    deadlines, two driver kills, and the default chaos plan (armed by the
    driver) covering worker death recovery, tier eviction, artifact
    tearing, and hop latency."""
    return TraceSpec(
        name="smoke", seed=seed, requests=24, shapes=((12, 12),),
        zipf=1.1, styles=3, base_rps=30.0,
        flash_crowds=((0.2, 0.6, 8.0),),
        diurnal_period_s=4.0, diurnal_amplitude=0.3,
        deadline_ms=(None, None, 30_000.0),
        kill_every=9, p999_bound_ms=60_000.0, audit=6)


def full_spec(seed: int = 7) -> TraceSpec:
    """The bench-profile soak: the same composite shape at duration —
    hundreds of requests, two surges over a diurnal cycle, periodic kills
    throughout; its ``p999_ms`` and ``loss`` are the soak's headlines."""
    return TraceSpec(
        name="full", seed=seed, requests=240, shapes=((16, 16),),
        zipf=1.1, styles=6, base_rps=40.0,
        flash_crowds=((1.0, 2.0, 10.0), (5.0, 1.5, 6.0)),
        diurnal_period_s=8.0, diurnal_amplitude=0.4,
        deadline_ms=(None, None, None, 60_000.0),
        kill_every=48, p999_bound_ms=120_000.0, audit=16)
