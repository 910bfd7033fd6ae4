"""Fault plans: what to inject, where, and when — deterministically (the
port's copy of the JAX package's ``chaos/plan.py``: the same fields,
defaults, validation and JSON, so a plan file written by either package
loads in the other to an equal dict).

A :class:`ChaosPlan` is a seed plus a rule per injection site.  Each
:class:`SiteRule` fires either on an explicit ``schedule`` of per-site
call indices (0-based: ``[0, 3]`` faults the 1st and 4th visit) or with
probability ``p`` per visit, capped by ``max_faults``.  Probability
draws come from a per-``(seed, site)`` stream, so the schedule a seed
produces is a pure function of the plan — re-running a drill with the
same plan replays the exact same faults.

Plans serialize to/from plain JSON so CI can keep drill plans as
checked-in files:

    {
      "seed": 42,
      "sites": {
        "level.dispatch": {"kind": "transient", "p": 0.5, "max_faults": 2},
        "ckpt.save":      {"kind": "corrupt", "schedule": [0]},
        "serve.dispatch": {"kind": "crash", "schedule": [1]}
      }
    }
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

_KINDS = ("transient", "oom", "latency", "corrupt", "crash",
          "process_death")

# Every injection site wired into the port (chaos/inject.py's docstring is
# the prose version), the JAX package's registry, name for name.  A plan
# naming a site outside this registry would arm NOTHING — the typo'd rule
# silently never fires and a drill (or a soak) passes vacuously — so
# loaders validate against it.
KNOWN_SITES = (
    "level.dispatch",    # models/analogy.py  — per-level device dispatch
    "devcache.upload",   # utils/devcache.py  — host→device upload
    "devcache.tier",     # catalog/tiers.py   — catalog tier resolution
    "match.prefilter",   # backends/cuda.py   — ANN projection resolution
    "ckpt.save",         # utils/checkpoint.py — checkpoint write
    "ckpt.load",         # utils/checkpoint.py — checkpoint read
    "serve.admit",       # serve/queue.py     — request admission
    "serve.dispatch",    # serve/worker.py    — batch dispatch
    "serve.journal",     # serve/journal.py   — journal append
    "engine.batch",      # batch/engine.py    — per-lane batched dispatch
    "mesh.step",         # parallel/step.py   — multichip level step
    "router.forward",    # serve/router.py    — fleet hop forward
    "archive.append",    # obs/archive.py     — sealed telemetry append
)


@dataclasses.dataclass(frozen=True)
class SiteRule:
    """One site's fault behavior.

    ``kind``       one of transient | oom | latency | corrupt | crash |
                   process_death.
    ``p``          per-visit fault probability (ignored when ``schedule``
                   is given).
    ``schedule``   explicit 0-based call indices that fault.
    ``max_faults`` total injection cap for the site (0 = unlimited).
    ``latency_ms`` sleep length for the latency kind (fixed delay).
    ``latency_p50_ms`` / ``latency_p99_ms``
                   latency only: when both are set (> 0) the sleep is
                   drawn from a lognormal with that median and 99th
                   percentile instead of the fixed ``latency_ms`` —
                   realistic tail-latency drills.  Draws come from the
                   per-``(seed, site)`` stream, so the same plan always
                   produces the same delays.
    ``hang``       latency only: after the sleep, raise instead of
                   resuming — models a wedged op that never completes
                   (the watchdog drill's fault; a plain sleep models a
                   slow-but-successful op).
    """

    kind: str
    p: float = 0.0
    schedule: Tuple[int, ...] = ()
    max_faults: int = 0
    latency_ms: float = 50.0
    latency_p50_ms: float = 0.0
    latency_p99_ms: float = 0.0
    hang: bool = False

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {_KINDS}")
        if not self.schedule and not (0.0 <= self.p <= 1.0):
            raise ValueError(f"p must be in [0, 1], got {self.p}")
        if self.max_faults < 0 or self.latency_ms < 0:
            raise ValueError("max_faults/latency_ms must be >= 0")
        if self.latency_p50_ms < 0 or self.latency_p99_ms < 0:
            raise ValueError("latency percentiles must be >= 0")
        if bool(self.latency_p50_ms) != bool(self.latency_p99_ms):
            raise ValueError(
                "latency_p50_ms and latency_p99_ms must be set together")
        if self.latency_p50_ms and self.latency_p99_ms < self.latency_p50_ms:
            raise ValueError("latency_p99_ms must be >= latency_p50_ms")


@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    """A seed + site rules; the unit `ia chaos` arms and replays."""

    seed: int = 0
    sites: Tuple[Tuple[str, SiteRule], ...] = ()
    name: str = ""

    def rule_for(self, site: str) -> Optional[SiteRule]:
        for name, rule in self.sites:
            if name == site:
                return rule
        return None

    def validate_sites(self, known: Optional[Tuple[str, ...]] = None
                       ) -> "ChaosPlan":
        """Reject site names outside ``known`` (default: the wired-in
        :data:`KNOWN_SITES` registry).  A typo'd site would never fire
        and the drill would pass vacuously — loud beats vacuous.
        Returns ``self`` so loaders can chain it."""
        registry = tuple(known) if known is not None else KNOWN_SITES
        unknown = [name for name, _ in self.sites if name not in registry]
        if unknown:
            raise ValueError(
                f"unknown injection site(s) {sorted(unknown)!r}; "
                f"known sites: {sorted(registry)}")
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {
            "seed": self.seed,
            "name": self.name,
            "sites": {
                name: {k: (list(v) if isinstance(v, tuple) else v)
                       for k, v in dataclasses.asdict(rule).items()
                       # keep the JSON minimal: drop inert defaults
                       if not (k == "p" and not v)
                       and not (k == "schedule" and not v)
                       and not (k == "max_faults" and not v)
                       and not (k == "latency_p50_ms" and not v)
                       and not (k == "latency_p99_ms" and not v)
                       and not (k == "hang" and not v)}
                for name, rule in self.sites
            },
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ChaosPlan":
        if not isinstance(d, dict):
            raise ValueError("chaos plan must be a JSON object")
        sites_raw = d.get("sites", {})
        if not isinstance(sites_raw, dict):
            raise ValueError("chaos plan 'sites' must be an object")
        sites = []
        for name, spec in sites_raw.items():
            if not isinstance(spec, dict) or "kind" not in spec:
                raise ValueError(f"site {name!r} needs a 'kind'")
            kw = dict(spec)
            if "schedule" in kw:
                kw["schedule"] = tuple(int(x) for x in kw["schedule"])
            sites.append((str(name), SiteRule(**kw)))
        return ChaosPlan(seed=int(d.get("seed", 0)),
                         sites=tuple(sites),
                         name=str(d.get("name", "")))

    @staticmethod
    def from_json(blob: str) -> "ChaosPlan":
        return ChaosPlan.from_dict(json.loads(blob))

    @staticmethod
    def load(path: str) -> "ChaosPlan":
        """Load a checked-in plan file.  Unlike the programmatic
        constructors (tests build plans against synthetic sites), a
        FILE plan is an operator artifact: its site names are validated
        against :data:`KNOWN_SITES` here, at load time, so a typo fails
        loudly instead of never firing."""
        with open(path) as f:
            return ChaosPlan.from_dict(json.load(f)).validate_sites()
