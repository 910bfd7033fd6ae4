"""Mergeable relative-error quantile sketch (DDSketch-style).

The base-2 histograms in obs/metrics.py answer "which power-of-two
bucket" — fine for p50/p95 dashboards, useless for p99.9 at a million
samples (the top bucket spans a 2x range and swallows the whole tail).
This module adds the honest tail: a log-indexed sketch with a *stated*
relative-error bound that holds at any count.

Design (DDSketch, Masson et al.):

- A value ``v > 0`` lands in bucket ``i = ceil(log(v) / log(gamma))``
  with ``gamma = (1 + alpha) / (1 - alpha)``.  Reporting the bucket
  midpoint ``2 * gamma^i / (gamma + 1)`` guarantees
  ``|est - true| <= alpha * true`` for every quantile — a *relative*
  bound, so p99.99 is as honest as p50.
- Bucket counts are plain integers keyed by index, so two sketches over
  disjoint streams merge by adding counts: ``merge(a, b)`` equals the
  sketch of the concatenated stream exactly (merge-closed, associative,
  commutative) — the property fleet federation and timeline window
  deltas both lean on.
- Memory is fixed: when the bucket map exceeds ``max_bins`` the two
  *lowest* buckets collapse into one.  The error bound degrades only
  at the cheap end of the distribution; tail quantiles keep the
  guarantee (that is the end we care about).

Values ``<= 0`` (and exact zeros) go to a dedicated ``zeros`` count —
latencies are non-negative, but a defensive path must not poison the
log.  Pure stdlib: the port's copy of the JAX package's
``obs/quantiles.py``; sidecars and offline readers import it without an
accelerator runtime.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional

DEFAULT_ALPHA = 0.01     # 1% relative error: p99.9 of 250ms is +/- 2.5ms
DEFAULT_MAX_BINS = 1024  # ~2.5 decades of dynamic range at alpha=0.01

# Quantiles exported on /metrics and in timeline point values.
EXPORT_QUANTILES = (0.5, 0.9, 0.99, 0.999, 0.9999)


class QuantileSketch:
    """Fixed-memory mergeable quantile sketch with relative-error
    guarantee ``alpha`` (see module docstring for the math)."""

    __slots__ = ("alpha", "gamma", "_lg", "max_bins", "count", "zeros",
                 "sum", "min", "max", "bins", "collapsed")

    def __init__(self, alpha: float = DEFAULT_ALPHA,
                 max_bins: int = DEFAULT_MAX_BINS):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        if max_bins < 2:
            raise ValueError(f"max_bins must be >= 2, got {max_bins}")
        self.alpha = alpha
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self._lg = math.log(self.gamma)
        self.max_bins = max_bins
        self.count = 0
        self.zeros = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.bins: Dict[int, int] = {}
        self.collapsed = False

    # ------------------------------------------------------------ write
    def observe(self, v: float) -> None:
        v = float(v)
        if v != v:  # NaN: drop rather than poison min/max
            return
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= 0.0:
            self.zeros += 1
            return
        i = math.ceil(math.log(v) / self._lg)
        self.bins[i] = self.bins.get(i, 0) + 1
        if len(self.bins) > self.max_bins:
            self._collapse()

    def _collapse(self) -> None:
        # Fold the lowest bucket into its neighbour above: tail accuracy
        # is preserved, only the cheapest values blur together.
        keys = sorted(self.bins)
        lo, nxt = keys[0], keys[1]
        self.bins[nxt] += self.bins.pop(lo)
        self.collapsed = True

    # ------------------------------------------------------------- read
    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1]; 0.0 for an empty sketch.
        Within ``alpha`` relative error of the exact stream quantile
        (exact-rank semantics: rank ``ceil(q * count)``)."""
        if self.count == 0:
            return 0.0
        q = min(max(q, 0.0), 1.0)
        rank = max(1, math.ceil(q * self.count))
        if rank <= self.zeros:
            # all mass at or below zero reports the observed floor
            return min(self.min, 0.0)
        cum = self.zeros
        for i in sorted(self.bins):
            cum += self.bins[i]
            if cum >= rank:
                # bucket i covers (gamma^(i-1), gamma^i]; midpoint halves
                # the worst-case multiplicative error to alpha.
                return 2.0 * self.gamma ** i / (self.gamma + 1.0)
        return self.max  # numeric slack: top bucket

    def quantiles_doc(self) -> Dict[str, float]:
        """The export view: p50/p90/p99/p999/p9999 rounded for JSON."""
        out: Dict[str, float] = {}
        for q in EXPORT_QUANTILES:
            key = "p" + format(q * 100, "g").replace(".", "")
            out[key] = round(self.quantile(q), 6)
        return out

    # ------------------------------------------------------------ merge
    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into self (in place; also returned).  Both
        sketches must share ``alpha`` — buckets are only additive on a
        common grid."""
        if abs(other.alpha - self.alpha) > 1e-12:
            raise ValueError(
                f"cannot merge sketches with alpha {self.alpha} and "
                f"{other.alpha}: bucket grids differ")
        self.count += other.count
        self.zeros += other.zeros
        self.sum += other.sum
        if other.count:
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)
        for i, n in other.bins.items():
            self.bins[i] = self.bins.get(i, 0) + n
        while len(self.bins) > self.max_bins:
            self._collapse()
        self.collapsed = self.collapsed or other.collapsed
        return self

    # ------------------------------------------------- JSON round trip
    def summary(self) -> Dict[str, Any]:
        """JSON-safe snapshot: everything needed to reconstruct the
        sketch (``from_summary``) or merge it remotely.  Bucket keys are
        strings because JSON objects only key on strings."""
        empty = self.count == 0
        return {
            "alpha": self.alpha,
            "count": self.count,
            "zeros": self.zeros,
            "sum": round(self.sum, 6),
            "min": 0.0 if empty else self.min,
            "max": 0.0 if empty else self.max,
            "bins": {str(i): n for i, n in sorted(self.bins.items())},
            "collapsed": self.collapsed,
        }

    @classmethod
    def from_summary(cls, summ: Dict[str, Any],
                     max_bins: int = DEFAULT_MAX_BINS) -> "QuantileSketch":
        sk = cls(alpha=float(summ.get("alpha", DEFAULT_ALPHA)),
                 max_bins=max_bins)
        sk.count = int(summ.get("count", 0))
        sk.zeros = int(summ.get("zeros", 0))
        sk.sum = float(summ.get("sum", 0.0))
        if sk.count:
            sk.min = float(summ.get("min", 0.0))
            sk.max = float(summ.get("max", 0.0))
        sk.bins = {int(i): int(n)
                   for i, n in (summ.get("bins") or {}).items()}
        sk.collapsed = bool(summ.get("collapsed", False))
        return sk


def merge_summaries(summaries: Iterable[Dict[str, Any]]
                    ) -> Optional[Dict[str, Any]]:
    """Merge JSON summaries (the federation path: worker snapshots ->
    one fleet sketch).  Returns ``None`` for an empty iterable."""
    merged: Optional[QuantileSketch] = None
    for summ in summaries:
        sk = QuantileSketch.from_summary(summ)
        merged = sk if merged is None else merged.merge(sk)
    return None if merged is None else merged.summary()


def delta_summary(cur: Dict[str, Any], prev: Optional[Dict[str, Any]]
                  ) -> Optional[Dict[str, Any]]:
    """Windowed delta of two cumulative summaries (``cur - prev``): the
    sketch of just the samples that arrived between the two snapshots.
    Bucket additivity makes subtraction exact.  Returns ``None`` when
    ``cur`` regressed below ``prev`` (process restart -> the caller
    should treat ``cur`` as a fresh generation)."""
    if prev is None:
        return dict(cur)
    if int(cur.get("count", 0)) < int(prev.get("count", 0)):
        return None
    bins: Dict[str, int] = {}
    pbins = prev.get("bins") or {}
    for i, n in (cur.get("bins") or {}).items():
        d = int(n) - int(pbins.get(i, 0))
        if d < 0:
            return None  # collapse shifted mass: treat as regression
        if d > 0:
            bins[i] = d
    count = int(cur.get("count", 0)) - int(prev.get("count", 0))
    return {
        "alpha": cur.get("alpha", DEFAULT_ALPHA),
        "count": count,
        "zeros": int(cur.get("zeros", 0)) - int(prev.get("zeros", 0)),
        "sum": round(float(cur.get("sum", 0.0))
                     - float(prev.get("sum", 0.0)), 6),
        # min/max are not subtractable; the window inherits the
        # cumulative envelope (documented approximation).
        "min": cur.get("min", 0.0),
        "max": cur.get("max", 0.0),
        "bins": bins,
        "collapsed": bool(cur.get("collapsed", False)),
    }


def exact_quantile(values: List[float], q: float) -> float:
    """Exact-rank quantile of a finite list — the oracle the sketch is
    asserted against in tests and the seeded bench selftest."""
    if not values:
        return 0.0
    s = sorted(values)
    rank = max(1, math.ceil(min(max(q, 0.0), 1.0) * len(s)))
    return s[rank - 1]


def selftest(n: int = 100_000, seed: int = 7,
             alpha: float = DEFAULT_ALPHA) -> Dict[str, Any]:
    """Seeded lognormal tail-honesty check: sketch p99.9 vs exact, both
    whole-stream and after a two-way (worker -> fleet) merge.  Returns a
    record-style dict; ``ok`` is False if either estimate violates the
    stated relative-error bound.  Scaled down (n=1e5) this rides tier-1;
    bench runs it at 1e6."""
    import random

    rng = random.Random(seed)
    values = [rng.lognormvariate(3.0, 0.7) for _ in range(n)]
    whole = QuantileSketch(alpha=alpha)
    a, b = QuantileSketch(alpha=alpha), QuantileSketch(alpha=alpha)
    for i, v in enumerate(values):
        whole.observe(v)
        (a if i % 2 == 0 else b).observe(v)
    merged = a.merge(b)
    out: Dict[str, Any] = {"n": n, "seed": seed, "alpha": alpha,
                           "bound": alpha, "ok": True}
    for q, key in ((0.99, "p99"), (0.999, "p999"), (0.9999, "p9999")):
        exact = exact_quantile(values, q)
        est, est_m = whole.quantile(q), merged.quantile(q)
        rel = abs(est - exact) / exact
        rel_m = abs(est_m - exact) / exact
        out[key] = {"exact": round(exact, 4), "sketch": round(est, 4),
                    "rel_err": round(rel, 6),
                    "rel_err_merged": round(rel_m, 6)}
        if rel > alpha or rel_m > alpha:
            out["ok"] = False
    out["p999_rel_err"] = out["p999"]["rel_err"]
    return out
