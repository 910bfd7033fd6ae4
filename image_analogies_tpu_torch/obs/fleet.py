"""Federated fleet metrics: N worker snapshots -> one labeled view (the
port's copy of the JAX package's ``obs/fleet.py``).

The merge is TRANSPORT-AGNOSTIC: it consumes the plain snapshot schema
(``MetricsRegistry.snapshot()``) — whether a snapshot came from an
in-process ``ObsScope`` or was recovered from a remote worker's
``/metrics`` exposition via :func:`snapshot_from_exposition` makes no
difference, so a future subprocess/socket worker federates by scrape
with zero new code here.

Federation is LABEL-ONLY: every per-worker sample is re-emitted exactly
as the worker reported it, under a ``worker="<wid>"`` label; the
unlabeled merged sample is a pure roll-up computed from those same
values (counters sum, max-gauges max, histograms merge bucketwise).
No worker's sample value is ever mutated, scaled, or reinterpreted —
the labeled series and the merged series are byte-consistent by
construction because both render through obs.live's formatter.

Merge rules per section:

- counters: SUM across workers.
- gauges: SUM, except max-gauge families (peak watermarks, uptime,
  breaker state, slo.* health gauges — see ``_MAX_GAUGE_MARKERS``)
  which take the MAX (summing two HBM peaks invents memory no device
  has; summing breaker states invents a state no breaker is in).
- histograms: counts/sums add, min/max extremize, base-2 buckets add
  key-wise — merging N workers' latency histograms is exact, not an
  approximation, because every worker uses the same bucket edges.

Host-side only, like the rest of the obs core: it reads snapshots,
never the card.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Tuple

from image_analogies_tpu_torch.obs import live as _live
from image_analogies_tpu_torch.obs import quantiles as _quantiles

# Gauge families merged by MAX instead of SUM.  Substring match on the
# dotted registry name: peak watermarks and state-like gauges are
# "highest wins"; everything else (queue depths, byte totals) sums.
_MAX_GAUGE_MARKERS = ("peak", "uptime", "breaker.state", "slo.")


def is_max_gauge(name: str) -> bool:
    return any(m in name for m in _MAX_GAUGE_MARKERS)


def _empty_hist() -> Dict[str, Any]:
    return {"count": 0, "sum": 0.0, "min": math.inf, "max": -math.inf,
            "buckets": {}}


def merge_histograms(summaries: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge N ``Histogram.summary()`` dicts into one (same schema)."""
    acc = _empty_hist()
    for s in summaries:
        count = int(s.get("count", 0))
        if not count:
            continue
        acc["count"] += count
        acc["sum"] += float(s.get("sum", 0.0))
        acc["min"] = min(acc["min"], float(s.get("min", 0.0)))
        acc["max"] = max(acc["max"], float(s.get("max", 0.0)))
        for k, v in (s.get("buckets") or {}).items():
            acc["buckets"][str(k)] = acc["buckets"].get(str(k), 0) + int(v)
    if not acc["count"]:
        return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0, "mean": 0.0}
    acc["mean"] = acc["sum"] / acc["count"]
    acc["buckets"] = {k: acc["buckets"][k]
                      for k in sorted(acc["buckets"], key=int)}
    return acc


def merge_snapshots(by_worker: Dict[str, Dict[str, dict]]
                    ) -> Dict[str, dict]:
    """Roll N worker snapshots into one fleet snapshot."""
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, List[Dict[str, Any]]] = {}
    for _wid, snap in sorted(by_worker.items()):
        for name, v in (snap.get("counters") or {}).items():
            counters[name] = counters.get(name, 0) + v
        for name, v in (snap.get("gauges") or {}).items():
            if name in gauges and is_max_gauge(name):
                gauges[name] = max(gauges[name], v)
            else:
                gauges[name] = gauges.get(name, 0) + v if name in gauges \
                    else v
    for _wid, snap in sorted(by_worker.items()):
        for name, summ in (snap.get("histograms") or {}).items():
            hists.setdefault(name, []).append(summ)
    sketches: Dict[str, List[Dict[str, Any]]] = {}
    for _wid, snap in sorted(by_worker.items()):
        for name, summ in (snap.get("sketches") or {}).items():
            sketches.setdefault(name, []).append(summ)
    out = {
        "counters": counters,
        "gauges": gauges,
        "histograms": {name: merge_histograms(ss)
                       for name, ss in hists.items()},
    }
    if sketches:
        # merge-closed by construction (bucket counts add on a shared
        # grid), so the fleet sketch equals the whole-stream sketch.
        out["sketches"] = {name: _quantiles.merge_summaries(ss)
                           for name, ss in sketches.items()}
    return out


# --- tenant federation -------------------------------------------------------

def merge_tenant_docs(docs: List[Dict[str, Any]],
                      k: Optional[int] = None) -> Dict[str, Any]:
    """Federate per-worker ``/tenants`` documents into one fleet-level
    top-K.  Thin re-export of :func:`obs.tenants.merge_docs` so the
    fleet-federation surface lives beside the metrics merge; the sketch
    math (mergeable space-saving, honest error intervals) is documented
    on the tenants module."""
    from image_analogies_tpu_torch.obs import tenants as _tenants

    return _tenants.merge_docs(docs, k=k)


# --- labeled exposition -----------------------------------------------------

def render_fleet(by_worker: Dict[str, Dict[str, dict]],
                 extra: Optional[Tuple[str, Dict[str, dict]]] = None) -> str:
    """Prometheus text of the fleet: for every metric family, the MERGED
    unlabeled sample followed by one ``{worker="<wid>"}`` sample per
    worker, all through obs.live's formatter so the labeled values sum
    byte-consistently to the merged one.

    ``extra`` is an optional ``(label, snapshot)`` whose families are
    appended (labeled, NOT merged) only where they do not collide with a
    worker family — the fleet's own routing-plane counters surface this
    way without double counting (the run scope's registry already
    contains every worker's chained writes).
    """
    merged = merge_snapshots(by_worker)
    wids = sorted(by_worker)
    lines: List[str] = []

    def val(snap: Dict[str, dict], section: str, name: str):
        return (snap.get(section) or {}).get(name)

    for name in sorted(merged["counters"]):
        pn = _live.prom_name(name) + "_total"
        lines.append(f"# HELP {pn} counter {name}")
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {_live._fmt(merged['counters'][name])}")
        for wid in wids:
            v = val(by_worker[wid], "counters", name)
            if v is not None:
                lines.append(f'{pn}{{worker="{wid}"}} {_live._fmt(v)}')

    for name in sorted(merged["gauges"]):
        pn = _live.prom_name(name)
        lines.append(f"# HELP {pn} gauge {name}")
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {_live._fmt(merged['gauges'][name])}")
        for wid in wids:
            v = val(by_worker[wid], "gauges", name)
            if v is not None:
                lines.append(f'{pn}{{worker="{wid}"}} {_live._fmt(v)}')

    for name in sorted(merged["histograms"]):
        pn = _live.prom_name(name)
        lines.append(f"# HELP {pn} histogram {name}")
        lines.append(f"# TYPE {pn} histogram")
        lines.extend(_hist_lines(pn, merged["histograms"][name], ""))
        for wid in wids:
            summ = val(by_worker[wid], "histograms", name)
            if summ is not None:
                lines.extend(_hist_lines(pn, summ, f'worker="{wid}"'))

    for name in sorted(merged.get("sketches") or {}):
        lines.extend(_live.sketch_lines(name, merged["sketches"][name]))
        for wid in wids:
            summ = val(by_worker[wid], "sketches", name)
            if summ is not None:
                lines.extend(_live.sketch_lines(name, summ,
                                                f'worker="{wid}"'))

    if extra is not None:
        label, snap = extra
        taken = (set(merged["counters"]) | set(merged["gauges"])
                 | set(merged["histograms"]))
        only = {
            "counters": {k: v for k, v in (snap.get("counters") or {})
                         .items() if k not in taken},
            "gauges": {k: v for k, v in (snap.get("gauges") or {})
                       .items() if k not in taken},
            "histograms": {k: v for k, v in (snap.get("histograms") or {})
                           .items() if k not in taken},
        }
        for name in sorted(only["counters"]):
            pn = _live.prom_name(name) + "_total"
            lines.append(f"# HELP {pn} counter {name}")
            lines.append(f"# TYPE {pn} counter")
            lines.append(f'{pn}{{worker="{label}"}} '
                         f"{_live._fmt(only['counters'][name])}")
        for name in sorted(only["gauges"]):
            pn = _live.prom_name(name)
            lines.append(f"# HELP {pn} gauge {name}")
            lines.append(f"# TYPE {pn} gauge")
            lines.append(f'{pn}{{worker="{label}"}} '
                         f"{_live._fmt(only['gauges'][name])}")
        for name in sorted(only["histograms"]):
            pn = _live.prom_name(name)
            lines.append(f"# HELP {pn} histogram {name}")
            lines.append(f"# TYPE {pn} histogram")
            lines.extend(_hist_lines(pn, only["histograms"][name],
                                     f'worker="{label}"'))

    if not lines:
        lines.append("# empty fleet (no worker scopes)")
    return "\n".join(lines) + "\n"


def _hist_lines(pn: str, summ: Dict[str, Any], label: str) -> List[str]:
    """One histogram family's sample lines, optionally worker-labeled
    (the ``le`` label composes with it)."""
    out: List[str] = []
    cum = 0
    for k in sorted(int(x) for x in (summ.get("buckets") or {})):
        cum += int(summ["buckets"][str(k)])
        le = _live._fmt(float(2 ** k))
        lab = f'le="{le}"' + (f",{label}" if label else "")
        out.append(f"{pn}_bucket{{{lab}}} {cum}")
    count = int(summ.get("count", 0))
    inf_lab = 'le="+Inf"' + (f",{label}" if label else "")
    suffix = f"{{{label}}}" if label else ""
    out.append(f"{pn}_bucket{{{inf_lab}}} {count}")
    out.append(f"{pn}_sum{suffix} {_live._fmt(summ.get('sum', 0.0))}")
    out.append(f"{pn}_count{suffix} {count}")
    return out


# --- scrape-side recovery ---------------------------------------------------

_HELP_RE = re.compile(r"^# HELP (\S+) (counter|gauge|histogram) (.+)$")
_SAMPLE_RE = re.compile(r"^(\S+?)(?:\{([^}]*)\})? (\S+)$")
_LE_RE = re.compile(r'le="([^"]+)"')


def snapshot_from_exposition(text: str) -> Dict[str, dict]:
    """Recover a registry snapshot from obs.live's Prometheus text.

    This is the remote half of transport-agnostic federation: scrape a
    worker's ``/metrics``, recover its snapshot, feed it to
    :func:`merge_snapshots` exactly like an in-process scope's.  The
    HELP line carries the original dotted registry name, so recovery is
    lossless for counters and gauges; histograms rebuild their base-2
    buckets from the cumulative samples (min/max/mean are not exposed
    by the text format — min degrades to 0 and max to the top occupied
    bucket edge, which the merge rules tolerate).  Labeled samples
    (an already-federated view) are skipped: federation composes by
    re-scraping workers, not by double-merging roll-ups.
    """
    kinds: Dict[str, Tuple[str, str]] = {}  # prom name -> (kind, dotted)
    for line in text.splitlines():
        m = _HELP_RE.match(line)
        if m:
            kinds[m.group(1)] = (m.group(2), m.group(3))

    snap: Dict[str, dict] = {"counters": {}, "gauges": {}, "histograms": {}}
    hstate: Dict[str, Dict[str, Any]] = {}
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        pn, labels, raw = m.group(1), m.group(2) or "", m.group(3)
        if "worker=" in labels:
            continue
        try:
            value = float(raw)
        except ValueError:
            continue
        base, suffix = pn, ""
        for suf in ("_bucket", "_sum", "_count"):
            if pn.endswith(suf) and pn[:-len(suf)] in kinds \
                    and kinds[pn[:-len(suf)]][0] == "histogram":
                base, suffix = pn[:-len(suf)], suf
                break
        if suffix:
            kind, dotted = kinds[base]
            st = hstate.setdefault(dotted, {"cum": [], "sum": 0.0,
                                            "count": 0})
            if suffix == "_bucket":
                le = _LE_RE.search(labels)
                if le and le.group(1) != "+Inf":
                    st["cum"].append((float(le.group(1)), value))
            elif suffix == "_sum":
                st["sum"] = value
            else:
                st["count"] = int(value)
            continue
        if pn not in kinds and pn.endswith("_total"):
            # counters expose as <name>_total but HELP is keyed on the
            # full sample name already; this branch is unreachable for
            # our own renderer and exists for foreign expositions
            continue
        kind_dotted = kinds.get(pn)
        if kind_dotted is None:
            continue
        kind, dotted = kind_dotted
        if kind == "counter":
            snap["counters"][dotted] = value
        elif kind == "gauge":
            snap["gauges"][dotted] = value

    for dotted, st in hstate.items():
        buckets: Dict[str, int] = {}
        prev = 0.0
        top_edge = 0.0
        for edge, cum in sorted(st["cum"]):
            n = int(cum - prev)
            prev = cum
            if n > 0:
                k = int(round(math.log2(edge))) if edge > 0 else 0
                buckets[str(k)] = buckets.get(str(k), 0) + n
                top_edge = edge
        count = st["count"]
        if count:
            snap["histograms"][dotted] = {
                "count": count, "sum": st["sum"],
                "min": 0.0, "max": top_edge,
                "mean": st["sum"] / count, "buckets": buckets}
        else:
            snap["histograms"][dotted] = {"count": 0, "sum": 0.0,
                                          "min": 0.0, "max": 0.0,
                                          "mean": 0.0}
    return snap
