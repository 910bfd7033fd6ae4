"""Measured autotuner of the main path's launch geometry (counterpart of the
JAX package's ``tune/autotune.py``; ``ia tune`` is its CLI face).

:func:`build_plan` lays out the sweeps as data, without touching CUDA;
:func:`run_plan` runs them.  Two sweeps, at the main path's headline
shapes (npr_1024's widest wavefront batch of each kernel's levels):

- ``packed2k_best`` (levels 0-1) at M = 352 query rows, N = 2^20 DB rows,
  223 of 256 lanes (L = 55 live dims): ``chunks_per_sm`` in {1, 2, 4} and
  ``ring_stages`` from 2 up to the deepest ring that fits;
- ``argmin_l2`` (levels 2-4) at M = 88, N = 65,536, F = 68 of 128 lanes:
  ``chunks_per_sm`` in {1, 2, 4}.

Each candidate flows through the production funnel (``tune.resolve``
under :func:`~image_analogies_tpu_torch.tune.resolve.override`) and the
production wrapper, on seeded data (a duplicated DB row in two chunks, a
query equal to it, and for the argmin padding rows).  Its time is the
minimum over ``reps`` calls of the device time between two CUDA events
(a spin kernel queued ahead of each call, so the host's issue is not in
the window), after one warm call, each call inside a ``tune.candidate``
span.  Before anything is persisted the tuner checks what the plans are
built to keep: every candidate's ``idx`` and ``val`` are the same bits.
A sweep that fails is reported ``verified: false`` and never stored.
Winners go under the bucket-wildcard key of their (device, strategy,
dtype, width), so one measurement covers every DB size.

``--knob ann`` (not part of ``all``, as in the JAX package) sweeps the
two-stage ANN matcher's slab ``ann_top_m`` over 16, 32, 64 and 128 with
full syntheses of the gates' probe pair (32^2, 2 levels, the wavefront),
each audited against an exact run of the same pair (``utils/parity.py``):
only a candidate whose mismatches are all tie-explained may win, and a
sweep with none is ``verified: false``.  Unlike the JAX package it stores
no winner: it prints the winner, the default's time and whether the
winner beats the default by more than either's spread, and the slab stays
``DEFAULT_ANN_TOP_M`` (or a row written by hand under the wildcard key
``device|wavefront|f32|f128|b*``, where every call site resolves it).  A
winner timed and audited on a 32^2 pair would serve every size.

``scan_tile_cap`` and ``PACKED_CROSSOVER_ROWS`` change picks, not only
time, so they are not swept here (their sweeps need the oracle audit).
``device="cpu"`` runs the kernels' plain versions, which have no geometry:
plumbing only, for the tests.
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Dict, List, Optional, Sequence

from image_analogies_tpu_torch.obs import trace as _trace
from image_analogies_tpu_torch.tune import geometry as _geometry
from image_analogies_tpu_torch.tune import resolve as _resolve
from image_analogies_tpu_torch.tune import store as _store

CHUNKS_CANDIDATES = (1, 2, 4)
KNOBS = {"chunks": ("chunks_per_sm",), "stages": ("ring_stages",),
         "all": ("chunks_per_sm", "ring_stages"), "ann": ("ann_top_m",)}
# the ANN slab candidates (the JAX package's ANN_TOP_M_CANDIDATES)
ANN_TOP_M_CANDIDATES = (16, 32, 64, 128)
# the ANN sweep's synthesis: the gates' probe pair at this size and depth
ANN_SHAPE = dict(size=32, levels=2)
# the main path's headline shapes (chip_smoke.py PACKED_SHAPE, ARGMIN_SHAPE)
PACKED_SHAPE = dict(m=352, n=1 << 20, lw=55)
ARGMIN_SHAPE = dict(m=88, n=65536, f=68, fp=128)
# cycles of the spin kernel queued ahead of each timed call
_SPIN_CYCLES = 1_000_000


def _packed_lanes(lw: int):
    """(width 4L + 3, k_used, K) of the main path's packed2k rows."""
    width = 4 * lw + 3
    k_used = -(-width // 16) * 16
    return width, k_used, -(-k_used // 128) * 128


def deepest_ring(m: int, n: int, k_used: int) -> int:
    """The ring depth of packed2k's default plan at this shape (the deepest
    that fits beside the chosen warpgroups' queries; no SM count enters)."""
    from image_analogies_tpu_torch.ops.match import _packed2k_plan

    return _packed2k_plan(m, n, 132, k_used).stages


def build_plan(*, knob: str = "all", reps: int = 5,
               candidates: Optional[Sequence[int]] = None,
               store: Optional[str] = None, device: str = "cuda",
               rows: int = 0) -> Dict[str, Any]:
    """The sweep plan as data.  ``candidates`` replaces the swept knob's
    default values (one knob only); ``rows`` (0: the headline N) is the DB
    rows of every sweep, for a short or CPU run."""
    if knob not in KNOBS:
        raise ValueError(f"unknown tune knob {knob!r}")
    if candidates is not None:
        if knob == "all":
            raise ValueError("--candidates takes one knob (chunks or "
                             "stages), not all")
        candidates = sorted({int(c) for c in candidates})
        if not candidates or candidates[0] < 1:
            raise ValueError(f"{knob} candidates must be positive, got "
                             f"{candidates}")
    kind = "cpu" if device == "cpu" else _resolve.device_kind()
    sweeps: List[Dict[str, Any]] = []
    if knob == "ann":
        sweeps.append({
            "kernel": "two_stage", "knobs": ["ann_top_m"],
            "store_key": _resolve.make_key(kind, "wavefront", "f32", 128,
                                           "*"),
            "candidates": [{"ann_top_m": c} for c in
                           (candidates or ANN_TOP_M_CANDIDATES)],
            "shape": dict(ANN_SHAPE),
        })
        return {"device": device, "device_kind": kind, "reps": int(reps),
                "store": _store.store_path(store), "sweeps": sweeps}
    m, lw = PACKED_SHAPE["m"], PACKED_SHAPE["lw"]
    n = rows or PACKED_SHAPE["n"]
    width, k_used, kp = _packed_lanes(lw)
    chunks = (candidates if knob == "chunks" and candidates
              else CHUNKS_CANDIDATES)
    deepest = deepest_ring(m, n, k_used)
    stages = (candidates if knob == "stages" and candidates
              else tuple(range(2, deepest + 1)))
    grid = {"chunks_per_sm": chunks, "ring_stages": stages}
    names = KNOBS[knob]
    sweeps.append({
        "kernel": "packed2k_best", "knobs": list(names),
        "store_key": _resolve.make_key(kind, "wavefront", "packed2", kp, "*"),
        "candidates": [dict(zip(names, vals)) for vals in
                       itertools.product(*(grid[k] for k in names))],
        "shape": {"m": m, "n": n, "lw": lw, "width": width,
                  "k_used": k_used, "kp": kp, "deepest_ring": deepest},
    })
    if "chunks_per_sm" in names:
        sweeps.append({
            "kernel": "argmin_l2", "knobs": ["chunks_per_sm"],
            "store_key": _resolve.make_key(kind, "wavefront", "f32",
                                           ARGMIN_SHAPE["fp"], "*"),
            "candidates": [{"chunks_per_sm": c} for c in chunks],
            "shape": dict(ARGMIN_SHAPE, n=rows or ARGMIN_SHAPE["n"]),
        })
    return {"device": device, "device_kind": kind, "reps": int(reps),
            "store": _store.store_path(store), "sweeps": sweeps}


def _operands(sweep: Dict[str, Any], dev, seed: int):
    """Seeded operands of a sweep on ``dev``: (call(cfg) -> (idx, val),
    the launch plan of a config on the card, or None)."""
    import torch

    from image_analogies_tpu_torch.ops import match

    g = torch.Generator(device=dev).manual_seed(seed)
    shape = sweep["shape"]
    m, n = shape["m"], shape["n"]
    lo, hi = n // 64, n * 15 // 16  # a duplicated row, in two chunks
    if sweep["kernel"] == "packed2k_best":
        width, k_used, kp = shape["width"], shape["k_used"], shape["kp"]
        wk = torch.zeros((n, kp), dtype=torch.bfloat16, device=dev)
        wk[:, :width] = torch.randn((n, width), generator=g, device=dev)
        wk[hi] = wk[lo]
        qa = torch.zeros((m, kp), dtype=torch.bfloat16, device=dev)
        qa[:, :width] = torch.randn((m, width), generator=g, device=dev)
        qa[0] = wk[lo]

        def call(cfg):
            return match.packed_best(qa, wk, k_used,
                                     chunks_per_sm=cfg.chunks_per_sm,
                                     ring_stages=cfg.ring_stages)

        def plan(cfg, sm):
            return match._packed2k_plan(m, n, sm, k_used, cfg.chunks_per_sm,
                                        cfg.ring_stages)._asdict()
        return call, plan
    f, fp = shape["f"], shape["fp"]
    n_real = n - 100  # the last 100 rows padding: zero rows, +inf norms
    db = torch.zeros((n, fp), dtype=torch.float32, device=dev)
    db[:n_real, :f] = 0.2 * torch.rand((n_real, f), generator=g, device=dev)
    db[hi] = db[lo]
    dbn = torch.full((n,), float("inf"), device=dev)
    dbn[:n_real] = (db[:n_real] ** 2).sum(dim=1)
    q = 0.2 * torch.rand((m, f), generator=g, device=dev)
    q[0] = db[lo, :f]

    def call(cfg):
        return match.argmin_l2(q, db, dbn, chunks_per_sm=cfg.chunks_per_sm)

    def plan(cfg, sm):
        return match._argmin_plan(m, n, sm, f, cfg.chunks_per_sm)._asdict()
    return call, plan


def _time_ms(fn, reps: int, on_card: bool, **attrs):
    """(min, max) ms of ``reps`` calls after one warm call: device time
    between CUDA events on the card, host time on the CPU."""
    import torch

    fn()
    times = []
    for _ in range(max(reps, 1)):
        with _trace.span("tune.candidate", **attrs):
            if on_card:
                torch.cuda._sleep(_SPIN_CYCLES)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
    return min(times), max(times)


def _run_ann_sweep(sweep: Dict[str, Any], reps: int,
                   device: str) -> Dict[str, Any]:
    """The ``ann_top_m`` sweep: per candidate, one warm and ``reps`` timed
    two-stage syntheses of the probe pair (the run's wall, after a wait for
    the device), the last audited against an exact run.  Only tie-clean
    candidates (no unexplained mismatch, first divergence a tie) may
    win."""
    import torch

    from image_analogies_tpu_torch.backends import gate
    from image_analogies_tpu_torch.models.analogy import create_image_analogy
    from image_analogies_tpu_torch.utils.parity import (
        audit_source_map_mismatches)

    shape = sweep["shape"]
    dev = torch.device(device)
    a, ap, b = gate._bf16_probe_pair(shape["size"])
    base = gate._probe_base_params(levels=shape["levels"],
                                   strategy="wavefront")
    exact = create_image_analogy(a, ap, b, base, device=dev,
                                 keep_levels=True)
    ann_params = base.replace(ann_prefilter=True)

    def run():
        res = create_image_analogy(a, ap, b, ann_params, device=dev,
                                   keep_levels=True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return res

    results: List[Dict[str, Any]] = []
    for cand in sweep["candidates"]:
        with _resolve.override(**cand), gate.ann_gate_bypass():
            res = run()
            times = []
            for _ in range(max(reps, 1)):
                with _trace.span("tune.candidate", kernel=sweep["kernel"],
                                 **cand):
                    t0 = time.perf_counter()
                    res = run()
                    times.append((time.perf_counter() - t0) * 1e3)
        audit = audit_source_map_mismatches(a, ap, b, base, res.levels,
                                            exact.levels)
        tie_ok = (audit["unexplained"] == 0
                  and audit["first_divergence_is_tie"] is not False)
        results.append({"candidate": cand, "ms": min(times),
                        "spread_ms": max(times) - min(times),
                        "tie_ok": tie_ok,
                        "mismatches": audit["mismatches"],
                        "unexplained": audit["unexplained"]})
    clean = [r for r in results if r["tie_ok"]]
    best = min(clean, key=lambda r: r["ms"]) if clean else None
    default = next((r for r in results if r["candidate"]["ann_top_m"]
                    == _geometry.DEFAULT_ANN_TOP_M), None)
    beats = (best is not None and default is not None
             and default["ms"] - best["ms"]
             > max(best["spread_ms"], default["spread_ms"]))
    # reported, never stored: the probe pair is 32^2, and a slab audited
    # there says nothing of the picks at the sizes a stored row would serve
    return {"kernel": sweep["kernel"], "store_key": sweep["store_key"],
            "shape": shape, "results": results, "verified": bool(clean),
            "winner": best["candidate"] if best else None,
            "winner_ms": best["ms"] if best else None,
            "default_ms": default["ms"] if default else None,
            "beats_default_by_more_than_spread": beats, "persist": False}


def _run_sweep(sweep: Dict[str, Any], reps: int, device: str,
               seed: int) -> Dict[str, Any]:
    import numpy as np
    import torch

    if sweep["kernel"] == "two_stage":
        return _run_ann_sweep(sweep, reps, device)

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    call, plan_of = _operands(sweep, dev, seed)
    sm = (torch.cuda.get_device_properties(dev).multi_processor_count
          if on_card else None)
    shape = sweep["shape"]
    dtype, fp = (("packed2", shape["kp"]) if sweep["kernel"] ==
                 "packed2k_best" else ("f32", shape["fp"]))
    results: List[Dict[str, Any]] = []
    first = None
    verified = True
    for cand in sweep["candidates"]:
        with _resolve.override(**cand):
            cfg = _resolve.resolve(strategy="wavefront", dtype=dtype, fp=fp,
                                   n_rows=shape["n"])
        fn = lambda: call(cfg)  # noqa: E731
        best, worst = _time_ms(fn, reps, on_card, kernel=sweep["kernel"],
                               **cand)
        idx, val = fn()
        bits = (idx.cpu().numpy(), val.cpu().numpy().view(np.int32))
        if first is None:
            first = bits
        same = all(np.array_equal(x, y) for x, y in zip(first, bits))
        verified = verified and same
        results.append({"candidate": cand, "ms": best,
                        "spread_ms": worst - best, "same_bits": same,
                        "plan": plan_of(cfg, sm) if on_card else None})
    best = min(results, key=lambda r: r["ms"])
    default = next((r for r in results if all(
        v == _default_value(k, shape) for k, v in r["candidate"].items())),
        None)
    out = {"kernel": sweep["kernel"], "store_key": sweep["store_key"],
           "shape": shape, "results": results, "verified": verified,
           "winner": best["candidate"], "winner_ms": best["ms"],
           "winner_spread_ms": best["spread_ms"]}
    if default is not None:
        out["default_ms"] = default["ms"]
        out["beats_default_by_more_than_spread"] = bool(
            default["ms"] - best["ms"] > best["spread_ms"])
    return out


def _default_value(knob: str, shape: Dict[str, Any]) -> int:
    """The value of ``knob`` that gives the default plan at ``shape``:
    ring_stages 0 means the deepest ring, which a sweep names by number."""
    if knob == "ring_stages" and "deepest_ring" in shape:
        return shape["deepest_ring"]
    return _resolve._DEFAULTS[knob]


def run_plan(plan: Dict[str, Any], *, persist: bool = True,
             seed: int = 0) -> Dict[str, Any]:
    """Run a plan of :func:`build_plan`.  A sweep whose candidates do not
    all give the same ``idx`` and ``val`` bits is reported
    ``verified: false`` and its winner is not persisted."""
    out: List[Dict[str, Any]] = []
    winners: Dict[str, Dict[str, Any]] = {}
    for sweep in plan["sweeps"]:
        res = _run_sweep(sweep, plan["reps"], plan["device"], seed)
        out.append(res)
        if res["verified"] and persist and res.get("persist", True):
            entry = winners.setdefault(res["store_key"], {})
            entry.update(res["winner"])
            entry["source"] = "ia tune"
            entry[f"{res['kernel']}_ms"] = res["winner_ms"]
    saved = None
    if winners and persist:
        saved = _store.merge_entries(winners, plan["store"])
    info: Dict[str, Any] = {}
    if plan["device"] != "cpu":
        info["power_limit"] = _trace._power_limit()
    return {"device_kind": plan["device_kind"], **info, "sweeps": out,
            "persisted": saved,
            "all_verified": all(r["verified"] for r in out)}
