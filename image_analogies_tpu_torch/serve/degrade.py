"""Deadline policy: run full, degrade, or cancel-before-dispatch (the
port's copy of the JAX package's ``serve/degrade.py``).

Cost model: synthesis work scales ~ target pixels x pyramid levels x
patch area (the per-pixel candidate scan dominates both backends), so we
keep one EWMA rate in seconds per (pixel*level*patch^2) unit, updated
from every completed dispatch.  The prior is deliberately optimistic —
until we have measurements we'd rather attempt full fidelity and learn
from the overrun than degrade requests a fresh server could have served
whole.

The degradation ladder only ever *reduces* fidelity knobs the paper's
pyramid makes safe to reduce (fewer levels, then the minimum 3x3 patch);
a degraded response is a valid synthesis, just flagged.

The EWMA's STARTING rate is no longer hardwired: :func:`load_prior`
seeds it from the tune store (this device's last serve run persisted its
learned rate there), falling back to the packaged per-device-class rate
(tune/tables.py ``COST_RATES``, empty in the port: no card's rate ships)
and only then to the optimistic default — so a restarted
server makes informed degrade decisions from its first request instead
of re-learning the device from scratch.  Provenance is counted as
``serve.cost_prior.{store,packaged,default}``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

from image_analogies_tpu_torch.config import AnalogyParams
from image_analogies_tpu_torch.serve.types import Request
from image_analogies_tpu_torch.tune import store as tune_store
from image_analogies_tpu_torch.tune import tables as tune_tables

# Optimistic prior (s per pixel*level*patch^2); EWMA weight of new samples.
_PRIOR_RATE = 1e-7
_ALPHA = 0.4


def work_units(pixels: int, levels: int, patch_size: int) -> float:
    return float(pixels) * max(1, levels) * patch_size * patch_size


class CostModel:
    """Thread-safe EWMA of observed dispatch cost.

    A ``seeded`` prior (loaded from the store/packaged tables) is treated
    as a real past measurement: the first observed sample BLENDS into it
    instead of replacing it — only the hardwired optimistic default is
    discarded wholesale on first contact with reality.
    """

    def __init__(self, prior_rate: float = _PRIOR_RATE,
                 seeded: bool = False):
        self._rate = prior_rate
        self._seeded = seeded
        self._samples = 1 if seeded else 0
        self._lock = threading.Lock()

    def observe(self, units: float, seconds: float) -> None:
        if units <= 0 or seconds <= 0:
            return
        sample = seconds / units
        with self._lock:
            if self._samples == 0:
                self._rate = sample
            else:
                self._rate = _ALPHA * sample + (1 - _ALPHA) * self._rate
            self._samples += 1

    def estimate(self, units: float) -> float:
        with self._lock:
            return self._rate * units

    @property
    def rate(self) -> float:
        with self._lock:
            return self._rate

    @property
    def samples(self) -> int:
        with self._lock:
            return self._samples

    @property
    def real_samples(self) -> int:
        """Observed (non-seed) samples — what persistence gates on."""
        with self._lock:
            return self._samples - (1 if self._seeded else 0)


def cost_key(params: AnalogyParams) -> str:
    """Tune-store key for this (backend, device class) pair's serve cost
    rate: ``serve_cost|cuda|h100`` for the device matcher on an H100,
    ``serve_cost|cuda|cpu`` for its plain versions on the CPU, and
    ``serve_cost|cpu|any`` for the host oracle.  The card's name is read
    best-effort (``tune/tables.py card_class``), so this resolves without
    a card."""
    cls = "any"
    if params.backend == "cuda":
        cls = tune_tables.card_class(params.device)
    return f"serve_cost|{params.backend}|{cls}"


def load_prior(params: AnalogyParams) -> Tuple[float, str]:
    """Resolve the EWMA's starting rate: ``(rate, provenance)`` with
    provenance one of ``store`` (a previous serve run on this device
    persisted its learned rate), ``packaged`` (per-device-class rate
    shipped with the package), ``default`` (the optimistic hardwired
    prior)."""
    key = cost_key(params)
    entry = tune_store.load_entries().get(key)
    if entry is not None:
        rate = entry.get("cost_rate")
        if isinstance(rate, (int, float)) and rate > 0:
            return float(rate), "store"
    cls = key.rsplit("|", 1)[1]
    packaged = tune_tables.COST_RATES.get(f"{params.backend}|{cls}")
    if packaged:
        return packaged, "packaged"
    return _PRIOR_RATE, "default"


def persist_rate(model: CostModel, params: AnalogyParams) -> Optional[str]:
    """Write the model's learned rate into the tune store (the next
    server's ``store`` prior).  No-op without real observations — a prior
    that never met traffic must not launder itself into a measurement."""
    if model.real_samples < 1:
        return None
    key = cost_key(params)
    tune_store.merge_entries({key: {
        "cost_rate": model.rate,
        "source": "serve",
        "samples": model.samples,
    }})
    return key


def _ladder(params: AnalogyParams):
    """Fidelity configs from full to minimum, each a valid AnalogyParams
    substitution.  Patch sizes stay odd (engine invariant)."""
    patches = [params.patch_size]
    if params.patch_size > 3:
        patches.append(3)
    for levels in range(params.levels, 0, -1):
        for patch in patches:
            yield levels, patch


def plan(req: Request, model: CostModel, *, allow_degrade: bool
         ) -> Tuple[str, AnalogyParams, Optional[Dict[str, Any]]]:
    """Decide what to dispatch for ``req`` right now.

    Returns ``(action, params, degraded)`` with action one of:
    - ``"run"``      — full fidelity fits (or no deadline).
    - ``"degrade"``  — ``params`` substituted per ``degraded`` dict.
    - ``"timeout"``  — deadline already expired; cancel before dispatch.
    """
    remaining = req.remaining()
    if remaining is None:
        return "run", req.params, None
    if remaining <= 0:
        return "timeout", req.params, None
    pixels = int(req.b.shape[0]) * int(req.b.shape[1])
    full = model.estimate(
        work_units(pixels, req.params.levels, req.params.patch_size))
    if full <= remaining or not allow_degrade:
        return "run", req.params, None
    for levels, patch in _ladder(req.params):
        if levels == req.params.levels and patch == req.params.patch_size:
            continue
        est = model.estimate(work_units(pixels, levels, patch))
        if est <= remaining:
            return ("degrade",
                    req.params.replace(levels=levels, patch_size=patch),
                    {"levels": levels, "patch_size": patch,
                     "estimate_s": round(est, 4),
                     "full_estimate_s": round(full, 4)})
    # Nothing fits the deadline; dispatch the cheapest valid config rather
    # than guaranteeing failure — the response stays flagged as degraded.
    levels, patch = 1, min(3, req.params.patch_size)
    return ("degrade", req.params.replace(levels=levels, patch_size=patch),
            {"levels": levels, "patch_size": patch, "best_effort": True,
             "full_estimate_s": round(full, 4)})
