"""The parity gates of the opt-in approximate matchers (counterpart of the
gates in the JAX package's ``backends/tpu.py``): bf16 scoring and the
two-stage ANN prefilter.

``AnalogyParams.bf16_scoring`` routes the wavefront anchor through the
scan_rescue machinery (bf16 per-tile champion scan + exact fp32 top-T
re-score with the lowest-index tie-break).  It is a supported flag because
of this gate: the FIRST bf16-scored synthesis on a device runs a small
deterministic probe twice (exact parity scan vs bf16 scan) and audits the
two source maps with ``utils/parity.py``.  Only a verdict whose mismatches
are ALL tie-explained (unexplained == 0, first divergence a tie) enables
the mode; anything else disables it for the process, and every synthesis
silently keeps the exact scan.  Verdicts are cached per device (the card's
name, or "cpu") and readable through :func:`bf16_gate_verdict`.

``AnalogyParams.ann_prefilter`` routes the wavefront anchor and the batched
approximate match through the two-stage matcher (``ops/ann.py``) behind the
same machinery, keyed per (device, strategy): the two strategies prefilter
different DBs (the full DB, the rows-above DB), so one verdict must not
vouch for the other.  The first verdict of a key counts ``ann.gate_ok`` or
``ann.disabled_unexplained`` and emits one ``ann_gate`` record.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from image_analogies_tpu_torch.obs import metrics as obs_metrics
from image_analogies_tpu_torch.obs import trace as obs_trace

_BF16_GATE: Dict[str, Dict[str, Any]] = {}
_BF16_GATE_LOCK = threading.Lock()
_BF16_TLS = threading.local()  # .probing: True inside the gate's bf16 run


def reset_bf16_gate() -> None:
    """Forget cached gate verdicts (tests re-probe after monkeypatching)."""
    with _BF16_GATE_LOCK:
        _BF16_GATE.clear()


def device_key(device) -> str:
    """The gate's cache key: the card's name, or "cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def bf16_gate_verdict(device) -> Optional[Dict[str, Any]]:
    """The cached verdict for ``device`` ({"ok", "mismatches",
    "unexplained", "first_divergence_is_tie"}), or None before the first
    bf16-scored synthesis there."""
    with _BF16_GATE_LOCK:
        verdict = _BF16_GATE.get(device_key(device))
    return None if verdict is None else dict(verdict)


def _bf16_probe_pair(n: int = 32
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic structured probe inputs (a copy of the JAX package's):
    textured enough that fine levels carry real near-tie structure, small
    enough to audit in well under a second."""
    yy, xx = np.meshgrid(np.linspace(0.0, 1.0, n, dtype=np.float32),
                         np.linspace(0.0, 1.0, n, dtype=np.float32),
                         indexing="ij")
    a = (0.5 + 0.5 * np.sin(9.0 * xx) * np.cos(7.0 * yy)).astype(np.float32)
    ap = np.clip(0.8 * a + 0.2 * xx, 0.0, 1.0).astype(np.float32)
    b = (0.5 + 0.5 * np.sin(5.0 * xx + 1.3)
         * np.cos(11.0 * yy + 0.7)).astype(np.float32)
    return a, ap, b


def _probe_base_params(params=None, *, levels: int = 2,
                       strategy: str = "wavefront"):
    """The probes' hermetic EXACT baseline: the caller's params (None: the
    defaults) with the scan forced to ``strategy``'s exact defaults, both
    approximate matchers, the mesh (a probe runs on one device, never
    sharded), the video term, the run's metrics and every resilience and
    IO knob off, so a probe is a pure synthesis of the probe pair that
    writes nothing of the caller's (the port's subset of the JAX
    package's ``_probe_base_params``).  Shared by the bf16 and ANN gates
    and ``ia tune --knob ann``."""
    if params is None:
        from image_analogies_tpu_torch.config import AnalogyParams

        params = AnalogyParams()
    return dataclasses.replace(
        params, levels=levels, strategy=strategy, match_mode="auto",
        bf16_scoring=False, ann_prefilter=False, db_shards=1,
        data_shards=1, temporal_weight=0.0,
        level_retries=0, dispatch_timeout_s=0.0, level_sync=True,
        checkpoint_dir=None, resume_from_level=None, profile_dir=None,
        log_path=None, metrics=False, save_levels_dir=None, pipeline=False,
        donate_buffers=False)


def _probe_verdict(base, flagged, device, tls) -> Dict[str, Any]:
    """The probe pair through ``base`` (the exact engine) and ``flagged``
    (the approximate one, run with ``tls.probing`` set so its own gate
    passes) on ``device``, then the audit of the two source maps."""
    from image_analogies_tpu_torch.models.analogy import create_image_analogy
    from image_analogies_tpu_torch.utils.parity import (
        audit_source_map_mismatches)

    a, ap, b = _bf16_probe_pair()
    exact = create_image_analogy(a, ap, b, base, device=device,
                                 keep_levels=True)
    tls.probing = True
    try:
        approx = create_image_analogy(a, ap, b, flagged, device=device,
                                      keep_levels=True)
    finally:
        tls.probing = False
    audit = audit_source_map_mismatches(a, ap, b, base, approx.levels,
                                        exact.levels)
    ok = (audit["unexplained"] == 0
          and audit["first_divergence_is_tie"] is not False)
    return {"ok": ok, "mismatches": audit["mismatches"],
            "unexplained": audit["unexplained"],
            "first_divergence_is_tie": audit["first_divergence_is_tie"]}


def _bf16_probe_verdict(params, device) -> Dict[str, Any]:
    """Run the probe pair through both scans on ``device`` and audit."""
    base = _probe_base_params(params)
    return _probe_verdict(base, dataclasses.replace(base, bf16_scoring=True),
                          device, _BF16_TLS)


def bf16_gate_allows(params, device) -> bool:
    """True when bf16 scoring may run on ``device``: the cached verdict, or
    a fresh probe the first time (the gate's own bf16 probe run passes)."""
    if getattr(_BF16_TLS, "probing", False):
        return True  # the gate's own bf16 probe run must not recurse
    key = device_key(device)
    with _BF16_GATE_LOCK:
        verdict = _BF16_GATE.get(key)
    if verdict is None:
        fresh = _bf16_probe_verdict(params, device)
        with _BF16_GATE_LOCK:
            verdict = _BF16_GATE.setdefault(key, fresh)
    return verdict["ok"]


# ------------------------------------------------ ANN prefilter parity gate

_ANN_GATE: Dict[str, Dict[str, Any]] = {}
_ANN_GATE_LOCK = threading.Lock()
_ANN_TLS = threading.local()  # .probing: True inside the gate's ANN run


def reset_ann_gate() -> None:
    """Forget cached ANN verdicts (tests re-probe after monkeypatching)."""
    with _ANN_GATE_LOCK:
        _ANN_GATE.clear()


def _ann_key(device, strategy: str) -> str:
    return f"{device_key(device)}|{strategy}"


def ann_gate_verdict(device, strategy: str = "wavefront"
                     ) -> Optional[Dict[str, Any]]:
    """The cached ANN verdict of (``device``, ``strategy``), or None before
    the first prefiltered synthesis there."""
    with _ANN_GATE_LOCK:
        verdict = _ANN_GATE.get(_ann_key(device, strategy))
    return None if verdict is None else dict(verdict)


@contextlib.contextmanager
def ann_gate_bypass():
    """Run the body with the ANN gate forced open (``ia tune --knob ann``
    audits every candidate itself; the card's smoke runs the path at full
    width whatever the verdict)."""
    prev = getattr(_ANN_TLS, "probing", False)
    _ANN_TLS.probing = True
    try:
        yield
    finally:
        _ANN_TLS.probing = prev


def _ann_probe_verdict(params, device, strategy: str) -> Dict[str, Any]:
    """The probe pair through the exact engine and the two-stage engine on
    ``device``, then the audit."""
    base = _probe_base_params(params, strategy=strategy)
    return _probe_verdict(base, dataclasses.replace(base, ann_prefilter=True),
                          device, _ANN_TLS)


def ann_gate_allows(params, device, strategy: str) -> bool:
    """True when the two-stage matcher may run on (``device``,
    ``strategy``): the cached verdict, or a fresh probe the first time
    (the gate's own probe run, and a bypassed body, pass)."""
    if getattr(_ANN_TLS, "probing", False):
        return True
    key = _ann_key(device, strategy)
    with _ANN_GATE_LOCK:
        verdict = _ANN_GATE.get(key)
    if verdict is None:
        fresh = _ann_probe_verdict(params, device, strategy)
        with _ANN_GATE_LOCK:
            verdict = _ANN_GATE.setdefault(key, fresh)
        if verdict is fresh:  # the first prober counts and logs it once
            obs_metrics.inc("ann.gate_ok" if verdict["ok"]
                            else "ann.disabled_unexplained")
            obs_trace.emit_record(
                {"event": "ann_gate",
                 "severity": "info" if verdict["ok"] else "warning",
                 "device": key, "strategy": strategy, **verdict})
    return verdict["ok"]
