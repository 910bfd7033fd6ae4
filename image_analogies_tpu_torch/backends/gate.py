"""The bf16 scoring parity gate (counterpart of the gate in the JAX
package's ``backends/tpu.py``).

``AnalogyParams.bf16_scoring`` routes the wavefront anchor through the
scan_rescue machinery (bf16 per-tile champion scan + exact fp32 top-T
re-score with the lowest-index tie-break).  It is a supported flag because
of this gate: the FIRST bf16-scored synthesis on a device runs a small
deterministic probe twice (exact parity scan vs bf16 scan) and audits the
two source maps with ``utils/parity.py``.  Only a verdict whose mismatches
are ALL tie-explained (unexplained == 0, first divergence a tie) enables
the mode; anything else disables it for the process, and every synthesis
silently keeps the exact scan.  Verdicts are cached per device (the card's
name, or "cpu") and readable through :func:`bf16_gate_verdict`; the JAX
package's obs counters and log event wait for the port's obs layer.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

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


def _probe_base_params(params, *, levels: int = 2):
    """The probe's hermetic EXACT baseline: the caller's params with the
    scan forced to the exact wavefront defaults, the video term off and
    every resilience and IO knob off, so a probe is a pure synthesis of the
    probe pair that writes nothing of the caller's (the port's subset of
    the JAX package's ``_probe_base_params``)."""
    return dataclasses.replace(
        params, levels=levels, strategy="wavefront", match_mode="auto",
        bf16_scoring=False, temporal_weight=0.0, level_retries=0,
        dispatch_timeout_s=0.0, level_sync=True, checkpoint_dir=None,
        resume_from_level=None, profile_dir=None, log_path=None,
        save_levels_dir=None, pipeline=False, donate_buffers=False)


def _bf16_probe_verdict(params, device) -> Dict[str, Any]:
    """Run the probe pair through both scans on ``device`` and audit."""
    from image_analogies_tpu_torch.models.analogy import create_image_analogy
    from image_analogies_tpu_torch.utils.parity import (
        audit_source_map_mismatches)

    base = _probe_base_params(params)
    a, ap, b = _bf16_probe_pair()
    exact = create_image_analogy(a, ap, b, base, device=device,
                                 keep_levels=True)
    _BF16_TLS.probing = True
    try:
        bf16 = create_image_analogy(
            a, ap, b, dataclasses.replace(base, bf16_scoring=True),
            device=device, keep_levels=True)
    finally:
        _BF16_TLS.probing = False
    audit = audit_source_map_mismatches(a, ap, b, base, bf16.levels,
                                        exact.levels)
    ok = (audit["unexplained"] == 0
          and audit["first_divergence_is_tie"] is not False)
    return {"ok": ok, "mismatches": audit["mismatches"],
            "unexplained": audit["unexplained"],
            "first_divergence_is_tie": audit["first_divergence_is_tie"]}


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
