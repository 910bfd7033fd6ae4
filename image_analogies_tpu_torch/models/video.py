"""Video analogies (counterpart of the single-device part of the JAX
package's ``models/video.py``).

One training pair A -> A' applied to a sequence of B frames with a
temporal term: each frame's feature vectors carry windows of the PREVIOUS
output frame (matched against A' windows on the DB side), weighted by
``params.temporal_weight``, so the synthesis prefers sources consistent
with where it looked last frame.

- ``scheme="sequential"``: frame t consumes frame t-1's actual output.
- ``scheme="two_phase"`` (default): phase 1 synthesizes every frame
  without the temporal term; phase 2 re-synthesizes frames 1.. with the
  term fed by phase 1's output of the frame before (a Jacobi step of the
  sequential recurrence).  Frame 0 keeps its phase-1 output.

Every frame's luminance remap is anchored on the clip's first frame, so
the A mapping is one for the whole clip, and one matcher serves the whole
clip.  The JAX package's mesh path (frames sharded over chips,
``_sharded_phase``) waits for the port of ``parallel/``; the port's params
have no ``data_shards``, so every clip runs here, on one device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from image_analogies_tpu_torch.backends.cuda import CudaMatcher
from image_analogies_tpu_torch.config import AnalogyParams
from image_analogies_tpu_torch.models.analogy import (
    create_image_analogy,
    resolve_device,
)
from image_analogies_tpu_torch.obs import trace as obs_trace
from image_analogies_tpu_torch.tune import resolve as tune_resolve
from image_analogies_tpu_torch.utils.ssim import ssim

SCHEMES = ("sequential", "two_phase")


@dataclass
class VideoResult:
    frames: List[np.ndarray]  # synthesized B' frames
    frames_y: List[np.ndarray]  # synthesized luminance planes
    stats: List[Dict[str, Any]] = field(default_factory=list)
    # each frame's (H,W) int32 flat indices into A (the port's addition:
    # what a card run is held to against its CPU run)
    source_maps: List[np.ndarray] = field(default_factory=list)

    def flicker(self) -> List[float]:
        """Temporal stability: SSIM between consecutive output frames
        (higher = less flicker, the quantity the temporal term exists to
        raise).  len == n_frames - 1."""
        return [float(ssim(self.frames_y[t], self.frames_y[t + 1]))
                for t in range(len(self.frames_y) - 1)]


def video_analogy(
    a: np.ndarray,
    ap: np.ndarray,
    frames: Sequence[np.ndarray],
    params: AnalogyParams = AnalogyParams(temporal_weight=1.0),
    scheme: str = "two_phase",
    backend: Optional[CudaMatcher] = None,
) -> VideoResult:
    """Synthesize every frame of ``frames`` by the analogy A : A'.

    The clip runs on ``params.device`` ("cuda" by default, which raises
    where there is no card); ``backend`` replaces the clip's one matcher.
    Each level record of ``stats`` carries ``frame`` and ``phase`` ("seq",
    "phase1" or "phase2")."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}")
    frames = list(frames)
    if not frames:
        return VideoResult(frames=[], frames_y=[])
    if backend is None:
        backend = CudaMatcher(params, resolve_device(params.device))
    # one obs run (the frames' syntheses join it) and one geometry
    # resolution a key for the whole clip, as in the JAX package
    with obs_trace.run_scope(params, manifest_extra=dict(
            tune_resolve.manifest_info(),
            device=str(getattr(backend, "device", None)))):
        with tune_resolve.pin_scope():
            return _clip(a, ap, frames, params, scheme, backend)


def _clip(a, ap, frames, params, scheme, backend) -> VideoResult:
    stats: List[Dict[str, Any]] = []

    def synth(b, prev_y, tag, idx):
        res = create_image_analogy(a, ap, b, params, backend=backend,
                                   temporal_prev=prev_y,
                                   remap_anchor=frames[0])
        for st in res.stats:
            st.update(frame=idx, phase=tag)
            stats.append(st)
        return res

    if scheme == "sequential":
        outs, prev_y = [], None
        for t, b in enumerate(frames):
            res = synth(b, prev_y, "seq", t)
            prev_y = res.bp_y
            outs.append(res)
    else:
        phase1 = [synth(b, None, "phase1", t) for t, b in enumerate(frames)]
        outs = [phase1[0]] + [
            synth(frames[t], phase1[t - 1].bp_y, "phase2", t)
            for t in range(1, len(frames))]
    return VideoResult(frames=[r.bp for r in outs],
                       frames_y=[r.bp_y for r in outs], stats=stats,
                       source_maps=[r.source_map for r in outs])
